"""Hand-written CUDA kernels for SIMDRAM's hot spots, with plain versions.

  transpose_kernel.py  K1/K2: the transposition unit (SWAR in registers
                       and warp shuffles)
  bitplane_ops.py      K3: a synthesized circuit as a slot program
  bitserial_matmul.py  K4: the binary popcount matmul
  ops.py               wrappers: padding, sign extension, bbop_cuda,
                       bitserial_matmul, quantized_matmul
  ref.py               plain torch oracles
  build.py             nvcc build into build/repro_torch/, ctypes loading,
                       launch counters

The replay kernels (K5, and K6 with fault injection) are wrapped in
:mod:`repro_torch.core.control_unit`.
Every wrapper runs its plain version for CPU tensors and its kernel for
CUDA tensors; a kernel that fails to build or launch raises.
"""
