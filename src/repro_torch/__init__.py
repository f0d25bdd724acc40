"""SIMDRAM on PyTorch and CUDA: the port of :mod:`repro` to one NVIDIA H100.

Layout mirrors the JAX package so every module has a named counterpart:

  core/     the μProgram compiler (Steps 1-2), the DRAM oracle, the
            timing/energy models, the control unit (Step 3 replay), the
            bit-plane fast path, the ISA surface and the bank dispatcher
  kernels/  Python wrappers of the hand-written CUDA kernels, each with
            its plain PyTorch version beside it, and the nvcc build
  csrc/     the CUDA C++ sources (sm_90a), built on first use
  models/, configs/
            the LM stack: the ten architectures' configs, layers,
            attention, MoE, SSD and the model assembly, with param trees
            carried across from the reference (``models/params.py``)
  train/    the LM serving path (``make_prefill``, ``make_serve_step``,
            ``Server``) and its PuM logit offload

Entry points take ``device`` (default ``"cuda"``); they run the plain
versions only when the caller asks for ``device="cpu"``.
"""
