"""The port's fast path mirrored from the reference's tests, on the CPU.

Mirrors ``tests/test_bitplane.py`` (pack/unpack round trips, ``bbop``
against the op oracles, signed unpack) on the port's ``core/bitplane.py``
with CPU tensors, its planes ``==`` the reference's ``pack``, and
``tests/test_kernels.py::test_bbop_pallas_sweep`` as the port's ``cuda``
backend (``kernels.ops.bbop_cuda``: K1 -> K3 -> K2, their plain versions
on the CPU), against the reference's oracles and its ``bitplane``
results.  Hypothesis cases run with ``deadline=None`` and a fixed
``max_examples``.
"""

import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st
from test_torch_examples_core import one_torch_thread  # noqa: F401
from repro.core import bitplane as ref_bitplane
from repro.core.ops_library import get_op as ref_get_op
from repro_torch.core import bitplane
from repro_torch.core.isa import SimdramDevice
from repro_torch.kernels import ops as kops

CPU = "cpu"


def _check(got, name, n_bits, ops_vals, what):
    got = got if isinstance(got, (tuple, list)) else (got,)
    spec = ref_get_op(name, n_bits)
    want = spec.oracle(*[np.asarray(v).astype(np.uint64) for v in ops_vals])
    assert len(got) == len(want)
    for gi, (g, e) in enumerate(zip(got, want)):
        mask = (1 << spec.out_bits[gi]) - 1
        np.testing.assert_array_equal(
            np.asarray(g).astype(np.int64) & mask,
            e.astype(np.int64) & mask, err_msg=f"{what} {name}/{n_bits}b")


@given(st.integers(1, 32), st.integers(1, 4), st.integers(0, 2**32 - 1))
@settings(max_examples=40, deadline=None)
def test_pack_unpack_roundtrip(n_bits, words, seed):
    import jax.numpy as jnp
    rng = np.random.default_rng(seed)
    lanes = 32 * words
    vals = rng.integers(0, 1 << min(n_bits, 31), size=lanes).astype(np.uint32)
    planes = bitplane.pack(torch.from_numpy(vals.astype(np.int64)), n_bits)
    assert tuple(planes.shape) == (n_bits, words)
    ref = np.asarray(ref_bitplane.pack(jnp.asarray(vals), n_bits))
    np.testing.assert_array_equal(planes.numpy().view(np.uint32),
                                  ref.astype(np.uint32))
    back = bitplane.unpack(planes).numpy()
    mask = (1 << n_bits) - 1
    np.testing.assert_array_equal(back.astype(np.int64) & mask,
                                  vals.astype(np.int64) & mask)


@given(st.sampled_from(["addition", "subtraction", "greater", "equal",
                        "max", "min", "relu", "abs", "bitcount"]),
       st.integers(2, 12), st.integers(0, 1000))
@settings(max_examples=50, deadline=None)
def test_bbop_matches_oracle(name, n_bits, seed):
    spec = ref_get_op(name, n_bits)
    rng = np.random.default_rng(seed)
    ops_vals = [rng.integers(0, 1 << w, size=64).astype(np.int64)
                for w in spec.operand_bits]
    got = bitplane.bbop(name, n_bits, *ops_vals, device=CPU)
    got = got if isinstance(got, tuple) else (got,)
    _check([g.numpy() for g in got], name, n_bits, ops_vals, "bitplane")


def test_signed_unpack():
    vals = torch.tensor([0, 1, 127, 128, 255] + [0] * 27, dtype=torch.int32)
    planes = bitplane.pack(vals, 8)
    out = bitplane.unpack(planes, signed=True).numpy()[:5]
    np.testing.assert_array_equal(out, [0, 1, 127, -128, -1])


@pytest.mark.parametrize("name,n_bits", [
    ("addition", 8), ("subtraction", 8), ("greater", 8),
    ("relu", 8), ("if_else", 6), ("equal", 12),
])
def test_bbop_cuda_sweep(name, n_bits):
    """The reference's ``bbop_pallas`` sweep on the port's ``cuda`` path
    (and its ``SimdramDevice(backend="cuda")``), plain on the CPU: the
    oracle's lanes and the reference ``bitplane`` backend's."""
    import jax.numpy as jnp
    spec = ref_get_op(name, n_bits)
    rng = np.random.default_rng(7)
    ops_vals = [rng.integers(0, 1 << w, size=200).astype(np.int32)
                for w in spec.operand_bits]
    got = kops.bbop_cuda(name, n_bits, *ops_vals, device=CPU)
    got = [g.numpy() for g in (got if isinstance(got, (tuple, list))
                               else (got,))]
    _check(got, name, n_bits, ops_vals, "bbop_cuda")
    ref = ref_bitplane.bbop(name, n_bits, *[jnp.asarray(v) for v in ops_vals])
    ref = ref if isinstance(ref, tuple) else (ref,)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, np.asarray(r))
    dev = SimdramDevice(backend="cuda", device=CPU)
    out = dev.bbop(name, *ops_vals, n_bits=n_bits)
    _check(out, name, n_bits, ops_vals, "SimdramDevice(cuda)")
