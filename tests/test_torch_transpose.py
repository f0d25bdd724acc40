"""K1/K2 (the transposition unit): the port's plain versions against the
JAX package's Pallas kernels, run in interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_oracles
from repro_torch.core.bank import VerticalOperand
from repro_torch.core.transpose import swar_transpose_32x32_np
from repro_torch.kernels import ops, ref
from repro_torch.kernels.transpose_kernel import h2v_plain, v2h_plain


def _lanes(n, signed, seed):
    rng = np.random.default_rng(seed)
    if signed:
        return rng.integers(-2**31, 2**31, size=n).astype(np.int32)
    return rng.integers(0, 2**32, size=n, dtype=np.uint32).view(np.int32)


@pytest.mark.parametrize("n", [32, 1024, 1056])
@pytest.mark.parametrize("n_bits", [8, 32])
@pytest.mark.parametrize("signed", [False, True])
def test_h2v_and_v2h_match_reference(n, n_bits, signed):
    vals = _lanes(n, signed, n + n_bits)
    want = np.asarray(ref_ops.h2v(jnp.asarray(vals), n_bits)).view(np.int32)
    got = ops.h2v(torch.from_numpy(vals), n_bits).numpy()
    np.testing.assert_array_equal(got, want)

    back_want = np.asarray(ref_ops.v2h(jnp.asarray(want.view(np.uint32)),
                                       signed=signed))
    back = ops.v2h(torch.from_numpy(got), signed=signed).numpy()
    np.testing.assert_array_equal(back, back_want)


@pytest.mark.parametrize("n", [32, 1024])
def test_plain_transposes_match_oracles(n):
    vals = _lanes(n, False, 7)
    planes = h2v_plain(torch.from_numpy(vals))
    np.testing.assert_array_equal(planes.numpy(),
                                  ref.transpose32_ref(torch.from_numpy(vals))
                                  .numpy())
    np.testing.assert_array_equal(
        planes.numpy().view(np.uint32),
        np.asarray(ref_oracles.transpose32_ref(jnp.asarray(
            vals.view(np.uint32)))))
    np.testing.assert_array_equal(v2h_plain(planes).numpy(), vals)


def test_swar_spec_is_an_involution():
    block = _lanes(32, False, 3).view(np.uint32)
    once = swar_transpose_32x32_np(block)
    np.testing.assert_array_equal(swar_transpose_32x32_np(once), block)


@pytest.mark.parametrize("n_bits,signed", [(8, False), (8, True),
                                           (16, True), (32, False)])
def test_vertical_operand_roundtrip(n_bits, signed):
    from repro.core.bank import VerticalOperand as RefVerticalOperand
    rng = np.random.default_rng(n_bits)
    lo = -(1 << (n_bits - 1)) if signed else 0
    hi = (1 << (n_bits - 1)) if signed else (1 << n_bits)
    vals = rng.integers(lo, hi, size=100).astype(np.int64)
    vo = VerticalOperand.from_values(vals, n_bits, device="cpu")
    rvo = RefVerticalOperand.from_values(vals, n_bits)
    np.testing.assert_array_equal(vo.planes, np.asarray(rvo.planes))
    np.testing.assert_array_equal(vo.to_values(signed=signed),
                                  rvo.to_values(signed=signed))
    np.testing.assert_array_equal(vo.to_values(signed=signed), vals)


# -- mirrors of the transpose cases of tests/test_kernels.py, held against
# the JAX package's Pallas kernels in interpret mode

@pytest.mark.parametrize("n", [32, 64, 256, 1024])
def test_h2v_matches_ref(n):
    from repro.kernels.transpose_kernel import h2v_pallas
    rng = np.random.default_rng(n)
    v = rng.integers(0, 2**32, size=n, dtype=np.uint32)
    want = np.asarray(h2v_pallas(jnp.asarray(v), block_b=min(8, n // 32)))
    np.testing.assert_array_equal(
        np.asarray(ref_oracles.transpose32_ref(jnp.asarray(v))), want)
    vt = torch.from_numpy(v.view(np.int32))
    np.testing.assert_array_equal(h2v_plain(vt).numpy().view(np.uint32),
                                  want)
    np.testing.assert_array_equal(
        ref.transpose32_ref(vt).numpy().view(np.uint32), want)


@pytest.mark.parametrize("seed", [0, 1, 2**31 - 1])
def test_transpose_involution(seed):
    from repro.kernels.transpose_kernel import h2v_pallas, v2h_pallas
    rng = np.random.default_rng(seed)
    v = rng.integers(0, 2**32, size=128, dtype=np.uint32)
    planes = h2v_pallas(jnp.asarray(v), block_b=4)
    back = np.asarray(v2h_pallas(planes, block_b=4))
    np.testing.assert_array_equal(back, v)
    vt = torch.from_numpy(v.view(np.int32))
    pt = h2v_plain(vt)
    np.testing.assert_array_equal(pt.numpy().view(np.uint32),
                                  np.asarray(planes))
    np.testing.assert_array_equal(v2h_plain(pt).numpy(), vt.numpy())


# -- the module-level conversion, the counterpart of repro.core.transpose

@pytest.mark.parametrize("n_bits", [1, 8, 16, 32])
@pytest.mark.parametrize("signed", [False, True])
def test_core_h2v_and_v2h_match_reference(n_bits, signed):
    from repro.core import transpose as ref_transpose
    from repro_torch.core import transpose as pt_transpose
    vals = _lanes(96, signed, n_bits)
    want = np.asarray(ref_transpose.h2v(jnp.asarray(vals), n_bits))
    got = pt_transpose.h2v(torch.from_numpy(vals), n_bits)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    np.testing.assert_array_equal(
        pt_transpose.v2h(got, signed=signed).numpy(),
        np.asarray(ref_transpose.v2h(jnp.asarray(want), signed=signed)))


# -- K2's signed store: its plain version against the reference's
# ops.v2h(signed=True), which sign-extends from bit k - 1 for k < 32

@pytest.mark.parametrize("k", [1, 2, 8, 16, 32])
@pytest.mark.parametrize("n_words", [1, 3, 40])
def test_v2h_plain_signed_matches_reference(k, n_words):
    rng = np.random.default_rng(k * 100 + n_words)
    planes = rng.integers(0, 2**32, size=(k, n_words), dtype=np.uint32)
    want = np.asarray(ref_ops.v2h(jnp.asarray(planes), signed=True))
    pt = torch.from_numpy(planes.view(np.int32))
    np.testing.assert_array_equal(v2h_plain(pt, signed=True).numpy(), want)
    np.testing.assert_array_equal(ops.v2h(pt, signed=True).numpy(), want)
    unsigned = np.asarray(ref_ops.v2h(jnp.asarray(planes), signed=False))
    np.testing.assert_array_equal(v2h_plain(pt).numpy(), unsigned)
