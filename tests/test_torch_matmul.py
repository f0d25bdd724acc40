"""K4 and the bit-serial matmul path: the port against the JAX package.

The same numpy-seeded inputs go through the reference (the Pallas kernel
in interpret mode, as ``tests/test_kernels.py`` runs it) and through the
port's plain versions on the CPU; every result is compared bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_ref
from repro.kernels.bitserial_matmul import binary_matmul as ref_binary_matmul
from repro_torch.kernels import ops, ref
from repro_torch.kernels.bitserial_matmul import binary_matmul


def _i32(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


@pytest.mark.parametrize("m,kw,n,bm,bn,bk", [
    (8, 2, 8, 8, 8, 2),
    (16, 4, 32, 8, 16, 2),
    (32, 8, 16, 16, 16, 4),
])
def test_binary_matmul_matches_reference(m, kw, n, bm, bn, bk):
    rng = np.random.default_rng(m * n)
    a = rng.integers(0, 2**32, size=(m, kw), dtype=np.uint32)
    w = rng.integers(0, 2**32, size=(kw, n), dtype=np.uint32)
    want = np.asarray(ref_binary_matmul(jnp.asarray(a), jnp.asarray(w),
                                        bm=bm, bn=bn, bk=bk))
    got = binary_matmul(_i32(a), _i32(w))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        ref.binary_matmul_ref(_i32(a), _i32(w)).numpy(),
        np.asarray(ref_ref.binary_matmul_ref(jnp.asarray(a), jnp.asarray(w))))


@pytest.mark.parametrize("shape", [(37, 3, 5), (1, 1, 1), (70, 0, 9)])
def test_binary_matmul_ragged_shapes(shape):
    """No tile padding: any (M, Kw, N), including an empty K."""
    m, kw, n = shape
    rng = np.random.default_rng(sum(shape))
    a = rng.integers(0, 2**32, size=(m, kw), dtype=np.uint32)
    w = rng.integers(0, 2**32, size=(kw, n), dtype=np.uint32)
    want = np.zeros((m, n), np.int64)
    for k in range(kw):
        anded = a[:, k, None] & w[None, k, :]
        want += np.unpackbits(anded.view(np.uint8).reshape(m, n, 4),
                              axis=-1).sum(-1).astype(np.int64)
    np.testing.assert_array_equal(binary_matmul(_i32(a), _i32(w)).numpy(),
                                  want)


def test_plain_version_chunks_rows(monkeypatch):
    """The plain version's row chunks do not change the result."""
    rng = np.random.default_rng(5)
    a = _i32(rng.integers(0, 2**32, size=(50, 6), dtype=np.uint32))
    w = _i32(rng.integers(0, 2**32, size=(6, 7), dtype=np.uint32))
    whole = ref.binary_matmul_ref(a, w)
    monkeypatch.setattr(ref, "_PLAIN_CHUNK", 6 * 7 * 3)
    torch.testing.assert_close(ref.binary_matmul_ref(a, w), whole,
                               rtol=0, atol=0)


def test_popcount_matches_reference():
    rng = np.random.default_rng(9)
    v = np.concatenate([rng.integers(0, 2**32, 1000, dtype=np.uint32),
                        np.array([0, 1, 2**31, 2**32 - 1], np.uint32)])
    np.testing.assert_array_equal(
        ref.popcount_u32(_i32(v)).numpy(),
        np.asarray(ref_ref.popcount_u32(jnp.asarray(v))))


def test_binary_matmul_rejects_bad_inputs():
    a = torch.zeros((4, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="inner dimensions"):
        binary_matmul(a, torch.zeros((3, 4), dtype=torch.int32))
    with pytest.raises(ValueError, match="int32"):
        binary_matmul(a.to(torch.int64),
                      torch.zeros((2, 4), dtype=torch.int32))


@pytest.mark.parametrize("a_bits,w_bits,a_signed,w_signed", [
    (1, 1, False, False),
    (2, 2, False, True),
    (4, 4, False, True),
    (3, 5, True, True),
])
def test_bitserial_matmul_matches_reference(a_bits, w_bits, a_signed,
                                            w_signed):
    rng = np.random.default_rng(a_bits * 10 + w_bits)
    m, k, n = 8, 64, 12
    alo = -(1 << (a_bits - 1)) if a_signed else 0
    ahi = (1 << (a_bits - 1)) if a_signed else (1 << a_bits)
    wlo = -(1 << (w_bits - 1)) if w_signed else 0
    whi = (1 << (w_bits - 1)) if w_signed else (1 << w_bits)
    a = rng.integers(alo, ahi, size=(m, k)).astype(np.int32)
    w = rng.integers(wlo, whi, size=(k, n)).astype(np.int32)
    want = np.asarray(ref_ops.bitserial_matmul(
        jnp.asarray(a), jnp.asarray(w), a_bits, w_bits, a_signed=a_signed,
        w_signed=w_signed, bm=8, bn=4, bk=2))
    np.testing.assert_array_equal(want, a @ w)
    got = ops.bitserial_matmul(torch.from_numpy(a), torch.from_numpy(w),
                               a_bits, w_bits, a_signed=a_signed,
                               w_signed=w_signed)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    oracle = ref.bitserial_matmul_ref(torch.from_numpy(a),
                                      torch.from_numpy(w), a_bits, w_bits,
                                      a_signed, w_signed)
    np.testing.assert_array_equal(oracle.numpy(), want)


def test_bitserial_matmul_ragged_k_and_host_arrays():
    """K = 45 pads to two words; host arrays run where ``device`` says."""
    rng = np.random.default_rng(11)
    a = rng.integers(0, 4, size=(5, 45)).astype(np.int32)
    w = rng.integers(-2, 2, size=(45, 3)).astype(np.int32)
    got = ops.bitserial_matmul(a, w, 2, 2, device="cpu")
    np.testing.assert_array_equal(got.numpy(), a @ w)
    want = np.asarray(ref_ops.bitserial_matmul(jnp.asarray(a),
                                               jnp.asarray(w), 2, 2))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("a_bits,w_bits,a_range,w_range,k", [
    (1, 1, (0, 2), (0, 2), 64),          # bit-serial branch
    (2, 2, (0, 4), (-2, 2), 33),         # bit-serial branch, ragged K
    (8, 8, (-128, 128), (-128, 128), 16),  # exact float64 branch
    (16, 16, (-2**15, 2**15), (-2**15, 2**15), 96),  # the int32 sum wraps
])
def test_quantized_matmul_matches_reference(a_bits, w_bits, a_range,
                                            w_range, k):
    rng = np.random.default_rng(a_bits * w_bits + k)
    a = rng.integers(*a_range, size=(6, k)).astype(np.int32)
    w = rng.integers(*w_range, size=(k, 5)).astype(np.int32)
    want = np.asarray(ref_ops.quantized_matmul(jnp.asarray(a),
                                               jnp.asarray(w), a_bits,
                                               w_bits))
    got = ops.quantized_matmul(torch.from_numpy(a), torch.from_numpy(w),
                               a_bits, w_bits)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    exact = a.astype(np.int64) @ w.astype(np.int64)
    np.testing.assert_array_equal(want, exact.astype(np.int32))
    if a_bits == 16:
        assert np.abs(exact).max() >= 2**31        # the case wraps


def test_quantized_matmul_raises_where_float64_is_not_exact():
    a = torch.full((2, 4), 2**30, dtype=torch.int32)
    w = torch.full((4, 2), 2**30, dtype=torch.int32)
    with pytest.raises(ValueError, match="2\\*\\*53"):
        ops.quantized_matmul(a, w, 31, 31)


def test_pack_bits_matrix_matches_reference():
    rng = np.random.default_rng(4)
    x = rng.integers(0, 2, size=(3, 96)).astype(np.int32)
    want = np.asarray(ref_ops._pack_bits_matrix(jnp.asarray(x), 1))
    got = ops._pack_bits_matrix(torch.from_numpy(x), 1)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    want0 = np.asarray(ref_ops._pack_bits_matrix(jnp.asarray(x.T), 0))
    got0 = ops._pack_bits_matrix(torch.from_numpy(x.T.copy()), 0)
    np.testing.assert_array_equal(got0.numpy().view(np.uint32), want0)
