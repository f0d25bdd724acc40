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
from repro_torch.kernels.bitserial_matmul import (binary_matmul,
                                                  bitserial_planes)


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


@pytest.mark.parametrize("m,k,n,bits", [
    (5, 1, 4, 32),       # full-range int32: one product already wraps
    (5, 7, 4, 32),
    (6, 300, 5, 32),
    (6, 300, 5, 16),     # 16-bit operands
    (2, (1 << 21) + 5, 2, 32),   # K over one float64 chunk
])
def test_quantized_matmul_wraps_as_the_reference_at_every_width(m, k, n,
                                                                bits):
    rng = np.random.default_rng(k + bits)
    lo, hi = -(1 << (bits - 1)), 1 << (bits - 1)
    a = rng.integers(lo, hi, size=(m, k)).astype(np.int32)
    w = rng.integers(lo, hi, size=(k, n)).astype(np.int32)
    a[0, 0], w[0, 0] = lo, lo              # the extremes of the width
    if k > 1:
        a[-1, -1], w[-1, -1] = hi - 1, hi - 1
    want = np.asarray(ref_ops.quantized_matmul(jnp.asarray(a),
                                               jnp.asarray(w), bits, bits))
    got = ops.quantized_matmul(torch.from_numpy(a), torch.from_numpy(w),
                               bits, bits)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if k < 1000:     # Python integers: the true sum, wrapped to int32
        wrapped = [[(sum(int(x) * int(y) for x, y in zip(a[i], w[:, j]))
                     + 2**31) % 2**32 - 2**31 for j in range(n)]
                   for i in range(m)]
        np.testing.assert_array_equal(want, np.array(wrapped, np.int64))


def test_pack_bits_matrix_matches_reference():
    rng = np.random.default_rng(4)
    x = rng.integers(0, 2, size=(3, 96)).astype(np.int32)
    want = np.asarray(ref_ops._pack_bits_matrix(jnp.asarray(x), 1))
    got = ops._pack_bits_matrix(torch.from_numpy(x), 1)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    want0 = np.asarray(ref_ops._pack_bits_matrix(jnp.asarray(x.T), 0))
    got0 = ops._pack_bits_matrix(torch.from_numpy(x.T.copy()), 0)
    np.testing.assert_array_equal(got0.numpy().view(np.uint32), want0)


@pytest.mark.parametrize("a_bits", [1, 2, 3, 4])
@pytest.mark.parametrize("w_bits", [1, 2, 3, 4])
@pytest.mark.parametrize("signed", [False, True])
def test_fused_planes_plain_matches_reference(a_bits, w_bits, signed):
    """K4's fused entry (every plane pair in one launch on a card) through
    its plain version, against the reference's bitserial_matmul."""
    rng = np.random.default_rng(a_bits * 100 + w_bits * 10 + signed)
    m, k, n = 9, 70, 6                       # K pads to three words
    alo = -(1 << (a_bits - 1)) if signed and a_bits > 1 else 0
    wlo = -(1 << (w_bits - 1)) if signed and w_bits > 1 else 0
    a = rng.integers(alo, alo + (1 << a_bits), size=(m, k)).astype(np.int32)
    w = rng.integers(wlo, wlo + (1 << w_bits), size=(k, n)).astype(np.int32)
    want = np.asarray(ref_ops.bitserial_matmul(
        jnp.asarray(a), jnp.asarray(w), a_bits, w_bits, a_signed=signed,
        w_signed=signed, bm=8, bn=8, bk=1))
    np.testing.assert_array_equal(want, a.astype(np.int64) @ w)
    au = (a & ((1 << a_bits) - 1)).astype(np.int64)
    wu = (w & ((1 << w_bits) - 1)).astype(np.int64)
    au = np.pad(au, ((0, 0), (0, 26)))
    wu = np.pad(wu, ((0, 26), (0, 0)))
    a_planes = np.stack([np.asarray(ref_ops._pack_bits_matrix(
        jnp.asarray((au >> i) & 1), 1)) for i in range(a_bits)])
    w_planes = np.stack([np.asarray(ref_ops._pack_bits_matrix(
        jnp.asarray((wu >> j) & 1), 0)) for j in range(w_bits)])
    # as ops.bitserial_matmul passes them: a 1-bit operand is unsigned
    sa, sw = signed and a_bits > 1, signed and w_bits > 1
    got = bitserial_planes(_i32(a_planes), _i32(w_planes), sa, sw)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        ref.bitserial_planes_ref(_i32(a_planes), _i32(w_planes), sa,
                                 sw).numpy(), want)


def test_fused_planes_weights_wrap_modulo_2_to_the_32():
    """Plane pairs whose weight reaches 2**32 add nothing, and the sum
    wraps: 32 x 32-bit operands give the true product modulo 2**32 (the
    reference cannot run 32-bit planes: its mask ``(1 << 32) - 1``
    overflows int32)."""
    rng = np.random.default_rng(3)
    a = rng.integers(-2**31, 2**31, size=(4, 64)).astype(np.int32)
    w = rng.integers(-2**31, 2**31, size=(64, 3)).astype(np.int32)
    exact = a.astype(object) @ w.astype(object)
    wrapped = np.vectorize(lambda v: (v + 2**31) % 2**32 - 2**31)(exact)
    got = ops.bitserial_matmul(torch.from_numpy(a), torch.from_numpy(w), 32,
                               32, a_signed=True, w_signed=True)
    np.testing.assert_array_equal(got.numpy(), wrapped.astype(np.int64))


def test_fused_planes_rejects_bad_inputs():
    a = torch.zeros((2, 4, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="inner dimensions"):
        bitserial_planes(a, torch.zeros((2, 4, 5), dtype=torch.int32))
    with pytest.raises(ValueError, match="3-D"):
        bitserial_planes(a[0], torch.zeros((3, 5), dtype=torch.int32))
    with pytest.raises(ValueError, match="1..32 planes"):
        bitserial_planes(torch.zeros((33, 4, 3), dtype=torch.int32),
                         torch.zeros((1, 3, 5), dtype=torch.int32))
