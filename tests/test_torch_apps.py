"""The seven paper apps on the port against the JAX package, on the CPU.

Mirrors ``tests/test_apps.py`` case by case at its sizes: each app runs
through the reference (its default ``bitplane`` device, or the device the
reference test builds) and through the port with ``torch_device="cpu"``
on the same seeds, and the port's ``output`` and every other key of its
result dict (``totals()`` among them) must be ``==`` the reference's, bit
for bit.  The ladder contract and the per-rung parity are in
``tests/test_torch_apps_ladder.py``.  Then what the port adds: its entry
points raise without a card, ``torch_device`` reaches the device it
builds, and every (op, width) the apps drive equals the reference's
oracle on the port's sequential and fused rungs.
"""

import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

from repro.apps import bitweaving as ref_bitweaving
from repro.apps import brightness as ref_brightness
from repro.apps import knn as ref_knn
from repro.apps import lenet as ref_lenet
from repro.apps import nn_layers as ref_nn_layers
from repro.apps import runtime as ref_runtime
from repro.apps import tpch as ref_tpch
from repro.apps import vgg as ref_vgg
from repro.core.isa import SimdramDevice as RefDevice
from repro.core.ops_library import get_op as ref_get_op
from repro.core.timing import DramConfig as RefConfig
from repro_torch.apps import (bitweaving, brightness, knn, lenet, nn_layers,
                              runtime, tpch, vgg)
from repro_torch.apps.runtime import AppVerificationError, verify
from repro_torch.core.bank import BbopInstr
from repro_torch.core.isa import SimdramDevice
from repro_torch.core.timing import DramConfig

SMALL = dict(n_banks=2, subarrays_per_bank=2, n_chips=2)


def _dev(backend):
    return SimdramDevice(backend=backend, cfg=DramConfig(**SMALL),
                         style="mig", device="cpu")


def _ref_dev(backend):
    return RefDevice(backend=backend, cfg=RefConfig(**SMALL), style="mig")


def assert_same_result(got, want):
    """The port's result dict ``==`` the reference's: the output as int64
    arrays, every other key (totals included) as plain values."""
    assert set(got) == set(want)
    np.testing.assert_array_equal(np.asarray(got["output"]).astype(np.int64),
                                  np.asarray(want["output"]).astype(np.int64))
    for k in want:
        if k != "output":
            assert got[k] == want[k], k


def test_bitweaving_scans():
    r = bitweaving.run(n_rows=2048, n_bits=10, torch_device="cpu")
    assert r["calls"] > 0 and r["latency_s"] > 0
    assert_same_result(r, ref_bitweaving.run(n_rows=2048, n_bits=10))


@pytest.mark.parametrize("h,w,delta", [(16, 16, 60), (8, 8, -200)],
                         ids=["over-clamp", "under-clamp"])
def test_brightness_clamp(h, w, delta):
    r = brightness.run(h=h, w=w, delta=delta, torch_device="cpu")
    assert r["pixels"] == 3 * h * w
    assert_same_result(r, ref_brightness.run(h=h, w=w, delta=delta))


@pytest.mark.parametrize("delta", [300, -600, 256, -256])
def test_brightness_rejects_out_of_range_delta(delta):
    with pytest.raises(ValueError, match="delta must be in"):
        brightness.run(h=2, w=2, delta=delta, torch_device="cpu")


def test_relu_rejects_out_of_range_activations():
    with pytest.raises(ValueError, match="exceed 8-bit"):
        nn_layers.relu_pum(_dev("bitplane"), np.array([1 << 20]), n_bits=8)


def test_verify_raises_with_context():
    with pytest.raises(AppVerificationError, match="boom"):
        verify(False, "boom", got=1, want=2)
    with pytest.raises(AssertionError, match=r"got=1, want=2"):
        verify(False, "boom", got=1, want=2)
    verify(True, "fine")


def test_tpch_query():
    r = tpch.run(n_rows=1024, torch_device="cpu")
    assert r["revenue"] >= 0
    assert_same_result(r, ref_tpch.run(n_rows=1024))


def test_knn():
    r = knn.run(n_points=256, n_features=4, k=3, torch_device="cpu")
    assert 0 <= r["pred"] < 4
    assert_same_result(r, ref_knn.run(n_points=256, n_features=4, k=3))


def test_lenet_inference():
    r = lenet.run(torch_device="cpu")
    assert 0 <= r["pred"] < 10
    assert r["macs"] > 100_000
    assert_same_result(r, ref_lenet.run())


@pytest.mark.slow
def test_vgg13_inference():
    # 32×32 is the minimum: VGG-13's five 2× pools reduce to 1×1
    r = vgg.run("vgg13", img_hw=32, torch_device="cpu")
    assert r["macs"] > 100_000_000
    assert_same_result(r, ref_vgg.run("vgg13", img_hw=32))


def test_apps_cheaper_on_simdram_than_ambit():
    d_sd = SimdramDevice(backend="bitplane", style="mig", device="cpu")
    d_am = SimdramDevice(backend="bitplane", style="aig", device="cpu")
    r_sd = tpch.run(n_rows=512, device=d_sd)
    r_am = tpch.run(n_rows=512, device=d_am)
    assert r_sd["latency_s"] < r_am["latency_s"]
    assert r_sd["energy_mj"] < r_am["energy_mj"]
    assert_same_result(r_am, ref_tpch.run(
        n_rows=512, device=RefDevice(backend="bitplane", style="aig")))


def test_backend_parameter_builds_matching_device():
    r = brightness.run(h=4, w=4, backend="bank", torch_device="cpu")
    assert r["backend"] == "bank"
    assert_same_result(r, ref_brightness.run(h=4, w=4, backend="bank"))


def test_reference_full_nn_layers_setting_exceeds_16_bits():
    """``benchmarks/paper_tables.py``'s ``full`` nn_layers call (32 x 32,
    8 channels, the default 16-bit elementwise width) raises the
    reference's own range error: its dense layer reaches -57,282.  The
    port raises the same error, and runs at 17 bits as the reference
    does."""
    with pytest.raises(ValueError) as want:
        ref_nn_layers.run(img_hw=32, out_ch=8)
    with pytest.raises(ValueError) as got:
        nn_layers.run(img_hw=32, out_ch=8, torch_device="cpu")
    assert str(got.value) == str(want.value)
    assert "[-57282, 0]" in str(got.value)
    r = nn_layers.run(img_hw=32, out_ch=8, n_bits=17, torch_device="cpu")
    assert_same_result(r, ref_nn_layers.run(img_hw=32, out_ch=8, n_bits=17))


# --- width/signedness plumbing (the knn audit) -------------------------------

@st.composite
def _knn_window(draw):
    """Points pinned at the edges of one 2**n_bits-wide window — the
    boundary pairs (±2**(n_bits-1), full-range spans) that the widened
    (n+1)-bit signed subtract must represent exactly."""
    n_bits = draw(st.integers(min_value=2, max_value=6))
    signed = draw(st.booleans())
    if signed:
        lo, hi = -(1 << (n_bits - 1)), (1 << (n_bits - 1)) - 1
    else:
        lo, hi = 0, (1 << n_bits) - 1
    mid = draw(st.integers(min_value=lo, max_value=hi))
    vals = [lo, hi, lo, hi, mid, draw(st.integers(min_value=lo, max_value=hi))]
    q = draw(st.sampled_from([lo, hi, mid]))
    return n_bits, vals, q


@given(_knn_window(), st.sampled_from(["bitplane", "bank"]))
@settings(max_examples=25, deadline=None)
def test_knn_distance_exact_at_window_edges(window, backend):
    n_bits, vals, q = window
    refs = np.array(vals, np.int64).reshape(-1, 1)
    refs = np.concatenate([refs, refs[::-1]], axis=1)     # two features
    query = np.array([q, q], np.int64)
    dist = knn.l1_distance(_dev(backend), refs, query, n_bits)
    want = np.abs(refs - query[None, :]).sum(axis=1)
    np.testing.assert_array_equal(dist, want)
    np.testing.assert_array_equal(
        dist, ref_knn.l1_distance(_ref_dev(backend), refs, query, n_bits))


# --- what the port adds -------------------------------------------------------

APP_RUNS = {
    "knn": lambda **kw: knn.run(n_points=64, n_features=2, n_bits=4, **kw),
    "tpch": lambda **kw: tpch.run(n_rows=64, **kw),
    "bitweaving": lambda **kw: bitweaving.run(n_rows=64, n_bits=6, **kw),
    "brightness": lambda **kw: brightness.run(h=2, w=2, **kw),
    "nn_layers": lambda **kw: nn_layers.run(**kw),
    "lenet": lambda **kw: lenet.run(conv_channels=(2, 3), fc_dims=(12, 10),
                                    **kw),
    "vgg13": lambda **kw: vgg.run("vgg13", img_hw=8, n_layers=3, **kw),
}


@pytest.mark.parametrize("name", sorted(APP_RUNS))
def test_app_without_a_card_raises(name, monkeypatch):
    """``run()`` builds its device on the card unless asked for the CPU,
    and raises without one; it never moves to the CPU by itself."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        APP_RUNS[name]()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        APP_RUNS[name](backend="channel")


def test_resolve_device_and_units_follow_the_reference():
    cfg = DramConfig(**SMALL)
    given_dev = _dev("chip")
    assert runtime.resolve_device(given_dev, "bank") is given_dev
    for backend in ("bitplane", "cuda", "bank", "chip", "channel", "rank"):
        dev = runtime.resolve_device(None, backend, cfg=cfg,
                                     torch_device="cpu")
        assert (dev.backend, dev.device, dev.cfg) == (backend, "cpu", cfg)
        want = ref_runtime.n_parallel_units(
            _ref_dev("bitplane" if backend == "cuda" else backend))
        assert runtime.n_parallel_units(dev) == want
    assert runtime.n_parallel_units(_dev("channel")) == 8
    assert runtime.n_parallel_units(_dev("cuda")) == 1
    assert runtime.LADDER == ref_runtime.LADDER
    for n in (0, 1, 31, 32, 100, 4096, 6_001_215):
        for units in (1, 8, 128):
            assert (runtime.shard_slices(n, units)
                    == ref_runtime.shard_slices(n, units))


def test_engine_stats_per_rung():
    for backend in ("bitplane", "cuda", "rank"):
        assert runtime.engine_stats(_dev(backend)) is None
    for backend in ("bank", "chip", "channel"):
        dev = _dev(backend)
        brightness.run(h=2, w=2, device=dev)
        stats = runtime.engine_stats(dev)
        assert stats == runtime.engine_stats_object(dev).as_dict()
        assert stats["bbops"] > 0


# every (op, width, signed_out) an app emits, at the widths of the
# reference's app tables (knn: n_bits 5, 6 and 8 with 3, 4 and 16
# features; nn_layers: 16 and 17 bits)
APP_OPS = sorted({
    ("addition", 10, False), ("greater_equal", 10, False),
    ("greater", 10, False), ("if_else", 10, False),
    ("equal", 12, False), ("greater", 12, False),
    ("greater_equal", 12, False), ("greater_equal", 4, False),
    ("greater", 6, False), ("and_red", 1, False),
    ("multiplication", 14, False), ("if_else", 28, False),
    ("subtraction", 6, True), ("abs", 6, False), ("addition", 8, False),
    ("subtraction", 7, True), ("abs", 7, False), ("addition", 9, False),
    ("subtraction", 9, True), ("abs", 9, False), ("addition", 13, False),
    ("relu", 16, False), ("max", 16, False), ("subtraction", 16, True),
    ("relu", 17, False), ("max", 17, False), ("subtraction", 17, True),
})


def _masked(x, w):
    return np.asarray(x).astype(np.int64) & ((1 << w) - 1)


@pytest.mark.parametrize("op,n_bits,signed_out", APP_OPS,
                         ids=[f"{o}-{w}{'-signed' if s else ''}"
                              for o, w, s in APP_OPS])
def test_app_op_widths_match_oracle(op, n_bits, signed_out):
    """Each (op, width) of the apps, one instruction of 96 lanes on the
    port's ``bitplane``, ``cuda`` and ``bank`` rungs, equals the
    reference's oracle in its output width; a signed output is the
    oracle's value sign-extended."""
    spec = ref_get_op(op, n_bits)
    rng = np.random.default_rng(n_bits * 31 + len(op))
    operands = [rng.integers(0, 1 << w, 96).astype(np.uint64)
                for w in spec.operand_bits]
    want = spec.oracle(*operands)
    for backend in ("bitplane", "cuda", "bank"):
        got = _dev(backend).dispatch([BbopInstr(
            op, tuple(operands), n_bits, signed_out=signed_out)])[0]
        got = got if isinstance(got, tuple) else (got,)
        assert len(got) == len(want)
        for g, e, w in zip(got, want, spec.out_bits):
            np.testing.assert_array_equal(_masked(g, w), _masked(e, w),
                                          err_msg=backend)
            if signed_out and w > 1:
                e = _masked(e, w)
                e = np.where(e >= 1 << (w - 1), e - (1 << w), e)
                np.testing.assert_array_equal(
                    np.asarray(g).astype(np.int64), e, err_msg=backend)
