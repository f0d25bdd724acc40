"""The port's training substrate against the JAX package, on the CPU.

Mirrors ``tests/test_train.py`` on the port (its resume test is in
``tests/test_torch_train_launch.py``; the train step against the
reference's in ``tests/test_torch_train_step.py``), then holds each
module against the reference on the same inputs:
- ``synth_batch`` ``==`` for every arch, and the prefetching iterator;
- ``softmax_xent`` (value and gradient) within 1e-6, with the mask;
- ``schedule`` and ``update`` (params, moments, metrics) within float32
  rounding (rtol 1e-6, atol 1e-9), the decay rule on stacked leaves;
- ``quantize_int8``, its round trip and the error-feedback transform
  ``==``;
- checkpoints both ways: every leaf ``==`` (bf16 and an ``OptState``
  included) and the manifests' sha1s equal;
- fault tolerance's plans and policies ``==``.
"""

import json
import os
import shutil
import socket

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
import torch.distributed as dist
from _hypothesis_compat import given, settings, st

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import get_config as ref_get_config
from repro.configs import smoke_config as ref_smoke_config
from repro.models import transformer as ref_tf
from repro.train import checkpoint as ref_ckpt
from repro.train import compression as ref_comp
from repro.train import data as ref_data
from repro.train import fault_tolerance as ref_ft
from repro.train import optimizer as ref_opt
from repro.train import train_loop as ref_tl
from repro_torch.configs import get_config, smoke_config
from repro_torch.models.params import (flatten, params_from_numpy, tree_map,
                                       unflatten)
from repro_torch.models.transformer import init_lm
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import compression as comp
from repro_torch.train import optimizer as opt
from repro_torch.train.data import (DataConfig, batch_iterator, input_dtypes,
                                    synth_batch)
from repro_torch.train.fault_tolerance import (HeartbeatMonitor,
                                               StragglerPolicy,
                                               recovery_plan)
from repro_torch.train.train_loop import make_train_step, softmax_xent

CPU = "cpu"
RTOL, ATOL = 1e-6, 1e-9     # float32 rounding: elementwise math, same order


def np32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def grad_of(loss_fn, params):
    """``jax.grad`` of ``loss_fn`` over a tree of tensors, by autograd."""
    live = tree_map(lambda t: t.detach().requires_grad_(), params)
    return unflatten(live, torch.autograd.grad(loss_fn(live), flatten(live)))


# -- tests/test_train.py, on the port -------------------------------------

def test_adamw_reduces_quadratic():
    target = torch.tensor([1.0, -2.0, 3.0])
    params = {"w": torch.zeros(3)}
    ocfg = opt.AdamWConfig(lr=0.1, warmup_steps=1, total_steps=200,
                           weight_decay=0.0)
    state = opt.init(params)

    def loss(p):
        return torch.sum((p["w"] - target) ** 2)

    for _ in range(150):
        g = grad_of(loss, params)
        params, state, _ = opt.update(ocfg, params, g, state)
    assert float(loss(params)) < 1e-2


def test_train_loss_decreases_end_to_end():
    cfg = smoke_config("yi-6b")
    dc = DataConfig(seq_len=32, global_batch=4, seed=0)
    params = init_lm(cfg, generator=torch.Generator().manual_seed(0),
                     device=CPU)
    state = opt.init(params)
    ocfg = opt.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=30)
    step = make_train_step(cfg, ocfg)
    b = {k: torch.from_numpy(v) for k, v in synth_batch(cfg, dc, 0).items()}
    losses = []
    for s in range(12):
        params, state, m = step(params, state, b)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.3, losses


def test_microbatching_matches_full_batch():
    cfg = smoke_config("yi-6b").replace(param_dtype="float32")
    dc = DataConfig(seq_len=16, global_batch=4, seed=1)
    params = init_lm(cfg, generator=torch.Generator().manual_seed(0),
                     device=CPU)
    ocfg = opt.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    b = {k: torch.from_numpy(v) for k, v in synth_batch(cfg, dc, 0).items()}

    s1 = make_train_step(cfg, ocfg, n_microbatches=1)
    s2 = make_train_step(cfg, ocfg, n_microbatches=2)
    p1, _, m1 = s1(params, opt.init(params), b)
    p2, _, m2 = s2(params, opt.init(params), b)
    for a, c in zip(flatten(p1), flatten(p2)):
        np.testing.assert_allclose(np32(a), np32(c), rtol=2e-4, atol=2e-5)


def test_masked_loss_ignores_minus_one():
    logits = torch.zeros((1, 4, 8))
    labels = torch.tensor([[1, 2, -1, -1]])
    loss, denom = softmax_xent(logits, labels, z_loss=0.0)
    assert float(denom) == 2.0
    np.testing.assert_allclose(float(loss), np.log(8.0), rtol=1e-5)


def test_checkpoint_roundtrip_and_corruption(tmp_path):
    # leaf large enough that a mid-file byte-flip lands in array data
    tree = {"a": torch.arange(65536, dtype=torch.float32),
            "b": {"c": torch.ones((2, 3), dtype=torch.bfloat16)}}
    d = str(tmp_path / "ck")
    ckpt.save(d, 3, tree)
    assert ckpt.latest_step(d) == 3
    back = ckpt.restore(d, 3, tree, device=CPU)
    for x, y in zip(flatten(tree), flatten(back)):
        assert x.dtype == y.dtype and torch.equal(x, y)
    # corrupt a byte -> restore must fail loudly
    shard = os.path.join(d, "step_00000003", "shard_0.npz")
    data = bytearray(open(shard, "rb").read())
    data[len(data) // 2] ^= 0xFF
    open(shard, "wb").write(bytes(data))
    with pytest.raises(Exception):
        ckpt.restore(d, 3, tree, device=CPU)


@given(st.integers(0, 2**31 - 1), st.integers(1, 4))
@settings(max_examples=20, deadline=None)
def test_compression_roundtrip_bounded_error(seed, scale):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal(515).astype(np.float32) * scale)
    d, r = comp.compress_roundtrip(x)
    np.testing.assert_allclose((d + r).numpy(), x.numpy(), rtol=1e-6,
                               atol=1e-6)
    # max error bounded by scale/127 per block
    amax = float(x.abs().max())
    assert float(r.abs().max()) <= amax / 127.0 + 1e-6


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_compressed_psum_single_device():
    # a group of one rank: compressed psum == identity up to quantization
    x = torch.linspace(-1, 1, 256)
    with pytest.raises(RuntimeError, match="process group"):
        comp.compressed_psum(x)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:"
                            f"{_free_port()}", world_size=1, rank=0)
    try:
        y = comp.compressed_psum(x)
        group = dist.new_group([0])
        z = comp.compressed_psum(x, group)
    finally:
        dist.destroy_process_group()
    np.testing.assert_allclose(y.numpy(), x.numpy(), atol=1e-2)
    assert torch.equal(y, z)
    # one rank: its own scale is the common one, so the result is the
    # quantization round trip exactly
    assert torch.equal(y, comp.compress_roundtrip(x)[0])


def test_heartbeat_and_recovery_plan():
    hb = HeartbeatMonitor(n_hosts=4, timeout_s=10)
    for h in range(4):
        hb.beat(h, t=100.0)
    assert hb.alive(now=105.0) == [0, 1, 2, 3]
    assert hb.dead(now=111.0) == [0, 1, 2, 3]
    hb.beat(2, t=110.0)
    assert hb.alive(now=111.0) == [2]

    plan = recovery_plan(n_alive_chips=384, model_parallel=16,
                         chips_per_pod=256)
    pods, data, model = plan["mesh_shape"]
    assert model == 16
    assert pods * data * model <= 384
    assert plan["chips_used"] % (model) == 0


def test_straggler_policy():
    sp = StragglerPolicy(threshold=2.0, evict_after=2)
    for step in range(3):
        for h in range(4):
            sp.record(h, 1.0 if h != 3 else 5.0)
        skip, evict = sp.classify()
        assert 3 in skip
    assert 3 in evict
    assert sp.gradient_scale(4, len(skip)) == pytest.approx(4 / 3)


# -- against the reference ------------------------------------------------

@pytest.mark.parametrize("arch", sorted(REF_ARCHS))
def test_synth_batch_equals_reference(arch):
    """The published config's batches (vision and audio stubs included)
    ``==`` the reference's, at several steps and seeds."""
    for seed, step in ((0, 0), (3, 7), (11, 1)):
        got = synth_batch(get_config(arch), DataConfig(16, 2, seed), step)
        want = ref_data.synth_batch(ref_get_config(arch),
                                    ref_data.DataConfig(16, 2, seed), step)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert input_dtypes(get_config(arch)) == \
        ref_data.input_dtypes(ref_get_config(arch))


def test_batch_iterator_resumes_at_its_step():
    cfg, dc = smoke_config("internvl2-1b"), DataConfig(8, 2, seed=5)
    it = batch_iterator(cfg, dc, start_step=4)
    rit = ref_data.batch_iterator(ref_smoke_config("internvl2-1b"),
                                  ref_data.DataConfig(8, 2, seed=5),
                                  start_step=4)
    for step in (4, 5, 6):
        got, want = next(it), next(rit)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
            np.testing.assert_array_equal(got[k],
                                          synth_batch(cfg, dc, step)[k])
    it.close()
    rit.close()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_softmax_xent_matches_reference(dtype):
    """Loss, mask count and the gradient of the loss within 1e-6 of the
    reference's on the same logits, with masked labels and the z-loss."""
    rng = np.random.default_rng(4)
    logits = (rng.standard_normal((3, 7, 37)) * 4).astype(np.float32)
    labels = rng.integers(-1, 37, (3, 7)).astype(np.int32)
    labels[0] = -1
    jdt = jnp.dtype(dtype)
    tdt = getattr(torch, dtype)
    rx = jnp.asarray(logits).astype(jdt)
    x = torch.from_numpy(logits).to(tdt)
    (r_loss, r_den), r_grad = jax.value_and_grad(
        lambda z: ref_tl.softmax_xent(z, jnp.asarray(labels)),
        has_aux=True)(rx)
    xl = x.detach().requires_grad_()
    loss, den = softmax_xent(xl, torch.from_numpy(labels))
    (grad,) = torch.autograd.grad(loss, xl)
    assert float(den) == float(r_den) == float((labels >= 0).sum())
    np.testing.assert_allclose(float(loss.detach()), float(r_loss), rtol=1e-6)
    np.testing.assert_allclose(np32(grad), np32(r_grad), rtol=1e-6,
                               atol=1e-6 if dtype == "float32" else 1e-3)


def test_schedule_matches_reference():
    for kw in ({}, {"warmup_steps": 10, "total_steps": 50},
               {"warmup_steps": 1, "total_steps": 3, "lr": 1e-2}):
        ocfg, rcfg = opt.AdamWConfig(**kw), ref_opt.AdamWConfig(**kw)
        steps = np.arange(0, rcfg.total_steps + 20, 3, dtype=np.int32)
        got = [float(opt.schedule(ocfg, torch.tensor(int(s),
                                                     dtype=torch.int32)))
               for s in steps]
        want = [float(ref_opt.schedule(rcfg, jnp.asarray(s)))
                for s in steps]
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)


def _opt_tree(rng):
    """A param tree with the shapes the decay rule tells apart: a stacked
    (L, d, f) weight, a stacked (L, d) norm gain, a 1-D bias, a bf16
    matrix, and a 2-D float leaf."""
    return {"blocks": {"w": rng.standard_normal((3, 4, 5)),
                       "g": 1 + 0.1 * rng.standard_normal((3, 4))},
            "bias": rng.standard_normal(6),
            "emb": rng.standard_normal((7, 4)).astype(ml_dtypes.bfloat16),
            "out": {"w": rng.standard_normal((4, 7))}}


def _as(tree, kind):
    """A numpy tree (float64 leaves as float32) as JAX arrays or
    tensors."""
    def one(a):
        a = a if a.dtype == ml_dtypes.bfloat16 else a.astype(np.float32)
        return jnp.asarray(a) if kind == "jax" else params_from_numpy(
            {"x": a}, CPU)["x"]
    return jax.tree.map(one, tree) if kind == "jax" else tree_map(one, tree)


def test_update_matches_reference():
    """Three AdamW updates on seeded params and gradients (one with a
    gradient large enough to clip): params, moments, step, grad norm
    and lr within float32 rounding of the reference's."""
    rng = np.random.default_rng(7)
    tree = _opt_tree(rng)
    ocfg = opt.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=6)
    rcfg = ref_opt.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=6)
    rp, pp = _as(tree, "jax"), _as(tree, "torch")
    rs, ps = ref_opt.init(rp), opt.init(pp)
    for i, gscale in enumerate((0.1, 3.0, 0.5)):
        g = jax.tree.map(lambda a: a.astype(np.float64) * 0 + gscale
                         * rng.standard_normal(a.shape), tree)
        rp, rs, rm = ref_opt.update(rcfg, rp, _as(g, "jax"), rs)
        pp, ps, pm = opt.update(ocfg, pp, _as(g, "torch"), ps)
        assert int(ps.step) == int(rs.step) == i + 1
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(pm[k]), float(rm[k]), rtol=RTOL)
        for got, want in ((pp, rp), (ps.mu, rs.mu), (ps.nu, rs.nu)):
            for a, b in zip(flatten(got), jax.tree.leaves(want)):
                assert str(a.dtype).removeprefix("torch.") == str(b.dtype)
                np.testing.assert_allclose(np32(a), np32(b), rtol=RTOL,
                                           atol=ATOL)
    assert all(m.dtype == torch.float32 for m in flatten(ps.mu))


def test_stacked_norm_gains_are_decayed_as_in_the_reference():
    """With zero gradients only decay moves a leaf: the stacked (L, d)
    norm gain and every matrix shrink by (1 - lr * wd), the 1-D bias
    does not move (``wd if p.ndim > 1``, reference ``optimizer.py:76``)."""
    tree = _opt_tree(np.random.default_rng(8))
    ocfg = opt.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=4)
    pp = _as(tree, "torch")
    zeros = tree_map(torch.zeros_like, pp)
    new, _, m = opt.update(ocfg, pp, zeros, opt.init(pp))
    lr = float(m["lr"])
    assert torch.equal(new["bias"], pp["bias"])
    for leaf in (new["blocks"]["g"], new["blocks"]["w"], new["out"]["w"]):
        assert leaf.dim() > 1
    g = pp["blocks"]["g"]
    assert torch.equal(new["blocks"]["g"], g - m["lr"] * (0.0 + 0.1 * g))
    assert not torch.equal(new["blocks"]["g"], g)
    rp = _as(tree, "jax")
    r_new, _, _ = ref_opt.update(ref_opt.AdamWConfig(
        lr=1e-2, warmup_steps=1, total_steps=4), rp,
        jax.tree.map(jnp.zeros_like, rp), ref_opt.init(rp))
    np.testing.assert_allclose(np32(new["blocks"]["g"]),
                               np32(r_new["blocks"]["g"]), rtol=RTOL)
    assert lr == pytest.approx(1e-2)


@pytest.mark.parametrize("shape", [(515,), (3, 300), (256,), (2, 4, 64)])
def test_quantize_int8_equals_reference(shape):
    rng = np.random.default_rng(sum(shape))
    x = (rng.standard_normal(shape) * 3).astype(np.float32)
    x.reshape(-1)[:256] = 0        # an all-zero block takes scale 1
    q, s, n = comp.quantize_int8(torch.from_numpy(x))
    rq, rs, rn = ref_comp.quantize_int8(jnp.asarray(x))
    assert n == rn and q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
    np.testing.assert_array_equal(
        comp.dequantize_int8(q, s, n, shape, torch.float32).numpy(),
        np.asarray(ref_comp.dequantize_int8(rq, rs, rn, shape,
                                            jnp.float32)))
    d, r = comp.compress_roundtrip(torch.from_numpy(x))
    rd, rr = ref_comp.compress_roundtrip(jnp.asarray(x))
    np.testing.assert_array_equal(d.numpy(), np.asarray(rd))
    np.testing.assert_array_equal(r.numpy(), np.asarray(rr))


def test_compressed_grad_transform_equals_reference():
    rng = np.random.default_rng(9)
    grads = {"a": rng.standard_normal((5, 70)), "b": {
        "c": rng.standard_normal(300)}}
    res = jax.tree.map(lambda a: 1e-3 * rng.standard_normal(a.shape), grads)
    got = comp.compressed_grad_transform(_as(res, "torch"))(
        _as(grads, "torch"))
    want = ref_comp.compressed_grad_transform(_as(res, "jax"), "pod")(
        _as(grads, "jax"))
    for g_tree, w_tree in zip(got, want):
        for a, b in zip(flatten(g_tree), jax.tree.leaves(w_tree)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _model_and_state(seed=0):
    """A smoke internvl2-1b (bf16) and an AdamW state after one update,
    in both packages, on the same values."""
    rcfg = ref_smoke_config("internvl2-1b")
    rp = ref_tf.init_lm(jax.random.PRNGKey(seed), rcfg)
    g = jax.tree.map(lambda a: jnp.full(a.shape, 0.01, a.dtype), rp)
    _, rs, _ = ref_opt.update(ref_opt.AdamWConfig(), rp, g, ref_opt.init(rp))
    pp = params_from_numpy(jax.tree.map(np.asarray, rp), CPU)
    ps = opt.OptState(step=torch.tensor(int(rs.step), dtype=torch.int32),
                      mu=params_from_numpy(jax.tree.map(np.asarray, rs.mu),
                                           CPU),
                      nu=params_from_numpy(jax.tree.map(np.asarray, rs.nu),
                                           CPU))
    return (rp, rs), (pp, ps)


def _leaves_equal(port_tree, ref_tree):
    got, want = flatten(port_tree), jax.tree.leaves(ref_tree)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        b = np.asarray(b)
        assert tuple(a.shape) == b.shape
        assert str(a.dtype).removeprefix("torch.") == str(b.dtype)
        if b.dtype == ml_dtypes.bfloat16:
            np.testing.assert_array_equal(
                a.view(torch.int16).numpy(), b.view(np.int16))
        else:
            np.testing.assert_array_equal(a.numpy(), b)


def _sha1s(path):
    with open(os.path.join(path, "manifest.json")) as f:
        m = json.load(f)
    return {k: (v["sha1"], v["dtype"], v["shape"])
            for k, v in m["leaves"].items()}


def test_checkpoint_port_saves_reference_restores(tmp_path):
    (rp, rs), (pp, ps) = _model_and_state()
    for name, port_tree, ref_tree in (("params", pp, rp), ("opt", ps, rs)):
        d, rd = str(tmp_path / name), str(tmp_path / f"ref_{name}")
        path = ckpt.save(d, 3, port_tree, meta={"arch": "internvl2-1b"})
        ref_path = ref_ckpt.save(rd, 3, ref_tree,
                                 meta={"arch": "internvl2-1b"})
        assert _sha1s(path) == _sha1s(ref_path)
        like = jax.tree.map(jnp.zeros_like, ref_tree)
        back = ref_ckpt.restore(d, ref_ckpt.latest_step(d), like)
        _leaves_equal(port_tree, back)


def test_checkpoint_reference_saves_port_restores(tmp_path):
    (rp, rs), (pp, ps) = _model_and_state(seed=1)
    d = str(tmp_path / "ref")
    ref_ckpt.save(d, 5, rp)
    ref_ckpt.save(d + "_opt", 5, rs)
    assert ckpt.latest_step(d) == 5
    like_p = tree_map(torch.zeros_like, pp)
    like_s = opt.OptState(step=torch.zeros((), dtype=torch.int32),
                          mu=tree_map(torch.zeros_like, ps.mu),
                          nu=tree_map(torch.zeros_like, ps.nu))
    back_p = ckpt.restore(d, 5, like_p, device=CPU)
    back_s = ckpt.restore(d + "_opt", 5, like_s, device=CPU)
    assert isinstance(back_s, opt.OptState) and int(back_s.step) == 1
    assert list(back_p) == list(pp)         # the port's key order kept
    _leaves_equal(back_p, rp)
    _leaves_equal(back_s, rs)
    # a restore into the wrong structure is refused
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(d, 5, {"embed": {"emb": torch.zeros(3)}}, device=CPU)


def test_checkpoint_save_async_and_tmp_dirs(tmp_path):
    """``save_async`` writes what the tree held when it was called; a
    leftover ``.tmp`` directory is not a step."""
    tree = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3)}
    d = str(tmp_path / "a")
    ckpt.save_async(d, 2, tree)
    tree["w"].add_(100)                     # after the host copy
    ckpt.wait_pending(d)
    os.makedirs(os.path.join(d, "step_00000009.tmp"))
    assert ckpt.latest_step(d) == 2
    back = ckpt.restore(d, 2, tree, device=CPU)
    assert torch.equal(back["w"], torch.arange(6.0).reshape(2, 3))
    assert ckpt.latest_step(str(tmp_path / "none")) is None
    shutil.rmtree(d)


@pytest.mark.parametrize("n_alive,mp,per_pod", [
    (384, 16, 256), (512, 16, 256), (100, 4, 256), (7, 1, 4), (1024, 8, 128)])
def test_recovery_plan_equals_reference(n_alive, mp, per_pod):
    assert recovery_plan(n_alive, mp, per_pod) == \
        ref_ft.recovery_plan(n_alive, mp, per_pod)


def test_straggler_and_heartbeat_equal_reference():
    rng = np.random.default_rng(3)
    sp, rsp = StragglerPolicy(evict_after=3), ref_ft.StragglerPolicy(
        evict_after=3)
    hb, rhb = HeartbeatMonitor(5, 2.0), ref_ft.HeartbeatMonitor(5, 2.0)
    for t in range(20):
        for h in range(5):
            lat = float(rng.exponential(1.0) * (4 if h == t % 5 else 1))
            sp.record(h, lat)
            rsp.record(h, lat)
            if rng.random() < 0.7:
                hb.beat(h, t=float(t))
                rhb.beat(h, t=float(t))
        assert sp.classify() == rsp.classify()
        assert hb.alive(now=t + 0.5) == rhb.alive(now=t + 0.5)
        assert hb.dead(now=t + 3.0) == rhb.dead(now=t + 3.0)
    assert sp.median_latency() == rsp.median_latency()
    assert sp.gradient_scale(5, 2) == rsp.gradient_scale(5, 2)
