"""The port's MoE dispatch, int8 weight quantization and the SIMDRAM
router against the JAX package, on the CPU.

Mirrors ``tests/test_moe_quant.py`` and ``tests/test_pum_router.py``
case by case.  The MoE weights are the reference's init carried across
with ``params_from_numpy``: ``moe_forward_grouped`` and the dense
dispatch within ``rtol = atol = 1e-3`` of the reference's;
``quantize_tree``'s ``w_q`` and ``scale`` ``==`` on float32 weights; the
quantized model's decode logits within 1e-3 of the reference's.  The
routing inputs are random floats, so no test depends on how ``top_k``
breaks a tie.  The router runs on the port's
``SimdramDevice(backend="bitplane", device="cpu")`` and equals the
reference device's results and modeled totals.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import smoke_config as ref_smoke_config
from repro.core.isa import SimdramDevice as RefDevice
from repro.models import moe as ref_moe
from repro.models import quantized as ref_quant
from repro.models import transformer as ref_tf
from repro_torch.core.isa import SimdramDevice
from repro_torch.launch.mesh import Mesh
from repro_torch.models.config import ModelConfig
from repro_torch.models.moe import (moe_forward, moe_forward_ep,
                                    moe_forward_grouped)
from repro_torch.models.params import LM, params_from_numpy
from repro_torch.models.quantized import dequantize_weight, quantize_tree
from repro_torch.models.transformer import decode_step, init_caches

CPU = "cpu"
TOL = 1e-3


def np32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np32(got), np32(want), rtol=tol, atol=tol)


def moe_pair(seed, d, ff, n_e):
    p = ref_moe.moe_init(jax.random.PRNGKey(seed), d, ff, n_e, "swiglu",
                         jnp.float32)
    return p, params_from_numpy(jax.tree.map(np.asarray, p), CPU)


def inputs(seed, shape, scale=1.0):
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape)) * scale
    return jnp.asarray(x), torch.from_numpy(np.array(x))


def test_grouped_matches_dense_dispatch():
    """With capacity ≥ T·K/E·E (no drops), grouped == dense-masked MoE,
    and both equal the reference's; ``moe_forward_ep`` with no mesh is
    the grouped dispatch, and over a (1, 4) mesh of CPU positions (one
    expert a position, no data split) it computes the same within
    rtol 1e-5 (its partials add in another order)."""
    d, ff, n_e, top_k = 16, 32, 4, 2
    rp, p = moe_pair(0, d, ff, n_e)
    rx, x = inputs(1, (2, 8, d), 0.5)
    with torch.no_grad():
        out_d, aux_d = moe_forward(p, x, top_k=top_k, act="swiglu")
        out_g, aux_g = moe_forward_grouped(p, x, top_k=top_k, act="swiglu",
                                           capacity_factor=float(n_e))
        out_e, aux_e = moe_forward_ep(p, x, top_k=top_k, act="swiglu",
                                      capacity_factor=float(n_e))
    np.testing.assert_allclose(np32(out_g), np32(out_d), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(float(aux_g), float(aux_d), rtol=1e-5)
    assert torch.equal(out_e, out_g) and torch.equal(aux_e, aux_g)
    r_d, r_aux_d = ref_moe.moe_forward(rp, rx, top_k=top_k, act="swiglu")
    r_g, r_aux_g = ref_moe.moe_forward_grouped(rp, rx, top_k=top_k,
                                               act="swiglu",
                                               capacity_factor=float(n_e))
    r_e, _ = ref_moe.moe_forward_ep(rp, rx, top_k=top_k, act="swiglu",
                                    capacity_factor=float(n_e))
    close(out_d, r_d)
    close(out_g, r_g)
    close(out_e, r_e)
    close(aux_d, r_aux_d)
    close(aux_g, r_aux_g)
    mesh = Mesh((1, n_e), ("data", "model"), [torch.device(CPU)] * n_e)
    with torch.no_grad():
        out_m, aux_m = moe_forward_ep(p, x, top_k=top_k, act="swiglu",
                                      capacity_factor=float(n_e), mesh=mesh)
    np.testing.assert_allclose(np32(out_m), np32(out_g), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(float(aux_m), float(aux_g), rtol=1e-6)


def test_grouped_capacity_drops_are_weighted_zero():
    """Tiny capacity: the output is finite, and the same tokens drop as
    in the reference (its output within 1e-3)."""
    d, ff, n_e = 8, 16, 4
    rp, p = moe_pair(2, d, ff, n_e)
    rx, x = inputs(3, (1, 32, d))
    with torch.no_grad():
        out, _ = moe_forward_grouped(p, x, top_k=2, act="swiglu",
                                     capacity_factor=0.25)
    assert np.isfinite(np32(out)).all()
    r_out, _ = ref_moe.moe_forward_grouped(rp, rx, top_k=2, act="swiglu",
                                           capacity_factor=0.25)
    close(out, r_out)


def test_quantize_roundtrip_error_bounded():
    rw, w = inputs(4, (64, 32), 0.1)
    q = quantize_tree({"w": w})
    assert q["w_q"].dtype == torch.int8
    assert tuple(q["scale"].shape) == (32,)
    back = dequantize_weight(q, torch.float32)
    err = (back - w).abs().max().item()
    amax = w.abs().max().item()
    assert err <= amax / 127.0 + 1e-7
    rq = ref_quant.quantize_tree({"w": rw})
    np.testing.assert_array_equal(q["w_q"].numpy(), np.asarray(rq["w_q"]))
    np.testing.assert_array_equal(q["scale"].numpy(), np.asarray(rq["scale"]))


def test_quantized_lm_decode_close_to_fp():
    """int8 weights: the decode logits stay close to the float model's,
    and the quantized tree (stacked layers) and logits equal the
    reference's."""
    rcfg = ref_smoke_config("yi-6b").replace(param_dtype="float32",
                                             n_layers=2)
    cfg = ModelConfig(**dataclasses.asdict(rcfg))
    params = ref_tf.init_lm(jax.random.PRNGKey(0), rcfg)
    model = params_from_numpy(jax.tree.map(np.asarray, params), CPU)
    qparams = ref_quant.quantize_tree(params)
    qmodel = quantize_tree(model)
    got_sd = LM(qmodel).state_dict()
    want_sd = LM(params_from_numpy(jax.tree.map(np.asarray, qparams),
                                   CPU)).state_dict()
    assert sorted(got_sd) == sorted(want_sd)
    for name, t in want_sd.items():
        assert got_sd[name].dtype == t.dtype, name
        assert torch.equal(got_sd[name], t), name
    tok = torch.zeros(1, dtype=torch.int32)
    pos = torch.zeros(1, dtype=torch.int32)
    with torch.no_grad():
        lg_fp, _ = decode_step(model, init_caches(cfg, 1, 8, CPU), tok, pos,
                               cfg)
        lg_q, _ = decode_step(qmodel, init_caches(cfg, 1, 8, CPU), tok, pos,
                              cfg)
    denom = lg_fp.abs().max().item() + 1e-6
    rel = (lg_q - lg_fp).abs().max().item() / denom
    assert rel < 0.15, rel
    r_lg_q, _ = ref_tf.decode_step(qparams, ref_tf.init_caches(rcfg, 1, 8),
                                   jnp.zeros((1,), jnp.int32),
                                   jnp.zeros((1,), jnp.int32), rcfg)
    close(lg_q, r_lg_q)


def test_quantized_moe_forward():
    d, ff, n_e = 8, 16, 4
    rp, p = moe_pair(5, d, ff, n_e)
    qp = quantize_tree(p)
    assert "w_q" in qp["up"]
    rx, x = inputs(6, (1, 8, d), 0.5)
    with torch.no_grad():
        out_q, _ = moe_forward_grouped(qp, x, top_k=2, act="swiglu",
                                       capacity_factor=4.0)
        out_f, _ = moe_forward_grouped(p, x, top_k=2, act="swiglu",
                                       capacity_factor=4.0)
    np.testing.assert_allclose(np32(out_q), np32(out_f), rtol=0.2, atol=0.05)
    r_q, _ = ref_moe.moe_forward_grouped(ref_quant.quantize_tree(rp), rx,
                                         top_k=2, act="swiglu",
                                         capacity_factor=4.0)
    close(out_q, r_q)


# -- the MoE router's top-1 as SIMDRAM ops (tests/test_pum_router.py) -------

def pum_router_top1(logits_q: np.ndarray, dev, n_bits: int = 8):
    """logits_q: (T, E) unsigned ints < 2^n_bits -> (T,) argmax indices:
    per expert, ``greater`` and two ``if_else`` bbops update the running
    (best value, best index) across all tokens in parallel."""
    t, e = logits_q.shape
    best_v = logits_q[:, 0].astype(np.int64)
    best_i = np.zeros(t, dtype=np.int64)
    idx_bits = max(1, (e - 1).bit_length())
    for ei in range(1, e):
        cand = logits_q[:, ei].astype(np.int64)
        gt = np.asarray(dev.bbop("greater", cand, best_v, n_bits=n_bits))
        best_v = np.asarray(dev.bbop("if_else", gt.astype(np.int64),
                                     cand, best_v, n_bits=n_bits))
        best_i = np.asarray(dev.bbop("if_else", gt.astype(np.int64),
                                     np.full(t, ei, np.int64), best_i,
                                     n_bits=idx_bits))
    return best_i, best_v


def test_pum_router_matches_argmax():
    rng = np.random.default_rng(0)
    t, e = 512, 8
    logits = rng.integers(0, 256, size=(t, e)).astype(np.int64)
    dev = SimdramDevice(backend="bitplane", device=CPU)
    got_i, got_v = pum_router_top1(logits, dev)
    # ties: argmax picks the FIRST max; the scan keeps the first (strict >)
    np.testing.assert_array_equal(got_i, np.argmax(logits, axis=1))
    np.testing.assert_array_equal(got_v, logits.max(axis=1))
    tot = dev.totals()
    assert tot["calls"] == (e - 1) * 3
    assert tot["latency_s"] > 0 and tot["energy_mj"] > 0
    ref = RefDevice(backend="bitplane")
    ref_i, ref_v = pum_router_top1(logits, ref)
    np.testing.assert_array_equal(got_i, ref_i)
    np.testing.assert_array_equal(got_v, ref_v)
    assert tot == ref.totals()


def test_pum_router_cost_scales_with_experts():
    rng = np.random.default_rng(1)
    t = 256
    costs, ref_costs = [], []
    for e in (4, 8, 16):
        logits = rng.integers(0, 256, size=(t, e)).astype(np.int64)
        dev = SimdramDevice(backend="bitplane", device=CPU)
        pum_router_top1(logits, dev)
        costs.append(dev.totals()["latency_s"])
        ref = RefDevice(backend="bitplane")
        pum_router_top1(logits, ref)
        ref_costs.append(ref.totals()["latency_s"])
    assert costs[0] < costs[1] < costs[2]
    assert costs == ref_costs
