"""The port's LM serving path against the JAX package, on the CPU.

Mirrors ``tests/test_serve.py``'s four model cases and
``tests/test_system.py::test_pum_offload_inside_lm``.  The weights are
the reference's init of smoke yi-6b (2 layers, float32), carried across
with ``params_from_numpy``.  The port's ``Server`` gives the reference
``Server``'s greedy tokens ``==``, with and without ``PumServeOffload``,
until a token the reference emitted at a top-1/top-2 logit margin of at
most twice the tolerance (which may differ, and past which the request
is compared no further); the offload's chip ``bbops``,
``rounds`` and modeled ``ChipStats`` fields ``==`` the reference's;
``make_prefill`` and ``make_serve_step`` within ``rtol = atol = 1e-3``
of the reference's; the PuM MLP's integer relu stage ``==`` the
reference's bit for bit, and its logits within 1e-3.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as ref_smoke_config
from repro.core.chip import SimdramChip as RefChip
from repro.models import transformer as ref_tf
from repro.train import serve as ref_serve
from repro_torch.core.chip import SimdramChip
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import relu_stage
from repro_torch.models.params import params_from_numpy
from repro_torch.models.transformer import init_caches, init_lm, lm_forward
from repro_torch.train.serve import (PumServeOffload, PumStage, Request,
                                     Server, make_prefill, make_serve_step)

CPU = "cpu"
TOL = 1e-3
MEASURED = ("wall_s", "pack_wall_s")


def np32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np32(got), np32(want), rtol=tol, atol=tol)


def port_cfg(ref_cfg):
    return ModelConfig(**dataclasses.asdict(ref_cfg))


@pytest.fixture(scope="module")
def small_model():
    """Smoke yi-6b (2 layers, float32): the reference's config and params,
    and the port's copies."""
    rcfg = ref_smoke_config("yi-6b").replace(n_layers=2,
                                             param_dtype="float32")
    params = ref_tf.init_lm(jax.random.PRNGKey(0), rcfg)
    return (rcfg, params, port_cfg(rcfg),
            params_from_numpy(jax.tree.map(np.asarray, params), CPU))


def drive(server, reqs):
    """Run ``server`` over ``reqs`` step by step: the top-1/top-2 margin
    of the logits each emitted token came from, per request."""
    last = {}
    step_fn = server.step_fn

    def recorded(*args):
        logits, caches = step_fn(*args)
        last["logits"] = np32(logits)
        last["slot"] = {id(r): i for i, r in enumerate(server.slots) if r}
        return logits, caches

    server.step_fn = recorded
    for r in reqs:
        server.submit(r)
    margins = [[] for _ in reqs]
    for _ in range(128):
        if not server.queue and all(s is None for s in server.slots):
            break
        before = [len(r.out) for r in reqs]
        server.step()
        for j, r in enumerate(reqs):
            if len(r.out) > before[j]:
                top2 = np.sort(last["logits"][last["slot"][id(r)]])[-2:]
                margins[j].append(float(top2[1] - top2[0]))
    assert all(r.done for r in reqs)
    return margins


def same_tokens_where_margin(got, want, margins, tol=TOL):
    """Request by request, tokens ``==`` until the first that differs,
    which must be one the reference emitted at a margin of at most
    ``2 * tol`` (past it the two decode different prefixes)."""
    for g, w, m in zip(got, want, margins):
        for t, (a, b) in enumerate(zip(g, w)):
            if a != b:
                assert m[t] <= 2 * tol, (got, want, t, m[t])
                break
        else:
            assert len(g) == len(w), (got, want)


def serve_both(small_model, prompts, max_new, batch_slots,
               offloads=(None, None)):
    """The same requests through the reference's and the port's Server:
    (reference outs, port outs, port requests); tokens compared under the
    margin rule."""
    rcfg, params, cfg, model = small_model
    ref = ref_serve.Server(rcfg, params, batch_slots=batch_slots, max_len=32,
                           pum_offload=offloads[0])
    want = [ref_serve.Request(prompt=list(p), max_new=max_new)
            for p in prompts]
    margins = drive(ref, want)
    port = Server(cfg, model, batch_slots=batch_slots, max_len=32,
                  pum_offload=offloads[1], device=CPU)
    got = [Request(prompt=list(p), max_new=max_new) for p in prompts]
    drive(port, got)
    same_tokens_where_margin([r.out for r in got], [r.out for r in want],
                             margins)
    return [r.out for r in want], [r.out for r in got], got


def test_server_completes_requests(small_model):
    _, _, reqs = serve_both(small_model, [[5, 6, 7], [9], [3, 4]], 4,
                            batch_slots=2)
    assert all(1 <= len(r.out) <= 4 for r in reqs)


def test_server_slot_reuse(small_model):
    """One slot serves 3 requests serially, as the reference's does."""
    _, _, reqs = serve_both(small_model, [[2, 3]] * 3, 2, batch_slots=1)
    assert all(r.done for r in reqs)


def test_prefill_and_serve_step_shapes(small_model):
    rcfg, params, cfg, model = small_model
    prefill = make_prefill(cfg, remat="none")
    toks = np.arange(16, dtype=np.int32).reshape(2, 8) % cfg.vocab_size
    logits = prefill(model, toks)
    assert logits.shape == (2, cfg.vocab_padded)
    close(logits, ref_serve.make_prefill(rcfg, remat="none")(
        params, jnp.asarray(toks)))

    step = make_serve_step(cfg)
    caches = init_caches(cfg, 2, 16, CPU)
    tok = np.array([3, 7], np.int32)
    pos = np.zeros(2, np.int32)
    lg, caches2 = step(model, caches, tok, pos)
    assert lg.shape == (2, cfg.vocab_padded)
    # the cache was written at position 0
    assert not np.allclose(np32(caches2["attn"]["k"][:, :, 0]), 0.0)
    r_lg, r_caches = ref_serve.make_serve_step(rcfg)(
        params, ref_tf.init_caches(rcfg, 2, 16), jnp.asarray(tok),
        jnp.asarray(pos))
    close(lg, r_lg)
    assert caches2["attn"]["k"].shape == r_caches["attn"]["k"].shape
    close(caches2["attn"]["k"], r_caches["attn"]["k"])
    close(caches2["attn"]["v"], r_caches["attn"]["v"])


def _modeled(stats):
    return {k: v for k, v in stats.as_dict().items() if k not in MEASURED}


def test_server_with_pum_offload_decodes_identically(small_model):
    """End to end under batch traffic: routing every decode step's logits
    through the chip gives exactly the plain server's tokens, and the
    reference's (margin rule); the chip's modeled stats equal the
    reference chip's."""
    rcfg, params, cfg, model = small_model
    prompts = [[5, 6, 7], [9]]
    plain_ref, plain, _ = serve_both(small_model, prompts, 3, batch_slots=2)
    ref_off = ref_serve.PumServeOffload(chip=RefChip(n_banks=2,
                                                     n_subarrays=2))
    off = PumServeOffload(chip=SimdramChip(n_banks=2, n_subarrays=2,
                                           device=CPU))
    want, got, _ = serve_both(small_model, prompts, 3, batch_slots=2,
                              offloads=(ref_off, off))
    assert got == plain and want == plain_ref
    st, rst = off.chip.stats, ref_off.chip.stats
    assert st.bbops >= 2 * len(off.stages)
    assert st.rounds > 0
    got_m, want_m = _modeled(st), _modeled(rst)
    assert got_m.keys() == want_m.keys()
    for k, v in want_m.items():
        assert np.array_equal(np.asarray(got_m[k]), np.asarray(v)), k


def test_offload_writes_back_in_the_logits_dtype(small_model):
    """bf16 logits through a value-changing stage (bitcount): the
    dequantized result is rounded to bf16 before the greedy argmax (first
    maximum), in the port as in the reference.  In row 0 that rounding
    ties lanes 1 and 2 (1007.03 and 1008.03 both become 1008), so the
    token differs from an argmax of the float32 result."""
    rcfg, params, cfg, model = small_model
    rows = np.array([[1000, 1248, 1256, 1000],
                     [1000, 1000, 1256, 1248]], np.float32)   # exact in bf16
    off = PumServeOffload(chip=SimdramChip(n_banks=2, n_subarrays=2,
                                           device=CPU),
                          stages=(PumStage("bitcount"),))
    ref_off = ref_serve.PumServeOffload(
        chip=RefChip(n_banks=2, n_subarrays=2),
        stages=(ref_serve.PumStage("bitcount"),))
    f32 = off.reference(rows)
    np.testing.assert_array_equal(f32, ref_off.reference(rows))
    assert list(np.argmax(f32, -1)) == [2, 2]
    as_bf16 = torch.from_numpy(f32).to(torch.bfloat16)
    assert list(torch.argmax(as_bf16, -1).numpy()) == [1, 2]

    def tokens(server, logits):
        server.step_fn = lambda *args: (logits, server.caches)
        req = Request if isinstance(server, Server) else ref_serve.Request
        for prompt in ([5], [6]):
            server.submit(req(prompt=prompt, max_new=1))
        server.step()
        return [int(t) for t in server.cur]

    got = tokens(Server(cfg, model, batch_slots=2, max_len=32,
                        pum_offload=off, device=CPU),
                 torch.from_numpy(rows).to(torch.bfloat16))
    want = tokens(ref_serve.Server(rcfg, params, batch_slots=2, max_len=32,
                                   pum_offload=ref_off),
                  jnp.asarray(rows, jnp.bfloat16))
    assert got == want == [1, 2]


def test_pum_offload_inside_lm():
    """cfg.pum='bitplane' routes the MLP ReLU through SIMDRAM bbops (the
    plain circuit on the CPU): finite logits close to the float MLP's,
    within 1e-3 of the reference's PuM logits, and the integer relu stage
    bit for bit the reference's on the same activations."""
    from repro.core import bitplane as ref_bitplane
    rcfg = ref_smoke_config("seamless-m4t-medium").replace(
        act="relu", pum="bitplane", pum_bits=8, param_dtype="float32")
    cfg = port_cfg(rcfg)
    params = ref_tf.init_lm(jax.random.PRNGKey(0), rcfg)
    model = params_from_numpy(jax.tree.map(np.asarray, params), CPU)
    toks = torch.zeros((1, 8), dtype=torch.int32)
    feats = torch.zeros((1, 4, cfg.d_model))
    with torch.no_grad():
        logits_pum, _ = lm_forward(model, toks, cfg, encoder_feats=feats)
        logits_off, _ = lm_forward(model, toks, cfg.replace(pum="off"),
                                   encoder_feats=feats)
    assert np.isfinite(np32(logits_pum)).all()
    # the PuM path quantizes activations to 8 bits: close, not identical
    assert (logits_pum - logits_off).abs().max().item() < 1.0
    r_pum, _ = ref_tf.lm_forward(params, jnp.zeros((1, 8), jnp.int32), rcfg,
                                 encoder_feats=jnp.zeros((1, 4, cfg.d_model)))
    close(logits_pum, r_pum)

    # the integer stage alone, on activations that hit the grid's ends,
    # its rounding ties and zero
    up = np.random.default_rng(3).normal(size=(3, 5, 64)).astype(np.float32)
    up[0, 0, :8] = [-3.0, 3.0, 0.0, -0.0, 0.125, -0.125, 1.0 / 128, 1e-9]
    scale = np.float32(1 << 6)
    q = np.clip(np.round(up * scale), -128, 127).astype(np.int32) & 0xFF
    want = np.asarray(ref_bitplane.bbop("relu", 8, jnp.asarray(q.reshape(-1)),
                                        signed_out=True)).reshape(up.shape)
    got = relu_stage(torch.from_numpy(up), 8)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_entry_points_on_the_cpu_and_without_a_card(small_model,
                                                    monkeypatch):
    """``init_lm``, ``init_caches``, ``Server`` and ``PumServeOffload``
    build on the CPU when asked, and a server refuses params that live
    elsewhere; with no card the default ``"cuda"`` raises."""
    _, _, cfg, model = small_model
    tree = init_lm(cfg, device=CPU)
    assert tree["embed"]["emb"].device.type == "cpu"
    Server(cfg, tree, batch_slots=1, max_len=8, device=CPU)
    PumServeOffload(device=CPU)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (lambda: init_lm(cfg), lambda: init_caches(cfg, 1, 8),
               lambda: Server(cfg, model), lambda: PumServeOffload()):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn()
