"""The port's decode path, SSD, attention and param trees against the JAX
package, on the CPU.

The second half of the mirror of ``tests/test_models.py`` (the first is
``tests/test_torch_models.py``): the chunked SSD against its per-step
scan and the reference, decode against teacher-forced logits, the
sliding-window ring buffer, banded attention, the int8 KV cache, and
the param trees (``params_from_numpy``, ``LM``, ``init_lm``).  Each case
builds the params in the reference with ``jax.random`` and carries them
across; float32 within ``rtol = atol = 1e-3``, greedy tokens ``==``
wherever the reference's top-1/top-2 logit margin exceeds twice that,
int8 cache entries within 1.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import smoke_config as ref_smoke_config
from repro.models import attention as ref_attention
from repro.models import ssm as ref_ssm
from repro.models import transformer as ref_tf
from repro_torch.models.attention import _banded_sdpa, _sdpa
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import LM, params_from_numpy
from repro_torch.models.ssm import init_ssm_cache, ssd_chunked, ssm_forward
from repro_torch.models.transformer import (decode_step, init_caches, init_lm,
                                            lm_forward)

CPU = "cpu"
TOL = 1e-3          # float32, port against reference (CPU BLAS both)


def np32(x):
    """A torch or JAX array as float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def port_cfg(ref_cfg):
    """The port's copy of a reference config, field for field."""
    return ModelConfig(**dataclasses.asdict(ref_cfg))


def ref_model(rcfg, seed=0):
    """The reference's init of ``rcfg`` and the same weights in the port."""
    params = ref_tf.init_lm(jax.random.PRNGKey(seed), rcfg)
    return params, params_from_numpy(jax.tree.map(np.asarray, params), CPU)


def close(got, want, tol=TOL, what=""):
    np.testing.assert_allclose(np32(got), np32(want), rtol=tol, atol=tol,
                               err_msg=what)


def same_tokens_where_margin(got, want, tol=TOL):
    """Greedy tokens ``==`` at every position whose reference top-1/top-2
    margin exceeds ``2 * tol``; returns how many positions were held."""
    g, w = np32(got), np32(want)
    g, w = g.reshape(-1, g.shape[-1]), w.reshape(-1, w.shape[-1])
    top2 = np.sort(w, axis=-1)[:, -2:]
    held = (top2[:, 1] - top2[:, 0]) > 2 * tol
    np.testing.assert_array_equal(np.argmax(g, -1)[held],
                                  np.argmax(w, -1)[held])
    return int(held.sum())


def _ssm_sequential(p, x, cfg):
    """Naive per-step scan: the oracle for the chunked SSD."""
    c = init_ssm_cache(x.shape[0], cfg, x.dtype, CPU)
    outs = []
    for t in range(x.shape[1]):
        y, c = ssm_forward(p, x[:, t:t + 1, :], cfg, cache=c)
        outs.append(y)
    return torch.cat(outs, dim=1)


def test_ssd_chunked_equals_sequential():
    """The port's chunked SSD equals its own per-step scan (the reference
    test's tolerance); the mixer and ``ssd_chunked`` equal the
    reference's within 1e-3 on the same weights and inputs."""
    rcfg = ref_smoke_config("mamba2-370m").replace(
        n_layers=1, d_model=32, ssm_state=8, ssm_head_dim=8)
    cfg = port_cfg(rcfg)
    rp = ref_ssm.ssm_init(jax.random.PRNGKey(1), cfg.d_model, cfg.d_inner,
                          cfg.ssm_state, cfg.ssm_heads, cfg.ssm_conv,
                          jnp.float32)
    p = params_from_numpy(jax.tree.map(np.asarray, rp), CPU)
    x = np.array(jax.random.normal(jax.random.PRNGKey(2),
                                   (2, 16, cfg.d_model)) * 0.5)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        y_full, _ = ssm_forward(p, xt, cfg, chunk=8)
        y_seq = _ssm_sequential(p, xt, cfg)
    np.testing.assert_allclose(np32(y_full), np32(y_seq), rtol=2e-3,
                               atol=2e-3)
    r_full, _ = ref_ssm.ssm_forward(rp, jnp.asarray(x), rcfg, chunk=8)
    close(y_full, r_full)

    rng = np.random.default_rng(2)
    b, l, h, pd, n = 2, 32, 4, 8, 8
    xh = rng.normal(size=(b, l, h, pd)).astype(np.float32)
    bm = rng.normal(size=(b, l, n)).astype(np.float32)
    cm = rng.normal(size=(b, l, n)).astype(np.float32)
    dt = rng.uniform(0.01, 0.5, size=(b, l, h)).astype(np.float32)
    a_log = rng.normal(size=(h,)).astype(np.float32) * 0.1
    y, h_last = ssd_chunked(*(torch.from_numpy(a) for a in
                              (xh, bm, cm, dt, a_log)), chunk=8)
    ry, rh = ref_ssm.ssd_chunked(*(jnp.asarray(a) for a in
                                   (xh, bm, cm, dt, a_log)), chunk=8)
    close(y, ry)
    close(h_last, rh)


def test_decode_matches_prefill_logits():
    """Greedy decode step-by-step reproduces the teacher-forced logits
    (the reference test's 2e-4), and both equal the reference's."""
    rcfg = ref_smoke_config("yi-6b").replace(param_dtype="float32",
                                             n_layers=2)
    cfg = port_cfg(rcfg)
    params, model = ref_model(rcfg)
    b, l = 1, 8
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(3), (b, l), 0,
                                         cfg.vocab_size)).astype(np.int32)
    with torch.no_grad():
        full, _ = lm_forward(model, torch.from_numpy(toks), cfg,
                             remat="none")
        caches = init_caches(cfg, b, l + 1, CPU)
        steps = []
        for t in range(l):
            lg, caches = decode_step(model, caches,
                                     torch.from_numpy(toks[:, t]),
                                     torch.full((b,), t, dtype=torch.int32),
                                     cfg)
            steps.append(lg)
    steps = torch.stack(steps, dim=1)
    np.testing.assert_allclose(np32(steps), np32(full), rtol=2e-4, atol=2e-4)
    r_full, _ = ref_tf.lm_forward(params, jnp.asarray(toks), rcfg,
                                  remat="none")
    close(full, r_full)
    same_tokens_where_margin(steps, r_full)


def test_sliding_window_ring_buffer_decode():
    """Hymba-style windowed decode: positions beyond the window work, and
    each step's logits equal the reference's."""
    rcfg = ref_smoke_config("hymba-1.5b").replace(param_dtype="float32",
                                                  n_layers=1,
                                                  sliding_window=4)
    cfg = port_cfg(rcfg)
    params, model = ref_model(rcfg)
    b, steps = 1, 10
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(5), (b, steps),
                                         0, cfg.vocab_size)).astype(np.int32)
    caches = init_caches(cfg, b, steps, CPU)  # ring = window-sized
    assert caches["attn"]["k"].shape[2] == cfg.sliding_window
    r_caches = ref_tf.init_caches(rcfg, b, steps)
    for t in range(steps):
        pos = np.full((b,), t, np.int32)
        with torch.no_grad():
            lg, caches = decode_step(model, caches,
                                     torch.from_numpy(toks[:, t]),
                                     torch.from_numpy(pos), cfg)
        assert np.isfinite(np32(lg)).all(), t
        r_lg, r_caches = ref_tf.decode_step(params, r_caches,
                                            jnp.asarray(toks[:, t]),
                                            jnp.asarray(pos), rcfg)
        close(lg, r_lg, what=f"step {t}")
        same_tokens_where_margin(lg, r_lg)


def test_banded_sliding_window_equals_masked_full():
    """O(L·2W) banded attention == full masked attention, and both equal
    the reference's."""
    b, l, h, g, hd, w = 2, 32, 8, 4, 16, 8
    q = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (b, l, h, hd)))
    k = np.asarray(jax.random.normal(jax.random.PRNGKey(2), (b, l, g, hd)))
    v = np.asarray(jax.random.normal(jax.random.PRNGKey(3), (b, l, g, hd)))
    pos = np.arange(l)
    mask = ((pos[None, :, None] >= pos[None, None, :])
            & (pos[None, None, :] > pos[None, :, None] - w))
    mask = np.broadcast_to(mask, (b, l, l))
    scale = 1.0 / np.sqrt(hd)
    qt, kt, vt, mt = (torch.from_numpy(np.array(a))
                      for a in (q, k, v, mask))
    banded = _banded_sdpa(qt, kt, vt, w, scale)
    np.testing.assert_allclose(np32(banded), np32(_sdpa(qt, kt, vt, mt,
                                                        scale)),
                               rtol=2e-5, atol=2e-5)
    close(banded, ref_attention._banded_sdpa(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), w, scale))


def test_int8_kv_cache_matches_reference():
    """The int8 decode cache: entries within 1 and scales within 1e-3 of
    the reference's, and the logits within 1e-3, step by step."""
    rcfg = ref_smoke_config("yi-6b").replace(param_dtype="float32",
                                             kv_cache_dtype="int8")
    cfg = port_cfg(rcfg)
    params, model = ref_model(rcfg)
    b, steps = 2, 4
    toks = np.random.default_rng(4).integers(0, 256, (b, steps)).astype(
        np.int32)
    caches = init_caches(cfg, b, 8, CPU)
    assert caches["attn"]["k"].dtype == torch.int8
    r_caches = ref_tf.init_caches(rcfg, b, 8)
    for t in range(steps):
        pos = np.full((b,), t, np.int32)
        with torch.no_grad():
            lg, caches = decode_step(model, caches,
                                     torch.from_numpy(toks[:, t]),
                                     torch.from_numpy(pos), cfg)
        r_lg, r_caches = ref_tf.decode_step(params, r_caches,
                                            jnp.asarray(toks[:, t]),
                                            jnp.asarray(pos), rcfg)
        close(lg, r_lg, what=f"step {t}")
    for name in ("k", "v"):
        got = caches["attn"][name].numpy().astype(np.int64)
        want = np.asarray(r_caches["attn"][name]).astype(np.int64)
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 1, name
        close(caches["attn"][f"{name}_scale"],
              r_caches["attn"][f"{name}_scale"], what=f"{name}_scale")


def test_params_from_numpy_round_trips():
    """A reference tree (bf16, float32, int8 leaves, stacked layers)
    carried across keeps every key path, shape, dtype and value, and
    ``LM``'s state_dict holds the same tensors under the dotted paths."""
    from repro.models.quantized import quantize_tree
    rcfg = ref_smoke_config("granite-moe-1b-a400m")
    params = quantize_tree(ref_tf.init_lm(jax.random.PRNGKey(0), rcfg))
    ref_np = jax.tree.map(np.asarray, params)
    tree = params_from_numpy(ref_np, CPU)
    flat_ref = jax.tree_util.tree_flatten_with_path(ref_np)[0]
    sd = LM(tree).state_dict()
    assert len(sd) == len(flat_ref)
    for path, a in flat_ref:
        keys = [p.key for p in path]
        t = tree
        for k in keys:
            t = t[k]
        assert tuple(t.shape) == a.shape, keys
        assert str(t.dtype).split(".")[-1] == str(a.dtype), keys
        back = (t.view(torch.uint16).numpy().view(a.dtype)
                if t.dtype == torch.bfloat16 else t.numpy())
        np.testing.assert_array_equal(back, a)
        assert torch.equal(sd[".".join(keys)], t), keys
    assert LM(tree).tree().keys() == tree.keys()


def test_init_lm_is_seeded_and_distribution_equal():
    """The port's own init: one generator seed gives the same weights,
    the reference's key paths, shapes and dtypes (not its jax.random
    draws) and scales within 10 %; with no card the default device
    raises."""
    rcfg = ref_smoke_config("granite-moe-1b-a400m")
    cfg = port_cfg(rcfg)
    a = init_lm(cfg, generator=torch.Generator().manual_seed(7), device=CPU)
    b = init_lm(cfg, generator=torch.Generator().manual_seed(7), device=CPU)
    ref = jax.tree.map(np.asarray, ref_tf.init_lm(jax.random.PRNGKey(0),
                                                  rcfg))
    sa, sb = LM(a).state_dict(), LM(b).state_dict()
    sr = LM(params_from_numpy(ref, CPU)).state_dict()
    assert sorted(sa) == sorted(sr)
    for name, t in sa.items():
        assert torch.equal(t, sb[name]), name
        assert t.shape == sr[name].shape and t.dtype == sr[name].dtype, name
        if t.numel() >= 4096:
            std, rstd = t.float().std().item(), sr[name].float().std().item()
            assert abs(std - rstd) <= 0.1 * rstd, name
