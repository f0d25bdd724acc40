"""The port's model stack against the JAX package, on the CPU.

Mirrors ``tests/test_models.py``: the configs, every arch's forward and
decode, and the parameter counts here; the SSD, decode-against-prefill,
sliding-window, banded-attention and int8-cache cases, with the param
trees, in ``tests/test_torch_models_decode.py``.  Each case builds the
params in the reference with ``jax.random`` and carries them across with
``params_from_numpy``, then asks for: shapes and dtypes ``==``; float32
logits, aux losses and caches within ``rtol = atol = 1e-3``; greedy
tokens ``==`` wherever the reference's top-1/top-2 logit margin exceeds
twice that tolerance; int8 cache entries within 1.  ``param_count()``
is ``==`` the reference's for every arch at full size.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import get_config as ref_get_config
from repro.configs import smoke_config as ref_smoke_config
from repro.models import transformer as ref_tf
from repro_torch.configs import ARCHS, get_config, smoke_config
from repro_torch.models.config import SHAPES, ModelConfig
from repro_torch.models.params import LM, params_from_numpy
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


def stub_inputs(cfg, b, rng):
    """The enc-dec / VLM stub inputs (float32), for both packages."""
    kw = {}
    if cfg.is_encdec:
        kw["encoder_feats"] = rng.normal(size=(b, 8, cfg.d_model))
    if cfg.family == "vlm":
        kw["vision_embeds"] = rng.normal(size=(b, cfg.frontend_seq,
                                               cfg.d_model))
    kw = {k: v.astype(np.float32) for k, v in kw.items()}
    return ({k: jnp.asarray(v) for k, v in kw.items()},
            {k: torch.from_numpy(v) for k, v in kw.items()})


def cache_leaves(caches):
    """(name, array) of a cache tree in a fixed order."""
    return [(f"{kind}.{name}", caches[kind][name])
            for kind in sorted(caches) for name in sorted(caches[kind])]


def test_configs_are_the_references():
    assert list(ARCHS) == list(REF_ARCHS)
    for name in ARCHS:
        assert port_cfg(ref_get_config(name)) == get_config(name)
        assert port_cfg(ref_smoke_config(name)) == smoke_config(name)
        assert get_config(name).vocab_padded == \
            ref_get_config(name).vocab_padded
        assert get_config(name).hd == ref_get_config(name).hd
    assert [dataclasses.astuple(s) for s in SHAPES] == [
        dataclasses.astuple(s) for s in __import__(
            "repro.models.config", fromlist=["SHAPES"]).SHAPES]


@pytest.mark.parametrize("arch", sorted(REF_ARCHS))
def test_arch_smoke_forward_and_decode(arch):
    """Every arch at smoke_config in float32: the forward's logits and aux
    loss, and two decode steps' logits and caches, within 1e-3 of the
    reference on the same weights and inputs; greedy tokens under the
    margin rule."""
    b, l = 2, 16
    rng = np.random.default_rng(0)
    rcfg = ref_smoke_config(arch).replace(param_dtype="float32")
    cfg = port_cfg(rcfg)
    params, model = ref_model(rcfg)
    toks = rng.integers(0, cfg.vocab_size, (b, l)).astype(np.int32)
    rkw, pkw = stub_inputs(cfg, b, rng)
    r_logits, r_aux = ref_tf.lm_forward(params, jnp.asarray(toks), rcfg,
                                        **rkw)
    with torch.no_grad():
        logits, aux = lm_forward(model, torch.from_numpy(toks), cfg, **pkw)
    assert logits.shape == (b, l, cfg.vocab_padded) == r_logits.shape
    assert logits.dtype == torch.float32
    close(logits, r_logits, what="logits")
    close(aux, r_aux, what="aux")
    same_tokens_where_margin(logits, r_logits)

    r_caches = ref_tf.init_caches(rcfg, b, 32)
    caches = init_caches(cfg, b, 32, CPU)
    mem = rkw.get("encoder_feats")
    for t in range(2):
        pos = np.full(b, t, np.int32)
        r_lg, r_caches = ref_tf.decode_step(
            params, r_caches, jnp.asarray(toks[:, t]), jnp.asarray(pos),
            rcfg, memory=mem)
        with torch.no_grad():
            lg, caches = decode_step(
                model, caches, torch.from_numpy(toks[:, t]),
                torch.from_numpy(pos), cfg,
                memory=pkw.get("encoder_feats"))
        assert lg.shape == (b, cfg.vocab_padded)
        close(lg, r_lg, what=f"decode step {t}")
        same_tokens_where_margin(lg, r_lg)
    got, want = cache_leaves(caches), cache_leaves(r_caches)
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, g), (_, w) in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape), name
        assert str(g.dtype).split(".")[-1] == str(w.dtype), name
        close(g, w, what=name)


def test_param_counts_match_published():
    expect = {
        "granite-3-8b": 8.4e9, "yi-6b": 6.1e9, "qwen2-72b": 72.7e9,
        "phi3-medium-14b": 14.7e9, "mamba2-370m": 0.37e9,
        "arctic-480b": 477e9, "hymba-1.5b": 1.6e9,
    }
    for name, want in expect.items():
        got = get_config(name).param_count()
        assert abs(got - want) / want < 0.05, (name, got, want)


@pytest.mark.parametrize("arch", sorted(REF_ARCHS))
def test_param_count_equals_reference(arch):
    """``param_count()`` at full size, total and active, ``==`` the
    reference's; at smoke size it also counts the port's own init."""
    for active in (False, True):
        assert get_config(arch).param_count(active) == \
            ref_get_config(arch).param_count(active)
    cfg = smoke_config(arch)
    n = sum(t.numel() for t in LM(init_lm(cfg, device=CPU)).parameters())
    assert n == sum(x.size for x in jax.tree.leaves(
        ref_tf.init_lm(jax.random.PRNGKey(0), ref_smoke_config(arch))))


def test_moe_active_params():
    c = get_config("arctic-480b")
    active = c.param_count(active_only=True)
    assert active < 0.05 * c.param_count()
    assert 10e9 < active < 20e9  # ~17B claimed
