"""int8 weights, int8 KV caches and padded kv heads partitioned over a
device mesh (:mod:`repro_torch.distributed.partition`), on the CPU,
against the JAX package's sharded jit.

The reference side runs once, in a module-scoped subprocess with 8
forced host devices, over meshes built as
``jax.sharding.Mesh(devices.reshape(shape), ("data", "model"))`` (auto
axes, ROADMAP Queue 3), with smoke configs in float32 (the reference's
``init_lm`` weights, and its ``quantize_tree`` of them, carried across
with ``params_from_numpy``), on seeded numpy tokens, caches and decode
positions:

- ``q-yi``, ``q-granite``: ``quantize_tree`` weights of smoke yi-6b and
  granite-moe-1b-a400m (its expert stacks too), prefill and decode over
  (1, 4) and (2, 2);
- ``kv8-yi``: ``kv_cache_dtype="int8"`` decode of smoke yi-6b over
  (2, 2), the cache split by kv heads;
- ``kv8-internvl``: the same for smoke internvl2-1b over (1, 4), whose 2
  kv heads do not divide 4 ranks: the cache splits ``head_dim``, and
  each fresh row's amax spans the ranks;
- ``pad-yi``: ``kv_head_pad=4`` decode of smoke yi-6b (4 query and 2 kv
  heads) over (1, 4): the padded cache splits by heads.

The port's partitioned steps on CPU meshes of the same shapes: logits
within rtol = atol = 1e-5 of the reference's sharded jit and of the
port's unpartitioned step; the written caches likewise, except int8
entries, within 1 (a rounding at .5 may go either way), the share that
differs stated, and scales within 1e-5; each position's cache shard
against its slice of the unpartitioned cache.  An int8 tree's gathers
move int8 weights and float32 scales.  Two planted faults read above
1e-5: a rank-local amax in the ``head_dim`` split, and a query head
reading the padded kv head next to its own.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.distributed import partition
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import Mesh
from repro_torch.models.params import (flatten, params_from_numpy, tree_map,
                                       unflatten)
from repro_torch.models.quantized import quantize_tree
from repro_torch.models.transformer import init_caches, init_lm
from repro_torch.train.serve import make_prefill, make_serve_step

SRC = Path(__file__).resolve().parents[1] / "src"
CPU = torch.device("cpu")
TOL = dict(rtol=1e-5, atol=1e-5)
MESHES = {"1x4": [1, 4], "2x2": [2, 2]}
CASES = {
    "q-yi": {"arch": "yi-6b", "quantize": True, "meshes": ["1x4", "2x2"]},
    "q-granite": {"arch": "granite-moe-1b-a400m", "quantize": True,
                  "meshes": ["1x4", "2x2"]},
    "kv8-yi": {"arch": "yi-6b", "replace": {"kv_cache_dtype": "int8"},
               "meshes": ["2x2"]},
    "kv8-internvl": {"arch": "internvl2-1b",
                     "replace": {"kv_cache_dtype": "int8"}, "meshes": ["1x4"]},
    "pad-yi": {"arch": "yi-6b", "replace": {"kv_head_pad": 4},
               "meshes": ["1x4"]},
}
ARGS = {"batch": 8, "seq": 16, "cache": 32, "seed": 0, "cases": CASES,
        "meshes": MESHES}
DECODES = [(n, m) for n, c in CASES.items() for m in c["meshes"]]
PREFILLS = [(n, m) for n, m in DECODES if CASES[n].get("quantize")]

_REF = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs import smoke_config
    from repro.distributed import sharding as shd
    from repro.models import transformer as tf
    from repro.models.quantized import quantize_tree
    from repro.train.serve import make_prefill, make_serve_step

    out_dir, args = sys.argv[1], json.loads(sys.argv[2])
    b, l, s, seed = args["batch"], args["seq"], args["cache"], args["seed"]
    saved, errors = {}, {}


    def mesh_of(sizes):
        n = int(np.prod(sizes))
        return jax.sharding.Mesh(np.array(jax.devices()[:n]).reshape(sizes),
                                 ("data", "model"))


    def keep(tag, tree):
        for i, leaf in enumerate(jax.tree.leaves(tree)):
            saved[f"{tag}|{i}"] = np.asarray(leaf)


    def fill(rng, x):
        if x.dtype == jnp.int8:
            return rng.integers(-127, 128, x.shape).astype(np.int8)
        if len(x.shape) == 4:              # an int8 cache's scales
            return (0.001 + 0.05 * rng.random(x.shape)).astype(np.float32)
        return rng.standard_normal(x.shape).astype(np.float32)


    for name, case in args["cases"].items():
        cfg = smoke_config(case["arch"]).replace(
            param_dtype="float32", **case.get("replace", {}))
        params = tf.init_lm(jax.random.PRNGKey(seed), cfg)
        if case.get("quantize"):
            params = quantize_tree(params)
        keep(f"{name}|w", params)
        rng = np.random.default_rng(seed)
        tokens = rng.integers(0, cfg.vocab_size, (b, l)).astype(np.int32)
        caches = jax.tree.map(lambda x: fill(rng, x), jax.eval_shape(
            lambda: tf.init_caches(cfg, b, s)))
        token = rng.integers(0, cfg.vocab_size, (b,)).astype(np.int32)
        pos = rng.integers(l, s, (b,)).astype(np.int32)
        saved[f"{name}|in|tokens"], saved[f"{name}|in|token"] = tokens, token
        saved[f"{name}|in|pos"] = pos
        keep(f"{name}|in|caches", caches)
        prefill, serve = make_prefill(cfg), make_serve_step(cfg)
        for mname in case["meshes"]:
            tag = f"{name}|{mname}"
            mesh = mesh_of(args["meshes"][mname])
            ps = shd.param_shardings(params, mesh)
            bs = shd.batch_shardings({"tokens": tokens}, mesh)
            cs = shd.cache_shardings(caches, mesh)
            vec = shd.vector_sharding(mesh, b)
            lsh = shd.logits_sharding(mesh, b)
            try:
                with mesh:
                    if case.get("quantize"):
                        saved[f"{tag}|prefill"] = np.asarray(jax.jit(
                            prefill, in_shardings=(ps, bs["tokens"]),
                            out_shardings=lsh)(params, tokens))
                    logits, new = jax.jit(
                        serve, in_shardings=(ps, cs, vec, vec),
                        out_shardings=(lsh, cs))(params, caches, token, pos)
                saved[f"{tag}|decode"] = np.asarray(logits)
                keep(f"{tag}|caches", new)
            except Exception as e:  # recorded; the test says so
                errors[tag] = f"{type(e).__name__}: {e}"
    np.savez(os.path.join(out_dir, "ref.npz"), **saved)
    with open(os.path.join(out_dir, "errors.json"), "w") as f:
        json.dump(errors, f)
""")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread for the module's many small ops a position (see
    ``tests/test_torch_partition_train.py``); restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("partition_int8_ref")
    env = {**os.environ, "PYTHONPATH": str(SRC), "JAX_PLATFORMS": "cpu"}
    run = subprocess.run([sys.executable, "-c", _REF, str(d),
                          json.dumps(ARGS)],
                         capture_output=True, text=True, env=env, timeout=900)
    assert run.returncode == 0, run.stdout + run.stderr
    with np.load(d / "ref.npz") as z:
        arrays = dict(z)
    return {"arrays": arrays,
            "errors": json.loads((d / "errors.json").read_text())}


def test_reference_sharded_jit_runs(ref):
    """The installed JAX runs every sharded prefill and decode jit of the
    reference side."""
    assert ref["errors"] == {}


def cpu_mesh(sizes) -> Mesh:
    return Mesh(sizes, ("data", "model"), [CPU] * int(np.prod(sizes)))


def _cfg(name):
    case = CASES[name]
    return smoke_config(case["arch"]).replace(param_dtype="float32",
                                              **case.get("replace", {}))


def _tree(ref, tag, like):
    a = ref["arrays"]
    return unflatten(like, [torch.from_numpy(a[f"{tag}|{i}"].copy())
                            for i in range(len(flatten(like)))])


def _inputs(ref, name):
    """The reference's weights (quantized where the case is) and serving
    inputs of case ``name``."""
    a = ref["arrays"]
    cfg = _cfg(name)
    like = init_lm(cfg, device="meta")
    if CASES[name].get("quantize"):
        like = quantize_tree(like)
    params = params_from_numpy(unflatten(like, [
        a[f"{name}|w|{i}"] for i in range(len(flatten(like)))]), CPU)
    caches = _tree(ref, f"{name}|in|caches", init_caches(
        cfg, ARGS["batch"], ARGS["cache"], device="meta"))

    def get(k):
        return torch.from_numpy(a[f"{name}|in|{k}"].copy())

    return cfg, params, get("tokens"), caches, get("token"), get("pos")


def _copy(caches):
    return tree_map(torch.clone, caches)


def _decode(cfg, mesh, params, caches, token, pos):
    b = token.shape[0]
    ps = shd.param_shardings(params, mesh)
    cs = shd.cache_shardings(caches, mesh)
    vec = shd.vector_sharding(mesh, b)
    dec = partition.partitioned_step(make_serve_step(cfg), (ps, cs, vec, vec),
                                     (shd.logits_sharding(mesh, b), cs))
    logits, new = dec(shd.place(params, ps), shd.place(caches, cs),
                      shd.place(token, vec), shd.place(pos, vec))
    return logits, new, cs


def _prefill(cfg, mesh, params, tokens):
    ps = shd.param_shardings(params, mesh)
    bs = shd.batch_shardings({"tokens": tokens}, mesh)
    pre = partition.partitioned_step(make_prefill(cfg), (ps, bs["tokens"]),
                                     shd.logits_sharding(mesh, tokens.shape[0]))
    return pre(shd.place(params, ps), shd.place(tokens, bs["tokens"]))


def _close(got: np.ndarray, want: np.ndarray, what: str) -> None:
    """int8 entries within 1 (the share that differs in the message),
    anything else within the tolerance."""
    if got.dtype == np.int8:
        diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
        assert diff.max() <= 1, (what, int(diff.max()),
                                 f"{float((diff > 0).mean()):.2e} differ")
    else:
        np.testing.assert_allclose(got, want, err_msg=what, **TOL)


@pytest.mark.parametrize("name,mname", PREFILLS)
def test_prefill_equals_reference(ref, name, mname):
    """Partitioned prefill of an int8 tree (its gathers moving int8 and
    its scales, each position dequantizing its pieces) within 1e-5 of the
    reference's sharded jit and of the port's unpartitioned prefill."""
    cfg, params, tokens, _, _, _ = _inputs(ref, name)
    got = _prefill(cfg, cpu_mesh(MESHES[mname]), params, tokens)
    whole = got.gather(CPU).numpy()
    np.testing.assert_allclose(whole, ref["arrays"][f"{name}|{mname}|prefill"],
                               **TOL)
    np.testing.assert_allclose(whole, make_prefill(cfg)(params, tokens)
                               .numpy(), **TOL)


@pytest.mark.parametrize("name,mname", DECODES)
def test_decode_equals_reference(ref, name, mname):
    """Partitioned decode: logits within 1e-5 of the reference's sharded
    jit and of the port's unpartitioned step; every written cache leaf
    (int8 entries within 1, scales and float entries within 1e-5) against
    both, each position's shard against its slice of the unpartitioned
    cache in ``cache_shardings``' layout (an int8 cache's scales laid out
    by the kv heads only); the argument caches left as they were."""
    cfg, params, _, caches, token, pos = _inputs(ref, name)
    kept = _copy(caches)
    logits, new, cs = _decode(cfg, cpu_mesh(MESHES[mname]), params, caches,
                              token, pos)
    a, tag = ref["arrays"], f"{name}|{mname}"
    np.testing.assert_allclose(logits.gather(CPU).numpy(), a[f"{tag}|decode"],
                               **TOL)
    want, want_caches = make_serve_step(cfg)(params, _copy(caches), token,
                                             pos)
    np.testing.assert_allclose(logits.gather(CPU).numpy(), want.numpy(),
                               **TOL)
    names = [f"{g}.{k}" for g in sorted(new) for k in sorted(new[g])]
    for i, (what, leaf, whole, sh) in enumerate(zip(
            names, flatten(new), flatten(want_caches), flatten(cs))):
        assert leaf.sharding.spec == sh.spec, what
        _close(leaf.gather(CPU).numpy(), a[f"{tag}|caches|{i}"], what)
        for idx, part in zip(leaf.sharding.indices(leaf.shape), leaf.shards):
            _close(part.numpy(), whole[idx].numpy(), what)
    for x, y in zip(flatten(caches), flatten(kept)):
        assert torch.equal(x, y)
    if cfg.kv_cache_dtype == "int8":
        assert new["attn"]["k"].dtype == torch.int8
        assert tuple(cs["attn"]["k_scale"].spec) == tuple(
            cs["attn"]["k"].spec)[:4]


def test_layouts_the_cases_take():
    """yi-6b's int8 cache over (2, 2) splits by kv heads, internvl2-1b's
    over (1, 4) ``head_dim``; yi-6b's padded cache (4 heads) splits by
    heads over 4 ranks, where its 2 kv heads alone would split
    ``head_dim``."""
    assert partition._attention_mode(_cfg("kv8-yi"), 2, cache=True) == "heads"
    assert partition._attention_mode(_cfg("kv8-internvl"), 4,
                                     cache=True) == "hd"
    pad = _cfg("pad-yi")
    assert partition._attention_mode(pad, 4, cache=True) == "heads"
    assert partition._attention_mode(pad, 4) == "hd"
    cs = shd.cache_shardings(init_caches(pad, 8, 32, "meta"), cpu_mesh((1, 4)))
    assert tuple(cs["attn"]["k"].spec) == (None, "data", None, "model", None)


def test_gathers_move_int8(ref):
    """Over (2, 2) the quantized yi-6b decode's all-gathers move int8
    ``w_q`` pieces and float32 per-channel scales only (no dequantized
    weight), and fewer bytes than the float32 tree's: int8 is a quarter
    of float32, and the scales add one float32 a column."""
    cfg, params, _, caches, token, pos = _inputs(ref, "q-yi")
    moved, real = [], partition.all_gather

    def seen(p, vals, axes, dim, copies=False):
        moved.append((vals[0].dtype, vals[0].dim()))
        return real(p, vals, axes, dim, copies)

    mesh = cpu_mesh((2, 2))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(partition, "all_gather", seen)
        with partition.CollectiveLedger() as quant:
            _decode(cfg, mesh, params, caches, token, pos)
    assert moved and set(moved) <= {(torch.int8, 2), (torch.float32, 1)}
    whole = init_lm(cfg, generator=torch.Generator().manual_seed(0),
                    device="cpu")
    with partition.CollectiveLedger() as plain:
        _decode(cfg, mesh, whole, caches, token, pos)
    assert quant.bytes["all-gather"] < 0.3 * plain.bytes["all-gather"]


# -- planted faults ------------------------------------------------------------------

def _rel(got, want) -> float:
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


def test_rank_local_amax_reads_above_tolerance(ref, monkeypatch):
    """internvl2-1b's int8 decode over (1, 4) with each rank quantizing
    its ``head_dim`` slice by its own amax (no max all-reduce): the
    written scales move past 1e-5 of the unpartitioned step's."""
    cfg, params, _, caches, token, pos = _inputs(ref, "kv8-internvl")
    _, want = make_serve_step(cfg)(params, _copy(caches), token, pos)
    monkeypatch.setattr(partition, "all_max", lambda p, vals, axes: vals)
    _, new, _ = _decode(cfg, cpu_mesh((1, 4)), params, caches, token, pos)
    assert _rel(new["attn"]["k_scale"].shards[0],
                want["attn"]["k_scale"]) > 1e-5


def test_neighbour_padded_head_reads_above_tolerance(ref, monkeypatch):
    """yi-6b's padded decode over (1, 4) with each rank's padded head
    filled from the padded head next to its own (``j + 1``): the logits
    move past 1e-5."""
    cfg, params, _, caches, token, pos = _inputs(ref, "pad-yi")
    want, _ = make_serve_step(cfg)(params, _copy(caches), token, pos)

    def neighbour(cfg, tp, rank, device):
        m = cfg.kv_head_pad // tp
        j = torch.arange(rank * m, (rank + 1) * m, device=device)
        return ((j + 1) % cfg.kv_head_pad) // (cfg.kv_head_pad
                                               // cfg.n_kv_heads)

    monkeypatch.setattr(partition, "padded_sources", neighbour)
    logits, _, _ = _decode(cfg, cpu_mesh((1, 4)), params, caches, token, pos)
    assert _rel(logits.gather(CPU), want) > 1e-5
