"""The SSM and hybrid mixers partitioned over a device mesh
(:mod:`repro_torch.distributed.partition_ssm`, and the sliding window of
:mod:`repro_torch.distributed.partition`), on the CPU, against the JAX
package's sharded jit.

The reference side runs once, in a module-scoped subprocess with 8
forced host devices, over meshes built as
``jax.sharding.Mesh(devices.reshape(shape), ("data", "model"))`` (auto
axes, ROADMAP Queue 3), with smoke configs in float32 and
``ssm_chunk=4`` (the reference's ``init_lm`` weights, carried across
with ``params_from_numpy``):

- ``mamba2``: smoke mamba2-370m (8 SSD heads of 16, state 8; 144 conv
  channels), a 16-token prefill (4 chunks);
- ``hymba``: smoke hymba-1.5b (4 query over 2 kv heads, window 16,
  beside 8 SSD heads), a 32-token prefill (past the window: the banded
  form);
- ``hymba-p``: hymba with ``d_model=48`` (6 SSD heads, which split
  their head dim ``P`` over 4 model ranks) and 6 query heads (which
  divide neither 4 ranks nor the 2 kv heads' ``head_dim`` split's
  cache, as hymba's 25 do at full width: attention splits ``head_dim``
  over 4), a 24-token prefill (past the window by a part of one: the
  masked form) and 32-token train steps (the banded form).

``jax.jit(make_prefill / make_serve_step / make_train_step, in_shardings
=..., out_shardings=...)`` over (1, 4), (2, 2) and (4, 2), on seeded
numpy tokens, caches (every leaf: kv, ``conv`` and ``ssm``) and decode
positions past the window (the ring has wrapped), and two AdamW steps
(``eps=1e-3``) on batches whose label masks differ by microbatch.

The port's partitioned steps on CPU meshes of the same shapes: logits,
every written cache shard, and the train step's loss, grad_norm,
params, ``mu`` and ``nu`` (under ``remat`` ``"none"`` and ``"dots"``)
within rtol = atol = 1e-5 of the reference's sharded jit and of the
port's unpartitioned step.  Also: each position's FLOPs at most 1.25 x
the unpartitioned step's share (mamba2 over (2, 2), prefill and train),
and three planted faults read above 1e-5.
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
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import smoke_config
from repro_torch.distributed import partition, partition_ssm
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import Mesh
from repro_torch.models.params import (flatten, params_from_numpy, tree_map,
                                       unflatten)
from repro_torch.models.transformer import init_caches, init_lm
from repro_torch.train import optimizer as opt
from repro_torch.train.serve import make_prefill, make_serve_step
from repro_torch.train.train_loop import make_train_step

SRC = Path(__file__).resolve().parents[1] / "src"
CPU = torch.device("cpu")
TOL = dict(rtol=1e-5, atol=1e-5)
OPT_KW = dict(lr=1e-3, eps=1e-3, warmup_steps=2, total_steps=40)
CONFIGS = {
    "mamba2": {"arch": "mamba2-370m", "prefill": 16, "train": 16},
    "hymba": {"arch": "hymba-1.5b", "prefill": 32, "train": 32},
    "hymba-p": {"arch": "hymba-1.5b", "prefill": 24, "train": 32,
                "replace": {"d_model": 48, "n_heads": 6}},
}
MESHES = {"1x4": [1, 4], "2x2": [2, 2], "4x2": [4, 2]}
MICRO = {"1x4": 1, "2x2": 2, "4x2": 2}
ARGS = {"batch": 8, "cache": 32, "seed": 0, "steps": 2, "chunk": 4,
        "opt": OPT_KW, "configs": CONFIGS, "meshes": MESHES, "micro": MICRO}

_REF = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs import smoke_config
    from repro.distributed import sharding as shd
    from repro.models import transformer as tf
    from repro.train import optimizer as opt
    from repro.train.serve import make_prefill, make_serve_step
    from repro.train.train_loop import make_train_step

    out_dir, args = sys.argv[1], json.loads(sys.argv[2])
    b, s, seed = args["batch"], args["cache"], args["seed"]
    ocfg = opt.AdamWConfig(**args["opt"])
    saved, errors = {}, {}


    def mesh_of(sizes):
        n = int(np.prod(sizes))
        return jax.sharding.Mesh(np.array(jax.devices()[:n]).reshape(sizes),
                                 ("data", "model"))


    def batch_of(cfg, l, step):
        rng = np.random.default_rng(seed * 1000 + step)
        toks = rng.integers(0, cfg.vocab_size, (b, l)).astype(np.int32)
        labels = np.concatenate([toks[:, 1:], np.full((b, 1), -1, np.int32)], 1)
        p = np.where(np.arange(b)[:, None] < b // 2, 0.1, 0.6)
        labels = np.where(rng.random((b, l)) < p, -1, labels).astype(np.int32)
        return {"tokens": toks, "labels": labels}


    def keep(tag, tree):
        for i, leaf in enumerate(jax.tree.leaves(tree)):
            saved[f"{tag}|{i}"] = np.asarray(leaf)


    for name, case in args["configs"].items():
        cfg = smoke_config(case["arch"]).replace(
            param_dtype="float32", ssm_chunk=args["chunk"],
            **case.get("replace", {}))
        params = tf.init_lm(jax.random.PRNGKey(seed), cfg)
        keep(f"{name}|w", params)
        rng = np.random.default_rng(seed)
        tokens = rng.integers(0, cfg.vocab_size, (b, case["prefill"])).astype(
            np.int32)
        caches = jax.tree.map(
            lambda x: rng.standard_normal(x.shape).astype(np.float32),
            jax.eval_shape(lambda: tf.init_caches(cfg, b, s)))
        token = rng.integers(0, cfg.vocab_size, (b,)).astype(np.int32)
        pos = rng.integers(case["prefill"], 3 * s, (b,)).astype(np.int32)
        saved[f"{name}|in|tokens"], saved[f"{name}|in|token"] = tokens, token
        saved[f"{name}|in|pos"] = pos
        keep(f"{name}|in|caches", caches)
        batches = [batch_of(cfg, case["train"], st)
                   for st in range(args["steps"])]
        for st, bt in enumerate(batches):
            for k, v in bt.items():
                saved[f"{name}|batch{st}|{k}"] = v
        prefill, serve = make_prefill(cfg), make_serve_step(cfg)
        for mname, sizes in args["meshes"].items():
            tag = f"{name}|{mname}"
            mesh = mesh_of(sizes)
            ps = shd.param_shardings(params, mesh)
            bs = shd.batch_shardings({"tokens": tokens}, mesh)
            cs = shd.cache_shardings(caches, mesh)
            vec = shd.vector_sharding(mesh, b)
            lsh = shd.logits_sharding(mesh, b)
            state = opt.init(params)
            os_ = shd.opt_shardings(state, params, mesh)
            tbs = shd.batch_shardings(batches[0], mesh)
            step = make_train_step(cfg, ocfg,
                                   n_microbatches=args["micro"][mname])
            try:
                with mesh:
                    saved[f"{tag}|prefill"] = np.asarray(jax.jit(
                        prefill, in_shardings=(ps, bs["tokens"]),
                        out_shardings=lsh)(params, tokens))
                    logits, new = jax.jit(
                        serve, in_shardings=(ps, cs, vec, vec),
                        out_shardings=(lsh, cs))(params, caches, token, pos)
                    saved[f"{tag}|decode"] = np.asarray(logits)
                    keep(f"{tag}|caches", new)
                    fn = jax.jit(step, in_shardings=(ps, os_, tbs),
                                 out_shardings=(ps, os_, None))
                    p, o = jax.device_put(params, ps), jax.device_put(state, os_)
                    for st, bt in enumerate(batches):
                        p, o, m = fn(p, o, {k: jnp.asarray(v)
                                            for k, v in bt.items()})
                        for k, v in m.items():
                            saved[f"{tag}|m{st}|{k}"] = np.asarray(v)
                keep(f"{tag}|p", p)
                keep(f"{tag}|mu", o.mu)
                keep(f"{tag}|nu", o.nu)
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
    d = tmp_path_factory.mktemp("partition_ssm_ref")
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
    """The installed JAX runs every sharded prefill, decode and train jit
    of the reference side."""
    assert ref["errors"] == {}


def cpu_mesh(sizes) -> Mesh:
    return Mesh(sizes, ("data", "model"), [CPU] * int(np.prod(sizes)))


def _cfg(name):
    case = CONFIGS[name]
    return smoke_config(case["arch"]).replace(
        param_dtype="float32", ssm_chunk=ARGS["chunk"],
        **case.get("replace", {}))


def _tree(ref, tag, like):
    """The reference's leaves ``tag|0, tag|1, ...`` as tensors in
    ``like``'s structure."""
    a = ref["arrays"]
    return unflatten(like, [a[f"{tag}|{i}"] for i in range(len(flatten(
        like)))]) if tag.endswith("|w") else unflatten(like, [
            torch.from_numpy(a[f"{tag}|{i}"].copy())
            for i in range(len(flatten(like)))])


def _inputs(ref, name):
    """The reference's weights and serving inputs of config ``name``."""
    a = ref["arrays"]
    cfg = _cfg(name)
    params = params_from_numpy(_tree(ref, f"{name}|w", init_lm(
        cfg, device="meta")), CPU)
    caches = _tree(ref, f"{name}|in|caches", init_caches(
        cfg, ARGS["batch"], ARGS["cache"], device="meta"))

    def get(k):
        return torch.from_numpy(a[f"{name}|in|{k}"].copy())

    return cfg, params, get("tokens"), caches, get("token"), get("pos")


def _copy(caches):
    return tree_map(torch.clone, caches)


def _serve(cfg, mesh, params, tokens, caches, token, pos):
    """The partitioned prefill's logits and decode's (logits, new
    caches), laid out by ``logits_sharding`` and ``cache_shardings``."""
    b = tokens.shape[0]
    ps = shd.param_shardings(params, mesh)
    bs = shd.batch_shardings({"tokens": tokens}, mesh)
    lsh = shd.logits_sharding(mesh, b)
    cs = shd.cache_shardings(caches, mesh)
    vec = shd.vector_sharding(mesh, b)
    placed = shd.place(params, ps)
    pre = partition.partitioned_step(make_prefill(cfg), (ps, bs["tokens"]),
                                     lsh)
    dec = partition.partitioned_step(make_serve_step(cfg),
                                     (ps, cs, vec, vec), (lsh, cs))
    first = pre(placed, shd.place(tokens, bs["tokens"]))
    logits, new = dec(placed, shd.place(caches, cs), shd.place(token, vec),
                      shd.place(pos, vec))
    return first, logits, new, cs


@pytest.mark.parametrize("mname", list(MESHES))
@pytest.mark.parametrize("name", list(CONFIGS))
def test_prefill_equals_reference(ref, name, mname):
    """Partitioned prefill logits within 1e-5 of the reference's sharded
    jit and of the port's unpartitioned prefill."""
    cfg, params, tokens, caches, token, pos = _inputs(ref, name)
    got, _, _, _ = _serve(cfg, cpu_mesh(MESHES[mname]), params, tokens,
                          caches, token, pos)
    whole = got.gather(CPU).numpy()
    np.testing.assert_allclose(
        whole, ref["arrays"][f"{name}|{mname}|prefill"], **TOL)
    np.testing.assert_allclose(whole, make_prefill(cfg)(params, tokens)
                               .numpy(), **TOL)


@pytest.mark.parametrize("mname", list(MESHES))
@pytest.mark.parametrize("name", list(CONFIGS))
def test_decode_equals_reference(ref, name, mname):
    """Partitioned decode from positions past the window: logits and
    every cache it wrote (kv ring, ``conv``, ``ssm``) within 1e-5 of the
    reference's sharded jit and of the port's unpartitioned step, each
    position's shard against its slice of the unpartitioned cache, in
    ``cache_shardings``' layout; the argument caches left as they
    were."""
    cfg, params, tokens, caches, token, pos = _inputs(ref, name)
    assert (pos >= cfg.sliding_window).all() or not cfg.sliding_window
    mesh = cpu_mesh(MESHES[mname])
    kept = _copy(caches)
    _, logits, new, cs = _serve(cfg, mesh, params, tokens, caches, token,
                                pos)
    a = ref["arrays"]
    np.testing.assert_allclose(logits.gather(CPU).numpy(),
                               a[f"{name}|{mname}|decode"], **TOL)
    want, want_caches = make_serve_step(cfg)(params, _copy(caches), token,
                                             pos)
    np.testing.assert_allclose(logits.gather(CPU).numpy(), want.numpy(),
                               **TOL)
    got = flatten(new)
    assert len(got) == len(flatten(caches))
    for i, (leaf, whole, sh) in enumerate(zip(got, flatten(want_caches),
                                              flatten(cs))):
        assert leaf.sharding.spec == sh.spec
        np.testing.assert_allclose(leaf.gather(CPU).numpy(),
                                   a[f"{name}|{mname}|caches|{i}"],
                                   err_msg=f"cache leaf {i}", **TOL)
        for idx, part in zip(leaf.sharding.indices(leaf.shape), leaf.shards):
            np.testing.assert_allclose(part.numpy(), whole[idx].numpy(),
                                       **TOL)
    for x, y in zip(flatten(caches), flatten(kept)):
        assert torch.equal(x, y)


def test_layouts_the_cases_take():
    """What the cases exercise: mamba2 splits its SSD by heads
    everywhere; hymba-p's 6 heads split ``P`` over 4 ranks; hymba's
    decode splits ``head_dim`` over 4 (2 kv heads), hymba-p's prefill
    too (6 query heads)."""
    from repro_torch.distributed.partition_train import attention_mode
    assert [partition_ssm.ssm_mode(_cfg(n), 4) for n in CONFIGS] == \
        ["heads", "heads", "p"]
    assert partition_ssm.ssm_mode(_cfg("hymba-p"), 2) == "heads"
    assert partition._attention_mode(_cfg("hymba"), 4) == "hd"
    assert attention_mode(_cfg("hymba"), 4) == "qheads"
    assert attention_mode(_cfg("hymba-p"), 4) == "hd"
    cs = shd.cache_shardings(init_caches(_cfg("hymba-p"), 8, 32, "meta"),
                             cpu_mesh((1, 4)))
    assert tuple(cs["ssm"]["ssm"].spec) == (None, "data", None, None,
                                            "model")
    assert tuple(cs["ssm"]["conv"].spec) == (None, "data", None, "model")


# -- the train step ------------------------------------------------------------------

def _batches(ref, name):
    a = ref["arrays"]
    return [{k: torch.from_numpy(a[f"{name}|batch{s}|{k}"].copy())
             for k in ("tokens", "labels")} for s in range(ARGS["steps"])]


def _train(cfg, params, batches, mesh, n_mb, remat):
    """Params, optimizer state (whole) and each step's metrics after the
    batches' steps, partitioned over ``mesh`` (unpartitioned where it is
    None)."""
    step = make_train_step(cfg, opt.AdamWConfig(**OPT_KW),
                           n_microbatches=n_mb, remat=remat)
    p, o = params, opt.init(params)
    if mesh is not None:
        ps = shd.param_shardings(params, mesh)
        os_ = shd.opt_shardings(o, params, mesh)
        bs = shd.batch_shardings(batches[0], mesh)
        step = partition.partitioned_step(step, (ps, os_, bs),
                                          (ps, os_, None))
        p, o = shd.place(params, ps), shd.place(o, os_)
    metrics = []
    for b in batches:
        p, o, m = step(p, o, b)
        metrics.append({k: float(v) for k, v in m.items()})
    if mesh is not None:
        p, o = shd.gather(p, CPU), shd.gather(o, CPU)
    return p, o, metrics


def _held(got, want):
    p, o, metrics = got
    wp, wmu, wnu, wmetrics = want
    for m, w in zip(metrics, wmetrics):
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(m[k], w[k], err_msg=k, **TOL)
    for what, a, b in (("params", p, wp), ("mu", o.mu, wmu),
                       ("nu", o.nu, wnu)):
        for i, (x, y) in enumerate(zip(flatten(a), flatten(b))):
            np.testing.assert_allclose(x.numpy(), y.numpy(),
                                       err_msg=f"{what} leaf {i}", **TOL)


@pytest.mark.parametrize("remat", ["none", "dots"])
@pytest.mark.parametrize("mname", list(MESHES))
@pytest.mark.parametrize("name", list(CONFIGS))
def test_train_equals_reference(ref, name, mname, remat):
    """Two partitioned train steps (2 microbatches over (2, 2) and
    (4, 2)) within 1e-5 of the reference's sharded jit and of the port's
    unpartitioned step: loss, grad_norm, lr, and every leaf of params,
    ``mu`` and ``nu``."""
    cfg, params, _, _, _, _ = _inputs(ref, name)
    batches = _batches(ref, name)
    n_mb = MICRO[mname]
    got = _train(cfg, params, batches, cpu_mesh(MESHES[mname]), n_mb, remat)
    tag, a = f"{name}|{mname}", ref["arrays"]
    metrics = [{k: float(a[f"{tag}|m{s}|{k}"])
                for k in ("loss", "grad_norm", "lr")}
               for s in range(ARGS["steps"])]
    _held(got, (_tree(ref, f"{tag}|p", got[0]),
                _tree(ref, f"{tag}|mu", got[1].mu),
                _tree(ref, f"{tag}|nu", got[1].nu), metrics))
    p, o, m = _train(cfg, params, batches, None, n_mb, remat)
    _held(got, (p, o.mu, o.nu, m))


# -- compute is split ----------------------------------------------------------------

@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_each_position_computes_its_share(kind):
    """mamba2 over (2, 2): each position's prefill, or train step with
    its backward and optimizer, traced alone on ``meta``, counts at most
    1.25 x the unpartitioned step's FLOPs over the 4 positions, the
    four counts equal."""
    cfg = _cfg("mamba2")
    mesh = Mesh((2, 2), ("data", "model"))
    params = init_lm(cfg, device="meta")
    b, l = ARGS["batch"], CONFIGS["mamba2"]["prefill"]
    tokens = torch.empty((b, l), dtype=torch.int32, device="meta")
    ps = shd.param_shardings(params, mesh)
    if kind == "prefill":
        fn = make_prefill(cfg)
        args = (params, tokens)
        step = partition.partitioned_step(
            fn, (ps, shd.batch_shardings({"t": tokens}, mesh)["t"]),
            shd.logits_sharding(mesh, b))
    else:
        fn = make_train_step(cfg, opt.AdamWConfig(**OPT_KW))
        state = opt.init(params)
        batch = {"tokens": tokens, "labels": tokens}
        args = (params, state, batch)
        step = partition.partitioned_step(fn, (
            ps, shd.opt_shardings(state, params, mesh),
            shd.batch_shardings(batch, mesh)), None)
    with FlopCounterMode(display=False) as fc:
        fn(*args)
    total = fc.get_total_flops()
    counts = []
    for k in range(mesh.size):
        local = step.local_arguments(*args)
        with FlopCounterMode(display=False) as fc:
            step.run_position(local, position=k)
        counts.append(fc.get_total_flops())
    assert len(set(counts)) == 1, counts
    assert 0 < counts[0] <= 1.25 * total / mesh.size, (counts, total)


# -- planted faults ------------------------------------------------------------------

def _rel(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


def _local_mean_square(prog, y):
    return prog.map(lambda t: torch.mean(torch.square(t.to(torch.float32)),
                                         dim=-1, keepdim=True), y)


def test_rank_local_norm_reads_above_tolerance(ref, monkeypatch):
    """The gated norm's mean square taken over each rank's own channels
    (mamba2's prefill over (2, 2)) moves the logits past 1e-5."""
    cfg, params, tokens, caches, token, pos = _inputs(ref, "mamba2")
    want = make_prefill(cfg)(params, tokens)
    monkeypatch.setattr(partition_ssm, "_mean_square", _local_mean_square)
    got, _, _, _ = _serve(cfg, cpu_mesh((2, 2)), params, tokens, caches,
                          token, pos)
    assert _rel(got.gather(CPU), want) > 1e-5


def test_own_conv_slice_b_c_reads_above_tolerance(ref, monkeypatch):
    """B and C taken from the last channels of each rank's own conv
    slice, not from the gathered ones (mamba2's decode over (2, 2)),
    move the logits past 1e-5."""
    cfg, params, tokens, caches, token, pos = _inputs(ref, "mamba2")
    want, _ = make_serve_step(cfg)(params, _copy(caches), token, pos)
    n, conv_dim = cfg.ssm_state, cfg.d_inner + 2 * cfg.ssm_state
    real, hits = partition.all_gather, []

    def own_b_c(pos_, vals, axes, dim, copies=False):
        out = real(pos_, vals, axes, dim, copies)
        if dim == 2 and out[0].shape[-1] == conv_dim:
            hits.append(dim)
            out = [torch.cat([o[..., :-2 * n], v[..., -2 * n:]], dim=-1)
                   for o, v in zip(out, vals)]
        return out

    monkeypatch.setattr(partition, "all_gather", own_b_c)
    _, logits, _, _ = _serve(cfg, cpu_mesh((2, 2)), params, tokens, caches,
                             token, pos)
    assert len(hits) == 2 * cfg.n_layers      # prefill's and decode's
    assert _rel(logits.gather(CPU), want) > 1e-5


def test_unwrapped_ring_slot_reads_above_tolerance(ref, monkeypatch):
    """hymba's decode over (1, 4) (``head_dim`` split) writing each new
    key and value at slot ``pos`` instead of ``pos % window``: past the
    window that slot lies outside the ring and, as the reference's
    ``where(slot == idx, new, cache)`` write does, nothing is written;
    the logits move past 1e-5."""
    cfg, params, tokens, caches, token, pos = _inputs(ref, "hymba")
    want, _ = make_serve_step(cfg)(params, _copy(caches), token, pos)

    def dropped_outside(cache, slot, new):
        at = torch.arange(cache.shape[1])[None, :] == slot[:, None]
        at = at.reshape(*at.shape, *([1] * (cache.dim() - 2)))
        cache.copy_(torch.where(at, new[:, None].to(cache.dtype), cache))

    monkeypatch.setattr(partition, "ring_slot", lambda cfg, t: t)
    monkeypatch.setattr(partition, "write_slot", dropped_outside)
    _, logits, _, _ = _serve(cfg, cpu_mesh((1, 4)), params, tokens, caches,
                             token, pos)
    assert _rel(logits.gather(CPU), want) > 1e-5
