"""What the partitioned program once refused, on the CPU, against the
JAX package's sharded jit: SSD heads, head dim or conv channels that do
not divide over ``model`` (:mod:`repro_torch.distributed.partition_ssm`),
and microbatch rows that do not divide over the data parts
(:mod:`repro_torch.distributed.partition_train`).

The reference side runs once, in a module-scoped subprocess with 8
forced host devices, over meshes built as
``jax.sharding.Mesh(devices.reshape(shape), ("data", "model"))`` (auto
axes), with smoke configs in float32 and ``ssm_chunk=4`` (the port's
``init_lm`` weights, handed to it as numpy in the same key paths).  The
reference's ``_fit`` leaves whole each dim that does not divide, and
GSPMD computes on that layout:

- (a) ``mamba2`` over (1, 3): smoke mamba2-370m, whose 8 SSD heads of 16
  divide 3 neither way (the SSD whole at every ``model`` rank) and whose
  144 conv channels split, an 8-token prefill;
- (b) ``hymba`` over (1, 3): smoke hymba-1.5b with ``ssm_state=10``
  (148 conv channels) and a window of 8, where the SSD, the conv and
  attention (4 query over 2 kv heads of 16) are all whole, a 16-token
  prefill past the window (the banded form);
- (c) ``hymba-p`` over (1, 8): hymba with ``d_model=48, n_heads=6,
  ssm_state=10``: 6 SSD heads of 16, which split their head dim over 8,
  and 116 conv channels, which stay whole (hymba-1.5b over 64 ranks
  does the same), a 12-token prefill (past the window by a part of
  one: the masked form);
- (d) two AdamW steps (``eps=1e-3``) on batches of 6 rows x 8 tokens in
  2 microbatches, 3 rows each: ``mamba2`` over (2, 3) (the SSD whole)
  and granite-moe-1b-a400m (``granite``, the grouped MoE: each
  microbatch's uneven rows gathered over ``data`` and their cotangents
  reduce-scattered back in the parts' sizes) over (2, 2), 2 rows to
  data part 0 and 1 to part 1; and ``mamba2`` over (4, 2), where the
  batch's 6 rows do not divide 4 either (the batch held whole; shares
  of 1, 1, 1 and 0 rows); label masks that differ by microbatch;
- (e) a batch of 6 rows in 4 microbatches, which the reference's
  reshape refuses.

For (a)-(c) the port's partitioned prefill and decode (decode from
seeded caches at positions past the window): logits and every written
cache shard; for (d) loss, grad_norm, lr and every leaf of params,
``mu`` and ``nu`` under ``remat`` ``"none"`` and ``"dots"``, each within
rtol = atol = 1e-5 of the reference's sharded jit and of the port's
unpartitioned step.  (e) raises in both packages.  One planted fault a
case reads above 1e-5.
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
from repro_torch.distributed import (partition, partition_ssm,
                                     partition_train)
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import Mesh
from repro_torch.models.params import flatten, tree_map, unflatten
from repro_torch.models.transformer import init_caches, init_lm
from repro_torch.train import optimizer as opt
from repro_torch.train.serve import make_prefill, make_serve_step
from repro_torch.train.train_loop import make_train_step

SRC = Path(__file__).resolve().parents[1] / "src"
CPU = torch.device("cpu")
TOL = dict(rtol=1e-5, atol=1e-5)
OPT_KW = dict(lr=1e-3, eps=1e-3, warmup_steps=2, total_steps=40)
CONFIGS = {
    "mamba2": {"arch": "mamba2-370m", "prefill": 8, "replace": {}},
    "hymba": {"arch": "hymba-1.5b", "prefill": 16,
              "replace": {"ssm_state": 10, "sliding_window": 8}},
    "hymba-p": {"arch": "hymba-1.5b", "prefill": 12,
                "replace": {"d_model": 48, "n_heads": 6, "ssm_state": 10,
                            "sliding_window": 8}},
    "granite": {"arch": "granite-moe-1b-a400m", "replace": {}},
}
SERVE = {"mamba2": [1, 3], "hymba": [1, 3], "hymba-p": [1, 8]}
TRAIN = {"mamba2|2x3": [2, 3], "granite|2x2": [2, 2], "mamba2|4x2": [4, 2]}
ARGS = {"batch": 6, "serve_batch": 4, "cache": 32, "seed": 0, "steps": 2,
        "micro": 2, "train_len": 8, "chunk": 4, "opt": OPT_KW,
        "configs": CONFIGS, "serve": SERVE, "train": TRAIN,
        "refused_micro": 4}

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
    b, sb, s, seed = (args["batch"], args["serve_batch"], args["cache"],
                      args["seed"])
    ocfg = opt.AdamWConfig(**args["opt"])
    saved, errors, raised = {}, {}, {}
    weights = dict(np.load(os.path.join(out_dir, "weights.npz")))


    def params_of(name):
        # the port's weights: "name|key/key/..." entries as nested dicts
        tree = {}
        for key, value in weights.items():
            owner, path = key.split("|")
            if owner == name:
                *up, last = path.split("/")
                node = tree
                for k in up:
                    node = node.setdefault(k, {})
                node[last] = jnp.asarray(value)
        return tree


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


    cfgs, params = {}, {}
    for name, case in args["configs"].items():
        cfg = cfgs[name] = smoke_config(case["arch"]).replace(
            param_dtype="float32", ssm_chunk=args["chunk"], **case["replace"])
        params[name] = params_of(name)
        if name not in args["serve"]:
            continue
        rng = np.random.default_rng(seed)
        tokens = rng.integers(0, cfg.vocab_size,
                              (sb, case["prefill"])).astype(np.int32)
        caches = jax.tree.map(
            lambda x: rng.standard_normal(x.shape).astype(np.float32),
            jax.eval_shape(lambda: tf.init_caches(cfg, sb, s)))
        token = rng.integers(0, cfg.vocab_size, (sb,)).astype(np.int32)
        pos = rng.integers(case["prefill"], 3 * s, (sb,)).astype(np.int32)
        saved[f"{name}|in|tokens"], saved[f"{name}|in|token"] = tokens, token
        saved[f"{name}|in|pos"] = pos
        keep(f"{name}|in|caches", caches)
        mesh = mesh_of(args["serve"][name])
        ps = shd.param_shardings(params[name], mesh)
        cs = shd.cache_shardings(caches, mesh)
        vec = shd.vector_sharding(mesh, sb)
        lsh = shd.logits_sharding(mesh, sb)
        try:
            with mesh:
                saved[f"{name}|prefill"] = np.asarray(jax.jit(
                    make_prefill(cfg),
                    in_shardings=(ps, shd.batch_shardings(
                        {"t": tokens}, mesh)["t"]),
                    out_shardings=lsh)(params[name], tokens))
                logits, new = jax.jit(
                    make_serve_step(cfg), in_shardings=(ps, cs, vec, vec),
                    out_shardings=(lsh, cs))(params[name], caches, token, pos)
            saved[f"{name}|decode"] = np.asarray(logits)
            keep(f"{name}|caches", new)
        except Exception as e:  # recorded; the test says so
            errors[name] = f"{type(e).__name__}: {e}"

    for tag, sizes in args["train"].items():
        name = tag.split("|")[0]
        cfg = cfgs[name]
        batches = [batch_of(cfg, args["train_len"], st)
                   for st in range(args["steps"])]
        for st, bt in enumerate(batches):
            for k, v in bt.items():
                saved[f"{tag}|batch{st}|{k}"] = v
        mesh = mesh_of(sizes)
        ps = shd.param_shardings(params[name], mesh)
        state = opt.init(params[name])
        os_ = shd.opt_shardings(state, params[name], mesh)
        tbs = shd.batch_shardings(batches[0], mesh)
        step = make_train_step(cfg, ocfg, n_microbatches=args["micro"])
        try:
            with mesh:
                fn = jax.jit(step, in_shardings=(ps, os_, tbs),
                             out_shardings=(ps, os_, None))
                p = jax.device_put(params[name], ps)
                o = jax.device_put(state, os_)
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

    # (e) 6 rows in 4 microbatches: the reference's reshape refuses
    cfg = cfgs["mamba2"]
    step = make_train_step(cfg, ocfg, n_microbatches=args["refused_micro"])
    try:
        jax.eval_shape(step, params["mamba2"], opt.init(params["mamba2"]),
                       batch_of(cfg, args["train_len"], 0))
        raised["refused"] = None
    except Exception as e:
        raised["refused"] = f"{type(e).__name__}: {e}"
    np.savez(os.path.join(out_dir, "ref.npz"), **saved)
    with open(os.path.join(out_dir, "errors.json"), "w") as f:
        json.dump({"errors": errors, "raised": raised}, f)
""")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread for the module's many small ops a position (see
    ``tests/test_torch_partition_train.py``); restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(name):
    case = CONFIGS[name]
    return smoke_config(case["arch"]).replace(
        param_dtype="float32", ssm_chunk=ARGS["chunk"], **case["replace"])


def _paths(tree, pre=""):
    """(key path joined by "/", leaf) of a params tree."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], f"{pre}/{k}" if pre else k)
    else:
        yield pre, tree


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The port's weights of every config (``init_lm`` from a seeded
    generator) and the reference's results on them."""
    d = tmp_path_factory.mktemp("partition_uneven_ref")
    params = {name: init_lm(_cfg(name), generator=torch.Generator()
                            .manual_seed(ARGS["seed"]), device="cpu")
              for name in CONFIGS}
    np.savez(d / "weights.npz", **{
        f"{name}|{path}": leaf.numpy() for name, tree in params.items()
        for path, leaf in _paths(tree)})
    env = {**os.environ, "PYTHONPATH": str(SRC), "JAX_PLATFORMS": "cpu"}
    run = subprocess.run([sys.executable, "-c", _REF, str(d),
                          json.dumps(ARGS)],
                         capture_output=True, text=True, env=env, timeout=900)
    assert run.returncode == 0, run.stdout + run.stderr
    with np.load(d / "ref.npz") as z:
        arrays = dict(z)
    return {"arrays": arrays, "params": params,
            **json.loads((d / "errors.json").read_text())}


def test_reference_sharded_jit_runs(ref):
    """The installed JAX runs every sharded prefill, decode and train jit
    of the reference side."""
    assert ref["errors"] == {}


def cpu_mesh(sizes) -> Mesh:
    return Mesh(sizes, ("data", "model"), [CPU] * int(np.prod(sizes)))


def _tree(ref, tag, like):
    """The reference's leaves ``tag|0, tag|1, ...`` as tensors in
    ``like``'s structure."""
    a = ref["arrays"]
    return unflatten(like, [torch.from_numpy(a[f"{tag}|{i}"].copy())
                            for i in range(len(flatten(like)))])


def _inputs(ref, name):
    """The weights and the reference's serving inputs of config
    ``name``."""
    a = ref["arrays"]
    cfg = _cfg(name)
    params = ref["params"][name]
    if name not in SERVE:
        return cfg, params, None, None, None, None
    caches = _tree(ref, f"{name}|in|caches", init_caches(
        cfg, ARGS["serve_batch"], ARGS["cache"], device="meta"))

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


def test_layouts_the_cases_take():
    """What the cases exercise, as ``cache_shardings`` lays the state
    out: (a) the SSD whole, the conv split; (b) the SSD, the conv and
    attention whole; (c) the SSD by ``P``, the conv whole."""
    from repro_torch.distributed.partition_train import attention_mode
    got = {n: (partition_ssm.ssm_mode(_cfg(n), SERVE[n][1]),
               partition_ssm.conv_split(_cfg(n), SERVE[n][1]))
           for n in SERVE}
    assert got == {"mamba2": ("full", True), "hymba": ("full", False),
                   "hymba-p": ("p", False)}
    assert partition._attention_mode(_cfg("hymba"), 3, cache=True) == "full"
    assert attention_mode(_cfg("hymba"), 3) == "full"
    for name, want_ssm, want_conv in (
            ("mamba2", (None, "data", None, None, None),
             (None, "data", None, "model")),
            ("hymba-p", (None, "data", None, None, "model"),
             (None, "data", None, None))):
        cs = shd.cache_shardings(init_caches(_cfg(name), 4, 32, "meta"),
                                 cpu_mesh(SERVE[name]))
        assert tuple(cs["ssm"]["ssm"].spec) == want_ssm
        assert tuple(cs["ssm"]["conv"].spec) == want_conv
    assert partition_train.shares(3, 2) == [2, 1]
    assert partition_train.shares(3, 4) == [1, 1, 1, 0]


@pytest.mark.parametrize("name", list(SERVE))
def test_serving_equals_reference(ref, name):
    """Partitioned prefill and decode (from positions past the window):
    logits and every cache it wrote within 1e-5 of the reference's
    sharded jit and of the port's unpartitioned steps, each position's
    shard against its slice of the unpartitioned cache, in
    ``cache_shardings``' layout; the argument caches left as they
    were."""
    cfg, params, tokens, caches, token, pos = _inputs(ref, name)
    kept = _copy(caches)
    first, logits, new, cs = _serve(cfg, cpu_mesh(SERVE[name]), params,
                                    tokens, caches, token, pos)
    a = ref["arrays"]
    np.testing.assert_allclose(first.gather(CPU).numpy(),
                               a[f"{name}|prefill"], **TOL)
    np.testing.assert_allclose(first.gather(CPU).numpy(), make_prefill(cfg)(
        params, tokens).numpy(), **TOL)
    np.testing.assert_allclose(logits.gather(CPU).numpy(),
                               a[f"{name}|decode"], **TOL)
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
                                   a[f"{name}|caches|{i}"],
                                   err_msg=f"cache leaf {i}", **TOL)
        for idx, part in zip(leaf.sharding.indices(leaf.shape), leaf.shards):
            np.testing.assert_allclose(part.numpy(), whole[idx].numpy(),
                                       **TOL)
    for x, y in zip(flatten(caches), flatten(kept)):
        assert torch.equal(x, y)


# -- the train step ------------------------------------------------------------------

def _batches(ref, tag):
    a = ref["arrays"]
    return [{k: torch.from_numpy(a[f"{tag}|batch{s}|{k}"].copy())
             for k in ("tokens", "labels")} for s in range(ARGS["steps"])]


def _train(cfg, params, batches, mesh, remat="dots",
           n_mb=ARGS["micro"]):
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
@pytest.mark.parametrize("tag", list(TRAIN))
def test_train_equals_reference(ref, tag, remat):
    """Two partitioned train steps on 6-row batches in 2 microbatches of
    3 rows (uneven over 2 data parts; over 4, with the batch whole and
    one part taking none) within 1e-5 of the reference's sharded jit and
    of the port's unpartitioned step: loss, grad_norm, lr, and every
    leaf of params, ``mu`` and ``nu``."""
    name = tag.split("|")[0]
    cfg, params, _, _, _, _ = _inputs(ref, name)
    batches = _batches(ref, tag)
    got = _train(cfg, params, batches, cpu_mesh(TRAIN[tag]), remat)
    a = ref["arrays"]
    metrics = [{k: float(a[f"{tag}|m{s}|{k}"])
                for k in ("loss", "grad_norm", "lr")}
               for s in range(ARGS["steps"])]
    _held(got, (_tree(ref, f"{tag}|p", got[0]),
                _tree(ref, f"{tag}|mu", got[1].mu),
                _tree(ref, f"{tag}|nu", got[1].nu), metrics))
    p, o, m = _train(cfg, params, batches, None, remat)
    _held(got, (p, o.mu, o.nu, m))


def test_uneven_microbatches_refused_by_both(ref):
    """6 rows in 4 microbatches: the reference's reshape raises, and so
    does the port's partitioned step, a ``ValueError`` naming the
    shapes."""
    assert ref["raised"]["refused"] is not None
    cfg, params, _, _, _, _ = _inputs(ref, "mamba2")
    batches = _batches(ref, "mamba2|2x3")[:1]
    with pytest.raises(ValueError, match="6 rows does not split into 4"):
        _train(cfg, params, batches, cpu_mesh((2, 3)),
               n_mb=ARGS["refused_micro"])


# -- planted faults ------------------------------------------------------------------

def _rel(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


def _rel_mu(got, want) -> float:
    return max(_rel(x, y) for x, y in zip(flatten(got[1].mu),
                                          flatten(want[1].mu)))


def test_own_conv_slice_b_c_reads_above_tolerance(ref, monkeypatch):
    """(a) B and C taken from the last channels of each rank's own conv
    slice, not from the gathered ones (mamba2's decode over (1, 3), the
    SSD whole): the logits move past 1e-5."""
    cfg, params, tokens, caches, token, pos = _inputs(ref, "mamba2")
    want, _ = make_serve_step(cfg)(params, _copy(caches), token, pos)
    n, conv_dim = cfg.ssm_state, cfg.d_inner + 2 * cfg.ssm_state
    real = partition.all_gather

    def own_b_c(pos_, vals, axes, dim, copies=False):
        out = real(pos_, vals, axes, dim, copies)
        if dim == 2 and out[0].shape[-1] == conv_dim:
            out = [torch.cat([o[..., :-2 * n], v[..., -2 * n:]], dim=-1)
                   for o, v in zip(out, vals)]
        return out

    monkeypatch.setattr(partition, "all_gather", own_b_c)
    _, logits, _, _ = _serve(cfg, cpu_mesh(SERVE["mamba2"]), params, tokens,
                             caches, token, pos)
    assert _rel(logits.gather(CPU), want) > 1e-5


def test_whole_ssd_summed_over_model_reads_above_tolerance(ref,
                                                          monkeypatch):
    """(b) the whole SSD output all-reduced over ``model`` as if it were
    row-parallel partials (hymba's prefill over (1, 3), everything
    whole): the logits move past 1e-5."""
    cfg, params, tokens, caches, token, pos = _inputs(ref, "hymba")
    want = make_prefill(cfg)(params, tokens)
    real = partition_ssm.mixer

    def summed(prog, p, h, c):
        out, new = real(prog, p, h, c)
        return prog.model_sum(out), new

    monkeypatch.setattr(partition_ssm, "mixer", summed)
    got, _, _, _ = _serve(cfg, cpu_mesh(SERVE["hymba"]), params, tokens,
                          caches, token, pos)
    assert _rel(got.gather(CPU), want) > 1e-5


def test_rank_local_norm_reads_above_tolerance(ref, monkeypatch):
    """(c) the gated norm's mean square over each rank's own ``P``
    columns (hymba-p's prefill over (1, 8), the conv whole): the logits
    move past 1e-5."""
    cfg, params, tokens, caches, token, pos = _inputs(ref, "hymba-p")
    want = make_prefill(cfg)(params, tokens)
    monkeypatch.setattr(partition_ssm, "_mean_square", lambda prog, y: (
        prog.map(lambda t: torch.mean(torch.square(t.to(torch.float32)),
                                      dim=-1, keepdim=True), y)))
    got, _, _, _ = _serve(cfg, cpu_mesh(SERVE["hymba-p"]), params, tokens,
                          caches, token, pos)
    assert _rel(got.gather(CPU), want) > 1e-5


def test_per_position_loss_mean_reads_above_tolerance(ref, monkeypatch):
    """(d) each data position's loss over its own mask count, averaged
    over the positions, in place of the global sums' ratio (granite over
    (2, 2), 2 rows and 1 of each microbatch): the loss and ``mu`` move
    past 1e-5."""
    cfg, params, _, _, _, _ = _inputs(ref, "granite")
    batches = _batches(ref, "granite|2x2")[:1]
    mesh = cpu_mesh(TRAIN["granite|2x2"])
    want = _train(cfg, params, batches, mesh)
    real_xent, real_ar = (partition_train._TrainProgram.xent,
                          partition.all_reduce)

    def xent(self, logits, ax, labels):
        first = [True]

        def own_count(pos, vals, axes):
            if first[0] and tuple(axes) == tuple(self.bax):
                first[0] = False
                return [v * pos.size(axes) for v in vals]
            return real_ar(pos, vals, axes)

        partition.all_reduce = own_count
        try:
            return real_xent(self, logits, ax, labels)
        finally:
            partition.all_reduce = real_ar

    monkeypatch.setattr(partition_train._TrainProgram, "xent", xent)
    got = _train(cfg, params, batches, mesh)
    assert abs(got[2][0]["loss"] - want[2][0]["loss"]) > 1e-5
    assert _rel_mu(got, want) > 1e-5


def test_dropped_copies_transpose_reads_above_tolerance(ref, monkeypatch):
    """(d) the gathered conv channels' backward a reduce-scatter where
    the whole SSD after them is computed at every ``model`` rank
    (mamba2 over (2, 3)): the ranks' whole cotangents summed, ``mu``
    moves past 1e-5."""
    cfg, params, _, _, _, _ = _inputs(ref, "mamba2")
    batches = _batches(ref, "mamba2|2x3")[:1]
    mesh = cpu_mesh(TRAIN["mamba2|2x3"])
    want = _train(cfg, params, batches, mesh)
    real, hits = partition.all_gather, []
    conv_dim = cfg.d_inner + 2 * cfg.ssm_state

    def no_copies(pos, vals, axes, dim, copies=False):
        if dim == 2 and vals[0].shape[-1] * pos.size(axes) == conv_dim:
            hits.append(copies)
            copies = False
        return real(pos, vals, axes, dim, copies)

    monkeypatch.setattr(partition, "all_gather", no_copies)
    got = _train(cfg, params, batches, mesh)
    assert hits and all(hits)
    assert _rel_mu(got, want) > 1e-5
