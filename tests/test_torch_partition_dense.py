"""The dense MoE (``moe_impl="dense"``) partitioned over a device mesh in
prefill, decode and the train step, and decode caches handed in another
layout than ``cache_shardings``' (:mod:`repro_torch.distributed.partition`,
:mod:`~repro_torch.distributed.partition_train`), on the CPU, against
the JAX package's sharded jit.

The reference side runs once, in a module-scoped subprocess with 8
forced host devices, over meshes built as
``jax.sharding.Mesh(devices.reshape(shape), ("data", "model"))`` (auto
axes, ROADMAP Queue 3), on smoke granite-moe-1b-a400m with
``moe_impl="dense"`` in float32 (the reference's ``init_lm`` weights,
carried across with ``params_from_numpy``; 4 experts, top 2), seeded
numpy tokens, caches, decode positions and train batches:

- prefill and decode over (2, 2), where the experts split over
  ``model``, and (1, 4), where they split one a rank;
- decode over (2, 2) with the caches handed replicated, and with their
  batch over ``model`` and their kv heads over ``data`` (the pieces of
  ``cache_shardings``' layout in shape, not in content), the new caches
  asked for in ``cache_shardings``' layout;
- two train steps over (2, 2) in one microbatch and over (1, 4) in two,
  AdamW with ``eps=1e-3`` (see ``tests/test_torch_train_step.py``).

The port's partitioned steps on CPU meshes of the same shapes: logits,
written caches, loss, aux, grad_norm, lr, params, ``mu`` and ``nu``
within rtol = atol = 1e-5 of the reference's sharded jit and of the
port's unpartitioned steps.  The dense dispatch gathers no rows (its
collectives ``==`` a closed form), a relaid cache's gathers are charged
(``==`` its bytes), and three planted faults read above 1e-5: model rank
1's expert partial dropped (decode and train), and caches relabelled
into ``cache_shardings``' layout without being relaid.
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
from repro_torch.models.params import flatten, params_from_numpy, unflatten
from repro_torch.models.transformer import init_lm
from repro_torch.train import optimizer as opt
from repro_torch.train.serve import make_prefill, make_serve_step
from repro_torch.train.train_loop import make_train_step

SRC = Path(__file__).resolve().parents[1] / "src"
CPU = torch.device("cpu")
TOL = dict(rtol=1e-5, atol=1e-5)
ARCH = "granite-moe-1b-a400m"
MESHES = {"2x2": [2, 2], "1x4": [1, 4]}
# the caches' layouts handed to decode over (2, 2), by name
CACHE_SPECS = {"replicated": [], "batch-over-model":
               [None, "model", None, "data", None]}
TRAIN = {"2x2|1": ("2x2", 1), "1x4|2": ("1x4", 2)}
OPT_KW = dict(lr=1e-3, eps=1e-3, warmup_steps=2, total_steps=40)
ARGS = {"arch": ARCH, "batch": 8, "seq": 16, "cache": 32, "seed": 0,
        "steps": 2, "meshes": MESHES, "cache_specs": CACHE_SPECS,
        "train": TRAIN, "opt": OPT_KW}

_REF = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.configs import smoke_config
    from repro.distributed import sharding as shd
    from repro.models import transformer as tf
    from repro.train import optimizer as opt
    from repro.train.serve import make_prefill, make_serve_step
    from repro.train.train_loop import make_train_step

    out_dir, args = sys.argv[1], json.loads(sys.argv[2])
    b, l, s, seed = args["batch"], args["seq"], args["cache"], args["seed"]
    saved, errors = {}, {}


    def mesh_of(sizes):
        n = int(np.prod(sizes))
        return jax.sharding.Mesh(np.array(jax.devices()[:n]).reshape(sizes),
                                 ("data", "model"))


    def attempt(tag, fn):
        try:
            fn()
        except Exception as e:  # recorded; the test says so
            errors[tag] = f"{type(e).__name__}: {e}"


    cfg = smoke_config(args["arch"]).replace(param_dtype="float32",
                                             moe_impl="dense")
    params = tf.init_lm(jax.random.PRNGKey(seed), cfg)
    for i, leaf in enumerate(jax.tree.leaves(params)):
        saved[f"w|{i}"] = np.asarray(leaf)
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (b, l)).astype(np.int32)
    caches = jax.tree.map(
        lambda x: rng.standard_normal(x.shape).astype(np.float32),
        jax.eval_shape(lambda: tf.init_caches(cfg, b, s)))
    token = rng.integers(0, cfg.vocab_size, (b,)).astype(np.int32)
    pos = rng.integers(l, s, (b,)).astype(np.int32)
    saved["in|tokens"], saved["in|token"], saved["in|pos"] = tokens, token, pos
    for k, v in caches["attn"].items():
        saved[f"in|cache_{k}"] = v
    prefill, serve = make_prefill(cfg), make_serve_step(cfg)


    def keep(tag, logits, new=None):
        saved[f"{tag}|logits"] = np.asarray(logits)
        for k, v in (new or {"attn": {}})["attn"].items():
            saved[f"{tag}|cache_{k}"] = np.asarray(v)


    keep("prefill|none", jax.jit(prefill)(params, tokens))
    keep("decode|none", *jax.jit(serve)(params, caches, token, pos))
    for mname, sizes in args["meshes"].items():
        mesh = mesh_of(sizes)
        ps = shd.param_shardings(params, mesh)
        bs = shd.batch_shardings({"tokens": tokens}, mesh)
        cs = shd.cache_shardings(caches, mesh)
        vec = shd.vector_sharding(mesh, b)
        lsh = shd.logits_sharding(mesh, b)

        def serving():
            with mesh:
                keep(f"prefill|{mname}", jax.jit(
                    prefill, in_shardings=(ps, bs["tokens"]),
                    out_shardings=lsh)(params, tokens))
                keep(f"decode|{mname}", *jax.jit(
                    serve, in_shardings=(ps, cs, vec, vec),
                    out_shardings=(lsh, cs))(params, caches, token, pos))
                if mname != "2x2":
                    return
                for name, spec in args["cache_specs"].items():
                    given = {"attn": {k: NamedSharding(mesh, P(*spec))
                                      for k in caches["attn"]}}
                    keep(f"relaid|{name}", *jax.jit(
                        serve, in_shardings=(ps, given, vec, vec),
                        out_shardings=(lsh, cs))(params, caches, token, pos))

        attempt(f"serve|{mname}", serving)

    ocfg = opt.AdamWConfig(**args["opt"])
    batches = []
    for st in range(args["steps"]):
        r = np.random.default_rng(seed * 1000 + st)
        t = r.integers(0, cfg.vocab_size, (b, l)).astype(np.int32)
        lab = np.concatenate([t[:, 1:], np.full((b, 1), -1, np.int32)], 1)
        lab = np.where(r.random((b, l)) < 0.2, -1, lab).astype(np.int32)
        batches.append({"tokens": t, "labels": lab})
        saved[f"batch{st}|tokens"], saved[f"batch{st}|labels"] = t, lab
    for tag, (mname, n_mb) in args["train"].items():
        def train():
            mesh = mesh_of(args["meshes"][mname])
            state = opt.init(params)
            ps = shd.param_shardings(params, mesh)
            os_ = shd.opt_shardings(state, params, mesh)
            bs = shd.batch_shardings(batches[0], mesh)
            step = make_train_step(cfg, ocfg, n_microbatches=n_mb)
            with mesh:
                fn = jax.jit(step, in_shardings=(ps, os_, bs),
                             out_shardings=(ps, os_, None))
                p, o = jax.device_put(params, ps), jax.device_put(state, os_)
                for st, bt in enumerate(batches):
                    p, o, m = fn(p, o, {k: jnp.asarray(v)
                                        for k, v in bt.items()})
                    for k, v in m.items():
                        saved[f"train|{tag}|m{st}|{k}"] = np.asarray(v)
            for name, t in (("p", p), ("mu", o.mu), ("nu", o.nu)):
                for i, leaf in enumerate(jax.tree.leaves(t)):
                    saved[f"train|{tag}|{name}|{i}"] = np.asarray(leaf)
            saved[f"train|{tag}|step"] = np.asarray(o.step)

        attempt(f"train|{tag}", train)
    np.savez(os.path.join(out_dir, "ref.npz"), **saved)
    with open(os.path.join(out_dir, "errors.json"), "w") as f:
        json.dump(errors, f)
""")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many small ops a position: one thread a worker (see
    ``tests/test_torch_partition_train.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("partition_dense_ref")
    env = {**os.environ, "PYTHONPATH": str(SRC), "JAX_PLATFORMS": "cpu"}
    run = subprocess.run([sys.executable, "-c", _REF, str(d),
                          json.dumps(ARGS)],
                         capture_output=True, text=True, env=env, timeout=600)
    assert run.returncode == 0, run.stdout + run.stderr
    with np.load(d / "ref.npz") as z:
        arrays = dict(z)
    return {"arrays": arrays,
            "errors": json.loads((d / "errors.json").read_text())}


def test_reference_sharded_jit_runs(ref):
    """The installed JAX runs every sharded jit of the reference side."""
    assert ref["errors"] == {}


def cpu_mesh(sizes) -> Mesh:
    return Mesh(sizes, ("data", "model"), [CPU] * int(np.prod(sizes)))


def _inputs(ref):
    """The config, the reference's weights and inputs as tensors."""
    a = ref["arrays"]
    cfg = smoke_config(ARCH).replace(param_dtype="float32", moe_impl="dense")
    like = init_lm(cfg, device="meta")
    params = params_from_numpy(unflatten(like, [
        a[f"w|{i}"] for i in range(len(flatten(like)))]), CPU)

    def get(k):
        return torch.from_numpy(a[f"in|{k}"].copy())

    caches = {"attn": {k: get(f"cache_{k}") for k in ("k", "v")}}
    return cfg, params, get("tokens"), caches, get("token"), get("pos")


def _fresh(caches):
    return {"attn": {k: v.clone() for k, v in caches["attn"].items()}}


def _decode(cfg, mesh, params, caches, token, pos, given=None):
    """The partitioned decode over ``mesh``, the caches placed by
    ``given`` (default ``cache_shardings``) and asked for in
    ``cache_shardings``' layout: (logits, new caches, the ledger)."""
    ps = shd.param_shardings(params, mesh)
    cs = shd.cache_shardings(caches, mesh)
    vec = shd.vector_sharding(mesh, ARGS["batch"])
    given = given or cs
    step = partition.partitioned_step(
        make_serve_step(cfg), (ps, given, vec, vec),
        (shd.logits_sharding(mesh, ARGS["batch"]), cs))
    with partition.CollectiveLedger() as ledger:
        logits, new = step(shd.place(params, ps), shd.place(caches, given),
                           shd.place(token, vec), shd.place(pos, vec))
    for leaf in new["attn"].values():
        assert leaf.sharding.spec == cs["attn"]["k"].spec
    return logits.gather(CPU), {k: v.gather(CPU)
                                for k, v in new["attn"].items()}, ledger


@pytest.mark.parametrize("mname", list(MESHES))
def test_dense_prefill_equals_reference(ref, mname):
    """The partitioned dense prefill within 1e-5 of the reference's
    sharded jit and of the port's unpartitioned prefill; it gathers no
    rows: its all-gathers are the weights' alone."""
    cfg, params, tokens, _, _, _ = _inputs(ref)
    mesh = cpu_mesh(MESHES[mname])
    ps = shd.param_shardings(params, mesh)
    bs = shd.batch_shardings({"tokens": tokens}, mesh)
    step = partition.partitioned_step(make_prefill(cfg), (ps, bs["tokens"]),
                                      shd.logits_sharding(mesh,
                                                          ARGS["batch"]))
    got = step(shd.place(params, ps), shd.place(tokens, bs["tokens"]))
    whole = got.gather(CPU).numpy()
    np.testing.assert_allclose(
        whole, ref["arrays"][f"prefill|{mname}|logits"], **TOL)
    np.testing.assert_allclose(
        whole, make_prefill(cfg)(params, tokens).numpy(), **TOL)


@pytest.mark.parametrize("mname", list(MESHES))
def test_dense_decode_equals_reference(ref, mname):
    """The partitioned dense decode: logits and written caches within
    1e-5 of the reference's sharded jit and of the port's unpartitioned
    step."""
    cfg, params, _, caches, token, pos = _inputs(ref)
    a = ref["arrays"]
    logits, new, _ = _decode(cfg, cpu_mesh(MESHES[mname]), params, caches,
                             token, pos)
    want, want_caches = make_serve_step(cfg)(params, _fresh(caches), token,
                                             pos)
    np.testing.assert_allclose(logits.numpy(), a[f"decode|{mname}|logits"],
                               **TOL)
    np.testing.assert_allclose(logits.numpy(), want.numpy(), **TOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(new[k].numpy(),
                                   a[f"decode|{mname}|cache_{k}"], **TOL)
        np.testing.assert_allclose(new[k].numpy(),
                                   want_caches["attn"][k].numpy(), **TOL)


def test_dense_decode_collectives_equal_closed_form(ref):
    """One dense decode over (2, 2) (4 experts, 2 a model rank; 4 query
    and 2 kv heads split by heads): all-gathers, the FSDP gathers of
    each layer's weights over ``data`` alone, each output the rank's
    model slice in float32 (q and o 64 x 32, k and v 64 x 16, the up,
    gate and down stacks 2 x 64 x 32; the embedding and the router are
    not split over ``data``); all-reduces, twice their float32 input:
    the embedding's lookup and, in each layer, attention's and the
    experts' row partials, (4, 1, 64) each.  No rows are gathered."""
    cfg, params, _, caches, token, pos = _inputs(ref)
    _, _, ledger = _decode(cfg, cpu_mesh((2, 2)), params, caches, token, pos)
    d, rows, layers, tp = cfg.d_model, ARGS["batch"] // 2, cfg.n_layers, 2
    attn = 2 * d * (cfg.n_heads + cfg.n_kv_heads) * cfg.hd // tp * 4
    experts = 3 * cfg.n_experts // tp * d * cfg.moe_d_ff * 4
    gathers = layers * (attn + experts)
    assert gathers == 2 * (24_576 + 49_152)
    reduces = 2 * (rows * d * 4 + layers * 2 * rows * d * 4)
    assert reduces == 10_240
    assert ledger.bytes["all-gather"] == gathers
    assert ledger.bytes["all-reduce"] == reduces
    assert ledger.totals()["total"] == gathers + reduces


@pytest.mark.parametrize("layout", list(CACHE_SPECS))
def test_relaid_caches_equal_reference(ref, layout):
    """Caches handed replicated, or with their batch over ``model`` and
    their kv heads over ``data``, over (2, 2): relaid to
    ``cache_shardings``' layout on entry, the logits and new caches
    (laid out as asked) within 1e-5 of the reference's sharded jit given
    the same layout and of the port's unpartitioned step.  The relayout
    is charged: a replicated cache is cut and moves nothing; the other
    gathers each of k and v over ``data`` (its heads: an output of half
    the cache) and then over ``model`` (its batch: the whole cache)."""
    cfg, params, _, caches, token, pos = _inputs(ref)
    mesh = cpu_mesh((2, 2))
    given = {"attn": {k: shd.Sharding(mesh, shd.P(*CACHE_SPECS[layout]))
                      for k in caches["attn"]}}
    logits, new, ledger = _decode(cfg, mesh, params, caches, token, pos,
                                  given)
    _, _, base = _decode(cfg, mesh, params, caches, token, pos)
    a = ref["arrays"]
    want, want_caches = make_serve_step(cfg)(params, _fresh(caches), token,
                                             pos)
    np.testing.assert_allclose(logits.numpy(), a[f"relaid|{layout}|logits"],
                               **TOL)
    np.testing.assert_allclose(logits.numpy(), want.numpy(), **TOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(new[k].numpy(),
                                   a[f"relaid|{layout}|cache_{k}"], **TOL)
        np.testing.assert_allclose(new[k].numpy(),
                                   want_caches["attn"][k].numpy(), **TOL)
    moved = 0 if layout == "replicated" else sum(
        v.numel() * v.element_size() * 3 // 2
        for v in caches["attn"].values())
    assert ledger.bytes["all-gather"] - base.bytes["all-gather"] == moved
    assert {k: v for k, v in ledger.bytes.items() if k != "all-gather"} == \
        {k: v for k, v in base.bytes.items() if k != "all-gather"}


# -- the train step ----------------------------------------------------------------

def _batches(ref):
    a = ref["arrays"]
    return [{k: torch.from_numpy(a[f"batch{s}|{k}"].copy())
             for k in ("tokens", "labels")} for s in range(ARGS["steps"])]


def _train(cfg, params, batches, mesh, n_mb):
    """Params, state (whole) and each step's metrics after the batches'
    steps, partitioned over ``mesh`` (unpartitioned where it is None)."""
    step = make_train_step(cfg, opt.AdamWConfig(**OPT_KW),
                           n_microbatches=n_mb)
    p, o = params, opt.init(params)
    if mesh is not None:
        ps = shd.param_shardings(params, mesh)
        os_ = shd.opt_shardings(o, params, mesh)
        step = partition.partitioned_step(
            step, (ps, os_, shd.batch_shardings(batches[0], mesh)),
            (ps, os_, None))
        p, o = shd.place(p, ps), shd.place(o, os_)
    metrics = []
    for b in batches:
        p, o, m = step(p, o, b)
        metrics.append({k: float(v) for k, v in m.items()})
    if mesh is not None:
        p, o = shd.gather(p, CPU), shd.gather(o, CPU)
    return p, o, metrics


def _held(got, want):
    """Each step's metrics, the step, every leaf of params, mu and nu
    within 1e-5."""
    p, o, metrics = got
    wp, wo, wmetrics = want
    for m, w in zip(metrics, wmetrics):
        for k in ("loss", "aux", "grad_norm", "lr"):
            np.testing.assert_allclose(m[k], w[k], err_msg=k, **TOL)
    assert int(o.step) == int(wo.step)
    for name, x, y in (("params", p, wp), ("mu", o.mu, wo.mu),
                       ("nu", o.nu, wo.nu)):
        for i, (g, w) in enumerate(zip(flatten(x), flatten(y))):
            np.testing.assert_allclose(g.numpy(), w.numpy(),
                                       err_msg=f"{name} leaf {i}", **TOL)


def _reference(ref, tag, like):
    a = ref["arrays"]
    p, o = like

    def tree(name, t):
        return unflatten(t, [torch.from_numpy(a[f"train|{tag}|{name}|{i}"])
                             for i in range(len(flatten(t)))])

    metrics = [{k: float(a[f"train|{tag}|m{s}|{k}"])
                for k in ("loss", "aux", "grad_norm", "lr")}
               for s in range(ARGS["steps"])]
    return tree("p", p), opt.OptState(
        torch.from_numpy(a[f"train|{tag}|step"]), tree("mu", o.mu),
        tree("nu", o.nu)), metrics


@pytest.mark.parametrize("tag", list(TRAIN))
def test_dense_train_equals_reference(ref, tag):
    """Two partitioned dense train steps (the gradient reaching the
    router through the combine weights and the global batch's aux)
    within 1e-5 of the reference's sharded jit and of the port's
    unpartitioned step: loss, aux, grad_norm, lr, params, mu, nu."""
    mname, n_mb = TRAIN[tag]
    cfg, params, _, _, _, _ = _inputs(ref)
    batches = _batches(ref)
    got = _train(cfg, params, batches, cpu_mesh(MESHES[mname]), n_mb)
    _held(got, _reference(ref, tag, got[:2]))
    _held(got, _train(cfg, params, batches, None, n_mb))


# -- planted faults ------------------------------------------------------------------

def _rel(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


def _drop_expert_partial(monkeypatch):
    """Model rank 1's partial dropped from every expert sum over
    ``model`` (the all-reduces :meth:`_Program.moe_dense` makes)."""
    real = partition._Program.moe_dense
    inside = [False]

    def moe_dense(self, p, h, aux=False):
        inside[0] = True
        try:
            return real(self, p, h, aux)
        finally:
            inside[0] = False

    real_sum = partition._Program.model_sum

    def model_sum(self, vals):
        if inside[0]:
            vals = [torch.zeros_like(v) if self.rank(k) == 1 else v
                    for k, v in zip(self.pos.ks, vals)]
        return real_sum(self, vals)

    monkeypatch.setattr(partition._Program, "moe_dense", moe_dense)
    monkeypatch.setattr(partition._Program, "model_sum", model_sum)


def test_dropped_expert_partial_reads_above_tolerance(ref, monkeypatch):
    """Model rank 1's expert partial dropped: decode's logits and the
    train step's ``mu`` over (2, 2) move past 1e-5 of the unpartitioned
    steps'."""
    cfg, params, _, caches, token, pos = _inputs(ref)
    want, _ = make_serve_step(cfg)(params, _fresh(caches), token, pos)
    batches = _batches(ref)[:1]
    want_train = _train(cfg, params, batches, None, 1)
    _drop_expert_partial(monkeypatch)
    logits, _, _ = _decode(cfg, cpu_mesh((2, 2)), params, caches, token, pos)
    assert _rel(logits, want) > 1e-5
    got = _train(cfg, params, batches, cpu_mesh((2, 2)), 1)
    assert max(_rel(a, b) for a, b in zip(flatten(got[1].mu),
                                          flatten(want_train[1].mu))) > 1e-5


def test_caches_not_relaid_read_above_tolerance(ref, monkeypatch):
    """Caches with their batch over ``model`` and their kv heads over
    ``data`` relabelled as ``cache_shardings``' layout, their pieces
    not moved (each piece has the shape of that layout's): the logits
    move past 1e-5."""
    cfg, params, _, caches, token, pos = _inputs(ref)
    mesh = cpu_mesh((2, 2))
    monkeypatch.setattr(partition._Program, "relay_caches", lambda self, c: (
        partition.tree_map(lambda d, sh: partition.Dist(
            d.shape, partition._spec(sh.spec, len(d.shape)), d.vals), c,
            shd.cache_shardings(caches, mesh))))
    given = {"attn": {k: shd.Sharding(mesh, shd.P(
        *CACHE_SPECS["batch-over-model"])) for k in caches["attn"]}}
    logits, _, _ = _decode(cfg, mesh, params, caches, token, pos, given)
    want, _ = make_serve_step(cfg)(params, _fresh(caches), token, pos)
    assert _rel(logits, want) > 1e-5
