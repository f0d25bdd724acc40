"""A train step's ``grad_transform``, a batch laid out outside the data
axes and ``moe_impl="ep"`` with the batch over other axes, partitioned
over a device mesh (:mod:`repro_torch.distributed.partition_train`), and
AdamW's update of a transform that returns a pair, on the CPU, against
the JAX package.

The reference side runs once, in a module-scoped subprocess with 8
forced host devices, over meshes built as
``jax.sharding.Mesh(devices.reshape(shape), ("data", "model"))`` (auto
axes, ROADMAP Queue 3), on smoke configs in float32 (the reference's
``init_lm`` weights, carried across with ``params_from_numpy``) and two
seeded numpy batches of 8 rows x 16 tokens, two train steps each:

- ``pair|none`` and ``pair|2x2``: smoke yi-6b with
  ``grad_transform=compressed_grad_transform(residuals)`` on seeded
  nonzero residuals, unsharded and over (2, 2).  The transform returns
  a pair ``(grads, new residuals)``: the reference's ``update`` takes
  the clip norm over both and steps on the first (its ``zip`` of the
  params' leaves with the pair's), and the new residuals are dropped;
- ``first|2x2``: the same with ``lambda g: t(g)[0]``;
- ``batch|2x2``: smoke yi-6b with every batch leaf replicated;
- ``ep|2x2``: smoke granite-moe-1b-a400m with ``moe_impl="ep"`` and the
  batch over ``("data", "model")``.

AdamW takes ``eps=1e-3`` (see ``tests/test_torch_train_step.py``) and
``lr=1e-4``: the transform rounds each gradient entry to a step of
1/127 of its block's amax, and gradients that differ in their last bits
(any two summation orders: JAX's and the port's, or a partitioned and
an unpartitioned step) round an entry that sits at a tie to either
neighbour.  On these seeds a handful of the 106,816 entries do (1 to 3
a leaf); at ``lr=1e-3`` such an entry moved its parameter by up to
1.7e-5, at ``1e-4`` it moves it by a tenth of that, under the 1e-5 the
params are held to.
``mu`` (which no ``lr`` scales) is held to 1e-5 too.

The port's steps: loss, aux, grad_norm, lr, params, ``mu`` and ``nu``
within rtol = atol = 1e-5 of the reference's (the unpartitioned port's
update of the pair included, which raised before it took the leaves in
``flatten`` order), and of the port's unpartitioned step.  The
transform sees each whole leaf, gathered and charged; three planted
faults read above 1e-5: the transform applied to each position's shard
(its 256-entry blocks are not the whole leaf's), the replicated batch
taken as each position's rows, and model rank 1's expert partial
dropped from ep's reduce-scatter.
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
from repro_torch.distributed import partition, partition_train
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import Mesh
from repro_torch.models.params import (flatten, params_from_numpy, tree_map,
                                       unflatten)
from repro_torch.models.transformer import init_lm
from repro_torch.train import optimizer as opt
from repro_torch.train.compression import compressed_grad_transform
from repro_torch.train.train_loop import make_train_step

SRC = Path(__file__).resolve().parents[1] / "src"
CPU = torch.device("cpu")
TOL = dict(rtol=1e-5, atol=1e-5)
OPT_KW = dict(lr=1e-4, eps=1e-3, warmup_steps=2, total_steps=40)
BATCH_OVER = {"batch": [], "ep": [("data", "model")]}
CASES = {
    "pair|none": {"arch": "yi-6b", "transform": "pair"},
    "pair|2x2": {"arch": "yi-6b", "transform": "pair", "mesh": [2, 2]},
    "first|2x2": {"arch": "yi-6b", "transform": "first", "mesh": [2, 2]},
    "batch|2x2": {"arch": "yi-6b", "mesh": [2, 2], "batch": "batch"},
    "ep|2x2": {"arch": "granite-moe-1b-a400m", "mesh": [2, 2], "batch": "ep",
               "replace": {"moe_impl": "ep"}},
}
ARGS = {"batch": 8, "seq": 16, "seed": 0, "steps": 2, "opt": OPT_KW,
        "cases": CASES, "batch_over": BATCH_OVER, "residual": 1e-3}

_REF = textwrap.dedent("""
    import contextlib, json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.configs import smoke_config
    from repro.distributed import sharding as shd
    from repro.models import transformer as tf
    from repro.train import optimizer as opt
    from repro.train.compression import compressed_grad_transform
    from repro.train.train_loop import make_train_step

    out_dir, args = sys.argv[1], json.loads(sys.argv[2])
    b, l, seed = args["batch"], args["seq"], args["seed"]
    ocfg = opt.AdamWConfig(**args["opt"])
    saved, errors = {}, {}

    for tag, case in args["cases"].items():
        cfg = smoke_config(case["arch"]).replace(
            param_dtype="float32", **case.get("replace", {}))
        params = tf.init_lm(jax.random.PRNGKey(seed), cfg)
        for i, leaf in enumerate(jax.tree.leaves(params)):
            saved[f"{tag}|w|{i}"] = np.asarray(leaf)
        rng = np.random.default_rng(seed + 1)
        res = jax.tree.map(lambda x: (args["residual"] * rng.standard_normal(
            x.shape)).astype(np.float32), params)
        for i, leaf in enumerate(jax.tree.leaves(res)):
            saved[f"{tag}|res|{i}"] = leaf
        batches = []
        for st in range(args["steps"]):
            r = np.random.default_rng(seed * 1000 + st)
            t = r.integers(0, cfg.vocab_size, (b, l)).astype(np.int32)
            lab = np.concatenate([t[:, 1:], np.full((b, 1), -1, np.int32)], 1)
            lab = np.where(r.random((b, l)) < 0.2, -1, lab).astype(np.int32)
            batches.append({"tokens": t, "labels": lab})
            saved[f"{tag}|batch{st}|tokens"] = t
            saved[f"{tag}|batch{st}|labels"] = lab
        t = compressed_grad_transform(res, "pod")
        transform = {"pair": t, "first": lambda g: t(g)[0]}.get(
            case.get("transform"))
        step = make_train_step(cfg, ocfg, grad_transform=transform)
        state = opt.init(params)
        try:
            if "mesh" not in case:
                fn, p, o = jax.jit(step), params, state
                ctx = contextlib.nullcontext()
            else:
                sizes = case["mesh"]
                mesh = jax.sharding.Mesh(np.array(jax.devices()[
                    :int(np.prod(sizes))]).reshape(sizes), ("data", "model"))
                ps = shd.param_shardings(params, mesh)
                os_ = shd.opt_shardings(state, params, mesh)
                bs = shd.batch_shardings(batches[0], mesh)
                if "batch" in case:
                    spec = P(*args["batch_over"][case["batch"]])
                    bs = {k: NamedSharding(mesh, spec) for k in bs}
                fn = jax.jit(step, in_shardings=(ps, os_, bs),
                             out_shardings=(ps, os_, None))
                p, o = jax.device_put(params, ps), jax.device_put(state, os_)
                ctx = mesh
            with ctx:
                for st, bt in enumerate(batches):
                    p, o, m = fn(p, o, {k: jnp.asarray(v)
                                        for k, v in bt.items()})
                    for k, v in m.items():
                        saved[f"{tag}|m{st}|{k}"] = np.asarray(v)
            for name, tree in (("p", p), ("mu", o.mu), ("nu", o.nu)):
                for i, leaf in enumerate(jax.tree.leaves(tree)):
                    saved[f"{tag}|{name}|{i}"] = np.asarray(leaf)
            saved[f"{tag}|step"] = np.asarray(o.step)
        except Exception as e:  # recorded; the test says so
            errors[tag] = f"{type(e).__name__}: {e}"
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
    d = tmp_path_factory.mktemp("partition_transform_ref")
    env = {**os.environ, "PYTHONPATH": str(SRC), "JAX_PLATFORMS": "cpu"}
    run = subprocess.run([sys.executable, "-c", _REF, str(d),
                          json.dumps(ARGS)],
                         capture_output=True, text=True, env=env, timeout=600)
    assert run.returncode == 0, run.stdout + run.stderr
    with np.load(d / "ref.npz") as z:
        arrays = dict(z)
    return {"arrays": arrays,
            "errors": json.loads((d / "errors.json").read_text())}


def test_reference_runs(ref):
    """The installed JAX runs every step of the reference side."""
    assert ref["errors"] == {}


def cpu_mesh(sizes) -> Mesh:
    return Mesh(sizes, ("data", "model"), [CPU] * int(np.prod(sizes)))


def _inputs(ref, tag):
    """Case ``tag``'s config, the reference's weights, residuals and
    batches as tensors."""
    a = ref["arrays"]
    case = CASES[tag]
    cfg = smoke_config(case["arch"]).replace(param_dtype="float32",
                                             **case.get("replace", {}))
    like = init_lm(cfg, device="meta")
    n = len(flatten(like))
    params = params_from_numpy(unflatten(like, [a[f"{tag}|w|{i}"]
                                                for i in range(n)]), CPU)
    res = params_from_numpy(unflatten(like, [a[f"{tag}|res|{i}"]
                                             for i in range(n)]), CPU)
    batches = [{k: torch.from_numpy(a[f"{tag}|batch{s}|{k}"].copy())
                for k in ("tokens", "labels")} for s in range(ARGS["steps"])]
    return cfg, params, res, batches


def _transform(kind, res):
    t = compressed_grad_transform(res)
    return {"pair": t, "first": lambda g: t(g)[0], None: None}[kind]


def _train(cfg, params, batches, mesh=None, transform=None, bs=None,
           ledger=None):
    """Params, state (whole) and each step's metrics after the batches'
    steps, partitioned over ``mesh`` (unpartitioned where it is None),
    the batch laid out by ``bs`` (default ``batch_shardings``'); the
    partitioned steps' collectives charged to ``ledger``."""
    step = make_train_step(cfg, opt.AdamWConfig(**OPT_KW),
                           grad_transform=transform)
    p, o = params, opt.init(params)
    if mesh is not None:
        ps = shd.param_shardings(params, mesh)
        os_ = shd.opt_shardings(o, params, mesh)
        step = partition.partitioned_step(
            step, (ps, os_, bs or shd.batch_shardings(batches[0], mesh)),
            (ps, os_, None))
        p, o = shd.place(p, ps), shd.place(o, os_)
    metrics = []
    for b in batches:
        with ledger or partition.CollectiveLedger():
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
        return unflatten(t, [torch.from_numpy(a[f"{tag}|{name}|{i}"])
                             for i in range(len(flatten(t)))])

    metrics = [{k: float(a[f"{tag}|m{s}|{k}"])
                for k in ("loss", "aux", "grad_norm", "lr")}
               for s in range(ARGS["steps"])]
    return tree("p", p), opt.OptState(torch.from_numpy(a[f"{tag}|step"]),
                                      tree("mu", o.mu), tree("nu", o.nu)), \
        metrics


def _rel_mu(got, want) -> float:
    return max(float((a - b).abs().max() / b.abs().max())
               for a, b in zip(flatten(got[1].mu), flatten(want[1].mu)))


# -- AdamW's update of a pair --------------------------------------------------------

def test_pair_update_equals_reference(ref):
    """The unpartitioned port's ``make_train_step`` with the raw
    ``compressed_grad_transform`` (a pair): two steps within 1e-5 of the
    reference's jitted step, whose clip norm counts the residuals and
    whose params step on the compressed gradients."""
    cfg, params, res, batches = _inputs(ref, "pair|none")
    got = _train(cfg, params, batches, transform=_transform("pair", res))
    _held(got, _reference(ref, "pair|none", got[:2]))
    # the new residuals (the rounding errors) add to the pair's norm
    first = _train(cfg, params, batches, transform=_transform("first", res))
    assert first[2][0]["grad_norm"] < got[2][0]["grad_norm"]


# -- the partitioned grad_transform ----------------------------------------------------

@pytest.mark.parametrize("kind", ["pair", "first"])
def test_transform_train_equals_reference(ref, kind):
    """Two partitioned train steps over (2, 2) with the compressed
    transform (its pair, or its first element) within 1e-5 of the
    reference's sharded jit and of the port's unpartitioned step."""
    tag = f"{kind}|2x2"
    cfg, params, res, batches = _inputs(ref, tag)
    t = _transform(kind, res)
    got = _train(cfg, params, batches, cpu_mesh((2, 2)), t)
    _held(got, _reference(ref, tag, got[:2]))
    _held(got, _train(cfg, params, batches, transform=t))


def test_transform_sees_whole_leaves(ref):
    """The transform gets every leaf whole (the params' shapes), at each
    of the 4 positions, and the gathers are charged: at least each leaf
    split over an axis, whole, more than the step without it."""
    cfg, params, res, batches = _inputs(ref, "pair|2x2")
    seen = []
    t = compressed_grad_transform(res)

    def spy(g):
        seen.append([x.shape for x in flatten(g)])
        return t(g)

    with_t, without = partition.CollectiveLedger(), \
        partition.CollectiveLedger()
    _train(cfg, params, batches[:1], cpu_mesh((2, 2)), spy, ledger=with_t)
    _train(cfg, params, batches[:1], cpu_mesh((2, 2)), ledger=without)
    assert seen == [[x.shape for x in flatten(params)]] * 4
    specs = flatten(shd.param_shardings(params, cpu_mesh((2, 2))))
    split = sum(x.numel() * 4 for x, s in zip(flatten(params), specs)
                if any(a is not None for a in s.spec))
    assert with_t.bytes["all-gather"] - without.bytes["all-gather"] >= split


def test_transform_per_shard_reads_above_tolerance(ref, monkeypatch):
    """The transform applied to each position's shard of the gradients
    (with the matching shard of the residuals), in place of the whole
    leaves: its 256-entry blocks are not the whole leaf's (a shard cut
    along any but the leading dim is no run of whole blocks), and
    ``mu`` moves past 1e-5."""
    cfg, params, res, batches = _inputs(ref, "pair|2x2")
    mesh = cpu_mesh((2, 2))
    want = _train(cfg, params, batches[:1], transform=_transform("pair", res))
    shardings = flatten(shd.param_shardings(params, mesh))

    def per_shard(pos, transform, like, grads):
        shape = tree_map(lambda d: None, like)
        outs = pos.map(lambda k, *gs: compressed_grad_transform(unflatten(
            shape, [r[s.indices(r.shape)[k]] for r, s in zip(
                flatten(res), shardings)]))(unflatten(shape, list(gs))),
            list(pos.ks), *(g.vals for g in grads))
        flat = [flatten(o) for o in outs]
        whole = [partition.relayout(pos, partition.Dist(
            g.shape, g.spec, [f[j] for f in flat]), *(None,) * len(g.shape))
            for j, g in enumerate(grads)]
        gnorm = pos.map(lambda *ws: opt.global_norm(ws), *(
            whole + [partition.relayout(pos, partition.Dist(
                g.shape, g.spec, [f[len(grads) + j] for f in flat]),
                *(None,) * len(g.shape)) for j, g in enumerate(grads)]))
        return [partition.Dist(g.shape, g.spec, [f[j] for f in flat])
                for j, g in enumerate(grads)], gnorm

    monkeypatch.setattr(partition_train, "transformed", per_shard)
    got = _train(cfg, params, batches[:1], mesh, _transform("pair", res))
    assert _rel_mu(got, want) > 1e-5


# -- batches and ep outside the data axes ------------------------------------------------

def _over(mesh, tag, batches):
    spec = shd.P(*BATCH_OVER[CASES[tag]["batch"]])
    return {k: shd.Sharding(mesh, spec) for k in batches[0]}


def test_replicated_batch_equals_reference(ref):
    """Every batch leaf replicated over (2, 2): relaid to the data axes
    (a cut, which moves nothing), two steps within 1e-5 of the
    reference's sharded jit given the same layout and of the port's
    unpartitioned step."""
    cfg, params, _, batches = _inputs(ref, "batch|2x2")
    mesh = cpu_mesh((2, 2))
    got = _train(cfg, params, batches, mesh, bs=_over(mesh, "batch|2x2",
                                                      batches))
    _held(got, _reference(ref, "batch|2x2", got[:2]))
    _held(got, _train(cfg, params, batches))


def test_replicated_batch_taken_as_rows_reads_above_tolerance(ref,
                                                              monkeypatch):
    """The replicated batch not relaid, each position taking the whole
    batch as its rows: ``mu`` moves past 1e-5."""
    cfg, params, _, batches = _inputs(ref, "batch|2x2")
    mesh = cpu_mesh((2, 2))
    want = _train(cfg, params, batches[:1])
    monkeypatch.setattr(partition_train, "_batch_axes",
                        lambda mesh, tokens: partition._axes(tokens.spec[0]))
    got = _train(cfg, params, batches[:1], mesh,
                 bs=_over(mesh, "batch|2x2", batches))
    assert _rel_mu(got, want) > 1e-5


def test_ep_batch_over_every_axis_equals_reference(ref):
    """granite-moe-1b-a400m with ``moe_impl="ep"`` and the batch over
    ``("data", "model")``: the rows relaid to ``data`` for the
    dispatch (the reference's ``shard_map`` ``in_specs``) and the ranks'
    partials reduce-scattered back; two steps within 1e-5 of the
    reference's sharded jit, and equal to the port's ep step with the
    batch over ``data``."""
    tag = "ep|2x2"
    cfg, params, _, batches = _inputs(ref, tag)
    mesh = cpu_mesh((2, 2))
    got = _train(cfg, params, batches, mesh, bs=_over(mesh, tag, batches))
    _held(got, _reference(ref, tag, got[:2]))
    _held(got, _train(cfg, params, batches, mesh))


def test_ep_dropped_partial_reads_above_tolerance(ref, monkeypatch):
    """Model rank 1's expert partial dropped from ep's first
    reduce-scatter over ``model`` (layer 0's, in the forward): ``mu``
    moves past 1e-5."""
    tag = "ep|2x2"
    cfg, params, _, batches = _inputs(ref, tag)
    mesh = cpu_mesh((2, 2))
    bs = _over(mesh, tag, batches)
    want = _train(cfg, params, batches[:1], mesh, bs=bs)
    real, calls = partition.reduce_scatter, []

    def dropped(pos, vals, axes, dim):
        calls.append(tuple(axes))
        if len(calls) == 1:
            vals = [torch.zeros_like(v) if pos.part(k, axes) == 1 else v
                    for k, v in zip(pos.ks, vals)]
        return real(pos, vals, axes, dim)

    monkeypatch.setattr(partition, "reduce_scatter", dropped)
    got = _train(cfg, params, batches[:1], mesh, bs=bs)
    assert calls[0] == ("model",)
    assert _rel_mu(got, want) > 1e-5
