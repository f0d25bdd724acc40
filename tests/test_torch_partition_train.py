"""The train step partitioned over a device mesh
(:mod:`repro_torch.distributed.partition_train`), and the PuM MLP in the
partitioned block, on the CPU, against the JAX package's sharded jit.

The reference side runs once, in a module-scoped subprocess with 8
forced host devices: ``jax.jit(make_train_step(cfg, ocfg,
n_microbatches=...), in_shardings=(ps, os_, bs), out_shardings=(ps,
os_, None))`` for two steps, with the reference's own shardings over
meshes built as ``jax.sharding.Mesh(devices.reshape(shape), ("data",
"model"))`` (auto axes: under ``jax.make_mesh``'s explicit axes the
reference's train step raises ``ShardingTypeError`` in the embedding
gather, ROADMAP Queue 3), AdamW with ``eps=1e-3`` (see
``tests/test_torch_train_step.py``), on seeded numpy batches of 8 rows x
16 tokens whose label masks differ by microbatch (a tenth of the first
half's labels masked, six tenths of the second half's), and smoke
configs in float32 (the reference's ``init_lm`` weights, carried across
with ``params_from_numpy``):

- yi-6b (heads split) over (2, 2) in 2 microbatches and over (1, 4);
  internvl2-1b (vision embeddings; query heads split) over (1, 4) and
  (4, 2) in 2 microbatches, and over (1, 8), where its 4 query heads do
  not divide and attention splits ``head_dim``; granite-moe-1b-a400m (grouped MoE) over
  (2, 2) and (4, 2) in 2 microbatches; granite with ``moe_impl="ep"``
  over (2, 2); yi-6b with the PuM MLP (``act="relu", pum="bitplane"``)
  over (2, 2), whose sharded prefill and decode run there too.

The port's partitioned steps on CPU meshes of the same shapes, under
``remat`` ``"none"`` and ``"dots"``: loss, aux, grad_norm and lr of both
steps, the step, and every leaf of params, ``mu`` and ``nu`` within
rtol = atol = 1e-5 of the reference's sharded jit and of the port's
unpartitioned ``make_train_step``.  ``ep`` is held to the reference
only: its aux is data shard 0's, and its gradient is the one the
reference's ``jax.grad`` gives through ``out_specs=P()`` without a
replication check (the mean over the data shards' aux), not the grouped
step's.  Also: the PuM MLP's integer stage ``==`` on each shard, each
position's FLOPs at most 1.25 x the unpartitioned step's share, no
argument gathered, the backward's collectives charged by the ring
accounting, three planted faults read above 1e-5, other archs and the
``"dp"``/``"dp2"`` layouts against the unpartitioned step, and what the
step once refused (uneven microbatch rows among it) runs on ``meta``.
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
from repro_torch.distributed import partition, partition_train
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import Mesh
from repro_torch.models import layers
from repro_torch.models.params import (flatten, params_from_numpy, tree_map,
                                       unflatten)
from repro_torch.models.transformer import init_lm
from repro_torch.train import optimizer as opt
from repro_torch.train.compression import compressed_grad_transform
from repro_torch.train.serve import make_prefill, make_serve_step
from repro_torch.train.train_loop import make_train_step

SRC = Path(__file__).resolve().parents[1] / "src"
CPU = torch.device("cpu")
TOL = dict(rtol=1e-5, atol=1e-5)
OPT_KW = dict(lr=1e-3, eps=1e-3, warmup_steps=2, total_steps=40)
PUM = {"act": "relu", "pum": "bitplane", "pum_bits": 8}
CASES = {
    "yi-6b|2x2|2": {"arch": "yi-6b", "mesh": [2, 2], "n_mb": 2},
    "yi-6b|1x4|1": {"arch": "yi-6b", "mesh": [1, 4], "n_mb": 1},
    "internvl2-1b|1x4|1": {"arch": "internvl2-1b", "mesh": [1, 4],
                           "n_mb": 1},
    "internvl2-1b|4x2|2": {"arch": "internvl2-1b", "mesh": [4, 2],
                           "n_mb": 2},
    "internvl2-1b|1x8|1": {"arch": "internvl2-1b", "mesh": [1, 8],
                           "n_mb": 1},
    "granite|2x2|1": {"arch": "granite-moe-1b-a400m", "mesh": [2, 2],
                      "n_mb": 1},
    "granite|4x2|2": {"arch": "granite-moe-1b-a400m", "mesh": [4, 2],
                      "n_mb": 2},
    "ep|2x2|1": {"arch": "granite-moe-1b-a400m", "mesh": [2, 2], "n_mb": 1,
                 "replace": {"moe_impl": "ep"}},
    "pum|2x2|1": {"arch": "yi-6b", "mesh": [2, 2], "n_mb": 1,
                  "replace": PUM, "serve": True},
}
ARGS = {"batch": 8, "seq": 16, "cache": 32, "seed": 0, "steps": 2,
        "opt": OPT_KW, "cases": CASES}

_REF = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import time
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs import smoke_config
    from repro.distributed import sharding as shd
    from repro.models import transformer as tf
    from repro.train import optimizer as opt
    from repro.train.serve import make_prefill, make_serve_step
    from repro.train.train_loop import make_train_step

    out_dir, args = sys.argv[1], json.loads(sys.argv[2])
    b, l, s, seed = args["batch"], args["seq"], args["cache"], args["seed"]
    ocfg = opt.AdamWConfig(**args["opt"])
    saved, errors, walls = {}, {}, {}


    def mesh_of(sizes):
        n = int(np.prod(sizes))
        return jax.sharding.Mesh(np.array(jax.devices()[:n]).reshape(sizes),
                                 ("data", "model"))


    def batch_of(cfg, step):
        rng = np.random.default_rng(seed * 1000 + step)
        toks = rng.integers(0, cfg.vocab_size, (b, l)).astype(np.int32)
        labels = np.concatenate([toks[:, 1:], np.full((b, 1), -1, np.int32)], 1)
        # masks that differ by microbatch: a tenth of the first half's labels,
        # six tenths of the second half's
        p = np.where(np.arange(b)[:, None] < b // 2, 0.1, 0.6)
        labels = np.where(rng.random((b, l)) < p, -1, labels).astype(np.int32)
        out = {"tokens": toks, "labels": labels}
        if cfg.family == "vlm":
            out["vision_embeds"] = (0.02 * rng.standard_normal(
                (b, cfg.frontend_seq, cfg.d_model))).astype(np.float32)
        return out


    def cfg_of(case):
        cfg = smoke_config(case["arch"]).replace(param_dtype="float32")
        return cfg.replace(**case.get("replace", {}))


    for tag, case in args["cases"].items():
        t0 = time.time()
        cfg = cfg_of(case)
        params = tf.init_lm(jax.random.PRNGKey(seed), cfg)
        for i, leaf in enumerate(jax.tree.leaves(params)):
            saved[f"{tag}|w|{i}"] = np.asarray(leaf)
        batches = [batch_of(cfg, st) for st in range(args["steps"])]
        for st, bt in enumerate(batches):
            for k, v in bt.items():
                saved[f"{tag}|batch{st}|{k}"] = v
        mesh = mesh_of(case["mesh"])
        state = opt.init(params)
        ps = shd.param_shardings(params, mesh)
        os_ = shd.opt_shardings(state, params, mesh)
        bs = shd.batch_shardings(batches[0], mesh)
        step = make_train_step(cfg, ocfg, n_microbatches=case["n_mb"])
        try:
            with mesh:
                fn = jax.jit(step, in_shardings=(ps, os_, bs),
                             out_shardings=(ps, os_, None))
                p, o = jax.device_put(params, ps), jax.device_put(state, os_)
                for st, bt in enumerate(batches):
                    p, o, m = fn(p, o, {k: jnp.asarray(v) for k, v in bt.items()})
                    for k, v in m.items():
                        saved[f"{tag}|m{st}|{k}"] = np.asarray(v)
            for i, leaf in enumerate(jax.tree.leaves(p)):
                saved[f"{tag}|p|{i}"] = np.asarray(leaf)
            for i, leaf in enumerate(jax.tree.leaves(o.mu)):
                saved[f"{tag}|mu|{i}"] = np.asarray(leaf)
            for i, leaf in enumerate(jax.tree.leaves(o.nu)):
                saved[f"{tag}|nu|{i}"] = np.asarray(leaf)
            saved[f"{tag}|step"] = np.asarray(o.step)
            if case.get("serve"):
                rng = np.random.default_rng(seed + 1)
                toks = rng.integers(0, cfg.vocab_size, (b, l)).astype(np.int32)
                caches = jax.tree.map(
                    lambda x: rng.standard_normal(x.shape).astype(np.float32),
                    jax.eval_shape(lambda: tf.init_caches(cfg, b, s)))
                token = rng.integers(0, cfg.vocab_size, (b,)).astype(np.int32)
                pos = rng.integers(l, s, (b,)).astype(np.int32)
                saved[f"{tag}|serve|tokens"] = toks
                saved[f"{tag}|serve|token"], saved[f"{tag}|serve|pos"] = token, pos
                for k, v in caches["attn"].items():
                    saved[f"{tag}|serve|cache_{k}"] = v
                cs = shd.cache_shardings(caches, mesh)
                vec = shd.vector_sharding(mesh, b)
                lsh = shd.logits_sharding(mesh, b)
                with mesh:
                    saved[f"{tag}|serve|prefill"] = np.asarray(jax.jit(
                        make_prefill(cfg), in_shardings=(ps, bs["tokens"]),
                        out_shardings=lsh)(params, toks))
                    logits, new = jax.jit(
                        make_serve_step(cfg), in_shardings=(ps, cs, vec, vec),
                        out_shardings=(lsh, cs))(params, caches, token, pos)
                saved[f"{tag}|serve|decode"] = np.asarray(logits)
                for k, v in new["attn"].items():
                    saved[f"{tag}|serve|new_{k}"] = np.asarray(v)
        except Exception as e:  # recorded; the test says so
            errors[tag] = f"{type(e).__name__}: {e}"
        walls[tag] = time.time() - t0
    np.savez(os.path.join(out_dir, "ref.npz"), **saved)
    with open(os.path.join(out_dir, "errors.json"), "w") as f:
        json.dump({"errors": errors, "walls": walls}, f)
""")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """This module's steps run many small ops a position: under parallel
    test workers, an OpenMP thread team on each of them makes a step
    tens of times slower than on one thread (a MoE step 97.8 s against
    3.1 s beside five busy processes).  Restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("partition_train_ref")
    env = {**os.environ, "PYTHONPATH": str(SRC), "JAX_PLATFORMS": "cpu"}
    run = subprocess.run([sys.executable, "-c", _REF, str(d),
                          json.dumps(ARGS)],
                         capture_output=True, text=True, env=env, timeout=600)
    assert run.returncode == 0, run.stdout + run.stderr
    with np.load(d / "ref.npz") as z:
        arrays = dict(z)
    return {"arrays": arrays,
            **json.loads((d / "errors.json").read_text())}


def test_reference_sharded_jit_runs(ref):
    """The installed JAX runs every sharded train jit of the reference
    side over meshes with auto axes."""
    assert ref["errors"] == {}


def cpu_mesh(sizes) -> Mesh:
    return Mesh(sizes, ("data", "model"), [CPU] * int(np.prod(sizes)))


def _cfg(case):
    return smoke_config(case["arch"]).replace(param_dtype="float32",
                                              **case.get("replace", {}))


def _inputs(ref, tag):
    """The reference's weights and batches of case ``tag`` as tensors."""
    a = ref["arrays"]
    cfg = _cfg(CASES[tag])
    like = init_lm(cfg, device="meta")
    params = params_from_numpy(unflatten(like, [
        a[f"{tag}|w|{i}"] for i in range(len(flatten(like)))]), CPU)
    batches = [{k: torch.from_numpy(a[f"{tag}|batch{s}|{k}"].copy())
                for k in ("tokens", "labels", "vision_embeds")
                if f"{tag}|batch{s}|{k}" in a} for s in range(ARGS["steps"])]
    return cfg, params, batches


def _step(cfg, n_mb, remat="dots", **kw):
    return make_train_step(cfg, opt.AdamWConfig(**OPT_KW),
                           n_microbatches=n_mb, remat=remat, **kw)


def _partitioned_step(cfg, params, batch, mesh, n_mb, remat="dots",
                      policy="2d", **kw):
    state = opt.init(params)
    ps = shd.param_shardings(params, mesh, policy)
    os_ = shd.opt_shardings(state, params, mesh, policy)
    bs = shd.batch_shardings(batch, mesh, policy)
    step = partition.partitioned_step(_step(cfg, n_mb, remat, **kw),
                                      (ps, os_, bs), (ps, os_, None))
    return step, shd.place(params, ps), shd.place(state, os_)


def _train(cfg, params, batches, mesh, n_mb, remat="dots", policy="2d"):
    """Params, optimizer state (whole) and each step's metrics after the
    batches' steps, partitioned over ``mesh`` (unpartitioned where it is
    None)."""
    if mesh is None:
        step, p, o = _step(cfg, n_mb, remat), params, opt.init(params)
    else:
        step, p, o = _partitioned_step(cfg, params, batches[0], mesh, n_mb,
                                       remat, policy)
    metrics = []
    for b in batches:
        p, o, m = step(p, o, b)
        metrics.append({k: float(v) for k, v in m.items()})
    if mesh is not None:
        assert isinstance(p["embed"]["emb"], shd.Sharded)
        assert all(v.device == CPU and v.dim() == 0 for v in m.values())
        p, o = shd.gather(p, CPU), shd.gather(o, CPU)
    return p, o, metrics


def _held(got, want):
    """``got`` within 1e-5 of ``want``: each step's metrics, the step,
    every leaf of params, mu and nu."""
    p, o, metrics = got
    wp, wo, wmetrics = want
    for m, w in zip(metrics, wmetrics):
        for k in ("loss", "aux", "grad_norm", "lr"):
            np.testing.assert_allclose(m[k], w[k], err_msg=k, **TOL)
    assert int(o.step) == int(wo.step)
    for name, a, b in (("params", p, wp), ("mu", o.mu, wo.mu),
                       ("nu", o.nu, wo.nu)):
        for i, (x, y) in enumerate(zip(flatten(a), flatten(b))):
            np.testing.assert_allclose(x.numpy(), y.numpy(),
                                       err_msg=f"{name} leaf {i}", **TOL)


def _reference(ref, tag, like):
    """The reference's sharded run of case ``tag`` in ``_train``'s form
    (``like``: the port's params and state, for their structure)."""
    a = ref["arrays"]
    p, o = like

    def tree(name, t):
        return unflatten(t, [torch.from_numpy(a[f"{tag}|{name}|{i}"])
                             for i in range(len(flatten(t)))])

    metrics = [{k: float(a[f"{tag}|m{s}|{k}"])
                for k in ("loss", "aux", "grad_norm", "lr")}
               for s in range(ARGS["steps"])]
    state = opt.OptState(torch.from_numpy(a[f"{tag}|step"]),
                         tree("mu", o.mu), tree("nu", o.nu))
    return tree("p", p), state, metrics


TRAIN = [t for t in CASES if not t.startswith("ep")]


@pytest.mark.parametrize("remat", ["none", "dots"])
@pytest.mark.parametrize("tag", TRAIN)
def test_train_equals_reference(ref, tag, remat):
    """Two partitioned train steps within 1e-5 of the reference's sharded
    jit and of the port's unpartitioned step."""
    case = CASES[tag]
    cfg, params, batches = _inputs(ref, tag)
    got = _train(cfg, params, batches, cpu_mesh(case["mesh"]), case["n_mb"],
                 remat)
    _held(got, _reference(ref, tag, got[:2]))
    _held(got, _train(cfg, params, batches, None, case["n_mb"], remat))


def test_ep_train_equals_reference(ref):
    """granite-moe-1b-a400m with ``moe_impl="ep"`` over (2, 2): within
    1e-5 of the reference's sharded jit, whose aux is data shard 0's;
    the grouped step's aux is another."""
    tag = "ep|2x2|1"
    cfg, params, batches = _inputs(ref, tag)
    got = _train(cfg, params, batches, cpu_mesh((2, 2)), 1)
    _held(got, _reference(ref, tag, got[:2]))
    grouped = _train(cfg.replace(moe_impl="grouped"), params, batches,
                     cpu_mesh((2, 2)), 1)
    assert abs(got[2][0]["aux"] - grouped[2][0]["aux"]) > 1e-3


def _serving(cfg, mesh, params, tokens, caches, token, pos):
    ps = shd.param_shardings(params, mesh)
    bs = shd.batch_shardings({"tokens": tokens}, mesh)
    lsh = shd.logits_sharding(mesh, tokens.shape[0])
    pre = partition.partitioned_step(make_prefill(cfg), (ps, bs["tokens"]),
                                     lsh)
    cs = shd.cache_shardings(caches, mesh)
    vec = shd.vector_sharding(mesh, tokens.shape[0])
    dec = partition.partitioned_step(make_serve_step(cfg),
                                     (ps, cs, vec, vec), (lsh, cs))
    placed = shd.place(params, ps)
    first = pre(placed, shd.place(tokens, bs["tokens"])).gather(CPU)
    logits, new = dec(placed, shd.place(caches, cs), shd.place(token, vec),
                      shd.place(pos, vec))
    return first, logits.gather(CPU), {k: v.gather(CPU)
                                       for k, v in new["attn"].items()}


def _pum_serving_inputs(ref):
    a = ref["arrays"]
    tag = "pum|2x2|1"
    cfg, params, _ = _inputs(ref, tag)

    def get(k):
        return torch.from_numpy(a[f"{tag}|serve|{k}"].copy())

    caches = {"attn": {k: get(f"cache_{k}") for k in ("k", "v")}}
    return cfg, params, get("tokens"), caches, get("token"), get("pos")


def test_pum_prefill_and_decode_equal_reference(ref):
    """Smoke yi-6b with the PuM MLP over (2, 2): the partitioned prefill,
    decode and its written caches within 1e-5 of the reference's sharded
    jit and of the port's unpartitioned steps."""
    a = ref["arrays"]
    cfg, params, tokens, caches, token, pos = _pum_serving_inputs(ref)
    pre, dec, new = _serving(cfg, cpu_mesh((2, 2)), params, tokens, caches,
                             token, pos)
    np.testing.assert_allclose(pre.numpy(), a["pum|2x2|1|serve|prefill"],
                               **TOL)
    np.testing.assert_allclose(dec.numpy(), a["pum|2x2|1|serve|decode"],
                               **TOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(new[k].numpy(),
                                   a[f"pum|2x2|1|serve|new_{k}"], **TOL)
    np.testing.assert_allclose(pre.numpy(), make_prefill(cfg)(
        params, tokens).numpy(), **TOL)
    mine = {"attn": {k: v.clone() for k, v in caches["attn"].items()}}
    np.testing.assert_allclose(dec.numpy(), make_serve_step(cfg)(
        params, mine, token, pos)[0].numpy(), **TOL)


def _recorded(monkeypatch, calls):
    """Record every integer stage's result: ``mlp_pum`` and the
    partitioned MLP both reach it through ``layers.pum_relu_hidden``."""
    real = layers.relu_stage

    def rec(up, bits=8):
        out = real(up, bits)
        calls.append(out)
        return out

    monkeypatch.setattr(layers, "relu_stage", rec)


@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_pum_integer_stage_equal_on_each_shard(ref, monkeypatch, kind):
    """The PuM MLP's integer relu stage over (2, 2): each position's
    stage ``==`` its rows and hidden columns of the unpartitioned
    stage's, in every layer (the train step: its forward)."""
    cfg, params, tokens, caches, token, pos = _pum_serving_inputs(ref)
    _, _, batches = _inputs(ref, "pum|2x2|1")
    mesh = cpu_mesh((2, 2))
    calls = []
    _recorded(monkeypatch, calls)
    if kind == "prefill":
        make_prefill(cfg)(params, tokens)
        whole = calls[:]
        calls.clear()
        _serving(cfg, mesh, params, tokens, caches, token, pos)
        parts = calls[:len(whole) * mesh.size]
    else:
        _step(cfg, 1, "none")(params, opt.init(params), batches[0])
        whole = calls[:]
        calls.clear()
        step, p, o = _partitioned_step(cfg, params, batches[0], mesh, 1,
                                       "none")
        step(p, o, batches[0])
        parts = calls
    assert len(whole) == cfg.n_layers and len(parts) == 4 * cfg.n_layers
    for i, w in enumerate(whole):
        rows, cols = w.shape[0] // 2, w.shape[-1] // 2
        for k in range(4):
            d, r = divmod(k, 2)
            assert torch.equal(parts[4 * i + k], w[d * rows:(d + 1) * rows,
                                                   ..., r * cols:
                                                   (r + 1) * cols])


def test_train_each_position_computes_its_share():
    """yi-6b over (2, 2): each position's train step (backward and
    optimizer included), traced alone on ``meta``, counts at most 1.25 x
    the unpartitioned step's FLOPs over the 4 positions, the four counts
    equal."""
    cfg = smoke_config("yi-6b")
    mesh = Mesh((2, 2), ("data", "model"))
    params = init_lm(cfg, device="meta")
    state = opt.init(params)
    batch = {k: torch.empty((8, 16), dtype=torch.int32, device="meta")
             for k in ("tokens", "labels")}
    step = _step(cfg, 1)
    with FlopCounterMode(display=False) as fc:
        step(params, state, batch)
    total = fc.get_total_flops()
    pstep = partition.partitioned_step(step, (
        shd.param_shardings(params, mesh),
        shd.opt_shardings(state, params, mesh),
        shd.batch_shardings(batch, mesh)), None)
    counts = []
    for k in range(mesh.size):
        local = pstep.local_arguments(params, state, batch)
        with FlopCounterMode(display=False) as fc:
            pstep.run_position(local, position=k)
        counts.append(fc.get_total_flops())
    assert len(set(counts)) == 1, counts
    assert 0 < counts[0] <= 1.25 * total / mesh.size, (counts, total)


def test_train_position_trace_has_the_run_shapes(ref):
    """internvl2-1b over (1, 4): position 3's train step traced on
    ``meta`` holds its params and moments in the shapes of the run's
    shards, and its metrics are scalars."""
    cfg, params, batches = _inputs(ref, "internvl2-1b|1x4|1")
    mesh = cpu_mesh((1, 4))
    step, p, o = _partitioned_step(cfg, params, batches[0], mesh, 1)
    p, o, _ = step(p, o, batches[0])
    like = init_lm(cfg, device="meta")
    meta_batch = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
                  for k, v in batches[0].items()}
    tp, to, tm = step.run_position(step.local_arguments(
        like, opt.init(like), meta_batch), position=3)
    for got, want in ((tp, p), (to.mu, o.mu), (to.nu, o.nu)):
        for g, w in zip(flatten(got), flatten(want)):
            assert g.device.type == "meta" and g.shape == w.shards[3].shape
    assert all(v.shape == () for v in tm.values())


def test_train_never_gathers_an_argument(ref, monkeypatch):
    """A train step over (2, 2) calls no ``Sharded.gather`` and no
    ``sharding.gather``: nothing falls back to the whole tensors."""
    cfg, params, batches = _inputs(ref, "granite|2x2|1")
    step, p, o = _partitioned_step(cfg, params, batches[0], cpu_mesh((2, 2)),
                                   1)

    def refuse(*a, **k):
        raise AssertionError("gathered")

    monkeypatch.setattr(shd.Sharded, "gather", refuse)
    monkeypatch.setattr(shd, "gather", refuse)
    new_p, new_o, m = step(p, o, batches[0])
    assert isinstance(new_p["blocks"]["moe"]["up"], shd.Sharded)
    assert isinstance(new_o.mu["embed"]["emb"], shd.Sharded)
    assert torch.isfinite(m["grad_norm"])


@pytest.mark.parametrize("arch,sizes,policy,n_mb", [
    ("yi-6b", (1, 8), "2d", 1), ("qwen2-72b", (1, 4), "2d", 1),
    ("arctic-480b", (2, 2), "2d", 2), ("yi-6b", (2, 2), "dp", 1),
    ("yi-6b", (2, 2), "dp2", 1), ("granite-moe-1b-a400m", (2, 2), "dp", 2)])
def test_other_train_steps_equal_unpartitioned(arch, sizes, policy, n_mb):
    """yi-6b over (1, 8), whose 4 query heads do not divide and whose
    attention splits ``head_dim``; qwen2-72b's qkv biases; arctic's MoE
    beside a dense MLP in 2 microbatches; the ``"dp"`` and ``"dp2"``
    layouts (no tensor parallelism; ``"dp2"``'s moments sharded where
    its params are whole): two steps within 1e-5 of the unpartitioned
    ones on the same seeded weights and batches."""
    cfg = smoke_config(arch).replace(param_dtype="float32")
    gen = torch.Generator().manual_seed(5)
    params = init_lm(cfg, generator=gen, device="cpu")
    batches = []
    for _ in range(2):
        t = torch.randint(0, cfg.vocab_size, (8, 16), generator=gen)
        masked = torch.rand((8, 16), generator=gen) < 0.3
        batches.append({"tokens": t, "labels": torch.where(
            masked, -1, torch.roll(t, -1, 1))})
    got = _train(cfg, params, batches, cpu_mesh(sizes), n_mb, policy=policy)
    _held(got, _train(cfg, params, batches, None, n_mb))


def test_train_attention_modes():
    """How the train step's attention splits the smoke archs' 4 query
    and 2 kv heads: by heads over 2 ranks, by query heads over 4, by
    ``head_dim`` over 8 (as prefill does)."""
    cfg = smoke_config("yi-6b")
    modes = {}
    for tp in (1, 2, 4, 8):
        mesh = Mesh((2, tp), ("data", "model"))
        prog = partition_train._TrainProgram(
            cfg, partition.Positions(mesh, [0], meta=True), ("data",),
            "dots")
        modes[tp] = prog.mode
    assert modes == {1: "heads", 2: "heads", 4: "qheads", 8: "hd"}


# -- the backward's collectives -------------------------------------------------

def _ring(kind, in_bytes, out_bytes):
    return {"all-gather": out_bytes, "all-reduce": 2 * in_bytes}.get(
        kind, in_bytes)


TRANSPOSE = {"all-gather": "reduce-scatter", "reduce-scatter": "all-gather",
             "all-to-all": "all-to-all",
             "collective-permute": "collective-permute",
             "all-reduce": None, "enter": "all-reduce"}


@pytest.mark.parametrize("kind", list(TRANSPOSE))
def test_backward_collectives_are_charged(kind):
    """Over ``model`` (4 positions) of a (2, 4) CPU mesh: each
    collective's backward ``==`` its explicit transpose on the
    cotangents, and the ledger holds the transpose's ring accounting of
    one position's bytes (the all-reduce of partials passes its
    cotangent through and moves nothing; ``enter`` all-reduces)."""
    mesh = cpu_mesh((2, 4))
    pos = partition.Positions(mesh, range(mesh.size))
    gen = torch.Generator().manual_seed(4)
    vals = [torch.randn((4, 6), generator=gen).requires_grad_()
            for _ in range(mesh.size)]
    m = ("model",)
    fwd = {"all-gather": lambda: partition.all_gather(pos, vals, m, 1),
           "reduce-scatter": lambda: partition.reduce_scatter(pos, vals, m,
                                                              0),
           "all-to-all": lambda: partition.all_to_all(pos, vals, m, 0, 1),
           "collective-permute": lambda: partition.permute(pos, vals, m, 1),
           "all-reduce": lambda: partition.all_reduce(pos, vals, m),
           "enter": lambda: partition.enter(pos, vals, m)}[kind]
    with partition.CollectiveLedger() as ledger:
        out = fwd()
        before = dict(ledger.bytes)
        cts = [torch.randn(o.shape, generator=gen) for o in out]
        grads = torch.autograd.grad(out, vals, grad_outputs=cts)
    charged = {k: ledger.bytes[k] - before[k] for k in ledger.bytes}
    with torch.no_grad():
        want = {"all-gather": lambda: partition.reduce_scatter(pos, cts, m,
                                                               1),
                "reduce-scatter": lambda: partition.all_gather(pos, cts, m,
                                                               0),
                "all-to-all": lambda: partition.all_to_all(pos, cts, m, 1,
                                                           0),
                "collective-permute": lambda: partition.permute(pos, cts, m,
                                                                -1),
                "all-reduce": lambda: cts,
                "enter": lambda: partition.all_reduce(pos, cts, m)}[kind]()
    for g, w in zip(grads, want):
        assert torch.equal(g, w)
    t = TRANSPOSE[kind]
    assert charged == {**dict.fromkeys(partition.KINDS, 0), **(
        {} if t is None else {t: _ring(t, cts[0].numel() * 4,
                                       want[0].numel() * 4)})}


def test_all_gather_of_copies_takes_its_own_part():
    """An all-gather feeding duplicated computation (``copies``): each
    position's gradient is its own part of its cotangent, and nothing
    is charged in the backward."""
    mesh = cpu_mesh((1, 4))
    pos = partition.Positions(mesh, range(4))
    vals = [torch.randn(3, 2).requires_grad_() for _ in range(4)]
    cts = [torch.randn(3, 8) for _ in range(4)]
    out = partition.all_gather(pos, vals, ("model",), 1, copies=True)
    with partition.CollectiveLedger() as ledger:
        grads = torch.autograd.grad(out, vals, grad_outputs=cts)
    assert ledger.totals()["total"] == 0
    for k, g in enumerate(grads):
        assert torch.equal(g, cts[k][:, 2 * k:2 * k + 2])


def test_smoke_step_charges_its_backward(ref):
    """yi-6b over (2, 2) under ``remat="none"``: every weight gather's
    backward reduce-scatters as many bytes as it gathered, once each;
    the loss's gather of the ranks' log-sum-exp feeds duplicated
    computation and moves nothing back."""
    cfg, params, batches = _inputs(ref, "yi-6b|2x2|2")
    step, p, o = _partitioned_step(cfg, params, batches[0], cpu_mesh((2, 2)),
                                   1, "none")
    with partition.CollectiveLedger() as ledger:
        step(p, o, batches[0])
    lse = 2 * 4 * 16 * 4     # the loss's gather: (2, 4, 16) float32 out
    assert ledger.bytes["reduce-scatter"] == ledger.bytes["all-gather"] - lse
    assert ledger.calls["reduce-scatter"] == ledger.calls["all-gather"] - 1


# -- planted faults ------------------------------------------------------------------

def _rel_mu(got, want) -> float:
    return max(float((a - b).abs().max() / b.abs().max())
               for a, b in zip(flatten(got[1].mu), flatten(want[1].mu)))


def _fault_case(ref, tag="yi-6b|2x2|2", n_mb=1):
    cfg, params, batches = _inputs(ref, tag)
    want = _train(cfg, params, batches[:1], None, n_mb)
    return cfg, params, batches[:1], want


def test_dropped_reduce_scatter_partial_reads_above_tolerance(ref,
                                                             monkeypatch):
    """Data rank 1's partial dropped from the backward's first
    reduce-scatter (the readout's gradient) moves ``mu`` past 1e-5."""
    cfg, params, batches, want = _fault_case(ref)
    real, calls = partition.reduce_scatter, []

    def dropped(pos, vals, axes, dim):
        calls.append(tuple(axes))
        if len(calls) == 1:
            vals = [torch.zeros_like(v) if pos.part(k, axes) == 1 else v
                    for k, v in zip(pos.ks, vals)]
        return real(pos, vals, axes, dim)

    monkeypatch.setattr(partition, "reduce_scatter", dropped)
    got = _train(cfg, params, batches, cpu_mesh((2, 2)), 1)
    assert calls and calls[0] == ("data",)
    assert _rel_mu(got, want) > 1e-5


def test_norm_gain_summed_over_model_reads_above_tolerance(ref,
                                                          monkeypatch):
    """ln_f's gain, whole over every axis, with its gradient summed over
    ``model`` as well as DATA (its two model ranks' copies added) moves
    ``mu`` past 1e-5."""
    cfg, params, batches, want = _fault_case(ref)
    real = partition_train.summed_axes
    monkeypatch.setattr(partition_train, "summed_axes", lambda prog, spec: (
        real(prog, spec) + (("model",) if tuple(spec) == (None,) else ())))
    got = _train(cfg, params, batches, cpu_mesh((2, 2)), 1)
    assert _rel_mu(got, want) > 1e-5


def test_local_microbatches_read_above_tolerance(ref, monkeypatch):
    """Each position's own rows cut into microbatches, in place of its
    share of the reference's: the uneven masks move the loss and ``mu``
    past 1e-5."""
    cfg, params, batches, want = _fault_case(ref, n_mb=2)
    monkeypatch.setattr(partition_train, "relay",
                        lambda pos, vals, axes, n_mb: list(vals))
    got = _train(cfg, params, batches, cpu_mesh((2, 2)), 2)
    assert abs(got[2][0]["loss"] - want[2][0]["loss"]) > 1e-5
    assert _rel_mu(got, want) > 1e-5


# -- what the train step does not partition -------------------------------------------

def test_train_refusals():
    """What the train step once refused partitions: a
    ``grad_transform``, ``moe_impl="dense"``, an encoder-decoder, a
    replicated batch and a batch of 6 rows in 2 microbatches over 2 data
    parts (3 rows a microbatch: uneven shares): position 0's step runs
    on ``meta`` (their parity with the reference:
    ``test_torch_partition_transform.py``,
    ``test_torch_partition_dense.py``, ``test_torch_partition_encdec.py``
    and ``test_torch_partition_uneven.py``)."""
    mesh = cpu_mesh((2, 2))
    cfg = smoke_config("yi-6b")
    params = init_lm(cfg, device="meta")
    state = opt.init(params)
    batch = {k: torch.empty((8, 16), dtype=torch.int32, device="meta")
             for k in ("tokens", "labels")}
    sh = (shd.param_shardings(params, mesh),
          shd.opt_shardings(state, params, mesh),
          shd.batch_shardings(batch, mesh))
    res = tree_map(lambda t: torch.zeros(t.shape, dtype=torch.float32,
                                         device="meta"), params)
    step = partition.partitioned_step(
        _step(cfg, 1, grad_transform=compressed_grad_transform(res)), sh,
        None)
    new_p, _, metrics = step.run_position(step.local_arguments(
        params, state, batch))
    assert metrics["grad_norm"].device.type == "meta"
    # no out shardings: the new params come back whole
    assert [t.shape for t in flatten(new_p)] == [t.shape
                                                 for t in flatten(params)]
    dense = smoke_config("granite-moe-1b-a400m").replace(moe_impl="dense")
    d_params = init_lm(dense, device="meta")
    d_state = opt.init(d_params)
    step = partition.partitioned_step(_step(dense, 1), (
        shd.param_shardings(d_params, mesh),
        shd.opt_shardings(d_state, d_params, mesh), sh[2]), None)
    _, _, metrics = step.run_position(step.local_arguments(
        d_params, d_state, batch))
    assert metrics["aux"].device.type == "meta"
    # the encoder-decoder partitions: position 0's step runs on meta (its
    # parity with the reference: tests/test_torch_partition_encdec.py)
    encdec = smoke_config("seamless-m4t-medium")
    e_params = init_lm(encdec, device="meta")
    e_state = opt.init(e_params)
    e_batch = dict(batch, encoder_feats=torch.empty(
        (8, 4, encdec.d_model), dtype=torch.float32, device="meta"))
    e_step = partition.partitioned_step(_step(encdec, 1), (
        shd.param_shardings(e_params, mesh),
        shd.opt_shardings(e_state, e_params, mesh),
        shd.batch_shardings(e_batch, mesh)), None)
    new_p, _, metrics = e_step.run_position(
        e_step.local_arguments(e_params, e_state, e_batch))
    assert metrics["loss"].device.type == "meta"
    assert set(new_p) >= {"enc_blocks", "enc_ln_f", "frontend_proj"}
    whole = {k: shd.replicated(mesh) for k in batch}
    step = partition.partitioned_step(_step(cfg, 1), sh[:2] + (whole,), None)
    _, _, metrics = step.run_position(step.local_arguments(params, state,
                                                           batch))
    assert metrics["loss"].device.type == "meta"
    uneven = {k: torch.empty((6, 16), dtype=torch.int32, device="meta")
              for k in batch}
    step = partition.partitioned_step(_step(cfg, 2), sh, None)
    _, _, metrics = step.run_position(step.local_arguments(params, state,
                                                           uneven))
    assert metrics["loss"].device.type == "meta"
