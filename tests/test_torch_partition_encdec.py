"""The encoder-decoder partitioned over a device mesh
(:mod:`repro_torch.distributed.partition`'s encoder and cross-attention,
and :mod:`~repro_torch.distributed.partition_train`'s), on the CPU,
against the JAX package's sharded jit.

The reference side runs once, in a module-scoped subprocess with 8
forced host devices, over meshes built as
``jax.sharding.Mesh(devices.reshape(shape), ("data", "model"))`` (auto
axes, ROADMAP Queue 3), for smoke seamless-m4t-medium in float32 (2
encoder and 2 decoder layers, 4 query over 2 kv heads of 16, gelu, tied
embeddings, the audio stub's ``frontend_proj``; the reference's
``init_lm`` weights, carried across with ``params_from_numpy``):
``jax.jit(make_prefill / make_serve_step / make_train_step,
in_shardings=..., out_shardings=...)`` over (1, 4), (2, 2) and (4, 2), on
seeded numpy tokens with 4 encoder frames a row, caches and a 6-frame
``memory`` for decode, and two AdamW steps (``eps=1e-3``) on batches
whose label masks differ by microbatch.

The port's partitioned steps on CPU meshes of the same shapes: logits,
every written cache shard, and the train step's loss, grad_norm, lr,
params, ``mu`` and ``nu`` (under ``remat`` ``"none"`` and ``"dots"``)
within rtol = atol = 1e-5 of the reference's sharded jit and of the
port's unpartitioned step.  Over (1, 4) the 2 kv heads do not divide:
decode splits ``head_dim`` (its cache's layout), prefill, train and the
encoder split the query heads, and so does the cross-attention.  Also:
each position's FLOPs at most 1.25 x the unpartitioned step's share
((2, 2), prefill and train), and two planted faults read above 1e-5.
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
from repro_torch.distributed import partition
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.partition_train import attention_mode
from repro_torch.launch.mesh import Mesh
from repro_torch.models.params import (flatten, params_from_numpy, tree_map,
                                       unflatten)
from repro_torch.models.transformer import init_caches, init_lm
from repro_torch.train import optimizer as opt
from repro_torch.train.serve import make_prefill, make_serve_step
from repro_torch.train.train_loop import make_train_step

SRC = Path(__file__).resolve().parents[1] / "src"
CPU = torch.device("cpu")
ARCH = "seamless-m4t-medium"
TOL = dict(rtol=1e-5, atol=1e-5)
OPT_KW = dict(lr=1e-3, eps=1e-3, warmup_steps=2, total_steps=40)
MESHES = {"1x4": [1, 4], "2x2": [2, 2], "4x2": [4, 2]}
MICRO = {"1x4": 1, "2x2": 2, "4x2": 2}
ARGS = {"arch": ARCH, "batch": 8, "seq": 16, "cache": 32, "memory": 6,
        "seed": 0, "steps": 2, "opt": OPT_KW, "meshes": MESHES,
        "micro": MICRO}

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
    b, l, s, seed = args["batch"], args["seq"], args["cache"], args["seed"]
    ocfg = opt.AdamWConfig(**args["opt"])
    saved, errors = {}, {}


    def mesh_of(sizes):
        n = int(np.prod(sizes))
        return jax.sharding.Mesh(np.array(jax.devices()[:n]).reshape(sizes),
                                 ("data", "model"))


    def keep(tag, tree):
        for i, leaf in enumerate(jax.tree.leaves(tree)):
            saved[f"{tag}|{i}"] = np.asarray(leaf)


    cfg = smoke_config(args["arch"]).replace(param_dtype="float32")
    params = tf.init_lm(jax.random.PRNGKey(seed), cfg)
    keep("w", params)
    rng = np.random.default_rng(seed)
    d = cfg.d_model
    ins = {"tokens": rng.integers(0, cfg.vocab_size, (b, l)).astype(np.int32),
           "encoder_feats": rng.standard_normal((b, l // 4, d)).astype(
               np.float32)}
    caches = jax.tree.map(
        lambda x: rng.standard_normal(x.shape).astype(np.float32),
        jax.eval_shape(lambda: tf.init_caches(cfg, b, s)))
    token = rng.integers(0, cfg.vocab_size, (b,)).astype(np.int32)
    pos = rng.integers(l, s, (b,)).astype(np.int32)
    memory = rng.standard_normal((b, args["memory"], d)).astype(np.float32)
    for k, v in ins.items():
        saved[f"in|{k}"] = v
    saved["in|token"], saved["in|pos"], saved["in|memory"] = token, pos, memory
    keep("in|caches", caches)
    batches = []
    for st in range(args["steps"]):
        r = np.random.default_rng(seed * 1000 + st)
        toks = r.integers(0, cfg.vocab_size, (b, l)).astype(np.int32)
        labels = np.concatenate([toks[:, 1:], np.full((b, 1), -1, np.int32)],
                                1)
        share = np.where(np.arange(b)[:, None] < b // 2, 0.1, 0.6)
        labels = np.where(r.random((b, l)) < share, -1, labels).astype(
            np.int32)
        feats = r.standard_normal((b, l // 4, d)).astype(np.float32)
        batches.append({"tokens": toks, "labels": labels,
                        "encoder_feats": feats})
        for k, v in batches[-1].items():
            saved[f"batch{st}|{k}"] = v
    prefill, serve = make_prefill(cfg), make_serve_step(cfg)
    for mname, sizes in args["meshes"].items():
        mesh = mesh_of(sizes)
        ps = shd.param_shardings(params, mesh)
        bs = shd.batch_shardings(ins, mesh)
        cs = shd.cache_shardings(caches, mesh)
        vec = shd.vector_sharding(mesh, b)
        msh = shd.batch_shardings({"m": memory}, mesh)["m"]
        lsh = shd.logits_sharding(mesh, b)
        state = opt.init(params)
        os_ = shd.opt_shardings(state, params, mesh)
        tbs = shd.batch_shardings(batches[0], mesh)
        step = make_train_step(cfg, ocfg, n_microbatches=args["micro"][mname])
        try:
            with mesh:
                saved[f"{mname}|prefill"] = np.asarray(jax.jit(
                    prefill, in_shardings=(ps, bs["tokens"],
                                           bs["encoder_feats"]),
                    out_shardings=lsh)(params, ins["tokens"],
                                       ins["encoder_feats"]))
                logits, new = jax.jit(
                    serve, in_shardings=(ps, cs, vec, vec, msh),
                    out_shardings=(lsh, cs))(params, caches, token, pos,
                                             memory)
                saved[f"{mname}|decode"] = np.asarray(logits)
                keep(f"{mname}|caches", new)
                fn = jax.jit(step, in_shardings=(ps, os_, tbs),
                             out_shardings=(ps, os_, None))
                p, o = jax.device_put(params, ps), jax.device_put(state, os_)
                for st, bt in enumerate(batches):
                    p, o, m = fn(p, o, {k: jnp.asarray(v)
                                        for k, v in bt.items()})
                    for k, v in m.items():
                        saved[f"{mname}|m{st}|{k}"] = np.asarray(v)
            keep(f"{mname}|p", p)
            keep(f"{mname}|mu", o.mu)
            keep(f"{mname}|nu", o.nu)
        except Exception as e:  # recorded; the test says so
            errors[mname] = f"{type(e).__name__}: {e}"
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
    d = tmp_path_factory.mktemp("partition_encdec_ref")
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


def _cfg():
    return smoke_config(ARCH).replace(param_dtype="float32")


def _tree(ref, tag, like):
    """The reference's leaves ``tag|0, tag|1, ...`` as tensors in
    ``like``'s structure."""
    a = ref["arrays"]
    return unflatten(like, [torch.from_numpy(a[f"{tag}|{i}"].copy())
                            for i in range(len(flatten(like)))])


def _inputs(ref):
    """The reference's weights and serving inputs."""
    a = ref["arrays"]
    cfg = _cfg()
    like = init_lm(cfg, device="meta")
    params = params_from_numpy(unflatten(like, [
        a[f"w|{i}"] for i in range(len(flatten(like)))]), CPU)
    caches = _tree(ref, "in|caches", init_caches(
        cfg, ARGS["batch"], ARGS["cache"], device="meta"))

    def get(k):
        return torch.from_numpy(a[f"in|{k}"].copy())

    ins = {"tokens": get("tokens"), "encoder_feats": get("encoder_feats")}
    return cfg, params, ins, caches, get("token"), get("pos"), get("memory")


def _copy(caches):
    return tree_map(torch.clone, caches)


def _steps(cfg, mesh, params, ins, caches, memory):
    """The partitioned prefill and decode over ``mesh`` and their
    shardings."""
    b = ARGS["batch"]
    ps = shd.param_shardings(params, mesh)
    bs = shd.batch_shardings(ins, mesh)
    lsh = shd.logits_sharding(mesh, b)
    cs = shd.cache_shardings(caches, mesh)
    vec = shd.vector_sharding(mesh, b)
    msh = shd.batch_shardings({"m": memory}, mesh)["m"]
    pre = partition.partitioned_step(
        make_prefill(cfg), (ps, bs["tokens"], bs["encoder_feats"]), lsh)
    dec = partition.partitioned_step(make_serve_step(cfg),
                                     (ps, cs, vec, vec, msh), (lsh, cs))
    return pre, dec, {"ps": ps, "bs": bs, "cs": cs, "vec": vec, "msh": msh}


def _decode(cfg, mesh, params, caches, token, pos, memory, ins,
            memory_shards=None):
    """The partitioned decode's (logits, new caches, caches' shardings);
    ``memory_shards`` rearranges the placed memory's shards first."""
    _, dec, sh = _steps(cfg, mesh, params, ins, caches, memory)
    mem = shd.place(memory, sh["msh"])
    if memory_shards is not None:
        mem = shd.Sharded(mem.shape, mem.dtype, mem.sharding,
                          memory_shards(list(mem.shards)))
    logits, new = dec(shd.place(params, sh["ps"]), shd.place(caches, sh["cs"]),
                      shd.place(token, sh["vec"]), shd.place(pos, sh["vec"]),
                      memory=mem)
    return logits, new, sh["cs"]


@pytest.mark.parametrize("mname", list(MESHES))
def test_prefill_equals_reference(ref, mname):
    """Partitioned prefill (encoder, then the decoder over its memory)
    logits within 1e-5 of the reference's sharded jit and of the port's
    unpartitioned prefill, laid out by ``logits_sharding``."""
    cfg, params, ins, caches, _, _, memory = _inputs(ref)
    mesh = cpu_mesh(MESHES[mname])
    pre, _, sh = _steps(cfg, mesh, params, ins, caches, memory)
    got = pre(shd.place(params, sh["ps"]), **shd.place(ins, sh["bs"]))
    assert got.sharding.spec == shd.logits_sharding(mesh, 8).spec
    whole = got.gather(CPU).numpy()
    np.testing.assert_allclose(whole, ref["arrays"][f"{mname}|prefill"],
                               **TOL)
    np.testing.assert_allclose(whole, make_prefill(cfg)(params, **ins)
                               .numpy(), **TOL)


@pytest.mark.parametrize("mname", list(MESHES))
def test_decode_equals_reference(ref, mname):
    """Partitioned decode over ``memory`` (the cross k and v recomputed
    from it): logits and the caches it wrote within 1e-5 of the
    reference's sharded jit and of the port's unpartitioned step, each
    position's shard against its slice of the unpartitioned cache, in
    ``cache_shardings``' layout; the argument caches left as they
    were."""
    cfg, params, ins, caches, token, pos, memory = _inputs(ref)
    kept = _copy(caches)
    logits, new, cs = _decode(cfg, cpu_mesh(MESHES[mname]), params, caches,
                              token, pos, memory, ins)
    a = ref["arrays"]
    np.testing.assert_allclose(logits.gather(CPU).numpy(),
                               a[f"{mname}|decode"], **TOL)
    want, want_caches = make_serve_step(cfg)(params, _copy(caches), token,
                                             pos, memory=memory)
    np.testing.assert_allclose(logits.gather(CPU).numpy(), want.numpy(),
                               **TOL)
    for i, (leaf, whole, sh) in enumerate(zip(flatten(new),
                                              flatten(want_caches),
                                              flatten(cs))):
        assert leaf.sharding.spec == sh.spec
        np.testing.assert_allclose(leaf.gather(CPU).numpy(),
                                   a[f"{mname}|caches|{i}"],
                                   err_msg=f"cache leaf {i}", **TOL)
        for idx, part in zip(leaf.sharding.indices(leaf.shape), leaf.shards):
            np.testing.assert_allclose(part.numpy(), whole[idx].numpy(),
                                       **TOL)
    for x, y in zip(flatten(caches), flatten(kept)):
        assert torch.equal(x, y)


def test_layouts_the_cases_take():
    """What the cases exercise: over 4 model ranks the 2 kv heads do not
    divide, so decode splits ``head_dim`` (the cache's layout), prefill,
    train and the encoder the query heads, and the cross-attention the
    query heads too; over 2 every attention splits by kv heads."""
    cfg = _cfg()
    assert partition._attention_mode(cfg, 4) == "hd"
    assert attention_mode(cfg, 4) == "qheads"
    assert partition._cross_mode(cfg, 4) == "qheads"
    assert partition._cross_mode(cfg, 8) == "full"
    assert {partition._attention_mode(cfg, 2), attention_mode(cfg, 2),
            partition._cross_mode(cfg, 2)} == {"heads"}
    cs = shd.cache_shardings(init_caches(cfg, 8, 32, "meta"),
                             cpu_mesh((1, 4)))
    assert tuple(cs["attn"]["k"].spec) == (None, "data", None, None, "model")


# -- the train step ------------------------------------------------------------------

def _batches(ref):
    a = ref["arrays"]
    return [{k: torch.from_numpy(a[f"batch{s}|{k}"].copy())
             for k in ("tokens", "labels", "encoder_feats")}
            for s in range(ARGS["steps"])]


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
        for k in ("loss", "aux", "grad_norm", "lr"):
            np.testing.assert_allclose(m[k], w[k], err_msg=k, **TOL)
    for what, a, b in (("params", p, wp), ("mu", o.mu, wmu),
                       ("nu", o.nu, wnu)):
        for i, (x, y) in enumerate(zip(flatten(a), flatten(b))):
            np.testing.assert_allclose(x.numpy(), y.numpy(),
                                       err_msg=f"{what} leaf {i}", **TOL)


@pytest.mark.parametrize("remat", ["none", "dots"])
@pytest.mark.parametrize("mname", list(MESHES))
def test_train_equals_reference(ref, mname, remat):
    """Two partitioned train steps (2 microbatches over (2, 2) and
    (4, 2)) within 1e-5 of the reference's sharded jit and of the port's
    unpartitioned step: loss, aux, grad_norm, lr, and every leaf of
    params, ``mu`` and ``nu`` (the encoder's, whose gradients come
    through the memory's cotangent summed over the decoder's layers,
    included)."""
    cfg, params = _inputs(ref)[:2]
    batches = _batches(ref)
    n_mb = MICRO[mname]
    got = _train(cfg, params, batches, cpu_mesh(MESHES[mname]), n_mb, remat)
    a = ref["arrays"]
    metrics = [{k: float(a[f"{mname}|m{s}|{k}"])
                for k in ("loss", "aux", "grad_norm", "lr")}
               for s in range(ARGS["steps"])]
    _held(got, (_tree(ref, f"{mname}|p", got[0]),
                _tree(ref, f"{mname}|mu", got[1].mu),
                _tree(ref, f"{mname}|nu", got[1].nu), metrics))
    p, o, m = _train(cfg, params, batches, None, n_mb, remat)
    _held(got, (p, o.mu, o.nu, m))
    assert max(float(t.abs().max()) for t in flatten(
        got[1].mu["enc_blocks"])) > 0


# -- compute is split ----------------------------------------------------------------

@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_each_position_computes_its_share(kind):
    """Over (2, 2): each position's prefill, or train step with its
    backward and optimizer, traced alone on ``meta``, counts at most
    1.25 x the unpartitioned step's FLOPs over the 4 positions, the four
    counts equal."""
    cfg = smoke_config(ARCH)
    mesh = Mesh((2, 2), ("data", "model"))
    params = init_lm(cfg, device="meta")
    b, l = ARGS["batch"], ARGS["seq"]
    tokens = torch.empty((b, l), dtype=torch.int32, device="meta")
    feats = torch.empty((b, l // 4, cfg.d_model), dtype=torch.bfloat16,
                        device="meta")
    ps = shd.param_shardings(params, mesh)
    if kind == "prefill":
        fn = make_prefill(cfg)
        args = (params, tokens, feats)
        bs = shd.batch_shardings({"t": tokens, "f": feats}, mesh)
        step = partition.partitioned_step(fn, (ps, bs["t"], bs["f"]),
                                          shd.logits_sharding(mesh, b))
    else:
        fn = make_train_step(cfg, opt.AdamWConfig(**OPT_KW))
        state = opt.init(params)
        batch = {"tokens": tokens, "labels": tokens, "encoder_feats": feats}
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


def test_other_shard_memory_reads_above_tolerance(ref):
    """Over (2, 2), position 0 (data shard 0) reading data shard 1's
    memory rows in its cross-attention moves the logits past 1e-5."""
    cfg, params, ins, caches, token, pos, memory = _inputs(ref)
    want, _ = make_serve_step(cfg)(params, _copy(caches), token, pos,
                                   memory=memory)

    def swapped(shards):
        shards[0] = shards[2]
        return shards

    logits, _, _ = _decode(cfg, cpu_mesh((2, 2)), params, caches, token,
                           pos, memory, ins, memory_shards=swapped)
    assert _rel(logits.gather(CPU), want) > 1e-5


def test_dropped_cross_partial_reads_above_tolerance(ref, monkeypatch):
    """Model rank 1's partial dropped from each cross-attention's
    row-parallel ``o`` (its one all-reduce over ``model``), in the
    decode over (2, 2): the logits move past 1e-5."""
    cfg, params, ins, caches, token, pos, memory = _inputs(ref)
    want, _ = make_serve_step(cfg)(params, _copy(caches), token, pos,
                                   memory=memory)
    real_cross, real_reduce, calls = (partition._Program.cross,
                                      partition.all_reduce, [])

    def dropped(p, vals, axes):
        calls.append(tuple(axes))
        vals = [torch.zeros_like(v) if p.part(k, ("model",)) == 1 else v
                for k, v in zip(p.ks, vals)]
        return real_reduce(p, vals, axes)

    def cross(self, p, x, memory):
        monkeypatch.setattr(partition, "all_reduce", dropped)
        try:
            return real_cross(self, p, x, memory)
        finally:
            monkeypatch.setattr(partition, "all_reduce", real_reduce)

    monkeypatch.setattr(partition._Program, "cross", cross)
    logits, _, _ = _decode(cfg, cpu_mesh((2, 2)), params, caches, token,
                           pos, memory, ins)
    assert calls == [("model",)] * cfg.n_layers
    assert _rel(logits.gather(CPU), want) > 1e-5
