"""The LM's prefill and decode steps partitioned over a device mesh
(:mod:`repro_torch.distributed.partition`), on the CPU, against the JAX
package's sharded jit.

The reference side runs once, in a module-scoped subprocess with 8
forced host devices (``--xla_force_host_platform_device_count=8``):
for smoke yi-6b, internvl2-1b and granite-moe-1b-a400m in float32 (the
reference's ``init_lm`` weights, carried across with
``params_from_numpy``), ``jax.jit(make_prefill(cfg) /
make_serve_step(cfg), in_shardings=..., out_shardings=...)`` with the
reference's own shardings over (1, 4), (2, 2) and (4, 2) ``("data",
"model")`` meshes, on seeded numpy tokens, vision embeddings, caches and
positions, and the unsharded jitted steps beside them.

- The port's partitioned steps on CPU meshes of the same shapes: logits
  and written caches within rtol = atol = 1e-5 of the reference's
  sharded jit and of the port's own unpartitioned step, each position's
  cache shard against its slice of the unpartitioned cache.
- Compute is split: each position's ``FlopCounterMode`` count (its
  program traced alone on ``meta``) is at most 1.25 x the unpartitioned
  step's over the positions, for yi-6b over (2, 2).
- The collectives: values ``==`` a rank-order sum or concatenation, and
  the charged bytes ``==`` the reference dry run's ring accounting, one
  case a kind.
- Planted faults read above 1e-5: one model rank's partial dropped from
  one all-reduce, and a position computing on another's cache slice.
- Any other function raises; padded kv heads, seamless-m4t-medium, an
  int8 tree and ``moe_impl="dense"`` run.
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
from repro_torch.launch.mesh import Mesh
from repro_torch.models.params import flatten, params_from_numpy, unflatten
from repro_torch.models.quantized import quantize_tree
from repro_torch.models.transformer import init_caches, init_lm
from repro_torch.train.serve import make_prefill, make_serve_step

SRC = Path(__file__).resolve().parents[1] / "src"
CPU = torch.device("cpu")
ARCHS = ("yi-6b", "internvl2-1b", "granite-moe-1b-a400m")
MESHES = {"1x4": (1, 4), "2x2": (2, 2), "4x2": (4, 2)}
BATCH, SEQ, CACHE, SEED = 8, 16, 32, 0
TOL = dict(rtol=1e-5, atol=1e-5)

_REF = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs import smoke_config
    from repro.distributed import sharding as shd
    from repro.models import transformer as tf
    from repro.train.serve import make_prefill, make_serve_step

    out_dir, args = sys.argv[1], json.loads(sys.argv[2])
    b, l, s = args["batch"], args["seq"], args["cache"]
    saved, errors = {}, {}
    for arch in args["archs"]:
        cfg = smoke_config(arch).replace(param_dtype="float32")
        params = tf.init_lm(jax.random.PRNGKey(args["seed"]), cfg)
        for i, leaf in enumerate(jax.tree.leaves(params)):
            saved[f"{arch}|w|{i}"] = np.asarray(leaf)
        rng = np.random.default_rng(args["seed"])
        ins = {"tokens": rng.integers(0, cfg.vocab_size, (b, l)).astype(
            np.int32)}
        if cfg.family == "vlm":
            ins["vision_embeds"] = rng.standard_normal(
                (b, cfg.frontend_seq, cfg.d_model)).astype(np.float32)
        caches = jax.tree.map(
            lambda x: rng.standard_normal(x.shape).astype(np.float32),
            jax.eval_shape(lambda: tf.init_caches(cfg, b, s)))
        token = rng.integers(0, cfg.vocab_size, (b,)).astype(np.int32)
        pos = rng.integers(l, s, (b,)).astype(np.int32)
        for k, v in ins.items():
            saved[f"{arch}|in|{k}"] = v
        for k, v in caches["attn"].items():
            saved[f"{arch}|in|cache_{k}"] = v
        saved[f"{arch}|in|token"], saved[f"{arch}|in|pos"] = token, pos

        prefill, serve = make_prefill(cfg), make_serve_step(cfg)
        names = list(ins)

        def pre(p, *xs):
            return prefill(p, **dict(zip(names, xs)))

        def keep(tag, logits, new=None):
            saved[f"{arch}|{tag}|logits"] = np.asarray(logits)
            if new is not None:
                for k, v in new["attn"].items():
                    saved[f"{arch}|{tag}|cache_{k}"] = np.asarray(v)

        keep("prefill|none", jax.jit(pre)(params, *ins.values()))
        keep("decode|none", *jax.jit(serve)(params, caches, token, pos))
        for mname, sizes in args["meshes"].items():
            mesh = jax.make_mesh(tuple(sizes), ("data", "model"))
            ps = shd.param_shardings(params, mesh)
            bs = shd.batch_shardings(ins, mesh)
            cs = shd.cache_shardings(caches, mesh)
            vec = shd.vector_sharding(mesh, b)
            lsh = shd.logits_sharding(mesh, b)
            try:
                keep(f"prefill|{mname}", jax.jit(
                    pre, in_shardings=(ps, *(bs[k] for k in names)),
                    out_shardings=lsh)(params, *ins.values()))
                keep(f"decode|{mname}", *jax.jit(
                    serve, in_shardings=(ps, cs, vec, vec),
                    out_shardings=(lsh, cs))(params, caches, token, pos))
            except Exception as e:  # recorded; the test says so
                errors[f"{arch}|{mname}"] = f"{type(e).__name__}: {e}"
    np.savez(os.path.join(out_dir, "ref.npz"), **saved)
    with open(os.path.join(out_dir, "errors.json"), "w") as f:
        json.dump(errors, f)
""")


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("partition_ref")
    args = {"archs": ARCHS, "meshes": MESHES, "batch": BATCH, "seq": SEQ,
            "cache": CACHE, "seed": SEED}
    env = {**os.environ, "PYTHONPATH": str(SRC), "JAX_PLATFORMS": "cpu"}
    run = subprocess.run([sys.executable, "-c", _REF, str(d), json.dumps(args)],
                         capture_output=True, text=True, env=env, timeout=600)
    assert run.returncode == 0, run.stdout + run.stderr
    with np.load(d / "ref.npz") as z:
        arrays = dict(z)
    return {"arrays": arrays,
            "errors": json.loads((d / "errors.json").read_text())}


def test_reference_sharded_jit_runs(ref):
    """The installed JAX runs every sharded jit of the reference side
    (else the comparisons fall back to its unsharded step)."""
    assert ref["errors"] == {}


def cpu_mesh(sizes) -> Mesh:
    return Mesh(sizes, ("data", "model"), [CPU] * int(np.prod(sizes)))


def test_attention_splits():
    """How the smoke archs' attention splits: decode follows the cache's
    layout (kv heads, else head_dim), prefill splits the query heads
    where the kv heads do not divide but the query heads do."""
    cfg = smoke_config("yi-6b")            # 4 query heads, 2 kv heads
    assert [partition._attention_mode(cfg, tp) for tp in (1, 2, 4, 8)] == \
        ["heads", "heads", "hd", "hd"]
    trace = {}
    for tp in (2, 4, 8):
        step = partition.partitioned_step(
            make_prefill(cfg), (shd.param_shardings(
                init_lm(cfg, device="meta"), Mesh((1, tp), ("data", "model"))),
                shd.Sharding(Mesh((1, tp), ("data", "model")), shd.P())),
            None)
        prog = partition._Program(cfg, partition.Positions(step.mesh, [0],
                                                           meta=True))
        args, kw = _meta_args(cfg, "prefill")
        local = step.local_arguments(*args, **kw)
        prog.prefill(local["params"], local["tokens"], None)
        trace[tp] = prog.mode
    assert trace == {2: "heads", 4: "qheads", 8: "hd"}


def _cfg(arch):
    return smoke_config(arch).replace(param_dtype="float32")


def _inputs(ref, arch):
    """The reference's weights and inputs as the port's tensors."""
    a = ref["arrays"]
    cfg = _cfg(arch)
    like = init_lm(cfg, device="meta")
    params = params_from_numpy(unflatten(like, [
        a[f"{arch}|w|{i}"] for i in range(len(flatten(like)))]), CPU)

    def get(k):
        return torch.from_numpy(a[f"{arch}|in|{k}"].copy())

    ins = {"tokens": get("tokens")}
    if cfg.family == "vlm":
        ins["vision_embeds"] = get("vision_embeds")
    caches = {"attn": {k: get(f"cache_{k}") for k in ("k", "v")}}
    return cfg, params, ins, caches, get("token"), get("pos")


def _want(ref, arch, tag, mname):
    """The reference's sharded output (its unsharded one where the
    sharded jit raised, as ``test_reference_sharded_jit_runs`` says)."""
    a = ref["arrays"]
    key = f"{arch}|{tag}|{mname}"
    return key if f"{key}|logits" in a else f"{arch}|{tag}|none"


def _prefill_step(cfg, mesh, ins):
    bs = shd.batch_shardings(ins, mesh)
    params_like = init_lm(cfg, device="meta")
    ps = shd.param_shardings(params_like, mesh)
    return ps, bs, partition.partitioned_step(
        make_prefill(cfg), (ps, bs["tokens"], None, bs.get("vision_embeds")),
        shd.logits_sharding(mesh, BATCH))


def _decode_step(cfg, mesh, caches):
    ps = shd.param_shardings(init_lm(cfg, device="meta"), mesh)
    cs = shd.cache_shardings(caches, mesh)
    vec = shd.vector_sharding(mesh, BATCH)
    return ps, cs, vec, partition.partitioned_step(
        make_serve_step(cfg), (ps, cs, vec, vec),
        (shd.logits_sharding(mesh, BATCH), cs))


def _run_decode(cfg, mesh, params, caches, token, pos):
    ps, cs, vec, step = _decode_step(cfg, mesh, caches)
    placed = shd.place(caches, cs)
    logits, new = step(shd.place(params, ps), placed, shd.place(token, vec),
                       shd.place(pos, vec))
    return logits, new, placed


@pytest.mark.parametrize("mname", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_equals_reference(ref, arch, mname):
    """Partitioned prefill logits within 1e-5 of the reference's sharded
    jit and of the port's unpartitioned prefill, laid out by
    ``logits_sharding``."""
    cfg, params, ins, _, _, _ = _inputs(ref, arch)
    mesh = cpu_mesh(MESHES[mname])
    ps, bs, step = _prefill_step(cfg, mesh, ins)
    got = step(shd.place(params, ps), **shd.place(ins, bs))
    assert isinstance(got, shd.Sharded)
    assert got.sharding.spec == shd.logits_sharding(mesh, BATCH).spec
    whole = got.gather(CPU).numpy()
    np.testing.assert_allclose(
        whole, ref["arrays"][_want(ref, arch, "prefill", mname) + "|logits"],
        **TOL)
    np.testing.assert_allclose(whole, make_prefill(cfg)(params, **ins)
                               .numpy(), **TOL)


@pytest.mark.parametrize("mname", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_equals_reference(ref, arch, mname):
    """Partitioned decode: logits and the caches it wrote within 1e-5 of
    the reference's sharded jit and of the port's unpartitioned step;
    each position's cache shard against its slice of the unpartitioned
    cache; the argument caches left as they were."""
    cfg, params, _, caches, token, pos = _inputs(ref, arch)
    mesh = cpu_mesh(MESHES[mname])
    logits, new, placed = _run_decode(cfg, mesh, params, caches, token, pos)
    key = _want(ref, arch, "decode", mname)
    a = ref["arrays"]
    np.testing.assert_allclose(logits.gather(CPU).numpy(),
                               a[key + "|logits"], **TOL)
    mine = {"attn": {k: v.clone() for k, v in caches["attn"].items()}}
    want_logits, want_caches = make_serve_step(cfg)(params, mine, token, pos)
    np.testing.assert_allclose(logits.gather(CPU).numpy(),
                               want_logits.numpy(), **TOL)
    for name in ("k", "v"):
        leaf = new["attn"][name]
        assert leaf.sharding.spec == shd.cache_shardings(
            caches, mesh)["attn"][name].spec
        np.testing.assert_allclose(leaf.gather(CPU).numpy(),
                                   a[f"{key}|cache_{name}"], **TOL)
        whole = want_caches["attn"][name]
        for idx, part in zip(leaf.sharding.indices(leaf.shape), leaf.shards):
            np.testing.assert_allclose(part.numpy(), whole[idx].numpy(),
                                       **TOL)
        assert torch.equal(placed["attn"][name].gather(CPU),
                           caches["attn"][name])


def _meta_args(cfg, kind):
    """Whole ``meta`` arguments of a step of ``kind``."""
    params = init_lm(cfg, device="meta")
    if kind == "prefill":
        return (params,), {"tokens": torch.empty(
            (BATCH, SEQ), dtype=torch.int32, device="meta")}
    caches = init_caches(cfg, BATCH, CACHE, device="meta")
    vec = torch.empty((BATCH,), dtype=torch.int32, device="meta")
    return (params, caches, vec, vec), {}


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_each_position_computes_its_share(kind):
    """yi-6b over (2, 2): each position's program, traced alone on
    ``meta``, counts at most 1.25 x the unpartitioned step's FLOPs over
    the 4 positions, and the four counts are equal."""
    cfg = smoke_config("yi-6b")
    mesh = Mesh((2, 2), ("data", "model"))
    args, kw = _meta_args(cfg, kind)
    if kind == "prefill":
        fn = make_prefill(cfg)
        ins = {"tokens": kw["tokens"]}
        ps, bs = shd.param_shardings(args[0], mesh), shd.batch_shardings(
            ins, mesh)
        step = partition.partitioned_step(fn, (ps, bs["tokens"]),
                                          shd.logits_sharding(mesh, BATCH))
    else:
        fn = make_serve_step(cfg)
        ps, cs, vec, step = _decode_step(cfg, mesh, args[1])
    with FlopCounterMode(display=False) as fc:
        fn(*args, **kw)
    total = fc.get_total_flops()
    counts = []
    for k in range(mesh.size):
        local = step.local_arguments(*args, **kw)
        with FlopCounterMode(display=False) as fc:
            step.run_position(local, position=k)
        counts.append(fc.get_total_flops())
    assert len(set(counts)) == 1, counts
    assert 0 < counts[0] <= 1.25 * total / mesh.size, (counts, total)


@pytest.mark.parametrize("arch,sizes", [
    ("qwen2-72b", (1, 4)), ("granite-3-8b", (1, 4)),
    ("phi3-medium-14b", (1, 4)), ("arctic-480b", (1, 4)),
    ("yi-6b", (1, 8))])
def test_other_archs_equal_unpartitioned(arch, sizes):
    """The other archs the slice partitions (qkv biases; arctic's MoE
    beside a dense MLP) over (1, 4), where smoke sizes split the query
    heads in prefill and ``head_dim`` in decode, and yi-6b over (1, 8),
    where 4 query heads do not divide and prefill splits ``head_dim``
    too: prefill and decode within 1e-5 of the unpartitioned steps on
    the same seeded weights and inputs."""
    cfg = _cfg(arch)
    gen = torch.Generator().manual_seed(7)
    params = init_lm(cfg, generator=gen, device="cpu")
    mesh = cpu_mesh(sizes)
    tokens = torch.randint(0, cfg.vocab_size, (BATCH, SEQ), generator=gen)
    ps, bs, pre = _prefill_step(cfg, mesh, {"tokens": tokens})
    got = pre(shd.place(params, ps), shd.place(tokens, bs["tokens"]))
    np.testing.assert_allclose(got.gather(CPU).numpy(),
                               make_prefill(cfg)(params, tokens).numpy(),
                               **TOL)
    caches = {"attn": {k: torch.randn(v.shape, generator=gen) for k, v in
                       init_caches(cfg, BATCH, CACHE, "cpu")["attn"].items()}}
    token = torch.randint(0, cfg.vocab_size, (BATCH,), generator=gen)
    pos = torch.randint(SEQ, CACHE, (BATCH,), generator=gen)
    logits, new, _ = _run_decode(cfg, mesh, params, caches, token, pos)
    want, want_caches = make_serve_step(cfg)(params, caches, token, pos)
    np.testing.assert_allclose(logits.gather(CPU).numpy(), want.numpy(),
                               **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(new["attn"][name].gather(CPU).numpy(),
                                   want_caches["attn"][name].numpy(), **TOL)


# -- the collectives -------------------------------------------------------------

def _ring(kind, in_bytes, out_bytes):
    return {"all-gather": out_bytes, "all-reduce": 2 * in_bytes}.get(
        kind, in_bytes)


@pytest.mark.parametrize("kind", partition.KINDS)
def test_collective_values_and_bytes(kind):
    """Over ``model`` (4 positions) of a (2, 4) CPU mesh: each position's
    result ``==`` its group's rank-order sum or concatenation, and the
    ledger holds the ring accounting of one position's bytes."""
    mesh = cpu_mesh((2, 4))
    pos = partition.Positions(mesh, range(mesh.size))
    gen = torch.Generator().manual_seed(3)
    vals = [torch.randn((4, 6), generator=gen) for _ in range(mesh.size)]
    fns = {"all-gather": lambda: partition.all_gather(pos, vals, ("model",),
                                                      1),
           "all-reduce": lambda: partition.all_reduce(pos, vals, ("model",)),
           "reduce-scatter": lambda: partition.reduce_scatter(
               pos, vals, ("model",), 0),
           "all-to-all": lambda: partition.all_to_all(pos, vals, ("model",),
                                                      0, 1),
           "collective-permute": lambda: partition.permute(
               pos, vals, ("model",), 1)}
    with partition.CollectiveLedger() as ledger:
        out = fns[kind]()
    for k in range(mesh.size):
        row, r = divmod(k, 4)
        parts = vals[row * 4:(row + 1) * 4]
        total = parts[0] + parts[1] + parts[2] + parts[3]
        want = {"all-gather": torch.cat(parts, 1),
                "all-reduce": total,
                "reduce-scatter": total[r:r + 1],
                "all-to-all": torch.cat([p[r:r + 1] for p in parts], 1),
                "collective-permute": parts[(r - 1) % 4]}[kind]
        assert torch.equal(out[k], want), (kind, k)
    in_b = 4 * 6 * 4
    out_b = out[0].numel() * 4
    assert ledger.bytes == {**dict.fromkeys(partition.KINDS, 0),
                            kind: _ring(kind, in_b, out_b)}
    assert ledger.calls[kind] == 1
    assert ledger.totals()["total"] == _ring(kind, in_b, out_b)
    # over an axis of one position nothing moves and nothing is charged
    with partition.CollectiveLedger() as ledger:
        assert partition.all_reduce(pos, vals, ()) == vals
    assert ledger.totals()["total"] == 0


# -- planted faults ------------------------------------------------------------------

def _rel(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


def test_dropped_partial_reads_above_tolerance(ref, monkeypatch):
    """Model rank 1's partial dropped from the second all-reduce (layer
    0's attention output; the first is the embedding's) of yi-6b's
    decode over (2, 2): the logits move past 1e-5 of the unpartitioned
    step's."""
    cfg, params, _, caches, token, pos = _inputs(ref, "yi-6b")
    mesh = cpu_mesh((2, 2))
    real, calls = partition.all_reduce, []

    def dropped(p, vals, axes):
        calls.append(axes)
        if len(calls) == 2:
            vals = [torch.zeros_like(v) if p.part(k, ("model",)) == 1 else v
                    for k, v in zip(p.ks, vals)]
        return real(p, vals, axes)

    monkeypatch.setattr(partition, "all_reduce", dropped)
    logits, _, _ = _run_decode(cfg, mesh, params, caches, token, pos)
    mine = {"attn": {k: v.clone() for k, v in caches["attn"].items()}}
    want, _ = make_serve_step(cfg)(params, mine, token, pos)
    # the embedding's, then attention's and the MLP's in each of 2 layers
    assert calls == [("model",)] * 5
    assert _rel(logits.gather(CPU), want) > 1e-5


def test_wrong_cache_slice_reads_above_tolerance(ref):
    """internvl2-1b's decode over (1, 4) splits the cache's head_dim:
    positions 1 and 2 computing on each other's slices move the logits
    past 1e-5."""
    cfg, params, _, caches, token, pos = _inputs(ref, "internvl2-1b")
    mesh = cpu_mesh((1, 4))
    ps, cs, vec, step = _decode_step(cfg, mesh, caches)
    assert cs["attn"]["k"].spec[4] == "model"
    placed = shd.place(caches, cs)
    for name in ("k", "v"):
        leaf = placed["attn"][name]
        s = list(leaf.shards)
        s[1], s[2] = s[2], s[1]
        placed["attn"][name] = shd.Sharded(leaf.shape, leaf.dtype,
                                           leaf.sharding, s)
    logits, _ = step(shd.place(params, ps), placed, shd.place(token, vec),
                     shd.place(pos, vec))
    mine = {"attn": {k: v.clone() for k, v in caches["attn"].items()}}
    want, _ = make_serve_step(cfg)(params, mine, token, pos)
    assert _rel(logits.gather(CPU), want) > 1e-5


def test_never_gathers_an_argument(ref, monkeypatch):
    """A run over (2, 2) calls no ``Sharded.gather`` and no
    ``sharding.gather``: nothing falls back to the whole tensors."""
    cfg, params, _, caches, token, pos = _inputs(ref, "internvl2-1b")
    mesh = cpu_mesh((2, 2))
    ps, cs, vec, step = _decode_step(cfg, mesh, caches)
    args = (shd.place(params, ps), shd.place(caches, cs),
            shd.place(token, vec), shd.place(pos, vec))

    def refuse(*a, **k):
        raise AssertionError("gathered")

    monkeypatch.setattr(shd.Sharded, "gather", refuse)
    monkeypatch.setattr(shd, "gather", refuse)
    logits, new = step(*args)
    assert isinstance(logits, shd.Sharded)
    assert isinstance(new["attn"]["k"], shd.Sharded)


def test_position_trace_has_the_run_shapes(ref):
    """The program of one position traced on ``meta`` gives that
    position's logits and cache shapes of the run."""
    cfg, params, _, caches, token, pos = _inputs(ref, "internvl2-1b")
    mesh = cpu_mesh((1, 4))
    logits, new, _ = _run_decode(cfg, mesh, params, caches, token, pos)
    _, _, _, step = _decode_step(cfg, mesh, caches)
    args, kw = _meta_args(cfg, "decode")
    t_logits, t_new = step.run_position(step.local_arguments(*args, **kw),
                                        position=3)
    assert t_logits.device.type == "meta"
    assert t_logits.shape == logits.shards[3].shape
    for name in ("k", "v"):
        assert t_new["attn"][name].shape == new["attn"][name].shards[3].shape


# -- what the slice does not partition -------------------------------------------------

@pytest.mark.parametrize("what", ["padded-kv-heads", "seamless-m4t-medium",
                                  "int8", "moe-dense"])
def test_unsupported_raise(what):
    """Padded kv heads, seamless-m4t-medium, an int8 tree and
    ``moe_impl="dense"`` partition over (2, 2): a decode (padded heads)
    or prefill equals the unpartitioned step within 1e-5 (their parity
    with the reference: ``test_torch_partition_int8.py``,
    ``test_torch_partition_encdec.py`` and
    ``test_torch_partition_dense.py``)."""
    mesh = cpu_mesh((2, 2))
    arch = {"padded-kv-heads": "yi-6b", "int8": "yi-6b",
            "moe-dense": "granite-moe-1b-a400m"}.get(what, what)
    cfg = _cfg(arch)
    if what == "padded-kv-heads":
        cfg = cfg.replace(kv_head_pad=4)
    if what == "moe-dense":
        cfg = cfg.replace(moe_impl="dense")
    gen = torch.Generator().manual_seed(0)
    params = init_lm(cfg, generator=gen, device="cpu")
    if what == "int8":
        params = quantize_tree(params)
    ps = shd.param_shardings(params, mesh)
    vec = shd.vector_sharding(mesh, BATCH)
    if what == "padded-kv-heads":
        caches = {"attn": {k: torch.randn(v.shape, generator=gen) for k, v in
                           init_caches(cfg, BATCH, CACHE, "cpu")["attn"]
                           .items()}}
        assert caches["attn"]["k"].shape[3] == 4
        token = torch.randint(0, cfg.vocab_size, (BATCH,), generator=gen)
        pos = torch.randint(SEQ, CACHE, (BATCH,), generator=gen)
        logits, _, _ = _run_decode(cfg, mesh, params, caches, token, pos)
        want, _ = make_serve_step(cfg)(params, caches, token, pos)
        np.testing.assert_allclose(logits.gather(CPU).numpy(), want.numpy(),
                                   **TOL)
        return
    ins = {"tokens": torch.randint(0, cfg.vocab_size, (BATCH, SEQ),
                                   generator=gen)}
    if cfg.is_encdec:
        ins["encoder_feats"] = torch.randn((BATCH, SEQ // 4, cfg.d_model),
                                           generator=gen)
    bs = shd.batch_shardings(ins, mesh)
    step = partition.partitioned_step(
        make_prefill(cfg), (ps, bs["tokens"], bs.get("encoder_feats")),
        shd.logits_sharding(mesh, BATCH))
    got = step(shd.place(params, ps), **shd.place(ins, bs))
    np.testing.assert_allclose(got.gather(CPU).numpy(),
                               make_prefill(cfg)(params, **ins).numpy(), **TOL)


def test_other_functions_raise():
    mesh = cpu_mesh((2, 2))
    vec = shd.vector_sharding(mesh, BATCH)
    cfg = smoke_config("yi-6b")
    with pytest.raises(ValueError, match="make_prefill or make_serve_step"):
        partition.partitioned_step(lambda p, t: t, (None, vec), vec)
    with pytest.raises(ValueError, match="make_prefill or make_serve_step"):
        partition.partitioned_step(shd.sharded_step, (None, vec), vec)
    with pytest.raises(ValueError, match="needs a Sharding"):
        partition.partitioned_step(make_prefill(cfg), (None, None), None)
