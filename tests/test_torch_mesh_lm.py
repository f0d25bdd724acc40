"""The LM side over a device mesh, on the CPU: meshes of CPU positions
against the JAX package's real multi-device runs.

The reference side runs once, in a module-scoped subprocess with 8
forced host devices (``--xla_force_host_platform_device_count=8``):

- placement: every leaf of each smoke arch's params (``2d`` and
  ``serve``), optimizer state, batch and caches, each filled with
  seeded normals, ``jax.device_put`` by the reference's shardings on
  (8,) ``("model",)``, (4, 2) and (2, 4) ``("data", "model")`` and
  (2, 2, 2) ``("pod", "data", "model")``.  Every shard's index and the
  sha1 of its bytes ``==`` the port's ``place`` on a mesh of as many CPU
  positions;
- ``moe_forward_ep`` of smoke granite-moe-1b-a400m (float32, x of
  (4, 8, 64), top-2) under ``with mesh:`` on (1, 4), (2, 4) and (4, 2),
  with float and int8-quantized weights: the port's output within
  rtol = atol = 1e-5, its aux within 1e-6.  Under a data axis the
  reference dispatches each data shard alone and returns data shard 0's
  aux (its ``out_specs=P()`` has no replication check), and so does
  the port;
- ``gpipe`` over 4 positions of ``pod``: the port's forward within
  2e-5 (its backward against the sequential blocks, as
  ``tests/test_torch_pipeline.py``);
- the first 4 unsharded jitted train steps of the elastic drill of
  ``tests/test_elastic.py`` (smoke yi-6b in float32, AdamW eps 1e-3 as
  ``tests/test_torch_train_step.py`` explains), from the weights it
  hands the port.

The port's drill trains on a (4, 2) mesh of CPU positions, checkpoints,
takes ``recovery_plan(4, 2, 8)`` and ``reshard_restore``s onto (2, 2):
its 8 losses ``==`` the uninterrupted unsharded run's, and every shard
``==`` its slice of the gathered leaf.
"""

import contextlib
import hashlib
import json
import os
import subprocess
import sys
import textwrap
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, smoke_config
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.pipeline import gpipe, split_stages
from repro_torch.launch.mesh import Mesh
from repro_torch.models.moe import moe_forward_ep, moe_forward_grouped
from repro_torch.models.params import flatten, params_from_numpy, unflatten
from repro_torch.models.transformer import init_caches, init_lm
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as opt
from repro_torch.train.data import DataConfig, synth_batch
from repro_torch.train.fault_tolerance import recovery_plan
from repro_torch.train.train_loop import make_train_step

SRC = Path(__file__).resolve().parents[1] / "src"
CPU = torch.device("cpu")
PLACE_MESHES = {"8": ((8,), ("model",)), "4x2": ((4, 2), ("data", "model")),
                "2x4": ((2, 4), ("data", "model")),
                "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
EP_MESHES = {"1x4": (1, 4), "2x4": (2, 4), "4x2": (4, 2)}
BATCH_DC = DataConfig(seq_len=16, global_batch=8, seed=0)
CACHE_LEN = 32
MOE_X = (4, 8, 64)
PIPE = dict(s=4, l=8, d=16, b=8, n_micro=4)
OPT_KW = dict(lr=1e-3, eps=1e-3, warmup_steps=2, total_steps=40)
DRILL_DC = DataConfig(seq_len=32, global_batch=8, seed=0)

_REF = textwrap.dedent("""
    import hashlib, json, os, sys, zlib
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import NamedSharding
    from repro.configs import ARCHS, smoke_config
    from repro.distributed import sharding as shd
    from repro.distributed.pipeline import gpipe, split_stages
    from repro.models import moe as moe_mod, quantized as quant
    from repro.models import transformer as tf
    from repro.train import optimizer as opt, train_loop as tl
    from repro.train.data import DataConfig, synth_batch

    out_dir, args = sys.argv[1], json.loads(sys.argv[2])

    def name(path):
        return "/".join(str(getattr(k, "key", getattr(k, "name", k)))
                        for k in path)

    def data(key, shape):
        rng = np.random.default_rng(zlib.crc32(key.encode()))
        return rng.standard_normal(shape).astype(np.float32)

    # -- placement -------------------------------------------------------
    place = {}
    for mname, (sizes, axes) in args["place_meshes"].items():
        mesh = jax.make_mesh(tuple(sizes), tuple(axes))
        order = list(mesh.devices.flat)
        for arch in sorted(ARCHS):
            cfg = smoke_config(arch)
            params = jax.eval_shape(lambda: tf.init_lm(jax.random.PRNGKey(0),
                                                       cfg))
            dc = DataConfig(*args["batch_dc"])
            trees = {
                "params": (params, shd.param_shardings(params, mesh)),
                "serve": (params, shd.param_shardings(params, mesh, "serve")),
                "caches": (jax.eval_shape(lambda: tf.init_caches(
                    cfg, dc.global_batch, args["cache_len"])), None),
                "batch": (synth_batch(cfg, dc, 0), None),
            }
            state = jax.eval_shape(opt.init, params)
            trees["opt"] = (state, shd.opt_shardings(state, params, mesh))
            trees["caches"] = (trees["caches"][0],
                               shd.cache_shardings(trees["caches"][0], mesh))
            trees["batch"] = (trees["batch"][0],
                              shd.batch_shardings(trees["batch"][0], mesh))
            for kind, (tree, shardings) in trees.items():
                leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
                shs = jax.tree_util.tree_leaves(
                    shardings, is_leaf=lambda s: isinstance(s, NamedSharding))
                for (path, leaf), s in zip(leaves, shs):
                    key = f"{arch}|{kind}|{name(path)}"
                    arr = jax.device_put(data(key, leaf.shape), s)
                    got = [None] * len(order)
                    for sh in arr.addressable_shards:
                        idx = [list(sl.indices(n)[:2]) for sl, n in
                               zip(sh.index, leaf.shape)]
                        got[order.index(sh.device)] = [idx, hashlib.sha1(
                            np.ascontiguousarray(sh.data)).hexdigest()]
                    place[f"{mname}|{key}"] = got

    # -- moe_forward_ep under `with mesh:` ---------------------------------
    cfg = smoke_config("granite-moe-1b-a400m").replace(param_dtype="float32")
    p = moe_mod.moe_init(jax.random.PRNGKey(3), cfg.d_model, cfg.moe_d_ff,
                         cfg.n_experts, cfg.act, jnp.float32)
    x = np.random.default_rng(4).standard_normal(args["moe_x"]).astype(
        np.float32)
    saved = {"x": x}
    for kind, w in (("float", p), ("int8", quant.quantize_tree(p))):
        for k, v in jax.tree_util.tree_flatten_with_path(w)[0]:
            saved[f"w|{kind}|{name(k)}"] = np.asarray(v)
        for mname, sizes in args["ep_meshes"].items():
            mesh = jax.make_mesh(tuple(sizes), ("data", "model"))
            with mesh:
                out, aux = jax.jit(lambda w, x: moe_mod.moe_forward_ep(
                    w, x, top_k=cfg.experts_per_token, act=cfg.act))(
                        w, jnp.asarray(x))
            saved[f"ep|{kind}|{mname}|out"] = np.asarray(out)
            saved[f"ep|{kind}|{mname}|aux"] = np.asarray(aux)

    # -- gpipe over 4 positions --------------------------------------------
    pp = args["pipe"]
    rng = np.random.default_rng(0)
    ws = (rng.normal(size=(pp["l"], pp["d"], pp["d"])) * 0.3).astype(
        np.float32)
    xp = rng.normal(size=(pp["b"], pp["d"])).astype(np.float32)

    def stage_fn(stage_ws, h):
        def body(hh, w):
            return jnp.tanh(hh @ w), None
        return jax.lax.scan(body, h, stage_ws)[0]

    saved["pipe"] = np.asarray(gpipe(
        stage_fn, split_stages(jnp.asarray(ws), pp["s"]), jnp.asarray(xp),
        mesh=jax.make_mesh((pp["s"],), ("pod",)), axis="pod",
        n_micro=pp["n_micro"]))

    # -- the drill's first 4 unsharded jitted steps ------------------------
    rcfg = smoke_config("yi-6b").replace(param_dtype="float32")
    rp = tf.init_lm(jax.random.PRNGKey(0), rcfg)
    for i, leaf in enumerate(jax.tree.leaves(rp)):
        saved[f"drill|leaf_{i}"] = np.asarray(leaf)
    step = jax.jit(tl.make_train_step(rcfg, opt.AdamWConfig(**args["opt"])))
    rs, losses = opt.init(rp), []
    dc = DataConfig(*args["drill_dc"])
    for s in range(4):
        b = {k: jnp.asarray(v) for k, v in synth_batch(rcfg, dc, s).items()}
        rp, rs, m = step(rp, rs, b)
        losses.append(float(m["loss"]))
    saved["drill|losses"] = np.asarray(losses)

    np.savez(os.path.join(out_dir, "ref.npz"), **saved)
    with open(os.path.join(out_dir, "place.json"), "w") as f:
        json.dump(place, f)
""")


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_lm_ref")
    args = {"place_meshes": PLACE_MESHES, "ep_meshes": EP_MESHES,
            "batch_dc": [BATCH_DC.seq_len, BATCH_DC.global_batch,
                         BATCH_DC.seed],
            "cache_len": CACHE_LEN, "moe_x": MOE_X, "pipe": PIPE,
            "opt": OPT_KW, "drill_dc": [DRILL_DC.seq_len,
                                        DRILL_DC.global_batch, DRILL_DC.seed]}
    env = {**os.environ, "PYTHONPATH": str(SRC), "JAX_PLATFORMS": "cpu"}
    run = subprocess.run([sys.executable, "-c", _REF, str(d), json.dumps(args)],
                         capture_output=True, text=True, env=env, timeout=600)
    assert run.returncode == 0, run.stdout + run.stderr
    with np.load(d / "ref.npz") as z:
        arrays = dict(z)
    return {"arrays": arrays,
            "place": json.loads((d / "place.json").read_text())}


def cpu_mesh(sizes, axes) -> Mesh:
    return Mesh(sizes, axes, [CPU] * int(np.prod(sizes)))


# -- placement -------------------------------------------------------------

def _data(key, shape):
    rng = np.random.default_rng(zlib.crc32(key.encode()))
    return torch.from_numpy(rng.standard_normal(tuple(shape)).astype(
        np.float32))


def _port_trees(cfg, mesh):
    """(tree of seeded tensors, shardings) per kind, as the reference
    subprocess builds them."""
    params = init_lm(cfg, device="meta")
    state = opt.init(params)
    caches = init_caches(cfg, BATCH_DC.global_batch, CACHE_LEN, "meta")
    batch = {k: torch.from_numpy(v)
             for k, v in synth_batch(cfg, BATCH_DC, 0).items()}
    return {"params": (params, shd.param_shardings(params, mesh)),
            "serve": (params, shd.param_shardings(params, mesh, "serve")),
            "opt": (state, shd.opt_shardings(state, params, mesh)),
            "caches": (caches, shd.cache_shardings(caches, mesh)),
            "batch": (batch, shd.batch_shardings(batch, mesh))}


@pytest.mark.parametrize("arch", sorted(ARCHS))
@pytest.mark.parametrize("mesh_name", list(PLACE_MESHES))
def test_place_shards_equal_reference(ref, mesh_name, arch):
    """Every shard of every leaf: its index and its bytes ``==`` the
    reference's ``addressable_shards`` at the same mesh position."""
    mesh = cpu_mesh(*PLACE_MESHES[mesh_name])
    n = 0
    for kind, (tree, shardings) in _port_trees(smoke_config(arch),
                                                mesh).items():
        keys = {}

        def fill(path, leaf):
            key = f"{arch}|{kind}|{'/'.join(map(str, path))}"
            keys[path] = key
            return _data(key, leaf.shape)

        placed = shd.place(shd.tree_map_with_path(fill, tree), shardings)

        def check(path, leaf):
            nonlocal n
            want = ref["place"][f"{mesh_name}|{keys[path]}"]
            assert isinstance(leaf, shd.Sharded), keys[path]
            idx = leaf.sharding.indices(leaf.shape)
            got = [[[[s.start, s.stop] for s in i],
                    hashlib.sha1(part.numpy()).hexdigest()]
                   for i, part in zip(idx, leaf.shards)]
            assert got == want, keys[path]
            n += 1

        shd.tree_map_with_path(check, placed)
    assert n > 0


def test_sharded_gather_and_reshard_roundtrip():
    """``shard`` then ``gather`` is the identity; replicated positions
    hold copies of their own; a Sharded leaf placed on another mesh is
    gathered and cut anew; a one-device mesh gives plain tensors."""
    x = torch.arange(48, dtype=torch.float32).reshape(4, 6, 2)
    m8 = cpu_mesh((2, 2, 2), ("pod", "data", "model"))
    s = shd.Sharding(m8, shd.P(("pod", "data"), "model"))
    sx = shd.shard(x, s)
    assert [tuple(t.shape) for t in sx.shards] == [(1, 3, 2)] * 8
    assert torch.equal(sx.gather(CPU), x)
    assert torch.equal(sx.shards[5], x[2:3, 3:6])       # pod 1, data 0, model 1
    m4 = cpu_mesh((2, 2), ("data", "model"))
    rep = shd.place({"x": sx}, {"x": shd.Sharding(m4, shd.P(None, "data"))})
    assert torch.equal(rep["x"].shards[1], x[:, :3])     # data 0, model 1
    assert rep["x"].shards[0].data_ptr() != rep["x"].shards[1].data_ptr()
    one = shd.place({"x": sx}, {"x": shd.Sharding(cpu_mesh((1,), ("data",)),
                                                  shd.P("data"))})
    assert isinstance(one["x"], torch.Tensor) and torch.equal(one["x"], x)
    with pytest.raises(ValueError, match="does not divide"):
        shd.shard(torch.zeros(3, 6), shd.Sharding(m4, shd.P("data")))


# -- moe_forward_ep ------------------------------------------------------------

def _moe_weights(ref, kind):
    """The reference's (possibly quantized) moe dict as the port's."""
    a = ref["arrays"]
    tree = {}
    for key, v in a.items():
        if key.startswith(f"w|{kind}|"):
            node, *rest = key.split("|")[2].split("/")
            if rest:
                tree.setdefault(node, {})[rest[0]] = v
            else:
                tree[node] = v
    return params_from_numpy(tree, CPU)


CFG_MOE = smoke_config("granite-moe-1b-a400m").replace(param_dtype="float32")


@pytest.mark.parametrize("kind", ["float", "int8"])
@pytest.mark.parametrize("mesh_name", list(EP_MESHES))
def test_moe_ep_equals_reference(ref, mesh_name, kind):
    """Output within 1e-5 of the reference's ``shard_map`` run, aux
    within 1e-6; the aux is data shard 0's and each data shard
    dispatched alone, as in the reference."""
    p = _moe_weights(ref, kind)
    x = torch.from_numpy(ref["arrays"]["x"])
    sizes = EP_MESHES[mesh_name]
    mesh = cpu_mesh(sizes, ("data", "model"))
    kw = dict(top_k=CFG_MOE.experts_per_token, act=CFG_MOE.act)
    with torch.no_grad():
        out, aux = moe_forward_ep(p, x, mesh=mesh, **kw)
        with mesh:
            ambient = moe_forward_ep(p, x, **kw)
        b_loc = x.shape[0] // sizes[0]
        shards = [moe_forward_grouped(p, x[i * b_loc:(i + 1) * b_loc], **kw)
                  for i in range(sizes[0])]
    assert torch.equal(ambient[0], out) and torch.equal(ambient[1], aux)
    want = ref["arrays"][f"ep|{kind}|{mesh_name}|out"]
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(aux),
                               float(ref["arrays"][f"ep|{kind}|{mesh_name}|aux"]),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        out.numpy(), torch.cat([o for o, _ in shards]).numpy(), rtol=1e-5,
        atol=1e-6)
    np.testing.assert_allclose(float(aux), float(shards[0][1]), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("mesh_name", list(EP_MESHES))
def test_moe_ep_uses_sharded_weights(ref, mesh_name):
    """Weights placed by the ``serve`` policy (experts on ``model``):
    each position reads its own shard, and the result ``==`` the run on
    whole tensors."""
    p = _moe_weights(ref, "float")
    x = torch.from_numpy(ref["arrays"]["x"])
    mesh = cpu_mesh(EP_MESHES[mesh_name], ("data", "model"))
    placed = shd.place(p, shd.param_shardings(p, mesh, "serve"))
    assert isinstance(placed["up"], shd.Sharded)
    kw = dict(top_k=CFG_MOE.experts_per_token, act=CFG_MOE.act, mesh=mesh)
    with torch.no_grad():
        a = moe_forward_ep(p, x, **kw)
        b = moe_forward_ep(placed, x, **kw)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_moe_ep_falls_back_as_the_reference():
    """No mesh, no ``model`` axis, or experts that do not divide over it:
    the grouped dispatch itself."""
    gen = torch.Generator().manual_seed(5)
    p = {k: v[0] for k, v in init_lm(CFG_MOE, generator=gen, device="cpu")
         ["blocks"]["moe"].items()}
    x = torch.randn((2, 8, CFG_MOE.d_model), generator=gen)
    kw = dict(top_k=2, act=CFG_MOE.act)
    want = moe_forward_grouped(p, x, **kw)
    for mesh in (None, cpu_mesh((4,), ("data",)),
                 cpu_mesh((1, 3), ("data", "model"))):
        got = moe_forward_ep(p, x, mesh=mesh, **kw)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_moe_ep_missing_device_raises():
    """A position whose device this process does not see raises: nothing
    carries on elsewhere."""
    gen = torch.Generator().manual_seed(6)
    p = {k: v[0] for k, v in init_lm(CFG_MOE, generator=gen, device="cpu")
         ["blocks"]["moe"].items()}
    x = torch.randn((2, 8, CFG_MOE.d_model), generator=gen)
    mesh = Mesh((1, 2), ("data", "model"), [CPU, torch.device("cuda", 99)])
    with pytest.raises(ValueError, match="does not exist"):
        moe_forward_ep(p, x, top_k=2, act=CFG_MOE.act, mesh=mesh)


def test_dryrun_moe_ep_traces_on_meta():
    """``--moe ep`` on the abstract production mesh traces on meta (every
    position on the meta device), with the argument bytes of ``--moe
    grouped`` (one layer of granite-moe-1b-a400m at its published
    width, decode_32k, 16 x 16)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import lower_cell
    res = {}
    for impl in ("grouped", "ep"):
        cfg = get_config("granite-moe-1b-a400m").replace(n_layers=1,
                                                         moe_impl=impl)
        res[impl] = lower_cell("granite-moe-1b-a400m", "decode_32k",
                               cfg_override=cfg)
    assert res["ep"]["memory"] == res["grouped"]["memory"]
    assert res["ep"]["flops_per_device"] > 0


# -- gpipe across positions ------------------------------------------------------

def _pipe_inputs():
    rng = np.random.default_rng(0)
    ws = (rng.normal(size=(PIPE["l"], PIPE["d"], PIPE["d"])) * 0.3).astype(
        np.float32)
    x = rng.normal(size=(PIPE["b"], PIPE["d"])).astype(np.float32)
    return torch.from_numpy(ws), torch.from_numpy(x)


def test_gpipe_over_positions_equals_reference(ref):
    """One stage a position of ``pod`` (4 CPU positions): the forward
    within 2e-5 of the reference's ``shard_map`` pipeline, each stage's
    input on its position's device; the gradients of sum(out**2) within
    rtol 5e-4, atol 5e-5 of the sequential blocks'."""
    ws, x = _pipe_inputs()
    ws.requires_grad_()
    mesh = cpu_mesh((PIPE["s"], 2), ("pod", "model"))
    seen = []

    def stage_fn(stage_ws, h):
        seen.append(h.device)
        for w in stage_ws:
            h = torch.tanh(h @ w)
        return h

    out = gpipe(stage_fn, split_stages(ws, PIPE["s"]), x, mesh=mesh,
                axis="pod", n_micro=PIPE["n_micro"])
    assert len(seen) == PIPE["s"] * (PIPE["n_micro"] + PIPE["s"] - 1)
    np.testing.assert_allclose(out.detach().numpy(), ref["arrays"]["pipe"],
                               rtol=2e-5, atol=2e-5)
    seq = x
    for i in range(PIPE["l"]):
        seq = torch.tanh(seq @ ws[i])
    g_pipe, = torch.autograd.grad((out ** 2).sum(), ws)
    g_seq, = torch.autograd.grad((seq ** 2).sum(), ws)
    np.testing.assert_allclose(g_pipe.numpy(), g_seq.numpy(), rtol=5e-4,
                               atol=5e-5)


def test_gpipe_missing_device_raises():
    ws, x = _pipe_inputs()
    mesh = Mesh((2,), ("pod",), [CPU, torch.device("cuda", 99)])
    with pytest.raises(ValueError, match="does not exist"):
        gpipe(lambda w, h: h, split_stages(ws, 2), x, mesh=mesh, n_micro=4)


# -- the elastic drill over CPU positions -------------------------------------

def _drill_batch(cfg, s):
    return {k: torch.from_numpy(v)
            for k, v in synth_batch(cfg, DRILL_DC, s).items()}


def _check_shards(tree) -> int:
    """Every shard of every Sharded leaf ``==`` its slice of the gathered
    leaf: the number of shards checked."""
    n = 0
    for leaf in flatten(tree):
        assert isinstance(leaf, shd.Sharded)
        whole = leaf.gather(CPU)
        for idx, part in zip(leaf.sharding.indices(leaf.shape), leaf.shards):
            assert torch.equal(part, whole[idx])
            n += 1
    return n


def test_elastic_drill_over_cpu_positions(ref, tmp_path):
    """tests/test_elastic.py's drill with meshes of CPU positions: 4
    sharded steps on (4, 2), checkpoint, lose half the chips, restore
    onto (2, 2), 4 more.  The 8 losses ``==`` the uninterrupted unsharded
    run's; the first 4 within rtol 1e-5 of the reference's jitted
    steps."""
    cfg = smoke_config("yi-6b").replace(param_dtype="float32")
    like = init_lm(cfg, device="meta")
    p0 = params_from_numpy(unflatten(like, [
        ref["arrays"][f"drill|leaf_{i}"] for i in range(len(flatten(like)))]),
        CPU)
    step = make_train_step(cfg, opt.AdamWConfig(**OPT_KW))

    params, state = p0, opt.init(p0)
    straight = []
    for s in range(8):
        params, state, m = step(params, state, _drill_batch(cfg, s))
        straight.append(float(m["loss"]))

    def make(mesh):
        ps = shd.param_shardings(p0, mesh)
        os_ = shd.opt_shardings(opt.init(p0), p0, mesh)
        bs = shd.batch_shardings(_drill_batch(cfg, 0), mesh)
        return ps, os_, shd.sharded_step(step, (ps, os_, bs),
                                         (ps, os_, None))

    mesh8 = cpu_mesh((4, 2), ("data", "model"))
    ps, os_, step8 = make(mesh8)
    params, state = shd.place(p0, ps), shd.place(opt.init(p0), os_)
    losses = []
    for s in range(4):
        params, state, m = step8(params, state, _drill_batch(cfg, s))
        losses.append(float(m["loss"]))
    assert _check_shards(params) > 0 and _check_shards(state) > 0
    d = str(tmp_path / "ck")
    ckpt.save(d, 4, params)
    ckpt.save(d + "_opt", 4, state)
    plan = recovery_plan(n_alive_chips=4, model_parallel=2, chips_per_pod=8)
    assert plan["mesh_shape"] == (1, 2, 2) and plan["chips_idle"] == 0
    mesh4 = cpu_mesh(plan["mesh_shape"][1:], ("data", "model"))
    ps4, os4, step4 = make(mesh4)
    params2 = ckpt.reshard_restore(d, 4, p0, ps4)
    state2 = ckpt.reshard_restore(d + "_opt", 4, opt.init(p0), os4)
    assert all(torch.equal(a, b) for a, b in zip(
        flatten(shd.gather(params2, CPU)), flatten(shd.gather(params, CPU))))
    assert params2["embed"]["emb"].sharding.mesh is mesh4
    assert int(state2.step.gather(CPU)) == 4
    for s in range(4, 8):
        params2, state2, m = step4(params2, state2, _drill_batch(cfg, s))
        losses.append(float(m["loss"]))
    _check_shards(params2)
    assert losses == straight
    assert losses[-1] < losses[0], losses
    np.testing.assert_allclose(losses[:4], ref["arrays"]["drill|losses"],
                               rtol=1e-5)


# -- the server under a mesh ---------------------------------------------------

def _served(cfg, params, mesh, prompts):
    """Greedy tokens and every step's logits of a 4-slot ``Server``
    through ``PumServeOffload`` on a CPU chip."""
    from repro_torch.core.chip import SimdramChip
    from repro_torch.train.serve import PumServeOffload, Request, Server
    off = PumServeOffload(chip=SimdramChip(n_banks=4, n_subarrays=2,
                                           device="cpu"))
    server = Server(cfg, params, batch_slots=4, max_len=32, pum_offload=off,
                    device="cpu")
    step, logits = server.step_fn, []

    def kept(*args):
        out = step(*args)
        logits.append(out[0].clone())
        return out

    server.step_fn = kept
    reqs = [Request(prompt=list(p), max_new=4) for p in prompts]
    for r in reqs:
        server.submit(r)
    with mesh if mesh is not None else contextlib.nullcontext():
        server.run()
    assert all(r.done for r in reqs) and off.chip.stats.rounds > 0
    return [r.out for r in reqs], torch.stack(logits)


def test_server_serves_moe_ep_under_a_mesh():
    """Smoke granite-moe-1b-a400m with ``moe_impl="ep"`` served under a
    (1, 4) mesh of CPU positions, one expert a position, through the
    offload: every step's logits within rtol = atol = 1e-5 of the grouped
    run without a mesh, its tokens ``==`` (no data split: the two
    dispatch the same tokens to the same slots)."""
    cfg = smoke_config("granite-moe-1b-a400m").replace(param_dtype="float32")
    params = init_lm(cfg, generator=torch.Generator().manual_seed(7),
                     device="cpu")
    prompts = [[5, 6, 7], [9, 3], [11, 12, 13, 14], [2]]
    ep_tokens, ep_logits = _served(cfg.replace(moe_impl="ep"), params,
                                   cpu_mesh((1, 4), ("data", "model")),
                                   prompts)
    tokens, logits = _served(cfg, params, None, prompts)
    torch.testing.assert_close(ep_logits, logits, rtol=1e-5, atol=1e-5)
    assert ep_tokens == tokens
