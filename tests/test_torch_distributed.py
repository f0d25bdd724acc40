"""The port's hints and collectives against the reference's, on the CPU.

- hints change nothing without a mesh, and under an abstract mesh the
  spec they fit equals the one the reference pins, read from its
  ``sharding_constraint`` in ``jax.make_jaxpr`` under
  ``jax.sharding.use_abstract_mesh``;
- ``async_allreduce_scan`` over a one-rank ``gloo`` group equals the
  reference's under ``shard_map`` on a one-device mesh (rtol 1e-5, float32
  gradients computed by two frameworks), and equals plain accumulation
  bit for bit;
- two ``gloo`` ranks (``torch.multiprocessing``, CPU):
  ``pod_psum_compressed`` over ``pod=2`` sums ``tests/test_distributed.py``'s
  two ``linspace`` rows within its bound ``4 * 2/127`` and ``==`` a numpy
  model of the int8 blocks, and ``async_allreduce_scan`` sums both ranks'
  gradients, ``==`` the same sums taken in the same order.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.distributed import collectives as ref_coll
from repro.distributed import hints as ref_hints
from repro.distributed import sharding as ref_shd
from repro_torch.configs import smoke_config
from repro_torch.distributed import collectives, hints
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import Mesh, ambient_mesh, make_production_mesh
from repro_torch.models.transformer import decode_step, init_caches, init_lm

SRC = Path(__file__).resolve().parents[1] / "src"
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def ref_pinned(fn, mesh_name, shape, dtype=jnp.bfloat16):
    """The spec the reference's ``fn`` pins for an input of ``shape``."""
    mesh = ref_shd.abstract_mesh(*MESHES[mesh_name])
    with jax.sharding.use_abstract_mesh(mesh):
        jp = jax.make_jaxpr(fn)(jax.ShapeDtypeStruct(shape, dtype))
    eqns = [e for e in jp.eqns if e.primitive.name == "sharding_constraint"]
    assert len(eqns) == 1, jp
    return tuple(eqns[0].params["sharding"].spec)


def port_pinned(fn, mesh_name, shape):
    mesh = shd.abstract_mesh(*MESHES[mesh_name])
    x = torch.empty(shape, dtype=torch.bfloat16, device="meta")
    with mesh:
        assert fn(x) is x
    assert len(mesh.hints) == 1
    assert mesh.hints[0][0] == tuple(shape)
    return tuple(mesh.hints[0][1])


def test_hints_are_noops_without_a_mesh():
    assert ambient_mesh() is None
    x = torch.ones((4, 8))
    assert hints.hint(x, "data", None) is x
    kv = torch.ones((2, 16, 4, 8))
    assert hints.hint_kv(kv) is kv
    assert hints.hint_kv_spec(None, kv.shape) is None
    assert collectives.constrain(x, None, "model") is x


KV_SHAPES = {
    "heads_divide": (128, 32, 16, 64),
    "head_dim_divides": (128, 32768, 2, 64),
    "neither": (128, 32, 2, 8),
    "batch_short": (3, 32, 16, 64),
}


@pytest.mark.parametrize("stacked", [False, True], ids=["4d", "5d"])
@pytest.mark.parametrize("case", list(KV_SHAPES))
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_hint_kv_spec_equals_reference(mesh_name, case, stacked):
    shape = ((4,) if stacked else ()) + KV_SHAPES[case]
    want = ref_pinned(ref_hints.hint_kv, mesh_name, shape)
    got = port_pinned(hints.hint_kv, mesh_name, shape)
    assert got == want


@pytest.mark.parametrize("spec", [
    ("model", None, None), (("pod", "data"), None, "model"),
    ("data", "model", None), (None, None, None), ("pod", None, "model")])
@pytest.mark.parametrize("shape", [(8, 4, 4), (32, 16, 48), (2, 64, 16)])
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_hint_spec_equals_reference(mesh_name, shape, spec):
    want = ref_pinned(lambda x: ref_hints.hint(x, *spec), mesh_name, shape)
    got = port_pinned(lambda x: hints.hint(x, *spec), mesh_name, shape)
    assert got == want


def test_decode_hints_under_a_mesh():
    """The decode step pins each layer's fresh k/v and written cache (4
    hints a layer, the reference's call sites) and computes what it
    computes with no mesh."""
    cfg = smoke_config("yi-6b").replace(param_dtype="float32")
    params = init_lm(cfg, generator=torch.Generator().manual_seed(0),
                     device="cpu")
    tok = torch.tensor([3, 5])
    pos = torch.tensor([0, 4])
    c0 = init_caches(cfg, 2, 16, device="cpu")
    c1 = init_caches(cfg, 2, 16, device="cpu")
    want, _ = decode_step(params, c0, tok, pos, cfg)
    mesh = shd.abstract_mesh(*MESHES["2x16x16"])
    with mesh:
        got, _ = decode_step(params, c1, tok, pos, cfg)
    assert torch.equal(got, want)
    assert torch.equal(c1["attn"]["k"], c0["attn"]["k"])
    g = cfg.n_kv_heads
    assert [s for s, _ in mesh.hints] == (
        [(2, 1, g, cfg.hd)] * 2 + [(2, 16, g, cfg.hd)] * 2) * cfg.n_layers
    for shape, spec in mesh.hints:
        assert spec == hints.hint_spec(mesh, shape,
                                       *hints.hint_kv_spec(mesh, shape))


def test_moe_ep_hints_and_mesh_refusal():
    """Under an abstract (2, 2) mesh the grouped dispatch records its two
    expert-buffer hints and keeps its values; ``moe_forward_ep`` runs
    every position on ``x``'s device, each data shard dispatching alone
    (its capacity from its own tokens), with data shard 0's aux, and
    records no hint."""
    from repro_torch.models.moe import moe_forward_ep, moe_forward_grouped
    cfg = smoke_config("granite-moe-1b-a400m").replace(param_dtype="float32")
    params = init_lm(cfg, generator=torch.Generator().manual_seed(1),
                     device="cpu")
    p = {k: v[0] for k, v in params["blocks"]["moe"].items()}
    x = torch.randn((2, 8, cfg.d_model), generator=torch.Generator()
                    .manual_seed(2))
    want = moe_forward_grouped(p, x, top_k=2, act=cfg.act)
    mesh = shd.abstract_mesh((2, 2), ("data", "model"))
    with mesh:
        got = moe_forward_grouped(p, x, top_k=2, act=cfg.act)
        ep_out, ep_aux = moe_forward_ep(p, x, top_k=2, act=cfg.act)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert [s for _, s in mesh.hints] == [shd.P("model", None, None)] * 2
    shards = [moe_forward_grouped(p, x[i:i + 1], top_k=2, act=cfg.act)
              for i in range(2)]
    torch.testing.assert_close(ep_out, torch.cat([o for o, _ in shards]),
                               rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(ep_aux, shards[0][1], rtol=1e-6, atol=0)
    with Mesh((1, 1), ("data", "model")):
        one = moe_forward_ep(p, x, top_k=2, act=cfg.act)
    assert all(torch.equal(a, b) for a, b in zip(one, want))


def test_sequence_parallel_norm_records_and_keeps_values():
    mesh = make_production_mesh()
    x = torch.randn(2, 32, 8)
    with mesh:
        y = collectives.sequence_parallel_norm(lambda t: t * 2, x)
    assert torch.equal(y, x * 2)
    assert [s for _, s in mesh.hints] == [shd.P(None, "model", None)] * 2


# -- async_allreduce_scan on one rank, against the reference -------------

D_IN, D_OUT, N_MICRO, MB = 6, 5, 4, 3


def toy_inputs(seed):
    rng = np.random.default_rng(seed)
    params = {"w": rng.normal(size=(D_IN, D_OUT)).astype(np.float32) * 0.5,
              "b": rng.normal(size=(D_OUT,)).astype(np.float32)}
    mbs = rng.normal(size=(N_MICRO, MB, D_IN)).astype(np.float32)
    return params, mbs


def torch_grad_fn(params, x):
    live = {k: v.detach().requires_grad_() for k, v in params.items()}
    loss = torch.square(torch.tanh(x @ live["w"] + live["b"])).sum()
    gw, gb = torch.autograd.grad(loss, [live["w"], live["b"]])
    return {"w": gw, "b": gb}


def jax_grad_fn(params, x):
    return jax.grad(lambda p: jnp.square(jnp.tanh(x @ p["w"] + p["b"]))
                    .sum())(params)


class one_rank_group:
    def __enter__(self):
        dist.init_process_group("gloo", init_method=f"tcp://localhost:"
                                f"{free_port()}", world_size=1, rank=0)

    def __exit__(self, *exc):
        dist.destroy_process_group()


def test_async_allreduce_scan_one_rank_equals_reference():
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec

    params, mbs = toy_inputs(0)
    mesh = jax.make_mesh((1,), ("data",))
    ref_fn = shard_map(
        lambda p, m: ref_coll.async_allreduce_scan(jax_grad_fn, p, m, "data"),
        mesh=mesh, in_specs=(PartitionSpec(), PartitionSpec()),
        out_specs=PartitionSpec(), check_rep=False)
    want = jax.tree.map(np.asarray, ref_fn(
        jax.tree.map(jnp.asarray, params), jnp.asarray(mbs)))
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    with one_rank_group():
        got = collectives.async_allreduce_scan(torch_grad_fn, tp,
                                               torch.from_numpy(mbs))
    plain = {k: torch.zeros_like(v) for k, v in tp.items()}
    for i in range(N_MICRO):
        for k, g in torch_grad_fn(tp, torch.from_numpy(mbs[i])).items():
            plain[k] += g
    for k in params:
        assert got[k].dtype == torch.float32
        assert torch.equal(got[k], plain[k])
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-5,
                                   atol=1e-6)


def test_collectives_raise_without_a_group():
    assert not dist.is_initialized()
    params, mbs = toy_inputs(1)
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    with pytest.raises(RuntimeError, match="process group"):
        collectives.async_allreduce_scan(torch_grad_fn, tp,
                                         torch.from_numpy(mbs))
    x = torch.ones(8)
    assert collectives.pod_psum_compressed(make_production_mesh(), x) is x
    with pytest.raises(RuntimeError, match="process group"):
        collectives.pod_psum_compressed(
            make_production_mesh(multi_pod=True), x)


# -- two gloo ranks -------------------------------------------------------

_WORKER = textwrap.dedent("""
    import json, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    def worker(rank, port, out):
        sys.modules["jax"] = None            # the port alone
        from repro_torch.distributed import collectives
        from repro_torch.launch.mesh import Mesh
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                world_size=2, rank=rank)
        try:
            rows = [np.linspace(-1, 1, 512), np.linspace(0, 2, 512)]
            x = torch.from_numpy(rows[rank].astype(np.float32))
            pod = Mesh((2,), ("pod",))
            s = collectives.pod_psum_compressed(pod, x)
            rng = np.random.default_rng(10 + rank)
            w = torch.from_numpy(rng.normal(size=(6, 5)).astype(np.float32))
            mbs = torch.from_numpy(rng.normal(size=(4, 3, 6))
                                   .astype(np.float32))

            def grad_fn(p, xb):
                live = p["w"].detach().requires_grad_()
                loss = torch.square(torch.tanh(xb @ live)).sum()
                return {"w": torch.autograd.grad(loss, live)[0]}

            local = [grad_fn({"w": w}, mbs[i])["w"].numpy().tolist()
                     for i in range(4)]
            acc = collectives.async_allreduce_scan(grad_fn, {"w": w}, mbs)
            json.dump({"psum": s.numpy().tolist(), "local": local,
                       "acc": acc["w"].numpy().tolist()},
                      open(f"{out}/rank{rank}.json", "w"))
        finally:
            dist.destroy_process_group()

    if __name__ == "__main__":
        mp.spawn(worker, args=(int(sys.argv[1]), sys.argv[2]), nprocs=2)
""")


def int8_psum_model(rows):
    """numpy float32 model of compressed_psum over the ranks' ``rows``."""
    f32 = np.float32
    qs, scales = [], []
    for r in rows:
        blocks = r.astype(f32).reshape(-1, 256)
        amax = np.abs(blocks).max(axis=1, keepdims=True)
        scale = np.where(amax > 0, amax / f32(127.0), f32(1.0)).astype(f32)
        qs.append(np.clip(np.round(blocks / scale), -127, 127))
        scales.append(scale[:, 0])
    common = np.maximum(*scales)
    total = sum(np.clip(np.round(q.astype(f32) * (s / common)[:, None]),
                        -127, 127).astype(np.int32)
                for q, s in zip(qs, scales))
    return (total.astype(f32) * common[:, None]).reshape(-1)


def test_two_gloo_ranks(tmp_path):
    script = tmp_path / "two_ranks.py"
    script.write_text(_WORKER)
    out = subprocess.run(
        [sys.executable, str(script), str(free_port()), str(tmp_path)],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(SRC)})
    assert out.returncode == 0, out.stdout + out.stderr
    r = [json.loads((tmp_path / f"rank{i}.json").read_text())
         for i in range(2)]
    rows = [np.linspace(-1, 1, 512), np.linspace(0, 2, 512)]
    want = np.sum(rows, axis=0)
    for i in range(2):
        got = np.asarray(r[i]["psum"], np.float32)
        assert np.abs(got - want).max() < 4 * (2.0 / 127)
        np.testing.assert_array_equal(got, int8_psum_model(rows))
        acc = np.zeros((6, 5), np.float32)
        for m in range(4):
            acc += (np.asarray(r[0]["local"][m], np.float32)
                    + np.asarray(r[1]["local"][m], np.float32))
        np.testing.assert_array_equal(np.asarray(r[i]["acc"], np.float32),
                                      acc)
