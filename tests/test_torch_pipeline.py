"""The port's GPipe schedule on the CPU: against the sequential layer
loop (forward and gradients), at the sizes of ``tests/test_pipeline.py``
(S=4 stages, L=8 layers, D=16, B=8, 4 microbatches) and of the 2-stage
pod case in ``tests/test_distributed.py``, with their tolerances
(forward rtol = atol = 2e-5; gradients rtol 5e-4, atol 5e-5); and the
forward against the reference's ``gpipe``, run with 8 host devices in a
subprocess on the same numpy inputs."""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.distributed.pipeline import gpipe, split_stages
from repro_torch.launch.mesh import Mesh

SRC = Path(__file__).resolve().parents[1] / "src"


def layer(h, w):
    return torch.tanh(h @ w)


def stage_fn(stage_ws, h):
    for w in stage_ws:
        h = layer(h, w)
    return h


def inputs(l, d, b, seed=0):
    rng = np.random.default_rng(seed)
    ws = (rng.normal(size=(l, d, d)) * 0.3).astype(np.float32)
    x = rng.normal(size=(b, d)).astype(np.float32)
    return ws, x


def pipe_vs_sequential(s, l, d, b, n_micro):
    ws_np, x_np = inputs(l, d, b)
    mesh = Mesh((s,), ("pod",))
    ws = torch.from_numpy(ws_np).requires_grad_()
    x = torch.from_numpy(x_np)
    out = gpipe(stage_fn, split_stages(ws, s), x, mesh=mesh, axis="pod",
                n_micro=n_micro)
    ref = x
    for i in range(l):
        ref = layer(ref, ws[i])
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(),
                               rtol=2e-5, atol=2e-5)
    g_pipe, = torch.autograd.grad((out ** 2).sum(), ws)
    g_seq, = torch.autograd.grad((ref ** 2).sum(), ws)
    np.testing.assert_allclose(g_pipe.numpy(), g_seq.numpy(), rtol=5e-4,
                               atol=5e-5)
    return out


def test_split_stages_shapes():
    tree = {"w": torch.zeros((8, 3, 5)), "b": torch.zeros((8, 5))}
    st = split_stages(tree, 4)
    assert st["w"].shape == (4, 2, 3, 5)
    assert st["b"].shape == (4, 2, 5)
    with pytest.raises(ValueError, match="stages"):
        split_stages(tree, 3)


def test_gpipe_matches_sequential():
    pipe_vs_sequential(s=4, l=8, d=16, b=8, n_micro=4)


def test_gpipe_two_stage_pod():
    pipe_vs_sequential(s=2, l=4, d=8, b=4, n_micro=2)


def test_gpipe_rejects_uneven_microbatches():
    ws, x = inputs(4, 8, 6)
    with pytest.raises(ValueError, match="microbatches"):
        gpipe(stage_fn, split_stages(torch.from_numpy(ws), 2),
              torch.from_numpy(x), mesh=Mesh((2,), ("pod",)), n_micro=4)


_REF = textwrap.dedent("""
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp, numpy as np
    from repro.distributed.pipeline import gpipe, split_stages

    d = np.load(sys.argv[1])
    ws, x, s, n_micro = (jnp.asarray(d["ws"]), jnp.asarray(d["x"]),
                         int(d["s"]), int(d["n_micro"]))
    mesh = jax.make_mesh((s,), ("pod",))

    def stage_fn(stage_ws, h):
        def body(hh, w):
            return jnp.tanh(hh @ w), None
        out, _ = jax.lax.scan(body, h, stage_ws)
        return out

    out = gpipe(stage_fn, split_stages(ws, s), x, mesh=mesh, axis="pod",
                n_micro=n_micro)
    np.save(sys.argv[2], np.asarray(out))
""")


@pytest.mark.parametrize("s,l,d,b,n_micro", [(4, 8, 16, 8, 4),
                                             (2, 4, 8, 4, 2)])
def test_gpipe_forward_equals_reference(tmp_path, s, l, d, b, n_micro):
    ws, x = inputs(l, d, b)
    np.savez(tmp_path / "in.npz", ws=ws, x=x, s=s, n_micro=n_micro)
    env = {**os.environ, "PYTHONPATH": str(SRC), "JAX_PLATFORMS": "cpu"}
    out = subprocess.run(
        [sys.executable, "-c", _REF, str(tmp_path / "in.npz"),
         str(tmp_path / "out.npy")],
        capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    want = np.load(tmp_path / "out.npy")
    got = gpipe(stage_fn, split_stages(torch.from_numpy(ws), s),
                torch.from_numpy(x), mesh=Mesh((s,), ("pod",)),
                n_micro=n_micro)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
