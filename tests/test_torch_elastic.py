"""The elastic scale-down drill of ``tests/test_elastic.py`` on one
device, on the CPU: smoke yi-6b trains 4 steps on a host mesh with its
params and optimizer state placed by ``param_shardings`` and
``opt_shardings``, is checkpointed, the plan for losing half the chips
is ``recovery_plan(4, 2, 8)``'s, and the checkpoints are restored onto a
new host mesh by ``reshard_restore`` for 4 more steps.  The 8 losses
``==`` an uninterrupted run's, and the first 4 are within the train
step's parity tolerance (rtol 1e-5, ``tests/test_torch_train_step.py``)
of the reference's unsharded jitted steps from the same weights.  As there, the model runs in float32 with ``eps = 1e-3``
(see ``tests/test_torch_train_step.py``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import smoke_config as ref_smoke_config
from repro.models import transformer as ref_tf
from repro.train import optimizer as ref_opt
from repro.train import train_loop as ref_tl
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import params_from_numpy
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as opt
from repro_torch.train.data import DataConfig, synth_batch
from repro_torch.train.fault_tolerance import recovery_plan
from repro_torch.train.train_loop import make_train_step

OPT_KW = dict(lr=1e-3, eps=1e-3, warmup_steps=2, total_steps=40)
DC = DataConfig(seq_len=32, global_batch=8, seed=0)


def batch(cfg, s):
    return {k: torch.from_numpy(v) for k, v in synth_batch(cfg, DC, s).items()}


def test_elastic_remesh_single_device(tmp_path):
    rcfg = ref_smoke_config("yi-6b").replace(param_dtype="float32")
    cfg = ModelConfig(**dataclasses.asdict(rcfg))
    rp = ref_tf.init_lm(jax.random.PRNGKey(0), rcfg)
    p0 = params_from_numpy(jax.tree.map(np.asarray, rp), "cpu")
    step = make_train_step(cfg, opt.AdamWConfig(**OPT_KW))

    def make(mesh, params):
        state = opt.init(params)
        return (shd.place(params, shd.param_shardings(params, mesh)),
                shd.place(state, shd.opt_shardings(state, params, mesh)))

    # uninterrupted: 8 steps
    params, state = make(make_host_mesh(device="cpu"), p0)
    straight = []
    for s in range(8):
        params, state, m = step(params, state, batch(cfg, s))
        straight.append(float(m["loss"]))

    # 4 steps, checkpoint, lose half the chips, restore, 4 more
    mesh8 = make_host_mesh(device="cpu")
    params, state = make(mesh8, p0)
    losses = []
    for s in range(4):
        params, state, m = step(params, state, batch(cfg, s))
        losses.append(float(m["loss"]))
    d = str(tmp_path / "ck")
    ckpt.save(d, 4, params)
    ckpt.save(d + "_opt", 4, state)
    plan = recovery_plan(n_alive_chips=4, model_parallel=2, chips_per_pod=8)
    assert plan["mesh_shape"] == (1, 2, 2) and plan["chips_idle"] == 0
    mesh4 = make_host_mesh(device="cpu")
    like_p, like_s = make(mesh4, p0)
    params2 = ckpt.reshard_restore(d, 4, like_p,
                                   shd.param_shardings(like_p, mesh4))
    state2 = ckpt.reshard_restore(d + "_opt", 4, like_s,
                                  shd.opt_shardings(like_s, like_p, mesh4))
    assert int(state2.step) == 4
    for s in range(4, 8):
        params2, state2, m = step(params2, state2, batch(cfg, s))
        losses.append(float(m["loss"]))
    assert losses == straight
    assert losses[-1] < losses[0], losses

    # the reference's unsharded jitted steps from the same weights
    rstep = jax.jit(ref_tl.make_train_step(rcfg, ref_opt.AdamWConfig(**OPT_KW)))
    rs = ref_opt.init(rp)
    ref_losses = []
    for s in range(4):
        b = {k: jnp.asarray(v) for k, v in synth_batch(cfg, DC, s).items()}
        rp, rs, rm = rstep(rp, rs, b)
        ref_losses.append(float(rm["loss"]))
    np.testing.assert_allclose(losses[:4], ref_losses, rtol=1e-5)
