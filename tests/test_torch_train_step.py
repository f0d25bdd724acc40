"""The port's train step against the reference's jitted step, on the CPU.

Each case builds the params in the reference with ``jax.random``,
carries them across with ``params_from_numpy`` and runs three steps of
``make_train_step`` in both packages on the same ``synth_batch``es, in
float32 (the ``remat`` modes against each other are in
``tests/test_torch_train_remat.py``).  Tolerances: loss, aux and grad norm within rtol 1e-5; params
within rtol = atol = 1e-5 (the worst case measured over these cases is
1.2e-7).  The optimizer runs with ``eps = 1e-3``: at the default 1e-8,
AdamW's first steps move every parameter by about ``lr`` whatever its
gradient's size, so a gradient entry within float32 rounding of zero
(its sign set by the order of a sum) moves by ``±lr`` in either package
(4.9e-5 apart at lr 1e-3 on internvl2-1b).  With eps 1e-3 the step is a
smooth function of the gradient, and the params compare the gradients;
``update`` itself is held at the default in ``tests/test_torch_train.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as ref_smoke_config
from repro.models import transformer as ref_tf
from repro.train import optimizer as ref_opt
from repro.train import train_loop as ref_tl
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import flatten, params_from_numpy
from repro_torch.train import optimizer as opt
from repro_torch.train.data import DataConfig, synth_batch
from repro_torch.train.train_loop import make_train_step

CPU = "cpu"
METRIC_RTOL = 1e-5
PARAM_TOL = 1e-5
OPT_KW = dict(lr=1e-3, eps=1e-3, warmup_steps=1, total_steps=10)
PUM = dict(act="relu", pum="bitplane", pum_bits=8)


def ref_config(case):
    """The reference config of a case, in float32."""
    if case == "padded-vocab":
        # a vocabulary padded to 256: the masked readout columns
        return ref_smoke_config("yi-6b").replace(vocab_size=250,
                                                 param_dtype="float32")
    if case == "pum-relu":
        # tests/test_system.py::test_pum_offload_inside_lm's configuration
        return ref_smoke_config("seamless-m4t-medium").replace(
            param_dtype="float32", **PUM)
    return ref_smoke_config(case).replace(param_dtype="float32")


def np32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def run_both(case, n_microbatches, steps=3):
    """``steps`` train steps in both packages from the same weights:
    (reference params, port params, metrics per step of each, the
    initial params)."""
    rcfg = ref_config(case)
    cfg = ModelConfig(**dataclasses.asdict(rcfg))
    rp = ref_tf.init_lm(jax.random.PRNGKey(0), rcfg)
    p0 = params_from_numpy(jax.tree.map(np.asarray, rp), CPU)
    rstep = jax.jit(ref_tl.make_train_step(
        rcfg, ref_opt.AdamWConfig(**OPT_KW), n_microbatches=n_microbatches))
    pstep = make_train_step(cfg, opt.AdamWConfig(**OPT_KW),
                            n_microbatches=n_microbatches)
    dc = DataConfig(seq_len=16, global_batch=4, seed=2)
    pp, rs, ps = p0, ref_opt.init(rp), opt.init(p0)
    rms, pms = [], []
    for s in range(steps):
        b = synth_batch(cfg, dc, s)
        rp, rs, rm = rstep(rp, rs, {k: jnp.asarray(v) for k, v in b.items()})
        pp, ps, pm = pstep(pp, ps, {k: torch.from_numpy(v)
                                    for k, v in b.items()})
        rms.append(rm)
        pms.append(pm)
    assert int(ps.step) == int(rs.step) == steps
    return rp, pp, rms, pms, p0


def assert_params_close(pp, rp):
    got, want = flatten(pp), jax.tree.leaves(rp)
    paths = [jax.tree_util.keystr(k) for k, _ in
             jax.tree_util.tree_flatten_with_path(rp)[0]]
    assert len(got) == len(want)
    for path, a, b in zip(paths, got, want):
        assert tuple(a.shape) == b.shape and a.dtype == torch.float32, path
        np.testing.assert_allclose(np32(a), np32(b), rtol=PARAM_TOL,
                                   atol=PARAM_TOL, err_msg=path)


@pytest.mark.parametrize("n_microbatches", [1, 2])
@pytest.mark.parametrize("case", ["yi-6b", "internvl2-1b",
                                  "granite-moe-1b-a400m",
                                  "seamless-m4t-medium", "padded-vocab"])
def test_train_step_matches_reference(case, n_microbatches):
    """Three steps: every step's loss, aux loss, grad norm and lr, and
    the final params, against the reference's jitted step."""
    rp, pp, rms, pms, _ = run_both(case, n_microbatches)
    for s, (rm, pm) in enumerate(zip(rms, pms)):
        assert set(pm) == set(rm)
        for k in rm:
            np.testing.assert_allclose(float(pm[k]), float(rm[k]),
                                       rtol=METRIC_RTOL, atol=1e-7,
                                       err_msg=f"step {s} {k}")
    assert_params_close(pp, rp)


def test_pum_relu_train_step_moves_up_by_decay_alone():
    """The PuM MLP's relu is an integer bbop: no gradient reaches
    ``mlp.up``, in either package, so after three steps ``up`` has moved
    by weight decay alone, ``p - lr_t * (0 + wd * p)`` a step, and the
    rest of the model matches the reference."""
    rp, pp, rms, pms, p0 = run_both("pum-relu", 1)
    for rm, pm in zip(rms, pms):
        for k in rm:
            np.testing.assert_allclose(float(pm[k]), float(rm[k]),
                                       rtol=METRIC_RTOL, atol=1e-7)
    assert_params_close(pp, rp)
    ocfg = opt.AdamWConfig(**OPT_KW)
    up = p0["blocks"]["mlp"]["up"]["w"]
    for s in range(1, 4):
        lr = opt.schedule(ocfg, torch.tensor(s, dtype=torch.int32))
        up = up - lr * (0.0 + ocfg.weight_decay * up)
    assert torch.equal(pp["blocks"]["mlp"]["up"]["w"], up)
    assert not torch.equal(up, p0["blocks"]["mlp"]["up"]["w"])
