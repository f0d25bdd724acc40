"""The port's ``remat`` modes on the CPU (no reference needed).

``"full"``, ``"dots"`` and no remat recompute the same float ops, so two
train steps give ``==`` params, moments and metrics; and each policy
saves what it says: "dots" keeps the unbatched weight products and
recomputes attention's batched ones, and a stacked leaf's gradient is
one ``stack`` of its layers' (``models.params.unstack``).
"""

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import smoke_config
from repro_torch.models.params import flatten, tree_map
from repro_torch.models.transformer import init_lm
from repro_torch.train import optimizer as opt
from repro_torch.train.data import DataConfig, synth_batch
from repro_torch.train.train_loop import make_loss_fn, make_train_step

CPU = "cpu"
PUM = dict(act="relu", pum="bitplane", pum_bits=8)


def port_config(case):
    """A smoke config in float32; "pum-relu" is
    tests/test_system.py::test_pum_offload_inside_lm's configuration."""
    if case == "pum-relu":
        return smoke_config("seamless-m4t-medium").replace(
            param_dtype="float32", **PUM)
    return smoke_config(case).replace(param_dtype="float32")


def _port_steps(cfg, remat, steps=2):
    params = init_lm(cfg, generator=torch.Generator().manual_seed(0),
                     device=CPU)
    step = make_train_step(cfg, opt.AdamWConfig(lr=1e-3, warmup_steps=1,
                                                total_steps=10),
                           n_microbatches=2, remat=remat)
    state = opt.init(params)
    dc = DataConfig(seq_len=16, global_batch=4, seed=0)
    for s in range(steps):
        params, state, m = step(params, state, {
            k: torch.from_numpy(v) for k, v in synth_batch(cfg, dc, s).items()})
    return params, state, m


@pytest.mark.parametrize("case", ["yi-6b", "granite-moe-1b-a400m",
                                  "mamba2-370m", "hymba-1.5b", "pum-relu"])
def test_remat_modes_give_equal_params(case):
    """``remat`` "full", "dots" and "none" recompute the same float ops
    on the CPU: params, moments and metrics ``==`` after two steps of two
    microbatches."""
    cfg = port_config(case)
    runs = {r: _port_steps(cfg, r) for r in ("none", "full", "dots")}
    p, s, m = runs["none"]
    for r in ("full", "dots"):
        p2, s2, m2 = runs[r]
        for a, b in zip(flatten((p, s)), flatten((p2, s2))):
            assert torch.equal(a, b), r
        assert all(torch.equal(m[k], m2[k]) for k in m), r


class _CountOps(TorchDispatchMode):
    """Counts the calls of the named ops and keeps their output shapes."""

    def __init__(self, names):
        super().__init__()
        self.counts = dict.fromkeys(names, 0)
        self.shapes = {n: [] for n in names}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        if name in self.counts:
            self.counts[name] += 1
            self.shapes[name].append(tuple(out.shape))
        return out


@pytest.mark.parametrize("case", ["yi-6b", "seamless-m4t-medium"])
def test_remat_policies_save_what_they_say(case):
    """Over one forward and backward: "dots" recomputes no weight product
    (``mm``/``addmm`` as often as with no remat) but does recompute the
    batched einsums (more ``bmm``), "full" recomputes both; and no
    layer's gradient is a ``select_backward`` of the stacked leaf (each
    stacked leaf's gradient is one ``stack``)."""
    cfg = smoke_config(case).replace(param_dtype="float32")
    params = init_lm(cfg, generator=torch.Generator().manual_seed(0),
                     device=CPU)
    b = {k: torch.from_numpy(v) for k, v in synth_batch(
        cfg, DataConfig(16, 2, 0), 0).items()}
    ops = ("mm", "addmm", "bmm", "select_backward", "stack")
    stacked = [tuple(t.shape) for t in flatten(params["blocks"])
               + flatten(params.get("enc_blocks", {}))]
    counts = {}
    for remat in ("none", "dots", "full"):
        live = tree_map(lambda t: t.detach().requires_grad_(), params)
        with _CountOps(ops) as c:
            total, _ = make_loss_fn(cfg, remat)(live, b)
            torch.autograd.grad(total, flatten(live))
        counts[remat] = c.counts
        assert not set(c.shapes["select_backward"]) & set(stacked)
        assert sorted(s for s in c.shapes["stack"] if s in stacked) == \
            sorted(stacked)
    none, dots, full = counts["none"], counts["dots"], counts["full"]
    prod = lambda c: c["mm"] + c["addmm"]  # noqa: E731
    assert prod(dots) == prod(none) < prod(full)
    assert none["bmm"] < dots["bmm"] <= full["bmm"]
