"""The port's training launcher (``repro_torch.launch.train``) on the CPU.

Mirrors ``tests/test_train.py::test_checkpoint_resume_determinism`` and
``tests/test_system.py::test_failure_recovery_drill`` on the port, runs
``chip_smoke.py`` 12b's resume at smoke size (a run's step-3 checkpoints
moved to a new directory resume it bit for bit, the CPU being
deterministic), and resumes a run of the reference from its checkpoint.
"""

import json
import shutil
import sys

import numpy as np
import pytest
import torch

from repro.launch.train import train as ref_train
from repro_torch.launch import train as launch
from repro_torch.launch.train import train
from repro_torch.models.params import flatten
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.fault_tolerance import recovery_plan

CPU = "cpu"


def test_checkpoint_resume_determinism(tmp_path):
    """Train 4 steps == train 2, checkpoint, restore, train 2."""
    d = str(tmp_path / "run")
    r1 = train(arch="internvl2-1b", steps=4, seq_len=16, batch=2,
               ckpt_dir=None, device=CPU)
    train(arch="internvl2-1b", steps=2, seq_len=16, batch=2, ckpt_dir=d,
          ckpt_every=2, device=CPU)
    r2b = train(arch="internvl2-1b", steps=4, seq_len=16, batch=2,
                ckpt_dir=d, ckpt_every=2, device=CPU)
    assert r2b["logs"][0]["step"] == 3
    assert abs(r1["final_loss"] - r2b["final_loss"]) < 5e-2


def test_failure_recovery_drill(tmp_path):
    """Train → checkpoint → lose 128 chips → re-mesh plan → restore → train."""
    d = str(tmp_path / "drill")
    train(arch="yi-6b", steps=3, seq_len=16, batch=2, ckpt_dir=d,
          ckpt_every=3, device=CPU)
    assert ckpt.latest_step(d) == 3
    plan = recovery_plan(n_alive_chips=384, model_parallel=16)
    assert plan["needs_reshard"]
    assert plan["mesh_shape"][2] == 16
    r2 = train(arch="yi-6b", steps=6, seq_len=16, batch=2, ckpt_dir=d,
               ckpt_every=3, device=CPU)   # resumes from step 3 automatically
    assert r2["logs"][0]["step"] == 4


def _move_step(src, dst, step):
    """A run's params and optimizer checkpoints of ``step`` into ``dst``."""
    for suffix in ("", "_opt"):
        shutil.copytree(f"{src}{suffix}/step_{step:08d}",
                        f"{dst}{suffix}/step_{step:08d}")


def test_resume_from_moved_checkpoint_is_exact(tmp_path):
    """``chip_smoke.py`` 12b at smoke size: six steps of two microbatches
    with checkpoints every three; the step-3 checkpoints, moved to a new
    directory, resume the same call at step 4, and steps 4-6's losses and
    grad norms and the final params ``==`` the uninterrupted run's."""
    a, b = str(tmp_path / "A"), str(tmp_path / "B")
    kw = dict(arch="internvl2-1b", steps=6, seq_len=16, batch=4,
              n_microbatches=2, ckpt_every=3, device=CPU)
    ra = train(ckpt_dir=a, **kw)
    assert ckpt.latest_step(a) == ckpt.latest_step(a + "_opt") == 6
    _move_step(a, b, 3)
    rb = train(ckpt_dir=b, **kw)
    assert [r["step"] for r in rb["logs"]] == [4, 5, 6]
    for got, want in zip(rb["logs"], ra["logs"][3:]):
        assert (got["loss"], got["grad_norm"]) == \
            (want["loss"], want["grad_norm"])
    assert all(np.isfinite(r["loss"]) for r in ra["logs"])
    for x, y in zip(flatten(rb["params"]), flatten(ra["params"])):
        assert x.dtype == y.dtype == torch.bfloat16 and torch.equal(x, y)
    assert ckpt.latest_step(b) == 6


def test_port_resumes_a_reference_run(tmp_path):
    """The reference trains six steps and checkpoints at 3; the port
    resumes from its step-3 checkpoints (params and ``OptState``, bf16 and
    fp32) and its steps 4-6 follow the reference's losses, on another
    init than its own (bf16 on two BLAS: within 5e-2, the reference's own
    resume tolerance)."""
    a, b = str(tmp_path / "ref"), str(tmp_path / "port")
    kw = dict(arch="yi-6b", steps=6, seq_len=16, batch=2, ckpt_every=3)
    want = ref_train(ckpt_dir=a, **kw)
    _move_step(a, b, 3)
    got = train(ckpt_dir=b, device=CPU, **kw)
    assert [r["step"] for r in got["logs"]] == [4, 5, 6]
    for g, w in zip(got["logs"], want["logs"][3:]):
        assert abs(g["loss"] - w["loss"]) < 5e-2, (g, w)
    own = train(device=CPU, **{**kw, "ckpt_every": 100})
    assert own["logs"][3]["loss"] != got["logs"][0]["loss"]


def test_main_writes_the_log(tmp_path, monkeypatch, capsys):
    log = tmp_path / "logs" / "train.jsonl"
    monkeypatch.setattr(sys, "argv", [
        "train", "--arch", "granite-moe-1b-a400m", "--steps", "2",
        "--seq_len", "8", "--batch", "2", "--microbatches", "2",
        "--log", str(log), "--device", CPU])
    launch.main()
    recs = [json.loads(x) for x in log.read_text().splitlines()]
    assert [r["step"] for r in recs] == [1, 2]
    assert all(np.isfinite(r["loss"]) and r["grad_norm"] > 0 for r in recs)
    assert "done: loss" in capsys.readouterr().out


def test_train_on_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train(steps=1)
