"""The port stands alone: no JAX, nothing of the JAX package, no card
needed to import, and no entry point that falls back to the CPU."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _port_files():
    return (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
            + _example_files() + sorted(ROOT.glob("scripts/*_torch.py")))


def _example_files():
    return sorted((ROOT / "examples_torch").glob("*.py"))


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, name)


def test_imports_with_jax_blocked():
    modules = sorted(
        ".".join(p.relative_to(PORT.parent).with_suffix("").parts)
        for p in PORT.rglob("*.py"))
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            "import importlib\n"
            f"for m in {modules!r}:\n"
            "    importlib.import_module(m.removesuffix('.__init__'))\n"
            "print('ok')\n")
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
        timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def _entry_points():
    import torch

    from repro_torch.core import bitplane, control_unit
    from repro_torch.core.bank import Bank, VerticalOperand
    from repro_torch.core.fault import FaultModel
    from repro_torch.core.channel import SimdramChannel
    from repro_torch.core.chip import SimdramChip
    from repro_torch.core.isa import SimdramDevice
    from repro_torch.core.rank import SimdramRank
    from repro_torch.configs import smoke_config
    from repro_torch.distributed import pum
    from repro_torch.kernels import ops as kops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import train
    from repro_torch.models.params import params_from_numpy
    from repro_torch.models.transformer import init_caches, init_lm
    from repro_torch.train import checkpoint, serve

    x = np.arange(64, dtype=np.int64)
    state = np.zeros((16, 2), np.uint32)
    table = np.zeros((4, 13), np.int32)
    return {
        "SimdramDevice": lambda: SimdramDevice(backend="bank"),
        "Bank": lambda: Bank(),
        "VerticalOperand.from_values": lambda: VerticalOperand.from_values(
            x, 8),
        "bitplane.bbop": lambda: bitplane.bbop("addition", 8, x, x),
        "bbop_cuda": lambda: kops.bbop_cuda("addition", 8, x, x),
        "run_command_table": lambda: control_unit.run_command_table(
            state, table),
        "hetero_batched_interpreter":
            lambda: control_unit.hetero_batched_interpreter(),
        "tables_from_numpy": lambda: control_unit.tables_from_numpy([table]),
        "faulty_batched_interpreter":
            lambda: control_unit.faulty_batched_interpreter(),
        "SimdramDevice(fault=...)": lambda: SimdramDevice(
            backend="bank", fault=FaultModel(p_flip=0.0)),
        "Bank(fault=...)": lambda: Bank(fault=FaultModel(p_flip=0.0)),
        "SimdramDevice(backend='chip')": lambda: SimdramDevice(
            backend="chip"),
        "SimdramChip": lambda: SimdramChip(),
        "SimdramChannel": lambda: SimdramChannel(),
        "SimdramRank": lambda: SimdramRank(),
        "SimdramChip(fault=...)": lambda: SimdramChip(
            fault=FaultModel(p_flip=0.0)),
        "chip_batched_interpreter":
            lambda: control_unit.chip_batched_interpreter(),
        "channel_batched_interpreter":
            lambda: control_unit.channel_batched_interpreter(),
        "rank_batched_interpreter":
            lambda: control_unit.rank_batched_interpreter(),
        "faulty_chip_batched_interpreter":
            lambda: control_unit.faulty_chip_batched_interpreter(),
        "faulty_channel_batched_interpreter":
            lambda: control_unit.faulty_channel_batched_interpreter(),
        "make_rank_executor": lambda: pum.make_rank_executor(2, 2, 2),
        "bitserial_matmul": lambda: kops.bitserial_matmul(
            np.ones((4, 32), np.int32), np.ones((32, 4), np.int32), 1, 1),
        "quantized_matmul": lambda: kops.quantized_matmul(
            np.ones((4, 32), np.int32), np.ones((32, 4), np.int32), 8, 8),
        "init_lm": lambda: init_lm(smoke_config("yi-6b")),
        "init_caches": lambda: init_caches(smoke_config("yi-6b"), 1, 8),
        "params_from_numpy": lambda: params_from_numpy(
            {"w": np.ones((2, 2), np.float32)}),
        "Server": lambda: serve.Server(
            smoke_config("yi-6b"),
            {"embed": {"emb": torch.zeros(4, 4)}}),
        "PumServeOffload": lambda: serve.PumServeOffload(),
        "launch.train.train": lambda: train(steps=1),
        "make_host_mesh": lambda: make_host_mesh(),
        "checkpoint.restore": lambda: checkpoint.restore(
            "no-such-dir", 1, {"w": torch.zeros(2)}),
    }


@pytest.mark.parametrize("name", sorted(_entry_points()))
def test_cuda_without_a_card_raises(name, monkeypatch):
    """An entry point asked for the card, with no card, raises; it never
    moves to the CPU by itself."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _entry_points()[name]()


@pytest.mark.parametrize("kwargs,match", [
    ({"backend": "pallas"}, "unknown backend"),
    ({"backend": "rank", "fault": "model"}, "fault injection"),
    ({"backend": "chip", "use_shard_map": True}, "shard_map requested"),
    ({"backend": "channel", "use_shard_map": True}, "shard_map requested"),
    ({"backend": "rank", "use_shard_map": True}, "shard_map requested"),
])
def test_unported_options_raise(kwargs, match):
    """What the port does not do raises: the reference's TPU-only
    backend, a faulty rank (as in the reference), and splitting a tier's
    units across devices (the reference raises it on one device)."""
    from repro_torch.core.channel import SimdramChannel
    from repro_torch.core.chip import SimdramChip
    from repro_torch.core.fault import FaultModel
    from repro_torch.core.isa import SimdramDevice
    from repro_torch.core.rank import SimdramRank
    if kwargs.pop("use_shard_map", False):
        engine = {"chip": SimdramChip, "channel": SimdramChannel,
                  "rank": SimdramRank}[kwargs["backend"]]
        with pytest.raises(ValueError, match=match):
            engine(use_shard_map=True, device="cpu")
        return
    if kwargs.get("fault") == "model":
        kwargs = {**kwargs, "fault": FaultModel(p_flip=0.0)}
        dev = SimdramDevice(device="cpu", **kwargs)
        with pytest.raises(ValueError, match=match):
            dev.bbop("addition", np.arange(4), np.arange(4), n_bits=8)
        return
    with pytest.raises(ValueError, match=match):
        SimdramDevice(device="cpu", **kwargs)


def test_every_reference_example_has_a_port():
    """``examples_torch/`` holds one file for each reference example,
    under the same name."""
    want = sorted(p.name for p in (ROOT / "examples").glob("*.py"))
    assert [p.name for p in _example_files()] == want


@pytest.mark.parametrize("path", _example_files(), ids=lambda p: p.name)
def test_example_without_a_card_raises(path, monkeypatch):
    """An example run with no ``--device`` wants the card: without one it
    raises before it prints anything; it never carries on on the CPU."""
    import contextlib
    import importlib.util
    import io

    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = importlib.util.spec_from_file_location(f"ex_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), \
            pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main([])
    assert buf.getvalue() == ""
