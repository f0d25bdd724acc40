"""The port's gates, on the CPU.

``scripts/check_uprograms_torch.py`` and ``check_compaction_torch.py``
beside ``scripts/check_uprograms.py`` and ``check_compaction.py``: both
pass, and their printed tables equal line for line, the compaction
gate's measured seconds masked.  The reference's compaction gate (about
35 s of pure Python) runs in a subprocess while the port's runs here, so
the case takes the time of one.  (A file of its own: with the two
sweeps, ``test_torch_examples_core.py`` would pass 150 s on one worker.)

``scripts/check_docs_torch.py`` passes on this tree and fails on a
planted dangling path and module; ``scripts/check_coverage_torch.py``
passes on a one-test selection of this tree under a floor below what it
measures there (its default selection takes about 6 minutes) and fails
where the measured figure lies under the floor.
"""

import json
import os
import subprocess
import sys

from test_torch_examples_core import (ROOT, assert_same_lines, capture, load,
                                      one_torch_thread)  # noqa: F401

SCRIPTS = ROOT / "scripts"


def test_check_uprograms_torch_equals_reference():
    """All 16 ops, MIG and AIG, at 8 bits on 192 lanes: the same AAP, AP,
    activation and scratch counts, both exact on the DRAM oracle."""
    ref, _ = capture(load(SCRIPTS / "check_uprograms.py",
                          "reference_check_uprograms").main)
    port, _ = capture(load(SCRIPTS / "check_uprograms_torch.py",
                           "port_check_uprograms").main)
    assert port.splitlines()[-1] == "ALL UPROGRAMS CORRECT (8-bit, 192 lanes)"
    assert_same_lines(ref, port)


def test_check_compaction_torch_equals_reference():
    """The default sweep (92 cases): the same activation counts before
    and after compaction, every case exact, both gates exit 0."""
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]),
        "JAX_PLATFORMS": "cpu"}
    ref = subprocess.Popen(
        [sys.executable, str(SCRIPTS / "check_compaction.py")], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        port, rc_port = capture(load(SCRIPTS / "check_compaction_torch.py",
                                     "port_check_compaction").main)
    finally:
        out, err = ref.communicate(timeout=600)
    assert ref.returncode == 0, err
    assert rc_port == 0
    assert port.startswith("COMPACTION OK: 92 cases bit-exact")
    assert_same_lines(out, port, subs=[(r", \d+s$", ", *s")])


def test_check_docs_torch_passes_and_names_a_dangling_reference(tmp_path,
                                                                 monkeypatch):
    """Every path and module the README's port section and
    ``examples_torch/README.md`` name exists; a document naming a file
    and a function that do not fails the lint, each named."""
    gate = load(SCRIPTS / "check_docs_torch.py", "port_check_docs")
    out, rc = capture(gate.main)
    assert rc == 0, out
    assert out.splitlines()[-1] == "DOCS LINT OK"
    assert "README.md (The PyTorch/CUDA port): OK" in out
    doc = tmp_path / "planted.md"
    doc.write_text(gate.section((ROOT / "README.md").read_text(),
                                "## The PyTorch/CUDA port")
                   + "\n`src/repro_torch/distributed/partition_gone.py` and"
                     " `repro_torch.distributed.partition.no_such_step`\n")
    monkeypatch.setattr(gate, "DOCS", [(str(doc), None)])
    out, rc = capture(gate.main)
    assert rc == 1
    assert "dangling path reference " \
        "`src/repro_torch/distributed/partition_gone.py`" in out
    assert "dangling module reference " \
        "`repro_torch.distributed.partition.no_such_step`" in out
    assert out.splitlines()[-1] == "DOCS LINT FAILED"


def test_check_coverage_torch_passes_and_fails_under_its_floor(tmp_path,
                                                               monkeypatch):
    """The gate over one case of ``tests/test_torch_imports.py`` (five
    ``SimdramDevice`` options the port refuses), by the ``sys.settrace``
    collector: it measures a share of every ``src/repro_torch/core``
    file's lines and passes under a floor of 20 %; a run that measures
    nothing stays under the default floor and fails."""
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]),
        "JAX_PLATFORMS": "cpu",
        "HYPOTHESIS_STORAGE_DIRECTORY": str(tmp_path / "hypothesis")}
    report = tmp_path / "coverage.json"
    run = subprocess.run(
        [sys.executable, str(SCRIPTS / "check_coverage_torch.py"),
         "--floor", "20", "--json", str(report),
         "tests/test_torch_imports.py::test_unported_options_raise"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stdout + run.stderr
    assert run.stdout.splitlines()[-1] == "COVERAGE OK"
    rep = json.loads(report.read_text())
    assert rep["mode"] == "settrace" and rep["ok"]
    assert 20 <= rep["percent"] < 89
    assert {f["file"] for f in rep["files"]} == {
        f"src/repro_torch/core/{p.name}"
        for p in (ROOT / "src" / "repro_torch" / "core").glob("*.py")}
    gate = load(SCRIPTS / "check_coverage_torch.py", "port_check_coverage")
    monkeypatch.setattr(gate, "have_pytest_cov", lambda: False)
    monkeypatch.setattr(gate, "run_settrace", lambda tests: ({}, 0))
    monkeypatch.setattr(sys, "argv", ["check_coverage_torch.py"])
    out, rc = capture(gate.main)
    assert rc == 1
    assert f"COVERAGE GATE FAILED: 0.00% < {gate.DEFAULT_FLOOR:.2f}%" in out
