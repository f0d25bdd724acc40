#!/usr/bin/env python
"""Coverage floor gate of the PyTorch port over ``src/repro_torch/core``.

The port's counterpart of ``scripts/check_coverage.py``: the same two
measurement paths, report and exit codes, over the port's core engine
modules and the port's tests of them.  CI runs a bounded selection of
core-exercising ``tests/test_torch_*.py`` files under a line tracer and
fails the build when the measured line coverage of the core engine
modules drops below the floor.  The floor ratchets quality: new
core code must arrive with tests that execute it, and deleting tests
that were load-bearing for coverage fails loudly.

Two measurement paths:

  - ``pytest-cov``/``coverage`` installed → delegate to the real tool
    (subprocess ``pytest --cov``), parse its JSON report;
  - neither installed → a ``sys.settrace`` collector: the global trace
    callback returns a local tracer ONLY for frames whose code lives
    under ``src/repro_torch/core`` (every other frame is traced at call
    granularity and immediately opted out), so the overhead stays
    proportional to core-module Python work, not to the time spent in
    PyTorch or in the JAX package the parity tests compare against.
    Executable lines come from the compiled code objects' ``co_lines()``
    tables — the same ground truth coverage.py uses — so the two paths
    agree on the denominator.

Exit codes: 0 coverage >= floor, 1 below floor or no lines measured.

Usage:
  python scripts/check_coverage_torch.py                 # default floor + tests
  python scripts/check_coverage_torch.py --floor 55.0
  python scripts/check_coverage_torch.py --json COVERAGE_TORCH.json
  python scripts/check_coverage_torch.py tests/test_torch_channel.py tests/test_torch_rank.py
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import threading
from typing import Dict, Iterable, Set, Tuple

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.normpath(os.path.join(HERE, ".."))
CORE = os.path.join(ROOT, "src", "repro_torch", "core")

# Bounded default selection: the port's counterparts of the reference
# gate's files (test_torch_compiler_mirror.py mirrors test_uprogram.py,
# test_logic.py and test_ops_library.py), which exercise the core
# engine ladder directly.  Deliberately NOT the whole suite; extend the
# list when a new core module lands with its own test file.
DEFAULT_TESTS = (
    "tests/test_torch_compiler_mirror.py",
    "tests/test_torch_control_unit.py",
    "tests/test_torch_bank_engine.py",
    "tests/test_torch_fused_dispatch.py",
    "tests/test_torch_chip.py",
    "tests/test_torch_channel.py",
    "tests/test_torch_rank.py",
    "tests/test_torch_transfer_model.py",
    "tests/test_torch_telemetry.py",
    "tests/test_torch_fault.py",
)

# Floor just under the selection's measured coverage when the gate
# landed (90.38%, 4,940 of 5,466 lines, settrace) — raise it as
# coverage grows, never lower it to make a failing build pass.
DEFAULT_FLOOR = 89.0


def _core_files() -> Tuple[str, ...]:
    return tuple(sorted(
        os.path.join(CORE, f) for f in os.listdir(CORE)
        if f.endswith(".py")))


def executable_lines(path: str) -> Set[int]:
    """Line numbers that CAN execute, from the compiled code objects'
    ``co_lines()`` tables (recursively through nested functions /
    comprehensions / class bodies) — docstrings and blank lines are
    excluded by construction."""
    with open(path) as f:
        code = compile(f.read(), path, "exec")
    lines: Set[int] = set()
    stack = [code]
    while stack:
        co = stack.pop()
        for _, _, lineno in co.co_lines():
            if lineno is not None:
                lines.add(lineno)
        for const in co.co_consts:
            if hasattr(const, "co_lines"):
                stack.append(const)
    return lines


# --- settrace collector -------------------------------------------------

class LineCollector:
    """Per-file hit-line sets for frames under one directory prefix."""

    def __init__(self, prefix: str):
        self.prefix = prefix
        self.hits: Dict[str, Set[int]] = {}

    def _local(self, frame, event, arg):
        if event == "line":
            self.hits[frame.f_code.co_filename].add(frame.f_lineno)
        return self._local

    def _global(self, frame, event, arg):
        if event != "call":
            return None
        fn = frame.f_code.co_filename
        if not fn.startswith(self.prefix):
            return None          # opt out: no line events for this frame
        self.hits.setdefault(fn, set())
        return self._local

    def __enter__(self):
        threading.settrace(self._global)
        sys.settrace(self._global)
        return self

    def __exit__(self, *exc):
        sys.settrace(None)
        threading.settrace(None)  # type: ignore[arg-type]
        return False


def run_settrace(tests: Iterable[str]) -> Tuple[Dict[str, Set[int]], int]:
    """Run pytest in-process under the collector; returns (hits, rc).
    The repo root goes on the path too: the parity tests import the
    reference's ``benchmarks`` package."""
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import pytest
    with LineCollector(os.path.realpath(CORE) + os.sep) as col:
        rc = pytest.main(["-q", "-p", "no:cacheprovider", *tests])
    # settrace reports whatever path the frames carry; normalize
    hits = {os.path.realpath(f): s for f, s in col.hits.items()}
    return hits, int(rc)


# --- pytest-cov delegation ----------------------------------------------

def have_pytest_cov() -> bool:
    return (importlib.util.find_spec("pytest_cov") is not None
            and importlib.util.find_spec("coverage") is not None)


def run_pytest_cov(tests: Iterable[str]) -> Tuple[Dict[str, Set[int]], int]:
    """Delegate to the real coverage tool when the container has it."""
    report = os.path.join(ROOT, ".coverage_report.json")
    env = dict(os.environ)
    env["PYTHONPATH"] = (os.path.join(ROOT, "src")
                         + os.pathsep + env.get("PYTHONPATH", ""))
    rc = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "--cov=repro_torch.core",
         f"--cov-report=json:{report}", *tests],
        cwd=ROOT, env=env).returncode
    hits: Dict[str, Set[int]] = {}
    if os.path.exists(report):
        with open(report) as f:
            data = json.load(f)
        for fn, rec in data.get("files", {}).items():
            path = os.path.realpath(os.path.join(ROOT, fn))
            hits[path] = set(rec.get("executed_lines", ()))
        os.remove(report)
    return hits, rc


# --- report -------------------------------------------------------------

def summarize(hits: Dict[str, Set[int]]) -> Dict:
    files = []
    tot_exec = tot_hit = 0
    for path in _core_files():
        want = executable_lines(path)
        got = hits.get(os.path.realpath(path), set()) & want
        tot_exec += len(want)
        tot_hit += len(got)
        files.append({
            "file": os.path.relpath(path, ROOT),
            "executable": len(want),
            "covered": len(got),
            "percent": round(100.0 * len(got) / len(want), 2)
            if want else 100.0,
        })
    pct = 100.0 * tot_hit / tot_exec if tot_exec else 0.0
    return {"files": files, "executable": tot_exec, "covered": tot_hit,
            "percent": round(pct, 2)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("tests", nargs="*", default=None,
                    help="test files to run (default: the bounded core "
                         "selection)")
    ap.add_argument("--floor", type=float, default=DEFAULT_FLOOR,
                    help=f"fail below this total %% (default "
                         f"{DEFAULT_FLOOR})")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="write the per-file report here (CI artifact)")
    args = ap.parse_args()
    tests = args.tests or [os.path.join(ROOT, t) for t in DEFAULT_TESTS]

    if have_pytest_cov():
        mode = "pytest-cov"
        hits, rc = run_pytest_cov(tests)
    else:
        mode = "settrace"
        hits, rc = run_settrace(tests)
    if rc != 0:
        print(f"coverage: test run failed (rc={rc}) — gate void", flush=True)
        return 1

    rep = summarize(hits)
    rep["mode"] = mode
    rep["floor"] = args.floor
    rep["ok"] = rep["percent"] >= args.floor and rep["executable"] > 0
    width = max(len(f["file"]) for f in rep["files"])
    print(f"\n# coverage of src/repro_torch/core ({mode})")
    for f in sorted(rep["files"], key=lambda r: r["percent"]):
        print(f"{f['file']:<{width}}  {f['covered']:>5}/{f['executable']:<5}"
              f"  {f['percent']:6.2f}%")
    print(f"{'TOTAL':<{width}}  {rep['covered']:>5}/{rep['executable']:<5}"
          f"  {rep['percent']:6.2f}%   (floor {args.floor:.2f}%)")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rep, f, indent=2)
        print(f"# wrote {args.json}")
    if not rep["ok"]:
        print(f"COVERAGE GATE FAILED: {rep['percent']:.2f}% < "
              f"{args.floor:.2f}%")
        return 1
    print("COVERAGE OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
