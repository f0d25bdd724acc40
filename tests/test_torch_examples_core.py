"""The port's examples against the reference's, on the CPU: the core ones.

Each case runs the reference example (``examples/``) in-process on JAX's
CPU and its counterpart under ``examples_torch/`` with ``--device cpu``,
both from a temporary working directory with their standard output
captured, and compares the two outputs line for line.  The reference's
module-scope examples run through ``runpy.run_path(...,
run_name="__main__")``.  Masked are measured quantities (walls, pack
times, tok/s, s/step) and the design lines each case names; every
modeled number, result and count must then be equal as printed.  Beyond
the text, each case holds the port's returned results against the
reference's oracle or its own other paths.

This file has the core examples (quickstart, bank scaling, fused
dispatch, compaction, the database apps); ``test_torch_examples_ladder.py``
the ladder's, ``test_torch_examples_lm.py`` the LM's and
``test_torch_examples_gates.py`` the two compiler gate scripts.  The
helpers here are shared by those files.
"""

import contextlib
import importlib.util
import io
import re
import runpy
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
REF = ROOT / "examples"
PORT = ROOT / "examples_torch"
CPU = ["--device", "cpu"]


def load(path: Path, name: str):
    """``path`` imported as a fresh module called ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def capture(fn, *args, **kwargs):
    """(what ``fn`` printed, what it returned)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kwargs)
    return buf.getvalue(), out


def run_reference(name: str, argv=(), module_scope: bool = False,
                  patch=None):
    """The reference example ``name`` run in-process with ``sys.argv``
    set to ``argv``: (its output, its module or globals).  ``patch``, if
    given, is called on the freshly loaded module before ``main()``."""
    path = REF / f"{name}.py"
    saved = sys.argv
    sys.argv = [str(path), *argv]
    try:
        if module_scope:
            return capture(runpy.run_path, str(path), run_name="__main__")
        mod = load(path, f"reference_{name}")
        if patch is not None:
            patch(mod)
        text, _ = capture(mod.main)
        return text, mod
    finally:
        sys.argv = saved


def run_port(name: str, argv=(), **kwargs):
    """The port's example ``name``: (its output, the dict ``main``
    returned)."""
    mod = load(PORT / f"{name}.py", f"port_{name}")
    return capture(mod.main, [*argv, *CPU], **kwargs)


def lines(text: str, subs=(), drop=()):
    """``text``'s lines after each ``(pattern, replacement)`` of ``subs``,
    without those matching a pattern of ``drop``."""
    out = []
    for line in text.splitlines():
        if any(re.search(p, line) for p in drop):
            continue
        for pat, rep in subs:
            line = re.sub(pat, rep, line)
        out.append(line)
    return out


def assert_same_lines(ref: str, port: str, subs=(), drop_port=(),
                      drop=()):
    """The two outputs equal line for line once ``subs`` masked both,
    ``drop`` left lines out of both and ``drop_port`` the port's design
    lines out of its output."""
    want = lines(ref, subs, drop)
    got = lines(port, subs, tuple(drop) + tuple(drop_port))
    assert len(got) == len(want), "\n".join(
        ["line counts differ", "reference:", *want, "port:", *got])
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"line {i}:\n  reference: {w}\n  port:      {g}"


def same(a, b) -> bool:
    """``a == b`` through nested dicts, lists, tuples and numpy arrays
    (floats compared with ``==``)."""
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(same(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (isinstance(b, (list, tuple)) and len(a) == len(b)
                and all(same(x, y) for x, y in zip(a, b)))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(np.asarray(a), np.asarray(b))
    return a == b


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for a file's cases, the earlier count restored
    after them: the cases run small tensors, where more threads only
    contend with the other test workers for the cores (autouse in every
    file that imports it)."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def in_tmp(tmp_path, monkeypatch):
    """Run the case from a temporary working directory, with both
    packages' command-table caches empty (an example's trace shows its
    cache misses, which earlier tests in the process would turn into
    hits)."""
    from repro.core.control_unit import TABLE_CACHE as REF_TABLE_CACHE
    from repro_torch.core.control_unit import TABLE_CACHE
    REF_TABLE_CACHE.clear()
    TABLE_CACHE.clear()
    monkeypatch.chdir(tmp_path)
    return tmp_path


# --------------------------------------------------------------------------
# the cases
# --------------------------------------------------------------------------

def test_quickstart(in_tmp):
    """Every line equal; the port's fourth backend line (``cuda``, the
    K1 -> K3 -> K2 fast path standing where the reference's ``pallas``
    stands) is its design line, and its lanes equal ``bitplane``'s."""
    ref, _ = run_reference("quickstart")
    port, out = run_port("quickstart")
    assert_same_lines(ref, port, drop_port=[r"^  backend cuda     : OK"])
    res = out["results"]
    rng = np.random.default_rng(0)
    x, y = rng.integers(0, 256, 1000), rng.integers(0, 256, 1000)
    assert res["subarray"] == ((x + y) % 256).tolist()
    assert all(res[b] == res["subarray"]
               for b in ("interp", "bitplane", "cuda"))
    assert same(out["modeled"]["cuda_totals"],
                out["modeled"]["bitplane_totals"])
    assert all(v == 0 for v in out["launches"].values())


def test_bank_scaling_quickstart(in_tmp):
    """Every line equal; the 50,000-lane bbop equals the reference's
    oracle."""
    from repro.core.ops_library import get_op as ref_get_op
    ref, _ = run_reference("bank_scaling_quickstart")
    port, out = run_port("bank_scaling_quickstart")
    assert_same_lines(ref, port)
    rng = np.random.default_rng(0)
    x, y = rng.integers(0, 256, 50_000), rng.integers(0, 256, 50_000)
    want = ref_get_op("addition", 8).oracle(x.astype(np.uint64),
                                            y.astype(np.uint64))[0]
    assert out["results"]["bbop"] == (want.astype(np.int64) & 0xFF).tolist()
    assert out["modeled"]["queue_stats"]["bbops"] == 32


def test_fused_dispatch_quickstart(in_tmp):
    """The reference's module-scope walk-through against the port's
    ``main()``: every line equal; fused and grouped give the same
    results."""
    ref, _ = run_reference("fused_dispatch_quickstart", module_scope=True)
    port, out = run_port("fused_dispatch_quickstart")
    assert_same_lines(ref, port)
    assert out["results"]["fused"] == out["results"]["grouped"]


def test_compaction_quickstart(in_tmp):
    """Every line equal but the cached-replay lines, where walls and pack
    times are measured and the reference's "new traces 0" (XLA) stands
    against the port's "new builds 0  K5 launches +0" (nvcc runs; the
    CPU launches no kernel): both must count zero new compilations, and
    the table-cache hits and misses must be equal."""
    ref, _ = run_reference("compaction_quickstart", module_scope=True)
    port, out = run_port("compaction_quickstart")
    subs = [(r"wall +\d+us  pack +\d+us", "wall *us  pack *us"),
            (r"new traces (\d+)", r"new compilations \1"),
            (r"new builds (\d+)  K5 launches \+0", r"new compilations \1")]
    assert_same_lines(ref, port, subs=subs)
    assert out["modeled"]["second"][:3] == [0, 3, 0]
    assert out["results"]["second"] != out["results"]["third"]


def test_simdram_database(in_tmp, monkeypatch):
    """Every line equal; the three apps' result dicts (selections,
    revenue, outputs, modeled latency and energy) equal the reference
    example's own, kept as it ran them."""
    from repro.apps import bitweaving as ref_bw
    from repro.apps import tpch as ref_tpch
    kept = []
    for mod in (ref_bw, ref_tpch):
        run0 = mod.run

        def run(*args, _run=run0, **kwargs):
            kept.append(_run(*args, **kwargs))
            return kept[-1]
        monkeypatch.setattr(mod, "run", run)
    ref, _ = run_reference("simdram_database")
    port, out = run_port("simdram_database")
    assert_same_lines(ref, port)
    res = out["results"]
    for got, want in zip((res["bitweaving"], res["tpch"], res["tpch_ambit"]),
                         kept):
        assert got.keys() == want.keys()
        for k, v in want.items():
            if k == "output":
                np.testing.assert_array_equal(np.asarray(got[k]),
                                              np.asarray(v))
            else:
                assert got[k] == v, k
    assert len(kept) == 3 and res["bitweaving"]["verified"]
