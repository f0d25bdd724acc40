"""The port's ladder, fault, telemetry and serving examples against the
reference's, on the CPU.

``chip_offload_quickstart.py``, ``channel_quickstart.py``,
``rank_overlap_quickstart.py``, ``fault_tolerance_quickstart.py``,
``telemetry_quickstart.py`` and ``serving_quickstart.py``, each run
in-process beside its reference (module-scope ones through
``runpy.run_path``) from a temporary working directory, outputs compared
line for line (``test_torch_examples_core.py``).  Masked: measured walls
and pack times; the telemetry example's five per-stage rows, which it
sorts by measured wall; the flip-drawn fault lines, held statistically
(``fault_stats_agree``).  The chip example's LM goes by the rules of
``test_torch_examples_lm.py`` on the reference's weights.
"""

import ast
import re
import subprocess
import sys
from pathlib import Path

import numpy as np

from test_torch_examples_core import (ROOT, assert_same_lines,  # noqa: F401
                                      in_tmp, one_torch_thread, run_port,
                                      run_reference, same)
from test_torch_examples_lm import (BF16_REL, decode_agrees, port_params,
                                    record_reference_lm)

MEASURED_WALL = (r"^measured wall .*$", "measured wall *")


def test_chip_offload_quickstart(in_tmp, monkeypatch):
    """Every line equal but the measured wall (its design text, "first
    dispatch includes the kernel builds", is masked with it); the served
    tokens on the reference's weights under the bf16 margin rule, and
    the offload chip's counts with them."""
    rec = record_reference_lm(monkeypatch)
    ref, _ = run_reference("chip_offload_quickstart")
    port, out = run_port("chip_offload_quickstart",
                         params=port_params(rec["params"][0]))
    agree = decode_agrees(out["lm"]["logits"], rec["logits"], BF16_REL)
    drop = [] if agree else [r"^server decoded ", r"^  \d+ bbops in "]
    assert_same_lines(ref, port, subs=[MEASURED_WALL], drop=drop)
    assert out["modeled"]["offload"][0] > 0      # bbops on the chip


def test_channel_quickstart(in_tmp):
    """Every line equal but the measured wall."""
    ref, _ = run_reference("channel_quickstart")
    port, out = run_port("channel_quickstart")
    assert_same_lines(ref, port, subs=[MEASURED_WALL])
    st = out["modeled"]["channel"]
    assert st["super_rounds"] == 2 and st["bbops"] == 10


def test_rank_overlap_quickstart(in_tmp):
    """Every line equal: results against the sequential per-channel
    dispatch, the DMA overlap split and the crossover."""
    ref, _ = run_reference("rank_overlap_quickstart")
    port, out = run_port("rank_overlap_quickstart")
    assert_same_lines(ref, port)
    assert out["modeled"]["serial"]["exposed_transfer_s"] == \
        out["modeled"]["serial"]["transfer_s"]


def fault_stats_agree(ref: dict, port: dict, max_retries: int = 3) -> None:
    """Two ``FaultStats`` dicts of one faulty dispatch, one drawn by
    ``jax.random``, one by the port's Philox: the same keys; the same
    redispatches, remaps and host fallbacks (none at this rate); the
    injected flip counts, each Poisson, within 4 standard deviations of
    their difference plus 4 (|a - b| <= 4 sqrt(a + b) + 4); detected <=
    injected, corrected <= detected; at most ``max_retries`` retries;
    and a positive overhead in both."""
    assert ref.keys() == port.keys()
    for k in ("redispatches", "remapped", "host_fallbacks"):
        assert port[k] == ref[k] == 0, k
    a, b = ref["injected"], port["injected"]
    assert abs(a - b) <= 4 * np.sqrt(a + b) + 4, (a, b)
    for s in (ref, port):
        assert s["corrected"] <= s["detected"] <= s["injected"]
        assert s["retries"] <= max_retries and s["overhead_s"] > 0


def test_fault_tolerance_quickstart(in_tmp):
    """Sections 2, 4 and 5 (dead units drawn with numpy, exhaustion, the
    disabled model) equal line for line; sections 1 and 3 (flips) equal
    in everything but the drawn fields: both exact after vote and retry,
    the same modeled replay latency, ``fault_stats_agree``."""
    ref, _ = run_reference("fault_tolerance_quickstart", module_scope=True)
    port, out = run_port("fault_tolerance_quickstart")
    drawn = {}

    def keep(tag):
        def sub(m):
            drawn.setdefault(tag, []).append(ast.literal_eval(m.group(1)))
            return f"{tag} *"
        return sub

    subs = [(r"^fault stats: (\{.*\})$", keep("fault stats:")),
            (r" \+ fault overhead [\d.]+ us$", " + fault overhead * us"),
            (r"stats: (\{.*\})$", keep("stats:"))]
    assert_same_lines(ref, port, subs=subs)
    for tag, (r, p) in drawn.items():
        fault_stats_agree(r, p)
    assert out["drawn"]["bank"]["exact"] and out["drawn"]["chip"]["exact"]
    assert out["results"]["dead"] == out["results"]["clean"]


def exports_under(monkeypatch, obs_module, folder):
    """Send ``obs_module``'s two exporters to ``folder`` under the name
    the caller gave them, so that the example's ``/tmp`` paths stay its
    own text and no other run's files are read back."""
    folder.mkdir(parents=True, exist_ok=True)
    for fn in ("write_chrome_trace", "write_jsonl"):
        orig = getattr(obs_module, fn)
        monkeypatch.setattr(obs_module, fn, lambda path, *a, _f=orig, **k:
                            _f(str(folder / Path(path).name), *a, **k))


def test_telemetry_quickstart(in_tmp, monkeypatch):
    """Every line equal with the spans' measured walls masked, the five
    per-stage rows (sorted by measured wall) left out and the script the
    summary line names (``trace_summary.py`` / ``trace_summary_torch.py``)
    masked; the port's Chrome trace passes ``scripts/check_trace.py``.
    Each example's two exports go under this case's temporary directory,
    the reference's and the port's apart."""
    from repro import obs as ref_obs
    from repro_torch import obs as port_obs
    exports_under(monkeypatch, ref_obs, in_tmp / "reference")
    exports_under(monkeypatch, port_obs, in_tmp / "port")
    ref, _ = run_reference("telemetry_quickstart", module_scope=True)
    port, out = run_port("telemetry_quickstart")
    subs = [(r"wall +[\d.]+ us", "wall * us"),
            (r"scripts/trace_summary(_torch)?\.py", "scripts/trace_summary")]
    drop = [r"^    \S+ +x\d+ wall .* modeled .* us$"]
    assert_same_lines(ref, port, subs=subs, drop=drop)
    assert all(out["modeled"]["reconciled"])
    trace = in_tmp / "port" / "simdram_trace.json"
    assert (in_tmp / "port" / "simdram_spans.jsonl").stat().st_size > 0
    gate = subprocess.run(
        [sys.executable, str(ROOT / "scripts" / "check_trace.py"),
         str(trace)], capture_output=True, text=True, timeout=120)
    assert gate.returncode == 0, gate.stdout + gate.stderr
    summary = subprocess.run(
        [sys.executable, str(ROOT / "scripts" / "trace_summary_torch.py"),
         str(trace), "--sort", "modeled"],
        capture_output=True, text=True, timeout=120)
    assert summary.returncode == 0, summary.stderr
    assert re.search(r"^channel\.dispatch +dispatch +1 ", summary.stdout,
                     re.M), summary.stdout


def test_serving_quickstart(in_tmp):
    """Every line equal (the front-end runs on the modeled clock, so the
    whole walk-through is deterministic); no thread left running."""
    import threading
    ref, _ = run_reference("serving_quickstart", module_scope=True)
    before = set(threading.enumerate())
    port, out = run_port("serving_quickstart")
    assert_same_lines(ref, port)
    assert not set(threading.enumerate()) - before
    assert out["modeled"]["breaker"]["stats"]["breaker_recoveries"] >= 1
