#!/usr/bin/env python3
"""Drive the PyTorch port's bbop main path once on one CUDA card.

    python3 chip_smoke.py [--json PATH]

Run from a checkout; it puts the checkout's ``src/`` and ``experiments/``
on ``sys.path`` itself, reads ``BENCH_apps.json`` and imports only
``repro_torch`` and ``popmma_probe`` (no JAX).  Phases, one line each:

  1. build the CUDA kernels from ``src/repro_torch/csrc`` (nvcc, sm_90a)
     and print the ptxas register / shared-memory / spill lines;
  2. K1/K2: transpose 1,048,576 random lanes at 8, 16 and 32 planes; the
     round trip is exact and each kernel equals its plain version bit for
     bit (K2 signed and unsigned); each width's wrapper time, bare-launch
     time (CUDA events), host time per launch and kernel-only time
     (``torch.profiler``);
  3. the fast path: ``SimdramDevice(backend="cuda").bbop`` for all 16 ops
     at 8 bits and addition/multiplication/greater at 16 bits, at
     ``DDR4.simd_lanes`` lanes, checked against each op's oracle, plus
     one ``backend="bitplane"`` call; then K3 against the plain circuit,
     and K1 and K2 against theirs at each op's operand and output
     widths, with each op's times as in phase 2 and its program's gates,
     levels, slots and warps (the ``bitplane`` call's K3 launch repeats
     addition/8's at its shape, so 19 comparisons cover 20 launches);
  4. the slice: ``SimdramDevice(backend="bank").dispatch`` of the mix and
     chain queues of ``benchmarks/bank_scaling.py`` at 65,536 lanes per
     instruction, checked against the numpy oracle, with 5 K5 launches;
     K1 on the chain's entry operand and K2 on its vertical results
     against their plain versions; then each of the mix queue's fused
     waves through K5 (with the wave's cached schedule) and through the
     plain replay, and the chain queue's waves of a repeat of its
     dispatch likewise; each mix wave's device
     time, longest real command count and time per command, and a
     repeat of both dispatches under ``torch.profiler`` (host wall,
     device time by kernel and copy, the device's idle share);
  5. the bit-serial matmul (K4): ``bitserial_matmul`` of 2-bit unsigned
     activations by 2-bit signed weights at the im2col shapes of three
     VGG-16 layers at 224 x 224, one fused K4 launch each, checked against
     exact integer oracles, plus a 1 x 1-bit and a 4 x 4-bit
     ``quantized_matmul`` (both branches); then the binary MAC rate of
     each unit K4 could run on (``experiments/popmma_probe.py``, built in
     phase 1), of which the fastest sets K4's bound; then at each shape
     K4's fused product against its plain version and ``torch._int_mm``
     on the 2-bit values, and one binary product against
     ``torch._int_mm`` on the bits; every K4 launch of the path has its
     twin compared with the plain version;
  6. the fault path (K6): ``SimdramDevice(backend="bank", fault=...)``
     over the mix queue at 32,768 logical lanes (two replicas fill each
     unit's 65,536 columns) at the paper's sigma = 0.15, checked against
     the fault-free dispatch and the oracle (lanes whose replicas were
     corrupted alike are counted and bounded, see ``WRONG_LANE_SHARE``,
     and its wrong lanes and K6 launches must be those of ``SIGMA_SEED0``);
     a dead-unit run that must heal exactly by blacklisting; a
     stuck-column run with 1e-3 flips that must exhaust every unit as the
     reference does, or return exact results; K6
     against its plain version bit for bit on every attempt of the sigma
     run and on every wave with all three failure modes; a disabled
     model launches no K6;
  7. the ladder at full width (``DDR4``, 65,536 columns a subarray, 16
     banks a chip): ``SimdramDevice(backend="chip")`` (16 units),
     ``backend="channel"`` with 8 chips (128 units) and ``backend="rank"``
     with 2 channels of 8 chips (256 units) each dispatch the mix queue
     with two instructions a unit and the chain queue at 65,536 lanes an
     instruction, and run one ``bbop`` over all their lanes; every result
     equals the oracle and the tier's ``sequential_*`` baseline, and each
     stacked round is one K5 launch.  Per tier: first and warm wall, pack
     wall, table-cache hits, misses and bytes, the card's busy time and
     idle share and host-to-device copies (profiler), each round's K5
     kernel time beside its bound, and the modeled latency and transfer
     fields.  Every round of a repeat of the counted run (its twin) goes
     through K5 and the plain replay, which must agree bit for bit, and
     K1 and K2 of the chain queue are held against theirs.  Then the
     fault wrappers on the chip and a 2-chip channel: sigma 0.15 with
     two replicas (wrong lanes bounded as in phase 6), dead units and
     sparse stuck columns (both exact), one K6 launch per attempt of a
     round, and K6 against its plain version, states and flip counts,
     on every attempt of the three runs;
  8. the seven paper apps (``src/repro_torch/apps``) on the rungs
     ``bitplane``, ``cuda``, ``bank``, ``chip`` and ``channel``: (8a) at
     ``benchmarks/paper_tables.py``'s "smoke" sizes and configuration,
     card ``==`` the same run with ``torch_device="cpu"`` (outputs,
     result dicts, totals, modeled engine stats), and ``==``
     ``BENCH_apps.json`` on every integer field, its floats within a
     relative 1e-12 (they were summed in another order); ``cuda`` ``==``
     ``bitplane``; (8b) at its "full" sizes on 16 banks x 2 subarrays x
     4 chips, every app verified and bit-equal on all five rungs, with
     first and warm walls, packing, launches, rounds, table-cache hits
     and misses and the modeled latency and energy; (8c) TPC-H Q6 over
     the 6,001,215 lineitem rows of scale factor 1 on the same
     configuration, the revenue equal to numpy on every rung, plus a
     profiled repeat on the fused rungs (busy time, idle share,
     host-to-device copies, K5 time) and K5 per round beside its bound.
     Every app run on the card is counted, then repeated as its twin:
     each K1, K2, K3 and K5 launch of the repeat is held against the
     plain version on the same inputs, bit for bit, one twin per launch
     of the counted run (the ``apps`` path of each kernel's agreement);
  9. one JSON line with every kernel's launches on its path, its
     agreement with its plain version (per path: the launches, the
     calls compared at the path's shapes and their largest error;
     ``max_abs_err`` is the largest over the paths, and every path with
     a launch must have a comparison), its time (CUDA events), its
     kernel-only time (profiler), the plain version's time, its bound on
     the card and, where one PyTorch call computes the same function,
     that call's time; K5 and K6 add each wave's device and kernel time,
     the longest unit's real command count and ns per real command, and
     the ladder's rounds; and the kernels ranked by launches x (kernel
     time - bound) per call.

The launch counters are set to 0 just before each path (phases 3, 4, 5
and 6, each tier of phase 7 and each app run of phase 8) and read just
after; comparison launches come after the read.
Any mismatch, a missing card, a failed build or a kernel with no launch
exits non-zero without the result line.  The last line is the device
JSON.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
EXPERIMENTS = ROOT / "experiments"

# H100 SXM peaks used for the bounds: HBM3 at
# 3.35 TB/s; 32-bit bitwise LOP3 (and 32-bit integer add, multiply and
# compare) at 64 per clock per SM (compute capability 9.0) x 132 SMs x
# 1.98 GHz boost = 16.7 T/s; population count at 16 per clock per SM =
# 4.18 T/s
HBM_BYTES_PER_S = 3.35e12
LOP3_PER_S = 64 * 132 * 1.98e9
# int8 tensor cores, dense: 1,979 T operations/s (data sheet), half as many
# multiply-accumulates.  K4's bound takes the larger of this and the
# binary MAC rates experiments/popmma_probe.py measures in this run (the
# b1 forms have no data-sheet rate); an int8 MAC on {0, 1} bits is one
# binary MAC
INT8_MACS_PER_S = 1979e12 / 2
PROBE_LIBRARIES = ("units", "wgmma_b1", "wgmma_s8")
# K6's integer operations, counted from csrc/replay.cu: per word and AP
# command 8 Philox calls of 10 rounds (2 multiply-high, 2 multiply-low,
# two 3-input XORs of one LOP3 each) and 2 operations per uniform
# (compare, OR), then the XOR, popcount and count addition of the mask;
# the key schedule's 9 bumps of 2 additions once per word column
PHILOX_CALL_OPS = 10 * (4 + 2) + 4 * 2
FLIP_OPS_PER_AP_WORD = 8 * PHILOX_CALL_OPS + 3
KEY_SCHEDULE_OPS = 9 * 2
# im2col shapes (M = output pixels, K = 3 x 3 x input channels, N =
# output channels) of three VGG-16 layers at the published 224 x 224
# input (src/repro/apps/vgg.py's plan)
VGG16_SHAPES = (("conv1_2", 224 * 224, 9 * 64, 64),
                ("conv3_2", 56 * 56, 9 * 256, 256),
                ("conv4_2", 28 * 28, 9 * 512, 512))
FAULT_LANES = 32768
STUCK_LANES = 16384          # three replicas fill 49,152 of 65,536 columns
# the ladder's tiers at full width: (backend, chips a channel, channels);
# two mix instructions a unit
LADDER = (("chip", 1, 1), ("channel", 8, 1), ("rank", 8, 2))
LADDER_FAULT = (("chip", 1), ("channel", 2))
# the ladder's stuck-only run: at the bank run's 0.02 every unit holds
# lanes with two replicas on stuck columns and is retired (phase 6); at
# 1e-4 a unit holds about one cluster of 4 stuck columns, so the vote
# outvotes each stuck replica and the run must be exact
LADDER_STUCK_RATE = 1e-4
# The fault layer's vote accepts a wrong value when the replicas of a
# lane were corrupted alike, in the reference as in the port, so the
# sigma = 0.15 run is not exact at this scale.  experiments/fault_share.py
# counted the wrong lanes of 1,048,576 at fault seeds 0-9: 6 to 24 (166
# in all) in the port on an H100, 9 to 19 (140 in all) in the reference
# on the CPU (PERF.md).  The bound is about twice the largest count.
WRONG_LANE_SHARE = 5e-5
# the sigma = 0.15 run at fault seed 0 as it came out before the replay
# kernels were redesigned (PERF.md): the redesign keeps every random bit
# and the vote, so the outcome must not move
SIGMA_SEED0 = {"wrong_lanes": 24, "faulty_replay_launches": 9}

# the apps (phase 8): benchmarks/paper_tables.py's app tables on their
# configurations (its "smoke" sizes, which BENCH_apps.json records, and
# its "full" sizes), rebuilt in app_runs; the port's five rungs
APPS_SMOKE_CFG = {"n_banks": 4, "subarrays_per_bank": 2, "n_chips": 2}
APPS_FULL_CFG = {"n_banks": 16, "subarrays_per_bank": 2, "n_chips": 4}
APP_RUNGS = ("bitplane", "cuda", "bank", "chip", "channel")
FUSED_RUNGS = ("bank", "chip", "channel")
# the float fields of BENCH_apps.json were summed in another order than a
# live run sums them and differ in the last bits; its integer fields
# must be equal
BENCH_REL_TOL = 1e-12
MEASURED_STATS = ("wall_s", "pack_wall_s")
# TPC-H lineitem rows at scale factor 1 (TPC-H specification, clause 4.2.5)
TPCH_SF1_ROWS = 6_001_215

TRANSPOSE_WIDTHS = (8, 16, 32)
MIX_OPS = ("addition", "multiplication", "greater", "and_red")
FAST_PATH = [(op, 8) for op in (
    "abs", "addition", "and_red", "bitcount", "division", "equal", "greater",
    "greater_equal", "if_else", "max", "min", "multiplication", "or_red",
    "relu", "subtraction", "xor_red")] + [
    ("addition", 16), ("multiplication", 16), ("greater", 16)]


class SmokeFailure(RuntimeError):
    pass


# profiler sessions tried before a time is taken another way, and the
# kernels that kernel_ms timed with CUDA events because no session
# recorded them
PROFILER_ATTEMPTS = 3
PROFILER_MISSES: list = []


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else \
        f"nvidia-smi failed: {out.stderr.strip()}"


def bound(n_bytes: float, n_ops: float, ops_per_s: float = LOP3_PER_S):
    """(bound_ms, bound_by): the larger of bytes over HBM and operations
    over their rate (32-bit integer and bitwise by default)."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs_err(a, b) -> int:
    import torch
    check(a.shape == b.shape, f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean ms per call over ``reps`` calls, CUDA events, after warm-up."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn, reps: int) -> float:
    """Host ms per call of ``fn`` (a bare launch) over ``reps`` calls: the
    time to enqueue, on the host's clock, with the card kept busy."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e3


def kernel_name(key: str) -> str:
    """A profiler event's kernel name without namespace, return type,
    template arguments or parameters."""
    name = key.replace("(anonymous namespace)::", "")
    return name.split("(")[0].split("<")[0].strip().split(" ")[-1]


def kernel_ms(fn, reps: int, name: str) -> float:
    """Kernel-only ms per launch: ``torch.profiler``'s self device time of
    the kernel ``name`` over ``reps`` calls of ``fn`` (after one warm-up
    call), divided by the kernel's launches in them.  A session that
    records none of the launches (the profiler drops one now and then,
    and now and then every session for a while) is repeated, up to
    PROFILER_ATTEMPTS sessions in all; after that the kernel is timed with
    CUDA events over ``reps`` calls instead (the host's launch rate
    where that is longer), and the miss is kept in PROFILER_MISSES."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILER_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us, n = 0.0, 0
        for e in prof.key_averages():
            if (e.device_type == DeviceType.CUDA
                    and kernel_name(e.key) == name):
                us += e.self_device_time_total
                n += e.count
        if n > 0:
            return us / n / 1e3
    seen = sorted({kernel_name(e.key) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA})
    ms = time_ms(fn, reps)
    PROFILER_MISSES.append({"kernel": name, "device_events_seen": seen,
                            "events_ms": ms})
    print(f"[profiler] no {name} launch in {PROFILER_ATTEMPTS} sessions "
          f"(device events {seen}); timed by CUDA events instead: "
          f"{ms:.4f} ms", flush=True)
    return ms


def device_breakdown(fn) -> dict:
    """Run ``fn`` once under ``torch.profiler``: host wall, device time by
    kernel or copy name and the device's idle share of the wall (one
    stream, so busy spans do not overlap).  Only device-side events
    count: a host op's device time is that of its kernels and copies,
    which are counted themselves, and the profiler's own buffer requests
    are not the program's work.  A session that records no device event
    runs ``fn`` again, up to PROFILER_ATTEMPTS sessions in all."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(PROFILER_ATTEMPTS):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        device_ms = {}
        for e in prof.key_averages():
            us = e.self_device_time_total
            if (e.device_type != DeviceType.CUDA or us <= 0
                    or e.key == "Activity Buffer Request"):
                continue
            name = e.key.replace("(anonymous namespace)::", "")
            name = name.split("(")[0].split("<")[0].strip() or e.key
            device_ms[name] = device_ms.get(name, 0.0) + us / 1e3
        if device_ms:
            break
    busy = sum(device_ms.values())
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "idle_share": max(0.0, 1.0 - busy / wall_ms),
            "device_ms": dict(sorted(device_ms.items(),
                                     key=lambda kv: -kv[1]))}


def replay_ops_per_word(t: np.ndarray, counts: np.ndarray,
                        fault_thr=None) -> int:
    """Bitwise operations a word column needs for the (n_units, n_cmds,
    13) tables ``t`` replayed to each unit's real command count
    ``counts``: one LOP3 per majority and per complemented port.  With
    ``fault_thr`` (K6) add the stuck masking of the three writes of every
    real command and, when the threshold needs random bits, the flip mask
    of each AP.  (The NOPs after a unit's count are all zeros: no AP, no
    complement.)"""
    is_ap = t[..., 0] == 1
    ops = int(is_ap.sum()
              + np.where(is_ap, t[..., 2] + t[..., 4] + t[..., 6]
                         + t[..., 8] + t[..., 10] + t[..., 12],
                         t[..., 2] + t[..., 8]).sum())
    if fault_thr is not None:
        ops += 3 * int(counts.sum())
        if 0 < fault_thr < 1 << 32:
            ops += (FLIP_OPS_PER_AP_WORD * int(is_ap.sum())
                    + KEY_SCHEDULE_OPS * t.shape[0])
    return ops


def add_replay_wave(k: dict, wave_ms: float, tables, schedule) -> None:
    """Add one wave's device time, longest real command count and real
    table bytes to a K5 or K6 entry."""
    counts = schedule[0].cpu().numpy()
    longest = int(counts.max())
    k["wave_device_ms"].append(wave_ms)
    k["longest_unit_cmds"].append(longest)
    k["ns_per_real_cmd"].append(wave_ms * 1e6 / max(longest, 1))
    k["bytes"] += int(counts.sum()) * 13 * 4


def mix_queue(bank_mod, get_op, lanes, n_instrs=32, widths=(8, 16), seed=0):
    """benchmarks/bank_scaling.py:_mix_queue, rebuilt on the port."""
    rng = np.random.default_rng(seed)
    queue = []
    for i in range(n_instrs):
        op = MIX_OPS[i % len(MIX_OPS)]
        w = widths[(i // len(MIX_OPS)) % len(widths)]
        ops = tuple(rng.integers(0, 1 << b, lanes).astype(np.uint64)
                    for b in get_op(op, w).operand_bits)
        queue.append(bank_mod.BbopInstr(op, ops, w))
    return queue


def chain_queue(bank_mod, lanes, device, seed=1):
    """benchmarks/bank_scaling.py:_chain_queue (mul8 -> add16 -> relu16,
    relu kept vertical), rebuilt on the port; the first chain's add16
    operand enters through the transposition unit (K1)."""
    rng = np.random.default_rng(seed)
    queue, raw = [], []
    for c in range(4):
        x, y = (rng.integers(0, 256, lanes).astype(np.uint64)
                for _ in range(2))
        z = rng.integers(0, 1 << 16, lanes).astype(np.uint64)
        raw.append((x, y, z))
        z_op = (bank_mod.VerticalOperand.from_values(z, 16, device=device)
                if c == 0 else z)
        base = len(queue)
        queue.append(bank_mod.BbopInstr("multiplication", (x, y), 8))
        queue.append(bank_mod.BbopInstr("addition", (bank_mod.Ref(base), z_op),
                                        16))
        queue.append(bank_mod.BbopInstr("relu", (bank_mod.Ref(base + 1),), 16,
                                        keep_vertical=True))
    return queue, raw


def fmt_list(xs) -> str:
    return "[" + ", ".join(f"{x:.4f}" for x in xs) + "]"


def masked_equal(got, want, out_bits) -> bool:
    got = got if isinstance(got, tuple) else (got,)
    return all(
        np.array_equal(np.asarray(g).astype(np.int64) & ((1 << w) - 1),
                       np.asarray(e).astype(np.int64) & ((1 << w) - 1))
        for g, e, w in zip(got, want, out_bits))


def run() -> dict:
    import torch

    from repro_torch.core import bitplane
    from repro_torch.core.bank import Bank, plan_queue, flatten_result
    from repro_torch.core import bank as bank_mod
    from repro_torch.core.control_unit import (CMD_WIDTH, replay,
                                               replay_plain)
    from repro_torch.core.isa import SimdramDevice
    from repro_torch.core.ops_library import get_op
    from repro_torch.core.timing import DDR4
    from repro_torch.kernels import build
    from repro_torch.kernels.bitplane_ops import _launch as k3_launch
    from repro_torch.kernels.bitplane_ops import (circuit_on_planes,
                                                  circuit_plain, slot_program)
    from repro_torch.kernels.ops import h2v
    from repro_torch.kernels.transpose_kernel import (h2v_cuda, h2v_plain,
                                                      v2h_cuda, v2h_plain)
    import popmma_probe

    dev = torch.device("cuda")
    record: dict = {"card": nvidia_smi("name,power.limit")}

    # -- 1. build --------------------------------------------------------
    # the unit-rate probes of K4's bound (phase 5) build beside the kernels
    t0 = time.perf_counter()
    probes = popmma_probe.start_builds(build, PROBE_LIBRARIES)
    build_s = build.build_all()
    probe_libs = popmma_probe.finish_builds(probes)
    record["build_s"] = time.perf_counter() - t0
    print(f"[1] built {len(build.LIBRARIES)} kernel libraries in "
          f"{build_s:.1f} s (nvcc runs: {sum(build.BUILDS.values())}) and "
          f"{len(PROBE_LIBRARIES)} unit-rate probes, "
          f"{record['build_s']:.1f} s in all")
    for line in build.build_log().splitlines():
        if line.startswith("==") or any(k in line for k in (
                "Compiling entry", "registers", "spill")):
            print("[1]   " + line.strip())
    for name, lib in probe_libs.items():
        log = lib if isinstance(lib, str) else lib.build_log
        refused = " (refused by nvcc)" if isinstance(lib, str) else ""
        for line in log.splitlines():
            if isinstance(lib, str) or "arning" in line:
                print(f"[1]   probe {name}{refused}: {line.strip()}")

    # -- 2. K1/K2 at 1,048,576 lanes --------------------------------------
    n_lanes = DDR4.simd_lanes
    rng = np.random.default_rng(2)
    vals = torch.from_numpy(rng.integers(0, 2**32, n_lanes, dtype=np.uint32)
                            .view(np.int32)).to(dev)
    planes = h2v_cuda(vals)
    err_h2v = max_abs_err(planes, h2v_plain(vals))
    back = v2h_cuda(planes)
    err_v2h = max_abs_err(back, v2h_plain(planes))
    torch.cuda.synchronize()
    check(err_h2v == 0 and err_v2h == 0, "K1/K2 disagree with plain")
    check(torch.equal(back, vals), "h2v -> v2h round trip is not exact")
    n_words = n_lanes // 32
    # each kernel at 8, 16 and 32 planes: the wrapper, the bare launch
    # (CUDA events over a loop of launches, and the host's enqueue time),
    # and the kernel alone (the profiler); bytes: each lane value once and
    # each plane word once
    kern = {"h2v": {"per_width": {}}, "v2h": {"per_width": {}}}
    errs_t = {"h2v": [err_h2v], "v2h": [err_v2h]}
    for k in TRANSPOSE_WIDTHS:
        pk = h2v_cuda(vals, k)
        vk = v2h_cuda(pk)
        err_h = max_abs_err(pk, h2v_plain(vals, k))
        err_v = max(max_abs_err(vk, v2h_plain(pk)),
                    max_abs_err(v2h_cuda(pk, signed=True),
                                v2h_plain(pk, signed=True)))
        torch.cuda.synchronize()
        check(err_h == 0 and err_v == 0,
              f"K1/K2 at {k} planes disagree with plain (K2 signed and "
              f"unsigned)")
        errs_t["h2v"].append(err_h)
        errs_t["v2h"].append(err_v)
        h2v_bare = (lambda: build.launch(
            "transpose", "h2v_launch", vals.data_ptr(), pk.data_ptr(),
            n_words, k))
        v2h_bare = (lambda: build.launch(
            "transpose", "v2h_launch", pk.data_ptr(), vk.data_ptr(),
            n_words, k, 0))
        for name, wrapper, bare in (
                ("h2v", lambda: h2v_cuda(vals, k), h2v_bare),
                ("v2h", lambda: v2h_cuda(pk), v2h_bare)):
            row = {"ms": time_ms(wrapper, 50),
                   "device_ms": time_ms(bare, 50),
                   "kernel_ms": kernel_ms(bare, 50, f"{name}_kernel"),
                   "launch_host_ms": host_ms(bare, 50),
                   "bound_ms": bound((4 + k / 8) * n_lanes, 0)[0]}
            kern[name]["per_width"][k] = row
            print(f"[2] {name} at {k} planes: kernel {row['kernel_ms']:.4f} "
                  f"ms (profiler), bare launch {row['device_ms']:.4f} ms "
                  f"(events; host {row['launch_host_ms']:.4f} ms a call), "
                  f"wrapper {row['ms']:.4f} ms, bound "
                  f"{row['bound_ms']:.4f} ms")
    for name, plain, arg in (("h2v", h2v_plain, vals),
                             ("v2h", v2h_plain, planes)):
        k = kern[name]
        k.update({key: k["per_width"][32][key] for key in (
            "ms", "device_ms", "kernel_ms", "launch_host_ms")})
        k["max_abs_err"] = err_h2v if name == "h2v" else err_v2h
        k["plain_ms"] = time_ms(lambda: plain(arg), 5)
        k["bound"] = bound(2 * 4 * n_lanes, 0)
        k["shape"] = f"{n_lanes} lanes x 32 planes"
        k["n_calls"] = 1
    print(f"[2] K1/K2 round trip on {n_lanes} lanes: bit-exact at "
          f"{TRANSPOSE_WIDTHS} planes, K2 signed and unsigned; at 32: h2v "
          f"{kern['h2v']['ms']:.4f} ms, v2h {kern['v2h']['ms']:.4f} ms")

    # -- 3. the fast path: bbop on backend="cuda" (main path) -------------
    inputs = {}
    for op, w in FAST_PATH:
        spec = get_op(op, w)
        r = np.random.default_rng(len(op) * 100 + w)
        inputs[(op, w)] = [r.integers(0, 1 << b, n_lanes).astype(np.int64)
                           for b in spec.operand_bits]
    build.reset_launches()
    fast = SimdramDevice(backend="cuda", device="cuda")
    for op, w in FAST_PATH:
        spec = get_op(op, w)
        got = fast.bbop(op, *inputs[(op, w)], n_bits=w)
        want = spec.oracle(*[v.astype(np.uint64) for v in inputs[(op, w)]])
        check(masked_equal(got, want, spec.out_bits),
              f"backend='cuda' {op}/{w} disagrees with the oracle")
    before = build.LAUNCHES["circuit"]
    bp = SimdramDevice(backend="bitplane", device="cuda")
    got = bp.bbop("addition", *inputs[("addition", 8)], n_bits=8)
    check(masked_equal(got, get_op("addition", 8).oracle(
        *[v.astype(np.uint64) for v in inputs[("addition", 8)]]), (8,)),
        "backend='bitplane' addition/8 disagrees with the oracle")
    torch.cuda.synchronize()
    counts_fast = dict(build.LAUNCHES)
    check(counts_fast["circuit"] > before,
          "backend='bitplane' did not launch the circuit kernel")
    print(f"[3] SimdramDevice(backend='cuda').bbop: {len(FAST_PATH)} ops x "
          f"{n_lanes} lanes match spec.oracle; backend='bitplane' launched "
          f"K3 {counts_fast['circuit'] - before}x; launches {counts_fast}")

    # K3 against the plain circuit on the card, and its times: the
    # wrapper, the bare launch (events) and the kernel alone (profiler)
    k3 = {"max_abs_err": 0, "ms": 0.0, "device_ms": 0.0, "kernel_ms": 0.0,
          "plain_ms": 0.0, "bytes": 0, "ops": 0, "n_calls": len(FAST_PATH)}
    per_op, errs_k3 = {}, []
    for op, w in FAST_PATH:
        spec, circ, ids = bitplane._compiled_op(op, w)
        vals_t = [torch.from_numpy(bitplane.host_i32(v)).to(dev)
                  for v in inputs[(op, w)]]
        ops_planes = [h2v(t, b) for t, b in zip(vals_t, spec.operand_bits)]
        out = circuit_on_planes(circ, ids, ops_planes)
        err = max_abs_err(out, circuit_plain(circ, ids, ops_planes))
        check(err == 0, f"K3 {op}/{w} disagrees with the plain circuit")
        errs_k3.append(err)
        # the fast path's transposes at this op's widths: K1 on each
        # operand, K2 (unsigned and signed) on each output
        errs_t["h2v"] += [max_abs_err(pl, h2v_plain(t, b)) for pl, t, b in
                          zip(ops_planes, vals_t, spec.operand_bits)]
        ends = np.cumsum(spec.out_bits)
        check(ends[-1] == out.shape[0], f"{op}/{w}: {out.shape[0]} output "
              f"planes for widths {spec.out_bits}")
        for lo, hi in zip(ends - spec.out_bits, ends):
            sl = out[lo:hi].contiguous()
            errs_t["v2h"] += [max_abs_err(v2h_cuda(sl, signed=sg),
                                          v2h_plain(sl, signed=sg))
                              for sg in (False, True)]
        check(max(errs_t["h2v"] + errs_t["v2h"]) == 0,
              f"K1/K2 at {op}/{w}'s widths disagree with plain")
        prog = slot_program(circ, ids)
        code = torch.from_numpy(prog.code).to(dev)
        words = out.shape[1]
        bare = (lambda: k3_launch(prog, code, ops_planes, out))
        row = {
            "ms": time_ms(lambda: circuit_on_planes(circ, ids, ops_planes),
                          20),
            "device_ms": time_ms(bare, 20),
            "kernel_ms": kernel_ms(bare, 20, "circuit_kernel"),
            "launch_host_ms": host_ms(bare, 20),
            "plain_ms": time_ms(lambda: circuit_plain(circ, ids, ops_planes),
                                2, warmup=1),
            "gates": prog.n_gates, "levels": prog.n_levels,
            "steps": prog.n_steps, "slots": prog.n_slots,
            "warps": prog.warps, "chunks": len(prog.chunks) - 1,
            "shared_bytes": prog.shared_bytes,
        }
        n_bytes = 4 * words * (prog.n_inputs + prog.n_outputs)
        n_ops = prog.n_logic * words
        row["bound_ms"], row["bound_by"] = bound(n_bytes, n_ops)
        per_op[f"{op}/{w}"] = row
        print(f"[3] K3 {op}/{w}: kernel {row['kernel_ms']:.4f} ms "
              f"(profiler), bare launch {row['device_ms']:.4f} ms (host "
              f"{row['launch_host_ms']:.4f} ms a call), bound "
              f"{row['bound_ms']:.4f} ms; {prog.n_gates} gates, "
              f"{prog.n_levels} levels, {prog.n_slots} slots, "
              f"{prog.warps} warps")
        for k in ("ms", "device_ms", "kernel_ms", "plain_ms"):
            k3[k] += row[k]
        k3["bytes"] += n_bytes
        k3["ops"] += n_ops
    k3["launch_host_ms"] = float(np.mean([r["launch_host_ms"]
                                          for r in per_op.values()]))
    k3_bound_ms = sum(r["bound_ms"] for r in per_op.values())
    k3["bound"] = (k3_bound_ms, bound(k3["bytes"], k3["ops"])[1])
    k3["shape"] = (f"sum over {len(FAST_PATH)} ops (16 at 8 bits, 3 at 16 "
                   f"bits) x {n_lanes} lanes")
    kern["circuit"] = k3
    record["k3_per_op"] = per_op
    # the fast path's transposes run at phase 2's lanes and widths
    for name, errs in errs_t.items():
        kern[name]["agreement"] = {}
        _agree(kern[name]["agreement"], "fast", counts_fast[name], errs)
    k3["agreement"] = {}
    _agree(k3["agreement"], "fast", counts_fast["circuit"], errs_k3)
    print(f"[3] K3 vs plain circuit on the card: bit-exact for "
          f"{len(FAST_PATH)} ops; kernel total {k3['kernel_ms']:.4f} ms "
          f"(profiler), wrapper {k3['ms']:.3f} ms, bound "
          f"{k3_bound_ms:.4f} ms")

    # -- 4. the slice: fused bank dispatch (main path) ---------------------
    lanes = DDR4.columns_per_subarray
    mix = mix_queue(bank_mod, get_op, lanes)
    build.reset_launches()
    bank_dev = SimdramDevice(backend="bank", device="cuda")
    t0 = time.perf_counter()
    chain, chain_raw = chain_queue(bank_mod, lanes, "cuda")
    res_mix = bank_dev.dispatch(mix)
    res_chain = bank_dev.dispatch(chain)
    chain_vals = [flatten_result(r) for r in res_chain]   # relu via K2
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts_bank = dict(build.LAUNCHES)
    for name, errs in _chain_transposes(dev, chain, chain_raw, res_chain,
                                        [v[0] for v in chain_vals]).items():
        _agree(kern[name]["agreement"], "bank", counts_bank[name], errs)
    for i, ins in enumerate(mix):
        spec = get_op(ins.op, ins.n_bits)
        check(masked_equal(res_mix[i], spec.oracle(*ins.operands),
                           spec.out_bits),
              f"mix instruction {i} ({ins.op}/{ins.n_bits}) is wrong")
    mul, add, relu = (get_op(op, w) for op, w in (
        ("multiplication", 8), ("addition", 16), ("relu", 16)))
    for c, (x, y, z) in enumerate(chain_raw):
        m = mul.oracle(x, y)[0]          # the full 16-bit product
        a = add.oracle(m, z)[0]
        r = relu.oracle(a)[0]
        check(all(masked_equal(chain_vals[3 * c + k][0], (e,), spec.out_bits)
                  for k, (e, spec) in enumerate(((m, mul), (a, add),
                                                 (r, relu)))),
              f"chain {c} is wrong")
    stats = bank_dev.bank().stats.as_dict()
    record["bank_stats"] = stats
    record["bank_wall_s"] = wall
    print(f"[4] bank dispatch: mix {len(mix)} x {lanes} lanes and chain "
          f"{len(chain)} instrs match the oracle in {wall:.3f} s host wall, "
          f"first dispatch, μProgram compile included (pack "
          f"{stats['pack_wall_s']:.3f} s); launches {counts_bank}")
    print(f"[4] BankStats {json.dumps(stats)}")

    # K5 on each of the mix queue's fused waves, against the plain replay
    bank = Bank(n_subarrays=DDR4.n_banks, device="cuda")
    q_lanes, stage, _ = plan_queue(mix)
    waves = bank._build_waves(mix, list(range(len(mix))), stage, q_lanes)
    k5 = {"max_abs_err": 0, "ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0,
          "bytes": 0, "ops": 0, "wave_device_ms": [], "wave_kernel_ms": [],
          "longest_unit_cmds": [], "ns_per_real_cmd": []}
    errs_k5 = []
    for wave in waves:
        states_np, ct, _ = bank._pack_wave(mix, wave, q_lanes, {})
        tables, schedule = ct
        states = torch.from_numpy(states_np.view(np.int32)).to(dev)
        out_k = replay(states, ct)
        out_p = replay_plain(states, tables)
        err = max_abs_err(out_k, out_p)
        check(err == 0, "K5 disagrees with the plain replay")
        errs_k5.append(err)
        n_units, n_rows, w_words = states.shape
        out = torch.empty_like(states)
        n_cmds = tables.shape[1]
        k5["ms"] += time_ms(lambda: replay(states, ct), 10)
        bare = (lambda: build.launch(
            "replay", "replay_launch", states.data_ptr(), out.data_ptr(),
            tables.data_ptr(), n_cmds * CMD_WIDTH, schedule.data_ptr(),
            n_units, n_rows, w_words, n_cmds))
        wave_ms = time_ms(bare, 10)
        k5["device_ms"] += wave_ms
        k5["wave_kernel_ms"].append(kernel_ms(bare, 10, "replay_kernel"))
        k5["launch_host_ms"] = host_ms(bare, 10)
        k5["plain_ms"] += time_ms(lambda: replay_plain(states, tables), 1,
                                  warmup=0)
        k5["ops"] += replay_ops_per_word(
            tables.cpu().numpy(), schedule[0].cpu().numpy()) * w_words
        k5["bytes"] += 2 * states.numel() * 4
        add_replay_wave(k5, wave_ms, tables, schedule)
    k5["kernel_ms"] = sum(k5["wave_kernel_ms"])
    k5["n_calls"] = len(waves)
    # the chain queue's waves forward planes between waves, so they are
    # taken from a repeat of its dispatch
    with _RecordedInterpreter(bank_mod, "hetero_batched_interpreter") as rec:
        [flatten_result(r) for r in SimdramDevice(
            backend="bank", device="cuda").dispatch(chain)]
    check(len(waves) + len(rec) == counts_bank["replay"],
          f"{len(waves)} mix and {len(rec)} chain waves for "
          f"{counts_bank['replay']} K5 launches")
    errs_k5 += [_round_k5(dev, st, ct, reps=1)[2] for st, ct in rec]
    k5["agreement"] = {}
    _agree(k5["agreement"], "bank", counts_bank["replay"], errs_k5)
    k5["bound"] = bound(k5["bytes"], k5["ops"])
    k5["shape"] = (f"sum over the mix queue's {len(waves)} fused waves, "
                   f"{DDR4.n_banks} units x {lanes} columns")
    kern["replay"] = k5
    print(f"[4] K5 vs plain replay on {len(waves)} mix waves: bit-exact; "
          f"kernel total {k5['ms']:.3f} ms, per wave (device) "
          f"{fmt_list(k5['wave_device_ms'])} ms, (profiler) "
          f"{fmt_list(k5['wave_kernel_ms'])} ms at longest real counts "
          f"{k5['longest_unit_cmds']} ({fmt_list(k5['ns_per_real_cmd'])} "
          f"ns per command); bound {k5['bound'][0]:.4f} ms")

    # the same dispatches again, warm (every μProgram compiled, every
    # wave's tables cached), then once more under the profiler: where a
    # repeated bank dispatch's wall goes, host vs device
    again = SimdramDevice(backend="bank", device="cuda")
    t0 = time.perf_counter()
    again.dispatch(mix)
    [flatten_result(r) for r in again.dispatch(chain)]
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    warm_pack = again.bank().stats.pack_wall_s
    record["bank_warm_wall_s"] = warm
    record["bank_warm_pack_wall_s"] = warm_pack
    print(f"[4] warm repeat of both dispatches: {warm:.3f} s host wall "
          f"(pack {warm_pack:.3f} s)")
    breakdown = {
        "mix": device_breakdown(lambda: again.dispatch(mix)),
        "chain": device_breakdown(lambda: [
            flatten_result(r) for r in again.dispatch(chain)]),
    }
    record["bank_breakdown"] = breakdown
    check(any("replay_kernel" in k for k in breakdown["mix"]["device_ms"]),
          "the profiler saw no replay kernel in the mix dispatch")
    for name, b in breakdown.items():
        print(f"[4] profiled {name} dispatch: wall {b['wall_ms']:.2f} ms, "
              f"device busy {b['device_busy_ms']:.3f} ms, idle share "
              f"{b['idle_share']:.4f}; device ms {json.dumps(b['device_ms'])}")

    kern["popmatmul"], counts_mm = matmul_phase(dev, record, probe_libs)
    kern["faulty_replay"], counts_fault = fault_phase(dev, record, mix_queue)
    counts_ladder = ladder_phase(dev, record, kern)
    counts_apps = apps_phase(dev, record, kern)

    # -- 9. the kernels line ------------------------------------------------
    for name in ("h2v", "v2h", "circuit", "replay"):
        n = counts_fast[name] + counts_bank[name]
        check(n > 0, f"kernel {name} was not launched on the main path")
    check(counts_fast["circuit"] > 0 and counts_bank["replay"] > 0
          and counts_bank["h2v"] > 0 and counts_bank["v2h"] > 0,
          "a kernel of its path was not launched")
    check(counts_mm["popmatmul"] > 0 and counts_fault["faulty_replay"] > 0,
          "K4 or K6 was not launched on its path")
    check(counts_bank["replay"] == 5,
          f"expected 5 K5 launches on the bank path, got "
          f"{counts_bank['replay']}")
    check(all(counts_apps[name] > 0
              for name in ("h2v", "v2h", "circuit", "replay")),
          f"a kernel of the apps path was not launched: {counts_apps}")
    launches = {name: counts_fast[name] + counts_bank[name]
                + counts_ladder[name] + counts_apps[name]
                for name in ("h2v", "v2h", "circuit", "replay")}
    launches["popmatmul"] = counts_mm["popmatmul"]
    launches["faulty_replay"] = (counts_fault["faulty_replay"]
                                 + counts_ladder["faulty_replay"])
    meta = {
        "h2v": ("src/repro_torch/csrc/transpose.cu",
                "src/repro/kernels/transpose_kernel.py:75"),
        "v2h": ("src/repro_torch/csrc/transpose.cu",
                "src/repro/kernels/transpose_kernel.py:105"),
        "circuit": ("src/repro_torch/csrc/circuit.cu",
                    "src/repro/kernels/bitplane_ops.py:57"),
        "replay": ("src/repro_torch/csrc/replay.cu",
                   "src/repro/core/control_unit.py:126"),
        "popmatmul": ("src/repro_torch/csrc/popmatmul.cu",
                      "src/repro/kernels/bitserial_matmul.py:75"),
        "faulty_replay": ("src/repro_torch/csrc/replay.cu",
                          "src/repro/core/control_unit.py:370"),
    }
    line = []
    for name, (source, replaces) in meta.items():
        k = kern[name]
        # every launch of the main path had a twin at its shape compared
        # with the plain version; max_abs_err covers those comparisons
        agreement = k["agreement"]
        on_path = sum(a["launches"] for a in agreement.values())
        check(on_path == launches[name], f"{name}: {on_path} launches in "
              f"its agreement, {launches[name]} on the main path")
        check(all(a["compared"] > 0 for a in agreement.values()),
              f"{name}: a path without a comparison: {agreement}")
        k["max_abs_err"] = max(a["max_abs_err"] for a in agreement.values())
        line.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": k["max_abs_err"], "agreement": agreement,
            "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound"][0],
            "bound_by": k["bound"][1], "library_ms": k.get("library_ms"),
            "device_ms": k["device_ms"], "kernel_ms": k["kernel_ms"],
            "launch_host_ms": k["launch_host_ms"],
            "rank_ms": launches[name] * (k["kernel_ms"] - k["bound"][0])
            / k["n_calls"],
            "shape": k["shape"],
            "tolerance": "bit-exact (max_abs_err 0 over int32 words)",
        })
        for key in ("wave_device_ms", "wave_kernel_ms", "longest_unit_cmds",
                    "ns_per_real_cmd", "per_width", "ladder"):
            if key in k:
                line[-1][key] = k[key]
    record["kernels"] = line
    order = sorted(line, key=lambda k: -k["rank_ms"])
    print("[9] launches x (kernel ms - bound ms) per call: " + ", ".join(
        f"{k['name']} {k['rank_ms']:.4f}" for k in order))
    record["launches_fast_path"] = counts_fast
    record["launches_bank"] = counts_bank
    record["launches_matmul"] = counts_mm
    record["launches_fault"] = counts_fault
    record["launches_ladder"] = counts_ladder
    record["launches_apps"] = counts_apps
    record["profiler_misses"] = PROFILER_MISSES
    print(f"[9] kernel times the profiler missed (timed by CUDA events): "
          f"{len(PROFILER_MISSES)}")
    return record


def matmul_phase(dev, record: dict, probe_libs: dict):
    """Phase 5: the bit-serial matmul path on K4.  Returns the kernel's
    entry and the launch counts of the path's run."""
    import torch

    import popmma_probe
    from repro_torch.kernels import build
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.bitserial_matmul import (binary_matmul,
                                                      bitserial_planes)
    from repro_torch.kernels.ref import (binary_matmul_ref,
                                         bitserial_planes_ref)

    gen = torch.Generator(device=dev).manual_seed(5)
    mats = {}
    for name, m, k, n in VGG16_SHAPES:
        mats[name] = (
            torch.randint(0, 4, (m, k), generator=gen, device=dev,
                          dtype=torch.int32),       # 2-bit unsigned
            torch.randint(-2, 2, (k, n), generator=gen, device=dev,
                          dtype=torch.int32))       # 2-bit signed
    rng = np.random.default_rng(5)
    q1_np = (rng.integers(0, 2, (512, 256)).astype(np.int32),
             rng.integers(0, 2, (256, 128)).astype(np.int32))
    q4_np = (rng.integers(0, 16, (512, 1024)).astype(np.int32),
             rng.integers(-8, 8, (1024, 128)).astype(np.int32))
    q1 = [torch.from_numpy(x).to(dev) for x in q1_np]
    q4 = [torch.from_numpy(x).to(dev) for x in q4_np]
    torch.cuda.synchronize()

    build.reset_launches()
    t0 = time.perf_counter()
    prods = {name: kops.bitserial_matmul(a, w, 2, 2)
             for name, (a, w) in mats.items()}
    q1_out = kops.quantized_matmul(*q1, 1, 1)       # bit-serial branch
    q4_out = kops.quantized_matmul(*q4, 4, 4)       # 16-bit limb branch
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(build.LAUNCHES)
    # one fused K4 launch per product, all plane pairs inside it
    check(counts["popmatmul"] == len(VGG16_SHAPES) + 1,
          f"expected {len(VGG16_SHAPES) + 1} K4 launches, got "
          f"{counts['popmatmul']}")

    # exact integer oracles: a float64 product on the card is exact here
    # (|sums| <= K * 3 * 2 < 2**53), and 64 rows of each on the host in
    # int64
    for name, (a, w) in mats.items():
        got = prods[name]
        exact = (a.double() @ w.double()).to(torch.int64)
        check(torch.equal(got.to(torch.int64), exact),
              f"bitserial_matmul at {name} disagrees with the exact product")
        host = a[:64].cpu().numpy().astype(np.int64) @ \
            w.cpu().numpy().astype(np.int64)
        check(np.array_equal(got[:64].cpu().numpy(), host),
              f"bitserial_matmul at {name} disagrees with numpy")
    check(np.array_equal(q1_out.cpu().numpy(),
                         q1_np[0].astype(np.int64) @ q1_np[1]),
          "quantized_matmul 1x1 disagrees with numpy")
    check(np.array_equal(q4_out.cpu().numpy(),
                         q4_np[0].astype(np.int64) @ q4_np[1]),
          "quantized_matmul 4x4 disagrees with numpy")
    check(torch.equal(kops.bitserial_matmul(*q4, 4, 4), q4_out),
          "the bit-serial and limb routes disagree at 4x4 bits")
    # the 1 x 1-bit product's K4 launch against the plain version, which
    # the same entry point runs on CPU tensors
    errs_k4 = [max_abs_err(q1_out, kops.quantized_matmul(
        *[x.cpu() for x in q1], 1, 1).to(dev))]
    check(errs_k4[0] == 0, "quantized_matmul 1x1 disagrees with its plain "
          "version")
    print(f"[5] bitserial_matmul 2x2 bits at VGG-16 "
          f"{', '.join(n for n, *_ in VGG16_SHAPES)}: exact; "
          f"quantized_matmul 1x1 (K4) and 4x4 (16-bit limbs) exact; "
          f"{wall:.3f} s host wall; launches {counts}")

    # the units K4 could run on: binary MACs a second, fed from registers
    # (experiments/popmma_probe.py); the bound takes the fastest exact one
    rates = popmma_probe.peak_rates(probe_libs, time_ms)
    record["k4_unit_rates"] = rates
    units = {u: (r["macs_per_s"], f"{r['label']}, measured")
             for u, r in rates.items() if "macs_per_s" in r}
    units["int8_data_sheet"] = (INT8_MACS_PER_S,
                                "int8 tensor cores, data sheet")
    best = max(units, key=lambda u: units[u][0])
    unit_rate, unit_label = units[best]
    record["k4_bound_unit"] = {"unit": best, "label": unit_label,
                               "macs_per_s": unit_rate}
    print("[5] K4's candidate units, binary MACs/s (measured, fed from "
          "registers): " + ", ".join(
              f"{u} {r['macs_per_s'] / 1e12:.1f} T" if "macs_per_s" in r
              else f"{u} refused by nvcc ({r['refused'].splitlines()[-1]})"
              for u, r in rates.items())
          + f"; int8 data sheet {INT8_MACS_PER_S / 1e12:.1f} T; the bound "
          f"takes {best} ({unit_label})")

    # K4 at each shape: the path's fused 2 x 2-bit product (the launch the
    # path makes) against its plain version and torch._int_mm on the
    # 2-bit values, and one binary product (plane 0 of each operand)
    # against torch._int_mm on the bits; bounds: A and W read once, out
    # written once, and the binary MACs over the fastest unit
    per_shape = {}
    entry = None
    iw = torch.arange(2, dtype=torch.int32, device=dev)
    for name, (a, w) in mats.items():
        m, n = a.shape[0], w.shape[1]
        a_pl = kops._pack_bits_matrix((a >> iw[:, None, None]) & 1, 2)
        w_pl = kops._pack_bits_matrix(((w & 3) >> iw[:, None, None]) & 1, 1)
        kw = a_pl.shape[2]
        fused = bitserial_planes(a_pl, w_pl, False, True)
        a8, w8 = a.to(torch.int8), w.to(torch.int8)
        check(torch.equal(fused, torch._int_mm(a8, w8)),
              f"K4 (fused) and torch._int_mm disagree at {name}")
        fused_out = torch.empty_like(fused)
        fused_bare = (lambda: build.launch(
            "popmatmul", "popmatmul_launch", a_pl.data_ptr(),
            w_pl.data_ptr(), fused_out.data_ptr(), m, n, kw, 2, 2, 0, 1))
        row = {
            "shape": f"{name}: M={m}, K={32 * kw}, N={n}, 2 x 2 bits "
                     f"(4 plane pairs, one launch)",
            "ms": time_ms(lambda: bitserial_planes(a_pl, w_pl, False, True),
                          20),
            "device_ms": time_ms(fused_bare, 20),
            "kernel_ms": kernel_ms(fused_bare, 20, "popmatmul_kernel"),
            "launch_host_ms": host_ms(fused_bare, 20),
            "library_ms": time_ms(lambda: torch._int_mm(a8, w8), 20),
            "n_calls": 1,
            "bound": bound(4 * (2 * m * kw + 2 * kw * n + m * n),
                           4 * m * n * 32 * kw, unit_rate),
        }
        # one binary product
        ap, wp = a_pl[0], w_pl[0]
        out = binary_matmul(ap, wp)
        a1, w1 = (a & 1).to(torch.int8), (w & 1).to(torch.int8)
        check(torch.equal(torch._int_mm(a1, w1), out),
              f"K4 and torch._int_mm disagree at {name}")
        one_bare = (lambda: build.launch(
            "popmatmul", "popmatmul_launch", ap.data_ptr(), wp.data_ptr(),
            out.data_ptr(), m, n, kw, 1, 1, 0, 0))
        row["binary"] = {
            "kernel_ms": kernel_ms(one_bare, 20, "popmatmul_kernel"),
            "device_ms": time_ms(one_bare, 20),
            "library_ms": time_ms(lambda: torch._int_mm(a1, w1), 20),
            "bound": bound(4 * (m * kw + kw * n + m * n), m * n * 32 * kw,
                           unit_rate),
        }
        err = max(max_abs_err(fused, bitserial_planes_ref(a_pl, w_pl,
                                                           False, True)),
                  max_abs_err(out, binary_matmul_ref(ap, wp)))
        check(err == 0, f"K4 disagrees with its plain versions at {name}")
        errs_k4.append(err)
        row["max_abs_err"] = err
        if name == "conv3_2":
            row["plain_ms"] = time_ms(
                lambda: bitserial_planes_ref(a_pl, w_pl, False, True), 1,
                warmup=0)
            entry = row
        per_shape[name] = row
        one = row["binary"]
        print(f"[5] K4 at {row['shape']}: kernel {row['kernel_ms']:.4f} ms "
              f"(profiler; bare launch {row['device_ms']:.4f}, wrapper "
              f"{row['ms']:.4f} by events), torch._int_mm "
              f"{row['library_ms']:.4f} ms, bound {row['bound'][0]:.4f} ms "
              f"({row['bound'][1]}); one binary product: kernel "
              f"{one['kernel_ms']:.4f} ms, torch._int_mm "
              f"{one['library_ms']:.4f} ms, bound {one['bound'][0]:.4f} ms "
              f"({one['bound'][1]})")
    record["k4_per_shape"] = per_shape
    record["matmul_wall_s"] = wall
    # the path's launches are the three fused products and the 1 x 1-bit
    # product, each compared above
    entry["agreement"] = {}
    _agree(entry["agreement"], "matmul", counts["popmatmul"], errs_k4)
    entry["max_abs_err"] = max(errs_k4)
    b = device_breakdown(lambda: [kops.bitserial_matmul(a, w, 2, 2)
                                  for a, w in mats.values()])
    record["matmul_breakdown"] = b
    print(f"[5] profiled repeat of the three products: wall "
          f"{b['wall_ms']:.2f} ms, device busy {b['device_busy_ms']:.3f} ms, "
          f"idle share {b['idle_share']:.4f}; device ms "
          f"{json.dumps(b['device_ms'])}")
    return entry, counts


def fault_phase(dev, record: dict, mix_queue):
    """Phase 6: the fault-injected bank dispatch on K6.  Returns the
    kernel's entry and the launch counts of the path's run."""
    import torch

    from repro_torch.core import bank as bank_mod
    from repro_torch.core.bank import Bank, flatten_result, plan_queue
    from repro_torch.core.control_unit import (faulty_bank_replay,
                                               faulty_replay_plain,
                                               flip_threshold)
    from repro_torch.core.fault import (FaultExhaustedError, FaultModel,
                                        FaultRuntime, replicate_queue)
    from repro_torch.core.isa import SimdramDevice
    from repro_torch.core.ops_library import get_op
    from repro_torch.core.timing import DDR4
    from repro_torch.kernels import build

    n_units = DDR4.n_banks * DDR4.subarrays_per_bank
    fmix = mix_queue(bank_mod, get_op, FAULT_LANES)
    # the paper's sigma; at 32,768 lanes x 32 instructions the default 3
    # retries leave lanes undecided (ROADMAP Queue 3), so 10 are allowed
    model = FaultModel(sigma=0.15, spare_lanes=1, seed=0, max_retries=10)
    p_flip = model.flip_probability()      # the reliability Monte-Carlo

    build.reset_launches()
    t0 = time.perf_counter()
    with _RecordedInterpreter(bank_mod, "faulty_batched_interpreter") as rec:
        fdev = SimdramDevice(backend="bank", device=dev, fault=model)
        res = fdev.dispatch(fmix)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(build.LAUNCHES)
    check(len(rec) == counts["faulty_replay"],
          f"{len(rec)} faulty runs for {counts['faulty_replay']} K6 launches")
    # K6 against its plain version on every attempt of this run
    errs_k6 = [_k6_attempt(dev, args, timed=False)[0] for args in rec]
    fs = fdev.bank().stats.faults
    check(counts["faulty_replay"] > 0, "the fault path did not launch K6")

    clean = SimdramDevice(backend="bank", device=dev).dispatch(fmix)
    wrong = {}
    for i, ins in enumerate(fmix):
        spec = get_op(ins.op, ins.n_bits)
        check(masked_equal(clean[i], spec.oracle(*ins.operands),
                           spec.out_bits),
              f"fault-free instruction {i} is wrong")
        for g, e in zip(flatten_result(res[i]), flatten_result(clean[i])):
            g, e = (np.asarray(x).astype(np.int64) for x in (g, e))
            bad = g != e
            if bad.any():   # the lane count and the first XOR patterns
                wrong[f"{i} {ins.op}/{ins.n_bits}"] = [
                    int(bad.sum()), (g[bad] ^ e[bad])[:4].tolist()]
    n_wrong = sum(n for n, _ in wrong.values())
    check(n_wrong <= WRONG_LANE_SHARE * len(fmix) * FAULT_LANES,
          f"{n_wrong} lanes differ from the fault-free dispatch: {wrong}")
    seed0 = {"wrong_lanes": n_wrong,
             "faulty_replay_launches": counts["faulty_replay"]}
    record["sigma_seed0"] = seed0
    check(seed0 == SIGMA_SEED0, f"the sigma = 0.15 run at fault seed 0 "
          f"gave {seed0}, not {SIGMA_SEED0} as before the redesign")
    check(fs.injected > 0 and fs.detected > 0 and fs.corrected > 0,
          f"faults were not injected, detected and corrected: {fs}")
    record["fault_stats"] = fs.as_dict()
    record["fault_wall_s"] = wall
    record["fault_wrong_lanes"] = wrong
    print(f"[6] fault-injected bank dispatch, sigma=0.15 (p_flip "
          f"{p_flip:g}), 1 spare lane, {len(fmix)} x {FAULT_LANES} lanes, "
          f"{wall:.3f} s host wall: {n_wrong} lanes differ from the "
          f"fault-free dispatch (replicas corrupted alike) {wrong}; "
          f"launches {counts}")
    print(f"[6] FaultStats {json.dumps(fs.as_dict())}")

    # dead units: the first seed that draws one; p_flip = 0, so the only
    # damage is the garbage, which blacklisting must route around
    seed = next(s for s in range(1000) if FaultRuntime(
        FaultModel(dead_unit_rate=0.1, seed=s), (), n_units).dead.any())
    dmodel = FaultModel(p_flip=0.0, dead_unit_rate=0.1, spare_lanes=1,
                        seed=seed)
    ddev = SimdramDevice(backend="bank", device=dev, fault=dmodel)
    res_d = ddev.dispatch(fmix)
    dfs = ddev.bank().stats.faults
    check(all(np.array_equal(g, e) for r, c in zip(res_d, clean)
              for g, e in zip(flatten_result(r), flatten_result(c))),
          "the dead-unit dispatch differs from the fault-free one")
    check(dfs.detected > 0 and dfs.redispatches > 0 and dfs.remapped > 0,
          f"dead units were not detected and remapped: {dfs}")
    record["dead_unit_stats"] = dfs.as_dict()
    print(f"[6] dead units (seed {seed}, units "
          f"{np.nonzero(ddev.bank()._fault_rt.dead)[0].tolist()}): exact "
          f"after blacklisting; FaultStats {json.dumps(dfs.as_dict())}")

    # stuck columns with flips: a lane with a stuck replica needs both
    # others clean in one attempt, which 1e-3 flips on 16-bit
    # multiplication rarely allow, so every unit is blacklisted and the
    # dispatch raises FaultExhaustedError (cause no_capacity), as the
    # reference does at every fault seed experiments/fault_share.py ran.
    # A dispatch that returns must be exact.
    smix = mix_queue(bank_mod, get_op, STUCK_LANES)
    smodel = FaultModel(p_flip=1e-3, stuck_lane_rate=0.02, spare_lanes=2,
                        seed=0)
    sdev = SimdramDevice(backend="bank", device=dev, fault=smodel)
    try:
        res_s = sdev.dispatch(smix)
        check(all(masked_equal(res_s[i], get_op(ins.op, ins.n_bits).oracle(
            *ins.operands), get_op(ins.op, ins.n_bits).out_bits)
            for i, ins in enumerate(smix)), "the stuck run returned wrong "
            "lanes")
        outcome = {"outcome": "returned", "wrong_lanes": 0}
    except FaultExhaustedError as e:
        outcome = {"outcome": "exhausted", **e.context()}
        check(e.cause == "no_capacity" and len(e.blacklist) == n_units,
              f"the stuck run exhausted otherwise than the reference: "
              f"{outcome}")
    sfs = sdev.bank().stats.faults
    check(sfs.detected > 0 and sfs.redispatches > 0 and sfs.remapped > 0,
          f"stuck columns were not detected and remapped: {sfs}")
    record["stuck_run"] = {**outcome, "stats": sfs.as_dict()}
    print(f"[6] stuck columns 0.02 + p_flip 1e-3, 2 spare lanes, "
          f"{len(smix)} x {STUCK_LANES} lanes: {json.dumps(outcome)}; "
          f"FaultStats {json.dumps(sfs.as_dict())}")

    # K6 against its plain version on every wave of the main path's
    # replicated queue, with its p_flip, seed-0 keys, the stuck run's
    # masks and the dead-unit run's dead units: all three failure modes
    bank = Bank(n_subarrays=n_units, device=dev)
    rep = replicate_queue(fmix, model.replicas)
    q_lanes, stage, _ = plan_queue(rep)
    waves = bank._build_waves(rep, list(range(len(rep))), stage, q_lanes)
    rt = FaultRuntime(model, (), n_units)
    s0_all, s1_all = FaultRuntime(smodel, (), n_units).stuck_masks(2048)
    dead = torch.from_numpy(ddev.bank()._fault_rt.dead.copy()).to(dev)
    thr = flip_threshold(p_flip)
    k6 = {"max_abs_err": 0, "ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0,
          "bytes": 0, "ops": 0, "wave_device_ms": [], "wave_kernel_ms": [],
          "longest_unit_cmds": [], "ns_per_real_cmd": []}
    flips = 0
    for wave in waves:
        states_np, ct, _ = bank._pack_wave(rep, wave, q_lanes, {})
        tables, schedule = ct
        states = torch.from_numpy(states_np.view(np.int32)).to(dev)
        n_rows, w_words = states.shape[1:]
        keys = torch.from_numpy(rt.draw_keys().view(np.int32)).to(dev)
        s0 = torch.from_numpy(s0_all[:, :w_words].view(np.int32)).to(dev)
        s1 = torch.from_numpy(s1_all[:, :w_words].view(np.int32)).to(dev)
        args = (states, tables, keys, s0, s1, dead, p_flip)
        out_k, n_k = faulty_bank_replay(states, ct, *args[2:])
        t_plain = time.perf_counter()
        out_p, n_p = faulty_replay_plain(*args)
        torch.cuda.synchronize()
        k6["plain_ms"] += (time.perf_counter() - t_plain) * 1e3
        err = max(max_abs_err(out_k, out_p), max_abs_err(n_k, n_p))
        check(err == 0, "K6 disagrees with its plain version")
        errs_k6.append(err)
        flips += int(n_k.sum())
        out = torch.empty_like(states)
        cnt = torch.zeros(n_units, dtype=torch.int64, device=dev)
        n_cmds = tables.shape[1]
        k6["ms"] += time_ms(
            lambda: faulty_bank_replay(states, ct, *args[2:]), 10)
        bare = (lambda: build.launch(
            "replay", "faulty_replay_launch", states.data_ptr(),
            out.data_ptr(), tables.data_ptr(), n_cmds * 13,
            schedule.data_ptr(), keys.data_ptr(), s0.data_ptr(),
            s1.data_ptr(), dead.data_ptr(), cnt.data_ptr(), thr, n_units,
            n_rows, w_words, n_cmds))
        wave_ms = time_ms(bare, 10)
        k6["device_ms"] += wave_ms
        k6["wave_kernel_ms"].append(
            kernel_ms(bare, 10, "faulty_replay_kernel"))
        k6["launch_host_ms"] = host_ms(bare, 10)
        k6["ops"] += replay_ops_per_word(
            tables.cpu().numpy(), schedule[0].cpu().numpy(), thr) * w_words
        k6["bytes"] += (2 * states.numel() * 4 + keys.numel() * 4
                        + 2 * s0.numel() * 4 + n_units + n_units * 8)
        add_replay_wave(k6, wave_ms, tables, schedule)
    check(flips > 0, "the K6 comparison drew no flips")
    k6["agreement"] = {}
    _agree(k6["agreement"], "faulty bank", counts["faulty_replay"], errs_k6)
    k6["kernel_ms"] = sum(k6["wave_kernel_ms"])
    k6["n_calls"] = len(waves)
    k6["bound"] = bound(k6["bytes"], k6["ops"])
    k6["shape"] = (f"sum over the replicated mix queue's {len(waves)} waves, "
                   f"{n_units} units x {32 * w_words} columns, p_flip "
                   f"{p_flip:g}, stuck masks, {int(dead.sum())} dead "
                   f"unit(s)")
    print(f"[6] K6 vs plain on {len(waves)} waves ({flips} flips): "
          f"bit-exact, states and flip counts; kernel total "
          f"{k6['ms']:.3f} ms, per wave (device) "
          f"{fmt_list(k6['wave_device_ms'])} ms, (profiler) "
          f"{fmt_list(k6['wave_kernel_ms'])} ms at longest real counts "
          f"{k6['longest_unit_cmds']} ({fmt_list(k6['ns_per_real_cmd'])} "
          f"ns per command); plain {k6['plain_ms']:.0f} ms, bound "
          f"{k6['bound'][0]:.4f} ms ({k6['bound'][1]})")

    # a disabled model costs nothing: no K6 launch, the fault-free replay
    before = dict(build.LAUNCHES)
    off = SimdramDevice(backend="bank", device=dev,
                        fault=FaultModel(enabled=False))
    res_off = off.dispatch(fmix)
    torch.cuda.synchronize()
    check(build.LAUNCHES["faulty_replay"] == before["faulty_replay"]
          and build.LAUNCHES["replay"] > before["replay"],
          "a disabled fault model launched K6 or skipped K5")
    check(all(np.array_equal(g, e) for r, c in zip(res_off, clean)
              for g, e in zip(flatten_result(r), flatten_result(c))),
          "the disabled-model dispatch differs from the fault-free one")
    print("[6] FaultModel(enabled=False): no K6 launch, results equal")

    # where a fault-injected dispatch's wall goes: the same run again (a
    # new device draws the same faults) under the profiler
    b = device_breakdown(lambda: SimdramDevice(
        backend="bank", device=dev, fault=model).dispatch(fmix))
    record["fault_breakdown"] = b
    check(any("faulty_replay_kernel" in k for k in b["device_ms"]),
          "the profiler saw no faulty_replay kernel in the fault dispatch")
    print(f"[6] profiled fault dispatch: wall {b['wall_ms']:.2f} ms, device "
          f"busy {b['device_busy_ms']:.3f} ms, idle share "
          f"{b['idle_share']:.4f}; device ms {json.dumps(b['device_ms'])}")
    return k6, counts


def _recording(executor, calls: list):
    """``executor`` with a ``run`` that keeps the arguments of every call
    in ``calls``."""
    run = executor.run

    def rec(*args):
        calls.append(args)
        return run(*args)

    return dataclasses.replace(executor, run=rec)


class _RecordedInterpreter:
    """Within ``with``: the bank's replay interpreter factory ``name`` in
    ``bank_mod`` (``hetero_batched_interpreter`` or
    ``faulty_batched_interpreter``) makes callables that keep the
    arguments of every call in ``calls``."""

    def __init__(self, bank_mod, name: str):
        self.mod, self.name, self.calls = bank_mod, name, []

    def __enter__(self):
        make = self.made = getattr(self.mod, self.name)

        def recording(device):
            run = make(device)

            def rec(*args):
                self.calls.append(args)
                return run(*args)
            return rec

        setattr(self.mod, self.name, recording)
        return self.calls

    def __exit__(self, *exc):
        setattr(self.mod, self.name, self.made)


def _flat(results):
    from repro_torch.core.bank import flatten_result
    return [np.asarray(x) for r in results for x in flatten_result(r)]


def _agree(agreement: dict, path: str, launches: int, errs: list) -> None:
    """Record a path's agreement with the plain version: its launches on
    the path, the calls held against the plain version at the path's
    shapes and their largest error."""
    agreement[path] = {"launches": int(launches), "compared": len(errs),
                       "max_abs_err": max(errs, default=0)}


def _chain_transposes(dev, chain, chain_raw, results, values) -> dict:
    """K1 on the chain queue's entry operand and K2 on each of its
    vertical results, against their plain versions on the same inputs:
    ``{"h2v": [max_abs_err], "v2h": [max_abs_err per result]}``."""
    import torch

    from repro_torch.core.bank import VerticalOperand
    from repro_torch.core.bitplane import host_i32
    from repro_torch.kernels.transpose_kernel import h2v_plain, v2h_plain
    entry = chain[1].operands[1]
    check(isinstance(entry, VerticalOperand) and len(values) == len(results),
          "the chain queue lost its vertical entry operand")
    z = torch.from_numpy(host_i32(chain_raw[0][2])).to(dev)
    planes = torch.from_numpy(entry.planes.view(np.int32)).to(dev)
    errs = {"h2v": [max_abs_err(planes, h2v_plain(z, planes.shape[0]))],
            "v2h": []}
    for r, v in zip(results, values):
        if isinstance(r, VerticalOperand):
            pl = torch.from_numpy(np.ascontiguousarray(
                r.planes, dtype=np.uint32).view(np.int32)).to(dev)
            errs["v2h"].append(max_abs_err(
                torch.from_numpy(np.asarray(v)).to(dev),
                v2h_plain(pl)[:r.lanes]))
    check(errs["v2h"] and max(errs["h2v"] + errs["v2h"]) == 0,
          f"K1/K2 on the chain queue disagree with plain: {errs}")
    return errs


def _k5_round_ms(states, tables, schedule, reps: int = 5,
                 profiler: bool = True):
    """K5's kernel-only ms (profiler; with ``profiler=False`` the device
    ms of back-to-back bare launches, CUDA events) on one round's
    (n_units, n_rows, n_words) int32 states and its tables (one a unit,
    or one shared) with their schedule, and its bound: (ms, (bound ms,
    by))."""
    import torch

    from repro_torch.core.control_unit import CMD_WIDTH
    from repro_torch.kernels import build
    n_units, n_rows, n_words = states.shape
    n_cmds = tables.shape[-2]
    stride = 0 if tables.dim() == 2 else n_cmds * CMD_WIDTH
    out = torch.empty_like(states)
    bare = (lambda: build.launch(
        "replay", "replay_launch", states.data_ptr(), out.data_ptr(),
        tables.data_ptr(), stride, schedule.data_ptr(), n_units, n_rows,
        n_words, n_cmds))
    ms = (kernel_ms(bare, reps, "replay_kernel") if profiler
          else time_ms(bare, reps))
    counts = schedule[0].cpu().numpy()
    per_unit = tables if tables.dim() == 3 else tables.expand(
        n_units, *tables.shape)
    n_bytes = 2 * states.numel() * 4 + int(counts.sum()) * CMD_WIDTH * 4
    n_ops = replay_ops_per_word(per_unit.cpu().numpy(), counts) * n_words
    return ms, bound(n_bytes, n_ops)


def _round_k5(dev, states_np, ct, reps: int = 5):
    """One captured stacked round (or bank wave) through K5, held against
    the plain replay on the same inputs: (kernel ms by the profiler,
    (bound ms, by), max_abs_err, plain s, the states tensor)."""
    import torch

    from repro_torch.core.control_unit import replay, replay_plain
    tables, schedule = ct
    n_rows, n_words = states_np.shape[-2:]
    states = torch.from_numpy(np.ascontiguousarray(
        states_np.reshape(-1, n_rows, n_words)).view(np.int32)).to(dev)
    ms, bnd = _k5_round_ms(states, tables, schedule, reps)
    out_k = replay(states, ct)
    t_plain = time.perf_counter()
    out_p = replay_plain(states, tables)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t_plain
    err = max_abs_err(out_k, out_p)
    check(err == 0, f"K5 disagrees with the plain replay on a "
          f"{tuple(states.shape)} round")
    return ms, bnd, err, plain_s, states


def _k6_attempt(dev, args, reps: int = 5, timed: bool = True):
    """One captured attempt of a faulty round (or bank wave) through a
    bare K6 launch over its inputs flattened to one unit axis, held
    against the plain version on the same inputs, states and flip counts:
    (max_abs_err, plain s, kernel ms by the profiler, (bound ms, by)),
    the last two ``None`` unless ``timed``."""
    import torch

    from repro_torch.core.control_unit import (CMD_WIDTH, faulty_replay_plain,
                                               flip_threshold)
    from repro_torch.kernels import build
    states, ct, keys, s0, s1, dead, p_flip = args
    tables, schedule = ct
    n_rows, n_words = states.shape[-2:]
    st = states.reshape(-1, n_rows, n_words).contiguous()
    n_units, n_cmds = st.shape[0], tables.shape[1]
    k = keys.reshape(n_units, 2).contiguous()
    m0 = s0.reshape(n_units, n_words).contiguous()
    m1 = s1.reshape(n_units, n_words).contiguous()
    dd = dead.reshape(n_units).to(torch.bool).contiguous()
    out = torch.empty_like(st)
    cnt = torch.zeros(n_units, dtype=torch.int64, device=dev)
    thr = flip_threshold(p_flip)
    bare = (lambda: build.launch(
        "replay", "faulty_replay_launch", st.data_ptr(), out.data_ptr(),
        tables.data_ptr(), n_cmds * CMD_WIDTH, schedule.data_ptr(),
        k.data_ptr(), m0.data_ptr(), m1.data_ptr(), dd.data_ptr(),
        cnt.data_ptr(), thr, n_units, n_rows, n_words, n_cmds))
    bare()
    t_plain = time.perf_counter()
    out_p, cnt_p = faulty_replay_plain(st, tables, k, m0, m1, dd, p_flip)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t_plain
    err = max(max_abs_err(out, out_p), max_abs_err(cnt, cnt_p))
    check(err == 0, f"K6 disagrees with its plain version on a "
          f"{tuple(st.shape)} attempt")
    del out_p, cnt_p
    if not timed:
        return err, plain_s, None, None
    counts = schedule[0].cpu().numpy()
    n_bytes = (2 * st.numel() * 4 + k.numel() * 4 + 2 * m0.numel() * 4
               + n_units + n_units * 8 + int(counts.sum()) * CMD_WIDTH * 4)
    n_ops = replay_ops_per_word(tables.cpu().numpy(), counts, thr) * n_words
    return (err, plain_s, kernel_ms(bare, reps, "faulty_replay_kernel"),
            bound(n_bytes, n_ops))


def ladder_phase(dev, record: dict, kern: dict) -> dict:
    """Phase 7: the chip, channel and rank tiers at full width, and the
    fault wrappers of the chip and channel.  Adds the ladder's rounds to
    K5's and K6's entries and returns the launch counts of the tiers'
    counted runs, summed."""
    import torch

    from repro_torch.core import bank as bank_mod
    from repro_torch.core.channel import sequential_channel_dispatch
    from repro_torch.core.chip import sequential_dispatch
    from repro_torch.core.control_unit import TABLE_CACHE
    from repro_torch.core.fault import FaultModel, FaultRuntime
    from repro_torch.core.isa import SimdramDevice
    from repro_torch.core.ops_library import get_op
    from repro_torch.core.rank import sequential_rank_dispatch
    from repro_torch.core.timing import DDR4
    from repro_torch.kernels import build

    lanes = DDR4.columns_per_subarray
    per_unit = DDR4.n_banks * DDR4.subarrays_per_bank
    total = {k: 0 for k in build.LAUNCHES}
    k5_ladder, k6_ladder, rows = {}, {}, {}
    agreement = {name: kern[name].setdefault("agreement", {})
                 for name in ("h2v", "v2h", "replay", "faulty_replay")}
    for tier, n_chips, n_channels in LADDER:
        cfg = dataclasses.replace(DDR4, n_chips=n_chips,
                                  n_channels=n_channels)
        units = n_channels * n_chips * per_unit
        mix = mix_queue(bank_mod, get_op, lanes, n_instrs=2 * units)
        rng = np.random.default_rng(7)
        x, y = (rng.integers(0, 256, units * lanes) for _ in range(2))

        # the counted run: the mix queue, the chain queue, one bbop over
        # every lane of the tier
        build.reset_launches()
        cache0 = TABLE_CACHE.stats()
        t0 = time.perf_counter()
        tdev = SimdramDevice(cfg=cfg, backend=tier, device=dev)
        chain, chain_raw = chain_queue(bank_mod, lanes, dev)
        res_mix = tdev.dispatch(mix)
        raw_chain = tdev.dispatch(chain)
        res_chain = _flat(raw_chain)                      # relu via K2
        got = tdev.bbop("addition", x, y, n_bits=8)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        counts = dict(build.LAUNCHES)
        cache1 = TABLE_CACHE.stats()
        eng = getattr(tdev, tier)()
        st = eng.stats
        n_rounds = st.rounds if tier == "chip" else st.super_rounds
        check(counts["replay"] == n_rounds,
              f"{tier}: {counts['replay']} K5 launches for {n_rounds} "
              f"stacked rounds")
        check(counts["h2v"] > 0 and counts["v2h"] > 0
              and counts["faulty_replay"] == 0 and counts["circuit"] == 0,
              f"{tier}: unexpected launches {counts}")
        for k, v in counts.items():
            total[k] += v
        for name, errs in _chain_transposes(dev, chain, chain_raw, raw_chain,
                                            res_chain).items():
            _agree(agreement[name], tier, counts[name], errs)
        del raw_chain

        for i, ins in enumerate(mix):
            spec = get_op(ins.op, ins.n_bits)
            check(masked_equal(res_mix[i], spec.oracle(*ins.operands),
                               spec.out_bits),
                  f"{tier}: mix instruction {i} ({ins.op}/{ins.n_bits}) "
                  f"is wrong")
        mul, add, relu = (get_op(op, w) for op, w in (
            ("multiplication", 8), ("addition", 16), ("relu", 16)))
        for c, (cx, cy, cz) in enumerate(chain_raw):
            m = mul.oracle(cx, cy)[0]
            a = add.oracle(m, cz)[0]
            want = (m, a, relu.oracle(a)[0])
            check(all(masked_equal(res_chain[3 * c + j], (want[j],),
                                   (16,)) for j in range(3)),
                  f"{tier}: chain {c} is wrong")
        check(masked_equal(got, get_op("addition", 8).oracle(
            x.astype(np.uint64), y.astype(np.uint64)), (8,)),
            f"{tier}: the bbop over {units * lanes} lanes is wrong")
        geo = dict(n_banks=cfg.n_banks, n_subarrays=cfg.subarrays_per_bank,
                   cfg=cfg, device=dev)
        if tier == "chip":
            seq = lambda q: sequential_dispatch(q, **geo)[0]  # noqa: E731
        elif tier == "channel":
            seq = lambda q: sequential_channel_dispatch(  # noqa: E731
                q, n_chips=n_chips, **geo)[0]
        else:
            seq = lambda q: sequential_rank_dispatch(  # noqa: E731
                q, n_channels=n_channels, n_chips=n_chips, **geo)[0]
        for name, q, res in (("mix", mix, _flat(res_mix)),
                             ("chain", chain, res_chain)):
            check(all(np.array_equal(g, e) for g, e in zip(res, _flat(
                seq(q)))), f"{tier}: the {name} queue differs from the "
                f"sequential baseline")
        stats = st.as_dict()

        # warm: the same dispatches on the same engine (lane loads reset,
        # so the same placement), each round's inputs kept; the bbop's
        # round is kept too, after the timed repeat, so every round of the
        # counted run has its twin; then the mix dispatch once more under
        # the profiler
        eng.reset_stats()
        rounds: list = []
        executor = eng.executor
        eng.executor = _recording(executor, rounds)
        cache_w = TABLE_CACHE.stats()
        t0 = time.perf_counter()
        tdev.dispatch(mix)
        _flat(tdev.dispatch(chain))
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        warm_pack = eng.stats.pack_wall_s
        cache2 = TABLE_CACHE.stats()
        tdev.bbop("addition", x, y, n_bits=8)
        eng.executor = executor
        check(len(rounds) == n_rounds, f"{tier}: the repeat ran "
              f"{len(rounds)} rounds, the counted run {n_rounds}")
        eng.reset_stats()
        prof = device_breakdown(lambda: tdev.dispatch(mix))
        check(any("replay_kernel" in k for k in prof["device_ms"]),
              f"{tier}: the profiler saw no replay kernel")
        h2d_ms = sum(v for k, v in prof["device_ms"].items() if "HtoD" in k)

        # K5 on every round of the repeat, against the plain replay on the
        # same stack, and beside its bound
        per_round = []
        for states_np, ct in rounds:
            ms, bnd, err, plain_s, states = _round_k5(dev, states_np, ct)
            per_round.append({"kernel_ms": ms, "bound_ms": bnd[0],
                              "bound_by": bnd[1], "max_abs_err": err,
                              "plain_s": plain_s,
                              "units": int(states.shape[0]),
                              "rows": int(states.shape[1]),
                              "words": int(states.shape[2]),
                              "cmds": int(ct.tables.shape[1]),
                              "table_bytes": int(ct.tables.numel()) * 4})
            print(f"[7] {tier} round {len(per_round) - 1}: "
                  f"{json.dumps(per_round[-1])}", flush=True)
            del states
        _agree(agreement["replay"], tier, counts["replay"],
               [r["max_abs_err"] for r in per_round])
        print(f"[7] {tier}: K5 equals the plain replay bit for bit on all "
              f"{len(per_round)} rounds (plain " + ", ".join(
                  f"{r['plain_s']:.2f}" for r in per_round) + " s)")
        row = {
            "units": units, "lanes": units * lanes,
            "instructions": {"mix": len(mix), "chain": len(chain), "bbop": 1},
            "launches": counts, "rounds": n_rounds,
            "first_wall_s": first_s, "first_pack_wall_s": stats["pack_wall_s"],
            "warm_wall_s": warm_s, "warm_pack_wall_s": warm_pack,
            "table_cache": {
                "first": {k: cache1[k] - cache0[k]
                          for k in ("hits", "misses", "evictions")},
                "warm": {k: cache2[k] - cache_w[k]
                         for k in ("hits", "misses", "evictions")},
                "bytes": cache2["bytes"], "entries": cache2["entries"]},
            "profiled_mix": {k: prof[k] for k in (
                "wall_ms", "device_busy_ms", "idle_share", "device_ms")},
            "h2d_ms": h2d_ms,
            "warm_rounds": per_round,
            "modeled": {k: stats[k] for k in stats if k in (
                "latency_s", "total_latency_s", "transfer_bytes",
                "transfer_s", "transfer_h2d_s", "transfer_d2h_s",
                "transfer_overlapped_s", "exposed_transfer_s",
                "crossover_chips", "transfer_bound", "elements")},
        }
        rows[tier] = row
        k5_ladder[tier] = {
            "launches": counts["replay"], "rounds": n_rounds,
            "round_kernel_ms": [r["kernel_ms"] for r in per_round],
            "round_bound_ms": [r["bound_ms"] for r in per_round],
            "round_plain_s": [r["plain_s"] for r in per_round]}
        print(f"[7] {tier} ({units} units, {units * lanes} lanes): mix "
              f"{len(mix)} + chain {len(chain)} instrs + one bbop match the "
              f"oracle and the sequential baseline; {n_rounds} rounds, "
              f"launches {counts}; first {first_s:.3f} s (pack "
              f"{stats['pack_wall_s']:.3f} s), warm {warm_s:.3f} s (pack "
              f"{warm_pack:.3f} s)")
        print(f"[7] {tier} table cache: first {row['table_cache']['first']}, "
              f"warm {row['table_cache']['warm']}, {cache2['bytes']} bytes in "
              f"{cache2['entries']} entries")
        print(f"[7] {tier} profiled mix dispatch: wall {prof['wall_ms']:.2f} "
              f"ms, card busy {prof['device_busy_ms']:.3f} ms, idle share "
              f"{prof['idle_share']:.4f}, host-to-device copies "
              f"{h2d_ms:.3f} ms; device ms {json.dumps(prof['device_ms'])}")
        print(f"[7] {tier} K5 per round (profiler): " + ", ".join(
            f"{r['kernel_ms']:.4f} ms ({r['units']} x {r['rows']} x "
            f"{r['words']}, {r['cmds']} cmds, tables "
            f"{r['table_bytes'] / 2**20:.1f} MiB; bound {r['bound_ms']:.4f} "
            f"{r['bound_by']})" for r in per_round))
        print(f"[7] {tier} modeled {json.dumps(row['modeled'])}")
        del rounds, res_mix, res_chain, got, tdev, eng

    # the fault wrappers: the chip and a 2-chip channel
    for tier, n_chips in LADDER_FAULT:
        cfg = dataclasses.replace(DDR4, n_chips=n_chips)
        units = n_chips * per_unit
        fmix = mix_queue(bank_mod, get_op, FAULT_LANES, n_instrs=2 * units)
        clean = _flat(SimdramDevice(cfg=cfg, backend=tier,
                                    device=dev).dispatch(fmix))
        want = [o for ins in fmix for o in get_op(ins.op, ins.n_bits).oracle(
            *ins.operands)]
        widths = [w for ins in fmix for w in get_op(ins.op, ins.n_bits).out_bits]
        check(all(masked_equal(g, (e,), (w,))
                  for g, e, w in zip(clean, want, widths)),
              f"{tier}: the fault-free dispatch is wrong")

        def faulty(model, queue):
            build.reset_launches()
            calls: list = []
            fdev = SimdramDevice(cfg=cfg, backend=tier, device=dev,
                                 fault=model)
            eng = getattr(fdev, tier)()
            eng._faulty_executor = _recording(eng._faulty_executor, calls)
            t0 = time.perf_counter()
            res = _flat(fdev.dispatch(queue))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = dict(build.LAUNCHES)
            check(counts["faulty_replay"] == len(calls) > 0
                  and counts["replay"] == 0,
                  f"{tier}: {counts['faulty_replay']} K6 launches for "
                  f"{len(calls)} faulty runs (launches {counts})")
            for k, v in counts.items():
                total[k] += v
            return res, eng, calls, wall, counts

        def k6_agrees(attempts) -> list:
            """K6 against its plain version on each of ``attempts``: the
            (max_abs_err, plain s) of each."""
            return [_k6_attempt(dev, args, timed=False)[:2]
                    for args in attempts]

        model = FaultModel(sigma=0.15, spare_lanes=1, seed=0, max_retries=10)
        res, eng, calls, wall, counts = faulty(model, fmix)
        fs = eng.stats.faults
        n_wrong = sum(int((g.astype(np.int64) != e.astype(np.int64)).sum())
                      for g, e in zip(res, clean))
        check(n_wrong <= WRONG_LANE_SHARE * len(fmix) * FAULT_LANES,
              f"{tier}: {n_wrong} lanes differ from the fault-free dispatch")
        check(fs.injected > 0 and fs.detected > 0 and fs.corrected > 0,
              f"{tier}: faults were not injected, detected and corrected")
        # K6 on every attempt, against its plain version; the first also
        # timed beside its bound
        err0, plain0, k6_ms, k6_bound = _k6_attempt(dev, calls[0])
        k6_checked = [(err0, plain0)] + k6_agrees(calls[1:])
        prof = device_breakdown(lambda: SimdramDevice(
            cfg=cfg, backend=tier, device=dev, fault=model).dispatch(fmix))
        sigma = {"wall_s": wall, "wrong_lanes": n_wrong,
                 "k6_compared": len(k6_checked),
                 "k6_plain_s": [t for _, t in k6_checked],
                 "k6_launches": counts["faulty_replay"],
                 "k6_attempt_kernel_ms": k6_ms, "k6_bound_ms": k6_bound[0],
                 "k6_bound_by": k6_bound[1], "stats": fs.as_dict(),
                 "profiled": {k: prof[k] for k in (
                     "wall_ms", "device_busy_ms", "idle_share",
                     "device_ms")}}
        print(f"[7] faulty {tier} ({units} units), sigma 0.15, 1 spare lane, "
              f"{len(fmix)} x {FAULT_LANES} lanes: {n_wrong} lanes differ "
              f"from the fault-free dispatch, {wall:.3f} s host wall, "
              f"{counts['faulty_replay']} K6 launches (one per attempt); K6 "
              f"first attempt {k6_ms:.4f} ms (profiler), bound "
              f"{k6_bound[0]:.4f} ms ({k6_bound[1]}); FaultStats "
              f"{json.dumps(fs.as_dict())}")
        print(f"[7] faulty {tier} profiled: wall {prof['wall_ms']:.2f} ms, "
              f"card busy {prof['device_busy_ms']:.3f} ms, idle share "
              f"{prof['idle_share']:.4f}; device ms "
              f"{json.dumps(prof['device_ms'])}")

        # dead units: the first fault seed that draws one in some bank
        paths = ([(b,) for b in range(cfg.n_banks)] if tier == "chip" else
                 [(c, b) for c in range(n_chips) for b in range(cfg.n_banks)])
        seed = next(s for s in range(1000) if any(
            FaultRuntime(FaultModel(dead_unit_rate=0.1, seed=s), path,
                         cfg.subarrays_per_bank).dead.any() for path in paths))
        res_d, eng_d, calls_d, _, counts_d = faulty(FaultModel(
            p_flip=0.0, dead_unit_rate=0.1, spare_lanes=1, seed=seed), fmix)
        dfs = eng_d.stats.faults
        k6_checked_d = k6_agrees(calls_d)
        check(all(np.array_equal(g, e) for g, e in zip(res_d, clean)),
              f"{tier}: the dead-unit dispatch differs from the fault-free one")
        check(dfs.redispatches > 0 and dfs.remapped > 0,
              f"{tier}: dead units were not remapped: {dfs}")

        # sparse stuck columns, no flips: the vote outvotes each stuck
        # replica, so the run is exact
        smix = mix_queue(bank_mod, get_op, STUCK_LANES, n_instrs=2 * units)
        res_s, eng_s, calls_s, _, counts_s = faulty(FaultModel(
            p_flip=0.0, stuck_lane_rate=LADDER_STUCK_RATE, spare_lanes=2,
            seed=0), smix)
        sfs = eng_s.stats.faults
        k6_checked_s = k6_agrees(calls_s)
        swant = [o for ins in smix for o in get_op(ins.op, ins.n_bits).oracle(
            *ins.operands)]
        swidths = [w for ins in smix
                   for w in get_op(ins.op, ins.n_bits).out_bits]
        check(all(masked_equal(g, (e,), (w,))
                  for g, e, w in zip(res_s, swant, swidths)),
              f"{tier}: the stuck-only dispatch is not exact: {sfs}")
        check(sfs.detected > 0 and sfs.corrected > 0,
              f"{tier}: stuck columns were not detected and corrected: {sfs}")
        rows[f"faulty_{tier}"] = {
            "units": units, "sigma": sigma,
            "dead": {"seed": seed, "k6_launches": counts_d["faulty_replay"],
                     "k6_compared": len(k6_checked_d),
                     "k6_plain_s": [t for _, t in k6_checked_d],
                     "stats": dfs.as_dict()},
            "stuck": {"rate": LADDER_STUCK_RATE,
                      "k6_launches": counts_s["faulty_replay"],
                      "k6_compared": len(k6_checked_s),
                      "k6_plain_s": [t for _, t in k6_checked_s],
                      "stats": sfs.as_dict()}}
        checked = k6_checked + k6_checked_d + k6_checked_s
        k6_ladder[tier] = {
            "launches": (counts["faulty_replay"] + counts_d["faulty_replay"]
                         + counts_s["faulty_replay"]),
            "attempt_kernel_ms": k6_ms, "attempt_bound_ms": k6_bound[0],
            "attempt_plain_s": [t for _, t in checked]}
        _agree(agreement["faulty_replay"], f"faulty {tier}",
               k6_ladder[tier]["launches"], [e for e, _ in checked])
        print(f"[7] faulty {tier}: dead units (seed {seed}) exact after "
              f"blacklisting, {counts_d['faulty_replay']} K6 launches, "
              f"FaultStats {json.dumps(dfs.as_dict())}; stuck columns "
              f"{LADDER_STUCK_RATE:g}, 2 spare lanes, {len(smix)} x "
              f"{STUCK_LANES} lanes: exact, {counts_s['faulty_replay']} K6 "
              f"launches, FaultStats {json.dumps(sfs.as_dict())}")
        print(f"[7] faulty {tier}: K6 equals its plain version, states and "
              f"flip counts, on every attempt of the three runs "
              f"({len(k6_checked)}, {len(k6_checked_d)} and "
              f"{len(k6_checked_s)}; plain "
              f"{sum(t for _, t in checked):.1f} s)")

    kern["replay"]["ladder"] = k5_ladder
    kern["faulty_replay"]["ladder"] = k6_ladder
    record["ladder"] = rows
    return total


def app_runs(mode: str):
    """benchmarks/paper_tables.py:_app_runs, rebuilt on the port: the
    seven apps as device-taking callables at the "smoke" or "full"
    sizes.  The reference's full nn_layers call (32 x 32, 8 channels)
    raises its own range error at the default 16-bit width (its dense
    layer reaches -57,282, PERF.md); it runs here at 17 bits, the
    narrowest width that holds it."""
    from repro_torch.apps import (bitweaving, brightness, knn, lenet,
                                  nn_layers, tpch, vgg)
    if mode == "smoke":
        return [
            ("knn", lambda d: knn.run(n_points=256, n_features=4, n_bits=6,
                                      device=d)),
            ("tpch", lambda d: tpch.run(n_rows=512, device=d)),
            ("bitweaving", lambda d: bitweaving.run(n_rows=512, n_bits=8,
                                                    device=d)),
            ("brightness", lambda d: brightness.run(h=8, w=8, device=d)),
            ("nn_layers", lambda d: nn_layers.run(device=d)),
            ("lenet", lambda d: lenet.run(device=d, conv_channels=(2, 3),
                                          fc_dims=(12, 10))),
            ("vgg13", lambda d: vgg.run("vgg13", img_hw=8, n_layers=3,
                                        device=d)),
        ]
    return [
        ("knn", lambda d: knn.run(n_points=4096, n_features=16, device=d)),
        ("tpch", lambda d: tpch.run(n_rows=65536, device=d)),
        ("bitweaving", lambda d: bitweaving.run(n_rows=65536, device=d)),
        ("brightness", lambda d: brightness.run(h=128, w=128, device=d)),
        ("nn_layers", lambda d: nn_layers.run(img_hw=32, out_ch=8, n_bits=17,
                                              device=d)),
        ("lenet", lambda d: lenet.run(device=d)),
        ("vgg13", lambda d: vgg.run("vgg13", img_hw=32, device=d)),
    ]


def tpch_oracle(n_rows: int) -> int:
    """TPC-H Q6's revenue over the lineitem columns that
    src/repro_torch/apps/tpch.py draws at its default seed, in numpy."""
    rng = np.random.default_rng(0)
    shipdate = rng.integers(0, 2556, size=n_rows).astype(np.int64)
    quantity = rng.integers(1, 51, size=n_rows).astype(np.int64)
    discount = rng.integers(0, 11, size=n_rows).astype(np.int64)
    price = rng.integers(100, 10000, size=n_rows).astype(np.int64)
    sel = ((shipdate >= 365) & (shipdate < 730) & (discount >= 4)
           & (discount <= 6) & (quantity < 24))
    return int((price * discount)[sel].sum())


class _Twins:
    """Within ``with``: each launch of K1, K2, K3 and K5 made through the
    port's wrappers is followed by the kernel's plain version on the same
    inputs.  ``errs[kernel]`` gets the largest absolute difference of each
    launch; with ``keep_rounds`` every K5 launch's (states, tables,
    schedule) is kept in ``rounds`` as well."""

    def __init__(self, keep_rounds: bool = False):
        self.errs = {"h2v": [], "v2h": [], "circuit": [], "replay": []}
        self.rounds = []
        self.keep_rounds = keep_rounds
        self._undo = []

    def __enter__(self):
        from repro_torch.core import control_unit as cu
        from repro_torch.kernels import bitplane_ops, build
        from repro_torch.kernels import transpose_kernel as tk

        def twin(name, orig, plain):
            def wrapped(*args, **kw):
                before = build.LAUNCHES[name]
                out = orig(*args, **kw)
                if build.LAUNCHES[name] > before:
                    self.errs[name].append(max_abs_err(out, plain(*args,
                                                                  **kw)))
                    if name == "replay" and self.keep_rounds:
                        self.rounds.append(args)
                return out
            return wrapped

        for name, orig, plain in (
                ("h2v", tk.h2v_cuda, tk.h2v_plain),
                ("v2h", tk.v2h_cuda, tk.v2h_plain),
                ("circuit", bitplane_ops._circuit_kernel,
                 bitplane_ops.circuit_plain),
                ("replay", cu._replay_kernel,
                 lambda states, tables, schedule: cu.replay_plain(
                     states, tables))):
            wrapped = twin(name, orig, plain)
            for mod_name, mod in list(sys.modules.items()):
                if not mod_name.startswith("repro_torch") or mod is None:
                    continue
                for attr, val in list(vars(mod).items()):
                    if val is orig:
                        setattr(mod, attr, wrapped)
                        self._undo.append((mod, attr, orig))
        return self

    def __exit__(self, *exc):
        for mod, attr, orig in reversed(self._undo):
            setattr(mod, attr, orig)
        self._undo.clear()


def _app_once(fn, backend: str, cfg, device: str):
    """One run of an app on a fresh ``SimdramDevice``: (result, device,
    host wall s)."""
    import torch

    from repro_torch.core.isa import SimdramDevice
    d = SimdramDevice(backend=backend, cfg=cfg, device=device)
    t0 = time.perf_counter()
    r = fn(d)
    if device == "cuda":
        torch.cuda.synchronize()
    return r, d, time.perf_counter() - t0


def _same_output(a: dict, b: dict) -> bool:
    return np.array_equal(np.asarray(a["output"]).astype(np.int64),
                          np.asarray(b["output"]).astype(np.int64))


def _same_result(a: dict, b: dict) -> bool:
    """Two result dicts ``==``: the outputs as int64 arrays, every other
    key (the device's totals among them) as plain values."""
    return _same_output(a, b) and (
        {k: v for k, v in a.items() if k != "output"}
        == {k: v for k, v in b.items() if k != "output"})


def _modeled(d):
    """The engine's stats without the measured wall clocks (None for the
    sequential rungs)."""
    from repro_torch.apps.runtime import engine_stats
    es = engine_stats(d)
    return None if es is None else {k: v for k, v in es.items()
                                    if k not in MEASURED_STATS}


def _bench_mismatches(tier: dict, d) -> tuple:
    """A rung of BENCH_apps.json against a live run's device ``d``: the
    fields that differ beyond BENCH_REL_TOL (an integer or a flag must be
    equal), how many float fields differ at all, and how many fields were
    compared."""
    from repro_torch.apps.runtime import engine_stats
    t = d.totals()
    pairs = [("device_latency_s", tier["modeled"]["device_latency_s"],
              t["latency_s"]),
             ("device_energy_mj", tier["modeled"]["device_energy_mj"],
              t["energy_mj"])]
    want, got = tier["modeled"]["engine"], engine_stats(d)
    if (want is None) != (got is None):
        return [("engine", want, got)], 0, 1
    for k, v in (want or {}).items():
        if k not in MEASURED_STATS:
            pairs.append((k, v, got.get(k)))
    bad, n_float_diff = [], 0
    for k, w, g in pairs:
        if isinstance(w, float) and isinstance(g, float):
            n_float_diff += w != g
            if abs(w - g) > BENCH_REL_TOL * max(abs(w), abs(g)):
                bad.append((k, w, g))
        elif type(w) is not type(g) or w != g:
            bad.append((k, w, g))
    return bad, n_float_diff, len(pairs)


def _app_path(fn, backend: str, cfg, total: dict, errs: dict,
              warm: bool = True, keep_rounds: bool = False):
    """One app on one rung of the card: the counted run (launch counters
    0 just before, read just after), then its twin (a repeat in which
    every launch is held against its plain version and must agree bit
    for bit; one twin per launch of the counted run) and, with ``warm``,
    a timed warm repeat.  Adds the counts to ``total`` and the twins'
    errors to ``errs``; returns (row, result, device, twins)."""
    from repro_torch.core.control_unit import TABLE_CACHE
    from repro_torch.kernels import build

    build.reset_launches()
    c0 = TABLE_CACHE.stats()
    r, d, first_s = _app_once(fn, backend, cfg, "cuda")
    counts = dict(build.LAUNCHES)
    c1 = TABLE_CACHE.stats()
    check(r["verified"] is True, f"{backend}: the app did not verify")
    stats = d.totals()
    eng = _modeled(d)
    pack_s = (None if eng is None else
              getattr(d, backend)().stats.pack_wall_s)
    if backend == "bitplane":
        want = {"circuit"}
    elif backend == "cuda":
        want = {"h2v", "v2h", "circuit"}
    else:
        want = {"replay"}
        rounds = eng.get("rounds", eng.get("super_rounds", eng["batches"]))
        check(counts["replay"] == rounds, f"{backend}: {counts['replay']} K5 "
              f"launches for {rounds} rounds")
    check(all(counts[k] > 0 for k in want)
          and all(v == 0 for k, v in counts.items() if k not in want),
          f"{backend}: launches {counts}, expected only {sorted(want)}")
    for k, v in counts.items():
        total[k] += v

    with _Twins(keep_rounds) as tw:
        r_t, _, _ = _app_once(fn, backend, cfg, "cuda")
    for k, e in tw.errs.items():
        check(len(e) == counts[k], f"{backend}: {len(e)} {k} launches in "
              f"the twin run, {counts[k]} in the counted run")
        check(max(e, default=0) == 0, f"{backend}: {k} disagrees with its "
              f"plain version: {max(e, default=0)}")
        errs[k] += e
    check(_same_result(r_t, r), f"{backend}: the twin run's result differs")

    row = {"first_wall_s": first_s, "first_pack_wall_s": pack_s,
           "launches": {k: counts[k] for k in ("h2v", "v2h", "circuit",
                                               "replay")},
           "rounds": counts["replay"] if backend in FUSED_RUNGS else None,
           "table_cache_first": {k: c1[k] - c0[k]
                                 for k in ("hits", "misses", "evictions")},
           "latency_s": stats["latency_s"], "energy_mj": stats["energy_mj"]}
    if warm:
        cw = TABLE_CACHE.stats()
        before = dict(build.LAUNCHES)
        r_w, d_w, warm_s = _app_once(fn, backend, cfg, "cuda")
        c2 = TABLE_CACHE.stats()
        check(all(build.LAUNCHES[k] - before[k] == counts[k]
                  for k in counts) and _same_result(r_w, r),
              f"{backend}: the warm run differs from the counted run")
        row.update({
            "warm_wall_s": warm_s,
            "warm_pack_wall_s": (None if eng is None else getattr(
                d_w, backend)().stats.pack_wall_s),
            "table_cache_warm": {k: c2[k] - cw[k]
                                 for k in ("hits", "misses", "evictions")},
            "table_cache_bytes": c2["bytes"],
            "table_cache_entries": c2["entries"]})
    return row, r, d, tw


def _fmt_app_row(name: str, backend: str, row: dict) -> str:
    pack = ("" if row["first_pack_wall_s"] is None else
            f" (pack {row['first_pack_wall_s']:.3f} s)")
    warm = ""
    if "warm_wall_s" in row:
        wp = ("" if row["warm_pack_wall_s"] is None else
              f" (pack {row['warm_pack_wall_s']:.3f} s)")
        warm = (f", warm {row['warm_wall_s']:.3f} s{wp}, cache warm "
                f"{row['table_cache_warm']}")
    rounds = "" if row["rounds"] is None else f", {row['rounds']} rounds"
    return (f"{name}/{backend}: first {row['first_wall_s']:.3f} s{pack}"
            f"{warm}; launches K1 {row['launches']['h2v']}, K2 "
            f"{row['launches']['v2h']}, K3 {row['launches']['circuit']}, "
            f"K5 {row['launches']['replay']}{rounds}; cache first "
            f"{row['table_cache_first']}; modeled latency "
            f"{row['latency_s']!r} s, energy {row['energy_mj']!r} mJ")


def apps_phase(dev, record: dict, kern: dict) -> dict:
    """Phase 8: the seven apps on the card's five rungs.  8a at the
    reference's recorded sizes against the CPU and BENCH_apps.json, 8b at
    the full sizes, 8c TPC-H Q6 at scale factor 1.  Every launch has its
    twin through the plain version (the ``apps`` path of each kernel's
    agreement); returns the launch counts of the counted runs, summed."""
    import torch

    from repro_torch.apps.runtime import n_parallel_units, shard_slices
    from repro_torch.core.control_unit import TABLE_CACHE
    from repro_torch.core.isa import SimdramDevice
    from repro_torch.core.timing import DramConfig
    from repro_torch.kernels import build

    total = {k: 0 for k in build.LAUNCHES}
    errs = {"h2v": [], "v2h": [], "circuit": [], "replay": []}
    out = record["apps"] = {"smoke": {}, "full": {}, "sf1": {}}

    # -- 8a: the reference's recorded sizes -------------------------------
    bench = json.loads((ROOT / "BENCH_apps.json").read_text())
    check(bench["config"]["mode"] == "smoke" and all(
        bench["config"][k] == v for k, v in APPS_SMOKE_CFG.items()),
        f"BENCH_apps.json records another configuration: {bench['config']}")
    cfg = DramConfig(**APPS_SMOKE_CFG)
    t0 = time.perf_counter()
    n_float_diff = n_fields = 0
    for name, fn in app_runs("smoke"):
        results = {}
        for be in APP_RUNGS:
            row, r, d, _ = _app_path(fn, be, cfg, total, errs, warm=False)
            results[be] = r
            if be == "cuda":
                check(_same_output(r, results["bitplane"]),
                      f"8a {name}: the cuda rung's output differs from the "
                      f"bitplane rung's")
                continue
            r_c, d_c, _ = _app_once(fn, be, cfg, "cpu")
            check(_same_result(r, r_c) and d.totals() == d_c.totals()
                  and _modeled(d) == _modeled(d_c),
                  f"8a {name}/{be}: the card's run differs from the CPU's")
            tier = bench["apps"][name]["tiers"][be]
            check(tier["verified"] is True, f"8a {name}/{be}: not verified "
                  f"in BENCH_apps.json")
            bad, n_diff, n = _bench_mismatches(tier, d)
            check(not bad, f"8a {name}/{be} differs from BENCH_apps.json: "
                  f"{bad}")
            n_float_diff += n_diff
            n_fields += n
            out["smoke"][f"{name}/{be}"] = row
    print(f"[8a] 7 apps x {len(APP_RUNGS)} rungs at the smoke sizes on "
          f"{APPS_SMOKE_CFG}: card == CPU (outputs, result dicts, totals, "
          f"modeled engine stats); == BENCH_apps.json on every integer "
          f"field, floats within {BENCH_REL_TOL:g} relative "
          f"({n_float_diff} of {n_fields} fields differ in the last bits); "
          f"cuda == bitplane; {time.perf_counter() - t0:.1f} s")

    # -- 8b: the reference's full sizes -----------------------------------
    cfg = DramConfig(**APPS_FULL_CFG)
    t0 = time.perf_counter()
    for name, fn in app_runs("full"):
        results = {}
        for be in APP_RUNGS:
            row, r, d, _ = _app_path(fn, be, cfg, total, errs)
            results[be] = r
            out["full"][f"{name}/{be}"] = row
            print(f"[8b] {_fmt_app_row(name, be, row)}", flush=True)
        check(all(_same_output(r, results["bitplane"])
                  for r in results.values()),
              f"8b {name}: the outputs differ across the rungs")
    print(f"[8b] 7 apps at the full sizes on {APPS_FULL_CFG}: verified and "
          f"bit-equal on all {len(APP_RUNGS)} rungs; "
          f"{time.perf_counter() - t0:.1f} s")

    # -- 8c: TPC-H Q6 at scale factor 1 -----------------------------------
    from repro_torch.apps import tpch
    want = tpch_oracle(TPCH_SF1_ROWS)
    fn = lambda d: tpch.run(n_rows=TPCH_SF1_ROWS, device=d)  # noqa: E731
    shards = shard_slices(TPCH_SF1_ROWS, n_parallel_units(
        SimdramDevice(backend="channel", cfg=cfg, device=dev)))
    t0 = time.perf_counter()
    for be in APP_RUNGS:
        fused = be in FUSED_RUNGS
        row, r, d, tw = _app_path(fn, be, cfg, total, errs,
                                  keep_rounds=fused)
        check(r["revenue"] == want, f"8c {be}: revenue {r['revenue']} != "
              f"{want}")
        row["revenue"] = r["revenue"]
        if fused:
            prof = device_breakdown(lambda: _app_once(fn, be, cfg, "cuda"))
            row["profiled"] = {k: prof[k] for k in (
                "wall_ms", "device_busy_ms", "idle_share", "device_ms")}
            row["h2d_ms"] = sum(v for k, v in prof["device_ms"].items()
                                if "HtoD" in k)
            row["k5_device_ms"] = sum(v for k, v in prof["device_ms"].items()
                                      if "replay_kernel" in k)
            check(row["k5_device_ms"] > 0, f"8c {be}: the profiler saw no "
                  f"replay kernel: {prof['device_ms']}")
            per_round = []
            for states, tables, schedule in tw.rounds:
                ms, (b_ms, b_by) = _k5_round_ms(states, tables, schedule, 10,
                                                profiler=False)
                per_round.append({"device_ms": ms, "bound_ms": b_ms,
                                  "bound_by": b_by,
                                  "shape": list(states.shape),
                                  "cmds": int(tables.shape[-2])})
            row["k5_rounds"] = per_round
        del tw
        out["sf1"][be] = row
        print(f"[8c] {_fmt_app_row('tpch_sf1', be, row)}; revenue "
              f"{r['revenue']} == numpy", flush=True)
        if fused:
            print(f"[8c] tpch_sf1/{be} profiled: wall "
                  f"{row['profiled']['wall_ms']:.1f} ms, card busy "
                  f"{row['profiled']['device_busy_ms']:.3f} ms, idle share "
                  f"{row['profiled']['idle_share']:.4f}, host-to-device "
                  f"copies {row['h2d_ms']:.3f} ms, K5 "
                  f"{row['k5_device_ms']:.3f} ms; device ms "
                  f"{json.dumps(row['profiled']['device_ms'])}")
            print(f"[8c] tpch_sf1/{be} K5 per round (CUDA events over 10 "
                  f"bare launches): " + ", ".join(
                f"{x['device_ms']:.4f} ms ({'x'.join(map(str, x['shape']))}"
                f", {x['cmds']} cmds; bound {x['bound_ms']:.4f} "
                f"{x['bound_by']})" for x in row["k5_rounds"]))
        del r, d
        torch.cuda.empty_cache()
    cache = TABLE_CACHE.stats()
    print(f"[8c] TPC-H Q6 over {TPCH_SF1_ROWS} rows ({len(shards)} channel "
          f"shards of up to {shards[0].stop} rows): revenue {want} on all "
          f"{len(APP_RUNGS)} rungs; table cache {cache}; "
          f"{time.perf_counter() - t0:.1f} s")

    for name, e in errs.items():
        agreement = kern[name].setdefault("agreement", {})
        _agree(agreement, "apps", total[name], e)
    print(f"[8] apps path: launches {total}; every launch's twin agrees "
          f"with the plain version bit for bit ({sum(map(len, errs.values()))}"
          f" compared)")
    return total


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--json", help="also write the full record here")
    args = p.parse_args()
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir() or not (
            EXPERIMENTS / "popmma_probe.py").is_file() or not (
            ROOT / "BENCH_apps.json").is_file():
        print(f"chip_smoke: no port package under {SRC}, no "
              f"{EXPERIMENTS / 'popmma_probe.py'} or no "
              f"{ROOT / 'BENCH_apps.json'}", file=sys.stderr)
        return 2
    sys.path[:0] = [str(SRC), str(EXPERIMENTS)]
    card = nvidia_smi("name,power.limit")
    print(f"[0] {card}")
    print(f"[0] python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, SM clock now/max "
          f"{nvidia_smi('clocks.sm,clocks.max.sm')}")
    try:
        record = run()
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(record, indent=1))
    print(json.dumps({"kernels": record["kernels"]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
