"""Where K5's and K6's time goes on one fused wave, on a CUDA card.

    PYTHONPATH=src python experiments/replay_probe.py [--json OUT.json]

Packs wave 1 of the two queues ``chip_smoke.py`` drives (the mix queue
at 65,536 lanes for K5; the mix queue at 32,768 lanes, two replicas, at
sigma = 0.15 for K6), then times the bare kernel launch (CUDA events,
20 calls after warm-up) on the same states and tables under schedules
that isolate one cause at a time:

  real             the wave's own schedule;
  longest only     every unit but the longest ones stops at command 0;
  one longest      one of the longest units runs, the rest stop at 0;
  one block        that unit's first 32 word columns only (one block:
                   one replay warp and its producers alone on the card);
  no random bits   K6 with p = 0 (one producer warp, no Philox);
  state only       every unit stops at command 0 (load and store).

Each line gives the time, and the cycles per real command of the
longest unit at the card's 1.98 GHz boost clock.  Units that stop at 0
still load and store their state, so "real" minus the rest is the
replay itself.  States and masks are left as they are: these outputs
are not checked here (``chip_smoke.py`` and the card tests hold both
kernels against their plain versions).

Then two more things:

  instr. floor     the replay warp's loop, read from the kernels' SASS
                   (``cuobjdump -sass``): each innermost loop that
                   loads ring entries (64- or 128-bit shared loads) and
                   stores rows (three 32-bit shared stores a command),
                   its instructions per command, and what that many
                   cycles a command come to for the longest unit (one
                   warp starts at most one instruction a cycle);
  designs          the same wave ("real") under designs that were
                   weighed against the kernel: commands staged in
                   chunks of 16, 32 and 128 rather than 64, five Philox
                   warps rather than three (copies of ``csrc/replay.cu``
                   with that constant changed), and K5 with 8-byte
                   entries decoded in the replay loop
                   (``experiments/replay_narrow.cu``); each one's
                   outputs (and K6's flip counts) must equal the
                   kernel's.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
SM_CLOCK_HZ = 1.98e9
OUT_DIR = ROOT / "build" / "replay_probe"
# design -> (constant of csrc/replay.cu, its value), or None for
# experiments/replay_narrow.cu
DESIGNS = {
    "chunk 16": ("kChunk", 16),
    "chunk 32": ("kChunk", 32),
    "chunk 128": ("kChunk", 128),
    "5 drawers": ("kDrawers", 5),
    "8-byte entries": None,
}
# kernel -> its mangled name's identifier, as cuobjdump prints it
KERNEL_TAGS = {"K5": "13replay_kernel", "K6": "20faulty_replay_kernel",
               "K5 8-byte entries": "20narrow_replay_kernel"}
_INS = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")


def build_designs(build) -> dict:
    """Compile every design, all at once; returns name -> (CDLL, path)."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    base = (build.CSRC / "replay.cu").read_text()
    procs = {}
    for name, change in DESIGNS.items():
        stem = OUT_DIR / name.replace(" ", "_")
        if change is None:
            src, extra = ROOT / "experiments" / "replay_narrow.cu", [
                "-I", str(build.CSRC)]
        else:
            const, value = change
            text, n = re.subn(rf"constexpr int {const} = \d+;",
                              f"constexpr int {const} = {value};", base)
            assert n == 1, const
            src, extra = stem.with_suffix(".cu"), []
            src.write_text(text)
        so = stem.with_suffix(".so")
        cmd = [build._nvcc(), *build.NVCC_FLAGS, *extra, "-o", str(so),
               str(src)]
        procs[name] = (so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    functions = dict(build.LIBRARIES["replay"][1])
    functions["narrow_replay_launch"] = functions["replay_launch"]
    libs = {}
    for name, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        lib = ctypes.CDLL(str(so))
        for fn, argtypes in functions.items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = argtypes
        libs[name] = (lib, so)
    return libs


def call(lib, fn, *args) -> None:
    """One C entry point of a design's library on the current stream."""
    import torch
    rc = getattr(lib, fn)(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{fn} failed with CUDA error {rc}")


def sass_loops(build, so: Path) -> dict:
    """Kernel -> [(instructions, 32-bit shared stores)] of each replay
    loop in its SASS: an innermost loop that loads ring entries (64- or
    128-bit shared loads) and stores rows (three 32-bit shared stores a
    command).  The compiler may keep more than one copy of the loop."""
    cuobjdump = Path(build._nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(cuobjdump), "-sass", str(so)],
                          capture_output=True, text=True, check=True).stdout
    kernels = {}
    name = None
    for line in text.splitlines():
        if "Function :" in line:
            name = next((k for k, tag in KERNEL_TAGS.items()
                         if tag in line), None)
            if name is not None:
                kernels[name] = []
        elif name is not None:
            m = _INS.search(line)
            if m:
                kernels[name].append((int(m.group(1), 16), m.group(2)))
    found = {}
    for name, ins in kernels.items():
        loops = []
        for addr, t in ins:
            m = re.search(r"\bBRA\s+(0x[0-9a-f]+)", t)
            if m and int(m.group(1), 16) < addr:
                loops.append((int(m.group(1), 16), addr))
        inner = [a for a in loops if not any(
            b != a and a[0] <= b[0] and b[1] <= a[1] for b in loops)]
        found[name] = []
        for lo, hi in inner:
            body = [re.sub(r"^@!?U?P\w+\s+", "", t)
                    for addr, t in ins if lo <= addr <= hi]
            sts = sum(1 for t in body if re.match(r"STS\s", t))
            entries = sum(1 for t in body if re.match(r"LDS\.(64|128)\s", t))
            if entries and sts >= 3:
                found[name].append((len(body), sts))
    return found


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--json", help="also write the rows here")
    args = p.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("replay_probe: torch finds no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.core import bank as bank_mod
    from repro_torch.core.control_unit import CMD_WIDTH, flip_threshold
    from repro_torch.core.fault import (FaultModel, FaultRuntime,
                                        replicate_queue)
    from repro_torch.core.ops_library import get_op
    from repro_torch.kernels import build

    dev = torch.device("cuda")
    model = FaultModel(sigma=0.15, spare_lanes=1, seed=0, max_retries=10)

    def wave_one(queue):
        bank = bank_mod.Bank(n_subarrays=16, device=dev)
        lanes, stage, _ = bank_mod.plan_queue(queue)
        waves = bank._build_waves(queue, list(range(len(queue))), stage,
                                  lanes)
        states, (tables, schedule), _ = bank._pack_wave(
            queue, waves[0], lanes, {})
        return (torch.from_numpy(states.view(np.int32)).to(dev), tables,
                schedule)

    def schedule_of(counts):
        c = torch.tensor(counts, dtype=torch.int32)
        order = torch.argsort(c, descending=True, stable=True)
        return torch.stack([c, order.to(torch.int32)]).to(dev)

    rows = []

    def probe(kernel, name, launch, counts, longest, **extra):
        ms = cs.time_ms(launch, 20)
        row = {"kernel": kernel, "schedule": name, "ms": ms,
               "cycles_per_cmd": ms * 1e-3 * SM_CLOCK_HZ / max(longest, 1),
               "counts": [int(c) for c in counts], **extra}
        rows.append(row)
        print(f"{kernel} {name:16s} {ms:.4f} ms  "
              f"{row['cycles_per_cmd']:.1f} cycles per command")

    def variants(counts):
        longest = int(counts.max())
        only = np.where(counts == longest, counts, 0)
        one = np.zeros_like(counts)
        one[int(np.argmax(counts))] = longest
        return longest, [("real", counts, None), ("longest only", only, None),
                         ("one longest", one, None), ("one block", one, 32),
                         ("state only", np.zeros_like(counts), None)]

    lib = build.library("replay")
    designs = build_designs(build)

    # K5 on the mix queue's wave 1
    states, tables, schedule = wave_one(
        cs.mix_queue(bank_mod, get_op, 65536))
    n_units, n_rows, n_words = states.shape
    n_cmds = tables.shape[1]
    out = torch.empty_like(states)
    counts5 = schedule[0].cpu().numpy()
    longest5, cases = variants(counts5)

    def k5(lib, fn="replay_launch", sched=schedule, words=n_words,
           into=out):
        call(lib, fn, states.data_ptr(), into.data_ptr(),
             tables.data_ptr(), n_cmds * CMD_WIDTH, sched.data_ptr(),
             n_units, n_rows, words, n_cmds)

    for name, c, words in cases:
        sched = schedule_of(c)
        probe("K5", name, lambda s=sched, w=words or n_words: k5(
            lib, sched=s, words=w), c, longest5)
    want5 = torch.empty_like(states)
    k5(lib, into=want5)
    for name, (dlib, _) in designs.items():
        fn = "narrow_replay_launch" if DESIGNS[name] is None \
            else "replay_launch"
        got = torch.empty_like(states)
        k5(dlib, fn, into=got)
        same = bool(torch.equal(got, want5))
        probe("K5", name, lambda d=dlib, f=fn: k5(d, f), counts5, longest5,
              design=True, same_as_kernel=same)
        if not same:
            raise SystemExit(f"K5 design {name!r} disagrees with the kernel")

    # K6 on the replicated fault queue's wave 1, seed-0 keys, no stuck
    # columns, no dead unit
    states, tables, schedule = wave_one(replicate_queue(
        cs.mix_queue(bank_mod, get_op, cs.FAULT_LANES), model.replicas))
    n_units, n_rows, n_words = states.shape
    n_cmds = tables.shape[1]
    out = torch.empty_like(states)
    keys = torch.from_numpy(FaultRuntime(model, (), n_units).draw_keys()
                            .view(np.int32)).to(dev)
    stuck = torch.zeros((n_units, n_words), dtype=torch.int32, device=dev)
    dead = torch.zeros(n_units, dtype=torch.bool, device=dev)
    flips = torch.zeros(n_units, dtype=torch.int64, device=dev)
    thr = flip_threshold(model.flip_probability())
    counts6 = schedule[0].cpu().numpy()
    longest6, cases = variants(counts6)
    cases.insert(1, ("no random bits", counts6, None))

    def k6(lib, sched=schedule, words=n_words, t=thr, into=out, cnt=flips):
        call(lib, "faulty_replay_launch", states.data_ptr(),
             into.data_ptr(), tables.data_ptr(), n_cmds * CMD_WIDTH,
             sched.data_ptr(), keys.data_ptr(), stuck.data_ptr(),
             stuck.data_ptr(), dead.data_ptr(), cnt.data_ptr(), t, n_units,
             n_rows, words, n_cmds)

    for name, c, words in cases:
        sched = schedule_of(c)
        t = 0 if name == "no random bits" else thr
        probe("K6", name, lambda s=sched, w=words or n_words, t=t: k6(
            lib, s, w, t), c, longest6)
    want6 = torch.empty_like(states)
    nwant6 = torch.zeros_like(flips)
    k6(lib, into=want6, cnt=nwant6)
    for name, (dlib, _) in designs.items():
        if DESIGNS[name] is None:          # K5 only
            continue
        got, ngot = torch.empty_like(states), torch.zeros_like(flips)
        k6(dlib, into=got, cnt=ngot)
        same = bool(torch.equal(got, want6) and torch.equal(ngot, nwant6))
        probe("K6", name, lambda d=dlib: k6(d), counts6, longest6,
              design=True, same_as_kernel=same)
        if not same:
            raise SystemExit(f"K6 design {name!r} disagrees with the kernel")

    # the replay warp's instructions per command, from the SASS
    _, so, _ = build._paths("replay")
    loops = sass_loops(build, so)
    narrow = sass_loops(build, designs["8-byte entries"][1])
    loops["K5 8-byte entries"] = narrow["K5 8-byte entries"]
    sass = {}
    for kernel, found in loops.items():
        longest = longest6 if kernel == "K6" else longest5
        sass[kernel] = []
        for n_ins, n_sts in found:
            per_cmd = n_ins / (n_sts / 3)
            sass[kernel].append({
                "loop_instructions": n_ins, "loop_shared_stores": n_sts,
                "instructions_per_cmd": per_cmd,
                "instruction_floor_ms": longest * per_cmd / SM_CLOCK_HZ * 1e3})
            print(f"{kernel:18s} replay loop: {n_ins} instructions, "
                  f"{n_sts} row stores: {per_cmd:.1f} instructions a "
                  f"command; at one a cycle, the wave's longest unit "
                  f"({longest} commands) takes "
                  f"{sass[kernel][-1]['instruction_floor_ms']:.4f} ms")

    card = cs.nvidia_smi("name,power.limit")
    print(card)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(
            {"card": card, "rows": rows, "sass": sass}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
