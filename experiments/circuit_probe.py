"""K3's kernel time per op, against the serial design it replaced, on a
CUDA card.

    PYTHONPATH=src python experiments/circuit_probe.py [--json OUT.json]

For each of ``chip_smoke.py``'s fast-path ops (16 at 8 bits, three at
16) and 16-bit division, at 1,048,576 lanes of random operands, it runs
and times (kernel-only, ``torch.profiler``, 20 launches after warm-up):

  serial     the serial design (``experiments/circuit_serial.cu``: one
             thread per word runs the whole slot program, one
             instruction after another, with a ``switch`` per
             instruction), on its own lowering (``serial_program``);
  kernel     ``csrc/circuit.cu`` on ``lower_circuit``'s program, at the
             warp count the host picks;
  W = n      the same program at 1, 2, 4 and 8 warps per block.

Every run's output must equal the plain circuit's bit for bit.  A copy
of the kernel that reads ``clock64`` and ``%globaltimer`` in each block
(``timed``) gives, for every op, a block's mean cycles, the cycles it
spends staging its tables and gates, its cycles per step and the SM
clock it ran at.  On four ops, timed copies that leave one part of
every step out (the cp.async wait, the barrier, both, the gates, the
input loads, the output stores, all three; all but the gates; all but
the gates, whose arguments then come from their entries and not from
the slots; their outputs are not checked) show what a step costs.
Then it reads the level-parallel kernel's SASS (``cuobjdump -sass``): the
innermost loop that runs four gates at once (twelve 64-bit shared
loads), its instructions per gate, in the MIG and the XOR form.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import heapq
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
OUT_DIR = ROOT / "build" / "circuit_probe"
WARPS = (1, 2, 4, 8)
EXTRA = [("division", 16)]
SERIAL_OPCODES = {"in": 0, "out": 1, "c0": 2, "c1": 3, "not": 4, "and": 5,
                  "or": 6, "xor": 7, "maj": 8}
_INS = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")


def serial_program(circ, input_ids):
    """The serial design's lowering: live nodes in topological order, an
    input plane loaded right before its first use, an output stored
    right after its node, slots reused by liveness (lowest free first).
    Returns ((n_instr, 4) int32 code, n_slots)."""
    in_index = {}
    for ids in input_ids:
        for nid in ids:
            in_index[nid] = len(in_index)
    live = circ.live_nodes()
    uses = {}
    for nid in live:
        for a in circ.args[nid]:
            uses[a] = uses.get(a, 0) + 1
    out_pos = {}
    for pos, nid in enumerate(circ.outputs):
        out_pos.setdefault(nid, []).append(pos)
    free, slot, code, n_slots = [], {}, [], 0
    for nid in live:
        op, args = circ.ops[nid], circ.args[nid]
        srcs = [slot[a] for a in args]
        for a in set(args):
            uses[a] -= args.count(a)
            if uses[a] == 0:
                heapq.heappush(free, slot.pop(a))
        if free:
            dst = heapq.heappop(free)
        else:
            dst, n_slots = n_slots, n_slots + 1
        slot[nid] = dst
        if op == "in":
            srcs = [in_index[nid]]
        srcs = (srcs + [0, 0, 0])[:3]
        code.append((SERIAL_OPCODES[op] | dst << 8, *srcs))
        for pos in out_pos.get(nid, ()):
            code.append((SERIAL_OPCODES["out"] | pos << 8, dst, 0, 0))
        if uses.get(nid, 0) == 0:
            heapq.heappush(free, slot.pop(nid))
    return np.asarray(code, np.int32).reshape(-1, 4), n_slots


def build_serial(build):
    """Compile ``experiments/circuit_serial.cu``; returns its CDLL."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    so = OUT_DIR / "circuit_serial.so"
    cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", str(so),
           str(ROOT / "experiments" / "circuit_serial.cu")]
    out = subprocess.run(cmd, capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{out.stdout}{out.stderr}")
    lib = ctypes.CDLL(str(so))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.circuit_launch.argtypes = [P, I, I, P, P, I, P]
    return lib


TIMING_HEAD = """
__device__ long long g_timing[3 * 65536];
"""
TIMING_TAIL = """
extern "C" int circuit_timing(void* dst, int n) {
    return static_cast<int>(cudaMemcpyFromSymbol(dst, g_timing, 8LL * n));
}
"""


STORES = ("                    if (ok0) dst[w0] = v.x ^ mask;\n"
          "                    if (ok1) dst[w0 + 1] = v.y ^ mask;\n")
STEP_END = ("                cp_async_wait<kAhead - 1>();\n"
            "                __syncthreads();\n")
GATES = ("                for (; g + (kBatch - 1) * n_warps < g1;\n"
         "                     g += kBatch * n_warps)\n"
         "                    run_gates<kXor, kBatch, false>(sg, my, g, n_warps, "
         "g1);\n"
         "                for (; g < g1; g += 2 * n_warps)   // the last one "
         "to three\n"
         "                    run_gates<kXor, 2, true>(sg, my, g, n_warps, g1);\n")
LOADS = ("                    cp_async4(dst, src + (ok0 ? w0 : 0), ok0 ? 4 : 0);\n"
         "                    cp_async4(dst + 4, src + (ok1 ? w0 + 1 : 0), "
         "ok1 ? 4 : 0);\n")
# timed copies that leave one part of every step out, to see what a step
# costs; their outputs are not checked
CAUSES = {
    "timed": [],
    "no cp.async wait": [(STEP_END, "                __syncthreads();\n")],
    "no barrier": [(STEP_END, "                cp_async_wait<kAhead - 1>();\n")],
    "no wait, no barrier": [(STEP_END, "")],
    "no gates": [(GATES, "")],
    "no loads": [(LOADS, "")],
    "no stores": [(STORES, "")],
    "empty steps": [(GATES, ""), (LOADS, ""), (STORES, "")],
    "gates only": [(LOADS, ""), (STORES, ""), (STEP_END, "")],
    "gates only, no slot loads": [
        (LOADS, ""), (STORES, ""), (STEP_END, ""),
        ("        a[k] = slot(my, kXor ? e[k].x & ~1 : e[k].x);\n"
         "        b[k] = slot(my, e[k].y);\n"
         "        c[k] = slot(my, e[k].z & ~1);\n",
         "        a[k] = make_uint2(e[k].x, e[k].y);\n"
         "        b[k] = make_uint2(e[k].z, e[k].w);\n"
         "        c[k] = make_uint2(e[k].y, e[k].x);\n")],
}
CAUSE_OPS = (("relu", 8), ("greater", 8), ("division", 8),
             ("multiplication", 16))


def build_timed(build) -> dict:
    """Compile copies of ``csrc/circuit.cu`` whose blocks record clock64
    cycles and %globaltimer nanoseconds (thread 0: at the start, once the
    tables and gates are staged, at the end) into ``g_timing``, one per
    entry of CAUSES, all at once; returns name -> CDLL."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    base = (build.CSRC / "circuit.cu").read_text()
    start = "    extern __shared__ __align__(16) unsigned char smem[];\n"
    staged = "    if (resident) stage(sg, gates, n_gates);\n"
    end = "                g1 = g2, l1 = l2, o1 = o2;\n            }\n" \
          "        }\n    }\n"
    now = ("    asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"({}));\n")
    procs = {}
    for name, subs in CAUSES.items():
        text = base
        for old, new in [(start, start + "    const long long t_clk = "
                          "clock64();\n    unsigned long long t_ns;\n"
                          + now.format("t_ns")),
                         (staged, staged + "    const long long s_clk = "
                          "clock64();\n"),
                         (end, end + "    unsigned long long e_ns;\n"
                          + now.format("e_ns") +
                          "    if (threadIdx.x == 0 && blockIdx.x < 65536) {\n"
                          "        g_timing[3 * blockIdx.x] = clock64() - t_clk;\n"
                          "        g_timing[3 * blockIdx.x + 1] = s_clk - t_clk;\n"
                          "        g_timing[3 * blockIdx.x + 2] = "
                          "(long long)(e_ns - t_ns);\n    }\n"),
                         ("namespace {\n", "namespace {\n" + TIMING_HEAD)]:
            assert text.count(old) == 1, old
            text = text.replace(old, new)
        for old, new in subs:
            assert text.count(old) == 1, old
            text = text.replace(old, new)
        stem = OUT_DIR / ("circuit_" + re.sub(r"\W+", "_", name))
        stem.with_suffix(".cu").write_text(text + TIMING_TAIL)
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o",
               str(stem.with_suffix(".so")), str(stem.with_suffix(".cu"))]
        procs[name] = (stem.with_suffix(".so"), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        lib = ctypes.CDLL(str(so))
        lib.circuit_launch.argtypes = build.LIBRARIES["circuit"][1][
            "circuit_launch"]
        lib.circuit_timing.argtypes = [ctypes.c_void_p, ctypes.c_int]
        libs[name] = lib
    return libs


def block_times(lib, prog, code, planes, out) -> dict:
    """One launch of a timed copy: a block's mean cycles, cycles to stage
    its tables and gates, nanoseconds, and the SM clock."""
    import torch
    words = out.shape[1]
    ptrs = [p.data_ptr() for p in planes]
    ptrs += [ptrs[0]] * (4 - len(ptrs))
    rc = lib.circuit_launch(
        code.data_ptr(), prog.n_gates, prog.n_steps,
        int(prog.loads.shape[0]), int(prog.stores.shape[0]),
        len(prog.chunks) - 1, prog.chunk_cap, prog.n_slots, prog.warps,
        int(prog.has_xor), *ptrs, out.data_ptr(), words,
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    if rc != 0:
        raise RuntimeError(f"timed launch failed: {rc}")
    blocks = -(-words // 64)
    t = np.zeros(3 * blocks, np.int64)
    if lib.circuit_timing(t.ctypes.data, t.size) != 0:
        raise RuntimeError("reading the block timings failed")
    t = t.reshape(-1, 3)
    cycles, ns = float(t[:, 0].mean()), float(t[:, 2].mean())
    return {"block_cycles": cycles, "staging_cycles": float(t[:, 1].mean()),
            "block_ns": ns, "sm_ghz": cycles / ns,
            "cycles_per_step": (cycles - float(t[:, 1].mean()))
            / prog.n_steps}


def gate_loops(build) -> dict:
    """Kernel form -> SASS instructions per gate of each innermost loop
    that runs four gates (twelve 64-bit shared loads) in the kernel."""
    _, so, _ = build._paths("circuit")
    cuobjdump = Path(build._nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(cuobjdump), "-sass", str(so)],
                          capture_output=True, text=True, check=True).stdout
    forms, name = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            name = ("xor" if "ILb1E" in line else "mig"
                    if "ILb0E" in line else None)
            if name:
                forms[name] = []
        elif name:
            m = _INS.search(line)
            if m:
                forms[name].append((int(m.group(1), 16), m.group(2)))
    found = {}
    for name, ins in forms.items():
        loops = []
        for addr, t in ins:
            m = re.search(r"\bBRA\s+(0x[0-9a-f]+)", t)
            if m and int(m.group(1), 16) < addr:
                loops.append((int(m.group(1), 16), addr))
        inner = [a for a in loops if not any(
            b != a and a[0] <= b[0] and b[1] <= a[1] for b in loops)]
        found[name] = []
        for lo, hi in inner:
            body = [t for addr, t in ins if lo <= addr <= hi]
            lds64 = sum(1 for t in body if re.search(r"\bLDS\.64\s", t))
            if lds64 == 12:
                found[name].append(len(body) / 4)
    return found


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--json", help="also write the rows here")
    args = p.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("circuit_probe: torch finds no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.core import bitplane
    from repro_torch.core.timing import DDR4
    from repro_torch.kernels import build
    from repro_torch.kernels.bitplane_ops import (_launch, circuit_plain,
                                                  lower_circuit)
    from repro_torch.kernels.transpose_kernel import h2v_cuda

    dev = torch.device("cuda")
    print(f"[0] {cs.nvidia_smi('name,power.limit')}")
    build.build_all(["circuit", "transpose"])
    serial = build_serial(build)
    timed = build_timed(build)
    n_lanes = DDR4.simd_lanes
    rows = {}
    for op, w in cs.FAST_PATH + EXTRA:
        spec, circ, ids = bitplane._compiled_op(op, w)
        rng = np.random.default_rng(len(op) * 100 + w)
        planes = [h2v_cuda(torch.from_numpy(
            rng.integers(0, 1 << b, n_lanes).astype(np.uint32).view(np.int32)
        ).to(dev), b) for b in spec.operand_bits]
        want = circuit_plain(circ, ids, planes)
        words = want.shape[1]
        row = {}

        code_s, slots_s = serial_program(circ, ids)
        code_s = torch.from_numpy(code_s).to(dev)
        inp = torch.cat(planes).contiguous()
        out = torch.empty_like(want)

        def run_serial():
            rc = serial.circuit_launch(
                code_s.data_ptr(), int(code_s.shape[0]), slots_s,
                inp.data_ptr(), out.data_ptr(), words,
                torch.cuda.current_stream().cuda_stream)
            cs.check(rc == 0, f"serial launch failed: {rc}")
        run_serial()
        cs.check(torch.equal(out, want), f"serial {op}/{w} is wrong")
        row["serial_ms"] = cs.kernel_ms(run_serial, 20, "circuit_kernel")
        row["serial_slots"] = slots_s

        prog = lower_circuit(circ, ids)
        code = torch.from_numpy(prog.code).to(dev)
        for warps in (prog.warps,) + WARPS:
            pw = dataclasses.replace(prog, warps=warps)
            out.fill_(7)
            _launch(pw, code, planes, out)
            cs.check(torch.equal(out, want),
                     f"kernel {op}/{w} at {warps} warps is wrong")
            ms = cs.kernel_ms(lambda: _launch(pw, code, planes, out), 20,
                              "circuit_kernel")
            row.setdefault("warps_ms", {})[warps] = ms
        out.fill_(7)
        row.update(block_times(timed["timed"], prog, code, planes, out))
        cs.check(torch.equal(out, want), f"timed copy {op}/{w} is wrong")
        if (op, w) in CAUSE_OPS:
            row["causes"] = {name: block_times(lib, prog, code, planes, out)
                             for name, lib in timed.items()}
        row.update(kernel_ms=row["warps_ms"][prog.warps], warps=prog.warps,
                   gates=prog.n_gates, levels=prog.n_levels,
                   slots=prog.n_slots, chunks=len(prog.chunks) - 1)
        n_bytes = 4 * words * (prog.n_inputs + prog.n_outputs)
        row["bound_ms"], row["bound_by"] = cs.bound(n_bytes,
                                                    prog.n_gates * words)
        rows[f"{op}/{w}"] = row
        print(f"[1] {op}/{w}: serial {row['serial_ms']:.4f} ms "
              f"({slots_s} slots); kernel {row['kernel_ms']:.4f} ms at W = "
              f"{prog.warps} ({prog.n_gates} gates, {prog.n_levels} levels, "
              f"{prog.n_slots} slots); by W "
              + ", ".join(f"{k}: {v:.4f}" for k, v in
                          sorted(row["warps_ms"].items()))
              + f"; bound {row['bound_ms']:.4f} ms; a block "
              f"{row['block_cycles']:.0f} cycles in {row['block_ns']:.0f} ns "
              f"({row['sm_ghz']:.2f} GHz), {row['staging_cycles']:.0f} "
              f"staging, {row['cycles_per_step']:.0f} cycles a step")
        for name, c in row.get("causes", {}).items():
            print(f"[1]   {op}/{w} {name}: a block {c['block_cycles']:.0f} "
                  f"cycles, staging {c['staging_cycles']:.0f}, "
                  f"{c['cycles_per_step']:.0f} a step")
    fast = [f"{op}/{w}" for op, w in cs.FAST_PATH]
    total = {k: sum(rows[r][k] for r in fast)
             for k in ("serial_ms", "kernel_ms", "bound_ms")}
    print(f"[1] fast path total: serial {total['serial_ms']:.4f} ms, "
          f"kernel {total['kernel_ms']:.4f} ms, bound "
          f"{total['bound_ms']:.4f} ms")
    loops = gate_loops(build)
    print(f"[2] SASS instructions per gate, four-gate loop: {loops}")
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(
            {"card": cs.nvidia_smi("name,power.limit"), "ops": rows,
             "fast_path_total": total, "sass_per_gate": loops}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
