"""K4's candidate units on a CUDA card: each one's rate of binary
multiply-accumulates, and K4 at the three VGG-16 shapes beside the design
it replaced.

    PYTHONPATH=src python experiments/popmma_probe.py [--json OUT.json]

1. Builds, all at once, ``experiments/popmma_probe.cu`` (mma.sync .b1 and
   .s8, the CUDA-core popcount), ``experiments/popmma_probe_wgmma.cu``
   twice (``-DUNIT_B1``: ``wgmma ... .b1.b1.and.popc``; ``-DUNIT_S8``:
   ``wgmma ... .s8.s8``) and ``experiments/popmatmul_simt.cu`` (K4's
   earlier CUDA-core design).  A form that ptxas refuses is a result: it is
   printed with the compiler's words and left out of the rates.
2. Each unit's rate fed from registers (no memory traffic): binary MACs a
   second at a launch long enough to fill the card (CUDA events over five
   launches), and the time the unit needs for the instructions each
   VGG-16 shape takes (``chip_smoke.VGG16_SHAPES``, one binary product),
   at four blocks per SM, kernel-only (``torch.profiler``).  An int8 MAC on bits held as {0, 1} is one
   binary MAC, so every rate is in the same unit.
3. At each shape, on the plane-0 bits of random 2-bit operands: K4
   (``csrc/popmatmul.cu``, ``binary_matmul``), the earlier design and
   ``torch._int_mm`` on the same bits as int8, each kernel-only
   (``torch.profiler``, 20 launches) and equal to one another; and a
   2 x 2-bit product through K4's fused entry (one launch) against the
   same product as four single products and the elementwise sum (the
   design before the fused entry): device time per product (profiler,
   ten calls) and CUDA events over 20 calls.  A copy of the kernel that
   reads %globaltimer and clock64 in every block (``build_timed``) shows
   where one launch of each goes: how many blocks, when the last one
   starts, how long a block takes, its stage loop and its epilogue.

The last line is one JSON object with every number; ``--json`` also
writes it to a file.  ``chip_smoke.py`` phase 5 imports :func:`start_builds`,
:func:`finish_builds` and :func:`peak_rates` for its K4 bound.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT_DIR = ROOT / "build" / "popmma_probe"
HERE = Path(__file__).resolve().parent

# library -> (source, extra nvcc flags)
SOURCES = {
    "units": ("popmma_probe.cu", ()),
    "wgmma_b1": ("popmma_probe_wgmma.cu", ("-DUNIT_B1",)),
    "wgmma_s8": ("popmma_probe_wgmma.cu", ("-DUNIT_S8",)),
    "simt": ("popmatmul_simt.cu", ()),
}
# unit -> (library, unit index or None for wgmma, binary MACs an instruction
# (a thread's popcount for "popc"), label)
UNITS = {
    "mma_b1": ("units", 0, 16 * 8 * 256,
               "mma.sync m16n8k256 .b1 .and.popc"),
    "mma_s8": ("units", 1, 16 * 8 * 32,
               "mma.sync m16n8k32 .s8 on bits as int8"),
    "popc": ("units", 2, 32, "__popc(a & w) on the CUDA cores"),
    "wgmma_b1": ("wgmma_b1", None, 64 * 128 * 256,
                 "wgmma m64n128k256 .b1 .and.popc"),
    "wgmma_s8": ("wgmma_s8", None, 64 * 128 * 32,
                 "wgmma m64n128k32 .s8 on bits as int8"),
}
WARPS = 4              # warps per block of the mma.sync and popc probes


def start_builds(build, names=None) -> list:
    """Start one ``nvcc`` per probe library (into ``build/popmma_probe``),
    all at once; returns the running processes for :func:`finish_builds`."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    started = []
    for name in names or SOURCES:
        src, flags = SOURCES[name]
        so = OUT_DIR / f"{name}.so"
        cmd = [build._nvcc(), *build.NVCC_FLAGS, *flags, "-o", str(so),
               str(HERE / src)]
        started.append((name, so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    return started


def finish_builds(started) -> dict:
    """name -> loaded CDLL, or the compiler's output where it failed."""
    P, I = ctypes.c_void_p, ctypes.c_int
    libs = {}
    for name, so, proc in started:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            libs[name] = out.strip()
            continue
        lib = ctypes.CDLL(str(so))
        lib.build_log = out         # ptxas -v, and any wgmma warning
        lib.repro_error_string.argtypes = [I]
        lib.repro_error_string.restype = ctypes.c_char_p
        if name == "units":
            lib.rate_launch.argtypes = [I, P, P, I, I, I, P]
        elif name == "simt":
            lib.popmatmul_simt_launch.argtypes = [P, P, P, I, I, I, P]
        else:
            lib.wgmma_rate_launch.argtypes = [P, I, I, P]
        for fn in ("rate_launch", "wgmma_rate_launch",
                   "popmatmul_simt_launch"):
            if hasattr(lib, fn):
                getattr(lib, fn).restype = I
        libs[name] = lib
    return libs


TIMING = """
__device__ long long g_timing[6 * 65536];
__device__ __forceinline__ long long now_ns() {
    long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
}
"""
TIMING_TAIL = """
extern "C" int popmatmul_timing(void* dst, int n) {
    return static_cast<int>(cudaMemcpyFromSymbol(dst, g_timing, 8LL * n));
}
extern "C" int popmatmul_timing_reset() {
    void* p = nullptr;
    cudaGetSymbolAddress(&p, g_timing);
    return static_cast<int>(cudaMemset(p, 0, sizeof(g_timing)));
}
"""


# timed copies of K4: as it is, and with one design constant changed
VARIANTS = {
    "kernel": {},
    "ring of 4": {"constexpr int kStages = 3;": "constexpr int kStages = 4;",
                  "constexpr int kMinBlocks = 6;":
                  "constexpr int kMinBlocks = 5;"},
    "no split": {"constexpr int kMaxSplits = 8;":
                 "constexpr int kMaxSplits = 1;"},
    "128-row tiles": {
        "constexpr int kBM = 64;": "constexpr int kBM = 128;",
        "constexpr int kThreads = 128;": "constexpr int kThreads = 256;",
        "constexpr int kMinBlocks = 6;": "constexpr int kMinBlocks = 3;"},
}


def build_timed(build, name="kernel"):
    """A copy of ``csrc/popmatmul.cu`` (with ``VARIANTS[name]``'s
    substitutions) whose blocks record, from thread 0, %globaltimer ns and
    clock64 cycles at the start, once the stage loop is done and at the
    end, into ``g_timing`` (6 words a block, blocks in x, y, z order),
    with ``popmatmul_timing`` to read it; returns its CDLL, launched as
    ``popmatmul_launch``."""
    text = (build.CSRC / "popmatmul.cu").read_text()
    for old, new in VARIANTS[name].items():
        if text.count(old) != 1:
            raise RuntimeError(f"timed K4 {name}: {old!r} not found")
        text = text.replace(old, new)
    start = "    const int tid = threadIdx.x;\n"
    looped = "    __syncthreads();                // every warp is done with the ring\n"
    end = "    if (splits > 1) cg::this_cluster().sync();  // peers read our tile\n"
    for anchor in (start, looped, end):
        if text.count(anchor) != 1:
            raise RuntimeError(f"timed K4: anchor not found: {anchor!r}")
    text = text.replace("namespace {\n", "namespace {\n" + TIMING, 1)
    text = text.replace(start, start + "    const long long t0 = now_ns(), "
                        "c0 = clock64();\n")
    text = text.replace(looped, looped + "    const long long t1 = now_ns(), "
                        "c1 = clock64();\n")
    text = text.replace(end, end + (
        "    if (tid == 0) {\n"
        "        const long long b = blockIdx.x + (long long)gridDim.x * "
        "(blockIdx.y + (long long)gridDim.y * blockIdx.z);\n"
        "        if (b < 65536) {\n"
        "            long long* r = g_timing + 6 * b;\n"
        "            r[0] = t0; r[1] = t1; r[2] = now_ns();\n"
        "            r[3] = c0; r[4] = c1; r[5] = clock64();\n"
        "        }\n    }\n"))
    text += TIMING_TAIL
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    stem = "popmatmul_timed_" + name.replace(" ", "_")
    src = OUT_DIR / f"{stem}.cu"
    src.write_text(text)
    so = OUT_DIR / f"{stem}.so"
    out = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(so),
                          str(src)], capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"nvcc failed for the timed K4:\n{out.stdout}"
                           f"{out.stderr}")
    lib = ctypes.CDLL(str(so))
    lib.popmatmul_launch.argtypes = build.LIBRARIES["popmatmul"][1][
        "popmatmul_launch"]
    lib.popmatmul_timing.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.popmatmul_timing_reset.argtypes = []
    lib.repro_error_string.argtypes = [ctypes.c_int]
    lib.repro_error_string.restype = ctypes.c_char_p
    return lib


def timed_run(lib, a_pl, w_pl, n_a, n_w, sign_w) -> dict:
    """One launch of the timed K4 after a warm-up; per block: its start
    and end against the first block's start (ns), its stage loop and its
    epilogue (cycles)."""
    import numpy as np
    import torch
    m, kw = a_pl.shape[-2:]
    n = w_pl.shape[-1]
    out = torch.empty((m, n), dtype=torch.int32, device="cuda")
    for i in range(2):          # the second launch is the one recorded
        torch.cuda.synchronize()
        if i and lib.popmatmul_timing_reset() != 0:
            raise RuntimeError("popmatmul_timing_reset failed")
        _call(lib, "popmatmul_launch", a_pl.data_ptr(), w_pl.data_ptr(),
              out.data_ptr(), m, n, kw, n_a, n_w, 0, sign_w)
    torch.cuda.synchronize()
    buf = np.zeros(6 * 65536, np.int64)
    rc = lib.popmatmul_timing(buf.ctypes.data, buf.size)
    if rc != 0:
        raise RuntimeError(f"popmatmul_timing: {rc}")
    rows = buf.reshape(-1, 6)
    rows = rows[rows[:, 0] > 0]
    t0 = rows[:, 0].min()
    return {"blocks": int(len(rows)),
            "span_us": float((rows[:, 2].max() - t0) / 1e3),
            "last_start_us": float((rows[:, 0].max() - t0) / 1e3),
            "block_us": float(np.mean(rows[:, 2] - rows[:, 0]) / 1e3),
            "loop_cycles": float(np.mean(rows[:, 4] - rows[:, 3])),
            "epilogue_cycles": float(np.mean(rows[:, 5] - rows[:, 4]))}


def _call(lib, fn, *args) -> None:
    import torch
    rc = getattr(lib, fn)(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{fn}: {lib.repro_error_string(rc).decode()}")


def _unit_run(libs, unit: str, n_instr: int, blocks: int):
    """(launch, binary MACs) for about ``n_instr`` of ``unit``'s
    instructions over ``blocks`` blocks."""
    import torch
    lib_name, index, macs, _ = UNITS[unit]
    lib = libs[lib_name]
    if index is None:                       # wgmma: one warpgroup a block
        per_round = blocks * lib.per_group()
        rounds = max(1, -(-n_instr // per_round))
        out = torch.empty(blocks * 128, dtype=torch.int32, device="cuda")
        return ((lambda: _call(lib, "wgmma_rate_launch", out.data_ptr(),
                               blocks, rounds)),
                rounds * per_round * macs)
    seed = torch.randint(-2**31, 2**31 - 1, (256,), dtype=torch.int32,
                         device="cuda")
    threads = 32 * WARPS
    out = torch.empty(blocks * threads, dtype=torch.int32, device="cuda")
    per_round = blocks * lib.chains() * (threads if index == 2 else WARPS)
    rounds = max(1, -(-n_instr // per_round))
    return ((lambda: _call(lib, "rate_launch", index, seed.data_ptr(),
                           out.data_ptr(), blocks, threads, rounds)),
            rounds * per_round * macs)


def peak_rates(libs, time_ms) -> dict:
    """unit -> {"label", "macs_per_s", "ms"} at a launch that fills the
    card (8 blocks per SM, about a millisecond or more), CUDA events over
    five launches (``time_ms`` is ``chip_smoke.time_ms``); a unit whose
    library did not build has its compiler output under "refused"."""
    import torch
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    # instructions a launch: about 2.3e12 binary MACs on the b1 forms
    n_instr = {"mma_b1": 1 << 26, "mma_s8": 1 << 26, "popc": 1 << 32,
               "wgmma_b1": 1 << 21, "wgmma_s8": 1 << 21}
    rates = {}
    for unit, (lib_name, _, _, label) in UNITS.items():
        if not isinstance(libs.get(lib_name), ctypes.CDLL):
            rates[unit] = {"label": label,
                           "refused": str(libs.get(lib_name))[-2000:]}
            continue
        fn, macs = _unit_run(libs, unit, n_instr[unit], 8 * sms)
        ms = time_ms(fn, 5, warmup=1)
        rates[unit] = {"label": label, "macs_per_s": macs / (ms * 1e-3),
                       "ms": ms}
    return rates


def shape_instructions(unit: str, m: int, k: int, n: int) -> int:
    """Instructions of ``unit`` one binary (M, K) x (K, N) product takes."""
    up = lambda x, d: -(-x // d)            # noqa: E731
    return {"mma_b1": up(m, 16) * up(n, 8) * up(k, 256),
            "mma_s8": up(m, 16) * up(n, 8) * up(k, 32),
            "popc": m * n * up(k, 32),
            "wgmma_b1": up(m, 64) * up(n, 128) * up(k, 256),
            "wgmma_s8": up(m, 64) * up(n, 128) * up(k, 32)}[unit]


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--json", help="also write the record here")
    args = p.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("popmma_probe: torch finds no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.bitserial_matmul import (binary_matmul,
                                                      bitserial_planes)

    card = cs.nvidia_smi("name,power.limit")
    print(f"[0] {card}")
    started = start_builds(build)
    build.build_all(["popmatmul"])
    timed = {name: build_timed(build, name) for name in VARIANTS}
    libs = finish_builds(started)
    record = {"card": card, "refused": {}}
    for name, lib in libs.items():
        if not isinstance(lib, ctypes.CDLL):
            record["refused"][name] = lib[-2000:]
            print(f"[1] {name}: nvcc refused it:\n{lib[-2000:]}")
            continue
        for line in lib.build_log.splitlines():
            if any(w in line for w in ("registers", "spill", "arning")):
                print(f"[1] {name}: {line.strip()}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    rates = peak_rates(libs, cs.time_ms)
    record["peak"] = rates
    for unit, r in rates.items():
        if "macs_per_s" in r:
            print(f"[2] {unit} ({r['label']}): "
                  f"{r['macs_per_s'] / 1e12:.1f} T binary MACs/s "
                  f"({r['ms']:.3f} ms a launch)")

    gen = torch.Generator(device="cuda").manual_seed(5)
    record["shapes"] = {}
    for name, m, k, n in cs.VGG16_SHAPES:
        row = {"m": m, "k": k, "n": n, "macs": m * k * n, "units_ms": {}}
        for unit in UNITS:
            if "macs_per_s" not in rates[unit]:
                continue
            fn, _ = _unit_run(libs, unit, shape_instructions(unit, m, k, n),
                              4 * sms)
            row["units_ms"][unit] = cs.kernel_ms(
                fn, 20, "rate_kernel" if UNITS[unit][1] is not None
                else "wgmma_rate_kernel")
        a = torch.randint(0, 4, (m, k), generator=gen, device="cuda",
                          dtype=torch.int32)
        w = torch.randint(-2, 2, (k, n), generator=gen, device="cuda",
                          dtype=torch.int32)
        ap = kops._pack_bits_matrix(a & 1, 1)
        wp = kops._pack_bits_matrix(w & 1, 0)
        kw = ap.shape[1]
        out = binary_matmul(ap, wp)
        old = torch.empty_like(out)
        simt = libs["simt"]
        simt_launch = (lambda: _call(simt, "popmatmul_simt_launch",
                                     ap.data_ptr(), wp.data_ptr(),
                                     old.data_ptr(), m, n, kw))
        simt_launch()
        a8, w8 = (a & 1).to(torch.int8), (w & 1).to(torch.int8)
        lib = torch._int_mm(a8, w8)
        torch.cuda.synchronize()
        cs.check(torch.equal(out, old) and torch.equal(out, lib),
                 f"K4, the earlier design and torch._int_mm disagree at "
                 f"{name}")
        row["kernel_ms"] = cs.kernel_ms(lambda: binary_matmul(ap, wp), 20,
                                        "popmatmul_kernel")
        row["simt_kernel_ms"] = cs.kernel_ms(simt_launch, 20,
                                             "popmatmul_simt_kernel")
        row["int_mm_ms"] = cs.time_ms(lambda: torch._int_mm(a8, w8), 20)
        # the 2 x 2-bit product: fused (one launch) against four single
        # products and their weighted sum, as before the fused entry
        iw = torch.arange(2, dtype=torch.int32, device="cuda")
        a_pl = kops._pack_bits_matrix((a >> iw[:, None, None]) & 1, 2)
        w_pl = kops._pack_bits_matrix((w & 3) >> iw[:, None, None] & 1, 1)

        def pairs():
            acc = torch.zeros((m, n), dtype=torch.int32, device="cuda")
            for i in range(2):
                for j in range(2):
                    part = binary_matmul(a_pl[i], w_pl[j])
                    acc = acc + (-1 if j == 1 else 1) * (part << (i + j))
            return acc

        fused = bitserial_planes(a_pl, w_pl, False, True)
        cs.check(torch.equal(fused, pairs()),
                 f"fused and per-pair products disagree at {name}")
        exact = (a.double() @ w.double()).to(torch.int32)
        cs.check(torch.equal(fused, exact), f"fused product wrong at {name}")
        # device time per product (profiler, ten calls): the fused launch,
        # and the four launches plus the elementwise passes
        for key, fn in (("fused", lambda: bitserial_planes(
                a_pl, w_pl, False, True)), ("pairs", pairs)):
            fn()
            b = cs.device_breakdown(lambda: [fn() for _ in range(10)])
            row[f"{key}_device_ms"] = b["device_busy_ms"] / 10
            row[f"{key}_ms"] = cs.time_ms(fn, 20)
        row["fused_kernel_ms"] = cs.kernel_ms(
            lambda: bitserial_planes(a_pl, w_pl, False, True), 20,
            "popmatmul_kernel")
        row["bytes"] = 4 * (m * kw + kw * n + m * n)
        # where a launch's time goes: per block, from the timed copies,
        # with each copy's kernel time (profiler; the timing adds a few
        # instructions a block)
        row["timed"] = {}
        for vname, lib_t in timed.items():
            for key, run in (("binary", (a_pl[:1], w_pl[:1], 1, 1, 0)),
                             ("fused", (a_pl, w_pl, 2, 2, 1))):
                t = timed_run(lib_t, *run)
                ap_, wp_, n_a, n_w, sw = run
                o_ = torch.empty((m, n), dtype=torch.int32, device="cuda")
                t["kernel_ms"] = cs.kernel_ms(lambda: _call(
                    lib_t, "popmatmul_launch", ap_.data_ptr(), wp_.data_ptr(),
                    o_.data_ptr(), m, n, kw, n_a, n_w, 0, sw), 20,
                    "popmatmul_kernel")
                row["timed"][f"{vname}, {key}"] = t
        record["shapes"][name] = row
        print(f"[3] {name} (M {m}, K {k}, N {n}): K4 {row['kernel_ms']:.4f} "
              f"ms, earlier design {row['simt_kernel_ms']:.4f} ms, "
              f"torch._int_mm {row['int_mm_ms']:.4f} ms (kernel ms; "
              f"_int_mm by events); units fed from registers "
              + ", ".join(f"{u} {t:.4f}" for u, t in row["units_ms"].items())
              + f" ms (kernel ms); 2x2 bits, device ms a product: fused "
              f"{row['fused_device_ms']:.4f} (kernel "
              f"{row['fused_kernel_ms']:.4f}) vs four products + sum "
              f"{row['pairs_device_ms']:.4f}; by events (host-bound) "
              f"{row['fused_ms']:.4f} vs {row['pairs_ms']:.4f} ms")
        for key, t in row["timed"].items():
            print(f"[3] {name} {key}, timed copy: kernel "
                  f"{t['kernel_ms']:.4f} ms, {t['blocks']} blocks, span "
                  f"{t['span_us']:.2f} us, last "
                  f"block starts at {t['last_start_us']:.2f} us, a block "
                  f"{t['block_us']:.2f} us (stage loop "
                  f"{t['loop_cycles']:.0f} cycles, epilogue "
                  f"{t['epilogue_cycles']:.0f})")
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(record, indent=1))
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
