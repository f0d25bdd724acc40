"""Build, load and count the port's CUDA kernels.

Each source under ``src/repro_torch/csrc/`` is one shared library with a
plain C interface, compiled by ``nvcc`` for ``sm_90a`` on first use into
``build/repro_torch/`` at the root of the checkout and loaded with
``ctypes``.  A library's file name carries a hash of its source and the
compiler flags, so an edited source builds anew and an unchanged one is
loaded from disk.  ``nvcc -Xptxas -v`` output (registers, shared memory,
spills per kernel) is kept beside each library in a ``.log`` file;
:func:`build_log` returns it.

Every C entry point launches on the stream it is given, allocates
nothing, and returns ``cudaGetLastError()`` after the launch; the
wrappers raise on a non-zero code.  There is no fallback: a missing
``nvcc``, a failed build or a failed launch raises.

:data:`LAUNCHES` holds one plain integer per kernel; a wrapper adds one
where it launches its kernel and nowhere else.  :data:`BUILDS` counts
``nvcc`` runs in this process (a repeated dispatch builds nothing).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

ROOT = Path(__file__).resolve().parents[3]
CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = ROOT / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_U64 = ctypes.c_ulonglong

# library -> (source, {C function: argtypes}); every function returns int
LIBRARIES = {
    "transpose": ("transpose.cu", {
        "h2v_launch": [_P, _P, _I, _I, _P],
        "v2h_launch": [_P, _P, _I, _I, _I, _P],
    }),
    "circuit": ("circuit.cu", {
        "circuit_launch": [_P] + [_I] * 9 + [_P] * 5 + [_I, _P],
    }),
    "replay": ("replay.cu", {
        "replay_launch": [_P, _P, _P, _L, _P, _I, _I, _I, _I, _P],
        "faulty_replay_launch": [_P, _P, _P, _L, _P, _P, _P, _P, _P, _P,
                                 _U64, _I, _I, _I, _I, _P],
    }),
    "popmatmul": ("popmatmul.cu", {
        "popmatmul_launch": [_P, _P, _P] + [_I] * 7 + [_P],
    }),
}

LAUNCHES: Dict[str, int] = {"h2v": 0, "v2h": 0, "circuit": 0, "replay": 0,
                            "popmatmul": 0, "faulty_replay": 0}
BUILDS: Dict[str, int] = {name: 0 for name in LIBRARIES}

_LOADED: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def reset_launches() -> None:
    """Set every launch counter to 0."""
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def resolve_device(device) -> torch.device:
    """``torch.device`` for an entry point's ``device`` argument.

    ``"cuda"`` with no card raises: the port never moves to the CPU by
    itself; a caller that wants the plain versions passes ``"cpu"``."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' was asked for, but torch finds no CUDA "
                "device; pass device='cpu' to run the plain versions")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    return dev


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError(
            "nvcc not found on PATH or at /usr/local/cuda/bin/nvcc; the "
            "CUDA kernels cannot be built")
    return found


def _paths(name: str):
    source = CSRC / LIBRARIES[name][0]
    h = hashlib.sha256(source.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    stem = BUILD_DIR / f"{name}-{h.hexdigest()[:16]}"
    return source, stem.with_suffix(".so"), stem.with_suffix(".log")


def build_all(names: Optional[Iterable[str]] = None) -> float:
    """Build every library not yet on disk, one ``nvcc`` per source, all
    started together.  Returns the seconds spent; raises on a failure."""
    names = list(LIBRARIES if names is None else names)
    t0 = time.perf_counter()
    with _LOCK:
        todo = []
        for name in names:
            source, so, log = _paths(name)
            if so.exists():
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            todo.append((name, so, log, tmp, cmd, proc))
        failed = []
        for name, so, log, tmp, cmd, proc in todo:
            out, _ = proc.communicate()
            log.write_text(" ".join(cmd) + "\n" + out)
            if proc.returncode != 0:
                failed.append(f"{name} (exit {proc.returncode}):\n{out}")
                continue
            os.replace(tmp, so)
            BUILDS[name] += 1
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library ``name``, built first if needed."""
    lib = _LOADED.get(name)
    if lib is not None:
        return lib
    build_all([name])
    with _LOCK:
        if name not in _LOADED:
            _, so, _ = _paths(name)
            lib = ctypes.CDLL(str(so))
            for fn, argtypes in LIBRARIES[name][1].items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            lib.repro_error_string.argtypes = [ctypes.c_int]
            lib.repro_error_string.restype = ctypes.c_char_p
            _LOADED[name] = lib
    return _LOADED[name]


def build_log() -> str:
    """The ``nvcc`` command and ``ptxas -v`` output of every library on
    disk for the current sources."""
    parts = []
    for name in LIBRARIES:
        _, _, log = _paths(name)
        if log.exists():
            parts.append(f"== {name}\n{log.read_text()}")
    return "\n".join(parts)


def launch(lib_name: str, fn: str, *args) -> None:
    """Call one C entry point on the current stream; raise on a non-zero
    ``cudaGetLastError()`` code."""
    lib = library(lib_name)
    stream = torch.cuda.current_stream().cuda_stream
    rc = getattr(lib, fn)(*args, stream)
    if rc != 0:
        msg = lib.repro_error_string(rc).decode()
        raise RuntimeError(f"{fn} failed with CUDA error {rc}: {msg}")
