#!/usr/bin/env python
"""Docs lint of the PyTorch port: every file path and module the port's
documents reference must exist.

The port's counterpart of ``scripts/check_docs.py``: the same patterns
and rules over the port's documents, the README's port section (from
its ``## The PyTorch/CUDA port`` heading to the next ``## `` heading)
and ``examples_torch/README.md``.  Backtick-quoted repo paths
(`src/repro_torch/...py`, `scripts/...sh`, `experiments/...py`), dotted
module paths (`repro_torch.distributed.partition`, and the reference's
`repro.*` and `benchmarks.*` that the port's text names beside it; an
attribute after the module, as in
`repro_torch.distributed.partition.partitioned_step`, must be defined
in the module's source) and `python -m` invocations must resolve, or it
exits non-zero listing each dangling reference.  A path resolves from
the repo root or from the document's own directory; an absolute path (a
file an example writes under ``/tmp``) is not a repo path, and generated
artifacts (``BENCH_*.json``, ``TRACE_*.json``) may be absent.

Run from anywhere:  python scripts/check_docs_torch.py
"""

from __future__ import annotations

import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# (document, heading of the section checked; None: the whole file)
DOCS = [("README.md", "## The PyTorch/CUDA port"),
        ("examples_torch/README.md", None)]

_PATH = re.compile(r"`([\w./-]+\.(?:py|md|sh|toml|json|yml|cu))`")
_MODULE = re.compile(r"`((?:repro_torch|repro|benchmarks)(?:\.\w+)+)`")
_PYTHON_M = re.compile(r"python -m ([\w.]+)")
_GENERATED = re.compile(r"^(?:BENCH|TRACE)_\w+\.json$")


def _module_file(dotted: str):
    """The .py file a dotted prefix resolves to, plus the unresolved
    tail."""
    parts = dotted.split(".")
    for cut in range(len(parts), 0, -1):
        rel = Path(*parts[:cut])
        for base in (ROOT / "src", ROOT):
            if (base / rel).with_suffix(".py").exists():
                return (base / rel).with_suffix(".py"), parts[cut:]
            if (base / rel / "__init__.py").exists():
                return base / rel / "__init__.py", parts[cut:]
    return None, parts


def _module_exists(dotted: str, attr_ok: bool = False) -> bool:
    """True when ``dotted`` names a real module or, with ``attr_ok``, a
    name the module's source defines."""
    f, tail = _module_file(dotted)
    if f is None:
        return False
    if not tail:
        return True
    if not attr_ok:
        return False
    return re.search(rf"\b{re.escape(tail[0])}\b", f.read_text()) is not None


def section(text: str, heading) -> str:
    """``text`` from the line ``heading`` to the next heading of its
    level (all of it where ``heading`` is None); empty where the heading
    is missing."""
    if heading is None:
        return text
    lines = text.splitlines(keepends=True)
    level = heading.split(" ")[0] + " "
    for i, line in enumerate(lines):
        if line.startswith(heading):
            end = next((j for j in range(i + 1, len(lines))
                        if lines[j].startswith(level)), len(lines))
            return "".join(lines[i:end])
    return ""


def check(doc: Path, text: str) -> list:
    """(reference, kind) of each reference in ``text`` (of ``doc``) that
    does not resolve."""
    missing = []
    for m in _PATH.finditer(text):
        ref = m.group(1)
        if ref.startswith("/") or _GENERATED.match(Path(ref).name):
            continue
        if not ((ROOT / ref).exists() or (doc.parent / ref).exists()):
            missing.append((ref, "path"))
    for m in _MODULE.finditer(text):
        if not _module_exists(m.group(1), attr_ok=True):
            missing.append((m.group(1), "module"))
    for m in _PYTHON_M.finditer(text):
        if m.group(1) in ("pytest",):
            continue
        if not _module_exists(m.group(1)):
            missing.append((m.group(1), "python -m"))
    return missing


def main() -> int:
    failed = False
    for name, heading in DOCS:
        doc = ROOT / name
        text = section(doc.read_text(), heading) if doc.exists() else ""
        where = name if heading is None else f"{name} ({heading.lstrip('# ')})"
        if not text:
            print(f"MISSING DOC: {where}")
            failed = True
            continue
        missing = check(doc, text)
        for ref, kind in missing:
            print(f"{where}: dangling {kind} reference `{ref}`")
        failed = failed or bool(missing)
        if not missing:
            print(f"{where}: OK")
    if failed:
        print("DOCS LINT FAILED")
        return 1
    print("DOCS LINT OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
