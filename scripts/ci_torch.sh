#!/usr/bin/env bash
# CI gate of the PyTorch port (src/repro_torch), on the CPU: collection,
# the port's parity tests, the ladder split over CPU positions (slow cases
# included), the compiler gates, the coverage floor and the docs lint,
# every example with --device cpu, and the card's smoke where nvidia-smi
# finds a card.
#
# Run from the repo root:  bash scripts/ci_torch.sh
#
# It replaces nothing in scripts/ci.sh (the JAX package's gate).
# telemetry_quickstart.py writes its two exports to /tmp, as its
# reference does; here they are sent to a temporary directory, whose
# trace check_trace.py then reads.  train_lm.py runs in a temporary
# directory too, because it writes experiments/ under its working
# directory.

set -euo pipefail
cd "$(dirname "$0")/.."

root="$PWD"
export PYTHONPATH="$root/src${PYTHONPATH:+:$PYTHONPATH}"
# the parity tests hold the port against the JAX package on the CPU
export JAX_PLATFORMS="${JAX_PLATFORMS:-cpu}"
# keep the tracked .hypothesis/ example database untouched
export HYPOTHESIS_STORAGE_DIRECTORY="${HYPOTHESIS_STORAGE_DIRECTORY:-${TMPDIR:-/tmp}/hypothesis_torch}"

echo "== collection (all modules must import) =="
python -m pytest --collect-only -q >/dev/null

echo "== the port's parity tests (tests/test_torch_*.py; card cases skip) =="
python -m pytest -x -q tests/test_torch_*.py

echo "== the ladder split across devices: chip, channel and rank over meshes of CPU positions, the forced-device subprocesses included =="
# the port's counterpart of ci.sh's forced-host-device steps: a mesh
# names the CPU 2, 4 or 8 times, and the slow cases run each tier split
# in a fresh process against the sequential drain
python -m pytest -x -q -m "" tests/test_torch_pum_sharded.py

echo "== μProgram validation on the port (16 ops, MIG + AIG, DRAM oracle) =="
python scripts/check_uprograms_torch.py

echo "== μProgram compaction gate on the port (≤ activations, bit-exact) =="
python scripts/check_compaction_torch.py

echo "== core coverage floor on the port (src/repro_torch/core, settrace or pytest-cov) =="
# exits non-zero when line coverage of the port's core modules over the
# bounded core test selection drops below the ratcheting floor (see
# scripts/check_coverage_torch.py); about 6 minutes here
python scripts/check_coverage_torch.py

echo "== docs lint on the port (README's port section, examples_torch/README.md) =="
python scripts/check_docs_torch.py

echo "== the port's examples on the CPU =="
work="$(mktemp -d)"
trap 'rm -rf "$work"' EXIT
for ex in examples_torch/*.py; do
    case "$(basename "$ex")" in
        train_lm.py|telemetry_quickstart.py) continue ;;
    esac
    echo "-- $ex"
    python "$ex" --device cpu >/dev/null
done
echo "-- examples_torch/telemetry_quickstart.py (exports to a temporary directory)"
python - "$root/examples_torch/telemetry_quickstart.py" "$work" <<'PY' >/dev/null
import runpy, sys
from pathlib import Path
from repro_torch import obs
example, work = sys.argv[1], Path(sys.argv[2])
for fn in ("write_chrome_trace", "write_jsonl"):
    orig = getattr(obs, fn)
    setattr(obs, fn, lambda path, *a, _f=orig, **k:
            _f(str(work / Path(path).name), *a, **k))
sys.argv = [example, "--device", "cpu"]
runpy.run_path(example, run_name="__main__")
PY
python scripts/check_trace.py "$work/simdram_trace.json"
echo "-- examples_torch/train_lm.py (2 steps, in a temporary directory)"
(cd "$work" && python "$root/examples_torch/train_lm.py" --device cpu \
    --steps 2 --seq_len 64 --batch 2 >/dev/null)

if command -v nvidia-smi >/dev/null 2>&1 && nvidia-smi -L >/dev/null 2>&1; then
    echo "== chip_smoke.py on the card =="
    python chip_smoke.py
else
    echo "== chip_smoke.py skipped: nvidia-smi finds no card =="
fi

echo "CI TORCH OK"
