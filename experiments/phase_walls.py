"""Time each phase of a ``chip_smoke.py`` run from its output, so that two
checkouts (say a commit and its parent) can be compared phase by phase
in one call on the card.

    python experiments/phase_walls.py --dir CHECKOUT [--json PATH] \
        [--log PATH] [--record PATH]

Runs ``python3 -u chip_smoke.py [--json RECORD]`` in ``CHECKOUT``,
stamps every line of its standard output with the seconds since the
start, and echoes it.  A
phase's lines start ``[N]`` or ``[Na]``; phases print as they finish, so
a phase is charged from the last line of the phase before it to its own
last line (the first phase from the start).  Writes the return code,
the total seconds and the seconds per phase, in the order they appeared,
to ``--json``, and the stamped output to ``--log``.  Exits with the
smoke's return code.
"""

import argparse
import json
import re
import subprocess
import sys
import time
from pathlib import Path

LABEL = re.compile(r"^\[(\d+)[a-z]?\]")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", required=True, help="the checkout to run")
    ap.add_argument("--json", help="write the phase walls here")
    ap.add_argument("--log", help="write the stamped output here")
    ap.add_argument("--record", help="the smoke writes its record here")
    args = ap.parse_args()
    smoke = [sys.executable, "-u", "chip_smoke.py"]
    if args.record:
        smoke += ["--json", str(Path(args.record).resolve())]
    t0 = time.perf_counter()
    proc = subprocess.Popen(smoke,
                            cwd=args.dir, stdout=subprocess.PIPE, text=True)
    last: dict = {}                     # phase -> seconds of its last line
    stamped = []
    for line in proc.stdout:
        t = time.perf_counter() - t0
        stamped.append(f"{t:9.2f} {line}")
        print(stamped[-1], end="", flush=True)
        m = LABEL.match(line)
        if m:
            last.pop(m.group(1), None)  # keep the order of last lines
            last[m.group(1)] = t
    rc = proc.wait()
    total = time.perf_counter() - t0
    walls, before = {}, 0.0
    for label, t in last.items():
        walls[label] = round(t - before, 2)
        before = t
    result = {"dir": args.dir, "rc": rc, "total_s": round(total, 2),
              "phase_s": walls}
    print(json.dumps(result))
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(result, indent=1))
    if args.log:
        Path(args.log).parent.mkdir(parents=True, exist_ok=True)
        Path(args.log).write_text("".join(stamped))
    return rc


if __name__ == "__main__":
    sys.exit(main())
