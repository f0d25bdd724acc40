"""The port's compiler gates against the reference's, on the CPU.

``scripts/check_uprograms_torch.py`` and ``check_compaction_torch.py``
beside ``scripts/check_uprograms.py`` and ``check_compaction.py``: both
pass, and their printed tables equal line for line, the compaction
gate's measured seconds masked.  The reference's compaction gate (about
35 s of pure Python) runs in a subprocess while the port's runs here, so
the case takes the time of one.  (A file of its own: with the two
sweeps, ``test_torch_examples_core.py`` would pass 150 s on one worker.)
"""

import os
import subprocess
import sys

from test_torch_examples_core import (ROOT, assert_same_lines, capture, load,
                                      one_torch_thread)  # noqa: F401

SCRIPTS = ROOT / "scripts"


def test_check_uprograms_torch_equals_reference():
    """All 16 ops, MIG and AIG, at 8 bits on 192 lanes: the same AAP, AP,
    activation and scratch counts, both exact on the DRAM oracle."""
    ref, _ = capture(load(SCRIPTS / "check_uprograms.py",
                          "reference_check_uprograms").main)
    port, _ = capture(load(SCRIPTS / "check_uprograms_torch.py",
                           "port_check_uprograms").main)
    assert port.splitlines()[-1] == "ALL UPROGRAMS CORRECT (8-bit, 192 lanes)"
    assert_same_lines(ref, port)


def test_check_compaction_torch_equals_reference():
    """The default sweep (92 cases): the same activation counts before
    and after compaction, every case exact, both gates exit 0."""
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]),
        "JAX_PLATFORMS": "cpu"}
    ref = subprocess.Popen(
        [sys.executable, str(SCRIPTS / "check_compaction.py")], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        port, rc_port = capture(load(SCRIPTS / "check_compaction_torch.py",
                                     "port_check_compaction").main)
    finally:
        out, err = ref.communicate(timeout=600)
    assert ref.returncode == 0, err
    assert rc_port == 0
    assert port.startswith("COMPACTION OK: 92 cases bit-exact")
    assert_same_lines(out, port, subs=[(r", \d+s$", ", *s")])
