"""The port's compiler mirrored from the reference's tests: the cases
that compile 16- and 32-bit multiplication and division.

``tests/test_uprogram.py``'s ``test_simdram_beats_ambit_on_arithmetic``
and ``test_rowhammer_bound``, ``test_shift_and_csa.py``'s
``test_csa_popcount_beats_ripple_budget`` and ``test_eval_models.py``'s
``test_wider_ops_are_slower``, on the port's compiler (the rest of those
files' mirrors are in ``test_torch_compiler_mirror.py``).  The claims
are checked on the port's programs; that those programs are the
reference's is held elsewhere: every 16-bit command table byte for byte
in ``tests/test_torch_compiler.py`` and ``test_torch_compiler_wide_*.py``
(the reference compiling them again here would double the time).
"""

from test_torch_examples_core import one_torch_thread  # noqa: F401
from repro_torch.core import timing
from repro_torch.core.isa import compile_op


def test_simdram_beats_ambit_on_arithmetic():
    """The paper's core claim: MAJ/NOT programs need fewer activations."""
    for name in ("addition", "subtraction", "multiplication", "division",
                 "greater", "max"):
        _, up_sd = compile_op(name, 16, "mig")
        _, up_am = compile_op(name, 16, "aig")
        assert up_sd.n_activations < up_am.n_activations, name


def test_rowhammer_bound():
    """No row is activated more than 8 times in a row (paper §4)."""
    for name in ("multiplication", "division"):
        _, up = compile_op(name, 16, "mig")
        streak, prev, worst = 0, None, 0
        for c in up.commands:
            rows = {c.src[0], c.dst[0]} if c.kind == "AAP" else set()
            if prev is not None and prev & rows:
                streak += 1
                worst = max(worst, streak)
            else:
                streak = 0
            prev = rows
        assert worst <= 8, (name, worst)


def test_wider_ops_are_slower():
    for name in ("addition", "multiplication"):
        l8, l16, l32 = (timing.uprogram_latency_s(compile_op(name, w)[1])
                        for w in (8, 16, 32))
        assert l8 < l16 < l32, name


def test_csa_popcount_beats_ripple_budget():
    for n, budget in ((8, 200), (16, 420), (32, 850)):
        _, up = compile_op("bitcount", n, "mig")
        assert up.n_activations <= budget, (n, up.n_activations)
