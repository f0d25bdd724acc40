"""The port's LM examples against the reference's, on the CPU.

``pum_offload_demo.py``, ``serve_llm.py`` and ``train_lm.py`` (at
``--steps 2 --seq_len 64 --batch 2``), each run in-process beside its
reference from a temporary working directory.  The port's side runs the
reference's own weights: the reference's ``init_lm`` is wrapped to keep
what it drew, and ``main(params=...)`` gets it through
``params_from_numpy``.  Outputs are compared line for line with measured
walls masked; logits, tokens and losses go by these rules:

- float32 logits (``pum_offload_demo``'s PuM LM) within rtol = atol =
  1e-3 (``PERF.md`` §2);
- bfloat16 logits (``serve_llm``'s and ``chip_offload_quickstart``'s
  smoke yi-6b, the examples' own dtype) within ``BF16_REL`` = 4e-2 of
  each row's max|logit|, ``PERF.md`` §2's bf16 rule: the two packages
  sum bf16 products in different orders, 1.3e-2 of max|logit| measured
  here at most;
- greedy tokens ``==`` step by step while the reference's top-1/top-2
  margin exceeds twice the tolerance; past a token taken at a smaller
  margin the two decode different prefixes and are compared no further;
- ``train_lm``'s losses (bf16 params, AdamW eps set to 1e-3 in both
  packages, as ``tests/test_torch_train_step.py`` does) within rtol =
  ``TRAIN_RTOL`` = 1e-3: 1.2e-4 of the loss measured here; the same
  steps in float32 agree within 2.1e-7, so the gap is bf16's rounding
  of the weights and products, not the loop.
"""

import dataclasses
import functools

import numpy as np
import pytest

from test_torch_examples_core import (assert_same_lines, in_tmp,  # noqa: F401
                                      lines, one_torch_thread, run_port,
                                      run_reference)

LM_TOL = 1e-3
BF16_REL = 4e-2
TRAIN_RTOL = 1e-3


def record_reference_lm(monkeypatch):
    """Wrap the reference's ``init_lm`` (what it drew; also where
    ``repro.launch.train`` imported it) and ``Server`` (each step's
    logits, float32): the dict they fill."""
    import repro.launch.train as ref_train
    import repro.models.transformer as ref_tf
    import repro.train.serve as ref_serve
    rec = {"params": [], "logits": []}
    init0, server0 = ref_tf.init_lm, ref_serve.Server.__init__

    def init_lm(*args, **kwargs):
        rec["params"].append(init0(*args, **kwargs))
        return rec["params"][-1]

    def server_init(self, *args, **kwargs):
        server0(self, *args, **kwargs)
        step = self.step_fn

        def recording(*a, **k):
            lg, caches = step(*a, **k)
            rec["logits"].append(np.asarray(lg, np.float32))
            return lg, caches
        self.step_fn = recording

    monkeypatch.setattr(ref_tf, "init_lm", init_lm)
    monkeypatch.setattr(ref_train, "init_lm", init_lm)
    monkeypatch.setattr(ref_serve.Server, "__init__", server_init)
    return rec


def port_params(ref_params):
    import jax

    from repro_torch.models.params import params_from_numpy
    return params_from_numpy(jax.tree.map(np.asarray, ref_params), "cpu")


def logits_close(got, want, rel=None, tol=LM_TOL) -> float:
    """``got`` within ``rel`` of each row's max|want| (bf16), else within
    rtol = atol = ``tol``: the largest error relative to its bound."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want)
    if rel is not None:
        bound = rel * np.abs(want).max(-1, keepdims=True)
    else:
        bound = tol + tol * np.abs(want)
    assert (err <= bound).all(), f"largest error {err.max():.3e}"
    return float((err / bound).max())


def decode_agrees(got_steps, want_steps, rel) -> bool:
    """Step by step: logits within ``rel`` of each row's max|logit| and
    greedy tokens ``==`` at every row whose reference margin exceeds
    twice that.  True if every step's tokens agree; False if a token
    was taken at a smaller margin (the decodes part there, and the rest
    is not compared)."""
    assert len(got_steps) >= 1
    for g, w in zip(got_steps, want_steps):
        logits_close(g, w, rel=rel)
        top2 = np.sort(w, -1)[..., -2:]
        margin = top2[..., 1] - top2[..., 0]
        thr = 2 * rel * np.abs(w).max(-1)
        differ = np.argmax(g, -1) != np.argmax(w, -1)
        assert not (differ & (margin > thr)).any(), (margin, thr)
        if differ.any():
            return False
    assert len(got_steps) == len(want_steps)
    return True


def test_pum_offload_demo(in_tmp, monkeypatch):
    """Every line equal (the offload sweep and transposition cost are
    modeled); the PuM LM's logits within 1e-3 of the reference's on its
    weights, its relu a bbop per layer on the CPU's plain circuit."""
    import repro.models.transformer as ref_tf
    rec = record_reference_lm(monkeypatch)
    forwards = []
    fwd0 = ref_tf.lm_forward

    def lm_forward(*args, **kwargs):
        forwards.append(fwd0(*args, **kwargs))
        return forwards[-1]

    monkeypatch.setattr(ref_tf, "lm_forward", lm_forward)
    ref, _ = run_reference("pum_offload_demo")
    port, out = run_port("pum_offload_demo",
                         params=port_params(rec["params"][0]))
    assert_same_lines(ref, port)
    logits_close(out["lm"]["logits"], forwards[0][0])
    want = np.asarray(forwards[0][0], np.float32)
    top2 = np.sort(want, -1)[..., -2:]
    held = top2[..., 1] - top2[..., 0] > 2 * LM_TOL
    assert (np.argmax(out["lm"]["logits"], -1) == np.argmax(want, -1))[held].all()


def test_serve_llm(in_tmp, monkeypatch):
    """The served line equal but its wall, tok/s and device name; each
    request's tokens under the margin rule (bf16 logits)."""
    rec = record_reference_lm(monkeypatch)
    ref, _ = run_reference("serve_llm")
    port, out = run_port("serve_llm", params=port_params(rec["params"][0]))
    subs = [(r" in [\d.]+s \([\d.]+ tok/s on .*\)$", " in *s (* tok/s)")]
    same_tokens = decode_agrees(out["lm"]["logits"], rec["logits"], BF16_REL)
    drop = [] if same_tokens else [r"^  req\d+: "]
    assert_same_lines(ref, port, subs=subs, drop=drop)
    assert out["results"] == {"done": 6, "tokens": 48}


def test_train_lm(in_tmp, monkeypatch):
    """``--steps 2 --seq_len 64 --batch 2`` from the reference's weights:
    the same lines but the measured times; the losses within
    ``TRAIN_RTOL`` of the reference's (AdamW eps 1e-3 in both)."""
    import repro.launch.train as ref_train
    import repro.train.optimizer as ref_opt
    import repro_torch.launch.train as port_train
    import repro_torch.train.optimizer as port_opt
    monkeypatch.setattr(ref_train.opt, "AdamWConfig",
                        functools.partial(ref_opt.AdamWConfig, eps=1e-3))
    monkeypatch.setattr(port_train.opt, "AdamWConfig",
                        functools.partial(port_opt.AdamWConfig, eps=1e-3))
    rec = record_reference_lm(monkeypatch)
    logs = []

    def keep_logs(mod):
        train0 = mod.train

        def train(*args, **kwargs):
            out = train0(*args, **kwargs)
            logs.extend(r["loss"] for r in out["logs"])
            return out
        mod.train = train

    argv = ["--steps", "2", "--seq_len", "64", "--batch", "2"]
    ref, _ = run_reference("train_lm", argv, patch=keep_logs)
    (in_tmp / "experiments").rename(in_tmp / "reference_experiments")
    port, out = run_port("train_lm", argv,
                         params=port_params(rec["params"][0]))
    np.testing.assert_allclose(out["lm"]["losses"], logs, rtol=TRAIN_RTOL,
                               atol=0)
    assert len(logs) == 2 and np.isfinite(logs).all()
    subs = [(r"loss [\d.]+  [\d.]+s/step$", "loss *  *s/step"),
            (r"^loss: [\d.]+ -> [\d.]+ \(\d+s total\)$", "loss: * -> *")]
    assert_same_lines(ref, port, subs=subs)
    assert (in_tmp / "experiments" / "train_log_100m.jsonl").is_file()
