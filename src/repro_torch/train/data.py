"""Synthetic-token data pipeline (counterpart of
:mod:`repro.train.data`): deterministic, prefetching, numpy.

Produces {tokens, labels} batches: labels = next-token shift with the
final position masked (-1).  Deterministic per (seed, step), so a
restart resumes mid-epoch without state files.  For enc-dec / VLM archs
the batch carries the stub frontend features.  The batches are numpy
arrays, ``==`` the reference's; the train loop moves them to the card.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np

from ..models.config import ModelConfig


@dataclass(frozen=True)
class DataConfig:
    seq_len: int
    global_batch: int
    seed: int = 0


def synth_batch(cfg: ModelConfig, dc: DataConfig, step: int) -> Dict[str, np.ndarray]:
    """Deterministic synthetic batch for a given step (restart-safe)."""
    rng = np.random.default_rng(np.uint64(dc.seed * 1_000_003 + step))
    b, l = dc.global_batch, dc.seq_len
    # skewed zipf-ish ids exercise the embedding like real text
    toks = (rng.zipf(1.3, size=(b, l)) % cfg.vocab_size).astype(np.int32)
    labels = np.concatenate([toks[:, 1:], np.full((b, 1), -1, np.int32)], axis=1)
    out = {"tokens": toks, "labels": labels}
    if cfg.is_encdec:
        frames = max(1, l // 4)
        out["encoder_feats"] = rng.standard_normal(
            (b, frames, cfg.d_model)).astype(np.float32) * 0.02
    if cfg.family == "vlm":
        out["vision_embeds"] = rng.standard_normal(
            (b, cfg.frontend_seq, cfg.d_model)).astype(np.float32) * 0.02
    return out


def batch_iterator(
    cfg: ModelConfig, dc: DataConfig, start_step: int = 0,
    prefetch: int = 2,
) -> Iterator[Dict[str, np.ndarray]]:
    """Background-thread prefetching iterator (host-side overlap)."""
    q: "queue.Queue" = queue.Queue(maxsize=prefetch)
    stop = threading.Event()

    def producer():
        step = start_step
        while not stop.is_set():
            q.put(synth_batch(cfg, dc, step))
            step += 1

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            yield q.get()
    finally:
        stop.set()


def input_dtypes(cfg: ModelConfig) -> Dict[str, str]:
    d = {"tokens": "int32", "labels": "int32"}
    if cfg.is_encdec:
        d["encoder_feats"] = "float32"
    if cfg.family == "vlm":
        d["vision_embeds"] = "float32"
    return d
