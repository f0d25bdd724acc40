"""Atomic, content-hashed, restart-safe checkpointing (counterpart of
:mod:`repro.train.checkpoint`, in its on-disk format).

Layout:  <dir>/step_<N>/
            manifest.json        step, meta, per-leaf shape, dtype, sha1
            shard_0.npz          the tree's leaves, leaf_<i>

- leaves are numbered in ``jax.tree.flatten``'s order (dict keys
  sorted; an ``OptState`` as step, mu, nu), so a checkpoint written by
  either package restores in the other;
- bf16 leaves are stored as their uint16 bits with a ``bfloat16`` tag,
  and read back through a torch view (no ``ml_dtypes``);
- atomic: writes go to step_<N>.tmp then os.rename (POSIX atomic) — a
  crash mid-save never corrupts the latest checkpoint;
- content-hashed: restore verifies each leaf's sha1 (bit-rot /
  truncation detection).  The leaves are hashed on worker threads
  (``hashlib`` releases the GIL) while the archive is written or read;
- async: ``save_async`` copies the tree to the host synchronously and
  writes it on a worker thread, letting the train loop overlap the I/O
  with the next step.

:func:`restore` takes a ``device``; :func:`reshard_restore` places each
leaf by its sharding on a mesh (the elastic remesh; on the port's
one-device host mesh, every leaf whole on that device).
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..kernels.build import resolve_device
from ..models.params import flatten, unflatten


def _to_numpy_storable(x) -> Tuple[np.ndarray, str]:
    """npz can't store bfloat16 — persist as a uint16 view + dtype tag."""
    t = torch.as_tensor(x).detach().cpu()
    dtype_name = str(t.dtype).removeprefix("torch.")
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), dtype_name
    return t.numpy(), dtype_name


def _from_numpy_storable(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _sha1(arr: np.ndarray) -> str:
    """sha1 of the array's bytes in C order (``arr.tobytes()``'s)."""
    return hashlib.sha1(np.ascontiguousarray(arr)).hexdigest()


def save(ckpt_dir: str, step: int, tree: Any, meta: Optional[Dict] = None) -> str:
    stored = {}
    dtypes = {}
    for i, leaf in enumerate(flatten(tree)):
        stored[f"leaf_{i}"], dtypes[f"leaf_{i}"] = _to_numpy_storable(leaf)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    with ThreadPoolExecutor() as pool:
        sha1 = {k: pool.submit(_sha1, v) for k, v in stored.items()}
        np.savez(os.path.join(tmp, "shard_0.npz"), **stored)
        manifest = {
            "step": step,
            "meta": meta or {},
            "leaves": {
                k: {
                    "shape": list(v.shape),
                    "dtype": dtypes[k],
                    "sha1": sha1[k].result(),
                }
                for k, v in stored.items()
            },
        }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


_pending: Dict[str, threading.Thread] = {}


def save_async(ckpt_dir: str, step: int, tree: Any, meta=None) -> None:
    host_tree = unflatten(tree, [torch.as_tensor(x).detach().to(
        "cpu", copy=True) for x in flatten(tree)])      # sync device_get
    t = threading.Thread(target=save, args=(ckpt_dir, step, host_tree, meta))
    t.start()
    _pending[ckpt_dir] = t


def wait_pending(ckpt_dir: str) -> None:
    t = _pending.pop(ckpt_dir, None)
    if t:
        t.join()


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int, tree_like: Any, verify: bool = True,
            device="cuda") -> Any:
    """Restore into the structure of ``tree_like`` (shapes must match):
    tensors of its leaves' dtypes on ``device``."""
    dev = resolve_device(device)
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    out, sha1 = [], []
    with np.load(os.path.join(path, "shard_0.npz")) as data, \
            ThreadPoolExecutor() as pool:
        for i, ref in enumerate(flatten(tree_like)):
            arr = data[f"leaf_{i}"]
            entry = manifest["leaves"][f"leaf_{i}"]
            if verify:
                sha1.append((i, entry["sha1"], pool.submit(_sha1, arr)))
            t = _from_numpy_storable(arr, entry["dtype"])
            if tuple(t.shape) != tuple(ref.shape):
                raise ValueError(f"leaf_{i} shape {tuple(t.shape)} != "
                                 f"{tuple(ref.shape)}")
            out.append(t.to(device=dev, dtype=ref.dtype))
        for i, want, got in sha1:
            if want != got.result():
                raise IOError(f"checkpoint leaf_{i} hash mismatch (corrupt)")
    return unflatten(tree_like, out)


def reshard_restore(ckpt_dir: str, step: int, tree_like: Any,
                    shardings: Any) -> Any:
    """Restore + place each leaf with the given sharding (elastic remesh),
    see :func:`repro_torch.distributed.sharding.place`."""
    from ..distributed.sharding import place
    return place(restore(ckpt_dir, step, tree_like, device="cpu"), shardings)
