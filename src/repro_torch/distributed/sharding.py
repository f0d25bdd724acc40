"""Sharding rules: 2-D (FSDP x TP) parameter layout + EP for MoE
(counterpart of :mod:`repro.distributed.sharding`, the rules unchanged).

Mesh axes:
  single-pod: ("data", "model") = (16, 16)
  multi-pod : ("pod", "data", "model") = (2, 16, 16)

DATA = ("pod","data") — the combined FSDP/batch axes.  Every large matrix
is sharded BOTH ways: its "parallel" dim on `model` (tensor parallelism:
heads / ffn-hidden / vocab / experts) and the other dim on DATA (FSDP
storage sharding).  MoE expert stacks shard experts on `model` (expert
parallelism).  Norm gains / scalar vectors replicate.

Every desired axis passes through a divisibility fit (`_fit`): if a dim
doesn't divide by the requested axis product, the rule degrades gracefully
(tuple → shorter tuple → replicated).  This is what lets ONE rule set
serve a batch-1 500k-decode cell and a batch-256 train cell, kv-head
counts below the TP degree, and hymba's 50 SSD heads, without per-arch
special cases.  Vocab dims are pre-padded in the model (config.vocab_padded).

The rules are pure functions (key path, leaf) -> :class:`P` over the
port's trees (nested dicts under the reference's key paths, an
:class:`~repro_torch.train.optimizer.OptState`), so the same tree serves
params, grads and both Adam moments; caches/batches have their own rule
sets.  A :class:`Sharding` gives a leaf's per-device shard shape and
bytes, which the dry run (:mod:`repro_torch.launch.dryrun`) sums, and
``Sharding.indices`` the slices each mesh position holds (the
reference's ``devices_indices_map``).

:func:`place` lays a tree out on a mesh with devices, in one process:
on a mesh of one device every leaf goes whole onto it; on a mesh of
more each leaf becomes a :class:`Sharded`, one shard a position on that
position's device (positions may repeat a device: ``cpu`` repeated in
the tests, ``cuda:0`` repeated on one card).  :func:`gather` gives the
whole tensors back, and :func:`sharded_step` is the counterpart of
``jax.jit`` with ``in_shardings``/``out_shardings``.
"""

from __future__ import annotations

import itertools
import math
from dataclasses import dataclass
from typing import (Any, Callable, List, Mapping, Optional, Sequence, Tuple,
                    Union)

import torch

from ..launch.mesh import Mesh

Axis = Union[None, str, Tuple[str, ...]]


class P(tuple):
    """A partition spec (the reference's ``PartitionSpec``): one entry per
    leading dim of a tensor, each None (whole), a mesh axis name, or a
    tuple of names (split over the product of their sizes); dims past
    its length are whole."""

    def __new__(cls, *entries: Axis) -> "P":
        return super().__new__(cls, entries)

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self) -> str:
        return "P(" + ", ".join(map(repr, self)) + ")"


def abstract_mesh(axis_sizes: Sequence[int], axis_names: Sequence[str]) -> Mesh:
    """A mesh of shapes only (no devices)."""
    return Mesh(axis_sizes, axis_names)


def data_axes(mesh: Mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def _axis_size(mesh: Mesh, axis: Axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, str):
        return mesh.shape[axis]
    return math.prod(mesh.shape[a] for a in axis)


def _fit(mesh: Mesh, dim: int, want: Axis) -> Axis:
    """Largest prefix of `want` whose size divides `dim` (None if none)."""
    if want is None:
        return None
    cands = [want]
    if isinstance(want, tuple):
        # try dropping leading axes: ('pod','data') -> ('data',)
        for i in range(1, len(want)):
            cands.append(want[i:])
    cands.append(None)
    for c in cands:
        if c is None:
            return None
        if dim % _axis_size(mesh, c) == 0:
            return c if not (isinstance(c, tuple) and len(c) == 1) else c[0]
    return None


def fit_spec(mesh: Mesh, shape: Sequence[int], *want: Axis) -> P:
    if len(shape) != len(want):
        raise ValueError(f"{len(want)} axes for shape {tuple(shape)}")
    return P(*[_fit(mesh, d, w) for d, w in zip(shape, want)])


def _names(path) -> list:
    return [str(k) for k in path]


@dataclass(frozen=True)
class Sharding:
    """A leaf's layout on ``mesh`` (the reference's ``NamedSharding``)."""

    mesh: Mesh
    spec: P

    def shard_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        """The shape of one device's shard of a tensor of ``shape``."""
        out = list(shape)
        for i, ax in enumerate(self.spec):
            n = _axis_size(self.mesh, ax)
            if out[i] % n:
                raise ValueError(f"dim {i} of {tuple(shape)} does not divide "
                                 f"over {ax!r} ({n})")
            out[i] //= n
        return tuple(out)

    def shard_bytes(self, leaf: torch.Tensor) -> int:
        """Bytes of one device's shard of ``leaf``."""
        return math.prod(self.shard_shape(leaf.shape)) * leaf.element_size()

    def indices(self, shape: Sequence[int]) -> List[Tuple[slice, ...]]:
        """The slices of a tensor of ``shape`` that each mesh position
        holds, one tuple a position in row-major order (the order of
        ``mesh.devices``): the reference's ``devices_indices_map``.  A
        dim split over a tuple of axes numbers its parts with the first
        axis major; positions that differ only along axes the spec does
        not name hold the same slices."""
        sub = self.shard_shape(shape)
        names = self.mesh.axis_names
        out = []
        for coords in itertools.product(*(range(self.mesh.shape[a])
                                          for a in names)):
            at = dict(zip(names, coords))
            idx = []
            for i, n in enumerate(shape):
                ax = self.spec[i] if i < len(self.spec) else None
                part = 0
                for a in (() if ax is None else
                          (ax,) if isinstance(ax, str) else ax):
                    part = part * self.mesh.shape[a] + at[a]
                idx.append(slice(part * sub[i], (part + 1) * sub[i]))
            out.append(tuple(idx))
        return out


def tree_map_with_path(fn: Callable, tree, path: tuple = ()):
    """``fn(path, leaf)`` over nested dicts and tuples (an ``OptState``),
    ``path`` the keys (and tuple field names) down to the leaf."""
    if isinstance(tree, Mapping):
        return {k: tree_map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map_with_path(fn, v, path + (f,))
                            for f, v in zip(tree._fields, tree)))
    return fn(path, tree)


def shard_bytes(tree, shardings) -> int:
    """Per-device bytes of a tree laid out by ``shardings``."""
    if isinstance(tree, Mapping):
        return sum(shard_bytes(tree[k], shardings[k]) for k in tree)
    if isinstance(tree, tuple):
        return sum(shard_bytes(t, s) for t, s in zip(tree, shardings))
    return shardings.shard_bytes(tree)


# parents whose dense 'w' has its OUTPUT dim model-parallel
_COL_PARALLEL = {"q", "k", "v", "up", "gate", "in_proj_z", "in_proj_xbc",
                 "out", "frontend_proj"}
# parents whose dense 'w' has its INPUT dim model-parallel
_ROW_PARALLEL = {"o", "down", "out_proj"}
# tiny projections that replicate their output dim
_REPLICATED_OUT = {"in_proj_dt"}


def param_spec(path, leaf, mesh: Mesh) -> P:
    names = _names(path)
    DATA = data_axes(mesh)
    stacked = any(n in ("blocks", "enc_blocks") for n in names)
    pre: Tuple[Axis, ...] = (None,) if stacked else ()
    shape = leaf.shape[len(pre):]
    name = names[-1] if names else ""
    parent = names[-2] if len(names) > 1 else ""
    nd = len(shape)

    def fs(*want: Axis) -> P:
        return fit_spec(mesh, leaf.shape, *(pre + want))

    # int8-quantized weights: w_q follows the projection's 'w' rule; the
    # per-output-channel scale follows the weight's LAST-dim sharding
    if name in ("w_q", "scale"):
        proj = parent
        container = names[-3] if len(names) > 2 else ""
        if name == "scale":
            if proj in ("up", "gate") and (container == "moe" or nd == 2):
                return fs("model", None)          # (E, f)
            if proj == "down" and (container == "moe" or nd == 2):
                return fs("model", DATA)          # (E, d)
            if proj in _COL_PARALLEL:
                return fs("model")
            if proj in _ROW_PARALLEL:
                return fs(DATA)
            return fs(*([None] * nd))
        name, parent = (proj if nd == 3 else "w"), (container if nd == 3 else proj)

    if name == "emb":
        return fs("model", None)
    if name in ("g", "a_log", "d_skip", "dt_bias", "conv_b"):
        return fs(*([None] * nd))
    if name == "conv_w":
        return fs(None, "model")
    if name == "router":
        return fs(None, None)
    if parent == "moe" or nd == 3:
        # stacked expert weights (E, d, f) / (E, f, d): EP on model
        if name in ("up", "gate"):
            return fs("model", DATA, None)
        if name == "down":
            return fs("model", None, DATA)
        return fs("model", None, None)
    if nd == 2:
        if parent in _COL_PARALLEL:
            return fs(DATA, "model")
        if parent in _ROW_PARALLEL:
            return fs("model", DATA)
        if parent in _REPLICATED_OUT:
            return fs(DATA, None)
        return fs(*([None] * nd))
    if nd == 1:
        if parent in _COL_PARALLEL:
            return fs("model")
        return fs(None)
    return fs(*([None] * nd))


def param_spec_dp(path, leaf, mesh: Mesh) -> P:
    """Pure-FSDP (ZeRO-3) layout: no tensor parallelism — every param's
    largest dimension is sharded across ALL mesh axes; activations are
    batch-sharded across all axes too.  Embeddings and the readout stay
    vocab-TP (the vocab table is often the largest tensor)."""
    names = _names(path)
    stacked = any(n in ("blocks", "enc_blocks") for n in names)
    pre: Tuple[Axis, ...] = (None,) if stacked else ()
    shape = leaf.shape[len(pre):]
    if not shape:
        return P(*pre)
    name = names[-1] if names else ""
    parent = names[-2] if len(names) > 1 else ""
    if name == "emb":
        return fit_spec(mesh, leaf.shape, *(pre + ("model", None)))
    if parent == "out" and name in ("w", "w_q"):
        return fit_spec(mesh, leaf.shape, *(pre + (None, "model")))
    if parent == "out" and name == "scale":
        return fit_spec(mesh, leaf.shape, *(pre + ("model",)))
    ALL = tuple(mesh.axis_names)
    # shard the largest divisible dim over all axes (degrade via _fit)
    order = sorted(range(len(shape)), key=lambda i: -shape[i])
    want: list = [None] * len(shape)
    for i in order:
        ax = _fit(mesh, shape[i], ALL)
        if ax is not None and _axis_size(mesh, ax) == _axis_size(mesh, ALL):
            want[i] = ax
            break
    else:
        for i in order:                      # partial sharding fallback
            ax = _fit(mesh, shape[i], ALL)
            if ax is not None:
                want[i] = ax
                break
    return P(*(pre + tuple(want)))


def _strip_data_axes(spec: P, mesh: Mesh) -> P:
    """Replace DATA axes with replication (serve policy: weights stay
    resident, TP-sharded only — no per-step FSDP re-gathers at decode)."""
    drop = set(data_axes(mesh))

    def clean(s):
        if s is None:
            return None
        if isinstance(s, str):
            return None if s in drop else s
        kept = tuple(a for a in s if a not in drop)
        return kept if len(kept) > 1 else (kept[0] if kept else None)

    return P(*[clean(s) for s in spec])


def param_spec_dp2(path, leaf, mesh: Mesh) -> P:
    """ZeRO-2-style: small block weights fully REPLICATED, embeddings
    vocab-TP, optimizer state sharded (see opt_shardings)."""
    names = _names(path)
    name = names[-1] if names else ""
    parent = names[-2] if len(names) > 1 else ""
    stacked = any(n in ("blocks", "enc_blocks") for n in names)
    pre: Tuple[Axis, ...] = (None,) if stacked else ()
    nd = leaf.dim() - len(pre)
    if name == "emb":
        return fit_spec(mesh, leaf.shape, *(pre + ("model", None)))
    if parent == "out" and name in ("w", "w_q"):
        return fit_spec(mesh, leaf.shape, *(pre + (None, "model")))
    return P(*(pre + (None,) * nd))


def param_shardings(params_like: Any, mesh: Mesh, policy: str = "2d") -> Any:
    spec_fn = {"dp": param_spec_dp, "dp2": param_spec_dp2}.get(policy, param_spec)

    def one(path, leaf):
        spec = spec_fn(path, leaf, mesh)
        if policy == "serve":
            spec = _strip_data_axes(spec, mesh)
        return Sharding(mesh, spec)

    return tree_map_with_path(one, params_like)


def opt_shardings(opt_state_like: Any, params_like: Any, mesh: Mesh,
                  policy: str = "2d") -> Any:
    """OptState(step, mu, nu): moments mirror the param layout — except
    under dp2 (ZeRO-2), where moments stay fully sharded while params
    replicate."""
    from ..train.optimizer import OptState
    moment_policy = "dp" if policy == "dp2" else policy
    ps = param_shardings(params_like, mesh, moment_policy)
    return OptState(step=replicated(mesh), mu=ps, nu=ps)


def batch_shardings(batch_like: Any, mesh: Mesh, policy: str = "2d") -> Any:
    DATA = (tuple(mesh.axis_names) if policy in ("dp", "dp2")
            else data_axes(mesh))

    def spec(path, leaf):
        want = (DATA,) + (None,) * (leaf.dim() - 1)
        return Sharding(mesh, fit_spec(mesh, leaf.shape, *want))

    return tree_map_with_path(spec, batch_like)


def cache_shardings(caches_like: Any, mesh: Mesh) -> Any:
    """Stacked caches (L, B, ...): batch on DATA, heads on model — with
    divisibility fallback (kv groups < TP degree shard head_dim instead)."""
    DATA = data_axes(mesh)

    def spec(path, leaf):
        names = _names(path)
        name = names[-1] if names else ""
        s = leaf.shape
        if name in ("k", "v"):                 # (L,B,S,G,hd)
            g_ax = _fit(mesh, s[3], "model")
            hd_ax = _fit(mesh, s[4], "model") if g_ax is None else None
            return Sharding(mesh, fit_spec(
                mesh, s, None, DATA, None, g_ax, hd_ax))
        if name in ("k_scale", "v_scale"):      # (L,B,S,G)
            g_ax = _fit(mesh, s[3], "model")
            return Sharding(mesh, fit_spec(mesh, s, None, DATA, None, g_ax))
        if name == "ssm":                       # (L,B,H,N,P)
            h_ax = _fit(mesh, s[2], "model")
            p_ax = _fit(mesh, s[4], "model") if h_ax is None else None
            return Sharding(mesh, fit_spec(
                mesh, s, None, DATA, h_ax, None, p_ax))
        if name == "conv":                      # (L,B,K-1,C)
            return Sharding(mesh, fit_spec(mesh, s, None, DATA, None, "model"))
        return Sharding(mesh, P(*([None] * leaf.dim())))

    return tree_map_with_path(spec, caches_like)


def logits_sharding(mesh: Mesh, batch: int) -> Sharding:
    DATA = data_axes(mesh)
    return Sharding(mesh, fit_spec(mesh, (batch, 1 << 30), DATA, "model"))


def vector_sharding(mesh: Mesh, batch: int) -> Sharding:
    DATA = data_axes(mesh)
    return Sharding(mesh, fit_spec(mesh, (batch,), DATA))


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, P())


class Sharded:
    """A tensor laid out by ``sharding`` over a mesh with devices (what
    ``jax.device_put(x, NamedSharding)`` gives): ``shards[k]`` is the
    slice ``sharding.indices(shape)[k]`` of the whole, on the device of
    mesh position ``k``, a tensor of its own (replicated axes hold
    copies).  :meth:`gather` gives the whole tensor back."""

    def __init__(self, shape: Sequence[int], dtype: torch.dtype,
                 sharding: Sharding, shards: Sequence[torch.Tensor]):
        self.shape = torch.Size(shape)
        self.dtype = dtype
        self.sharding = sharding
        self.shards = tuple(shards)
        if len(self.shards) != sharding.mesh.size:
            raise ValueError(f"{len(self.shards)} shards for a mesh of "
                             f"{sharding.mesh.size}")

    def gather(self, device) -> torch.Tensor:
        """The whole tensor on ``device``, each distinct slice copied
        once."""
        out = torch.empty(self.shape, dtype=self.dtype, device=device)
        seen = set()
        for idx, part in zip(self.sharding.indices(self.shape), self.shards):
            key = tuple((s.start, s.stop) for s in idx)
            if key not in seen:
                seen.add(key)
                out[idx].copy_(part)
        return out

    def __repr__(self) -> str:
        return (f"Sharded({tuple(self.shape)}, {self.dtype}, "
                f"{self.sharding.spec!r} on {self.sharding.mesh!r})")


def shard(x: torch.Tensor, sharding: Sharding) -> Sharded:
    """``x`` cut by ``sharding``: each position's slice copied onto its
    device (the inverse of :meth:`Sharded.gather`)."""
    mesh = sharding.mesh
    if mesh.abstract:
        raise ValueError(f"cannot shard onto {mesh!r}: it has no devices")
    return Sharded(x.shape, x.dtype, sharding, [
        x[idx].to(device=torch.device(dev), copy=True,
                  memory_format=torch.contiguous_format)
        for idx, dev in zip(sharding.indices(x.shape), mesh.devices)])


def _sharding_at(shardings, path) -> Optional[Sharding]:
    s = shardings
    for k in path:
        if s is None:
            break
        s = s[k] if isinstance(s, Mapping) else getattr(s, k)
    return s


def place(tree: Any, shardings: Any) -> Any:
    """Each leaf laid out by its sharding (a leaf whose sharding is None
    stays as it is).  On a mesh of one device the leaf goes whole onto
    it; on a mesh of more it becomes a :class:`Sharded` (a
    :class:`Sharded` leaf is gathered and cut anew: the elastic
    remesh); an abstract mesh raises."""

    def one(path, leaf):
        s = _sharding_at(shardings, path)
        if s is None:
            return leaf
        mesh = s.mesh
        if mesh.abstract:
            raise ValueError(
                f"cannot place {'.'.join(map(str, path))} on {mesh!r}: it "
                "has no devices")
        home = torch.device(mesh.devices[0])
        whole = leaf.gather(home) if isinstance(leaf, Sharded) else leaf
        if mesh.size == 1:
            return whole.to(home)
        return shard(whole, s)

    return tree_map_with_path(one, tree)


def gather(tree: Any, device) -> Any:
    """Every leaf whole on ``device``: :class:`Sharded` leaves gathered,
    tensors moved."""
    dev = torch.device(device)
    return tree_map_with_path(
        lambda _, leaf: leaf.gather(dev) if isinstance(leaf, Sharded)
        else leaf.to(dev), tree)


def _first_sharding(tree) -> Optional[Sharding]:
    if isinstance(tree, Sharding):
        return tree
    if isinstance(tree, Mapping):
        tree = tuple(tree.values())
    if isinstance(tree, tuple):
        for t in tree:
            s = _first_sharding(t)
            if s is not None:
                return s
    return None


def sharded_step(fn: Callable, in_shardings: tuple,
                 out_shardings: tuple) -> Callable:
    """``fn`` over a mesh with devices, as ``jax.jit(fn,
    in_shardings=..., out_shardings=...)`` runs it: each call takes the
    arguments laid out by ``in_shardings`` (:class:`Sharded` leaves, or
    whole tensors) and returns the outputs laid out by
    ``out_shardings`` (an entry of None leaves that output whole).

    This shards storage, not compute: the arguments are gathered onto
    the first device of the mesh, ``fn`` runs there once, and its
    outputs are cut onto the mesh by :func:`place`.  So a sharded step
    gives exactly what ``fn`` gives on that device.  Tensor- and
    data-parallel compute over several cards is not ported (the card's
    machine has one H100)."""
    s = _first_sharding(tuple(in_shardings))
    if s is None or s.mesh.abstract:
        raise ValueError("sharded_step needs a Sharding over a mesh with "
                         "devices among its in_shardings")
    home = torch.device(s.mesh.devices[0])

    def run(*args):
        if len(args) != len(in_shardings):
            raise ValueError(f"{len(args)} arguments for "
                             f"{len(in_shardings)} in_shardings")
        out = fn(*(gather(a, home) for a in args))
        return tuple(place(o, sh) for o, sh in zip(out, out_shardings))

    return run
