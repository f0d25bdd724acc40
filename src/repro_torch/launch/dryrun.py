"""Multi-pod dry run: trace every (arch × shape × mesh) cell on the meta
device (counterpart of :mod:`repro.launch.dryrun`).

    python -m repro_torch.launch.dryrun --arch internvl2-1b \
        --shape decode_32k --mesh multi [--out DIR]

For each cell this:
  1. builds the params, optimizer state, batch and caches on ``meta``
     (shapes and dtypes, no storage),
  2. applies the sharding rules (:mod:`repro_torch.distributed.sharding`)
     on the cell's mesh (abstract: the production meshes do not exist on
     the port's one-card machine),
  3. runs the train, prefill or decode step on those tensors, at full
     depth, under ``torch.utils.flop_counter.FlopCounterMode``,
  4. traces the partitioned program of mesh position 0
     (:mod:`repro_torch.distributed.partition`; a train cell's,
     :mod:`~repro_torch.distributed.partition_train`, runs its backward
     and the optimizer too) on ``meta`` over that position's shards
     (every position's shards have the same shapes, so one stands for
     all), counting
     - ``collective_bytes``: its collectives, by the reference's five
       kinds and their total, in the reference's ring accounting
       (:class:`~repro_torch.distributed.partition.CollectiveLedger`);
     - ``bytes_per_device``: over every aten op the position dispatches,
       its tensor inputs' and outputs' bytes (:class:`DeviceBytes`; a
       view moves nothing and counts nothing, an output written in place
       into an input counts once);
     - ``memory.peak_bytes``: the most bytes live at once on the
       position, each storage from the op that makes it until its last
       tensor goes, a view's storage once, the arguments throughout;
     - ``memory.temp_bytes``: that peak less the argument and output
       bytes,
  5. records the counted FLOPs per device, these fields and the
     per-device argument and output bytes summed from the specs, into
     ``--out`` (default ``build/dryrun_torch/``; never the reference's
     ``experiments/``).

The port loops over the layers in Python, so the counters see every
layer, and the reference's depth calibration (compile depth 1 and 2 and
extrapolate, because XLA counts a scan body once) is not needed:
``depth_calibrated`` is False, ``flops_per_device_raw`` equals
``flops_per_device`` and ``collective_bytes_raw`` ``collective_bytes``.
``flops_per_device`` stays the unpartitioned step's count over the
devices.  Every cell the unpartitioned step traces is partitioned and
filled: the encoder-decoder's, the serving levers (``--quantize``,
``--kvint8``, ``--kvpad``), ``moe_impl="dense"``, SSD heads or conv
channels that divide neither way over ``model`` (computed whole at each
``model`` rank) and a train cell's uneven microbatch rows.  In a train
cell under ``remat="dots"`` the recompute's all-gathers count again, as
XLA's re-gathers of the FSDP backward do.
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback
import weakref
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from ..configs import ARCHS, cell_is_supported, get_config
from ..distributed import sharding as shd
from ..distributed.partition import CollectiveLedger, Dist, partitioned_step
from ..models.config import SHAPES_BY_NAME, ModelConfig, ShapeSpec
from ..models.params import tree_map
from ..models.transformer import init_caches, init_lm
from ..train import optimizer as opt
from ..train.serve import make_prefill, make_serve_step
from ..train.train_loop import make_train_step
from .mesh import Mesh, make_production_mesh

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "build",
                       "dryrun_torch")
META = torch.device("meta")

NOT_MEASURED = {
    "depth_calibrated": "not needed: every layer of the Python loop is "
                        "counted",
}
class DeviceBytes(TorchDispatchMode):
    """What one position's program touches and holds, over the aten ops
    it dispatches: ``accessed`` sums each op's tensor inputs' and
    outputs' bytes (a view op moves nothing and counts nothing; an
    output that is one of the op's inputs, written in place, counts
    once); ``peak`` is the most bytes live at once, each storage from
    the op that makes it until its last tensor goes, a view's storage
    once, the storages of ``arguments`` live from the start."""

    def __init__(self, arguments=()):
        super().__init__()
        self.accessed = 0
        self.live = 0
        self._storages: Dict[int, list] = {}
        self._tracked: set = set()
        for t in arguments:
            self._track(t)
        self.peak = self.live

    def _track(self, t: torch.Tensor) -> None:
        if id(t) in self._tracked:
            return
        storage = t.untyped_storage()
        key = storage._cdata
        entry = self._storages.get(key)
        if entry is None:
            entry = self._storages[key] = [0, storage.nbytes()]
            self.live += entry[1]
        entry[0] += 1
        self._tracked.add(id(t))
        weakref.finalize(t, self._release, id(t), key)

    def _release(self, tid: int, key: int) -> None:
        self._tracked.discard(tid)
        entry = self._storages[key]
        entry[0] -= 1
        if entry[0] == 0:
            del self._storages[key]
            self.live -= entry[1]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = [t for t in pytree.tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        outs = [t for t in pytree.tree_leaves(out)
                if isinstance(t, torch.Tensor)]
        view = any(r.alias_info is not None and not r.alias_info.is_write
                   for r in func._schema.returns)
        if not view:
            self.accessed += sum(_nbytes(t) for t in ins) + sum(
                _nbytes(t) for t in outs if not any(t is i for i in ins))
        for t in outs:
            self._track(t)
        self.peak = max(self.peak, self.live)
        return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


# ---------------------------------------------------------------------------
# input specs (meta tensors, no allocation)
# ---------------------------------------------------------------------------

def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, torch.Tensor]:
    b, l = shape.global_batch, shape.seq_len
    i32, f32, bf16 = torch.int32, torch.float32, torch.bfloat16
    if shape.kind == "train":
        out = {"tokens": _meta((b, l), i32), "labels": _meta((b, l), i32)}
        if cfg.is_encdec:
            out["encoder_feats"] = _meta((b, max(1, l // 4), cfg.d_model), f32)
        if cfg.family == "vlm":
            out["vision_embeds"] = _meta((b, cfg.frontend_seq, cfg.d_model),
                                         f32)
        return out
    if shape.kind == "prefill":
        out = {"tokens": _meta((b, l), i32)}
        if cfg.is_encdec:
            out["encoder_feats"] = _meta((b, max(1, l // 4), cfg.d_model),
                                         bf16)
        if cfg.family == "vlm":
            out["vision_embeds"] = _meta((b, cfg.frontend_seq, cfg.d_model),
                                         bf16)
        return out
    # decode: one new token against a seq_len cache
    out = {"token": _meta((b,), i32), "pos": _meta((b,), i32)}
    if cfg.is_encdec:
        out["memory"] = _meta((b, max(1, l // 4), cfg.d_model), bf16)
    return out


def _eval_shapes(cfg: ModelConfig, shape: ShapeSpec):
    """Params / opt state / caches on meta."""
    params_s = init_lm(cfg, device=META)
    opt_s = opt.init(params_s) if shape.kind == "train" else None
    caches_s = None
    if shape.kind == "decode":
        caches_s = init_caches(cfg, shape.global_batch, shape.seq_len,
                               device=META)
    return params_s, opt_s, caches_s


# ---------------------------------------------------------------------------
# cell tracing
# ---------------------------------------------------------------------------

@dataclass
class Lowered:
    """One traced cell: the FLOPs counted over its step, and its
    arguments and outputs, each a (tree, shardings) pair."""

    flops: int
    args: List[Tuple[Any, Any]]
    outs: List[Tuple[Any, Any]]
    partitioned: Optional[Dict] = None


def _lower_one(cfg, shape, mesh, remat, n_microbatches, unroll=False,
               policy="2d", quantize=False) -> Tuple[Lowered, float]:
    """Trace one configuration on meta; returns (lowered, trace seconds)."""
    params_s, opt_s, caches_s = _eval_shapes(cfg, shape)
    if quantize and shape.kind != "train":
        from ..models.quantized import quantize_tree
        params_s = quantize_tree(params_s)
    ins = input_specs(cfg, shape)

    t0 = time.time()
    with mesh, FlopCounterMode(display=False) as counter:
        p_shard = shd.param_shardings(params_s, mesh, policy)
        if shape.kind == "train":
            o_shard = shd.opt_shardings(opt_s, params_s, mesh, policy)
            b_shard = shd.batch_shardings(ins, mesh, policy)
            step = make_train_step(cfg, opt.AdamWConfig(),
                                   n_microbatches=n_microbatches, remat=remat,
                                   unroll=unroll)
            new_p, new_o, metrics = step(params_s, opt_s, ins)
            rep = shd.replicated(mesh)
            args = [(params_s, p_shard), (opt_s, o_shard), (ins, b_shard)]
            outs = [(new_p, p_shard), (new_o, o_shard),
                    (metrics, tree_map(lambda _: rep, metrics))]
            fn = step
            part = ((p_shard, o_shard, b_shard), (p_shard, o_shard, None),
                    (params_s, opt_s, ins), {})
        elif shape.kind == "prefill":
            b_shard = shd.batch_shardings(ins, mesh, policy)
            fn = make_prefill(cfg, remat=remat, unroll=unroll)
            # by keyword: the reference passes the inputs by position,
            # which hands a VLM's vision_embeds to encoder_feats, where
            # its prefill drops them
            logits = fn(params_s, **ins)
            args = [(params_s, p_shard), (ins, b_shard)]
            outs = [(logits, shd.logits_sharding(mesh, shape.global_batch))]
            part = ((p_shard, b_shard["tokens"], b_shard.get("encoder_feats"),
                     b_shard.get("vision_embeds")), outs[0][1],
                    (params_s,), ins)
        else:  # decode
            c_shard = shd.cache_shardings(caches_s, mesh)
            vec = shd.vector_sharding(mesh, shape.global_batch)
            fn = make_serve_step(cfg, unroll=unroll)
            mem = ins.get("memory")
            args = [(params_s, p_shard), (caches_s, c_shard),
                    (ins["token"], vec), (ins["pos"], vec)]
            if mem is not None:
                args.append((mem, shd.batch_shardings({"m": mem}, mesh)["m"]))
            logits, caches = fn(params_s, caches_s, ins["token"], ins["pos"],
                                memory=mem)
            outs = [(logits, shd.logits_sharding(mesh, shape.global_batch)),
                    (caches, c_shard)]
            part = (tuple(s for _, s in args), (outs[0][1], c_shard),
                    (params_s, caches_s, ins["token"], ins["pos"]),
                    {} if mem is None else {"memory": mem})
    lowered = Lowered(counter.get_total_flops(), args, outs)
    lowered.partitioned = _trace_position(fn, *part)
    return lowered, time.time() - t0


def _trace_position(fn, in_sh, out_sh, args, kwargs) -> Dict:
    """Mesh position 0's partitioned program traced on meta: its
    collective bytes, bytes accessed and peak live bytes."""
    step = partitioned_step(fn, in_sh, out_sh)
    local = step.local_arguments(*args, **kwargs)
    leaves = [t for d in pytree.tree_leaves(
        local, is_leaf=lambda x: isinstance(x, Dist)) for t in d.vals]
    with CollectiveLedger() as ledger, DeviceBytes(leaves) as counter:
        step.run_position(local)
    return {"colls": ledger.totals(), "bytes": counter.accessed,
            "peak": counter.peak}


def _measure(lowered: Lowered, n_devices: int) -> Dict:
    def total(pairs):
        return sum(shd.shard_bytes(t, s) for t, s in pairs)

    args, outs = total(lowered.args), total(lowered.outs)
    part = lowered.partitioned
    return {
        "flops": lowered.flops / n_devices,
        "bytes": float(part["bytes"]),
        "colls": part["colls"],
        "memory": {
            "argument_bytes": args,
            "output_bytes": outs,
            "temp_bytes": part["peak"] - args - outs,
            "peak_bytes": part["peak"],
        },
    }


def lower_cell(
    arch: str,
    shape_name: str,
    multi_pod: bool = False,
    remat: str = "dots",
    n_microbatches: int = 1,
    variant: str = "base",
    cfg_override: Optional[ModelConfig] = None,
    policy: str = "2d",
    quantize: bool = False,
    mesh: Optional[Mesh] = None,
) -> Dict:
    """Trace a cell at full depth on the production mesh (or ``mesh``)."""
    cfg = cfg_override or get_config(arch)
    shape = SHAPES_BY_NAME[shape_name]
    if not cell_is_supported(cfg, shape):
        return {"arch": arch, "shape": shape_name, "skipped": True,
                "reason": "long_500k needs sub-quadratic mixing (DESIGN.md)"}

    mesh = mesh if mesh is not None else make_production_mesh(
        multi_pod=multi_pod)
    lowered, trace_s = _lower_one(cfg, shape, mesh, remat, n_microbatches,
                                  policy=policy, quantize=quantize)
    full = _measure(lowered, mesh.size)
    return {
        "arch": arch,
        "shape": shape_name,
        "variant": variant,
        "mesh": "x".join(str(n) for n in mesh.shape.values()),
        "n_devices": mesh.size,
        "compile_s": round(trace_s, 1),
        "flops_per_device": full["flops"],
        "bytes_per_device": full["bytes"],
        "collective_bytes": full["colls"],
        "flops_per_device_raw": full["flops"],
        "collective_bytes_raw": full["colls"],
        "depth_calibrated": False,
        "memory": full["memory"],
        "params": cfg.param_count(),
        "active_params": cfg.param_count(active_only=True),
        "tokens": shape.global_batch * (1 if shape.is_decode else shape.seq_len),
        "kind": shape.kind,
        "skipped": False,
        "not_measured": dict(NOT_MEASURED),
    }


def save_result(res: Dict, out_dir: str = OUT_DIR) -> str:
    os.makedirs(out_dir, exist_ok=True)
    tag = f"{res['arch']}_{res['shape']}_{res['mesh']}"
    if res.get("variant", "base") != "base":
        tag += f"_{res['variant']}"
    path = os.path.join(out_dir, tag + ".json")
    with open(path, "w") as f:
        json.dump(res, f, indent=1)
    return path


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--remat", default="dots")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--variant", default="base")
    ap.add_argument("--policy", default="2d", choices=["2d", "dp", "dp2", "serve"])
    ap.add_argument("--quantize", action="store_true",
                    help="int8 weight-only quantization (serve cells)")
    ap.add_argument("--kvpad", type=int, default=0,
                    help="replicate kv heads to this count for decode")
    ap.add_argument("--moe", default=None, choices=["grouped", "ep"],
                    help="MoE dispatch implementation override")
    ap.add_argument("--kvint8", action="store_true",
                    help="int8 KV cache for decode cells")
    ap.add_argument("--ssmchunk", type=int, default=0,
                    help="SSD chunk size override")
    ap.add_argument("--out", default=OUT_DIR)
    args = ap.parse_args()

    cells = []
    archs = list(ARCHS) if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES_BY_NAME) if (args.all or not args.shape) else [args.shape]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    for a in archs:
        for s in shapes:
            for mp in meshes:
                cells.append((a, s, mp))

    n_ok = n_skip = n_fail = 0
    for a, s, mp in cells:
        tag = f"{a} × {s} × {'2x16x16' if mp else '16x16'}"
        try:
            cfg_o = None
            if args.kvpad or args.moe or args.kvint8 or args.ssmchunk:
                kw = {}
                if args.ssmchunk:
                    kw["ssm_chunk"] = args.ssmchunk
                if args.kvpad:
                    kw["kv_head_pad"] = args.kvpad
                if args.moe:
                    kw["moe_impl"] = args.moe
                if args.kvint8:
                    kw["kv_cache_dtype"] = "int8"
                cfg_o = get_config(a).replace(**kw)
            res = lower_cell(a, s, multi_pod=mp, remat=args.remat,
                             n_microbatches=args.microbatches,
                             variant=args.variant, policy=args.policy,
                             quantize=args.quantize, cfg_override=cfg_o)
            if res.get("skipped"):
                n_skip += 1
                print(f"[skip] {tag}: {res['reason']}")
            else:
                n_ok += 1
                path = save_result(res, args.out)
                colls = res["collective_bytes"]
                print(f"[ ok ] {tag}: trace={res['compile_s']}s "
                      f"flops/dev={res['flops_per_device']:.3e} "
                      f"args/dev={res['memory']['argument_bytes']}B "
                      f"collectives/dev="
                      f"{'-' if colls is None else int(colls['total'])}B "
                      f"peak/dev={res['memory']['peak_bytes']}B -> {path}")
        except Exception as e:  # noqa: BLE001
            n_fail += 1
            print(f"[FAIL] {tag}: {type(e).__name__}: {e}")
            traceback.print_exc(limit=3)
    print(f"\ndryrun: ok={n_ok} skip={n_skip} fail={n_fail}")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
