"""The SSM mixer (Mamba-2's SSD) of the partitioned program: each
position computes its share of :func:`~repro_torch.models.ssm.ssm_forward`
on its own shards, with explicit collectives.

Like :mod:`~repro_torch.distributed.partition`, this module stands in
for what GSPMD does under the reference's shardings
(``repro.distributed.sharding``): ``in_proj_z`` and ``in_proj_xbc`` are
column-parallel over ``model``, ``in_proj_dt`` replicates its output,
``conv_w`` has its channels on ``model``, ``out_proj`` is row-parallel,
and ``a_log``, ``d_skip``, ``dt_bias``, ``conv_b`` and the gated norm's
gain are replicated; a dim that does not divide over ``model`` is left
whole (the reference's ``_fit``).  The decode state keeps
:func:`~repro_torch.distributed.sharding.cache_shardings`' layout: the
``ssm`` state ``(B, H, N, P)`` split by heads where they divide
``model`` (:func:`ssm_mode` ``"heads"``), else by the head dim ``P``
(``"p"``), else whole (``"full"``), and the ``conv`` state by channels
where they divide (:func:`conv_split`), else whole.  The conv's layout
and the SSD's are chosen apart: hymba-1.5b over 64 model ranks splits
its SSD by ``P`` and keeps its 3,232 conv channels whole.

- **The conv channels do not follow heads.**  The conv's channel axis is
  ``[x | B | C]`` (``d_inner + 2N``).  Where it divides ``model`` it is
  cut contiguously: each position projects and convolves its own slice
  of it (a depthwise conv, so its slice of the ``conv`` state is all it
  reads and writes), then the slices are all-gathered (backward: the
  reduce-scatter, or each position's own part where the SSD after it is
  whole).  Otherwise every position projects and convolves all of them
  from ``in_proj_xbc``, ``conv_w`` and its ``conv`` state held whole.
  Each position then takes ``B`` and ``C`` whole and the ``x`` of its
  own heads (or its ``P`` slice of every head, or every head).
- **The scan** (:func:`~repro_torch.models.ssm.ssd_chunked` for prefill
  and train, the one-token recurrence for decode) runs on the position's
  heads or ``P`` slice: both are independent there.  ``dt`` is projected
  for the position's heads only (``"heads"``) or whole (``"p"``,
  ``"full"``).
- **In the ``"p"`` layout** ``z`` and ``out_proj`` are relaid to the
  position's ``P`` slice of every head: their whole weights are
  gathered and the matching columns (rows) taken, as attention's
  ``head_dim`` split does.
- **In the ``"full"`` layout** every position computes the whole SSD of
  its rows, as attention's ``"full"`` mode does: ``dt``, ``a_log``,
  ``d_skip``, ``z``, the gated norm and ``out_proj`` from weights
  gathered whole over ``model`` (their backward each position's own
  part, ``copies``), the output whole with no ``model`` all-reduce.
- **The gated RMSNorm** normalizes over the whole ``d_inner``: where the
  SSD splits, each position's sum of squares over its channels is
  all-reduced over ``model`` in float32 (*g*), and, since each position
  then normalizes only its channels, goes through ``partition.enter``
  (*f*) so that its cotangent sums the ranks'.
- Every value whole over ``model`` that enters computation split over it
  (the rows ``h``; ``in_proj_dt``, the replicated vectors and the norm's
  gain where the SSD splits; the whole convolved channels where the conv
  is whole and the SSD splits) goes through ``enter``
  (``_Program.fetch(..., split=True)`` for a leaf), so its gradient is
  summed over ``model``; over the DATA axes the train step sums it as
  any other leaf.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from ..models.layers import dense, rmsnorm
from ..models.ssm import _causal_conv, ssd_chunked
from . import partition as part
from .partition import _axes


def ssm_mode(cfg, tp: int) -> str:
    """How the SSD splits over ``tp`` model ranks (``cache_shardings``'
    layout of its state): by heads where they divide, else by the head
    dim ``P``, else not at all (``"full"``)."""
    if tp == 1 or cfg.ssm_heads % tp == 0:
        return "heads"
    return "p" if cfg.ssm_head_dim % tp == 0 else "full"


def conv_split(cfg, tp: int) -> bool:
    """Whether the conv channels ``d_inner + 2N`` split over ``tp``
    model ranks (``conv_w``'s and the ``conv`` state's layout); else
    every rank convolves them all."""
    return tp > 1 and (cfg.d_inner + 2 * cfg.ssm_state) % tp == 0


def _p_columns(cfg, tp: int, rank: int, device) -> torch.Tensor:
    """The ``d_inner`` channels (head-major, ``h·P + p``) of model rank
    ``rank``'s ``P`` slice of every head."""
    pd = cfg.ssm_head_dim
    d = pd // tp
    own = torch.arange(rank * d, (rank + 1) * d, device=device)
    return (torch.arange(cfg.ssm_heads, device=device)[:, None] * pd
            + own[None, :]).reshape(-1)


def _mean_square(prog, y: list) -> list:
    """Each position's mean of ``y²`` over the whole ``d_inner``: its
    float32 sum over its own channels, all-reduced over ``model`` (*g*)
    and entering the split normalization (*f*)."""
    local = prog.map(lambda t: torch.sum(torch.square(t.to(torch.float32)),
                                         dim=-1, keepdim=True), y)
    total = prog.enter(prog.model_sum(local))
    n = prog.cfg.d_inner
    return prog.map(lambda s: s / n, total)


def mixer(prog, p: dict, h: list, caches: list
          ) -> Tuple[list, Optional[List[dict]]]:
    """The SSM mixer of ``prog`` (a ``partition._Program``) on each
    position's rows ``h`` (whole over ``model``): its output (whole over
    ``model``, as the row-parallel ``out_proj``'s all-reduce gives it,
    or as every rank computes it in the ``"full"`` layout) and, for
    decode (``caches`` each position's ``{"conv", "ssm"}`` shards of
    this layer), each position's new state shards."""
    cfg, pos = prog.cfg, prog.pos
    di, n, nh, pd = (cfg.d_inner, cfg.ssm_state, cfg.ssm_heads,
                     cfg.ssm_head_dim)
    tp, M = prog.tp, prog.M
    mode = ssm_mode(cfg, tp)
    split_conv = conv_split(cfg, tp)
    split_ssd = tp > 1 and mode != "full"
    entered = prog.enter(h) if split_conv or split_ssd else h
    h_conv = entered if split_conv else h
    h_ssd = entered if split_ssd else h
    cax = M if split_conv else None
    hax = M if mode == "heads" else None

    # conv channels: each position's own slice (then gathered), or all
    xbc = prog.dense(p["in_proj_xbc"], h_conv, None, cax)
    state = [None if c is None else c["conv"] for c in caches]
    convolved = prog.map(_causal_conv, xbc,
                         prog.fetch(p["conv_w"], None, cax),
                         prog.fetch(p["conv_b"], cax), state)
    whole = [c[0] for c in convolved]
    if split_conv:
        whole = part.all_gather(pos, whole, _axes(M), 2,
                                copies=not split_ssd)
    elif split_ssd:
        whole = prog.enter(whole)

    dt = prog.map(dense, prog.local(p["in_proj_dt"], None, hax,
                                    split=split_ssd), h_ssd)
    dt = prog.map(lambda t, bias: F.softplus(t.to(torch.float32)
                                             + bias[None, None, :]),
                  dt, prog.fetch(p["dt_bias"], hax, split=split_ssd))
    a_log = prog.fetch(p["a_log"], hax, split=split_ssd)
    d_skip = prog.fetch(p["d_skip"], hax, split=split_ssd)
    if mode == "heads":
        z = prog.dense(p["in_proj_z"], h_ssd, None, hax)
        gain = prog.fetch(p["norm"]["g"], hax, split=split_ssd)
        w_out = prog.wfetch(p["out_proj"], hax, None)
    elif mode == "p":
        cols = [_p_columns(cfg, tp, prog.rank(k), t.device)
                for k, t in zip(pos.ks, h)]
        z = prog.map(lambda pz, x, c: dense(part._cols(pz, c), x),
                     prog.local(p["in_proj_z"], None, None, split=True),
                     h_ssd, cols)
        gain = prog.map(lambda g, c: g[c], prog.fetch(
            p["norm"]["g"], None, split=True), cols)
        w_out = prog.map(part._rows, prog.wfetch(
            p["out_proj"], None, None, split=True), cols)
    else:
        z = prog.dense(p["in_proj_z"], h, None, None)
        gain = prog.fetch(p["norm"]["g"], None)

    def scan(xbc_whole, k, dt, a_log, d_skip, c):
        b, l, _ = xbc_whole.shape
        xs, bmat, cmat = torch.split(xbc_whole, [di, n, n], dim=-1)
        xh = xs.reshape(b, l, nh, pd)
        r = prog.rank(k)
        if mode == "heads":
            hl = nh // tp
            xh = xh[:, :, r * hl:(r + 1) * hl]
        elif mode == "p":
            pl = pd // tp
            xh = xh[..., r * pl:(r + 1) * pl]
        if c is None:
            y, _ = ssd_chunked(xh, bmat, cmat, dt, a_log, cfg.ssm_chunk)
            new = None
        else:
            dec = torch.exp(dt * (-torch.exp(a_log))[None, None, :])
            db_x = torch.einsum("bln,blh,blhp->bhnp", bmat,
                                dt.to(bmat.dtype), xh)
            new = c["ssm"] * dec[:, 0, :, None, None] + db_x.to(torch.float32)
            y = torch.einsum("bln,bhnp->blhp", cmat, new.to(cmat.dtype))
        y = y + xh * d_skip.to(xh.dtype)[None, None, :, None]
        return y.flatten(2), new

    scanned = prog.map(scan, whole, list(pos.ks), dt, a_log, d_skip, caches)
    y = prog.map(lambda t, zz: t[0] * F.silu(zz), scanned, z)
    eps = cfg.norm_eps
    if split_ssd:
        ms = _mean_square(prog, y)
        y = prog.map(lambda t, s, g: (t.to(torch.float32)
                                      * torch.rsqrt(s + eps)
                                      * g.to(torch.float32)).to(t.dtype),
                     y, ms, gain)
        out = prog.row(p["out_proj"], y, w_out)
    else:
        y = prog.map(lambda t, g: rmsnorm({"g": g}, t, eps), y, gain)
        out = prog.dense(p["out_proj"], y, None, None)
    if caches[0] is None:
        return out, None
    return out, [{"conv": c[1], "ssm": s[1]}
                 for c, s in zip(convolved, scanned)]
