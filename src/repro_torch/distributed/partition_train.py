"""The train step partitioned over a device mesh: forward, backward, the
global gradient norm and AdamW, one program a mesh position.

Like :mod:`~repro_torch.distributed.partition`, this module has no
file-for-file counterpart in the reference: it stands in for what GSPMD
does under ``jax.jit(make_train_step(...), in_shardings=(ps, os_, bs),
out_shardings=(ps, os_, None))``.  ``partition.partitioned_step`` of a
step of :func:`~repro_torch.train.train_loop.make_train_step` returns a
:class:`PartitionedTrainStep`, whose program each position runs on its
own shards of the params, the optimizer state and the batch:

- **microbatches in the reference's order**: the reference cuts the
  global batch into ``n_microbatches`` contiguous slices, each split
  over the DATA axes.  A position's rows of the batch are not its rows
  of those slices, so the batch is relayed once (:func:`relay`, one
  all-to-all over DATA) and microbatch ``i`` of each position is its
  share of the reference's microbatch ``i``.  Where a microbatch's rows
  do not divide over the data parts, the first ``rows % parts`` parts
  take one row more (:func:`shares`; a part may take none, and still
  joins every collective); where the batch's rows do not divide either,
  ``batch_shardings`` leaves it whole or on fewer axes, and each
  position takes its shares from it gathered whole.  A batch that does
  not split into the microbatches raises ``ValueError``, as the
  reference's reshape does;
- **the forward** is the partitioned prefill's (``_Program``'s embed,
  norm, attention in its heads/qheads/hd modes with its sliding window,
  the SSM mixer of :mod:`~repro_torch.distributed.partition_ssm` beside
  or instead of it, MLP, the PuM MLP, an encoder-decoder's bidirectional
  encoder and cross-attention, readout) over every position of
  the sequence, with no cache, each
  block under ``remat`` as the port's ``train_loop`` runs it (per-block
  ``torch.utils.checkpoint``; ``"dots"`` saves the ``aten.mm``/``addmm``
  outputs).  A recompute re-runs its all-gathers and charges them again,
  as XLA's FSDP backward re-gathers;
- **the MoE FFN** routes every token at every ``model`` rank (a copy of
  the routing), dispatches the tokens to the rank's own experts and adds
  the ranks' partial outputs.  Grouped (``moe_impl="grouped"``), each
  position dispatches the whole microbatch (its rows all-gathered over
  DATA) with the whole microbatch's capacity; ``"ep"`` dispatches each
  data shard's rows alone, as the reference's ``shard_map`` does, whose
  aux is then data shard 0's (each position reports its own shard's).
  With the batch over other axes than the DATA axes, ``"ep"`` relays
  the rows to the DATA axes first (the ``shard_map``'s ``in_specs``),
  and its ranks' partials are reduce-scattered back over ``model``.
  ``"dense"`` runs each rank's experts over its own rows
  (``partition._Program.moe_dense``), the gradient reaching the router
  through the combine weights and the aux, which is the global batch's
  (its per-expert sums all-reduced over DATA) at every position.  With
  uneven rows ``"ep"`` dispatches the whole microbatch at every
  position, as the reference's ``shard_map`` does where the rows do not
  divide (the grouped path), and the gathered rows' reduce-scatter cuts
  the parts' uneven sizes;
- **the loss is vocab-parallel**: logits stay split over ``model``, each
  rank takes its log-sum-exp over its vocabulary slice, the ranks'
  values are all-gathered and combined in rank order, and the gold logit
  comes from the rank that holds it (a masked pick, then an all-reduce).
  Padded vocabulary entries get -1e30 on the rank that holds them; then
  the z-loss.  The mask count (``denom``) is all-reduced over DATA and
  the loss is the sum over DATA of each position's share: the ratio of
  global sums, whatever rows each position holds;
- **the backward** runs through autograd, each collective's backward its
  explicit transpose (see ``partition``'s docstring).  Every position
  seeds its copy of the loss with 1; over DATA a position's cotangents
  are partials of its rows, over ``model`` every rank's cotangent of a
  whole value is the whole one.  A leaf the layout does not split over a
  DATA axis (norm gains, biases, the router, a vocabulary split only
  over ``model``) goes through ``partition.enter`` over those axes
  (:func:`summed_axes`), so its gradient is summed over them and only
  them: over ``model`` its compute is duplicated, and the ranks' grads
  are copies.  A value computed whole by every position of a data group
  (the grouped MoE's aux) goes through ``partition.share``.  Gradients
  accumulate in float32 over the microbatches, as the reference's scan
  does;
- **the optimizer runs on shards**: each leaf's local sum of squares
  counts once (a leaf not split over an axis contributes from rank 0 of
  that axis only), the per-leaf sums go through one packed all-reduce
  and add up in the reference's leaf order; the clip scale, ``lr`` and
  the step are then the same at every position, and each position
  updates its own shards of the params, ``mu`` and ``nu`` (in the
  moments' layout, which ``"dp2"`` makes differ from the params');
- **a ``grad_transform``** sees what it sees under GSPMD, the logical
  whole gradients: each leaf is all-gathered whole at every position,
  the callable runs on the whole tree there (the same values at every
  position), the global norm is taken over every leaf it returned (a
  pair ``(grads, residuals)`` counts both, and its first leaves step the
  params, as the reference's ``update`` does) and each gradient is cut
  back to the moments' layout (:func:`transformed`).  A shard-wise
  application would differ: ``compressed_grad_transform`` quantizes each
  flattened leaf in blocks of 256, which a shard's cut does not keep.

Layouts: the batch splits over every DATA axis, and every other axis of
the mesh is ``model`` (tensor parallel) or also splits the batch
(``param_shardings``' ``"dp"``/``"dp2"``, whose program has no tensor
parallelism); a batch laid out otherwise (replicated, over some of the
DATA axes, over ``model``) is relaid to the DATA axes on entry.  An
encoder-decoder's memory enters each decoder block's cross-attention
through ``partition.enter`` over ``model``, so each block's partial
cotangents are all-reduced there, and the encoder's weights take the
decoder's FSDP gathers and their reduce-scatters.
"""

from __future__ import annotations

import functools
from typing import Callable, List, Optional, Tuple

import torch
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

from ..models import moe
from ..models.layers import _dtype
from ..models.params import flatten, tree_map, unflatten
from ..models.transformer import _save_products
from ..train import optimizer as opt
from . import partition as part
from . import sharding as shd
from .partition import Dist, Positions, _axes, _spec


def _leaves(tree) -> List[Dist]:
    """The leaves of a params tree of :class:`Dist` in ``flatten``'s
    order (keys sorted), the reference's leaf order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def _held(spec) -> set:
    return {a for e in spec for a in _axes(e)}


def summed_axes(prog: "_TrainProgram", spec) -> Tuple[str, ...]:
    """The axes over which a leaf laid out by ``spec`` has its gradient
    summed where it enters the step: the batch's axes that it is not
    split over (its copies there see other rows)."""
    held = _held(spec)
    return tuple(a for a in prog.bax if a not in held)


def shares(rows: int, nd: int) -> List[int]:
    """The rows of a microbatch of ``rows`` rows that each of ``nd``
    data parts takes, in part order: the first ``rows % nd`` parts one
    more than the others (a part may take none)."""
    return [rows // nd + (d < rows % nd) for d in range(nd)]


def _wanted(b: int, n_mb: int, nd: int, d: int) -> List[Tuple[int, int]]:
    """(first row, rows) of data part ``d``'s share of each of the
    reference's ``n_mb`` contiguous microbatches of a ``b``-row batch."""
    c = b // n_mb
    took = shares(c, nd)
    return [(i * c + sum(took[:d]), took[d]) for i in range(n_mb)]


def _take(parts: list, wanted: List[Tuple[int, int]]) -> torch.Tensor:
    """The rows of the ranges ``wanted`` ((first row, rows) of the global
    batch), in turn, from ``parts``: the batch cut into equal contiguous
    blocks in order."""
    s = parts[0].shape[0]
    pieces = [parts[0][:0]]
    for lo, n in wanted:
        while n:
            j, at = divmod(lo, s)
            take = min(n, s - at)
            pieces.append(parts[j].narrow(0, at, take))
            lo, n = lo + take, n - take
    return torch.cat(pieces)


def relay(pos: Positions, vals: list, axes: Tuple[str, ...],
          n_mb: int) -> list:
    """Batch rows laid out over ``axes`` (each position a contiguous
    block of the global batch), relayed so that each position holds its
    share of each of the reference's microbatches in turn (the shares
    of :func:`shares`, uneven where a microbatch's rows do not divide):
    one all-to-all over ``axes``."""
    nd = pos.size(axes)
    b = vals[0].shape[0] * nd
    if nd == 1 or n_mb == 1:
        return list(vals)
    return part._exchange(pos, vals, axes, "all-to-all", lambda parts, d:
                          _take(parts, _wanted(b, n_mb, nd, d)))


def _batch_axes(mesh, tokens: Dist) -> Tuple[str, ...]:
    """The axes the step splits the batch over: the tokens' where they
    hold every data axis and any other is ``model``, else the DATA axes
    (the batch is relaid to them)."""
    bax = _axes(tokens.spec[0])
    if not set(shd.data_axes(mesh)) <= set(bax) or \
            not set(mesh.axis_names) - set(bax) <= {"model"}:
        return shd.data_axes(mesh)
    return bax


def attention_mode(cfg, tp: int) -> str:
    """How the train step's attention splits over ``tp`` model ranks:
    as prefill's, by kv heads where they divide, else by query heads
    where they divide (there is no cache to keep in its layout), else by
    ``head_dim``."""
    mode = part._attention_mode(cfg, tp)
    return "qheads" if mode != "heads" and cfg.n_heads % tp == 0 else mode


class _TrainProgram(part._Program):
    """One partitioned train step's forward of ``cfg`` over ``pos``, the
    batch split over ``bax``."""

    def __init__(self, cfg, pos: Positions, bax: Tuple[str, ...],
                 remat: str):
        super().__init__(cfg, pos)
        mesh = pos.mesh
        self.bax = bax
        self.M = "model" if "model" in mesh.axis_names and \
            "model" not in bax else None
        self.tp = mesh.shape["model"] if self.M else 1
        self.mode = attention_mode(cfg, self.tp)
        self.remat = remat

    # -- the forward -----------------------------------------------------------

    def loss(self, params: dict, mb: dict) -> Tuple[list, list, list]:
        """(loss + the MoE weight x aux, loss, aux) at each position for
        one microbatch ``mb`` (each position's rows of its leaves)."""
        cfg, pos = self.cfg, self.pos
        ids = mb["tokens"]
        x = self.embed(params["embed"]["emb"], ids)
        positions = self._positions(ids)
        # the reference casts the stub features to bf16 and lets the
        # first product promote them to the params' dtype
        dt = _dtype(cfg.param_dtype)
        memory = None
        if cfg.is_encdec:
            feats = self.map(lambda v: v.to(torch.bfloat16).to(dt),
                             mb["encoder_feats"])
            if cfg.frontend:
                feats = self.frontend(params["frontend_proj"], feats)
            memory, _ = self.stack(params["enc_blocks"], feats,
                                   self._positions(feats), causal=False)
            memory = self.norm(params["enc_ln_f"], memory)
        vp = 0
        if "vision_embeds" in mb:
            ve = self.frontend(params["frontend_proj"], self.map(
                lambda v: v.to(torch.bfloat16).to(dt), mb["vision_embeds"]))
            x = self.map(lambda v, h: torch.cat([v.to(h.dtype), h], dim=1),
                         ve, x)
            vp = ve[0].shape[1]
            positions = self.map(lambda t: torch.cat([torch.arange(
                vp, dtype=torch.int32, device=t.device)[None].expand(
                    t.shape[0], vp), t + vp], dim=1), positions)
        x, aux = self.stack(params["blocks"], x, positions, memory)
        x = self.norm(params["ln_f"], x)
        if vp:
            x = self.map(lambda h: h[:, vp:, :], x)
        logits, (_, ax) = self.readout(params, x)
        loss = self.xent(logits, ax, mb["labels"])
        if cfg.moe_impl != "dense":
            # the dense aux is the global batch's, all-reduced over DATA:
            # every position's cotangent of it is the whole one
            aux = part.share(pos, aux, self.bax)
        moe_w = 0.01 if cfg.n_experts else 0.0
        total = self.map(lambda l, a: l + moe_w * a, loss, aux)
        return total, loss, aux

    def stack(self, blocks: dict, x: list, positions: list,
              memory: Optional[list] = None, causal: bool = True):
        """The blocks, each under ``remat`` (a decoder's reading
        ``memory``, the encoder's with ``causal=False``); (x, the summed
        aux).  The memory feeds every decoder block, so its cotangent
        sums over them before it enters the encoder."""
        parts = tree_map(lambda d: [v.unbind(0) for v in d.vals], blocks)
        n_layers = len(next(iter(_leaves(parts)))[0])

        def layer(i):
            return tree_map(lambda d, u: Dist(d.shape[1:], d.spec[1:],
                                              [t[i] for t in u]),
                            blocks, parts)

        body: Callable = self.block_train
        if self.remat == "full":
            body = functools.partial(checkpoint, body, use_reentrant=False)
        elif self.remat == "dots":
            body = functools.partial(
                checkpoint, body, use_reentrant=False,
                context_fn=functools.partial(
                    create_selective_checkpoint_contexts, _save_products))
        aux = self.map(lambda h: torch.zeros((), dtype=torch.float32,
                                             device=h.device), x)
        for i in range(n_layers):
            x, a = body(layer(i), x, positions, memory, causal)
            if a is not None:
                aux = self.map(torch.add, aux, a)
        return x, aux

    def block_train(self, p: dict, x: list, positions: list,
                    memory: Optional[list] = None, causal: bool = True):
        none = self.pos.same(None)
        h = self.norm(p["ln1"], x)
        x = self.map(torch.add, x, self.mix(p, h, positions, none, none,
                                            causal))
        x = self.cross(p, x, memory)
        if "ln2" not in p:
            return x, None
        h2 = self.norm(p["ln2"], x)
        ff, aux = None, None
        if "moe" in p:
            ff, aux = self.moe_train(p["moe"], h2)
        if "mlp" in p:
            m = self.mlp(p["mlp"], h2)
            ff = m if ff is None else self.map(torch.add, ff, m)
        return self.map(torch.add, x, ff), aux

    def moe_train(self, p: dict, h: list) -> Tuple[list, list]:
        """The MoE FFN and its aux at each position: the routing a copy
        at every ``model`` rank, the dispatch to the rank's experts, the
        ranks' partials added (see the module docstring)."""
        cfg, pos = self.cfg, self.pos
        if cfg.moe_impl == "dense":
            return self.moe_dense(p, h, aux=True)
        mesh = pos.mesh
        n_e = p["router"].shape[1]
        top_k = cfg.experts_per_token
        split = self.splits(n_e)
        # the reference's shard_map dispatches the whole microbatch at
        # every position where its rows do not divide over DATA
        ep = cfg.moe_impl == "ep" and "model" in mesh.axis_names and \
            n_e % mesh.shape["model"] == 0 and self.shares is None
        if ep and self.bax != shd.data_axes(mesh):
            return self.moe_ep_relaid(p, h)
        gather = bool(self.bax) and not ep
        x = part.all_gather(pos, h, self.bax, 0) if gather else h
        ax = self.M if split else None
        names = [n for n in ("up", "gate", "down") if n in p]
        ws = [self.fetch(p[n], ax, None, None) for n in names]

        def route(xb, r):
            b, l, d = xb.shape
            xt = xb.reshape(b * l, d)
            return (xt,) + moe._route({"router": r}, xt, top_k)

        xt, probs, topv, topi = (list(z) for z in zip(
            *self.map(route, x, self.fetch(p["router"], None, None))))
        if split:
            xt, topv = self.enter(xt), self.enter(topv)
        e_loc = n_e // self.tp if split else n_e
        b, l, d = x[0].shape
        cap = max(1, int(1.25 * b * l * top_k / n_e))

        def dispatch(xt, tv, ti, k, *w):
            return moe.dispatch_local(
                dict(zip(names, w)), xt, tv, ti, act=cfg.act, cap=cap,
                e_lo=self.rank(k) * e_loc if split else 0, e_loc=e_loc)

        out = self.map(dispatch, xt, topv, topi, list(pos.ks), *ws)
        if split:
            out = self.model_sum(out)
        out = self.map(lambda o: o.reshape(b, l, d), out)
        if gather:
            took = self.shares or shares(b, pos.size(self.bax))
            out = [o.narrow(0, sum(took[:d]), took[d]) for o, d in zip(
                out, (pos.part(k, self.bax) for k in pos.ks))]
        aux = self.map(lambda pr, ti: moe.load_balance_aux(pr, ti, n_e),
                       probs, topi)
        return out, aux

    def moe_ep_relaid(self, p: dict, h: list) -> Tuple[list, list]:
        """``moe_impl="ep"`` with the batch over other axes than the DATA
        axes (``model`` among them): the rows relaid to the DATA axes, as
        the reference's ``shard_map`` ``in_specs`` reshard them, each
        ``model`` rank dispatching its data shard's rows to its own
        experts, and the ranks' partials reduce-scattered over ``model``
        back to each position's rows.  Every position's cotangents stay
        partials of its rows (the program has no tensor parallelism), so
        the relayout's gather sums them back (its reduce-scatter)."""
        cfg, pos = self.cfg, self.pos
        data, m = shd.data_axes(pos.mesh), ("model",)
        n_e = p["router"].shape[1]
        top_k = cfg.experts_per_token
        e_loc = n_e // pos.size(m)
        b, l, d = h[0].shape
        whole = torch.Size((b * pos.size(self.bax), l, d))
        x = part.relayout(pos, Dist(whole, (self.bax, None, None), h), data)
        names = [n for n in ("up", "gate", "down") if n in p]
        ws = [part.relayout(pos, p[n], "model", None, None) for n in names]
        bd = x[0].shape[0]
        cap = max(1, int(1.25 * bd * l * top_k / n_e))

        def local(xb, r, k, *w):
            xt = xb.reshape(bd * l, d)
            probs, topv, topi = moe._route({"router": r}, xt, top_k)
            out = moe.dispatch_local(
                dict(zip(names, w)), xt, topv, topi, act=cfg.act, cap=cap,
                e_lo=pos.part(k, m) * e_loc, e_loc=e_loc)
            return out.reshape(bd, l, d), moe.load_balance_aux(probs, topi,
                                                               n_e)

        out, aux = (list(z) for z in zip(*self.map(
            local, x, self.fetch(p["router"], None, None), list(pos.ks),
            *ws)))
        out = part.reduce_scatter(pos, out, m, 0)
        if data + m != self.bax:
            out = part.relayout(pos, Dist(whole, (data + m, None, None), out),
                                self.bax)
        return out, aux

    def xent(self, logits: list, ax, labels: list) -> list:
        """The masked next-token loss + z-loss of vocab-parallel logits
        (vocab on ``ax``), the same at every position."""
        cfg, pos = self.cfg, self.pos
        n = logits[0].shape[-1]

        def local(lg, lab, k):
            lo = self.rank(k) * n if ax else 0
            if cfg.vocab_padded != cfg.vocab_size:
                real = torch.arange(lo, lo + n, device=lg.device) < \
                    cfg.vocab_size
                lg = torch.where(real, lg, -1e30)
            lf = lg.to(torch.float32)
            t = torch.clamp(lab, min=0).long() - lo
            hit = (t >= 0) & (t < n)
            gold = torch.take_along_dim(lf, t.clamp(0, n - 1)[..., None],
                                        dim=-1)[..., 0]
            return torch.logsumexp(lf, dim=-1), torch.where(hit, gold, 0.0)

        lse, gold = (list(z) for z in zip(
            *self.map(local, logits, labels, list(pos.ks))))
        if ax:
            m = _axes(self.M)
            lse = self.map(lambda s: torch.logsumexp(s, dim=0),
                           part.all_gather(pos, self.map(lambda s: s[None],
                                                         lse), m, 0,
                                           copies=True))
            gold = part.all_reduce(pos, gold, m)

        def sums(lse, gold, lab):
            mask = (lab >= 0).to(torch.float32)
            nll = (lse - gold) * mask
            zl = 1e-4 * torch.square(lse) * mask
            return nll.sum() + zl.sum(), mask.sum()

        total, count = (list(z) for z in zip(
            *self.map(sums, lse, gold, labels)))
        denom = part.all_reduce(pos, count, self.bax)
        return part.all_reduce(pos, self.map(
            lambda t, c: t / torch.clamp(c, min=1.0), total, denom), self.bax)

    # -- the optimizer -----------------------------------------------------------

    def global_norm(self, grads: List[Dist]) -> list:
        """The gradients' global norm at every position: each leaf's sum
        of squares from the positions at rank 0 of every axis it is not
        split over, one packed all-reduce, the leaves added in order."""
        pos = self.pos
        names = pos.mesh.axis_names

        def local(k, *gs):
            out = []
            for d, g in zip(grads, gs):
                ssq = torch.sum(torch.square(g.to(torch.float32)))
                own = all(pos.part(k, (a,)) == 0 for a in names
                          if a not in _held(d.spec))
                out.append(ssq if own else torch.zeros_like(ssq))
            return torch.stack(out)

        packed = part.all_reduce(pos, self.map(local, list(pos.ks),
                                               *(d.vals for d in grads)),
                                 names)
        return self.map(lambda v: torch.sqrt(sum(v.unbind())), packed)


def _per_position(tree, i: int):
    return tree_map(lambda d: d.vals[i], tree)


def transformed(pos: Positions, transform: Callable, like: dict,
                grads: List[Dist]) -> Tuple[List[Dist], list]:
    """A train step's ``grad_transform`` on the summed gradients
    ``grads`` (the leaves of ``like``, in ``flatten``'s order), as GSPMD
    applies it to logical whole arrays: each leaf all-gathered whole at
    every position (charged), the callable applied to the whole tree at
    each position, the global norm taken over every leaf it returned,
    and its first leaves, one a parameter in ``flatten``'s order (the
    reference's ``update`` zips them so: a pair ``(grads, residuals)``
    steps on its first element), cut back to the gradients' layout.
    Returns (those gradients, the norm at each position)."""
    with torch.no_grad():
        whole = [part.relayout(pos, g, *(None,) * len(g.shape))
                 for g in grads]
        shape = tree_map(lambda d: None, like)
        outs = pos.map(lambda *ws: transform(unflatten(shape, list(ws))),
                       *whole)
        gnorm = pos.map(opt.global_norm, outs)
        flat = [flatten(o)[:len(grads)] for o in outs]
        return [Dist(g.shape, g.spec, part.relayout(
            pos, Dist(g.shape, (None,) * len(g.shape), [f[j] for f in flat]),
            *g.spec)) for j, g in enumerate(grads)], gnorm


def _step(pos: Positions, cfg, ocfg, n_mb: int, remat: str, dists: dict,
          transform: Optional[Callable] = None):
    """(new params, new optimizer state, metrics) at ``pos``: the params
    and moments as trees of :class:`Dist`, the metrics as lists, one
    value a position; ``transform`` the step's ``grad_transform``."""
    params, state, batch = (dists["params"], dists["opt_state"],
                            dists["batch"])
    mesh = pos.mesh
    bax = _batch_axes(mesh, batch["tokens"])
    prog = _TrainProgram(cfg, pos, bax, remat)
    nd = pos.size(bax)
    b = batch["tokens"].shape[0]
    if b % n_mb:
        raise ValueError(f"a batch of {b} rows does not split into "
                         f"{n_mb} microbatches")
    if b % nd:
        # batch_shardings left the batch whole or on fewer axes: each
        # position takes its shares from it gathered whole
        rows = {name: [_take([v], _wanted(b, n_mb, nd, pos.part(k, bax)))
                       for k, v in zip(pos.ks, part.relayout(pos, d, None))]
                for name, d in batch.items()}
    else:
        rows = {name: relay(pos, part.relayout(pos, d, bax), bax, n_mb)
                for name, d in batch.items()}
    took = shares(b // n_mb, nd)
    if len(set(took)) > 1:
        prog.shares = took
    took = [took[pos.part(k, bax)] for k in pos.ks]

    live = tree_map(lambda d: Dist(d.shape, d.spec, [
        v.detach().requires_grad_() for v in d.vals]), params)
    leaves = _leaves(live)
    inputs = [v for d in leaves for v in d.vals]
    acc, losses, auxes = None, [], []
    for i in range(n_mb):
        mb = {name: [v.narrow(0, i * c, c) for v, c in zip(vals, took)]
              for name, vals in rows.items()}
        used = tree_map(lambda d: Dist(d.shape, d.spec, part.enter(
            pos, d.vals, summed_axes(prog, d.spec))), live)
        total, loss, aux = prog.loss(used, mb)
        grads = torch.autograd.grad(
            total, inputs, grad_outputs=[torch.ones_like(t) for t in total],
            materialize_grads=True)
        if n_mb == 1:
            acc = list(grads)
        else:
            if acc is None:
                acc = [torch.zeros(v.shape, dtype=torch.float32,
                                   device=v.device) for v in inputs]
            for a, g in zip(acc, grads):
                a.add_(g)
        # the reference's scan keeps each microbatch's whole objective
        losses.append([t.detach() for t in (loss if n_mb == 1 else total)])
        auxes.append([t.detach() for t in aux])
    if n_mb > 1:
        acc = [a / n_mb for a in acc]
        loss = [torch.stack(v).mean() for v in zip(*losses)]
        aux = [torch.stack(v).mean() for v in zip(*auxes)]
    else:
        loss, aux = losses[0], auxes[0]
    it = iter(acc)
    gleaves = [Dist(d.shape, d.spec, [next(it) for _ in d.vals])
               for d in leaves]
    if transform is None:
        gnorm = prog.global_norm(gleaves)
    else:
        gleaves, gnorm = transformed(pos, transform, live, gleaves)

    # each position updates its shards in the moments' layout
    with torch.no_grad():
        g_of = dict(zip(map(id, leaves), gleaves))
        grads = tree_map(lambda d: g_of[id(d)], live)

        def moments_layout(d: Dist, m: Dist) -> Dist:
            return d if d.spec == m.spec else Dist(
                d.shape, m.spec, part.relayout(pos, d, *m.spec))

        params_m = tree_map(moments_layout, params, state.mu)
        grads_m = tree_map(moments_layout, grads, state.mu)
        out = pos.map(
            lambda i, gn: opt.update(
                ocfg, _per_position(params_m, i), _per_position(grads_m, i),
                opt.OptState(state.step.vals[i], _per_position(state.mu, i),
                             _per_position(state.nu, i)), gnorm=gn),
            list(range(len(pos.ks))), gnorm)

    new_p = _collect(params_m, [o[0] for o in out])
    new_mu = _collect(state.mu, [o[1].mu for o in out])
    new_nu = _collect(state.nu, [o[1].nu for o in out])
    new_state = opt.OptState(
        Dist(state.step.shape, state.step.spec, [o[1].step for o in out]),
        new_mu, new_nu)
    metrics = {"loss": loss, "aux": aux, "grad_norm": gnorm,
               "lr": [o[2]["lr"] for o in out]}
    return new_p, new_state, metrics


def _collect(like: dict, trees: list) -> dict:
    """Trees of one tensor a position as a tree of :class:`Dist` laid
    out as ``like``."""
    if isinstance(like, dict):
        return {k: _collect(v, [t[k] for t in trees]) for k, v in like.items()}
    return Dist(like.shape, like.spec, list(trees))


class PartitionedTrainStep(part.PartitionedStep):
    """A step of :func:`~repro_torch.train.train_loop.make_train_step`
    partitioned over the mesh of its shardings (see the module
    docstring): ``step(params, opt_state, batch)`` takes arguments laid
    out by ``in_shardings = (ps, os_, bs)`` and returns ``(params,
    opt_state, metrics)`` laid out by ``out_shardings`` (``metrics``
    whole on the first position's device where its entry is None)."""

    def __init__(self, step, in_shardings, out_shardings):
        super().__init__(step, in_shardings, out_shardings)
        c = self.closure
        self.ocfg, self.n_mb, self.remat, self.transform = (
            c["ocfg"], c["n_microbatches"], c["remat"], c["grad_transform"])

    def _run(self, pos: Positions, dists: dict):
        with torch.enable_grad():
            return _step(pos, self.cfg, self.ocfg, self.n_mb, self.remat,
                         dists, self.transform)

    def _outputs(self, pos: Positions, new_p: dict, new_s, leaf):
        """The new params and optimizer state, each leaf ``leaf(d,
        sharding)`` with its out sharding (None where there is none)."""

        def tree(t, sh):
            if isinstance(t, dict):
                return {k: tree(v, None if sh is None else sh[k])
                        for k, v in t.items()}
            return leaf(t, sh)

        p_sh, s_sh = self._out_sharding(0), self._out_sharding(1)
        return tree(new_p, p_sh), opt.OptState(*(
            tree(t, None if s_sh is None else getattr(s_sh, f))
            for t, f in zip(new_s, opt.OptState._fields)))

    def __call__(self, *args, **kwargs):
        pos = Positions(self.mesh, range(self.mesh.size))
        dists = self._dists(self._bind(args, kwargs), self._placed)
        new_p, new_s, metrics = self._run(pos, dists)
        params, state = self._outputs(
            pos, new_p, new_s, lambda d, sh: self._out(pos, d, sh))
        m_sh = self._out_sharding(2)
        if m_sh is None:
            # the same value at every position: the first one's
            for v in metrics.values():
                pos.join(v)
            return params, state, {k: v[0] for k, v in metrics.items()}
        return params, state, {
            k: self._out(pos, Dist(torch.Size(), (), v), m_sh[k])
            for k, v in metrics.items()}

    def run_position(self, local: dict, position: int = 0):
        """Position ``position``'s train step alone on ``meta``, backward
        and optimizer included, over the pieces :meth:`local_arguments`
        gave (its peers' parts stand in by its own): its params and
        optimizer state as it holds them after the step, in the out
        shardings' layout, and its metrics."""
        pos = Positions(self.mesh, [position], meta=True)
        new_p, new_s, metrics = self._run(pos, local)
        params, state = self._outputs(pos, new_p, new_s, lambda d, sh: (
            part.relayout(pos, d, *_spec(() if sh is None else sh.spec,
                                         len(d.shape)))[0]))
        return params, state, {k: v[0] for k, v in metrics.items()}
