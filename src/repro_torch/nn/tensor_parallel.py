"""Tensor parallelism over the ``model`` mesh axis: each rank computes on
its own blocks of the parameters that the binding rules split over it.

The reference has no module of this kind: its sharded steps are GSPMD
programs, and XLA's partitioner splits every matmul that touches a split
parameter.  The port's sharded steps (``launch.steps``) split the compute
themselves, Megatron's way, for the leaves the plan allows
(``launch.shardings.model_split``): attention over ``heads`` and
``kv_heads``, or over ``head_dim`` where the rules split the head width
instead (Qwen2's and Qwen2-VL's, whose KV heads do not divide ``model``),
the MLP and the MoE's shared expert over ``mlp``, the RG-LRU over ``mlp``
(its channels) and ``heads`` (its block-diagonal gates, whose heads are
its channels' own), the MoE's experts over ``experts``, the embedding and
the unembedding over ``vocab``.  The layers call the functions here with
the logical axis a product splits over; each applies only where
:func:`model_shard` is entered and the rules split that axis.  Outside it
every function is the unsplit computation, so the unsharded path runs the
same code.

* :func:`copy_to_model` — a column-parallel product's input: identity
  forward, its gradient all-reduced over ``model`` backward;
* :func:`reduce_from_model` — a row-parallel product's partial sums:
  all-reduced forward, identity backward;
* :func:`embedding` — the vocabulary-parallel lookup: each rank's rows,
  zeros for the ids it does not hold, one all-reduce (exact: one rank
  contributes each row);
* :func:`cross_entropy` — the vocabulary-parallel loss: the rows'
  log-sum-exp combined over ``model`` and the target's logit from the rank
  that holds it; its backward is local and writes each element once;
* :func:`gather` — a tensor whole along its last dimension from the
  ranks' blocks: the last position's logits over the vocabulary (so that
  ``argmax`` gives the first index of the maximum, as the reference's
  does), a decode step's one-token q and k over ``head_dim`` (RoPE pairs
  dim i with dim i + D/2, which another rank holds);
* :func:`kv_heads` — the KV heads a rank's query heads attend with where
  the query heads are split and the KV heads are not (``prune_spec``
  replicates them where their count does not divide ``model``);
* :func:`block` — the entries of a split axis a rank holds (the RG-LRU's
  heads, the MoE's experts, a decode step's head-width columns);
* :func:`once_over_model` — a term every rank computes whole (the MoE's
  load-balancing loss), its gradient taken once over the group's sums;
* :func:`to_rows` / :func:`to_cols` — the attention's exchange where
  ``head_dim`` is split: each rank holds its D-columns of every (batch x
  head) row after the column-parallel q/k/v projections, and attends on
  whole D, for which it needs whole rows.  :func:`to_rows` trades the
  columns of all rows for a block of rows at whole D (one all-to-all over
  ``model``), :func:`to_cols` trades them back; each one's backward is
  the other's exchange.  :func:`row_ranges` gives each rank its
  (batch x query-head) rows, :func:`kv_ranges` the (batch x KV-head) rows
  those attend with.  (A decode step instead sums its one token's partial
  scores over ``model``: ``nn.attention.full_attention``.)

A module global, as ``nn.moe.batch_shard``: the train step enters it
around each microbatch's forward and backward (under remat the backward
runs the forward again), and autograd runs the backward on threads of its
own.  The backward's collectives take the group from the forward's
context, saved with the autograd node.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Optional, Union

import torch


@dataclasses.dataclass(frozen=True)
class ModelShard:
    """One rank's place along ``model``: its ``index`` of ``ways``, the
    logical axes the rules split over it (of "heads", "kv_heads",
    "head_dim", "mlp", "experts" and "vocab"), and the group's
    collectives: ``reduce(t, op)`` in place (op "sum" or "max"),
    ``gather(t)`` along the last dimension in rank order, and
    ``all_to_all(t, send, recv)``: a flat ``t`` whose first ``send[j]``
    elements after those of lower ranks go to rank ``j``, returning the
    ``recv[i]`` elements from each rank ``i`` in rank order."""

    index: int
    ways: int
    split: frozenset
    reduce: Callable[[torch.Tensor, str], torch.Tensor]
    gather: Callable[[torch.Tensor], torch.Tensor]
    all_to_all: Callable[[torch.Tensor, list, list], torch.Tensor]


_shard: Optional[ModelShard] = None


@contextlib.contextmanager
def model_shard(shard: Optional[ModelShard]):
    """Within ``with``, the layers compute on ``shard``'s blocks."""
    global _shard
    saved, _shard = _shard, shard
    try:
        yield
    finally:
        _shard = saved


def is_split(axis: Optional[str]) -> bool:
    """Whether the entered shard splits the logical ``axis`` over
    ``model``."""
    return _shard is not None and axis in _shard.split


#: the leaves whose compute this module splits over ``model``, the split
#: plan's (``launch.shardings.model_split``): (the end of the leaf's path,
#: the logical axis split; the vocabulary leaves' paths are whole).  The
#: attention's q/k/v are split by ``nn.attention.qkv_project``, its o by
#: ``out_project``, over their heads or their head width (``head_dim``:
#: ``nn.attention.self_attention`` then attends on whole rows through
#: :func:`to_rows`, ``decode_attention`` sums partial scores); the MLP's
#: by ``nn.layers.mlp``; the RG-LRU's by
#: ``nn.rglru.rglru_block`` (in_x/in_gate column-parallel, out row-parallel,
#: the rest per channel or per head); the MoE's experts and shared expert
#: by ``nn.moe.moe``; the table by ``nn.layers.embed`` and ``unembed``, the
#: unembedding by ``nn.layers.dense`` at ``out_axis="vocab"``.  A leaf added
#: here needs its layer's split.
SPLIT_LEAVES = (
    (("mixer", "q", "kernel"), "heads"), (("mixer", "q", "bias"), "heads"),
    (("mixer", "k", "kernel"), "kv_heads"),
    (("mixer", "k", "bias"), "kv_heads"),
    (("mixer", "v", "kernel"), "kv_heads"),
    (("mixer", "v", "bias"), "kv_heads"),
    (("mixer", "o", "kernel"), "heads"),
    (("mixer", "q", "kernel"), "head_dim"),
    (("mixer", "q", "bias"), "head_dim"),
    (("mixer", "k", "kernel"), "head_dim"),
    (("mixer", "k", "bias"), "head_dim"),
    (("mixer", "v", "kernel"), "head_dim"),
    (("mixer", "v", "bias"), "head_dim"),
    (("mixer", "o", "kernel"), "head_dim"),
    (("mlp", "wi"), "mlp"), (("mlp", "wg"), "mlp"), (("mlp", "wo"), "mlp"),
    (("mixer", "in_x", "kernel"), "mlp"),
    (("mixer", "in_gate", "kernel"), "mlp"),
    (("mixer", "conv", "kernel"), "mlp"), (("mixer", "conv", "bias"), "mlp"),
    (("mixer", "gate_a", "kernel"), "heads"),
    (("mixer", "gate_a", "bias"), "mlp"),
    (("mixer", "gate_x", "kernel"), "heads"),
    (("mixer", "gate_x", "bias"), "mlp"),
    (("mixer", "lamb"), "mlp"), (("mixer", "out", "kernel"), "mlp"),
    (("moe", "experts", "wi"), "experts"),
    (("moe", "experts", "wg"), "experts"),
    (("moe", "experts", "wo"), "experts"),
    (("moe", "shared", "wi"), "mlp"), (("moe", "shared", "wg"), "mlp"),
    (("moe", "shared", "wo"), "mlp"),
    (("embed", "table"), "vocab"),
    (("unembed", "kernel"), "vocab"),
)


def splits_leaf(path: tuple, axis: str) -> bool:
    """Whether the leaf at ``path`` (its keys from the tree's root) is
    one of :data:`SPLIT_LEAVES` split over ``axis``."""
    return any(axis == ax and (path == tail if ax == "vocab"
                               else path[-len(tail):] == tail)
               for tail, ax in SPLIT_LEAVES)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, reduce):
        ctx.reduce = reduce
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        # the incoming gradient may be shared with other branches
        return ctx.reduce(g.contiguous().clone(), "sum"), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, reduce):
        return reduce(x.clone(), "sum")

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, axis: Optional[str]) -> torch.Tensor:
    """``x`` as the input of products whose output ``axis`` is split: the
    same values; each rank's gradient of it is partial, so the backward
    sums it over ``model``.  Also the parameter whose whole value every
    rank holds and uses in part (:func:`kv_heads`)."""
    if not is_split(axis) or not torch.is_grad_enabled():
        return x
    return _CopyToModel.apply(x, _shard.reduce)


def reduce_from_model(x: torch.Tensor, axis: Optional[str]
                      ) -> torch.Tensor:
    """The sum over ``model`` of the partial products whose input
    ``axis`` is split; ``x`` is written in place where no gradient is
    recorded."""
    if not is_split(axis):
        return x
    if not torch.is_grad_enabled():
        return _shard.reduce(x, "sum")
    return _ReduceFromModel.apply(x, _shard.reduce)


def block(n: int, axis: Optional[str]) -> slice:
    """The entries of ``n`` along the logical ``axis`` that this rank's
    block holds: its ``ways``-th part in rank order where the entered shard
    splits the axis, else all of them."""
    if not is_split(axis):
        return slice(0, n)
    per = n // _shard.ways
    return slice(_shard.index * per, (_shard.index + 1) * per)


class _OnceOverModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ways):
        ctx.ways = ways
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.ways, None


def once_over_model(x: torch.Tensor, axis: Optional[str]) -> torch.Tensor:
    """``x``, a value every rank of the group computes whole from whole
    inputs, where the other terms of its layer's gradient are partial and
    summed over ``model`` (by :func:`copy_to_model`): the same value, its
    gradient ``1/ways`` on each rank, so the sums count it once."""
    if not is_split(axis) or not torch.is_grad_enabled():
        return x
    return _OnceOverModel.apply(x, _shard.ways)


def embedding(table: torch.Tensor, ids: torch.Tensor, dtype) -> torch.Tensor:
    """The rows ``ids`` of the table (this rank's block of its ``vocab``
    rows where split), cast to ``dtype``."""
    if not is_split("vocab"):
        return table[ids].to(dtype)
    n = table.shape[0]
    local = ids - _shard.index * n
    held = (local >= 0) & (local < n)
    rows = table[local.clamp(0, n - 1)].to(dtype)
    rows = torch.where(held[..., None], rows, torch.zeros((), dtype=dtype,
                                                          device=rows.device))
    return reduce_from_model(rows, "vocab")


class _CrossEntropy(torch.autograd.Function):
    """-log softmax at the targets of (N, V_local) fp32 logits whose
    columns start at vocabulary id ``lo``; ``reduce`` None on one rank.
    The ranks' log-sum-exps combine as one over the whole row: on one
    rank of a group the combination is the rank's own, bit for bit."""

    @staticmethod
    def forward(ctx, logits, targets, lo, reduce):
        n_local = logits.shape[-1]
        lse_local = torch.logsumexp(logits, dim=-1)
        local = targets - lo
        held = (local >= 0) & (local < n_local)
        idx = local.clamp(0, n_local - 1)
        xt = torch.where(held, logits.gather(1, idx[:, None])[:, 0], 0.0)
        lse = lse_local
        if reduce is not None:
            m = reduce(lse_local.clone(), "max")
            both = reduce(torch.stack([torch.exp(lse_local - m), xt]), "sum")
            lse, xt = m + torch.log(both[0]), both[1]
        ctx.save_for_backward(logits, lse_local, lse, idx, held)
        return lse - xt

    @staticmethod
    def backward(ctx, g):
        logits, lse_local, lse, idx, held = ctx.saved_tensors
        # softmax over the whole row: the local one times exp(lse_local -
        # lse); minus the cotangent at the target, one element a row
        p = torch.softmax(logits, dim=-1)
        p.mul_((g * torch.exp(lse_local - lse))[:, None])
        at = idx[:, None]
        p.scatter_(1, at, p.gather(1, at)
                   - torch.where(held, g, 0.0)[:, None])
        return p, None, None, None


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor
                  ) -> torch.Tensor:
    """(N,) fp32 ``-log softmax(logits)[target]`` of (N, V) fp32 logits,
    this rank's columns of them where ``vocab`` is split, at (N,) int64
    global ids >= 0.  The gradient is ``softmax - onehot`` times the
    cotangent, one element written once each: no atomics, so a replay
    gives the eager step's values."""
    if not is_split("vocab"):
        return _CrossEntropy.apply(logits, targets, 0, None)
    return _CrossEntropy.apply(logits, targets,
                               _shard.index * logits.shape[-1],
                               _shard.reduce)


def gather(t: torch.Tensor, axis: str) -> torch.Tensor:
    """``t`` whole along its last dimension from this rank's block of it
    where the entered shard splits ``axis``, else ``t``: the last
    position's logits over ``vocab``, a decode step's one-token q and k
    over ``head_dim``.  No gradient: serving's."""
    if not is_split(axis):
        return t
    return _shard.gather(t.contiguous())


def ways(axis: str) -> int:
    """The ranks that split ``axis`` (1 where none does)."""
    return _shard.ways if is_split(axis) else 1


def index() -> int:
    """This rank's index along ``model`` (0 outside a shard)."""
    return 0 if _shard is None else _shard.index


def row_ranges(n: int) -> list:
    """Each rank's rows of ``n`` in rank order, ``[(lo, hi), ...]``, where
    the entered shard splits ``head_dim``: contiguous, the first ``n %
    ways`` ranks one row more than the rest (rank 0 the heaviest).  One
    range of all ``n`` where it does not."""
    w = ways("head_dim")
    per, extra = divmod(n, w)
    cuts = [r * per + min(r, extra) for r in range(w + 1)]
    return list(zip(cuts[:-1], cuts[1:]))


def kv_ranges(rows: list, n_heads: int, n_kv: int) -> list:
    """The (batch x KV-head) rows that each range of (batch x query-head)
    ``rows`` attends with: contiguous, since a query row's KV row grows
    with it; neighbouring ranks' ranges share a KV row where they split
    its group."""
    group = n_heads // n_kv

    def kv(r):
        return r // n_heads * n_kv + r % n_heads // group
    return [(kv(lo), kv(hi - 1) + 1) if hi > lo else (kv(lo), kv(lo))
            for lo, hi in rows]


def _exchange_rows(shard, xs, ranges):
    """Each of ``xs`` (N_i, S, c): this rank's D-columns of all its rows
    -> (n_i, S, ways * c): its own rows ``ranges[i][index]`` at whole D
    (the ranks' columns in rank order).  One all-to-all for all of
    them."""
    me = shard.index
    s, c = xs[0].shape[1], xs[0].shape[2]
    parts, send = [], []
    for j in range(shard.ways):
        rows = [x[rg[j][0]:rg[j][1]] for x, rg in zip(xs, ranges)]
        parts += rows
        send.append(sum(r.numel() for r in rows))
    mine = [rg[me][1] - rg[me][0] for rg in ranges]
    flat = torch.cat([p.reshape(-1) for p in parts])
    got = shard.all_to_all(flat, send, [sum(mine) * s * c] * shard.ways)
    got = got.view(shard.ways, sum(mine), s, c)
    return [g.permute(1, 2, 0, 3).reshape(n, s, shard.ways * c)
            for g, n in zip(got.split(mine, dim=1), mine)]


def _exchange_cols(shard, ys, ranges, totals):
    """The reverse of :func:`_exchange_rows`: each of ``ys`` (n_i, S, ways
    * c), this rank's rows at whole D -> (N_i, S, c), its D-columns of
    all ``totals[i]`` rows, the rows that several ranks held summed."""
    w = shard.ways
    s, c = ys[0].shape[1], ys[0].shape[2] // w
    mine = [y.shape[0] for y in ys]
    blocks = torch.cat([y.reshape(n, s, w, c).permute(2, 0, 1, 3)
                        for y, n in zip(ys, mine)], dim=1)
    recv = [sum(rg[j][1] - rg[j][0] for rg in ranges) * s * c
            for j in range(w)]
    got = shard.all_to_all(blocks.reshape(-1), [sum(mine) * s * c] * w,
                           recv).view(-1, s, c)
    # each tensor's rows from the ranks in rank order are contiguous, but
    # for a KV row that a rank shares with its lower neighbours: those
    # rows are set aside and summed in, the rest concatenated
    keep, shared, idx = [[] for _ in ys], [[] for _ in ys], [[] for _ in ys]
    ends, at = [0] * len(ys), 0
    for j in range(w):
        for i, rg in enumerate(ranges):
            lo, hi = rg[j]
            over = min(max(ends[i] - lo, 0), hi - lo)
            shared[i].append(got[at:at + over])
            idx[i].extend(range(lo, lo + over))
            keep[i].append(got[at + over:at + hi - lo])
            ends[i] = max(ends[i], hi)
            at += hi - lo
    outs = []
    for i, n in enumerate(totals):
        out = torch.cat(keep[i])
        assert out.shape[0] == n, (out.shape, n)
        if idx[i]:
            out.index_add_(0, torch.tensor(idx[i], device=out.device),
                           torch.cat(shared[i]))
        outs.append(out)
    return outs


class _ToRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, shard, ranges, *xs):
        ctx.shard, ctx.ranges = shard, ranges
        ctx.totals = [x.shape[0] for x in xs]
        return tuple(_exchange_rows(shard, xs, ranges))

    @staticmethod
    def backward(ctx, *gs):
        return (None, None, *_exchange_cols(
            ctx.shard, [g.contiguous() for g in gs], ctx.ranges,
            ctx.totals))


class _ToCols(torch.autograd.Function):
    @staticmethod
    def forward(ctx, shard, ranges, total, y):
        ctx.shard, ctx.ranges = shard, ranges
        return _exchange_cols(shard, [y], [ranges], [total])[0]

    @staticmethod
    def backward(ctx, g):
        return None, None, None, _exchange_rows(ctx.shard, [g.contiguous()],
                                                [ctx.ranges])[0]


def to_rows(xs: list, ranges: list) -> list:
    """Where the entered shard splits ``head_dim``: each of ``xs`` (N_i,
    S, c), this rank's D-columns of every (batch x head) row, traded for
    its own rows ``ranges[i][index]`` at whole D, (n_i, S, ways * c), in
    one all-to-all over ``model``; the backward is :func:`to_cols`'
    exchange, the gradients of a row that several ranks held summed."""
    if not torch.is_grad_enabled():
        return _exchange_rows(_shard, xs, ranges)
    return list(_ToRows.apply(_shard, ranges, *xs))


def to_cols(y: torch.Tensor, ranges: list, total: int) -> torch.Tensor:
    """The reverse of :func:`to_rows` for one tensor: ``y`` (n, S, ways *
    c), this rank's rows at whole D -> (``total``, S, c), its D-columns
    of every row, in one all-to-all over ``model``."""
    if not torch.is_grad_enabled():
        return _exchange_cols(_shard, [y], [ranges], [total])[0]
    return _ToCols.apply(_shard, ranges, total, y)


def kv_heads(n_q: int, n_kv: int) -> Union[None, slice, list]:
    """The KV heads that this rank's ``n_q`` query heads attend with, out
    of ``n_kv`` whole ones, where the rules split the query heads over
    ``model`` and not the KV heads: a slice where the rank's query heads
    fall into whole groups, else one KV head per query head.  None where
    there is nothing to select (no split, or the KV heads split as the
    query heads are)."""
    if not is_split("heads") or is_split("kv_heads"):
        return None
    group = n_q * _shard.ways // n_kv
    first = _shard.index * n_q
    idx = [(first + j) // group for j in range(n_q)]
    lo, hi = idx[0], idx[-1] + 1
    per = n_q // (hi - lo)
    if per * (hi - lo) == n_q and idx == [lo + j // per for j in range(n_q)]:
        return slice(lo, hi)
    return idx
