"""Mixture of Experts: the reference's ``repro.nn.moe`` in torch.

Routing follows Mixtral/Qwen2-MoE: an fp32 softmax router (padding experts
masked to -1e30, so their probability is exactly 0 and top-k never picks
one while ``top_k`` is at most the real experts), top-k with renormalised
gates, and (Qwen2-MoE) shared experts with a sigmoid gate.  Dispatch is the
reference's *sort-based* capacity dispatch: the assignments sorted by
expert (stable), each expert's first ``capacity`` of them copied into an
(E, capacity, d) buffer and the rest dropped.  Token chunks are routed
together, each with its own capacity (:func:`route`).  The capacity comes from
shapes only, and nothing here reads a value back to the host (counts by
``scatter_add_``, no ``one_hot``, ``bincount`` or boolean mask), so a decode
step is static and captures into a CUDA graph.  A data rank of the
sharded train step routes its rows as the whole microbatch would
(:func:`batch_shard`): it exchanges the per-(chunk, expert) counts, not
the tokens.

The three expert products take their operands in the activation dtype and
sum in fp32 (:func:`~repro_torch.nn.layers.matmul_f32`); the reference
leaves them to XLA outside any Pallas kernel, and the port to cuBLAS.  The
expert weights are cast once per call and run once over every chunk's
rows: the cast is exact, so the values are the reference's per-chunk
casts.

The combine adds a token's ``top_k`` contributions one after another in
ascending expert id, from zeros in the activation dtype: the order of the
reference's scatter-add over the sorted assignments.  An atomic
``index_add_`` there would add them in no fixed order, and at bf16 a
replayed step would then not equal the eager one.

Under tensor parallelism (:mod:`repro_torch.nn.tensor_parallel`, where the
rules split ``experts`` and the shared expert's ``mlp`` over ``model``)
each rank of a model group holds its contiguous block of the (padded)
experts and the shared expert's columns.  The router and the plan run
whole on every rank, on the same activations, so every rank routes alike;
the dispatch buffer and the expert products hold the rank's experts only
(a rank of padding experts alone computes zeros), the shared expert is
column- then row-parallel, and the rank's combined output, its experts'
contributions plus its part of the gated shared output, is summed over
``model``: one all-reduce per layer.  The gradients of the layer's input,
the router and the shared gate are then partial on each rank, and summed
over ``model`` (``copy_to_model``); the aux loss, whole on every rank,
passes 1/ways of its gradient on each (``once_over_model``).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from repro_torch.nn import tensor_parallel as tp
from repro_torch.nn.layers import activation, matmul_f32, maybe_quantize
from repro_torch.nn.module import ParamSpec

ACCUM = torch.float32


def moe_specs(d: int, n_experts: int, expert_d_ff: int, *,
              n_experts_padded: Optional[int] = None,
              n_shared: int = 0, shared_d_ff: int = 0) -> dict:
    e = n_experts_padded or n_experts
    s = {
        "router": {"kernel": ParamSpec((d, e), ("embed", None), scale=0.02)},
        "experts": {
            "wi": ParamSpec((e, d, expert_d_ff),
                            ("experts", "expert_embed", "expert_mlp")),
            "wg": ParamSpec((e, d, expert_d_ff),
                            ("experts", "expert_embed", "expert_mlp")),
            "wo": ParamSpec((e, expert_d_ff, d),
                            ("experts", "expert_mlp", "expert_embed")),
        },
    }
    if n_shared:
        ff = shared_d_ff or n_shared * expert_d_ff
        s["shared"] = {
            "wi": ParamSpec((d, ff), ("embed", "mlp")),
            "wg": ParamSpec((d, ff), ("embed", "mlp")),
            "wo": ParamSpec((ff, d), ("mlp", "embed")),
            "gate": ParamSpec((d, 1), ("embed", None), scale=0.02),
        }
    return s


@dataclasses.dataclass
class Routing:
    """The routing and dispatch plan of T token chunks, each with its own
    capacity; the assignments (top_k per token) in sorted order, by chunk,
    then by expert, then by token."""

    probs: torch.Tensor        #: (..., N_c, E) router probabilities, fp32
    counts: torch.Tensor       #: (..., E) assignments per chunk and expert
    order: torch.Tensor        #: (NK,) flat assignment of each sorted one
    token: torch.Tensor        #: (NK,) its token, over all chunks
    gate: torch.Tensor         #: (NK,) its renormalised gate, fp32
    keep: torch.Tensor         #: (NK,) 1.0 within the capacity, else 0.0
    slot: torch.Tensor         #: (NK,) its row of the (E·T·rows, d) buffer
    capacity: int              #: C, the assignments kept per chunk, expert
    chunks: int                #: T
    rows: int                  #: buffer rows per chunk and expert (≤ C)


@dataclasses.dataclass(frozen=True)
class BatchShard:
    """One data rank's block of a microbatch: the rows ``index`` of ``ways``
    equal, contiguous blocks in row order, so its tokens are one range of
    the microbatch's flattened token order; ``reduce`` sums a tensor over
    the data ranks in place."""

    index: int
    ways: int
    reduce: Callable[[torch.Tensor], torch.Tensor]


#: the block of the microbatch the :func:`moe` calls route (None: all of it)
_shard: Optional[BatchShard] = None


@contextlib.contextmanager
def batch_shard(shard: Optional[BatchShard]):
    """Within ``with``, every :func:`moe` call takes its tokens as
    ``shard``'s block of a microbatch ``shard.ways`` times larger and routes
    them as the whole microbatch would (:func:`_plan`).  The sharded train
    step enters it around each microbatch's forward and backward (under
    remat the backward runs the forward again).  A module global, not a
    context variable: autograd runs the backward on threads of its own."""
    global _shard
    saved, _shard = _shard, shard
    try:
        yield
    finally:
        _shard = saved


class _SumOverRanks(torch.autograd.Function):
    """A tensor summed over the data ranks; its gradient summed the same
    way, so each rank's inputs get the gradient of every rank's use."""

    @staticmethod
    def forward(ctx, x, reduce):
        ctx.reduce = reduce
        return reduce(x.clone())

    @staticmethod
    def backward(ctx, g):
        return ctx.reduce(g.clone()), None


def _plan(xt: torch.Tensor, w_router: torch.Tensor, *, n_experts: int,
          top_k: int, capacity_factor: float, chunks: int, offset: int = 0,
          chunk_size: int = 0, shard: Optional[BatchShard] = None
          ) -> tuple[Routing, torch.Tensor, torch.Tensor]:
    """The routing of tokens ``xt`` (N, d), the range from ``offset`` of a
    microbatch cut into ``chunks`` chunks of ``chunk_size`` tokens (0: N
    tokens, the whole microbatch in ``chunks`` chunks).  Returns (the plan
    over the chunks the tokens touch, the assignments per chunk and expert
    of every chunk (T, E), the router probabilities summed per chunk over
    every chunk (T, E)).

    One stable sort over the key ``chunk·E + expert`` ranks each assignment
    among this call's tokens of its (chunk, expert).  With a ``shard`` each
    rank's counts go into its own slot of a (ways, T, E) tensor summed over
    the ranks (one small collective): an assignment's rank over the whole
    microbatch is its rank here plus the counts of the lower blocks, and it
    is kept if that is below the capacity, as the reference's sort over the
    whole microbatch keeps it.  Its slot is ``(expert·T_l + chunk)·rows +
    min(rank here, rows-1)``, T_l the chunks the tokens touch: a kept
    assignment's rank here is below both C and the tokens this call holds
    of its chunk, so ``rows`` is the least of C, the chunk and N, and the
    buffer holds no other rank's rows."""
    n_l = xt.shape[0]
    nc = chunk_size or n_l // chunks
    dev = xt.device
    first = offset // nc                       # the first chunk touched
    t_l = (offset + n_l - 1) // nc + 1 - first
    logits = xt.to(ACCUM) @ w_router.to(ACCUM)            # (N, E)
    e_pad = logits.shape[-1]
    if e_pad > n_experts:                       # mask padding experts
        pad = torch.arange(e_pad, device=dev) >= n_experts
        logits = torch.where(pad, -1e30, logits)
    probs = torch.softmax(logits, dim=-1)
    gate, eidx = torch.topk(probs, top_k, dim=-1)         # (N, K)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)

    nk = n_l * top_k
    capacity = max(1, int(nc * top_k / n_experts * capacity_factor))
    rows = min(capacity, nc, n_l)
    chunk = (torch.arange(n_l, device=dev) + offset) // nc - first
    key = (chunk[:, None] * e_pad + eidx).reshape(nk)
    order = torch.argsort(key, stable=True)
    skey = key[order]
    counts = torch.zeros(t_l * e_pad, dtype=torch.int64, device=dev
                         ).scatter_add_(0, key, torch.ones_like(key))
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(nk, device=dev) - starts[skey]    # in (chunk, e)
    # the router's probabilities summed per chunk (zeros pad the tokens
    # of the touched chunks that other ranks hold)
    lead = offset - first * nc
    psum = F.pad(probs, (0, 0, lead, t_l * nc - lead - n_l)).reshape(
        t_l, nc, e_pad).sum(1)
    counts = counts.reshape(t_l, e_pad)
    if shard is None:
        every, kept_rank = counts, rank
    else:
        slots = counts.new_zeros(shard.ways, chunks, e_pad)
        slots[shard.index, first:first + t_l] = counts
        slots = shard.reduce(slots)
        below = slots[:shard.index, first:first + t_l].sum(0)
        kept_rank = rank + below.reshape(-1)[skey]
        every = slots.sum(0)
        counts = every[first:first + t_l]
        psum = _SumOverRanks.apply(F.pad(
            psum, (0, 0, first, chunks - first - t_l)), shard.reduce)
    row = (skey % e_pad) * t_l + skey // e_pad            # expert·T_l + chunk
    plan = Routing(probs=probs, counts=counts, order=order,
                   token=order // top_k, gate=gate.reshape(nk)[order],
                   keep=(kept_rank < capacity).to(ACCUM),
                   slot=row * rows + torch.clamp(rank, max=rows - 1),
                   capacity=capacity, chunks=t_l, rows=rows)
    return plan, every, psum


def route(xt: torch.Tensor, w_router: torch.Tensor, *, n_experts: int,
          top_k: int, capacity_factor: float) -> Routing:
    """Router, top-k and the sort-based capacity dispatch of tokens ``xt``,
    (N, d) as one chunk or (T, N_c, d) as T chunks; ``w_router`` (d, E),
    E ≥ ``n_experts`` (the rest padding).

    All chunks in one pass (:func:`_plan`): the slot of an assignment is
    ``expert·(T·C) + chunk·C + min(rank, C-1)``, so the rows of one expert
    lie together over every chunk.
    """
    lead = xt.shape[:-2]
    t = xt.shape[0] if lead else 1
    r, _, _ = _plan(xt.reshape(-1, xt.shape[-1]), w_router,
                    n_experts=n_experts, top_k=top_k,
                    capacity_factor=capacity_factor, chunks=t)
    r.probs = r.probs.reshape(*xt.shape[:-1], -1)
    r.counts = r.counts.reshape(*lead, -1)
    return r


def _operand(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A weight cast to the activation dtype, as ``matmul_f32`` takes it.
    On the CPU it is widened here too, once, where ``matmul_f32`` would
    widen it in each product."""
    w = w.to(dtype)
    return w if w.is_cuda else w.to(ACCUM)


def moe(p: dict, x: torch.Tensor, *, n_experts: int, top_k: int,
        capacity_factor: float = 1.25, act: str = "silu",
        quant: Optional[str] = None, token_chunks: int = 1
        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Apply the MoE layer.  x: (B, S, d).  Returns (y, aux_loss).

    ``n_experts`` is the number of *real* experts; the router masks any
    padding experts (columns n_experts..E-1 of the router kernel).

    ``token_chunks`` T > 1 (when it divides B·S) routes the tokens as T
    chunks, each with its own capacity and drops, and returns the mean of
    their ``aux``: which tokens drop depends on the chunking, so it is part
    of the result.  The chunks go through in one pass (:func:`route`): the
    (E, T·C, d) buffer holds every chunk's rows, so each expert's weights
    are read once.  The reference runs the chunks one after another to
    bound its transient memory.  Here that memory is the buffer (E·T·C·d
    in the activation dtype) and the expert activations ``h`` and ``g``
    (E·T·C·ffn in fp32 each).  On qwen2-moe-a2.7b (E 64, d 2,048, ffn
    1,408, T 32) that is 84 MB for the buffer in bf16 and 115 MB for each
    of ``h`` and ``g`` at 4 x 1,024 tokens (C 10, 20,480 rows), and
    0.71 GB and 0.98 GB each at 32,768 tokens (C 85, 174,080 rows).

    Under :func:`batch_shard` ``x`` is one data rank's rows of the
    microbatch: T, the capacity and the aux loss count the whole
    microbatch, the kept assignments are the ones the whole microbatch's
    routing keeps (the counts exchanged, not the tokens), and the expert
    products run over the rows of this rank's kept assignments only, in a
    buffer sized by the chunks its tokens touch.  ``aux`` is then the whole
    microbatch's, on every rank, and its gradient reaches each rank's
    router through the summed probabilities: a caller that sums the ranks'
    gradients weighs it by 1/ways.

    Under tensor parallelism (the module docstring) ``p``'s experts and
    shared columns are this rank's block: the buffer and the expert
    activations hold its E/ways experts' rows, and ``y`` is summed over
    ``model`` (the value of every rank's combine together).
    """
    if not 0 < top_k <= n_experts:
        raise ValueError(f"top_k {top_k} of {n_experts} real experts")
    b, s, d = x.shape
    shard = _shard
    ways, index = (shard.ways, shard.index) if shard is not None else (1, 0)
    n_l = b * s
    n = n_l * ways                      # the whole microbatch's tokens
    t = token_chunks if token_chunks > 1 and n % token_chunks == 0 else 1
    dt = x.dtype
    f = activation(act)
    q = lambda w: _operand(maybe_quantize(w, quant), dt)  # noqa: E731
    # the router and the shared gate are whole on every rank of a model
    # group, and their gradients partial where the experts are split
    router = tp.copy_to_model(maybe_quantize(p["router"]["kernel"], quant)
                              .to(ACCUM), "experts")
    xt = tp.copy_to_model(x.reshape(n_l, d), "experts")
    r, counts, psum = _plan(xt, router, n_experts=n_experts, top_k=top_k,
                            capacity_factor=capacity_factor, chunks=t,
                            offset=index * n_l, chunk_size=n // t,
                            shard=shard)
    ex = p["experts"]
    held = tp.block(router.shape[-1], "experts")      # this rank's experts
    rows = r.chunks * r.rows
    n_rows = (held.stop - held.start) * rows
    # the slots of this rank's experts, and its assignments' weights: 0
    # for the other ranks' experts
    slot = r.slot - held.start * rows
    keep = r.keep * ((slot >= 0) & (slot < n_rows))
    slot = slot.clamp(0, n_rows - 1)

    # dispatch: a dropped assignment adds an exact 0 to a clamped slot, so
    # the (atomic) index_add_ gives the same buffer in any order
    buf = torch.zeros(n_rows, d, dtype=dt, device=x.device)
    buf.index_add_(0, slot, xt[r.token] * keep[:, None].to(dt))
    buf = buf.reshape(-1, rows, d)
    h = matmul_f32(buf, q(ex["wi"]))
    g = matmul_f32(buf, q(ex["wg"]))
    h = (f(g) * h).to(dt)
    out = matmul_f32(h, q(ex["wo"])).to(dt)             # (E_l, T_l·rows, d)

    tok_out = out.reshape(n_rows, d)[slot]                   # (NK, d)
    tok_out = tok_out * (r.gate * keep)[:, None].to(dt)
    # combine: each token's contributions at their sorted positions, which
    # ascend with the expert id, added in that order
    nk = r.order.numel()
    sorted_at = torch.empty_like(r.order)
    sorted_at[r.order] = torch.arange(nk, device=x.device)
    contrib = tok_out[torch.sort(sorted_at.reshape(n_l, top_k),
                                 dim=1).values]
    y = torch.zeros((n_l, d), dtype=dt, device=x.device)
    for j in range(top_k):
        y = y + contrib[:, j]

    if "shared" in p:                                        # Qwen2-MoE
        sh = p["shared"]
        hh = matmul_f32(xt, q(sh["wi"]))
        gg = matmul_f32(xt, q(sh["wg"]))
        hh = (f(gg) * hh).to(dt)
        sh_out = matmul_f32(hh, q(sh["wo"]))
        sh_gate = torch.sigmoid(xt.to(ACCUM) @ tp.copy_to_model(
            sh["gate"].to(ACCUM), "experts"))
        y = y + (sh_out * sh_gate).to(dt)
    y = tp.reduce_from_model(y, "experts")

    # Switch-style load-balancing loss of each chunk of the whole
    # microbatch, then their mean (the same value on every data rank, and
    # on every rank of a model group)
    frac_tokens = counts.to(ACCUM) / (n // t * top_k)
    mean_prob = psum / (n // t)
    aux = n_experts * torch.sum(frac_tokens * mean_prob, dim=-1)
    return y.reshape(b, s, d), tp.once_over_model(torch.mean(aux), "experts")
