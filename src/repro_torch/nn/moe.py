"""Mixture of Experts: the reference's ``repro.nn.moe`` in torch.

Routing follows Mixtral/Qwen2-MoE: an fp32 softmax router (padding experts
masked to -1e30, so their probability is exactly 0 and top-k never picks
one while ``top_k`` is at most the real experts), top-k with renormalised
gates, and (Qwen2-MoE) shared experts with a sigmoid gate.  Dispatch is the
reference's *sort-based* capacity dispatch: the assignments sorted by
expert (stable), each expert's first ``capacity`` of them copied into an
(E, capacity, d) buffer and the rest dropped.  The capacity comes from
shapes only, and nothing here reads a value back to the host (counts by
``scatter_add_``, no ``one_hot``, ``bincount`` or boolean mask), so a decode
step is static and captures into a CUDA graph.

The three expert products take their operands in the activation dtype and
sum in fp32 (:func:`~repro_torch.nn.layers.matmul_f32`); the reference
leaves them to XLA outside any Pallas kernel, and the port to cuBLAS.  The
expert weights are cast once per call, outside the loop over token chunks:
the cast is exact and the same each time, so the values are the
reference's per-chunk casts.

The combine adds a token's ``top_k`` contributions one after another in
ascending expert id, from zeros in the activation dtype: the order of the
reference's scatter-add over the sorted assignments.  An atomic
``index_add_`` there would add them in no fixed order, and at bf16 a
replayed step would then not equal the eager one.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

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
    """One chunk's routing and dispatch plan; the assignments (N·top_k of
    them) in sorted order, by expert and then by token."""

    probs: torch.Tensor        #: (N, E) router probabilities, fp32
    counts: torch.Tensor       #: (E,) assignments per expert
    order: torch.Tensor        #: (NK,) flat assignment of each sorted one
    token: torch.Tensor        #: (NK,) its token
    gate: torch.Tensor         #: (NK,) its renormalised gate, fp32
    keep: torch.Tensor         #: (NK,) 1.0 within the capacity, else 0.0
    slot: torch.Tensor         #: (NK,) its row of the (E·C, d) buffer
    capacity: int              #: C, rows per expert


def route(xt: torch.Tensor, w_router: torch.Tensor, *, n_experts: int,
          top_k: int, capacity_factor: float) -> Routing:
    """Router, top-k and the sort-based capacity dispatch of tokens ``xt``
    (N, d); ``w_router`` (d, E), E ≥ ``n_experts`` (the rest padding)."""
    n = xt.shape[0]
    dev = xt.device
    logits = xt.to(ACCUM) @ w_router.to(ACCUM)                  # (N, E)
    e_pad = logits.shape[-1]
    if e_pad > n_experts:                       # mask padding experts
        pad = torch.arange(e_pad, device=dev) >= n_experts
        logits = torch.where(pad, -1e30, logits)
    probs = torch.softmax(logits, dim=-1)
    gate, eidx = torch.topk(probs, top_k, dim=-1)               # (N, K)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)

    nk = n * top_k
    capacity = max(1, int(n * top_k / n_experts * capacity_factor))
    flat_e = eidx.reshape(nk)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    counts = torch.zeros(e_pad, dtype=torch.int64, device=dev).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(nk, device=dev) - starts[se]            # in expert
    return Routing(probs=probs, counts=counts, order=order,
                   token=order // top_k, gate=gate.reshape(nk)[order],
                   keep=(rank < capacity).to(ACCUM),
                   slot=se * capacity + torch.clamp(rank, max=capacity - 1),
                   capacity=capacity)


def _operand(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A weight cast to the activation dtype, as ``matmul_f32`` takes it.
    On the CPU it is widened here too, once, where ``matmul_f32`` would
    widen it in every chunk."""
    w = w.to(dtype)
    return w if w.is_cuda else w.to(ACCUM)


def _moe_tokens(xt: torch.Tensor, router: torch.Tensor, experts: dict,
                shared: Optional[dict], *, n_experts: int, top_k: int,
                capacity_factor: float, act: str
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The layer on one chunk of tokens ``xt`` (N, d): (y (N, d), aux)."""
    n, d = xt.shape
    f = activation(act)
    r = route(xt, router, n_experts=n_experts, top_k=top_k,
              capacity_factor=capacity_factor)
    e_pad = r.counts.shape[0]

    # dispatch: a dropped assignment adds an exact 0 to a clamped slot, so
    # the (atomic) index_add_ gives the same buffer in any order
    buf = torch.zeros(e_pad * r.capacity, d, dtype=xt.dtype,
                      device=xt.device)
    buf.index_add_(0, r.slot, xt[r.token] * r.keep[:, None].to(xt.dtype))
    buf = buf.reshape(e_pad, r.capacity, d)
    h = matmul_f32(buf, experts["wi"])
    g = matmul_f32(buf, experts["wg"])
    h = (f(g) * h).to(xt.dtype)
    out = matmul_f32(h, experts["wo"]).to(xt.dtype)             # (E, C, d)

    tok_out = out.reshape(e_pad * r.capacity, d)[r.slot]        # (NK, d)
    tok_out = tok_out * (r.gate * r.keep)[:, None].to(xt.dtype)
    # combine: each token's contributions at their sorted positions, which
    # ascend with the expert id, added in that order
    nk = r.order.numel()
    sorted_at = torch.empty_like(r.order)
    sorted_at[r.order] = torch.arange(nk, device=xt.device)
    contrib = tok_out[torch.sort(sorted_at.reshape(n, top_k), dim=1).values]
    y = torch.zeros((n, d), dtype=xt.dtype, device=xt.device)
    for j in range(top_k):
        y = y + contrib[:, j]

    if shared is not None:                                      # Qwen2-MoE
        hh = matmul_f32(xt, shared["wi"])
        gg = matmul_f32(xt, shared["wg"])
        hh = (f(gg) * hh).to(xt.dtype)
        sh_out = matmul_f32(hh, shared["wo"])
        sh_gate = torch.sigmoid(xt.to(ACCUM) @ shared["gate"])
        y = y + (sh_out * sh_gate).to(xt.dtype)

    # Switch-style load-balancing loss
    frac_tokens = r.counts.to(ACCUM) / max(nk, 1)               # f_e
    aux = n_experts * torch.sum(frac_tokens * torch.mean(r.probs, dim=0))
    return y, aux


def moe(p: dict, x: torch.Tensor, *, n_experts: int, top_k: int,
        capacity_factor: float = 1.25, act: str = "silu",
        quant: Optional[str] = None, token_chunks: int = 1
        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Apply the MoE layer.  x: (B, S, d).  Returns (y, aux_loss).

    ``n_experts`` is the number of *real* experts; the router masks any
    padding experts (columns n_experts..E-1 of the router kernel).

    ``token_chunks`` > 1 (when it divides B·S) routes the tokens in that
    many sequential chunks, each with its own capacity, and returns the
    mean of their ``aux``: which tokens drop depends on the chunking, so
    it is part of the result.
    """
    if not 0 < top_k <= n_experts:
        raise ValueError(f"top_k {top_k} of {n_experts} real experts")
    b, s, d = x.shape
    n = b * s
    q = lambda w: _operand(maybe_quantize(w, quant), x.dtype)  # noqa: E731
    experts = {k: q(v) for k, v in p["experts"].items()}
    shared = None
    if "shared" in p:
        shared = {k: q(p["shared"][k]) for k in ("wi", "wg", "wo")}
        shared["gate"] = p["shared"]["gate"].to(ACCUM)
    router = maybe_quantize(p["router"]["kernel"], quant).to(ACCUM)
    kw = dict(n_experts=n_experts, top_k=top_k,
              capacity_factor=capacity_factor, act=act)
    xt = x.reshape(n, d)
    if token_chunks > 1 and n % token_chunks == 0:
        outs = [_moe_tokens(xc, router, experts, shared, **kw)
                for xc in xt.chunk(token_chunks)]
        y = torch.cat([o[0] for o in outs])
        aux = torch.mean(torch.stack([o[1] for o in outs]))
    else:
        y, aux = _moe_tokens(xt, router, experts, shared, **kw)
    return y.reshape(b, s, d), aux
