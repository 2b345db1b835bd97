"""Basic layers: norms, dense projections, embeddings, MLPs.

The reference's ``repro.nn.layers`` in torch.  Params are plain dicts
produced from the matching ``*_specs`` function; apply functions are pure.
Matmuls take their operands in the activation dtype (bf16 by default) and
accumulate in fp32 (:func:`matmul_f32`, the reference's
``preferred_element_type=float32``); norms run in fp32.  When a ``quant``
format is supplied, weights pass through the paper's (wE,wF) quantiser
first.

Under tensor parallelism (:mod:`repro_torch.nn.tensor_parallel`) the
products split Megatron's way over the logical axis the rules split: a
product whose output axis is split is column-parallel (its input's
gradient summed over ``model``), one whose input axis is split is
row-parallel (its partial sums all-reduced, a bias added once after), and
the embedding and the unembedding split over ``vocab``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.precision import FORMATS, quantize
from repro_torch.nn import tensor_parallel as tp
from repro_torch.nn.module import ParamSpec

ACCUM = torch.float32


def maybe_quantize(w: torch.Tensor, quant: Optional[str]) -> torch.Tensor:
    """``w`` rounded to the FloPoCo format ``quant`` (a ``FORMATS`` key), or
    ``w`` itself for ``None``."""
    return w if quant is None else quantize(w, FORMATS[quant])


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x (..., K) @ w (K, N)``, or a batch of products ``x (E, C, K) @
    w (E, K, N)`` (the experts'), summed in fp32 and returned in fp32.

    fp32 operands multiply as they are.  bf16 operands go to cuBLAS on the
    card with an fp32 result (``torch.mm``/``torch.bmm(...,
    out_dtype=float32)``, tensor cores, fp32 accumulation); ATen has no
    such kernel for the CPU, so there they are widened first (a weight may
    come widened already, once for many calls): a product of two bf16
    values is exact in fp32, so the widened product is the same fp32 sum.
    """
    if x.dtype == torch.float32:
        return x @ w
    if x.is_cuda:
        if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
            return _MatmulF32.apply(x, w)
        return _mm_f32(x, w)
    if w.dim() == 3:
        return torch.bmm(x.to(ACCUM), w.to(ACCUM))
    x2 = x.reshape(-1, x.shape[-1])
    y = x2.to(ACCUM) @ w.to(ACCUM)
    return y.reshape(*x.shape[:-1], w.shape[-1])


def _mm_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """bf16 operands on the card: cuBLAS with an fp32 result."""
    if w.dim() == 3:
        return torch.bmm(x, w, out_dtype=ACCUM)
    y = torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=ACCUM)
    return y.reshape(*x.shape[:-1], w.shape[-1])


class _MatmulF32(torch.autograd.Function):
    """:func:`matmul_f32` of bf16 operands on the card: cuBLAS with an fp32
    result, whose ``out_dtype`` overloads have no derivative in PyTorch.
    The backward takes the two products of the same kind on the cotangent
    rounded to the operands' dtype, each summed in fp32 and rounded once
    to that dtype: the gradients of bf16 operands are bf16, as the
    reference's VJP converts them."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _mm_f32(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        if w.dim() == 3:
            return (torch.bmm(g, w.transpose(1, 2)),
                    torch.bmm(x.transpose(1, 2), g))
        g2 = g.reshape(-1, g.shape[-1])
        return ((g2 @ w.T).reshape(x.shape),
                x.reshape(-1, x.shape[-1]).T @ g2)


def activation(name: str):
    return {
        "silu": F.silu,
        "gelu": lambda x: F.gelu(x, approximate="tanh"),
        "relu": torch.relu,
        "tanh": torch.tanh,
    }[name]


# -- norms -------------------------------------------------------------------

def rmsnorm_specs(d: int) -> dict:
    return {"scale": ParamSpec((d,), ("embed",), init="ones")}


def rmsnorm(p: dict, x: torch.Tensor, *, eps: float = 1e-6,
            zero_centered: bool = False) -> torch.Tensor:
    xf = x.to(ACCUM)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    scale = p["scale"].to(ACCUM)
    if zero_centered:           # gemma-style (1 + scale)
        scale = 1.0 + scale
    return (y * scale).to(x.dtype)


def layernorm_specs(d: int) -> dict:
    return {"scale": ParamSpec((d,), ("embed",), init="ones"),
            "bias": ParamSpec((d,), ("embed",), init="zeros")}


def layernorm(p: dict, x: torch.Tensor, *, eps: float = 1e-5
              ) -> torch.Tensor:
    xf = x.to(ACCUM)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"].to(ACCUM) + p["bias"].to(ACCUM)).to(x.dtype)


# -- dense -------------------------------------------------------------------

def dense_specs(d_in: int, d_out: int, *, axes: tuple = ("embed", "mlp"),
                bias: bool = False, bias_axis: Optional[str] = None) -> dict:
    out = {"kernel": ParamSpec((d_in, d_out), axes)}
    if bias:
        out["bias"] = ParamSpec((d_out,), (bias_axis,), init="zeros")
    return out


def dense(p: dict, x: torch.Tensor, *, quant: Optional[str] = None,
          out_axis: Optional[str] = None) -> torch.Tensor:
    """``x @ kernel + bias``.  ``out_axis``: the logical axis of the
    kernel's columns; where the rules split it over ``model`` the product
    is column-parallel (this rank's columns)."""
    dtype = x.dtype
    x = tp.copy_to_model(x, out_axis)
    w = maybe_quantize(p["kernel"], quant).to(dtype)
    y = matmul_f32(x, w)
    if "bias" in p:
        y = y + p["bias"].to(ACCUM)
    return y.to(dtype)


# -- embedding ----------------------------------------------------------------

def embedding_specs(vocab: int, d: int) -> dict:
    return {"table": ParamSpec((vocab, d), ("vocab", "embed"), scale=1.0)}


def embed(p: dict, ids: torch.Tensor, *, dtype=torch.bfloat16
          ) -> torch.Tensor:
    """The rows of ``ids``, cast after the gather: the reference casts the
    whole table first, which gives the same values.  Vocabulary-parallel
    where the rules split ``vocab``."""
    return tp.embedding(p["table"], ids, dtype)


def unembed(p: dict, x: torch.Tensor, *, quant: Optional[str] = None
            ) -> torch.Tensor:
    """Project to vocabulary logits (fp32) with the (possibly tied)
    table: this rank's columns where the rules split ``vocab``."""
    w = maybe_quantize(p["table"], quant).to(x.dtype)
    return matmul_f32(tp.copy_to_model(x, "vocab"), w.T)


# -- MLPs ---------------------------------------------------------------------

def mlp_specs(d: int, d_ff: int, *, gated: bool = True) -> dict:
    out = {
        "wi": ParamSpec((d, d_ff), ("embed", "mlp")),
        "wo": ParamSpec((d_ff, d), ("mlp", "embed")),
    }
    if gated:
        out["wg"] = ParamSpec((d, d_ff), ("embed", "mlp"))
    return out


def mlp(p: dict, x: torch.Tensor, *, act: str = "silu",
        quant: Optional[str] = None,
        reduce_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``reduce_dtype``: dtype of the row-parallel output projection whose
    partial sums cross devices (bf16 halves the TP all-reduce bytes): its
    fp32 sum is rounded to it before x's dtype.  Where the rules split
    ``mlp`` over ``model``, ``wi``/``wg`` are column-parallel and ``wo``
    row-parallel: each rank's fp32 partial is rounded to ``reduce_dtype``
    and then summed over ``model``."""
    f = activation(act)
    dtype = x.dtype
    x = tp.copy_to_model(x, "mlp")
    wi = maybe_quantize(p["wi"], quant).to(dtype)
    wo = maybe_quantize(p["wo"], quant).to(dtype)
    h = matmul_f32(x, wi)
    if "wg" in p:
        wg = maybe_quantize(p["wg"], quant).to(dtype)
        h = f(matmul_f32(x, wg)) * h
    else:
        h = f(h)
    out = matmul_f32(h.to(dtype), wo)
    out = tp.reduce_from_model(out.to(reduce_dtype or out.dtype), "mlp")
    return out.to(dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """Gemma-2 logit soft-capping: cap * tanh(x / cap)."""
    if not cap:
        return x
    return cap * torch.tanh(x / cap)
