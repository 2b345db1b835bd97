"""Gradient compression with error feedback.

Int8 deterministic (round-half-to-even) quantisation with per-tensor
scales and an error-feedback accumulator: the quantisation residual is
carried to the next step, so the compression bias vanishes asymptotically
(Karimireddy et al., "Error Feedback Fixes SignSGD").  Under data
parallelism the quantised gradients are what crosses the network: the
all-reduce payload drops 4x (f32 -> i8 + one f32 scale).  Two forms, as in
the reference: ``compress_with_feedback`` quantises and dequantises the
train step's gradients (on a mesh, each rank its own block under one
per-tensor scale: ``reduce_max`` reduces the block maxima across ranks), and
``compressed_psum`` is the explicit collective: an int8 payload summed as
int32 over one mesh axis.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.nn.module import tree_flatten, tree_unflatten


def init_error_state(params: Any) -> Any:
    """Zero fp32 error accumulators shaped like ``params``."""
    leaves, treedef = tree_flatten(params)
    return tree_unflatten(treedef, [
        torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        for p in leaves])


def quantize_int8(x: torch.Tensor, reduce_max=None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8.  Returns (q, scale).  ``reduce_max``:
    where ``x`` is one block of a sharded tensor, the reduction (in place)
    of the block's max |x| to the whole tensor's."""
    amax = torch.max(torch.abs(x))
    if reduce_max is not None:
        reduce_max(amax)
    scale = torch.clamp(amax / 127.0, min=1e-12)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_with_feedback(grads: Any, err: Any, reduce_max=None
                           ) -> tuple[Any, Any]:
    """Quantise (grads + carried error); return (dequantised grads, new err).

    The dequantised value is what the optimizer consumes; the difference is
    carried.  Communication happens on the int8 payload.  ``reduce_max``:
    see :func:`quantize_int8` (the trees then hold this rank's blocks).
    """
    def one(g, e):
        g32 = g.to(torch.float32) + e
        q, s = quantize_int8(g32, reduce_max)
        deq = dequantize_int8(q, s)
        return deq.to(g.dtype), g32 - deq

    flat_g, treedef = tree_flatten(grads)
    flat_e = tree_flatten(err)[0]
    if len(flat_g) != len(flat_e):
        raise ValueError(f"grads have {len(flat_g)} leaves, the error "
                         f"state {len(flat_e)}")
    outs = [one(g, e) for g, e in zip(flat_g, flat_e)]
    return (tree_unflatten(treedef, [o[0] for o in outs]),
            tree_unflatten(treedef, [o[1] for o in outs]))


def compressed_psum(axis_name: str, mesh):
    """The compressed all-reduce over ``mesh``'s axis ``axis_name``: int8
    payload, int32 reduction.  ``reduce_fn(x)`` on every rank of the axis
    returns the sum, as the reference's does under ``shard_map``.

    Each rank quantises its ``x`` with its own scale; the payloads are
    summed as int32 and the scales reduced by their max, and the sum is
    the int32 total times that max scale: the reference's bound, kept
    exactly (a rank whose scale is below the max contributes its integers
    at the larger scale).
    """
    import torch.distributed as dist
    group = mesh.group(axis_name)

    def reduce_fn(x: torch.Tensor) -> torch.Tensor:
        q, s = quantize_int8(x.to(torch.float32))
        total = q.to(torch.int32)
        dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
        s_max = s.clone()
        dist.all_reduce(s_max, op=dist.ReduceOp.MAX, group=group)
        return (total.to(torch.float32) * s_max).to(x.dtype)
    return reduce_fn
