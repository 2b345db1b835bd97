"""Gradient compression with error feedback.

Int8 deterministic (round-half-to-even) quantisation with per-tensor
scales and an error-feedback accumulator: the quantisation residual is
carried to the next step, so the compression bias vanishes asymptotically
(Karimireddy et al., "Error Feedback Fixes SignSGD").  Under data
parallelism the quantised gradients are what crosses the network: the
all-reduce payload drops 4x (f32 -> i8 + one f32 scale).  The collective
itself (the reference's ``compressed_psum``) comes with the port's mesh.
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


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8.  Returns (q, scale)."""
    amax = torch.max(torch.abs(x))
    scale = torch.clamp(amax / 127.0, min=1e-12)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_with_feedback(grads: Any, err: Any) -> tuple[Any, Any]:
    """Quantise (grads + carried error); return (dequantised grads, new err).

    The dequantised value is what the optimizer consumes; the difference is
    carried.  Communication happens on the int8 payload.
    """
    def one(g, e):
        g32 = g.to(torch.float32) + e
        q, s = quantize_int8(g32)
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
