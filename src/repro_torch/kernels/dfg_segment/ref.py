"""Plain PyTorch version of the DFG-segment kernel: the reference's
``_segment_body`` over the port's value-major ``(n_values, batch)`` buffer.

Group by group: gather each operand, compute through
:data:`repro_torch.kernels.registry.OPCODE_KERNELS`, re-quantise where
flagged, and scatter, as the kernel does (every group, also where the
planner elided the scatter).  Result slots at ``n_values`` (ops without a
destination) are dropped.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.precision import FloatFormat, quantize
from repro_torch.kernels.dfg_segment.dfg_segment import (
    DESC_WIDTH, FLAG_DROPS, FLAG_QUANT, SEGMENT_OPCODES)


def dfg_segment_ref(buf: torch.Tensor, idx: torch.Tensor,
                    desc: torch.Tensor, *,
                    fmt: Optional[tuple[int, int]] = None) -> torch.Tensor:
    """Same arguments and result as the kernel: ``buf`` updated in place.

    ``desc`` may lie on the CPU whatever the buffer's device: then the
    version queues its work without waiting for the card."""
    from repro_torch.kernels.registry import OPCODE_KERNELS

    if desc.dim() != 2 or desc.shape[1] != DESC_WIDTH:
        raise ValueError(f"desc must be (n_groups, {DESC_WIDTH}), got "
                         f"{tuple(desc.shape)}")
    fmt_obj = FloatFormat(*fmt) if fmt is not None else None
    n_values = buf.shape[0]
    lidx = idx.long()
    for op, arity, *offs, roff, n, flags in desc.tolist():
        a = [buf.index_select(0, lidx[o:o + n]) for o in offs[:arity]]
        r = OPCODE_KERNELS[SEGMENT_OPCODES[op]][1](a)
        if flags & FLAG_QUANT:
            if fmt_obj is None:
                raise ValueError("a group is flagged for re-quantisation "
                                 "but no fmt was given")
            r = quantize(r, fmt_obj)
        res = lidx[roff:roff + n]
        if flags & FLAG_DROPS:
            keep = res < n_values
            res, r = res[keep], r[keep]
        buf.index_copy_(0, res, r)
    return buf
