"""Plain PyTorch version of the DFG-segment kernel: the reference's
``_segment_body`` over the port's value-major ``(n_values, batch)`` buffer.

Entry by entry, as the descriptor table lists them: gather each operand,
or take it from the entry of the same unit that holds it (a forwarded
value), compute through :data:`repro_torch.kernels.registry.OPCODE_KERNELS`,
re-quantise where flagged, and scatter unless the entry is flagged
elided.  So the kernel, this version and the reference body leave the
same whole buffer when they start from the same one.  Result slots at
``n_values`` (ops without a destination) are dropped.  It reads the table
on the host and waits for the card only where an entry drops results.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.precision import FloatFormat, quantize
from repro_torch.kernels.dfg_segment.dfg_segment import (
    COL_RES_SLOT, COL_SLOT, DESC_WIDTH, FLAG_DROPS, FLAG_ELIDED, FLAG_QUANT,
    SEGMENT_OPCODES)


def dfg_segment_ref(buf: torch.Tensor, idx: torch.Tensor,
                    desc: torch.Tensor, *,
                    fmt: Optional[tuple[int, int]] = None) -> torch.Tensor:
    """Same arguments and result as the kernel: ``buf`` updated in place.

    ``desc`` may lie on the CPU whatever the buffer's device: then the
    version queues its work without waiting for the card."""
    from repro_torch.kernels.registry import OPCODE_KERNELS

    if desc.dim() != 2 or desc.shape[1] != DESC_WIDTH:
        raise ValueError(f"desc must be (n_entries, {DESC_WIDTH}), got "
                         f"{tuple(desc.shape)}")
    fmt_obj = FloatFormat(*fmt) if fmt is not None else None
    n_values = buf.shape[0]
    lidx = idx.long()
    held: dict[int, torch.Tensor] = {}     # register slot -> values
    for row in desc.tolist():
        op, arity, offs, roff, n, flags = (row[0], row[1], row[2:5], row[5],
                                           row[6], row[7])
        slots = row[COL_SLOT:COL_SLOT + 3]
        a = [held[s] if s >= 0 else buf.index_select(0, lidx[o:o + n])
             for o, s in zip(offs[:arity], slots[:arity])]
        r = OPCODE_KERNELS[SEGMENT_OPCODES[op]][1](a)
        if flags & FLAG_QUANT:
            if fmt_obj is None:
                raise ValueError("an entry is flagged for re-quantisation "
                                 "but no fmt was given")
            r = quantize(r, fmt_obj)
        if row[COL_RES_SLOT] >= 0:
            held[row[COL_RES_SLOT]] = r
        if flags & FLAG_ELIDED:
            continue
        res = lidx[roff:roff + n]
        if flags & FLAG_DROPS:
            keep = res < n_values
            res, r = res[keep], r[keep]
        buf.index_copy_(0, res, r)
    return buf
