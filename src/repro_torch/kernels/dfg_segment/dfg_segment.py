"""Launch wrapper for the CUDA DFG-segment kernel (``csrc/dfg_segment.cu``).

One fused segment of the generic DFG tier: for each levelised
(level, opcode) group in order, gather the operands through the group's
index spans, compute the opcode, re-quantise, and scatter the result,
all in ONE launch over a value-major ``(n_values, batch)`` fp32 buffer
that the kernel updates in place.

The segment is described by two int32 arrays that the DFG tier builds
once per design (:func:`repro_torch.core.emit_cuda._segment_layout`):
``idx`` concatenates every gather and scatter index span of the segment,
and ``desc`` holds one row of :data:`DESC_WIDTH` ints per group:

  ====  ===========================================================
  0     opcode, an index into :data:`SEGMENT_OPCODES`
  1     arity (1..3)
  2-4   offsets of the operand index spans in ``idx`` (0 if unused)
  5     offset of the result index span
  6     ops in the group (every span's length)
  7     flags: :data:`FLAG_QUANT` (re-quantise the result),
        :data:`FLAG_DROPS` (some ops have no destination: their result
        slot is ``n_values`` and is dropped)
  ====  ===========================================================

Every group's result is scattered, also where the planner elided the
scatter: only the matching gathers read those slots, so the values are
the same.  ``dfg_segment.launches`` counts the launches.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels._checks import fmt_args, require, same_device

#: opcodes a segment computes, in the kernel's numbering
SEGMENT_OPCODES = ("mulf", "addf", "subf", "divf", "sqrtf", "maxf", "minf",
                   "negf", "relu", "fmac", "load", "store", "copy")
SEGMENT_OPCODE_ID = {name: i for i, name in enumerate(SEGMENT_OPCODES)}
DESC_WIDTH = 8
FLAG_QUANT = 1
FLAG_DROPS = 2


def dfg_segment(buf: torch.Tensor, idx: torch.Tensor, desc: torch.Tensor,
                *, fmt: Optional[tuple[int, int]] = None) -> torch.Tensor:
    """buf: contiguous fp32 ``(n_values, batch)``, idx: int32 ``(n_idx,)``,
    desc: int32 ``(n_groups, DESC_WIDTH)``, all on one CUDA device ->
    ``buf``, updated in place.

    The whole segment is one persistent cooperative launch with a
    grid-wide barrier between groups.  ``fmt`` is the format of the
    groups flagged for re-quantisation."""
    require(buf, "buf", ndim=2)
    require(idx, "idx", ndim=1, dtypes=(torch.int32,))
    require(desc, "desc", ndim=2, dtypes=(torch.int32,))
    same_device(buf, idx, desc)
    if desc.shape[1] != DESC_WIDTH:
        raise ValueError(f"desc has {desc.shape[1]} columns, want "
                         f"{DESC_WIDTH}")
    n_values, batch = buf.shape
    if n_values * batch >= 2 ** 31:
        raise ValueError(f"a ({n_values}, {batch}) value buffer has "
                         f"2^31 or more elements; the kernel indexes a "
                         f"group's elements with 32-bit ints")
    eb, mb = fmt_args(fmt)
    n_groups = desc.shape[0]
    if n_groups == 0 or batch == 0:
        return buf
    stream = torch.cuda.current_stream(buf.device).cuda_stream
    err = build.library().dfg_segment_f32(
        buf.data_ptr(), idx.data_ptr(), desc.data_ptr(), n_groups,
        n_values, batch, eb, mb, stream)
    build.check(err, "dfg_segment")
    dfg_segment.launches += 1
    return buf


dfg_segment.launches = 0
