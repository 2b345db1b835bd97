"""Launch wrapper for the CUDA DFG-segment kernel (``csrc/dfg_segment.cu``).

One fused segment of the generic DFG tier: for each levelised
(level, opcode) group in order, gather the operands through the group's
index spans (or take them forwarded from the group that computed them),
compute the opcode, re-quantise, and scatter the result unless the
planner elided the scatter, all in ONE launch over a value-major
``(n_values, batch)`` fp32 buffer that the kernel updates in place.

The segment is described by two int32 arrays that the DFG tier builds
once per design (:func:`repro_torch.core.emit_cuda._segment_layout`):
``idx`` concatenates every gather and scatter index span of the segment,
and ``desc`` holds one row of :data:`DESC_WIDTH` ints per entry.  An
entry computes one group; the entries come in **stages** (no entry gathers
from the buffer a slot that another entry of its stage scatters, so a
stage needs no barrier inside it) and, within a stage, in **units**
(entries of one length linked by forwarded operands, computed together
element by element with the forwarded values held per thread).  A
forwarded operand whose producer lies in an earlier stage is read from
the buffer if the producer was scattered, else the producer is computed
again in the consumer's unit by a *recompute* entry (its operands are
SSA values still in the buffer, so the same roundings give the same
bits).

  =======  ==========================================================
  0        opcode, an index into :data:`SEGMENT_OPCODES`
  1        arity (1..3)
  2-4      offsets of the operand index spans in ``idx`` (0 if unused)
  5        offset of the result index span
  6        ops in the group (every span's length)
  7        flags: :data:`FLAG_QUANT` (re-quantise the result),
           :data:`FLAG_DROPS` (some ops have no destination: their
           result slot is ``n_values`` and is dropped),
           :data:`FLAG_ELIDED` (no scatter), :data:`FLAG_STAGE` (the
           entry opens a stage: a barrier before it),
           :data:`FLAG_RECOMPUTE` (the entry computes again an elided
           group of an earlier stage; it is also flagged elided)
  8-10     per operand: the segment position of the group it is
           forwarded from, -1 for a gather from the buffer
  11-13    per operand: the unit's register slot it is read from, -1 for
           a gather from the buffer
  14       the slot the result is held in for later entries of the
           unit, -1 for none
  15       on a unit's first entry, the entries in the unit; else 0
  16       the segment position of the group the entry computes
  =======  ==========================================================

A unit holds at most :data:`MAX_SLOTS` forwarded values per element at a
time.  ``dfg_segment.launches`` counts the launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels._checks import fmt_args, require, same_device

#: opcodes a segment computes, in the kernel's numbering
SEGMENT_OPCODES = ("mulf", "addf", "subf", "divf", "sqrtf", "maxf", "minf",
                   "negf", "relu", "fmac", "load", "store", "copy")
SEGMENT_OPCODE_ID = {name: i for i, name in enumerate(SEGMENT_OPCODES)}
DESC_WIDTH = 17
FLAG_QUANT = 1
FLAG_DROPS = 2
FLAG_ELIDED = 4
FLAG_STAGE = 8
FLAG_RECOMPUTE = 16
#: columns of ``desc`` (see the module docstring)
COL_SRC, COL_SLOT, COL_RES_SLOT, COL_UNIT, COL_GROUP = 8, 11, 14, 15, 16
#: register slots per element a unit may hold (``kSlots`` in the kernel)
MAX_SLOTS = 4
#: samples per 16-byte vector: the kernel reads and writes four samples of
#: a row at a time, so every row of the buffer starts on 16 bytes
QUAD = 4


def value_buffer(n_values: int, batch: int, device) -> torch.Tensor:
    """An uninitialised value-major ``(n_values, batch)`` fp32 buffer as the
    kernel takes it: unit column stride and a row stride of ``batch``
    rounded up to a multiple of :data:`QUAD` (a view of the padded
    allocation when ``batch`` is not a multiple)."""
    ld = max(-(-batch // QUAD) * QUAD, QUAD)
    return torch.empty((n_values, ld), dtype=torch.float32,
                       device=device)[:, :batch]


def dfg_segment(buf: torch.Tensor, idx: torch.Tensor, desc: torch.Tensor,
                *, fmt: Optional[tuple[int, int]] = None) -> torch.Tensor:
    """buf: fp32 ``(n_values, batch)`` with rows that start on 16 bytes (as
    :func:`value_buffer` makes it), idx: int32 ``(n_idx,)``, desc: int32
    ``(n_entries, DESC_WIDTH)``, all on one CUDA device -> ``buf``, updated
    in place.

    One launch: a thread-block cluster per slab of consecutive samples
    walks the whole segment, with a cluster barrier between stages.
    ``fmt`` is the format of the entries flagged for re-quantisation."""
    require(buf, "buf", ndim=2, contiguous=False)
    require(idx, "idx", ndim=1, dtypes=(torch.int32,))
    require(desc, "desc", ndim=2, dtypes=(torch.int32,))
    same_device(buf, idx, desc)
    if desc.shape[1] != DESC_WIDTH:
        raise ValueError(f"desc has {desc.shape[1]} columns, want "
                         f"{DESC_WIDTH}")
    n_values, batch = buf.shape
    ld = buf.stride(0)
    if batch and (buf.stride(1) != 1 or ld % QUAD or ld < batch
                  or buf.data_ptr() % (4 * QUAD)):
        raise ValueError(f"buf: the kernel takes rows of unit stride that "
                         f"start on 16 bytes (row stride a multiple of "
                         f"{QUAD}), got strides {buf.stride()}; allocate "
                         f"it with value_buffer()")
    eb, mb = fmt_args(fmt)
    n_entries = desc.shape[0]
    if n_entries == 0 or batch == 0:
        return buf
    stream = torch.cuda.current_stream(buf.device).cuda_stream
    err = build.library().dfg_segment_f32(
        buf.data_ptr(), ld, idx.data_ptr(), desc.data_ptr(), n_entries,
        n_values, batch, eb, mb, stream)
    build.check(err, "dfg_segment")
    dfg_segment.launches += 1
    return buf


dfg_segment.launches = 0


def launch_shape(batch: int) -> dict:
    """How :func:`dfg_segment` launches for ``batch`` samples on the current
    card: the slab width in samples, the CTAs per cluster, and the clusters
    the card holds at once (``cudaOccupancyMaxActiveClusters``).  Raises if
    the card cannot hold one cluster."""
    out = (ctypes.c_int * 3)()
    build.check(build.library().dfg_segment_shape(int(batch),
                                                  ctypes.addressof(out)),
                "dfg_segment")
    return {"slab": out[0], "cluster": out[1], "active_clusters": out[2]}
