"""Launch wrapper for the CUDA sLSTM time loop (``csrc/slstm_scan.cu``).

The sLSTM's whole sequence for one layer call in one launch: per step the
recurrent products ``h @ R_g`` of the four gates (i, f, z, o) per head,
the exponential gating with its max-stabiliser, and the new state, as the
reference's ``_slstm_scan`` computes them under ``lax.scan``.  No TPU
kernel computes this; the kernel replaces a Python loop of about 20
launches a step.  One thread-block cluster of :data:`CLUSTER` blocks per
(batch row, head) exchanges h through distributed shared memory, one
cluster barrier a step.  The state ``h, c, n, m`` is read at the start and
written back at the end, in place, so the engine's captured decode step
can hold it.  ``slstm_scan.launches`` counts the launches.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from repro_torch.kernels import build
from repro_torch.kernels._checks import require, same_device

#: blocks per (batch row, head), and threads per block: a block owns
#: ceil(W / CLUSTER) units and one thread per unit applies the gating
CLUSTER, THREADS = 8, 256
#: the widest head the kernel takes
MAX_WIDTH = CLUSTER * THREADS


def slstm_scan(x_pre: Sequence[torch.Tensor], rec: Sequence[torch.Tensor],
               h: torch.Tensor, c: torch.Tensor, n: torch.Tensor,
               m: torch.Tensor) -> torch.Tensor:
    """x_pre: four (B, S, H, W) preactivations (the gates i, f, z, o), rec:
    their four (H, W, W) recurrent weights, h, c, n, m: the (B, H, W)
    state, read and written in place; all contiguous fp32 on one CUDA
    device, W a multiple of 4 and R 16-byte aligned (the kernel reads R as
    float4) -> hs (B, S, H, W)."""
    if len(x_pre) != 4 or len(rec) != 4:
        raise ValueError("slstm_scan takes the four gates i, f, z, o")
    for i, t in enumerate(x_pre):
        require(t, f"x_pre[{i}]", ndim=4)
    for i, t in enumerate(rec):
        require(t, f"rec[{i}]", ndim=3)
    for t, name in ((h, "h"), (c, "c"), (n, "n"), (m, "m")):
        require(t, name, ndim=3)
    same_device(h, *x_pre, *rec, c, n, m)
    b, s, nh, w = x_pre[0].shape
    if any(t.shape != x_pre[0].shape for t in x_pre) or any(
            t.shape != (nh, w, w) for t in rec) or any(
            t.shape != (b, nh, w) for t in (h, c, n, m)):
        raise ValueError(
            f"slstm_scan shapes x_pre {[tuple(t.shape) for t in x_pre]}, "
            f"rec {[tuple(t.shape) for t in rec]}, state "
            f"{[tuple(t.shape) for t in (h, c, n, m)]} do not fit")
    if not (1 <= w <= MAX_WIDTH and w % 4 == 0):
        raise ValueError(f"head width {w}: the kernel takes a multiple of "
                         f"4 up to {MAX_WIDTH}")
    if any(r.data_ptr() % 16 for r in rec):
        raise ValueError("rec: the kernel reads R as float4, so each must "
                         "start on a 16-byte boundary")
    out = torch.empty_like(x_pre[0])
    if b * s * nh == 0:
        return out
    ptrs = ctypes.c_void_p * 4
    stream = torch.cuda.current_stream(h.device).cuda_stream
    err = build.library().slstm_scan_f32(
        ptrs(*(t.data_ptr() for t in x_pre)),
        ptrs(*(t.data_ptr() for t in rec)), h.data_ptr(), c.data_ptr(),
        n.data_ptr(), m.data_ptr(), out.data_ptr(), b, s, nh, w, stream)
    build.check(err, "slstm_scan")
    slstm_scan.launches += 1
    return out


slstm_scan.launches = 0
