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

For training the forward may also fill :data:`SAVES`, per step, and
:func:`slstm_scan_backward` (``csrc/slstm_scan_backward.cu``) walks the
steps in reverse from them: the gradients of the four preactivations, one
launch per layer call, the same cluster layout reading R's rows.
``slstm_scan_backward.launches`` counts its launches.

Each launch is a custom op, ``torch.ops.repro_torch.slstm_scan`` and
``torch.ops.repro_torch.slstm_scan_backward``, whose outputs and state are
mutated arguments: the CUDA implementation is the ctypes launch, the fake
implementation (the dry-run's tensors without data) launches and counts
nothing, and the FLOP formula counts the recurrent products, 8·B·S·H·W²
for each of the two (the four gates' ``h @ R_g`` a step forward, the four
``dpre_g @ R_gᵀ`` back); the gating's elementwise work is not counted, as
``FlopCounterMode`` counts no elementwise op.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import build
from repro_torch.kernels._checks import require, same_device

#: blocks per (batch row, head), and threads per block: a block owns
#: ceil(W / CLUSTER) units and one thread per unit applies the gating
CLUSTER, THREADS = 8, 256
#: the widest head the kernel takes
MAX_WIDTH = CLUSTER * THREADS
#: what the forward saves for the backward, per step: the four gates'
#: preactivations, and the state after the step
SAVES = ("pre_i", "pre_f", "pre_z", "pre_o", "c", "n", "m")


def _check(name: str, seqs: dict, rec: Sequence[torch.Tensor],
           states: dict) -> tuple[int, ...]:
    """Raise unless ``seqs`` (name -> (B, S, H, W)), the four (H, W, W)
    ``rec`` and ``states`` (name -> (B, H, W)) are contiguous fp32 on one
    CUDA device with shapes that fit and R readable as float4;
    -> (B, S, H, W)."""
    for i, t in enumerate(rec):
        require(t, f"rec[{i}]", ndim=3)
    for k, t in seqs.items():
        require(t, k, ndim=4)
    for k, t in states.items():
        require(t, k, ndim=3)
    first = next(iter(seqs.values()))
    same_device(first, *seqs.values(), *rec, *states.values())
    b, s, nh, w = first.shape
    if any(t.shape != first.shape for t in seqs.values()) or any(
            t.shape != (nh, w, w) for t in rec) or any(
            t.shape != (b, nh, w) for t in states.values()):
        raise ValueError(
            f"{name} shapes {[(k, tuple(t.shape)) for k, t in seqs.items()]}"
            f", rec {[tuple(t.shape) for t in rec]}, state "
            f"{[(k, tuple(t.shape)) for k, t in states.items()]} do not fit")
    if not (1 <= w <= MAX_WIDTH and w % 4 == 0):
        raise ValueError(f"head width {w}: the kernel takes a multiple of "
                         f"4 up to {MAX_WIDTH}")
    return b, s, nh, w


def _aligned(rec: Sequence[torch.Tensor]) -> None:
    """Raise unless every R starts on 16 bytes (the kernels read it as
    float4); called in the launch, where the tensors have data."""
    if any(r.data_ptr() % 16 for r in rec):
        raise ValueError("rec: the kernel reads R as float4, so each must "
                         "start on a 16-byte boundary")


def slstm_scan(x_pre: Sequence[torch.Tensor], rec: Sequence[torch.Tensor],
               h: torch.Tensor, c: torch.Tensor, n: torch.Tensor,
               m: torch.Tensor,
               saves: Optional[Sequence[torch.Tensor]] = None
               ) -> torch.Tensor:
    """x_pre: four (B, S, H, W) preactivations (the gates i, f, z, o), rec:
    their four (H, W, W) recurrent weights, h, c, n, m: the (B, H, W)
    state, read and written in place; saves: None (serving), or seven
    (B, S, H, W) tensors the launch fills per step, in :data:`SAVES`'
    order; all contiguous fp32 on one CUDA device, W a multiple of 4 and R
    16-byte aligned (the kernel reads R as float4) -> hs (B, S, H, W)."""
    if len(x_pre) != 4 or len(rec) != 4:
        raise ValueError("slstm_scan takes the four gates i, f, z, o")
    if saves is not None and len(saves) != len(SAVES):
        raise ValueError(f"saves: the {len(SAVES)} tensors {SAVES}")
    seqs = {f"x_pre[{i}]": t for i, t in enumerate(x_pre)}
    seqs.update(zip(SAVES, saves or ()))
    b, s, nh, w = _check("slstm_scan", seqs, rec,
                         {"h": h, "c": c, "n": n, "m": m})
    out = torch.empty_like(x_pre[0])
    if b * s * nh == 0:
        return out
    torch.ops.repro_torch.slstm_scan(x_pre, rec, h, c, n, m, out,
                                     saves or [])
    return out


@torch.library.custom_op("repro_torch::slstm_scan",
                         mutates_args=("h", "c", "n", "m", "out", "saves"),
                         device_types="cuda")
def _launch(x_pre: Sequence[torch.Tensor], rec: Sequence[torch.Tensor],
            h: torch.Tensor, c: torch.Tensor, n: torch.Tensor,
            m: torch.Tensor, out: torch.Tensor,
            saves: Sequence[torch.Tensor]) -> None:
    """One launch of the forward on tensors :func:`slstm_scan` checked
    (``saves`` empty: none)."""
    _aligned(rec)
    b, s, nh, w = out.shape
    ptrs = ctypes.c_void_p * 4
    stream = torch.cuda.current_stream(h.device).cuda_stream
    err = build.library().slstm_scan_f32(
        ptrs(*(t.data_ptr() for t in x_pre)),
        ptrs(*(t.data_ptr() for t in rec)), h.data_ptr(), c.data_ptr(),
        n.data_ptr(), m.data_ptr(), out.data_ptr(),
        (ctypes.c_void_p * 7)(*(t.data_ptr() for t in saves))
        if saves else None, b, s, nh, w, stream)
    build.check(err, "slstm_scan")
    slstm_scan.launches += 1


@_launch.register_fake
def _(x_pre, rec, h, c, n, m, out, saves) -> None:
    return None


def _recurrent_flops(seq_shape) -> int:
    """The four gates' W x W products per (batch row, step, head)."""
    b, s, nh, w = seq_shape
    return 2 * 4 * b * s * nh * w * w


@register_flop_formula(torch.ops.repro_torch.slstm_scan)
def _flops(x_pre_shapes, *args, **kwargs) -> int:
    return _recurrent_flops(x_pre_shapes[0])


slstm_scan.launches = 0


def slstm_scan_backward(dhs: torch.Tensor, rec: Sequence[torch.Tensor],
                        saves: Sequence[torch.Tensor], c0: torch.Tensor,
                        n0: torch.Tensor, m0: torch.Tensor
                        ) -> list[torch.Tensor]:
    """dhs: (B, S, H, W), the gradient of :func:`slstm_scan`'s hs; rec: the
    four (H, W, W) R; saves: the forward's seven (B, S, H, W) saves;
    c0, n0, m0: (B, H, W), the state the forward started from; all
    contiguous fp32 on one CUDA device -> the gradients of the four
    (B, S, H, W) preactivations x_pre (i, f, z, o)."""
    if len(rec) != 4 or len(saves) != len(SAVES):
        raise ValueError(f"slstm_scan_backward takes the four R and the "
                         f"{len(SAVES)} saves {SAVES}")
    seqs = {"dhs": dhs, **dict(zip(SAVES, saves))}
    b, s, nh, w = _check("slstm_scan_backward", seqs, rec,
                         {"c0": c0, "n0": n0, "m0": m0})
    dx = [torch.empty_like(dhs) for _ in range(4)]
    if b * s * nh == 0:
        return dx
    torch.ops.repro_torch.slstm_scan_backward(dhs, rec, saves, c0, n0, m0,
                                              dx)
    return dx


@torch.library.custom_op("repro_torch::slstm_scan_backward",
                         mutates_args=("dx",), device_types="cuda")
def _launch_backward(dhs: torch.Tensor, rec: Sequence[torch.Tensor],
                     saves: Sequence[torch.Tensor], c0: torch.Tensor,
                     n0: torch.Tensor, m0: torch.Tensor,
                     dx: Sequence[torch.Tensor]) -> None:
    """One launch of the backward on tensors :func:`slstm_scan_backward`
    checked."""
    _aligned(rec)
    b, s, nh, w = dhs.shape
    ptrs = ctypes.c_void_p * 4
    stream = torch.cuda.current_stream(dhs.device).cuda_stream
    err = build.library().slstm_scan_backward_f32(
        ptrs(*(t.data_ptr() for t in rec)), dhs.data_ptr(),
        (ctypes.c_void_p * 7)(*(t.data_ptr() for t in saves)),
        c0.data_ptr(), n0.data_ptr(), m0.data_ptr(),
        ptrs(*(t.data_ptr() for t in dx)), b, s, nh, w, stream)
    build.check(err, "slstm_scan_backward")
    slstm_scan_backward.launches += 1


@_launch_backward.register_fake
def _(dhs, rec, saves, c0, n0, m0, dx) -> None:
    return None


@register_flop_formula(torch.ops.repro_torch.slstm_scan_backward)
def _flops_backward(dhs_shape, *args, **kwargs) -> int:
    return _recurrent_flops(dhs_shape)


slstm_scan_backward.launches = 0
