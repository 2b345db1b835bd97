"""Public wrapper for the sLSTM time loop: the plain version for CPU
tensors, the CUDA kernels for CUDA tensors, and its gradient through an
``autograd.Function`` on both."""

from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.kernels.slstm_scan.ref import (rec_grads, slstm_scan_backward_ref,
                                                slstm_scan_ref)
from repro_torch.kernels.slstm_scan.slstm_scan import (SAVES, slstm_scan,
                                                       slstm_scan_backward)


class _Scan(torch.autograd.Function):
    """hs of the sLSTM, differentiable in x_pre and rec.

    Forward: the kernel on the card, the plain loop on the CPU, either
    filling the per-step saves (the preactivations and the state after
    each step); the state h, c, n, m is written in place, as the serving
    call writes it, and takes no gradient.  Backward: the backward kernel
    on the card, the plain reverse loop on the CPU, for the preactivations'
    gradients; the recurrent weights' as one product per gate
    (:func:`~repro_torch.kernels.slstm_scan.ref.rec_grads`)."""

    @staticmethod
    def forward(ctx, h, c, n, m, *xr):
        x_pre, rec = xr[:4], xr[4:]
        start = [t.clone() for t in (h, c, n, m)]
        saves = [torch.empty_like(x_pre[0]) for _ in SAVES]
        run = slstm_scan_ref if h.device.type == "cpu" else slstm_scan
        hs = run(x_pre, rec, h, c, n, m, saves=saves)
        ctx.save_for_backward(*rec, hs, *start, *saves)
        return hs

    @staticmethod
    def backward(ctx, dhs):
        saved = ctx.saved_tensors
        rec, hs, (h0, c0, n0, m0), saves = (saved[:4], saved[4], saved[5:9],
                                            saved[9:])
        dhs = dhs.contiguous()
        run = slstm_scan_backward_ref if dhs.device.type == "cpu" else \
            slstm_scan_backward
        dx = run(dhs, rec, saves, c0, n0, m0)
        drec = rec_grads(hs, h0, dx) if any(ctx.needs_input_grad[8:]) \
            else [None] * 4
        return (None,) * 4 + tuple(dx) + tuple(drec)


def scan(x_pre: Sequence[torch.Tensor], rec: Sequence[torch.Tensor],
         h: torch.Tensor, c: torch.Tensor, n: torch.Tensor, m: torch.Tensor
         ) -> torch.Tensor:
    """hs (B, S, H, W) of the sLSTM over x_pre's steps, the (B, H, W)
    state ``h, c, n, m`` updated in place (shapes as in
    :func:`slstm_scan`).

    Where autograd records and x_pre or rec needs a gradient, the call
    goes through :class:`_Scan`; the state is then a constant (training
    starts each sequence from zeros and ``m`` = -1e30), and a state that
    needs a gradient is refused.  Otherwise it is one launch of the kernel
    on the card, the plain step loop on the CPU."""
    if torch.is_grad_enabled():
        if any(t.requires_grad for t in (h, c, n, m)):
            raise ValueError(
                "slstm scan: the state h, c, n, m takes no gradient (the "
                "forward writes it in place); pass it detached")
        if any(t.requires_grad for t in (*x_pre, *rec)):
            return _Scan.apply(h, c, n, m, *x_pre, *rec)
    if h.device.type == "cpu":
        return slstm_scan_ref(x_pre, rec, h, c, n, m)
    return slstm_scan(x_pre, rec, h, c, n, m)
