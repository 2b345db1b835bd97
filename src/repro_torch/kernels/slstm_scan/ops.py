"""Public wrapper for the sLSTM time loop: the plain version for CPU
tensors, the CUDA kernel for CUDA tensors."""

from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.kernels.slstm_scan.ref import slstm_scan_ref
from repro_torch.kernels.slstm_scan.slstm_scan import slstm_scan


def scan(x_pre: Sequence[torch.Tensor], rec: Sequence[torch.Tensor],
         h: torch.Tensor, c: torch.Tensor, n: torch.Tensor, m: torch.Tensor
         ) -> torch.Tensor:
    """hs (B, S, H, W) of the sLSTM over x_pre's steps, the (B, H, W)
    state ``h, c, n, m`` updated in place (shapes as in
    :func:`slstm_scan`).

    On the CPU the plain step loop is differentiable, as the reference's
    ``lax.scan`` is.  The kernel has no backward yet: on the card a call
    that needs a gradient raises."""
    if h.device.type == "cpu":
        return slstm_scan_ref(x_pre, rec, h, c, n, m)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (*x_pre, *rec, h, c, n, m)):
        raise NotImplementedError(
            "slstm_scan has no backward kernel: xLSTM's training on the "
            "card waits for it, ROADMAP.md queue 1 item 8.5b")
    return slstm_scan(x_pre, rec, h, c, n, m)
