"""Plain PyTorch version of slstm_scan: the reference's ``_slstm_scan``
step loop (``src/repro/nn/xlstm.py``), one step after another."""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F


def slstm_scan_ref(x_pre: Sequence[torch.Tensor], rec: Sequence[torch.Tensor],
                   h: torch.Tensor, c: torch.Tensor, n: torch.Tensor,
                   m: torch.Tensor) -> torch.Tensor:
    """x_pre: the gates' (i, f, z, o) preactivations, four (B, S, H, W);
    rec: their recurrent weights, four (H, W, W); h, c, n, m: the (B, H, W)
    state, written back in place -> hs (B, S, H, W), every step's h.  All
    fp32.  Differentiable: the loop reads copies of the state, so the
    write-back leaves autograd's saved tensors intact."""
    state = (h, c, n, m)
    h, c, n, m = (t.clone() for t in state)
    hs = []
    for t in range(x_pre[0].shape[1]):
        pre = [x[:, t] + torch.einsum("bhw,hwv->bhv", h, r)
               for x, r in zip(x_pre, rec)]
        log_f = F.logsigmoid(pre[1])
        m_new = torch.maximum(log_f + m, pre[0])
        i_p = torch.exp(pre[0] - m_new)
        f_p = torch.exp(log_f + m - m_new)
        c = f_p * c + i_p * torch.tanh(pre[2])
        n = f_p * n + i_p
        m = m_new
        h = torch.sigmoid(pre[3]) * c / torch.clamp(n, min=1e-6)
        hs.append(h)
    for dst, src in zip(state, (h, c, n, m)):
        dst.copy_(src)
    return torch.stack(hs, 1)
