"""Plain PyTorch versions of slstm_scan and its backward: the reference's
``_slstm_scan`` step loop (``src/repro/nn/xlstm.py``), one step after
another, and the gradient jax.grad takes through it, as an explicit loop
over the steps in reverse (no autograd)."""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F


def slstm_scan_ref(x_pre: Sequence[torch.Tensor], rec: Sequence[torch.Tensor],
                   h: torch.Tensor, c: torch.Tensor, n: torch.Tensor,
                   m: torch.Tensor,
                   saves: Optional[Sequence[torch.Tensor]] = None
                   ) -> torch.Tensor:
    """x_pre: the gates' (i, f, z, o) preactivations, four (B, S, H, W);
    rec: their recurrent weights, four (H, W, W); h, c, n, m: the (B, H, W)
    state, written back in place; saves: None, or seven (B, S, H, W)
    tensors filled per step as the kernel fills them (pre_i, pre_f, pre_z,
    pre_o, then c, n, m after the step) -> hs (B, S, H, W), every step's h.
    All fp32 (any one float dtype here).  Differentiable: the loop reads
    copies of the state, so the write-back leaves autograd's saved tensors
    intact."""
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
        if saves is not None:
            for dst, src in zip(saves, (*pre, c, n, m)):
                dst[:, t] = src
    for dst, src in zip(state, (h, c, n, m)):
        dst.copy_(src)
    return torch.stack(hs, 1)


def _half_on_tie(a: torch.Tensor, b) -> torch.Tensor:
    """d max(a, b) / da as ``jnp.maximum``'s derivative: 1 where a > b, 0
    where a < b, 0.5 at a tie."""
    return (a > b).to(a.dtype) + 0.5 * (a == b).to(a.dtype)


def slstm_scan_backward_ref(dhs: torch.Tensor, rec: Sequence[torch.Tensor],
                            saves: Sequence[torch.Tensor], c0: torch.Tensor,
                            n0: torch.Tensor, m0: torch.Tensor
                            ) -> list[torch.Tensor]:
    """The gradients of the four preactivations x_pre (i, f, z, o), each
    (B, S, H, W), from ``dhs`` (B, S, H, W), the gradient of the forward's
    hs; ``saves``: the forward's seven per-step saves; c0, n0, m0: the
    (B, H, W) state the forward started from.  Steps in reverse; the
    gradients of c, n and m carried from step to step, and h's through
    the recurrent products ``dpre_g @ R_g^T``.  At a tie of the stabiliser's
    max, or of n with 1e-6, each side takes half (``jnp.maximum``'s
    derivative; ``torch.clamp`` would give n all of it)."""
    pre_s, c_s, n_s, m_s = saves[:4], saves[4], saves[5], saves[6]
    dx = [torch.empty_like(dhs) for _ in range(4)]
    dc = torch.zeros_like(c0)
    dn = torch.zeros_like(c0)
    dm = torch.zeros_like(c0)
    dh_rec = torch.zeros_like(c0)
    for t in reversed(range(dhs.shape[1])):
        pre = [p[:, t] for p in pre_s]
        c_prev, n_prev, m_prev = ((s[:, t - 1] for s in (c_s, n_s, m_s))
                                  if t else (c0, n0, m0))
        c, n = c_s[:, t], n_s[:, t]
        log_f = F.logsigmoid(pre[1])
        a = log_f + m_prev
        m_new = torch.maximum(a, pre[0])
        ig = torch.exp(pre[0] - m_new)
        fg = torch.exp(a - m_new)
        z = torch.tanh(pre[2])
        o = torch.sigmoid(pre[3])

        dh = dhs[:, t] + dh_rec
        inv = 1.0 / torch.clamp(n, min=1e-6)
        d_o = dh * c * inv
        dc_t = dc + dh * o * inv
        dn_t = dn - dh * o * c * inv * inv * _half_on_tie(n, 1e-6)
        dfg = dc_t * c_prev + dn_t * n_prev
        dig = dc_t * z + dn_t
        dz = dc_t * ig
        dc, dn = dc_t * fg, dn_t * fg
        dm_new = dm - dig * ig - dfg * fg
        wa = _half_on_tie(a, pre[0])
        dlog_f = dfg * fg + dm_new * wa
        dm = dfg * fg + dm_new * wa
        grads = (dig * ig + dm_new * (1.0 - wa),
                 dlog_f * torch.sigmoid(-pre[1]),
                 dz * (1.0 - z * z),
                 d_o * o * (1.0 - o))
        for dst, g in zip(dx, grads):
            dst[:, t] = g
        dh_rec = sum(torch.einsum("bhv,hwv->bhw", g, r)
                     for g, r in zip(grads, rec))
    return dx


def rec_grads(hs: torch.Tensor, h0: torch.Tensor,
              dx: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """The gradients of the four (H, W, W) recurrent weights:
    ``dR_g = sum_{b,t} h_{t-1}^T dpre_g,t`` per head, h_{-1} = h0 (B, H,
    W), from hs (B, S, H, W) and the preactivations' gradients ``dx``.
    One (H, W, B S) x (H, B S, W) product per gate, on either device."""
    b, s, nh, w = hs.shape
    h_prev = torch.cat([h0[:, None], hs[:, :-1]], 1)
    lhs = h_prev.permute(2, 3, 0, 1).reshape(nh, w, b * s)
    return [torch.matmul(lhs, g.permute(2, 0, 1, 3).reshape(nh, b * s, w))
            for g in dx]
