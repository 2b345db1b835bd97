"""xLSTM blocks (arXiv:2405.04517): the reference's ``repro.nn.xlstm`` in
torch.  mLSTM (matrix memory, chunkwise-parallel) and sLSTM (scalar
memory, sequential).

mLSTM is a linear-attention-style cell with exponential gating and a
max-stabiliser.  The prefill uses the chunkwise form: quadratic within a
chunk, the recurrent (C, n, m) state carried across chunks.  Where the
reference scans the chunks with ``lax.scan``, the port loops over them in
Python (S / chunk iterations of whole-tensor products, 4 at xlstm-1.3b's
prefill of 1,024).  Decode is one chunk of length 1.

sLSTM has state-dependent gating (recurrent R matrices, a shared
max-stabiliser) and cannot be parallelised over time.  Its time loop is
one launch of the ``slstm_scan`` kernel per layer call on the card
(:mod:`repro_torch.kernels.slstm_scan`), the prefill's and the decode
tick's alike; on the CPU the kernel's plain version runs the steps.  In
training the loop's gradient is one launch of ``slstm_scan_backward`` per
layer call (the plain reverse loop on the CPU).

Block structure follows the official xLSTM backbone: an mLSTM block with
projection factor 2 and a causal conv of width 4; an sLSTM block with a
gated FFN of factor 4/3.  A decode step writes its new state into the
cache it was given, in place (``copy_``, or the kernel's own writes): the
engine's captured decode step holds that cache.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels.slstm_scan import ops as slstm_ops
from repro_torch.nn.layers import matmul_f32, maybe_quantize, rmsnorm
from repro_torch.nn.module import ParamSpec
# the reference's _conv4: the same shifted adds, tap j against
# kernel[cw - 1 - j], summed in fp32 in that order
from repro_torch.nn.rglru import _causal_conv as _conv4

ACCUM = torch.float32
#: the stabiliser's start, and the log input gate of a padded step
M_INIT = -1e30
GATES = ("i", "f", "z", "o")


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def mlstm_block_specs(d: int, n_heads: int, *, proj_factor: int = 2,
                      conv_width: int = 4) -> dict:
    d_in = proj_factor * d
    dh = d_in // n_heads
    return {
        "up_main": {"kernel": ParamSpec((d, d_in), ("embed", "mlp"))},
        "up_gate": {"kernel": ParamSpec((d, d_in), ("embed", "mlp"))},
        "conv": {"kernel": ParamSpec((conv_width, d_in), (None, "mlp")),
                 "bias": ParamSpec((d_in,), ("mlp",), init="zeros")},
        "q": {"kernel": ParamSpec((d_in, n_heads, dh),
                                  ("mlp", "heads", "head_dim"))},
        "k": {"kernel": ParamSpec((d_in, n_heads, dh),
                                  ("mlp", "heads", "head_dim"))},
        "v": {"kernel": ParamSpec((d_in, n_heads, dh),
                                  ("mlp", "heads", "head_dim"))},
        "igate": {"kernel": ParamSpec((d_in, n_heads), ("mlp", "heads"),
                                      scale=0.02),
                  "bias": ParamSpec((n_heads,), ("heads",), init="zeros")},
        "fgate": {"kernel": ParamSpec((d_in, n_heads), ("mlp", "heads"),
                                      scale=0.02),
                  "bias": ParamSpec((n_heads,), ("heads",), init="ones")},
        "head_norm": {"scale": ParamSpec((n_heads, dh),
                                         ("heads", "head_dim"),
                                         init="ones")},
        "down": {"kernel": ParamSpec((d_in, d), ("mlp", "embed"))},
    }


def _cumsum(x: torch.Tensor) -> torch.Tensor:
    """``cumsum(x, dim=1)`` of (B, L, H) fp32 as one product with a
    lower-triangular matrix of ones in fp64, rounded to fp32: near exact,
    so the CPU and the card give the same sums, and deterministic, so a
    training step's replay equals its eager run (PyTorch flags its CUDA
    floating-point cumsum as nondeterministic; under
    ``torch.use_deterministic_algorithms`` it raises).  A decode step's
    one-row sum is its input."""
    l = x.shape[1]
    if l == 1:
        return x
    tri = torch.ones(l, l, dtype=torch.float64, device=x.device).tril()
    return torch.einsum("ts,bsh->bth", tri, x.double()).to(x.dtype)


def _mlstm_chunk(q, k, v, log_f, log_i, state):
    """One chunk of the stabilised chunkwise mLSTM.

    q, k, v: (B, L, H, D); log_f, log_i: (B, L, H) fp32;
    state: (C (B, H, D, D), n (B, H, D), m (B, H)), all fp32.
    Returns (h (B, L, H, D) fp32, new_state).
    """
    c_prev, n_prev, m_prev = state
    b, l, h, d = q.shape
    # the reference's fp32 1 / sqrt(d)
    scale = float(np.float32(1.0) / np.sqrt(np.float32(d)))
    qf, kf, vf = (t.to(ACCUM) for t in (q, k, v))
    f_cum = _cumsum(log_f)                              # inclusive (B,L,H)
    # intra-chunk log decays  D[t, s] = F_t - F_s + log_i_s  (s <= t)
    dmat = (f_cum[:, :, None, :] - f_cum[:, None, :, :]
            + log_i[:, None, :, :])                     # (B,T,S,H)
    causal = torch.ones(l, l, dtype=torch.bool, device=q.device).tril()
    dmat = torch.where(causal[None, :, :, None], dmat, -torch.inf)
    # stabiliser per (b, t, h): max over intra decays and inter decay
    b_inter = f_cum + m_prev[:, None, :]                # (B,L,H)
    m_t = torch.maximum(dmat.amax(dim=2), b_inter).clamp(min=M_INIT)
    w_intra = torch.exp(dmat - m_t[:, :, None, :])      # (B,T,S,H)
    w_inter = torch.exp(b_inter - m_t)                  # (B,T,H)

    qs = qf * scale
    scores = torch.einsum("bthd,bshd->btsh", qf, kf) * scale * w_intra
    num = torch.einsum("btsh,bshd->bthd", scores, vf)
    num = num + w_inter[..., None] * torch.einsum("bthd,bhde->bthe", qs,
                                                  c_prev)
    den_vec = torch.einsum("btsh,bshd->bthd", w_intra, kf)
    den = torch.einsum("bthd,bthd->bth", qs, den_vec)
    den = den + w_inter * torch.einsum("bthd,bhd->bth", qs, n_prev)
    den = torch.maximum(den.abs(), torch.exp(-m_t))
    h_out = num / den[..., None]

    # end-of-chunk state update
    f_last = f_cum[:, -1, :]                            # (B,H)
    tail = f_last[:, None, :] - f_cum + log_i           # (B,L,H)
    m_new = torch.maximum(f_last + m_prev, tail.amax(dim=1))
    decay = torch.exp(f_last + m_prev - m_new)          # (B,H)
    w_kv = torch.exp(tail - m_new[:, None, :])
    c_new = decay[..., None, None] * c_prev + torch.einsum(
        "bshd,bshe->bhde", w_kv[..., None] * kf, vf)
    n_new = decay[..., None] * n_prev + torch.einsum("bsh,bshd->bhd", w_kv,
                                                     kf)
    return h_out, (c_new, n_new, m_new)


def mlstm_cell(q, k, v, log_f, log_i, *, chunk: int = 256,
               state: Optional[tuple] = None):
    """Chunkwise mLSTM over a full sequence.  Shapes as in
    :func:`_mlstm_chunk`; chunk after chunk, the state carried."""
    b, s, h, d = q.shape
    if state is None:
        state = (torch.zeros(b, h, d, d, dtype=ACCUM, device=q.device),
                 torch.zeros(b, h, d, dtype=ACCUM, device=q.device),
                 torch.full((b, h), M_INIT, dtype=ACCUM, device=q.device))
    if s <= chunk:
        return _mlstm_chunk(q, k, v, log_f, log_i, state)
    pad = -s % chunk
    if pad:
        # padded steps carry zero input gates (log_i = -1e30) so they
        # contribute nothing, and their outputs are sliced off below
        # (causality protects the real positions)
        q, k, v = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (q, k, v))
        log_f = F.pad(log_f, (0, 0, 0, pad))
        log_i = F.pad(log_i, (0, 0, 0, pad), value=M_INIT)
    outs = []
    for c0 in range(0, s + pad, chunk):
        part = slice(c0, c0 + chunk)
        h_out, state = _mlstm_chunk(q[:, part], k[:, part], v[:, part],
                                    log_f[:, part], log_i[:, part], state)
        outs.append(h_out)
    return torch.cat(outs, dim=1)[:, :s], state


def mlstm_block(p: dict, x: torch.Tensor, *, n_heads: int, chunk: int = 256,
                cache: Optional[dict] = None, quant: Optional[str] = None
                ) -> tuple[torch.Tensor, Optional[dict]]:
    """The full mLSTM block.  cache (decode): {C, n, m, conv}, written in
    place and returned; None for the prefill."""
    dt = x.dtype
    b, s, _ = x.shape
    w_main = maybe_quantize(p["up_main"]["kernel"], quant).to(dt)
    w_gate = maybe_quantize(p["up_gate"]["kernel"], quant).to(dt)
    main = matmul_f32(x, w_main).to(dt)
    gate = matmul_f32(x, w_gate)
    conv_out, new_conv = _conv4(p["conv"], main,
                                cache["conv"] if cache else None)
    conv_act = F.silu(conv_out.to(ACCUM)).to(dt)

    def proj(name, src):
        w = maybe_quantize(p[name]["kernel"], quant).to(dt)
        d_in, h, dh = w.shape
        return matmul_f32(src, w.reshape(d_in, h * dh)).reshape(
            b, s, h, dh).to(dt)

    q = proj("q", conv_act)
    k = proj("k", conv_act)
    v = proj("v", main)
    act32 = conv_act.to(ACCUM)
    log_i = act32 @ p["igate"]["kernel"].to(ACCUM) \
        + p["igate"]["bias"].to(ACCUM)
    f_pre = act32 @ p["fgate"]["kernel"].to(ACCUM) \
        + p["fgate"]["bias"].to(ACCUM)
    log_f = F.logsigmoid(f_pre)

    if cache is not None:
        h, (c_new, n_new, m_new) = _mlstm_chunk(
            q, k, v, log_f, log_i, (cache["C"], cache["n"], cache["m"]))
        for name, new in (("C", c_new), ("n", n_new), ("m", m_new),
                          ("conv", new_conv)):
            cache[name].copy_(new)
    else:
        h, _ = mlstm_cell(q, k, v, log_f, log_i, chunk=chunk)

    # per-head norm, flatten, gate, project down.  h is fp32, so the gate
    # and the down projection meet it in fp32, as the reference's type
    # promotion has them
    h = rmsnorm({"scale": p["head_norm"]["scale"].reshape(-1)},
                h.reshape(b, s, -1))
    h = h * F.silu(gate).to(dt)
    w_down = maybe_quantize(p["down"]["kernel"], quant).to(dt)
    return matmul_f32(h, w_down.to(h.dtype)).to(dt), cache


def init_mlstm_cache(batch: int, d: int, n_heads: int, *,
                     proj_factor: int = 2, conv_width: int = 4,
                     conv_dtype=torch.bfloat16, device=None) -> dict:
    d_in = proj_factor * d
    dh = d_in // n_heads
    return {
        "C": torch.zeros(batch, n_heads, dh, dh, dtype=ACCUM, device=device),
        "n": torch.zeros(batch, n_heads, dh, dtype=ACCUM, device=device),
        "m": torch.full((batch, n_heads), M_INIT, dtype=ACCUM,
                        device=device),
        "conv": torch.zeros(batch, conv_width - 1, d_in, dtype=conv_dtype,
                            device=device),
    }


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def slstm_block_specs(d: int, n_heads: int, *, conv_width: int = 4,
                      ffn_factor: float = 4.0 / 3.0) -> dict:
    w = d // n_heads
    ffn = int(d * ffn_factor)
    gates = {}
    for g in GATES:
        gates[g] = {
            "kernel": ParamSpec((d, n_heads, w),
                                ("embed", "heads", "head_dim"), scale=0.02),
            "rec": ParamSpec((n_heads, w, w), ("heads", "head_dim", None),
                             scale=0.02),
            "bias": ParamSpec((n_heads, w), ("heads", "head_dim"),
                              init="zeros"),
        }
    return {
        "conv": {"kernel": ParamSpec((conv_width, d), (None, "embed")),
                 "bias": ParamSpec((d,), ("embed",), init="zeros")},
        "gates": gates,
        "head_norm": {"scale": ParamSpec((n_heads, w),
                                         ("heads", "head_dim"),
                                         init="ones")},
        "ffn_up": {"kernel": ParamSpec((d, 2 * ffn), ("embed", "mlp"))},
        "ffn_down": {"kernel": ParamSpec((ffn, d), ("mlp", "embed"))},
    }


def slstm_block(p: dict, x: torch.Tensor, *, n_heads: int,
                cache: Optional[dict] = None, quant: Optional[str] = None
                ) -> tuple[torch.Tensor, Optional[dict]]:
    """sLSTM block with causal conv and gated FFN.

    cache (decode): {h, c, n, m: (B, H, W) fp32, conv}, written in place
    (the state by the time loop itself) and returned; None for the
    prefill.
    """
    dt = x.dtype
    b, s, d = x.shape
    w = d // n_heads
    xc, new_conv = _conv4(p["conv"], x, cache["conv"] if cache else None)
    xc = F.silu(xc.to(ACCUM))
    x32 = x.to(ACCUM)
    x_pre = [matmul_f32(xc if g in ("i", "f") else x32,
                        p["gates"][g]["kernel"].to(ACCUM).reshape(d, d))
             .reshape(b, s, n_heads, w) + p["gates"][g]["bias"].to(ACCUM)
             for g in GATES]
    rec = [p["gates"][g]["rec"].to(ACCUM) for g in GATES]
    if cache is not None:
        hs = slstm_ops.scan(x_pre, rec, cache["h"], cache["c"], cache["n"],
                            cache["m"])
        cache["conv"].copy_(new_conv)
    else:
        state = init_slstm_cache(b, d, n_heads, device=x.device)
        hs = slstm_ops.scan(x_pre, rec, state["h"], state["c"], state["n"],
                            state["m"])

    y = rmsnorm({"scale": p["head_norm"]["scale"].reshape(-1)},
                hs.reshape(b, s, d).to(dt))
    # gated FFN (factor 4/3)
    w_up = maybe_quantize(p["ffn_up"]["kernel"], quant).to(dt)
    u1, u2 = matmul_f32(y, w_up).chunk(2, dim=-1)
    u = (F.gelu(u1, approximate="tanh") * u2).to(dt)
    w_dn = maybe_quantize(p["ffn_down"]["kernel"], quant).to(dt)
    return matmul_f32(u, w_dn).to(dt), cache


def init_slstm_cache(batch: int, d: int, n_heads: int, *,
                     conv_width: int = 4, conv_dtype=torch.bfloat16,
                     device=None) -> dict:
    w = d // n_heads
    return {
        "h": torch.zeros(batch, n_heads, w, dtype=ACCUM, device=device),
        "c": torch.zeros(batch, n_heads, w, dtype=ACCUM, device=device),
        "n": torch.zeros(batch, n_heads, w, dtype=ACCUM, device=device),
        "m": torch.full((batch, n_heads, w), M_INIT, dtype=ACCUM,
                        device=device),
        "conv": torch.zeros(batch, conv_width - 1, d, dtype=conv_dtype,
                            device=device),
    }
