"""Attention: GQA/MQA/MHA with causal, local-window (SWA) and
logit-softcapped variants, and full and rolling-window KV caches for
decode.

The reference's ``repro.nn.attention`` in torch.  Projections take their
operands in the activation dtype and sum in fp32; scores, softmax and the
probabilities-by-values product are fp32.  Prefill's and training's
self-attention at positions ``arange(S)`` runs the flash-attention kernel
(K5, ``kernels/flash_attention``), the reference's ``blockwise_attention``
forward on the card, with :func:`blockwise_grads` as its backward.  At a
caller's positions ((B, S), or (B, 3, S) for M-RoPE) it runs the
reference's own paths on either device: :func:`blockwise_attention` above
``block_size``, :func:`full_attention` up to it.  A one-token decode step
attends to the cache with :func:`full_attention`, as the reference does,
and so does the encoder-decoder's :func:`cross_attention` (no TPU kernel
serves it in the reference either).  ``attn_specs``, ``qkv_project`` and
``out_project`` also serve the transformer encoder block's tensor twin
(``models/transformer.py``).

Under tensor parallelism (:mod:`repro_torch.nn.tensor_parallel`) each
rank holds its block of the query heads, and of the KV heads where the
rules split them too; the projections are column-parallel, the output
projection row-parallel, and every function here works on the local heads
its weights give.  Where the KV heads are whole on every rank (their
count does not divide ``model``), each rank's query heads attend with
their own groups' KV heads (``tp.kv_heads``): prefill and training project
only those, their weights' gradients summed over ``model``; a decode step
projects and caches them all, the cache being whole there too.  Where the
rules split the head width (``head_dim``) instead, each rank projects its
columns of every head; prefill and training trade them for whole-width
rows, a block of the (batch x head) rows a rank, attend there with K5 and
trade back (:func:`_attend_rows`), and a decode step sums its one token's
partial scores over ``model`` (:func:`full_attention`'s ``partial``),
caching its columns.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.nn import tensor_parallel as tp
from repro_torch.nn.layers import maybe_quantize, matmul_f32, softcap
from repro_torch.nn.module import ParamSpec
from repro_torch.nn.rope import apply_rope, rotate

ACCUM = torch.float32
NEG_INF = -2.3819763e38  # large negative, safe in bf16/f32
#: the key position of an empty or out-of-window cache slot
INVALID_POS = -1_000_000


# -- specs -------------------------------------------------------------------

def attn_specs(d_model: int, n_heads: int, n_kv_heads: int, head_dim: int,
               *, qkv_bias: bool = False) -> dict:
    s = {
        "q": {"kernel": ParamSpec((d_model, n_heads, head_dim),
                                  ("embed", "heads", "head_dim"))},
        "k": {"kernel": ParamSpec((d_model, n_kv_heads, head_dim),
                                  ("embed", "kv_heads", "head_dim"))},
        "v": {"kernel": ParamSpec((d_model, n_kv_heads, head_dim),
                                  ("embed", "kv_heads", "head_dim"))},
        "o": {"kernel": ParamSpec((n_heads, head_dim, d_model),
                                  ("heads", "head_dim", "embed"))},
    }
    if qkv_bias:
        s["q"]["bias"] = ParamSpec((n_heads, head_dim),
                                   ("heads", "head_dim"), init="zeros")
        s["k"]["bias"] = ParamSpec((n_kv_heads, head_dim),
                                   ("kv_heads", "head_dim"), init="zeros")
        s["v"]["bias"] = ParamSpec((n_kv_heads, head_dim),
                                   ("kv_heads", "head_dim"), init="zeros")
    return s


def _project(sub: dict, x: torch.Tensor, quant: Optional[str]
             ) -> torch.Tensor:
    """x: (B, S, D) through one of q, k, v ((D, H, dh) and a bias) ->
    (B, S, H, dh) in x's dtype: the weight cast to x's dtype, fp32 sums
    and bias."""
    w = maybe_quantize(sub["kernel"], quant).to(x.dtype)
    d, h, k = w.shape
    y = matmul_f32(x, w.reshape(d, h * k)).reshape(*x.shape[:-1], h, k)
    if "bias" in sub:
        y = y + sub["bias"].to(ACCUM)
    return y.to(x.dtype)


def _heads(sub: dict, heads) -> dict:
    """One of k, v cut to the KV heads ``heads`` (:func:`tp.kv_heads`),
    its whole weights' gradients summed over ``model``: every rank holds
    them and uses a part."""
    return {n: tp.copy_to_model(w, "heads")[..., heads, :]
            for n, w in sub.items()}


def _split_axis() -> str:
    """The logical axis the projections split over ``model``: the head
    width where the rules split it, else the heads."""
    return "head_dim" if tp.is_split("head_dim") else "heads"


def qkv_project(p: dict, x: torch.Tensor, *, quant: Optional[str] = None,
                all_kv: bool = False
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> q, k, v: (B, S, H, dh) each, in x's dtype (``p``:
    the :func:`attn_specs` tree): the local heads under tensor
    parallelism (or the local columns of every head, where ``head_dim`` is
    split), k and v those of the local query heads' groups unless
    ``all_kv``."""
    x = tp.copy_to_model(x, _split_axis())
    q = _project(p["q"], x, quant)
    heads = None if all_kv else tp.kv_heads(q.shape[-2],
                                            p["k"]["kernel"].shape[1])
    k, v = (_project(p[n] if heads is None else _heads(p[n], heads), x,
                     quant) for n in ("k", "v"))
    return q, k, v


def out_project(p: dict, y: torch.Tensor, *, quant: Optional[str] = None,
                reduce_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """y: (B, S, H, dh) -> (B, S, D), in y's dtype (fp32 sums).
    ``reduce_dtype``: the dtype of the product, whose partial sums cross
    devices under tensor parallelism (bf16 halves that all-reduce's
    bytes); the result is rounded to it before y's dtype."""
    w = maybe_quantize(p["o"]["kernel"], quant).to(y.dtype)
    h, k, d = w.shape
    out = matmul_f32(y.reshape(*y.shape[:-2], h * k), w.reshape(h * k, d))
    out = tp.reduce_from_model(out.to(reduce_dtype or out.dtype),
                               _split_axis())
    return out.to(y.dtype)


# -- masks -------------------------------------------------------------------

def mask_bias(q_pos: torch.Tensor, k_pos: torch.Tensor, *, causal: bool,
              window: Optional[int]) -> torch.Tensor:
    """Additive fp32 mask bias of shape broadcastable to (..., Q, K).

    Negative key positions are the universal "invalid" sentinel (empty or
    padded cache slots) and are masked regardless of the causal/window
    flags — a bare causal test would *pass* for a negative sentinel since
    it looks like the distant past.
    """
    qp = q_pos[..., :, None]
    kp = k_pos[..., None, :]
    ok = kp >= 0
    if causal:
        ok = ok & (kp <= qp)
    if window is not None and window > 0:
        ok = ok & ((qp - kp) < window)
    return torch.where(ok, 0.0, NEG_INF).to(ACCUM)


# -- reference full-matrix attention -----------------------------------------

def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   q_pos: torch.Tensor, k_pos: torch.Tensor,
                   causal: bool = True, window: Optional[int] = None,
                   logit_cap: float = 0.0, partial: bool = False
                   ) -> torch.Tensor:
    """Materialised-scores attention (the decode step's, and a caller's
    positions up to ``block_size``).

    q: (B,S,H,D); k,v: (B,T,K,D); q_pos: (B,S); k_pos: (B,T).  Scores,
    softmax and sums are fp32 on widened operands; the probabilities are
    rounded to v's dtype before they meet v, as the reference rounds them
    (the flash kernel keeps them in fp32: at bf16 the decode step and
    prefill differ by that rounding).

    ``partial``: q, k and v are this rank's columns of the head width
    (``head_dim`` split over ``model``): the fp32 scores are summed over
    ``model`` before the scale, the soft-cap, the mask and the softmax,
    and the output is this rank's columns.
    """
    b, s, h, d = q.shape
    n_kv = k.shape[2]
    qr = q.reshape(b, s, n_kv, h // n_kv, d)
    scores = torch.einsum("bskgd,btkd->bkgst", qr.to(ACCUM), k.to(ACCUM))
    if partial:
        scores = tp.reduce_from_model(scores, "head_dim")
        d *= tp.ways("head_dim")
    # sqrt(d) rounds to the same fp32 as the reference's jnp.sqrt
    scores = scores / math.sqrt(d)
    scores = softcap(scores, logit_cap)
    bias = mask_bias(q_pos, k_pos, causal=causal, window=window)
    scores = scores + bias[:, None, None, :, :]
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", w.to(ACCUM), v.to(ACCUM))
    return out.reshape(b, s, h, -1).to(v.dtype)


# -- blockwise streaming attention, with its gradient -----------------------
#
# The reference's ``blockwise_attention`` and its ``jax.custom_vjp``
# (``src/repro/nn/attention.py:124-270``) ported from jnp to torch: a loop
# over key blocks with a running (max, denominator, accumulator), memory
# O(S x block) instead of O(S x T), numerically the full-matrix path.  It
# is not the plain version of a kernel: no TPU kernel has a backward, and
# the reference trains through this function.  Its backward recomputes
# each block's scores from the saved (out, m, l) instead of keeping every
# block's probabilities, and serves K5's training path too
# (``kernels/flash_attention/ops.py``), whose forward writes the rows'
# log-sum-exp in place of (m, l).

def _scale(d: int) -> float:
    """1/sqrt(d) rounded as the reference's fp32 ``1 / jnp.sqrt(d)``."""
    return float(1.0 / torch.sqrt(torch.tensor(float(d))))


def _blocks(k: torch.Tensor, v: torch.Tensor, k_pos: torch.Tensor,
            block_size: int):
    """(k, v, k_pos) blocks of ``block_size`` keys; the last one padded with
    zero keys at position ``INVALID_POS``, which every mask refuses."""
    pad = -k.shape[1] % block_size
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        k_pos = F.pad(k_pos, (0, pad), value=INVALID_POS)
    return zip(k.split(block_size, 1), v.split(block_size, 1),
               k_pos.split(block_size, 1))


def _block_scores(qr, kc, pc, q_pos, scale, causal, window, logit_cap):
    """(raw scores, masked and capped scores) of one key block, fp32
    (B, K, G, S, block): qr (B, S, K, G, D) and kc (B, block, K, D) fp32."""
    raw = torch.einsum("bskgd,btkd->bkgst", qr, kc) * scale
    bias = mask_bias(q_pos, pc, causal=causal, window=window)
    return raw, softcap(raw, logit_cap) + bias[:, None, None, :, :]


def _blockwise_fwd(q, k, v, q_pos, k_pos, causal, window, logit_cap,
                   block_size):
    """The streaming forward: out (B, S, K, G, D) fp32, m and l (B, K, G,
    S), each step in the reference's order."""
    b, s, h, d = q.shape
    n_kv = k.shape[2]
    g = h // n_kv
    qr = q.reshape(b, s, n_kv, g, d).to(ACCUM)
    scale = _scale(d)
    m = torch.full((b, n_kv, g, s), NEG_INF, dtype=ACCUM, device=q.device)
    l = torch.zeros((b, n_kv, g, s), dtype=ACCUM, device=q.device)
    acc = torch.zeros((b, s, n_kv, g, d), dtype=ACCUM, device=q.device)
    for kc, vc, pc in _blocks(k, v, k_pos, block_size):
        _, sc = _block_scores(qr, kc.to(ACCUM), pc, q_pos, scale, causal,
                              window, logit_cap)
        m_new = torch.maximum(m, sc.amax(-1))
        m_safe = torch.where(m_new == NEG_INF, 0.0, m_new)
        p = torch.exp(sc - m_safe[..., None])
        p = torch.where(sc == NEG_INF, 0.0, p)
        corr = torch.exp(torch.where(m == NEG_INF, NEG_INF, m - m_safe))
        l = l * corr + p.sum(-1)
        # the probabilities rounded to v's dtype, as the reference's are
        pv = torch.einsum("bkgst,btkd->bskgd", p.to(vc.dtype).to(ACCUM),
                          vc.to(ACCUM))
        acc = acc * corr.permute(0, 3, 1, 2)[..., None] + pv
        m = m_new
    l = torch.clamp(l, min=1e-37)
    return acc / l.permute(0, 3, 1, 2)[..., None], m, l


def blockwise_grads(q, k, v, q_pos, k_pos, out, m, l, do, *, causal: bool,
                    window: Optional[int], logit_cap: float,
                    block_size: int):
    """The reference's ``_blockwise_vjp_bwd``: (dq, dk, dv) in q's, k's
    and v's dtypes from the forward's fp32 ``out`` (B, S, K, G, D) and the
    rows' ``m`` and ``l`` (B, K, G, S), each key block's scores recomputed;
    ``l=None`` takes ``m`` as the rows' log-sum-exp (K5's).  The widened
    original q, k and v, fp32 throughout; a score at ``NEG_INF`` has
    probability 0, and the soft-cap's tanh is differentiated.  Grouped KV
    heads get the sum over their group, with no copy per group."""
    b, s, h, d = q.shape
    n_kv = k.shape[2]
    g = h // n_kv
    t = k.shape[1]
    qr = q.reshape(b, s, n_kv, g, d).to(ACCUM)
    scale = _scale(d)
    do_r = do.reshape(b, s, n_kv, g, d).to(ACCUM)
    delta = (do_r * out).sum(-1).permute(0, 2, 3, 1)          # (B,K,G,S)
    m_safe = torch.where(m == NEG_INF, 0.0, m)
    dq = torch.zeros((b, s, n_kv, g, d), dtype=ACCUM, device=q.device)
    dks, dvs = [], []
    for kc, vc, pc in _blocks(k, v, k_pos, block_size):
        kc, vc = kc.to(ACCUM), vc.to(ACCUM)
        raw, sc = _block_scores(qr, kc, pc, q_pos, scale, causal, window,
                                logit_cap)
        p = torch.exp(sc - m_safe[..., None])
        p = torch.where(sc == NEG_INF, 0.0, p)
        if l is not None:
            p = p / l[..., None]                              # (B,K,G,S,T)
        dp = torch.einsum("bskgd,btkd->bkgst", do_r, vc)
        ds = p * (dp - delta[..., None])
        if logit_cap:
            ds = ds * (1.0 - torch.tanh(raw / logit_cap) ** 2)
        dvs.append(torch.einsum("bkgst,bskgd->btkd", p, do_r))
        dks.append(torch.einsum("bkgst,bskgd->btkd", ds, qr) * scale)
        dq = dq + torch.einsum("bkgst,btkd->bskgd", ds, kc) * scale
    dk = torch.cat(dks, 1)[:, :t]
    dv = torch.cat(dvs, 1)[:, :t]
    return (dq.reshape(b, s, h, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


class _Blockwise(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, q_pos, k_pos, causal, window, logit_cap,
                block_size):
        out, m, l = _blockwise_fwd(q, k, v, q_pos, k_pos, causal, window,
                                   logit_cap, block_size)
        ctx.save_for_backward(q, k, v, q_pos, k_pos, out, m, l)
        ctx.opts = dict(causal=causal, window=window, logit_cap=logit_cap,
                        block_size=block_size)
        return out.reshape(q.shape).to(v.dtype)

    @staticmethod
    def backward(ctx, do):
        q, k, v, q_pos, k_pos, out, m, l = ctx.saved_tensors
        dq, dk, dv = blockwise_grads(q, k, v, q_pos, k_pos, out, m, l, do,
                                     **ctx.opts)
        return dq, dk, dv, None, None, None, None, None, None


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, q_pos: torch.Tensor, k_pos: torch.Tensor,
                        causal: bool = True, window: Optional[int] = None,
                        logit_cap: float = 0.0,
                        block_size: int = 512) -> torch.Tensor:
    """Exact streaming attention with a flash-style forward and backward:
    q (B,S,H,D), k/v (B,T,K,D), q_pos (B,S), k_pos (B,T) -> (B,S,H,D) in
    v's dtype."""
    return _Blockwise.apply(q, k, v, q_pos, k_pos, causal, window,
                            logit_cap, block_size)


# -- top-level self-attention ------------------------------------------------

def self_attention(p: dict, x: torch.Tensor,
                   positions: Optional[torch.Tensor] = None, *,
                   n_kv_heads: int, causal: bool = True,
                   window: Optional[int] = None, logit_cap: float = 0.0,
                   rope_theta: float = 10000.0, rope_fraction: float = 1.0,
                   mrope_sections=None, quant: Optional[str] = None,
                   block_size: Optional[int] = None,
                   reduce_dtype: Optional[torch.dtype] = None
                   ) -> torch.Tensor:
    """Self-attention for prefill and training (no cache).

    ``positions=None`` means ``arange(S)`` for every sequence: the flash
    kernel's contract, which it serves on the card (its plain version on
    the CPU), with a gradient.  A caller's positions ((B, S), or (B, 3, S)
    for M-RoPE) take the reference's paths on either device:
    :func:`blockwise_attention` when S > ``block_size``, else
    :func:`full_attention`.
    """
    q, k, v = qkv_project(p, x, quant=quant)
    b, s = x.shape[:2]
    pos = positions
    if pos is None:
        pos = torch.arange(s, device=x.device).expand(b, s)
    rope_kw = dict(theta=rope_theta, fraction=rope_fraction,
                   mrope_sections=mrope_sections)
    kw = dict(causal=causal, window=window, logit_cap=logit_cap)
    if tp.ways("head_dim") > 1:
        y = _attend_rows(q, k, v, pos, positions is not None, rope_kw, kw,
                         block_size)
    else:
        q, k = apply_rope(q, k, pos, **rope_kw)
        y = _attend(q, k, v, None if positions is None else pos, kw,
                    block_size)
    return out_project(p, y, quant=quant, reduce_dtype=reduce_dtype)


def _attend(q, k, v, positions, kw: dict, block_size: Optional[int]
            ) -> torch.Tensor:
    """Rotated q (B, S, H, D), k and v (B, S, K, D) -> (B, S, H, D): K5
    where ``positions`` is None (``arange(S)``), else the reference's
    paths at them ((B, S), or (B, 3, S) for M-RoPE)."""
    if positions is None:
        return flash_ops.attention(q, k, v, **kw)
    pos_1d = positions if positions.dim() == 2 else positions[:, 0, :]
    kw = dict(kw, q_pos=pos_1d, k_pos=pos_1d)
    if block_size is not None and q.shape[1] > block_size:
        return blockwise_attention(q, k, v, block_size=block_size, **kw)
    return full_attention(q, k, v, **kw)


def _runs(lo: int, hi: int, per: int) -> list:
    """(group, count) of each group of ``per`` consecutive rows that the
    rows [lo, hi) meet, in order."""
    out = []
    while lo < hi:
        g = lo // per
        end = min(hi, (g + 1) * per)
        out.append((g, end - lo))
        lo = end
    return out


def _repeat(t: torch.Tensor, runs: list, first: int = 0) -> torch.Tensor:
    """Row ``g - first`` of ``t`` ``count`` times for each (g, count) of
    ``runs``: views and one copy (its gradient a sum, with no atomics)."""
    return torch.cat([t[g - first:g - first + 1].expand(n, *t.shape[1:])
                      for g, n in runs])


def _as_rows(t: torch.Tensor) -> torch.Tensor:
    """(B, S, H, c) -> its (batch x head) rows (B * H, S, c)."""
    b, s, h, c = t.shape
    return t.permute(0, 2, 1, 3).reshape(b * h, s, c)


def _as_seqs(r: torch.Tensor, h: int) -> torch.Tensor:
    """(B * H, S, c) rows -> (B, S, H, c), contiguous."""
    n, s, c = r.shape
    return r.reshape(n // h, h, s, c).permute(0, 2, 1, 3).contiguous()


def _attend_rows(q, k, v, pos, given: bool, rope_kw: dict, kw: dict,
                 block_size: Optional[int]) -> torch.Tensor:
    """Attention where ``head_dim`` is split over ``model``: q (B, S, H,
    c), k and v (B, S, K, c) are this rank's columns of every head ->
    this rank's columns of the output (B, S, H, c).

    One all-to-all trades them for this rank's block of the (batch x
    query-head) rows at whole D (``tp.row_ranges``, ragged where the rows
    do not divide the ways) and the (batch x KV-head) rows those attend
    with (``tp.kv_ranges``); RoPE or M-RoPE runs there, on whole D, and
    the attention on those rows alone, each query row with its own KV
    row: K5 at ``arange(S)``, the reference's paths at a caller's
    positions (``given``).  One all-to-all trades the output back.  On
    one rank of ``model`` the exchange is the identity and
    :func:`self_attention` runs the unsplit path itself."""
    b, s, h, _ = q.shape
    n_kv = k.shape[2]
    rows = tp.row_ranges(b * h)
    kv = tp.kv_ranges(rows, h, n_kv)
    (lo, hi), (klo, khi) = rows[tp.index()], kv[tp.index()]
    qr, kr, vr = tp.to_rows([_as_rows(q), _as_rows(k), _as_rows(v)],
                            [rows, kv, kv])
    if hi == lo:
        y = qr
    else:
        q_pos = _repeat(pos, _runs(lo, hi, h))
        q1 = rotate(qr[:, :, None], q_pos, **rope_kw)
        k1 = rotate(kr[:, :, None], _repeat(pos, _runs(klo, khi, n_kv)),
                    **rope_kw)
        # a query row's KV row: rows of one group are consecutive
        groups = _runs(lo, hi, h // n_kv)
        y = _attend(q1, _repeat(k1, groups, klo),
                    _repeat(vr[:, :, None], groups, klo),
                    q_pos if given else None, kw, block_size)[:, :, 0]
    return _as_seqs(tp.to_cols(y, rows, b * h), h)


# -- KV caches ---------------------------------------------------------------

def init_kv_cache(batch: int, max_len: int, n_kv_heads: int, head_dim: int,
                  *, window: Optional[int] = None, dtype=torch.bfloat16,
                  device=None) -> dict:
    """Cache entry for one attention layer (bf16 k/v whatever the
    activation dtype, as the reference keeps them).

    Full cache:   k/v (B, max_len, K, D)
    Rolling SWA:  k/v (B, window, K, D) + kpos (B, window) actual positions
                  (-1 = empty), written at pos % window.
    """
    size = min(window, max_len) if window else max_len
    shape = (batch, size, n_kv_heads, head_dim)
    cache = {"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device)}
    if window:
        cache["kpos"] = torch.full((batch, size), -1, dtype=torch.int32,
                                   device=device)
    return cache


def _write_at(cache_arr: torch.Tensor, val: torch.Tensor,
              slot: torch.Tensor) -> None:
    """Write one step per sequence, ``val[b]`` (B, ...) into
    ``cache_arr[b, slot[b]]``, in place: O(1) work per step, and the cache
    (a view into the model's stacked cache) is never copied."""
    lanes = torch.arange(cache_arr.shape[0], device=cache_arr.device)
    cache_arr[lanes, slot] = val.to(cache_arr.dtype)


def decode_attention(p: dict, x: torch.Tensor, cache: dict,
                     pos: torch.Tensor, *, n_kv_heads: int,
                     window: Optional[int] = None, logit_cap: float = 0.0,
                     rope_theta: float = 10000.0, rope_fraction: float = 1.0,
                     mrope_sections=None, quant: Optional[str] = None
                     ) -> tuple[torch.Tensor, dict]:
    """One decode step: x (B,1,d), per-sequence positions pos (B,).

    Writes this step's k/v (and, for a window, its position) into
    ``cache`` in place and returns ``(out, cache)``; the reference returns
    an updated copy with the same values.
    """
    q, k, v = qkv_project(p, x, quant=quant, all_kv=True)
    split = tp.is_split("head_dim")
    if split:
        # RoPE pairs dim i with dim i + D/2, another rank's: the token's q
        # and k whole, in one gather
        h = q.shape[2]
        qk = tp.gather(torch.cat([q, k], dim=2), "head_dim")
        q, k = qk[:, :, :h], qk[:, :, h:]
    positions = pos[:, None]                                  # (B,1)
    if mrope_sections:
        positions = torch.stack([positions] * 3, dim=1)       # (B,3,1)
    q, k = apply_rope(q, k, positions, theta=rope_theta,
                      fraction=rope_fraction, mrope_sections=mrope_sections)
    if split:
        cols = tp.block(q.shape[-1], "head_dim")
        q, k = q[..., cols], k[..., cols]
    size = cache["k"].shape[1]
    slot = pos % size if window else torch.clamp(pos, max=size - 1)
    _write_at(cache["k"], k[:, 0], slot)
    _write_at(cache["v"], v[:, 0], slot)
    now = pos[:, None]
    if window:
        _write_at(cache["kpos"], pos, slot)
        k_pos = cache["kpos"]
        # valid = written and within window of the current position
        valid = (k_pos >= 0) & (now - k_pos < window) & (k_pos <= now)
    else:
        k_pos = torch.arange(size, device=x.device).expand(x.shape[0], size)
        valid = k_pos <= now
    k_pos = torch.where(valid, k_pos, INVALID_POS)
    heads = tp.kv_heads(q.shape[2], k.shape[2])
    ck, cv = (cache[n] if heads is None else cache[n][:, :, heads]
              for n in ("k", "v"))
    y = full_attention(q, ck, cv, q_pos=now, k_pos=k_pos, causal=True,
                       window=None, logit_cap=logit_cap, partial=split)
    return out_project(p, y, quant=quant), cache


# -- cross-attention (encoder-decoder) ---------------------------------------

def cross_attention(p: dict, x: torch.Tensor, enc: torch.Tensor, *,
                    n_kv_heads: int, quant: Optional[str] = None
                    ) -> torch.Tensor:
    """Decoder-to-encoder attention (no positional rotation, no mask) with
    the materialised scores of :func:`full_attention`.  x: (B, S, D)
    decoder states, enc: (B, T, D) the encoder's output; q from x, k and v
    from enc, each in its input's dtype."""
    q = _project(p["q"], x, quant)
    k = _project(p["k"], enc, quant)
    v = _project(p["v"], enc, quant)
    b, s = x.shape[:2]
    t = enc.shape[1]
    q_pos = torch.arange(s, device=x.device).expand(b, s)
    k_pos = torch.arange(t, device=x.device).expand(b, t)
    y = full_attention(q, k, v, q_pos=q_pos, k_pos=k_pos, causal=False)
    return out_project(p, y, quant=quant)
