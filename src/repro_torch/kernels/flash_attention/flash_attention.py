"""Launch wrapper for the CUDA flash-attention kernel
(``csrc/flash_attention.cu``).

Online-softmax attention over (BH, S, D) fp32 with heads pre-flattened
into BH, scale 1/sqrt(D), optionally causal, windowed and soft-capped —
the reference ``flash_attention``'s contract, any S and any D up to
``MAX_HEAD_DIM``.  The operands may be strided views, and may keep batch
and heads apart as (B, H, S, D).  For training the kernel also writes
each query row's log-sum-exp into a given ``lse`` buffer, which the
backward reads.  ``flash_attention.launches`` counts the launches.

The launch is the custom op ``torch.ops.repro_torch.flash_attention``
(``out`` and ``lse`` mutated): its CUDA implementation is the ctypes
launch; its fake implementation, for tensors without data (the dry-run's
``FakeTensorMode``), launches and counts nothing; its FLOP formula, for
``FlopCounterMode``, counts the full S_q x S_kv products, 4·B·H·S_q·S_kv·D,
causal or not, as torch's own ``sdpa_flop_count`` does, so the count
compares with a dot count of the reference's attention.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import build
from repro_torch.kernels._checks import require, same_device

#: the widest head the kernel takes
MAX_HEAD_DIM = 256


def _heads(t: torch.Tensor, name: str) -> tuple[int, int, list[int]]:
    """(B, H) and the element strides (B, H, S, D) of a 3-D (BH, S, D) or
    4-D (B, H, S, D) view."""
    if t.dim() == 3:
        return t.shape[0], 1, [t.stride(0), 0, t.stride(1), t.stride(2)]
    if t.dim() == 4:
        return t.shape[0], t.shape[1], list(t.stride())
    raise ValueError(f"{name}: expected (BH, S, D) or (B, H, S, D), got "
                     f"shape {tuple(t.shape)}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    logit_cap: float = 0.0,
                    out: Optional[torch.Tensor] = None,
                    lse: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: (BH, Sq, D), k/v: (BH, Skv, D) — or (B, H, S, D) — fp32 views on
    one CUDA device, any strides -> (BH, Sq, D), written into ``out`` (a
    view of q's shape, any strides) when it is given.  ``lse``, when
    given: a contiguous fp32 (B*H, Sq) tensor that receives each row's
    log-sum-exp, ``m + log(max(l, 1e-37))`` (``m`` 0 for a row that sees
    no key)."""
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        require(t, name, ndim=q.dim(), contiguous=False)
    same_device(q, k, v, out, lse)
    nb, nh, _ = _heads(q, "q")
    sq, d = q.shape[-2:]
    if (k.shape != v.shape or k.shape[:-2] != q.shape[:-2]
            or k.shape[-1] != d):
        raise ValueError(f"attention shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not fit")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {d}: the kernel takes 1 to "
                         f"{MAX_HEAD_DIM}")
    if out is None:
        out = torch.empty(q.shape, device=q.device, dtype=torch.float32)
    else:
        require(out, "out", ndim=q.dim(), contiguous=False)
        if out.shape != q.shape:
            raise ValueError(f"out {tuple(out.shape)} is not q's shape "
                             f"{tuple(q.shape)}")
    if lse is not None:
        require(lse, "lse", ndim=2)
        if tuple(lse.shape) != (nb * nh, sq):
            raise ValueError(f"lse {tuple(lse.shape)} is not (B*H, Sq) = "
                             f"{(nb * nh, sq)}")
    if q.numel() == 0:
        return out
    torch.ops.repro_torch.flash_attention(q, k, v, out, lse, bool(causal),
                                          int(window or 0), float(logit_cap))
    return out


@torch.library.custom_op("repro_torch::flash_attention",
                         mutates_args=("out", "lse"), device_types="cuda")
def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            out: torch.Tensor, lse: Optional[torch.Tensor], causal: bool,
            window: int, logit_cap: float) -> None:
    """One launch of the kernel on views :func:`flash_attention` checked."""
    nb, nh, q_strides = _heads(q, "q")
    sq, d = q.shape[-2:]
    strides = q_strides + _heads(k, "k")[2] + _heads(v, "v")[2] \
        + _heads(out, "out")[2]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = build.library().flash_attention_f32(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(),
        (ctypes.c_longlong * 16)(*strides), nb, nh, sq, k.shape[-2], d,
        int(causal), window, logit_cap, stream)
    build.check(err, "flash_attention")
    flash_attention.launches += 1


@_launch.register_fake
def _(q, k, v, out, lse, causal, window, logit_cap) -> None:
    return None


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _flops(q_shape, k_shape, *args, **kwargs) -> int:
    """4·(B·H)·S_q·S_kv·D: the scores and the weighted sum, every pair."""
    *lead, sq, d = q_shape
    return 4 * math.prod(lead) * sq * k_shape[-2] * d


def launch_shape(bh: int, sq: int, skv: int, d: int) -> dict:
    """The launch the kernel makes for these sizes on the current card:
    lanes per query row, head-dim chunk, query rows and heads per block,
    keys per staged tile, threads, shared memory, blocks, and the blocks
    and warps resident per SM."""
    vals = (ctypes.c_int * 10)()
    build.check(build.library().flash_attention_shape(bh, sq, skv, d, vals),
                "flash_attention")
    keys = ("lanes", "chunk", "rows", "heads", "keys_per_tile", "threads",
            "smem_bytes", "blocks", "blocks_per_sm", "warps_per_sm")
    return dict(zip(keys, vals))


flash_attention.launches = 0
