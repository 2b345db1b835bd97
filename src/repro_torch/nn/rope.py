"""Rotary position embeddings: standard, partial (StableLM) and M-RoPE
(Qwen2-VL multimodal 3-section rotary, arXiv:2409.12191).

The reference's ``repro.nn.rope`` in torch: angles, cos/sin and the
rotation in fp32, the result in the input's dtype.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

ACCUM = torch.float32


def _freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies for pairs (head_dim must be even), in fp32 as
    the reference computes them."""
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=ACCUM,
                                         device=device) / half))


def _rotate(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    """The fp32 rotation of x's two halves by ``ang`` (broadcast over
    heads)."""
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x.to(ACCUM), 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def rope(x: torch.Tensor, positions: torch.Tensor, *,
         theta: float = 10000.0, fraction: float = 1.0) -> torch.Tensor:
    """Apply RoPE.

    x:         (..., S, H, D)
    positions: (..., S)  integer positions
    fraction:  rotate only the first ``fraction`` of D (StableLM partial rope)
    """
    d = x.shape[-1]
    rot_d = int(d * fraction)
    rot_d -= rot_d % 2
    if rot_d == 0:
        return x
    x_rot, x_pass = x[..., :rot_d], x[..., rot_d:]
    inv = _freqs(rot_d, theta, x.device)                   # (rot_d/2,)
    ang = positions[..., None].to(ACCUM) * inv             # (..., S, rot_d/2)
    out = _rotate(x_rot, ang[..., None, :])
    return torch.cat([out.to(x.dtype), x_pass], dim=-1)


def mrope(x: torch.Tensor, positions_3d: torch.Tensor, *,
          sections: Sequence[int], theta: float = 10000.0) -> torch.Tensor:
    """Multimodal RoPE (Qwen2-VL): frequency bands split into (t, h, w)
    sections, each rotated by its own position stream.

    x:            (B, S, H, D)
    positions_3d: (B, 3, S) — temporal, height, width position ids
    sections:     per-section sizes in *pair* units; sum == D/2
    """
    d = x.shape[-1]
    if sum(sections) != d // 2:
        raise ValueError(f"sections {tuple(sections)} do not sum to "
                         f"{d // 2}")
    inv = _freqs(d, theta, x.device)                        # (half,)
    # the position stream per frequency band
    pos = torch.cat([positions_3d[:, i, :, None].expand(
        *positions_3d[:, i].shape, sec) for i, sec in enumerate(sections)],
        dim=-1).to(ACCUM)                                   # (B, S, half)
    return _rotate(x, (pos * inv)[..., None, :]).to(x.dtype)


def text_positions_3d(positions: torch.Tensor) -> torch.Tensor:
    """M-RoPE position stream for text-only input: t == h == w."""
    return torch.stack([positions, positions, positions], dim=1)


def rotate(x: torch.Tensor, positions: torch.Tensor, *, theta: float,
           fraction: float = 1.0,
           mrope_sections: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Rotate one of q, k with the configured scheme: x (..., S, H, D) at
    positions (..., S), or (B, 3, S) for M-RoPE."""
    if mrope_sections:
        if positions.dim() == 2:  # (B, S) text-only fallback
            positions = text_positions_3d(positions)
        return mrope(x, positions, sections=mrope_sections, theta=theta)
    return rope(x, positions, theta=theta, fraction=fraction)


def apply_rope(q: torch.Tensor, k: torch.Tensor, positions: torch.Tensor, *,
               theta: float, fraction: float = 1.0,
               mrope_sections: Optional[Sequence[int]] = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Rotate q and k with the configured scheme."""
    kw = dict(theta=theta, fraction=fraction, mrope_sections=mrope_sections)
    return rotate(q, positions, **kw), rotate(k, positions, **kw)
