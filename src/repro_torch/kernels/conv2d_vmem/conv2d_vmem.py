"""Launch wrapper for the CUDA conv kernel (``csrc/conv2d_vmem.cu``).

Weights-resident direct convolution, one thread per output pixel: valid
padding, stride 1, NCHW, fp32 accumulation, optional (wE,wF) operand
quantisation, bias and ReLU — the loop-nest semantics of
``frontend.conv2d`` — and, in the epilogue, the result optionally rounded
to a format and a residual added.
``conv2d_vmem.launches`` counts the launches.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels._checks import fmt_args, require, same_device

#: the most dynamic shared memory one block may take on Hopper
SMEM_LIMIT = 232448


def conv2d_vmem(x: torch.Tensor, w: torch.Tensor,
                b: Optional[torch.Tensor] = None, *,
                fmt: Optional[tuple[int, int]] = None,
                fuse_relu: bool = False,
                out_fmt: Optional[tuple[int, int]] = None,
                residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: (B, Cin, H, W), w: (Cout, Cin, kh, kw), b: (Cout,) -> fp32
    (B, Cout, H-kh+1, W-kw+1), all contiguous fp32 on one CUDA device.

    ``fmt`` rounds the operands, ``out_fmt`` the result; ``residual``
    (the output's shape) is then added and the sum rounded to
    ``out_fmt`` too."""
    require(x, "x", ndim=4)
    require(w, "w", ndim=4)
    if b is not None:
        require(b, "b", ndim=1)
    if residual is not None:
        require(residual, "residual", ndim=4)
    same_device(x, w, b, residual)
    bsz, cin, h, wd = x.shape
    cout, cin2, kh, kw = w.shape
    if cin != cin2 or kh > h or kw > wd:
        raise ValueError(f"conv shapes x {tuple(x.shape)} and w "
                         f"{tuple(w.shape)} do not fit")
    if b is not None and b.shape[0] != cout:
        raise ValueError(f"bias {tuple(b.shape)} for {cout} channels")
    eb, mb = fmt_args(fmt)
    oeb, omb = fmt_args(out_fmt)
    out = torch.empty((bsz, cout, h - kh + 1, wd - kw + 1),
                      device=x.device, dtype=torch.float32)
    if residual is not None and residual.shape != out.shape:
        raise ValueError(f"residual {tuple(residual.shape)} for an output "
                         f"of {tuple(out.shape)}")
    if bsz == 0 or cout == 0:
        return out
    lib = build.library()
    smem = lib.conv2d_vmem_smem_bytes(cin, h, wd, cout, kh, kw)
    if smem > SMEM_LIMIT:
        raise ValueError(f"conv2d_vmem stages a tile of {cin}x{kh}x{kw} "
                         f"weights in {smem} B of shared memory, over the "
                         f"{SMEM_LIMIT} B a block may take")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.conv2d_vmem_f32(
        x.data_ptr(), w.data_ptr(), b.data_ptr() if b is not None else None,
        residual.data_ptr() if residual is not None else None,
        out.data_ptr(), bsz, cin, h, wd, cout, kh, kw, eb, mb,
        int(fuse_relu), oeb, omb, stream)
    build.check(err, "conv2d_vmem")
    conv2d_vmem.launches += 1
    return out


conv2d_vmem.launches = 0
