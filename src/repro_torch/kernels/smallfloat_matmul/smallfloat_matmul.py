"""Launch wrapper for the CUDA smallfloat matmul
(``csrc/smallfloat_matmul.cu``).

(M, K) @ (K, N) with both operands rounded to (wE, wF) on load (or left
fp32 with ``exp_bits=None``), fp32 FMA accumulation on the CUDA cores,
optional fp32 bias and ReLU, and the result optionally rounded to a
format (``out_fmt``) in the epilogue.  ``smallfloat_matmul.launches`` counts the
launches.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels._checks import fmt_args, require, same_device

_INT_MAX = 2**31 - 1


def smallfloat_matmul(x: torch.Tensor, w: torch.Tensor,
                      b: Optional[torch.Tensor] = None, *,
                      exp_bits: Optional[int] = 5,
                      man_bits: Optional[int] = 4,
                      fuse_relu: bool = False,
                      out_fmt: Optional[tuple[int, int]] = None
                      ) -> torch.Tensor:
    """x: (M, K), w: (K, N), both fp32 or both bf16, any strides (a
    transposed view is fine); b: contiguous fp32 (N,) -> contiguous fp32
    (M, N)."""
    dtypes = (torch.float32, torch.bfloat16)
    require(x, "x", ndim=2, dtypes=dtypes, contiguous=False)
    require(w, "w", ndim=2, dtypes=dtypes, contiguous=False)
    if b is not None:
        require(b, "b", ndim=1)
    same_device(x, w, b)
    if x.dtype != w.dtype:
        raise TypeError(f"x is {x.dtype} but w is {w.dtype}")
    m, k = x.shape
    k2, n = w.shape
    if k != k2 or (b is not None and b.shape[0] != n):
        raise ValueError(f"matmul shapes x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}, b "
                         f"{None if b is None else tuple(b.shape)}")
    if max(m * x.stride(0), k * x.stride(1), k * w.stride(0),
           n * w.stride(1), m * n) > _INT_MAX:
        raise ValueError("operands too large for the kernel's int32 "
                         "strides")
    eb, mb = fmt_args(None if exp_bits is None else (exp_bits, man_bits))
    oeb, omb = fmt_args(out_fmt)
    out = torch.empty((m, n), device=x.device, dtype=torch.float32)
    if m == 0 or n == 0:
        return out
    lib = build.library()
    launch = (lib.smallfloat_matmul_bf16 if x.dtype == torch.bfloat16
              else lib.smallfloat_matmul_f32)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = launch(x.data_ptr(), w.data_ptr(),
                 b.data_ptr() if b is not None else None, out.data_ptr(),
                 m, k, n, x.stride(0), x.stride(1), w.stride(0), w.stride(1),
                 eb, mb, int(fuse_relu), oeb, omb, stream)
    build.check(err, "smallfloat_matmul")
    smallfloat_matmul.launches += 1
    return out


smallfloat_matmul.launches = 0
