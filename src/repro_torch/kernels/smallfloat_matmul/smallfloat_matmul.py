"""Launch wrappers for the CUDA smallfloat matmul
(``csrc/smallfloat_matmul.cu``).

One kernel takes a chain of dense layers: (M, K) @ (K, N) with both
operands rounded to (wE, wF) on load (or left fp32 with
``exp_bits=None``), fp32 FMA accumulation on the CUDA cores, optional fp32
bias and ReLU, and the result optionally rounded to a format
(``out_fmt``); each layer's result is the next one's input, held in shared
memory.  :func:`smallfloat_matmul` launches a chain of one (any shape,
fp32 or bf16, strided operands), :func:`smallfloat_matmul_chain` a chain of
one or more fp32 layers.  ``smallfloat_matmul.launches`` counts the
launches of both.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from repro_torch.kernels import build
from repro_torch.kernels._checks import fmt_args, require, same_device
from repro_torch.kernels.smallfloat_matmul.ref import Dense

_INT_MAX = 2**31 - 1
#: rows per block of a chain of two or more (``kChainRows``)
CHAIN_ROWS = 4
#: the most layers one launch takes, and the widest inner activation
MAX_LAYERS, MAX_INNER = 8, 256
#: the shared memory an H100 grants a block: the chain rule's figure where
#: no card is asked (the plain versions on the CPU)
H100_SMEM_GRANT = 232_448
_grants: dict = {}


def chain_smem_bytes(dims: Sequence[int]) -> int:
    """Shared memory a chain of widths ``dims`` (K0, N0, N1, ...) needs:
    every layer's weights and biases, the block's input rows and two
    buffers of inner activations (``smem_bytes`` in the source)."""
    inner = max(dims[1:-1], default=1)
    floats = sum(n * (1 + k) for k, n in zip(dims[:-1], dims[1:]))
    return 4 * (floats + CHAIN_ROWS * ((dims[0] | 1) + 2 * (inner | 1)))


def smem_grant(device) -> int:
    """Bytes of shared memory the card grants one block (queried once per
    device); the H100's figure for a CPU device."""
    device = torch.device(device)
    if device.type != "cuda":
        return H100_SMEM_GRANT
    key = device.index if device.index is not None \
        else torch.cuda.current_device()
    if key not in _grants:
        out = ctypes.c_int(0)
        with torch.cuda.device(key):
            build.check(build.library().smallfloat_matmul_smem_grant(
                ctypes.byref(out)), "smallfloat_matmul")
        _grants[key] = out.value
    return _grants[key]


def chain_fits(dims: Sequence[int], device) -> bool:
    """Whether one launch takes a chain of two or more layers of widths
    ``dims``: at most ``MAX_LAYERS``, every inner width at most
    ``MAX_INNER``, every weight in the shared memory the card grants."""
    return (2 <= len(dims) - 1 <= MAX_LAYERS
            and max(dims[1:-1]) <= MAX_INNER
            and chain_smem_bytes(dims) <= smem_grant(device))


def _launch(x: torch.Tensor, layers: Sequence[Dense], exp_bits, man_bits
            ) -> torch.Tensor:
    words = []
    for ly in layers:
        oeb, omb = fmt_args(ly.out_fmt)
        words += [ly.w.data_ptr(),
                  ly.b.data_ptr() if ly.b is not None else 0,
                  ly.w.shape[0], ly.w.shape[1], ly.w.stride(0),
                  ly.w.stride(1), int(ly.relu), oeb, omb]
    eb, mb = fmt_args(None if exp_bits is None else (exp_bits, man_bits))
    m = x.shape[0]
    out = torch.empty((m, layers[-1].w.shape[1]), device=x.device,
                      dtype=torch.float32)
    if m == 0 or out.shape[1] == 0:
        return out
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = build.library().smallfloat_matmul_chain(
        x.data_ptr(), out.data_ptr(), m, x.stride(0), x.stride(1),
        len(layers), (ctypes.c_longlong * len(words))(*words), eb, mb,
        int(x.dtype == torch.bfloat16), stream)
    build.check(err, "smallfloat_matmul")
    smallfloat_matmul.launches += 1
    return out


def _check_layer(ly: Dense, k: int, x: torch.Tensor, name: str) -> None:
    require(ly.w, f"{name}.w", ndim=2, dtypes=(x.dtype,), contiguous=False)
    if ly.b is not None:
        require(ly.b, f"{name}.b", ndim=1)
    same_device(x, ly.w, ly.b)
    kw, n = ly.w.shape
    if kw != k or (ly.b is not None and ly.b.shape[0] != n):
        raise ValueError(f"{name}: w {tuple(ly.w.shape)}, b "
                         f"{None if ly.b is None else tuple(ly.b.shape)} "
                         f"do not follow an input of width {k}")
    if max(k * ly.w.stride(0), n * ly.w.stride(1), x.shape[0] * n) \
            > _INT_MAX:
        raise ValueError(f"{name}: operands too large for the kernel")


def smallfloat_matmul(x: torch.Tensor, w: torch.Tensor,
                      b: Optional[torch.Tensor] = None, *,
                      exp_bits: Optional[int] = 5,
                      man_bits: Optional[int] = 4,
                      fuse_relu: bool = False,
                      out_fmt: Optional[tuple[int, int]] = None
                      ) -> torch.Tensor:
    """x: (M, K), w: (K, N), both fp32 or both bf16, any strides (a
    transposed view is fine); b: contiguous fp32 (N,) -> contiguous fp32
    (M, N).  One launch: a chain of one."""
    require(x, "x", ndim=2, dtypes=(torch.float32, torch.bfloat16),
            contiguous=False)
    ly = Dense(w, b, fuse_relu, out_fmt)
    _check_layer(ly, x.shape[1], x, "w")
    return _launch(x, [ly], exp_bits, man_bits)


def smallfloat_matmul_chain(x: torch.Tensor, layers: Sequence[Dense], *,
                            exp_bits: Optional[int] = 5,
                            man_bits: Optional[int] = 4) -> torch.Tensor:
    """x: fp32 (M, K0), any strides; ``layers``: ``Dense(w, b, relu,
    out_fmt)`` with w fp32 (K_l, N_l), any strides, K_l = N_{l-1} ->
    contiguous fp32 (M, N_last), the last layer's result, in one launch.
    Raises ``ValueError`` for a chain of two or more that
    :func:`chain_fits` refuses."""
    require(x, "x", ndim=2, contiguous=False)
    if not layers:
        raise ValueError("a chain needs at least one layer")
    k = x.shape[1]
    for i, ly in enumerate(layers):
        _check_layer(ly, k, x, f"layers[{i}]")
        k = ly.w.shape[1]
    dims = [x.shape[1]] + [ly.w.shape[1] for ly in layers]
    if len(layers) > 1 and not chain_fits(dims, x.device):
        raise ValueError(
            f"chain of widths {dims}: one launch takes at most "
            f"{MAX_LAYERS} layers, inner widths <= {MAX_INNER} and "
            f"{smem_grant(x.device)} B of shared memory (it needs "
            f"{chain_smem_bytes(dims)} B)")
    return _launch(x, list(layers), exp_bits, man_bits)


smallfloat_matmul.launches = 0
