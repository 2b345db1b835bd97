"""FloPoCo-style reduced-precision floating point emulation (paper §3, §4.2).

OpenHLS delegates arithmetic to FloPoCo-generated cores parameterised by
(wE, wF) = (exponent bits, fraction bits).  FloPoCo's representation differs
from IEEE-754: **no subnormals** (values below the smallest normal flush to
zero) and two extra exception bits instead of reserved exponent codes, so a
(wE, wF) number occupies  1 + wE + wF + 2  wires — e.g. (5,4) is 12 bits,
which is exactly the width used in the paper's SLL-crossing computation
(§4.2: (1x16x9x9 + 1x8x9x9) x 12 = 23,328 > 23,040 SLLs).

We emulate the value lattice of these formats inside fp32 containers:
round-to-nearest-even on the fraction, exponent clamping with flush-to-zero
below ``emin`` and saturation above ``emax``.

Two quantisers with one contract: ``quantize_np`` (numpy, the functional
model's) and ``quantize`` (torch, the tensor path's and the CUDA kernels'
plain version).  They agree bitwise, including flush-to-zero, saturation,
signed zeros and the non-finite passthrough.  2^e is built from exponent
bits, never with ``exp2``, whose results on integer exponents are not
exact on every backend.  The CUDA kernels carry a third copy of the same
rounding as a device function (``csrc/quantize.cuh``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class FloatFormat:
    """A FloPoCo (wE, wF) floating-point format."""

    exp_bits: int
    man_bits: int
    name: str = ""

    @property
    def bias(self) -> int:
        return (1 << (self.exp_bits - 1)) - 1

    @property
    def emax(self) -> int:
        return self.bias

    @property
    def emin(self) -> int:
        return 1 - self.bias

    @property
    def max_value(self) -> float:
        return float((2.0 - 2.0 ** (-self.man_bits)) * 2.0 ** self.emax)

    @property
    def min_normal(self) -> float:
        return float(2.0 ** self.emin)

    @property
    def wire_bits(self) -> int:
        """Bits on a wire: sign + wE + wF + 2 exception bits (paper §4.2)."""
        return 1 + self.exp_bits + self.man_bits + 2

    def __str__(self) -> str:
        return self.name or f"({self.exp_bits},{self.man_bits})"


#: The three formats the paper steps through for BraggNN.
FP_5_11 = FloatFormat(5, 11, "(5,11)")   # ~IEEE half precision
FP_5_4 = FloatFormat(5, 4, "(5,4)")
FP_5_3 = FloatFormat(5, 3, "(5,3)")
FORMATS = {"5_11": FP_5_11, "5_4": FP_5_4, "5_3": FP_5_3}


def quantize_np(x: np.ndarray, fmt: FloatFormat) -> np.ndarray:
    """Numpy quantiser — used by the scalar-DFG functional models.
    RNE fraction rounding, FTZ, saturation."""
    x = np.asarray(x, dtype=np.float32)
    sign = np.sign(x)
    v = np.abs(x)
    # decompose |x| = f * 2^E with f in [0.5, 1)  ->  m = 2f in [1, 2)
    f, e = np.frexp(v)
    m = f * 2.0
    e = e - 1
    # round-to-nearest-even on the fraction
    scale = float(1 << fmt.man_bits)
    q = np.round((m - 1.0) * scale)
    carry = q >= scale
    m_q = np.where(carry, 1.0, 1.0 + q / scale)
    e_q = np.where(carry, e + 1, e)
    out = sign * m_q * np.exp2(e_q.astype(np.float32))
    # flush-to-zero below min normal (FloPoCo: no subnormals)
    out = np.where(v < fmt.min_normal * 0.5, 0.0, out)
    out = np.where((v >= fmt.min_normal * 0.5) & (v < fmt.min_normal),
                   sign * fmt.min_normal, out)
    # saturate above max finite (FloPoCo raises the overflow exception bit;
    # we saturate, which is the DNN-friendly policy)
    out = np.where(v > fmt.max_value, sign * fmt.max_value, out)
    # exact zeros / non-finites pass through
    out = np.where(v == 0.0, x, out)
    out = np.where(np.isfinite(x), out, x)
    return out.astype(np.float32)


def _pow2(e: torch.Tensor) -> torch.Tensor:
    """2^e as fp32 from its exponent bits (exact; 2^128 -> inf).

    Exponents below -126 would be subnormal and come out as 2^-126; every
    format with ``exp_bits <= 8`` flushes those magnitudes before they are
    read, which :func:`quantize` checks.
    """
    biased = (e.clamp(-126, 128) + 127).to(torch.int32)
    return torch.bitwise_left_shift(biased, 23).view(torch.float32)


def quantize(x: torch.Tensor, fmt: FloatFormat) -> torch.Tensor:
    """Torch quantiser, bitwise equal to :func:`quantize_np` (fp32 out).

    Runs on whatever device ``x`` lives on; ``torch.round`` rounds half to
    even like ``np.round``.
    """
    if fmt.exp_bits > 8:
        raise ValueError(f"{fmt}: exp_bits > 8 reaches below fp32's normal "
                         f"range, which the exponent-bit 2^e does not model")
    x = x.to(torch.float32)
    sign = torch.sign(x)
    v = torch.abs(x)
    f, e = torch.frexp(v)
    m = f * 2.0
    e = e - 1
    scale = float(1 << fmt.man_bits)
    q = torch.round((m - 1.0) * scale)
    carry = q >= scale
    m_q = torch.where(carry, 1.0, 1.0 + q / scale)
    e_q = torch.where(carry, e + 1, e)
    out = sign * m_q * _pow2(e_q)
    out = torch.where(v < fmt.min_normal * 0.5, 0.0, out)
    out = torch.where((v >= fmt.min_normal * 0.5) & (v < fmt.min_normal),
                      sign * fmt.min_normal, out)
    out = torch.where(v > fmt.max_value, sign * fmt.max_value, out)
    out = torch.where(v == 0.0, x, out)
    return torch.where(torch.isfinite(x), out, x)

