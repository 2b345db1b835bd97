"""The kernels' shared device quantiser (``csrc/quantize.cuh``), launched
elementwise so a check can hold it bitwise against
:func:`repro_torch.core.precision.quantize`, and the probe values such a
check feeds it.  Not on the serving path."""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.precision import FloatFormat
from repro_torch.kernels import build
from repro_torch.kernels._checks import fmt_args, require


def device_quantize(x: torch.Tensor, fmt: tuple[int, int]) -> torch.Tensor:
    """x: contiguous fp32 CUDA tensor (any shape) -> quantised copy."""
    require(x, "x", ndim=x.dim())
    eb, mb = fmt_args(fmt)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = build.library().quantize_f32(x.data_ptr(), out.data_ptr(),
                                       x.numel(), eb, mb, stream)
    build.check(err, "quantize")
    return out


def probe_values(fmt: FloatFormat, n: int, seed: int = 0) -> np.ndarray:
    """``n`` fp32 values that exercise every branch of the quantiser.

    Random magnitudes across the format's whole range and beyond it (the
    flush-to-zero band, the band snapped to the smallest normal,
    saturation), exact round-half-to-even ties, the band edges and their
    fp32 neighbours, fp32 subnormals, signed zeros, infinities and NaN.
    """
    rng = np.random.default_rng(seed)
    f32 = np.float32
    mn, mx = f32(fmt.min_normal), f32(fmt.max_value)
    edges = np.array([mn, mn / 2, np.nextafter(mn, f32(0)),
                      np.nextafter(mn / 2, f32(0)),
                      np.nextafter(mn / 2, f32(1)), mx,
                      np.nextafter(mx, f32(np.inf)),
                      mx + f32(2.0 ** (fmt.emax - fmt.man_bits - 1)),
                      np.finfo(f32).max, np.finfo(f32).tiny, f32(1e-40),
                      f32(1e-45), f32(0.0), f32(np.inf), f32(np.nan)],
                     dtype=f32)
    edges = np.concatenate([edges, -edges])
    n_ties = n // 8
    e = rng.integers(fmt.emin, fmt.emax + 1, n_ties)
    k = rng.integers(0, 1 << fmt.man_bits, n_ties)
    mant = 1.0 + (2 * k + 1) / float(1 << (fmt.man_bits + 1))
    ties = (rng.choice([-1.0, 1.0], n_ties) * np.ldexp(mant, e)).astype(f32)
    n_rand = n - n_ties - edges.size
    mag = np.exp2(rng.uniform(fmt.emin - 4, fmt.emax + 3, n_rand))
    rand = (rng.standard_normal(n_rand) * mag).astype(f32)
    return np.concatenate([edges, ties, rand])
