"""The port's FloPoCo quantiser against the numpy functional model.

``repro_torch.core.precision.quantize`` (torch) must equal ``quantize_np``
bit for bit — flush-to-zero, the band snapped to the smallest normal,
saturation, signed zeros, round-half-to-even ties and the non-finite
passthrough included — and the port's ``quantize_np`` must equal the
reference's.  The CUDA kernels' device quantiser is held to the same
contract on the card.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.precision import (FORMATS, FP_5_4,  # noqa: E402
                                        FloatFormat, quantize, quantize_np)
from repro_torch.kernels.quantize import probe_values  # noqa: E402

N_PROBES = 1 << 20


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.float32).view(np.int32)


@pytest.fixture(scope="module")
def ref_precision():
    """The reference package's precision module (it imports JAX)."""
    pytest.importorskip("jax")
    from repro.core import precision
    return precision


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("key", sorted(FORMATS))
def test_torch_quantize_bitwise_equals_numpy(key):
    fmt = FORMATS[key]
    x = probe_values(fmt, N_PROBES, seed=3)
    assert x.size == N_PROBES
    with np.errstate(over="ignore"):
        want = quantize_np(x, fmt)
    got = quantize(torch.from_numpy(x), fmt).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("key", sorted(FORMATS))
def test_port_quantize_np_equals_reference(ref_precision, key):
    fmt = FORMATS[key]
    x = probe_values(fmt, 1 << 16, seed=4)
    with np.errstate(over="ignore"):
        want = ref_precision.quantize_np(x, ref_precision.FORMATS[key])
        got = quantize_np(x, fmt)
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("key", sorted(FORMATS))
def test_formats_equal_reference(ref_precision, key):
    a, b = FORMATS[key], ref_precision.FORMATS[key]
    assert (a.exp_bits, a.man_bits, a.name) == (b.exp_bits, b.man_bits,
                                                b.name)
    assert (a.min_normal, a.max_value, a.wire_bits) == (
        b.min_normal, b.max_value, b.wire_bits)


def test_probes_cover_every_branch():
    fmt = FP_5_4
    x = probe_values(fmt, 1 << 14, seed=0)
    v = np.abs(x)
    assert np.isnan(x).any() and np.isinf(x).any()
    assert (np.signbit(x) & (x == 0)).any()
    assert ((v > 0) & (v < fmt.min_normal / 2)).any()          # flushed
    assert ((v >= fmt.min_normal / 2) & (v < fmt.min_normal)).any()
    assert (v[np.isfinite(v)] > fmt.max_value).any()          # saturated
    # exact ties: the fraction sits halfway between two (5,4) neighbours
    f, _ = np.frexp(v[(v >= fmt.min_normal) & (v <= fmt.max_value)])
    frac = (2 * f - 1) * (1 << fmt.man_bits)
    assert (frac - np.floor(frac) == 0.5).any()


def test_quantize_edge_cases():
    fmt = FP_5_4
    mn, mx = fmt.min_normal, fmt.max_value
    x = torch.tensor([-0.0, 0.0, mn * 0.4, -mn * 0.4, mn * 0.75, -mn * 0.75,
                      mx * 8, -mx * 8, float("inf"), float("-inf"),
                      float("nan"), 1.03125, 1.09375, 2.0 ** 16])
    got = quantize(x, fmt)
    # signed zeros pass through; the flush gives +0; the band snaps to
    # +-min normal; saturation; non-finites pass through
    assert torch.signbit(got[0]) and not torch.signbit(got[1])
    assert got[2] == 0 and not torch.signbit(got[3]) and got[3] == 0
    assert got[4] == mn and got[5] == -mn
    assert got[6] == mx and got[7] == -mx
    assert got[8] == float("inf") and got[9] == float("-inf")
    assert torch.isnan(got[10])
    # ties to even: 1 + 1/32 -> 1, 1 + 3/32 -> 1 + 1/8
    assert got[11] == 1.0 and got[12] == 1.125
    assert got[13] == mx


def test_quantize_keeps_fp32_and_rejects_wide_exponents():
    x = torch.randn(8, dtype=torch.float64)
    assert quantize(x, FP_5_4).dtype == torch.float32
    with pytest.raises(ValueError, match="exp_bits > 8"):
        quantize(x, FloatFormat(11, 52))


@pytest.mark.gpu
@pytest.mark.parametrize("key", sorted(FORMATS))
def test_device_quantizer_bitwise_on_card(cuda, key):
    from repro_torch.kernels.quantize import device_quantize
    fmt = FORMATS[key]
    x = probe_values(fmt, N_PROBES, seed=5)
    xd = torch.from_numpy(x).to(cuda)
    got = device_quantize(xd, (fmt.exp_bits, fmt.man_bits)).cpu().numpy()
    np.testing.assert_array_equal(_bits(got),
                                  _bits(quantize(xd, fmt).cpu().numpy()))
    with np.errstate(over="ignore"):
        np.testing.assert_array_equal(_bits(got), _bits(quantize_np(x, fmt)))
