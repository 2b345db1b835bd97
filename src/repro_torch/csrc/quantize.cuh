// FloPoCo (wE, wF) quantiser as a device function, shared by the
// conv2d_vmem, smallfloat_matmul and fused_softmax kernels.
//
// Written against the numpy functional model (repro_torch.core.precision
// .quantize_np): round the fraction to nearest-even, flush magnitudes below
// half the smallest normal to +0, snap the rest of the subnormal band to
// the smallest normal, saturate above the largest finite value, and pass
// zeros (with their sign), infinities and NaNs through unchanged.  The
// fraction is rounded on the bit pattern (half to even, like np.round on
// the scaled fraction), which is exact, so the result equals the torch and
// numpy quantisers bit for bit.

#pragma once

#include <math.h>

struct QFmt {
  int man_bits;      // < 0: plain fp32, the quantiser is the identity
  float min_normal;  // 2^emin
  float max_value;   // (2 - 2^-wF) * 2^emax
};

// exp_bits < 0 selects plain fp32.
static inline QFmt make_qfmt(int exp_bits, int man_bits) {
  QFmt f;
  if (exp_bits < 0) {
    f.man_bits = -1;
    f.min_normal = 0.0f;
    f.max_value = 0.0f;
    return f;
  }
  const int bias = (1 << (exp_bits - 1)) - 1;
  f.man_bits = man_bits;
  f.min_normal = (float)ldexp(1.0, 1 - bias);
  f.max_value = (float)((2.0 - ldexp(1.0, -man_bits)) * ldexp(1.0, bias));
  return f;
}

__device__ __forceinline__ float quantize_fp(float x, const QFmt& f) {
  if (f.man_bits < 0 || !isfinite(x)) return x;
  const float v = fabsf(x);
  if (v == 0.0f) return x;
  const float sign = x < 0.0f ? -1.0f : 1.0f;
  if (v > f.max_value) return sign * f.max_value;
  if (v < f.min_normal) return v < 0.5f * f.min_normal ? 0.0f : sign * f.min_normal;
  // v is a normal fp32 here (2^emin >= 2^-126 for wE <= 8).  Round its 23
  // fraction bits to man_bits, half to even, on the bit pattern: a carry
  // out of the fraction moves v into the next binade, as rintf's does.  The
  // parity is the kept fraction's last bit (0 when none is kept: the
  // fraction integer is then 0, which is even).
  const int drop = 23 - f.man_bits;
  const unsigned u = __float_as_uint(v);
  const unsigned odd = ((u & 0x7fffffu) >> drop) & 1u;
  const unsigned r = (u + (1u << (drop - 1)) - 1u + odd) & ~((1u << drop) - 1u);
  return sign * __uint_as_float(r);
}
