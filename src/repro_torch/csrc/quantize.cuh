// FloPoCo (wE, wF) quantiser as a device function, shared by the
// conv2d_vmem, smallfloat_matmul and fused_softmax kernels.
//
// Written against the numpy functional model (repro_torch.core.precision
// .quantize_np): round the fraction to nearest-even, flush magnitudes below
// half the smallest normal to +0, snap the rest of the subnormal band to
// the smallest normal, saturate above the largest finite value, and pass
// zeros (with their sign), infinities and NaNs through unchanged.  Every
// step is exact in fp32 (rintf rounds half to even like np.round; frexpf and
// ldexpf only move exponent bits), so the result equals the torch and numpy
// quantisers bit for bit.

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
  int e;
  const float m = frexpf(v, &e) * 2.0f;  // v = m * 2^(e-1), m in [1, 2)
  e -= 1;
  const float scale = (float)(1 << f.man_bits);
  const float q = rintf((m - 1.0f) * scale);
  float mq = 1.0f + q / scale;
  if (q >= scale) {  // the fraction rounded up into the next binade
    mq = 1.0f;
    e += 1;
  }
  return sign * mq * ldexpf(1.0f, e);
}
