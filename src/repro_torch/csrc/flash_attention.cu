// flash_attention: online-softmax attention over (BH, S, D) fp32, scale
// 1/sqrt(D), with the TPU kernel's options: causal, a local window, a tanh
// logit soft-cap, the finite NEG_INF mask value and the 1e-37 floor on the
// denominator.
//
// Replaces the TPU kernel flash_attention / _flash_kernel
// (src/repro/kernels/flash_attention/flash_attention.py, pl.pallas_call at
// L93).
//
// What bounds it on an H100: at the BraggNN NLB shape (B*1 heads, S = 81,
// D = 8) q, k, v and o are 2.65 MB at batch 256 and the two contractions
// 54 MFLOP, 0.79 us of bytes against 0.81 us of fp32 CUDA-core flops:
// the two bounds nearly balance, and a launch costs more than either.
// For long sequences the flops dominate (4 S^2 D per head).
//
// Design: one block per (bh, tile of 64 query rows), one thread per query
// row.  The block stages 32-key tiles of K and V in shared memory (every
// thread of a warp then reads the same K/V element, a broadcast); each
// thread keeps its query row, its running max, its denominator and its
// output accumulator in fp32 registers, as _flash_kernel keeps them in
// VMEM scratch, and its tile of scores in a shared-memory column (so the
// key loops need not unroll into registers), and folds each tile in the
// reference's order: the tile's
// scores, their max, the correction exp(m_prev - m_new), the
// probabilities, then the accumulator update.  Tiles that the causal mask
// or the window masks entirely are skipped (their update is the
// identity).  The last query tile and the last key tile are masked, so any
// S is taken where the TPU kernel asserts that the blocks divide it.  The
// exponential is expf, not __expf.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kRows = 64;   // query rows per block, one per thread
constexpr int kKeys = 32;   // keys per shared-memory tile
constexpr float kNegInf = -2.3819763e38f;

template <int D>
__global__ void __launch_bounds__(kRows)
    flash_attention_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           float* __restrict__ out, int sq, int skv,
                           float scale, int causal, int window,
                           float logit_cap) {
  __shared__ float ks[kKeys][D];
  __shared__ float vs[kKeys][D];
  __shared__ float ps[kKeys][kRows];  // scores, then probabilities
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kRows;
  const int qpos = q0 + threadIdx.x;
  const bool live = qpos < sq;
  const float* kb = k + (long long)bh * skv * D;
  const float* vb = v + (long long)bh * skv * D;

  float qr[D], acc[D];
  const float* qrow = q + ((long long)bh * sq + (live ? qpos : 0)) * D;
#pragma unroll
  for (int c = 0; c < D; ++c) {
    qr[c] = live ? qrow[c] : 0.0f;
    acc[c] = 0.0f;
  }
  float m = kNegInf, l = 0.0f;

  // key range any row of this block can see
  const int q_last = min(q0 + kRows, sq) - 1;
  int k_end = skv;
  if (causal) k_end = min(k_end, q_last + 1);
  int k_begin = 0;
  if (window > 0) k_begin = max(0, q0 - window + 1);
  k_begin = (k_begin / kKeys) * kKeys;

  for (int k0 = k_begin; k0 < k_end; k0 += kKeys) {
    __syncthreads();  // the previous tile is consumed
    for (int t = threadIdx.x; t < kKeys * D; t += kRows) {
      const int r = t / D, c = t - r * D;
      const bool in = k0 + r < skv;
      ks[r][c] = in ? kb[(long long)(k0 + r) * D + c] : 0.0f;
      vs[r][c] = in ? vb[(long long)(k0 + r) * D + c] : 0.0f;
    }
    __syncthreads();
    if (!live) continue;

    float* s = ps[0] + threadIdx.x;  // this row's scores, stride kRows
    float m_blk = kNegInf;
#pragma unroll 4
    for (int j = 0; j < kKeys; ++j) {
      float dot = 0.0f;
#pragma unroll
      for (int c = 0; c < D; ++c) dot = fmaf(qr[c], ks[j][c], dot);
      float sv = dot * scale;
      if (logit_cap != 0.0f) sv = logit_cap * tanhf(sv / logit_cap);
      const int kpos = k0 + j;
      bool ok = kpos < skv;
      if (causal) ok = ok && kpos <= qpos;
      if (window > 0) ok = ok && (qpos - kpos) < window;
      sv = ok ? sv : kNegInf;
      s[j * kRows] = sv;
      m_blk = fmaxf(m_blk, sv);
    }
    const float m_new = fmaxf(m, m_blk);
    const float m_safe = m_new == kNegInf ? 0.0f : m_new;
    const float corr = m == kNegInf ? 0.0f : expf(m - m_safe);
    float p_sum = 0.0f;
#pragma unroll 4
    for (int j = 0; j < kKeys; ++j) {
      const float sv = s[j * kRows];
      const float p = sv == kNegInf ? 0.0f : expf(sv - m_safe);
      s[j * kRows] = p;
      p_sum += p;
    }
    l = l * corr + p_sum;
#pragma unroll
    for (int c = 0; c < D; ++c) acc[c] *= corr;
#pragma unroll 2
    for (int j = 0; j < kKeys; ++j) {
      const float p = s[j * kRows];
#pragma unroll
      for (int c = 0; c < D; ++c) acc[c] = fmaf(p, vs[j][c], acc[c]);
    }
    m = m_new;
  }
  if (!live) return;
  const float den = fmaxf(l, 1e-37f);
  float* orow = out + ((long long)bh * sq + qpos) * D;
#pragma unroll
  for (int c = 0; c < D; ++c) orow[c] = acc[c] / den;
}

template <int D>
cudaError_t launch(const float* q, const float* k, const float* v, float* o,
                   int bh, int sq, int skv, float scale, int causal,
                   int window, float logit_cap, cudaStream_t s) {
  const dim3 grid((sq + kRows - 1) / kRows, bh);
  flash_attention_kernel<D><<<grid, kRows, 0, s>>>(
      q, k, v, o, sq, skv, scale, causal, window, logit_cap);
  return cudaGetLastError();
}

}  // namespace

// q: (bh, sq, d), k and v: (bh, skv, d), out: (bh, sq, d), contiguous fp32
// device pointers.  d in {8, 16, 32, 64}; window <= 0: no window;
// logit_cap == 0: no cap.  Returns cudaGetLastError().
extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* out, int bh, int sq,
                                   int skv, int d, int causal, int window,
                                   float logit_cap, void* stream) {
  const float* qp = (const float*)q;
  const float* kp = (const float*)k;
  const float* vp = (const float*)v;
  float* op = (float*)out;
  const float scale = (float)(1.0 / sqrt((double)d));
  cudaStream_t s = (cudaStream_t)stream;
  switch (d) {
    case 8: return (int)launch<8>(qp, kp, vp, op, bh, sq, skv, scale, causal, window, logit_cap, s);
    case 16: return (int)launch<16>(qp, kp, vp, op, bh, sq, skv, scale, causal, window, logit_cap, s);
    case 32: return (int)launch<32>(qp, kp, vp, op, bh, sq, skv, scale, causal, window, logit_cap, s);
    case 64: return (int)launch<64>(qp, kp, vp, op, bh, sq, skv, scale, causal, window, logit_cap, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
