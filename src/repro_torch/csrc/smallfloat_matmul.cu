// smallfloat_matmul: (M, K) @ (K, N) with both operands rounded to a
// FloPoCo (wE, wF) lattice (or left in fp32), fp32 accumulation, optional
// bias and ReLU.
//
// Replaces the TPU kernel smallfloat_matmul / _matmul_kernel
// (src/repro/kernels/smallfloat_matmul/smallfloat_matmul.py,
// pl.pallas_call at L111).
//
// What bounds it on an H100: at BraggNN(s=1) shapes (M = batch, K <= 50,
// N <= 16) the inputs and outputs are a few tens of kilobytes and the work
// a few hundred kFLOP, so the launch is the floor; for large shapes the
// fp32 CUDA-core rate (67 TFLOP/s) is the roof, because the accumulation
// stays in fp32 FMAs rather than TF32 tensor cores, which would change
// the numbers.
//
// Design: 32x32 output tiles, one block of 32x8 threads each, looping over
// K in 32-wide steps.  Operands are quantised as they are loaded into
// shared memory (once per tile), each thread accumulates four outputs with
// fmaf, and the epilogue adds the bias, applies ReLU and optionally rounds
// the result to a (wE, wF) format.  Ragged edges are
// masked (loads past the end read 0, stores past the end are skipped), so
// any M, K, N is taken.  The operands may be strided (the nest tier hands
// in transposed weight views), fp32 or bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "quantize.cuh"

namespace {

constexpr int kTile = 32;
constexpr int kRows = 8;  // blockDim.y; each thread owns kTile / kRows rows

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void smallfloat_matmul_kernel(const T* __restrict__ x,
                                         const T* __restrict__ w,
                                         const float* __restrict__ b,
                                         float* __restrict__ out, int m, int k,
                                         int n, int sxm, int sxk, int swk,
                                         int swn, QFmt fmt, QFmt ofmt,
                                         int relu) {
  __shared__ float xs[kTile][kTile + 1];
  __shared__ float ws[kTile][kTile + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int row0 = blockIdx.y * kTile;
  const int col = blockIdx.x * kTile + tx;
  float acc[kTile / kRows];
#pragma unroll
  for (int i = 0; i < kTile / kRows; ++i) acc[i] = 0.0f;

  for (int k0 = 0; k0 < k; k0 += kTile) {
    for (int r = ty; r < kTile; r += kRows) {
      const int gm = row0 + r, gk = k0 + tx;
      xs[r][tx] = (gm < m && gk < k)
                      ? quantize_fp(to_f32(x[(long long)gm * sxm + (long long)gk * sxk]), fmt)
                      : 0.0f;
      const int wk = k0 + r;
      ws[r][tx] = (wk < k && col < n)
                      ? quantize_fp(to_f32(w[(long long)wk * swk + (long long)col * swn]), fmt)
                      : 0.0f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kTile; ++kk) {
      const float wv = ws[kk][tx];
#pragma unroll
      for (int i = 0; i < kTile / kRows; ++i)
        acc[i] = fmaf(xs[ty + i * kRows][kk], wv, acc[i]);
    }
    __syncthreads();
  }

  if (col >= n) return;
#pragma unroll
  for (int i = 0; i < kTile / kRows; ++i) {
    const int gm = row0 + ty + i * kRows;
    if (gm >= m) continue;
    float v = acc[i];
    if (b != nullptr) v += b[col];
    if (relu && v < 0.0f) v = 0.0f;
    out[(long long)gm * n + col] = quantize_fp(v, ofmt);
  }
}

template <typename T>
int launch(const void* x, const void* w, const void* b, void* out, int m,
           int k, int n, int sxm, int sxk, int swk, int swn, int exp_bits,
           int man_bits, int relu, int out_exp_bits, int out_man_bits,
           void* stream) {
  dim3 grid((n + kTile - 1) / kTile, (m + kTile - 1) / kTile);
  dim3 block(kTile, kRows);
  smallfloat_matmul_kernel<T><<<grid, block, 0, (cudaStream_t)stream>>>(
      (const T*)x, (const T*)w, (const float*)b, (float*)out, m, k, n, sxm,
      sxk, swk, swn, make_qfmt(exp_bits, man_bits),
      make_qfmt(out_exp_bits, out_man_bits), relu);
  return (int)cudaGetLastError();
}

}  // namespace

// Strides are in elements.  exp_bits < 0: operands left fp32.
// out_exp_bits >= 0: the result rounded to (out_exp_bits, out_man_bits).
// b (fp32) may be null.  The output is a contiguous fp32 (M, N).  Returns
// cudaGetLastError().
extern "C" int smallfloat_matmul_f32(const void* x, const void* w,
                                     const void* b, void* out, int m, int k,
                                     int n, int sxm, int sxk, int swk, int swn,
                                     int exp_bits, int man_bits, int relu,
                                     int out_exp_bits, int out_man_bits,
                                     void* stream) {
  return launch<float>(x, w, b, out, m, k, n, sxm, sxk, swk, swn, exp_bits,
                       man_bits, relu, out_exp_bits, out_man_bits, stream);
}

extern "C" int smallfloat_matmul_bf16(const void* x, const void* w,
                                      const void* b, void* out, int m, int k,
                                      int n, int sxm, int sxk, int swk,
                                      int swn, int exp_bits, int man_bits,
                                      int relu, int out_exp_bits,
                                      int out_man_bits, void* stream) {
  return launch<__nv_bfloat16>(x, w, b, out, m, k, n, sxm, sxk, swk, swn,
                               exp_bits, man_bits, relu, out_exp_bits,
                               out_man_bits, stream);
}
