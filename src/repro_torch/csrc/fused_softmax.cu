// fused_softmax: row softmax over the last axis, with the exponential
// either true (expf) or the paper's order-k Taylor series of z / 2^r
// squared r times.
//
// Replaces the TPU kernel fused_softmax / _softmax_kernel + _taylor_exp
// (src/repro/kernels/fused_softmax/fused_softmax.py, pl.pallas_call at L52).
//
// What bounds it on an H100: bytes.  BraggNN(s=1, img=11) at batch 256
// hands it 256*81 rows of 81 fp32 values, 6.7 MB in and 6.7 MB out, about
// 4 us at 3.35 TB/s; the order-8 Taylor series is ~20 flops per element,
// far below the fp32 roof.
//
// Design: one warp per row, eight rows per block.  Lanes stride over the
// columns (any width), the row max and the row sum are warp-shuffle
// reductions, and the exponentials are written once and normalised in
// place by the lane that wrote them, so a row is read from device memory
// once.  The Taylor series follows the reference operation by operation
// (y = z / 2^r, term = term * y / k, acc = acc + term, then r squarings).
// The input may be rounded to a (wE, wF) format as it is read (the
// quantised NLB rounds its attention scores before the softmax), so that
// rounding needs no launch of its own.  Any row count: the last block masks
// the rows past the end.

#include <cuda_runtime.h>
#include <math.h>

#include "quantize.cuh"

namespace {

constexpr int kRowsPerBlock = 8;

__device__ __forceinline__ float taylor_exp(float z, int order, int rr) {
  const float y = z / (float)(1 << rr);
  float acc = 1.0f, term = 1.0f;
  for (int k = 1; k <= order; ++k) {
    term = term * y / (float)k;
    acc = acc + term;
  }
  for (int r = 0; r < rr; ++r) acc = acc * acc;
  return acc;
}

__global__ void fused_softmax_kernel(const float* __restrict__ x,
                                     float* __restrict__ out, int rows,
                                     int cols, int order, int rr,
                                     QFmt fmt) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warps leave together
  const float* xr = x + row * cols;
  float* orow = out + row * cols;

  float m = -INFINITY;
  for (int c = lane; c < cols; c += 32) m = fmaxf(m, quantize_fp(xr[c], fmt));
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));

  float s = 0.0f;
  for (int c = lane; c < cols; c += 32) {
    const float z = quantize_fp(xr[c], fmt) - m;
    const float e = order > 0 ? taylor_exp(z, order, rr) : expf(z);
    orow[c] = e;
    s += e;
  }
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);

  for (int c = lane; c < cols; c += 32) orow[c] = orow[c] / s;
}

}  // namespace

// order == 0: true exp.  exp_bits < 0: the input is read as it is.
// Returns cudaGetLastError().
extern "C" int fused_softmax_f32(const void* x, void* out, int rows, int cols,
                                 int order, int range_reduce, int exp_bits,
                                 int man_bits, void* stream) {
  const int blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  fused_softmax_kernel<<<blocks, 32 * kRowsPerBlock, 0, (cudaStream_t)stream>>>(
      (const float*)x, (float*)out, rows, cols, order, range_reduce,
      make_qfmt(exp_bits, man_bits));
  return (int)cudaGetLastError();
}
