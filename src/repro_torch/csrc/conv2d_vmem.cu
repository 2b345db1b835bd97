// conv2d_vmem: valid, stride-1 NCHW direct convolution with optional (wE, wF)
// operand quantisation, bias and ReLU.
//
// Replaces the TPU kernel conv2d_vmem / _conv_kernel
// (src/repro/kernels/conv2d_vmem/conv2d_vmem.py, pl.pallas_call at L82).
//
// What bounds it on an H100: at BraggNN(s=1) shapes every call is small
// (conv1 at batch 256 moves 1.45 MB, conv2a does 29 MFLOP), so the memory
// and fp32 bounds are well under a microsecond and the launch itself is
// the floor.  Among the two roofs the bytes are the larger: each output
// pixel costs Cin*kh*kw fused multiply-adds, at most 144 here, against 4
// bytes written.
//
// Design: one block per (sample, tile of 8 output channels).  The block
// stages the whole input sample and the tile's weights in shared memory,
// quantised once on load (the TPU kernel keeps the weights resident in
// VMEM the same way), then each thread computes output pixels with fp32
// fmaf accumulation over (Cin, kh, kw).  The epilogue adds the bias,
// applies ReLU, optionally rounds the result to a (wE, wF) format and
// optionally adds a residual tensor of the output's shape (rounded again),
// so the quantised serving path needs no launches beside the kernel's.
// Any batch size: the grid has one row of blocks per sample.

#include <cuda_runtime.h>

#include "quantize.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kCoutTile = 8;

__global__ void conv2d_vmem_kernel(const float* __restrict__ x,
                                   const float* __restrict__ w,
                                   const float* __restrict__ b,
                                   const float* __restrict__ res,
                                   float* __restrict__ out, int cin, int h,
                                   int wd, int cout, int kh, int kw, QFmt fmt,
                                   QFmt ofmt, int relu) {
  extern __shared__ float smem[];
  const int ho = h - kh + 1, wo = wd - kw + 1;
  const int npix = ho * wo;
  const int n = blockIdx.x;
  const int co0 = blockIdx.y * kCoutTile;
  const int ct = min(kCoutTile, cout - co0);
  const int xsz = cin * h * wd;
  const int wper = cin * kh * kw;
  float* xs = smem;
  float* ws = smem + xsz;

  const float* xn = x + (size_t)n * xsz;
  for (int i = threadIdx.x; i < xsz; i += blockDim.x)
    xs[i] = quantize_fp(xn[i], fmt);
  const float* wt = w + (size_t)co0 * wper;
  for (int i = threadIdx.x; i < ct * wper; i += blockDim.x)
    ws[i] = quantize_fp(wt[i], fmt);
  __syncthreads();

  const size_t obase = ((size_t)n * cout + co0) * npix;
  float* on = out + obase;
  for (int o = threadIdx.x; o < ct * npix; o += blockDim.x) {
    const int c = o / npix, p = o - c * npix;
    const int oy = p / wo, ox = p - oy * wo;
    const float* wc = ws + c * wper;
    float acc = 0.0f;
    for (int ci = 0; ci < cin; ++ci) {
      const float* xc = xs + (ci * h + oy) * wd + ox;
      const float* wk = wc + ci * kh * kw;
      for (int i = 0; i < kh; ++i)
        for (int j = 0; j < kw; ++j)
          acc = fmaf(xc[i * wd + j], wk[i * kw + j], acc);
    }
    if (b != nullptr) acc += b[co0 + c];
    if (relu && acc < 0.0f) acc = 0.0f;
    acc = quantize_fp(acc, ofmt);
    if (res != nullptr) acc = quantize_fp(res[obase + o] + acc, ofmt);
    on[o] = acc;
  }
}

}  // namespace

// Dynamic shared memory bytes one block needs (the wrapper checks it
// against the card's limit before launching).
extern "C" int conv2d_vmem_smem_bytes(int cin, int h, int wd, int cout, int kh,
                                      int kw) {
  const int ct = cout < kCoutTile ? cout : kCoutTile;
  return (cin * h * wd + ct * cin * kh * kw) * (int)sizeof(float);
}

// exp_bits < 0: operands left fp32.  out_exp_bits >= 0: the result, and its
// sum with the residual, rounded to (out_exp_bits, out_man_bits).  b and res
// (contiguous, the output's shape) may be null.  Returns
// cudaGetLastError().
extern "C" int conv2d_vmem_f32(const void* x, const void* w, const void* b,
                               const void* res, void* out, int batch, int cin,
                               int h, int wd, int cout, int kh, int kw,
                               int exp_bits, int man_bits, int relu,
                               int out_exp_bits, int out_man_bits,
                               void* stream) {
  const int smem = conv2d_vmem_smem_bytes(cin, h, wd, cout, kh, kw);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        conv2d_vmem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(batch, (cout + kCoutTile - 1) / kCoutTile);
  conv2d_vmem_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)w, (const float*)b, (const float*)res,
      (float*)out, cin, h, wd, cout, kh, kw, make_qfmt(exp_bits, man_bits),
      make_qfmt(out_exp_bits, out_man_bits), relu);
  return (int)cudaGetLastError();
}
