// conv2d_vmem: valid, stride-1 NCHW direct convolution with optional (wE, wF)
// operand quantisation, bias and ReLU.
//
// Replaces the TPU kernel conv2d_vmem / _conv_kernel
// (src/repro/kernels/conv2d_vmem/conv2d_vmem.py, pl.pallas_call at L82).
//
// What bounds it on an H100: at BraggNN(s=1) shapes every call is small
// (conv1 at batch 256 moves 1.45 MB, conv2a does 29 MFLOP), so the memory
// and fp32 bounds are well under a microsecond, and what is left is
// latency: the launch, and round trips to memory.  A call has only
// B*Ho*Wo output pixels (12,544 for conv2a at batch 256, about three warps
// per SM), so few warps are there to hide a load's latency, and a thread
// that waits for each operand in turn spends the call waiting.  Among the
// two roofs the bytes are the larger: each output pixel costs Cin*kh*kw
// fused multiply-adds, at most 144 here, against 4 bytes written.
//
// Design: one thread per output pixel of one sample, holding all of a
// tile's output channels (8, or 16 where Cout > 8; wider convs take
// several tiles along the grid's y axis) in registers, in blocks of 128
// threads.  Each block stages the tile's weights once in shared memory
// with cp.async, quantised once they land, laid out tap-major and
// channel-minor so a tap's weights are four-wide broadcast reads
// (channels past Cout are zero), beside a table of each tap's offset in
// the input (channel, row, column: the integer division is done here, once
// per block).  A thread walks its taps in chunks of kChunk: the chunk's
// input values are loaded together through the read-only cache (__ldg),
// so their latencies overlap, and the next chunk is fetched while this
// one is multiplied into the accumulators.  The first chunk is in flight
// together with the weights' copies, and the residual's lines are
// prefetched into L1, so a 1x1 call waits for about one round trip.
// Neighbouring threads hold neighbouring pixels, so a warp's reads of a tap
// are coalesced along the pixel axis, and a 3x3 window's other taps hit
// L1.  The operand is quantised as it is read and reused across all of the
// tile's channels.  The epilogue adds the bias, applies ReLU, optionally
// rounds the result to a (wE, wF) format and optionally adds a residual
// tensor of the output's shape (rounded again), so the quantised serving
// path needs no launches beside the kernel's.  Any batch size: the last
// block masks the pixels past the end.

#include <cuda_runtime.h>
#include <limits.h>

#include "quantize.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 8;  // taps whose input loads are in flight together

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

template <int CT>
__global__ void __launch_bounds__(kThreads)
conv2d_vmem_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ b, const float* __restrict__ res,
                   float* __restrict__ out, int batch, int cin, int h, int wd,
                   int cout, int kh, int kw, QFmt fmt, QFmt ofmt, int relu) {
  extern __shared__ float4 smem4[];
  const int taps = cin * kh * kw;
  float* ws = reinterpret_cast<float*>(smem4);        // [taps][CT]
  int* offs = reinterpret_cast<int*>(ws + taps * CT);  // [taps]
  const int co0 = blockIdx.y * CT;
  const int ct = min(CT, cout - co0);

  for (int i = threadIdx.x; i < taps * CT; i += blockDim.x) {
    const int t = i / CT, c = i - t * CT;  // CT is a power of two
    if (c < ct)
      cp_async4(ws + i, w + (size_t)(co0 + c) * taps + t);
    else
      ws[i] = 0.0f;
  }
  asm volatile("cp.async.commit_group;\n" ::);
  const int khw = kh * kw;
  for (int t = threadIdx.x; t < taps; t += blockDim.x) {
    const int ci = t / khw, r = t - ci * khw, i = r / kw;
    offs[t] = (ci * h + i) * wd + (r - i * kw);
  }
  __syncthreads();  // the tap table

  const int ho = h - kh + 1, wo = wd - kw + 1, npix = ho * wo;
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = gid < (long long)batch * npix;
  const int n = live ? (int)(gid / npix) : 0;
  const int p = live ? (int)(gid - (long long)n * npix) : 0;
  const int oy = p / wo, ox = p - oy * wo;
  const float* xp = x + (size_t)n * cin * h * wd + (size_t)oy * wd + ox;
  const size_t o0 = ((size_t)n * cout + co0) * npix + p;
  if (res != nullptr && live)
    for (int c = 0; c < ct; ++c)
      asm volatile("prefetch.global.L1 [%0];\n" ::"l"(res + o0 +
                                                      (size_t)c * npix));
  float xa[kChunk];
#pragma unroll
  for (int u = 0; u < kChunk; ++u)
    xa[u] = live && u < taps ? __ldg(xp + offs[u]) : 0.0f;

  asm volatile("cp.async.wait_group 0;\n" ::);
  if (fmt.man_bits >= 0)  // each thread rounds the weights it copied
    for (int i = threadIdx.x; i < taps * CT; i += blockDim.x)
      if (i % CT < ct) ws[i] = quantize_fp(ws[i], fmt);
  __syncthreads();  // the weights
  if (!live) return;

  float acc[CT];
#pragma unroll
  for (int c = 0; c < CT; ++c) acc[c] = 0.0f;
  for (int t0 = 0; t0 < taps; t0 += kChunk) {
    float xb[kChunk];
#pragma unroll
    for (int u = 0; u < kChunk; ++u)
      xb[u] = t0 + kChunk + u < taps ? __ldg(xp + offs[t0 + kChunk + u])
                                     : 0.0f;
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      if (t0 + u < taps) {
        const float xv = quantize_fp(xa[u], fmt);
        const float4* wt = reinterpret_cast<const float4*>(ws + (t0 + u) * CT);
#pragma unroll
        for (int c4 = 0; c4 < CT / 4; ++c4) {
          const float4 wv = wt[c4];
          acc[4 * c4 + 0] = fmaf(xv, wv.x, acc[4 * c4 + 0]);
          acc[4 * c4 + 1] = fmaf(xv, wv.y, acc[4 * c4 + 1]);
          acc[4 * c4 + 2] = fmaf(xv, wv.z, acc[4 * c4 + 2]);
          acc[4 * c4 + 3] = fmaf(xv, wv.w, acc[4 * c4 + 3]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kChunk; ++u) xa[u] = xb[u];
  }

#pragma unroll
  for (int c = 0; c < CT; ++c) {
    if (c < ct) {
      float v = acc[c];
      if (b != nullptr) v += __ldg(b + co0 + c);
      if (relu && v < 0.0f) v = 0.0f;
      v = quantize_fp(v, ofmt);
      if (res != nullptr)
        v = quantize_fp(__ldg(res + o0 + (size_t)c * npix) + v, ofmt);
      out[o0 + (size_t)c * npix] = v;
    }
  }
}

int tile_of(int cout) { return cout <= 8 ? 8 : 16; }

template <int CT>
cudaError_t launch(const float* x, const float* w, const float* b,
                   const float* res, float* out, int batch, int cin, int h,
                   int wd, int cout, int kh, int kw, QFmt fmt, QFmt ofmt,
                   int relu, int smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        conv2d_vmem_kernel<CT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return e;
  }
  const long long pixels = (long long)batch * (h - kh + 1) * (wd - kw + 1);
  dim3 grid((unsigned)((pixels + kThreads - 1) / kThreads),
            (cout + CT - 1) / CT);
  conv2d_vmem_kernel<CT><<<grid, kThreads, smem, stream>>>(
      x, w, b, res, out, batch, cin, h, wd, cout, kh, kw, fmt, ofmt, relu);
  return cudaGetLastError();
}

}  // namespace

// Dynamic shared memory bytes one block needs: one tile's weights and the
// tap table (the wrapper checks it against the card's limit before
// launching).
extern "C" int conv2d_vmem_smem_bytes(int cin, int h, int wd, int cout, int kh,
                                      int kw) {
  (void)h;
  (void)wd;
  const long long bytes = (long long)cin * kh * kw *
                          (tile_of(cout) * sizeof(float) + sizeof(int));
  return bytes < INT_MAX ? (int)bytes : INT_MAX;
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
  const QFmt fmt = make_qfmt(exp_bits, man_bits);
  const QFmt ofmt = make_qfmt(out_exp_bits, out_man_bits);
  const auto* xf = (const float*)x;
  const auto* wf = (const float*)w;
  const auto* bf = (const float*)b;
  const auto* rf = (const float*)res;
  auto* of = (float*)out;
  auto* st = (cudaStream_t)stream;
  const cudaError_t e =
      tile_of(cout) == 8
          ? launch<8>(xf, wf, bf, rf, of, batch, cin, h, wd, cout, kh, kw,
                      fmt, ofmt, relu, smem, st)
          : launch<16>(xf, wf, bf, rf, of, batch, cin, h, wd, cout, kh, kw,
                       fmt, ofmt, relu, smem, st);
  return (int)e;
}
