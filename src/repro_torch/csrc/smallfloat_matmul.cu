// smallfloat_matmul: a chain of 1 to kMaxLayers dense layers.  Layer l is
// (M, K_l) @ (K_l, N_l) with both operands rounded to a FloPoCo (wE, wF)
// lattice (or left in fp32), fp32 accumulation, optional fp32 bias and
// ReLU, and the result optionally rounded to a format; its result is layer
// l+1's input.  A chain of one is the reference kernel's whole contract.
//
// Replaces the TPU kernel smallfloat_matmul / _matmul_kernel
// (src/repro/kernels/smallfloat_matmul/smallfloat_matmul.py,
// pl.pallas_call at L111).
//
// What bounds it on an H100: at BraggNN's dense chain (50->16->8->4->2,
// M = batch) one batch of 256 moves about 57 KB and does about 0.5 MFLOP,
// 0.017 us of bytes: the launch and the latency of one pass through the
// chain are the floor, so four layers launched one at a time cost four
// launches.  For large single layers the fp32 CUDA-core rate (67 TFLOP/s)
// is the roof, because the accumulation stays in fp32 FMAs rather than
// TF32 tensor cores, which would change the numbers.
//
// Design: one launch carries a block of rows (4 for a chain of two or
// more) through the whole chain.  A block of 256 threads stages its rows
// of the input and every layer's weights and biases in shared memory at
// the start, all by cp.async and waited for once, then rounds the weights
// and the input to (wE, wF) in place (the biases are not rounded); its
// threads walk each operand as a grid a power of two wide along the
// source's unit-stride axis, so no element costs a division.  Then it
// walks the layers: each output is one fmaf chain over k in ascending
// order (no branch inside the sum), then the bias, the ReLU and the
// rounding to the layer's output format; the result stays in shared
// memory as the next layer's input (rounded to the operand format), and
// only the last layer writes global memory.  Because every output is
// summed in the same order, a chain equals its layers launched one at a
// time, value for value.  A chain of one whose weight slice does not fit
// the block's shared memory streams K in 32-wide tiles instead (one tile
// of input and weights at a time, the sums carried in registers across
// tiles), and the grid splits its N into 32-column slices, so any
// (M, K, N) is taken; such a layer may be fp32 or bf16 (bf16 is staged by
// plain loads) and its operands strided.  Ragged edges are masked (loads
// past the end read 0, stores past the end are skipped).

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "quantize.cuh"

namespace {

constexpr int kMaxLayers = 8;
constexpr int kThreads = 256;
constexpr int kThreadsLog2 = 8;
constexpr int kAcc = 4;          // outputs in flight per thread
constexpr int kChainRows = 4;    // rows per block of a chain of two or more
constexpr int kOneRows = 32;     // rows per block of a chain of one
constexpr int kOneCols = 32;     // columns per block of a chain of one
constexpr int kTileK = 32;       // K step of a streamed chain of one
constexpr int kMaxInner = 256;   // widest inner activation of a chain
constexpr int kStaticSmem = 48 * 1024;

struct Layer {
  const void* w;    // (k, n), element strides swk, swn
  const float* b;   // (n,) contiguous fp32, or null
  int k, n;
  long long swk, swn;
  int relu;
  QFmt ofmt;        // the result's format (man_bits < 0: fp32)
};

struct Chain {
  const void* x;    // (m, k0), element strides sxm, sxk
  float* out;       // (m, n_last) contiguous fp32
  long long sxm, sxk;
  int m, layers;
  int rows, cols;   // rows per block; last layer's columns per block
  int kt;           // layer 0's K step: k0 (resident) or kTileK (streamed)
  int ldx, lda;     // shared-memory row strides of the input tile and of
                    // the inner activations (odd: rows fall on other banks)
  QFmt fmt;         // the operands' format
  Layer l[kMaxLayers];
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// dst[r * ld + c] = src[r * sr + c * sc] for r < live_r, c < live_c, and
// zero elsewhere in the (nr, nc) box.  fp32 goes by cp.async (the caller
// commits, waits and rounds), bf16 by plain loads.  The block's threads
// form a grid whose width is a power of two along the source's
// unit-stride axis: no division per element.
template <typename T>
__device__ void stage(float* dst, int ld, const T* src, long long sr,
                      long long sc, int nr, int nc, int live_r, int live_c) {
  const bool rows_fast = sr == 1 && sc != 1;
  const int nf = rows_fast ? nr : nc, ns = rows_fast ? nc : nr;
  const int lx = min(nf > 1 ? 32 - __clz(nf - 1) : 0, kThreadsLog2);
  const int tx = threadIdx.x & ((1 << lx) - 1), ty = threadIdx.x >> lx;
  for (int sl = ty; sl < ns; sl += kThreads >> lx)
    for (int f = tx; f < nf; f += 1 << lx) {
      const int r = rows_fast ? f : sl, c = rows_fast ? sl : f;
      float* d = dst + r * ld + c;
      if (r >= live_r || c >= live_c) {
        *d = 0.0f;
      } else if constexpr (sizeof(T) == 4) {
        __pipeline_memcpy_async(d, src + r * sr + c * sc, 4);
      } else {
        *d = to_f32(src[r * sr + c * sc]);
      }
    }
}

// Waits for the block's copies, then rounds n staged floats in place.
__device__ void staged(float* p, int n, const QFmt& f) {
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
  if (f.man_bits < 0) return;
  for (int i = threadIdx.x; i < n; i += kThreads) p[i] = quantize_fp(p[i], f);
  __syncthreads();
}

// acc[j] += sum over kk < kl of in[r[j]][kk] * w[kk][col[j]], one fmaf
// chain per output in ascending kk
template <int NA>
__device__ __forceinline__ void sums(float* acc, const float* in, int ld_in,
                                     const float* w, int wn, const int* r,
                                     const int* col, int kl) {
  const float* a[NA];
  const float* b[NA];
#pragma unroll
  for (int j = 0; j < NA; ++j) {
    a[j] = in + r[j] * ld_in;
    b[j] = w + col[j];
  }
#pragma unroll 4
  for (int kk = 0; kk < kl; ++kk) {
#pragma unroll
    for (int j = 0; j < NA; ++j) acc[j] = fmaf(a[j][kk], b[j][kk * wn], acc[j]);
  }
}

// minBlocks 1: with the thread bound alone ptxas holds the kernel to fewer
// registers than it needs and spills
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    smallfloat_matmul_kernel(const __grid_constant__ Chain c) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * c.rows;
  const int live_rows = min(c.rows, c.m - row0);
  const int last = c.layers - 1;
  const int col0 = blockIdx.y * c.cols;   // the last layer's first column
  const bool resident = c.kt == c.l[0].k;
  const T* x = static_cast<const T*>(c.x) + row0 * c.sxm;

  // layout: biases, weights (every layer's, or one streamed tile), the
  // input tile, two activation buffers
  float* bs = smem;
  int off = 0;
  for (int i = 0; i < c.layers; ++i)
    off += i == last ? c.cols : c.l[i].n;
  float* ws = bs + off;
  off = 0;
  for (int i = 0; i < c.layers; ++i)
    off += (i == 0 ? c.kt : c.l[i].k) * (i == last ? c.cols : c.l[i].n);
  float* xs = ws + off;
  float* const act0 = xs + c.rows * c.ldx;
  float* const act1 = act0 + c.rows * c.lda;

  {
    float* bp = bs;
    float* wp = ws;
    for (int i = 0; i < c.layers; ++i) {
      const Layer& L = c.l[i];
      const int c0 = i == last ? col0 : 0;
      const int wn = i == last ? c.cols : L.n;
      const int live_n = min(wn, L.n - c0);
      if (L.b != nullptr)
        stage<float>(bp, wn, L.b + c0, 0, 1, 1, wn, 1, live_n);
      if (resident)
        stage<T>(wp, wn, static_cast<const T*>(L.w) + c0 * L.swn, L.swk,
                 L.swn, L.k, wn, L.k, live_n);
      bp += wn;
      wp += (i == 0 ? c.kt : L.k) * wn;
    }
    if (resident)
      stage<T>(xs, c.ldx, x, c.sxm, c.sxk, c.rows, c.kt, live_rows, c.kt);
    // the weights and the input tile are one span: round them together
    staged(ws, resident ? (int)(act0 - ws) : 0, c.fmt);
  }

  const float* in = xs;
  int ld_in = c.ldx;
  float* bp = bs;
  float* wp = ws;
  for (int i = 0; i < c.layers; ++i) {
    const Layer& L = c.l[i];
    const bool is_last = i == last;
    const int wn = is_last ? c.cols : L.n;
    const int live_n = is_last ? min(c.cols, L.n - col0) : L.n;
    const int kt = i == 0 ? c.kt : L.k;
    float* dst = i & 1 ? act1 : act0;
    // outputs on a (rows, 2^sh) grid: row o >> sh, column o & mask
    const int sh = wn > 1 ? 32 - __clz(wn - 1) : 0;
    const int slots = c.rows << sh;
    for (int o0 = 0; o0 < slots; o0 += kThreads * kAcc) {
      // sums this pass needs per thread (the same for the whole block)
      const int na = min(kAcc, (slots - o0 + kThreads - 1) / kThreads);
      int r[kAcc], col[kAcc];
      float acc[kAcc];
#pragma unroll
      for (int j = 0; j < kAcc; ++j) {
        const int o = o0 + tid + j * kThreads;
        r[j] = min(o >> sh, c.rows - 1);
        col[j] = min(o & ((1 << sh) - 1), wn - 1);
        acc[j] = 0.0f;
      }
      for (int k0 = 0; k0 < L.k; k0 += kt) {
        const int kl = min(kt, L.k - k0);
        if (!resident) {   // a streamed chain of one: the next K tile
          __syncthreads();
          stage<T>(xs, c.ldx, x + k0 * c.sxk, c.sxm, c.sxk, c.rows, kt,
                   live_rows, kl);
          stage<T>(wp, wn, static_cast<const T*>(L.w) + k0 * L.swk +
                               col0 * L.swn,
                   L.swk, L.swn, kt, wn, kl, live_n);
          staged(ws, (int)(act0 - ws), c.fmt);
        }
        switch (na) {   // no branch inside the sums
          case 1: sums<1>(acc, in, ld_in, wp, wn, r, col, kl); break;
          case 2: sums<2>(acc, in, ld_in, wp, wn, r, col, kl); break;
          case 3: sums<3>(acc, in, ld_in, wp, wn, r, col, kl); break;
          default: sums<kAcc>(acc, in, ld_in, wp, wn, r, col, kl);
        }
      }
#pragma unroll
      for (int j = 0; j < kAcc; ++j) {
        const int o = o0 + tid + j * kThreads;
        if (o >= slots || (o >> sh) >= live_rows ||
            (o & ((1 << sh) - 1)) >= live_n)
          continue;
        float v = acc[j];
        if (L.b != nullptr) v += bp[col[j]];
        if (L.relu && v < 0.0f) v = 0.0f;
        v = quantize_fp(v, L.ofmt);
        if (is_last)
          c.out[(long long)(row0 + r[j]) * L.n + col0 + col[j]] = v;
        else
          dst[r[j] * c.lda + col[j]] = quantize_fp(v, c.fmt);
      }
    }
    if (!is_last) {
      __syncthreads();
      in = dst;
      ld_in = c.lda;
    }
    bp += wn;
    wp += kt * wn;
  }
}

// Shared-memory bytes of a launch.
size_t smem_bytes(const Chain& c) {
  size_t f = 0;
  for (int i = 0; i < c.layers; ++i) {
    const int wn = i == c.layers - 1 ? c.cols : c.l[i].n;
    f += (size_t)wn * (1 + (i == 0 ? c.kt : c.l[i].k));
  }
  f += (size_t)c.rows * (c.ldx + (c.layers > 1 ? 2 * c.lda : 0));
  return f * sizeof(float);
}

int smem_optin() {
  static int bytes = -1;   // queried once
  if (bytes < 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev) != cudaSuccess)
      bytes = kStaticSmem;
  }
  return bytes;
}

template <typename T>
int launch(Chain& c, void* stream) {
  static bool opted = false;
  const size_t smem = smem_bytes(c);
  if ((long long)smem > smem_optin()) return (int)cudaErrorInvalidValue;
  if (smem > (size_t)kStaticSmem && !opted) {
    const cudaError_t e = cudaFuncSetAttribute(
        smallfloat_matmul_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem_optin());
    if (e != cudaSuccess) return (int)e;
    opted = true;
  }
  const int n_last = c.l[c.layers - 1].n;
  const dim3 grid((c.m + c.rows - 1) / c.rows,
                  (n_last + c.cols - 1) / c.cols);
  smallfloat_matmul_kernel<T><<<grid, kThreads, smem,
                                (cudaStream_t)stream>>>(c);
  return (int)cudaGetLastError();
}

}  // namespace

// A chain of n_layers dense layers.  x: (m, k0) with element strides
// (sxm, sxk); out: contiguous fp32 (m, n_last).  layers: n_layers rows of
// kLayerWords int64s, (w pointer, b pointer or 0, k, n, w's element
// strides over k and n, relu, out_exp_bits, out_man_bits); layer l's k
// must be layer l-1's n.  exp_bits < 0: operands left fp32; out_exp_bits
// < 0: the layer's result left fp32.  bf16 (x and w) only for a chain of
// one; a chain of two or more needs every inner width <= 256 and every
// weight in the shared memory the card grants a block.  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a chain it does not
// take.
extern "C" int smallfloat_matmul_chain(const void* x, void* out, int m,
                                       long long sxm, long long sxk,
                                       int n_layers, const long long* layers,
                                       int exp_bits, int man_bits, int bf16,
                                       void* stream) {
  constexpr int kLayerWords = 9;
  if (n_layers < 1 || n_layers > kMaxLayers || (bf16 && n_layers > 1))
    return (int)cudaErrorInvalidValue;
  Chain c{};
  c.x = x;
  c.out = (float*)out;
  c.sxm = sxm;
  c.sxk = sxk;
  c.m = m;
  c.layers = n_layers;
  c.fmt = make_qfmt(exp_bits, man_bits);
  int inner = 1;
  for (int i = 0; i < n_layers; ++i) {
    const long long* a = layers + kLayerWords * i;
    Layer& L = c.l[i];
    L.w = (const void*)a[0];
    L.b = (const float*)a[1];
    L.k = (int)a[2];
    L.n = (int)a[3];
    L.swk = a[4];
    L.swn = a[5];
    L.relu = (int)a[6];
    L.ofmt = make_qfmt((int)a[7], (int)a[8]);
    if (i > 0 && L.k != c.l[i - 1].n) return (int)cudaErrorInvalidValue;
    if (i < n_layers - 1) inner = L.n > inner ? L.n : inner;
  }
  const int k0 = c.l[0].k;
  if (n_layers > 1) {
    if (inner > kMaxInner) return (int)cudaErrorInvalidValue;
    c.rows = kChainRows;
    c.cols = c.l[n_layers - 1].n;
    c.kt = k0;
    c.ldx = k0 | 1;
    c.lda = inner | 1;
    return launch<float>(c, stream);
  }
  c.rows = kOneRows;
  c.cols = c.l[0].n < kOneCols ? c.l[0].n : kOneCols;
  c.kt = k0;
  c.ldx = k0 | 1;
  c.lda = 0;
  if (smem_bytes(c) > (size_t)kStaticSmem) {   // stream K
    c.kt = kTileK;
    c.ldx = kTileK + 1;
  }
  return bf16 ? launch<__nv_bfloat16>(c, stream) : launch<float>(c, stream);
}

// The shared memory the card grants a block, in bytes (queried once): a
// chain of two or more layers must fit in it.
extern "C" int smallfloat_matmul_smem_grant(int* bytes) {
  *bytes = smem_optin();
  return 0;
}
