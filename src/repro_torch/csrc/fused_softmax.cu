// fused_softmax: row softmax over the last axis, with the exponential
// either true (expf) or the paper's order-k Taylor series of z / 2^r
// squared r times.
//
// Replaces the TPU kernel fused_softmax / _softmax_kernel + _taylor_exp
// (src/repro/kernels/fused_softmax/fused_softmax.py, pl.pallas_call at L52).
//
// What bounds it on an H100: bytes.  BraggNN(s=1, img=11) at batch 256
// hands it 256*81 rows of 81 fp32 values, 6.7 MB in and 6.7 MB out, about
// 4 us at 3.35 TB/s.  Rows of 81 floats (324 B) are never 16-byte aligned,
// so a warp that reads its own row takes 4-byte loads and partial sectors.
// Once each byte moves once, the next limit is instruction issue: the
// order-8 series is 27 floating-point operations per element, and an IEEE
// division costs about ten instructions, so eight of them per element
// would double the kernel's time.
//
// Design: a block owns a run of consecutive rows, which is one contiguous
// span of rows_per_block * cols floats.  It stages the span in shared
// memory with 16-byte loads (scalar loads only for the unaligned head and
// tail), rounding each input to (wE, wF) once as it lands.  Each of the
// block's eight warps then takes a row at a time and reduces its max and
// sum with shuffles: a row of up to 32 * kRegs values stays in the lane's
// registers through the three passes, a wider one is walked in shared
// memory, where its exponentials are kept.  The normalised row goes back
// to shared memory and the block writes the span with 16-byte stores, so
// each element is read from device memory once and written once.
// rows_per_block is 16, two rows per warp (at BraggNN's width, 1,296
// blocks of 16 rows finish sooner than 2,592 blocks of 8: a block's load,
// compute and store phases follow one another, and fewer, fuller blocks
// leave less of each exposed), while 16 rows fit in the shared memory a
// block may take; fewer for wider rows (8 at about 7,000 columns), down
// to one; wider rows are refused
// (fused_softmax_rows_per_block returns 0).  The series keeps the
// reference's order of operations (y = z / 2^r, term = term * y / k,
// acc = acc + term, r squarings), with one exact rewrite and two that
// round differently: z / 2^r is z * 2^-r (the same real number, rounded
// once either way); / k is a multiplication by 1/k rounded to nearest,
// and the row's sum is inverted once and each exponential multiplied by
// it (PERF.md gives the measured gap from the plain version).  The orders
// the port serves (0: true exp; 8: BraggNN's) are compiled with the
// series unrolled and 1/k folded to constants; any other order reads 1/k
// from a table the block fills once.  Any row count: the last block takes
// the rows left.

#include <cuda_runtime.h>
#include <math.h>

#include "quantize.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxRowsPerBlock = 16;  // two rows per warp
// the span sits at its input address's offset within 16 bytes, so up to
// three floats of padding precede it
constexpr int kPad = 3;
constexpr int kRegs = 4;  // values per lane of a row held in registers

// ORDER >= 0: the series' order, fixed at compile time (0: expf);
// ORDER < 0: `order` at run time, with inv_k[k] = 1/k.
template <int ORDER>
__device__ __forceinline__ float exp_of(float z, int order, int rr,
                                        float scale,
                                        const float* __restrict__ inv_k) {
  if (ORDER == 0) return expf(z);
  const float y = z * scale;  // z / 2^rr
  float acc = 1.0f, term = 1.0f;
  if (ORDER > 0) {
#pragma unroll
    for (int k = 1; k <= ORDER; ++k) {
      term = term * y * (1.0f / (float)k);
      acc = acc + term;
    }
  } else {
    for (int k = 1; k <= order; ++k) {
      term = term * y * inv_k[k];
      acc = acc + term;
    }
  }
  for (int r = 0; r < rr; ++r) acc = acc * acc;
  return acc;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// One warp normalises `row` (cols staged values) in place.
template <int ORDER>
__device__ __forceinline__ void softmax_row(float* row, int cols, int lane,
                                            int order, int rr, float scale,
                                            const float* inv_k) {
  if (cols <= 32 * kRegs) {
    float v[kRegs];
    float m = -INFINITY;
#pragma unroll
    for (int e = 0; e < kRegs; ++e) {
      const int c = lane + 32 * e;
      v[e] = c < cols ? row[c] : -INFINITY;
      m = fmaxf(m, v[e]);
    }
    m = warp_max(m);
    float s = 0.0f;
#pragma unroll
    for (int e = 0; e < kRegs; ++e) {
      if (lane + 32 * e < cols) {
        v[e] = exp_of<ORDER>(v[e] - m, order, rr, scale, inv_k);
        s += v[e];
      }
    }
    const float inv_s = 1.0f / warp_sum(s);
#pragma unroll
    for (int e = 0; e < kRegs; ++e) {
      const int c = lane + 32 * e;
      if (c < cols) row[c] = v[e] * inv_s;
    }
  } else {
    float m = -INFINITY;
    for (int c = lane; c < cols; c += 32) m = fmaxf(m, row[c]);
    m = warp_max(m);
    float s = 0.0f;
    for (int c = lane; c < cols; c += 32) {
      const float e = exp_of<ORDER>(row[c] - m, order, rr, scale, inv_k);
      row[c] = e;
      s += e;
    }
    const float inv_s = 1.0f / warp_sum(s);
    for (int c = lane; c < cols; c += 32) row[c] = row[c] * inv_s;
  }
}

template <int ORDER>
__global__ void __launch_bounds__(kThreads)
fused_softmax_kernel(const float* __restrict__ x, float* __restrict__ out,
                     int rows, int cols, int rows_per_block, int order,
                     int rr, QFmt fmt) {
  extern __shared__ float4 smem4[];
  float* inv_k = reinterpret_cast<float*>(smem4);  // [order + 1]
  // the span, after the table rounded up to 16 bytes
  float* base = inv_k + ((order + 4) & ~3);

  const long long row0 = (long long)blockIdx.x * rows_per_block;
  const int nrows = (int)min((long long)rows_per_block, rows - row0);
  const int n = nrows * cols;
  const float* xs = x + row0 * cols;
  float* os = out + row0 * cols;
  const int tid = threadIdx.x;

  if (ORDER < 0)
    for (int k = 1 + tid; k <= order; k += blockDim.x)
      inv_k[k] = 1.0f / (float)k;

  // Stage: element i of the span goes to sp[i], where sp sits at the
  // span's offset within 16 bytes, so aligned float4s land aligned.
  const int a = (int)((reinterpret_cast<size_t>(xs) >> 2) & 3);
  float* sp = base + a;
  const int head = min((4 - a) & 3, n);
  const int nvec = (n - head) >> 2;
  const int tail0 = head + 4 * nvec;
  const float4* xv = reinterpret_cast<const float4*>(xs + head);
  float4* sv = reinterpret_cast<float4*>(sp + head);
  if (fmt.man_bits < 0) {
    if (tid < head) sp[tid] = xs[tid];
    for (int i = tid; i < nvec; i += blockDim.x) sv[i] = __ldg(xv + i);
    if (tail0 + tid < n) sp[tail0 + tid] = xs[tail0 + tid];
  } else {
    if (tid < head) sp[tid] = quantize_fp(xs[tid], fmt);
    for (int i = tid; i < nvec; i += blockDim.x) {
      const float4 v = __ldg(xv + i);
      sv[i] = make_float4(quantize_fp(v.x, fmt), quantize_fp(v.y, fmt),
                          quantize_fp(v.z, fmt), quantize_fp(v.w, fmt));
    }
    if (tail0 + tid < n) sp[tail0 + tid] = quantize_fp(xs[tail0 + tid], fmt);
  }
  __syncthreads();

  const float scale = __int_as_float((127 - rr) << 23);  // 2^-rr, exact
  for (int r = tid >> 5; r < nrows; r += kWarps)
    softmax_row<ORDER>(sp + r * cols, cols, tid & 31, order, rr, scale,
                       inv_k);
  __syncthreads();

  // Store: the output span's own alignment decides its head; its body
  // reads the staged values as float4s where the two spans share an
  // offset within 16 bytes, else one float at a time.
  const int b = (int)((reinterpret_cast<size_t>(os) >> 2) & 3);
  const int ohead = min((4 - b) & 3, n);
  const int onvec = (n - ohead) >> 2;
  if (tid < ohead) os[tid] = sp[tid];
  float4* ov = reinterpret_cast<float4*>(os + ohead);
  if (a == b) {
    const float4* src = reinterpret_cast<const float4*>(sp + ohead);
    for (int i = tid; i < onvec; i += blockDim.x) ov[i] = src[i];
  } else {
    for (int i = tid; i < onvec; i += blockDim.x) {
      const float* s4 = sp + ohead + 4 * i;
      ov[i] = make_float4(s4[0], s4[1], s4[2], s4[3]);
    }
  }
  const int otail0 = ohead + 4 * onvec;
  if (otail0 + tid < n) os[otail0 + tid] = sp[otail0 + tid];
}

int max_smem_bytes() {
  static int bytes = 0;
  if (bytes == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                           dev);
  }
  return bytes;
}

long long smem_bytes(int rows_per_block, int cols, int order) {
  return (long long)sizeof(float) *
         (((order + 4LL) & ~3LL) + kPad + (long long)rows_per_block * cols);
}

template <int ORDER>
cudaError_t launch(const float* x, float* out, int rows, int cols, int rpb,
                   int order, int rr, QFmt fmt, cudaStream_t stream) {
  const int smem = (int)smem_bytes(rpb, cols, order);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fused_softmax_kernel<ORDER>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  const int blocks = (rows + rpb - 1) / rpb;
  fused_softmax_kernel<ORDER><<<blocks, kThreads, smem, stream>>>(
      x, out, rows, cols, rpb, order, rr, fmt);
  return cudaGetLastError();
}

}  // namespace

// Rows one block stages at this width and order: kMaxRowsPerBlock, fewer
// for rows too wide for that many in the card's shared memory, 0 for a row
// too wide for one block (the wrapper refuses those).
extern "C" int fused_softmax_rows_per_block(int cols, int order) {
  const int limit = max_smem_bytes();
  for (int r = kMaxRowsPerBlock; r > 0; --r)
    if (smem_bytes(r, cols, order) <= limit) return r;
  return 0;
}

// order == 0: true exp.  exp_bits < 0: the input is read as it is.
// Returns cudaGetLastError() (cudaErrorInvalidValue for rows too wide).
extern "C" int fused_softmax_f32(const void* x, void* out, int rows, int cols,
                                 int order, int range_reduce, int exp_bits,
                                 int man_bits, void* stream) {
  const int rpb = fused_softmax_rows_per_block(cols, order);
  if (rpb == 0) return (int)cudaErrorInvalidValue;
  const auto* xf = (const float*)x;
  auto* of = (float*)out;
  const QFmt fmt = make_qfmt(exp_bits, man_bits);
  auto* st = (cudaStream_t)stream;
  const cudaError_t e =
      order == 0   ? launch<0>(xf, of, rows, cols, rpb, 0, range_reduce, fmt, st)
      : order == 8 ? launch<8>(xf, of, rows, cols, rpb, 8, range_reduce, fmt, st)
                   : launch<-1>(xf, of, rows, cols, rpb, order, range_reduce,
                                fmt, st);
  return (int)e;
}
