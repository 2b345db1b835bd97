// dfg_segment: one fused segment of the generic DFG tier.  For each
// levelised (level, opcode) group in order: gather the operands through the
// group's index spans, compute the opcode, re-quantise the result to
// (wE, wF) where flagged, and scatter it into the value buffer.
//
// Replaces the TPU kernel _segment_fn's kernel running _segment_body
// (src/repro/core/emit_pallas.py:248-279, pl.pallas_call at L269).
//
// What bounds it on an H100: bytes.  BraggNN(s=1, img=11) is one segment of
// 138 groups over 953,633 values per sample; its 1.6M int32 indices
// (6.4 MB) address about 1.6M 4-byte operand reads and result writes per
// sample, 1.64 GB per batch of 256, 0.49 ms at 3.35 TB/s.  The operations
// are one or two flops per gathered value, far below the fp32 roof.
//
// Design.  The TPU kernel keeps a (block, n_values) slab of the buffer
// resident in VMEM.  Here the buffer (976 MB at batch 256) lives in device
// memory, VALUE-MAJOR, (n_values, batch): a thread takes (op j, sample b)
// with b the fastest index, so a warp reads and writes 32 samples of one
// value, 128 contiguous bytes, and every gather and scatter is coalesced.
// The whole segment is ONE persistent cooperative launch sized to the
// card's co-resident blocks; it walks a per-group descriptor table in
// device memory (opcode, arity, span offsets, length, flags) with a
// grid-wide barrier between groups, since a group reads what earlier
// groups wrote.  Operands are loaded with __ldcg (L2, not L1): another SM
// wrote them.  Every group's result is scattered, also where the planner
// elided the scatter (forwarding in registers is left to a faster kernel):
// only the matching gathers read those slots, so the values are the same.
//
// Rounding, value for value with the numpy functional model
// (emit.evaluate): fmac is __fadd_rn(__fmul_rn(a, b), c), two roundings,
// since nvcc would contract a*b+c into one FMA; the other arithmetic uses
// the _rn intrinsics too; divf and sqrtf are IEEE (-prec-div and
// -prec-sqrt, never --use_fast_math); maxf, minf and relu propagate NaN as
// np.maximum does; re-quantisation is the shared quantize_fp.  In groups
// flagged kFlagDrops, result slots at n_values (ops without a destination)
// are dropped.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include "quantize.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kDescWidth = 8;
constexpr int kThreads = 256;
constexpr int kFlagQuant = 1;
constexpr int kFlagDrops = 2;

// SEGMENT_OPCODES in kernels/dfg_segment/dfg_segment.py
enum Op {
  kMul = 0, kAdd, kSub, kDiv, kSqrt, kMax, kMin, kNeg, kRelu, kFmac,
  kLoad, kStore, kCopy
};

__device__ __forceinline__ float max_np(float a, float b) {
  return (isnan(a) || isnan(b)) ? a + b : fmaxf(a, b);
}

__device__ __forceinline__ float min_np(float a, float b) {
  return (isnan(a) || isnan(b)) ? a + b : fminf(a, b);
}

__device__ __forceinline__ float apply(int op, float a, float b, float c) {
  switch (op) {
    case kMul: return __fmul_rn(a, b);
    case kAdd: return __fadd_rn(a, b);
    case kSub: return __fsub_rn(a, b);
    case kDiv: return a / b;
    case kSqrt: return sqrtf(a);
    case kMax: return max_np(a, b);
    case kMin: return min_np(a, b);
    case kNeg: return -a;
    case kRelu: return max_np(a, 0.0f);
    case kFmac: return __fadd_rn(__fmul_rn(a, b), c);
    default: return a;  // load, store, copy
  }
}

// One group, elements first, first + stride, ... of its len * batch.
__device__ __forceinline__ void run_group(float* __restrict__ buf,
                                          const int* __restrict__ idx,
                                          const int* __restrict__ d,
                                          int n_values, int batch,
                                          const QFmt& fmt, int first,
                                          int stride) {
  const int op = __ldg(d + 0), arity = __ldg(d + 1);
  const int* a0 = idx + __ldg(d + 2);
  const int* a1 = idx + __ldg(d + 3);
  const int* a2 = idx + __ldg(d + 4);
  const int* res = idx + __ldg(d + 5);
  const int total = __ldg(d + 6) * batch;
  const int flags = __ldg(d + 7);
  const bool quant = (flags & kFlagQuant) != 0;
  const bool drops = (flags & kFlagDrops) != 0;
  for (int e = first; e < total; e += stride) {
    const int j = e / batch;
    const int b = e - j * batch;
    const float x = __ldcg(buf + (long long)__ldg(a0 + j) * batch + b);
    const float y =
        arity > 1 ? __ldcg(buf + (long long)__ldg(a1 + j) * batch + b) : 0.0f;
    const float z =
        arity > 2 ? __ldcg(buf + (long long)__ldg(a2 + j) * batch + b) : 0.0f;
    float r = apply(op, x, y, z);
    if (quant) r = quantize_fp(r, fmt);
    const int o = __ldg(res + j);
    if (!drops || o < n_values) buf[(long long)o * batch + b] = r;
  }
}

__global__ void __launch_bounds__(kThreads)
    dfg_segment_kernel(float* __restrict__ buf, const int* __restrict__ idx,
                       const int* __restrict__ desc, int n_groups,
                       int n_values, int batch, QFmt fmt) {
  cg::grid_group grid = cg::this_grid();
  const int first = blockIdx.x * blockDim.x + threadIdx.x;
  const int stride = gridDim.x * blockDim.x;
  for (int g = 0; g < n_groups; ++g) {
    run_group(buf, idx, desc + g * kDescWidth, n_values, batch, fmt, first,
              stride);
    if (g + 1 < n_groups) grid.sync();
  }
}

}  // namespace

// buf: (n_values, batch) fp32, updated in place; idx: the segment's int32
// index spans; desc: (n_groups, 8) int32 descriptors; all device
// pointers.  exp_bits < 0: no re-quantisation.  One cooperative launch for
// the whole segment.  Returns the first CUDA error, or cudaGetLastError().
extern "C" int dfg_segment_f32(void* buf, const void* idx, const void* desc,
                               int n_groups, int n_values, int batch,
                               int exp_bits, int man_bits, void* stream) {
  QFmt fmt = make_qfmt(exp_bits, man_bits);
  float* b = (float*)buf;
  const int* i = (const int*)idx;
  const int* d = (const int*)desc;
  cudaStream_t s = (cudaStream_t)stream;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, dfg_segment_kernel, kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid(sms * per_sm), block(kThreads);
  int coop = 0;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return (int)err;
  if (!coop) return (int)cudaErrorNotSupported;
  void* args[] = {&b, &i, &d, &n_groups, &n_values, &batch, &fmt};
  err = cudaLaunchCooperativeKernel((const void*)dfg_segment_kernel, grid,
                                    block, args, 0, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
