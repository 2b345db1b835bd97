// dfg_segment: one fused segment of the generic DFG tier.  For each
// levelised (level, opcode) group in order: gather the operands through the
// group's index spans or take them forwarded from the group that computed
// them, compute the opcode, re-quantise the result to (wE, wF) where
// flagged, and scatter it into the value buffer unless the planner elided
// the scatter.
//
// Replaces the TPU kernel _segment_fn's kernel running _segment_body
// (src/repro/core/emit_pallas.py:248-279, pl.pallas_call at L269).
//
// What bounds it on an H100: latency, then L2 bandwidth.  BraggNN(s=1,
// img=11) is one segment of 138 groups over 953,633 values per sample,
// 484,374 ops per sample in groups of 2 to 32,805 ops.  The slots it must
// read from outside the segment and the results it must scatter come to
// about 300 MB per batch of 256 (0.09 ms at 3.35 TB/s), but the gathers
// through the index spans read several times that, from L2.  The operations
// are one or two flops per value, far below the fp32 roof.  Most groups are
// small, so a stage costs a barrier plus a chain of dependent reads (index,
// then operand) per entry whatever its size.
//
// Design.  The TPU kernel's grid runs over blocks of samples, and each grid
// step walks the whole segment for its block alone: samples are
// independent.  Here the same decomposition sits on Hopper's thread-block
// clusters.  The buffer (976 MB at batch 256) stays in device memory,
// VALUE-MAJOR, (n_values, batch), its rows padded to 16 bytes.  The batch
// is cut into slabs of consecutive samples, a multiple of 4 wide, one slab
// per cluster the card holds at once (cudaOccupancyMaxActiveClusters);
// ONE cluster of 16 CTAs owns a slab and walks every entry of the segment
// for it, and no cluster ever waits for another.  A thread's work item is
// one op of a group for four consecutive samples: one 16-byte load per
// operand and one 16-byte store, so a warp reads whole sectors of a few
// rows.  The layout (core/emit_cuda.py _segment_layout) cuts the segment
// into STAGES, such that no entry gathers from the buffer a slot that
// another entry of its stage scatters; between stages the cluster meets at
// the hardware cluster barrier (cooperative_groups::this_cluster().sync()),
// 58 barriers for BraggNN where one grid-wide barrier per group took 137.
// Operands are read through L2 (__ldcg), because another CTA of the cluster
// wrote them: the barrier's arrive has release and its wait acquire
// semantics at cluster scope, which makes those writes visible, and L2 is
// where they are; an SM's L1 is not coherent and might hold a stale line.
// Within a stage, entries linked by forwarded operands form a UNIT of one
// length: one loop over its items computes the producer and then its
// consumers, with the forwarded value held per thread in shared memory
// (kSlots values of kUnroll items), and an elided producer is never
// written to the buffer.  A producer that the planner elided but that sits
// in an earlier stage than its consumer is recomputed in the consumer's
// unit from its own operands, which are SSA values still in the buffer.
// Each thread keeps kUnroll items in flight (their index and operand loads
// issued together) and prefetches into L1 the index words of its next
// items; a stage's units share the cluster's threads as one range of items,
// so a small unit does not leave most threads idle.
//
// Rounding, value for value with the numpy functional model
// (emit.evaluate): fmac is __fadd_rn(__fmul_rn(a, b), c), two roundings,
// since nvcc would contract a*b+c into one FMA; the other arithmetic uses
// the _rn intrinsics too; divf and sqrtf are IEEE (-prec-div and
// -prec-sqrt, never --use_fast_math); maxf, minf and relu propagate NaN as
// np.maximum does; re-quantisation is the shared quantize_fp.  Result slots
// at n_values (ops without a destination) are dropped.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include "quantize.cuh"

namespace cg = cooperative_groups;

namespace {

// kernels/dfg_segment/dfg_segment.py: DESC_WIDTH, the FLAG_* bits, the
// COL_* columns and MAX_SLOTS
constexpr int kDescWidth = 17;
constexpr int kFlagQuant = 1;
constexpr int kFlagElided = 4;
constexpr int kFlagStage = 8;
constexpr int kColFlags = 7;
constexpr int kColSlot = 11;
constexpr int kColResSlot = 14;
constexpr int kColUnit = 15;
constexpr int kSlots = 4;

constexpr int kThreads = 1024;   // threads per CTA
constexpr int kCluster = 16;     // CTAs per cluster (a non-portable size)
constexpr int kUnroll = 2;       // quads in flight per thread
constexpr int kMinSlab = 8;      // samples in a slab, at least (a sector)

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

template <int OP>
__device__ __forceinline__ float apply(float a, float b, float c) {
  switch (OP) {
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

template <int OP>
__device__ __forceinline__ float4 apply4(float4 a, float4 b, float4 c) {
  return make_float4(apply<OP>(a.x, b.x, c.x), apply<OP>(a.y, b.y, c.y),
                     apply<OP>(a.z, b.z, c.z), apply<OP>(a.w, b.w, c.w));
}

template <int OP>
__device__ __forceinline__ void apply_all(const float4 (&a)[3][kUnroll],
                                          float4 (&r)[kUnroll]) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) r[u] = apply4<OP>(a[0][u], a[1][u], a[2][u]);
}

__device__ __forceinline__ float4 quantize4(float4 x, const QFmt& f) {
  return make_float4(quantize_fp(x.x, f), quantize_fp(x.y, f),
                     quantize_fp(x.z, f), quantize_fp(x.w, f));
}

// Where one cluster's thread stands: its slab of samples and its place
// among the cluster's threads.  A thread's work item is (op j, quad q):
// samples col0 + 4q .. col0 + 4q + 3 of op j, one 16-byte vector, numbered
// e = j * nq + q with nq = width / 4 quads in the slab.  A thread visits e,
// e + step, e + 2 step, ..., so (j, q) advances by (dq, dr) = (step / nq,
// step % nq) with a carry, and no item needs a division.
struct Lane {
  int nq;     // quads in a slab
  int col0;   // first sample of the slab
  int nb;     // samples of the slab that exist (the last slab is ragged)
  int step;   // threads in the cluster
  int dq, dr; // step = dq * nq + dr
};

struct Item {
  int j, q;
};

__device__ __forceinline__ Item advance(Item x, int dq, int dr, int nq) {
  x.j += dq;
  x.q += dr;
  if (x.q >= nq) {
    x.q -= nq;
    ++x.j;
  }
  return x;
}

// An entry's row of the descriptor table, as run_entry reads it.
struct Entry {
  int op, arity, flags, rslot;
  int slot[3];
  const int* span[3];
  const int* rspan;
};

__device__ __forceinline__ Entry load_entry(const int* __restrict__ d,
                                            const int* __restrict__ idx) {
  Entry e;
  e.op = __ldg(d + 0);
  e.arity = __ldg(d + 1);
  e.flags = __ldg(d + kColFlags);
  e.rslot = __ldg(d + kColResSlot);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    e.slot[i] = i < e.arity ? __ldg(d + kColSlot + i) : 0;
    e.span[i] = idx + __ldg(d + 2 + i);
  }
  e.rspan = idx + __ldg(d + 5);
  return e;
}

__device__ __forceinline__ void prefetch_l1(const int* p) {
  asm volatile("prefetch.global.L1 [%0];" ::"l"(p));
}

// Bring into L1 the index words an entry reads for the items base, base +
// step, ... (kUnroll of them), so that their loads, one round trip before
// the operand loads, hit L1 when the items come up.
__device__ __forceinline__ void prefetch_items(const Entry& e, Item base,
                                               int n_ops, const Lane& ln) {
  Item x = base;
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    if (x.j < n_ops) {
#pragma unroll
      for (int i = 0; i < 3; ++i)
        if (i < e.arity && e.slot[i] < 0) prefetch_l1(e.span[i] + x.j);
      if (!(e.flags & kFlagElided)) prefetch_l1(e.rspan + x.j);
    }
    x = advance(x, ln.dq, ln.dr, ln.nq);
  }
}

// One entry for the items base, base + step, ... (kUnroll of them) of its
// unit, which has n_ops ops.  Every load is issued before any store: no
// entry of a stage gathers what another one scatters, and an entry reads
// its forwarded operands before it writes its own held value.  A quad that
// starts inside the batch may end in the row's padding (the row stride ld
// is a multiple of 4): those lanes compute on padding and store to it,
// which nothing reads.
__device__ __forceinline__ void run_entry(
    const Entry& e, float* __restrict__ buf, long long ld,
    float4* __restrict__ held, Item base, int n_ops, int n_values,
    const Lane& ln, const QFmt& fmt) {
  int j[kUnroll], col[kUnroll];
  bool ok[kUnroll];
  Item x = base;
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    j[u] = x.j;
    col[u] = ln.col0 + 4 * x.q;
    ok[u] = x.j < n_ops && 4 * x.q < ln.nb;
    x = advance(x, ln.dq, ln.dr, ln.nq);
  }
  int v[3][kUnroll];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const bool gather = i < e.arity && e.slot[i] < 0;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      v[i][u] = gather && ok[u] ? __ldg(e.span[i] + j[u]) : 0;
  }
  const bool scatter = !(e.flags & kFlagElided);
  int o[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u)
    o[u] = scatter && ok[u] ? __ldg(e.rspan + j[u]) : n_values;
  float4 a[3][kUnroll];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const bool gather = i < e.arity && e.slot[i] < 0;
    const bool hold = i < e.arity && e.slot[i] >= 0;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (gather && ok[u])
        a[i][u] = __ldcg(reinterpret_cast<const float4*>(
            buf + v[i][u] * ld + col[u]));
      else if (hold)
        a[i][u] = held[(e.slot[i] * kUnroll + u) * kThreads + threadIdx.x];
      else
        a[i][u] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  }
  float4 r[kUnroll];
  switch (e.op) {
    case kMul: apply_all<kMul>(a, r); break;
    case kAdd: apply_all<kAdd>(a, r); break;
    case kSub: apply_all<kSub>(a, r); break;
    case kDiv: apply_all<kDiv>(a, r); break;
    case kSqrt: apply_all<kSqrt>(a, r); break;
    case kMax: apply_all<kMax>(a, r); break;
    case kMin: apply_all<kMin>(a, r); break;
    case kNeg: apply_all<kNeg>(a, r); break;
    case kRelu: apply_all<kRelu>(a, r); break;
    case kFmac: apply_all<kFmac>(a, r); break;
    default: apply_all<kCopy>(a, r); break;
  }
  const bool quant = (e.flags & kFlagQuant) != 0;
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const float4 y = quant ? quantize4(r[u], fmt) : r[u];
    if (o[u] < n_values)
      *reinterpret_cast<float4*>(buf + o[u] * ld + col[u]) = y;
    if (e.rslot >= 0)
      held[(e.rslot * kUnroll + u) * kThreads + threadIdx.x] = y;
  }
}

// One cluster per slab of samples; the clusters tile the grid along x.
__global__ void __launch_bounds__(kThreads, 1)
    dfg_segment_kernel(float* __restrict__ buf, long long ld,
                       const int* __restrict__ idx,
                       const int* __restrict__ desc, int n_entries,
                       int n_values, int batch, int width, QFmt fmt) {
  extern __shared__ float4 held[];  // [kSlots][kUnroll][kThreads]
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = (int)cluster.num_blocks();
  Lane ln;
  ln.nq = width / 4;
  ln.col0 = (blockIdx.x / csize) * width;
  ln.nb = min(width, batch - ln.col0);
  ln.step = csize * kThreads;
  ln.dq = ln.step / ln.nq;
  ln.dr = ln.step - ln.dq * ln.nq;
  const int chunk = ln.step * kUnroll;
  const int cq = chunk / ln.nq, cr = chunk - cq * ln.nq;
  const int rank = (int)cluster.block_rank() * kThreads + threadIdx.x;
  // A stage's units share the cluster's threads as one range of items:
  // acc is where the unit starts in it, modulo the thread count.
  int acc = 0;
  for (int k = 0; k < n_entries;) {
    const int* d = desc + (long long)k * kDescWidth;
    if ((__ldg(d + kColFlags) & kFlagStage) && k > 0) {
      cluster.sync();
      acc = 0;
    }
    const int len = __ldg(d + kColUnit);
    const int n_ops = __ldg(d + 6);
    int first = rank - acc;
    if (first < 0) first += ln.step;
    Item base = {first / ln.nq, first % ln.nq};
    if (len == 1) {  // most units: the entry's row read once
      const Entry e = load_entry(d, idx);
      while (base.j < n_ops) {
        const Item next = advance(base, cq, cr, ln.nq);
        prefetch_items(e, next, n_ops, ln);
        run_entry(e, buf, ld, held, base, n_ops, n_values, ln, fmt);
        base = next;
      }
    } else {
      for (; base.j < n_ops; base = advance(base, cq, cr, ln.nq))
        for (int m = 0; m < len; ++m)
          run_entry(load_entry(d + m * kDescWidth, idx), buf, ld, held, base,
                    n_ops, n_values, ln, fmt);
    }
    acc = (int)((acc + (long long)n_ops * ln.nq) % ln.step);
    k += len;
  }
}

constexpr size_t kSmemBytes = sizeof(float4) * kSlots * kUnroll * kThreads;

// The most clusters the card holds at once (cudaOccupancyMaxActiveClusters),
// asked once per device.
cudaError_t active_clusters(int* out) {
  static int dev_seen = -1, clusters = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev != dev_seen) {
    err = cudaFuncSetAttribute(dfg_segment_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kSmemBytes);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(dfg_segment_kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
    if (err != cudaSuccess) return err;
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = kCluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(kCluster);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = kSmemBytes;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int n = 0;
    err = cudaOccupancyMaxActiveClusters(&n, (void*)dfg_segment_kernel,
                                         &cfg);
    if (err != cudaSuccess) return err;
    clusters = n;
    dev_seen = dev;
  }
  *out = clusters;
  return cudaSuccess;
}

// The slab width for a batch: a multiple of 4 samples (whole quads), at
// least kMinSlab, and no more slabs than the card holds clusters at once.
int slab_width(int batch, int clusters) {
  const int w = ((batch + clusters - 1) / clusters + 3) / 4 * 4;
  return w > kMinSlab ? w : kMinSlab;
}

}  // namespace

// The launch shape for a batch: out[0] the slab width in samples, out[1]
// the CTAs per cluster, out[2] the clusters the card holds at once.
// cudaErrorInvalidConfiguration when the card cannot hold one cluster.
extern "C" int dfg_segment_shape(int batch, int* out) {
  int clusters = 0;
  cudaError_t err = active_clusters(&clusters);
  if (err != cudaSuccess) return (int)err;
  if (clusters < 1) return (int)cudaErrorInvalidConfiguration;
  out[0] = slab_width(batch, clusters);
  out[1] = kCluster;
  out[2] = clusters;
  return 0;
}

// buf: (n_values, batch) fp32 with row stride ld (a multiple of 4, 16-byte
// aligned rows), updated in place; idx: the segment's int32 index spans;
// desc: (n_entries, 17) int32 entries; all device pointers.
// exp_bits < 0: no re-quantisation.  One launch of ceil(batch / slab)
// clusters of kCluster CTAs.  Returns the first CUDA error, or
// cudaGetLastError().
extern "C" int dfg_segment_f32(void* buf, long long ld, const void* idx,
                               const void* desc, int n_entries, int n_values,
                               int batch, int exp_bits, int man_bits,
                               void* stream) {
  int clusters = 0;
  cudaError_t err = active_clusters(&clusters);
  if (err != cudaSuccess) return (int)err;
  if (clusters < 1) return (int)cudaErrorInvalidConfiguration;
  const int width = slab_width(batch, clusters);
  const int slabs = (batch + width - 1) / width;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(slabs * kCluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmemBytes;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, dfg_segment_kernel, (float*)buf, ld,
                           (const int*)idx, (const int*)desc, n_entries,
                           n_values, batch, width,
                           make_qfmt(exp_bits, man_bits));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
