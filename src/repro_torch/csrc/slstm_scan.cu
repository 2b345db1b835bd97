// slstm_scan: the sLSTM's time loop (xLSTM's scalar-memory cell), the whole
// sequence of one layer call in one launch.  Per step t and head, in fp32:
//
//   rec_g = h_{t-1} @ R_g                      (g in i, f, z, o; per head)
//   pre_g = x_pre_g[t] + rec_g
//   log_f = log_sigmoid(pre_f)
//   m'    = max(log_f + m, pre_i)
//   i     = exp(pre_i - m'),  f = exp(log_f + m - m')
//   c'    = f c + i tanh(pre_z),  n' = f n + i
//   h'    = sigmoid(pre_o) c' / max(n', 1e-6)
//
// Replaces no TPU kernel: the reference computes this step in jnp under
// lax.scan (src/repro/nn/xlstm.py:275, _slstm_scan), which XLA compiles
// into one loop.  Run eagerly in PyTorch the loop would be about 20
// launches a step, 1,024 steps a prefill and 6 sLSTM layers in
// xlstm-1.3b: this kernel is that loop, one launch per layer call, for the
// prefill and the decode tick alike, and it can be captured in a CUDA
// graph (no host sync, no allocation).
//
// What bounds it on an H100: the work is 4 W^2 multiply-adds per (batch
// row, head, step) and R (4 x H x W x W fp32, 16 MB at xlstm-1.3b's H 4,
// W 512) is read once per step per (batch row, head); the bound of the
// function (each input read once, 2 flops per multiply-add at the fp32
// CUDA-core rate) is 0.51 ms at B 4, S 1,024.  But the steps depend on one
// another: every step waits for the whole h_{t-1} of its head, so the
// floor is S times one step's latency (a cluster barrier, a shared-memory
// gather and a pass over R from L2), far above the flops.
//
// Design: R is block-diagonal over heads, so only the blocks of one
// (batch row, head) exchange h.  One thread-block cluster of kCluster
// blocks per (batch row, head); each block owns `units` consecutive units
// (W / 8: 64 at W 512) for all four gates and keeps its slice of h in its
// shared memory, double-buffered by step parity.  A step: every block
// gathers h_{t-1} from the cluster's distributed shared memory; its
// threads split the 4 x units dot products of length W into slices of W
// (float4 loads of R through the read-only path, neighbouring threads on
// neighbouring groups of four units); the slices are summed in
// a fixed order; the threads that own a unit apply the gating, keep c, n
// and m in registers, write h_t to their slice and to hs; one cluster
// barrier ends the step.  R (16 MB a layer) does not fit in shared memory
// and stays in L2 (50 MB), read once per step by each block.  The gating
// is slstm_gates.cuh's, which the backward shares.
//
// For training the launch may also save, per step, what the backward
// (slstm_scan_backward.cu) reads: the four preactivations pre_g and the
// state c, n, m after the step, seven (B, S, H, W) fp32 tensors (56 MB at
// B 1, S 1,024, H 4, W 512; the backward rebuilds the gates from them with
// no second product over R).  On the serving paths the save pointers are
// null and the step writes nothing more.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include <algorithm>

#include "slstm_gates.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;    // blocks per (batch row, head)
constexpr int kThreads = 256;
constexpr int kVec = 4;        // units per float4 load of R

struct Scan {
  const float* x[4];   // (B, S, H, W) preactivations of the gates i, f, z, o
  const float* r[4];   // (H, W, W) recurrent weights, unit v = sum_w h_w r_wv
  float* h;            // (B, H, W) state, read at the start and written at
  float* c;            // the end
  float* n;
  float* m;
  float* hs;           // (B, S, H, W) the h of every step
  float* save[7];      // null, or (B, S, H, W) pre_i, pre_f, pre_z, pre_o
                       // and c, n, m after the step
  int steps, heads, width;
  int units;           // units per block (a multiple of kVec)
};

__global__ void __launch_bounds__(kThreads) slstm_scan_kernel(Scan a) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int bh = blockIdx.x / kCluster;       // batch row * heads + head
  const int head = bh % a.heads;
  const int W = a.width, U = a.units;
  const int v0 = rank * U;                     // this block's first unit
  const int owned = max(0, min(U, W - v0));
  // (slice, gate, unit group) items: consecutive threads on consecutive
  // units of one gate's row of R
  const int groups = 4 * (U / kVec);
  const int slices = max(1, min(W, kThreads / groups));
  const int span = (W + slices - 1) / slices;

  extern __shared__ __align__(16) float smem[];
  float* h_all = smem;                 // [W]      h_{t-1}, gathered
  float* h_own = smem + W;             // [2][U]   this block's slice
  float* part = h_own + 2 * U;         // [slices][4][U] partial sums

  const int u = threadIdx.x;
  const bool mine = u < owned;
  const long long st = (long long)bh * W + v0 + u;   // (b, head, unit)
  float c = 0.f, n = 0.f, m = 0.f;
  if (mine) {
    h_own[u] = a.h[st];
    c = a.c[st];
    n = a.n[st];
    m = a.m[st];
  }
  const long long head_r = (long long)head * W * W;
  cluster.sync();

  for (int t = 0; t < a.steps; ++t) {
    const int p = t & 1;
    // (b, t, head) row of x_pre and hs; batch row b = bh / heads
    const long long row =
        (((long long)(bh / a.heads) * a.steps + t) * a.heads + head) * W;
    float xg[4];
    if (mine)
      for (int g = 0; g < 4; ++g) xg[g] = __ldg(a.x[g] + row + v0 + u);
    for (int j = threadIdx.x; j < W; j += kThreads) {
      const int src = j / U;
      const float* slice = cluster.map_shared_rank(h_own + p * U, src);
      h_all[j] = slice[j - src * U];
    }
    __syncthreads();
    for (int item = threadIdx.x; item < slices * groups; item += kThreads) {
      const int k = item / groups, gq = item - k * groups;
      const int g = gq / (U / kVec), q = gq - g * (U / kVec);
      const int v = v0 + q * kVec;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      if (v < W) {
        const float* r = a.r[g] + head_r + v;
        const int w1 = min(W, (k + 1) * span);
#pragma unroll 8
        for (int w = k * span; w < w1; ++w) {
          const float hw = h_all[w];
          const float4 rv =
              __ldg(reinterpret_cast<const float4*>(r + (long long)w * W));
          acc.x = fmaf(hw, rv.x, acc.x);
          acc.y = fmaf(hw, rv.y, acc.y);
          acc.z = fmaf(hw, rv.z, acc.z);
          acc.w = fmaf(hw, rv.w, acc.w);
        }
      }
      *reinterpret_cast<float4*>(part + (k * 4 + g) * U + q * kVec) = acc;
    }
    __syncthreads();
    if (mine) {
      float pre[4];
      for (int g = 0; g < 4; ++g) {
        float rec = 0.f;
        for (int k = 0; k < slices; ++k) rec += part[(k * 4 + g) * U + u];
        pre[g] = xg[g] + rec;
      }
      const SlstmGates q = slstm_gates(pre, m);
      c = q.fg * c + q.ig * q.z;
      n = q.fg * n + q.ig;
      m = q.m_new;
      const float h = q.o * c / fmaxf(n, 1e-6f);
      h_own[(p ^ 1) * U + u] = h;
      a.hs[row + v0 + u] = h;
      if (a.save[0]) {
        const long long at = row + v0 + u;
        for (int g = 0; g < 4; ++g) a.save[g][at] = pre[g];
        a.save[4][at] = c;
        a.save[5][at] = n;
        a.save[6][at] = m;
      }
    }
    // h_t is in every slice, and nobody reads h_{t-1} any more
    cluster.sync();
  }
  if (mine) {
    a.h[st] = h_own[(a.steps & 1) * U + u];
    a.c[st] = c;
    a.n[st] = n;
    a.m[st] = m;
  }
}

}  // namespace

// x, r: arrays of four device pointers (the gates i, f, z, o): x_pre
// (B, S, H, W) and R (H, W, W), contiguous fp32; h, c, n, m: (B, H, W)
// fp32, read and written in place; hs: (B, S, H, W) fp32; save: null, or
// seven (B, S, H, W) fp32 pointers (pre_i, pre_f, pre_z, pre_o, then c, n,
// m after each step).  R is read as float4: W a multiple of 4, each R
// 16-byte aligned, W <= kCluster * kThreads.  One launch of B * H clusters
// of kCluster blocks.  Returns the launch's CUDA error, or
// cudaGetLastError().
extern "C" int slstm_scan_f32(const void* const* x, const void* const* r,
                              void* h, void* c, void* n, void* m, void* hs,
                              void* const* save, int batch, int steps,
                              int heads, int width, void* stream) {
  if (width < kVec || width > kCluster * kThreads || width % kVec)
    return (int)cudaErrorInvalidValue;
  Scan a;
  for (int g = 0; g < 4; ++g) {
    a.x[g] = static_cast<const float*>(x[g]);
    a.r[g] = static_cast<const float*>(r[g]);
  }
  a.h = static_cast<float*>(h);
  a.c = static_cast<float*>(c);
  a.n = static_cast<float*>(n);
  a.m = static_cast<float*>(m);
  a.hs = static_cast<float*>(hs);
  for (int k = 0; k < 7; ++k)
    a.save[k] = save ? static_cast<float*>(save[k]) : nullptr;
  a.steps = steps;
  a.heads = heads;
  a.width = width;
  const int per = (width + kCluster - 1) / kCluster;
  a.units = (per + kVec - 1) / kVec * kVec;
  const int groups = 4 * (a.units / kVec);
  const int slices = std::max(1, std::min(width, kThreads / groups));
  const size_t smem =
      sizeof(float) * (width + 2 * a.units + slices * 4 * a.units);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(batch * heads * kCluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, slstm_scan_kernel, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
