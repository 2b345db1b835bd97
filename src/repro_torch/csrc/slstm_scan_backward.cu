// slstm_scan_backward: the gradient of the sLSTM's time loop
// (slstm_scan.cu) with respect to the gates' preactivations, the whole
// sequence of one layer call in one launch, walking the steps in reverse
// from t = S-1 down to 0.  Per step and unit, in fp32, from the forward's
// saves (pre_g, and c, n, m after each step):
//
//   dh   = dhs_t + dh_rec                    (dh_rec from step t+1)
//   the gate derivatives dpre_g,t of the forward's step, as autodiff gives
//   them through the reference's jnp ops: at a tie of max(log_f + m,
//   pre_i) or of max(n, 1e-6) each side takes half, as jnp.maximum's
//   derivative does; dc, dn and dm carried to step t-1 in registers
//   dh_rec(t-1) = sum_g dpre_g,t @ R_g^T     (per head)
//
// and writes dpre_g,t for every step: the gradients of x_pre.  The
// gradients of R, dR_g = sum_{b,t} h_{t-1}^T dpre_g,t, are one large
// product per gate that the caller takes after the launch
// (kernels/slstm_scan/ref.rec_grads).
//
// Replaces no TPU kernel: the reference differentiates its lax.scan with
// jax.grad (src/repro/nn/xlstm.py:275, _slstm_scan), which XLA compiles
// into a reverse loop.
//
// What bounds it on an H100: as the forward, 4 W^2 multiply-adds per
// (batch row, head, step) and R read once per step per (batch row, head);
// the steps depend on one another through dh_rec, so the floor is S times
// one step's latency (a cluster barrier, a shared-memory gather and a pass
// over R from L2), far above the flops.
//
// Design: the forward's layout.  One thread-block cluster of kCluster
// blocks per (batch row, head); each block owns `units` consecutive units
// of all four gates.  A step: the threads that own a unit take its dh
// (dhs_t plus the dh_rec this block computed for its units), rebuild the
// gates from the saves with slstm_gates.cuh (the forward's own code),
// compute dpre_g,t, write it to dx and to their slice in shared memory,
// double-buffered by step parity; one cluster barrier; then every block
// gathers all 4 W of dpre_g,t from the cluster's distributed shared memory
// and computes dh_rec(t-1) for its own units: where the forward reads R's
// columns of its units, the backward reads R's rows, one warp per row,
// consecutive lanes on consecutive float4s of the row (coalesced), each
// lane's products summed in a fixed order and the lanes' sums by a fixed
// shuffle tree.  No atomics: a launch computes the same bits every time.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include <algorithm>

#include "slstm_gates.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;    // blocks per (batch row, head): the forward's
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 4;        // floats per float4 load of R

struct ScanBack {
  const float* r[4];     // (H, W, W) recurrent weights, unit v = sum_w h_w r_wv
  const float* dhs;      // (B, S, H, W) gradient of every step's h
  const float* save[7];  // (B, S, H, W) pre_i, pre_f, pre_z, pre_o; c, n, m
                         // after each step (the forward's saves)
  const float* c0;       // (B, H, W) the state before step 0
  const float* n0;
  const float* m0;
  float* dx[4];          // (B, S, H, W) gradients of the preactivations
  int steps, heads, width;
  int units;             // units per block (a multiple of kVec)
};

__device__ __forceinline__ float half_on_tie(float a, float b) {
  // d max(a, b) / da, as jnp.maximum's derivative: 1, 0, or 0.5 at a tie
  return a > b ? 1.f : (a == b ? 0.5f : 0.f);
}

__global__ void __launch_bounds__(kThreads)
slstm_scan_backward_kernel(ScanBack a) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int bh = blockIdx.x / kCluster;       // batch row * heads + head
  const int head = bh % a.heads;
  const int W = a.width, U = a.units;
  const int v0 = rank * U;                     // this block's first unit
  const int owned = max(0, min(U, W - v0));

  extern __shared__ __align__(16) float smem[];
  float* dp_all = smem;                // [4][W]    dpre of a step, gathered
  float* dp_own = smem + 4 * W;        // [2][4][U] this block's slice
  float* dh_rec = dp_own + 8 * U;      // [U]       dh_rec of its units

  const int u = threadIdx.x;
  const bool mine = u < owned;
  const long long st = (long long)bh * W + v0 + u;   // (b, head, unit)
  float dc = 0.f, dn = 0.f, dm = 0.f;  // gradients of the state after t
  if (mine) dh_rec[u] = 0.f;
  const long long head_r = (long long)head * W * W;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int chunks = W / kVec;
  cluster.sync();

  for (int t = a.steps - 1; t >= 0; --t) {
    if (t < a.steps - 1) {
      // dh_rec(t) = sum_g dpre_g,t+1 @ R_g^T for this block's units
      float* step_own = dp_own + ((t + 1) & 1) * 4 * U;
      for (int j = threadIdx.x; j < 4 * W; j += kThreads) {
        const int g = j / W, v = j - g * W, src = v / U;
        const float* slice = cluster.map_shared_rank(step_own, src);
        dp_all[j] = slice[g * U + v - src * U];
      }
      __syncthreads();
      for (int w = warp; w < owned; w += kWarps) {
        float acc = 0.f;
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          const float4* row = reinterpret_cast<const float4*>(
              a.r[g] + head_r + (long long)(v0 + w) * W);
          const float4* dp = reinterpret_cast<const float4*>(dp_all + g * W);
#pragma unroll 4
          for (int k = lane; k < chunks; k += 32) {
            const float4 rv = __ldg(row + k);
            const float4 d = dp[k];
            acc = fmaf(rv.x, d.x, acc);
            acc = fmaf(rv.y, d.y, acc);
            acc = fmaf(rv.z, d.z, acc);
            acc = fmaf(rv.w, d.w, acc);
          }
        }
        for (int off = 16; off > 0; off >>= 1)
          acc += __shfl_down_sync(0xffffffffu, acc, off);
        if (lane == 0) dh_rec[w] = acc;
      }
      __syncthreads();
    }
    if (mine) {
      // (b, t, head) row of the saves; batch row b = bh / heads
      const long long row =
          (((long long)(bh / a.heads) * a.steps + t) * a.heads + head) * W;
      const long long at = row + v0 + u;
      const long long prev = at - (long long)a.heads * W;   // step t-1
      float pre[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) pre[g] = __ldg(a.save[g] + at);
      const float c_prev = t ? __ldg(a.save[4] + prev) : __ldg(a.c0 + st);
      const float n_prev = t ? __ldg(a.save[5] + prev) : __ldg(a.n0 + st);
      const float m_prev = t ? __ldg(a.save[6] + prev) : __ldg(a.m0 + st);
      const float c = __ldg(a.save[4] + at), n = __ldg(a.save[5] + at);
      const SlstmGates q = slstm_gates(pre, m_prev);

      // h = o c / den, den = max(n, 1e-6)
      const float dh = __ldg(a.dhs + at) + dh_rec[u];
      const float inv = 1.f / fmaxf(n, 1e-6f);
      const float d_o = dh * c * inv;
      const float dc_t = dc + dh * q.o * inv;
      const float dden = -dh * q.o * c * inv * inv;
      const float dn_t = dn + dden * half_on_tie(n, 1e-6f);
      // c = fg c_prev + ig z, n = fg n_prev + ig
      const float dfg = dc_t * c_prev + dn_t * n_prev;
      const float dig = dc_t * q.z + dn_t;
      const float dz = dc_t * q.ig;
      dc = dc_t * q.fg;
      dn = dn_t * q.fg;
      // ig = exp(pre_i - m_new), fg = exp(log_f + m_prev - m_new)
      const float dm_new = dm - dig * q.ig - dfg * q.fg;
      float dpre_i = dig * q.ig;
      float dlog_f = dfg * q.fg;
      dm = dfg * q.fg;
      // m_new = max(log_f + m_prev, pre_i)
      const float wa = half_on_tie(q.log_f + m_prev, pre[0]);
      dlog_f += dm_new * wa;
      dm += dm_new * wa;
      dpre_i += dm_new * (1.f - wa);

      float d[4];
      d[0] = dpre_i;
      d[1] = dlog_f / (1.f + expf(pre[1]));   // log_sigmoid' = sigmoid(-x)
      d[2] = dz * (1.f - q.z * q.z);
      d[3] = d_o * q.o * (1.f - q.o);
      float* own = dp_own + (t & 1) * 4 * U;
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        a.dx[g][at] = d[g];
        own[g * U + u] = d[g];
      }
    }
    // dpre of step t is in every slice, and nobody reads step t+2's any
    // more
    cluster.sync();
  }
}

}  // namespace

// r: four device pointers to R (H, W, W); dhs: (B, S, H, W); save: the
// forward's seven (B, S, H, W) saves; c0, n0, m0: (B, H, W), the state
// the forward started from; dx: four (B, S, H, W) outputs.  All contiguous
// fp32; W a multiple of 4, each R 16-byte aligned, W <= kCluster *
// kThreads.  One launch of B * H clusters of kCluster blocks.  Returns the
// launch's CUDA error, or cudaGetLastError().
extern "C" int slstm_scan_backward_f32(
    const void* const* r, const void* dhs, const void* const* save,
    const void* c0, const void* n0, const void* m0, void* const* dx,
    int batch, int steps, int heads, int width, void* stream) {
  if (width < kVec || width > kCluster * kThreads || width % kVec)
    return (int)cudaErrorInvalidValue;
  ScanBack a;
  for (int g = 0; g < 4; ++g) {
    a.r[g] = static_cast<const float*>(r[g]);
    a.dx[g] = static_cast<float*>(dx[g]);
  }
  for (int k = 0; k < 7; ++k) a.save[k] = static_cast<const float*>(save[k]);
  a.dhs = static_cast<const float*>(dhs);
  a.c0 = static_cast<const float*>(c0);
  a.n0 = static_cast<const float*>(n0);
  a.m0 = static_cast<const float*>(m0);
  a.steps = steps;
  a.heads = heads;
  a.width = width;
  const int per = (width + kCluster - 1) / kCluster;
  a.units = (per + kVec - 1) / kVec * kVec;
  const size_t smem = sizeof(float) * (4 * width + 9 * a.units);
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
  cudaError_t err = cudaLaunchKernelEx(&cfg, slstm_scan_backward_kernel, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
