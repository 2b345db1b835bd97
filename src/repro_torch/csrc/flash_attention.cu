// flash_attention: online-softmax attention over (BH, S, D) fp32, scale
// 1/sqrt(D), with the TPU kernel's options: causal, a local window, a tanh
// logit soft-cap, the finite NEG_INF mask value and the 1e-37 floor on the
// denominator.  Any S, and any D from 1 to kMaxHeadDim.
//
// Replaces the TPU kernel flash_attention / _flash_kernel
// (src/repro/kernels/flash_attention/flash_attention.py, pl.pallas_call at
// L93).
//
// What bounds it on an H100: at the BraggNN NLB shape (B*1 heads, S = 81,
// D = 8) q, k, v and o are 2.65 MB at batch 256 and the two contractions
// 54 MFLOP, 0.79 us of bytes against 0.81 us of fp32 CUDA-core flops; the
// 1.7 M accurate expf (one per score) and the masking cost about as much
// again in issued instructions, and a block's start (parameters, staging
// and its wait) is a fixed latency of a few microseconds: at this size the
// kernel is bound by latency and instruction issue, not by the card's
// rates.  For long sequences the flops dominate (4 S^2 D per head).
//
// Design: a block covers all the query rows of a head (or of several
// heads when S is small; a tile of rows when S is long) and stages the
// head's q rows, K and V in shared memory once, by cp.async (16 bytes at
// a time where rows are unit-stride and aligned, 4 where the operand is a
// transposed view), waited for once; a K, V too large for the block
// streams through in tiles of keys.  The operands are strided
// (B, H, S, D) views, so callers pass transposed layouts without a copy.
// Each query row gets `lanes` threads (a power of two up to 32; 4 at the
// NLB shape, 22 warps per SM); each lane walks its own slice of the keys,
// 8 at a time in registers, with its own running max, denominator and
// accumulator, in the reference's order per step: the scores, their max,
// the correction exp(m_prev - m_new), the probabilities, then the
// accumulator update.  The scores never leave registers, and the code
// between them has no branch (a masked score's expf is 0, as the
// reference's where() makes it).  The lanes of a row are merged at the end
// with shuffles (m = max m_i, l = sum l_i exp(m_i - m), the accumulator
// likewise).  Registers hold one chunk of D (8, 16 or 32 floats, the tail
// lanes zero-padded): a head wider than 32 is computed chunk by chunk over
// its output dims, the scores recomputed per chunk, so no width spills.
// Keys that the causal mask or the window exclude are not visited.  The
// exponential is expf, not __expf; sums stay fp32 FMAs on the CUDA cores
// (TF32 would move results past the 1e-4 tolerance).
//
// Training: given an `lse` buffer, the epilogue also writes each row's
// log-sum-exp, m + log(max(l, 1e-37)) (m taken as 0 where the row saw no
// key), one fp32 per (bh, query row) from the merged lanes; the backward
// (PyTorch, repro_torch/nn/attention.py) recomputes the probabilities as
// exp(score - lse).  Serving passes a null pointer and nothing is written.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kNegInf = -2.3819763e38f;
constexpr int kMaxHeadDim = 256;
constexpr int kKeysPerStep = 8;    // keys a lane scores at once
constexpr int kLaneKeys = 16;      // keys a lane walks at the least
constexpr int kTileKeys = 64;      // keys per staged tile of a long head
constexpr int kPad = 4;            // floats after each staged row (16 B)
constexpr int kSmemBudget = 100 * 1024;   // bytes a block stages at most
constexpr int kStaticSmem = 48 * 1024;

struct Operand {
  const float* p;
  long long sb, sh, ss, sd;   // element strides over (B, H, S, D)
};

struct Attn {
  Operand q, k, v, o;
  float* lse;  // (nbh, sq) log-sum-exp per row, or null
  int nh, nbh, sq, skv, d;
  float scale, cap;
  int causal, window;
  int lanes_log2;   // log2 of the threads per query row
  int rq;      // query rows of one head per block
  int heads;   // heads per block
  int kt;      // keys per staged tile (>= skv: the whole head, staged once)
  int dp;      // staged row width: d rounded up to the chunk, plus kPad
};

constexpr int max_threads(int dc) { return dc == 32 ? 256 : 512; }

__device__ __forceinline__ const float* head_ptr(const Operand& t, int bh,
                                                 int nh) {
  if (nh == 1) return t.p + (long long)bh * t.sb;
  return t.p + (long long)(bh / nh) * t.sb + (long long)(bh % nh) * t.sh;
}

// Asynchronous copies dst[r * dp + c] = src[r * sr + c * sc] for r < nr,
// c < d (16 bytes at a time where rows are unit-stride and 16-byte
// aligned, else 4), and zeros for c in [d, dz).  The block's threads form
// a grid whose width is a power of two along the source's unit-stride
// axis: no division per element.  The caller commits and waits.
__device__ void stage_rows(float* dst, int dp, const float* src,
                           long long sr, long long sc, int nr, int d,
                           int dz) {
  const int tid = threadIdx.x, nthr = blockDim.x;
  const bool vec = sc == 1 && d % 4 == 0 && sr % 4 == 0 &&
                   (reinterpret_cast<unsigned long long>(src) & 15) == 0;
  const bool rows_fast = !vec && sr == 1 && sc != 1;
  const int w = vec ? 4 : 1;
  const int nf = rows_fast ? nr : d / w, ns = rows_fast ? d : nr;
  const int lx = min(nf > 1 ? 32 - __clz(nf - 1) : 0, 31 - __clz(nthr));
  const int tx = tid & ((1 << lx) - 1), ty = tid >> lx;
  const int ny = nthr >> lx;
  if (ty < ny) {
    for (int sl = ty; sl < ns; sl += ny)
      for (int f = tx; f < nf; f += 1 << lx) {
        const int r = rows_fast ? f : sl, c = rows_fast ? sl : w * f;
        __pipeline_memcpy_async(dst + r * dp + c, src + r * sr + c * sc,
                                4 * w);
      }
  }
  for (int r = tid; r < nr; r += nthr)
    for (int c = d; c < dz; ++c) dst[r * dp + c] = 0.0f;
}

// K and V rows [t0, t0 + kl) of each head of the block
__device__ void stage_kv(const Attn& a, float* ks, float* vs, int t0, int kl,
                         int dz) {
  for (int h = 0; h < a.heads; ++h) {
    const int bh = blockIdx.y * a.heads + h;
    if (bh >= a.nbh) break;
    stage_rows(ks + h * a.kt * a.dp, a.dp,
               head_ptr(a.k, bh, a.nh) + t0 * a.k.ss, a.k.ss, a.k.sd, kl,
               a.d, dz);
    stage_rows(vs + h * a.kt * a.dp, a.dp,
               head_ptr(a.v, bh, a.nh) + t0 * a.v.ss, a.v.ss, a.v.sd, kl,
               a.d, dz);
  }
}

__device__ __forceinline__ void staged() {
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
}

// DC: floats of D a thread holds; ONE: D <= DC (one chunk, q in registers
// for the whole key loop)
// No __launch_bounds__: with them ptxas holds DC = 8 to 64 registers and
// DC = 32 to 128, and spills; without, no instantiation spills, and the
// launch keeps to the threads per block its registers allow
// (kernel_threads).
template <int DC, bool ONE>
__global__ void flash_attention_kernel(const __grid_constant__ Attn a) {
  constexpr int KB = kKeysPerStep;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + a.heads * a.rq * a.dp;
  float* vs = ks + a.heads * a.kt * a.dp;
  const int G = 1 << a.lanes_log2;
  const int row = threadIdx.x >> a.lanes_log2;
  const int lane = threadIdx.x & (G - 1);
  const int rows = a.heads * a.rq;
  const int rc = min(row, rows - 1);
  const int hl = a.heads == 1 ? 0 : rc / a.rq;
  const int qi = rc - hl * a.rq;
  const int q0 = blockIdx.x * a.rq;
  const int qpos = q0 + qi;
  const int bh = blockIdx.y * a.heads + hl;
  const bool active = row < rows && bh < a.nbh && qpos < a.sq;
  const int dz = ONE ? DC : (a.d + DC - 1) / DC * DC;

  for (int h = 0; h < a.heads; ++h) {
    const int bhh = blockIdx.y * a.heads + h;
    if (bhh >= a.nbh) break;
    stage_rows(qs + h * a.rq * a.dp, a.dp,
               head_ptr(a.q, bhh, a.nh) + q0 * a.q.ss, a.q.ss, a.q.sd,
               min(a.rq, a.sq - q0), a.d, dz);
  }
  const bool whole = a.kt >= a.skv;
  if (whole) stage_kv(a, ks, vs, 0, a.skv, dz);
  staged();

  // the keys this row sees, and those any row of the block sees
  int lo = 0, hi = 0;
  if (active) {
    lo = a.window > 0 ? max(0, qpos - a.window + 1) : 0;
    hi = a.causal ? min(a.skv, qpos + 1) : a.skv;
  }
  const int q_last = min(q0 + a.rq, a.sq) - 1;
  const int k_end = a.causal ? min(a.skv, q_last + 1) : a.skv;
  const int k_begin =
      whole || a.window <= 0 ? 0 : max(0, q0 - a.window + 1) / a.kt * a.kt;

  const float* qrow = qs + rc * a.dp;
  const float* kh = ks + hl * a.kt * a.dp;
  const float* vh = vs + hl * a.kt * a.dp;
  const int n_chunks = ONE ? 1 : dz / DC;
  for (int ch = 0; ch < n_chunks; ++ch) {
    float qr[DC], acc[DC];
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      acc[c] = 0.0f;
      if (ONE) qr[c] = qrow[c];
    }
    float m = kNegInf, l = 0.0f;

    for (int t0 = k_begin; t0 < k_end; t0 += a.kt) {
      if (!whole) {   // the next tile of keys (uniform across the block)
        __syncthreads();
        stage_kv(a, ks, vs, t0, min(a.kt, a.skv - t0), dz);
        staged();
      }
      const int jb = max(t0, lo), je = min(t0 + a.kt, hi);
      for (int j0 = jb + lane; j0 < je; j0 += G * KB) {
        float s[KB];
#pragma unroll
        for (int i = 0; i < KB; ++i) s[i] = 0.0f;
        for (int c0 = 0; c0 < dz; c0 += DC) {
          if (!ONE) {
#pragma unroll
            for (int c = 0; c < DC; c += 4) {
              const float4 v4 =
                  *reinterpret_cast<const float4*>(qrow + c0 + c);
              qr[c] = v4.x;
              qr[c + 1] = v4.y;
              qr[c + 2] = v4.z;
              qr[c + 3] = v4.w;
            }
          }
#pragma unroll
          for (int i = 0; i < KB; ++i) {
            const int j = min(j0 + i * G, je - 1);
            const float4* kr =
                reinterpret_cast<const float4*>(kh + (j - t0) * a.dp + c0);
#pragma unroll
            for (int c = 0; c < DC / 4; ++c) {
              const float4 k4 = kr[c];
              s[i] = fmaf(qr[4 * c], k4.x, s[i]);
              s[i] = fmaf(qr[4 * c + 1], k4.y, s[i]);
              s[i] = fmaf(qr[4 * c + 2], k4.z, s[i]);
              s[i] = fmaf(qr[4 * c + 3], k4.w, s[i]);
            }
          }
        }
        // the cap's branch stays outside the loops over scores, which then
        // run straight through
        if (a.cap != 0.0f) {
#pragma unroll
          for (int i = 0; i < KB; ++i)
            s[i] = a.cap * tanhf(s[i] * a.scale / a.cap);
        } else {
#pragma unroll
          for (int i = 0; i < KB; ++i) s[i] *= a.scale;
        }
        float m_blk = kNegInf;
#pragma unroll
        for (int i = 0; i < KB; ++i) {
          s[i] = j0 + i * G < je ? s[i] : kNegInf;
          m_blk = fmaxf(m_blk, s[i]);
        }
        // a masked score (NEG_INF) or running max gives expf(NEG_INF -
        // m_safe) = 0, the reference's 0, with no branch around expf
        const float m_new = fmaxf(m, m_blk);
        const float m_safe = m_new == kNegInf ? 0.0f : m_new;
        const float corr = expf(m - m_safe);
        float p_sum = 0.0f;
#pragma unroll
        for (int i = 0; i < KB; ++i) {
          s[i] = expf(s[i] - m_safe);
          p_sum += s[i];
        }
        l = l * corr + p_sum;
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[c] *= corr;
        // a slot past the row's keys has p = 0: it reads the last live
        // key's V row, which it leaves unchanged
#pragma unroll
        for (int i = 0; i < KB; ++i) {
          const int j = min(j0 + i * G, je - 1);
          const float4* vr = reinterpret_cast<const float4*>(
              vh + (j - t0) * a.dp + ch * DC);
#pragma unroll
          for (int c = 0; c < DC / 4; ++c) {
            const float4 v4 = vr[c];
            acc[4 * c] = fmaf(s[i], v4.x, acc[4 * c]);
            acc[4 * c + 1] = fmaf(s[i], v4.y, acc[4 * c + 1]);
            acc[4 * c + 2] = fmaf(s[i], v4.z, acc[4 * c + 2]);
            acc[4 * c + 3] = fmaf(s[i], v4.w, acc[4 * c + 3]);
          }
        }
        m = m_new;
      }
    }

    // merge the row's lanes: every lane ends with the row's state
    for (int off = 1; off < G; off <<= 1) {
      const float m_o = __shfl_xor_sync(0xffffffffu, m, off);
      const float l_o = __shfl_xor_sync(0xffffffffu, l, off);
      const float m_new = fmaxf(m, m_o);
      const float m_safe = m_new == kNegInf ? 0.0f : m_new;
      const float c_s = expf(m - m_safe);
      const float c_o = expf(m_o - m_safe);
      l = l * c_s + l_o * c_o;
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float a_o = __shfl_xor_sync(0xffffffffu, acc[c], off);
        acc[c] = acc[c] * c_s + a_o * c_o;
      }
      m = m_new;
    }
    if (active) {
      const float den = fmaxf(l, 1e-37f);
      float* orow = const_cast<float*>(head_ptr(a.o, bh, a.nh)) +
                    qpos * a.o.ss;
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int dd = ch * DC + c;
        if ((c & (G - 1)) == lane && dd < a.d) orow[dd * a.o.sd] = acc[c] / den;
      }
      // every chunk of D recomputes the same m and l: the first writes
      if (a.lse != nullptr && ch == 0 && lane == 0)
        a.lse[(long long)bh * a.sq + qpos] =
            (m == kNegInf ? 0.0f : m) + logf(den);
    }
  }
}

int device_attr(cudaDeviceAttr attr) {
  int dev = 0, v = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&v, attr, dev);
  return v;
}

// The most threads a block of this instantiation may have (its registers
// decide), asked once.
template <int DC, bool ONE>
int kernel_threads() {
  static int n = 0;
  if (n == 0) {
    cudaFuncAttributes fa;
    n = cudaFuncGetAttributes(&fa, flash_attention_kernel<DC, ONE>) ==
                cudaSuccess
            ? fa.maxThreadsPerBlock
            : 32;
  }
  return n;
}

int kernel_threads_for(int d) {
  return d <= 8    ? kernel_threads<8, true>()
         : d <= 16 ? kernel_threads<16, true>()
         : d <= 32 ? kernel_threads<32, true>()
                   : kernel_threads<32, false>();
}

// The launch shape for these sizes: lanes per query row, the chunk of D
// a thread holds, query rows and heads per block, keys per staged tile,
// the staged row width, threads and shared-memory bytes.
struct Shape {
  int lanes, chunk, rq, heads, kt, dp, threads;
  size_t smem;
};

Shape shape_for(int nbh, int sq, int skv, int d) {
  static const int sms = device_attr(cudaDevAttrMultiProcessorCount);
  Shape s;
  s.chunk = d <= 8 ? 8 : d <= 16 ? 16 : 32;
  s.dp = (d + s.chunk - 1) / s.chunk * s.chunk + kPad;
  const int cap = kernel_threads_for(d);
  const int most = max_threads(s.chunk) < cap ? max_threads(s.chunk) : cap;
  // lanes per row: a power of two, each lane walks >= kLaneKeys keys
  auto lanes_for = [](int keys) {
    int g = 1;
    while (g < 32 && 2 * g * kLaneKeys <= keys) g *= 2;
    return g;
  };
  auto floats = [&]() {
    return (size_t)s.heads * (s.rq + 2 * s.kt) * s.dp;
  };
  s.lanes = lanes_for(skv);
  s.rq = sq < most / s.lanes ? sq : most / s.lanes;
  s.heads = 1;
  if (s.rq == sq) {   // several heads per block, while >= 2 blocks per SM
    const int fit = most / s.lanes / (sq > 0 ? sq : 1);
    const int keep = nbh / (2 * sms);
    s.heads = fit < keep ? fit : keep;
    if (s.heads < 1) s.heads = 1;
  }
  s.kt = skv > 0 ? skv : 1;
  const size_t budget = kSmemBudget / sizeof(float);
  if (floats() > budget) {   // stream the keys; fewer rows if need be
    s.heads = 1;
    s.kt = kTileKeys;
    while (s.kt > 8 && (size_t)4 * s.kt * s.dp > budget) s.kt /= 2;
    s.lanes = lanes_for(s.kt);
    s.rq = sq < most / s.lanes ? sq : most / s.lanes;
    while (s.rq > 1 && floats() > budget) s.rq = (s.rq + 1) / 2;
  }
  s.threads = (s.heads * s.rq * s.lanes + 31) / 32 * 32;
  s.smem = floats() * sizeof(float);
  return s;
}

// Shared memory past the static 48 KB, asked for once per instantiation.
template <int DC, bool ONE>
cudaError_t opt_in(size_t smem) {
  static bool done = false;
  if (smem <= (size_t)kStaticSmem || done) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_attention_kernel<DC, ONE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBudget);
  done = e == cudaSuccess;
  return e;
}

template <int DC, bool ONE>
cudaError_t launch(const Attn& a, const Shape& s, cudaStream_t st) {
  const cudaError_t e = opt_in<DC, ONE>(s.smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.sq + s.rq - 1) / s.rq, (a.nbh + s.heads - 1) / s.heads);
  flash_attention_kernel<DC, ONE><<<grid, s.threads, s.smem, st>>>(a);
  return cudaGetLastError();
}

template <int DC, bool ONE>
int occupancy(const Shape& s) {
  int blocks = 0;
  if (opt_in<DC, ONE>(s.smem) == cudaSuccess)
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, flash_attention_kernel<DC, ONE>, s.threads, s.smem);
  return blocks;
}

}  // namespace

// q, k, v: (nb, nh, sq | skv, d) fp32 views with element strides
// strides[0..3], [4..7], [8..11] over (B, H, S, D); out likewise with
// strides[12..15]; lse: null, or (nb * nh, sq) contiguous fp32 for each
// row's log-sum-exp.  1 <= d <= kMaxHeadDim; window <= 0: no window;
// logit_cap == 0: no cap.  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a d it does not take.
extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* out, void* lse,
                                   const long long* strides, int nb, int nh,
                                   int sq, int skv, int d, int causal,
                                   int window, float logit_cap,
                                   void* stream) {
  if (d < 1 || d > kMaxHeadDim) return (int)cudaErrorInvalidValue;
  Attn a;
  const void* ptrs[4] = {q, k, v, out};
  Operand* ops[4] = {&a.q, &a.k, &a.v, &a.o};
  for (int i = 0; i < 4; ++i) {
    *ops[i] = Operand{(const float*)ptrs[i], strides[4 * i],
                      strides[4 * i + 1], strides[4 * i + 2],
                      strides[4 * i + 3]};
  }
  a.lse = (float*)lse;
  a.nh = nh;
  a.nbh = nb * nh;
  a.sq = sq;
  a.skv = skv;
  a.d = d;
  a.scale = (float)(1.0 / sqrt((double)d));
  a.cap = logit_cap;
  a.causal = causal;
  a.window = window;
  const Shape s = shape_for(a.nbh, sq, skv, d);
  a.lanes_log2 = 31 - __builtin_clz(s.lanes);
  a.rq = s.rq;
  a.heads = s.heads;
  a.kt = s.kt;
  a.dp = s.dp;
  cudaStream_t st = (cudaStream_t)stream;
  if (d <= 8) return (int)launch<8, true>(a, s, st);
  if (d <= 16) return (int)launch<16, true>(a, s, st);
  if (d <= 32) return (int)launch<32, true>(a, s, st);
  return (int)launch<32, false>(a, s, st);
}

// The launch flash_attention_f32 makes for these sizes on the current
// card, into out[0..9]: lanes per query row, chunk of D per thread, query
// rows and heads per block, keys per staged tile, threads, shared-memory
// bytes, blocks, resident blocks per SM and resident warps per SM.
extern "C" int flash_attention_shape(int bh, int sq, int skv, int d,
                                     int* out) {
  if (d < 1 || d > kMaxHeadDim) return (int)cudaErrorInvalidValue;
  const Shape s = shape_for(bh, sq, skv, d);
  const int per_sm = d <= 8    ? occupancy<8, true>(s)
                     : d <= 16 ? occupancy<16, true>(s)
                     : d <= 32 ? occupancy<32, true>(s)
                               : occupancy<32, false>(s);
  const int blocks = ((sq + s.rq - 1) / s.rq) * ((bh + s.heads - 1) / s.heads);
  const int vals[10] = {s.lanes,     s.chunk, s.rq,        s.heads, s.kt,
                        s.threads,   (int)s.smem, blocks, per_sm,
                        per_sm * s.threads / 32};
  for (int i = 0; i < 10; ++i) out[i] = vals[i];
  return (int)cudaGetLastError();
}
