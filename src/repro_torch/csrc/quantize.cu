// The shared quantiser (quantize.cuh) as an elementwise kernel, so that a
// check can hold the device function against the torch and numpy
// quantisers bit for bit.  Not on the serving path.

#include <cuda_runtime.h>

#include "quantize.cuh"

namespace {

__global__ void quantize_kernel(const float* __restrict__ x,
                                float* __restrict__ out, long long n,
                                QFmt fmt) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    out[i] = quantize_fp(x[i], fmt);
}

}  // namespace

extern "C" int quantize_f32(const void* x, void* out, long long n,
                            int exp_bits, int man_bits, void* stream) {
  const long long want = (n + 255) / 256;
  const int blocks = (int)(want < 4096 ? want : 4096);
  quantize_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(
      (const float*)x, (float*)out, n, make_qfmt(exp_bits, man_bits));
  return (int)cudaGetLastError();
}
