// What the training kernels share beside their GEMM mainloops: the compute
// type's conversions and rounding points, and the small deterministic
// reductions (a fixed-order sum of split partials, per-frame row sums,
// per-chunk column sums).  No float atomics anywhere, so every sum is
// taken in one order and a run repeats bit for bit.
//
// Included by train_gemm.cuh (the loss head's tile GEMM) and by the stack
// kernels, whose products run on hopper_gemm.cuh.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace tg {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16(x);
}
// round to T and back: the rounding points of the TPU kernels
template <typename T> __device__ __forceinline__ float rnd(float x) {
  return to_f(from_f<T>(x));
}

inline int ceil_div(long long a, long long b) { return (int)((a + b - 1) / b); }

// Two adjacent values of a row in the compute type, as they lie in memory
// (the first index even: 4- or 8-byte aligned), and two floats stored so.
template <typename T> struct Two;
template <> struct Two<float> {
  float2 v;
  __device__ __forceinline__ void load(const float* p) {
    v = *reinterpret_cast<const float2*>(p);
  }
  __device__ __forceinline__ float lo() const { return v.x; }
  __device__ __forceinline__ float hi() const { return v.y; }
};
template <> struct Two<bf16> {
  __nv_bfloat162 v;
  __device__ __forceinline__ void load(const bf16* p) {
    v = *reinterpret_cast<const __nv_bfloat162*>(p);
  }
  __device__ __forceinline__ float lo() const { return __low2float(v); }
  __device__ __forceinline__ float hi() const { return __high2float(v); }
};
__device__ __forceinline__ void st2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void st2(bf16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// ---------------------------------------------------------------- reductions

// out[c] = sum_s part[s * C + c], s ascending
__global__ void reduce_splits(const float* __restrict__ part, int splits,
                              long long C, float* __restrict__ out) {
  const long long c = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (c >= C) return;
  float s = 0.f;
#pragma unroll 8
  for (int i = 0; i < splits; ++i) s += part[i * C + c];
  out[c] = s;
}

inline cudaError_t launch_reduce(const float* part, int splits, long long C,
                                 float* out, cudaStream_t s) {
  reduce_splits<<<(unsigned)((C + 255) / 256), 256, 0, s>>>(part, splits, C,
                                                             out);
  return cudaGetLastError();
}

// out[(f * B + b) * C + c] = sum over the FR rows of frame f of batch row b
template <typename Tin>
__global__ void frame_sum(const Tin* __restrict__ in, int B, int T, int FR,
                          int C, float* __restrict__ out) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int fb = blockIdx.y;
  if (c >= C) return;
  const int f = fb / B, b = fb % B;
  const Tin* src = in + ((long long)b * T + (long long)f * FR) * C + c;
  float s = 0.f;
  for (int t = 0; t < FR; ++t) s += to_f(src[(long long)t * C]);
  out[(long long)fb * C + c] = s;
}

template <typename Tin>
cudaError_t launch_frame_sum(const Tin* in, int B, int T, int FR, int C,
                             float* out, cudaStream_t s) {
  dim3 grid((C + 255) / 256, (T / FR) * B);
  frame_sum<Tin><<<grid, 256, 0, s>>>(in, B, T, FR, C, out);
  return cudaGetLastError();
}

// part[s * C + c] = sum of in[r][c] over rows r of chunk s
__global__ void col_partials(const float* __restrict__ in, int rows, int C,
                             int chunk, float* __restrict__ part) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int sidx = blockIdx.y;
  if (c >= C) return;
  const int r1 = min(rows, (sidx + 1) * chunk);
  float s = 0.f;
#pragma unroll 8
  for (int r = sidx * chunk; r < r1; ++r) s += in[(long long)r * C + c];
  part[(long long)sidx * C + c] = s;
}

// one block: out[0] = sum of x[0..n) in a fixed order
__global__ void sum_all(const float* __restrict__ x, int n,
                        float* __restrict__ out) {
  __shared__ float red[256];
  float s = 0.f;
  for (int i = threadIdx.x; i < n; i += 256) s += x[i];
  red[threadIdx.x] = s;
  __syncthreads();
  for (int h = 128; h > 0; h >>= 1) {
    if (threadIdx.x < h) red[threadIdx.x] += red[threadIdx.x + h];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[0] = red[0];
}

}  // namespace tg

extern "C" const char* vqw_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
