// VQ nearest-code search: idx[n] = argmin_k ||e_k||^2 - 2 z_n . e_k
//
// Replaces vqvae_wavenet_tpu/ops/vq_pallas.py::_vq_argmin_kernel (the Pallas
// distance + argmin kernel reached from models/vq.py:67).  Like the TPU
// kernel, the [N, k] distance matrix never reaches device memory: one block
// owns TN rows of z, stages them in shared memory once, then streams the
// codebook through shared memory KC codes at a time and keeps a running
// (distance, index) minimum per row in registers; each thread computes a
// 2-row x 4-code tile of dot products per chunk.
//
// Numerics: plain f32 FMAs (no TF32, no bf16), matching the HIGHEST
// precision dot of the TPU kernel; the ||z||^2 term is row-constant and
// dropped.  Ties go to the lowest code index, as jnp.argmin does.
//
// What bounds it on the H100: at the main path's shapes (N = B*T/64 rows,
// k = 512, d = 64) it is a few MFLOP -- launch latency.  At large N it is
// bound by f32 FMA issue (no tensor cores: they would change the numerics),
// and by reading z once; the codebook is re-read per block from L2.
//
// C interface (ctypes): pointers and the stream as void*, returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TN = 64;              // rows of z per block
constexpr int KC = 32;              // codes per shared-memory chunk
constexpr int NT = 256;             // threads per block
constexpr int RPT = 2;              // rows per thread
constexpr int CPT = 4;              // codes per thread per chunk
constexpr int GROUPS = NT / (TN / RPT);  // code groups (8 x 4 codes = KC)
static_assert(GROUPS * CPT == KC, "one pass covers a chunk");

// Each thread owns rows {r, r + 32} and codes {4g .. 4g+3} of every chunk:
// a 2 x 4 register tile, 6 shared-memory loads per 8 FMAs.  The 32 threads
// of a warp share g, so the code loads are broadcasts, and their rows are
// consecutive with an odd stride, so the row loads are conflict-free.
__global__ void __launch_bounds__(NT)
vq_argmin_kernel(const float* __restrict__ z, const float* __restrict__ emb,
                 int n, int k, int d, int* __restrict__ out) {
  extern __shared__ float smem[];
  const int ds = d | 1;                       // odd row stride: no bank conflicts
  float* zs = smem;                           // [TN][ds]
  float* es = zs + TN * ds;                   // [KC][d]
  float* esq = es + KC * d;                   // [KC]
  float* redv = esq + KC;                     // [NT * RPT]
  int* redi = reinterpret_cast<int*>(redv + NT * RPT);  // [NT * RPT]

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * TN;
  for (int i = tid; i < TN * d; i += NT) {
    int r = i / d, c = i - r * d;
    int row = row0 + r;
    zs[r * ds + c] = row < n ? z[(size_t)row * d + c] : 0.f;
  }

  const int r = tid % (TN / RPT);
  const int g = tid / (TN / RPT);
  float best[RPT];
  int best_i[RPT];
#pragma unroll
  for (int q = 0; q < RPT; ++q) { best[q] = INFINITY; best_i[q] = 0; }
  for (int c0 = 0; c0 < k; c0 += KC) {
    const int nc = min(KC, k - c0);
    __syncthreads();                          // previous chunk consumed
    for (int i = tid; i < KC * d; i += NT)
      es[i] = i < nc * d ? emb[(size_t)c0 * d + i] : 0.f;
    __syncthreads();
    if (tid < KC) {
      float s = 0.f;
      for (int c = 0; c < d; ++c) s = fmaf(es[tid * d + c], es[tid * d + c], s);
      esq[tid] = s;
    }
    __syncthreads();
    float dot[RPT][CPT];
#pragma unroll
    for (int q = 0; q < RPT; ++q)
#pragma unroll
      for (int j = 0; j < CPT; ++j) dot[q][j] = 0.f;
    const float* z0 = zs + r * ds;
    const float* z1 = zs + (r + TN / RPT) * ds;
    const float* e0 = es + (g * CPT) * d;
    for (int c = 0; c < d; ++c) {
      const float za = z0[c], zb = z1[c];
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float e = e0[j * d + c];
        dot[0][j] = fmaf(za, e, dot[0][j]);
        dot[1][j] = fmaf(zb, e, dot[1][j]);
      }
    }
#pragma unroll
    for (int j = 0; j < CPT; ++j) {           // ascending: lowest index kept
      const int code = g * CPT + j;
      if (code < nc) {
#pragma unroll
        for (int q = 0; q < RPT; ++q) {
          const float dist = esq[code] - 2.f * dot[q][j];
          if (dist < best[q]) { best[q] = dist; best_i[q] = c0 + code; }
        }
      }
    }
  }
#pragma unroll
  for (int q = 0; q < RPT; ++q) {
    redv[q * NT + tid] = best[q];
    redi[q * NT + tid] = best_i[q];
  }
  __syncthreads();
  if (tid < TN) {                             // one thread per row of the tile
    const int q = tid / (TN / RPT), rr = tid % (TN / RPT);
    float v0 = INFINITY;
    int i0 = 0;
    for (int h = 0; h < GROUPS; ++h) {
      const int slot = q * NT + h * (TN / RPT) + rr;
      const float v = redv[slot];
      const int i = redi[slot];
      if (v < v0 || (v == v0 && i < i0) || h == 0) { v0 = v; i0 = i; }
    }
    const int row = row0 + tid;
    if (row < n) out[row] = i0;
  }
}

}  // namespace

extern "C" const char* vqw_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int vq_argmin(const void* z, const void* emb, int n, int k, int d,
                         void* out, void* stream) {
  const size_t smem = sizeof(float) * ((size_t)TN * (d | 1) + (size_t)KC * d
                                       + KC + NT * RPT) + sizeof(int) * NT * RPT;
  cudaError_t err = cudaFuncSetAttribute(
      vq_argmin_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (n + TN - 1) / TN;
  vq_argmin_kernel<<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(z), static_cast<const float*>(emb), n, k, d,
      static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
