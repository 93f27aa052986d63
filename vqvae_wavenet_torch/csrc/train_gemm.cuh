// The shared-memory tile GEMM of the loss-head kernels (train_epilogue.cu).
// The residual stack's products run on hopper_gemm.cuh; the conversions
// and reductions both share live in train_common.cuh.
//
// One block computes a 128 x 128 tile of C[M, N] = A[M, Kred] . B[Kred, N]
// with 256 threads, 32-deep K steps, both operands staged in shared memory
// as rows of K ("k-contiguous": As[m][k], Bs[n][k]).  A problem struct P
// supplies the operands and the epilogue:
//
//   int M, N, K, kchunk;               // sizes; kchunk = Kred rows per split
//   bool a8(int m, int k, T* v);       // 8 values of A, see below
//   bool b8(int n, int k, T* v);       // 8 values of B^T
//   void epi(int m, int n, float v0, float v1, int split);  // C[m][n..n+1]
//
// With A_K (B_K) true, a8 (b8) returns 8 values along k at (m, k..k+7): the
// operand is stored with k contiguous (activations in row-major [rows, K],
// weights pre-transposed).  With it false, a8 returns 8 values along m at
// (m..m+7, k): the operand is stored with m contiguous and the fill
// transposes it (the weight-gradient products, which reduce over the rows
// of two activations).  Returning false means zeros.
//
// Split-K: blockIdx.z picks rows [z*kchunk, (z+1)*kchunk) of the reduction;
// the epilogue gets z and writes a partial, and reduce_splits sums the
// partials in a fixed order, so a run repeats bit for bit (no float
// atomics anywhere).
//
// Products: bf16 x bf16 -> f32 with mma.sync m16n8k16 (each warp a 64 x 32
// sub-tile of 4 x 4 mma tiles); f32 with FFMA only (no TF32: the TPU
// kernels ran f32 at HIGHEST precision), each thread an 8 x 8 register
// tile.  Every accumulator pair (v0, v1) holds two adjacent columns of one
// row in both layouts.
//
// Requirements the wrappers check: M and N even, every K and every row
// pitch a multiple of 8 elements, base pointers 16-byte aligned.
#pragma once

#include "train_common.cuh"

namespace tg {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 32;
constexpr int NT = 256;

template <typename T> struct Pad;
template <> struct Pad<bf16> { static constexpr int v = 8; };   // 80-byte rows
template <> struct Pad<float> { static constexpr int v = 4; };  // 144-byte rows

template <typename T> using Tile = T[BK + Pad<T>::v];

template <typename T>
__device__ __forceinline__ void ld8(const T* src, T* dst) {
  if constexpr (sizeof(T) == 2) {
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
  } else {
    reinterpret_cast<float4*>(dst)[0] = reinterpret_cast<const float4*>(src)[0];
    reinterpret_cast<float4*>(dst)[1] = reinterpret_cast<const float4*>(src)[1];
  }
}

template <typename T>
__device__ __forceinline__ void st8(T* dst, const T* src) {
  if constexpr (sizeof(T) == 2) {
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
  } else {
    reinterpret_cast<float4*>(dst)[0] = reinterpret_cast<const float4*>(src)[0];
    reinterpret_cast<float4*>(dst)[1] = reinterpret_cast<const float4*>(src)[1];
  }
}

template <typename T>
__device__ __forceinline__ void zero8(T* v) {
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = from_f<T>(0.f);
}

// ---------------------------------------------------------------- fills

// S[r][k] for r < ROWS, k < BK from 8-along-k chunks
template <typename T, int ROWS, bool IS_A, class P>
__device__ __forceinline__ void fill_k(Tile<T>* S, const P& p, int r0,
                                       int r_lim, int k0, int k_lim) {
  constexpr int CH = BK / 8;
#pragma unroll
  for (int idx = threadIdx.x; idx < ROWS * CH; idx += NT) {
    const int r = idx / CH, kc = (idx % CH) * 8;
    alignas(16) T v[8];
    bool ok = false;
    if (r0 + r < r_lim && k0 + kc < k_lim) {
      if constexpr (IS_A) ok = p.a8(r0 + r, k0 + kc, v);
      else ok = p.b8(r0 + r, k0 + kc, v);
    }
    if (!ok) zero8(v);
    st8(&S[r][kc], v);
  }
}

// S[r][k] from 8-along-r chunks (transposing fill); neighbouring threads
// take neighbouring k, so the scalar stores do not conflict
template <typename T, int ROWS, bool IS_A, class P>
__device__ __forceinline__ void fill_m(Tile<T>* S, const P& p, int r0,
                                       int r_lim, int k0, int k_lim) {
  constexpr int CH = ROWS / 8;
#pragma unroll
  for (int idx = threadIdx.x; idx < CH * BK; idx += NT) {
    const int kk = idx % BK, rc = (idx / BK) * 8;
    alignas(16) T v[8];
    bool ok = false;
    if (r0 + rc < r_lim && k0 + kk < k_lim) {
      if constexpr (IS_A) ok = p.a8(r0 + rc, k0 + kk, v);
      else ok = p.b8(r0 + rc, k0 + kk, v);
    }
    if (!ok) zero8(v);
#pragma unroll
    for (int i = 0; i < 8; ++i) S[rc + i][kk] = v[i];
  }
}

// ---------------------------------------------------------------- cores

template <typename T> struct Core;

template <> struct Core<bf16> {
  static __device__ __forceinline__ uint32_t ld32(const bf16* p) {
    return *reinterpret_cast<const uint32_t*>(p);
  }
  static __device__ __forceinline__ void step(const Tile<bf16>* As,
                                              const Tile<bf16>* Bs,
                                              float* acc) {
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    const int wm = w >> 2, wn = w & 3, g = lane >> 2, tq = lane & 3;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int r = wm * 64 + mi * 16 + g;
        a[mi][0] = ld32(&As[r][kk + tq * 2]);
        a[mi][1] = ld32(&As[r + 8][kk + tq * 2]);
        a[mi][2] = ld32(&As[r][kk + 8 + tq * 2]);
        a[mi][3] = ld32(&As[r + 8][kk + 8 + tq * 2]);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int n = wn * 32 + ni * 8 + g;
        b[ni][0] = ld32(&Bs[n][kk + tq * 2]);
        b[ni][1] = ld32(&Bs[n][kk + 8 + tq * 2]);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          float* c = acc + (mi * 4 + ni) * 4;
          asm volatile(
              "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
              "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
              : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
              : "r"(a[mi][0]), "r"(a[mi][1]), "r"(a[mi][2]), "r"(a[mi][3]),
                "r"(b[ni][0]), "r"(b[ni][1]));
        }
    }
  }
  // accumulators 2q, 2q+1 hold C[r][c], C[r][c+1]
  static __device__ __forceinline__ void pair(int q, int& r, int& c) {
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    const int wm = w >> 2, wn = w & 3, g = lane >> 2, tq = lane & 3;
    const int mi = q >> 3, ni = (q >> 1) & 3, h = q & 1;
    r = wm * 64 + mi * 16 + g + h * 8;
    c = wn * 32 + ni * 8 + tq * 2;
  }
};

template <> struct Core<float> {
  static __device__ __forceinline__ void step(const Tile<float>* As,
                                              const Tile<float>* Bs,
                                              float* acc) {
    const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 4) {
      float4 a[8], b[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        a[i] = *reinterpret_cast<const float4*>(&As[ty + 16 * i][kk]);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        b[j] = *reinterpret_cast<const float4*>(
            &Bs[2 * tx + 32 * (j >> 1) + (j & 1)][kk]);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float s = acc[i * 8 + j];
          s = fmaf(a[i].x, b[j].x, s);
          s = fmaf(a[i].y, b[j].y, s);
          s = fmaf(a[i].z, b[j].z, s);
          s = fmaf(a[i].w, b[j].w, s);
          acc[i * 8 + j] = s;
        }
    }
  }
  static __device__ __forceinline__ void pair(int q, int& r, int& c) {
    const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
    r = ty + 16 * (q >> 2);
    c = 2 * tx + 32 * (q & 3);
  }
};

// ---------------------------------------------------------------- kernel

// One block's 128 x 128 tile: rows blockIdx.y * BM, columns blockIdx.x *
// BN, split blockIdx.z of the reduction.
template <typename T, bool A_K, bool B_K, class P>
__global__ void __launch_bounds__(NT) gemm_kernel(const P p) {
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN, split = blockIdx.z;
  __shared__ __align__(16) Tile<T> As[BM];
  __shared__ __align__(16) Tile<T> Bs[BN];
  const int kb = split * p.kchunk;
  const int ke = min(p.K, kb + p.kchunk);
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int k0 = kb; k0 < ke; k0 += BK) {
    if constexpr (A_K) fill_k<T, BM, true>(As, p, m0, p.M, k0, ke);
    else fill_m<T, BM, true>(As, p, m0, p.M, k0, ke);
    if constexpr (B_K) fill_k<T, BN, false>(Bs, p, n0, p.N, k0, ke);
    else fill_m<T, BN, false>(Bs, p, n0, p.N, k0, ke);
    __syncthreads();
    Core<T>::step(As, Bs, acc);
    __syncthreads();
  }
#pragma unroll
  for (int q = 0; q < 32; ++q) {
    int r, c;
    Core<T>::pair(q, r, c);
    const int m = m0 + r, n = n0 + c;
    if (m < p.M && n < p.N) p.epi(m, n, acc[2 * q], acc[2 * q + 1], split);
  }
}

template <typename T, bool A_K, bool B_K, class P>
cudaError_t launch_gemm(const P& p, int splits, cudaStream_t s) {
  dim3 grid((p.N + BN - 1) / BN, (p.M + BM - 1) / BM, splits);
  gemm_kernel<T, A_K, B_K, P><<<grid, NT, 0, s>>>(p);
  return cudaGetLastError();
}

}  // namespace tg
