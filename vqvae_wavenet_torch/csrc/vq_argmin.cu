// VQ nearest-code search: idx[n] = argmin_k ||e_k||^2 - 2 z_n . e_k
//
// Replaces vqvae_wavenet_tpu/ops/vq_pallas.py::_vq_argmin_kernel (the Pallas
// distance + argmin kernel reached from models/vq.py:67).  Like the TPU
// kernel, the [N, k] distance matrix never reaches device memory.
//
// Numerics: plain f32 FMAs (no TF32, no bf16), matching the HIGHEST
// precision dot of the TPU kernel; the ||z||^2 term is row-constant and
// dropped.  Ties go to the lowest code index, as jnp.argmin does: every
// merge takes the smaller (distance, index) pair, an order that does not
// depend on which thread or warp meets which first.
//
// What bounds it on the H100: at the main path's shapes (N = 384 rows for
// a generate call, 832 for a training step; k = 512, d = 64) a few MFLOP,
// so latency: the codebook's staging and the launch.  At large N, f32 FMA
// issue (2 N k d operations at 67 TFLOP/s; no tensor cores: they would
// change the numerics).
//
// The design: the codebook (128 KB at k = 512, d = 64) is staged once per
// block into shared memory by TMA (boxes of 64 codes x 32 floats, 16 at
// the shipped widths, completion on an mbarrier, TMA's 128-byte swizzle:
// 16-byte chunk q of row r lies at q ^ (r % 8), so the float4 reads of 8
// different rows in a shared-memory phase hit 8 different bank groups),
// and ||e||^2 is computed there once per code, all threads at once.  A
// block is persistent: it walks groups of RB rows (grid.x = min(groups,
// SMs)), the next group's rows loaded by TMA into a second buffer while
// the current one is searched.  In a group, the 8 warps take different
// codes at the same time: lane (lr, lc) = (lane % 4, lane / 4) of warp w
// holds rows lr + 4 i (i < RB / 4) and codes lc + 8 (w + 8 j) (j < 8) of
// each pass of 512 codes, a register tile of float4 dot products along d
// (every code summed in the same order, so equal codes tie exactly); the
// (distance, index) minima are merged over lc by shuffles, then over the
// warps in shared memory.  RB = 8 for small N (N = 832 gives 104
// blocks), 32 when there are rows enough to fill the card (a larger tile:
// fewer shared-memory reads per FMA).  A codebook larger than shared
// memory is searched in chunks restaged for every group.
//
// Measured (chip_smoke.py [vq], NVIDIA H100 80GB HBM3, 700 W; device time
// by torch.profiler): N = 384 6.9 us, N = 832 7.0 us, N = 65,536 154 us
// (the f32 FMA bound: 64 us); the earlier kernel, 64 rows a block with the
// codebook streamed from L2 by every block, took 82 us at N = 384 and 832
// and 381 us at 65,536 (CUDA events around the call).
// At large N a thread issues 16 float4 shared-memory reads per 256 FMAs,
// as many cycles of the SM's shared-memory port as of FMA issue, and 8
// warps an SM (one 150 KB block) do not overlap the two.
//
// C interface (ctypes): pointers and the stream as void*, returns
// cudaGetLastError().

#include "hopper_gemm.cuh"

#include <math.h>

#include <algorithm>

namespace {

constexpr int NT = 256;               // threads: 8 warps
constexpr int WARPS = NT / 32;
constexpr int CPT = 8;                // codes per thread per pass
constexpr int PASS = WARPS * 8 * CPT; // codes per pass: 512
constexpr int EB = 64;                // codes per TMA box
constexpr int SMEM_MAX = 227 * 1024;

// f32 tiles of 128-byte rows (32 floats), TMA's 128-byte swizzle
struct Tile {
  using T = float;
  static constexpr CUtensorMapSwizzle SWIZZLE = CU_TENSOR_MAP_SWIZZLE_128B;
  static constexpr CUtensorMapDataType DTYPE = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
};

struct Args {
  CUtensorMap z;        // [n][d], boxes of RB rows x 32
  CUtensorMap e;        // [k][d], boxes of EB codes x 32
  long long* out;       // [n]
  int n, k, d, ct, kc;  // ct tiles of 32 floats along d; kc codes a chunk
};

// Shared memory past its 1024-byte alignment: the codebook chunk es
// [ct][kc][32], two row buffers zs [2][ct][rb][32], the norms esq [kc],
// the warps' minima redv, redi [WARPS][rb], 3 mbarriers.
__host__ __device__ inline long long smem_bytes(int ct, int kc, int rb) {
  return 128ll * ct * (kc + 2 * rb) + 4ll * (kc + 2 * WARPS * rb) + 24;
}

// float4 q (along d) of row r in a swizzled [ct][rows][32] tile set
__device__ __forceinline__ const float4* at(const uint8_t* base, int rows,
                                            int r, int q) {
  return reinterpret_cast<const float4*>(
      base + ((long long)(q >> 3) * rows + r) * 128 + (((q ^ r) & 7) << 4));
}

// rows [row0, row0 + rows) of a map into a [ct][rows][32] tile set, boxes
// of ``box`` rows (past the end: zeros); one thread
__device__ __forceinline__ void stage(const CUtensorMap* map, uint8_t* dst,
                                      int ct, int row0, int rows, int box,
                                      uint32_t bar) {
  hg::mbar_expect_tx(bar, (uint32_t)ct * rows * 128);
  for (int t = 0; t < ct; ++t)
    for (int r = 0; r < rows; r += box)
      hg::tma_load_4d(hg::smem_u32(dst + ((long long)t * rows + r) * 128), map,
                      bar, 32 * t, row0 + r, 0, 0);
}

__device__ __forceinline__ float norm2(const uint8_t* es, int kc, int c,
                                       int d) {
  float s = 0.f;
  for (int q = 0; q < d / 4; ++q) {
    const float4 v = *at(es, kc, c, q);
    s = fmaf(v.x, v.x, s);
    s = fmaf(v.y, v.y, s);
    s = fmaf(v.z, v.z, s);
    s = fmaf(v.w, v.w, s);
  }
  return s;
}

// (v, i) < (bv, bi) in the lexicographic order: the lower index wins a tie
__device__ __forceinline__ void take_min(float v, int i, float& bv, int& bi) {
  if (v < bv || (v == bv && i < bi)) {
    bv = v;
    bi = i;
  }
}

template <int RPT>
__global__ void __launch_bounds__(NT, 1)
vq_argmin_kernel(const __grid_constant__ Args a) {
  constexpr int RB = 4 * RPT;                 // rows per group
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hg::smem_u32(smem_raw);
  uint8_t* es = smem_raw + (((raw + 1023) & ~1023u) - raw);
  uint8_t* zs = es + 128ll * a.ct * a.kc;
  float* esq = reinterpret_cast<float*>(zs + 256ll * a.ct * RB);
  float* redv = esq + a.kc;
  int* redi = reinterpret_cast<int*>(redv + WARPS * RB);
  const uint32_t bar_e = hg::smem_u32(redi + WARPS * RB);  // the codebook
  const uint32_t bar_z = bar_e + 8;           // the row buffers: + 8 buf
  const int n = a.n, k = a.k, d = a.d, kc = a.kc;

  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int lr = lane & 3, lc = lane >> 2;
  const int groups = (n + RB - 1) / RB;
  const bool resident = kc >= k;
  if (tid == 0) {
    hg::mbar_init(bar_e, 1);
    hg::mbar_init(bar_z, 1);
    hg::mbar_init(bar_z + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  int g = blockIdx.x;
  if (tid == 0) {
    stage(&a.z, zs, a.ct, g * RB, RB, RB, bar_z);
    if (resident) stage(&a.e, es, a.ct, 0, kc, EB, bar_e);
  }
  uint32_t e_phase = 0;
  if (resident) {
    hg::mbar_wait(bar_e, 0);
    for (int c = tid; c < k; c += NT) esq[c] = norm2(es, kc, c, d);
    __syncthreads();
  }

  for (int it = 0; g < groups; ++it, g += gridDim.x) {
    const int buf = it & 1;
    const int gn = g + gridDim.x;
    // the next group's rows into the other buffer, free since the last
    // group's closing __syncthreads
    if (tid == 0 && gn < groups)
      stage(&a.z, zs + 128ll * (buf ^ 1) * a.ct * RB, a.ct, gn * RB, RB, RB,
            bar_z + 8 * (buf ^ 1));
    hg::mbar_wait(bar_z + 8 * buf, (it >> 1) & 1);
    const uint8_t* zb = zs + 128ll * buf * a.ct * RB;
    float best[RPT];
    int bi[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      best[i] = INFINITY;
      bi[i] = 0;
    }
    for (int c0 = 0; c0 < k; c0 += kc) {
      const int nc = min(kc, k - c0);
      if (!resident) {
        __syncthreads();                      // es, esq no longer read
        if (tid == 0) stage(&a.e, es, a.ct, c0, kc, EB, bar_e);
        hg::mbar_wait(bar_e, e_phase);
        e_phase ^= 1;
        for (int c = tid; c < nc; c += NT) esq[c] = norm2(es, kc, c, d);
        __syncthreads();
      }
      for (int p0 = 0; p0 < nc; p0 += PASS) {
        int code[CPT];
#pragma unroll
        for (int j = 0; j < CPT; ++j)
          code[j] = min(p0 + lc + 8 * (w + WARPS * j), kc - 1);
        float acc[RPT][CPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;
#pragma unroll 2
        for (int q = 0; q < d / 4; ++q) {
          float4 zr[RPT], ev[CPT];
#pragma unroll
          for (int i = 0; i < RPT; ++i) zr[i] = *at(zb, RB, lr + 4 * i, q);
#pragma unroll
          for (int j = 0; j < CPT; ++j) ev[j] = *at(es, kc, code[j], q);
#pragma unroll
          for (int i = 0; i < RPT; ++i)
#pragma unroll
            for (int j = 0; j < CPT; ++j) {
              float t = acc[i][j];
              t = fmaf(zr[i].x, ev[j].x, t);
              t = fmaf(zr[i].y, ev[j].y, t);
              t = fmaf(zr[i].z, ev[j].z, t);
              t = fmaf(zr[i].w, ev[j].w, t);
              acc[i][j] = t;
            }
        }
#pragma unroll
        for (int j = 0; j < CPT; ++j) {       // ascending codes: strict <
          const int c = p0 + lc + 8 * (w + WARPS * j);   // keeps the lowest
          if (c < nc) {
            const float e2 = esq[c];
#pragma unroll
            for (int i = 0; i < RPT; ++i) {
              const float dist = e2 - 2.f * acc[i][j];
              if (dist < best[i]) {
                best[i] = dist;
                bi[i] = c0 + c;
              }
            }
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {      // over lc: lane bits 2-4
        const float v = __shfl_xor_sync(0xffffffffu, best[i], o);
        const int x = __shfl_xor_sync(0xffffffffu, bi[i], o);
        take_min(v, x, best[i], bi[i]);
      }
    if (lc == 0) {
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        redv[w * RB + lr + 4 * i] = best[i];
        redi[w * RB + lr + 4 * i] = bi[i];
      }
    }
    __syncthreads();
    if (tid < RB) {
      float v = redv[tid];
      int x = redi[tid];
      for (int u = 1; u < WARPS; ++u)
        take_min(redv[u * RB + tid], redi[u * RB + tid], v, x);
      const long long row = (long long)g * RB + tid;
      if (row < n) a.out[row] = x;
    }
    __syncthreads();                          // redv and zs[buf] free
  }
}

// the kernels' shared-memory limit, set once per device; the SM count
struct DeviceInfo {
  int device = -1, sms = 0;
};

cudaError_t device_info(DeviceInfo& info) {
  static DeviceInfo cached;
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (cached.device != dev) {
    DeviceInfo fresh;
    fresh.device = dev;
    if ((e = cudaDeviceGetAttribute(&fresh.sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
        (e = cudaFuncSetAttribute(vq_argmin_kernel<2>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  SMEM_MAX)) != cudaSuccess ||
        (e = cudaFuncSetAttribute(vq_argmin_kernel<8>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  SMEM_MAX)) != cudaSuccess)
      return e;
    cached = fresh;
  }
  info = cached;
  return cudaSuccess;
}

template <int RPT>
cudaError_t launch(const float* z, const float* emb, int n, int k, int d,
                   int sms, long long* out, cudaStream_t s) {
  constexpr int RB = 4 * RPT;
  Args a;
  a.out = out;
  a.n = n; a.k = k; a.d = d;
  a.ct = (d + 31) / 32;
  // codes a chunk holds: whole boxes, as many as fit beside the rest
  const long long room = SMEM_MAX - 1024 - smem_bytes(a.ct, 0, RB);
  const long long fit = room / (128ll * a.ct * EB + 4 * EB) * EB;
  a.kc = (int)std::min<long long>((k + EB - 1) / EB * EB, fit);
  cudaError_t e;
  if ((e = hg::encode<Tile>(&a.z, z, hg::dense(d, n, 1, 1),
                            {32u, (cuuint32_t)RB, 1u, 1u})) != cudaSuccess ||
      (e = hg::encode<Tile>(&a.e, emb, hg::dense(d, k, 1, 1),
                            {32u, (cuuint32_t)EB, 1u, 1u})) != cudaSuccess)
    return e;
  const int groups = (n + RB - 1) / RB;
  vq_argmin_kernel<RPT><<<std::min(groups, sms), NT,
                          (size_t)(1024 + smem_bytes(a.ct, a.kc, RB)), s>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* vqw_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// z [n, d], emb [k, d] f32 and out [n] int64, 16-byte aligned; d a
// multiple of 4 (the wrapper pads), d <= 256.
extern "C" int vq_argmin(const void* z, const void* emb, int n, int k, int d,
                         void* out, void* stream) {
  if (d % 4 || n < 1 || k < 1) return static_cast<int>(cudaErrorInvalidValue);
  DeviceInfo info;
  cudaError_t e = device_info(info);
  if (e != cudaSuccess) return static_cast<int>(e);
  const float* zf = static_cast<const float*>(z);
  const float* ef = static_cast<const float*>(emb);
  long long* o = static_cast<long long*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 32-row groups when they alone fill the card, else 8-row groups
  e = (n + 31) / 32 >= info.sms ? launch<8>(zf, ef, n, k, d, info.sms, o, s)
                                : launch<2>(zf, ef, n, k, d, info.sms, o, s);
  return static_cast<int>(e);
}
