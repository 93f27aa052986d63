// Whole-clip autoregressive WaveNet generation in ONE persistent launch.
//
// Replaces vqvae_wavenet_tpu/ops/gen_pallas.py::_make_kernel (launched at
// gen_pallas.py:950) in all its modes: resident and hybrid with float32 or
// bfloat16 weights, and streamed with int8 weights (the int8 variant below;
// the streamed float mode is a VMEM fact that this kernel, which reads its
// weights from device memory at every size, does not need).  The TPU
// kernel ran the sample loop as a sequential grid on one core with weights
// and rings in VMEM.  Here one cooperative launch keeps one block per SM
// alive for the whole clip; the blocks loop over samples and, inside, over
// layers, and meet at grid barriers between phases that depend on each
// other (2L + 3 per sample):
//
//   SP   every block picks the previous step's bins from its logits
//        (argmax, or Gumbel-max with Philox-4x32-10 bits keyed on seed,
//        step, row, bin; the same pick in every block, block 0 writes it),
//        then the preprocess conv over the last PK mu-law inputs -> cur   barrier
//   per layer l:
//     A  gate: pre[:, j] and pre[:, D+j] from [ring taps | cur | lc_t]
//        (one fused [K*R+C] dot per column pair), + bias + gc term,
//        tanh*sigmoid -> gated[:, j]                                    barrier
//     B  [skip | res] columns from gated: skip columns accumulate into
//        the f32 skip sum (layer 0 adds the skip-start conv), res columns
//        push the layer input into the ring and write the new current    barrier
//   H1   relu(skip) and lc_t -> postprocess1 -> relu                     barrier
//   H2   postprocess2 -> f32 logits                                      barrier
//
// What bounds it on the H100: latency, not bytes or operations.  At B=1 a
// sample is ~0.1 us of arithmetic and 40.6 MB of bf16 weights (12 us at
// 3.35 TB/s if they came from HBM; they mostly stay in the 50 MB L2),
// spread over 2L+3 dependent phases; each phase costs a grid barrier (one
// arrival counter in L2: ~0.7-0.9 us from the last arrival to the first
// exit) plus the L2 round trips its data needs.  The first version of this
// kernel spent 7.0 us in each gate phase at B=1 (NVIDIA H100 80GB HBM3,
// 700 W; chip_smoke.py [gen] stamps): 1.9 staging activations element by
// element with a division each, 3.7 in dependent rounds of weight loads on
// the ~2 warps per block that had a column, 1.4 in the barrier.  This
// design takes each of those off the critical path:
//
// * Every warp works.  A phase's J output columns (A: column pairs) go to
//   blocks first (column j -> block j % G), and each column's dot is cut
//   into P slices of the input, P = 8 / (columns per block), one per warp;
//   the slices' partial sums meet in shared memory and are added in slice
//   order, so a run repeats bit for bit.  The assignment is static: each
//   kind's plan and each warp's column and slice are computed once per
//   launch into shared memory, as are the dilations, the ring offsets and
//   each step's ring slots, so the phase loop does no integer division.
// * Weights before the barrier.  Weights do not depend on the phase's
//   data, so each warp loads its next slice's weights (<= MAXV 16-byte
//   vectors per lane and row) into registers between its arrival at the
//   barrier and its wait; the loads land while it waits.
// * Inputs that do not depend on the previous phase (the ring taps, which
//   were written samples ago, lc_t, the int8 scales) are copied in the
//   same window with cp.async, which holds no register; after the barrier
//   a warp stages only the rest of its own slice, 8 values per load, one
//   round trip for all staged batch rows, and needs no block-wide sync
//   before its products.
// * The barrier is a release-add and an acquire-load poll of one counter
//   (no __threadfence), split into arrive and wait around that window, and
//   the sampling lives in the preprocess phase of every block: one barrier
//   fewer per sample than a sampling phase of its own.
// What remains per phase at B=1 is ~3.9 us: the barrier's propagation,
// the L2 round trip of the phase's inputs after it, the slices' join and
// the epilogue.  Polling the inputs themselves instead of a counter (each
// value tagged with its phase) was measured slower: every output needs
// every input, so each warp polls ~all producers, and the polls crowd L2.
//
// Data written by other blocks during the launch is read with ld.global.cg
// (L2, not L1).  Every packed width (K*R+C, D, R, S, S+C, PK) is a multiple
// of 8 (16 for int8 rows); the wrapper refuses others.
//
// int8 variant (gen_pallas.py:104-159, 584-588): the gate weights w_a and
// the skip half of [skip | res] are int8 with one scale per *input* index
// (the JAX row scales of the transposed layout), copied beside the slice's
// activations; a 16-byte load carries 16 weights, each used as
// bf16(float(q) * scale) -- the scale is a bf16 value, so the product is
// exact in f32 and rounds once, as the plain twin and the TPU kernel's bf16
// multiply do.  Activations are bf16; the res half is a separate bf16
// array, the biases bf16 (dequantized at pack time).
//
// Numerics: f32 accumulation everywhere; current is rounded to the
// activation type after each residual add, gated after the gate; the skip
// sum and the logits stay f32 (gen_pallas.py:548, 647, 679-680, 740-742).
//
// Stamped build (ST = true, chosen only by a non-null stamp buffer): thread
// 0 of every block writes globaltimer stamps of each phase's events, for a
// window of samples, from which chip_smoke.py splits a phase into staging,
// weight loads, arithmetic and barrier wait.
//
// C interface (ctypes): pointers and the stream as void*, returns the CUDA
// error code (0 = launched).

#include <cuda_bf16.h>
#include <stdint.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NT = 256;          // threads per block
constexpr int NW = NT / 32;      // warps per block
constexpr int MAXV = 4;          // prefetched 16-byte vectors per lane and row

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// loads of data that other blocks write during the launch: through L2
__device__ __forceinline__ float ld_cg(const float* p) { return __ldcg(p); }
__device__ __forceinline__ float ld_cg(const bf16* p) {
  unsigned short bits = __ldcg(reinterpret_cast<const unsigned short*>(p));
  return __bfloat162float(__ushort_as_bfloat16(bits));
}

// 8 consecutive values as float; CG: through L2 (data of this launch)
template <bool CG>
__device__ __forceinline__ void ld8f(const bf16* p, float* o) {
  const uint4 v = CG ? __ldcg(reinterpret_cast<const uint4*>(p))
                     : __ldg(reinterpret_cast<const uint4*>(p));
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    o[2 * i] = __uint_as_float(w[i] << 16);
    o[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
template <bool CG>
__device__ __forceinline__ void ld8f(const float* p, float* o) {
  const float4* q = reinterpret_cast<const float4*>(p);
  const float4 a = CG ? __ldcg(q) : __ldg(q);
  const float4 b = CG ? __ldcg(q + 1) : __ldg(q + 1);
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}
__device__ __forceinline__ void st8(float* d, const float* o) {
  reinterpret_cast<float4*>(d)[0] = make_float4(o[0], o[1], o[2], o[3]);
  reinterpret_cast<float4*>(d)[1] = make_float4(o[4], o[5], o[6], o[7]);
}

constexpr int BCH = 4;           // batch rows staged per pass

// Stage 8 values of nb batch rows (src + bb * stride) as float at dst +
// bb * xw: every row's load issued before the first store, so the rows
// share one round trip.  RELU: relu, then round to T (the skip sum).
template <bool CG, bool RELU, typename T, typename S>
__device__ __forceinline__ void rows8(const S* src, size_t stride, int nb,
                                      float* dst, int xw) {
  float v[BCH][8];
#pragma unroll
  for (int bb = 0; bb < BCH; ++bb)
    if (bb < nb) ld8f<CG>(src + bb * stride, v[bb]);
#pragma unroll
  for (int bb = 0; bb < BCH; ++bb)
    if (bb < nb) {
      if (RELU)
#pragma unroll
        for (int i = 0; i < 8; ++i) v[bb][i] = to_f(from_f<T>(fmaxf(v[bb][i], 0.f)));
      st8(dst + bb * xw, v[bb]);
    }
}

// 16 bytes global -> shared without a register (cp.async, through L2);
// cp_wait() waits for this thread's copies
__device__ __forceinline__ void cp16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// Start copying 8 values of nb batch rows (src + bb * stride): float rows
// straight to their staging place dst + bb * xw, bfloat16 rows to raw +
// bb * xw, converted by unraw8 once the copies have landed.
__device__ __forceinline__ void rows8_async(const float* src, size_t stride,
                                            int nb, float* dst, float*, int xw) {
#pragma unroll
  for (int bb = 0; bb < BCH; ++bb)
    if (bb < nb) {
      cp16(dst + bb * xw, src + bb * stride);
      cp16(dst + bb * xw + 4, src + bb * stride + 4);
    }
}
__device__ __forceinline__ void rows8_async(const bf16* src, size_t stride,
                                            int nb, float*, bf16* raw, int xw) {
#pragma unroll
  for (int bb = 0; bb < BCH; ++bb)
    if (bb < nb) cp16(raw + bb * xw, src + bb * stride);
}
__device__ __forceinline__ void unraw8(const float*, float*, int, int) {}
__device__ __forceinline__ void unraw8(const bf16* raw, float* dst, int nb, int xw) {
#pragma unroll
  for (int bb = 0; bb < BCH; ++bb)
    if (bb < nb) {
      const uint4 v = *reinterpret_cast<const uint4*>(raw + bb * xw);
      const unsigned w[4] = {v.x, v.y, v.z, v.w};
      float o[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        o[2 * i] = __uint_as_float(w[i] << 16);
        o[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
      }
      st8(dst + bb * xw, o);
    }
}

// T: the activation type; W: the type of w_a and w_sr (T, or int8_t)
template <typename T, typename W>
struct Args {
  int L, K, R, D, S, Q, C, PK, B, length, ratio, xw;
  const int* dil;          // [L]
  const int* ring_off;     // [L] first ring row of each layer
  const W *w_a, *w_sr;     // int8: w_sr is the skip half [L, S, D]
  const T *b_a, *b_sr, *w_pre, *b_pre, *w_ss, *b_ss;
  const T *w_h1, *b_h1, *w_pp2, *b_pp2;
  const float *s_a, *s_s;  // int8 only: scales [L, K*R+C], [L, D]
  const T* w_r;            // int8 only: res half [L, R, D]
  const T* lc;             // [T_cond, B, C]
  const T* gcon;           // [L, B, 2D]
  const T* g_pp1;          // [B, S]
  float* inputs;           // [length + 1, B] input sample per step
  int forced;              // inputs given (teacher forcing): never written
  T* ring;                 // [sum (K-1) d_l, B, R], zeroed
  T* cur;                  // [2, B, R]
  T* gated;                // [B, D]
  float* skip;             // [B, S]
  T* h1;                   // [B, S]
  float* logits;           // [B, Q]
  float* logits_out;       // [length, B, Q] or null
  int* bins;               // [length, B]
  unsigned long long* barrier;  // zeroed arrival counter
  int sample, sigmoid_first;
  unsigned long long seed;
  // stamped build only: globaltimer stamps [st_n samples from st_lo][2L+3
  // phases][gridDim.x blocks][NEV events], written by thread 0 of a block
  unsigned long long* stamps;
  int st_lo, st_n;
};

// stamped build: events of one phase in one block (thread 0's view, the
// first staging pass of a phase)
enum Ev { EV_START, EV_STAGED, EV_WEIGHTS, EV_DONE, EV_EXIT, NEV };

__device__ __forceinline__ unsigned long long gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t) :: "memory");
  return t;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// 16-byte vectors of weights: 4 float, 8 bfloat16 or 16 int8 values.  sc
// points at the vector's 16 scales (shared memory; int8 only).
template <typename W> struct Vec16;
template <> struct Vec16<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void unpack(const uint4& v, float out[4],
                                                const float*) {
    out[0] = __uint_as_float(v.x); out[1] = __uint_as_float(v.y);
    out[2] = __uint_as_float(v.z); out[3] = __uint_as_float(v.w);
  }
};
template <> struct Vec16<bf16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void unpack(const uint4& v, float out[8],
                                                const float*) {
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      out[2 * i] = __uint_as_float(w[i] << 16);          // low half first
      out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};
template <> struct Vec16<int8_t> {
  static constexpr int N = 16;
  __device__ __forceinline__ static void unpack(const uint4& v, float out[16],
                                                const float* sc) {
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
    const float4* s4 = reinterpret_cast<const float4*>(sc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 s = s4[i];
      const float ss[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {                    // byte j = weight 4i + j
        const int q = (int)(signed char)((w[i] >> (8 * j)) & 0xffu);
        out[4 * i + j] = __bfloat162float(__float2bfloat16_rn((float)q * ss[j]));
      }
    }
  }
};

__device__ __forceinline__ uint4 ld_weights(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// acc[i][bb] += w_i . x[bb] for one 16-byte weight vector per row i
template <typename WV, int NR>
__device__ __forceinline__ void fma_vec(const uint4 (&wv)[NR], const float* x,
                                        int xw, int nb, const float* sc,
                                        float (&acc)[NR][BCH]) {
  constexpr int V = Vec16<WV>::N;
  float wf[NR][V];
#pragma unroll
  for (int i = 0; i < NR; ++i) Vec16<WV>::unpack(wv[i], wf[i], sc);
#pragma unroll
  for (int bb = 0; bb < BCH; ++bb) {
    if (bb < nb) {
      const float4* x4 = reinterpret_cast<const float4*>(x + bb * xw);
#pragma unroll
      for (int q = 0; q < V / 4; ++q) {
        const float4 xv = x4[q];
#pragma unroll
        for (int i = 0; i < NR; ++i) {
          acc[i][bb] = fmaf(wf[i][4 * q], xv.x, acc[i][bb]);
          acc[i][bb] = fmaf(wf[i][4 * q + 1], xv.y, acc[i][bb]);
          acc[i][bb] = fmaf(wf[i][4 * q + 2], xv.z, acc[i][bb]);
          acc[i][bb] = fmaf(wf[i][4 * q + 3], xv.w, acc[i][bb]);
        }
      }
    }
  }
}

// A warp's dot of NR weight rows (elements [k0, k0 + n) of each row, of
// type WV) with its staged x [bb][xw] (slice-relative), summed over the
// warp into acc[i][bb] (every lane holds the sums).  The first MAXV
// vectors per lane come from wr (loaded before the barrier); the rest, if
// the slice is longer, are loaded here.  int8 rows take their scales from
// sc (slice-relative).
template <typename WV, int NR>
__device__ __forceinline__ void slice_dot(const WV* const (&rows)[NR], int k0,
                                          int n, const uint4 (&wr)[2][MAXV],
                                          const float* x, int xw, int nb,
                                          const float* sc, int lane,
                                          float (&acc)[NR][BCH],
                                          unsigned long long* st) {
  constexpr int V = Vec16<WV>::N;
#pragma unroll
  for (int i = 0; i < NR; ++i)
#pragma unroll
    for (int bb = 0; bb < BCH; ++bb) acc[i][bb] = 0.f;
  const int nv = n / V;
#pragma unroll
  for (int m = 0; m < MAXV; ++m) {
    const int v = lane + 32 * m;
    if (v < nv) {
      uint4 wv[NR];
#pragma unroll
      for (int i = 0; i < NR; ++i) wv[i] = wr[i][m];
      if (st && m == 0) {        // stamped build: the first vector is here
        __shared__ unsigned sink;
        *static_cast<volatile unsigned*>(&sink) = wv[0].x;
        st[EV_WEIGHTS] = gtime();
      }
      fma_vec<WV, NR>(wv, x + v * V, xw, nb, sc ? sc + v * V : nullptr, acc);
    }
  }
  for (int v = lane + 32 * MAXV; v < nv; v += 32) {
    uint4 wv[NR];
#pragma unroll
    for (int i = 0; i < NR; ++i) wv[i] = ld_weights(rows[i] + k0 + v * V);
    fma_vec<WV, NR>(wv, x + v * V, xw, nb, sc ? sc + v * V : nullptr, acc);
  }
#pragma unroll
  for (int i = 0; i < NR; ++i)
#pragma unroll
    for (int bb = 0; bb < BCH; ++bb)
      if (bb < nb) acc[i][bb] = warp_sum(acc[i][bb]);
}

template <typename WV, int NR>
__device__ __forceinline__ void prefetch(const WV* const (&rows)[NR], int k0,
                                         int n, int lane,
                                         uint4 (&wr)[2][MAXV]) {
  constexpr int V = Vec16<WV>::N;
  const int nv = n / V;
#pragma unroll
  for (int m = 0; m < MAXV; ++m) {
    const int v = lane + 32 * m;
    if (v < nv)
#pragma unroll
      for (int i = 0; i < NR; ++i) wr[i][m] = ld_weights(rows[i] + k0 + v * V);
  }
}

__device__ __forceinline__ float sigmoidf_(float x) { return 1.f / (1.f + expf(-x)); }

__device__ __forceinline__ float mu_encode(float x, float mu, float log1p_mu) {
  x = fminf(fmaxf(x, -1.f), 1.f);
  const float s = (x > 0.f) - (x < 0.f);
  return s * log1pf(mu * fabsf(x)) / log1p_mu;
}

__device__ __forceinline__ float mu_decode(int bin, float mu) {
  const float y = 2.f * (float)bin / mu - 1.f;
  const float s = (y > 0.f) - (y < 0.f);
  const float x = s * (powf(1.f + mu, fabsf(y)) - 1.f) / mu;
  return fminf(fmaxf(x, -1.f), 1.f);
}

// Gumbel noise from Philox-4x32-10 word 0 of counter (t, b, q, 0)
__device__ __forceinline__ float gumbel(unsigned long long seed, int t, int b, int q) {
  unsigned c0 = (unsigned)t, c1 = (unsigned)b, c2 = (unsigned)q, c3 = 0u;
  unsigned k0 = (unsigned)seed, k1 = (unsigned)(seed >> 32);
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const unsigned hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const unsigned hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    const unsigned n0 = hi1 ^ c1 ^ k0, n2 = hi0 ^ c3 ^ k1;
    c0 = n0; c1 = lo1; c2 = n2; c3 = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  const float u = ((float)(c0 >> 8) + 0.5f) * (1.0f / 16777216.0f);
  return -logf(-logf(u));
}

// ----------------------------------------------------------------- plan

enum Kind { KA, KB, KH1, KH2 };

// Slices per column (P) and slice length (ns, a multiple of 16) of a phase
// with J columns of n inputs over G blocks of NW warps: as many slices as
// the busiest block has warps per column, none shorter than 32 inputs.
__host__ __device__ inline void plan(int J, int n, int G, int& P, int& ns) {
  const int nj = (J + G - 1) / G;
  P = NW / nj;
  if (P < 1) P = 1;
  const int pmax = n / 32 > 0 ? n / 32 : 1;
  if (P > pmax) P = pmax;
  ns = ((n + P - 1) / P + 15) / 16 * 16;
  P = (n + ns - 1) / ns;
}

// The shared-memory row pitch of a warp's staging region: the longest
// slice of any phase, B's with room for layer 0's skip-start input (R).
__host__ __device__ inline int region_pitch(int K, int R, int D, int S, int Q,
                                            int C, int G) {
  int P, a, b, h1, h2;
  plan(D, K * R + C, G, P, a);
  plan(S + R, D, G, P, b);
  plan(S, S + C, G, P, h1);
  plan(Q, S, G, P, h2);
  int m = a;
  if (b + R > m) m = b + R;
  if (h1 > m) m = h1;
  if (h2 > m) m = h2;
  return m;
}

struct Phase {
  int kind, l, J, n, P, ns;
  const int* tab;        // the kind's plan in shared memory (KT ints)
};

// Per kind, computed once per launch: P, ns, columns per round (jr), this
// block's columns (nj), rounds; then per warp its round-0 item: valid,
// column, k0, k1.
constexpr int KT = 5 + 4 * NW;

__host__ __device__ inline void kind_dims(int kind, int K, int R, int D, int S,
                                          int Q, int C, int& J, int& n) {
  if (kind == KA) { J = D; n = K * R + C; }
  else if (kind == KB) { J = S + R; n = D; }
  else if (kind == KH1) { J = S; n = S + C; }
  else { J = Q; n = S; }
}

// ----------------------------------------------------------------- kernel

// ST: the stamped build (per-phase globaltimer stamps, see Args::stamps)
template <typename T, typename W, bool ST>
__global__ void __launch_bounds__(NT, 1) gen_kernel(Args<T, W> a) {
  constexpr bool Q8 = sizeof(W) == 1;            // int8 weights
  extern __shared__ float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = gridDim.x, blk = blockIdx.x;
  const int L = a.L, K = a.K, R = a.R, D = a.D, S = a.S, Q = a.Q, C = a.C,
            PK = a.PK, B = a.B, xw = a.xw;
  const int KR = K * R, KRC = K * R + C, SR = S + R;
  // shared memory: per warp [BCH rows][xw] staged inputs and [xw] int8
  // scales; the slices' partial sums [NW][2][BCH]; the preprocess window
  // [BCH][PK]; the decoded inputs of the step [B]; the kinds' plans
  // [4][KT]; the dilations, ring offsets and this step's ring slots
  // t % ((K-1) d_l) [L] each
  float* xr = smem + warp * (BCH + 1) * xw;      // this warp's region
  float* sc = xr + BCH * xw;
  // bfloat16 inputs copied ahead of the barrier, raw [BCH][xw] per warp
  constexpr int RAW = sizeof(T) == 2 ? NW * BCH / 2 : 0;   // x xw floats
  T* xq = reinterpret_cast<T*>(smem + NW * (BCH + 1) * xw) + warp * BCH * xw;
  float* part = smem + (NW * (BCH + 1) + RAW) * xw;
  float* win = part + NW * 2 * BCH;
  float* xin = win + BCH * PK;
  int* ktab = reinterpret_cast<int*>(xin + B);
  int* sdil = ktab + 4 * KT;
  int* soff = sdil + L;
  int* sslot = soff + L;
  if (tid < 4) {
    int J, n, P, ns;
    kind_dims(tid, K, R, D, S, Q, C, J, n);
    plan(J, n, G, P, ns);
    int* e = ktab + tid * KT;
    const int jr = NW / P, nj = blk < J ? (J - 1 - blk) / G + 1 : 0;
    e[0] = P; e[1] = ns; e[2] = jr; e[3] = nj; e[4] = (nj + jr - 1) / jr;
    for (int w = 0; w < NW; ++w) {
      const int u = w / P, k0 = (w % P) * ns, k1 = min(n, k0 + ns);
      e[5 + 4 * w] = w < jr * P && u < nj && k0 < k1;
      e[6 + 4 * w] = blk + u * G;
      e[7 + 4 * w] = k0;
      e[8 + 4 * w] = k1;
    }
  }
  for (int i = tid; i < L; i += NT) {
    sdil[i] = a.dil[i];
    soff[i] = a.ring_off[i];
  }
  __syncthreads();
  const float mu = (float)(Q - 1);
  const float log1p_mu = (float)log1p((double)mu);
  unsigned long long target = 0;
  uint4 wr[2][MAXV];     // the next phase's weights, loaded before its barrier
  float ep[4];           // this thread's epilogue operands of the next phase
  float winx = 0.f;      // this thread's preprocess input of the next step
  const T* lct = a.lc;   // lc of the current step

  auto stamp_at = [&](int t, int ph) -> unsigned long long* {
    const int ts = t - a.st_lo;
    if (!ST || tid != 0 || ts < 0 || ts >= a.st_n) return nullptr;
    unsigned long long* p =
        a.stamps + (((size_t)ts * (2 * L + 3) + ph) * G + blk) * NEV;
    p[EV_START] = gtime();
    return p;
  };
  // the grid barrier in two halves: arrive when the phase's writes are
  // done, wait when the next phase needs them; between the two a block
  // loads what the next phase needs that does not depend on them
  auto arrive = [&](unsigned long long* st) {
    target += G;
    __syncthreads();
    if (tid == 0) {
      if (st) st[EV_DONE] = gtime();
      asm volatile("red.release.gpu.global.add.u64 [%0], 1;" ::"l"(a.barrier)
                   : "memory");
    }
  };
  auto wait = [&](unsigned long long* st) {
    if (tid == 0) {
      unsigned long long v;
      const long long t0 = clock64();
      do {
        asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
                     : "=l"(v) : "l"(a.barrier) : "memory");
        if (clock64() - t0 > (1LL << 34)) __trap();
      } while (v < target);
      if (st) st[EV_EXIT] = gtime();
    }
    __syncthreads();
  };

  // phase ph of a sample after SP: 2l = layer l's A, 2l+1 its B, 2L H1,
  // 2L+1 H2
  auto describe = [&](int ph) {
    Phase p;
    p.kind = ph < 2 * L ? (ph & 1 ? KB : KA) : (ph == 2 * L ? KH1 : KH2);
    p.l = ph < 2 * L ? ph >> 1 : 0;
    kind_dims(p.kind, K, R, D, S, Q, C, p.J, p.n);
    p.tab = ktab + p.kind * KT;
    p.P = p.tab[0];
    p.ns = p.tab[1];
    return p;
  };
  auto njobs = [&](const Phase& p) { return p.tab[3]; };
  // this warp's item in round rd: column u of the block, slice s
  auto item = [&](const Phase& p, int rd, int& job, int& k0, int& k1) {
    if (rd == 0) {
      const int* e = p.tab + 5 + 4 * warp;
      job = e[1];
      k0 = e[2];
      k1 = e[3];
      return e[0] != 0;
    }
    const int jr = p.tab[2];                     // columns per round
    if (warp >= jr * p.P) return false;
    const int u = rd * jr + warp / p.P, s = warp % p.P;
    if (u >= njobs(p)) return false;
    job = blk + u * G;
    k0 = s * p.ns;
    k1 = min(p.n, k0 + p.ns);
    return k0 < k1;
  };
  // int8 rows: the gate's, and a skip column's
  auto is_q8 = [&](const Phase& p, int job) {
    return Q8 && (p.kind == KA || (p.kind == KB && job < S));
  };
  // weight row i of type W: the gate pair j, D + j (A), a skip column
  // (int8 B)
  auto row_w = [&](const Phase& p, int job, int i) -> const W* {
    if (p.kind == KA)
      return a.w_a + ((size_t)p.l * 2 * D + job + (size_t)i * D) * KRC;
    return a.w_sr + ((size_t)p.l * S + job) * D;
  };
  // weight row of type T: B's columns (int8: its res half), H1, H2
  auto row_t = [&](const Phase& p, int job) -> const T* {
    if (p.kind == KB)
      return Q8 ? a.w_r + ((size_t)p.l * R + job - S) * D
                : reinterpret_cast<const T*>(a.w_sr) + ((size_t)p.l * SR + job) * D;
    if (p.kind == KH1) return a.w_h1 + (size_t)job * (S + C);
    return a.w_pp2 + (size_t)job * S;
  };
  auto do_prefetch = [&](const Phase& p, int rd) {
    int job, k0, k1;
    if (!item(p, rd, job, k0, k1)) return;
    if (p.kind == KA)
      prefetch<W, 2>({row_w(p, job, 0), row_w(p, job, 1)}, k0, k1 - k0, lane, wr);
    else if (is_q8(p, job))
      prefetch<W, 1>({row_w(p, job, 0)}, k0, k1 - k0, lane, wr);
    else
      prefetch<T, 1>({row_t(p, job)}, k0, k1 - k0, lane, wr);
  };

  // Stage x[bb][k - k0] for k in [k0, k1) and the batch rows b0 + bb < B:
  // pre = the inputs that do not depend on the previous phase (ring taps,
  // lc, int8 scales), post = the rest.
  auto stage = [&](const Phase& p, int t, int job, int k0, int k1,
                   int b0, int nb, bool pre, bool post) {
    const int l = p.l;
    const T* lc_t = lct + (size_t)b0 * C;
    const int nc = (k1 - k0) / 8;
    if (p.kind == KA) {
      const int d = sdil[l], size = (K - 1) * d, off = soff[l], now = sslot[l];
      const T* cur_in = a.cur + ((size_t)(l & 1) * B + b0) * R;
      for (int c = lane; c < nc; c += 32) {
        const int k = k0 + 8 * c;
        float* dst = xr + k - k0;
        if (k < KR - R) {                        // tap block jb: x[t - (K-1-jb) d]
          if (!pre) continue;
          const int jb = k / R, r = k - jb * R, j = K - 1 - jb;
          const int slot = now - j * d < 0 ? now - j * d + size : now - j * d;
          rows8_async(a.ring + ((size_t)(off + slot) * B + b0) * R + r, R, nb,
                      dst, xq + k - k0, xw);
        } else if (k < KR) {
          if (post) rows8<true, false, T>(cur_in + k - (KR - R), R, nb, dst, xw);
        } else if (pre) {
          rows8_async(lc_t + k - KR, C, nb, dst, xq + k - k0, xw);
        }
      }
      if (Q8 && pre)
        for (int q = lane; q < (k1 - k0) / 4; q += 32)
          cp16(sc + 4 * q, a.s_a + (size_t)l * KRC + k0 + 4 * q);
    } else if (p.kind == KB) {
      if (post) {
        for (int c = lane; c < nc; c += 32)
          rows8<true, false, T>(a.gated + (size_t)b0 * D + k0 + 8 * c, D, nb,
                                xr + 8 * c, xw);
        // layer 0's skip columns also read cur (the skip-start conv),
        // staged after the slice, at column ns
        if (l == 0 && job < S && k0 == 0)
          for (int c = lane; c < R / 8; c += 32)
            rows8<true, false, T>(a.cur + (size_t)b0 * R + 8 * c, R, nb,
                                  xr + p.ns + 8 * c, xw);
      }
      if (Q8 && pre && job < S)
        for (int q = lane; q < (k1 - k0) / 4; q += 32)
          cp16(sc + 4 * q, a.s_s + (size_t)l * D + k0 + 4 * q);
    } else if (p.kind == KH1) {
      for (int c = lane; c < nc; c += 32) {
        const int k = k0 + 8 * c;
        if (k < S) {
          if (post)
            rows8<true, true, T>(a.skip + (size_t)b0 * S + k, S, nb, xr + 8 * c, xw);
        } else if (pre) {
          rows8_async(lc_t + k - S, C, nb, xr + 8 * c, xq + 8 * c, xw);
        }
      }
    } else {
      if (post)
        for (int c = lane; c < nc; c += 32)
          rows8<true, false, T>(a.h1 + (size_t)b0 * S + k0 + 8 * c, S, nb,
                                xr + 8 * c, xw);
    }
  };

  // after the barrier: wait for this lane's copies of the pre inputs and
  // convert the bfloat16 ones
  auto finish_pre = [&](const Phase& p, int k0, int k1, int nb) {
    cp_wait();
    if (sizeof(T) != 2) return;
    const int nc = (k1 - k0) / 8;
    for (int c = lane; c < nc; c += 32) {
      const int k = k0 + 8 * c;
      const bool pre = p.kind == KA ? (k < KR - R || k >= KR)
                                    : p.kind == KH1 && k >= S;
      if (pre) unraw8(xq + k - k0, xr + k - k0, nb, xw);
    }
  };

  // the epilogue's operands of column job, batch row b: biases, condition
  // terms, and (B) the skip sum or the layer input it adds to
  auto ep_load = [&](const Phase& p, int job, int b, float (&e)[4]) {
    const int l = p.l;
    if (p.kind == KA) {
      const T* gc = a.gcon + ((size_t)l * B + b) * 2 * D;
      e[0] = to_f(a.b_a[(size_t)l * 2 * D + job]);
      e[1] = to_f(gc[job]);
      e[2] = to_f(a.b_a[(size_t)l * 2 * D + D + job]);
      e[3] = to_f(gc[D + job]);
    } else if (p.kind == KB) {
      e[0] = to_f(a.b_sr[(size_t)l * SR + job]);
      if (job < S)
        e[1] = l == 0 ? to_f(a.b_ss[job]) : ld_cg(&a.skip[(size_t)b * S + job]);
      else
        e[1] = ld_cg(&a.cur[((size_t)(l & 1) * B + b) * R + job - S]);
    } else if (p.kind == KH1) {
      e[0] = to_f(a.b_h1[job]);
      e[1] = to_f(a.g_pp1[(size_t)b * S + job]);
    } else {
      e[0] = to_f(a.b_pp2[job]);
    }
  };
  // the column's epilogue for batch row b on its sums v0 (and v1, the
  // gate pair's second row) and its operands e
  auto epilogue = [&](const Phase& p, int t, int job, int b,
                      float v0, float v1, const float (&e)[4]) {
    const int l = p.l;
    if (p.kind == KA) {
      const float p0 = v0 + e[0] + e[1];
      const float p1 = v1 + e[2] + e[3];
      const float g = a.sigmoid_first ? sigmoidf_(p0) * tanhf(p1)
                                      : tanhf(p0) * sigmoidf_(p1);
      a.gated[(size_t)b * D + job] = from_f<T>(g);
    } else if (p.kind == KB) {
      const float out = v0 + e[0];
      if (job < S) {
        a.skip[(size_t)b * S + job] = e[1] + out;
      } else {
        const int r = job - S;
        T* cur_out = a.cur + (size_t)((l + 1) & 1) * B * R;
        a.ring[((size_t)(soff[l] + sslot[l]) * B + b) * R + r] = from_f<T>(e[1]);
        cur_out[(size_t)b * R + r] = from_f<T>(e[1] + out);
      }
    } else if (p.kind == KH1) {
      a.h1[(size_t)b * S + job] = from_f<T>(fmaxf(v0 + e[0] + e[1], 0.f));
    } else {
      const float v = v0 + e[0];
      a.logits[(size_t)b * Q + job] = v;
      if (a.logits_out) a.logits_out[((size_t)t * B + b) * Q + job] = v;
    }
  };

  // One dot phase: every round of items, every pass of BCH batch rows.
  // Round 0's weights are in wr, its pass 0's pre inputs staged and its
  // epilogue operands in ep.
  auto run = [&](const Phase& p, int t, unsigned long long* st) {
    const int jr = p.tab[2];
    const int rounds = p.tab[4];
    for (int rd = 0; rd < rounds; ++rd) {
      int job = 0, k0 = 0, k1 = 0;
      const bool mine = item(p, rd, job, k0, k1);
      if (rd > 0) do_prefetch(p, rd);
      for (int b0 = 0; b0 < B; b0 += BCH) {
        const int nb = min(BCH, B - b0);
        const bool first = rd == 0 && b0 == 0;
        if (mine) {
          stage(p, t, job, k0, k1, b0, nb, !first, true);
          finish_pre(p, k0, k1, nb);
          __syncwarp();
        }
        if (st && first) st[EV_STAGED] = gtime();
        unsigned long long* sw = st && first ? st : nullptr;
        if (mine) {
          float acc[2][BCH];
          if (p.kind == KA) {
            slice_dot<W, 2>({row_w(p, job, 0), row_w(p, job, 1)}, k0,
                            k1 - k0, wr, xr, xw, nb, Q8 ? sc : nullptr, lane,
                            acc, sw);
          } else {
            float a1[1][BCH];
            if (is_q8(p, job))
              slice_dot<W, 1>({row_w(p, job, 0)}, k0, k1 - k0, wr, xr, xw,
                              nb, sc, lane, a1, sw);
            else
              slice_dot<T, 1>({row_t(p, job)}, k0, k1 - k0, wr, xr, xw,
                              nb, nullptr, lane, a1, sw);
#pragma unroll
            for (int bb = 0; bb < BCH; ++bb) acc[0][bb] = a1[0][bb];
            if (p.kind == KB) {
              if (p.l == 0 && job < S && k0 == 0) {
                // the skip-start conv, on cur staged at column ns
                constexpr int VT = Vec16<T>::N;
                const T* wss = a.w_ss + (size_t)job * R;
#pragma unroll
                for (int bb = 0; bb < BCH; ++bb) a1[0][bb] = 0.f;
                for (int v = lane; v < R / VT; v += 32) {
                  const uint4 wv[1] = {ld_weights(wss + v * VT)};
                  fma_vec<T, 1>(wv, xr + p.ns + v * VT, xw, nb, nullptr, a1);
                }
#pragma unroll
                for (int bb = 0; bb < BCH; ++bb)
                  if (bb < nb) acc[0][bb] += warp_sum(a1[0][bb]);
              }
            }
          }
          if (lane == 0) {
#pragma unroll
            for (int bb = 0; bb < BCH; ++bb) {
              part[(warp * 2) * BCH + bb] = acc[0][bb];
              if (p.kind == KA) part[(warp * 2 + 1) * BCH + bb] = acc[1][bb];
            }
          }
        }
        __syncthreads();
        // the slices of a column meet in slice order
        if (tid < jr * BCH) {
          const int ul = tid / BCH, bb = tid % BCH, u = rd * jr + ul;
          if (u < njobs(p) && bb < nb) {
            float v0 = 0.f, v1 = 0.f;
            for (int s = 0; s < p.P; ++s) {
              v0 += part[((ul * p.P + s) * 2) * BCH + bb];
              if (p.kind == KA) v1 += part[((ul * p.P + s) * 2 + 1) * BCH + bb];
            }
            const int job_u = blk + u * G;
            if (!first) ep_load(p, job_u, b0 + bb, ep);
            epilogue(p, t, job_u, b0 + bb, v0, v1, ep);
          }
        }
        __syncthreads();
      }
    }
  };

  // between arrive and wait: the next phase's weights, pre inputs and
  // epilogue operands
  auto ahead = [&](const Phase& p, int t) {
    do_prefetch(p, 0);
    int job, k0, k1;
    const int nb = min(BCH, B);
    if (item(p, 0, job, k0, k1))
      stage(p, t, job, k0, k1, 0, nb, true, false);
    const int jr = p.tab[2];
    if (tid < jr * BCH) {
      const int u = tid / BCH, bb = tid % BCH;
      if (u < njobs(p) && bb < nb) ep_load(p, blk + u * G, bb, ep);
    }
  };

  // step t's bins from its logits, in every block (the same values
  // everywhere; block 0 writes them): xin[b] = the decoded sample
  auto select = [&](int t) {
    for (int b = warp; b < B; b += NW) {
      float best = -INFINITY;
      int bi = Q;
      for (int q0 = 0; q0 < Q; q0 += 32 * 8) {
        float v[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int q = q0 + lane + 32 * i;
          v[i] = q < Q ? ld_cg(&a.logits[(size_t)b * Q + q]) : -INFINITY;
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int q = q0 + lane + 32 * i;
          if (q < Q) {
            const float x = a.sample ? v[i] + gumbel(a.seed, t, b, q) : v[i];
            if (x > best || (x == best && q < bi)) { best = x; bi = q; }
          }
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, best, o);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
        if (ov > best || (ov == best && oi < bi)) { best = ov; bi = oi; }
      }
      if (lane == 0) {
        if (bi >= Q) bi = 0;                     // all logits NaN
        xin[b] = mu_decode(bi, mu);
        if (blk == 0) {
          a.bins[(size_t)t * B + b] = bi;
          if (!a.forced) a.inputs[(size_t)(t + 1) * B + b] = xin[b];
        }
      }
    }
  };
  // the preprocess window value of thread i (pass 0) at step t, but the
  // newest sample of a free-running step (xin, from select)
  auto window_x = [&](int t, int i) {
    const int bb = i / PK, s = t - (PK - 1) + (i - bb * PK);
    if (s < 0 || bb >= min(BCH, B)) return 0.f;
    if (s == t && t > 0 && !a.forced) return 0.f;
    return ld_cg(&a.inputs[(size_t)s * B + bb]);
  };
  // between arrive and wait before step t: the preprocess conv's weights
  // (warp's column blk + warp * G) and bias, and the window's known inputs
  auto ahead_sp = [&](int t) {
    const int r = blk + warp * G;
    constexpr int VT = Vec16<T>::N;
    if (r < R) {
      if (lane < PK / VT) wr[0][0] = ld_weights(a.w_pre + (size_t)r * PK + lane * VT);
      ep[0] = to_f(a.b_pre[r]);
    }
    if (tid < BCH * PK) winx = window_x(t, tid);
  };

  ahead_sp(0);
  for (int t = 0; t < a.length; ++t) {
    lct = a.lc + (size_t)(t / a.ratio) * B * C;
    for (int l = tid; l < L; l += NT) sslot[l] = t % ((K - 1) * sdil[l]);
    // ---- SP: the bins of step t-1, then the preprocess conv -> cur[0]
    unsigned long long* st = stamp_at(t, 0);
    if (t > 0) select(t - 1);
    __syncthreads();
    constexpr int VT = Vec16<T>::N;
    for (int b0 = 0; b0 < B; b0 += BCH) {
      const int nb = min(BCH, B - b0);
      for (int i = tid; i < nb * PK; i += NT) {
        const int bb = i / PK, pp = i - bb * PK;
        const int s = t - (PK - 1) + pp, b = b0 + bb;
        float u = 0.f;
        if (s >= 0) {
          float x;
          if (s == t && t > 0 && !a.forced) x = xin[b];
          else if (b0 == 0 && i == tid) x = winx;
          else x = ld_cg(&a.inputs[(size_t)s * B + b]);
          u = mu_encode(x, mu, log1p_mu);
        }
        win[bb * PK + pp] = to_f(from_f<T>(u));
      }
      __syncthreads();
      if (st && b0 == 0) st[EV_STAGED] = gtime();
      for (int r = blk + warp * G; r < R; r += G * NW) {
        const bool first = b0 == 0 && r == blk + warp * G;
        float acc[1][BCH];
#pragma unroll
        for (int bb = 0; bb < BCH; ++bb) acc[0][bb] = 0.f;
        for (int v = lane; v < PK / VT; v += 32) {
          const uint4 wv[1] = {first && v == lane
                                   ? wr[0][0]
                                   : ld_weights(a.w_pre + (size_t)r * PK + v * VT)};
          fma_vec<T, 1>(wv, win + v * VT, PK, nb, nullptr, acc);
        }
        const float bias = first ? ep[0] : to_f(a.b_pre[r]);
#pragma unroll
        for (int bb = 0; bb < BCH; ++bb)
          if (bb < nb) {
            const float v = warp_sum(acc[0][bb]);
            if (lane == 0) a.cur[(size_t)(b0 + bb) * R + r] = from_f<T>(v + bias);
          }
      }
      __syncthreads();
    }
    arrive(st);
    ahead(describe(0), t);
    wait(st);

    // ---- layer l's A and B, then H1 and H2: phase ph + 1 of the sample
    for (int ph = 0; ph < 2 * L + 2; ++ph) {
      st = stamp_at(t, ph + 1);
      run(describe(ph), t, st);
      arrive(st);
      if (ph + 1 < 2 * L + 2) ahead(describe(ph + 1), t);
      else if (t + 1 < a.length) ahead_sp(t + 1);
      wait(st);
    }
  }
  select(a.length - 1);                          // the last step's bins
}

template <typename T, typename W, bool ST>
int launch(Args<T, W> a, cudaStream_t stream) {
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (!coop) return (int)cudaErrorNotSupported;
  a.xw = region_pitch(a.K, a.R, a.D, a.S, a.Q, a.C, sms);
  const int raw = sizeof(T) == 2 ? NW * BCH / 2 : 0;
  const size_t smem = sizeof(float) * ((size_t)(NW * (BCH + 1) + raw) * a.xw +
                                       NW * 2 * BCH + BCH * a.PK + a.B +
                                       4 * KT + 3 * a.L);
  e = cudaFuncSetAttribute(gen_kernel<T, W, ST>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gen_kernel<T, W, ST>, NT, smem);
  if (e != cudaSuccess) return (int)e;
  // one block per SM: the launch needs every block resident
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel((const void*)gen_kernel<T, W, ST>, dim3(sms), dim3(NT),
                                  args, smem, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename T, typename W>
int run(int L, int K, int R, int D, int S, int Q, int C, int PK, int B,
        int length, int ratio, const void* dil, const void* ring_off,
        const void* const* w, const void* lc, const void* gcon,
        const void* g_pp1, void* inputs, int forced, void* ring, void* cur,
        void* gated, void* skip, void* h1, void* logits, void* logits_out,
        void* bins, void* barrier, int sample, int sigmoid_first,
        unsigned long long seed, void* stamps, int st_lo, int st_n,
        void* stream) {
  Args<T, W> a;
  a.L = L; a.K = K; a.R = R; a.D = D; a.S = S; a.Q = Q; a.C = C; a.PK = PK;
  a.B = B; a.length = length; a.ratio = ratio; a.xw = 0;
  a.dil = static_cast<const int*>(dil);
  a.ring_off = static_cast<const int*>(ring_off);
  const T* const* wt = reinterpret_cast<const T* const*>(w);
  a.w_a = static_cast<const W*>(w[0]); a.b_a = wt[1];
  a.w_sr = static_cast<const W*>(w[2]); a.b_sr = wt[3];
  a.w_pre = wt[4]; a.b_pre = wt[5]; a.w_ss = wt[6]; a.b_ss = wt[7];
  a.w_h1 = wt[8]; a.b_h1 = wt[9]; a.w_pp2 = wt[10]; a.b_pp2 = wt[11];
  a.s_a = static_cast<const float*>(w[12]);
  a.s_s = static_cast<const float*>(w[13]);
  a.w_r = wt[14];
  a.lc = static_cast<const T*>(lc);
  a.gcon = static_cast<const T*>(gcon);
  a.g_pp1 = static_cast<const T*>(g_pp1);
  a.inputs = static_cast<float*>(inputs);
  a.forced = forced;
  a.ring = static_cast<T*>(ring);
  a.cur = static_cast<T*>(cur);
  a.gated = static_cast<T*>(gated);
  a.skip = static_cast<float*>(skip);
  a.h1 = static_cast<T*>(h1);
  a.logits = static_cast<float*>(logits);
  a.logits_out = static_cast<float*>(logits_out);
  a.bins = static_cast<int*>(bins);
  a.barrier = static_cast<unsigned long long*>(barrier);
  a.sample = sample;
  a.sigmoid_first = sigmoid_first;
  a.seed = seed;
  a.stamps = static_cast<unsigned long long*>(stamps);
  a.st_lo = st_lo;
  a.st_n = st_n;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return stamps ? launch<T, W, true>(a, s) : launch<T, W, false>(a, s);
}

}  // namespace

extern "C" const char* vqw_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 = float32, 1 = bfloat16, 2 = int8 weights with bfloat16
// activations.  The weight pointers are in the order w_a b_a w_sr b_sr
// w_pre b_pre w_ss b_ss w_h1 b_h1 w_pp2 b_pp2, then (int8 only, else null)
// s_a s_s w_r.  stamps: null, or the stamped build's buffer of
// st_n * (2L+3) * gridDim.x * 5 u64, zeroed (gen_wavenet_grid gives
// gridDim.x), for samples st_lo .. st_lo + st_n - 1.
extern "C" int gen_wavenet(
    int dtype, int L, int K, int R, int D, int S, int Q, int C, int PK, int B,
    int length, int ratio, const void* dil, const void* ring_off,
    const void* w_a, const void* b_a, const void* w_sr, const void* b_sr,
    const void* w_pre, const void* b_pre, const void* w_ss, const void* b_ss,
    const void* w_h1, const void* b_h1, const void* w_pp2, const void* b_pp2,
    const void* s_a, const void* s_s, const void* w_r, const void* lc, const void* gcon, const void* g_pp1, void* inputs,
    int forced, void* ring, void* cur, void* gated, void* skip, void* h1,
    void* logits, void* logits_out, void* bins, void* barrier, int sample,
    int sigmoid_first, unsigned long long seed, void* stamps, int st_lo,
    int st_n, void* stream) {
  const void* w[15] = {w_a, b_a, w_sr, b_sr, w_pre, b_pre, w_ss, b_ss,
                       w_h1, b_h1, w_pp2, b_pp2, s_a, s_s, w_r};
  if (dtype == 0)
    return run<float, float>(L, K, R, D, S, Q, C, PK, B, length, ratio, dil, ring_off,
                      w, lc, gcon, g_pp1, inputs, forced, ring, cur, gated,
                      skip, h1, logits, logits_out, bins, barrier, sample,
                      sigmoid_first, seed, stamps, st_lo, st_n, stream);
  if (dtype == 1)
    return run<bf16, bf16>(
        L, K, R, D, S, Q, C, PK, B, length, ratio, dil, ring_off, w, lc, gcon,
        g_pp1, inputs, forced, ring, cur, gated, skip, h1, logits, logits_out,
        bins, barrier, sample, sigmoid_first, seed, stamps, st_lo, st_n,
        stream);
  if (dtype == 2)
    return run<bf16, int8_t>(
        L, K, R, D, S, Q, C, PK, B, length, ratio, dil, ring_off, w, lc, gcon,
        g_pp1, inputs, forced, ring, cur, gated, skip, h1, logits, logits_out,
        bins, barrier, sample, sigmoid_first, seed, stamps, st_lo, st_n,
        stream);
  return (int)cudaErrorInvalidValue;
}

// The grid the launch uses (one block per SM): sizes the stamp buffer.
extern "C" int gen_wavenet_grid() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
      cudaSuccess)
    return -1;
  return sms;
}
