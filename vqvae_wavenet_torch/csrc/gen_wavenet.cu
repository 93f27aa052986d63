// Whole-clip autoregressive WaveNet generation in ONE persistent launch.
//
// Replaces vqvae_wavenet_tpu/ops/gen_pallas.py::_make_kernel (launched at
// gen_pallas.py:950) in all its modes: resident and hybrid with float32 or
// bfloat16 weights, and streamed with int8 weights (the int8 variant below;
// the streamed float mode is a VMEM fact that this kernel, which reads its
// weights from device memory at every size, does not need).  The TPU
// kernel ran the sample loop as a sequential grid on one core with weights
// and rings in VMEM.  Here one cooperative launch keeps gridDim.x co-resident blocks
// (one per SM by default) alive for the whole clip; the blocks loop over
// samples and, inside, over layers, and meet at grid barriers between
// phases that depend on each other:
//
//   P0   preprocess conv over the last PK mu-law inputs -> current   barrier
//   per layer l:
//     A  gate: the warp owning gate column j computes pre[:, j] and
//        pre[:, D+j] from [ring taps | current | lc_t] (one fused
//        [K*R+C] dot per column), adds bias + gc term, applies
//        tanh*sigmoid and writes gated[:, j]                          barrier
//     B  the warp owning column c of [skip | res] computes gated . w[c];
//        skip columns accumulate into the f32 skip sum (layer 0 adds the
//        skip-start conv), res columns push the layer input into the ring
//        and write the new current (double-buffered)                  barrier
//   H1   relu(skip) and lc_t -> postprocess1 -> relu                  barrier
//   H2   postprocess2 -> f32 logits                                   barrier
//   S    block 0 picks the bin (argmax, or Gumbel-max with Philox-4x32-10
//        bits keyed on seed, step, row, bin), writes it, and feeds the
//        mu-law decoded sample to the next step's input                barrier
//
// 2L + 4 grid barriers per sample.  Work is spread over warps "blocks
// first" (job = block + warp * gridDim.x), so every SM streams its share
// of the weights.  Each block stages the activations it needs (<= 8 batch
// rows at a time) as f32 in shared memory; weights are read straight from
// device memory, 16 bytes per lane, in the [out_column][in] layout the
// wrapper packs, so a warp's loads are contiguous.  Every packed width
// (K*R+C, D, R, S, S+C, PK) is a multiple of 8; the wrapper refuses others.
//
// int8 variant (gen_pallas.py:104-159, 584-588): the gate weights w_a and
// the skip half of [skip | res] are int8 with one scale per *input* index
// (the JAX row scales of the transposed layout), staged per layer into a
// shared-memory row beside the activations; a 16-byte load carries 16
// weights, each used as bf16(float(q) * scale) -- the scale is a bf16
// value, so the product is exact in f32 and rounds once, as the plain twin
// and the TPU kernel's bf16 multiply do.  Activations are bf16; the res half
// is a separate bf16 array, the biases bf16 (dequantized at pack time).
//
// Weights (39 MB bf16 / 79 MB f32 for the shipped 30-layer model) and the
// rings live in device memory: they do not fit in 227 KB of shared memory.
// What bounds it on the H100 at small batch: grid-barrier latency (62+
// per sample) and the per-sample weight stream from L2/HBM.  Data written
// by other blocks during the launch is read with ld.global.cg (L2, not L1).
//
// Numerics: f32 accumulation everywhere; current is rounded to the
// activation type after each residual add, gated after the gate; the skip
// sum and the logits stay f32 (gen_pallas.py:548, 647, 679-680, 740-742).
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
constexpr int BCH = 8;           // batch rows staged per pass

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// loads of data that other blocks write during the launch: through L2
__device__ __forceinline__ float ld_cg(const float* p) { return __ldcg(p); }
__device__ __forceinline__ float ld_cg(const __nv_bfloat16* p) {
  unsigned short bits = __ldcg(reinterpret_cast<const unsigned short*>(p));
  return __bfloat162float(__ushort_as_bfloat16(bits));
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
};

// Monotonic-counter grid barrier; the cooperative launch guarantees that
// every block is resident, so spinning cannot deadlock.  A wait of ~2^34
// cycles (seconds, where a legitimate wait is microseconds) means a bug:
// trap, so the launch fails instead of hanging the card.
__device__ __forceinline__ void grid_sync(unsigned long long* ctr,
                                          unsigned long long& target) {
  target += gridDim.x;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(ctr, 1ULL);
    volatile unsigned long long* v = ctr;
    const long long t0 = clock64();
    while (*v < target) {
      if (clock64() - t0 > (1LL << 34)) __trap();
    }
    __threadfence();
  }
  __syncthreads();
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
template <> struct Vec16<__nv_bfloat16> {
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

template <typename W, int NR>
__device__ __forceinline__ void fma_vec(const float wf[NR][Vec16<W>::N],
                                        const float* xs, int xw, int k0,
                                        int nb, float acc[NR][BCH]) {
  constexpr int V = Vec16<W>::N;
#pragma unroll
  for (int bb = 0; bb < BCH; ++bb) {
    if (bb < nb) {
      const float4* x4 = reinterpret_cast<const float4*>(xs + bb * xw + k0);
#pragma unroll
      for (int q = 0; q < V / 4; ++q) {
        const float4 x = x4[q];
#pragma unroll
        for (int i = 0; i < NR; ++i) {
          acc[i][bb] = fmaf(wf[i][4 * q], x.x, acc[i][bb]);
          acc[i][bb] = fmaf(wf[i][4 * q + 1], x.y, acc[i][bb]);
          acc[i][bb] = fmaf(wf[i][4 * q + 2], x.z, acc[i][bb]);
          acc[i][bb] = fmaf(wf[i][4 * q + 3], x.w, acc[i][bb]);
        }
      }
    }
  }
}

// acc[i][bb] = sum_k w_i[k] * xs[bb][off + k] for NR weight rows w_i and
// bb < nb, summed over the warp, with 16-byte weight loads and float4
// shared-memory loads.  n, off and xw are multiples of 8 (n of 16 for int8)
// and every weight row starts 16-byte aligned (the wrapper checks the
// packed widths).  int8 rows take their per-index scales from sc[k].
template <typename W, int NR>
__device__ __forceinline__ void warp_dots(const W* const* w, const float* xs,
                                          int xw, int off, int n, int nb,
                                          int lane, float acc[NR][BCH],
                                          const float* sc) {
  constexpr int V = Vec16<W>::N;
#pragma unroll
  for (int i = 0; i < NR; ++i)
#pragma unroll
    for (int bb = 0; bb < BCH; ++bb) acc[i][bb] = 0.f;
  const int nv = n / V;
  for (int v = lane; v < nv; v += 32) {
    float wf[NR][V];
#pragma unroll
    for (int i = 0; i < NR; ++i)
      Vec16<W>::unpack(ld_weights(w[i] + v * V), wf[i], sc + v * V);
    fma_vec<W, NR>(wf, xs, xw, off + v * V, nb, acc);
  }
#pragma unroll
  for (int i = 0; i < NR; ++i)
#pragma unroll
    for (int bb = 0; bb < BCH; ++bb) acc[i][bb] = warp_sum(acc[i][bb]);
}

template <typename W>
__device__ __forceinline__ void warp_dot(const W* w, const float* xs, int xw,
                                         int off, int n, int nb, int lane,
                                         float acc[BCH],
                                         const float* sc = nullptr) {
  const W* rows[1] = {w};
  float a[1][BCH];
  warp_dots<W, 1>(rows, xs, xw, off, n, nb, lane, a, sc);
#pragma unroll
  for (int bb = 0; bb < BCH; ++bb) acc[bb] = a[0][bb];
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

template <typename T, typename W>
__global__ void __launch_bounds__(NT) gen_kernel(Args<T, W> a) {
  constexpr bool Q8 = sizeof(W) == 1;            // int8 weights
  extern __shared__ float xs[];                  // [BCH][xw] (+ int8: scales [xw])
  float* sc = Q8 ? xs + BCH * a.xw : nullptr;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = gridDim.x, blk = blockIdx.x;
  const int TW = G * NW;
  const int job0 = blk + warp * G;               // blocks first
  const int L = a.L, K = a.K, R = a.R, D = a.D, S = a.S, Q = a.Q, C = a.C,
            PK = a.PK, B = a.B, xw = a.xw;
  const int KR = K * R, KRC = K * R + C, SR = S + R;
  const float mu = (float)(Q - 1);
  const float log1p_mu = (float)log1p((double)mu);
  unsigned long long target = 0;
  float acc[BCH], acc2[BCH];

  for (int t = 0; t < a.length; ++t) {
    const int tf = t / a.ratio;
    const T* lc_t = a.lc + (size_t)tf * B * C;

    // ---- P0: preprocess conv -> cur[0]
    if (blk < R) {
      for (int b0 = 0; b0 < B; b0 += BCH) {
        const int nb = min(BCH, B - b0);
        for (int i = tid; i < nb * PK; i += NT) {
          const int bb = i / PK, p = i - bb * PK;
          const int s = t - (PK - 1) + p;
          float u = 0.f;
          if (s >= 0) u = mu_encode(ld_cg(&a.inputs[(size_t)s * B + b0 + bb]), mu, log1p_mu);
          xs[bb * xw + p] = to_f(from_f<T>(u));
        }
        __syncthreads();
        for (int r = job0; r < R; r += TW) {
          warp_dot(a.w_pre + (size_t)r * PK, xs, xw, 0, PK, nb, lane, acc);
          if (lane == 0) {
            const float bias = to_f(a.b_pre[r]);
#pragma unroll
            for (int bb = 0; bb < BCH; ++bb)
              if (bb < nb) a.cur[(size_t)(b0 + bb) * R + r] = from_f<T>(acc[bb] + bias);
          }
        }
        __syncthreads();
      }
    }
    grid_sync(a.barrier, target);

    for (int l = 0; l < L; ++l) {
      const int d = a.dil[l], size = (K - 1) * d, off = a.ring_off[l];
      const T* cur_in = a.cur + (size_t)(l & 1) * B * R;
      T* cur_out = a.cur + (size_t)((l + 1) & 1) * B * R;

      // ---- A: gate columns
      if (blk < D) {
        for (int b0 = 0; b0 < B; b0 += BCH) {
          const int nb = min(BCH, B - b0);
          for (int i = tid; i < nb * KRC; i += NT) {
            const int bb = i / KRC, k = i - bb * KRC, b = b0 + bb;
            float v;
            if (k < KR - R) {                    // tap block jb sees x[t - (K-1-jb) d]
              const int jb = k / R, r = k - jb * R, j = K - 1 - jb;
              const int slot = (t - j * d + j * size) % size;
              v = ld_cg(&a.ring[((size_t)(off + slot) * B + b) * R + r]);
            } else if (k < KR) {
              v = ld_cg(&cur_in[(size_t)b * R + k - (KR - R)]);
            } else {
              v = to_f(lc_t[(size_t)b * C + k - KR]);
            }
            xs[bb * xw + k] = v;
          }
          if constexpr (Q8)
            for (int k = tid; k < KRC; k += NT) sc[k] = __ldg(&a.s_a[(size_t)l * KRC + k]);
          __syncthreads();
          for (int j = job0; j < D; j += TW) {
            const W* w0 = a.w_a + ((size_t)l * 2 * D + j) * KRC;
            const W* rows[2] = {w0, w0 + (size_t)D * KRC};
            float pair[2][BCH];
            warp_dots<W, 2>(rows, xs, xw, 0, KRC, nb, lane, pair, sc);
#pragma unroll
            for (int bb = 0; bb < BCH; ++bb) { acc[bb] = pair[0][bb]; acc2[bb] = pair[1][bb]; }
            if (lane == 0) {
              const float bias0 = to_f(a.b_a[(size_t)l * 2 * D + j]);
              const float bias1 = to_f(a.b_a[(size_t)l * 2 * D + D + j]);
#pragma unroll
              for (int bb = 0; bb < BCH; ++bb)
                if (bb < nb) {
                  const T* gc = a.gcon + ((size_t)l * B + b0 + bb) * 2 * D;
                  const float p0 = acc[bb] + bias0 + to_f(gc[j]);
                  const float p1 = acc2[bb] + bias1 + to_f(gc[D + j]);
                  const float g = a.sigmoid_first ? sigmoidf_(p0) * tanhf(p1)
                                                  : tanhf(p0) * sigmoidf_(p1);
                  a.gated[(size_t)(b0 + bb) * D + j] = from_f<T>(g);
                }
            }
          }
          __syncthreads();
        }
      }
      grid_sync(a.barrier, target);

      // ---- B: [skip | res] columns, ring push, residual update
      if (blk < SR) {
        const int nbw = (l == 0) ? D + R : D;    // layer 0 also stages cur for skip start
        for (int b0 = 0; b0 < B; b0 += BCH) {
          const int nb = min(BCH, B - b0);
          for (int i = tid; i < nb * nbw; i += NT) {
            const int bb = i / nbw, k = i - bb * nbw, b = b0 + bb;
            xs[bb * xw + k] = k < D ? ld_cg(&a.gated[(size_t)b * D + k])
                                    : ld_cg(&cur_in[(size_t)b * R + k - D]);
          }
          if constexpr (Q8)
            for (int k = tid; k < D; k += NT) sc[k] = __ldg(&a.s_s[(size_t)l * D + k]);
          __syncthreads();
          for (int c = job0; c < SR; c += TW) {
            if constexpr (Q8) {                  // int8 skip half, bf16 res half
              if (c < S)
                warp_dot(a.w_sr + ((size_t)l * S + c) * D, xs, xw, 0, D, nb, lane, acc, sc);
              else
                warp_dot(a.w_r + ((size_t)l * R + c - S) * D, xs, xw, 0, D, nb, lane, acc);
            } else {
              warp_dot(a.w_sr + ((size_t)l * SR + c) * D, xs, xw, 0, D, nb, lane, acc);
            }
            const bool start = (l == 0) && (c < S);
            if (start) warp_dot(a.w_ss + (size_t)c * R, xs, xw, D, R, nb, lane, acc2);
            if (lane == 0) {
              const float bias = to_f(a.b_sr[(size_t)l * SR + c]);
#pragma unroll
              for (int bb = 0; bb < BCH; ++bb)
                if (bb < nb) {
                  const int b = b0 + bb;
                  const float out = acc[bb] + bias;
                  if (c < S) {
                    float* sp = &a.skip[(size_t)b * S + c];
                    const float base = start ? acc2[bb] + to_f(a.b_ss[c]) : ld_cg(sp);
                    *sp = base + out;
                  } else {
                    const int r = c - S;
                    const float xin = ld_cg(&cur_in[(size_t)b * R + r]);
                    a.ring[((size_t)(off + t % size) * B + b) * R + r] = from_f<T>(xin);
                    cur_out[(size_t)b * R + r] = from_f<T>(xin + out);
                  }
                }
            }
          }
          __syncthreads();
        }
      }
      grid_sync(a.barrier, target);
    }

    // ---- H1: postprocess1 on [relu(skip) | lc_t]
    if (blk < S) {
      const int n = S + C;
      for (int b0 = 0; b0 < B; b0 += BCH) {
        const int nb = min(BCH, B - b0);
        for (int i = tid; i < nb * n; i += NT) {
          const int bb = i / n, k = i - bb * n, b = b0 + bb;
          xs[bb * xw + k] = k < S
              ? to_f(from_f<T>(fmaxf(ld_cg(&a.skip[(size_t)b * S + k]), 0.f)))
              : to_f(lc_t[(size_t)b * C + k - S]);
        }
        __syncthreads();
        for (int c = job0; c < S; c += TW) {
          warp_dot(a.w_h1 + (size_t)c * n, xs, xw, 0, n, nb, lane, acc);
          if (lane == 0) {
            const float bias = to_f(a.b_h1[c]);
#pragma unroll
            for (int bb = 0; bb < BCH; ++bb)
              if (bb < nb) {
                const int b = b0 + bb;
                const float v = acc[bb] + bias + to_f(a.g_pp1[(size_t)b * S + c]);
                a.h1[(size_t)b * S + c] = from_f<T>(fmaxf(v, 0.f));
              }
          }
        }
        __syncthreads();
      }
    }
    grid_sync(a.barrier, target);

    // ---- H2: postprocess2 -> logits
    if (blk < Q) {
      for (int b0 = 0; b0 < B; b0 += BCH) {
        const int nb = min(BCH, B - b0);
        for (int i = tid; i < nb * S; i += NT) {
          const int bb = i / S, k = i - bb * S;
          xs[bb * xw + k] = ld_cg(&a.h1[(size_t)(b0 + bb) * S + k]);
        }
        __syncthreads();
        for (int q = job0; q < Q; q += TW) {
          warp_dot(a.w_pp2 + (size_t)q * S, xs, xw, 0, S, nb, lane, acc);
          if (lane == 0) {
            const float bias = to_f(a.b_pp2[q]);
#pragma unroll
            for (int bb = 0; bb < BCH; ++bb)
              if (bb < nb) {
                const int b = b0 + bb;
                const float v = acc[bb] + bias;
                a.logits[(size_t)b * Q + q] = v;
                if (a.logits_out) a.logits_out[((size_t)t * B + b) * Q + q] = v;
              }
          }
        }
        __syncthreads();
      }
    }
    grid_sync(a.barrier, target);

    // ---- S: sampling (block 0); lowest index wins ties
    if (blk == 0) {
      float* rv = xs;
      int* ri = reinterpret_cast<int*>(xs + NW);
      for (int b = 0; b < B; ++b) {
        float best = -INFINITY;
        int bi = Q;
        for (int q = tid; q < Q; q += NT) {
          float v = ld_cg(&a.logits[(size_t)b * Q + q]);
          if (a.sample) v += gumbel(a.seed, t, b, q);
          if (v > best || (v == best && q < bi)) { best = v; bi = q; }
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          const float ov = __shfl_xor_sync(0xffffffffu, best, o);
          const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
          if (ov > best || (ov == best && oi < bi)) { best = ov; bi = oi; }
        }
        if (lane == 0) { rv[warp] = best; ri[warp] = bi; }
        __syncthreads();
        if (tid == 0) {
          for (int w = 1; w < NW; ++w)
            if (rv[w] > best || (rv[w] == best && ri[w] < bi)) { best = rv[w]; bi = ri[w]; }
          if (bi >= Q) bi = 0;                   // all logits NaN
          a.bins[(size_t)t * B + b] = bi;
          if (!a.forced) a.inputs[(size_t)(t + 1) * B + b] = mu_decode(bi, mu);
        }
        __syncthreads();
      }
    }
    if (t + 1 < a.length) grid_sync(a.barrier, target);
  }
}

template <typename T, typename W>
int launch(Args<T, W> a, cudaStream_t stream) {
  const int KRC = a.K * a.R + a.C;
  int xw = KRC;
  xw = xw > a.D + a.R ? xw : a.D + a.R;
  xw = xw > a.S + a.C ? xw : a.S + a.C;
  xw = xw > a.PK ? xw : a.PK;
  xw = xw > 2 * NW ? xw : 2 * NW;
  xw = (xw + 7) / 8 * 8;                 // 16-byte aligned staging rows
  a.xw = xw;
  const size_t smem = sizeof(float) * (size_t)(BCH + (sizeof(W) == 1)) * xw;
  cudaError_t e = cudaFuncSetAttribute(
      gen_kernel<T, W>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (!coop) return (int)cudaErrorNotSupported;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gen_kernel<T, W>, NT, smem);
  if (e != cudaSuccess) return (int)e;
  // one block per SM: more co-resident blocks measured faster than fewer
  // (16..132 blocks, PERF.md), and the launch needs every block resident
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const int grid = sms;
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel((const void*)gen_kernel<T, W>, dim3(grid), dim3(NT),
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
        unsigned long long seed, void* stream) {
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
  return launch<T, W>(a, static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" const char* vqw_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 = float32, 1 = bfloat16, 2 = int8 weights with bfloat16
// activations.  The weight pointers are in the order w_a b_a w_sr b_sr
// w_pre b_pre w_ss b_ss w_h1 b_h1 w_pp2 b_pp2, then (int8 only, else null)
// s_a s_s w_r.
extern "C" int gen_wavenet(
    int dtype, int L, int K, int R, int D, int S, int Q, int C, int PK, int B,
    int length, int ratio, const void* dil, const void* ring_off,
    const void* w_a, const void* b_a, const void* w_sr, const void* b_sr,
    const void* w_pre, const void* b_pre, const void* w_ss, const void* b_ss,
    const void* w_h1, const void* b_h1, const void* w_pp2, const void* b_pp2,
    const void* s_a, const void* s_s, const void* w_r, const void* lc, const void* gcon, const void* g_pp1, void* inputs,
    int forced, void* ring, void* cur, void* gated, void* skip, void* h1,
    void* logits, void* logits_out, void* bins, void* barrier, int sample,
    int sigmoid_first, unsigned long long seed, void* stream) {
  const void* w[15] = {w_a, b_a, w_sr, b_sr, w_pre, b_pre, w_ss, b_ss,
                       w_h1, b_h1, w_pp2, b_pp2, s_a, s_s, w_r};
  if (dtype == 0)
    return run<float, float>(L, K, R, D, S, Q, C, PK, B, length, ratio, dil, ring_off,
                      w, lc, gcon, g_pp1, inputs, forced, ring, cur, gated,
                      skip, h1, logits, logits_out, bins, barrier, sample,
                      sigmoid_first, seed, stream);
  if (dtype == 1)
    return run<__nv_bfloat16, __nv_bfloat16>(
        L, K, R, D, S, Q, C, PK, B, length, ratio, dil, ring_off, w, lc, gcon,
        g_pp1, inputs, forced, ring, cur, gated, skip, h1, logits, logits_out,
        bins, barrier, sample, sigmoid_first, seed, stream);
  if (dtype == 2)
    return run<__nv_bfloat16, int8_t>(
        L, K, R, D, S, Q, C, PK, B, length, ratio, dil, ring_off, w, lc, gcon,
        g_pp1, inputs, forced, ring, cur, gated, skip, h1, logits, logits_out,
        bins, barrier, sample, sigmoid_first, seed, stream);
  return (int)cudaErrorInvalidValue;
}
