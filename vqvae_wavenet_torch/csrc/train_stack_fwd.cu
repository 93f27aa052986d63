// WaveNet training residual stack, forward.
//
// Replaces vqvae_wavenet_tpu/ops/train_pallas.py::_make_fused_stack (the
// Pallas kernel launched at train_pallas.py:1502).  The TPU kernel walks
// time tiles in order and keeps every layer's history in VMEM; here the
// layers are the outer loop (a host loop inside train_stack_fwd, two
// launches per layer) and each layer is two GEMMs over all B*T rows:
//
//   conv    pre[N, 2D] = sum_j xs[l][t - (K-1-j) d] . W_j   (implicit GEMM,
//           Kred = K*R; rows before t = 0 read zeros: the causal pad)
//           epilogue: + lc_encb[l, t / FR, b] (f32), gate on the f32
//           pre-activation, act = (tanh, sigmoid) each rounded to the
//           compute type, gated = f*g in the compute type
//           (train_pallas.py:1376-1401)
//   skipres [N, S+R] = gated . [skipw | resw]
//           epilogue: skip columns add into an f32 accumulator; residual
//           columns write xs[l+1] = T((x + res) + res_b)
//           (train_pallas.py:1405-1426); the last layer writes the skip
//           sum rounded to the compute type (:1430) and no residual.
//
// Sequence-parallel variants (the TPU kernel's with_start / with_xout,
// train_pallas.py:1198, :1240-1276, :1426-1449, launched per dilation
// cycle by parallel/timeshard.py on a halo-extended time shard):
//   start   rows t < start of every batch row lie outside the computation:
//           the causal gather reads zeros for t - o < start (so the first
//           kept row sees the zero history of a sequence start), and both
//           epilogues write zeros there (act, gated, xs[l+1], xout; the
//           skip columns are then zero sums).
//   xout    when given, the last layer keeps N = S + R and writes its
//           residual output T((x + res) + res_b) to xout [B, T, R].
//
// The conv weights arrive with their output columns interleaved
// (column 2c = tanh-half channel c, 2c+1 = sigmoid-half channel c), so
// one thread's accumulator pair holds both halves of a channel.
//
// Saved for the backward, in the compute type: act [L, B, T, 2D] and the
// layer inputs xs [L, B, T, R] (xs[0] = x0).
//
// What bounds it on the H100: the products, 1.88 TFLOP per step at the
// shipped training shape (B=8, T=6656, R=D=256, S=512, K=3, L=30): ~1.9 ms
// at the bf16 tensor-core peak, ~28 ms at the f32 FFMA peak.  Beside them
// the epilogues: the gate (two transcendentals a channel) with act and
// gated written, xs[l+1] written and xs[l] read, and the skip sum's f32
// read-modify-write of [rows, S] (109 MB each way a layer, ~2 ms a step at
// 3.35 TB/s).
//
// The design: both products run on hopper_gemm.cuh's TMA ring (wgmma in
// bf16, FFMA in f32), K-major.  A tile is 128 rows of one batch row; the
// conv's k runs over (tap j, 64-channel tile), and tap j's A box is the
// xs map's rows t0 - o_j - start: the map starts at row ``start`` of every
// batch row (xs + start * R), so rows before it -- the causal pad, and
// the sequence-parallel head -- are negative coordinates and load zeros,
// with no index test in the mainloop.  The weights are maps too, with a
// box per (tap, channel tile) that is zero past R.  A tile wholly before
// start runs no k-tiles (its outputs are zeros).  The epilogues run after
// the mainloop from a C tile in shared memory (hopper_gemm.cuh).
//
// Measured (chip_smoke.py [train-stack], NVIDIA H100 80GB HBM3, 700 W):
// bf16 9.83 ms (the tile loop before: 27.87), f32 53.95 (91.04); the
// products alone as torch.matmul calls take 3.6 / 42.5 ms.  The bf16
// kernel is bound by its epilogues, which do not overlap the mainloop.
//
// C interface (ctypes): pointers and the stream as void*, returns
// cudaGetLastError() of the first failing launch (0 on success).

#include "hopper_gemm.cuh"
#include "train_common.cuh"

namespace {

using tg::bf16;
using tg::st2;
using tg::Two;

template <typename T> struct KCfg;
template <> struct KCfg<bf16> { using type = hg::Bf16KCfg; };
template <> struct KCfg<float> { using type = hg::F32KCfg; };

// the (batch row, first time step) of a tile: blockIdx.z = b, blockIdx.y
// = tile of the batch row (no division in the epilogue)
template <class Cfg>
__device__ __forceinline__ void row_tile(int& b, int& t0) {
  b = blockIdx.z;
  t0 = blockIdx.y * Cfg::BM;
}

template <class C>
struct Conv {
  using Cfg = C;
  using T = typename C::T;
  CUtensorMap x;     // xs [L][B][T - start][R], from row start
  CUtensorMap w;     // wconv_t [L][2D (interleaved)][K][R]
  const float* lc;   // lc_encb[l] [F, B, 2D]
  T* act;            // act[l]  [rows, 2D]
  T* gated;          // [rows, D]
  int l, T_, D, KS, d, FR, B, ct, start;   // ct channel tiles per tap
  float inv_fr;      // 1 / FR
  bool sigmoid_first;

  __device__ void k_range(int& it0, int& it1) const {
    int b, t0;
    row_tile<Cfg>(b, t0);
    it0 = 0;
    it1 = t0 + Cfg::BM <= start ? 0 : KS * ct;
  }
  __device__ void load(int it, uint32_t sA, uint32_t sB, uint32_t bar) const {
    int b, t0;
    row_tile<Cfg>(b, t0);
    const int j = it / ct, c0 = (it - j * ct) * Cfg::BK;
    const int o = (KS - 1 - j) * d;
    hg::tma_load_4d(sA, &x, bar, c0, t0 - o - start, b, l);
    hg::tma_load_4d(sB, &w, bar, c0, j, blockIdx.x * Cfg::BN, l);
  }
  // batch row b, time step t and output column n for the tile's (r, c)
  __device__ bool at(int r, int c, int& b, int& t, int& n) const {
    int t0;
    row_tile<Cfg>(b, t0);
    t = t0 + r;
    n = blockIdx.x * Cfg::BN + c;
    return t < T_ && n < 2 * D;
  }
  struct Pre {
    float2 l;          // the condition of both halves of channel n / 2
  };
  __device__ Pre fetch(int r, int c) const {
    Pre e{};
    int b, t, n;
    if (at(r, c, b, t, n) && t >= start) {
      // t / FR without an integer division: the float quotient is off by
      // at most one (t < 2^24), then corrected
      int f = __float2int_rz((float)t * inv_fr);
      f -= f * FR > t;
      f += (f + 1) * FR <= t;
      const float* lr = lc + ((long long)f * B + b) * (2 * D);
      e.l = make_float2(lr[n >> 1], lr[D + (n >> 1)]);
    }
    return e;
  }
  __device__ void put(int r, int c, float v0, float v1, const Pre& e) const {
    int b, t, n;
    if (!at(r, c, b, t, n)) return;
    const int ch = n >> 1;                 // columns n, n+1: both halves of ch
    const long long m = (long long)b * T_ + t;
    T* a = act + m * (2 * D);
    if (t < start) {
      const T z = tg::from_f<T>(0.f);
      a[ch] = z;
      a[D + ch] = z;
      gated[m * D + ch] = z;
      return;
    }
    const float pa = v0 + e.l.x, pb = v1 + e.l.y;
    float f, g;
    if (sigmoid_first) {
      f = tg::rnd<T>(1.f / (1.f + expf(-pa)));
      g = tg::rnd<T>(tanhf(pb));
    } else {
      f = tg::rnd<T>(tanhf(pa));
      g = tg::rnd<T>(1.f / (1.f + expf(-pb)));
    }
    a[ch] = tg::from_f<T>(f);
    a[D + ch] = tg::from_f<T>(g);
    gated[m * D + ch] = tg::from_f<T>(f * g);
  }
};

template <class C>
struct SkipRes {
  using Cfg = C;
  using T = typename C::T;
  CUtensorMap g;       // gated [B][T][D]
  CUtensorMap w;       // srw^T [L][S+R][D]
  const T* x;          // xs[l]   [rows, R]
  T* xnext;            // xs[l+1] (or xout after the last layer) [rows, R]
  const float* res_b;  // [R]
  float* skipacc;      // [rows, S] f32
  T* skip_out;         // [rows, S]
  int l, N, S, R, T_, kt, start;
  bool first, last;

  __device__ void k_range(int& it0, int& it1) const {
    int b, t0;
    row_tile<Cfg>(b, t0);
    it0 = 0;
    it1 = t0 + Cfg::BM <= start ? 0 : kt;
  }
  __device__ void load(int it, uint32_t sA, uint32_t sB, uint32_t bar) const {
    int b, t0;
    row_tile<Cfg>(b, t0);
    hg::tma_load_4d(sA, &g, bar, it * Cfg::BK, t0, b, 0);
    hg::tma_load_4d(sB, &w, bar, it * Cfg::BK, blockIdx.x * Cfg::BN, l, 0);
  }
  // row m, time step t and output column n for the tile's (r, c)
  __device__ bool at(int r, int c, long long& m, int& t, int& n) const {
    int b, t0;
    row_tile<Cfg>(b, t0);
    t = t0 + r;
    n = blockIdx.x * Cfg::BN + c;
    m = (long long)b * T_ + t;
    return t < T_ && n < N;               // S, N even: n, n+1 on one side
  }
  struct Pre {
    float2 a;          // skip: the running sum; residual: res_b
    Two<T> x;          // residual: the layer input
  };
  __device__ Pre fetch(int r, int c) const {
    Pre p{};
    long long m;
    int t, n;
    if (!at(r, c, m, t, n)) return p;
    if (n < S) {
      if (!first) p.a = *reinterpret_cast<const float2*>(skipacc + m * S + n);
    } else if (t >= start) {
      p.a = *reinterpret_cast<const float2*>(res_b + n - S);
      p.x.load(x + m * R + n - S);
    }
    return p;
  }
  __device__ void put(int r, int c, float v0, float v1, const Pre& p) const {
    long long m;
    int t, n;
    if (!at(r, c, m, t, n)) return;
    if (n < S) {
      const float s0 = first ? v0 : p.a.x + v0;
      const float s1 = first ? v1 : p.a.y + v1;
      if (last)
        st2(skip_out + m * S + n, s0, s1);
      else
        st2(skipacc + m * S + n, s0, s1);
    } else if (t < start) {
      st2(xnext + m * R + n - S, 0.f, 0.f);
    } else {
      st2(xnext + m * R + n - S, (p.x.lo() + v0) + p.a.x,
          (p.x.hi() + v1) + p.a.y);
    }
  }
};

#define FWD_TRY(x)                                      \
  do {                                                  \
    const cudaError_t e_ = (x);                         \
    if (e_ != cudaSuccess) return static_cast<int>(e_); \
  } while (0)

template <typename T>
int run(int L, int K, int R, int D, int S, int B, int T_, int FR, int start,
        const int* dils, const T* wconv_t, const T* srw_t,
        const float* res_b, const float* lc_encb, T* xs, T* act,
        T* gated, float* skipacc, T* skip_out, T* xout, bool sigmoid_first,
        cudaStream_t s) {
  using Cfg = typename KCfg<T>::type;
  const int rows = B * T_;
  const int F = T_ / FR;
  const int tpb = tg::ceil_div(T_, Cfg::BM);

  Conv<Cfg> c;
  // every layer's input seen from row start of each batch row
  FWD_TRY(hg::encode_k<Cfg>(
      &c.x, xs + (long long)start * R,
      hg::View{{R, T_ - start > 0 ? T_ - start : 1, B, L},
               {R, (long long)T_ * R, (long long)rows * R}},
      Cfg::BM));
  FWD_TRY(hg::encode_k<Cfg>(&c.w, wconv_t, hg::dense(R, K, 2 * D, L), Cfg::BN,
                            2));
  c.gated = gated;
  c.T_ = T_; c.D = D; c.KS = K; c.FR = FR; c.B = B;
  c.inv_fr = 1.f / FR;
  c.ct = tg::ceil_div(R, Cfg::BK);
  c.start = start;
  c.sigmoid_first = sigmoid_first;
  const dim3 c_grid(tg::ceil_div(2 * D, Cfg::BN), tpb, B);

  SkipRes<Cfg> p;
  FWD_TRY(hg::encode_k<Cfg>(&p.g, gated, hg::dense(D, T_, B, 1), Cfg::BM));
  FWD_TRY(hg::encode_k<Cfg>(&p.w, srw_t, hg::dense(D, S + R, L, 1), Cfg::BN));
  p.skipacc = skipacc;
  p.skip_out = skip_out;
  p.S = S; p.R = R; p.T_ = T_; p.start = start;
  p.kt = tg::ceil_div(D, Cfg::BK);

  for (int l = 0; l < L; ++l) {
    c.l = l;
    c.d = dils[l];
    c.lc = lc_encb + (long long)l * F * B * 2 * D;
    c.act = act + (long long)l * rows * 2 * D;
    FWD_TRY(hg::launch(c, c_grid, s));

    const bool last = l == L - 1;
    p.l = l;
    p.N = last && !xout ? S : S + R;
    p.x = xs + (long long)l * rows * R;
    p.xnext = last ? xout : xs + (long long)(l + 1) * rows * R;
    p.res_b = res_b + (long long)l * R;
    p.first = l == 0;
    p.last = last;
    FWD_TRY(hg::launch(p, dim3(tg::ceil_div(p.N, Cfg::BN), tpb, B), s));
  }
  return 0;
}

}  // namespace

// dtype 0 = float32, 1 = bfloat16.  xs[0] must hold x0 on entry; rows
// before start are never read.  xout may be null (no stream output).
extern "C" int train_stack_fwd(int dtype, int L, int K, int R, int D, int S,
                               int B, int T, int FR, int start,
                               const int* dils, const void* wconv_t,
                               const void* srw_t, const void* res_b,
                               const void* lc_encb, void* xs, void* act,
                               void* gated, void* skipacc, void* skip_out,
                               void* xout, int sigmoid_first, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return run<bf16>(L, K, R, D, S, B, T, FR, start, dils,
                     static_cast<const bf16*>(wconv_t),
                     static_cast<const bf16*>(srw_t),
                     static_cast<const float*>(res_b),
                     static_cast<const float*>(lc_encb),
                     static_cast<bf16*>(xs), static_cast<bf16*>(act),
                     static_cast<bf16*>(gated), static_cast<float*>(skipacc),
                     static_cast<bf16*>(skip_out), static_cast<bf16*>(xout),
                     sigmoid_first != 0, s);
  return run<float>(L, K, R, D, S, B, T, FR, start, dils,
                    static_cast<const float*>(wconv_t),
                    static_cast<const float*>(srw_t),
                    static_cast<const float*>(res_b),
                    static_cast<const float*>(lc_encb),
                    static_cast<float*>(xs), static_cast<float*>(act),
                    static_cast<float*>(gated), static_cast<float*>(skipacc),
                    static_cast<float*>(skip_out), static_cast<float*>(xout),
                    sigmoid_first != 0, s);
}
