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
//           skip columns are then zero sums).  The rows are still swept by
//           the GEMMs: skipping them is later work.
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
// at the bf16 tensor-core peak, ~28 ms at the f32 FFMA peak.  This first
// kernel is a plain single-buffered tile loop (no TMA, no wgmma), so it
// runs well below either bound; making it fast is later work.
//
// C interface (ctypes): pointers and the stream as void*, returns
// cudaGetLastError() of the first failing launch (0 on success).

#include "train_gemm.cuh"

namespace {

using tg::bf16;

template <typename T>
struct ConvP {
  int M, N, K, kchunk;
  const T* x;        // xs[l]   [rows, R]
  const T* wt;       // [2D (interleaved), K*R]
  const float* lc;   // lc_encb[l] [F, B, 2D]
  T* act;            // act[l]  [rows, 2D]
  T* gated;          // [rows, D]
  int T_, R, D, KS, d, FR, B, start;
  bool sigmoid_first;

  __device__ bool a8(int m, int k, T* v) const {
    const int j = k / R, c = k - j * R;
    const int o = (KS - 1 - j) * d;
    const int t = m % T_;
    if (t - o < start) return false;   // the causal pad (start = 0: t < o)
    tg::ld8(x + (long long)(m - o) * R + c, v);
    return true;
  }
  __device__ bool b8(int n, int k, T* v) const {
    tg::ld8(wt + (long long)n * K + k, v);
    return true;
  }
  __device__ void epi(int m, int n, float v0, float v1, int) const {
    const int c = n >> 1;
    const int b = m / T_, t = m - b * T_;
    T* a = act + (long long)m * (2 * D);
    if (t < start) {
      const T z = tg::from_f<T>(0.f);
      a[c] = z;
      a[D + c] = z;
      gated[(long long)m * D + c] = z;
      return;
    }
    const float* l = lc + ((long long)(t / FR) * B + b) * (2 * D);
    const float pa = v0 + l[c], pb = v1 + l[D + c];
    float f, g;
    if (sigmoid_first) {
      f = tg::rnd<T>(1.f / (1.f + expf(-pa)));
      g = tg::rnd<T>(tanhf(pb));
    } else {
      f = tg::rnd<T>(tanhf(pa));
      g = tg::rnd<T>(1.f / (1.f + expf(-pb)));
    }
    a[c] = tg::from_f<T>(f);
    a[D + c] = tg::from_f<T>(g);
    gated[(long long)m * D + c] = tg::from_f<T>(f * g);
  }
};

template <typename T>
struct SkipResP {
  int M, N, K, kchunk;
  const T* gated;    // [rows, D]
  const T* wt;       // srw^T [S+R, D]
  const T* x;        // xs[l]   [rows, R]
  T* xnext;          // xs[l+1] (or xout after the last layer) [rows, R]
  const float* res_b;  // [R]
  float* skipacc;    // [rows, S] f32
  T* skip_out;       // [rows, S]
  int S, R, T_, start;
  bool first, last;

  __device__ bool a8(int m, int k, T* v) const {
    tg::ld8(gated + (long long)m * K + k, v);
    return true;
  }
  __device__ bool b8(int n, int k, T* v) const {
    tg::ld8(wt + (long long)n * K + k, v);
    return true;
  }
  __device__ void col(int m, int n, float v) const {
    if (n < S) {
      float* acc = skipacc + (long long)m * S + n;
      const float s = first ? v : *acc + v;
      if (last) skip_out[(long long)m * S + n] = tg::from_f<T>(s);
      else *acc = s;
    } else {
      const int c = n - S;
      const long long i = (long long)m * R + c;
      xnext[i] = m % T_ < start
                     ? tg::from_f<T>(0.f)
                     : tg::from_f<T>((tg::to_f(x[i]) + v) + res_b[c]);
    }
  }
  __device__ void epi(int m, int n, float v0, float v1, int) const {
    col(m, n, v0);
    col(m, n + 1, v1);
  }
};

template <typename T>
int run(int L, int K, int R, int D, int S, int B, int T_, int FR, int start,
        const int* dils, const T* wconv_t, const T* srw_t,
        const float* res_b, const float* lc_encb, T* xs, T* act,
        T* gated, float* skipacc, T* skip_out, T* xout, bool sigmoid_first,
        cudaStream_t s) {
  const int rows = B * T_;
  const int F = T_ / FR;
  for (int l = 0; l < L; ++l) {
    ConvP<T> c;
    c.M = rows; c.N = 2 * D; c.K = K * R; c.kchunk = K * R;
    c.x = xs + (long long)l * rows * R;
    c.wt = wconv_t + (long long)l * 2 * D * K * R;
    c.lc = lc_encb + (long long)l * F * B * 2 * D;
    c.act = act + (long long)l * rows * 2 * D;
    c.gated = gated;
    c.T_ = T_; c.R = R; c.D = D; c.KS = K; c.d = dils[l]; c.FR = FR; c.B = B;
    c.start = start;
    c.sigmoid_first = sigmoid_first;
    cudaError_t e = tg::launch_gemm<T, true, true>(c, 1, s);
    if (e != cudaSuccess) return static_cast<int>(e);

    SkipResP<T> p;
    const bool last = l == L - 1;
    p.M = rows; p.N = last && !xout ? S : S + R; p.K = D; p.kchunk = D;
    p.gated = gated;
    p.wt = srw_t + (long long)l * (S + R) * D;
    p.x = xs + (long long)l * rows * R;
    p.xnext = last ? xout : xs + (long long)(l + 1) * rows * R;
    p.res_b = res_b + (long long)l * R;
    p.skipacc = skipacc;
    p.skip_out = skip_out;
    p.S = S; p.R = R; p.T_ = T_; p.start = start;
    p.first = l == 0;
    p.last = last;
    e = tg::launch_gemm<T, true, true>(p, 1, s);
    if (e != cudaSuccess) return static_cast<int>(e);
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
