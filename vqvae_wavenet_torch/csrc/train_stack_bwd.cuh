// The per-layer pieces of the WaveNet training stack's backward, shared by
// train_stack_bwd.cu (the layer sweep with dk per layer, TPU kernel
// _make_bwd_sweep_kernel) and train_stack_bwd2.cu (the two-kernel form:
// the chain, then dk for every layer in one launch).  Each struct is a
// problem for train_gemm.cuh's tile GEMM:
//
//   DgatedP  dgated [N, D] = [dX16 | dskip] . [resw^T ; skipw^T]; the
//            epilogue applies the gate derivative from the saved (f, g)
//            and writes dpre = [da | db] [N, 2D]
//   DskrsP   dsk|drs [D, S+R] = gated^T . [dskip | dX16] (split-K partials)
//   DkP      dk [K*R, 2D] = sum_t xs[l][t - o_j]^T . dpre[t]  (split-K;
//            the sweep's, per layer: train_stack_bwd2.cu's one-launch dk
//            for every layer runs on hopper_gemm.cuh)
//   DxP      dX += sum_j dpre[t + o_j] . W_j^T, and dX16 = T(dX)
//   seed_dx  dX, dX16 at the start of the walk
//
// and ``walk``, the reverse walk over the layers that launches them.
// Rounding points and the sequence-parallel ``start`` are described in
// train_stack_bwd.cu.
#pragma once

#include "train_gemm.cuh"

namespace bwd {

using tg::bf16;

template <typename T>
struct DgatedP {
  int M, N, K, kchunk;
  const T* dx16;     // [rows, R]
  const T* dskip;    // [rows, S]
  const T* wt;       // [resw | skipw][l]  [D, R+S]
  const T* act;      // act[l] [rows, 2D]
  T* dpre;           // [rows, 2D]
  int R, S, D, T_, start;
  bool sigmoid_first;

  __device__ bool a8(int m, int k, T* v) const {
    if (k < R) tg::ld8(dx16 + (long long)m * R + k, v);
    else tg::ld8(dskip + (long long)m * S + (k - R), v);
    return true;
  }
  __device__ bool b8(int n, int k, T* v) const {
    tg::ld8(wt + (long long)n * K + k, v);
    return true;
  }
  __device__ void col(int m, int c, float acc) const {
    T* o = dpre + (long long)m * (2 * D);
    if (m % T_ < start) {
      o[c] = tg::from_f<T>(0.f);
      o[D + c] = tg::from_f<T>(0.f);
      return;
    }
    const float dg = tg::rnd<T>(acc);
    const T* a = act + (long long)m * (2 * D);
    const float f = tg::to_f(a[c]), g = tg::to_f(a[D + c]);
    float da, db;
    if (sigmoid_first) {
      // da = dg*g*f*(1-f), db = dg*f*(1-g^2)
      const float v = tg::rnd<T>(tg::rnd<T>(dg * g) * f);
      const float w = tg::rnd<T>(dg * f);
      da = tg::rnd<T>(v - tg::rnd<T>(v * f));
      db = tg::rnd<T>(w - tg::rnd<T>(tg::rnd<T>(w * g) * g));
    } else {
      // u = dg*g, v = u*f: da = u - v*f = dg*g*(1-f^2),
      // db = v - v*g = dg*f*g*(1-g)
      const float u = tg::rnd<T>(dg * g);
      const float v = tg::rnd<T>(u * f);
      da = tg::rnd<T>(u - tg::rnd<T>(v * f));
      db = tg::rnd<T>(v - tg::rnd<T>(v * g));
    }
    o[c] = tg::from_f<T>(da);
    o[D + c] = tg::from_f<T>(db);
  }
  __device__ void epi(int m, int n, float v0, float v1, int) const {
    col(m, n, v0);
    col(m, n + 1, v1);
  }
};

// The two weight-gradient products below reduce over the rows: each split
// writes its partial [M, N] product to part[split], reduced afterwards.
template <typename T>
struct DskrsP {
  int M, N, K, kchunk;     // M = D, N = S + R, K = rows
  const T* act;            // act[l] [rows, 2D]
  const T* dskip;          // [rows, S]
  const T* dx16;           // [rows, R]
  float* part;
  int D, S, R;

  __device__ bool a8(int m, int k, T* v) const {     // gated[k][m..m+7]
    const T* a = act + (long long)k * (2 * D) + m;
    alignas(16) T f[8], g[8];
    tg::ld8(a, f);
    tg::ld8(a + D, g);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      v[i] = tg::from_f<T>(tg::to_f(f[i]) * tg::to_f(g[i]));
    return true;
  }
  __device__ bool b8(int n, int k, T* v) const {
    if (n < S) tg::ld8(dskip + (long long)k * S + n, v);
    else tg::ld8(dx16 + (long long)k * R + (n - S), v);
    return true;
  }
  __device__ void epi(int m, int n, float v0, float v1, int split) const {
    float* o = part + ((long long)split * M + m) * N + n;
    o[0] = v0;
    o[1] = v1;
  }
};

template <typename T>
struct DkP {
  int M, N, K, kchunk;     // M = K*R, N = 2D, K = rows
  const T* x;              // xs[l] [rows, R]
  const T* dpre;           // [rows, 2D]
  float* part;             // split s's [M, N] partial at part + s * pstride
  long long pstride;
  int T_, R, D, KS, d, start;

  __device__ bool a8(int m, int k, T* v) const {     // x[k - o_j][c..c+7]
    const int j = m / R, c = m - j * R;
    const int o = (KS - 1 - j) * d;
    if (k % T_ - o < start) return false;
    tg::ld8(x + (long long)(k - o) * R + c, v);
    return true;
  }
  __device__ bool b8(int n, int k, T* v) const {
    tg::ld8(dpre + (long long)k * (2 * D) + n, v);
    return true;
  }
  __device__ void epi(int m, int n, float v0, float v1, int split) const {
    float* o = part + split * pstride + (long long)m * N + n;
    o[0] = v0;
    o[1] = v1;
  }
};

template <typename T>
struct DxP {
  int M, N, K, kchunk;     // M = rows, N = R, K = KS*2D
  const T* dpre;           // [rows, 2D]
  const T* kern;           // kernel[l] [KS, R, 2D]
  float* dx;               // [rows, R] f32, updated in place
  T* dx16;                 // [rows, R]
  int T_, R, D, KS, d, start;

  __device__ bool a8(int m, int k, T* v) const {     // dpre[m + o_j][f..]
    const int j = k / (2 * D), f = k - j * 2 * D;
    const int o = (KS - 1 - j) * d;
    const int t = m % T_;
    // rows before start get nothing (their dX stays zero)
    if (t < start || t + o >= T_) return false;
    tg::ld8(dpre + (long long)(m + o) * (2 * D) + f, v);
    return true;
  }
  __device__ bool b8(int n, int k, T* v) const {     // W_j[n][f..]
    const int j = k / (2 * D), f = k - j * 2 * D;
    tg::ld8(kern + ((long long)j * R + n) * (2 * D) + f, v);
    return true;
  }
  __device__ void epi(int m, int n, float v0, float v1, int) const {
    const long long i = (long long)m * R + n;
    const float a = dx[i] + v0, b = dx[i + 1] + v1;
    dx[i] = a;
    dx[i + 1] = b;
    dx16[i] = tg::from_f<T>(a);
    dx16[i + 1] = tg::from_f<T>(b);
  }
};

// dx16 = T(dxout) (zeros without dxout, and on rows t < start), dx = dx16
template <typename T>
__global__ void seed_dx(const T* __restrict__ dxout, long long n, int T_,
                        int R, int start, float* __restrict__ dx,
                        T* __restrict__ dx16) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int t = (int)((i / R) % T_);
  const T v = (dxout == nullptr || t < start) ? tg::from_f<T>(0.f) : dxout[i];
  dx16[i] = v;
  dx[i] = tg::to_f(v);
}

constexpr int ROW_CHUNK = 1024;   // rows per split of the row reductions

// The reverse layer walk of both backwards.  With dk given (the sweep) each
// layer's dk is summed right after its dpre, which reuses one [rows, 2D]
// dpre buffer; with dk null (the chain) layer l's dpre is kept at
// dpre + l * rows * 2D for the one-launch dk pass, and xs is not read.
// part holds walk_part_floats(...) floats.
template <typename T>
int walk(int L, int K, int R, int D, int S, int B, int T_, int FR, int start,
         const int* dils, const T* rsk, const T* kern, const T* dskip,
         const T* act, const T* xs, const T* dxout, float* dk, float* dskrs,
         float* drb, float* dlc, T* dx16, float* dx, T* dpre, float* part,
         bool sigmoid_first, cudaStream_t s) {
  const int rows = B * T_;
  const int F = T_ / FR;
  const int splits = tg::ceil_div(rows, ROW_CHUNK);
  const long long n = (long long)rows * R;
  seed_dx<T><<<(unsigned)((n + 255) / 256), 256, 0, s>>>(dxout, n, T_, R,
                                                           start, dx, dx16);
  cudaError_t e;
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  for (int l = L - 1; l >= 0; --l) {
    const int d = dils[l];
    const T* act_l = act + (long long)l * rows * 2 * D;
    T* dpre_l = dk ? dpre : dpre + (long long)l * rows * 2 * D;

    DgatedP<T> g;
    g.M = rows; g.N = D; g.K = R + S; g.kchunk = R + S;
    g.dx16 = dx16; g.dskip = dskip;
    g.wt = rsk + (long long)l * D * (R + S);
    g.act = act_l; g.dpre = dpre_l;
    g.R = R; g.S = S; g.D = D; g.T_ = T_; g.start = start;
    g.sigmoid_first = sigmoid_first;
    if ((e = tg::launch_gemm<T, true, true>(g, 1, s)) != cudaSuccess)
      return static_cast<int>(e);

    DskrsP<T> q;
    q.M = D; q.N = S + R; q.K = rows; q.kchunk = ROW_CHUNK;
    q.act = act_l; q.dskip = dskip; q.dx16 = dx16; q.part = part;
    q.D = D; q.S = S; q.R = R;
    if ((e = tg::launch_gemm<T, false, false>(q, splits, s)) != cudaSuccess)
      return static_cast<int>(e);
    if ((e = tg::launch_reduce(part, splits, (long long)D * (S + R),
                               dskrs + (long long)l * D * (S + R), s))
        != cudaSuccess)
      return static_cast<int>(e);

    tg::col_partials<<<dim3(tg::ceil_div(R, 256), splits), 256, 0, s>>>(
        dx, rows, R, ROW_CHUNK, part);
    if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
    if ((e = tg::launch_reduce(part, splits, R, drb + (long long)l * R, s))
        != cudaSuccess)
      return static_cast<int>(e);

    if ((e = tg::launch_frame_sum<T>(dpre_l, B, T_, FR, 2 * D,
                                     dlc + (long long)l * F * B * 2 * D, s))
        != cudaSuccess)
      return static_cast<int>(e);

    if (dk) {
      DkP<T> k;
      k.M = K * R; k.N = 2 * D; k.K = rows; k.kchunk = ROW_CHUNK;
      k.x = xs + (long long)l * rows * R; k.dpre = dpre_l; k.part = part;
      k.pstride = (long long)K * R * 2 * D;
      k.T_ = T_; k.R = R; k.D = D; k.KS = K; k.d = d; k.start = start;
      if ((e = tg::launch_gemm<T, false, false>(k, splits, s)) !=
          cudaSuccess)
        return static_cast<int>(e);
      if ((e = tg::launch_reduce(part, splits, (long long)K * R * 2 * D,
                                 dk + (long long)l * K * R * 2 * D, s))
          != cudaSuccess)
        return static_cast<int>(e);
    }

    DxP<T> x;
    x.M = rows; x.N = R; x.K = K * 2 * D; x.kchunk = K * 2 * D;
    x.dpre = dpre_l; x.kern = kern + (long long)l * K * R * 2 * D;
    x.dx = dx; x.dx16 = dx16;
    x.T_ = T_; x.R = R; x.D = D; x.KS = K; x.d = d; x.start = start;
    if ((e = tg::launch_gemm<T, true, true>(x, 1, s)) != cudaSuccess)
      return static_cast<int>(e);
  }
  return 0;
}

// The floats of scratch walk needs (the dk partials only with dk).
inline long long walk_part_floats(int K, int R, int D, int S, int B, int T,
                                  bool with_dk) {
  long long width = (long long)D * (S + R);
  if (with_dk && (long long)K * R * 2 * D > width)
    width = (long long)K * R * 2 * D;
  if (R > width) width = R;
  return tg::ceil_div((long long)B * T, ROW_CHUNK) * width;
}

}  // namespace bwd
