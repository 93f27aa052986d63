// WaveNet training residual stack, backward.
//
// Replaces vqvae_wavenet_tpu/ops/train_pallas.py::_make_bwd_sweep_kernel
// (the Pallas kernel launched at train_pallas.py:1100, driven from the
// custom VJP's fused_bwd :1560-1610).  The TPU kernel sweeps reverse time
// tiles per layer group with a VMEM spill arena for the dilated taps;
// here the layers are walked in reverse by a host loop, and each layer is
// six launches over all B*T rows, with dpre making one round trip through
// device memory per layer:
//
//   dgated  [N, D] = [dX16 | dskip] . [resw^T ; skipw^T]    (Kred = R+S)
//           epilogue: dg = T(acc); the gate derivative from the saved
//           (f, g) in the compute type, factored as the TPU kernel does
//           (train_pallas.py:876-893); writes dpre = [da | db] [N, 2D]
//   dsk|drs [D, S+R] = gated^T . [dskip | dX16]  (split-K over rows)
//   drb     [R] = sum over rows of dX (f32)       (per-chunk partials)
//   dlc     [F, B, 2D] = per-frame sums of dpre (f32)
//   dk      [K*R, 2D] = sum_t xs[l][t - o_j]^T . dpre[t]   (split-K)
//   dX     += sum_j dpre[t + o_j] . W_j^T                  (Kred = K*2D;
//           rows past the batch's end read zeros), and dX16 = T(dX)
//
// dX (the gradient of the layer's output) stays float32 across all
// layers; dX16 is its compute-type copy that the products read, as the TPU
// kernel's xcat does.  Every sum over rows goes through per-split partials
// and a fixed-order second pass (no float atomics), so runs repeat bit for
// bit.  dx0 on exit is dX16.
//
// Sequence-parallel variants (the sweep kernel's with_start and its dX
// seed, train_pallas.py:739, :761-772, :845-848, :999-1009, :1579-1581):
//   dxout   when given (the cotangent of the forward's stream output), dX
//           starts from T(dxout) instead of zeros (seed_dx below);
//   start   rows t < start lie outside the computation: the seed and every
//           dX update leave them at zero (so dx0 is zero there), dgated
//           writes dpre = 0 there, and the dk gather reads zeros for
//           t - o_j < start.  The row sums (drb, dlc, dsk|drs, dk) then
//           get nothing from those rows: their dX, dpre and gated (the
//           forward wrote act = 0) are zero.
//
// What bounds it on the H100: the products, 3.77 TFLOP per step at the
// shipped training shape (about twice the forward): ~3.8 ms at the bf16
// tensor-core peak, ~56 ms at the f32 FFMA peak; plus ~1.6 GB of dpre
// traffic (bf16) per step.  Like the forward, this first kernel is a plain
// tile loop and runs well below the bound.
//
// C interface (ctypes): pointers and the stream as void*, returns
// cudaGetLastError() of the first failing launch (0 on success).

#include "train_gemm.cuh"

namespace {

using tg::bf16;

constexpr int ROW_CHUNK = 1024;   // rows per split of the row reductions

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
  float* part;
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
    float* o = part + ((long long)split * M + m) * N + n;
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

template <typename T>
int run(int L, int K, int R, int D, int S, int B, int T_, int FR, int start,
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
    const T* x_l = xs + (long long)l * rows * R;

    DgatedP<T> g;
    g.M = rows; g.N = D; g.K = R + S; g.kchunk = R + S;
    g.dx16 = dx16; g.dskip = dskip;
    g.wt = rsk + (long long)l * D * (R + S);
    g.act = act_l; g.dpre = dpre;
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

    if ((e = tg::launch_frame_sum<T>(dpre, B, T_, FR, 2 * D,
                                     dlc + (long long)l * F * B * 2 * D, s))
        != cudaSuccess)
      return static_cast<int>(e);

    DkP<T> k;
    k.M = K * R; k.N = 2 * D; k.K = rows; k.kchunk = ROW_CHUNK;
    k.x = x_l; k.dpre = dpre; k.part = part;
    k.T_ = T_; k.R = R; k.D = D; k.KS = K; k.d = d; k.start = start;
    if ((e = tg::launch_gemm<T, false, false>(k, splits, s)) != cudaSuccess)
      return static_cast<int>(e);
    if ((e = tg::launch_reduce(part, splits, (long long)K * R * 2 * D,
                               dk + (long long)l * K * R * 2 * D, s))
        != cudaSuccess)
      return static_cast<int>(e);

    DxP<T> x;
    x.M = rows; x.N = R; x.K = K * 2 * D; x.kchunk = K * 2 * D;
    x.dpre = dpre; x.kern = kern + (long long)l * K * R * 2 * D;
    x.dx = dx; x.dx16 = dx16;
    x.T_ = T_; x.R = R; x.D = D; x.KS = K; x.d = d; x.start = start;
    if ((e = tg::launch_gemm<T, true, true>(x, 1, s)) != cudaSuccess)
      return static_cast<int>(e);
  }
  return 0;
}

}  // namespace

// The floats of scratch (part) train_stack_bwd needs; the caller sizes part
// with this, so the row blocking is known to this file alone.
extern "C" long long train_stack_bwd_part_floats(int K, int R, int D, int S,
                                                 int B, int T) {
  long long width = (long long)K * R * 2 * D;
  if ((long long)D * (S + R) > width) width = (long long)D * (S + R);
  if (R > width) width = R;
  return tg::ceil_div(B * T, ROW_CHUNK) * width;
}

// dtype 0 = float32, 1 = bfloat16.  dxout may be null (the stack's
// residual output is not used: dX_L = 0); dx and dx16 are set here; part
// holds train_stack_bwd_part_floats(K, R, D, S, B, T) floats.
extern "C" int train_stack_bwd(int dtype, int L, int K, int R, int D, int S,
                               int B, int T, int FR, int start,
                               const int* dils, const void* rsk,
                               const void* kern, const void* dskip,
                               const void* act, const void* xs,
                               const void* dxout, void* dk, void* dskrs,
                               void* drb, void* dlc, void* dx16, void* dx,
                               void* dpre, void* part, int sigmoid_first,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return run<bf16>(L, K, R, D, S, B, T, FR, start, dils,
                     static_cast<const bf16*>(rsk),
                     static_cast<const bf16*>(kern),
                     static_cast<const bf16*>(dskip),
                     static_cast<const bf16*>(act),
                     static_cast<const bf16*>(xs),
                     static_cast<const bf16*>(dxout), static_cast<float*>(dk),
                     static_cast<float*>(dskrs), static_cast<float*>(drb),
                     static_cast<float*>(dlc), static_cast<bf16*>(dx16),
                     static_cast<float*>(dx), static_cast<bf16*>(dpre),
                     static_cast<float*>(part), sigmoid_first != 0, s);
  return run<float>(L, K, R, D, S, B, T, FR, start, dils,
                    static_cast<const float*>(rsk),
                    static_cast<const float*>(kern),
                    static_cast<const float*>(dskip),
                    static_cast<const float*>(act),
                    static_cast<const float*>(xs),
                    static_cast<const float*>(dxout), static_cast<float*>(dk),
                    static_cast<float*>(dskrs), static_cast<float*>(drb),
                    static_cast<float*>(dlc), static_cast<float*>(dx16),
                    static_cast<float*>(dx), static_cast<float*>(dpre),
                    static_cast<float*>(part), sigmoid_first != 0, s);
}
