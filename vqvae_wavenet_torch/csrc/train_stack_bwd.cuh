// The per-layer pieces of the WaveNet training stack's backward, shared by
// train_stack_bwd.cu (the layer sweep with dk per layer, TPU kernel
// _make_bwd_sweep_kernel) and train_stack_bwd2.cu (the two-kernel form:
// the chain, then dk for every layer in one launch).  Every product is a
// problem for hopper_gemm.cuh's TMA ring (wgmma in bf16, FFMA in f32):
//
//   Dgated  K-major  dgated [rows, D] = [dX16 | dskip] . [resw^T ; skipw^T];
//           k runs over (operand, 64-channel tile), each box zero past its
//           operand's width.  The epilogue applies the gate derivative from
//           the saved (f, g), writes dpre = [da | db] [rows, 2D] and
//           gated = T(f*g) [rows, D], which dsk|drs then reads through TMA
//   Dskrs   MN-major dsk|drs [D, S+R] = gated^T . [dskip | dX16] over the
//           rows (split-K partials); an n-tile lies in one operand
//   Dk      MN-major dk [K*R, 2D] = sum_t xs[l][t - o_j]^T . dpre[t]
//           (split-K partials): the sweep's per layer, and
//           train_stack_bwd2.cu's for every layer in one launch
//   Dx      K-major  dX += sum_j dpre[t + o_j] . W_j^T, and dX16 = T(dX);
//           k runs over (tap, 64-column tile of 2D), the tap shift a TMA
//           row coordinate (rows past T arrive as zeros)
//   seed_dx dX, dX16 at the start of the walk
//
// and ``walk``, the reverse walk over the layers that launches them.  A
// row-GEMM tile (Dgated, Dx) is BM rows of one batch row (b, t0), so a tap
// shift never reaches into the next batch row.  Rounding points and the
// sequence-parallel ``start`` are described in train_stack_bwd.cu.
//
// What bounds the walk on the H100 (B=8 x 6,656, the shipped widths): the
// products, 3.77 TFLOP per step (~3.8 ms at the bf16 tensor-core peak),
// and beside them ~0.71 GB of traffic per layer in bf16 (dpre written
// once and read three times, dX's f32 read-modify-write, dskip read twice,
// gated written and read), ~21 GB per step, ~6.3 ms at 3.35 TB/s: once
// the products run near their rate, memory sets the pace.  Fusing those
// round trips is later work.  Measured times: train_stack_bwd.cu (the
// sweep) and train_stack_bwd2.cu (the chain).
#pragma once

#include "hopper_gemm.cuh"
#include "train_common.cuh"

namespace bwd {

using tg::bf16;

// the two mainloop layouts of each compute type
template <typename T> struct Cfgs;
template <> struct Cfgs<bf16> {
  using K = hg::Bf16KCfg;
  using MN = hg::Bf16Cfg;
};
template <> struct Cfgs<float> {
  using K = hg::F32KCfg;
  using MN = hg::F32Cfg;
};

using tg::st2;
using tg::Two;

// the (batch row, first time step) of a row-GEMM tile: blockIdx.z = b,
// blockIdx.y = tile of the batch row (no division in the epilogue)
template <class Cfg>
__device__ __forceinline__ void row_tile(int& b, int& t0) {
  b = blockIdx.z;
  t0 = blockIdx.y * Cfg::BM;
}

template <class C>
struct Dgated {
  using Cfg = C;
  using T = typename C::T;
  CUtensorMap dx16, dskip;   // [B][T][R], [B][T][S]
  CUtensorMap wr, ws;        // resw^T, skipw^T of every layer: [L][D][R],
                             // [L][D][S] (rows R+S apart)
  const T* act;              // act[l] [rows, 2D]
  T* dpre;                   // [rows, 2D]
  T* gated;                  // [rows, D]
  int l, T_, D, rt, kt, start;   // rt k-tiles of dX16, kt in all
  bool sigmoid_first;

  __device__ void k_range(int& it0, int& it1) const {
    int b, t0;
    row_tile<Cfg>(b, t0);
    it0 = 0;
    it1 = t0 + Cfg::BM <= start ? 0 : kt;   // rows before start: dpre = 0
  }
  __device__ void load(int it, uint32_t sA, uint32_t sB, uint32_t bar) const {
    int b, t0;
    row_tile<Cfg>(b, t0);
    const int n0 = blockIdx.x * Cfg::BN;
    const bool res = it < rt;
    const int k0 = (res ? it : it - rt) * Cfg::BK;
    hg::tma_load_4d(sA, res ? &dx16 : &dskip, bar, k0, t0, b, 0);
    hg::tma_load_4d(sB, res ? &wr : &ws, bar, k0, n0, l, 0);
  }
  // the factored gate derivative of one channel (train_pallas.py:876-893)
  __device__ void gate(float acc, float f, float g, float& da,
                       float& db) const {
    const float dg = tg::rnd<T>(acc);
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
  }
  // row m, column n of the output for the tile's (r, c); false outside
  __device__ bool at(int r, int c, long long& m, int& n, int& t) const {
    int b, t0;
    row_tile<Cfg>(b, t0);
    t = t0 + r;
    n = blockIdx.x * Cfg::BN + c;
    m = (long long)b * T_ + t;
    return t < T_ && n < D;                      // D even: n + 1 < D too
  }
  struct Pre {
    Two<T> f, g;
  };
  __device__ Pre fetch(int r, int c) const {
    Pre x{};
    long long m;
    int n, t;
    if (at(r, c, m, n, t)) {
      x.f.load(act + m * (2 * D) + n);
      x.g.load(act + m * (2 * D) + D + n);
    }
    return x;
  }
  __device__ void put(int r, int c, float v0, float v1, const Pre& x) const {
    long long m;
    int n, t;
    if (!at(r, c, m, n, t)) return;
    const float f0 = x.f.lo(), f1 = x.f.hi(), g0 = x.g.lo(), g1 = x.g.hi();
    st2(gated + m * D + n, f0 * g0, f1 * g1);
    T* o = dpre + m * (2 * D);
    if (t < start) {
      st2(o + n, 0.f, 0.f);
      st2(o + D + n, 0.f, 0.f);
      return;
    }
    float da0, db0, da1, db1;
    gate(v0, f0, g0, da0, db0);
    gate(v1, f1, g1, da1, db1);
    st2(o + n, da0, da1);
    st2(o + D + n, db0, db1);
  }
};

// dsk|drs: blockIdx.x = output tile (the first nts over dskip's S
// columns, the rest over dX16's R), blockIdx.y = tile of D, blockIdx.z =
// split of the rows; k-tile it = Cfg::BK rows t0.. of batch row b.
template <class C>
struct Dskrs {
  using Cfg = C;
  CUtensorMap gated;         // [B][T][D]
  CUtensorMap dskip, dx16;   // [B][T][S], [B][T][R]
  float* part;               // [splits][D][S+R]
  int D, S, R, tpb, row_tiles, chunk, nts;

  __device__ void k_range(int& it0, int& it1) const {
    it0 = blockIdx.z * chunk;
    it1 = min(row_tiles, it0 + chunk);
  }
  __device__ void load(int it, uint32_t sA, uint32_t sB, uint32_t bar) const {
    const int b = it / tpb, t0 = (it - b * tpb) * Cfg::BK;
    const bool skip = (int)blockIdx.x < nts;
    const int n0 = (skip ? blockIdx.x : blockIdx.x - nts) * Cfg::BN;
#pragma unroll
    for (int i = 0; i < Cfg::BM / Cfg::BOX; ++i)
      hg::tma_load_4d(sA + i * Cfg::BOX_BYTES, &gated, bar,
                      blockIdx.y * Cfg::BM + i * Cfg::BOX, t0, b, 0);
#pragma unroll
    for (int i = 0; i < Cfg::BN / Cfg::BOX; ++i)
      hg::tma_load_4d(sB + i * Cfg::BOX_BYTES, skip ? &dskip : &dx16, bar,
                      n0 + i * Cfg::BOX, t0, b, 0);
  }
  struct Pre {};
  __device__ Pre fetch(int, int) const { return {}; }
  __device__ void put(int r, int c, float v0, float v1, const Pre&) const {
    const bool skip = (int)blockIdx.x < nts;
    const int m = blockIdx.y * Cfg::BM + r;
    const int n = (skip ? blockIdx.x : blockIdx.x - nts) * Cfg::BN + c;
    if (m >= D || n >= (skip ? S : R)) return;     // widths even
    st2(part + ((long long)blockIdx.z * D + m) * (S + R) + (skip ? n : S + n),
        v0, v1);
  }
};

// dk for L layers and every tap: blockIdx.x = tile of 2D, blockIdx.y =
// tap j x channel tile, blockIdx.z = layer x row split.  k-tile it of a
// split is Cfg::BK rows t0 .. t0+BK-1 of batch row b (a tile never
// crosses a batch row); tap j's A box starts at row t0 - o_j - start of a
// map whose row 0 is time step ``start``, so TMA fills rows before start
// (the causal head, or a whole tap with o_j >= T) and past T with zeros.
template <class C>
struct Dk {
  using Cfg = C;
  CUtensorMap xs;       // xs [L][B][T - start][R], from row start
  CUtensorMap dpre;     // dpre [L][B][T][2D]
  const int* dils;      // [L] in device memory, or null: every layer dil
  float* part;          // [splits][L][K*R][2D]
  int L, K, R, N, tpb, row_tiles, chunk, ctiles, splits, dil, start;

  __device__ void k_range(int& it0, int& it1) const {
    it0 = (blockIdx.z % splits) * chunk;
    it1 = min(row_tiles, it0 + chunk);
  }
  __device__ void load(int it, uint32_t sA, uint32_t sB, uint32_t bar) const {
    const int l = blockIdx.z / splits;
    const int j = blockIdx.y / ctiles;
    const int c0 = (blockIdx.y - j * ctiles) * Cfg::BM;
    const int b = it / tpb, t0 = (it - b * tpb) * Cfg::BK;
    const int o = (K - 1 - j) * (dils ? dils[l] : dil);
#pragma unroll
    for (int i = 0; i < Cfg::BM / Cfg::BOX; ++i)
      hg::tma_load_4d(sA + i * Cfg::BOX_BYTES, &xs, bar, c0 + i * Cfg::BOX,
                      t0 - o - start, b, l);
#pragma unroll
    for (int i = 0; i < Cfg::BN / Cfg::BOX; ++i)
      hg::tma_load_4d(sB + i * Cfg::BOX_BYTES, &dpre, bar,
                      blockIdx.x * Cfg::BN + i * Cfg::BOX, t0, b, l);
  }
  struct Pre {};
  __device__ Pre fetch(int, int) const { return {}; }
  __device__ void put(int r, int c, float v0, float v1, const Pre&) const {
    const int l = blockIdx.z / splits, split = blockIdx.z % splits;
    const int j = blockIdx.y / ctiles;
    const int m = (blockIdx.y - j * ctiles) * Cfg::BM + r;
    const int n = blockIdx.x * Cfg::BN + c;
    if (m >= R || n >= N) return;                 // N even, so n + 1 < N too
    st2(part + (((long long)split * L + l) * K * R + (long long)j * R + m) *
                   N + n,
        v0, v1);
  }
};

template <class C>
struct Dx {
  using Cfg = C;
  using T = typename C::T;
  CUtensorMap dpre;     // [Ld][B][T][2D]: this layer's at coordinate dl
  CUtensorMap kern;     // kernel [L][K][R][2D]
  float* dx;            // [rows, R] f32, updated in place
  T* dx16;              // [rows, R]
  int l, dl, T_, R, KS, d, ft, start;   // ft k-tiles of 2D per tap

  __device__ void k_range(int& it0, int& it1) const {
    int b, t0;
    row_tile<Cfg>(b, t0);
    it0 = 0;
    it1 = t0 + Cfg::BM <= start ? 0 : KS * ft;    // rows before start: nothing
  }
  __device__ void load(int it, uint32_t sA, uint32_t sB, uint32_t bar) const {
    int b, t0;
    row_tile<Cfg>(b, t0);
    const int j = it / ft, f0 = (it - j * ft) * Cfg::BK;
    const int o = (KS - 1 - j) * d;
    hg::tma_load_4d(sA, &dpre, bar, f0, t0 + o, b, dl);
    hg::tma_load_4d(sB, &kern, bar, f0, blockIdx.x * Cfg::BN, j, l);
  }
  // element i of dx for the tile's (r, c); false outside, and on rows
  // before start (they get nothing: their dX stays zero)
  __device__ bool at(int r, int c, long long& i) const {
    int b, t0;
    row_tile<Cfg>(b, t0);
    const int t = t0 + r;
    const int n = blockIdx.x * Cfg::BN + c;
    i = ((long long)b * T_ + t) * R + n;
    return t < T_ && t >= start && n < R;
  }
  struct Pre {
    float2 d;
  };
  __device__ Pre fetch(int r, int c) const {
    Pre x{};
    long long i;
    if (at(r, c, i)) x.d = *reinterpret_cast<const float2*>(dx + i);
    return x;
  }
  __device__ void put(int r, int c, float v0, float v1, const Pre& x) const {
    long long i;
    if (!at(r, c, i)) return;
    const float a = x.d.x + v0, e = x.d.y + v1;
    st2(dx + i, a, e);
    st2(dx16 + i, a, e);
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

constexpr int ROW_CHUNK = 256;    // rows per split of drb's column sums
using tg::fill_splits;

template <class MC> struct Splits {
  int row_tiles, sk_tiles, sk, dk_tiles, dk;
  Splits(int K, int R, int D, int S, int B, int T) {
    row_tiles = B * tg::ceil_div(T, MC::BK);
    sk_tiles = tg::ceil_div(D, MC::BM) *
               (tg::ceil_div(S, MC::BN) + tg::ceil_div(R, MC::BN));
    sk = fill_splits(sk_tiles, row_tiles);
    dk_tiles = tg::ceil_div(2 * D, MC::BN) * K * tg::ceil_div(R, MC::BM);
    dk = fill_splits(dk_tiles, row_tiles);
  }
};

// The floats of scratch walk needs: gated [rows, D] (room for f32), then
// the largest set of split partials (dk's only with dk), for either dtype.
inline long long gated_floats(int B, int T, int D) {
  return ((long long)B * T * D + 63) / 64 * 64;
}

inline long long walk_part_floats(int K, int R, int D, int S, int B, int T,
                                  bool with_dk) {
  const Splits<hg::Bf16Cfg> a(K, R, D, S, B, T);
  const Splits<hg::F32Cfg> f(K, R, D, S, B, T);
  const long long need[5] = {
      (long long)tg::ceil_div((long long)B * T, ROW_CHUNK) * R,
      (long long)a.sk * D * (S + R), (long long)f.sk * D * (S + R),
      with_dk ? (long long)a.dk * K * R * 2 * D : 0ll,
      with_dk ? (long long)f.dk * K * R * 2 * D : 0ll};
  long long width = 0;
  for (long long v : need)
    if (v > width) width = v;
  return gated_floats(B, T, D) + width;
}

#define BWD_TRY(x)                                  \
  do {                                              \
    const cudaError_t e_ = (x);                     \
    if (e_ != cudaSuccess) return static_cast<int>(e_); \
  } while (0)

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
  using KC = typename Cfgs<T>::K;
  using MC = typename Cfgs<T>::MN;
  const int rows = B * T_;
  const int F = T_ / FR;
  const int Ld = dk ? 1 : L;                // layers the dpre buffer holds
  T* gated = reinterpret_cast<T*>(part);
  float* psum = part + gated_floats(B, T_, D);
  const Splits<MC> sp(K, R, D, S, B, T_);
  const int tpb = tg::ceil_div(T_, KC::BM);
  const long long n = (long long)rows * R;
  seed_dx<T><<<(unsigned)((n + 255) / 256), 256, 0, s>>>(dxout, n, T_, R,
                                                           start, dx, dx16);
  BWD_TRY(cudaGetLastError());

  Dgated<KC> g;
  BWD_TRY(hg::encode_k<KC>(&g.dx16, dx16, hg::dense(R, T_, B, 1), KC::BM));
  BWD_TRY(hg::encode_k<KC>(&g.dskip, dskip, hg::dense(S, T_, B, 1), KC::BM));
  const long long rs = R + S;
  BWD_TRY(hg::encode_k<KC>(&g.wr, rsk, hg::View{{R, D, L, 1},
                                                 {rs, D * rs, L * D * rs}},
                           KC::BN));
  BWD_TRY(hg::encode_k<KC>(&g.ws, rsk + R, hg::View{{S, D, L, 1},
                                                     {rs, D * rs, L * D * rs}},
                           KC::BN));
  g.gated = gated;
  g.T_ = T_; g.D = D; g.start = start;
  g.rt = tg::ceil_div(R, KC::BK);
  g.kt = g.rt + tg::ceil_div(S, KC::BK);
  g.sigmoid_first = sigmoid_first;
  const dim3 g_grid(tg::ceil_div(D, KC::BN), tpb, B);

  Dskrs<MC> q;
  BWD_TRY(hg::encode_mn<MC>(&q.gated, gated, hg::dense(D, T_, B, 1)));
  BWD_TRY(hg::encode_mn<MC>(&q.dskip, dskip, hg::dense(S, T_, B, 1)));
  BWD_TRY(hg::encode_mn<MC>(&q.dx16, dx16, hg::dense(R, T_, B, 1)));
  q.part = psum;
  q.D = D; q.S = S; q.R = R;
  q.tpb = tg::ceil_div(T_, MC::BK);
  q.row_tiles = sp.row_tiles;
  q.chunk = tg::ceil_div(sp.row_tiles, sp.sk);
  q.nts = tg::ceil_div(S, MC::BN);
  const dim3 q_grid(q.nts + tg::ceil_div(R, MC::BN), tg::ceil_div(D, MC::BM),
                    sp.sk);

  Dk<MC> k;
  k.dils = nullptr; k.part = psum;
  k.L = 1; k.K = K; k.R = R; k.N = 2 * D; k.start = start;
  k.tpb = q.tpb;
  k.row_tiles = sp.row_tiles;
  k.splits = sp.dk;
  k.chunk = tg::ceil_div(sp.row_tiles, sp.dk);
  k.ctiles = tg::ceil_div(R, MC::BM);
  if (dk)
    BWD_TRY(hg::encode_mn<MC>(&k.dpre, dpre, hg::dense(2 * D, T_, B, 1)));
  const dim3 k_grid(tg::ceil_div(2 * D, MC::BN), K * k.ctiles, sp.dk);

  Dx<KC> x;
  BWD_TRY(hg::encode_k<KC>(&x.dpre, dpre, hg::dense(2 * D, T_, B, Ld),
                           KC::BM));
  BWD_TRY(hg::encode_k<KC>(&x.kern, kern, hg::dense(2 * D, R, K, L), KC::BN));
  x.dx = dx; x.dx16 = dx16;
  x.T_ = T_; x.R = R; x.KS = K; x.start = start;
  x.ft = tg::ceil_div(2 * D, KC::BK);
  const dim3 x_grid(tg::ceil_div(R, KC::BN), tpb, B);

  for (int l = L - 1; l >= 0; --l) {
    T* dpre_l = dk ? dpre : dpre + (long long)l * rows * 2 * D;

    g.l = l;
    g.act = act + (long long)l * rows * 2 * D;
    g.dpre = dpre_l;
    BWD_TRY(hg::launch(g, g_grid, s));

    BWD_TRY(hg::launch(q, q_grid, s));
    BWD_TRY(tg::launch_reduce(psum, sp.sk, (long long)D * (S + R),
                              dskrs + (long long)l * D * (S + R), s));

    tg::col_partials<<<dim3(tg::ceil_div(R, 256), tg::ceil_div(rows,
                                                                ROW_CHUNK)),
                       256, 0, s>>>(dx, rows, R, ROW_CHUNK, psum);
    BWD_TRY(cudaGetLastError());
    BWD_TRY(tg::launch_reduce(psum, tg::ceil_div(rows, ROW_CHUNK), R,
                              drb + (long long)l * R, s));

    BWD_TRY(tg::launch_frame_sum<T>(dpre_l, B, T_, FR, 2 * D,
                                    dlc + (long long)l * F * B * 2 * D, s));

    if (dk) {
      // this layer's xs seen from row start: rows t - o_j < start are
      // negative coordinates and load zeros
      BWD_TRY(hg::encode_mn<MC>(
          &k.xs, xs + (long long)l * rows * R + (long long)start * R,
          hg::View{{R, T_ - start > 0 ? T_ - start : 1, B, 1},
                   {R, (long long)T_ * R, (long long)rows * R}}));
      k.dil = dils[l];
      BWD_TRY(hg::launch(k, k_grid, s));
      BWD_TRY(tg::launch_reduce(psum, sp.dk, (long long)K * R * 2 * D,
                                dk + (long long)l * K * R * 2 * D, s));
    }

    x.l = l;
    x.dl = dk ? 0 : l;
    x.d = dils[l];
    BWD_TRY(hg::launch(x, x_grid, s));
  }
  return 0;
}

}  // namespace bwd
