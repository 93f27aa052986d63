// WaveNet loss head (postprocess heads + mean sparse softmax cross
// entropy), forward and backward.
//
// Replaces vqvae_wavenet_tpu/ops/train_pallas.py::_make_epilogue (the
// Pallas kernel pair launched at train_pallas.py:1981 (fwd) and :2008
// (bwd)).  Rows are the B*T samples; the frame condition enc2 [F, B, S]
// (postprocess1's condition projection + bias, folded outside) is added
// per row.
//
// Forward (train_pallas.py:1909-1940), compute type T:
//   sk   [N, S] = T(relu(skip))            one elementwise pass; saved for
//                                          the backward (TMA cannot apply
//                                          relu or round f32 to bf16)
//   h1   [N, S] = sk . W1                  epilogue: + enc2[t/FR, b],
//                                          a1 = T(relu(h1)) (saved)
//   h2   [N, Q] = a1 . W2                  epilogue, one block owning whole
//                                          rows: + b2, the row's max,
//                                          sum of exp, probs = T(softmax)
//                                          (saved), nll = lse -
//                                          logit[label]; each block sums
//                                          its rows' nll in row order,
//                                          then a fixed-order final sum.
//                                          The logits never reach memory.
// Backward (train_pallas.py:1942-1978), g = the loss's cotangent:
//   dlogits = (probs - onehot) * g / N      (f32; db2 = its column sums,
//                                            T(dlogits) feeds the products)
//   dW2  [S, Q] = a1^T . T(dlogits)         (split-K over rows)
//   da1  [N, S] = T(dlogits) . W2^T         epilogue: dh1 = [a1 > 0] da1
//                                           written as T(dh1); the tile's
//                                           column sums of each frame's
//                                           rows of the f32 dh1 give
//                                           dlc2 [F, B, S] (below)
//   dW1  [S, S] = sk^T . T(dh1)             (split-K over rows)
//   dskip [N, S] = T([skip > 0] (T(dh1) . W1^T))   (the mask on f32 skip)
//
// What bounds it on the H100: at the shipped training shape (N = 53,248,
// S = 512, Q = 256) the forward is 42 GFLOP over ~0.19 GB (bytes bind in
// bf16: ~57 us) and the backward 84 GFLOP over ~0.25 GB (~85 us, products
// bind in bf16).
//
// The design: every product runs on hopper_gemm.cuh's TMA ring (wgmma in
// bf16, FFMA in f32).  The row products (h1, h2, da1, dskip) are K-major:
// a tile is BM rows of one batch row (blockIdx.z = b), so a tile never
// straddles a batch row.  Frames of any FR rows dividing T: h1 finds a
// row's frame t / FR by a float reciprocal and an exact correction, one
// path for every FR; da1's tile sums each frame segment it holds (its
// rows of one frame, in row order), writes the sum of a frame that lies
// whole in the tile straight to dlc2 and the sums of the frames cut by
// the tile's edges (at most its first and last segment) to a scratch, and
// a second pass adds each cut frame's segments in tile order (dlc2_join).  When FR divides BM = 128, as Encoder_64's
// 64-row frames do, no frame is cut, the second pass has no work and is
// not launched, and every sum is the former per-tile sum bit for bit;
// Encoder_2019's 320-row frames are all cut.  h2 takes the 256-column
// K-major tile (Bf16KWCfg / F32KWCfg), so for Q <= 256 its block holds a
// whole row of logits in the staged C tile and runs the softmax there;
// past 256 classes the blocks walk 256-column chunks, a statistics pass
// (each chunk's max and sum of exp), a join of the chunks per row and a
// second pass that recomputes the chunk's logits for the probs (Head).
// The weight gradients are MN-major (the
// dk layout) with split counts that fill one wave and a fixed-order sum
// of the partials.  Nothing sums with atomics: a run repeats bit for bit.
//
// Measured (chip_smoke.py [train-epilogue], NVIDIA H100 80GB HBM3, 700 W,
// B=8 x 6656): bf16 forward 0.265 ms, backward 0.370 (the mma.sync tile
// loop with the f32 logits and dh1 in memory before: 0.661, 1.525); f32
// 1.270, 2.181.  Per kernel (bf16, us): H1 92, Head 81 (its softmax
// epilogue, run after the mainloop, is most of it), relu_round 52 (the
// bytes' pace); Dskip 110, Da1 84, Dw 42 each.  The row products take
// about mainloop plus epilogue, as the stack's do (hopper_gemm.cuh).
// At Encoder_2019's frames (chip_smoke.py [encoders], B=8 x 6400, FR=320,
// bf16, same card): forward 0.252-0.254 ms, backward 0.356-0.357, beside
// 0.258-0.263 / 0.360 at FR=64 in the same run.
//
// C interface (ctypes): pointers and the stream as void*, returns
// cudaGetLastError() of the first failing launch (0 on success).

#include "hopper_gemm.cuh"
#include "train_common.cuh"

namespace {

using tg::bf16;
using tg::st2;
using tg::Two;

// the mainloop layouts of each compute type: K for the row products, KW
// for the softmax's whole-row tile, MN for the weight gradients
template <typename T> struct Cfgs;
template <> struct Cfgs<bf16> {
  using K = hg::Bf16KCfg;
  using KW = hg::Bf16KWCfg;
  using MN = hg::Bf16Cfg;
};
template <> struct Cfgs<float> {
  using K = hg::F32KCfg;
  using KW = hg::F32KWCfg;
  using MN = hg::F32Cfg;
};

constexpr int CHUNK = 256;          // classes of the softmax tile
constexpr int DL_ROWS = 64;         // rows per block of the dlogits pass

// the (batch row, first time step) of a row-product tile
template <class Cfg>
__device__ __forceinline__ void row_tile(int& b, int& t0) {
  b = blockIdx.z;
  t0 = blockIdx.y * Cfg::BM;
}

// eight values stored in the compute type as one or two 16-byte stores
__device__ __forceinline__ void st8(float* o, const float (&v)[8]) {
  reinterpret_cast<float4*>(o)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(o)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void st8(bf16* o, const float (&v)[8]) {
  __nv_bfloat162 h[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(o) = *reinterpret_cast<const uint4*>(h);
}

// sk = T(relu(skip)), eight values a thread
template <typename T>
__global__ void relu_round(const float* __restrict__ skip, long long n8,
                           T* __restrict__ sk) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n8) return;
  const float4 a = reinterpret_cast<const float4*>(skip)[2 * i];
  const float4 b = reinterpret_cast<const float4*>(skip)[2 * i + 1];
  const float v[8] = {fmaxf(a.x, 0.f), fmaxf(a.y, 0.f), fmaxf(a.z, 0.f),
                      fmaxf(a.w, 0.f), fmaxf(b.x, 0.f), fmaxf(b.y, 0.f),
                      fmaxf(b.z, 0.f), fmaxf(b.w, 0.f)};
  st8(sk + 8 * i, v);
}

// h1 = sk . W1 + enc2, a1 = T(relu(h1))
template <class Cf>
struct H1 {
  using Cfg = Cf;
  using T = typename Cf::T;
  CUtensorMap sk;       // [B][T][S]
  CUtensorMap w;        // W1^T [S][S]
  const float* enc2;    // [F, B, S]
  T* a1;                // [rows, S]
  int T_, S, B, FR, kt;
  float inv_fr;         // 1 / FR

  __device__ void k_range(int& it0, int& it1) const {
    it0 = 0;
    it1 = kt;
  }
  __device__ void load(int it, uint32_t sA, uint32_t sB, uint32_t bar) const {
    int b, t0;
    row_tile<Cfg>(b, t0);
    hg::tma_load_4d(sA, &sk, bar, it * Cfg::BK, t0, b, 0);
    hg::tma_load_4d(sB, &w, bar, it * Cfg::BK, blockIdx.x * Cfg::BN, 0, 0);
  }
  __device__ bool at(int r, int c, int& b, int& t, int& n) const {
    int t0;
    row_tile<Cfg>(b, t0);
    t = t0 + r;
    n = blockIdx.x * Cfg::BN + c;
    return t < T_ && n < S;                 // S even: n + 1 < S too
  }
  struct Pre {
    float2 e;
  };
  __device__ Pre fetch(int r, int c) const {
    Pre p{};
    int b, t, n;
    if (at(r, c, b, t, n)) {
      // t / FR without an integer division: the float quotient is off by
      // at most one (t < 2^24), then corrected
      int f = __float2int_rz((float)t * inv_fr);
      f -= f * FR > t;
      f += (f + 1) * FR <= t;
      p.e = *reinterpret_cast<const float2*>(
          enc2 + ((long long)f * B + b) * S + n);
    }
    return p;
  }
  __device__ void put(int r, int c, float v0, float v1, const Pre& p) const {
    int b, t, n;
    if (!at(r, c, b, t, n)) return;
    st2(a1 + ((long long)b * T_ + t) * S + n, fmaxf(v0 + p.e.x, 0.f),
        fmaxf(v1 + p.e.y, 0.f));
  }
};

// logits = a1 . W2 + b2 and the softmax of each row, in the C tile of a
// block that holds BN = 256 columns of its rows.  MODE WHOLE (Q <= 256):
// the block holds whole rows and writes probs and its rows' nll sum.  For
// Q > 256 the classes are walked in 256-column chunks (blockIdx.x = the
// chunk) twice: MODE STATS writes each row's chunk max and sum of exp
// (relative to that max) and, from the chunk holding the label, the picked
// logit; softmax_join then joins the chunks' statistics into the row's max
// M and sum S (and its nll); MODE PROBS recomputes the chunk's logits and
// writes probs = T(exp(x - M) / S).  The logits never reach memory.
enum HeadMode { WHOLE = 0, STATS = 1, PROBS = 2 };

template <class Cf, int MODE>
struct Head {
  using Cfg = Cf;
  using T = typename Cf::T;
  CUtensorMap a1;       // [B][T][S]
  CUtensorMap w;        // W2^T [Q][S]
  const float* b2;      // [Q]
  const int* labels;    // [rows]
  T* probs;             // [rows, Q]
  float* part;          // WHOLE: [B * tiles of a batch row], each tile's nll
                        // sum; STATS: [rows][chunks] float2 (max, sum)
  float* picked;        // STATS: [rows], the label's logit
  const float* ms;      // PROBS: [rows] float2 (M, S)
  int T_, Q, kt;

  __device__ int col0() const { return MODE == WHOLE ? 0 : blockIdx.x * Cfg::BN; }
  __device__ void k_range(int& it0, int& it1) const {
    it0 = 0;
    it1 = kt;
  }
  __device__ void load(int it, uint32_t sA, uint32_t sB, uint32_t bar) const {
    int b, t0;
    row_tile<Cfg>(b, t0);
    hg::tma_load_4d(sA, &a1, bar, it * Cfg::BK, t0, b, 0);
    hg::tma_load_4d(sB, &w, bar, it * Cfg::BK, col0(), 0, 0);
  }
  // A quarter-warp owns a row: warp w takes rows w RW + i (i < RW), its
  // quarter-warp qw the rows i = 4 ii + qw, four consecutive rows at once;
  // lane l8 of the quarter holds the column pairs 2 l8 + 16 j (float2
  // reads of the staged tile: consecutive rows start 8 banks apart, so a
  // warp's read takes the least two wavefronts).  Max and sum are
  // butterflies over the quarter's 8 lanes (a fixed order).  The rows'
  // labels are loaded before the first row (lane i holds row w RW + i's),
  // and the picked logit comes from the lane holding it.  Rows past T
  // (zeros in the tile) are computed too, so every lane takes part in
  // every shuffle, and are stored nowhere.
  __device__ void tile(float* C) const {
    constexpr int PITCH = hg::c_pitch<Cfg>(), NJ = Cfg::BN / 16;
    constexpr int RW = Cfg::BM / 8;         // rows of a warp (<= 32)
    float* nll = C + Cfg::BM * PITCH;       // past the tile, in the ring
    int b, t0;
    row_tile<Cfg>(b, t0);
    const int q0 = col0();
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    const int qw = lane >> 3, l8 = lane & 7;
    float bias[2 * NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = q0 + 2 * l8 + 16 * j;
      const float2 v = c < Q ? *reinterpret_cast<const float2*>(b2 + c)
                             : make_float2(0.f, 0.f);
      bias[2 * j] = v.x;
      bias[2 * j + 1] = v.y;
    }
    const int lt = t0 + w * RW + lane;
    const bool lv = lane < RW && lt < T_;
    const int my_label = MODE != PROBS && lv ? labels[(long long)b * T_ + lt] - q0 : 0;
    float2 my_ms = make_float2(0.f, 1.f);
    if (MODE == PROBS && lv)
      my_ms = reinterpret_cast<const float2*>(ms)[(long long)b * T_ + lt];
#pragma unroll 1
    for (int ii = 0; ii < RW / 4; ++ii) {
      const int i = 4 * ii + qw, r = w * RW + i, t = t0 + r;
      const bool live = t < T_;
      const long long m = (long long)b * T_ + t;
      const float* row = C + r * PITCH;
      float x[2 * NJ];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float2 y = *reinterpret_cast<const float2*>(row + 2 * l8 + 16 * j);
        x[2 * j] = y.x + bias[2 * j];
        x[2 * j + 1] = y.y + bias[2 * j + 1];
      }
      if constexpr (MODE == PROBS) {
        const float mx = __shfl_sync(0xffffffffu, my_ms.x, i);
        const float se = __shfl_sync(0xffffffffu, my_ms.y, i);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int c = q0 + 2 * l8 + 16 * j;
          if (live && c < Q)
            st2(probs + m * Q + c, expf(x[2 * j] - mx) / se,
                expf(x[2 * j + 1] - mx) / se);
        }
        continue;
      }
      const int lab = __shfl_sync(0xffffffffu, my_label, i);
      float mx = -INFINITY, pick = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = q0 + 2 * l8 + 16 * j;
        if (c < Q) mx = fmaxf(mx, fmaxf(x[2 * j], x[2 * j + 1]));
        if (j == lab >> 4) pick = lab & 1 ? x[2 * j + 1] : x[2 * j];
      }
      pick = __shfl_sync(0xffffffffu, pick, (lane & 24) | ((lab & 15) >> 1));
#pragma unroll
      for (int o = 4; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      float se = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        if (q0 + 2 * l8 + 16 * j < Q) {
          x[2 * j] = expf(x[2 * j] - mx);
          x[2 * j + 1] = expf(x[2 * j + 1] - mx);
          se += x[2 * j];
          se += x[2 * j + 1];
        }
      }
#pragma unroll
      for (int o = 4; o > 0; o >>= 1)
        se += __shfl_xor_sync(0xffffffffu, se, o);
      if constexpr (MODE == STATS) {
        if (live && l8 == 0) {
          reinterpret_cast<float2*>(part)[m * gridDim.x + blockIdx.x] =
              make_float2(mx, se);
          if (0 <= lab && lab < Cfg::BN) picked[m] = pick;
        }
        continue;
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = 2 * l8 + 16 * j;
        if (live && c < Q)
          st2(probs + m * Q + c, x[2 * j] / se, x[2 * j + 1] / se);
      }
      if (l8 == 0) nll[r] = live ? (logf(se) + mx) - pick : 0.f;
    }
    if constexpr (MODE == WHOLE) {
      hg::consumers_sync();
      if (threadIdx.x < 32) {               // rows in order: lane l sums a
        constexpr int RL = Cfg::BM / 32;    // run of RL, then a butterfly
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < RL; ++i) s += nll[lane * RL + i];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
        if (lane == 0) part[(long long)b * gridDim.y + blockIdx.y] = s;
      }
    }
  }
};

// The chunks' statistics of each row joined in chunk order: M = the max of
// the chunk maxima, S = sum of s_c exp(m_c - M); ms[row] = (M, S), and
// nll[row] = log S + M - logit[label] (0 past T: rows = B * T exactly)
__global__ void softmax_join(const float2* __restrict__ st,
                             const float* __restrict__ pick, long long rows,
                             int chunks, float2* __restrict__ ms,
                             float* __restrict__ nll) {
  const long long m = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (m >= rows) return;
  const float2* s = st + m * chunks;
  float mx = -INFINITY;
  for (int c = 0; c < chunks; ++c) mx = fmaxf(mx, s[c].x);
  float se = 0.f;
  for (int c = 0; c < chunks; ++c) se += s[c].y * expf(s[c].x - mx);
  ms[m] = make_float2(mx, se);
  nll[m] = (logf(se) + mx) - pick[m];
}

// dlogits, a thread per column q (per Q / blockDim.x columns past 1,024
// classes), DL_ROWS rows per block: writes T(dlogits) and the block's f32
// column sums (for db2)
template <typename T>
__global__ void dlogits_rows(const T* __restrict__ probs,
                             const int* __restrict__ labels,
                             const float* __restrict__ g, int rows, int Q,
                             T* __restrict__ dl, float* __restrict__ part) {
  const float scale = g[0] / (float)rows;
  const int r0 = (int)blockIdx.x * DL_ROWS;
  const int r1 = min(rows, r0 + DL_ROWS);
  for (int q = threadIdx.x; q < Q; q += blockDim.x) {
    float s = 0.f;
    for (int r = r0; r < r1; ++r) {
      const long long i = (long long)r * Q + q;
      const float v = (tg::to_f(probs[i]) - (labels[r] == q ? 1.f : 0.f))
                      * scale;
      dl[i] = tg::from_f<T>(v);
      s += v;
    }
    part[(long long)blockIdx.x * Q + q] = s;
  }
}

// a weight gradient part[split] [M, N] = sum over the split's rows of
// a[row]^T b[row]: blockIdx.x = tile of N, blockIdx.y = tile of M,
// blockIdx.z = split; k-tile it = Cfg::BK rows t0.. of batch row bb
template <class Cf>
struct Dw {
  using Cfg = Cf;
  CUtensorMap a, b;     // [B][T][M], [B][T][N]
  float* part;          // [splits][M][N]
  int M, N, tpb, row_tiles, chunk;

  __device__ void k_range(int& it0, int& it1) const {
    it0 = blockIdx.z * chunk;
    it1 = min(row_tiles, it0 + chunk);
  }
  __device__ void load(int it, uint32_t sA, uint32_t sB, uint32_t bar) const {
    const int bb = it / tpb, t0 = (it - bb * tpb) * Cfg::BK;
#pragma unroll
    for (int i = 0; i < Cfg::BM / Cfg::BOX; ++i)
      hg::tma_load_4d(sA + i * Cfg::BOX_BYTES, &a, bar,
                      blockIdx.y * Cfg::BM + i * Cfg::BOX, t0, bb, 0);
#pragma unroll
    for (int i = 0; i < Cfg::BN / Cfg::BOX; ++i)
      hg::tma_load_4d(sB + i * Cfg::BOX_BYTES, &b, bar,
                      blockIdx.x * Cfg::BN + i * Cfg::BOX, t0, bb, 0);
  }
  struct Pre {};
  __device__ Pre fetch(int, int) const { return {}; }
  __device__ void put(int r, int c, float v0, float v1, const Pre&) const {
    const int m = blockIdx.y * Cfg::BM + r;
    const int n = blockIdx.x * Cfg::BN + c;
    if (m >= M || n >= N) return;           // N even: n + 1 < N too
    st2(part + ((long long)blockIdx.z * M + m) * N + n, v0, v1);
  }
};

// da1 = T(dl) . W2^T; dh1 = [a1 > 0] da1 -> T(dh1), and the column sums
// of the f32 dh1 over each frame segment the tile holds: a whole frame's
// to dlc2, a cut frame's to seg (slot 0: the tile's first segment, slot
// 1: its last), which dlc2_join adds up
template <class Cf>
struct Da1 {
  using Cfg = Cf;
  using T = typename Cf::T;
  CUtensorMap dl;       // [B][T][Q]
  CUtensorMap w;        // W2 [S][Q]
  const T* a1;          // [rows, S]
  T* dh16;              // [rows, S]
  float* dlc2;          // [F, B, S]
  float* seg;           // [B][row tiles][2][S]
  int T_, S, B, FR, kt;

  __device__ void k_range(int& it0, int& it1) const {
    it0 = 0;
    it1 = kt;
  }
  __device__ void load(int it, uint32_t sA, uint32_t sB, uint32_t bar) const {
    int b, t0;
    row_tile<Cfg>(b, t0);
    hg::tma_load_4d(sA, &dl, bar, it * Cfg::BK, t0, b, 0);
    hg::tma_load_4d(sB, &w, bar, it * Cfg::BK, blockIdx.x * Cfg::BN, 0, 0);
  }
  // Pass 1, pair by pair (a group of G a1 loads in flight before any
  // store): the masked f32 dh1 goes back into the tile and T(dh1) to
  // memory.  Pass 2: thread per (frame segment, column), its rows in
  // order.
  __device__ void tile(float* C) const {
    constexpr int PITCH = hg::c_pitch<Cfg>(), PAIRS = Cfg::BN / 2;
    constexpr int TOTAL = Cfg::BM * PAIRS, G = 8;
    static_assert(TOTAL % (hg::NCONS * G) == 0, "tile");
    int b, t0;
    row_tile<Cfg>(b, t0);
    const int n0 = blockIdx.x * Cfg::BN;
#pragma unroll 1
    for (int i0 = threadIdx.x; i0 < TOTAL; i0 += hg::NCONS * G) {
      Two<T> a[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int i = i0 + g * hg::NCONS, r = i / PAIRS, c = 2 * (i % PAIRS);
        if (t0 + r < T_ && n0 + c < S)
          a[g].load(a1 + ((long long)b * T_ + t0 + r) * S + n0 + c);
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int i = i0 + g * hg::NCONS, r = i / PAIRS, c = 2 * (i % PAIRS);
        float2* p = reinterpret_cast<float2*>(C + r * PITCH + c);
        float h0 = 0.f, h1 = 0.f;
        if (t0 + r < T_ && n0 + c < S) {
          const float2 v = *p;
          h0 = a[g].lo() > 0.f ? v.x : 0.f;
          h1 = a[g].hi() > 0.f ? v.y : 0.f;
          st2(dh16 + ((long long)b * T_ + t0 + r) * S + n0 + c, h0, h1);
        }
        *p = make_float2(h0, h1);
      }
    }
    hg::consumers_sync();
    const int rows = min(Cfg::BM, T_ - t0);
    const int f0 = t0 / FR, nseg = (t0 + rows - 1) / FR - f0 + 1;
#pragma unroll 1
    for (int i = threadIdx.x; i < nseg * Cfg::BN; i += hg::NCONS) {
      const int sg = i / Cfg::BN, c = i - sg * Cfg::BN;
      if (n0 + c >= S) continue;
      const int f = f0 + sg;
      const int lo = f * FR - t0, hi = lo + FR;  // the frame's rows, tile-relative
      const int r0 = max(lo, 0), r1 = min(hi, rows);
      const float* col = C + c;
      float s = 0.f;
      for (int rr = r0; rr < r1; ++rr) s += col[rr * PITCH];
      if (r0 == lo && r1 == hi)
        dlc2[((long long)f * B + b) * S + n0 + c] = s;
      else
        seg[(((long long)b * gridDim.y + blockIdx.y) * 2 + (sg > 0)) * S
            + n0 + c] = s;
    }
  }
};

// dlc2 of the frames no tile holds whole: a thread per (frame, batch row,
// column) adds the frame's segments in tile order (Da1's seg slots: 0
// where the frame is the tile's first, else 1)
__global__ void dlc2_join(const float* __restrict__ seg, int B, int S, int F,
                          int FR, int BM, int tiles, float* __restrict__ dlc2) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= (long long)F * B * S) return;
  const int n = (int)(i % S), fb = (int)(i / S);
  const int b = fb % B, f = fb / B;
  const int j0 = f * FR / BM, j1 = ((f + 1) * FR - 1) / BM;
  if (j0 == j1) return;                     // whole in one tile: Da1 wrote it
  float s = 0.f;
  for (int j = j0; j <= j1; ++j)
    s += seg[(((long long)b * tiles + j) * 2 + (j * BM / FR != f)) * S + n];
  dlc2[i] = s;
}

// dskip = T([skip > 0] (T(dh1) . W1^T))
template <class Cf>
struct Dskip {
  using Cfg = Cf;
  using T = typename Cf::T;
  CUtensorMap dh;       // T(dh1) [B][T][S]
  CUtensorMap w;        // W1 [S][S]
  const float* skip;    // [rows, S] f32
  T* dskip;             // [rows, S]
  int T_, S, kt;

  __device__ void k_range(int& it0, int& it1) const {
    it0 = 0;
    it1 = kt;
  }
  __device__ void load(int it, uint32_t sA, uint32_t sB, uint32_t bar) const {
    int b, t0;
    row_tile<Cfg>(b, t0);
    hg::tma_load_4d(sA, &dh, bar, it * Cfg::BK, t0, b, 0);
    hg::tma_load_4d(sB, &w, bar, it * Cfg::BK, blockIdx.x * Cfg::BN, 0, 0);
  }
  __device__ bool at(int r, int c, long long& i) const {
    int b, t0;
    row_tile<Cfg>(b, t0);
    const int n = blockIdx.x * Cfg::BN + c;
    i = ((long long)b * T_ + t0 + r) * S + n;
    return t0 + r < T_ && n < S;
  }
  struct Pre {
    float2 s;
  };
  __device__ Pre fetch(int r, int c) const {
    Pre p{};
    long long i;
    if (at(r, c, i)) p.s = *reinterpret_cast<const float2*>(skip + i);
    return p;
  }
  __device__ void put(int r, int c, float v0, float v1, const Pre& p) const {
    long long i;
    if (!at(r, c, i)) return;
    st2(dskip + i, p.s.x > 0.f ? v0 : 0.f, p.s.y > 0.f ? v1 : 0.f);
  }
};

#define EPI_TRY(x)                                      \
  do {                                                  \
    const cudaError_t e_ = (x);                         \
    if (e_ != cudaSuccess) return static_cast<int>(e_); \
  } while (0)

// frames of FR rows tiling each batch row
inline bool frames_fit(int T, int FR) { return FR >= 1 && T % FR == 0; }

// the floats of Da1's segment scratch: two slots per row tile and column
inline long long seg_floats(int B, int T, int S) {
  return 2LL * B * tg::ceil_div(T, hg::Bf16KCfg::BM) * S;
}

// The splits of a weight gradient [M, N] over the rows, and the floats of
// their partials
template <class MC> struct DwSplits {
  int row_tiles, splits;
  DwSplits(int M, int N, int B, int T) {
    row_tiles = B * tg::ceil_div(T, MC::BK);
    splits = tg::fill_splits(tg::ceil_div(M, MC::BM) * tg::ceil_div(N, MC::BN),
                             row_tiles);
  }
  static long long floats(int M, int N, int B, int T) {
    return (long long)DwSplits(M, N, B, T).splits * M * N;
  }
};

// h1's launch
template <class KC, typename T>
cudaError_t launch_h1(const T* sk, const T* w1t, const float* enc2, T* a1,
                      int B, int T_, int S, int FR, cudaStream_t s) {
  H1<KC> h;
  cudaError_t e = hg::encode_k<KC>(&h.sk, sk, hg::dense(S, T_, B, 1), KC::BM);
  if (e == cudaSuccess)
    e = hg::encode_k<KC>(&h.w, w1t, hg::dense(S, S, 1, 1), KC::BN);
  if (e != cudaSuccess) return e;
  h.enc2 = enc2; h.a1 = a1;
  h.T_ = T_; h.S = S; h.B = B; h.FR = FR;
  h.inv_fr = 1.f / (float)FR;
  h.kt = tg::ceil_div(S, KC::BK);
  return hg::launch(h, dim3(tg::ceil_div(S, KC::BN), tg::ceil_div(T_, KC::BM),
                            B), s);
}

// the float2 statistics, picked logits, (M, S) and nll of the chunked
// head: floats of fwd's scratch past 256 classes
inline long long chunked_floats(int B, int T, int Q) {
  const long long rows = (long long)B * T;
  return rows * (2LL * tg::ceil_div(Q, CHUNK) + 4);
}

template <class WC, int MODE>
Head<WC, MODE> head(const typename WC::T* a1, const typename WC::T* w2t,
                    const float* b2, const int* labels, typename WC::T* probs,
                    int T_, int S, int Q, int B, cudaError_t& e) {
  Head<WC, MODE> o{};
  e = hg::encode_k<WC>(&o.a1, a1, hg::dense(S, T_, B, 1), WC::BM);
  if (e == cudaSuccess)
    e = hg::encode_k<WC>(&o.w, w2t, hg::dense(S, Q, 1, 1), WC::BN);
  o.b2 = b2; o.labels = labels; o.probs = probs;
  o.T_ = T_; o.Q = Q;
  o.kt = tg::ceil_div(S, WC::BK);
  return o;
}

template <typename T>
int fwd(int B, int T_, int FR, int S, int Q, const float* skip, const T* w1t,
        const T* w2t, const float* b2, const float* enc2, const int* labels,
        T* sk, T* a1, T* probs, float* part, float* total, cudaStream_t s) {
  using KC = typename Cfgs<T>::K;
  using WC = typename Cfgs<T>::KW;
  static_assert(WC::BN == CHUNK, "a chunk is the tile's columns");
  if (!frames_fit(T_, FR)) return static_cast<int>(cudaErrorInvalidValue);
  const long long n8 = (long long)B * T_ * S / 8;
  relu_round<T><<<(unsigned)((n8 + 255) / 256), 256, 0, s>>>(skip, n8, sk);
  EPI_TRY(cudaGetLastError());

  EPI_TRY(launch_h1<KC>(sk, w1t, enc2, a1, B, T_, S, FR, s));

  const int tpb = tg::ceil_div(T_, WC::BM);
  cudaError_t e;
  if (Q <= CHUNK) {
    Head<WC, WHOLE> o = head<WC, WHOLE>(a1, w2t, b2, labels, probs, T_, S, Q, B, e);
    EPI_TRY(e);
    o.part = part;
    EPI_TRY(hg::launch(o, dim3(1, tpb, B), s));
    tg::sum_all<<<1, 256, 0, s>>>(part, B * tpb, total);
    return static_cast<int>(cudaGetLastError());
  }
  // past 256 classes: statistics per chunk, their join, then the probs
  const int chunks = tg::ceil_div(Q, CHUNK);
  const long long rows = (long long)B * T_;
  float* st = part;                          // [rows][chunks] float2
  float* pk = st + 2 * rows * chunks;        // [rows]
  float* ms = pk + rows;                     // [rows] float2
  float* nll = ms + 2 * rows;                // [rows]
  Head<WC, STATS> o1 = head<WC, STATS>(a1, w2t, b2, labels, probs, T_, S, Q, B, e);
  EPI_TRY(e);
  o1.part = st; o1.picked = pk;
  EPI_TRY(hg::launch(o1, dim3(chunks, tpb, B), s));
  softmax_join<<<(unsigned)((rows + 255) / 256), 256, 0, s>>>(
      reinterpret_cast<const float2*>(st), pk, rows, chunks,
      reinterpret_cast<float2*>(ms), nll);
  EPI_TRY(cudaGetLastError());
  Head<WC, PROBS> o2 = head<WC, PROBS>(a1, w2t, b2, labels, probs, T_, S, Q, B, e);
  EPI_TRY(e);
  o2.ms = ms;
  EPI_TRY(hg::launch(o2, dim3(chunks, tpb, B), s));
  tg::sum_all<<<1, 256, 0, s>>>(nll, (int)rows, total);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int bwd(int B, int T_, int FR, int S, int Q, const float* g, const T* probs,
        const int* labels, const T* a1, const T* sk, const float* skip,
        const T* w1, const T* w2, T* dskip, float* dlc2, float* dw1,
        float* dw2, float* db2, T* dl, T* dh16, float* part, cudaStream_t s) {
  using KC = typename Cfgs<T>::K;
  using MC = typename Cfgs<T>::MN;
  static_assert(KC::BM == hg::Bf16KCfg::BM, "seg_floats counts these tiles");
  if (!frames_fit(T_, FR)) return static_cast<int>(cudaErrorInvalidValue);
  const int rows = B * T_;
  const int nblk = tg::ceil_div(rows, DL_ROWS);
  dlogits_rows<T><<<nblk, min(Q, 1024), 0, s>>>(probs, labels, g, rows, Q,
                                                dl, part);
  EPI_TRY(cudaGetLastError());
  EPI_TRY(tg::launch_reduce(part, nblk, Q, db2, s));

  const DwSplits<MC> s2(S, Q, B, T_);
  Dw<MC> w;
  EPI_TRY(hg::encode_mn<MC>(&w.a, a1, hg::dense(S, T_, B, 1)));
  EPI_TRY(hg::encode_mn<MC>(&w.b, dl, hg::dense(Q, T_, B, 1)));
  w.part = part;
  w.M = S; w.N = Q;
  w.tpb = tg::ceil_div(T_, MC::BK);
  w.row_tiles = s2.row_tiles;
  w.chunk = tg::ceil_div(s2.row_tiles, s2.splits);
  EPI_TRY(hg::launch(w, dim3(tg::ceil_div(Q, MC::BN), tg::ceil_div(S, MC::BM),
                             s2.splits), s));
  EPI_TRY(tg::launch_reduce(part, s2.splits, (long long)S * Q, dw2, s));

  Da1<KC> a;
  EPI_TRY(hg::encode_k<KC>(&a.dl, dl, hg::dense(Q, T_, B, 1), KC::BM));
  EPI_TRY(hg::encode_k<KC>(&a.w, w2, hg::dense(Q, S, 1, 1), KC::BN));
  a.a1 = a1; a.dh16 = dh16; a.dlc2 = dlc2; a.seg = part;
  a.T_ = T_; a.S = S; a.B = B; a.FR = FR;
  a.kt = tg::ceil_div(Q, KC::BK);
  const dim3 row_grid(tg::ceil_div(S, KC::BN), tg::ceil_div(T_, KC::BM), B);
  EPI_TRY(hg::launch(a, row_grid, s));
  if (KC::BM % FR) {                         // some frame is cut by a tile
    const long long n = (long long)(T_ / FR) * B * S;
    dlc2_join<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
        part, B, S, T_ / FR, FR, KC::BM, row_grid.y, dlc2);
    EPI_TRY(cudaGetLastError());
  }

  const DwSplits<MC> s1(S, S, B, T_);
  Dw<MC> v;
  EPI_TRY(hg::encode_mn<MC>(&v.a, sk, hg::dense(S, T_, B, 1)));
  EPI_TRY(hg::encode_mn<MC>(&v.b, dh16, hg::dense(S, T_, B, 1)));
  v.part = part;
  v.M = S; v.N = S;
  v.tpb = w.tpb;
  v.row_tiles = s1.row_tiles;
  v.chunk = tg::ceil_div(s1.row_tiles, s1.splits);
  EPI_TRY(hg::launch(v, dim3(tg::ceil_div(S, MC::BN), tg::ceil_div(S, MC::BM),
                             s1.splits), s));
  EPI_TRY(tg::launch_reduce(part, s1.splits, (long long)S * S, dw1, s));

  Dskip<KC> k;
  EPI_TRY(hg::encode_k<KC>(&k.dh, dh16, hg::dense(S, T_, B, 1), KC::BM));
  EPI_TRY(hg::encode_k<KC>(&k.w, w1, hg::dense(S, S, 1, 1), KC::BN));
  k.skip = skip; k.dskip = dskip;
  k.T_ = T_; k.S = S;
  k.kt = tg::ceil_div(S, KC::BK);
  EPI_TRY(hg::launch(k, row_grid, s));
  return 0;
}

}  // namespace

// The floats of scratch (part) each entry needs; the caller sizes part
// with these, so the row blocking is known to this file alone.
extern "C" long long train_epilogue_fwd_part_floats(int B, int T, int Q) {
  if (Q > CHUNK) return chunked_floats(B, T, Q);
  return (long long)B * tg::ceil_div(T, hg::F32KWCfg::BM);   // the smaller BM
}

extern "C" long long train_epilogue_bwd_part_floats(int B, int T, int S,
                                                    int Q) {
  const long long need[6] = {
      (long long)tg::ceil_div((long long)B * T, DL_ROWS) * Q,
      DwSplits<hg::Bf16Cfg>::floats(S, Q, B, T),
      DwSplits<hg::Bf16Cfg>::floats(S, S, B, T),
      DwSplits<hg::F32Cfg>::floats(S, Q, B, T),
      DwSplits<hg::F32Cfg>::floats(S, S, B, T),
      seg_floats(B, T, S)};
  long long most = 0;
  for (long long v : need)
    if (v > most) most = v;
  return most;
}

// dtype 0 = float32, 1 = bfloat16.  sk gets T(relu(skip)) [B*T, S] (the
// backward reads it); part holds train_epilogue_fwd_part_floats(B, T, Q)
// floats; total gets the summed NLL (the caller divides by B*T).
extern "C" int train_epilogue_fwd(int dtype, int B, int T, int FR, int S,
                                  int Q, const void* skip, const void* w1t,
                                  const void* w2t, const void* b2,
                                  const void* enc2, const void* labels,
                                  void* sk, void* a1, void* probs,
                                  void* part, void* total, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sp = static_cast<const float*>(skip);
  const float* bb = static_cast<const float*>(b2);
  const float* en = static_cast<const float*>(enc2);
  const int* lab = static_cast<const int*>(labels);
  float* pt = static_cast<float*>(part);
  float* tot = static_cast<float*>(total);
  if (dtype == 1)
    return fwd<bf16>(B, T, FR, S, Q, sp, static_cast<const bf16*>(w1t),
                     static_cast<const bf16*>(w2t), bb, en, lab,
                     static_cast<bf16*>(sk), static_cast<bf16*>(a1),
                     static_cast<bf16*>(probs), pt, tot, s);
  return fwd<float>(B, T, FR, S, Q, sp, static_cast<const float*>(w1t),
                    static_cast<const float*>(w2t), bb, en, lab,
                    static_cast<float*>(sk), static_cast<float*>(a1),
                    static_cast<float*>(probs), pt, tot, s);
}

// dl [B*T, Q] and dh16 [B*T, S] (compute type) are scratch; part holds
// train_epilogue_bwd_part_floats(B, T, S, Q) floats.
extern "C" int train_epilogue_bwd(int dtype, int B, int T, int FR, int S,
                                  int Q, const void* g, const void* probs,
                                  const void* labels, const void* a1,
                                  const void* sk, const void* skip,
                                  const void* w1, const void* w2, void* dskip,
                                  void* dlc2, void* dw1, void* dw2, void* db2,
                                  void* dl, void* dh16, void* part,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* gg = static_cast<const float*>(g);
  const int* lab = static_cast<const int*>(labels);
  const float* sp = static_cast<const float*>(skip);
  float* lc = static_cast<float*>(dlc2);
  float* w1g = static_cast<float*>(dw1);
  float* w2g = static_cast<float*>(dw2);
  float* b2g = static_cast<float*>(db2);
  float* pt = static_cast<float*>(part);
  if (dtype == 1)
    return bwd<bf16>(B, T, FR, S, Q, gg, static_cast<const bf16*>(probs), lab,
                     static_cast<const bf16*>(a1),
                     static_cast<const bf16*>(sk), sp,
                     static_cast<const bf16*>(w1),
                     static_cast<const bf16*>(w2), static_cast<bf16*>(dskip),
                     lc, w1g, w2g, b2g, static_cast<bf16*>(dl),
                     static_cast<bf16*>(dh16), pt, s);
  return bwd<float>(B, T, FR, S, Q, gg, static_cast<const float*>(probs), lab,
                    static_cast<const float*>(a1),
                    static_cast<const float*>(sk), sp,
                    static_cast<const float*>(w1),
                    static_cast<const float*>(w2), static_cast<float*>(dskip),
                    lc, w1g, w2g, b2g, static_cast<float*>(dl),
                    static_cast<float*>(dh16), pt, s);
}
