// WaveNet loss head (postprocess heads + mean sparse softmax cross
// entropy), forward and backward.
//
// Replaces vqvae_wavenet_tpu/ops/train_pallas.py::_make_epilogue (the
// Pallas kernel pair launched at train_pallas.py:1981 (fwd) and :2008
// (bwd)).  Rows are the B*T samples; the frame condition enc2 [F, B, S]
// (postprocess1's condition projection + bias, folded outside) is added
// per row.
//
// Forward (train_pallas.py:1909-1940):
//   h1   [N, S] = T(relu(skip)) . W1       epilogue: + enc2[t/FR, b],
//                                          a1 = T(relu(h1)) (saved)
//   h2   [N, Q] = a1 . W2                  epilogue: + b2 -> f32 logits
//   rows: log-softmax over Q per row (one warp per row), probs saved in
//   the compute type, nll = logsumexp - logit[label]; per-block partial
//   sums, then a fixed-order final sum.
// Backward (train_pallas.py:1942-1978), g = the loss's cotangent:
//   dlogits = (probs - onehot) * g / N      (f32; db2 = its column sums,
//                                            T(dlogits) feeds the products)
//   dW2  [S, Q] = a1^T . T(dlogits)         (split-K over rows)
//   da1  [N, S] = T(dlogits) . W2^T         epilogue: dh1 = [a1 > 0] da1
//   dlc2 [F, B, S] = per-frame sums of dh1 (f32)
//   dW1  [S, S] = T(relu(skip))^T . T(dh1)  (split-K over rows)
//   dskip [N, S] = T([skip > 0] (T(dh1) . W1^T))
//
// What bounds it on the H100: at the shipped training shape (N = 53,248,
// S = 512, Q = 256) the forward is 42 GFLOP over ~0.19 GB (bytes bind in
// bf16: ~57 us) and the backward 84 GFLOP over ~0.25 GB (~85 us, products
// bind in bf16).  This first version round-trips the f32 logits and dh1
// through device memory and runs well above those bounds.
//
// C interface (ctypes): pointers and the stream as void*, returns
// cudaGetLastError() of the first failing launch (0 on success).

#include "train_gemm.cuh"

namespace {

using tg::bf16;

constexpr int ROW_CHUNK = 1024;     // rows per split of the dW products
constexpr int DL_ROWS = 64;         // rows per block of the dlogits pass
constexpr int SM_ROWS = 64;         // rows per block of the softmax pass

// relu(skip) rounded to the compute type, 8 values along one row
template <typename T>
__device__ __forceinline__ void relu8(const float* src, T* v) {
  const float4 a = reinterpret_cast<const float4*>(src)[0];
  const float4 b = reinterpret_cast<const float4*>(src)[1];
  const float x[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = tg::from_f<T>(fmaxf(x[i], 0.f));
}

template <typename T>
struct H1P {
  int M, N, K, kchunk;     // M = rows, N = K = S
  const float* skip;       // [rows, S] f32
  const T* w1t;            // W1^T [S, S]
  const float* enc2;       // [F, B, S]
  T* a1;                   // [rows, S]
  int T_, FR, B;

  __device__ bool a8(int m, int k, T* v) const {
    relu8(skip + (long long)m * K + k, v);
    return true;
  }
  __device__ bool b8(int n, int k, T* v) const {
    tg::ld8(w1t + (long long)n * K + k, v);
    return true;
  }
  __device__ void epi(int m, int n, float v0, float v1, int) const {
    const int b = m / T_, t = m - b * T_;
    const float* e = enc2 + ((long long)(t / FR) * B + b) * N + n;
    T* o = a1 + (long long)m * N + n;
    o[0] = tg::from_f<T>(fmaxf(v0 + e[0], 0.f));
    o[1] = tg::from_f<T>(fmaxf(v1 + e[1], 0.f));
  }
};

template <typename T>
struct H2P {
  int M, N, K, kchunk;     // M = rows, N = Q, K = S
  const T* a1;             // [rows, S]
  const T* w2t;            // W2^T [Q, S]
  const float* b2;         // [Q]
  float* logits;           // [rows, Q]

  __device__ bool a8(int m, int k, T* v) const {
    tg::ld8(a1 + (long long)m * K + k, v);
    return true;
  }
  __device__ bool b8(int n, int k, T* v) const {
    tg::ld8(w2t + (long long)n * K + k, v);
    return true;
  }
  __device__ void epi(int m, int n, float v0, float v1, int) const {
    float* o = logits + (long long)m * N + n;
    o[0] = v0 + b2[n];
    o[1] = v1 + b2[n + 1];
  }
};

// one warp per row: probs = T(softmax(logits)), nll = lse - logit[label];
// each block sums its rows' nll in row order into part[blockIdx.x]
template <typename T>
__global__ void softmax_rows(const float* __restrict__ logits,
                             const int* __restrict__ labels, int rows, int Q,
                             T* __restrict__ probs, float* __restrict__ part) {
  __shared__ float row_nll[SM_ROWS];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  for (int i = w; i < SM_ROWS; i += blockDim.x / 32) {
    const int r = (int)blockIdx.x * SM_ROWS + i;
    float nll = 0.f;
    if (r < rows) {
      const float* x = logits + (long long)r * Q;
      float m = -INFINITY;
      for (int q = lane; q < Q; q += 32) m = fmaxf(m, x[q]);
      for (int o = 16; o > 0; o >>= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      float se = 0.f;
      for (int q = lane; q < Q; q += 32) se += expf(x[q] - m);
      for (int o = 16; o > 0; o >>= 1)
        se += __shfl_xor_sync(0xffffffffu, se, o);
      for (int q = lane; q < Q; q += 32)
        probs[(long long)r * Q + q] = tg::from_f<T>(expf(x[q] - m) / se);
      nll = (logf(se) + m) - x[labels[r]];
    }
    if (lane == 0) row_nll[i] = nll;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int i = 0; i < SM_ROWS; ++i) s += row_nll[i];
    part[blockIdx.x] = s;
  }
}

// dlogits, one thread per column q, DL_ROWS rows per block: writes
// T(dlogits) and the block's f32 column sums (for db2)
template <typename T>
__global__ void dlogits_rows(const T* __restrict__ probs,
                             const int* __restrict__ labels,
                             const float* __restrict__ g, int rows, int Q,
                             T* __restrict__ dl, float* __restrict__ part) {
  const int q = threadIdx.x;
  const float scale = g[0] / (float)rows;
  const int r0 = (int)blockIdx.x * DL_ROWS;
  const int r1 = min(rows, r0 + DL_ROWS);
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

template <typename T>
struct Dw2P {
  int M, N, K, kchunk;     // M = S, N = Q, K = rows
  const T* a1;             // [rows, S]
  const T* dl;             // [rows, Q]
  float* part;

  __device__ bool a8(int m, int k, T* v) const {
    tg::ld8(a1 + (long long)k * M + m, v);
    return true;
  }
  __device__ bool b8(int n, int k, T* v) const {
    tg::ld8(dl + (long long)k * N + n, v);
    return true;
  }
  __device__ void epi(int m, int n, float v0, float v1, int split) const {
    float* o = part + ((long long)split * M + m) * N + n;
    o[0] = v0;
    o[1] = v1;
  }
};

template <typename T>
struct Da1P {
  int M, N, K, kchunk;     // M = rows, N = S, K = Q
  const T* dl;             // [rows, Q]
  const T* w2;             // W2 [S, Q]
  const T* a1;             // [rows, S]
  float* dh1;              // [rows, S] f32
  T* dh16;                 // [rows, S]

  __device__ bool a8(int m, int k, T* v) const {
    tg::ld8(dl + (long long)m * K + k, v);
    return true;
  }
  __device__ bool b8(int n, int k, T* v) const {
    tg::ld8(w2 + (long long)n * K + k, v);
    return true;
  }
  __device__ void epi(int m, int n, float v0, float v1, int) const {
    const long long i = (long long)m * N + n;
    const float h0 = tg::to_f(a1[i]) > 0.f ? v0 : 0.f;
    const float h1 = tg::to_f(a1[i + 1]) > 0.f ? v1 : 0.f;
    dh1[i] = h0;
    dh1[i + 1] = h1;
    dh16[i] = tg::from_f<T>(h0);
    dh16[i + 1] = tg::from_f<T>(h1);
  }
};

template <typename T>
struct Dw1P {
  int M, N, K, kchunk;     // M = N = S, K = rows
  const float* skip;       // [rows, S] f32
  const T* dh16;           // [rows, S]
  float* part;

  __device__ bool a8(int m, int k, T* v) const {
    relu8(skip + (long long)k * M + m, v);
    return true;
  }
  __device__ bool b8(int n, int k, T* v) const {
    tg::ld8(dh16 + (long long)k * N + n, v);
    return true;
  }
  __device__ void epi(int m, int n, float v0, float v1, int split) const {
    float* o = part + ((long long)split * M + m) * N + n;
    o[0] = v0;
    o[1] = v1;
  }
};

template <typename T>
struct DskipP {
  int M, N, K, kchunk;     // M = rows, N = K = S
  const T* dh16;           // [rows, S]
  const T* w1;             // W1 [S, S]
  const float* skip;       // [rows, S] f32
  T* dskip;                // [rows, S]

  __device__ bool a8(int m, int k, T* v) const {
    tg::ld8(dh16 + (long long)m * K + k, v);
    return true;
  }
  __device__ bool b8(int n, int k, T* v) const {
    tg::ld8(w1 + (long long)n * K + k, v);
    return true;
  }
  __device__ void epi(int m, int n, float v0, float v1, int) const {
    const long long i = (long long)m * N + n;
    dskip[i] = tg::from_f<T>(skip[i] > 0.f ? v0 : 0.f);
    dskip[i + 1] = tg::from_f<T>(skip[i + 1] > 0.f ? v1 : 0.f);
  }
};

template <typename T>
int fwd(int B, int T_, int FR, int S, int Q, const float* skip, const T* w1t,
        const T* w2t, const float* b2, const float* enc2, const int* labels,
        T* a1, T* probs, float* logits, float* part, float* total,
        cudaStream_t s) {
  const int rows = B * T_;
  cudaError_t e;
  H1P<T> h;
  h.M = rows; h.N = S; h.K = S; h.kchunk = S;
  h.skip = skip; h.w1t = w1t; h.enc2 = enc2; h.a1 = a1;
  h.T_ = T_; h.FR = FR; h.B = B;
  if ((e = tg::launch_gemm<T, true, true>(h, 1, s)) != cudaSuccess)
    return static_cast<int>(e);
  H2P<T> o;
  o.M = rows; o.N = Q; o.K = S; o.kchunk = S;
  o.a1 = a1; o.w2t = w2t; o.b2 = b2; o.logits = logits;
  if ((e = tg::launch_gemm<T, true, true>(o, 1, s)) != cudaSuccess)
    return static_cast<int>(e);
  const int nblk = tg::ceil_div(rows, SM_ROWS);
  softmax_rows<T><<<nblk, 256, 0, s>>>(logits, labels, rows, Q, probs, part);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  tg::sum_all<<<1, 256, 0, s>>>(part, nblk, total);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int bwd(int B, int T_, int FR, int S, int Q, const float* g, const T* probs,
        const int* labels, const T* a1, const float* skip, const T* w1,
        const T* w2, T* dskip, float* dlc2, float* dw1, float* dw2,
        float* db2, T* dl, float* dh1, T* dh16, float* part,
        cudaStream_t s) {
  const int rows = B * T_;
  cudaError_t e;
  const int nblk = tg::ceil_div(rows, DL_ROWS);
  dlogits_rows<T><<<nblk, Q, 0, s>>>(probs, labels, g, rows, Q, dl, part);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  if ((e = tg::launch_reduce(part, nblk, Q, db2, s)) != cudaSuccess)
    return static_cast<int>(e);

  const int splits = tg::ceil_div(rows, ROW_CHUNK);
  Dw2P<T> w;
  w.M = S; w.N = Q; w.K = rows; w.kchunk = ROW_CHUNK;
  w.a1 = a1; w.dl = dl; w.part = part;
  if ((e = tg::launch_gemm<T, false, false>(w, splits, s)) != cudaSuccess)
    return static_cast<int>(e);
  if ((e = tg::launch_reduce(part, splits, (long long)S * Q, dw2, s))
      != cudaSuccess)
    return static_cast<int>(e);

  Da1P<T> a;
  a.M = rows; a.N = S; a.K = Q; a.kchunk = Q;
  a.dl = dl; a.w2 = w2; a.a1 = a1; a.dh1 = dh1; a.dh16 = dh16;
  if ((e = tg::launch_gemm<T, true, true>(a, 1, s)) != cudaSuccess)
    return static_cast<int>(e);
  if ((e = tg::launch_frame_sum<float>(dh1, B, T_, FR, S, dlc2, s))
      != cudaSuccess)
    return static_cast<int>(e);

  Dw1P<T> v;
  v.M = S; v.N = S; v.K = rows; v.kchunk = ROW_CHUNK;
  v.skip = skip; v.dh16 = dh16; v.part = part;
  if ((e = tg::launch_gemm<T, false, false>(v, splits, s)) != cudaSuccess)
    return static_cast<int>(e);
  if ((e = tg::launch_reduce(part, splits, (long long)S * S, dw1, s))
      != cudaSuccess)
    return static_cast<int>(e);

  DskipP<T> k;
  k.M = rows; k.N = S; k.K = S; k.kchunk = S;
  k.dh16 = dh16; k.w1 = w1; k.skip = skip; k.dskip = dskip;
  if ((e = tg::launch_gemm<T, true, true>(k, 1, s)) != cudaSuccess)
    return static_cast<int>(e);
  return 0;
}

}  // namespace

// The floats of scratch (part) each entry needs; the caller sizes part
// with these, so the row blocking is known to this file alone.
extern "C" long long train_epilogue_fwd_part_floats(int B, int T) {
  return tg::ceil_div(B * T, SM_ROWS);
}

extern "C" long long train_epilogue_bwd_part_floats(int B, int T, int S,
                                                    int Q) {
  const long long dl = tg::ceil_div(B * T, DL_ROWS) * (long long)Q;
  const long long dw = tg::ceil_div(B * T, ROW_CHUNK) * (long long)S *
                       (S > Q ? S : Q);
  return dl > dw ? dl : dw;
}

// dtype 0 = float32, 1 = bfloat16.  part holds
// train_epilogue_fwd_part_floats(B, T) floats; total gets the summed NLL
// (the caller divides by B*T).
extern "C" int train_epilogue_fwd(int dtype, int B, int T, int FR, int S,
                                  int Q, const void* skip, const void* w1t,
                                  const void* w2t, const void* b2,
                                  const void* enc2, const void* labels,
                                  void* a1, void* probs, void* logits,
                                  void* part, void* total, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sk = static_cast<const float*>(skip);
  const float* bb = static_cast<const float*>(b2);
  const float* en = static_cast<const float*>(enc2);
  const int* lab = static_cast<const int*>(labels);
  float* lg = static_cast<float*>(logits);
  float* pt = static_cast<float*>(part);
  float* tot = static_cast<float*>(total);
  if (dtype == 1)
    return fwd<bf16>(B, T, FR, S, Q, sk, static_cast<const bf16*>(w1t),
                     static_cast<const bf16*>(w2t), bb, en, lab,
                     static_cast<bf16*>(a1), static_cast<bf16*>(probs), lg,
                     pt, tot, s);
  return fwd<float>(B, T, FR, S, Q, sk, static_cast<const float*>(w1t),
                    static_cast<const float*>(w2t), bb, en, lab,
                    static_cast<float*>(a1), static_cast<float*>(probs), lg,
                    pt, tot, s);
}

// part holds train_epilogue_bwd_part_floats(B, T, S, Q) floats.
extern "C" int train_epilogue_bwd(int dtype, int B, int T, int FR, int S,
                                  int Q, const void* g, const void* probs,
                                  const void* labels, const void* a1,
                                  const void* skip, const void* w1,
                                  const void* w2, void* dskip, void* dlc2,
                                  void* dw1, void* dw2, void* db2, void* dl,
                                  void* dh1, void* dh16, void* part,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* gg = static_cast<const float*>(g);
  const int* lab = static_cast<const int*>(labels);
  const float* sk = static_cast<const float*>(skip);
  float* lc = static_cast<float*>(dlc2);
  float* w1g = static_cast<float*>(dw1);
  float* w2g = static_cast<float*>(dw2);
  float* b2g = static_cast<float*>(db2);
  float* h = static_cast<float*>(dh1);
  float* pt = static_cast<float*>(part);
  if (dtype == 1)
    return bwd<bf16>(B, T, FR, S, Q, gg, static_cast<const bf16*>(probs), lab,
                     static_cast<const bf16*>(a1), sk,
                     static_cast<const bf16*>(w1),
                     static_cast<const bf16*>(w2), static_cast<bf16*>(dskip),
                     lc, w1g, w2g, b2g, static_cast<bf16*>(dl), h,
                     static_cast<bf16*>(dh16), pt, s);
  return bwd<float>(B, T, FR, S, Q, gg, static_cast<const float*>(probs), lab,
                    static_cast<const float*>(a1), sk,
                    static_cast<const float*>(w1),
                    static_cast<const float*>(w2), static_cast<float*>(dskip),
                    lc, w1g, w2g, b2g, static_cast<float*>(dl), h,
                    static_cast<float*>(dh16), pt, s);
}
