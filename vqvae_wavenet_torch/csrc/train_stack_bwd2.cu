// WaveNet training residual stack, the two-kernel backward.
//
// Replaces the TPU's two-kernel backward in
// vqvae_wavenet_tpu/ops/train_pallas.py, which computes the same function
// as the layer sweep (train_stack_bwd.cu) and runs under the switch
// _BWD_FUSED_DK = "off" (:1612-1663):
//
//   train_stack_bwd_chain  replaces _make_bwd_kernel (:180, pallas_call
//       at :470): the reverse layer walk of train_stack_bwd.cu without the
//       weight-gradient product.  Per layer l (five products/reductions,
//       each over all B*T rows):
//         dgated   [dX16 | dskip] . [resw^T ; skipw^T], gate derivative in
//                  the epilogue -> dpre_all[l] [B*T, 2D] (compute type)
//         dsk|drs  gated^T . [dskip | dX16]       (split-K, fixed order)
//         drb      column sums of dX (f32)        (per-chunk partials)
//         dlc      per-frame sums of dpre_all[l] (f32)
//         dX      += sum_j dpre_all[l][t + o_j] . W_j^T, dX16 = T(dX)
//       Every layer's dpre stays in device memory for the second kernel.
//   train_stack_bwd_dk  replaces _make_dk_kernel (:493, pallas_call at
//       :638): ONE launch for every layer and tap,
//         dk[l, j] = sum_t xs[l][t - o_j]^T . dpre_all[l][t],
//         o_j = (K-1-j) * d_l,
//       a grid over (2D tile, K*R tile, layer x row split); the per-layer
//       dilations come from a device array.  A row t - o_j < 0 of a batch
//       row reads zero (the TPU kernel's zero-started history arena; here
//       an index test, so no sum crosses into the previous batch row).
//       The split partials are summed in a fixed order by a second pass
//       (no float atomics), so runs repeat bit for bit.
//
// Rounding points are those of train_stack_bwd.cu (dX in f32, dX16 =
// T(dX) feeds the products, dpre rounded to T, every gradient summed in
// f32), so the two backwards compute one function; dx0 on exit is dX16.
//
// What bounds it on the H100: the products.  At B=8 x 6,656 the chain is
// 2.51 TFLOP (shipped) / 3.49 (Magenta) and dk 1.26 / 1.40: ~2.5 + 1.3 ms
// at the bf16 tensor-core peak, ~37 + 19 ms at the f32 FFMA peak.  dpre_all
// is written once and read back once by dk (1.64 GB shipped in bf16, ~0.5
// ms each way at 3.35 TB/s).  Like the sweep, this first version is a
// plain tile loop (mma.sync, single-buffered) well below the bound.
//
// C interface (ctypes): pointers and the stream as void*, returns
// cudaGetLastError() of the first failing launch (0 on success).

#include "train_stack_bwd.cuh"

namespace {

using tg::bf16;
using bwd::DkP;

constexpr int DK_ROW_CHUNK = 8192;   // rows per split of the dk product

// every layer's dk product in one grid: blockIdx.z = layer * splits + split
template <typename T>
struct DkAll {
  const T* xs;          // [L, rows, R]
  const T* dpre_all;    // [L, rows, 2D]
  const int* dils;      // [L], device memory
  float* part;          // [splits, L, K*R, 2D]
  int L, KS, R, D, T_, rows, splits;
};

template <typename T>
__global__ void __launch_bounds__(tg::NT) dk_all(const DkAll<T> a) {
  const int l = blockIdx.z / a.splits, split = blockIdx.z % a.splits;
  DkP<T> p;
  p.M = a.KS * a.R; p.N = 2 * a.D; p.K = a.rows; p.kchunk = DK_ROW_CHUNK;
  p.x = a.xs + (long long)l * a.rows * a.R;
  p.dpre = a.dpre_all + (long long)l * a.rows * 2 * a.D;
  p.part = a.part + (long long)l * p.M * p.N;
  p.pstride = (long long)a.L * p.M * p.N;
  p.T_ = a.T_; p.R = a.R; p.D = a.D; p.KS = a.KS; p.d = a.dils[l];
  p.start = 0;
  tg::gemm_tile<T, false, false>(p, blockIdx.y * tg::BM, blockIdx.x * tg::BN,
                                 split);
}

template <typename T>
int dk(int L, int K, int R, int D, int B, int T_, const int* dils_dev,
       const T* dpre_all, const T* xs, float* dk_out, float* part,
       cudaStream_t s) {
  DkAll<T> a;
  a.xs = xs; a.dpre_all = dpre_all; a.dils = dils_dev; a.part = part;
  a.L = L; a.KS = K; a.R = R; a.D = D; a.T_ = T_; a.rows = B * T_;
  a.splits = tg::ceil_div(a.rows, DK_ROW_CHUNK);
  dim3 grid(tg::ceil_div(2 * D, tg::BN),
            tg::ceil_div((long long)K * R, tg::BM), L * a.splits);
  dk_all<T><<<grid, tg::NT, 0, s>>>(a);
  cudaError_t e;
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(tg::launch_reduce(
      part, a.splits, (long long)L * K * R * 2 * D, dk_out, s));
}

}  // namespace

// The floats of scratch (part) each entry needs; the caller sizes part
// with these, so the row blocking is known to this file alone.
extern "C" long long train_stack_bwd_chain_part_floats(int R, int D, int S,
                                                       int B, int T) {
  return bwd::walk_part_floats(0, R, D, S, B, T, false);
}

extern "C" long long train_stack_bwd_dk_part_floats(int L, int K, int R,
                                                    int D, int B, int T) {
  return tg::ceil_div((long long)B * T, DK_ROW_CHUNK) * (long long)L * K * R *
         2 * D;
}

// The chain: the walk of train_stack_bwd.cu without dk, T = float or bf16.
template <typename T>
static int chain(int L, int K, int R, int D, int S, int B, int T_, int FR,
                 const int* dils, const void* rsk, const void* kern,
                 const void* dskip, const void* act, void* dskrs, void* drb,
                 void* dlc, void* dx16, void* dx, void* dpre_all, void* part,
                 int sigmoid_first, cudaStream_t s) {
  return bwd::walk<T>(
      L, K, R, D, S, B, T_, FR, 0, dils, static_cast<const T*>(rsk),
      static_cast<const T*>(kern), static_cast<const T*>(dskip),
      static_cast<const T*>(act), nullptr, nullptr, nullptr,
      static_cast<float*>(dskrs), static_cast<float*>(drb),
      static_cast<float*>(dlc), static_cast<T*>(dx16),
      static_cast<float*>(dx), static_cast<T*>(dpre_all),
      static_cast<float*>(part), sigmoid_first != 0, s);
}

// dtype 0 = float32, 1 = bfloat16.  Writes dpre_all [L, B*T, 2D], dskrs
// [L, D, S+R], drb [L, R], dlc [L, F, B, 2D] and dx16 (= dx0); dx [B*T, R]
// f32 is scratch; part holds train_stack_bwd_chain_part_floats(...) floats.
extern "C" int train_stack_bwd_chain(int dtype, int L, int K, int R, int D,
                                     int S, int B, int T, int FR,
                                     const int* dils, const void* rsk,
                                     const void* kern, const void* dskip,
                                     const void* act, void* dskrs, void* drb,
                                     void* dlc, void* dx16, void* dx,
                                     void* dpre_all, void* part,
                                     int sigmoid_first, void* stream) {
  auto fn = dtype == 1 ? &chain<bf16> : &chain<float>;
  return fn(L, K, R, D, S, B, T, FR, dils, rsk, kern, dskip, act, dskrs, drb,
            dlc, dx16, dx, dpre_all, part, sigmoid_first,
            static_cast<cudaStream_t>(stream));
}

// dtype 0 = float32, 1 = bfloat16.  dils is an int32 device array [L];
// writes dk [L, K, R, 2D] f32; part holds
// train_stack_bwd_dk_part_floats(...) floats.
extern "C" int train_stack_bwd_dk(int dtype, int L, int K, int R, int D,
                                  int B, int T, const void* dils,
                                  const void* dpre_all, const void* xs,
                                  void* dk_out, void* part, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* d = static_cast<const int*>(dils);
  if (dtype == 1)
    return dk<bf16>(L, K, R, D, B, T, d, static_cast<const bf16*>(dpre_all),
                    static_cast<const bf16*>(xs), static_cast<float*>(dk_out),
                    static_cast<float*>(part), s);
  return dk<float>(L, K, R, D, B, T, d, static_cast<const float*>(dpre_all),
                   static_cast<const float*>(xs), static_cast<float*>(dk_out),
                   static_cast<float*>(part), s);
}
