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
//       a grid over (2D tile, tap x channel tile, layer x row split) on
//       hopper_gemm.cuh's mainloop; the per-layer dilations come from a
//       device array.
//
// Rounding points are those of train_stack_bwd.cu (dX in f32, dX16 =
// T(dX) feeds the products, dpre rounded to T, every gradient summed in
// f32), so the two backwards compute one function; dx0 on exit is dX16.
//
// What bounds them on the H100: the products.  At B=8 x 6,656 the chain is
// 2.51 TFLOP (shipped) / 3.49 (Magenta) and dk 1.26 / 1.40: ~2.5 + 1.3 ms
// at the bf16 tensor-core peak, ~37 + 19 ms at the f32 FFMA peak.  dpre_all
// is written once and read back once by dk (1.64 GB shipped in bf16, ~0.5
// ms each way at 3.35 TB/s).  The chain's products are the sweep's, on
// hopper_gemm.cuh (train_stack_bwd.cuh): bf16 11.65 ms shipped, 18.08
// Magenta (the tile loop before: 48.45, 71.62; chip_smoke.py
// [train-bwd2], NVIDIA H100 80GB HBM3, 700 W), its outputs bit-identical
// to the sweep's.
//
// dk is a Hopper GEMM (hopper_gemm.cuh): a 4-stage ring of TMA loads
// feeding two wgmma warpgroups (bf16, 128 x 256 x 64 tiles) or a 5-stage
// ring feeding an FFMA core (f32, 128 x 128 x 32; wgmma has no f32
// product and the TPU ran f32 at HIGHEST).  Both operands are MN-major as
// they lie in memory (channels of xs, outputs of dpre contiguous), so no
// thread transposes anything.  The tap shift is a TMA coordinate: the
// tensor maps view xs and dpre_all as [L][B][T][width], a k-tile is 64
// (f32: 32) rows of one batch row, and tap j's A box starts at row t0 -
// o_j, so rows before 0 of that batch row (the causal head; a whole tap
// when o_j >= T) and rows past T arrive as zeros from TMA, and nothing
// crosses into the previous batch row: no index test in the mainloop.
// Channel and output tiles past the width load zeros too and are masked
// in the epilogue.  The rows of a layer are split in ceil(B*T / 12,288)
// parts (5 at B=8 x 6,656): with 12 (shipped) or 8 (Magenta) output tiles
// per layer that is 1,800 / 2,000 blocks of ~200 k-tiles, ~14 waves of one
// block per SM, so the grid is not persistent; each split writes its f32
// partial and a second pass sums the partials in a fixed order (no float
// atomics), so runs repeat bit for bit.  NVIDIA H100 80GB HBM3, 700 W
// (chip_smoke.py [train-bwd2]): bf16 ~600 TFLOP/s, 2.1 ms shipped against
// 14.6 for the mma.sync tile loop it replaces; the 128 x 256 tile stages
// 85 FLOP per byte from L2, which bounds it below the peak.
//
// C interface (ctypes): pointers and the stream as void*, returns
// cudaGetLastError() of the first failing launch (0 on success).

#include "hopper_gemm.cuh"
#include "train_stack_bwd.cuh"

using tg::bf16;

namespace dkp {

constexpr int DK_SPLIT_ROWS = 12288;   // rows per split of the dk product, about

// Splits of the row reduction: ceil(B*T / DK_SPLIT_ROWS), at most one per
// 64-row tile.  The same for both dtypes, so the scratch size depends on
// the shapes alone.
inline int dk_splits(int B, int T) {
  const long long rows = (long long)B * T;
  const long long cap = (long long)B * tg::ceil_div(T, 64);
  long long s = tg::ceil_div(rows, DK_SPLIT_ROWS);
  if (s > cap) s = cap;
  return s < 1 ? 1 : (int)s;
}

template <class Cfg>
int dk(int L, int K, int R, int D, int B, int T_, const int* dils_dev,
       const typename Cfg::T* dpre_all, const typename Cfg::T* xs,
       float* dk_out, float* part, cudaStream_t s) {
  bwd::Dk<Cfg> p;
  cudaError_t e;
  if ((e = hg::encode_mn<Cfg>(&p.xs, xs, hg::dense(R, T_, B, L))) !=
          cudaSuccess ||
      (e = hg::encode_mn<Cfg>(&p.dpre, dpre_all, hg::dense(2 * D, T_, B, L))) !=
          cudaSuccess)
    return static_cast<int>(e);
  p.dils = dils_dev; p.part = part;
  p.L = L; p.K = K; p.R = R; p.N = 2 * D; p.dil = 0; p.start = 0;
  p.tpb = tg::ceil_div(T_, Cfg::BK);
  p.row_tiles = B * p.tpb;
  p.splits = dk_splits(B, T_);
  p.chunk = tg::ceil_div(p.row_tiles, p.splits);
  p.ctiles = tg::ceil_div(R, Cfg::BM);
  dim3 grid(tg::ceil_div(2 * D, Cfg::BN), K * p.ctiles, L * p.splits);
  if ((e = hg::launch(p, grid, s)) != cudaSuccess)
    return static_cast<int>(e);
  return static_cast<int>(tg::launch_reduce(
      part, p.splits, (long long)L * K * R * 2 * D, dk_out, s));
}

}  // namespace dkp

// The floats of scratch (part) each entry needs; the caller sizes part
// with these, so the row blocking is known to this file alone.
extern "C" long long train_stack_bwd_chain_part_floats(int R, int D, int S,
                                                       int B, int T) {
  return bwd::walk_part_floats(0, R, D, S, B, T, false);
}

extern "C" long long train_stack_bwd_dk_part_floats(int L, int K, int R,
                                                    int D, int B, int T) {
  return (long long)dkp::dk_splits(B, T) * L * K * R * 2 * D;
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
    return dkp::dk<hg::Bf16Cfg>(L, K, R, D, B, T, d,
                           static_cast<const bf16*>(dpre_all),
                           static_cast<const bf16*>(xs),
                           static_cast<float*>(dk_out),
                           static_cast<float*>(part), s);
  return dkp::dk<hg::F32Cfg>(L, K, R, D, B, T, d,
                        static_cast<const float*>(dpre_all),
                        static_cast<const float*>(xs),
                        static_cast<float*>(dk_out), static_cast<float*>(part),
                        s);
}
