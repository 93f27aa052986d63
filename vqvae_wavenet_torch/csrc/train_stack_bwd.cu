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
// The products and the walk live in train_stack_bwd.cuh, shared with the
// two-kernel backward (train_stack_bwd2.cu), which runs the same walk
// without dk and keeps every layer's dpre.
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

#include "train_stack_bwd.cuh"

using tg::bf16;

// The floats of scratch (part) train_stack_bwd needs; the caller sizes part
// with this, so the row blocking is known to this file alone.
extern "C" long long train_stack_bwd_part_floats(int K, int R, int D, int S,
                                                 int B, int T) {
  return bwd::walk_part_floats(K, R, D, S, B, T, true);
}

// The walk with the pointers typed: T = float or bf16.
template <typename T>
static int typed(int L, int K, int R, int D, int S, int B, int T_, int FR,
                 int start, const int* dils, const void* rsk,
                 const void* kern, const void* dskip, const void* act,
                 const void* xs, const void* dxout, void* dk, void* dskrs,
                 void* drb, void* dlc, void* dx16, void* dx, void* dpre,
                 void* part, int sigmoid_first, cudaStream_t s) {
  return bwd::walk<T>(
      L, K, R, D, S, B, T_, FR, start, dils, static_cast<const T*>(rsk),
      static_cast<const T*>(kern), static_cast<const T*>(dskip),
      static_cast<const T*>(act), static_cast<const T*>(xs),
      static_cast<const T*>(dxout), static_cast<float*>(dk),
      static_cast<float*>(dskrs), static_cast<float*>(drb),
      static_cast<float*>(dlc), static_cast<T*>(dx16),
      static_cast<float*>(dx), static_cast<T*>(dpre),
      static_cast<float*>(part), sigmoid_first != 0, s);
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
  auto fn = dtype == 1 ? &typed<bf16> : &typed<float>;
  return fn(L, K, R, D, S, B, T, FR, start, dils, rsk, kern, dskip, act, xs,
            dxout, dk, dskrs, drb, dlc, dx16, dx, dpre, part, sigmoid_first,
            static_cast<cudaStream_t>(stream));
}
