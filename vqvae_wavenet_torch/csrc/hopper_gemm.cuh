// A Hopper GEMM mainloop for the training kernels: a ring of shared-memory
// stages filled by TMA (cp.async.bulk.tensor, completion on mbarriers) from
// one producer warp, consumed by two warpgroups of wgmma (bf16) or by eight
// warps of FFMA (f32).  It computes one block's tile of
//
//   C[m, n] = sum_k A(m, k) * B(n, k)
//
// with both operands in one of two layouts, as the products find them in
// memory; the problem's Cfg picks it:
//
//   MN-major (Bf16Cfg, F32Cfg): the weight gradients, which reduce over
//       rows: A is an activation [rows, channels] (channels contiguous), B
//       a gradient [rows, outputs], and k runs over rows.  A k-tile is
//       [BK rows][BOX channels] boxes; wgmma reads them through its
//       transpose bits; the f32 core takes a row of A and a row of B per k
//       (an outer product).
//   K-major (Bf16KCfg, F32KCfg): activations times transposed weights,
//       which reduce over channels: A is [rows, channels], B a weight
//       stored [outputs, channels], both with k contiguous.  A k-tile is
//       one box of [BM (BN) rows][BK] -- 128 bytes of k per row, TMA's
//       128-byte swizzle -- and wgmma reads it through the canonical
//       (non-transposed) descriptor.  The f32 core reads float4s along k;
//       the swizzle stores a row's 16-byte chunk c at c ^ (row % 8), and
//       each thread's rows are chosen so that the 8 threads of a
//       shared-memory phase hit 8 different chunks (f32 below).
//
// No thread transposes anything and the mainloop has no index test.
//
// A problem struct P gives the operands and the epilogue (one thread of the
// producer warp calls load; every consumer thread calls fetch and put):
//
//   using Cfg = one of the four;
//   __device__ void k_range(int& it0, int& it1) const;     // this block's k-tiles
//   __device__ void load(int it, uint32_t sA, uint32_t sB, uint32_t bar) const;
//       // TMA loads of k-tile it into sA (Cfg::A_BYTES) and sB
//       // (Cfg::B_BYTES); each load completes on bar.  MN-major: A as
//       // Cfg::BM / Cfg::BOX boxes at sA + i * Cfg::BOX_BYTES, B likewise;
//       // K-major: one box each (encode_k)
//   struct Pre { ... };                                  // what put reads
//   __device__ Pre fetch(int r, int c) const;            // loads only
//   __device__ void put(int r, int c, float v0, float v1, const Pre&) const;
//       // C[r][c], C[r][c+1] of the block's tile (r < BM, c < BN, c even)
//   or, for an epilogue that needs more than a pair (a row's softmax,
//   column sums), __device__ void tile(float* C) const over the whole
//   staged tile (finish() below).
//
// The epilogue fetches a group of pairs before it puts any: a load after a
// store that may alias it waits for it, so a read-modify-write (dX, the
// skip sum) or a read of saved activations (the gate) pair by pair would
// cost a memory round trip per pair, with few warps on an SM to hide it.
//
// The epilogue: once the mainloop is done the consumers write their
// accumulators to a C tile in shared memory (over the ring), then call
// fetch and put with consecutive threads on consecutive pairs of a row, in
// a loop that is not unrolled: an epilogue unrolled over every
// accumulator pair (a few hundred instructions a pair for the gate or the
// skip sum) outgrew the instruction cache and ran several times slower
// than the mainloop.
//
// Out-of-bounds box elements (a negative row coordinate, rows past the
// end, channels past the width) arrive as zeros, so a problem masks
// nothing in the mainloop; put masks the tile's ragged edge.  A k-tile
// that spans two tensors (a tap, an operand of a concatenation) is two
// boxes from two maps, each zero past its own width.
//
// Tiles: bf16 MN-major 128 x 256 x 64 (each warpgroup a 64 x 256 half, one
// m64n256k16 per 16 of k), 4 stages of 48 KB, one block an SM; bf16
// K-major 128 x 128 x 64 (m64n128k16), 3 stages of 32 KB, two blocks an SM,
// twice the warps for the stack's heavy epilogues, which carry these
// kernels (the two blocks' epilogues overlap each other); f32 128 x 128 x 32
// (each thread an 8 x 8 register tile), 5 stages of 32 KB, one block an
// SM; K-major with 256 columns (Bf16KWCfg 128 x 256, F32KWCfg 64 x 256)
// for an epilogue that needs whole rows of up to 256 columns.  The
// consumers release a stage as soon as the products reading it are done
// (bf16: wgmma.wait_group 1 keeps one k-tile of products in flight), so
// the producer keeps STAGES-1 k-tiles of loads ahead of the math.  A
// k-tile's products are summed in a fixed order, so a run repeats bit
// for bit.
//
// On an NVIDIA H100 80GB HBM3 (700 W; chip_smoke.py): dk, MN-major, bf16
// ~600 TFLOP/s, f32 46 TFLOP/s (68% of the FFMA peak); the stack's
// products in train_stack_fwd.cu and train_stack_bwd.cu, whose notes give
// their times.  What the grid does not do: overlap a tile's epilogue with
// a mainloop -- the two add up (measured by cutting either out), which a
// persistent schedule with the C tile outside the ring would change.
//
// Host side: encode() builds a CUtensorMap through the CUDA entry point
// cuTensorMapEncodeTiled, obtained from the runtime
// (cudaGetDriverEntryPoint), so nothing links against libcuda.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace hg {

struct Bf16Cfg {
  using T = __nv_bfloat16;
  static constexpr bool K_MAJOR = false;
  static constexpr int BM = 128, BN = 256, BK = 64, STAGES = 4, BLOCKS = 1;
  static constexpr int BOX = 64;                        // 128-byte rows
  static constexpr int BOX_BYTES = BOX * BK * 2;        // 8 KB
  static constexpr int A_BYTES = BM * BK * 2, B_BYTES = BN * BK * 2;
  static constexpr CUtensorMapSwizzle SWIZZLE = CU_TENSOR_MAP_SWIZZLE_128B;
  static constexpr CUtensorMapDataType DTYPE = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};

struct F32Cfg {
  using T = float;
  static constexpr bool K_MAJOR = false;
  static constexpr int BM = 128, BN = 128, BK = 32, STAGES = 5, BLOCKS = 1;
  static constexpr int BOX = 128;                       // 512-byte rows
  static constexpr int BOX_BYTES = BOX * BK * 4;        // 16 KB
  static constexpr int A_BYTES = BM * BK * 4, B_BYTES = BN * BK * 4;
  static constexpr CUtensorMapSwizzle SWIZZLE = CU_TENSOR_MAP_SWIZZLE_NONE;
  static constexpr CUtensorMapDataType DTYPE = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
};

// K-major: BK elements are 128 bytes, one swizzled row per tile row.
// bf16 runs two blocks an SM (BLOCKS), for twice the warps in the
// epilogues: 128 x 128 tiles (64 accumulators a thread), 3 stages of 32 KB.
struct Bf16KCfg {
  using T = __nv_bfloat16;
  static constexpr bool K_MAJOR = true;
  static constexpr int BM = 128, BN = 128, BK = 64, STAGES = 3, BLOCKS = 2;
  static constexpr int BOX_BYTES = 64 * BK * 2;         // 64 rows: 8 KB
  static constexpr int A_BYTES = BM * BK * 2, B_BYTES = BN * BK * 2;
  static constexpr CUtensorMapSwizzle SWIZZLE = CU_TENSOR_MAP_SWIZZLE_128B;
  static constexpr CUtensorMapDataType DTYPE = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};
struct F32KCfg : F32Cfg {
  static constexpr bool K_MAJOR = true;
  static constexpr CUtensorMapSwizzle SWIZZLE = CU_TENSOR_MAP_SWIZZLE_128B;
};

// K-major with 256 columns, for an epilogue that needs whole rows of C
// (the loss head's softmax over Q <= 256 classes): bf16 128 x 256 x 64
// (m64n256k16, 128 accumulators a thread), 4 stages of 48 KB; f32 64 x 256
// x 32 (each thread 4 rows x 16 columns), 5 stages of 40 KB.  One block
// an SM.
struct Bf16KWCfg : Bf16KCfg {
  static constexpr int BN = 256, STAGES = 4, BLOCKS = 1;
  static constexpr int B_BYTES = BN * BK * 2;
};
struct F32KWCfg : F32KCfg {
  static constexpr int BM = 64, BN = 256;
  static constexpr int A_BYTES = BM * BK * 4, B_BYTES = BN * BK * 4;
};

constexpr int NCONS = 256;               // consumer threads: 2 warpgroups
constexpr int NTHREADS = NCONS + 32;     // and one producer warp

template <class Cfg> __host__ __device__ constexpr int stage_bytes() {
  return Cfg::A_BYTES + Cfg::B_BYTES;
}
// dynamic shared memory of one block: the stages (1024-byte aligned, for
// the 128-byte swizzle), the alignment slack and the 2 x STAGES barriers
template <class Cfg> __host__ __device__ constexpr int smem_bytes() {
  return Cfg::STAGES * stage_bytes<Cfg>() + 1024 + 2 * Cfg::STAGES * 8;
}

// ---------------------------------------------------------------- device

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Wait for the completion of the barrier's phase of the given parity.  A
// wait of ~2^34 cycles (seconds; a real one is microseconds) is a bug:
// trap, so the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  const long long t0 = clock64();
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && clock64() - t0 > (1LL << 34)) __trap();
  } while (!done);
}

// one TMA load of a 4-D box at (c0, c1, c2, c3), innermost first
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile.  MN-major:
// lbo = bytes between 64-element atoms along M/N, sbo = bytes between
// groups of 8 rows along k (the canonical layout ((8,8,m),(8,k)) :
// ((1,8,lbo),(64,sbo)) in elements).  K-major: rows of 128 bytes of k,
// sbo = 1024 bytes between groups of 8 rows, lbo unused (16); a step of 16
// along k moves the start 32 bytes.  16-byte units in the fields.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N> __device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// keeps the compiler from moving accumulator reads or writes across the
// asynchronous products
__device__ __forceinline__ void reg_fence(float& x) {
  asm volatile("" : "+f"(x)::"memory");
}

// d[0..127] += A . B for one 64 x 256 x 16 step, bf16 operands from
// shared memory (descriptors da, db), both MN-major (TN = 1, transpose bits
// set) or both K-major (TN = 0), f32 accumulators in the warpgroup's
// registers.
template <int TN>
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127 "
      "}, "
      "%128, %129, p, 1, 1, %131, %131;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1), "n"(TN));
}

// the same for one 64 x 128 x 16 step (d[0..63])
template <int TN>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63 "
      "}, "
      "%64, %65, p, 1, 1, %67, %67;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TN));
}

// ---------------------------------------------------------------- epilogue

// The consumers' 256 threads alone (named barrier 1; the producer warp is
// not in it).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(NCONS) : "memory");
}

// The block's C tile, staged in shared memory (f32, rows Cfg::BN + 8
// apart: the consumers' stores of their accumulator layouts and the
// epilogue's row reads are free of bank conflicts), over the ring's
// stages once the mainloop is done.
template <class Cfg> __host__ __device__ constexpr int c_pitch() {
  return Cfg::BN + 8;
}
static_assert(Bf16Cfg::BM * c_pitch<Bf16Cfg>() * 4 <=
                  Bf16Cfg::STAGES * stage_bytes<Bf16Cfg>(), "C tile");
static_assert(F32Cfg::BM * c_pitch<F32Cfg>() * 4 <=
                  F32Cfg::STAGES * stage_bytes<F32Cfg>(), "C tile");
static_assert(Bf16KCfg::BM * c_pitch<Bf16KCfg>() * 4 <=
                  Bf16KCfg::STAGES * stage_bytes<Bf16KCfg>(), "C tile");
static_assert(Bf16KWCfg::BM * c_pitch<Bf16KWCfg>() * 4 <=
                  Bf16KWCfg::STAGES * stage_bytes<Bf16KWCfg>(), "C tile");
static_assert(F32KWCfg::BM * c_pitch<F32KWCfg>() * 4 <=
                  F32KWCfg::STAGES * stage_bytes<F32KWCfg>(), "C tile");

// The epilogue over the staged tile: pair (r, c..c+1) by pair, the 256
// consumer threads on consecutive pairs of a row (coalesced global
// accesses), in a loop that is not unrolled, so the problem's fetch and
// put are instantiated G times, not once per accumulator pair; a group of
// G pairs is fetched before any is put, so their loads are in flight
// together.
template <class P>
__device__ __forceinline__ void epilogue(const P& p, const float* C) {
  using Cfg = typename P::Cfg;
  constexpr int PITCH = c_pitch<Cfg>(), PAIRS = Cfg::BN / 2;
  constexpr int TOTAL = Cfg::BM * PAIRS, G = 8;
  static_assert(TOTAL % (NCONS * G) == 0, "tile");
#pragma unroll 1
  for (int i0 = threadIdx.x; i0 < TOTAL; i0 += NCONS * G) {
    typename P::Pre pre[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int i = i0 + g * NCONS, r = i / PAIRS, c = 2 * (i % PAIRS);
      pre[g] = p.fetch(r, c);
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int i = i0 + g * NCONS, r = i / PAIRS, c = 2 * (i % PAIRS);
      const float2 v = *reinterpret_cast<const float2*>(C + r * PITCH + c);
      p.put(r, c, v.x, v.y, pre[g]);
    }
  }
}

// A problem may run its own epilogue over the whole staged tile instead
// of fetch and put: ``__device__ void tile(float* C) const``, called by
// every consumer thread (C rows c_pitch<Cfg>() apart; the ring's bytes
// past the tile are free for it).  The loss head's row softmax and its
// per-frame column sums need more than a pair.
template <class P, class = void> struct has_tile : std::false_type {};
template <class P>
struct has_tile<P, std::void_t<decltype(&P::tile)>> : std::true_type {};

template <class P>
__device__ __forceinline__ void finish(const P& p, float* C) {
  if constexpr (has_tile<P>::value)
    p.tile(C);
  else
    epilogue(p, C);
}

// ---------------------------------------------------------------- consumers

// bf16: warpgroup wg (0, 1) computes rows [64 wg, 64 wg + 64) of the tile
template <class P>
__device__ __forceinline__ void consume_bf16(const P& p, uint32_t base,
                                             uint8_t* base_ptr,
                                             uint32_t full, uint32_t empty,
                                             int nk) {
  using Cfg = typename P::Cfg;
  constexpr int SB = stage_bytes<Cfg>(), NA = Cfg::BN / 2;
  const int wg = threadIdx.x >> 7;
  float acc[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) acc[i] = 0.f;
  for (int i = 0; i < nk; ++i) {
    const int s = i % Cfg::STAGES;
    mbar_wait(full + 8 * s, (i / Cfg::STAGES) & 1);
    // MN-major: warpgroup wg's box of 64 columns; K-major: its 64 rows of
    // 128 bytes (the same 8 KB offset)
    const uint32_t a = base + s * SB + wg * Cfg::BOX_BYTES;
    const uint32_t b = base + s * SB + Cfg::A_BYTES;
#pragma unroll
    for (int q = 0; q < NA; ++q) reg_fence(acc[q]);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < Cfg::BK / 16; ++kk) {
      if constexpr (Cfg::K_MAJOR && Cfg::BN == 256)  // 16 of k = 32 bytes
        wgmma_m64n256k16<0>(acc, desc_sw128(a + kk * 32, 16, 1024),
                            desc_sw128(b + kk * 32, 16, 1024));
      else if constexpr (Cfg::K_MAJOR)
        wgmma_m64n128k16<0>(acc, desc_sw128(a + kk * 32, 16, 1024),
                            desc_sw128(b + kk * 32, 16, 1024));
      else                                       // 16 rows = 2 KB of a box
        wgmma_m64n256k16<1>(acc,
                            desc_sw128(a + kk * 2048, Cfg::BOX_BYTES, 1024),
                            desc_sw128(b + kk * 2048, Cfg::BOX_BYTES, 1024));
    }
    wg_commit();
    wg_wait<1>();                                // k-tile i-1's products done
#pragma unroll
    for (int q = 0; q < NA; ++q) reg_fence(acc[q]);
    if (i > 0) mbar_arrive(empty + 8 * ((i - 1) % Cfg::STAGES));
  }
  wg_wait<0>();
#pragma unroll
  for (int q = 0; q < NA; ++q) reg_fence(acc[q]);
  consumers_sync();                              // no consumer reads the ring
  // the m64nNk16 accumulator layout: warp w of the warpgroup holds rows
  // 16w .. 16w+15; register q is row (lane/4) + 8 ((q/2)%2), column
  // 8 (q/4) + 2 (lane%4) + q%2
  float* C = reinterpret_cast<float*>(base_ptr);
  const int w = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
#pragma unroll
  for (int q = 0; q < NA; q += 2) {
    const int r = 64 * wg + 16 * w + (lane >> 2) + 8 * ((q >> 1) & 1);
    const int c = 8 * (q >> 2) + 2 * (lane & 3);
    *reinterpret_cast<float2*>(C + r * c_pitch<Cfg>() + c) =
        make_float2(acc[q], acc[q + 1]);
  }
  consumers_sync();
  finish(p, C);
}

// f32: thread (ty, tx) = (t / 16, t % 16) holds rows {4ty..4ty+3, 64+4ty..}
// and columns {4tx..4tx+3, 64+4tx..} of the tile
template <class P>
__device__ __forceinline__ void consume_f32(const P& p, uint8_t* base_ptr,
                                            uint32_t full, uint32_t empty,
                                            int nk) {
  using Cfg = typename P::Cfg;
  constexpr int SB = stage_bytes<Cfg>();
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  for (int i = 0; i < nk; ++i) {
    const int s = i % Cfg::STAGES;
    mbar_wait(full + 8 * s, (i / Cfg::STAGES) & 1);
    const float* As = reinterpret_cast<const float*>(base_ptr + s * SB);
    const float* Bs = As + Cfg::BM * Cfg::BK;
#pragma unroll 4
    for (int k = 0; k < Cfg::BK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(As + k * Cfg::BM + 4 * ty);
      const float4 a1 = *reinterpret_cast<const float4*>(As + k * Cfg::BM + 64 + 4 * ty);
      const float4 b0 = *reinterpret_cast<const float4*>(Bs + k * Cfg::BN + 4 * tx);
      const float4 b1 = *reinterpret_cast<const float4*>(Bs + k * Cfg::BN + 64 + 4 * tx);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int ii = 0; ii < 8; ++ii)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) acc[ii][jj] = fmaf(a[ii], b[jj], acc[ii][jj]);
    }
    mbar_arrive(empty + 8 * s);
  }
  consumers_sync();
  float* C = reinterpret_cast<float*>(base_ptr);
#pragma unroll
  for (int ii = 0; ii < 8; ++ii) {
    const int r = ii < 4 ? 4 * ty + ii : 64 + 4 * ty + ii - 4;
    float* row = C + r * c_pitch<Cfg>();
    *reinterpret_cast<float4*>(row + 4 * tx) =
        make_float4(acc[ii][0], acc[ii][1], acc[ii][2], acc[ii][3]);
    *reinterpret_cast<float4*>(row + 64 + 4 * tx) =
        make_float4(acc[ii][4], acc[ii][5], acc[ii][6], acc[ii][7]);
  }
  consumers_sync();
  finish(p, C);
}

// f32, K-major: tiles of 128-byte rows (32 floats of k), 16-byte chunk c of
// row r stored at chunk c ^ (r % 8).  Thread (ty, tx) holds rows ty + 16 i
// (i < RI = BM / 16; r % 8 = ty % 8 for all of them) and the column pairs
// (2 g, 2 g + 1), g = tx + 16 q (q < QN = BN / 32).  It reads B row
// 2 g + (e ^ flip) into slot e, flip = bit 2 of tx: for a fixed slot, the
// 8 threads of a shared-memory phase (tx 0-7 or 8-15, one ty) then read
// rows whose r % 8 are all different, hence 8 different chunks (without
// the flip, tx and tx + 4 would share one).  The A reads of a phase are
// one address (a broadcast).
template <class P>
__device__ __forceinline__ void consume_f32k(const P& p, uint8_t* base_ptr,
                                             uint32_t full, uint32_t empty,
                                             int nk) {
  using Cfg = typename P::Cfg;
  constexpr int SB = stage_bytes<Cfg>();
  constexpr int RI = Cfg::BM / 16, QN = Cfg::BN / 32;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int flip = (tx >> 2) & 1;
  const int xa = ty & 7;
  const int rb0 = 2 * tx + flip, rb1 = 2 * tx + (flip ^ 1);
  const int xb0 = rb0 & 7, xb1 = rb1 & 7;
  float acc[RI][2 * QN];                  // acc[i][2 q + e]
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < 2 * QN; ++j) acc[i][j] = 0.f;
  for (int i = 0; i < nk; ++i) {
    const int s = i % Cfg::STAGES;
    mbar_wait(full + 8 * s, (i / Cfg::STAGES) & 1);
    const uint8_t* As = base_ptr + s * SB;
    const uint8_t* Bs = As + Cfg::A_BYTES;
#pragma unroll 2
    for (int kc = 0; kc < Cfg::BK / 4; ++kc) {
      float4 a[RI], b[2 * QN];
#pragma unroll
      for (int ii = 0; ii < RI; ++ii)
        a[ii] = *reinterpret_cast<const float4*>(
            As + (ty + 16 * ii) * 128 + ((kc ^ xa) << 4));
#pragma unroll
      for (int q = 0; q < QN; ++q) {
        b[2 * q] = *reinterpret_cast<const float4*>(
            Bs + (rb0 + 32 * q) * 128 + ((kc ^ xb0) << 4));
        b[2 * q + 1] = *reinterpret_cast<const float4*>(
            Bs + (rb1 + 32 * q) * 128 + ((kc ^ xb1) << 4));
      }
#pragma unroll
      for (int ii = 0; ii < RI; ++ii)
#pragma unroll
        for (int jj = 0; jj < 2 * QN; ++jj) {
          float t = acc[ii][jj];
          t = fmaf(a[ii].x, b[jj].x, t);
          t = fmaf(a[ii].y, b[jj].y, t);
          t = fmaf(a[ii].z, b[jj].z, t);
          t = fmaf(a[ii].w, b[jj].w, t);
          acc[ii][jj] = t;
        }
    }
    mbar_arrive(empty + 8 * s);
  }
  consumers_sync();
  float* C = reinterpret_cast<float*>(base_ptr);
#pragma unroll
  for (int ii = 0; ii < RI; ++ii)
#pragma unroll
    for (int q = 0; q < QN; ++q) {
      const float u = acc[ii][2 * q], v = acc[ii][2 * q + 1];
      *reinterpret_cast<float2*>(C + (ty + 16 * ii) * c_pitch<Cfg>() +
                                 2 * (tx + 16 * q)) =
          flip ? make_float2(v, u) : make_float2(u, v);
    }
  consumers_sync();
  finish(p, C);
}

// ---------------------------------------------------------------- kernel

template <class P>
__global__ void __launch_bounds__(NTHREADS, P::Cfg::BLOCKS)
    gemm(const __grid_constant__ P p) {
  using Cfg = typename P::Cfg;
  constexpr int SB = stage_bytes<Cfg>();
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t pad = ((raw + 1023) & ~1023u) - raw;
  const uint32_t base = raw + pad;
  uint8_t* base_ptr = smem_raw + pad;
  const uint32_t full = base + Cfg::STAGES * SB;          // STAGES barriers
  const uint32_t empty = full + 8 * Cfg::STAGES;          // STAGES barriers
  if (threadIdx.x == 0) {
    for (int s = 0; s < Cfg::STAGES; ++s) {
      mbar_init(full + 8 * s, 1);           // the producer's expect_tx
      mbar_init(empty + 8 * s, NCONS);      // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();
  int it0, it1;
  p.k_range(it0, it1);
  const int nk = it1 > it0 ? it1 - it0 : 0;
  if (threadIdx.x >= NCONS) {               // the producer warp
    if (threadIdx.x == NCONS) {
      for (int i = 0; i < nk; ++i) {
        const int s = i % Cfg::STAGES;
        if (i >= Cfg::STAGES)
          mbar_wait(empty + 8 * s, ((i / Cfg::STAGES) - 1) & 1);
        mbar_expect_tx(full + 8 * s, SB);
        p.load(it0 + i, base + s * SB, base + s * SB + Cfg::A_BYTES,
               full + 8 * s);
      }
    }
  } else if constexpr (sizeof(typename Cfg::T) == 2) {
    consume_bf16(p, base, base_ptr, full, empty, nk);
  } else if constexpr (Cfg::K_MAJOR) {
    consume_f32k(p, base_ptr, full, empty, nk);
  } else {
    consume_f32(p, base_ptr, full, empty, nk);
  }
}

template <class P>
cudaError_t launch(const P& p, dim3 grid, cudaStream_t s) {
  using Cfg = typename P::Cfg;
  cudaError_t e = cudaFuncSetAttribute(
      gemm<P>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<Cfg>());
  if (e == cudaSuccess && Cfg::BLOCKS > 1)       // room for BLOCKS an SM
    e = cudaFuncSetAttribute(gemm<P>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             100);
  if (e != cudaSuccess) return e;
  gemm<P><<<grid, NTHREADS, smem_bytes<Cfg>(), s>>>(p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- host

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q) != cudaSuccess)
      return nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) != cudaSuccess)
      return nullptr;
#endif
    if (q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 4-D view of memory: dims innermost first (d[0] contiguous), s[i] the
// stride of dim i+1 in elements (each a multiple of 16 bytes).
struct View {
  long long d[4], s[3];
};

// the row-major tensor [d3][d2][d1][d0]
inline View dense(long long d0, long long d1, long long d2, long long d3) {
  return View{{d0, d1, d2, d3}, {d0, d0 * d1, d0 * d1 * d2}};
}

// A tensor map of v with the given box (innermost first).  Elements
// outside the view load as zeros.
template <class Cfg>
cudaError_t encode(CUtensorMap* map, const void* ptr, const View& v,
                   const cuuint32_t (&box)[4]) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return cudaErrorNotSupported;
  const long long es = sizeof(typename Cfg::T);
  for (int i = 0; i < 4; ++i)
    if (v.d[i] < 1) return cudaErrorInvalidValue;
  const cuuint64_t dims[4] = {(cuuint64_t)v.d[0], (cuuint64_t)v.d[1],
                              (cuuint64_t)v.d[2], (cuuint64_t)v.d[3]};
  const cuuint64_t strides[3] = {(cuuint64_t)(v.s[0] * es),
                                 (cuuint64_t)(v.s[1] * es),
                                 (cuuint64_t)(v.s[2] * es)};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, Cfg::DTYPE, 4, const_cast<void*>(ptr), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        Cfg::SWIZZLE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// MN-major k-tile boxes: [1][1][Cfg::BK rows][Cfg::BOX]
template <class Cfg>
cudaError_t encode_mn(CUtensorMap* map, const void* ptr, const View& v) {
  const cuuint32_t box[4] = {(cuuint32_t)Cfg::BOX, (cuuint32_t)Cfg::BK, 1, 1};
  return encode<Cfg>(map, ptr, v, box);
}

// K-major k-tile boxes: Cfg::BK along dim 0 and ``rows`` along dim
// ``row_dim`` (1 or 2), one elsewhere: a [rows][BK] tile in shared memory
template <class Cfg>
cudaError_t encode_k(CUtensorMap* map, const void* ptr, const View& v,
                     int rows, int row_dim = 1) {
  const cuuint32_t box[4] = {(cuuint32_t)Cfg::BK,
                             row_dim == 1 ? (cuuint32_t)rows : 1u,
                             row_dim == 2 ? (cuuint32_t)rows : 1u, 1};
  return encode<Cfg>(map, ptr, v, box);
}

}  // namespace hg
