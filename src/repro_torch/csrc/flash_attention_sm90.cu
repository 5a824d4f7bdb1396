// Flash-attention forward in bf16 for Hopper (sm_90a): tensor-core products
// with wgmma, TMA loads into swizzled shared memory, a K/V ring on mbarriers,
// a producer warpgroup and one or two consumer warpgroups. Written by hand.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:_flash_kernel
// (reached through flash_attention_tpu) for bf16 inputs; fp32 inputs take the
// split-TF32 mma.sync kernel in flash_attention.cu. Same function: GQA attention over
// q (B, H, Sq, D) and k/v (B, KV, Skv, D), H % KV == 0, with causal,
// local-window (q_pos - k_pos < window) or bidirectional masks, an absolute
// q_offset, any Sq and Skv, head_dim 16, 32, 64, 128 or 256 (one template).
// It rounds where the reference model's chunked twin rounds
// (src/repro/nn/attention.py:_flash_block): S = q.k from bf16 operands with
// fp32 accumulation, times the scale (folded with log2(e) into one fp32
// multiply); row max, alpha and the normalizer l in fp32, l summing the fp32
// exponentials; the unnormalized probabilities rounded to bf16 as the A
// operand of P.V; the output acc / max(l, 1e-30) in bf16. Masked scores are
// -1e30 (keys past Skv: -inf, so their probability is exactly 0). The kv walk
// runs over the tiles [lo, hi): hi stops at the causal diagonal, lo starts
// at q_start - window. No atomics and no split over keys: two launches on the
// same inputs give the same bits. For training the wrapper passes an fp32
// lse (B, H, Sq): each row's logsumexp of its masked scaled scores in
// natural-log units, (m + log2 l) ln 2 since m and l live in base 2 here,
// written by the row's quad leader in the epilogue; the backward
// (flash_attention_bwd.cu) recomputes P from it. Serving passes nullptr and
// gets what it got before lse existed, bit for bit.
//
// What bounds it on this card. At the main paths' prefill shapes the least
// times are (bytes of q, k, v, o once over 3.35 TB/s; 4.D FLOP per unmasked
// (query, key) pair over 989 TFLOP/s bf16):
//   smollm-360m      B8 H15 KV5 S512  D64  causal      0.0063 ms (bytes)
//   smollm-360m      B8 H15 KV5 S2048 D64  causal      0.0652 ms (operations)
//   recurrentgemma   B8 H10 KV1 S512  D256 window 2048 0.0138 ms (bytes)
//   recurrentgemma   B1 H10 KV1 S3072 D256 window 2048 0.0434 ms (operations)
// Only wgmma reaches the tensor cores' rate, so both products are wgmma:
//   * S = Q.K^T is an SS wgmma (m64 x BK x k16 steps over D): Q (64 rows of
//     one warpgroup) and K (BK keys) both K-major in shared memory;
//   * O += P.V is an RS wgmma (m64 x D x k16 steps over BK): P comes from
//     registers, V (keys x D, row-major) is an MN-major B operand read with
//     the transpose bit;
//   * warpgroup 0 of a block is the producer: it drops to 24 or 40
//     registers (setmaxnreg) and one of its threads issues every TMA load.
//     Each consumer warpgroup rises to 232 registers and owns 64 query rows
//     of one (batch, q head). Up to D = 64 a block has one consumer and two
//     blocks share a SM (each block's set-up and last stores hide behind the
//     other's products; a block of two consumers was slower at smollm's
//     shapes on an H100); above, a block has two consumers that share each
//     K/V tile, one block a SM. Either way two consumer warpgroups run on a
//     SM, and one's softmax overlaps the other's wgmma;
//   * K and V tiles go through a ring of 2 stages, each with its own
//     mbarriers (K full, V full, stage empty), so the next tile's copy
//     overlaps this tile's products, and S starts before V has landed;
//   * blocks run the heaviest query tiles first (the causal diagonal's far
//     end), so the last wave is the light one.
// Tiles: BK = 128 keys up to D = 128, 64 at D = 256. Registers at D = 256:
// O 128, S 32, P 16 a thread. Shared memory: Q (64 or 128 rows) x D, 2
// stages of K and V BK x D, all bf16: 73 KB a block at D = 64 (two blocks a
// SM), 161 KB at D = 128, 193 KB at D = 256 (Cfg::SMEM).
//
// What was hard, and where it is solved:
//   1. TMA descriptors. cuTensorMapEncodeTiled is a driver-API call; it is
//      taken through cudaGetDriverEntryPoint (tensor_map_encoder), so the
//      library links no -lcuda. The maps are 3-D views (D, S, B.heads), so a
//      ragged tail tile stops at its own head: TMA zero-fills rows past S
//      (and the kpos < Skv mask still applies: a zero K row scores 0, not
//      -1e30). Each map reaches the kernel as a __grid_constant__ parameter.
//   2. Alignment. TMA needs a 16-byte base; the wrapper
//      (kernels/flash_attention.py) raises on a misaligned pointer and never
//      falls back. Strides are D.2 >= 32 bytes.
//   3. Swizzle. The head dim is cut into panels of PW = min(D, 64) columns,
//      one swizzle span (32, 64 or 128 bytes); the TMA box and every wgmma
//      descriptor use the same span (smem_desc's layout code), and each
//      panel starts on a 1024-byte boundary. K-major steps of 16 columns add
//      32 bytes to the start address inside a span; MN-major V steps of 16
//      keys add 16 rows.
//   4. Serialized wgmma. Between wgmma.fence and wait_group only wgmma
//      instructions run; accumulators are touched before the fence and after
//      the wait (fence_regs pins the compiler's order). The build log is
//      checked for ptxas's "serialized" advisory (chip_smoke.py phase 2).
//      Issuing the next tile's S before this tile's P.V, so that a softmax
//      overlaps a product inside one warpgroup, drew that advisory (C7513:
//      non-wgmma instructions defining input registers of a wgmma inside
//      the pipeline stage) and ran slower on an H100, so each group is
//      waited out and the overlap comes from the second consumer warpgroup
//      on the SM.
//   5. The S fragment to the P operand. The S accumulator's fragment (rows
//      g and g + 8 of the warp's 16, columns 8j + 2(lane % 4) + {0, 1}) is
//      the A-operand fragment of the RS wgmma once two n8 chunks are packed
//      to bf16x2 (pack_bf16). A row lives in the 4 lanes of a quad, so its max
//      and sum go over __shfl_xor 1 and 2; l stays a per-thread partial sum
//      until the end.

#include <cuda.h>  // CUtensorMap and its enums; the entry point comes from the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WG_THREADS = 128;  // a warpgroup
constexpr int STAGES = 2;        // K/V ring depth (a third was no faster on an H100)
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int D>
struct Cfg {
  // Consumer warpgroups of 64 query rows each (see the header).
  static constexpr int CONSUMERS = D <= 64 ? 1 : 2;
  static constexpr int BQ = 64 * CONSUMERS;        // query rows per block
  static constexpr int THREADS = WG_THREADS * (1 + CONSUMERS);
  static constexpr int MIN_BLOCKS = CONSUMERS == 1 ? 2 : 1;
  // setmaxnreg targets: the register file a block gets at launch, moved from
  // the producer warpgroup to the consumers (65,536 / MIN_BLOCKS in all).
  static constexpr int PRODUCER_REGS = CONSUMERS == 1 ? 24 : 40;
  static constexpr int CONSUMER_REGS = 232;
  static constexpr int PW = D < 64 ? D : 64;      // panel width in elements
  static constexpr int SPAN = PW * 2;             // bytes of a panel row = swizzle span
  static constexpr int NP = D / PW;               // panels across the head dim
  static constexpr int BK = D >= 256 ? 64 : 128;  // keys per tile
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;     // K or V, one stage
  static constexpr int BARRIERS = 1 + 3 * STAGES; // q full; K full, V full, empty per stage
  // 1024 bytes of slack to align the tiles to the 128-byte swizzle's period.
  static constexpr int SMEM = 1024 + Q_BYTES + 2 * STAGES * KV_BYTES + 8 * BARRIERS;
  // wgmma descriptor layout type: 1 = 128-byte swizzle, 2 = 64, 3 = 32.
  static constexpr uint64_t LAYOUT = SPAN == 128 ? 1 : SPAN == 64 ? 2 : 3;
  static constexpr CUtensorMapSwizzle SWIZZLE =
      SPAN == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                  : SPAN == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers -------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait until the phase of parity `parity` has completed. A phase that has
// not completed after about 2^35 cycles (some 20 s) is a fault: trap, so the
// launch fails instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  long long start = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) start = clock64();
    else if (clock64() - start > (1ll << 35)) __trap();
  }
}

// ---- TMA -------------------------------------------------------------------

// One box of a 3-D tensor map into shared memory; completes on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// ---- wgmma -----------------------------------------------------------------

// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets (16-byte units) and the swizzle layout type.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                             uint64_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed wgmma groups are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of accumulator registers
// across the wgmma fence / wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// D (m64 x N, fp32) (+)= A (m64 x k16, bf16, shared, K-major) . B (N x k16,
// bf16, shared, K-major); scale_d = 0 overwrites D.
template <int N>
__device__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db, int scale_d);
// D (m64 x N, fp32) += A (m64 x k16, bf16, registers) . B (k16 x N, bf16,
// shared, MN-major: the transpose bit is set).
template <int N>
__device__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db);

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t da,
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, "
      "1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t da,
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34,"
      " %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, "
      "%51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1,"
      " 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8], const uint32_t (&a)[4],
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16], const uint32_t (&a)[4],
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, "
      "%18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4],
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, "
      "%34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t (&a)[4],
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34,"
      " %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, "
      "%51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, "
      "%67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<256>(float (&d)[128], const uint32_t (&a)[4],
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34,"
      " %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, "
      "%51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67,"
      " %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "
      "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, "
      "%114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127},"
      " {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]),
        "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]),
        "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]),
        "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]),
        "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]),
        "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]),
        "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]),
        "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]),
        "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// ---- the kernel ------------------------------------------------------------

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two fp32 values as one bf16x2 register, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---- the consumer's steps --------------------------------------------------

// Issue S = Q K^T for one tile, over D in k16 steps (no wait).
template <int D>
__device__ __forceinline__ void issue_qk(float (&sc)[Cfg<D>::BK / 2], uint32_t q_base,
                                         uint32_t k_base) {
  using C = Cfg<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int panel = (kk * 16) / C::PW;
    const uint32_t off = ((kk * 16) % C::PW) * 2;  // bytes into the swizzle span
    wgmma_ss<C::BK>(
        sc, smem_desc(q_base + panel * C::BQ * C::SPAN + off, 16, 8 * C::SPAN, C::LAYOUT),
        smem_desc(k_base + panel * C::BK * C::SPAN + off, 16, 8 * C::SPAN, C::LAYOUT), kk > 0);
  }
}

// Issue O += P V for one tile, over BK in k16 steps (no wait).
template <int D>
__device__ __forceinline__ void issue_pv(float (&acc)[D / 2],
                                         const uint32_t (&pa)[Cfg<D>::BK / 16][4],
                                         uint32_t v_base) {
  using C = Cfg<D>;
#pragma unroll
  for (int ks = 0; ks < C::BK / 16; ++ks)
    wgmma_rs<D>(acc, pa[ks],
                smem_desc(v_base + ks * 16 * C::SPAN, C::BK * C::SPAN, 8 * C::SPAN, C::LAYOUT));
}

// The online softmax of one tile's scores: scale into the log2 domain, mask,
// the new row max over the quad (m), alpha, P as bf16 A fragments, and this
// thread's part of l. sc[4j + 2hh + cc] is row row0 + 8hh, key
// k0 + 8j + 2 quad + cc.
template <int D>
__device__ __forceinline__ void softmax_tile(float (&sc)[Cfg<D>::BK / 2],
                                             uint32_t (&pa)[Cfg<D>::BK / 16][4], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2], float scale_log2,
                                             int k0, int row0, int quad, bool need_mask,
                                             int Skv, int causal, int window) {
  constexpr int BK = Cfg<D>::BK;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) sc[i] = __fmul_rn(sc[i], scale_log2);
  if (need_mask) {
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          const int kpos = k0 + 8 * j + 2 * quad + cc, qpos = row0 + 8 * hh;
          float& x = sc[4 * j + 2 * hh + cc];
          if ((causal && qpos < kpos) || (window > 0 && qpos - kpos >= window)) x = NEG_INF;
          if (kpos >= Skv) x = -__int_as_float(0x7f800000);  // no such key: -inf, p = 0
        }
  }
  float m_new[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      m_new[hh] = fmaxf(m_new[hh], fmaxf(sc[4 * j + 2 * hh], sc[4 * j + 2 * hh + 1]));
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    m_new[hh] = fmaxf(m_new[hh], __shfl_xor_sync(0xffffffffu, m_new[hh], 1));
    m_new[hh] = fmaxf(m_new[hh], __shfl_xor_sync(0xffffffffu, m_new[hh], 2));
    alpha[hh] = exp2_approx(m[hh] - m_new[hh]);
    m[hh] = m_new[hh];
    l[hh] *= alpha[hh];
  }
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    float p[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      p[e] = exp2_approx(sc[4 * j + e] - m[e / 2]);
      l[e / 2] += p[e];
    }
    // Chunk j = 2ks + half: row g into registers 0 and 2, row g + 8 into 1 and 3.
    pa[j / 2][2 * (j % 2) + 0] = pack_bf16(p[0], p[1]);
    pa[j / 2][2 * (j % 2) + 1] = pack_bf16(p[2], p[3]);
  }
}

template <int D>
__device__ __forceinline__ void rescale(float (&acc)[D / 2], const float (&alpha)[2]) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    acc[4 * j + 0] *= alpha[0];
    acc[4 * j + 1] *= alpha[0];
    acc[4 * j + 2] *= alpha[1];
    acc[4 * j + 3] *= alpha[1];
  }
}

template <int D>
__global__ void __launch_bounds__(Cfg<D>::THREADS, Cfg<D>::MIN_BLOCKS)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ o,
                      float* __restrict__ lse, int H, int KV, int Sq, int Skv, int causal,
                      int window, int q_offset, float scale_log2) {
  using C = Cfg<D>;
  constexpr int BQ = C::BQ, BK = C::BK, SPAN = C::SPAN, PW = C::PW;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t s_q = (smem_u32(smem_raw) + 1023) & ~1023u;  // NP panels of BQ rows
  const uint32_t s_k = s_q + C::Q_BYTES;                      // STAGES x NP panels of BK rows
  const uint32_t s_v = s_k + STAGES * C::KV_BYTES;            // the same for V
  const uint32_t bars = s_v + STAGES * C::KV_BYTES;
  const uint32_t q_full = bars;
  // Barrier of stage s: K full at 1 + s, V full at 1 + STAGES + s, empty at 1 + 2 STAGES + s.
  const uint32_t k_full = bars + 8, v_full = k_full + 8 * STAGES, empty = v_full + 8 * STAGES;

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;  // heaviest query tiles first
  const int bh_q = b * H + h, bh_kv = b * KV + h / (H / KV);
  const int q_start = q_offset + q0;  // absolute position of the block's row 0
  int hi = (Skv + BK - 1) / BK;
  if (causal) hi = min(hi, (q_start + BQ - 1) / BK + 1);
  int lo = 0;
  if (window > 0 && q_start - window > 0) lo = (q_start - window) / BK;
  const int n_tiles = max(hi - lo, 0);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * C::CONSUMERS);  // lane 0 of every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / WG_THREADS;
  if (wg == 0) {
    // Producer: one thread keeps the ring full.
    setmaxnreg_dec<C::PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, C::Q_BYTES);
#pragma unroll
      for (int p = 0; p < C::NP; ++p)
        tma_load(s_q + p * BQ * SPAN, &tm_q, q_full, p * PW, q0, bh_q);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % STAGES;
        mbar_wait(empty + 8 * s, ((it / STAGES) & 1) ^ 1);  // first round passes
        const int k0 = (lo + it) * BK;
        mbar_expect_tx(k_full + 8 * s, C::KV_BYTES);
#pragma unroll
        for (int p = 0; p < C::NP; ++p)
          tma_load(s_k + s * C::KV_BYTES + p * BK * SPAN, &tm_k, k_full + 8 * s, p * PW, k0,
                   bh_kv);
        mbar_expect_tx(v_full + 8 * s, C::KV_BYTES);
#pragma unroll
        for (int p = 0; p < C::NP; ++p)
          tma_load(s_v + s * C::KV_BYTES + p * BK * SPAN, &tm_v, v_full + 8 * s, p * PW, k0,
                   bh_kv);
      }
    }
  } else {
    // Consumer c: query rows 64c .. 64c + 63 of the block.
    setmaxnreg_inc<C::CONSUMER_REGS>();
    const int c = wg - 1;
    const int tid = threadIdx.x % WG_THREADS;
    const int warp = tid / 32, lane = tid % 32, g = lane / 4, quad = lane % 4;
    const int wg_first = q_start + 64 * c, wg_last = wg_first + 63;
    const int row0 = wg_first + 16 * warp + g;  // this thread's rows: row0 and row0 + 8

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m[2] = {NEG_INF, NEG_INF};  // running max of the scaled log2 scores
    float l[2] = {0.f, 0.f};          // this thread's part of the normalizer

    const uint32_t q_base = s_q + 64 * c * SPAN;
    mbar_wait(q_full, 0);

    // Tiles no row of this warpgroup may see (before the window, past the
    // diagonal) are a prefix and a suffix of the walk; only [t_lo, t_hi)
    // is computed. Every stage is still waited for (its fill has landed)
    // and released, so the ring's phases stay in step with the producer.
    auto dead = [&](int it) {
      const int k0 = (lo + it) * BK;
      return (causal && k0 > wg_last) || (window > 0 && wg_first - (k0 + BK - 1) >= window);
    };
    auto need_mask = [&](int k0) {
      return k0 + BK > Skv || (causal && k0 + BK - 1 > wg_first) ||
             (window > 0 && wg_last - k0 >= window);
    };
    auto stage_k = [&](int it) { return s_k + (it % STAGES) * C::KV_BYTES; };
    auto stage_v = [&](int it) { return s_v + (it % STAGES) * C::KV_BYTES; };
    auto wait_k = [&](int it) { mbar_wait(k_full + 8 * (it % STAGES), (it / STAGES) & 1); };
    auto wait_v = [&](int it) { mbar_wait(v_full + 8 * (it % STAGES), (it / STAGES) & 1); };
    auto release = [&](int it) {
      if (lane == 0) mbar_arrive(empty + 8 * (it % STAGES));
    };
    int t_lo = 0, t_hi = n_tiles;
    while (t_lo < t_hi && dead(t_lo)) ++t_lo;
    while (t_hi > t_lo && dead(t_hi - 1)) --t_hi;
    for (int it = 0; it < t_lo; ++it) {
      wait_v(it);
      release(it);
    }
    for (int it = t_lo; it < t_hi; ++it) {
      const int k0 = (lo + it) * BK;
      float sc[BK / 2], alpha[2];
      uint32_t pa[BK / 16][4];
      wait_k(it);
      wgmma_fence();
      issue_qk<D>(sc, q_base, stage_k(it));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      softmax_tile<D>(sc, pa, m, l, alpha, scale_log2, k0, row0, quad, need_mask(k0), Skv,
                      causal, window);
      rescale<D>(acc, alpha);
      wait_v(it);
      wgmma_fence();
      issue_pv<D>(acc, pa, stage_v(it));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      release(it);
    }
    for (int it = t_hi; it < n_tiles; ++it) {
      wait_v(it);
      release(it);
    }

    // Normalize and store rows below Sq.
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
      l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
    }
    __nv_bfloat16* op = o + (size_t)bh_q * Sq * D;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = row0 + 8 * hh - q_offset;
      if (r < Sq) {
        if (lse != nullptr && quad == 0)  // natural log: m and log2 l are base 2
          lse[(size_t)bh_q * Sq + r] = (m[hh] + log2f(l[hh])) * LN2;
        const float denom = fmaxf(l[hh], 1e-30f);
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          __nv_bfloat162 v = __floats2bfloat162_rn(acc[4 * j + 2 * hh] / denom,
                                                   acc[4 * j + 2 * hh + 1] / denom);
          *reinterpret_cast<__nv_bfloat162*>(op + (size_t)r * D + 8 * j + 2 * quad) = v;
        }
      }
    }
  }
}

// ---- host side -------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime (no -lcuda).
EncodeTiled tensor_map_encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status) ==
            cudaSuccess &&
        status == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 3-D map over a contiguous (BH, S, D) bf16 tensor, boxes of rows x PW.
template <int D>
bool make_map(CUtensorMap* map, const void* ptr, int S, int BH, int rows) {
  using C = Cfg<D>;
  EncodeTiled encode = tensor_map_encoder();
  if (!encode) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)S * D * 2};
  const cuuint32_t box[3] = {(cuuint32_t)C::PW, (cuuint32_t)rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, C::SWIZZLE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                   int H, int KV, int Sq, int Skv, int causal, int window, int q_offset,
                   float scale, cudaStream_t stream) {
  using C = Cfg<D>;
  CUtensorMap tm_q, tm_k, tm_v;
  if (!make_map<D>(&tm_q, q, Sq, B * H, C::BQ) || !make_map<D>(&tm_k, k, Skv, B * KV, C::BK) ||
      !make_map<D>(&tm_v, v, Skv, B * KV, C::BK))
    return cudaErrorInvalidValue;
  // The shared-memory limit is a per-device attribute of the function: set
  // it at the first launch on each device, not at every launch.
  static unsigned long long smem_set = 0;  // bit d: set on device d
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || !((smem_set >> dev) & 1)) {
    err = cudaFuncSetAttribute(flash_fwd_sm90_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) return err;
    if (dev < 64) smem_set |= 1ull << dev;
  }
  const dim3 grid(H, B, (Sq + C::BQ - 1) / C::BQ);
  flash_fwd_sm90_kernel<D><<<grid, C::THREADS, C::SMEM, stream>>>(
      tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(o), lse, H, KV, Sq, Skv, causal, window,
      q_offset, scale * LOG2E);
  return cudaGetLastError();
}

}  // namespace

// Dynamic shared memory one block uses at head dim D, in bytes (-1 if D is
// not supported).
extern "C" int flash_attention_sm90_smem_bytes(int D) {
  switch (D) {
    case 16: return Cfg<16>::SMEM;
    case 32: return Cfg<32>::SMEM;
    case 64: return Cfg<64>::SMEM;
    case 128: return Cfg<128>::SMEM;
    case 256: return Cfg<256>::SMEM;
    default: return -1;
  }
}

// bf16 tensors, contiguous, (B, heads, S, D), 16-byte aligned. lse is
// nullptr (serving: bit for bit what the kernel computed before lse
// existed) or a (B, H, Sq) fp32 tensor for each row's logsumexp in
// natural-log units (training). Returns cudaGetLastError() after the launch
// (0 on success).
extern "C" int flash_attention_sm90_fwd(const void* q, const void* k, const void* v, void* o,
                                        void* lse, int B, int H, int KV, int Sq, int Skv, int D,
                                        int causal, int window, int q_offset, float scale,
                                        void* stream) {
  if (B <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || Sq <= 0 || Skv <= 0 || q_offset < 0 ||
      window < 0 || B > 65535 || (Sq + 63) / 64 > 65535)
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) % 16)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* lf = static_cast<float*>(lse);
  switch (D) {
    case 16: return (int)launch<16>(q, k, v, o, lf, B, H, KV, Sq, Skv, causal, window, q_offset, scale, s);
    case 32: return (int)launch<32>(q, k, v, o, lf, B, H, KV, Sq, Skv, causal, window, q_offset, scale, s);
    case 64: return (int)launch<64>(q, k, v, o, lf, B, H, KV, Sq, Skv, causal, window, q_offset, scale, s);
    case 128: return (int)launch<128>(q, k, v, o, lf, B, H, KV, Sq, Skv, causal, window, q_offset, scale, s);
    case 256: return (int)launch<256>(q, k, v, o, lf, B, H, KV, Sq, Skv, causal, window, q_offset, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
