// Flash-attention backward in bf16 for Hopper (sm_90a): tensor-core products
// with wgmma, TMA loads into swizzled shared memory, a ring of streamed tiles
// on mbarriers, a producer warpgroup and one or two consumer warpgroups.
// Written by hand.
//
// The TPU side has no backward kernel: the JAX package trains through
// autodiff of the jnp twin of src/repro/kernels/flash_attention.py:
// _flash_kernel (src/repro/nn/attention.py:flash_attention). This is the
// backward of the bf16 forward (flash_attention_sm90.cu), bound to it by
// FlashAttentionFn in kernels/flash_attention.py; fp32 inputs take the
// split-TF32 mma.sync backward on the tensor cores in flash_attention_bwd.cu.
// Same function as the forward: GQA over q (B, H, Sq, D) and k/v (B, KV,
// Skv, D), H % KV == 0, causal, local-window (q_pos - k_pos < window) or
// bidirectional masks, an absolute q_offset, any Sq and Skv, head_dim 16, 32,
// 64, 128 or 256 (recurrentgemma's). Its plain version is
// kernels/ref.py:flash_attention_bwd_ref.
//
// What it computes, from q, k, v, the forward's output o, the output's
// gradient do and the forward's fp32 row logsumexp lse (natural log):
//   Δ = rowsum(dO∘O)                      (fp32, from o as the forward rounded it)
//   P = exp(S·scale - lse)                (fp32, 0 where masked)
//   dV = Pᵀ·dO,  dP = dO·Vᵀ,  dS = P∘(dP - Δ)
//   dQ = dS·K·scale,  dK = dSᵀ·Q·scale    (a GQA group's heads summed into dK, dV)
// Rounding: the products take bf16 operands and accumulate in fp32. P is
// rounded to bf16 for dV = Pᵀ·dO, where autodiff of the reference's twin
// rounds it (its P·V takes p.astype(v.dtype), src/repro/nn/attention.py:95);
// dS is rounded to bf16 for dK and dQ, which the twin does not do (its bound
// is tests/test_torch_kernels.py's model of this arithmetic). The scale is
// applied in fp32: folded with log2(e) into the exponent of P, and on the
// fp32 sums of dQ and dK before they are rounded to bf16.
//
// Deterministic: every output element is summed in a fixed order. Two
// routes by head dim. At D = 128 and 256, the FlashAttention-2 split into a
// Δ pass, a dK/dV kernel and a dQ kernel, no atomics. At D = 16, 32 and 64
// (FUSED_DQ_HEAD_DIMS, the fused route) the dK/dV kernel also computes dQ
// and adds its parts across blocks in a fixed order (below), and a pass
// scales and rounds the sums. The kernels:
//   1. flash_bwd_delta_sm90: Δ, D/8 threads a row, 16 bytes each, summed
//      over a fixed shuffle tree; fused, it also zeroes the turn counters.
//   2. flash_bwd_dkdv_sm90: one block a (b, kv head, key tile of 64, slice
//      of the walk). It keeps its K and V tiles and the dK, dV accumulators
//      (registers) and walks its slice of the key tile's walk: the G query
//      heads of its group, then the query tiles that see any of its keys,
//      in that order, streaming Q, dO and the rows' lse and Δ through the
//      ring; fused, each step's dQ part too.
//   3. flash_bwd_reduce_sm90 (split > 1 only): dK = scale·Σ parts, dV = Σ
//      parts, in fp32, each rounded to bf16 once.
//   4. flash_bwd_dq_sm90 (D = 128, 256): one block a (b, q head, query tile
//      of 64). It keeps Q, dO, the rows' lse and Δ and walks the key tiles
//      its rows see, streaming K and V through the ring. Fused,
//      flash_bwd_dqsum_sm90 instead: dQ = scale·(the fp32 sum) in bf16, and
//      zeros for a query tile no key tile's walk holds.
// The split of the dK/dV walk (the caller's `split`, P; the plan is
// kernels/flash_attention.py:bwd_split), as in flash_attention_bwd.cu: under
// MQA (recurrentgemma, G = 10) and GQA 8:1 (qwen2.5) the grid had 64 and 128
// blocks for the card's 132 and 264 slots, key tile 0's block walking 3.7
// times an even share of the launch's (head, query tile) steps. Each key
// tile's walk is cut into P contiguous slices, [p·n/P, (p+1)·n/P) of its n
// steps, one block each, key tile on the grid's slowest axis (y = tile·P +
// p), so the heaviest slices still start first; one P for the launch, not
// one a tile, for the reason that source gives. A block with P > 1 writes
// its fp32 accumulators, unscaled and unrounded, to its part of the
// caller's workspace, (2, P, B, KV, Skv, D) fp32 (dK's parts, then dV's);
// flash_bwd_reduce_sm90 adds the parts in slice order, p = 0 first, scales
// dK and rounds each sum to bf16 once: no partial is rounded to bf16. With P
// = 1 the block rounds its accumulators to bf16 itself, as before the
// split: the same code path and bits.
// Two launches on the same inputs give the same bits. The masks skip tiles as
// the forward's do; partial tiles are masked per element. Rows past Sq and
// keys past Skv load as zeros (TMA fills them) and get probability 0.
//
// The fused route (D <= 64, where the dK/dV tile is 64 queries wide, as the
// dQ tile is). The split route computes S = Q·Kᵀ and dP = dO·Vᵀ twice, in
// both tile kernels: seven products a (query, key) pair where five are
// needed. The dK/dV kernel already holds dSᵀ for every pair it visits, so
// after probs packs it the consumer stores it as bf16 into one of two
// 64 x 64 tiles (key rows of 64 queries, 128-byte swizzle; keys past Skv as
// zeros: their P, unmasked, may be inf and their K rows are zero), meets
// its warpgroup on named barrier 1, and issues dQ_part = dS·K as SS wgmma
// m64nDk16 with both transpose bits (dS MN-major from the tile, K MN-major
// from the resident tile), in the commit group of dV and dK. Those two
// products, their order and their inputs are the split route's: dK and dV
// keep its bits at every P. The part, fp32 and unscaled, goes into one of
// two buffers of 64 x D in panels of 32 columns (128-byte swizzle; 16 at D
// = 16, 64-byte), one adder warp each (producer warps 1 and 2).
// The ordered sum. Each (b, q head, query tile) has an int32 turn counter.
// The key tiles whose walks hold a query tile are one run (dq_run): the
// walks' query tiles rise with the key tile at both ends. The grid puts the
// key tiles in groups of `group` (key_tile_at): groups ascending, the tiles
// of a group descending, and a key tile's turn is how many of the run's key
// tiles come before it in that order (dq_turn). The adder waits until the
// counter equals its turn (ld.acquire.gpu), writes the part into the fp32
// workspace (TMA store) at turn 0 or adds it there (cp.reduce.async.bulk
// .add.f32) after, waits until the bulk operation is complete (not only
// read), and moves the counter on (red.release.gpu), async-proxy fences on
// both sides. So each element of dQ is first part + second + ... in fp32,
// in one order for given shapes and `group`. The caller's plan
// (flash_attention.py:dq_group): `group` the key tiles one wave of blocks
// holds where the launch is within two waves, else 1 (ascending). A causal
// walk reaches a query tile sooner the later its key tile; ascending, every
// key tile of a wave waits on the heaviest's pace (+12% at smollm S512, +19%
// at whisper's decoder, on the card), while grouped, a wave's tiles add in
// the order they arrive. Past two waves ascending keeps the blocks of a
// wave on the same query tiles: grouped, smollm S2048's adds spread over
// its 63 MB workspace, past L2, and took 20% longer.
// Why no block waits forever. A block waits only on adds by key tiles
// before its own in key_tile_at's order, whose blocks have lower linear
// indices (blockIdx.x fastest, then y = position·P + slice). The one
// assumption, which CUTLASS's stream-K and FlashAttention-3's deterministic
// backward also rest on: the card dispatches a grid's blocks in order of
// linear index, a block only once every lower one has been. Then the
// lowest unfinished block has been dispatched and waits on no unfinished
// block, so it finishes; by induction every block does, at any number of
// slots, however the adds are timed. tests/test_torch_kernels.py's
// schedule model checks it at 1 to 264 slots on every backward shape of
// chip_smoke.py at D <= 64. A wait that does not end in about 2^35 cycles,
// or a counter past the turn, traps (wait_turn): the launch fails instead
// of holding the card.
//
// What bounds it on this card. The five products (S, dP, dV, dQ, dK) are
// 10·D FLOP per unmasked (query, key) pair and head; the bytes are q, o, do,
// dq, k, v, dk, dv once each and the fp32 lse. At smollm-360m's training
// shape B8 H15 KV5 S512 D64 bf16 causal that is 10.09 GFLOP (0.0102 ms at
// 989 TFLOP/s) and 42.19 MB (0.0126 ms at 3.35 TB/s): the bytes bound it. At
// B8 S2048 it is 161.1 GFLOP (0.163 ms) and 168.8 MB (0.050 ms): the
// operations. At recurrentgemma-2b's, B8 H10 KV1 S512 D256 bf16 causal, it
// is 26.90 GFLOP (0.0272 ms) and 92.44 MB (0.0276 ms): the bytes, barely.
// The split route does seven products a pair, not five (S and dP in both
// tile kernels; nine at D = 256, below); the fused route five, plus the
// parts' adds (16 KB a step through L2: 1.04 GB at B8 S2048) and the
// workspace's pass. Both compute whole tiles on the causal diagonal.
//
// What the design does about what made the first bf16 backward slow (it ran
// on the CUDA cores in flash_attention_bwd.cu, which now serves fp32 inputs
// only, with split-TF32 mma.sync on the tensor cores):
//   * fp32 widening in shared memory: gone. Q, K, V and dO stay bf16, in
//     tiles that TMA loads into swizzled panels of PW = min(D, 64) columns
//     (one 32-, 64- or 128-byte swizzle span, each panel on a 1024-byte
//     boundary), the layout the wgmma descriptors read (sm90.cuh).
//   * scalar fmaf products: all seven are wgmma m64nNk16, bf16 in, fp32
//     accumulated in registers. The dK/dV kernel computes its tiles
//     transposed, keys as rows: Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ are SS wgmmas
//     (K, V, Q, dO all K-major over D); Pᵀ and dSᵀ then sit in registers
//     with keys as rows, which is the A-operand fragment of dV += Pᵀ·dO and
//     dK += dSᵀ·Q once packed to bf16x2 (as the forward packs P), with dO
//     and Q read again from the same shared tiles as MN-major B operands
//     (the transpose bit). The dQ kernel computes S = Q·Kᵀ and dP = dO·Vᵀ
//     and adds dS·K, dS from registers, K as the MN-major B operand.
//   * synchronous loads between __syncthreads: warpgroup 0 is the producer
//     (setmaxnreg down to 40 registers). One thread issues the TMA loads of
//     a stage once its empty barrier has flipped; in the dK/dV kernel the
//     producer warp also copies the stage's lse (times log2 e; +inf past Sq,
//     so those columns get P = 0 with no mask) and Δ into shared memory and
//     arrives on the same full barrier. The consumer warpgroup (up to 216
//     registers) waits on the full barrier, runs its products and releases
//     the stage, so the next tile's copy overlaps this tile's products.
//   * 98 KB of fp32 tiles a block: a block now holds two resident 64 x D
//     tiles and two stages of two streamed tiles, all bf16 (Cfg::SMEM_KV,
//     SMEM_Q): 50.0 KB at D = 64, 97.0 KB at D = 128; fused, two dSᵀ tiles
//     (16 KB) and two fp32 dQ buffers (2 x 64 x D x 4 B) more, 98.1 KB at D
//     = 64 (38.1 and 58.1 at 16 and 32). So two blocks share a SM at every
//     head dim up to 128 and one's exponentials overlap the other's
//     products.
//   * unequal blocks in key order: the dK/dV grid puts the key tile on its
//     slowest axis, key tile 0 first, which under a causal mask is the
//     heaviest; the dQ grid puts the last query tile first. The light
//     tiles fill the last wave.
// Registers of a consumer: dK and dV D/2 each, Sᵀ and dPᵀ KV_BN/2 each and
// the bf16 fragments of Pᵀ and dSᵀ KV_BN/4 each; the dK/dV tile is 64
// queries wide up to D = 64 and 32 at D = 128, so they stay under 216
// (160 at D = 64, 176 at D = 128, before indices and addresses); fused, the
// dQ part's D/2 more, in the place of Sᵀ and dPᵀ, dead by then. ptxas: 128
// registers at launch (setmaxnreg 40 / 216), no spill, at every head dim. Between
// wgmma.fence and wait_group only wgmma instructions run (sm90.cuh:
// fence_regs), and each group is waited out before its accumulators are
// read: the forward's rule against ptxas serializing the wgmma (C7513).
//
// Head dim 256 (recurrentgemma-2b) does not fit that budget: dK and dV alone
// take 256 registers a thread. So at D = 256:
//   * dK/dV: two consumer warpgroups split the head dim (Cfg::KV_CONSUMERS,
//     DC = 128 columns each): each keeps dK and dV for its 128 columns (128
//     registers), and each computes the whole Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ over
//     all 256 dims itself, from the same shared tiles, with the same wgmma,
//     so both hold the same Pᵀ and dSᵀ bits and need no exchange: 9 products
//     a (query, key) pair instead of 7, and no barrier between consumers but
//     the stage's empty barrier, which waits for the 8 consumer warps. The
//     other way, one consumer computing Sᵀ and the other dPᵀ and the two
//     swapping Pᵀ and dSᵀ as bf16 through shared memory on a named barrier,
//     saves 2 of the 9 products and adds that exchange and its waits a tile;
//     it is not taken. 384 threads, one block a SM (setmaxnreg 40 / 232 /
//     232), the dK/dV tile 32 queries wide: 176 registers of a consumer's
//     before indices.
//   * dQ: one consumer warpgroup holds the 64 x 256 fp32 dQ (128 registers
//     a thread) and walks 32-key tiles (Cfg::Q_BN: S and dP 16 registers
//     each), about 180 in all; one block a SM, launched with up to 255
//     registers a thread, sets no setmaxnreg.
//   * shared memory: K and V (dK/dV) or Q and dO (dQ) resident, 32 KB each,
//     and two stages of two streamed 32 x 256 tiles, 16 KB each: 129.5 KB a
//     block of either kernel.

#include "sm90.cuh"  // mbarriers, TMA, wgmma, the tensor-map encoder

namespace {

constexpr int STAGES = 2;  // streamed-tile ring depth
constexpr int REDUCE_THREADS = 256;
// Head dims whose dK/dV kernel also computes dQ (the fused route, a bit a
// head dim): dQ_part = dS·K from the dSᵀ it holds, summed across key tiles
// in ascending order; the dQ kernel is not launched there.
constexpr int FUSED_DQ_HEAD_DIMS = 16 | 32 | 64;
constexpr int DQ_BUFS = 2;  // fp32 dQ parts a fused block holds, one adder warp each

template <int D>
struct Cfg {
  static constexpr int PW = D < 64 ? D : 64;  // panel width in elements
  static constexpr int SPAN = PW * 2;         // bytes of a panel row = swizzle span
  static constexpr int NP = D / PW;           // panels across the head dim
  static constexpr uint64_t LAYOUT = desc_layout(SPAN);
  static constexpr CUtensorMapSwizzle SWIZZLE = tma_swizzle(SPAN);
  // A consumer warpgroup owns BM resident rows (keys in dK/dV, queries in
  // dQ) and walks streamed tiles of KV_BN queries (dK/dV) or Q_BN keys (dQ).
  // From D = 128 the dK/dV tile is 32 queries wide and from D = 256 the dQ
  // tile 32 keys wide, so the consumers' registers fit their budgets.
  static constexpr int BM = 64;
  static constexpr int KV_BN = D <= 64 ? 64 : 32;
  static constexpr int Q_BN = D <= 128 ? 64 : 32;
  // dK/dV consumer warpgroups: at D = 256, dK and dV would take 256
  // registers a thread in one, so two split the head dim, each owning DC
  // columns of dK and dV and computing the whole Sᵀ and dPᵀ itself.
  static constexpr int KV_CONSUMERS = D <= 128 ? 1 : 2;
  static constexpr int DC = D / KV_CONSUMERS;
  static constexpr int KV_THREADS = (1 + KV_CONSUMERS) * WG_THREADS;  // producer + consumers
  static constexpr int Q_THREADS = 2 * WG_THREADS;                    // producer + consumer
  // Up to D = 128 two blocks share a SM (a block's 256 threads share 32,768
  // registers); at D = 256 one block a SM, its shared memory being 129 KB.
  static constexpr int MIN_BLOCKS = D <= 128 ? 2 : 1;
  // setmaxnreg targets, multiples of 8 that spend the registers a block was
  // launched with: 128 a thread at two blocks (40 + 216 = 2 x 128); 168 at
  // D = 256 in the dK/dV kernel's 384 threads (40 + 2 x 232 = 3 x 168). The
  // producer keeps enough for its warp's lse/Δ copy. The dQ kernel at D =
  // 256 (256 threads, one block) sets none: launched at up to 255 registers
  // a thread, it has more than its consumer needs.
  static constexpr int PRODUCER_REGS = 40;
  static constexpr int CONSUMER_REGS = D <= 128 ? 216 : 232;
  static constexpr bool Q_SETMAXNREG = D <= 128;
  static constexpr int RES_BYTES = BM * D * 2;           // one resident tile
  static constexpr int KV_STREAM = KV_BN * D * 2;        // a streamed Q or dO tile
  static constexpr int Q_STREAM = Q_BN * D * 2;          // a streamed K or V tile
  static constexpr int STAT_BYTES = 2 * KV_BN * 4;       // a dK/dV stage's lse and Δ
  // The fused route: the dK/dV tile is as wide as the dQ tile (64 queries),
  // dSᵀ goes through a bf16 tile of 64 x 64 (128-byte rows, 128-byte
  // swizzle) to the dQ product, and each fp32 dQ part through one of
  // DQ_BUFS buffers of 64 x D, in panels of FPW columns (FSPAN bytes: the
  // swizzle the TMA reduction reads), to the adder.
  static constexpr bool FUSED = (FUSED_DQ_HEAD_DIMS & D) != 0;
  static_assert(!FUSED || (KV_BN == BM && KV_CONSUMERS == 1), "fused dQ: 64 x 64 tiles, one consumer");
  static constexpr int FPW = D < 32 ? D : 32;
  static constexpr int FSPAN = FPW * 4;
  static constexpr CUtensorMapSwizzle FSWIZZLE = tma_swizzle(FSPAN);
  static constexpr int DS_BYTES = FUSED ? BM * KV_BN * 2 : 0;  // one of two dSᵀ tiles
  static constexpr uint64_t DS_LAYOUT = desc_layout(128);  // dSᵀ's 128-byte rows
  static constexpr int DQ_BUF = FUSED ? KV_BN * D * 4 : 0;
  // resident full; full, empty per stage; fused: full, empty per dQ buffer
  static constexpr int BARRIERS = 1 + 2 * STAGES + (FUSED ? 2 * DQ_BUFS : 0);
  // 1024 bytes of slack to align the tiles to the 128-byte swizzle's period.
  static constexpr int SMEM_KV = 1024 + 2 * RES_BYTES + STAGES * (2 * KV_STREAM + STAT_BYTES) +
                                 2 * DS_BYTES + DQ_BUFS * DQ_BUF + 8 * BARRIERS;
  static constexpr int SMEM_Q = 1024 + 2 * RES_BYTES + STAGES * 2 * Q_STREAM + 8 * BARRIERS;
};

__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000); }

// Step p·n/P of a walk of n steps cut into P slices (floor), in 32-bit
// arithmetic: (n / P)·p + (n % P)·p / P, exact while P² fits 32 bits (the
// grid holds P under 65536).
__device__ __forceinline__ int slice_start(int p, int n, int P) {
  const unsigned q = (unsigned)n / P, r = (unsigned)n % P;
  return (int)(q * p + r * p / P);
}

// Whether a query at absolute position qpos sees the key at kpos.
__device__ __forceinline__ bool visible(int qpos, int kpos, int causal, int window) {
  return (!causal || qpos >= kpos) && (window <= 0 || qpos - kpos < window);
}

// Byte `off` of a tile of `span`-byte rows, at a 1024-byte-aligned base, as
// the span's swizzle (what TMA writes and wgmma and TMA read) places it: the
// 16-byte chunk XORed with bits 7 and up of the offset.
__device__ __forceinline__ uint32_t swizzled(uint32_t off, int span) {
  return off ^ (((off >> 7) & (span / 16 - 1)) << 4);
}

__device__ __forceinline__ void fence_async_shared() {  // generic writes -> async-proxy reads
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The consumer warpgroup meets on named barrier 1 (the producer's warps do
// not take part).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(WG_THREADS) : "memory");
}

// D (m64 x N, fp32) (+)= A (m64 x k16) . B (k16 x N), both bf16 in shared
// memory and read MN-major (both transpose bits set); scale_d = 0
// overwrites D.
template <int N>
__device__ void wgmma_ss_tt(float (&d)[N / 2], uint64_t da, uint64_t db, int scale_d);

template <>
__device__ __forceinline__ void wgmma_ss_tt<16>(float (&d)[8], uint64_t da, uint64_t db,
                                                int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss_tt<32>(float (&d)[16], uint64_t da, uint64_t db,
                                                int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, "
      "1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss_tt<64>(float (&d)[32], uint64_t da, uint64_t db,
                                                int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, "
      "1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// ---- the ordered dQ sum (fused route) ------------------------------------------

// The key tile of launch position `pos` (blockIdx.y / split) of k_tiles:
// groups of `group` key tiles, groups in ascending order, the tiles of a
// group in descending order (group 1: ascending, the split route's order).
__device__ __forceinline__ int key_tile_at(int pos, int k_tiles, int group) {
  const int g0 = pos / group * group, hi = min(k_tiles, g0 + group);
  return hi - 1 - (pos - g0);
}

// The key tiles (of 64 keys) whose walks hold query tile t (BN queries a
// tile): the walks' query tiles rise with the key tile at both ends, so
// they are one run, (first, last), empty if last < first. Only a window
// keeps early key tiles off t (key tile m reaches it iff its last key, 64m
// + 63 or the last tile's Skv - 1, is within the window of the tile's first
// query, t·BN + q_offset), and only a causal mask late ones (m reaches it
// iff its first key, 64m, is before the tile's end, min(Sq, (t + 1)·BN), as
// a query position).
__device__ __forceinline__ int2 dq_run(int t, int bn, int k_tiles, int Sq, int Skv, int causal,
                                       int window, int q_offset) {
  const int x = t * bn + q_offset - window;  // first: its last key past x
  int first = window <= 0 || x < 63 ? 0 : (x - 63) / 64 + 1;
  if (first >= k_tiles - 1 && window > 0 && Skv - 1 <= x) first = k_tiles;
  const int last = causal ? min(k_tiles, (min(Sq, (t + 1) * bn) + q_offset + 63) / 64) - 1
                          : k_tiles - 1;
  return make_int2(first, last);
}

// Key tile n's turn in the sum of a query tile's dQ whose run is `run`
// (dq_run): how many of the run's key tiles come before n in launch order
// (key_tile_at).
__device__ __forceinline__ int dq_turn(int n, int2 run, int k_tiles, int group) {
  const int g0 = n / group * group, hi = min(k_tiles, g0 + group);
  return max(0, min(run.y, g0 - 1) - run.x + 1) + max(0, min(run.y, hi - 1) - n);
}

// Wait until the int at ctr (global) equals turn, acquiring what its writer
// released. A value past turn is an order fault; one not reached after about
// 2^35 cycles (some 20 s) is a stall fault: either traps, so the launch fails
// instead of holding the card.
__device__ __forceinline__ void wait_turn(const int* ctr, int turn) {
  long long start = 0;
  while (true) {
    int v;
    asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(ctr) : "memory");
    if (v == turn) return;
    if (v > turn) __trap();
    if (start == 0) start = clock64();
    else if (clock64() - start > (1ll << 35)) __trap();
  }
}

// One box of a 3-D fp32 tensor map from shared memory: written over the
// box (first) or added into it, element by element in fp32 (later turns);
// rows past the map's end are not touched. Tracked by the bulk group.
__device__ __forceinline__ void tma_store_or_add(const CUtensorMap* map, uint32_t src, bool add,
                                                 int c0, int c1, int c2) {
  if (add)
    asm volatile(
        "cp.reduce.async.bulk.tensor.3d.global.shared::cta.add.bulk_group "
        "[%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
        "r"(src), "r"(c0), "r"(c1), "r"(c2)
        : "memory");
  else
    asm volatile(
        "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group "
        "[%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
        "r"(src), "r"(c0), "r"(c1), "r"(c2)
        : "memory");
}

// acc (64 x N, fp32) = A . Bᵀ over D in k16 steps (no wait): A is 64 rows
// at `a` in panels of a_rows rows, B is N rows at `b` in panels of N rows,
// both K-major (rows of D bf16).
template <int D, int N>
__device__ __forceinline__ void issue_ss(float (&acc)[N / 2], uint32_t a, int a_rows,
                                         uint32_t b) {
  using C = Cfg<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int panel = (kk * 16) / C::PW;
    const uint32_t off = ((kk * 16) % C::PW) * 2;  // bytes into the swizzle span
    wgmma_ss<N>(acc, smem_desc(a + panel * a_rows * C::SPAN + off, 16, 8 * C::SPAN, C::LAYOUT),
                smem_desc(b + panel * N * C::SPAN + off, 16, 8 * C::SPAN, C::LAYOUT), kk > 0);
  }
}

// acc (64 x N, fp32) += A . B over K rows in k16 steps (no wait): A from
// registers (bf16 fragments), B the K x N columns of a tile at `b` (the
// first of their panels of K rows), read MN-major.
template <int D, int K, int N = D>
__device__ __forceinline__ void issue_rs(float (&acc)[N / 2], const uint32_t (&a)[K / 16][4],
                                         uint32_t b) {
  using C = Cfg<D>;
#pragma unroll
  for (int ks = 0; ks < K / 16; ++ks)
    wgmma_rs<N>(acc, a[ks], smem_desc(b + ks * 16 * C::SPAN, K * C::SPAN, 8 * C::SPAN, C::LAYOUT));
}

// acc (64 queries x D, fp32) = dS . K over the tile's 64 keys in k16 steps
// (no wait): dS from the dSᵀ tile at `ds` (key rows of 64 queries, 128-byte
// swizzle), K from the resident tile at `k` (key rows of D), both MN-major.
template <int D>
__device__ __forceinline__ void issue_dq(float (&acc)[D / 2], uint32_t ds, uint32_t k) {
  using C = Cfg<D>;
#pragma unroll
  for (int ks = 0; ks < C::BM / 16; ++ks)
    wgmma_ss_tt<D>(acc, smem_desc(ds + ks * 16 * 128, C::KV_BN * 128, 8 * 128, C::DS_LAYOUT),
                   smem_desc(k + ks * 16 * C::SPAN, C::BM * C::SPAN, 8 * C::SPAN, C::LAYOUT),
                   ks > 0);
}

// One score tile's P and dS from S and dP, fragments of a 64 x N wgmma
// accumulator (x[4j + 2hh + cc] is row g + 8hh, column 8j + 2quad + cc of
// the tile), packed as the bf16 A fragments of the next products. With
// KEY_ROWS (dK/dV) the rows are keys and the columns queries, whose log2 lse
// and Δ are col_stat[8j + cc] and col_stat[N + 8j + cc] (col_stat already
// offset by 2quad); else (dQ) the rows are queries with lse2[hh], dl[hh].
// row_pos and col_pos are the positions of row g and column 2quad; the
// masks apply only where need_mask is set.
template <int N, bool KEY_ROWS>
__device__ __forceinline__ void probs(const float (&s)[N / 2], const float (&dp)[N / 2],
                                      uint32_t (&pa)[N / 16][4], uint32_t (&da)[N / 16][4],
                                      float scale_log2, const float* col_stat,
                                      const float (&lse2)[2], const float (&dl)[2],
                                      bool need_mask, int row_pos, int col_pos, int Skv,
                                      int causal, int window) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    float l2[4], d[4];
    if (KEY_ROWS) {
      const float2 cl = *reinterpret_cast<const float2*>(col_stat + 8 * j);
      const float2 cd = *reinterpret_cast<const float2*>(col_stat + N + 8 * j);
      l2[0] = l2[2] = cl.x;
      l2[1] = l2[3] = cl.y;
      d[0] = d[2] = cd.x;
      d[1] = d[3] = cd.y;
    } else {
      l2[0] = l2[1] = lse2[0];
      l2[2] = l2[3] = lse2[1];
      d[0] = d[1] = dl[0];
      d[2] = d[3] = dl[1];
    }
    float p[4], ds[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = exp2_approx(fmaf(s[4 * j + e], scale_log2, -l2[e]));
      if (need_mask) {
        const int rpos = row_pos + 8 * (e >> 1), cpos = col_pos + 8 * j + (e & 1);
        const bool keep = KEY_ROWS ? visible(cpos, rpos, causal, window)
                                   : cpos < Skv && visible(rpos, cpos, causal, window);
        if (!keep) x = 0.f;
      }
      p[e] = x;
      ds[e] = x * (dp[4 * j + e] - d[e]);
    }
    // Chunk j = 2ks + half: row g into registers 0 and 2, row g + 8 into 1 and 3.
    pa[j / 2][2 * (j % 2) + 0] = pack_bf16(p[0], p[1]);
    pa[j / 2][2 * (j % 2) + 1] = pack_bf16(p[2], p[3]);
    da[j / 2][2 * (j % 2) + 0] = pack_bf16(ds[0], ds[1]);
    da[j / 2][2 * (j % 2) + 1] = pack_bf16(ds[2], ds[3]);
  }
}

// Rows row and row + 8 of a 64 x N accumulator, times mul, as bf16 into N
// columns of a (S, D) matrix from `out`; rows at or past S are not written.
template <int D, int N = D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* __restrict__ out,
                                           const float (&acc)[N / 2], int row, int S, int quad,
                                           float mul) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = row + 8 * hh;
    if (r < S) {
#pragma unroll
      for (int j = 0; j < N / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)r * D + 8 * j + 2 * quad) =
            __floats2bfloat162_rn(acc[4 * j + 2 * hh] * mul, acc[4 * j + 2 * hh + 1] * mul);
    }
  }
}

// Rows row and row + 8 of a 64 x N accumulator, unscaled fp32, into N
// columns of a (S, D) fp32 matrix from `out`; rows at or past S are not
// written.
template <int D, int N>
__device__ __forceinline__ void store_part(float* __restrict__ out, const float (&acc)[N / 2],
                                           int row, int S, int quad) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = row + 8 * hh;
    if (r < S) {
#pragma unroll
      for (int j = 0; j < N / 8; ++j)
        *reinterpret_cast<float2*>(out + (size_t)r * D + 8 * j + 2 * quad) =
            make_float2(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
    }
  }
}

// ---- the kernels -------------------------------------------------------------

// Δ = rowsum(dO∘O) in fp32: D/8 threads a row, 8 elements (16 bytes) each.
// On the fused route (counters not null) the first row of each query tile
// of 64 also zeroes that tile's turn counter.
template <int D>
__global__ void __launch_bounds__(256)
flash_bwd_delta_sm90(const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dout,
                     float* __restrict__ delta, long long rows, int* __restrict__ counters,
                     int Sq, int q_tiles) {
  constexpr int TPR = D / 8;
  const long long row = (long long)blockIdx.x * (256 / TPR) + threadIdx.x / TPR;
  const int part = threadIdx.x % TPR;
  float acc = 0.f;
  if (row < rows) {
    const uint4 ov = *reinterpret_cast<const uint4*>(o + row * D + 8 * part);
    const uint4 dv = *reinterpret_cast<const uint4*>(dout + row * D + 8 * part);
    const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
    const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 a = __bfloat1622float2(o2[i]), b = __bfloat1622float2(d2[i]);
      acc = fmaf(b.x, a.x, acc);
      acc = fmaf(b.y, a.y, acc);
    }
  }
#pragma unroll
  for (int off = TPR / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (row >= rows || part != 0) return;
  delta[row] = acc;
  if (counters != nullptr && row % Sq % 64 == 0) counters[row / Sq * q_tiles + row % Sq / 64] = 0;
}

template <int D>
__global__ void __launch_bounds__(Cfg<D>::KV_THREADS, Cfg<D>::MIN_BLOCKS)
flash_bwd_dkdv_sm90(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_do, const float* __restrict__ lse,
                    const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
                    __nv_bfloat16* __restrict__ dv, float* __restrict__ parts, int split,
                    const __grid_constant__ CUtensorMap tm_dqw, int* __restrict__ counters,
                    int q_tiles, int group, int H, int KV, int Sq, int Skv, int causal,
                    int window, int q_offset, float scale, float scale_log2) {
  using C = Cfg<D>;
  constexpr int BM = C::BM, BN = C::KV_BN, SPAN = C::SPAN, PW = C::PW, DC = C::DC;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t s_k = (raw + 1023) & ~1023u;  // NP panels of BM rows
  const uint32_t s_v = s_k + C::RES_BYTES;
  const uint32_t s_q = s_v + C::RES_BYTES;  // STAGES x NP panels of BN rows
  const uint32_t s_do = s_q + STAGES * C::KV_STREAM;
  const uint32_t s_ds = s_do + STAGES * C::KV_STREAM;  // fused: two dSᵀ tiles, the dQ buffers
  const uint32_t s_dq = s_ds + 2 * C::DS_BYTES;         // each D / FPW panels of BN rows
  const uint32_t s_stat = s_dq + DQ_BUFS * C::DQ_BUF;  // a stage: BN lse2, then BN Δ
  float* const stat = reinterpret_cast<float*>(smem_raw + (s_stat - raw));
  const uint32_t bars = s_stat + STAGES * C::STAT_BYTES;
  const uint32_t kv_full = bars, full = bars + 8, empty = full + 8 * STAGES;
  const uint32_t dq_full = empty + 8 * STAGES, dq_empty = dq_full + 8 * DQ_BUFS;

  const int bkv = blockIdx.x, G = H / KV;
  const int part = blockIdx.y % split;  // the block's slice of its key tile's walk
  const int k_tiles = gridDim.y / split;
  // The block's key tile: with group = 1 tile 0 first (causal: the
  // heaviest), then ascending; the fused route's groups below.
  const int tile = key_tile_at(blockIdx.y / split, k_tiles, group);
  const int n0 = tile * BM;  // the block's first key
  // Query rows that see any key of the tile: at or past its first key
  // (causal), before its last key's window ends.
  const int n_last = min(n0 + BM, Skv) - 1;
  const int m_lo = causal ? max(0, n0 - q_offset) : 0;
  const int m_hi = window > 0 ? min(Sq, n_last + window - q_offset) : Sq;
  const int t_lo = m_lo / BN, t_hi = m_hi > m_lo ? (m_hi + BN - 1) / BN : t_lo;
  const int per_head = t_hi - t_lo, n_iter = G * per_head;
  // the slice: steps [it0, it0 + n_steps) of the walk (all of it when split = 1)
  const int it0 = slice_start(part, n_iter, split);
  const int n_steps = slice_start(part + 1, n_iter, split) - it0;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1 + 32);  // the TMA's expect_tx, then the producer warp's 32 lanes
      mbar_init(empty + 8 * s, 4 * C::KV_CONSUMERS);  // lane 0 of every consumer warp
    }
    if constexpr (C::FUSED) {
      for (int b = 0; b < DQ_BUFS; ++b) {
        mbar_init(dq_full + 8 * b, 4);  // lane 0 of every consumer warp
        mbar_init(dq_empty + 8 * b, 1);  // its adder
      }
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < WG_THREADS) {
    // Producer: thread 0 issues the TMA loads, warp 0 copies lse and Δ;
    // fused, warps 1 and 2 add the dQ parts.
    setmaxnreg_dec<C::PRODUCER_REGS>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        mbar_expect_tx(kv_full, 2 * C::RES_BYTES);
#pragma unroll
        for (int p = 0; p < C::NP; ++p) {
          tma_load(s_k + p * BM * SPAN, &tm_k, kv_full, p * PW, n0, bkv);
          tma_load(s_v + p * BM * SPAN, &tm_v, kv_full, p * PW, n0, bkv);
        }
      }
      for (int step = 0; step < n_steps; ++step) {
        const int s = step % STAGES, it = it0 + step;
        const int bh = bkv * G + it / per_head;  // = b H + kv_head G + g
        const int m0 = (t_lo + it % per_head) * BN;
        const uint32_t q_st = s_q + s * C::KV_STREAM, do_st = s_do + s * C::KV_STREAM;
        mbar_wait(empty + 8 * s, ((step / STAGES) & 1) ^ 1);  // first round passes
        if (lane == 0) {
          mbar_expect_tx(full + 8 * s, 2 * C::KV_STREAM);
#pragma unroll
          for (int p = 0; p < C::NP; ++p) {
            tma_load(q_st + p * BN * SPAN, &tm_q, full + 8 * s, p * PW, m0, bh);
            tma_load(do_st + p * BN * SPAN, &tm_do, full + 8 * s, p * PW, m0, bh);
          }
        }
        float* st = stat + s * 2 * BN;
        for (int i = lane; i < BN; i += 32) {
          const int r = m0 + i;
          st[i] = r < Sq ? lse[(size_t)bh * Sq + r] * LOG2E : pos_inf();  // P = 0 past Sq
          st[BN + i] = r < Sq ? delta[(size_t)bh * Sq + r] : 0.f;
        }
        mbar_arrive(full + 8 * s);
      }
    } else if (C::FUSED && threadIdx.x < 32 * (1 + DQ_BUFS)) {
      // Adder b (warp 1 + b), the steps of dQ buffer b: each step's dQ part
      // into the fp32 workspace, once every key tile before this one in
      // launch order that visits the same (q head, query tile) has added its
      // own, so each element's sum runs over the key tiles in that fixed
      // order, and waits only on blocks launched earlier. The first turn
      // writes, the others add; the counter moves on once the add is
      // complete in global memory. With an adder a buffer, one add's wait
      // and latency overlap the next's.
      const int b = threadIdx.x / 32 - 1, lane = threadIdx.x % 32;
      for (int step = b; step < n_steps; step += DQ_BUFS) {
        const int it = it0 + step;
        const int bh = bkv * G + it / per_head, t = t_lo + it % per_head;
        const int turn =
            dq_turn(tile, dq_run(t, BN, k_tiles, Sq, Skv, causal, window, q_offset), k_tiles, group);
        mbar_wait(dq_full + 8 * b, (step / DQ_BUFS) & 1);
        if (lane == 0) {
          int* const ctr = counters + (size_t)bh * q_tiles + t;
          wait_turn(ctr, turn);
          asm volatile("fence.proxy.async.global;\n" ::: "memory");  // the add after the acquire
#pragma unroll
          for (int p = 0; p < D / C::FPW; ++p)
            tma_store_or_add(&tm_dqw, s_dq + b * C::DQ_BUF + p * BN * C::FSPAN, turn > 0,
                             p * C::FPW, t * BN, bh);
          asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
          asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");  // written, not only read
          asm volatile("fence.proxy.async.global;\n" ::: "memory");  // the add before the release
          asm volatile("red.release.gpu.global.add.s32 [%0], 1;\n" ::"l"(ctr) : "memory");
          mbar_arrive(dq_empty + 8 * b);
        }
        __syncwarp();
      }
    }
  } else {
    // Consumer cw: keys n0 .. n0 + 63, the rows of every tile it computes,
    // and columns col0 .. col0 + DC - 1 of their dK and dV.
    setmaxnreg_inc<C::CONSUMER_REGS>();
    const int tid = threadIdx.x - WG_THREADS;
    const int cw = tid / WG_THREADS, col0 = cw * DC;
    const int warp = (tid % WG_THREADS) / 32, lane = tid % 32, quad = lane % 4;
    const int key0 = n0 + 16 * warp + lane / 4;  // this thread's keys: key0 and key0 + 8
    const float unused[2] = {0.f, 0.f};
    // the first panel of this consumer's columns in a streamed tile
    const uint32_t col_off = (col0 / PW) * BN * SPAN;

    float dka[DC / 2], dva[DC / 2];
#pragma unroll
    for (int i = 0; i < DC / 2; ++i) dka[i] = dva[i] = 0.f;
    mbar_wait(kv_full, 0);
    const int row0 = 16 * warp + lane / 4;  // this thread's rows of a tile: row0, row0 + 8
    // Fused: key rows past Skv go into the dSᵀ tile as zeros. Their P is
    // unmasked (only dK and dV rows past Skv, which are not stored, read
    // it) and can be inf, for a query whose lse is very low or -inf, and
    // inf times their zero K rows would be NaN in dQ.
    const bool key_past[2] = {key0 >= Skv, key0 + 8 >= Skv};
    // Fused: step st's dQ part, fp32 and unscaled, into its free buffer for
    // the adder, once its products are done.
    [[maybe_unused]] float dqa[C::FUSED ? D / 2 : 1];
    [[maybe_unused]] auto put_dq = [&](int st) {
      const int b = st % DQ_BUFS;
      const uint32_t buf = s_dq + b * C::DQ_BUF;
      mbar_wait(dq_empty + 8 * b, ((st / DQ_BUFS) & 1) ^ 1);  // first round passes
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int c = 8 * j + 2 * quad;
          const uint32_t off = (row0 + 8 * hh) * C::FSPAN + (c % C::FPW) * 4;
          asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(
                           buf + (c / C::FPW) * BN * C::FSPAN + swizzled(off, C::FSPAN)),
                       "f"(dqa[4 * j + 2 * hh]), "f"(dqa[4 * j + 2 * hh + 1])
                       : "memory");
        }
      fence_async_shared();
      __syncwarp();
      if (lane == 0) mbar_arrive(dq_full + 8 * b);
    };

    for (int step = 0; step < n_steps; ++step) {
      const int s = step % STAGES;
      const int qpos0 = q_offset + (t_lo + (it0 + step) % per_head) * BN;  // the tile's first query
      const uint32_t q_st = s_q + s * C::KV_STREAM, do_st = s_do + s * C::KV_STREAM;
      float sc[BN / 2], dp[BN / 2];
      uint32_t pa[BN / 16][4], da[BN / 16][4];
      mbar_wait(full + 8 * s, (step / STAGES) & 1);
      wgmma_fence();
      issue_ss<D, BN>(sc, s_k, BM, q_st);   // Sᵀ = K Qᵀ
      issue_ss<D, BN>(dp, s_v, BM, do_st);  // dPᵀ = V dOᵀ
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);
      const bool need_mask = (causal && qpos0 < n0 + BM - 1) ||
                             (window > 0 && qpos0 + BN - 1 - n0 >= window);
      probs<BN, true>(sc, dp, pa, da, scale_log2, stat + s * 2 * BN + 2 * quad, unused, unused,
                      need_mask, key0, qpos0 + 2 * quad, Skv, causal, window);
      const uint32_t ds_t = s_ds + (step % 2) * C::DS_BYTES;
      if constexpr (C::FUSED) {
        // dSᵀ as bf16 into this step's tile (key rows of 64 queries), for
        // dQ = dS K. The tile of two steps back is free: every consumer warp
        // passed the last step's barrier, so its wait for that step's
        // products too.
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
            asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(
                             ds_t + swizzled((row0 + 8 * hh) * 128 + (8 * j + 2 * quad) * 2, 128)),
                         "r"(key_past[hh] ? 0u : da[j / 2][2 * (j % 2) + hh])
                         : "memory");
        fence_async_shared();
        consumers_sync();
      }
      wgmma_fence();
      issue_rs<D, BN, DC>(dva, pa, do_st + col_off);  // dV += Pᵀ dO, this consumer's columns
      issue_rs<D, BN, DC>(dka, da, q_st + col_off);   // dK += dSᵀ Q
      if constexpr (C::FUSED) issue_dq<D>(dqa, ds_t, s_k);  // this step's dQ part = dS K
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dva);
      fence_regs(dka);
      if (lane == 0) mbar_arrive(empty + 8 * s);
      if constexpr (C::FUSED) {
        fence_regs(dqa);
        put_dq(step);
      }
    }
    if (split == 1) {
      store_rows<D, DC>(dk + (size_t)bkv * Skv * D + col0, dka, key0, Skv, quad, scale);
      store_rows<D, DC>(dv + (size_t)bkv * Skv * D + col0, dva, key0, Skv, quad, 1.f);
    } else {  // this slice's fp32 sums into its parts; flash_bwd_reduce_sm90 adds them
      const size_t n = (size_t)gridDim.x * Skv * D;  // elements of dK
      float* pk = parts + (size_t)part * n + (size_t)bkv * Skv * D + col0;
      store_part<D, DC>(pk, dka, key0, Skv, quad);
      store_part<D, DC>(pk + (size_t)split * n, dva, key0, Skv, quad);
    }
  }
}

// dK = scale·(part 0 + part 1 + ...), dV = part 0 + part 1 + ..., the parts
// of `parts` ((2, split, n) fp32: dK's, then dV's) added in slice order in
// fp32, each sum rounded to bf16 once; 4 elements a thread, n4 = n / 4.
__global__ void __launch_bounds__(REDUCE_THREADS)
flash_bwd_reduce_sm90(const float* __restrict__ parts, __nv_bfloat16* __restrict__ dk,
                      __nv_bfloat16* __restrict__ dv, long long n4, int split, float scale) {
  const long long i = (long long)blockIdx.x * REDUCE_THREADS + threadIdx.x;  // dK's, then dV's
  if (i >= 2 * n4) return;
  const bool is_v = i >= n4;
  const long long j = is_v ? i - n4 : i;
  const float4* src = reinterpret_cast<const float4*>(parts) + (is_v ? split * n4 : 0) + j;
  float4 acc = src[0];
  for (int p = 1; p < split; ++p) {
    const float4 x = src[p * n4];
    acc.x += x.x;
    acc.y += x.y;
    acc.z += x.z;
    acc.w += x.w;
  }
  const float mul = is_v ? 1.f : scale;
  __nv_bfloat162 out[2] = {__floats2bfloat162_rn(acc.x * mul, acc.y * mul),
                           __floats2bfloat162_rn(acc.z * mul, acc.w * mul)};
  reinterpret_cast<uint2*>(is_v ? dv : dk)[j] = *reinterpret_cast<const uint2*>(out);
}

// The fused route's dQ: the fp32 sums of the workspace (B, H, Sq, D) times
// the scale, each rounded to bf16 once; a query tile of 64 that no key tile
// visited (its turn counter still 0) gets zeros. 8 elements a thread, n8 =
// B·H·Sq·D / 8.
template <int D>
__global__ void __launch_bounds__(REDUCE_THREADS)
flash_bwd_dqsum_sm90(const float* __restrict__ ws, const int* __restrict__ counters,
                     __nv_bfloat16* __restrict__ dq, long long n8, int Sq, int q_tiles,
                     float scale) {
  const long long i = (long long)blockIdx.x * REDUCE_THREADS + threadIdx.x;
  if (i >= n8) return;
  const long long row = i / (D / 8);  // of the B·H·Sq rows
  uint4 out = make_uint4(0u, 0u, 0u, 0u);
  if (counters[row / Sq * q_tiles + (row % Sq) / 64] > 0) {
    const float4 a = reinterpret_cast<const float4*>(ws)[2 * i];
    const float4 c = reinterpret_cast<const float4*>(ws)[2 * i + 1];
    out = make_uint4(pack_bf16(a.x * scale, a.y * scale), pack_bf16(a.z * scale, a.w * scale),
                     pack_bf16(c.x * scale, c.y * scale), pack_bf16(c.z * scale, c.w * scale));
  }
  reinterpret_cast<uint4*>(dq)[i] = out;
}

template <int D>
__global__ void __launch_bounds__(Cfg<D>::Q_THREADS, Cfg<D>::MIN_BLOCKS)
flash_bwd_dq_sm90(const __grid_constant__ CUtensorMap tm_q,
                  const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v,
                  const __grid_constant__ CUtensorMap tm_do, const float* __restrict__ lse,
                  const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq, int H, int KV,
                  int Sq, int Skv, int causal, int window, int q_offset, float scale,
                  float scale_log2) {
  using C = Cfg<D>;
  constexpr int BM = C::BM, BN = C::Q_BN, SPAN = C::SPAN, PW = C::PW;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t s_q = (smem_u32(smem_raw) + 1023) & ~1023u;  // NP panels of BM rows
  const uint32_t s_do = s_q + C::RES_BYTES;
  const uint32_t s_k = s_do + C::RES_BYTES;  // STAGES x NP panels of BN rows
  const uint32_t s_v = s_k + STAGES * C::Q_STREAM;
  const uint32_t bars = s_v + STAGES * C::Q_STREAM;
  const uint32_t q_full = bars, full = bars + 8, empty = full + 8 * STAGES;

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int bh_kv = b * KV + h / (H / KV);
  const int m0 = (gridDim.y - 1 - blockIdx.y) * BM;  // heaviest query tiles first
  // Keys that any row of the tile sees: up to the last row's diagonal
  // (causal), from the first row's window start.
  const int qpos_first = q_offset + m0, qpos_last = q_offset + min(m0 + BM, Sq) - 1;
  const int n_hi = causal ? min(Skv, qpos_last + 1) : Skv;
  const int n_lo = window > 0 ? max(0, qpos_first - window + 1) : 0;
  const int t_lo = n_lo / BN, t_hi = n_hi > n_lo ? (n_hi + BN - 1) / BN : t_lo;
  const int n_iter = t_hi - t_lo;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4);  // lane 0 of every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < WG_THREADS) {
    // Producer: one thread keeps the ring full.
    if constexpr (C::Q_SETMAXNREG) setmaxnreg_dec<C::PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, 2 * C::RES_BYTES);
#pragma unroll
      for (int p = 0; p < C::NP; ++p) {
        tma_load(s_q + p * BM * SPAN, &tm_q, q_full, p * PW, m0, bh);
        tma_load(s_do + p * BM * SPAN, &tm_do, q_full, p * PW, m0, bh);
      }
      for (int it = 0; it < n_iter; ++it) {
        const int s = it % STAGES;
        const int k0 = (t_lo + it) * BN;
        mbar_wait(empty + 8 * s, ((it / STAGES) & 1) ^ 1);  // first round passes
        mbar_expect_tx(full + 8 * s, 2 * C::Q_STREAM);
#pragma unroll
        for (int p = 0; p < C::NP; ++p) {
          tma_load(s_k + s * C::Q_STREAM + p * BN * SPAN, &tm_k, full + 8 * s, p * PW, k0, bh_kv);
          tma_load(s_v + s * C::Q_STREAM + p * BN * SPAN, &tm_v, full + 8 * s, p * PW, k0, bh_kv);
        }
      }
    }
  } else {
    // Consumer: query rows m0 .. m0 + 63.
    if constexpr (C::Q_SETMAXNREG) setmaxnreg_inc<C::CONSUMER_REGS>();
    const int tid = threadIdx.x - WG_THREADS;
    const int warp = tid / 32, lane = tid % 32, quad = lane % 4;
    const int row0 = m0 + 16 * warp + lane / 4;  // this thread's rows: row0 and row0 + 8
    float lse2[2], dl[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = row0 + 8 * hh;
      lse2[hh] = r < Sq ? lse[(size_t)bh * Sq + r] * LOG2E : pos_inf();  // P = 0 past Sq
      dl[hh] = r < Sq ? delta[(size_t)bh * Sq + r] : 0.f;
    }

    float dqa[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dqa[i] = 0.f;
    mbar_wait(q_full, 0);

    for (int it = 0; it < n_iter; ++it) {
      const int s = it % STAGES;
      const int k0 = (t_lo + it) * BN;
      const uint32_t k_st = s_k + s * C::Q_STREAM, v_st = s_v + s * C::Q_STREAM;
      float sc[BN / 2], dp[BN / 2];
      uint32_t pa[BN / 16][4], da[BN / 16][4];
      mbar_wait(full + 8 * s, (it / STAGES) & 1);
      wgmma_fence();
      issue_ss<D, BN>(sc, s_q, BM, k_st);   // S = Q Kᵀ
      issue_ss<D, BN>(dp, s_do, BM, v_st);  // dP = dO Vᵀ
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);
      const bool need_mask = k0 + BN > Skv || (causal && qpos_first < k0 + BN - 1) ||
                             (window > 0 && qpos_first + BM - 1 - k0 >= window);
      probs<BN, false>(sc, dp, pa, da, scale_log2, nullptr, lse2, dl, need_mask,
                       q_offset + row0, k0 + 2 * quad, Skv, causal, window);
      wgmma_fence();
      issue_rs<D, BN>(dqa, da, k_st);  // dQ += dS K
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dqa);
      if (lane == 0) mbar_arrive(empty + 8 * s);
    }
    store_rows<D>(dq + (size_t)bh * Sq * D, dqa, row0, Sq, quad, scale);
  }
}

// ---- host side -------------------------------------------------------------

// A map over a contiguous (BH, S, D) bf16 tensor, boxes of rows x PW.
template <int D>
bool make_map(CUtensorMap* map, const void* ptr, int S, int BH, int rows) {
  return make_map_bf16(map, ptr, D, S, BH, Cfg<D>::PW, rows, Cfg<D>::SWIZZLE);
}

// A map over a contiguous (BH, S, D) fp32 tensor, boxes of rows x FPW
// columns in the fused route's swizzle.
template <int D>
bool make_map_f32(CUtensorMap* map, const void* ptr, int S, int BH, int rows) {
  EncodeTiled encode = tensor_map_encoder();
  if (!encode) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 4, (cuuint64_t)S * D * 4};
  const cuuint32_t box[3] = {(cuuint32_t)Cfg<D>::FPW, (cuuint32_t)rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, Cfg<D>::FSWIZZLE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
                   const float* lse, float* delta, void* dq, void* dk, void* dv, float* parts,
                   float* dq_ws, int* counters, int group, int split, int B, int H, int KV,
                   int Sq, int Skv, int causal, int window, int q_offset, float scale,
                   cudaStream_t stream) {
  using C = Cfg<D>;
  const long long rows = (long long)B * H * Sq;
  const long long delta_blocks = (rows * (D / 8) + 255) / 256;
  const int q_tiles = (Sq + C::BM - 1) / C::BM, k_tiles = (Skv + C::BM - 1) / C::BM;
  const long long n4 = (long long)B * KV * Skv * D / 4;  // 4-element groups of dK
  const long long reduce_blocks = (2 * n4 + REDUCE_THREADS - 1) / REDUCE_THREADS;
  const long long n8 = rows * D / 8;  // 8-element groups of dQ
  const long long dqsum_blocks = (n8 + REDUCE_THREADS - 1) / REDUCE_THREADS;
  if (delta_blocks > 0x7fffffffLL || reduce_blocks > 0x7fffffffLL ||
      dqsum_blocks > 0x7fffffffLL || q_tiles > 65535 || (long long)k_tiles * split > 65535 ||
      (C::FUSED && (dq_ws == nullptr || counters == nullptr || group < 1)))
    return cudaErrorInvalidValue;
  // Resident tiles of BM rows; streamed tiles of KV_BN queries and Q_BN keys.
  CUtensorMap q_res, do_res, k_res, v_res, q_kv, do_kv, k_q, v_q;
  if (!make_map<D>(&q_res, q, Sq, B * H, C::BM) || !make_map<D>(&do_res, dout, Sq, B * H, C::BM) ||
      !make_map<D>(&k_res, k, Skv, B * KV, C::BM) || !make_map<D>(&v_res, v, Skv, B * KV, C::BM) ||
      !make_map<D>(&q_kv, q, Sq, B * H, C::KV_BN) ||
      !make_map<D>(&do_kv, dout, Sq, B * H, C::KV_BN) ||
      !make_map<D>(&k_q, k, Skv, B * KV, C::Q_BN) || !make_map<D>(&v_q, v, Skv, B * KV, C::Q_BN))
    return cudaErrorInvalidValue;
  CUtensorMap dq_map{};  // the fused route's fp32 dQ workspace, boxes of a query tile
  if (C::FUSED && !make_map_f32<D>(&dq_map, dq_ws, Sq, B * H, C::KV_BN))
    return cudaErrorInvalidValue;
  static unsigned long long kv_set = 0, q_set = 0;  // bit d: the limit is set on device d
  cudaError_t err = allow_smem(flash_bwd_dkdv_sm90<D>, C::SMEM_KV, kv_set);
  if (err != cudaSuccess) return err;
  if constexpr (!C::FUSED) {
    err = allow_smem(flash_bwd_dq_sm90<D>, C::SMEM_Q, q_set);
    if (err != cudaSuccess) return err;
  }
  int* const ctr = C::FUSED ? counters : nullptr;

  flash_bwd_delta_sm90<D><<<(unsigned)delta_blocks, 256, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(o), static_cast<const __nv_bfloat16*>(dout), delta, rows,
      ctr, Sq, q_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const float scale_log2 = scale * LOG2E;
  // key tile on the slowest axis, then its slices: the split route tile 0's
  // first, the fused route in the dQ sum's order (its adds wait only on
  // blocks earlier in it)
  flash_bwd_dkdv_sm90<D><<<dim3(B * KV, k_tiles * split), C::KV_THREADS, C::SMEM_KV, stream>>>(
      q_kv, k_res, v_res, do_kv, lse, delta, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), parts, split, dq_map, ctr, q_tiles, C::FUSED ? group : 1,
      H, KV, Sq, Skv, causal, window, q_offset, scale, scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (split > 1) {  // right after the parts are written, while L2 holds them
    flash_bwd_reduce_sm90<<<(unsigned)reduce_blocks, REDUCE_THREADS, 0, stream>>>(
        parts, static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), n4, split,
        scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if constexpr (C::FUSED) {
    flash_bwd_dqsum_sm90<D><<<(unsigned)dqsum_blocks, REDUCE_THREADS, 0, stream>>>(
        dq_ws, counters, static_cast<__nv_bfloat16*>(dq), n8, Sq, q_tiles, scale);
  } else {
    flash_bwd_dq_sm90<D><<<dim3(B * H, q_tiles), C::Q_THREADS, C::SMEM_Q, stream>>>(
        q_res, k_q, v_q, do_res, lse, delta, static_cast<__nv_bfloat16*>(dq), H, KV, Sq, Skv,
        causal, window, q_offset, scale, scale_log2);
  }
  return cudaGetLastError();
}

template <int D>
constexpr int smem_bytes() {  // the fused route launches no dQ kernel
  return Cfg<D>::FUSED || Cfg<D>::SMEM_KV > Cfg<D>::SMEM_Q ? Cfg<D>::SMEM_KV : Cfg<D>::SMEM_Q;
}

// dK/dV blocks the current device holds at once: its SMs times the blocks a
// SM the kernel's registers and shared memory allow.
template <int D>
int dkdv_slots() {
  static unsigned long long kv_set = 0;
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      allow_smem(flash_bwd_dkdv_sm90<D>, Cfg<D>::SMEM_KV, kv_set) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, flash_bwd_dkdv_sm90<D>,
                                                    Cfg<D>::KV_THREADS, Cfg<D>::SMEM_KV) !=
          cudaSuccess)
    return -1;
  return sms * per_sm;
}

}  // namespace

// The dK/dV kernel's slots on the current device at head dim D: SMs x blocks
// a SM (-1 if D is not supported or a query fails).
extern "C" int flash_attention_bwd_sm90_slots(int D) {
  switch (D) {
    case 16: return dkdv_slots<16>();
    case 32: return dkdv_slots<32>();
    case 64: return dkdv_slots<64>();
    case 128: return dkdv_slots<128>();
    case 256: return dkdv_slots<256>();
    default: return -1;
  }
}

// Dynamic shared memory of the larger of the tile kernels' blocks at head
// dim D (the fused route's dK/dV kernel alone), in bytes (-1 if D is not
// supported).
extern "C" int flash_attention_bwd_sm90_smem_bytes(int D) {
  switch (D) {
    case 16: return smem_bytes<16>();
    case 32: return smem_bytes<32>();
    case 64: return smem_bytes<64>();
    case 128: return smem_bytes<128>();
    case 256: return smem_bytes<256>();
    default: return -1;
  }
}

// q, o, do, dq (B, H, Sq, D); k, v, dk, dv (B, KV, Skv, D): bf16,
// contiguous, 16-byte aligned. lse and the scratch delta: (B, H, Sq) fp32.
// split: the slices of each key tile's dK/dV walk (>= 1); with split > 1,
// parts is the workspace (2, split, B, KV, Skv, D) fp32, 16-byte aligned
// (unused at split = 1). At a fused head dim (FUSED_DQ_HEAD_DIMS), dq_ws is
// the fp32 dQ workspace (B, H, Sq, D) and counters the int32 turn counters
// (B, H, ceil(Sq / 64)), both scratch, and group (>= 1) the key tiles of a
// group of the dQ sum's order (dq_turn); all three unused elsewhere. Three
// launches on `stream` (four with split > 1); returns cudaGetLastError()
// after the last (0 on success).
extern "C" int flash_attention_bwd_sm90(const void* q, const void* k, const void* v,
                                        const void* o, const void* dout, const void* lse,
                                        void* delta, void* dq, void* dk, void* dv, int B, int H,
                                        int KV, int Sq, int Skv, int D, int causal, int window,
                                        int q_offset, float scale, int split, void* parts,
                                        void* dq_ws, void* counters, int group, void* stream) {
  if (B <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || Sq <= 0 || Skv <= 0 || q_offset < 0 ||
      window < 0 || (long long)B * H > 0x7fffffffLL || split < 1 ||
      (split > 1 && parts == nullptr))
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o) |
       reinterpret_cast<uintptr_t>(dout) | reinterpret_cast<uintptr_t>(dq) |
       reinterpret_cast<uintptr_t>(dk) | reinterpret_cast<uintptr_t>(dv) |
       reinterpret_cast<uintptr_t>(parts) | reinterpret_cast<uintptr_t>(dq_ws)) % 16)
    return (int)cudaErrorMisalignedAddress;
  const float* lf = static_cast<const float*>(lse);
  float* df = static_cast<float*>(delta);
  float* pf = static_cast<float*>(parts);
  float* wf = static_cast<float*>(dq_ws);
  int* cf = static_cast<int*>(counters);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return (int)launch<16>(q, k, v, o, dout, lf, df, dq, dk, dv, pf, wf, cf, group, split, B, H, KV, Sq, Skv, causal, window, q_offset, scale, s);
    case 32: return (int)launch<32>(q, k, v, o, dout, lf, df, dq, dk, dv, pf, wf, cf, group, split, B, H, KV, Sq, Skv, causal, window, q_offset, scale, s);
    case 64: return (int)launch<64>(q, k, v, o, dout, lf, df, dq, dk, dv, pf, wf, cf, group, split, B, H, KV, Sq, Skv, causal, window, q_offset, scale, s);
    case 128: return (int)launch<128>(q, k, v, o, dout, lf, df, dq, dk, dv, pf, wf, cf, group, split, B, H, KV, Sq, Skv, causal, window, q_offset, scale, s);
    case 256: return (int)launch<256>(q, k, v, o, dout, lf, df, dq, dk, dv, pf, wf, cf, group, split, B, H, KV, Sq, Skv, causal, window, q_offset, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
