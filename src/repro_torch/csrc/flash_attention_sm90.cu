// Flash-attention forward in bf16 for Hopper (sm_90a): tensor-core products
// with wgmma, TMA loads into swizzled shared memory, a K/V ring on mbarriers,
// a persistent grid of blocks of a producer warpgroup and one or two consumer
// warpgroups. Written by hand.
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
// (flash_attention_bwd_sm90.cu) recomputes P from it. Serving passes
// nullptr and gets what it got before lse existed, bit for bit.
//
// What bounds it on this card. At the main paths' prefill shapes the least
// times are (bytes of q, k, v, o once over 3.35 TB/s; 4.D FLOP per unmasked
// (query, key) pair over 989 TFLOP/s bf16):
//   smollm-360m      B8 H15 KV5 S512  D64  causal      0.0063 ms (bytes)
//   smollm-360m      B8 H15 KV5 S2048 D64  causal      0.0652 ms (operations)
//   llama3-8b        B8 H32 KV8 S512  D128 causal      0.0250 ms (bytes)
//   recurrentgemma   B8 H10 KV1 S512  D256 window 2048 0.0138 ms (bytes)
//   recurrentgemma   B1 H10 KV1 S3072 D256 window 2048 0.0434 ms (operations)
// Two costs stand between the kernel and those bounds. The softmax: a SM
// does about 4,096 bf16 FLOP a clock on its tensor cores but 16 ex2 a clock,
// and a (query, key) pair costs 4.D FLOP and one ex2, so at D = 128 the
// exponentials take half as long as both products, and the tensor cores idle
// while a warpgroup runs them. And each block's set-up: at S512 a work tile
// walks 1 to 4 key tiles, and the barriers' set-up, the first loads' latency
// and the epilogue's stores are a large part of it. The design:
//   * S = Q.K^T is an SS wgmma (m64 x BK x k16 steps over D): Q (64 rows of
//     one warpgroup) and K (BK keys) both K-major in shared memory;
//   * O += P.V is an RS wgmma (m64 x D x k16 steps over BK): P comes from
//     registers, V (keys x D, row-major) is an MN-major B operand read with
//     the transpose bit;
//   * warpgroup 0 of a block is the producer: it drops to 24 or 40
//     registers (setmaxnreg) and one of its threads issues every TMA load.
//     Each consumer warpgroup rises to 232 registers and owns 64 query rows
//     of a work tile. Up to D = 64 a block has one consumer and two blocks
//     share a SM; above, a block has two consumers that share each K/V tile,
//     one block a SM (a block of two was slower up to D = 64 on an H100, with
//     or without the overlaps below);
//   * the grid is persistent (PERSIST): as many blocks as the card holds at
//     once, each walking work tiles (batch, q head, query tile of 64 or 128
//     rows) in a static order, heaviest first (work_index). The producer
//     loads a tile's K and V as soon as their stages free and its Q into one
//     of two Q buffers (one at D = 256, where two do not fit), so a tile's
//     first loads land while the last tile is still running;
//   * at D = 128 each consumer pipelines its products (PIPELINE_HEAD_DIMS):
//     round r issues S of tile r, then P.V of tile r - 1, waits for S alone
//     (wait_group 1), runs tile r's softmax while P.V is on the tensor cores,
//     then waits for P.V and rescales O by tile r's alpha;
//   * at D = 128 the block's two consumers take turns (PINGPONG_HEAD_DIMS) on
//     named barriers 1 and 2: consumer c issues a round's products only after
//     the other has issued its own (bar.sync on 1 + c by the one whose turn
//     it is, bar.arrive on 2 - c by the other, 256 threads; consumer 0
//     first), so one's softmax runs while the other's products hold the
//     tensor cores, and the two never issue at once. Both take a round for
//     every key tile of the work tile and one more, passing the turn on tiles
//     their rows do not see, so their turns stay paired. At D <= 64 the
//     pipeline, and at D = 256 both overlaps, were slower on an H100
//     (benchmarks/torch_flash_fwd_variants.py; PERF.md);
//   * K and V tiles go through a ring of 2 stages with mbarriers of their own
//     (K full, V full, K empty, V empty): K's half of a stage frees once S has
//     landed, V's once P.V has, so the pipelined walk, which holds tile r's K
//     and tile r - 1's V at once, still has the next K in flight.
// None of this moves a rounding: each tile's S, softmax and P.V are the same
// operations on the same operands, and O's update is still acc *= alpha_j;
// acc += P_j V_j, tile after tile, so O and lse have the bits they had when
// each consumer waited out each product in turn, one block a work tile
// (benchmarks/torch_flash_fwd_ab.py holds them so against another tree).
// Tiles: BK = 128 keys up to D = 128, 64 at D = 256. Registers a consumer
// thread holds: at D = 128 O 64, S 64 and P 32 twice (the fragment in flight
// and the one the softmax writes); at D = 256 O 128, S 32, P 16; at D = 64
// O 32, S 64, P 32. ptxas gives 128 registers at launch up to D = 64 (two
// blocks of 256 threads a SM) and 168 above (384 threads), setmaxnreg moves
// them to the consumers, and nothing spills. Shared memory: Q_STAGES x Q (64
// or 128 rows x D), 2 stages of K and V BK x D, all bf16: 21, 41, 81, 193 and
// 193 KB a block at D = 16, 32, 64, 128 and 256 (Cfg::SMEM).
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
//   4. Serialized wgmma. ptxas serializes every wgmma of a function (its
//      advisory C7513) when a non-wgmma instruction defines an input register
//      of a wgmma still in flight. An earlier try at the in-warpgroup overlap
//      kept one P array, so tile r's softmax wrote the registers that tile
//      r - 1's P.V was reading, and a P array carried round the loop needed
//      a move on the back edge. Here the walk is unrolled by two over two P
//      arrays (pa0, pa1): the softmax always writes the one no product in
//      flight reads, each round's S accumulator is a fresh local, and
//      fence_regs pins O and P before each wgmma.fence and after each wait,
//      so the compiler moves no read or write of them across one. ptxas
//      draws the advisory at no head dim; the pipeline at D = 256 spills
//      (O 128 and two P arrays), which is one reason it is off there. The
//      build log is checked for both (chip_smoke.py phase 2).
//   5. The S fragment to the P operand. The S accumulator's fragment (rows
//      g and g + 8 of the warp's 16, columns 8j + 2(lane % 4) + {0, 1}) is
//      the A-operand fragment of the RS wgmma once two n8 chunks are packed
//      to bf16x2 (pack_bf16). A row lives in the 4 lanes of a quad, so its max
//      and sum go over __shfl_xor 1 and 2; l stays a per-thread partial sum
//      until the end.
//   6. Barrier phases across work tiles. The ring's stages and the Q buffers
//      keep counting across a block's work tiles (Walk::ring, the tile count
//      j), so each mbarrier's parity follows from the counts alone; the named
//      barriers stay paired because each consumer takes the same rounds.

#include "sm90.cuh"  // mbarriers, TMA, wgmma, the tensor-map encoder

namespace {

constexpr int STAGES = 2;        // K/V ring depth (a third was no faster on an H100)
// The schedule's choices (see the header), the two overlaps each a mask of
// the head dims (16 | 32 | 64 | 128 | 256) it is on at, as measured on an
// H100 (PERF.md); benchmarks/torch_flash_fwd_variants.py builds the kernel
// with each changed alone. None moves a bit.
constexpr int PIPELINE_HEAD_DIMS = 128;  // S of tile r in flight beside P.V of tile r - 1
constexpr int PINGPONG_HEAD_DIMS = 128;  // a block's two consumers take turns on the tensor cores
constexpr bool PERSIST = true;           // a block a slot, walking work tiles; else a block a tile
constexpr float NEG_INF = -1e30f;
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
  // Q buffers: two where they fit beside the ring, so the next work tile's
  // Q lands while this one's walk runs; one at D = 256.
  static constexpr int Q_STAGES = D >= 256 ? 1 : 2;
  static constexpr int KV_BYTES = BK * D * 2;     // K or V, one stage
  // Q full and Q empty per Q buffer; K full, V full, K empty and V empty per stage.
  static constexpr int BARRIERS = 2 * Q_STAGES + 4 * STAGES;
  // 1024 bytes of slack to align the tiles to the 128-byte swizzle's period.
  static constexpr int SMEM = 1024 + Q_STAGES * Q_BYTES + 2 * STAGES * KV_BYTES + 8 * BARRIERS;
  // wgmma descriptor layout type and the TMA swizzle of a panel (sm90.cuh).
  static constexpr uint64_t LAYOUT = desc_layout(SPAN);
  static constexpr CUtensorMapSwizzle SWIZZLE = tma_swizzle(SPAN);
  // The consumers take turns only where a block has two.
  static constexpr bool TURNS = (PINGPONG_HEAD_DIMS & D) != 0 && CONSUMERS == 2;
  static constexpr bool PIPELINE = (PIPELINE_HEAD_DIMS & D) != 0;
};

// Work tile w of a launch: (batch, q head, query tile), heaviest first. The
// query tiles run from the last (the causal diagonal's far end) to the
// first; within one, batch by batch, and the heads of a KV group side by side
// (they read the same K and V). A persistent grid of G blocks takes them in
// rounds of G, back and forth: in round k block i takes w = kG + i for even
// k and kG + G - 1 - i for odd k, so a block that took one of the heaviest
// tiles of a round takes one of the lightest of the next
// (kernels/flash_attention.py:fwd_tile_order is its twin).
struct WorkTile {
  int b, h, q0;
};
__device__ __forceinline__ int work_index(int k, int G) {
  return k * G + ((k & 1) ? G - 1 - (int)blockIdx.x : (int)blockIdx.x);
}
template <int D>
__device__ __forceinline__ WorkTile work_tile(int w, int B, int H, int q_tiles) {
  const int bh = w % (B * H);
  return {bh / H, bh % H, (q_tiles - 1 - w / (B * H)) * Cfg<D>::BQ};
}

// A P fragment array: the A operand of one tile's P.V, k16 step by step.
template <int D>
using PFrag = uint32_t[Cfg<D>::BK / 16][4];

// fence_regs (sm90.cuh) for a P fragment array.
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e])::"memory");
}

// Named barrier `id` over the block's two consumer warpgroups (256 threads):
// the one whose turn it is waits (bar.sync), the other arrives (bar.arrive).
__device__ __forceinline__ void turn_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(2 * WG_THREADS) : "memory");
}
__device__ __forceinline__ void turn_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(2 * WG_THREADS) : "memory");
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
__device__ __forceinline__ void issue_pv(float (&acc)[D / 2], const PFrag<D>& pa,
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
__device__ __forceinline__ void softmax_tile(float (&sc)[Cfg<D>::BK / 2], PFrag<D>& pa,
                                             float (&m)[2], float (&l)[2], float (&alpha)[2],
                                             float scale_log2, int k0, int row0, int quad,
                                             bool need_mask, int Skv, int causal, int window) {
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

// One consumer warpgroup's walk over the block's K/V ring: its rows, its
// running softmax state and O, and the rounds it takes. Tile `it` of the walk
// is key tile lo + it. Tiles no row of this warpgroup may see (before the
// window, past the diagonal) are a prefix and a suffix of the walk; only
// [t_lo, t_hi) is computed. Every stage is still waited for (its fill has
// landed) and released, so the ring's phases stay in step with the producer.
template <int D>
struct Walk {
  using C = Cfg<D>;
  static constexpr int BK = C::BK;
  uint32_t q_base, s_k, s_v, k_full, v_full, k_empty, v_empty;
  int c, lane, quad, row0, wg_first, wg_last, lo, n_tiles, Skv, causal, window;
  int ring;     // the block's ring tiles before this work tile's
  bool final;   // the block's last work tile
  float scale_log2;
  float acc[D / 2];
  float m[2];  // running max of the scaled log2 scores
  float l[2];  // this thread's part of the normalizer

  __device__ __forceinline__ bool dead(int it) const {
    const int k0 = (lo + it) * BK;
    return (causal && k0 > wg_last) || (window > 0 && wg_first - (k0 + BK - 1) >= window);
  }
  __device__ __forceinline__ bool need_mask(int it) const {
    const int k0 = (lo + it) * BK;
    return k0 + BK > Skv || (causal && k0 + BK - 1 > wg_first) ||
           (window > 0 && wg_last - k0 >= window);
  }
  // Tile it of the walk is ring tile ring + it of the block.
  __device__ __forceinline__ uint32_t stage_k(int it) const {
    return s_k + ((ring + it) % STAGES) * C::KV_BYTES;
  }
  __device__ __forceinline__ uint32_t stage_v(int it) const {
    return s_v + ((ring + it) % STAGES) * C::KV_BYTES;
  }
  __device__ __forceinline__ void wait_k(int it) const {
    mbar_wait(k_full + 8 * ((ring + it) % STAGES), ((ring + it) / STAGES) & 1);
  }
  __device__ __forceinline__ void wait_v(int it) const {
    mbar_wait(v_full + 8 * ((ring + it) % STAGES), ((ring + it) / STAGES) & 1);
  }
  // K's half of a stage is free once S has landed, V's once P.V has.
  __device__ __forceinline__ void release_k(int it) const {
    if (lane == 0) mbar_arrive(k_empty + 8 * ((ring + it) % STAGES));
  }
  __device__ __forceinline__ void release_v(int it) const {
    if (lane == 0) mbar_arrive(v_empty + 8 * ((ring + it) % STAGES));
  }
  // A tile these rows do not see: wait for its fill and free its stage.
  __device__ __forceinline__ void drop(int it) const {
    wait_k(it);
    release_k(it);
    wait_v(it);
    release_v(it);
  }
  // Round r's turn: wait for it, and hand it on once this round's products
  // are issued. Each consumer takes rounds 0 .. n_tiles of every work tile;
  // consumer 1 hands on none after the last round of its block's last, so
  // each barrier sees as many arrivals as waits.
  __device__ __forceinline__ void take_turn() const {
    if constexpr (C::TURNS) turn_sync(1 + c);
  }
  __device__ __forceinline__ void pass_turn(int r) const {
    if constexpr (C::TURNS)
      if (c == 0 || !final || r < n_tiles) turn_arrive(2 - c);
  }
  __device__ __forceinline__ void softmax(float (&sc)[BK / 2], PFrag<D>& pa, float (&alpha)[2],
                                          int it) {
    softmax_tile<D>(sc, pa, m, l, alpha, scale_log2, (lo + it) * BK, row0, quad,
                    need_mask(it), Skv, causal, window);
  }

  // A round with no product: retire tile r - 1, which these rows do not see.
  __device__ __forceinline__ void round_idle(int r) {
    if (r > 0) drop(r - 1);
    take_turn();
    pass_turn(r);
  }
  // Round t_lo: S of the first tile these rows see, its softmax into `pn`.
  __device__ __forceinline__ void round_first(int r, PFrag<D>& pn) {
    float sc[BK / 2], alpha[2];
    wait_k(r);
    take_turn();
    wgmma_fence();
    issue_qk<D>(sc, q_base, stage_k(r));
    wgmma_commit();
    pass_turn(r);
    wgmma_wait<0>();
    release_k(r);
    fence_regs(sc);
    softmax(sc, pn, alpha, r);
    rescale<D>(acc, alpha);
  }
  // Round r of the pipeline: S of tile r, then P.V of tile r - 1 from `pc`;
  // tile r's softmax into `pn` while P.V runs; then O rescaled by its alpha.
  __device__ __forceinline__ void round_both(int r, PFrag<D>& pc, PFrag<D>& pn) {
    float sc[BK / 2], alpha[2];
    wait_k(r);
    wait_v(r - 1);
    fence_regs(acc);
    fence_regs(pc);
    take_turn();
    wgmma_fence();
    issue_qk<D>(sc, q_base, stage_k(r));
    wgmma_commit();
    issue_pv<D>(acc, pc, stage_v(r - 1));
    wgmma_commit();
    pass_turn(r);
    wgmma_wait<1>();  // S has landed; P.V may still run
    release_k(r);
    fence_regs(sc);
    softmax(sc, pn, alpha, r);
    fence_regs(pn);
    wgmma_wait<0>();
    fence_regs(acc);
    rescale<D>(acc, alpha);
    release_v(r - 1);
  }
  // Round t_hi: P.V of the last tile these rows see.
  __device__ __forceinline__ void round_last(int r, PFrag<D>& pc) {
    wait_v(r - 1);
    fence_regs(acc);
    fence_regs(pc);
    take_turn();
    wgmma_fence();
    issue_pv<D>(acc, pc, stage_v(r - 1));
    wgmma_commit();
    pass_turn(r);
    wgmma_wait<0>();
    fence_regs(acc);
    release_v(r - 1);
  }
  // Without the pipeline: tile it's S, softmax and P.V one after another,
  // each product waited out; the turn covers S.
  __device__ __forceinline__ void round_serial(int it) {
    float sc[BK / 2], alpha[2];
    PFrag<D> pa;
    wait_k(it);
    take_turn();
    wgmma_fence();
    issue_qk<D>(sc, q_base, stage_k(it));
    wgmma_commit();
    pass_turn(it);
    wgmma_wait<0>();
    release_k(it);
    fence_regs(sc);
    softmax(sc, pa, alpha, it);
    rescale<D>(acc, alpha);
    wait_v(it);
    wgmma_fence();
    issue_pv<D>(acc, pa, stage_v(it));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    release_v(it);
  }

  // Rounds 0 .. n_tiles. Round r issues S of tile r and P.V of tile r - 1
  // where these rows see them; with PIPELINE off, round r < n_tiles runs
  // tile r whole and round n_tiles only passes the turn.
  __device__ __forceinline__ void run() {
    int t_lo = 0, t_hi = n_tiles;
    while (t_lo < t_hi && dead(t_lo)) ++t_lo;
    while (t_hi > t_lo && dead(t_hi - 1)) --t_hi;
    if constexpr (!C::PIPELINE) {
      for (int it = 0; it < n_tiles; ++it) {
        if (it < t_lo || it >= t_hi) {
          take_turn();
          pass_turn(it);
          drop(it);
        } else {
          round_serial(it);
        }
      }
      take_turn();
      pass_turn(n_tiles);
    } else {
      int r = 0;
      for (; r < t_lo; ++r) round_idle(r);
      if (t_lo < t_hi) {
        // The walk unrolled by two over pa0 and pa1: the softmax writes the
        // array that no product in flight reads.
        PFrag<D> pa0, pa1;
        if (r > 0) drop(r - 1);
        round_first(r++, pa0);
        for (; r + 1 < t_hi; r += 2) {
          round_both(r, pa0, pa1);
          round_both(r + 1, pa1, pa0);
        }
        if (r < t_hi) {
          round_both(r, pa0, pa1);
          round_last(r + 1, pa1);
        } else {
          round_last(r, pa0);
        }
        r = t_hi + 1;
      }
      for (; r <= n_tiles; ++r) round_idle(r);
    }
  }
};

template <int D>
__global__ void __launch_bounds__(Cfg<D>::THREADS, Cfg<D>::MIN_BLOCKS)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ o,
                      float* __restrict__ lse, int B, int H, int KV, int Sq, int Skv,
                      int causal, int window, int q_offset, float scale_log2) {
  using C = Cfg<D>;
  constexpr int BQ = C::BQ, BK = C::BK, SPAN = C::SPAN, PW = C::PW;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t s_q = (smem_u32(smem_raw) + 1023) & ~1023u;  // Q_STAGES x NP panels of BQ rows
  const uint32_t s_k = s_q + C::Q_STAGES * C::Q_BYTES;        // STAGES x NP panels of BK rows
  const uint32_t s_v = s_k + STAGES * C::KV_BYTES;            // the same for V
  const uint32_t bars = s_v + STAGES * C::KV_BYTES;
  // Barriers of Q buffer u: full at u, empty at Q_STAGES + u; of ring stage s:
  // K full at 2 Q_STAGES + s, then V full, K empty and V empty STAGES apart.
  const uint32_t q_full = bars, q_empty = q_full + 8 * C::Q_STAGES;
  const uint32_t k_full = q_empty + 8 * C::Q_STAGES, v_full = k_full + 8 * STAGES,
                 k_empty = v_full + 8 * STAGES, v_empty = k_empty + 8 * STAGES;
  const int q_tiles = (Sq + BQ - 1) / BQ, n_work = B * H * q_tiles;

  // The kv walk of a work tile: tiles [lo, lo + n_tiles) of BK keys. hi
  // stops at the causal diagonal, lo starts at q_start - window.
  auto walk_of = [&](const WorkTile& t, int& lo) {
    const int q_start = q_offset + t.q0;  // absolute position of the tile's row 0
    int hi = (Skv + BK - 1) / BK;
    if (causal) hi = min(hi, (q_start + BQ - 1) / BK + 1);
    lo = 0;
    if (window > 0 && q_start - window > 0) lo = (q_start - window) / BK;
    return max(hi - lo, 0);
  };

  if (threadIdx.x == 0) {
    for (int u = 0; u < C::Q_STAGES; ++u) {
      mbar_init(q_full + 8 * u, 1);
      mbar_init(q_empty + 8 * u, 4 * C::CONSUMERS);  // lane 0 of every consumer warp
    }
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(k_empty + 8 * s, 4 * C::CONSUMERS);
      mbar_init(v_empty + 8 * s, 4 * C::CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / WG_THREADS;
  if (wg == 0) {
    // Producer: one thread keeps the ring full, work tile after work tile,
    // and loads each tile's Q as soon as its buffer is free.
    setmaxnreg_dec<C::PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      int ring = 0, j = 0;
      for (int k = 0; k * (int)gridDim.x < n_work; ++k) {
        const int w = work_index(k, gridDim.x);
        if (w >= n_work) continue;
        const WorkTile t = work_tile<D>(w, B, H, q_tiles);
        int lo;
        const int n_tiles = walk_of(t, lo);
        const int bh_q = t.b * H + t.h, bh_kv = t.b * KV + t.h / (H / KV);
        // Q into buffer j % Q_STAGES once the consumers are done with the tile
        // that held it last. With one buffer that is the last tile, so its Q
        // follows this tile's first K tile, whose stage frees a round earlier.
        const int u = j % C::Q_STAGES, use = j / C::Q_STAGES;
        const bool q_first = C::Q_STAGES > 1 || j == 0 || n_tiles == 0;
        auto load_q = [&] {
          if (use > 0) mbar_wait(q_empty + 8 * u, (use - 1) & 1);
          mbar_expect_tx(q_full + 8 * u, C::Q_BYTES);
#pragma unroll
          for (int p = 0; p < C::NP; ++p)
            tma_load(s_q + u * C::Q_BYTES + p * BQ * SPAN, &tm_q, q_full + 8 * u, p * PW, t.q0,
                     bh_q);
        };
        if (q_first) load_q();
        for (int it = 0; it < n_tiles; ++it, ++ring) {
          const int s = ring % STAGES;
          const int k0 = (lo + it) * BK, free = ((ring / STAGES) & 1) ^ 1;  // the first pass passes
          mbar_wait(k_empty + 8 * s, free);
          mbar_expect_tx(k_full + 8 * s, C::KV_BYTES);
#pragma unroll
          for (int p = 0; p < C::NP; ++p)
            tma_load(s_k + s * C::KV_BYTES + p * BK * SPAN, &tm_k, k_full + 8 * s, p * PW, k0,
                     bh_kv);
          if (it == 0 && !q_first) load_q();
          mbar_wait(v_empty + 8 * s, free);
          mbar_expect_tx(v_full + 8 * s, C::KV_BYTES);
#pragma unroll
          for (int p = 0; p < C::NP; ++p)
            tma_load(s_v + s * C::KV_BYTES + p * BK * SPAN, &tm_v, v_full + 8 * s, p * PW, k0,
                     bh_kv);
        }
        ++j;
      }
    }
  } else {
    // Consumer c: query rows 64c .. 64c + 63 of each work tile.
    setmaxnreg_inc<C::CONSUMER_REGS>();
    const int c = wg - 1;
    const int tid = threadIdx.x % WG_THREADS;
    const int warp = tid / 32, lane = tid % 32, g = lane / 4, quad = lane % 4;
    if constexpr (C::TURNS)
      if (c == 1) turn_arrive(1);  // consumer 0 takes the first turn
    Walk<D> w;
    w.s_k = s_k;
    w.s_v = s_v;
    w.k_full = k_full;
    w.v_full = v_full;
    w.k_empty = k_empty;
    w.v_empty = v_empty;
    w.c = c;
    w.lane = lane;
    w.quad = quad;
    w.Skv = Skv;
    w.causal = causal;
    w.window = window;
    w.scale_log2 = scale_log2;
    w.ring = 0;
    int j = 0;
    for (int k = 0; k * (int)gridDim.x < n_work; ++k) {
      const int wt = work_index(k, gridDim.x);
      if (wt >= n_work) continue;
      const WorkTile t = work_tile<D>(wt, B, H, q_tiles);
      w.n_tiles = walk_of(t, w.lo);
      w.final = (k + 1) * (int)gridDim.x >= n_work || work_index(k + 1, gridDim.x) >= n_work;
      w.wg_first = q_offset + t.q0 + 64 * c;
      w.wg_last = w.wg_first + 63;
      w.row0 = w.wg_first + 16 * warp + g;  // this thread's rows: row0 and row0 + 8
      const int u = j % C::Q_STAGES;
      w.q_base = s_q + u * C::Q_BYTES + 64 * c * SPAN;
#pragma unroll
      for (int i = 0; i < D / 2; ++i) w.acc[i] = 0.f;
      w.m[0] = w.m[1] = NEG_INF;  // running max of the scaled log2 scores
      w.l[0] = w.l[1] = 0.f;      // this thread's part of the normalizer
      mbar_wait(q_full + 8 * u, (j / C::Q_STAGES) & 1);
      w.run();
      if (lane == 0) mbar_arrive(q_empty + 8 * u);  // every S of this tile has landed
      w.ring += w.n_tiles;

      // Normalize and store rows below Sq.
      const int bh_q = t.b * H + t.h;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        w.l[hh] += __shfl_xor_sync(0xffffffffu, w.l[hh], 1);
        w.l[hh] += __shfl_xor_sync(0xffffffffu, w.l[hh], 2);
      }
      __nv_bfloat16* op = o + (size_t)bh_q * Sq * D;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = w.row0 + 8 * hh - q_offset;
        if (r < Sq) {
          if (lse != nullptr && quad == 0)  // natural log: m and log2 l are base 2
            lse[(size_t)bh_q * Sq + r] = (w.m[hh] + log2f(w.l[hh])) * LN2;
          const float denom = fmaxf(w.l[hh], 1e-30f);
#pragma unroll
          for (int jj = 0; jj < D / 8; ++jj) {
            __nv_bfloat162 v = __floats2bfloat162_rn(w.acc[4 * jj + 2 * hh] / denom,
                                                     w.acc[4 * jj + 2 * hh + 1] / denom);
            *reinterpret_cast<__nv_bfloat162*>(op + (size_t)r * D + 8 * jj + 2 * quad) = v;
          }
        }
      }
      ++j;
    }
  }
}

// ---- host side -------------------------------------------------------------

// A map over a contiguous (BH, S, D) bf16 tensor, boxes of rows x PW.
template <int D>
bool make_map(CUtensorMap* map, const void* ptr, int S, int BH, int rows) {
  return make_map_bf16(map, ptr, D, S, BH, Cfg<D>::PW, rows, Cfg<D>::SWIZZLE);
}

// Blocks the current device holds at once: its SMs times the blocks a SM
// the kernel's registers and shared memory allow (-1 if a query fails);
// asked once a device.
template <int D>
int slots() {
  static int known[64] = {};
  static unsigned long long smem_set = 0;
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (dev < 64 && known[dev] > 0) return known[dev];
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      allow_smem(flash_fwd_sm90_kernel<D>, Cfg<D>::SMEM, smem_set) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, flash_fwd_sm90_kernel<D>,
                                                    Cfg<D>::THREADS, Cfg<D>::SMEM) !=
          cudaSuccess ||
      per_sm <= 0)
    return -1;
  if (dev < 64) known[dev] = sms * per_sm;
  return sms * per_sm;
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
  const int n_slots = slots<D>();  // also sets the shared memory limit
  if (n_slots <= 0) return cudaErrorInvalidValue;
  const long long n_work = (long long)B * H * ((Sq + C::BQ - 1) / C::BQ);
  if (n_work > 0x7fffffff) return cudaErrorInvalidValue;
  const int grid = PERSIST && n_work > n_slots ? n_slots : (int)n_work;
  flash_fwd_sm90_kernel<D><<<grid, C::THREADS, C::SMEM, stream>>>(
      tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(o), lse, B, H, KV, Sq, Skv, causal, window,
      q_offset, scale * LOG2E);
  return cudaGetLastError();
}

}  // namespace

// The blocks of a persistent launch on the current device at head dim D: SMs
// x blocks a SM (-1 if D is not supported or a query fails).
extern "C" int flash_attention_sm90_slots(int D) {
  switch (D) {
    case 16: return slots<16>();
    case 32: return slots<32>();
    case 64: return slots<64>();
    case 128: return slots<128>();
    case 256: return slots<256>();
    default: return -1;
  }
}

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
      window < 0)
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
