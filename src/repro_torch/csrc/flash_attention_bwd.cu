// Flash-attention backward in fp32 for Hopper (sm_90a): split-TF32 products
// on the tensor cores (mma.sync), fed by a cp.async ring. Written by hand.
// bf16 inputs, which the train paths give, take the wgmma backward in
// flash_attention_bwd_sm90.cu.
//
// The TPU side has no backward kernel: the JAX package trains through
// autodiff of the jnp twin of src/repro/kernels/flash_attention.py:
// _flash_kernel (src/repro/nn/attention.py:flash_attention). This is the
// backward of the port's fp32 forward (flash_attention.cu), bound to it by
// FlashAttentionFn in kernels/flash_attention.py. Same function as the
// forward: GQA over q (B, H, Sq, D) and k/v (B, KV, Skv, D), H % KV == 0,
// causal, local-window (q_pos - k_pos < window) or bidirectional masks, an
// absolute q_offset, any Sq and Skv, head_dim 16, 32, 64, 128 or 256
// (recurrentgemma's, whose fp32 training, a job manifest's dtype override,
// runs here). Its plain version is kernels/ref.py:flash_attention_bwd_ref,
// the explicit formulas below.
//
// What it computes, from q, k, v, the forward's output o, the output's
// gradient do and the forward's fp32 row logsumexp lse (natural log):
//   Δ = rowsum(dO∘O)
//   P = exp(S·scale - lse)              (0 where masked)
//   dV = Pᵀ·dO,  dP = dO·Vᵀ,  dS = P∘(dP - Δ)
//   dQ = dS·K·scale,  dK = dSᵀ·Q·scale  (a GQA group's heads summed into dK, dV)
// to fp32's accuracy: every product is three TF32 products of split
// operands (below). The scale is applied in fp32 to the sums: in the
// exponent of P, and to dQ and dK as they are stored.
//
// Deterministic, with no atomics: the FlashAttention-2 split into three
// kernels, each output element summed by one thread in a fixed order, and
// a fourth where the dK/dV walk is split (below).
//   1. flash_bwd_delta: Δ, D/4 threads a row (32 at D = 256, 32 bytes
//      each), 16 bytes at a time, summed over a fixed shuffle tree.
//   2. flash_bwd_dkdv: one block a (b, kv head, key tile of 64, slice of the
//      walk), key tile 0 first (under a causal mask the heaviest). It keeps
//      its K and V tiles in shared memory and the dK, dV sums in registers
//      and walks its slice of the key tile's walk: the G query heads of its
//      group, then the query tiles that see any of its keys, in that order,
//      streaming Q, dO and the rows' lse and Δ.
//   3. flash_bwd_reduce (split > 1 only): dK = scale·Σ parts, dV = Σ parts.
//   4. flash_bwd_dq: one block a (b, q head, query tile of 64), heaviest
//      tiles first. It keeps Q and dO in shared memory and the rows' lse and
//      Δ in registers and walks the key tiles its rows see, streaming K and V.
// The split of the dK/dV walk (the caller's `split`, P; the plan is
// kernels/flash_attention.py:bwd_split). Under GQA and MQA one key tile's
// walk is G heads long, and under a causal mask key tile 0's is the longest:
// at recurrentgemma's B8 H10 KV1 S512 D256 the grid had 64 blocks for the
// card's 132 slots (one block a SM), the first walking 10 x 32 (head, query
// tile) steps, 3.7 times an even share of the launch's 11,520. So each key
// tile's walk is cut into P contiguous slices, [p·n/P, (p+1)·n/P) of its n
// steps, one block each, with key tile on the grid's slowest axis (y = tile·P
// + p): every tile's slices are about n/P, so the launch order stays the
// heaviest first. P is one number for the launch, not one a tile that grows
// with the tile's weight: blocks are dispatched in launch order, and a
// weight-proportional split makes slices of about one even share each in
// every tile, in tile order, past the slots, which leaves a tail of a partial
// second wave as long as a slice; one P keeps the slices ordered by weight so
// that the light ones fill the gaps. A block with P > 1 writes its unscaled
// fp32 sums to its part of the caller's workspace, (2, P, B, KV, Skv, D) fp32
// (dK's parts, then dV's); flash_bwd_reduce adds the parts in slice order,
// p = 0 first, with round-to-nearest adds, scales dK and stores each element
// once. With P = 1 the block stores its sums scaled, as before the split:
// the same code path and bits. No long sum is an mma accumulator either way.
// Two launches on the same inputs give the same bits. The masks skip tiles as
// the forward's do: a warp visits no streamed tile wholly above the causal
// diagonal or wholly past the window for its 16 rows, and masks per element
// only the tiles that straddle an edge. Rows past Sq and keys past Skv load
// as zeros and get probability 0 (a key past Skv in the dK/dV kernel is a
// row of its own that is never stored).
//
// What bounds it on this card. The five products (S, dP, dV, dQ, dK) are
// 10·D FLOP per unmasked (query, key) pair and head; the bytes are q, o, do,
// dq, k, v, dk, dv once each and the fp32 lse. At B8 H15 KV5 S512 D64 fp32
// causal that is 10.09 GFLOP and 84.13 MB (0.025 ms at 3.35 TB/s). Done as
// three TF32 products each on the tensor cores (495 TFLOP/s dense) the
// operations bound it: 30.26 GFLOP, 0.061 ms; on the fp32 CUDA cores (67
// TFLOP/s) 0.151 ms. The split does seven products a pair, not five (S and
// dP in both tile kernels: the price of no atomics), over whole 16 x 32
// warp tiles: 44.92 TF32 GFLOP at that shape. At recurrentgemma's B8 H10
// KV1 S512 D256 causal: 26.90 GFLOP (80.69 split-TF32 GFLOP, 0.163 ms),
// 184.71 MB (0.055 ms), 0.401 ms on the CUDA cores.
//
// The split and its error: as the forward's (flash_attention.cu), each
// operand x goes to the tensor cores as hi = tf32(x) and lo = x - hi, and
// x.y as lo.hi' + hi.lo' + hi.hi' with fp32 accumulation (tf32.cuh). Every
// operand is split: Q, K, V, dO, and the fp32 P and dS (never rounded to
// bf16, unlike the bf16 route). The tensor cores round each accumulation
// toward zero, so a long sum in one mma accumulator drifts: dK and dV sum
// over the G heads of a group and every query row that sees a key (3000
// rows at B1 H15 KV5 S1000, 1,125 accumulations into one dK element). Summed
// that way, the gradients there come out 3.0e-5 of max|grad| from the plain
// backward, past fp32's tolerance of 2e-5; as below, 2.0e-6
// (benchmarks/torch_flash_bwd_variants.py fp32, variant longacc). So a long
// sum is never an mma accumulator:
//   * S and dP (sums over D) keep hi.hi' in an accumulator of its own, the
//     small terms in another, added once at the end (the forward's S);
//   * dV, dK and dQ take each streamed tile's product in a fresh mma
//     accumulator (a k-step's small terms first, then hi.hi'), FOLD 8-wide
//     D tiles at a time, and add it into their fp32 registers with
//     round-to-nearest adds: 4 registers a D tile, not a second copy of the
//     sums.
//
// The instruction: mma.sync.aligned.m16n8k8 .tf32, not wgmma, for the
// forward's reason: a TF32 wgmma takes both operands K-major only, and dV =
// Pᵀ·dO, dK = dSᵀ·Q and dQ = dS·K read dO, Q and K with rows as the
// reduction index, so each would need transposed hi and lo copies in shared
// memory. mma.sync loads each thread's fragment itself: one raw fp32 copy of
// a tile serves both reads, and the split happens in registers.
//
// The design, against what bounds it:
//   * both tile kernels have 4 warps (8 at D = 256, below), each owning 16
//     resident rows (the m16 of the mma: keys in dK/dV, queries in dQ), and
//     stream tiles of BS rows (32 up to D = 64, 16 from D = 128) through a
//     two-stage cp.async ring
//     (16 bytes a thread, L2 only; lse and Δ by 4-byte copies, since a row
//     of lse need not start on 16 bytes): the next tile's copy is in flight
//     while the warps compute this one's, and each __syncthreads both
//     publishes the copy that landed and frees the stage the next copy
//     overwrites;
//   * the dK/dV kernel keeps keys as rows: Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ, so Pᵀ
//     and dSᵀ leave the m16n8 accumulator as the A operand of dV += Pᵀ·dO
//     and dK += dSᵀ·Q in registers, with no shuffle: within each 8-query
//     step the thread's columns 2t and 2t + 1 are taken as the k indices t
//     and t + 4, and dO's and Q's rows are read in the same order. lse and Δ
//     are then per column; each stage carries the rows' copies. The dQ
//     kernel computes S = Q·Kᵀ and dP = dO·Vᵀ and adds dS·K the same way;
//   * one tile, two read patterns: Q and dO (dK/dV) and K (dQ) are read
//     K-major for the scores (rows 8n + g, columns 8kk + t and + 4) and
//     MN-major for the D-wide products (rows 8j + 2t and + 1, column 8n +
//     g). Every tile has rows of D + 4 floats, 16 bytes apart in the banks.
//     The K-major reads are ldmatrix.x4, four 8 x 4 fp32 blocks a load (A's
//     fragment of a k-step, or B's of two 8-row tiles), whose 8 rows a block
//     then fall on 8 different 16-byte bank groups; the MN-major reads are
//     4-byte loads (ldmatrix transposes only 16-bit elements), on banks 8t +
//     g (mod 32): both conflict-free. (The forward's float2 loads along D
//     need a stride of D + 8, under which the MN-major reads conflict two
//     ways.) Each row stays on 16 bytes for cp.async;
//   * registers: dK and dV take D floats a thread, dQ D/2; the streamed tile
//     is 16 rows at D = 128 so the scores (BS/2 floats each, with hi.hi'
//     apart) and the split fragments of P and dS fit beside them, with no
//     spill (255 and 189 registers a thread at D = 128, the cap 255).
//     Shared memory (Cfg::SMEM_KV, SMEM_Q): two resident 64-row tiles and
//     two stages of two streamed tiles, 70,144 B a dK/dV block at D = 64,
//     101,632 B at D = 128; the registers (about 200 a thread) hold a SM to
//     two blocks. Capping them at 168 for three blocks spills and runs
//     slower, and so do 16-row streamed tiles at D = 64
//     (benchmarks/torch_flash_bwd_variants.py fp32, PERF.md);
//   * head_dim 256 (Cfg::SPLIT = 2): dK and dV would take 256 floats a
//     thread, past the cap before any score. So each 16-row slab has two
//     warps (8 a block, 256 threads), each owning half of the output
//     columns (dK and dV, or dQ: D = 128's accumulator load). The first
//     computes the slab's full-D Sᵀ (S) and P, the second dPᵀ (dP); they
//     swap them through 2 KB of shared memory a slab under a 64-thread
//     named barrier, and each forms dS itself, the same bits in both. Both
//     computing both score tiles, with no barrier, gives the same bits and
//     took 3.04 ms against 2.36 at B8 H10 KV1 S512 causal
//     (benchmarks/torch_flash_bwd_variants.py fp32 redundant, PERF.md). S
//     and dP sum over 256 in one hi.hi' accumulator, as the forward's S
//     does at D = 256. The split changes no sum: each output element is
//     still one thread's, in the same order. 208,128 B of shared memory a
//     dK/dV block and 207,872 B a dQ block: one block an SM. Under
//     recurrentgemma's MQA the dK/dV kernel has B·KV·Skv/64 key tiles, 64
//     for 132 SMs at B8 S512, and the heaviest (the first key tile, causal)
//     walks all 10 heads' 32 query tiles: the walk's split (above) is for
//     this.
// The kernels allocate nothing and launch on the caller's stream.

#include "tf32.cuh"  // the TF32 split, mma.sync and cp.async helpers

namespace {

constexpr int SLABS = 4;        // 16-row slabs of resident rows a block
constexpr int BR = 16 * SLABS;  // resident rows a block: keys (dK/dV), queries (dQ)
constexpr int STAGES = 2;       // streamed-tile ring depth
constexpr int DELTA_THREADS = 256;
constexpr int REDUCE_THREADS = 256;

template <int D>
struct Cfg {
  static constexpr int BS = D <= 64 ? 32 : 16;  // streamed rows a tile: queries (dK/dV), keys (dQ)
  static constexpr int LD = D + 4;              // row stride of every tile, floats
  static constexpr int NS = BS / 8;             // 8-wide column tiles of a warp's score tile
  // warps a slab: each owns D / SPLIT of the output columns (dK and dV, or dQ)
  static constexpr int SPLIT = D > 128 ? 2 : 1;
  static constexpr int THREADS = 32 * SLABS * SPLIT;
  static constexpr int DT = D / 8 / SPLIT;      // 8-wide column tiles of a warp's output
  static constexpr int FOLD = 4 < DT ? 4 : DT;  // D tiles summed in fresh accumulators at once
  // blocks a SM: three at D = 16 (166 registers a thread), which the dK/dV
  // walk's planner counts on (kernels/flash_attention.py:meta_slots)
  static constexpr int MIN_BLOCKS = D == 16 ? 3 : SPLIT == 1 ? 2 : 1;
  static constexpr int RES = BR * LD;           // floats of a resident tile
  static constexpr int TILE = BS * LD;          // floats of a streamed tile
  static constexpr int KV_STAGE = 2 * TILE + 2 * BS;  // Q, dO, the rows' lse and Δ
  // a slab's two warps swap a score tile each (SPLIT = 2): P, then dP, NS x 4
  // floats a thread
  static constexpr int XT = NS * 4 * 32;
  static constexpr int XCH = SPLIT == 2 ? SLABS * 2 * XT : 0;
  static constexpr size_t SMEM_KV =
      (size_t)(2 * RES + STAGES * KV_STAGE + XCH) * sizeof(float);
  static constexpr size_t SMEM_Q = (size_t)(2 * RES + STAGES * 2 * TILE + XCH) * sizeof(float);
};

// 4 bytes global -> shared; src_bytes 0 writes a zero.
__device__ __forceinline__ void cp_async4(float* dst, const float* src, int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes)
               : "memory");
}

// Four 8 x 4 fp32 blocks of shared memory into registers (ldmatrix.x4 on
// 16-bit pairs, which moves 32-bit words unchanged): lanes 8i .. 8i + 7 give
// the rows of block i, and the thread gets word t of row g of each block.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const float* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}

// Rows [r0, r0 + ROWS) of a contiguous (S, D) matrix into a tile of row
// stride D + 4, 16 bytes a copy; rows past S become zeros. Not committed.
template <int D, int ROWS>
__device__ __forceinline__ void load_rows(float* dst, const float* src, int r0, int S, int tid) {
  constexpr int CPR = D / 4;  // 16-byte chunks a row
  for (int c = tid; c < ROWS * CPR; c += Cfg<D>::THREADS) {
    const int r = c / CPR, col = (c % CPR) * 4;
    const bool in = r0 + r < S;
    cp_async16(dst + r * Cfg<D>::LD + col, src + (in ? (size_t)(r0 + r) * D + col : 0),
               in ? 16 : 0);
  }
}

// Step p·n/P of a walk of n steps cut into P slices (floor), in 32-bit
// arithmetic: (n / P)·p + (n % P)·p / P, exact while P² fits 32 bits (the
// grid holds P under 65536).
__device__ __forceinline__ int slice_start(int p, int n, int P) {
  const unsigned q = (unsigned)n / P, r = (unsigned)n % P;
  return (int)(q * p + r * p / P);
}

// Whether the query at absolute position qpos sees the key at kpos.
__device__ __forceinline__ bool visible(int qpos, int kpos, int causal, int window) {
  return (!causal || qpos >= kpos) && (window <= 0 || qpos - kpos < window);
}

// A warp's score tile (the m16n8 accumulator layout) into shared memory and
// back, element (j, e) of lane l at (4j + e)·32 + l: conflict-free 4-byte
// accesses, and a lane of the other warp of the slab reads the same element.
template <int NS>
__device__ __forceinline__ void put_tile(float* x, const float (&v)[NS][4], int lane) {
#pragma unroll
  for (int j = 0; j < NS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[(4 * j + e) * 32 + lane] = v[j][e];
}
template <int NS>
__device__ __forceinline__ void get_tile(float (&v)[NS][4], const float* x, int lane) {
#pragma unroll
  for (int j = 0; j < NS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) v[j][e] = x[(4 * j + e) * 32 + lane];
}

// The two warps of slab `slab` (64 threads) meet: named barrier 1 + slab
// (0 is __syncthreads'); orders their shared-memory writes before the reads.
__device__ __forceinline__ void pair_sync(int slab) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(1 + slab) : "memory");
}

// acc (16 x 8NS, the m16n8 accumulator layout) = A·Bᵀ over D, both K-major
// with rows of D + 4 floats: `a` the warp's 16 rows of A, `b` the NS x 8 rows
// of B. k-step kk reads columns 8kk + t and 8kk + t + 4: one ldmatrix.x4 for
// A's fragment and one for each two 8-row tiles of B. lo.hi' and hi.lo' go
// into acc, hi.hi' into an accumulator of its own, added once at the end; in
// each k-step the products are issued by kind, so no two in a row share an
// accumulator.
template <int D, int NS>
__device__ __forceinline__ void scores(float (&acc)[NS][4], const float* a, const float* b) {
  constexpr int LD = D + 4;
  const int lane = threadIdx.x & 31;
  // The row and column of this lane's ldmatrix address: A's blocks are rows
  // 0-7 and 8-15 at column 0, then both at column 4; B's are rows 0-7 at
  // columns 0 and 4, then rows 8-15 at both.
  const float* ar = a + ((lane & 7) + ((lane >> 3) & 1) * 8) * LD + (lane >> 4) * 4;
  const float* br = b + ((lane & 7) + (lane >> 4) * 8) * LD + ((lane >> 3) & 1) * 4;
  float big[NS][4];
#pragma unroll
  for (int n = 0; n < NS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = big[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    uint32_t ah[4], al[4], bh[NS][2], bl[NS][2], r[4];
    ldsm_x4(r, ar + 8 * kk);
#pragma unroll
    for (int i = 0; i < 4; ++i) split(__uint_as_float(r[i]), ah[i], al[i]);
#pragma unroll
    for (int n = 0; n < NS; n += 2) {
      ldsm_x4(r, br + 8 * n * LD + 8 * kk);
      split(__uint_as_float(r[0]), bh[n][0], bl[n][0]);
      split(__uint_as_float(r[1]), bh[n][1], bl[n][1]);
      split(__uint_as_float(r[2]), bh[n + 1][0], bl[n + 1][0]);
      split(__uint_as_float(r[3]), bh[n + 1][1], bl[n + 1][1]);
    }
#pragma unroll
    for (int n = 0; n < NS; ++n) mma(acc[n], al, bh[n]);
#pragma unroll
    for (int n = 0; n < NS; ++n) mma(big[n], ah, bh[n]);
#pragma unroll
    for (int n = 0; n < NS; ++n) mma(acc[n], ah, bl[n]);
  }
#pragma unroll
  for (int n = 0; n < NS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] += big[n][e];
}

// A score tile in the accumulator layout as the split A operand of the next
// product: in k-step j the thread's columns 8j + 2t and 8j + 2t + 1 are the
// k indices t and t + 4.
template <int NS>
__device__ __forceinline__ void to_a(const float (&x)[NS][4], uint32_t (&hi)[NS][4],
                                     uint32_t (&lo)[NS][4]) {
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    split(x[j][0], hi[j][0], lo[j][0]);
    split(x[j][2], hi[j][1], lo[j][1]);
    split(x[j][1], hi[j][2], lo[j][2]);
    split(x[j][3], hi[j][3], lo[j][3]);
  }
}

// sum (16 x D / SPLIT, the warp's output columns) += A·B over the 8NS rows
// of a streamed tile: A split in registers (to_a), B the tile read MN-major,
// `b` at row 2t and the warp's first column plus g (rows of D + 4 floats):
// k-step j reads rows 8j + 2t and 8j + 2t + 1. FOLD D tiles at a time, the
// tile's product goes into fresh mma accumulators (each k-step's lo.hi',
// hi.lo', then hi.hi') and is then added into the fp32 sums with
// round-to-nearest adds, so no mma accumulator runs longer than one tile.
template <int D, int NS>
__device__ __forceinline__ void accumulate(float (&sum)[Cfg<D>::DT][4],
                                           const uint32_t (&ah)[NS][4],
                                           const uint32_t (&al)[NS][4], const float* b) {
  constexpr int LD = D + 4, FOLD = Cfg<D>::FOLD;
#pragma unroll
  for (int n0 = 0; n0 < Cfg<D>::DT; n0 += FOLD) {
    float part[FOLD][4];
#pragma unroll
    for (int n = 0; n < FOLD; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[n][e] = 0.f;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const float* r = b + 8 * j * LD + 8 * n0;
      uint32_t bh[FOLD][2], bl[FOLD][2];
#pragma unroll
      for (int n = 0; n < FOLD; ++n) {
        split(r[8 * n], bh[n][0], bl[n][0]);
        split(r[LD + 8 * n], bh[n][1], bl[n][1]);
      }
#pragma unroll
      for (int n = 0; n < FOLD; ++n) mma(part[n], al[j], bh[n]);
#pragma unroll
      for (int n = 0; n < FOLD; ++n) mma(part[n], ah[j], bl[n]);
#pragma unroll
      for (int n = 0; n < FOLD; ++n) mma(part[n], ah[j], bh[n]);
    }
#pragma unroll
    for (int n = 0; n < FOLD; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sum[n0 + n][e] += part[n][e];
  }
}

// Rows row and row + 8 of a warp's 16 x D / SPLIT sums, times mul, into
// columns col0 on of a (S, D) matrix; rows at or past S are not written.
template <int D>
__device__ __forceinline__ void store_rows(float* __restrict__ out,
                                           const float (&sum)[Cfg<D>::DT][4], int row, int S,
                                           int col0, int t, float mul) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = row + 8 * hh;
    if (r < S) {
#pragma unroll
      for (int n = 0; n < Cfg<D>::DT; ++n)
        *reinterpret_cast<float2*>(out + (size_t)r * D + col0 + 8 * n + 2 * t) =
            make_float2(sum[n][2 * hh] * mul, sum[n][2 * hh + 1] * mul);
    }
  }
}

// ---- the kernels -------------------------------------------------------------

// Δ = rowsum(dO∘O) in fp32: TPR threads a row (D/4, at most a warp), 16
// bytes at a time, columns 4 part + 4 TPR i for i = 0, 1, ... in order.
template <int D>
__global__ void __launch_bounds__(DELTA_THREADS)
flash_bwd_delta(const float* __restrict__ o, const float* __restrict__ dout,
                float* __restrict__ delta, long long rows) {
  constexpr int TPR = D / 4 < 32 ? D / 4 : 32;
  const long long row = (long long)blockIdx.x * (DELTA_THREADS / TPR) + threadIdx.x / TPR;
  const int part = threadIdx.x % TPR;
  float acc = 0.f;
  if (row < rows) {
#pragma unroll
    for (int c = 4 * part; c < D; c += 4 * TPR) {
      const float4 a = *reinterpret_cast<const float4*>(o + row * D + c);
      const float4 b = *reinterpret_cast<const float4*>(dout + row * D + c);
      acc = fmaf(b.x, a.x, acc);
      acc = fmaf(b.y, a.y, acc);
      acc = fmaf(b.z, a.z, acc);
      acc = fmaf(b.w, a.w, acc);
    }
  }
#pragma unroll
  for (int off = TPR / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (row < rows && part == 0) delta[row] = acc;
}

// Stage of the dK/dV ring: query rows [m0, m0 + BS) of q head bh: Q, dO, then
// the rows' lse and Δ (zeros past Sq, where the mask sets P to 0). Committed.
template <int D>
__device__ __forceinline__ void load_query_stage(float* st, const float* __restrict__ q,
                                                 const float* __restrict__ dout,
                                                 const float* __restrict__ lse,
                                                 const float* __restrict__ delta, size_t bh,
                                                 int m0, int Sq, int tid) {
  using C = Cfg<D>;
  load_rows<D, C::BS>(st, q + bh * Sq * D, m0, Sq, tid);
  load_rows<D, C::BS>(st + C::TILE, dout + bh * Sq * D, m0, Sq, tid);
  if (tid < 2 * C::BS) {
    const int i = tid % C::BS;
    const bool in = m0 + i < Sq;
    cp_async4(st + 2 * C::TILE + tid, (tid < C::BS ? lse : delta) + (in ? bh * Sq + m0 + i : 0),
              in ? 4 : 0);
  }
  cp_async_commit();
}

template <int D>
__global__ void __launch_bounds__(Cfg<D>::THREADS, Cfg<D>::MIN_BLOCKS)
flash_bwd_dkdv(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               float* __restrict__ dk, float* __restrict__ dv, float* __restrict__ parts,
               int split, int H, int KV, int Sq, int Skv, int causal, int window, int q_offset,
               float scale) {
  using C = Cfg<D>;
  constexpr int BS = C::BS, LD = C::LD, NS = C::NS, DT = C::DT;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;           // BR x LD
  float* vs = ks + C::RES;    // BR x LD
  float* ring = vs + C::RES;  // STAGES x KV_STAGE
  float* xs = ring + STAGES * C::KV_STAGE;  // SLABS x (P, dP) exchange tiles (SPLIT = 2)

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // the warp's slab of 16 keys, its half of the slab (SPLIT = 2) and its
  // first column of dK and dV
  const int slab = warp / C::SPLIT, half = warp % C::SPLIT, col0 = half * (D / C::SPLIT);
  const int g = lane >> 2, t = lane & 3;  // the mma fragment's row group and column pair
  const int bkv = blockIdx.x, G = H / KV;
  const int part = blockIdx.y % split;  // the block's slice of its key tile's walk
  const int n0 = (blockIdx.y / split) * BR;  // the block's first key
  const size_t bh0 = (size_t)bkv * G;  // the group's first q head: b H + kv_head G
  // Query rows that see any key of the tile: at or past its first key
  // (causal), before its last key's window ends.
  const int n_last = min(n0 + BR, Skv) - 1;
  const int m_lo = causal ? max(0, n0 - q_offset) : 0;
  const int m_hi = window > 0 ? min(Sq, n_last + window - q_offset) : Sq;
  const int t_lo = m_lo / BS, t_hi = m_hi > m_lo ? (m_hi + BS - 1) / BS : t_lo;
  const int per_head = t_hi - t_lo, n_iter = G * per_head;
  // the slice: steps [it0, it1) of the walk (all of it when split = 1)
  const int it0 = slice_start(part, n_iter, split), it1 = slice_start(part + 1, n_iter, split);

  load_rows<D, BR>(ks, k + (size_t)bkv * Skv * D, n0, Skv, tid);
  load_rows<D, BR>(vs, v + (size_t)bkv * Skv * D, n0, Skv, tid);
  cp_async_commit();
  if (it0 < it1)
    load_query_stage<D>(ring + (it0 % STAGES) * C::KV_STAGE, q, dout, lse, delta,
                        bh0 + it0 / per_head, (t_lo + it0 % per_head) * BS, Sq, tid);

  const int kw0 = n0 + 16 * slab;  // the warp's first key
  const float* kw = ks + 16 * slab * LD;  // the warp's rows of K and V
  const float* vw = vs + 16 * slab * LD;
  float dka[DT][4], dva[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  for (int it = it0; it < it1; ++it) {
    cp_async_wait_all();
    __syncthreads();  // stage it landed; every warp is done with the stage the next copy overwrites
    if (it + 1 < it1)
      load_query_stage<D>(ring + ((it + 1) % STAGES) * C::KV_STAGE, q, dout, lse, delta,
                          bh0 + (it + 1) / per_head, (t_lo + (it + 1) % per_head) * BS, Sq, tid);
    const int m0 = (t_lo + it % per_head) * BS, qpos0 = q_offset + m0;
    // A warp whose keys no query of the tile sees has nothing to add.
    if (kw0 >= Skv || (causal && qpos0 + BS - 1 < kw0) ||
        (window > 0 && qpos0 - (kw0 + 15) >= window))
      continue;
    const float* qs = ring + (it % STAGES) * C::KV_STAGE;
    const float* dos = qs + C::TILE;
    const float* stat = dos + C::TILE;  // the rows' lse, then their Δ

    float st[NS][4], dpt[NS][4];  // Sᵀ, then Pᵀ; dPᵀ, then dSᵀ: rows keys, columns queries
    // Element e of column tile j: key kw0 + g + 8(e >> 1), query m0 + 8j + 2t + (e & 1).
    const bool need_mask = m0 + BS > Sq || (causal && qpos0 < kw0 + 15) ||
                           (window > 0 && qpos0 + BS - 1 - kw0 >= window);
    if constexpr (C::SPLIT == 1) {
      scores<D, NS>(st, kw, qs);
      scores<D, NS>(dpt, vw, dos);
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const float2 l = *reinterpret_cast<const float2*>(stat + 8 * j + 2 * t);
        const float2 d = *reinterpret_cast<const float2*>(stat + BS + 8 * j + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * j + 2 * t + (e & 1);
          float p = expf(fmaf(st[j][e], scale, -((e & 1) ? l.y : l.x)));
          if (need_mask && !(m0 + col < Sq &&
                             visible(qpos0 + col, kw0 + g + 8 * (e >> 1), causal, window)))
            p = 0.f;
          dpt[j][e] = p * (dpt[j][e] - ((e & 1) ? d.y : d.x));
          st[j][e] = p;
        }
      }
    } else {
      // The slab's first warp computes Sᵀ and Pᵀ, its second dPᵀ; they swap
      // them through shared memory and each forms dSᵀ, the same bits in both.
      float* xw = xs + slab * 2 * C::XT;  // the slab's Pᵀ, then its dPᵀ
      if (half == 0) {
        scores<D, NS>(st, kw, qs);
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = 8 * j + 2 * t + (e & 1);
            float p = expf(fmaf(st[j][e], scale, -stat[col]));
            if (need_mask && !(m0 + col < Sq &&
                               visible(qpos0 + col, kw0 + g + 8 * (e >> 1), causal, window)))
              p = 0.f;
            st[j][e] = p;
          }
        put_tile<NS>(xw, st, lane);
      } else {
        scores<D, NS>(dpt, vw, dos);
        put_tile<NS>(xw + C::XT, dpt, lane);
      }
      pair_sync(slab);
      if (half == 0)
        get_tile<NS>(dpt, xw + C::XT, lane);
      else
        get_tile<NS>(st, xw, lane);
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dpt[j][e] = st[j][e] * (dpt[j][e] - stat[BS + 8 * j + 2 * t + (e & 1)]);
    }
    uint32_t ph[NS][4], pl[NS][4], dh[NS][4], dl[NS][4];
    to_a<NS>(st, ph, pl);
    to_a<NS>(dpt, dh, dl);
    accumulate<D, NS>(dva, ph, pl, dos + 2 * t * LD + col0 + g);  // dV += Pᵀ dO
    accumulate<D, NS>(dka, dh, dl, qs + 2 * t * LD + col0 + g);   // dK += dSᵀ Q
  }
  cp_async_wait_all();

  // P = 1: the sums, dK's scaled, into dK and dV; P > 1: this slice's
  // unscaled sums into its parts, which flash_bwd_reduce adds. (One store
  // for both: two spilled a register at D = 256.)
  const size_t n = (size_t)gridDim.x * Skv * D, at = (size_t)bkv * Skv * D;
  float* out_k = split == 1 ? dk + at : parts + (size_t)part * n + at;
  float* out_v = split == 1 ? dv + at : out_k + (size_t)split * n;
  store_rows<D>(out_k, dka, kw0 + g, Skv, col0, t, split == 1 ? scale : 1.f);
  store_rows<D>(out_v, dva, kw0 + g, Skv, col0, t, 1.f);
}

// dK = scale·(part 0 + part 1 + ...), dV = part 0 + part 1 + ..., the parts
// of `parts` ((2, split, n) fp32: dK's, then dV's) added in slice order with
// round-to-nearest adds, 4 elements a thread; n4 = n / 4.
__global__ void __launch_bounds__(REDUCE_THREADS)
flash_bwd_reduce(const float* __restrict__ parts, float* __restrict__ dk, float* __restrict__ dv,
                 long long n4, int split, float scale) {
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
  reinterpret_cast<float4*>(is_v ? dv : dk)[j] =
      make_float4(acc.x * mul, acc.y * mul, acc.z * mul, acc.w * mul);
}

// Stage of the dQ ring: keys [k0, k0 + BS) of K and V (zeros past Skv).
// Committed.
template <int D>
__device__ __forceinline__ void load_key_stage(float* st, const float* __restrict__ kp,
                                               const float* __restrict__ vp, int k0, int Skv,
                                               int tid) {
  load_rows<D, Cfg<D>::BS>(st, kp, k0, Skv, tid);
  load_rows<D, Cfg<D>::BS>(st + Cfg<D>::TILE, vp, k0, Skv, tid);
  cp_async_commit();
}

template <int D>
__global__ void __launch_bounds__(Cfg<D>::THREADS, Cfg<D>::MIN_BLOCKS)
flash_bwd_dq(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             float* __restrict__ dq, int H, int KV, int Sq, int Skv, int causal, int window,
             int q_offset, float scale) {
  using C = Cfg<D>;
  constexpr int BS = C::BS, LD = C::LD, NS = C::NS, DT = C::DT;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;            // BR x LD
  float* dos = qs + C::RES;    // BR x LD
  float* ring = dos + C::RES;  // STAGES x (K, V: BS x LD each)
  float* xs = ring + STAGES * 2 * C::TILE;  // SLABS x (P, dP) exchange tiles (SPLIT = 2)

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // the warp's slab of 16 query rows, its half of the slab (SPLIT = 2) and
  // its first column of dQ
  const int slab = warp / C::SPLIT, half = warp % C::SPLIT, col0 = half * (D / C::SPLIT);
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const size_t bkv = (size_t)b * KV + h / (H / KV);
  const int m0 = (gridDim.y - 1 - blockIdx.y) * BR;  // heaviest query tiles first
  // Keys that any row of the tile sees: up to the last row's diagonal
  // (causal), from the first row's window start.
  const int qpos_first = q_offset + m0, qpos_last = q_offset + min(m0 + BR, Sq) - 1;
  const int n_hi = causal ? min(Skv, qpos_last + 1) : Skv;
  const int n_lo = window > 0 ? max(0, qpos_first - window + 1) : 0;
  const int t_lo = n_lo / BS, t_hi = n_hi > n_lo ? (n_hi + BS - 1) / BS : t_lo;
  const float* kp = k + bkv * Skv * D;
  const float* vp = v + bkv * Skv * D;

  load_rows<D, BR>(qs, q + (size_t)bh * Sq * D, m0, Sq, tid);
  load_rows<D, BR>(dos, dout + (size_t)bh * Sq * D, m0, Sq, tid);
  cp_async_commit();
  if (t_lo < t_hi) load_key_stage<D>(ring, kp, vp, t_lo * BS, Skv, tid);

  const int row0 = m0 + 16 * slab + g;  // this thread's rows: row0 and row0 + 8
  const int wq0 = q_offset + m0 + 16 * slab;  // absolute position of the warp's row 0
  float ls[2], dl[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = row0 + 8 * hh;
    ls[hh] = r < Sq ? lse[(size_t)bh * Sq + r] : __int_as_float(0x7f800000);  // P = 0 past Sq
    dl[hh] = r < Sq ? delta[(size_t)bh * Sq + r] : 0.f;
  }
  const float* qw = qs + 16 * slab * LD;  // the warp's rows of Q and dO
  const float* dw = dos + 16 * slab * LD;
  float dqa[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[n][e] = 0.f;

  for (int tile = t_lo; tile < t_hi; ++tile) {
    cp_async_wait_all();
    __syncthreads();  // stage landed; every warp is done with the stage the next copy overwrites
    if (tile + 1 < t_hi)
      load_key_stage<D>(ring + ((tile + 1 - t_lo) % STAGES) * 2 * C::TILE, kp, vp,
                        (tile + 1) * BS, Skv, tid);
    const int k0 = tile * BS;
    // A warp whose rows see no key of the tile, or lie past Sq, has nothing to add.
    if (row0 - g >= Sq || (causal && k0 > wq0 + 15) || (window > 0 && k0 + BS - 1 <= wq0 - window))
      continue;
    const float* kst = ring + ((tile - t_lo) % STAGES) * 2 * C::TILE;
    const float* vst = kst + C::TILE;

    float s[NS][4], dp[NS][4];  // S, then P; dP, then dS: rows queries, columns keys
    // Element e of column tile j: query row0 + 8(e >> 1), key k0 + 8j + 2t + (e & 1).
    const bool need_mask = k0 + BS > Skv || (causal && k0 + BS - 1 > wq0) ||
                           (window > 0 && k0 <= wq0 + 15 - window);
    if constexpr (C::SPLIT == 1) {
      scores<D, NS>(s, qw, kst);
      scores<D, NS>(dp, dw, vst);
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = k0 + 8 * j + 2 * t + (e & 1);
          float p = expf(fmaf(s[j][e], scale, -ls[e >> 1]));
          if (need_mask &&
              !(kpos < Skv && visible(wq0 + g + 8 * (e >> 1), kpos, causal, window)))
            p = 0.f;
          dp[j][e] = p * (dp[j][e] - dl[e >> 1]);
        }
    } else {
      // The slab's first warp computes S and P, its second dP; they swap
      // them through shared memory and each forms dS, the same bits in both.
      float* xw = xs + slab * 2 * C::XT;  // the slab's P, then its dP
      if (half == 0) {
        scores<D, NS>(s, qw, kst);
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kpos = k0 + 8 * j + 2 * t + (e & 1);
            float p = expf(fmaf(s[j][e], scale, -ls[e >> 1]));
            if (need_mask &&
                !(kpos < Skv && visible(wq0 + g + 8 * (e >> 1), kpos, causal, window)))
              p = 0.f;
            s[j][e] = p;
          }
        put_tile<NS>(xw, s, lane);
      } else {
        scores<D, NS>(dp, dw, vst);
        put_tile<NS>(xw + C::XT, dp, lane);
      }
      pair_sync(slab);
      if (half == 0)
        get_tile<NS>(dp, xw + C::XT, lane);
      else
        get_tile<NS>(s, xw, lane);
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) dp[j][e] = s[j][e] * (dp[j][e] - dl[e >> 1]);
    }
    uint32_t dh[NS][4], dlo[NS][4];
    to_a<NS>(dp, dh, dlo);
    accumulate<D, NS>(dqa, dh, dlo, kst + 2 * t * LD + col0 + g);  // dQ += dS K
  }
  cp_async_wait_all();

  store_rows<D>(dq + (size_t)bh * Sq * D, dqa, row0, Sq, col0, t, scale);
}

// ---- host side -------------------------------------------------------------

template <int D>
cudaError_t launch(const float* q, const float* k, const float* v, const float* o,
                   const float* dout, const float* lse, float* delta, float* dq, float* dk,
                   float* dv, float* parts, int split, int B, int H, int KV, int Sq, int Skv,
                   int causal, int window, int q_offset, float scale, cudaStream_t stream) {
  using C = Cfg<D>;
  const long long rows = (long long)B * H * Sq;
  constexpr int TPR = D / 4 < 32 ? D / 4 : 32;  // flash_bwd_delta's threads a row
  const long long delta_blocks = (rows * TPR + DELTA_THREADS - 1) / DELTA_THREADS;
  const int q_tiles = (Sq + BR - 1) / BR, k_tiles = (Skv + BR - 1) / BR;
  const long long n4 = (long long)B * KV * Skv * D / 4;  // float4s of dK
  const long long reduce_blocks = (2 * n4 + REDUCE_THREADS - 1) / REDUCE_THREADS;
  if (delta_blocks > 0x7fffffffLL || reduce_blocks > 0x7fffffffLL || q_tiles > 65535 ||
      (long long)k_tiles * split > 65535)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkdv<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)C::SMEM_KV);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dq<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)C::SMEM_Q);
  if (err != cudaSuccess) return err;
  flash_bwd_delta<D><<<(unsigned)delta_blocks, DELTA_THREADS, 0, stream>>>(o, dout, delta, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // key tile on the slowest axis, then its slices, tile 0 first: under a
  // causal mask the heaviest blocks start first and the light ones fill the
  // last wave
  flash_bwd_dkdv<D><<<dim3(B * KV, k_tiles * split), C::THREADS, C::SMEM_KV, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, parts, split, H, KV, Sq, Skv, causal, window,
      q_offset, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (split > 1) {  // right after the parts are written, while L2 holds them
    flash_bwd_reduce<<<(unsigned)reduce_blocks, REDUCE_THREADS, 0, stream>>>(parts, dk, dv, n4,
                                                                            split, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  flash_bwd_dq<D><<<dim3(B * H, q_tiles), C::THREADS, C::SMEM_Q, stream>>>(
      q, k, v, dout, lse, delta, dq, H, KV, Sq, Skv, causal, window, q_offset, scale);
  return cudaGetLastError();
}

template <int D>
constexpr int smem_bytes() {
  return (int)(Cfg<D>::SMEM_KV > Cfg<D>::SMEM_Q ? Cfg<D>::SMEM_KV : Cfg<D>::SMEM_Q);
}

// dK/dV blocks the current device holds at once: its SMs times the blocks a
// SM the kernel's registers and shared memory allow.
template <int D>
int dkdv_slots() {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaFuncSetAttribute(flash_bwd_dkdv<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)Cfg<D>::SMEM_KV) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, flash_bwd_dkdv<D>, Cfg<D>::THREADS,
                                                    Cfg<D>::SMEM_KV) != cudaSuccess)
    return -1;
  return sms * per_sm;
}

}  // namespace

// The dK/dV kernel's slots on the current device at head dim D: SMs x blocks
// a SM (-1 if D is not supported or a query fails).
extern "C" int flash_attention_bwd_slots(int D) {
  switch (D) {
    case 16: return dkdv_slots<16>();
    case 32: return dkdv_slots<32>();
    case 64: return dkdv_slots<64>();
    case 128: return dkdv_slots<128>();
    case 256: return dkdv_slots<256>();
    default: return -1;
  }
}

// Dynamic shared memory of the larger of the two tile kernels' blocks at
// head dim D, in bytes (-1 if D is not supported).
extern "C" int flash_attention_bwd_smem_bytes(int D) {
  switch (D) {
    case 16: return smem_bytes<16>();
    case 32: return smem_bytes<32>();
    case 64: return smem_bytes<64>();
    case 128: return smem_bytes<128>();
    case 256: return smem_bytes<256>();
    default: return -1;
  }
}

// q, o, do, dq (B, H, Sq, D); k, v, dk, dv (B, KV, Skv, D): fp32,
// contiguous, 16-byte aligned (the cp.async copies and the Δ pass read 16
// bytes at a time; cudaErrorMisalignedAddress otherwise, with no launch).
// lse and the scratch delta: (B, H, Sq) fp32. split: the slices of each key
// tile's dK/dV walk (>= 1); with split > 1, parts is the workspace (2, split,
// B, KV, Skv, D) fp32, 16-byte aligned (unused at split = 1). Three launches
// on `stream` (four with split > 1); returns cudaGetLastError() after the
// last (0 on success).
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                   const void* dout, const void* lse, void* delta, void* dq,
                                   void* dk, void* dv, int B, int H, int KV, int Sq, int Skv,
                                   int D, int causal, int window, int q_offset, float scale,
                                   int split, void* parts, void* stream) {
  if (B <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || Sq <= 0 || Skv <= 0 || q_offset < 0 ||
      window < 0 || (long long)B * H > 0x7fffffffLL || split < 1 ||
      (split > 1 && parts == nullptr))
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o) |
       reinterpret_cast<uintptr_t>(dout) | reinterpret_cast<uintptr_t>(dq) |
       reinterpret_cast<uintptr_t>(dk) | reinterpret_cast<uintptr_t>(dv) |
       reinterpret_cast<uintptr_t>(parts)) % 16)
    return (int)cudaErrorMisalignedAddress;
  const float *qf = static_cast<const float*>(q), *kf = static_cast<const float*>(k),
              *vf = static_cast<const float*>(v), *of = static_cast<const float*>(o),
              *df = static_cast<const float*>(dout), *lf = static_cast<const float*>(lse);
  float *dl = static_cast<float*>(delta), *dqf = static_cast<float*>(dq),
        *dkf = static_cast<float*>(dk), *dvf = static_cast<float*>(dv),
        *pf = static_cast<float*>(parts);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return (int)launch<16>(qf, kf, vf, of, df, lf, dl, dqf, dkf, dvf, pf, split, B, H, KV, Sq, Skv, causal, window, q_offset, scale, s);
    case 32: return (int)launch<32>(qf, kf, vf, of, df, lf, dl, dqf, dkf, dvf, pf, split, B, H, KV, Sq, Skv, causal, window, q_offset, scale, s);
    case 64: return (int)launch<64>(qf, kf, vf, of, df, lf, dl, dqf, dkf, dvf, pf, split, B, H, KV, Sq, Skv, causal, window, q_offset, scale, s);
    case 128: return (int)launch<128>(qf, kf, vf, of, df, lf, dl, dqf, dkf, dvf, pf, split, B, H, KV, Sq, Skv, causal, window, q_offset, scale, s);
    case 256: return (int)launch<256>(qf, kf, vf, of, df, lf, dl, dqf, dkf, dvf, pf, split, B, H, KV, Sq, Skv, causal, window, q_offset, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
