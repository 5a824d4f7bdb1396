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
// (flash_attention_bwd_sm90.cu) recomputes P from it. Serving passes
// nullptr and gets what it got before lse existed, bit for bit.
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

#include "sm90.cuh"  // mbarriers, TMA, wgmma, the tensor-map encoder

namespace {

constexpr int STAGES = 2;        // K/V ring depth (a third was no faster on an H100)
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
  static constexpr int KV_BYTES = BK * D * 2;     // K or V, one stage
  static constexpr int BARRIERS = 1 + 3 * STAGES; // q full; K full, V full, empty per stage
  // 1024 bytes of slack to align the tiles to the 128-byte swizzle's period.
  static constexpr int SMEM = 1024 + Q_BYTES + 2 * STAGES * KV_BYTES + 8 * BARRIERS;
  // wgmma descriptor layout type and the TMA swizzle of a panel (sm90.cuh).
  static constexpr uint64_t LAYOUT = desc_layout(SPAN);
  static constexpr CUtensorMapSwizzle SWIZZLE = tma_swizzle(SPAN);
};

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

// A map over a contiguous (BH, S, D) bf16 tensor, boxes of rows x PW.
template <int D>
bool make_map(CUtensorMap* map, const void* ptr, int S, int BH, int rows) {
  return make_map_bf16(map, ptr, D, S, BH, Cfg<D>::PW, rows, Cfg<D>::SWIZZLE);
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
  static unsigned long long smem_set = 0;  // bit d: the limit is set on device d
  const cudaError_t err = allow_smem(flash_fwd_sm90_kernel<D>, C::SMEM, smem_set);
  if (err != cudaSuccess) return err;
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
