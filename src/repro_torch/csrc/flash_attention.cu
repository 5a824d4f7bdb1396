// Flash-attention forward in fp32 for Hopper (sm_90a): split-TF32 products
// on the tensor cores (mma.sync), fed by a cp.async pipeline. Written by hand.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:_flash_kernel
// (reached through flash_attention_tpu) for fp32 inputs; bf16 inputs take the
// wgmma kernel in flash_attention_sm90.cu. Same function: GQA attention over
// q (B, H, Sq, D) and k/v (B, KV, Skv, D), H % KV == 0, with causal,
// local-window (q_pos - k_pos < window) or bidirectional masks, an absolute
// q_offset, any Sq and Skv, head_dim 16, 32, 64, 128 or 256. q is scaled by
// d^-0.5 in fp32 before anything else; scores, running max, normalizer and
// the P.V accumulator are fp32; masked scores are -1e30 (not -inf: a tile
// whose entries are all masked must not give inf - inf), keys past Skv get
// probability exactly 0; the output is acc / max(l, 1e-30). The kv walk runs
// over the tiles [lo, hi): hi stops at the causal diagonal, lo starts at
// q_start - window. No atomics and no split over keys: two launches on the
// same inputs give the same bits. For training the wrapper passes an fp32
// lse (B, H, Sq), and the quad leader of each row writes m + log(l), the
// row's logsumexp in natural-log units, in the epilogue: the backward
// (flash_attention_bwd.cu) recomputes P from it. Serving passes nullptr and
// gets what it got before lse existed, bit for bit.
//
// What bounds it on this card. The least times (bytes of q, k, v, o once
// over 3.35 TB/s; FLOP from 4.D per unmasked (query, key) pair):
//   smollm-360m     B8 H15 KV5 S512 D64  causal       4.03 GFLOP, 41.94 MB
//   recurrentgemma  B8 H10 KV1 S512 D256 window 2048  10.76 GFLOP, 92.27 MB
// On the fp32 CUDA cores (67 TFLOP/s) the operations bound them: 0.0602 and
// 0.1606 ms. The bytes take 0.0125 and 0.0275 ms. This kernel does the same
// fp32-accurate work as three TF32 products on the tensor cores (495 TFLOP/s
// dense), 3 x 4.03 and 3 x 10.76 GFLOP: 0.0244 and 0.0652 ms, its bound.
//
// The split and its error. One TF32 product keeps 11 significant bits of each
// operand, about 1e-3 of error at these shapes, 50 times fp32's tolerance of
// 2e-5. So each operand x is split into hi = tf32(x), rounded to nearest with
// ties away from zero as cvt.rna.tf32.f32 rounds, and lo = x - hi, which is
// exact in fp32 and at most 2^-11 |x|. The product is lo.hi' + hi.lo' +
// hi.hi' with fp32 accumulation; each tf32 x tf32 product is exact in fp32
// (22 bits). What is dropped, lo.lo' and the bits of lo below the 11 the
// tensor cores read, is about 2^-21 of |x.y|, under the rounding of the fp32
// sums themselves. Every operand is split: q (scaled first), K, the fp32
// probabilities P (never rounded to bf16, unlike the bf16 route) and V. A
// CPU model of this arithmetic (tests/test_torch_kernels.py) stays within
// 4e-6 of the fp32 reference; chip_smoke.py holds the kernel to 2e-5 on the
// card, where the tensor cores' accumulation order and rounding decide.
// Three choices keep the card's error near the model's: the small terms
// and hi.hi' go into separate accumulators in Q.K^T (the tensor cores round
// each accumulation toward zero, and at D = 256 one accumulator takes 96 of
// them per score); small terms are added first; P.V's accumulator takes
// lo.hi', hi.lo', hi.hi' in that order.
//
// The instruction: mma.sync.aligned.m16n8k8 .tf32, not wgmma. A wgmma with
// tf32 operands takes A and B K-major only (the transpose bits exist for
// 16-bit types), so V (keys x D, D contiguous: MN-major for P.V) would need a
// transpose in shared memory, and hi and lo tiles of every operand in shared
// memory: at D = 256 a 64-key K tile's hi and lo take 128 KB of the 227 KB.
// mma.sync loads each thread's fragment elements itself, so the layout is
// free and the split happens in registers: shared memory holds one raw fp32
// copy of each tile, and V is read MN-major by plain loads.
//
// What the split costs, and what the design does about it. The in-register
// split is an integer add and a mask for hi and a subtraction for lo, three
// instructions per fragment element; the compiled cvt.rna.tf32.f32 adds a
// test and a select for inf and NaN (which these finite operands never
// are), and rounding lo as well cost more time than it bought accuracy, so
// lo goes to the tensor cores as it is (they read its leading 11 bits). Each
// element of a K or V fragment feeds three products of one 16-row tile, so
// loads and splits, not the tensor cores, set the pace (PERF.md):
//   * a warp owns 16 query rows (the m16 of the mma) of one (batch, q head);
//     a block has 4 warps (64 rows) up to D = 64 and 8 warps (128 rows)
//     above, and all of them share each 32-key K and V tile in shared
//     memory. The O accumulator is 16 x D, 128 registers a thread at
//     D = 256, so every K or V fragment feeds one 16-row tile only;
//   * Q.K^T's k index takes head dims in pairs: in k-step kk the fragment's
//     k columns t and t + 4 are dims 8kk + 2t and 8kk + 2t + 1, for Q and K
//     alike, so each thread loads both as one float2; Q and K rows are padded
//     to D + 8 floats and V rows to D + 4, so every fragment load of a warp
//     hits distinct banks, and each row stays on 16 bytes for cp.async;
//   * the S accumulator becomes P.V's A operand in registers with no
//     shuffle: within each 8-key step the thread's columns 2t and 2t + 1 are
//     taken as the k indices t and t + 4, and V's rows are read in the same
//     order;
//   * products are issued by kind across independent accumulators (never
//     two in a row into one accumulator), and the inline mma is not volatile,
//     so the compiler interleaves them with the next loads and splits;
//   * K and V come through a two-slot cp.async pipeline (16 bytes a thread,
//     L2 only), one slot for a K tile and one for a V tile: V of tile t is in
//     flight while the warps compute S of tile t, and K of tile t + 1 while
//     they compute P.V of tile t; each __syncthreads both publishes the copy
//     that landed and frees the slot the next copy overwrites. Against a
//     2-stage ring of K and V together this halves the tile memory, which at
//     D = 256 (Q alone takes 135 KB of the 227) is what lets a tile be 32
//     keys and not 16, so each Q fragment's split feeds twice the products:
//     202 KB a block at D = 256, 36 KB at D = 64. Rows past Skv are
//     zero-filled (a zero V row times a probability of 0 is 0; garbage
//     could be NaN);
//   * row max by quad shuffles of the accumulator layout; each thread keeps
//     a partial normalizer for its columns, summed across the quad at the
//     end; expf throughout (not __expf); the accumulator is rescaled only
//     when a row max moved;
//   * a warp visits only the tiles its rows keep anything in (causal
//     diagonal, window edge, rows past Sq) and masks only the tiles that
//     straddle an edge; blocks run the heaviest query tiles first (the
//     query-tile index is the slowest grid dimension, reversed).
// GQA: the block for q head h reads kv head h / (H / KV); K/V are never
// duplicated in memory (the group's blocks share them through L2). The
// kernel allocates nothing and launches on the caller's stream.

#include "tf32.cuh"  // the TF32 split, mma.sync and cp.async helpers

namespace {

constexpr float NEG_INF = -1e30f;

template <int D>
struct Cfg {
  static constexpr int WARPS = D >= 128 ? 8 : 4;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int BQ = 16 * WARPS;          // query rows a block
  static constexpr int BK = 32;                  // keys a tile
  static constexpr int LDK = D + 8;              // row stride of Q and K tiles, floats
  static constexpr int LDV = D + 4;              // row stride of V tiles
  static constexpr int MIN_BLOCKS = D >= 128 ? 1 : 4;
  static constexpr int G = D / 8 < 8 ? D / 8 : 8;  // O tiles whose V fragments are held at once
  // Q, then one K tile and one V tile
  static constexpr size_t SMEM = ((size_t)BQ * LDK + (size_t)BK * (LDK + LDV)) * sizeof(float);
};

// Rows [k0, k0 + BK) of src (K or V) into a tile of row stride LD; rows past
// Skv become zeros.
template <int D, int LD>
__device__ __forceinline__ void load_tile(float* dst, const float* src, int k0, int Skv, int tid) {
  using C = Cfg<D>;
  constexpr int CPR = D / 4;  // 16-byte chunks a row
  for (int c = tid; c < C::BK * CPR; c += C::THREADS) {
    const int r = c / CPR, col = (c % CPR) * 4;
    const bool in = k0 + r < Skv;
    cp_async16(dst + r * LD + col, src + (in ? (size_t)(k0 + r) * D + col : 0), in ? 16 : 0);
  }
  cp_async_commit();
}

template <int D>
__global__ void __launch_bounds__(Cfg<D>::THREADS, Cfg<D>::MIN_BLOCKS)
flash_fwd_tf32x3(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
                 int H, int KV, int Sq, int Skv, int causal, int window, int q_offset,
                 float scale) {
  using C = Cfg<D>;
  constexpr int BQ = C::BQ, BK = C::BK, LDK = C::LDK, LDV = C::LDV, THREADS = C::THREADS;
  constexpr int NT = BK / 8;  // 8-key column tiles of S (and k-steps of P.V)
  constexpr int DT = D / 8;   // 8-column tiles of O (and k-steps of Q.K^T)
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;            // BQ x LDK
  float* ks = qs + BQ * LDK;   // BK x LDK
  float* vs = ks + BK * LDK;   // BK x LDV

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // the mma fragment's row group and column pair
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;  // heaviest query tiles first
  const int kvh = h / (H / KV);
  const float* qp = q + (size_t)(b * H + h) * Sq * D;
  const float* kp = k + (size_t)(b * KV + kvh) * Skv * D;
  const float* vp = v + (size_t)(b * KV + kvh) * Skv * D;
  float* op = o + (size_t)(b * H + h) * Sq * D;

  const int q_start = q_offset + q0;  // absolute position of the block's row 0
  int hi = (Skv + BK - 1) / BK;
  if (causal) hi = min(hi, (q_start + BQ - 1) / BK + 1);
  int lo = 0;
  if (window > 0 && q_start - window > 0) lo = (q_start - window) / BK;

  if (lo < hi) load_tile<D, LDK>(ks, kp, lo * BK, Skv, tid);

  // This block's q rows in fp32, scaled; rows past Sq are 0.
  for (int c = tid; c < BQ * (D / 4); c += THREADS) {
    const int r = c / (D / 4), col = (c % (D / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < Sq) {
      x = *reinterpret_cast<const float4*>(qp + (size_t)(q0 + r) * D + col);
      x.x *= scale;
      x.y *= scale;
      x.z *= scale;
      x.w *= scale;
    }
    *reinterpret_cast<float4*>(qs + r * LDK + col) = x;
  }

  const bool live = q0 + warp * 16 < Sq;  // the warp has a row to store
  const int wq0 = q_start + warp * 16;    // absolute position of the warp's row 0
  const int row0 = wq0 + g, row1 = row0 + 8;
  // Q.K^T's k index runs over head dims in an order of the kernel's own: in
  // k-step kk the fragment columns t and t + 4 are dims 8kk + 2t and
  // 8kk + 2t + 1 for both Q and K, so each thread reads them as one float2.
  const float* qw = qs + (warp * 16 + g) * LDK + 2 * t;

  float acc[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;

  for (int tile = lo; tile < hi; ++tile) {
    const int k0 = tile * BK;
    cp_async_wait_all();
    __syncthreads();  // K published; every warp is done with V of the tile before
    load_tile<D, LDV>(vs, vp, k0, Skv, tid);  // lands while the warps compute S
    // Tiles in which every (row, key) of this warp is masked change nothing.
    const bool active = live && !(causal && k0 > wq0 + 15) &&
                        !(window > 0 && k0 + BK - 1 <= wq0 - window);
    float s[NT][4];  // S, then P
    if (active) {
      // S = Q K^T, 16 x BK: the small terms lo.hi' + hi.lo' and the large
      // hi.hi' in two accumulators, added once at the end (the tensor cores
      // round each accumulation toward zero, so the large sum takes D/8 of
      // them, not 3D/8). In each k-step the products of the NT column tiles
      // are issued by kind, so no two in a row share an accumulator.
      float big[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = big[n][e] = 0.f;
      const float* kw = ks + g * LDK + 2 * t;
#pragma unroll
      for (int kk = 0; kk < DT; ++kk) {
        uint32_t ah[4], al[4], bh[NT][2], bl[NT][2];
        const float2 qa = *reinterpret_cast<const float2*>(qw + 8 * kk);
        const float2 qb = *reinterpret_cast<const float2*>(qw + 8 * LDK + 8 * kk);
        split(qa.x, ah[0], al[0]);
        split(qb.x, ah[1], al[1]);
        split(qa.y, ah[2], al[2]);
        split(qb.y, ah[3], al[3]);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const float2 kv = *reinterpret_cast<const float2*>(kw + 8 * n * LDK + 8 * kk);
          split(kv.x, bh[n][0], bl[n][0]);
          split(kv.y, bh[n][1], bl[n][1]);
        }
#pragma unroll
        for (int n = 0; n < NT; ++n) mma(s[n], al, bh[n]);
#pragma unroll
        for (int n = 0; n < NT; ++n) mma(big[n], ah, bh[n]);
#pragma unroll
        for (int n = 0; n < NT; ++n) mma(s[n], ah, bl[n]);
      }
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] += big[n][e];

      // Masks, only on tiles that straddle an edge. The accumulator holds
      // rows row0 (s[n][0..1]) and row1 (s[n][2..3]), keys k0 + 8n + 2t + {0, 1}.
      const bool ragged = k0 + BK > Skv;
      if (ragged || (causal && k0 + BK - 1 > wq0) || (window > 0 && k0 <= wq0 + 15 - window)) {
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kpos = k0 + 8 * n + 2 * t + (e & 1);
            const int qpos = e < 2 ? row0 : row1;
            bool ok = kpos < Skv;
            if (causal) ok = ok && qpos >= kpos;
            if (window > 0) ok = ok && (qpos - kpos) < window;
            if (!ok) s[n][e] = NEG_INF;
          }
      }

      // Online softmax: the row max across the quad, then P in place of S.
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
        mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float alpha0 = expf(m0 - mx0), alpha1 = expf(m1 - mx1);
      m0 = mx0;
      m1 = mx1;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = expf(s[n][e] - (e < 2 ? m0 : m1));
          // Keys past Skv do not exist: probability exactly 0.
          if (ragged && k0 + 8 * n + 2 * t + (e & 1) >= Skv) p = 0.f;
          s[n][e] = p;
          if (e < 2) sum0 += p; else sum1 += p;
        }
      l0 = l0 * alpha0 + sum0;
      l1 = l1 * alpha1 + sum1;
      if (__any_sync(0xffffffffu, alpha0 != 1.f || alpha1 != 1.f)) {  // a row max moved
#pragma unroll
        for (int n = 0; n < DT; ++n) {
          acc[n][0] *= alpha0;
          acc[n][1] *= alpha0;
          acc[n][2] *= alpha1;
          acc[n][3] *= alpha1;
        }
      }
    }
    cp_async_wait_all();
    __syncthreads();  // V published; every warp is done with K
    if (tile + 1 < hi) load_tile<D, LDK>(ks, kp, k0 + BK, Skv, tid);  // lands during P.V
    if (!active) continue;

    // acc += P V, 16 x D, each acc[n] taking lo.hi', hi.lo', hi.hi' in that
    // order, issued by kind over G column tiles at a time. In k-step j the
    // thread's S columns 8j + 2t and 8j + 2t + 1 are the A fragment's k
    // indices t and t + 4, so its B fragment reads V rows 8j + 2t and
    // 8j + 2t + 1.
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      uint32_t ah[4], al[4];
      split(s[j][0], ah[0], al[0]);
      split(s[j][2], ah[1], al[1]);
      split(s[j][1], ah[2], al[2]);
      split(s[j][3], ah[3], al[3]);
      const float* vr = vs + (8 * j + 2 * t) * LDV + g;
#pragma unroll
      for (int n0 = 0; n0 < DT; n0 += C::G) {
        uint32_t bh[C::G][2], bl[C::G][2];
#pragma unroll
        for (int n = 0; n < C::G; ++n) {
          split(vr[8 * (n0 + n)], bh[n][0], bl[n][0]);
          split(vr[LDV + 8 * (n0 + n)], bh[n][1], bl[n][1]);
        }
#pragma unroll
        for (int n = 0; n < C::G; ++n) mma(acc[n0 + n], al, bh[n]);
#pragma unroll
        for (int n = 0; n < C::G; ++n) mma(acc[n0 + n], ah, bl[n]);
#pragma unroll
        for (int n = 0; n < C::G; ++n) mma(acc[n0 + n], ah, bh[n]);
      }
    }
  }
  cp_async_wait_all();

  if (!live) return;
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  if (lse != nullptr && t == 0) {  // the row's logsumexp, natural log, for the backward
    float* lp = lse + (size_t)(b * H + h) * Sq;
    if (r0 < Sq) lp[r0] = m0 + logf(l0);
    if (r1 < Sq) lp[r1] = m1 + logf(l1);
  }
#pragma unroll
  for (int n = 0; n < DT; ++n) {
    const int col = 8 * n + 2 * t;
    if (r0 < Sq)
      *reinterpret_cast<float2*>(op + (size_t)r0 * D + col) = make_float2(acc[n][0] / d0, acc[n][1] / d0);
    if (r1 < Sq)
      *reinterpret_cast<float2*>(op + (size_t)r1 * D + col) = make_float2(acc[n][2] / d1, acc[n][3] / d1);
  }
}

template <int D>
cudaError_t launch(const float* q, const float* k, const float* v, float* o, float* lse, int B,
                   int H, int KV, int Sq, int Skv, int causal, int window, int q_offset,
                   float scale, cudaStream_t stream) {
  using C = Cfg<D>;
  const int n_q_tiles = (Sq + C::BQ - 1) / C::BQ;
  if (n_q_tiles > 65535) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_tf32x3<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid(H, B, n_q_tiles);
  flash_fwd_tf32x3<D><<<grid, C::THREADS, C::SMEM, stream>>>(q, k, v, o, lse, H, KV, Sq, Skv,
                                                              causal, window, q_offset, scale);
  return cudaGetLastError();
}

}  // namespace

// Dynamic shared memory one block uses at head dim D, in bytes (-1 if D is
// not supported).
extern "C" int flash_attention_smem_bytes(int D) {
  switch (D) {
    case 16: return (int)Cfg<16>::SMEM;
    case 32: return (int)Cfg<32>::SMEM;
    case 64: return (int)Cfg<64>::SMEM;
    case 128: return (int)Cfg<128>::SMEM;
    case 256: return (int)Cfg<256>::SMEM;
    default: return -1;
  }
}

// fp32 tensors, contiguous, (B, heads, S, D), 16-byte aligned. lse is
// nullptr (serving) or a (B, H, Sq) fp32 tensor that gets each row's
// logsumexp of its masked scaled scores, m + log(l) in natural-log units
// (training: the backward recomputes P from it); with nullptr the kernel
// computes what it computed before lse existed, bit for bit. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   void* lse, int B, int H, int KV, int Sq, int Skv, int D,
                                   int causal, int window, int q_offset, float scale,
                                   void* stream) {
  if (B <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || Sq <= 0 || Skv <= 0 || q_offset < 0 ||
      window < 0 || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  const float *qf = static_cast<const float*>(q), *kf = static_cast<const float*>(k),
              *vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(o);
  float* lf = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return (int)launch<16>(qf, kf, vf, of, lf, B, H, KV, Sq, Skv, causal, window, q_offset, scale, s);
    case 32: return (int)launch<32>(qf, kf, vf, of, lf, B, H, KV, Sq, Skv, causal, window, q_offset, scale, s);
    case 64: return (int)launch<64>(qf, kf, vf, of, lf, B, H, KV, Sq, Skv, causal, window, q_offset, scale, s);
    case 128: return (int)launch<128>(qf, kf, vf, of, lf, B, H, KV, Sq, Skv, causal, window, q_offset, scale, s);
    case 256: return (int)launch<256>(qf, kf, vf, of, lf, B, H, KV, Sq, Skv, causal, window, q_offset, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
