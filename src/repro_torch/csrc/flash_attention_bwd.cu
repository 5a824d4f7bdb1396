// Flash-attention backward for fp32 inputs on Hopper (sm_90a), written by
// hand: products on the CUDA cores in fp32, fed from shared memory. bf16
// inputs, which the train paths give, take the tensor-core backward in
// flash_attention_bwd_sm90.cu.
//
// The TPU side has no backward kernel: the JAX package trains through
// autodiff of the jnp twin of src/repro/kernels/flash_attention.py:
// _flash_kernel (src/repro/nn/attention.py:flash_attention). This is the
// backward of the port's fp32 forward (flash_attention.cu), bound to it by
// FlashAttentionFn in kernels/flash_attention.py. Same function as the
// forward: GQA over q (B, H, Sq, D) and k/v (B, KV, Skv, D), H % KV == 0,
// causal, local-window (q_pos - k_pos < window) or bidirectional masks, an
// absolute q_offset, any Sq and Skv, head_dim 16, 32, 64 or 128 (256 is
// recurrentgemma's, whose training is ROADMAP A.9). Its plain version is
// kernels/ref.py:flash_attention_bwd_ref, the explicit formulas below.
//
// What it computes, from q, k, v, the forward's output o, the output's
// gradient do and the forward's fp32 row logsumexp lse (natural log):
//   Δ = rowsum(dO∘O)
//   P = exp(S·scale - lse)              (0 where masked)
//   dV = Pᵀ·dO,  dP = dO·Vᵀ,  dS = P∘(dP - Δ)
//   dQ = dS·K·scale,  dK = dSᵀ·Q·scale  (a GQA group's heads summed into dK, dV)
// all in fp32.
//
// Deterministic, with no atomics: the FlashAttention-2 split into three
// kernels, each output element summed by one thread in a fixed order.
//   1. flash_bwd_delta: one warp a (b, h, query row), Δ by a fixed shuffle tree.
//   2. flash_bwd_dkdv: one block a (key tile of 64, b, kv head). It holds its
//      K and V tiles and the dK, dV accumulators (in registers) and walks
//      the G query heads of its group, then the query tiles that see any of
//      its keys, in that order: per (head, query tile) it recomputes S and P,
//      dP and dS, and adds Pᵀ·dO into dV and dSᵀ·Q into dK.
//   3. flash_bwd_dq: one block a (query tile of 64, b, q head), heaviest tiles
//      first. It holds Q, dO, lse and Δ and walks the key tiles its rows see,
//      adding dS·K into dQ.
// Two launches on the same inputs give the same bits. The masks skip tiles as
// the forward's do: a key tile visits no query tile wholly above the causal
// diagonal or wholly past the window, and a query tile no key tile beyond
// them; partial tiles are masked per element. Rows past Sq and keys past Skv
// load as zeros and get probability 0.
//
// What bounds it on this card. The five products (S, dP, dV, dQ, dK) are
// 10·D FLOP per unmasked (query, key) pair and head; the bytes are q, o, do,
// dq, k, v, dk, dv once each and the fp32 lse. At B8 H15 KV5 S512 D64 fp32
// causal that is 10.09 GFLOP, 0.151 ms at the CUDA cores' 67 TFLOP/s, and
// 84.13 MB (0.025 ms at 3.35 TB/s): the operations bound it. This design runs
// seven products (S and dP in both tile kernels: the price of no atomics),
// 14.1 GFLOP, 0.21 ms at best. Its shape: 256 threads a block as 16 x 16,
// each thread owning a 4 x 4 sub-tile of a 64 x 64 score tile (rows ty +
// 16i, columns tx + 16j, so a warp reads 16 distinct rows of the key-side
// tile and two of the query-side one) and 4 x D/16 elements of a 64 x D
// output tile. Tiles live in shared memory with rows padded by one float
// (odd strides: no bank conflicts between the 16 rows a warp reads). Shared
// memory: 98 KB a block at D = 64 (two blocks a SM), 162 KB at D = 128. Its
// redesign on the tensor cores (split-TF32, as the fp32 forward) is ROADMAP
// B.1's.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;        // query rows a tile
constexpr int BN = 64;        // keys a tile
constexpr int THREADS = 256;  // 16 x 16

template <int D>
struct Cfg {
  static constexpr int LD = D + 1;    // row stride of a D-wide tile, floats
  static constexpr int LDS = BN + 1;  // row stride of a score tile
  static constexpr int DC = D / 16;   // columns of a D-wide output tile a thread owns
  // dK/dV kernel: K, V, Q, dO tiles; P and dS tiles; lse and Δ of the rows.
  static constexpr size_t SMEM_KV = (size_t)(2 * BN * LD + 2 * BM * LD + 2 * BM * LDS + 2 * BM) * 4;
  // dQ kernel: Q, dO, K, V tiles; the dS tile; lse and Δ.
  static constexpr size_t SMEM_Q = (size_t)(2 * BM * LD + 2 * BN * LD + BM * LDS + 2 * BM) * 4;
};

// Rows [r0, r0 + ROWS) of a contiguous (S, D) matrix into a tile of stride
// D + 1 floats, times mul; rows past S are zeros.
template <int D, int ROWS>
__device__ __forceinline__ void load_rows(float* dst, const float* __restrict__ src, int r0, int S,
                                          float mul, int tid) {
  for (int i = tid; i < ROWS * D; i += THREADS) {
    const int r = i / D, c = i % D;
    dst[r * (D + 1) + c] = r0 + r < S ? src[(size_t)(r0 + r) * D + c] * mul : 0.f;
  }
}

// acc[i][j] = sum_d A[ty + 16i][d] B[tx + 16j][d] over two 64-row tiles of
// stride D + 1, summed in the order of d.
template <int D>
__device__ __forceinline__ void tile_product(float (&acc)[4][4], const float* A, const float* B,
                                             int ty, int tx) {
  constexpr int LD = D + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty + 16 * i) * LD + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = B[(tx + 16 * j) * LD + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// Whether query row qi (index into Sq) sees key kp.
__device__ __forceinline__ bool visible(int qi, int kp, int Sq, int Skv, int causal, int window,
                                        int q_offset) {
  const int qpos = q_offset + qi;
  bool ok = qi < Sq && kp < Skv;
  if (causal) ok = ok && qpos >= kp;
  if (window > 0) ok = ok && qpos - kp < window;
  return ok;
}

// Δ = rowsum(dO∘O) in fp32, one warp a row.
template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_delta(const float* __restrict__ o, const float* __restrict__ dout,
                float* __restrict__ delta, int rows) {
  const int row = blockIdx.x * (THREADS / 32) + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= rows) return;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32)
    acc = fmaf(dout[(size_t)row * D + d], o[(size_t)row * D + d], acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkdv(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               float* __restrict__ dk, float* __restrict__ dv, int H, int KV, int Sq, int Skv,
               int causal, int window, int q_offset, float scale) {
  using C = Cfg<D>;
  constexpr int LD = C::LD, LDS = C::LDS, DC = C::DC;
  extern __shared__ float smem[];
  float* ks = smem;             // BN x LD
  float* vs = ks + BN * LD;     // BN x LD
  float* qs = vs + BN * LD;     // BM x LD, q times scale
  float* dos = qs + BM * LD;    // BM x LD
  float* ps = dos + BM * LD;    // BM x LDS
  float* dss = ps + BM * LDS;   // BM x LDS
  float* ls = dss + BM * LDS;   // BM
  float* dl = ls + BM;          // BM

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int n0 = blockIdx.x * BN;  // the tile's first key
  const int bkv = blockIdx.y, b = bkv / KV, kvh = bkv % KV, G = H / KV;
  load_rows<D, BN>(ks, k + (size_t)bkv * Skv * D, n0, Skv, 1.f, tid);
  load_rows<D, BN>(vs, v + (size_t)bkv * Skv * D, n0, Skv, 1.f, tid);

  // Query rows that see any key of the tile: at or past the tile's first
  // key (causal), and before its last key's window ends.
  const int n_last = min(n0 + BN, Skv) - 1;
  const int m_lo = causal ? max(0, n0 - q_offset) : 0;
  const int m_hi = window > 0 ? min(Sq, n_last + window - q_offset) : Sq;
  const int t_lo = m_lo / BM, t_hi = m_hi > m_lo ? (m_hi + BM - 1) / BM : t_lo;

  float dka[4][DC], dva[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DC; ++j) dka[i][j] = dva[i][j] = 0.f;

  for (int g = 0; g < G; ++g) {
    const size_t bh = (size_t)b * H + (size_t)kvh * G + g;
    const float* qp = q + bh * Sq * D;
    const float* dop = dout + bh * Sq * D;
    for (int t = t_lo; t < t_hi; ++t) {
      const int m0 = t * BM;
      __syncthreads();  // K and V landed; the last tile's readers are done
      load_rows<D, BM>(qs, qp, m0, Sq, scale, tid);
      load_rows<D, BM>(dos, dop, m0, Sq, 1.f, tid);
      if (tid < BM) {
        const bool in = m0 + tid < Sq;
        ls[tid] = in ? lse[bh * Sq + m0 + tid] : 0.f;
        dl[tid] = in ? delta[bh * Sq + m0 + tid] : 0.f;
      }
      __syncthreads();
      float s[4][4], dp[4][4];
      tile_product<D>(s, qs, ks, ty, tx);    // S·scale: rows queries, columns keys
      tile_product<D>(dp, dos, vs, ty, tx);  // dP = dO·Vᵀ
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = ty + 16 * i, c = tx + 16 * j;
          const float p = visible(m0 + r, n0 + c, Sq, Skv, causal, window, q_offset)
                              ? expf(s[i][j] - ls[r])
                              : 0.f;
          ps[r * LDS + c] = p;
          dss[r * LDS + c] = p * (dp[i][j] - dl[r]);
        }
      __syncthreads();
      // dV += Pᵀ·dO and dK += dSᵀ·(Q·scale): rows keys ty + 16i, columns tx + 16j.
      for (int m = 0; m < BM; ++m) {
        float pr[4], dr[4], orow[DC], qrow[DC];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pr[i] = ps[m * LDS + ty + 16 * i];
          dr[i] = dss[m * LDS + ty + 16 * i];
        }
#pragma unroll
        for (int j = 0; j < DC; ++j) {
          orow[j] = dos[m * LD + tx + 16 * j];
          qrow[j] = qs[m * LD + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < DC; ++j) {
            dva[i][j] = fmaf(pr[i], orow[j], dva[i][j]);
            dka[i][j] = fmaf(dr[i], qrow[j], dka[i][j]);
          }
      }
    }
  }

  float* dkp = dk + (size_t)bkv * Skv * D;
  float* dvp = dv + (size_t)bkv * Skv * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = n0 + ty + 16 * i;
    if (key < Skv) {
#pragma unroll
      for (int j = 0; j < DC; ++j) {
        dkp[(size_t)key * D + tx + 16 * j] = dka[i][j];
        dvp[(size_t)key * D + tx + 16 * j] = dva[i][j];
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             float* __restrict__ dq, int H, int KV, int Sq, int Skv, int causal, int window,
             int q_offset, float scale) {
  using C = Cfg<D>;
  constexpr int LD = C::LD, LDS = C::LDS, DC = C::DC;
  extern __shared__ float smem[];
  float* qs = smem;            // BM x LD, q times scale
  float* dos = qs + BM * LD;   // BM x LD
  float* ks = dos + BM * LD;   // BN x LD
  float* vs = ks + BN * LD;    // BN x LD
  float* dss = vs + BN * LD;   // BM x LDS
  float* ls = dss + BM * LDS;  // BM
  float* dl = ls + BM;         // BM

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int m0 = (gridDim.x - 1 - blockIdx.x) * BM;  // heaviest query tiles first
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const size_t bkv = (size_t)b * KV + h / (H / KV);
  load_rows<D, BM>(qs, q + (size_t)bh * Sq * D, m0, Sq, scale, tid);
  load_rows<D, BM>(dos, dout + (size_t)bh * Sq * D, m0, Sq, 1.f, tid);
  if (tid < BM) {
    const bool in = m0 + tid < Sq;
    ls[tid] = in ? lse[(size_t)bh * Sq + m0 + tid] : 0.f;
    dl[tid] = in ? delta[(size_t)bh * Sq + m0 + tid] : 0.f;
  }

  // Keys that any row of the tile sees: up to the last row's diagonal
  // (causal), from the first row's window start.
  const int qpos_first = q_offset + m0, qpos_last = q_offset + min(m0 + BM, Sq) - 1;
  const int n_hi = causal ? min(Skv, qpos_last + 1) : Skv;
  const int n_lo = window > 0 ? max(0, qpos_first - window + 1) : 0;
  const int t_lo = n_lo / BN, t_hi = n_hi > n_lo ? (n_hi + BN - 1) / BN : t_lo;
  const float* kp = k + bkv * Skv * D;
  const float* vp = v + bkv * Skv * D;

  float dqa[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DC; ++j) dqa[i][j] = 0.f;

  for (int t = t_lo; t < t_hi; ++t) {
    const int n0 = t * BN;
    __syncthreads();  // Q, dO, lse, Δ landed; the last tile's readers are done
    load_rows<D, BN>(ks, kp, n0, Skv, 1.f, tid);
    load_rows<D, BN>(vs, vp, n0, Skv, 1.f, tid);
    __syncthreads();
    float s[4][4], dp[4][4];
    tile_product<D>(s, qs, ks, ty, tx);
    tile_product<D>(dp, dos, vs, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        const float p = visible(m0 + r, n0 + c, Sq, Skv, causal, window, q_offset)
                            ? expf(s[i][j] - ls[r])
                            : 0.f;
        dss[r * LDS + c] = p * (dp[i][j] - dl[r]);
      }
    __syncthreads();
    // dQ += dS·K: rows queries ty + 16i, columns tx + 16j.
    for (int n = 0; n < BN; ++n) {
      float dr[4], krow[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) dr[i] = dss[(ty + 16 * i) * LDS + n];
#pragma unroll
      for (int j = 0; j < DC; ++j) krow[j] = ks[n * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DC; ++j) dqa[i][j] = fmaf(dr[i], krow[j], dqa[i][j]);
    }
  }

  float* dqp = dq + (size_t)bh * Sq * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = m0 + ty + 16 * i;
    if (r < Sq) {
#pragma unroll
      for (int j = 0; j < DC; ++j) dqp[(size_t)r * D + tx + 16 * j] = dqa[i][j] * scale;
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
                   const float* lse, float* delta, void* dq, void* dk, void* dv, int B, int H,
                   int KV, int Sq, int Skv, int causal, int window, int q_offset, float scale,
                   cudaStream_t stream) {
  using C = Cfg<D>;
  const float *qt = static_cast<const float*>(q), *kt = static_cast<const float*>(k),
          *vt = static_cast<const float*>(v), *ot = static_cast<const float*>(o),
          *dot = static_cast<const float*>(dout);
  const long long rows = (long long)B * H * Sq;
  const long long delta_blocks = (rows + THREADS / 32 - 1) / (THREADS / 32);
  const int q_tiles = (Sq + BM - 1) / BM, k_tiles = (Skv + BN - 1) / BN;
  if (delta_blocks > 0x7fffffffLL || (long long)B * H > 65535 || q_tiles > 0x7fffffff ||
      k_tiles > 0x7fffffff)
    return cudaErrorInvalidValue;
  flash_bwd_delta<D><<<(unsigned)delta_blocks, THREADS, 0, stream>>>(ot, dot, delta, (int)rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dkdv<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)C::SMEM_KV);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dq<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)C::SMEM_Q);
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv<D><<<dim3(k_tiles, B * KV), THREADS, C::SMEM_KV, stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<float*>(dk), static_cast<float*>(dv), H, KV, Sq, Skv,
      causal, window, q_offset, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dq<D><<<dim3(q_tiles, B * H), THREADS, C::SMEM_Q, stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<float*>(dq), H, KV, Sq, Skv, causal, window,
      q_offset, scale);
  return cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of the larger of the two tile kernels' blocks at
// head dim D, in bytes (-1 if D is not supported).
extern "C" int flash_attention_bwd_smem_bytes(int D) {
  switch (D) {
    case 16: return (int)Cfg<16>::SMEM_KV;
    case 32: return (int)Cfg<32>::SMEM_KV;
    case 64: return (int)Cfg<64>::SMEM_KV;
    case 128: return (int)Cfg<128>::SMEM_KV;
    default: return -1;
  }
}

// q, o, do, dq (B, H, Sq, D); k, v, dk, dv (B, KV, Skv, D): fp32,
// contiguous. lse and the scratch delta: (B, H, Sq) fp32. Three launches on
// `stream`; returns cudaGetLastError() after the last (0 on success).
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                   const void* dout, const void* lse, void* delta, void* dq,
                                   void* dk, void* dv, int B, int H, int KV, int Sq, int Skv,
                                   int D, int causal, int window, int q_offset, float scale,
                                   void* stream) {
  if (B <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || Sq <= 0 || Skv <= 0 || q_offset < 0 ||
      window < 0)
    return (int)cudaErrorInvalidValue;
  const float* lf = static_cast<const float*>(lse);
  float* df = static_cast<float*>(delta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return (int)launch<16>(q, k, v, o, dout, lf, df, dq, dk, dv, B, H, KV, Sq, Skv, causal, window, q_offset, scale, s);
    case 32: return (int)launch<32>(q, k, v, o, dout, lf, df, dq, dk, dv, B, H, KV, Sq, Skv, causal, window, q_offset, scale, s);
    case 64: return (int)launch<64>(q, k, v, o, dout, lf, df, dq, dk, dv, B, H, KV, Sq, Skv, causal, window, q_offset, scale, s);
    case 128: return (int)launch<128>(q, k, v, o, dout, lf, df, dq, dk, dv, B, H, KV, Sq, Skv, causal, window, q_offset, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
