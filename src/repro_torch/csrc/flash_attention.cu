// Flash-attention forward in fp32 for Hopper (sm_90a), on the CUDA cores.
// Written by hand.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:_flash_kernel
// (reached through flash_attention_tpu) for fp32 inputs; bf16 inputs take
// the tensor-core kernel in flash_attention_sm90.cu. Same function: GQA attention over
// q (B, H, Sq, D) and k/v (B, KV, Skv, D), with causal, local-window
// (q_pos - k_pos < window) or bidirectional masks and an absolute q_offset.
// q is cast to fp32 and scaled, k/v are cast to fp32; scores, running max,
// normalizer and the P.V accumulator are all fp32; masked scores are -1e30
// (not -inf: a tile whose entries are all masked must not give inf - inf);
// the output is acc / max(l, 1e-30) in fp32. The kv walk runs over the
// tiles [lo, hi): hi stops at the causal diagonal, lo starts at
// q_start - window. Unlike the TPU kernel it takes any Sq and Skv: the
// ragged tail of the last tile is masked (its probabilities are exactly 0).
//
// What bounds it on this card. The serving paths run bf16; in fp32, at the
// smollm-360m prefill shape (B=8, H=15, KV=5, S=512, D=64) the function needs
// about 4 GFLOP and 42 MB, and 4 GFLOP over the 67 TFLOP/s of the fp32 CUDA
// cores bounds it (about 60 us). Tensor cores cannot hold fp32's 2e-5
// tolerance (nor can TF32), so the products run on the CUDA cores out of
// shared memory, bound by shared-memory traffic and fp32 issue. What the
// design does about that:
//   * one block owns 64 query rows of one (batch, q head); each K/V tile
//     is read from device memory once per block and then reused from
//     shared memory by all of the block's threads;
//   * each thread keeps an RPTx8 register tile of scores and an RPTx(D/8)
//     tile of the accumulator; RPT = 4 rows (128 threads) up to D = 128, so
//     12 shared loads feed 32 FMAs. At D = 256 a 4x32 accumulator, the 4x8
//     scores and the operands in flight would crowd the 255 registers a
//     thread may have, so there RPT = 2 and the block has 256 threads: the
//     same 64 rows, half the registers a thread (the shared-memory tiles
//     fill 213,760 of the 232,448 bytes a block may have). Rows of Q, K and
//     P are padded by one float so the row-strided reads hit distinct banks;
//   * row max and row sum are warp shuffles among the 8 lanes of a row;
//   * only tiles the mask leaves anything in are visited (causal diagonal,
//     window edge), which halves a causal prefill's work.
// GQA: the block for q head h reads kv head h / (H / KV); K/V are never
// duplicated in memory (the group's blocks share them through L2). No
// atomics: the result is deterministic. The kernel allocates nothing and
// launches on the caller's stream.

#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;         // query rows per block
constexpr int BK = 64;         // keys per kv tile
constexpr int CPT = BK / 8;    // score columns per thread (8)
constexpr float NEG_INF = -1e30f;

// Rows per thread and threads per block at head dim D: BQ / RPT row groups
// of 8 column lanes each.
template <int D>
struct Tile {
  static constexpr int RPT = D >= 256 ? 2 : 4;
  static constexpr int THREADS = BQ / RPT * 8;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

template <int D>
constexpr size_t smem_floats() {
  // Q and K with padded rows, V unpadded, P with padded rows.
  return (size_t)BQ * (D + 1) + (size_t)BK * (D + 1) + (size_t)BK * D +
         (size_t)BQ * (BK + 1);
}

template <typename T, int D>
__global__ void __launch_bounds__(Tile<D>::THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int H, int KV,
                 int Sq, int Skv, int causal, int window, int q_offset,
                 float scale) {
  constexpr int LDQ = D + 1;   // padded row stride of Q and K tiles
  constexpr int LDP = BK + 1;  // padded row stride of the P tile
  constexpr int DPT = D / 8;   // output columns per thread
  constexpr int RPT = Tile<D>::RPT;
  constexpr int THREADS = Tile<D>::THREADS;
  extern __shared__ float smem[];
  float* Qs = smem;             // BQ x LDQ
  float* Ks = Qs + BQ * LDQ;    // BK x LDQ
  float* Vs = Ks + BK * LDQ;    // BK x D
  float* Ps = Vs + BK * D;      // BQ x LDP

  const int tid = threadIdx.x;
  const int tx = tid & 7;   // column lane: score columns tx + 8c, output columns tx + 8c
  const int ty = tid >> 3;  // row group: rows ty * RPT + i (the 8 lanes of a row share a warp)
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);

  const T* qp = q + (size_t)(b * H + h) * Sq * D;
  const T* kp = k + (size_t)(b * KV + kvh) * Skv * D;
  const T* vp = v + (size_t)(b * KV + kvh) * Skv * D;
  T* op = o + (size_t)(b * H + h) * Sq * D;

  // Stage this block's q rows in fp32, scaled after the cast; rows past Sq are 0.
  for (int e = tid; e < BQ * D; e += THREADS) {
    const int r = e / D, c = e % D;
    float x = 0.f;
    if (q0 + r < Sq) x = to_f32(qp[(size_t)(q0 + r) * D + c]) * scale;
    Qs[r * LDQ + c] = x;
  }

  const int q_start = q_offset + q0;  // absolute position of row 0
  int hi = (Skv + BK - 1) / BK;
  if (causal) hi = min(hi, (q_start + BQ - 1) / BK + 1);
  int lo = 0;
  if (window > 0 && q_start - window > 0) lo = (q_start - window) / BK;

  float m[RPT], l[RPT], acc[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;
  }

  for (int t = lo; t < hi; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile's P and V reads are done
    for (int e = tid; e < BK * D; e += THREADS) {
      const int r = e / D, c = e % D;
      float kx = 0.f, vx = 0.f;
      if (k0 + r < Skv) {
        kx = to_f32(kp[(size_t)(k0 + r) * D + c]);
        vx = to_f32(vp[(size_t)(k0 + r) * D + c]);
      }
      Ks[r * LDQ + c] = kx;
      Vs[r * D + c] = vx;
    }
    __syncthreads();

    // Scores S = Q K^T for this thread's 4 rows x 8 columns.
    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int c = 0; c < CPT; ++c) s[i][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qr[RPT], kc[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qr[i] = Qs[(ty * RPT + i) * LDQ + d];
#pragma unroll
      for (int c = 0; c < CPT; ++c) kc[c] = Ks[(tx + 8 * c) * LDQ + d];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int c = 0; c < CPT; ++c) s[i][c] = fmaf(qr[i], kc[c], s[i][c]);
    }

    // Mask, online softmax update, P to shared memory.
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int row = ty * RPT + i;
      const int qpos = q_start + row;
      float mx = NEG_INF;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int kpos = k0 + tx + 8 * c;
        bool ok = kpos < Skv;
        if (causal) ok = ok && qpos >= kpos;
        if (window > 0) ok = ok && (qpos - kpos) < window;
        if (!ok) s[i][c] = NEG_INF;
        mx = fmaxf(mx, s[i][c]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int col = tx + 8 * c;
        // Columns past Skv do not exist: probability exactly 0.
        const float p = (k0 + col < Skv) ? expf(s[i][c] - m_new) : 0.f;
        Ps[row * LDP + col] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    // acc += P V for this thread's 4 rows x D/8 output columns.
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pr[RPT], vc[DPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pr[i] = Ps[(ty * RPT + i) * LDP + c];
#pragma unroll
      for (int j = 0; j < DPT; ++j) vc[j] = Vs[c * D + tx + 8 * j];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < DPT; ++j) acc[i][j] = fmaf(pr[i], vc[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = q0 + ty * RPT + i;
    if (r < Sq) {
      const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int j = 0; j < DPT; ++j)
        store(&op[(size_t)r * D + tx + 8 * j], acc[i][j] / denom);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B,
                   int H, int KV, int Sq, int Skv, int causal, int window,
                   int q_offset, float scale, cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T, D><<<grid, Tile<D>::THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), H, KV, Sq, Skv, causal, window, q_offset, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v, void* o,
                     int B, int H, int KV, int Sq, int Skv, int causal, int window,
                     int q_offset, float scale, cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, k, v, o, B, H, KV, Sq, Skv, causal, window, q_offset, scale, stream);
    case 32:
      return launch<T, 32>(q, k, v, o, B, H, KV, Sq, Skv, causal, window, q_offset, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, B, H, KV, Sq, Skv, causal, window, q_offset, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, B, H, KV, Sq, Skv, causal, window, q_offset, scale, stream);
    case 256:
      return launch<T, 256>(q, k, v, o, B, H, KV, Sq, Skv, causal, window, q_offset, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Dynamic shared memory one block uses at head dim D, in bytes (-1 if D is
// not supported).
extern "C" int flash_attention_smem_bytes(int D) {
  switch (D) {
    case 16: return (int)(smem_floats<16>() * sizeof(float));
    case 32: return (int)(smem_floats<32>() * sizeof(float));
    case 64: return (int)(smem_floats<64>() * sizeof(float));
    case 128: return (int)(smem_floats<128>() * sizeof(float));
    case 256: return (int)(smem_floats<256>() * sizeof(float));
    default: return -1;
  }
}

// fp32 tensors, contiguous, (B, heads, S, D). Returns cudaGetLastError()
// after the launch (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, int B, int H, int KV, int Sq, int Skv,
                                   int D, int causal, int window, int q_offset,
                                   float scale, void* stream) {
  if (B <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || Sq <= 0 || Skv <= 0 ||
      q_offset < 0 || window < 0 || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  return (int)launch_d<float>(D, q, k, v, o, B, H, KV, Sq, Skv, causal, window,
                              q_offset, scale, static_cast<cudaStream_t>(stream));
}
