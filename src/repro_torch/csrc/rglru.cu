// RG-LRU linear-recurrence scan for Hopper (sm_90a), written by hand: a deep
// ring of asynchronous copies in shared memory under a per-lane walk that
// rounds like the plain version, so it equals it bit for bit.
//
// Replaces the TPU kernel src/repro/kernels/rglru.py:31 (_rglru_kernel,
// reached through rglru_scan_tpu, pl.pallas_call at :81). Same function:
// h_t = a_t * h_{t-1} + b_t over axis 1 of a, b (B, S, W), both fp32 or both
// bf16; h_{-1} is the fp32 h0 (B, W) or 0; h is written in b's dtype, h_last
// (B, W) in fp32, and the recurrence runs in fp32 inside. Unlike the TPU
// kernel it takes any B, S and W: the TPU kernel raises unless they divide
// its (8, 256, 128) blocks.
//
// What bounds it. It reads a and b once, writes h once and does 2 FLOP per
// element: it is bound by bytes. At recurrentgemma-2b's prefill shapes (fp32,
// W = 2560) that is 125.9 MB at B8 S512 and 94.4 MB at B1 S3072, 37.6 and
// 28.2 us at 3.35 TB/s.
//
// What held the first design back (one thread per (b, w) lane, each loading
// 16 steps of a and b and then running the dependent chain over them): a
// thread had at most 2 * 16 * 4 B = 128 B in flight. At B8 that is 20,480
// lanes and about 2.6 MB across the card; at B1, 2,560 lanes in 40 blocks of
// 64 threads, 40 of 132 SMs busy and about 0.33 MB in flight. Little's law at
// 3.35 TB/s and about 1 us of loaded DRAM latency asks for 3+ MB, and the
// two shapes reached 50% and 9% of the rate (8x the bytes in flight, 5.6x
// the rate). The chain itself is cheap: __fmul_rn then __fadd_rn is about 8
// cycles a step, while the bound at B1 W2560 allows 3 * 2560 * 4 B / 3.35
// TB/s = 9.2 ns, about 16 cycles. A walk fed fast enough fits under the bound.
//
// This design puts the missing bytes in flight and keeps the walk:
//   * Geometry. A block owns one batch row and LANES = 16 consecutive lanes
//     along W and walks all of S: B * ceil(W / 16) blocks, 160 at B1 W2560
//     (more than the 132 SMs), 1,280 at B8. Warp 0 is the producer, warp 1
//     the consumer; its lanes 0-15 own one lane of W each.
//   * The ring. STAGES = 4 stages of STEPS = 64 time steps x LANES lanes of
//     a and of b, on two mbarriers a stage (full, empty). The producer keeps
//     every stage the consumer has released in flight: 4 x 8 KB = 32 KB a
//     block in fp32, so up to 5.2 MB across the card at B1 and, at 6 blocks
//     an SM (shared memory bounds it), 26 MB at B8. On an H100, 8 stages,
//     32- or 128-step stages, 32-lane tiles (80 blocks at B1), no L2
//     promotion, and copying a whole stage to registers to release it
//     early were each slower or no faster.
//   * Loads. Where the row stride W * itemsize and both base pointers are
//     multiples of 16 bytes (every main-path shape), one producer thread
//     copies each tile as a 3-D TMA box (lanes, steps, 1) of the (W, S, B)
//     tensor, completing on the stage's full barrier; TMA fills the ragged
//     lanes and steps of the edge with zeros the walk never reads. Any other
//     shape (an odd W, a bf16 W not a multiple of 8, a view that starts off
//     16 bytes) takes the same kernel's other load path: the producer warp
//     reads each element with an ordinary load, stores it to the stage and
//     arrives on the full barrier (release), all 32 threads at once. Not
//     cp.async: it moves 4, 8 or 16 bytes and a bf16 element is 2.
//   * The walk. Each consumer thread reads its column of a stage (a warp
//     reads one 64-byte row a step: no bank conflict), runs
//     __fadd_rn(__fmul_rn(a, h), b) over the steps in order from h0, as the
//     TPU kernel's `a * h + b` and the plain version round (no contraction
//     into one FMA), and stores h straight to global memory (16 lanes, one
//     64-byte segment a step). The stage is released, by one arrive of lane
//     0 after __syncwarp, once every value read from it has been used.
//     h_last is written once at the end.
//   * Determinism. No atomics and no state shared across blocks: two
//     launches give the same bits by construction.
// Not taken: a chunked two-pass scan over time (per-chunk carries, then a
// fix-up pass) reads a and b twice, +67% bytes at B8 where 84 MB of a and b
// does not fit the 50 MB L2, and changes the association to A * carry +
// h_local, so it no longer equals the plain version; its single-pass
// decoupled look-back variant takes an association that depends on which
// predecessors had finished, so two launches could differ. The kernel
// allocates nothing and launches on the caller's stream.

#include "sm90.cuh"  // mbarriers, TMA, the tensor-map encoder

namespace {

constexpr int LANES = 16;   // consecutive lanes of W a block owns
constexpr int STEPS = 64;   // time steps in one stage
constexpr int STAGES = 4;   // stages in the ring
constexpr int THREADS = 64; // warp 0: producer; warp 1: consumer

template <typename T>
struct Ring {
  static constexpr int TILE = STEPS * LANES * (int)sizeof(T);  // a or b, one stage
  static constexpr int STAGE = 2 * TILE;
  static constexpr int BARS = STAGES * STAGE;  // byte offset of the barriers
  // 128 bytes of slack to align the ring to 128 bytes, which TMA needs.
  static constexpr int SMEM = 128 + BARS + 2 * STAGES * 8;
  static constexpr int PER_THREAD = STEPS * LANES / 32;  // elements a producer thread loads
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }
// h_t = a_t * h_{t-1} + b_t with two roundings, not one FMA.
__device__ __forceinline__ float step(float a, float h, float b) {
  return __fadd_rn(__fmul_rn(a, h), b);
}

// ---- the kernel ------------------------------------------------------------

// Block: batch row bi, lanes [w0, w0 + LANES). use_tma picks the producer's
// load path (the maps are unused otherwise).
template <typename T>
__global__ void __launch_bounds__(THREADS)
rglru_scan_kernel(const __grid_constant__ CUtensorMap tm_a,
                  const __grid_constant__ CUtensorMap tm_b, const T* __restrict__ a,
                  const T* __restrict__ b, const float* __restrict__ h0, T* __restrict__ h,
                  float* __restrict__ h_last, int S, int W, int w_tiles, int use_tma) {
  using R = Ring<T>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((128 - (smem_u32(smem_raw) & 127)) & 127);
  const int bi = blockIdx.x / w_tiles;
  const int w0 = (blockIdx.x % w_tiles) * LANES;
  const int n_tiles = (S + STEPS - 1) / STEPS;
  const uint32_t full = smem_u32(smem + R::BARS), empty = full + 8 * STAGES;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, use_tma ? 1 : 32);  // TMA: one expect_tx; else every producer thread
      mbar_init(empty + 8 * s, 1);                // lane 0 of the consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 0) {
    // Producer: refill each stage as soon as the consumer releases it.
    if (use_tma) {
      if (lane != 0) return;
      for (int k = 0; k < n_tiles; ++k) {
        const int s = k % STAGES;
        mbar_wait(empty + 8 * s, ((k / STAGES) & 1) ^ 1);  // the first round passes
        const uint32_t dst = smem_u32(smem + s * R::STAGE);
        mbar_expect_tx(full + 8 * s, R::STAGE);
        tma_load(dst, &tm_a, full + 8 * s, w0, k * STEPS, bi);
        tma_load(dst + R::TILE, &tm_b, full + 8 * s, w0, k * STEPS, bi);
      }
    } else {
      for (int k = 0; k < n_tiles; ++k) {
        const int s = k % STAGES;
        mbar_wait(empty + 8 * s, ((k / STAGES) & 1) ^ 1);
        T* sa = reinterpret_cast<T*>(smem + s * R::STAGE);
        T* sb = sa + STEPS * LANES;
        T va[R::PER_THREAD], vb[R::PER_THREAD];
#pragma unroll
        for (int i = 0; i < R::PER_THREAD; ++i) {  // every load before any store
          const int e = i * 32 + lane, t = k * STEPS + e / LANES, w = w0 + e % LANES;
          if (t < S && w < W) {
            const size_t off = ((size_t)bi * S + t) * W + w;
            va[i] = a[off];
            vb[i] = b[off];
          }
        }
#pragma unroll
        for (int i = 0; i < R::PER_THREAD; ++i) {
          const int e = i * 32 + lane;
          if (k * STEPS + e / LANES < S && w0 + e % LANES < W) {
            sa[e] = va[i];
            sb[e] = vb[i];
          }
        }
        mbar_arrive(full + 8 * s);
      }
    }
    return;
  }

  // Consumer: lane l walks lane w0 + l over all of S.
  const int w = w0 + lane;
  const bool active = lane < LANES && w < W;
  float hv = (active && h0) ? h0[(size_t)bi * W + w] : 0.f;
  T* hp = h + (size_t)bi * S * W + w;
  for (int k = 0; k < n_tiles; ++k) {
    const int s = k % STAGES;
    mbar_wait(full + 8 * s, (k / STAGES) & 1);
    if (active) {
      const T* sa = reinterpret_cast<const T*>(smem + s * R::STAGE) + lane;
      const T* sb = sa + STEPS * LANES;
      T* hq = hp + (size_t)k * STEPS * W;
      const int steps = min(STEPS, S - k * STEPS);
      if (steps == STEPS) {
        // Unrolled by half a stage: ptxas hoists the shared-memory loads of
        // 32 steps ahead of their chain (in full, it spills).
#pragma unroll 32
        for (int u = 0; u < STEPS; ++u) {
          hv = step(to_f32(sa[u * LANES]), hv, to_f32(sb[u * LANES]));
          store(hq, hv);
          hq += W;
        }
      } else {
        for (int u = 0; u < steps; ++u) {
          hv = step(to_f32(sa[u * LANES]), hv, to_f32(sb[u * LANES]));
          store(hq, hv);
          hq += W;
        }
      }
    }
    __syncwarp();  // every read of the stage has been used
    if (lane == 0) mbar_arrive(empty + 8 * s);
  }
  if (active) h_last[(size_t)bi * W + w] = hv;
}

// ---- host side -------------------------------------------------------------

// A 3-D map over a contiguous (B, S, W) tensor, as (W, S, B), boxes of
// LANES x STEPS x 1.
template <typename T>
bool make_map(CUtensorMap* map, const void* ptr, int B, int S, int W) {
  EncodeTiled encode = tensor_map_encoder();
  if (!encode) return false;
  const cuuint64_t isz = sizeof(T);
  const cuuint64_t dims[3] = {(cuuint64_t)W, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)W * isz, (cuuint64_t)S * W * isz};
  const cuuint32_t box[3] = {LANES, STEPS, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUtensorMapDataType dt =
      sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  return encode(map, dt, 3, const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Whether the producer loads with TMA: the row stride and both base pointers
// on 16 bytes.
bool tma_ok(const void* a, const void* b, int W, int itemsize) {
  return ((size_t)W * itemsize) % 16 == 0 &&
         ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) % 16) == 0;
}

template <typename T>
cudaError_t launch(const void* a, const void* b, const float* h0, void* h, float* h_last,
                   int B, int S, int W, cudaStream_t stream) {
  using R = Ring<T>;
  static_assert(R::SMEM <= 48 * 1024, "above 48 KB a launch needs "
                "cudaFuncAttributeMaxDynamicSharedMemorySize set first");
  const long long blocks = (long long)B * ((W + LANES - 1) / LANES);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  CUtensorMap tm_a = {}, tm_b = {};
  const int use_tma = tma_ok(a, b, W, sizeof(T));
  if (use_tma && (!make_map<T>(&tm_a, a, B, S, W) || !make_map<T>(&tm_b, b, B, S, W)))
    return cudaErrorInvalidValue;
  rglru_scan_kernel<T><<<(unsigned)blocks, THREADS, R::SMEM, stream>>>(
      tm_a, tm_b, static_cast<const T*>(a), static_cast<const T*>(b), h0, static_cast<T*>(h),
      h_last, S, W, (W + LANES - 1) / LANES, use_tma);
  return cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of one block, in bytes: dtype 0 = float32, 1 =
// bfloat16 (-1 otherwise).
extern "C" int rglru_scan_smem_bytes(int dtype) {
  return dtype == 0 ? Ring<float>::SMEM : dtype == 1 ? Ring<__nv_bfloat16>::SMEM : -1;
}

// Whether a launch on these inputs loads with TMA (1) or with the producer
// warp's ordinary loads (0).
extern "C" int rglru_scan_uses_tma(const void* a, const void* b, int W, int dtype) {
  return tma_ok(a, b, W, dtype == 0 ? 4 : 2) ? 1 : 0;
}

// dtype: 0 = float32, 1 = bfloat16 (a, b and h). a, b, h: contiguous
// (B, S, W); h0 (fp32, may be null) and h_last (fp32): contiguous (B, W).
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int rglru_scan_fwd(const void* a, const void* b, const void* h0,
                              void* h, void* h_last, int B, int S, int W,
                              int dtype, void* stream) {
  if (B <= 0 || S <= 0 || W <= 0 || (long long)B * W > (1LL << 40))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* h0f = static_cast<const float*>(h0);
  float* hl = static_cast<float*>(h_last);
  if (dtype == 0) return (int)launch<float>(a, b, h0f, h, hl, B, S, W, s);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(a, b, h0f, h, hl, B, S, W, s);
  return (int)cudaErrorInvalidValue;
}
