// Backward of the RG-LRU linear-recurrence scan for Hopper (sm_90a), written
// by hand: the forward's ring of asynchronous copies (rglru.cu) walked
// backward in time, under a per-lane reverse walk that rounds like the plain
// version, so it equals it bit for bit.
//
// The TPU side has no backward kernel: the JAX package trains through
// autodiff of jax.lax.associative_scan (src/repro/nn/recurrent.py:rglru),
// where the port runs the scan kernel that replaces src/repro/kernels/
// rglru.py:31 (_rglru_kernel). This is that kernel's backward, bound to it by
// RGLRUScanFn in kernels/rglru.py. Its plain version is
// kernels/ref.py:rglru_scan_bwd_ref. From the forward's inputs a (B, S, W),
// its output h, the gradient g of h and the gradient g_last (B, W) of h_last
// (or none), all fp32, with dh_t the gradient that reaches h_t:
//   dh_{S-1} = g_{S-1} + g_last,   dh_t = g_t + a_{t+1}·dh_{t+1}
//   da_t = dh_t·h_{t-1} (h_{-1} = h0, or 0),   db_t = dh_t,   dh0 = a_0·dh_0
// each product rounded, then the add (__fmul_rn, __fadd_rn: no contraction
// into an FMA), as the plain version rounds. Without g_last the walk starts
// from -0, which adds to any g exactly. da, db (B, S, W) and dh0 (B, W) are
// fp32. Any B, S and W.
//
// What bounds it. It reads a, h and g once and writes da and db once, with 3
// FLOP an element: bound by bytes. At recurrentgemma-2b's train shape (B8
// S512 W2560, fp32, no h0) that is 5 x 41.94 = 209.7 MB, 62.6 us at 3.35
// TB/s.
//
// The design is the forward's (rglru.cu's header has the numbers that chose
// it), run from the last time tile to the first:
//   * Geometry. A block owns one batch row and LANES = 16 consecutive lanes
//     along W and walks all of S backward: B * ceil(W / 16) blocks. Warp 0
//     is the producer, warp 1 the consumer; its lanes 0-15 own one lane of W
//     each.
//   * The ring. STAGES = 4 stages of STEPS = 64 time steps x LANES lanes of
//     a, h and g (12 KB a stage, 48 KB a ring: above the 48 KB default, so
//     the launch raises the block's limit), on two mbarriers a stage (full,
//     empty). The producer fills the stages with time tiles n-1, n-2, ..., 0
//     as the consumer releases them.
//   * Loads. Where the row stride and the three base pointers lie on 16
//     bytes, one producer thread copies each tile as a 3-D TMA box (lanes,
//     steps, 1) of the (W, S, B) tensor; TMA fills the ragged edge with
//     zeros the walk never reads. Elsewhere the producer warp loads each
//     element itself, stores it to the stage and arrives on the full barrier
//     (release), all 32 threads at once.
//   * The tile edges. dh_t reads a_{t+1} and da_t reads h_{t-1}, one step
//     into each neighbouring tile. The first needs no neighbour: the walk
//     carries a_{t+1}·dh_{t+1} from step t+1, where a_{t+1} is in the tile.
//     The second is one element a lane per tile: before it waits for a tile,
//     the consumer loads h at the step before the tile (or h0, or 0, at t =
//     0) from global memory, and the walk reads it at the tile's first step.
//   * The walk. Each consumer thread walks its lane's column of a stage from
//     the last step to the first, with the carry in a register, and stores
//     da and db straight to global memory (16 lanes: one 64-byte segment a
//     step each). One arrive of lane 0, after __syncwarp, releases the stage.
//     dh0 is written once at the end, where there is an h0.
//   * Determinism. No atomics and no state shared across blocks: two
//     launches give the same bits by construction.
// The kernel allocates nothing and launches on the caller's stream.

#include "sm90.cuh"  // mbarriers, TMA, the tensor-map encoder, allow_smem

namespace {

constexpr int LANES = 16;   // consecutive lanes of W a block owns
constexpr int STEPS = 64;   // time steps in one stage
constexpr int STAGES = 4;   // stages in the ring
constexpr int THREADS = 64; // warp 0: producer; warp 1: consumer
constexpr int TILE = STEPS * LANES * 4;  // a, h or g (fp32), one stage
constexpr int STAGE = 3 * TILE;
constexpr int BARS = STAGES * STAGE;     // byte offset of the barriers
// 128 bytes of slack to align the ring to 128 bytes, which TMA needs.
constexpr int SMEM = 128 + BARS + 2 * STAGES * 8;
constexpr int PER_THREAD = STEPS * LANES / 32;  // elements of each array a producer thread loads

// Block: batch row bi, lanes [w0, w0 + LANES). use_tma picks the producer's
// load path (the maps are unused otherwise).
__global__ void __launch_bounds__(THREADS)
rglru_scan_bwd_kernel(const __grid_constant__ CUtensorMap tm_a,
                      const __grid_constant__ CUtensorMap tm_h,
                      const __grid_constant__ CUtensorMap tm_g, const float* __restrict__ a,
                      const float* __restrict__ h, const float* __restrict__ g,
                      const float* __restrict__ h0, const float* __restrict__ g_last,
                      float* __restrict__ da, float* __restrict__ db, float* __restrict__ dh0,
                      int S, int W, int w_tiles, int use_tma) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((128 - (smem_u32(smem_raw) & 127)) & 127);
  const int bi = blockIdx.x / w_tiles;
  const int w0 = (blockIdx.x % w_tiles) * LANES;
  const int n_tiles = (S + STEPS - 1) / STEPS;
  const uint32_t full = smem_u32(smem + BARS), empty = full + 8 * STAGES;
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
    // Producer: the i-th stage filled holds time tile n_tiles - 1 - i.
    if (use_tma) {
      if (lane != 0) return;
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % STAGES, t0 = (n_tiles - 1 - i) * STEPS;
        mbar_wait(empty + 8 * s, ((i / STAGES) & 1) ^ 1);  // the first round passes
        const uint32_t dst = smem_u32(smem + s * STAGE);
        mbar_expect_tx(full + 8 * s, STAGE);
        tma_load(dst, &tm_a, full + 8 * s, w0, t0, bi);
        tma_load(dst + TILE, &tm_h, full + 8 * s, w0, t0, bi);
        tma_load(dst + 2 * TILE, &tm_g, full + 8 * s, w0, t0, bi);
      }
    } else {
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % STAGES, t0 = (n_tiles - 1 - i) * STEPS;
        mbar_wait(empty + 8 * s, ((i / STAGES) & 1) ^ 1);
        float* sa = reinterpret_cast<float*>(smem + s * STAGE);
        float* sh = sa + STEPS * LANES;
        float* sg = sh + STEPS * LANES;
        float va[PER_THREAD], vh[PER_THREAD], vg[PER_THREAD];
#pragma unroll
        for (int j = 0; j < PER_THREAD; ++j) {  // every load before any store
          const int e = j * 32 + lane, t = t0 + e / LANES, w = w0 + e % LANES;
          if (t < S && w < W) {
            const size_t off = ((size_t)bi * S + t) * W + w;
            va[j] = a[off];
            vh[j] = h[off];
            vg[j] = g[off];
          }
        }
#pragma unroll
        for (int j = 0; j < PER_THREAD; ++j) {
          const int e = j * 32 + lane;
          if (t0 + e / LANES < S && w0 + e % LANES < W) {
            sa[e] = va[j];
            sh[e] = vh[j];
            sg[e] = vg[j];
          }
        }
        mbar_arrive(full + 8 * s);
      }
    }
    return;
  }

  // Consumer: lane l walks lane w0 + l over all of S, backward.
  const int w = w0 + lane;
  const bool active = lane < LANES && w < W;
  const size_t row = (size_t)bi * W + w;
  const size_t col = (size_t)bi * S * W + w;  // (bi, 0, w)
  // a_{t+1}·dh_{t+1}, carried down the walk; it starts as g_last or as -0,
  // which adds to g_{S-1} exactly.
  float carry = (active && g_last) ? g_last[row] : -0.0f;
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % STAGES, t0 = (n_tiles - 1 - i) * STEPS;
    // h_{t0-1}: the step before this tile, read at its first step
    float h_edge = 0.f;
    if (active) h_edge = t0 > 0 ? h[col + (size_t)(t0 - 1) * W] : (h0 ? h0[row] : 0.f);
    mbar_wait(full + 8 * s, (i / STAGES) & 1);
    if (active) {
      const float* sa = reinterpret_cast<const float*>(smem + s * STAGE) + lane;
      const float* sh = sa + STEPS * LANES;
      const float* sg = sh + STEPS * LANES;
      float* dap = da + col + (size_t)t0 * W;
      float* dbp = db + col + (size_t)t0 * W;
      const int steps = min(STEPS, S - t0);
      // steps - 1 .. 1, each reading h_{t-1} from the stage; then step 0.
      if (steps == STEPS) {
        // Unrolled by half a stage, as the forward's walk.
#pragma unroll 32
        for (int u = STEPS - 1; u > 0; --u) {
          const float dh = __fadd_rn(sg[u * LANES], carry);
          dbp[(size_t)u * W] = dh;
          dap[(size_t)u * W] = __fmul_rn(dh, sh[(u - 1) * LANES]);
          carry = __fmul_rn(sa[u * LANES], dh);
        }
      } else {
        for (int u = steps - 1; u > 0; --u) {
          const float dh = __fadd_rn(sg[u * LANES], carry);
          dbp[(size_t)u * W] = dh;
          dap[(size_t)u * W] = __fmul_rn(dh, sh[(u - 1) * LANES]);
          carry = __fmul_rn(sa[u * LANES], dh);
        }
      }
      const float dh = __fadd_rn(sg[0], carry);
      dbp[0] = dh;
      dap[0] = __fmul_rn(dh, h_edge);
      carry = __fmul_rn(sa[0], dh);
    }
    __syncwarp();  // every read of the stage has been used
    if (lane == 0) mbar_arrive(empty + 8 * s);
  }
  if (active && dh0) dh0[row] = carry;  // a_0·dh_0
}

// ---- host side -------------------------------------------------------------

// A 3-D map over a contiguous fp32 (B, S, W) tensor, as (W, S, B), boxes of
// LANES x STEPS x 1.
bool make_map_f32(CUtensorMap* map, const void* ptr, int B, int S, int W) {
  EncodeTiled encode = tensor_map_encoder();
  if (!encode) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)W, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)W * 4, (cuuint64_t)S * W * 4};
  const cuuint32_t box[3] = {LANES, STEPS, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Whether the producer loads with TMA: the row stride and the three base
// pointers on 16 bytes.
bool tma_ok(const void* a, const void* h, const void* g, int W) {
  return ((size_t)W * 4) % 16 == 0 &&
         ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(h) |
           reinterpret_cast<uintptr_t>(g)) % 16) == 0;
}

cudaError_t launch(const float* a, const float* h, const float* g, const float* h0,
                   const float* g_last, float* da, float* db, float* dh0, int B, int S, int W,
                   cudaStream_t stream) {
  const long long blocks = (long long)B * ((W + LANES - 1) / LANES);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  CUtensorMap tm_a = {}, tm_h = {}, tm_g = {};
  const int use_tma = tma_ok(a, h, g, W);
  if (use_tma && (!make_map_f32(&tm_a, a, B, S, W) || !make_map_f32(&tm_h, h, B, S, W) ||
                  !make_map_f32(&tm_g, g, B, S, W)))
    return cudaErrorInvalidValue;
  static unsigned long long set_on = 0;  // bit d: the limit is set on device d
  cudaError_t err = allow_smem(rglru_scan_bwd_kernel, SMEM, set_on);
  if (err != cudaSuccess) return err;
  rglru_scan_bwd_kernel<<<(unsigned)blocks, THREADS, SMEM, stream>>>(
      tm_a, tm_h, tm_g, a, h, g, h0, g_last, da, db, dh0, S, W, (W + LANES - 1) / LANES,
      use_tma);
  return cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of one block, in bytes.
extern "C" int rglru_scan_bwd_smem_bytes() { return SMEM; }

// Whether a launch on these inputs loads with TMA (1) or with the producer
// warp's ordinary loads (0).
extern "C" int rglru_scan_bwd_uses_tma(const void* a, const void* h, const void* g, int W) {
  return tma_ok(a, h, g, W) ? 1 : 0;
}

// a, h, g, da, db: contiguous fp32 (B, S, W); h0, g_last (may be null) and
// dh0 (null where there is no h0): contiguous fp32 (B, W). Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int rglru_scan_bwd(const void* a, const void* h, const void* g, const void* h0,
                              const void* g_last, void* da, void* db, void* dh0, int B, int S,
                              int W, void* stream) {
  if (B <= 0 || S <= 0 || W <= 0 || (long long)B * W > (1LL << 40))
    return (int)cudaErrorInvalidValue;
  return (int)launch(static_cast<const float*>(a), static_cast<const float*>(h),
                     static_cast<const float*>(g), static_cast<const float*>(h0),
                     static_cast<const float*>(g_last), static_cast<float*>(da),
                     static_cast<float*>(db), static_cast<float*>(dh0), B, S, W,
                     static_cast<cudaStream_t>(stream));
}
