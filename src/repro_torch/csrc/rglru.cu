// RG-LRU linear-recurrence scan for Hopper (sm_90a), written by hand.
//
// Replaces the TPU kernel src/repro/kernels/rglru.py:_rglru_kernel (reached
// through rglru_scan_tpu). Same function: h_t = a_t * h_{t-1} + b_t over
// axis 1 of a, b (B, S, W), both fp32 or both bf16; h_{-1} is the fp32 h0
// (B, W) or 0; h is written in b's dtype, h_last (B, W) in fp32, and the
// recurrence runs in fp32 inside. Unlike the TPU kernel it takes any B, S
// and W: the TPU kernel raises unless they divide its (8, 256, 128) blocks.
//
// What bounds it on this card. The function reads a and b once and writes h
// once and does 2 FLOP per element, so it is bound by memory bytes: at the
// serving prefill shape of recurrentgemma-2b (B=8, S=512, W=2560, fp32) that
// is 125.8 MB, about 38 us at 3.35 TB/s. The TPU kernel walks time blocks in
// order on one core and carries h in VMEM; on Hopper blocks run in parallel
// and in no order, so this design gives each (b, w) lane to one thread:
//   * the thread walks the whole sequence with h in a register, so no state
//     crosses blocks and there are no atomics: the result is deterministic;
//   * neighbouring threads own neighbouring w, so each time step's loads and
//     stores of a warp are coalesced (32 consecutive elements);
//   * the loads of the next UNROLL steps are all sent before the dependent
//     chain over them, so each thread keeps 2 * UNROLL loads in flight;
//   * each step rounds a_t * h and then the sum, as the TPU kernel's
//     `a * h + b` and the plain version do (__fmul_rn/__fadd_rn keep the
//     compiler from contracting them into one FMA), so the kernel agrees
//     with the plain version bit for bit.
// What holds it back: the only parallelism is B * W lanes. At B=8, W=2560
// there are 20,480 lanes, 320 blocks of 64 threads, about 2.4 blocks (155
// lanes) per SM, and at B=1 only 40 blocks for 132 SMs, so too few bytes
// are in flight to reach the memory rate and the time grows with S. A
// chunked two-pass scan over time (per-chunk carries, then a fix-up pass)
// is the later kernel's work. The kernel allocates nothing and launches on
// the caller's stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 64;  // lanes per block
constexpr int UNROLL = 16;   // time steps loaded ahead of the dependent chain

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }
// h_t = a_t * h_{t-1} + b_t with two roundings, not one FMA.
__device__ __forceinline__ float step(float a, float h, float b) {
  return __fadd_rn(__fmul_rn(a, h), b);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
rglru_scan_kernel(const T* __restrict__ a, const T* __restrict__ b,
                  const float* __restrict__ h0, T* __restrict__ h,
                  float* __restrict__ h_last, int B, int S, int W) {
  const long long lane = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (lane >= (long long)B * W) return;
  const int bi = (int)(lane / W);
  const int w = (int)(lane % W);
  const size_t base = (size_t)bi * S * W + w;  // element (bi, 0, w)
  const T* ap = a + base;
  const T* bp = b + base;
  T* hp = h + base;

  float hv = h0 ? h0[lane] : 0.f;
  int t = 0;
  for (; t + UNROLL <= S; t += UNROLL) {
    float av[UNROLL], bv[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      av[u] = to_f32(ap[(size_t)(t + u) * W]);
      bv[u] = to_f32(bp[(size_t)(t + u) * W]);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      hv = step(av[u], hv, bv[u]);
      store(&hp[(size_t)(t + u) * W], hv);
    }
  }
  for (; t < S; ++t) {
    hv = step(to_f32(ap[(size_t)t * W]), hv, to_f32(bp[(size_t)t * W]));
    store(&hp[(size_t)t * W], hv);
  }
  h_last[lane] = hv;
}

template <typename T>
cudaError_t launch(const void* a, const void* b, const float* h0, void* h,
                   float* h_last, int B, int S, int W, cudaStream_t stream) {
  const long long lanes = (long long)B * W;
  const unsigned blocks = (unsigned)((lanes + THREADS - 1) / THREADS);
  rglru_scan_kernel<T><<<blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), h0, static_cast<T*>(h),
      h_last, B, S, W);
  return cudaGetLastError();
}

}  // namespace

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
