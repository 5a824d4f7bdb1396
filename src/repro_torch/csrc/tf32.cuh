// Shared pieces of the port's fp32 kernels on Hopper's tensor cores (sm_90a),
// written by hand: the TF32 split of an fp32 operand, the m16n8k8 TF32
// mma.sync, and the cp.async copies that feed it. Included by
// flash_attention.cu (the fp32 flash forward) and flash_attention_bwd.cu (its
// backward); each builds into a library of its own, so everything here has
// internal linkage. kernels/_build.py hashes this header into every
// library's name, so an edited header rebuilds them.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// cvt.rna.tf32.f32 (10 mantissa bits kept, round to nearest, ties away from
// zero) for finite x, in two integer instructions: add half a tf32 ulp to
// the magnitude, clear the 13 low bits. The compiled cvt adds a test and a
// select for inf and NaN, which these products never see.
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo, hi = tf32(x); lo = x - hi is exact in fp32 and goes to the
// tensor cores as it is: they read its 11 leading bits (rounding toward
// zero), within 2^-21 |x| of it.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// c += a.b, m16n8k8, tf32 operands, fp32 accumulator. Not volatile: the
// compiler may interleave independent products; each accumulator's own
// chain keeps its order.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 16 bytes global -> shared through L2; src_bytes 0 writes 16 zero bytes.
__device__ __forceinline__ void cp_async16(float* dst, const float* src, int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

}  // namespace
