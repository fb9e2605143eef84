// Tensor-core and copy primitives shared by the port's kernels (sm_80 and
// later; built for sm_90a): cp.async copies into shared memory, ldmatrix
// fragment loads, the bf16 m16n8k16 and tf32 m16n8k8 mma.sync shapes, and
// the precision-preserving splits of an f32 value into two bf16 or two
// tf32 terms.
//
// Fragment layouts (PTX ISA, "Matrix Fragments for mma.m16n8k16/k8"), with
// g = lane / 4 and t = lane % 4:
//   C/D m16n8 f32:    d0, d1 at (row g, cols 2t, 2t+1); d2, d3 at row g+8.
//   A m16k16 bf16:    a0 (row g, k 2t..2t+1), a1 (row g+8, same k),
//                     a2 (row g, k 2t+8..2t+9), a3 (row g+8, same k),
//                     each register two bf16, the lower k in the low half.
//   B k16n8 bf16:     b0 (k 2t..2t+1, col g), b1 (k 2t+8..2t+9, col g).
//   A m16k8 tf32:     a0 (row g, k t), a1 (row g+8, k t), a2 (row g, k t+4),
//                     a3 (row g+8, k t+4).
//   B k8n8 tf32:      b0 (k t, col g), b1 (k t+4, col g).
// So the C fragments of two neighbouring n8 tiles, converted to bf16 and
// packed in pairs, are exactly the A fragment of one k16 step: the
// probabilities of flash attention never leave registers.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace tc {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy global -> shared, bypassing L1; when `fill` is
// false nothing is read and the 16 bytes are zeroed (src-size 0).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool fill) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(fill ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i,
// register i receives matrix i's (row lane / 4, cols 2 (lane % 4) + {0, 1})
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// the same, each matrix transposed: register i receives matrix i's
// (rows 2 (lane % 4) + {0, 1}, col lane / 4)
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// d += a * b, m16n8k16, bf16 operands, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a * b, m16n8k8, tf32 operands, f32 accumulators
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x rounded to tf32 (10 mantissa bits), to nearest, ties away from zero;
// the low 13 bits of the result are zero, so it is also an exact f32
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo + O(2^-22 |x|): hi = tf32(x), lo = tf32(x - hi).  x - hi is
// exact in f32.  |x| < 2^11 integers give lo = 0.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x0, x1) = hi + lo + O(2^-16 |x|) in two packed bf16 pairs, x0 in the low
// halves: hi = bf16(x), lo = bf16(x - hi), both rounded to nearest
__device__ __forceinline__ void split_bf16x2(float x0, float x1, uint32_t& hi,
                                             uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = bf16x2_bits(h);
  lo = bf16x2_bits(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

}  // namespace tc
