// f32-accurate products on the tensor cores (3xTF32) and cp.async loads,
// shared by the scan kernels (ssd/csrc/ssd_fwd.cu, mlstm/csrc/mlstm_fwd.cu).
//
// 3xTF32.  An f32 operand a is split as a = hi + lo: hi is a with its low 13
// bits cleared (a TF32 value, rounded toward zero) and lo = a - hi, exact in
// f32.  A product a b is then taken as hi_a hi_b + hi_a lo_b + lo_a hi_b,
// accumulated in f32 by mma.sync m16n8k8 (TF32), which reads the top 19 bits
// of each operand register: lo enters truncated to TF32 (2^-10 of lo, below
// 2^-20 of a), and the dropped lo_a lo_b is below 2^-20 of the product, so
// the sum keeps f32 accuracy to ~1e-6 (one TF32 pass keeps ~1e-3).  Two
// instructions a split, where rounding both halves to nearest
// (cvt.rna.tf32.f32, TF32_RNA_SPLIT 1) takes more for ~4x less error.
// kPasses = 1 takes hi_a hi_b alone (the precision ablation).
//
// Fragments of mma.sync.m16n8k8 (PTX ISA, "Matrix fragments for mma.m16n8k8"
// with .tf32), lane = 4 g + q:
//   A (16 x 8, row major): a0 (g, q), a1 (g + 8, q), a2 (g, q + 4), a3 (g + 8, q + 4)
//   B (8 x 8, k x n):      b0 (k = q, n = g), b1 (k = q + 4, n = g)
//   C (16 x 8):            c0 (g, 2q), c1 (g, 2q + 1), c2 (g + 8, 2q), c3 (g + 8, 2q + 1)
// Shared-memory rows read as A (row r = g, column q) are free of bank
// conflicts at a row length of 4 mod 32 floats; rows read as (row q,
// column g) at 8 mod 32.
#pragma once

#include <stdint.h>

#include <cuda_runtime.h>

namespace tf32 {

#ifndef TF32_PASSES
#define TF32_PASSES 3
#endif
constexpr int kPasses = TF32_PASSES;

struct Split {
  uint32_t hi, lo;
};

#ifndef TF32_RNA_SPLIT
#define TF32_RNA_SPLIT 0
#endif

__device__ __forceinline__ uint32_t to_tf32(float x) {
#if TF32_RNA_SPLIT
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
#else
  return __float_as_uint(x) & 0xffffe000u;
#endif
}

__device__ __forceinline__ Split split(float x) {
  Split s;
  s.hi = to_tf32(x);
  if (kPasses == 3) {
    const float r = x - __uint_as_float(s.hi);
    s.lo = TF32_RNA_SPLIT ? to_tf32(r) : __float_as_uint(r);
  } else {
    s.lo = 0u;
  }
  return s;
}

__device__ __forceinline__ void mma1(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                     uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// A operand of one k step: four values, split once and reused across n tiles
struct AFrag {
  Split v[4];
};
struct BFrag {
  Split v[2];
};

__device__ __forceinline__ AFrag a_frag(float a0, float a1, float a2, float a3) {
  return {{split(a0), split(a1), split(a2), split(a3)}};
}

__device__ __forceinline__ BFrag b_frag(float b0, float b1) { return {{split(b0), split(b1)}}; }

// d += a b, f32-accurate: the small terms first, then hi hi
__device__ __forceinline__ void mma(float (&d)[4], const AFrag& a, const BFrag& b) {
  if (kPasses == 3) {
    mma1(d, a.v[0].lo, a.v[1].lo, a.v[2].lo, a.v[3].lo, b.v[0].hi, b.v[1].hi);
    mma1(d, a.v[0].hi, a.v[1].hi, a.v[2].hi, a.v[3].hi, b.v[0].lo, b.v[1].lo);
  }
  mma1(d, a.v[0].hi, a.v[1].hi, a.v[2].hi, a.v[3].hi, b.v[0].hi, b.v[1].hi);
}

// ---- operands split once into shared memory as (hi, lo) pairs ----
// One 8-byte load gives both halves.  Rows of pairs read as A (row g,
// column q) or as B (row q, column g) are both free of bank conflicts at a
// row length of 4 mod 16 pairs.

__device__ __forceinline__ Split ld_split(const float2* p) {
  const float2 v = *p;
  return {__float_as_uint(v.x), __float_as_uint(v.y)};
}

__device__ __forceinline__ AFrag a_frag2(const float2* a0, const float2* a1, const float2* a2,
                                         const float2* a3) {
  return {{ld_split(a0), ld_split(a1), ld_split(a2), ld_split(a3)}};
}

__device__ __forceinline__ BFrag b_frag2(const float2* b0, const float2* b1) {
  return {{ld_split(b0), ld_split(b1)}};
}

// ---- cp.async: global -> shared, zero-filled where the source is cut ----

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes (both addresses 16-byte aligned); bytes past src_bytes are zeroed
__device__ __forceinline__ void cp16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}

// 4 bytes; zero when !valid
__device__ __forceinline__ void cp4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }

template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// A (rows x cols) f32 tile of a row-major source with row stride ld_src into
// shared rows of ld_dst, zero past rows_valid x cols_valid.  vec: the source
// rows and columns are 16-byte aligned (cols_valid and ld_src multiples of 4,
// the base aligned), so whole 16-byte pieces are copied; otherwise floats.
// cols is a multiple of 4.
template <int kThreads>
__device__ __forceinline__ void load_tile(float* dst, int ld_dst, const float* src,
                                          long long ld_src, int rows, int cols, int rows_valid,
                                          int cols_valid, bool vec) {
  const int pieces = cols / 4;
  for (int i = threadIdx.x; i < rows * pieces; i += kThreads) {
    const int r = i / pieces, c = (i % pieces) * 4;
    float* d = dst + r * ld_dst + c;
    const bool row_ok = r < rows_valid;
    const float* s = src + (row_ok ? r * ld_src + c : 0);
    if (vec) {
      const int n = row_ok ? max(0, min(4, cols_valid - c)) : 0;
      cp16(d, n ? s : src, 4 * n);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) cp4(d + j, row_ok && c + j < cols_valid ? s + j : src,
                                      row_ok && c + j < cols_valid);
    }
  }
}

}  // namespace tf32
