// Pieces shared by the flash-attention kernels (flash_fwd.cu, flash_bwd.cu):
// the causal / window / ragged masking rules of the TPU kernels, and the
// Hopper building blocks of the bf16 paths (ldmatrix, mma.sync m16n8k16,
// cp.async).  `P` is a kernel's parameter struct; it has the fields Sq, Skv,
// causal, has_window, window and q_offset.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

constexpr float kMasked = -1e30f;

// Keys [k_lo, k_hi) that query rows [r0, r1) of one block can see.
template <class P>
__device__ __forceinline__ void key_range(const P& p, int r0, int r1, int& k_lo, int& k_hi) {
  const int qmin = r0 + p.q_offset, qmax = r1 - 1 + p.q_offset;
  k_lo = 0;
  k_hi = p.Skv;
  // the last row sees no key: walk every key, as the TPU grid does
  if (p.has_window && qmax - p.window + 1 >= p.Skv) return;
  if (p.has_window) k_lo = max(0, qmin - p.window + 1);
  if (p.causal) k_hi = min(p.Skv, qmax + 1);
}

// Whether keys [n0, n0 + n) need the per-element mask for rows [r0, r1).
template <class P>
__device__ __forceinline__ bool tile_needs_mask(const P& p, int n0, int n, int r0, int r1) {
  const int qmin = r0 + p.q_offset, qmax = r1 - 1 + p.q_offset;
  return n0 + n > p.Skv || (p.causal && n0 + n - 1 > qmin) ||
         (p.has_window && n0 <= qmax - p.window);
}

// Whether the query at absolute position qpos sees key `key` (< Skv).
template <class P>
__device__ __forceinline__ bool visible(const P& p, int qpos, int key) {
  return key < p.Skv && (!p.causal || key <= qpos) && (!p.has_window || key > qpos - p.window);
}

// A query row that sees no key at all (only a window can cause it, since
// q_offset >= 0 keeps key 0 in every causal row's reach).
template <class P>
__device__ __forceinline__ bool sees_no_key(const P& p, int qpos) {
  return p.has_window && qpos - p.window + 1 >= p.Skv;
}

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* ptr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(ptr)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* ptr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(ptr)));
}

// d (16x8 f32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A wgmma accumulator fragment (64 x N) to bf16 in the layout of wgmma's
// register A operand: columns 16j .. 16j + 15 are k step j's A fragment.
template <int N>
__device__ __forceinline__ void pack_a(const float (&s)[N / 2], uint32_t (&a)[N / 16][4]) {
#pragma unroll
  for (int j = 0; j < N / 16; ++j) {
    a[j][0] = pack_bf16(s[8 * j], s[8 * j + 1]);
    a[j][1] = pack_bf16(s[8 * j + 2], s[8 * j + 3]);
    a[j][2] = pack_bf16(s[8 * j + 4], s[8 * j + 5]);
    a[j][3] = pack_bf16(s[8 * j + 6], s[8 * j + 7]);
  }
}

// The fragment loads of a (rows, LD)-pitched bf16 tile in shared memory, for
// a warp.  mma A operand: rows [m0, m0 + 16) x cols [k0, k0 + 16).
template <int LD>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* t, int m0, int k0,
                                       int lane) {
  ldmatrix_x4(a, t + (m0 + (lane % 8) + ((lane / 8) % 2) * 8) * LD + k0 + (lane / 16) * 8);
}

// mma B operands of X * T^T, T stored [n][k]: n [n0, n0 + 16) x k [k0, k0 + 16);
// b[0..1] are the n-tile n0, b[2..3] the n-tile n0 + 8.
template <int LD>
__device__ __forceinline__ void load_b_nk(uint32_t (&b)[4], const __nv_bfloat16* t, int n0, int k0,
                                          int lane) {
  ldmatrix_x4(b, t + (n0 + (lane % 8) + (lane / 16) * 8) * LD + k0 + ((lane / 8) % 2) * 8);
}

// mma B operands of X * T, T stored [k][n]: k [k0, k0 + 16) x n [n0, n0 + 16);
// b[0..1] are the n-tile n0, b[2..3] the n-tile n0 + 8.
template <int LD>
__device__ __forceinline__ void load_b_kn(uint32_t (&b)[4], const __nv_bfloat16* t, int k0, int n0,
                                          int lane) {
  ldmatrix_x4_trans(b, t + (k0 + (lane % 8) + ((lane / 8) % 2) * 8) * LD + n0 + (lane / 16) * 8);
}

// 16-byte asynchronous copy global -> shared; src-size 0 zero-fills.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Start copying rows [row0, row0 + ROWS) of a (rows, D) slab with row stride
// `stride` into shared memory with row pitch D + 8 (bank-conflict-free for
// ldmatrix), using THREADS threads; rows at or past `limit` are zero-filled.
template <int D, int ROWS, int THREADS>
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                               long long stride, int row0, int limit) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  constexpr int LD = D + 8;
#pragma unroll
  for (int c = threadIdx.x; c < ROWS * kChunks; c += THREADS) {
    const int r = c / kChunks, col = (c % kChunks) * 8;
    const bool valid = row0 + r < limit;
    // an invalid row reads nothing, but its address stays inside the slab
    cp_async16(dst + r * LD + col, src + (long long)(valid ? row0 + r : 0) * stride + col, valid);
  }
}

}  // namespace flash
