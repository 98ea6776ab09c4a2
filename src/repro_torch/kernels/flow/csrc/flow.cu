// The flow-level simulator's hot loops for Hopper (sm_90a), written by hand.
//
// They replace no TPU kernel: the reference runs these loops in numpy on the
// host (src/repro/core/compiled_flow.py).  Four kernels, each beside its
// plain PyTorch version in ../ref.py:
//
//   flow_bfs_level          one level of the batched BFS (`_bfs_levels`
//                           :459-565).  For B sources at once, every
//                           undiscovered (source, vertex) key takes the least
//                           `rank(parent) * stride + slot` over its in-edges
//                           whose tail lies in that source's frontier (rank =
//                           the tail's position in the source's frontier,
//                           slot = the edge's position in the tail's
//                           adjacency), masked by edge_ok.  That least key is
//                           the seed deque BFS's first discoverer (FIFO order
//                           x adjacency order), so the trees are the
//                           reference's, and a minimum needs no order: the
//                           result does not depend on the schedule.  Two
//                           forms, chosen by the caller with the reference's
//                           work test (:503):
//                             top-down   one warp per frontier entry walks
//                                        its out-edges and atomicMin's the
//                                        key into each undiscovered head;
//                             bottom-up  one thread per key scans the
//                                        in-edges of its (undiscovered)
//                                        vertex and keeps the least key.
//                           Output: win[key] = the least key, or INT64_MAX.
//   flow_subtree_accumulate the per-level fold of the subtree counts
//                           (`subtree_edge_counts` :631-644,
//                           `_alltoall_edge_counts_impl` :799-803): every key
//                           of one depth adds its count to its parent's count
//                           and to its parent edge's total, with 64-bit
//                           integer atomics (integer sums do not depend on
//                           order: exact, as the reference's float64
//                           bincounts of integers below 2^53 are).
//   flow_orbit_gather       the symmetry sweep's orbit sum
//                           (`_symmetric_alltoall_counts_impl` :1059-1066):
//                           K[r] = sum over the translation group of C at the
//                           edge in the same CSR slot of the translated
//                           vertex, in int64.  One block per (representative
//                           edge, slice of the group), a block reduction,
//                           one atomicAdd a block.
//   flow_ordered_fold       the load fold of `route_demands` (:942-946) at
//                           num_paths=1, which must be bit-identical to the
//                           seed engine's `load[e] += share` loop.  The
//                           caller sorts the demand-ordered edge stream by
//                           edge id with a stable sort; here one thread per
//                           edge sums its run left to right in float64 from
//                           0.0 (__dadd_rn: no contraction, no reordering).
//
// What bounds them on the H100.  All four move bytes and do next to no
// arithmetic: the BFS level reads the frontier, the CSR (or reverse CSR),
// the depths and ranks of the keys it visits and writes win; the others
// read their inputs once and write their outputs once.  The visits are
// gathers at data-dependent addresses (a key's neighbours lie anywhere in
// the B x n key space), so they run at the rate of 32-byte sectors, not of
// whole lines: a simple design that keeps every visit to one load and one
// atomic.  Keys are int64 (B x n passes 2^31 at the 16,384-chip sweep).
//
// C interface (bound with ctypes): pointers, 64-bit ints and the stream;
// each function returns the cudaError_t of its launches.

#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr long long kInf = INT64_MAX;
constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132LL * 64;  // grid-stride beyond this

int blocks_for(long long items, int per_block) {
  long long b = (items + per_block - 1) / per_block;
  if (b < 1) b = 1;
  return static_cast<int>(b < kMaxBlocks ? b : kMaxBlocks);
}

__global__ void fill_kernel(long long* a, long long count, long long value) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < count;
       i += (long long)gridDim.x * blockDim.x)
    a[i] = value;
}

// One warp per frontier entry; its lanes walk the entry's out-edges.
__global__ void bfs_top_down_kernel(const long long* __restrict__ fkeys, long long F,
                                    const long long* __restrict__ rank,
                                    const long long* __restrict__ indptr,
                                    const int* __restrict__ nbr,
                                    const int* __restrict__ depth,
                                    const unsigned char* __restrict__ edge_ok,
                                    unsigned long long* __restrict__ win, long long n,
                                    long long stride) {
  const long long warps = (long long)gridDim.x * blockDim.x / 32;
  const int lane = threadIdx.x & 31;
  for (long long i = (blockIdx.x * (long long)blockDim.x + threadIdx.x) / 32; i < F; i += warps) {
    const long long key = fkeys[i];
    const long long u = key % n;
    const long long base = key - u;
    const long long r = rank[key];
    const long long e0 = indptr[u], e1 = indptr[u + 1];
    for (long long e = e0 + lane; e < e1; e += 32) {
      if (edge_ok != nullptr && !edge_ok[e]) continue;
      const long long ck = base + nbr[e];
      if (depth[ck] != -1) continue;
      atomicMin(&win[ck], static_cast<unsigned long long>(r * stride + (e - e0)));
    }
  }
}

// One thread per key; an undiscovered key scans its vertex's in-edges.
__global__ void bfs_bottom_up_kernel(long long size, long long n,
                                     const long long* __restrict__ rank,
                                     const long long* __restrict__ rev_indptr,
                                     const long long* __restrict__ rev_edge,
                                     const int* __restrict__ edge_src,
                                     const long long* __restrict__ edge_slot,
                                     const int* __restrict__ depth,
                                     const unsigned char* __restrict__ edge_ok,
                                     long long* __restrict__ win, long long stride) {
  for (long long key = blockIdx.x * (long long)blockDim.x + threadIdx.x; key < size;
       key += (long long)gridDim.x * blockDim.x) {
    long long best = kInf;
    if (depth[key] == -1) {
      const long long v = key % n;
      const long long base = key - v;
      const long long j1 = rev_indptr[v + 1];
      for (long long j = rev_indptr[v]; j < j1; ++j) {
        const long long fe = rev_edge[j];
        if (edge_ok != nullptr && !edge_ok[fe]) continue;
        const long long r = rank[base + edge_src[fe]];
        if (r == kInf) continue;  // the tail is not in this source's frontier
        const long long k = r * stride + edge_slot[fe];
        best = k < best ? k : best;
      }
    }
    win[key] = best;
  }
}

__global__ void subtree_kernel(const long long* __restrict__ keys,
                               const long long* __restrict__ epos, long long L,
                               const int* __restrict__ edge_src,
                               unsigned long long* __restrict__ cnt,
                               unsigned long long* __restrict__ K, long long n) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < L;
       i += (long long)gridDim.x * blockDim.x) {
    const long long key = keys[i];
    const unsigned long long w = cnt[key];
    if (w == 0) continue;
    const long long e = epos[i];
    atomicAdd(&K[e], w);
    atomicAdd(&cnt[key - key % n + edge_src[e]], w);
  }
}

// grid (R, slices): block (r, s) sums C over its slice of the group for
// representative edge r, then adds its sum to K[r].
__global__ void orbit_kernel(const long long* __restrict__ C,
                             const long long* __restrict__ indptr,
                             const long long* __restrict__ re_u,
                             const long long* __restrict__ re_slot,
                             const long long* __restrict__ sx,
                             const long long* __restrict__ sy, long long G, long long scale,
                             long long m2, unsigned long long* __restrict__ K) {
  const long long r = blockIdx.x;
  const long long u = re_u[r];
  const long long node = u / m2, chip = u % m2;
  const long long X = node / scale, Y = node % scale;
  const long long slot = re_slot[r];
  long long acc = 0;
  for (long long g = blockIdx.y * (long long)blockDim.x + threadIdx.x; g < G;
       g += (long long)gridDim.y * blockDim.x) {
    const long long u2 = (((X + sx[g]) % scale) * scale + (Y + sy[g]) % scale) * m2 + chip;
    acc += C[indptr[u2] + slot];
  }
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
  __shared__ long long part[kThreads / 32];
  if ((threadIdx.x & 31) == 0) part[threadIdx.x / 32] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    long long s = 0;
    for (int w = 0; w < kThreads / 32; ++w) s += part[w];
    atomicAdd(&K[r], static_cast<unsigned long long>(s));
  }
}

__global__ void fold_kernel(const double* __restrict__ w, const long long* __restrict__ off,
                            long long E, double* __restrict__ load) {
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < E;
       e += (long long)gridDim.x * blockDim.x) {
    double acc = 0.0;
    const long long j1 = off[e + 1];
    for (long long j = off[e]; j < j1; ++j) acc = __dadd_rn(acc, w[j]);
    load[e] = acc;
  }
}

}  // namespace

// fkeys (F,) the frontier's keys b * n + u; rank (B n,) each frontier key's
// position in its source's frontier, INT64_MAX elsewhere; depth (B n,) int32,
// -1 = undiscovered; indptr / rev_indptr (n + 1,), nbr / edge_src (E,) int32,
// rev_edge / edge_slot (E,) int64; edge_ok (E,) uint8 or null; win (B n,)
// int64, written whole.
extern "C" int flow_bfs_level(int bottom_up, const void* fkeys, long long F, const void* rank,
                              const void* depth, const void* indptr, const void* nbr,
                              const void* rev_indptr, const void* rev_edge,
                              const void* edge_src, const void* edge_slot, const void* edge_ok,
                              void* win, long long size, long long n, long long stride,
                              void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* ok = static_cast<const unsigned char*>(edge_ok);
  if (bottom_up) {
    bfs_bottom_up_kernel<<<blocks_for(size, kThreads), kThreads, 0, s>>>(
        size, n, static_cast<const long long*>(rank), static_cast<const long long*>(rev_indptr),
        static_cast<const long long*>(rev_edge), static_cast<const int*>(edge_src),
        static_cast<const long long*>(edge_slot), static_cast<const int*>(depth), ok,
        static_cast<long long*>(win), stride);
    return static_cast<int>(cudaGetLastError());
  }
  fill_kernel<<<blocks_for(size, kThreads), kThreads, 0, s>>>(static_cast<long long*>(win), size,
                                                              kInf);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || F == 0) return static_cast<int>(err);
  bfs_top_down_kernel<<<blocks_for(F, kThreads / 32), kThreads, 0, s>>>(
      static_cast<const long long*>(fkeys), F, static_cast<const long long*>(rank),
      static_cast<const long long*>(indptr), static_cast<const int*>(nbr),
      static_cast<const int*>(depth), ok, static_cast<unsigned long long*>(win), n, stride);
  return static_cast<int>(cudaGetLastError());
}

// keys, epos (L,) int64: one depth's keys and their parent edges; cnt (B n,)
// and K (E,) int64, updated in place.
extern "C" int flow_subtree_accumulate(const void* keys, const void* epos, long long L,
                                       const void* edge_src, void* cnt, void* K, long long n,
                                       void* stream) {
  if (L == 0) return 0;
  subtree_kernel<<<blocks_for(L, kThreads), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(keys), static_cast<const long long*>(epos), L,
      static_cast<const int*>(edge_src), static_cast<unsigned long long*>(cnt),
      static_cast<unsigned long long*>(K), n);
  return static_cast<int>(cudaGetLastError());
}

// C (E,) int64; indptr (n + 1,); re_u, re_slot (R,) int64; sx, sy (G,) int64;
// K (R,) int64, zeroed by the caller.
extern "C" int flow_orbit_gather(const void* C, const void* indptr, const void* re_u,
                                 const void* re_slot, long long R, const void* sx,
                                 const void* sy, long long G, long long scale, long long m2,
                                 void* K, void* stream) {
  if (R == 0 || G == 0) return 0;
  if (R > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  long long slices = (G + kThreads - 1) / kThreads;
  if (slices > 64) slices = 64;
  const dim3 grid(static_cast<unsigned>(R), static_cast<unsigned>(slices));
  orbit_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(C), static_cast<const long long*>(indptr),
      static_cast<const long long*>(re_u), static_cast<const long long*>(re_slot),
      static_cast<const long long*>(sx), static_cast<const long long*>(sy), G, scale, m2,
      static_cast<unsigned long long*>(K));
  return static_cast<int>(cudaGetLastError());
}

// w (L,) float64 sorted stably by edge id; off (E + 1,) int64, the runs'
// bounds; load (E,) float64, written whole.
extern "C" int flow_ordered_fold(const void* w, const void* off, long long E, void* load,
                                 void* stream) {
  if (E == 0) return 0;
  fold_kernel<<<blocks_for(E, kThreads), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(w), static_cast<const long long*>(off), E,
      static_cast<double*>(load));
  return static_cast<int>(cudaGetLastError());
}
