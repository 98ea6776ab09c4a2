// The flow-level simulator's hot loops for Hopper (sm_90a), written by hand.
//
// They replace no TPU kernel: the reference runs these loops in numpy on the
// host (src/repro/core/compiled_flow.py).  Four functions, each beside its
// plain PyTorch version in ../ref.py:
//
//   flow_bfs_level          one whole level of the batched BFS (`_bfs_levels`
//                           :459-565), its ranking included, so that the
//                           host reads one small buffer a level and runs no
//                           other op between the levels' launches.
//
//     State.  A BFS of B sources over n vertices keeps keys b * n + v in one
//     queue: the roots, then level 1, level 2, ... each level in (source,
//     parent, slot) order, the seed deque BFS's own order.  `rank[key]` is
//     a discovered key's position in its level (the reference's `fpos`: as
//     the level is grouped by source, the order of a source's candidates is
//     the same as by its position in its own frontier); the frontier is the
//     keys of depth level - 1, so no rank is ever reset.
//     `child[q]` is the queue position of entry q's first child: the levels
//     follow each other and a parent's children are adjacent, so `child` is
//     monotone and the forest is a CSR over queue positions (the fold below
//     reads it).  `win` (B n,) is INT64_MAX at every undiscovered key when a
//     level starts: it is filled once a BFS; the top-down candidate walk
//     writes only undiscovered keys (depth -1), each of which it hands a
//     candidate is discovered in this level, and the bottom-up pass keeps
//     its minima in registers and writes no `win`.  So no level refills it.
//
//     A level runs five kernels on the stream:
//       1. candidates: every undiscovered key takes the least
//          `rank(parent) * stride + slot` over its eligible in-edges from
//          the frontier (slot = the edge's position in the parent's
//          adjacency).  That least key is the seed deque BFS's first
//          discoverer (FIFO order x adjacency order), and a minimum needs no
//          order.  Top-down: one warp a frontier entry walks its out-edges
//          and atomicMin's into `win`; bottom-up: one thread a key scans its
//          vertex's in-edges (tails and slots gathered once into reverse-CSR
//          order), keeps the least key and claims at once (2.).
//       2. claim: each winner sets bit `slot` of its parent's mask (the
//          parent's frontier position is `win / stride`: no offset table),
//          ceil((stride - 1) / 64) words an entry.  Top-down, for a small
//          frontier (its out-edges fewer than a quarter of the B n keys),
//          walks the frontier's out-edges again: the lanes of the entry's
//          warp compare `win[head]` with their own candidates and one ballot
//          makes 32 bits of the word, which one lane stores (only this warp
//          writes the entry's mask); for a large one, one pass streams over
//          the keys and each undiscovered key with a candidate claims with
//          an atomicOr (the walk's dependent gathers cost more than reading
//          every key's depth and win).  Bottom-up: an atomicOr from the
//          key's thread.
//       3. tile sums: the children of each tile of 1,024 entries (__popcll).
//       4. one block scans the tile sums (exclusive) and writes the new
//          level's size into `info[0]`, zeroing `info[1..2]`.
//       5. emit: each tile scans its entries' counts again (a block scan on
//          warp shuffles), adds its tile's offset and writes
//          `child[q] = first child's queue position`; then, bit by bit in
//          slot order, each child's key and discovering edge into the queue,
//          `depth = level`, `rank = position`, and zeroes the mask words it
//          read (the scratch is clean for the next level).  Each block adds
//          its children's out- and in-degrees (one packed word a vertex)
//          into `info[1]` / `info[2]`: the next level's direction test (the
//          reference's work test, :503).
//
//   flow_subtree_accumulate the per-level fold of the subtree counts
//                           (`subtree_edge_counts` :631-644,
//                           `_alltoall_edge_counts_impl` :799-803), level
//                           order: for each entry q of one level, one thread
//                           sums `cnt` over q's children (adjacent, at the
//                           level below, already folded), adds q's own
//                           destination weight, stores `cnt[q]` and adds it
//                           to `K[epos[q]]` with one 64-bit atomic (the
//                           sources of a batch share edges).  PR 29's fold
//                           scattered every key into `cnt[parent]` with a
//                           second atomic; `chip_profile.py flow_ablate`
//                           found that atomic worth 11 % of the fold and the
//                           `K` atomic cheaper than a plain read-modify-write
//                           (PERF.md): the time is in the small levels'
//                           launches and the gathers, so a level is one
//                           launch whose reads of `cnt` and `child` are
//                           contiguous.  Integer sums: exact in any order.
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
// arithmetic: a BFS level reads the frontier, the CSR (or reverse CSR), the
// depths and ranks of the keys it visits, and writes the new level; the
// others read their inputs once and write their outputs once.  The visits
// are gathers at data-dependent addresses (a key's neighbours lie anywhere
// in the B x n key space), so they run at the rate of 32-byte sectors, not
// of whole lines.  Keys are int64 (B x n passes 2^31 at the 16,384-chip
// sweep).
//
// C interface (bound with ctypes): pointers, 64-bit ints and the stream;
// each function returns the cudaError_t of its launches.

#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr long long kInf = INT64_MAX;
constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132LL * 64;  // grid-stride beyond this
constexpr int kScanItems = 4;                 // frontier entries a thread in a tile
constexpr int kTile = kThreads * kScanItems;  // entries a tile (flow.py SCAN_TILE)
constexpr int kSumThreads = 1024;             // the one block that scans the tile sums

int blocks_for(long long items, int per_block) {
  long long b = (items + per_block - 1) / per_block;
  if (b < 1) b = 1;
  return static_cast<int>(b < kMaxBlocks ? b : kMaxBlocks);
}

// Exclusive sum of one value a thread over the block (blockDim.x a multiple
// of 32); *total gets the block's sum.  Every thread of the block calls it.
__device__ long long block_exclusive_sum(long long x, long long* total) {
  __shared__ long long part[33];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  long long incl = x;
  for (int o = 1; o < 32; o <<= 1) {
    const long long y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) part[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const long long w = lane < static_cast<int>(blockDim.x >> 5) ? part[lane] : 0;
    long long wi = w;
    for (int o = 1; o < 32; o <<= 1) {
      const long long y = __shfl_up_sync(0xffffffffu, wi, o);
      if (lane >= o) wi += y;
    }
    part[lane] = wi - w;
    if (lane == 31) part[32] = wi;
  }
  __syncthreads();
  const long long out = part[warp] + incl - x;
  *total = part[32];
  __syncthreads();  // part is read again by the next call
  return out;
}

__device__ int children_of(const unsigned long long* __restrict__ mask, long long i, int W) {
  int c = 0;
  for (int w = 0; w < W; ++w) c += __popcll(mask[i * W + w]);
  return c;
}

// 1. top-down candidates: one warp per frontier entry i (key queue[qs + i],
// rank i); its lanes walk the entry's out-edges.
__global__ void bfs_top_down_kernel(const long long* __restrict__ fkeys, long long F,
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
    const long long e0 = indptr[u], e1 = indptr[u + 1];
    for (long long e = e0 + lane; e < e1; e += 32) {
      if (edge_ok != nullptr && !edge_ok[e]) continue;
      const long long ck = base + nbr[e];
      if (depth[ck] != -1) continue;
      atomicMin(&win[ck], static_cast<unsigned long long>(i * stride + (e - e0)));
    }
  }
}

// 2. top-down claims: the same walk; the edge whose candidate is the head's
// least key sets its slot's bit in entry i's mask (one ballot a 32 slots).
__global__ void bfs_claim_kernel(const long long* __restrict__ fkeys, long long F,
                                 const long long* __restrict__ indptr,
                                 const int* __restrict__ nbr, const int* __restrict__ depth,
                                 const unsigned char* __restrict__ edge_ok,
                                 const long long* __restrict__ win,
                                 unsigned long long* __restrict__ mask, int W, long long n,
                                 long long stride) {
  const long long warps = (long long)gridDim.x * blockDim.x / 32;
  const int lane = threadIdx.x & 31;
  for (long long i = (blockIdx.x * (long long)blockDim.x + threadIdx.x) / 32; i < F; i += warps) {
    const long long key = fkeys[i];
    const long long u = key % n;
    const long long base = key - u;
    const long long e0 = indptr[u], deg = indptr[u + 1] - e0;
    unsigned long long word = 0;
    for (long long s0 = 0; s0 < deg; s0 += 32) {  // the same trip count in every lane
      const long long s = s0 + lane;
      bool hit = false;
      if (s < deg && (edge_ok == nullptr || edge_ok[e0 + s])) {
        const long long ck = base + nbr[e0 + s];
        hit = depth[ck] == -1 && win[ck] == i * stride + s;
      }
      word |= static_cast<unsigned long long>(__ballot_sync(0xffffffffu, hit)) << (s0 & 63);
      if ((s0 & 63) == 32 || s0 + 32 >= deg) {
        if (lane == 0 && word) mask[i * W + (s0 >> 6)] = word;
        word = 0;
      }
    }
  }
}

// 1. and 2. bottom-up: one thread per key, grid (vertices, sources); an
// undiscovered key scans its vertex's in-edges for the least key from the
// frontier (depth level - 1) and claims its bit at once.
__global__ void bfs_bottom_up_kernel(long long n, long long B, int level,
                                     const long long* __restrict__ rank,
                                     const long long* __restrict__ rev_indptr,
                                     const long long* __restrict__ rev_edge,
                                     const int* __restrict__ rev_src,
                                     const int* __restrict__ rev_slot,
                                     const int* __restrict__ depth,
                                     const unsigned char* __restrict__ edge_ok,
                                     unsigned long long* __restrict__ mask, int W,
                                     long long stride) {
  for (long long b = blockIdx.y; b < B; b += gridDim.y) {
    const long long base = b * n;
    for (long long v = blockIdx.x * (long long)blockDim.x + threadIdx.x; v < n;
         v += (long long)gridDim.x * blockDim.x) {
      if (depth[base + v] != -1) continue;
      const long long j1 = rev_indptr[v + 1];
      long long best = kInf;
      for (long long j = rev_indptr[v]; j < j1; ++j) {
        if (edge_ok != nullptr && !edge_ok[rev_edge[j]]) continue;
        const long long tail = base + rev_src[j];
        if (depth[tail] != level - 1) continue;  // not in the frontier
        const long long k = rank[tail] * stride + rev_slot[j];
        best = k < best ? k : best;
      }
      if (best == kInf) continue;
      const long long s = best % stride;
      atomicOr(&mask[(best / stride) * W + (s >> 6)], 1ULL << (s & 63));
    }
  }
}

// 2. top-down claims of a large frontier: one thread per key, grid
// (vertices, sources); an undiscovered key that took a candidate claims it.
__global__ void bfs_claim_dense_kernel(long long n, long long B, const int* __restrict__ depth,
                                       const long long* __restrict__ win,
                                       unsigned long long* __restrict__ mask, int W,
                                       long long stride) {
  for (long long b = blockIdx.y; b < B; b += gridDim.y) {
    const long long base = b * n;
    for (long long v = blockIdx.x * (long long)blockDim.x + threadIdx.x; v < n;
         v += (long long)gridDim.x * blockDim.x) {
      if (depth[base + v] != -1) continue;
      const long long w = win[base + v];
      if (w == kInf) continue;
      const long long s = w % stride;
      atomicOr(&mask[(w / stride) * W + (s >> 6)], 1ULL << (s & 63));
    }
  }
}

// 3. the children of each tile of kTile frontier entries
__global__ void bfs_tile_sums_kernel(const unsigned long long* __restrict__ mask, long long F,
                                     int W, long long* __restrict__ tile_sum) {
  const long long t0 = blockIdx.x * (long long)kTile;
  long long c = 0;
  for (int j = 0; j < kScanItems; ++j) {
    const long long i = t0 + j * kThreads + threadIdx.x;
    if (i < F) c += children_of(mask, i, W);
  }
  long long total;
  block_exclusive_sum(c, &total);
  if (threadIdx.x == 0) tile_sum[blockIdx.x] = total;
}

// 4. the tile sums' exclusive scan in one block; info = (size, 0, 0)
__global__ void bfs_scan_tiles_kernel(long long* __restrict__ tile_sum, long long tiles,
                                      long long* __restrict__ info) {
  long long carry = 0;
  for (long long t0 = 0; t0 < tiles; t0 += blockDim.x) {
    const long long t = t0 + threadIdx.x;
    const long long x = t < tiles ? tile_sum[t] : 0;
    long long total;
    const long long ex = block_exclusive_sum(x, &total);
    if (t < tiles) tile_sum[t] = carry + ex;
    carry += total;
  }
  if (threadIdx.x == 0) {
    info[0] = carry;
    info[1] = 0;
    info[2] = 0;
  }
}

// 5. emit: entry i's children at positions offset(i) + 0, 1, ... of the new
// level, in slot order; the new level starts at queue position qs + F.
__global__ void bfs_emit_kernel(long long* __restrict__ queue, long long* __restrict__ qepos,
                                long long* __restrict__ child, long long qs, long long F,
                                const long long* __restrict__ indptr,
                                const int* __restrict__ nbr,
                                const unsigned long long* __restrict__ deg,
                                unsigned long long* __restrict__ mask, int W,
                                const long long* __restrict__ tile_sum,
                                long long* __restrict__ rank, int* __restrict__ depth,
                                unsigned long long* __restrict__ info, long long n, int level) {
  const long long t0 = blockIdx.x * (long long)kTile;
  const long long out = qs + F;
  long long carry = tile_sum[blockIdx.x];
  long long out_deg = 0, in_deg = 0;
  for (int j = 0; j < kScanItems; ++j) {
    const long long i = t0 + j * kThreads + threadIdx.x;
    const int c = i < F ? children_of(mask, i, W) : 0;
    long long total;
    long long pos = carry + block_exclusive_sum(c, &total);
    carry += total;
    if (i >= F) continue;
    child[qs + i] = out + pos;
    if (c == 0) continue;
    const long long key = queue[qs + i];
    const long long u = key % n;
    const long long base = key - u, e0 = indptr[u];
    for (int w = 0; w < W; ++w) {
      unsigned long long m = mask[i * W + w];
      if (m == 0) continue;
      mask[i * W + w] = 0;
      while (m) {
        const long long e = e0 + w * 64 + (__ffsll(static_cast<long long>(m)) - 1);
        m &= m - 1;
        const long long v = nbr[e];
        const long long ck = base + v;
        queue[out + pos] = ck;
        qepos[out + pos] = e;
        depth[ck] = level;
        rank[ck] = pos;
        const unsigned long long dv = deg[v];  // out-degree << 32 | in-degree
        out_deg += static_cast<long long>(dv >> 32);
        in_deg += static_cast<long long>(dv & 0xffffffffULL);
        ++pos;
      }
    }
  }
  long long total;
  block_exclusive_sum(out_deg, &total);
  if (threadIdx.x == 0 && total) atomicAdd(&info[1], static_cast<unsigned long long>(total));
  block_exclusive_sum(in_deg, &total);
  if (threadIdx.x == 0 && total) atomicAdd(&info[2], static_cast<unsigned long long>(total));
}

// One level's fold: entries q in [qs, qs + L) of the queue
__global__ void subtree_sum_kernel(const long long* __restrict__ queue,
                                    const long long* __restrict__ qepos,
                                    const long long* __restrict__ child, long long qs,
                                    long long L, const long long* __restrict__ dest,
                                    long long* __restrict__ cnt,
                                    unsigned long long* __restrict__ K, long long n) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < L;
       i += (long long)gridDim.x * blockDim.x) {
    const long long q = qs + i;
    long long c = dest[queue[q] % n];
    const long long j1 = child[q + 1];
    for (long long j = child[q]; j < j1; ++j) c += cnt[j];
    cnt[q] = c;
    if (c != 0) atomicAdd(&K[qepos[q]], static_cast<unsigned long long>(c));
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

// One BFS level.  queue, qepos (B n,) int64: the keys level by level and
// their discovering edges; the frontier is queue[qs, qs + F) and the new
// level is written from qs + F; child (B n + 1,) int64: child[qs + i] is
// written for every frontier entry.  rank (B n,) int64: each discovered
// key's position in its level (the new level's written); depth (B n,)
// int32, -1 = undiscovered, the frontier's level - 1 (the new level's set
// to `level`); win (B n,) int64, INT64_MAX at every undiscovered key;
// indptr / rev_indptr (n + 1,) int64, nbr (E,) int32; rev_edge (E,) int64,
// rev_src / rev_slot (E,) int32: each in-edge's CSR id, tail and slot in
// reverse-CSR order; deg (n,) int64 out-degree << 32 | in-degree; edge_ok
// (E,) uint8 or null; frontier_edges the frontier's out-degree sum (it
// picks the claim); scratch int64: ceil(size / kTile) tile sums, then
// size * W mask words, all zero (left zero); info (3,) int64 <- the new
// level's size and the sums of its vertices' out- and in-degrees.
extern "C" int flow_bfs_level(int bottom_up, int level, void* queue, void* qepos, void* child,
                              long long qs, long long F, void* rank, void* depth, void* win,
                              const void* indptr, const void* nbr, const void* rev_indptr,
                              const void* rev_edge, const void* rev_src, const void* rev_slot,
                              const void* deg, const void* edge_ok, long long frontier_edges,
                              void* scratch, void* info, long long size, long long n,
                              long long stride, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* ok = static_cast<const unsigned char*>(edge_ok);
  const auto* ip = static_cast<const long long*>(indptr);
  const auto* nb = static_cast<const int*>(nbr);
  auto* dep = static_cast<int*>(depth);
  auto* q = static_cast<long long*>(queue);
  const int W = static_cast<int>((stride + 62) / 64);
  auto* tile_sum = static_cast<long long*>(scratch);
  auto* mask = reinterpret_cast<unsigned long long*>(tile_sum + (size + kTile - 1) / kTile);
  const long long tiles = (F + kTile - 1) / kTile;
  const long long B = n > 0 ? size / n : 0;
  // (vertices, sources) grids of the passes over every key
  const dim3 keys_grid(static_cast<unsigned>(n > 0 ? (n + kThreads - 1) / kThreads : 1),
                       static_cast<unsigned>(B < 65535 ? (B > 0 ? B : 1) : 65535));
  cudaError_t err = cudaSuccess;
  if (F > 0) {
    if (bottom_up) {
      bfs_bottom_up_kernel<<<keys_grid, kThreads, 0, s>>>(
          n, B, level, static_cast<const long long*>(rank),
          static_cast<const long long*>(rev_indptr), static_cast<const long long*>(rev_edge),
          static_cast<const int*>(rev_src), static_cast<const int*>(rev_slot), dep, ok, mask, W,
          stride);
    } else {
      bfs_top_down_kernel<<<blocks_for(F, kThreads / 32), kThreads, 0, s>>>(
          q + qs, F, ip, nb, dep, ok, static_cast<unsigned long long*>(win), n, stride);
      if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
      if (size <= 4 * frontier_edges) {
        bfs_claim_dense_kernel<<<keys_grid, kThreads, 0, s>>>(
            n, B, dep, static_cast<const long long*>(win), mask, W, stride);
      } else {
        bfs_claim_kernel<<<blocks_for(F, kThreads / 32), kThreads, 0, s>>>(
            q + qs, F, ip, nb, dep, ok, static_cast<const long long*>(win), mask, W, n, stride);
      }
    }
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    bfs_tile_sums_kernel<<<static_cast<unsigned>(tiles), kThreads, 0, s>>>(mask, F, W, tile_sum);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  bfs_scan_tiles_kernel<<<1, kSumThreads, 0, s>>>(tile_sum, tiles,
                                                  static_cast<long long*>(info));
  if ((err = cudaGetLastError()) != cudaSuccess || F == 0) return static_cast<int>(err);
  bfs_emit_kernel<<<static_cast<unsigned>(tiles), kThreads, 0, s>>>(
      q, static_cast<long long*>(qepos), static_cast<long long*>(child), qs, F, ip, nb,
      static_cast<const unsigned long long*>(deg), mask, W, tile_sum,
      static_cast<long long*>(rank), dep, static_cast<unsigned long long*>(info), n, level);
  return static_cast<int>(cudaGetLastError());
}

// One level's fold.  queue, qepos (B n,), child (B n + 1,) int64 as
// flow_bfs_level leaves them; the level is queue[qs, qs + L); dest (n,)
// int64 each vertex's destination weight; cnt int64 indexed by queue
// position: the level below already folded, this level's written; K (E,)
// int64, added to.
extern "C" int flow_subtree_accumulate(const void* queue, const void* qepos, const void* child,
                                       long long qs, long long L, const void* dest, void* cnt,
                                       void* K, long long n, void* stream) {
  if (L == 0) return 0;
  subtree_sum_kernel<<<blocks_for(L, kThreads), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(queue), static_cast<const long long*>(qepos),
      static_cast<const long long*>(child), qs, L, static_cast<const long long*>(dest),
      static_cast<long long*>(cnt), static_cast<unsigned long long*>(K), n);
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
