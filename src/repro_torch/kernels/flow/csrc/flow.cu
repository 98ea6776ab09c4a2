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
//                           vertex, in int64 (exact in any order).  The
//                           orbit of the representative block (X, Y < step)
//                           tiles the grid and every translate by step keeps
//                           each vertex's degree and slot order, so C read
//                           in CSR order is, for each residue x0 = X mod
//                           step, a (G, P[x0]) matrix: the grid row X = x0 +
//                           step X' starts at edge per (X' R + B[x0]) (per =
//                           scale / step, B[x0] = P[0] + ... + P[x0 - 1]), its
//                           period of step nodes at Y = k step starts P[x0]
//                           further per k, and column c of it is
//                           representative edge B[x0] + c.  So K is a column
//                           sum read once, coalesced, with no gather: a
//                           block sums a slice of the rows for a tile of
//                           columns in registers and adds each column to K
//                           with one atomic.  P and B come from indptr at the
//                           2 step vertices (x0, 0, 0) and (x0, step, 0).
//   flow_ordered_fold       the load fold of `route_demands` (:942-946) at
//                           num_paths=1, which must be bit-identical to the
//                           seed engine's `load[e] += share` loop.  The
//                           caller sorts the demand-ordered edge stream by
//                           edge id with a stable sort; each edge's run is
//                           summed left to right in float64 from 0.0
//                           (__dadd_rn: no contraction, no reordering), so a
//                           run is one dependent chain and its length is the
//                           floor.  A block takes the edges whose runs start
//                           in its span of kFoldSpan stream elements (a warp
//                           searches `off` 32 ways), stages their runs
//                           through shared memory in chunks of kFoldChunk
//                           (cp.async, two buffers: the next chunk lands
//                           while this one is summed), and each thread
//                           chains its edge's adds from shared memory; the
//                           one run that crosses a chunk's end carries its
//                           partial sum to the next chunk.
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

constexpr int kOrbitCols = 4;                         // columns a thread
constexpr int kOrbitTile = kThreads * kOrbitCols;      // columns a block
constexpr int kOrbitRows = 4;                          // rows whose loads are in flight together
constexpr long long kOrbitBlocks = 132LL * 2;          // blocks of a call, over residues and tiles

// grid (tiles x slices, step): block (t + tiles s, x0) sums rows [s rows,
// (s + 1) rows) of residue x0's (G, P) matrix (row g = X' per + k) at the
// columns c = t kOrbitTile + threadIdx.x + j kThreads, then adds each to
// K[B + c].
__global__ void orbit_kernel(const long long* __restrict__ C,
                             const long long* __restrict__ indptr, long long R, long long per,
                             long long scale, long long step, long long m2, int tiles,
                             long long rows, unsigned long long* __restrict__ K) {
  const long long x0 = blockIdx.y;
  const long long tile = blockIdx.x % tiles, slice = blockIdx.x / tiles;
  const long long row_v = scale * m2;  // vertices of a grid row X
  long long B = 0;
  for (long long x = 0; x < x0; ++x) B += indptr[x * row_v + step * m2] - indptr[x * row_v];
  long long P = indptr[x0 * row_v + step * m2] - indptr[x0 * row_v];
  // the caller checks E == G R; were indptr not invariant under the
  // translations, the columns past R would still be neither read nor written
  if (P > R - B) P = R - B;
  const long long c0 = tile * kOrbitTile + threadIdx.x;
  if (tile * kOrbitTile >= P) return;  // the whole block
  const long long G = per * per;
  const long long g0 = slice * rows, g1 = g0 + rows < G ? g0 + rows : G;
  long long acc[kOrbitCols] = {};
  long long Xp = g0 / per, k = g0 % per;  // row g0; then counted, not divided
  const long long* row = C + per * (Xp * R + B) + k * P;
  for (long long g = g0; g < g1; g += kOrbitRows) {
    long long x[kOrbitRows][kOrbitCols];
#pragma unroll
    for (int i = 0; i < kOrbitRows; ++i) {
#pragma unroll
      for (int j = 0; j < kOrbitCols; ++j) {
        const long long c = c0 + j * kThreads;
        x[i][j] = g + i < g1 && c < P ? row[c] : 0;
      }
      if (++k == per) {  // the next grid row of this residue
        k = 0;
        ++Xp;
        row = C + per * (Xp * R + B);
      } else {
        row += P;
      }
    }
#pragma unroll
    for (int i = 0; i < kOrbitRows; ++i)
#pragma unroll
      for (int j = 0; j < kOrbitCols; ++j) acc[j] += x[i][j];
  }
#pragma unroll
  for (int j = 0; j < kOrbitCols; ++j) {
    const long long c = c0 + j * kThreads;
    if (c < P && acc[j] != 0) atomicAdd(&K[B + c], static_cast<unsigned long long>(acc[j]));
  }
}

constexpr int kFoldThreads = 128;
constexpr long long kFoldSpan = 1024;  // stream elements whose runs a block starts
constexpr int kFoldChunk = 2048;       // elements a staging buffer (two: 32 KB)
constexpr int kFoldAhead = 8;          // weights in registers ahead of a run's adds

// The first i in [0, n) with a[i] >= x (a nondecreasing), n if none; every
// lane of the warp calls it and gets the answer: each round probes 32
// positions and keeps the stretch between the last one below x and the
// first one not below it.
__device__ long long warp_lower_bound(const long long* __restrict__ a, long long n, long long x) {
  const int lane = threadIdx.x & 31;
  long long lo = 0, hi = n;  // the answer lies in [lo, hi]
  while (lo < hi) {
    const long long step = (hi - lo + 31) / 32;
    const long long p = lo + (lane + 1) * step - 1;
    const bool ge = p >= hi || a[p] >= x;
    const unsigned m = __ballot_sync(0xffffffffu, ge);
    if (m == 0) return hi;  // every probe below x: the last one is hi - 1
    const int k = __ffs(m) - 1;
    const long long pk = lo + (k + 1) * step - 1;
    lo += k * step;
    if (pk < hi) hi = pk;
  }
  return lo;
}

__device__ __forceinline__ void stage8(double* dst, const double* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src));
}

// Block b folds the edges whose runs start in [b kFoldSpan, (b + 1)
// kFoldSpan) (the last block also those starting at L: empty runs).  Its
// chunks are aligned at b kFoldSpan, so the first one is staged while two
// warps search `off` for the block's edges.
__global__ void fold_kernel(const double* __restrict__ w, long long L,
                            const long long* __restrict__ off, long long E,
                            double* __restrict__ load) {
  __shared__ double buf[2][kFoldChunk];
  __shared__ long long range[2];
  __shared__ double carry[2];  // the crossing run's partial sum, by chunk parity
  const long long base = static_cast<long long>(blockIdx.x) * kFoldSpan;
  long long end = L;           // staged up to here: L until the block's span is known
  auto stage = [&](long long c) {
    const long long cs = base + c * kFoldChunk;
    const long long len = end - cs < kFoldChunk ? end - cs : kFoldChunk;
    for (long long i = threadIdx.x; i < len; i += kFoldThreads) stage8(&buf[c & 1][i], w + cs + i);
    asm volatile("cp.async.commit_group;\n" ::);
  };
  stage(0);
  const int warp = threadIdx.x >> 5;
  if (warp < 2) {
    const long long x = base + warp * kFoldSpan;
    const long long i = warp == 1 && blockIdx.x + 1 == gridDim.x ? E : warp_lower_bound(off, E, x);
    if ((threadIdx.x & 31) == 0) range[warp] = i;
  }
  __syncthreads();
  const long long e_lo = range[0], e_hi = range[1];
  if (e_lo >= e_hi) {
    asm volatile("cp.async.wait_all;\n" ::);
    return;
  }
  const long long e0 = e_lo + threadIdx.x;  // this thread's first edge, its run read ahead
  const long long f0 = e0 < e_hi ? off[e0] : 0, f1 = e0 < e_hi ? off[e0 + 1] : 0;
  end = off[e_hi];
  const long long span = end > base ? end - base : 0;
  const long long chunks = span > kFoldChunk ? (span + kFoldChunk - 1) / kFoldChunk : 1;
  for (long long c = 0; c < chunks; ++c) {
    if (c + 1 < chunks) {
      stage(c + 1);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
    const long long cs = base + c * kFoldChunk, ce = cs + kFoldChunk;
    const double* s = buf[c & 1];
    for (long long e = e0; e < e_hi; e += kFoldThreads) {
      const long long r0 = e == e0 ? f0 : off[e], r1 = e == e0 ? f1 : off[e + 1];
      if (r0 == r1) {
        if (c == 0) load[e] = 0.0;
        continue;
      }
      if (r1 <= cs || r0 >= ce) continue;
      double acc = r0 < cs ? carry[c & 1] : 0.0;
      const int j0 = static_cast<int>((r0 > cs ? r0 : cs) - cs);
      const int j1 = static_cast<int>((r1 < ce ? r1 : ce) - cs);
      // the next kFoldAhead weights are read while these are added, so
      // only the dependent adds set the pace
      double x[kFoldAhead];
#pragma unroll
      for (int k = 0; k < kFoldAhead; ++k) x[k] = j0 + k < j1 ? s[j0 + k] : 0.0;
      for (int j = j0; j < j1; j += kFoldAhead) {
        double y[kFoldAhead];
#pragma unroll
        for (int k = 0; k < kFoldAhead; ++k)
          y[k] = j + kFoldAhead + k < j1 ? s[j + kFoldAhead + k] : 0.0;
#pragma unroll
        for (int k = 0; k < kFoldAhead; ++k) {
          if (j + k < j1) acc = __dadd_rn(acc, x[k]);
          x[k] = y[k];
        }
      }
      if (r1 > ce) {
        carry[(c + 1) & 1] = acc;
      } else {
        load[e] = acc;
      }
    }
    __syncthreads();
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

// C (E,) int64 over n = scale^2 m2 vertices laid out ((X scale + Y) m2 +
// chip), invariant under translations by step; indptr (n + 1,) int64; R
// the representative edges (every CSR edge of the block X, Y < step, in
// CSR order), so E == (scale / step)^2 R, which the caller checks; K (R,)
// int64, zeroed by the caller.
extern "C" int flow_orbit_gather(const void* C, const void* indptr, long long R, long long scale,
                                 long long step, long long m2, void* K, void* stream) {
  if (R == 0) return 0;
  if (step < 1 || scale % step) return static_cast<int>(cudaErrorInvalidValue);
  const long long per = scale / step, G = per * per;
  // the widest residue has at most R columns
  const long long tiles = (R + kOrbitTile - 1) / kOrbitTile;
  if (tiles * kOrbitBlocks > INT32_MAX || step > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  long long slices = kOrbitBlocks / (step * tiles);
  if (slices < 1) slices = 1;
  if (slices > G) slices = G;
  const long long rows = (G + slices - 1) / slices;
  slices = (G + rows - 1) / rows;
  const dim3 grid(static_cast<unsigned>(tiles * slices), static_cast<unsigned>(step));
  orbit_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(C), static_cast<const long long*>(indptr), R, per, scale,
      step, m2, static_cast<int>(tiles), rows, static_cast<unsigned long long*>(K));
  return static_cast<int>(cudaGetLastError());
}

// w (L,) float64 sorted stably by edge id; off (E + 1,) int64, the runs'
// bounds, off[E] == L; load (E,) float64, written whole.
extern "C" int flow_ordered_fold(const void* w, long long L, const void* off, long long E,
                                 void* load, void* stream) {
  if (E == 0) return 0;
  const long long blocks = L > 0 ? (L + kFoldSpan - 1) / kFoldSpan : 1;
  if (blocks > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  fold_kernel<<<static_cast<unsigned>(blocks), kFoldThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(w), L, static_cast<const long long*>(off), E,
      static_cast<double*>(load));
  return static_cast<int>(cudaGetLastError());
}
