// Flash-attention backward for Hopper (sm_90a), written by hand: two kernels.
//
// Replaces the TPU kernels of src/repro/kernels/flash_attention/
// flash_attention.py reached through `flash_attention_bwd` (:242-312):
//   * flash_bwd_dq  <- `_flash_bwd_dq_kernel` (:121-156, called at :261):
//       dq = scale * sum_k dS K,   dS = P o (dO V^T - delta)
//   * flash_bwd_dkv <- `_flash_bwd_dkv_kernel` (:159-197, called at :281):
//       dV = P^T dO,   dK = scale * dS^T Q
// with P = exp(scale * Q K^T - lse) rebuilt from the forward's lse
// (csrc/flash_fwd.cu) and delta = rowsum(O o dO), which the wrapper computes
// outside the kernels as the reference does (:257-259).  Masking, GQA (query
// head h reads kv head h / (H / Hk)), q_offset, ragged Sq / Skv and the
// strides are those of flash_fwd.cu.  Both kernels recompute S = Q K^T, the
// reference's split; no atomics, so every sum has one fixed order and two
// calls on the same inputs give the same bits.
//
// What bounds it on the H100: at the training shape (B=4, H=24, Hk=8,
// S=1024, Dh=128, bf16, causal) dq does 6 Dh and dk/dv 8 Dh FLOP per visible
// (q, k) pair, 3.9e10 and 5.2e10 FLOP, 0.0391 and 0.0522 ms at 989 TFLOP/s,
// against ~0.1 GB of operands (30 us at 3.35 TB/s): the operations bound
// both, and only wgmma reaches the tensor cores' rate on this card.  At
// gemma3-4b's training shape (B 2, H 8, Hk 4, S 2048, Dh 320, causal) dq
// does 6.445e10 FLOP (0.0652 ms) and dk/dv 8.594e10 (0.0869 ms; 0.0489 and
// 0.0652 with the local layers' window of 1024) against ~84 MB (0.025 ms):
// the operations again.
//
// The design for bf16 at Dh in {64, 128, 320} is the forward's:
// persistent kernels, one block of three warpgroups per SM, walking work
// items heaviest first in snake order over the blocks.  Warpgroup 0 is the
// producer (setmaxnreg 24; 40 in dk/dv, whose producer warp also stages lse
// and delta) issuing TMA loads through 4-D tensor maps (Dh, S, H, B) of
// strided views, so the kernel-layout tensors and the transposed views of
// (B, S, H, Dh) that the model passes both load as 128-byte-swizzled
// 64-column slabs, zero-filled past Sq or Skv.  Warpgroups 1 and 2 are the
// consumers (setmaxnreg 240; 232 in dk/dv), running every product on wgmma
// with f32 accumulators in registers; P and dS are rounded to bf16 as
// operands, as the forward's P V does.
//   * dq (DqTiles): an item is a q tile of one (head, batch), whose Q and dO
//     tiles load once while K and V tiles stream through a two-stage ring.
//     A step is S = Q K^T and dP = dO V^T (wgmma, both operands K-major in
//     shared memory), dS = P o (dP - delta) on the fragments (one FFMA, one
//     ex2 and two more a score; branch-free masks on edge tiles only), then
//     dQ += dS K with dS packed to bf16 in registers as the A operand and K
//     read MN-major.  V is released as soon as dP has read it, K after dS K
//     (each has its own `empty` barrier).  lse and delta of the item's rows
//     stay in registers.
//     - Dh 64 / 128: 128-row items, 64 rows a consumer; both consumers read
//       every 128-key tile (m64n128).
//     - Dh 320: a consumer's 64 x 320 dQ is 160 f32 registers a thread, so
//       S and dP fit beside it only for a few keys (48: 24 + 24, and 12 of
//       packed dS, under 240).  Each step's SS products read the consumer's
//       64 rows of Q and dO (80 KB) as A operands however few keys it
//       covers, so narrow tiles leave the step bound by shared-memory reads;
//       and 128-row items (Q and dO 160 KB) would leave room for no more
//       than 16-key K/V stages.  So an item is 64 rows and the two consumers
//       split its key tiles: the ring's even tiles go to consumer 0, its odd
//       ones to consumer 1 (the ring's two stages are one a consumer), each
//       accumulates a partial dQ of all 64 rows over its keys, and at the
//       item's end consumer 1 hands its partial to consumer 0 through
//       shared memory, one 64 x 64 f32 slab at a time, which adds it to its
//       own (one fixed order) and stores dQ.  Q and dO (80 KB), two stages of
//       48-key K and V (120 KB) and the 16 KB slab take 217 KB.  512 items
//       at gemma3-4b's training shape (3.9 rounds on 132 SMs).  The
//       mma.sync design it replaces (8 warps of 16 rows, Q and dO read again
//       by ldmatrix for every 16-key tile, not persistent) reached 10.5 % of
//       the bound.
//   * dk/dv: an item is a key tile of one (kv head, batch), whose K and V
//     stay in shared memory for the whole item.  The producer streams
//     (query head of the group, q tile) steps through a ring (DkvTiles): Q
//     and dO by TMA, the rows' lse (times log2 e) and delta stored by the
//     producer warp's lanes, all behind one `full` barrier.  P^T and dS^T
//     are formed on the fragments with lse / delta indexed by column, and
//     dV += P^T dO and dK += dS^T Q run from registers with Q and dO read
//     MN-major.  The GQA sum over the group's query heads happens in those
//     accumulators: no (B, H, Skv, Dh) intermediates.
//     - Dh 64 / 128: 128-key items, 64 keys a consumer, 64-row steps in a
//       ring of three; each consumer runs S^T = K Q^T and dP^T = V dO^T
//       (m64n64) and both accumulations for its keys.
//     - Dh 320: dK and dV of 64 keys x 320 would be 320 f32 registers a
//       thread, and 160 columns a consumer would make the products' B
//       operand start halfway through a 64-column swizzled slab.  So the
//       consumers share an item of 64 keys and split the work by output:
//       consumer 0 runs S^T (m64n48 over the step's 48 rows), forms P^T,
//       passes it in f32 to consumer 1 through shared memory and runs dV +=
//       P^T dO; consumer 1 runs dP^T, forms dS^T from the P^T it receives
//       and runs dK += dS^T Q.  Each holds one 160-register accumulator and
//       executes half of the 8 Dh FLOP a visible pair, on whole slabs (n128
//       + n128 + n64 a k step).  K, V and a ring of two stages of 48-row Q
//       and dO take 200 KB.  The mma.sync design it replaces (two warps a
//       16-key row, each computing S^T and dP^T whole, 12 Dh FLOP a pair)
//       reached 6.5 % of the bound.
// Each consumer waits for its products before it goes on (wgmma_wait<0>), so
// the number of committed groups never varies inside a loop and the
// compiler keeps the products asynchronous; the overlap comes from the
// other consumer, whose products run while this one's elementwise work
// does (named barriers making the two take turns, as the forward's do,
// changed nothing here).  dQ, dK and dV are stored from registers.  Not done: dQ
// fused into the dk/dv pass (atomics), delta folded into a kernel, K/V
// shared by a cluster (TMA multicast), a second K/V buffer for dk/dv.
//
// bf16 at Dh in {16, 32} (card tests and small cases only) keeps the first
// design: mma.sync m16n8k16 from ldmatrix fragments, tiles
// double-buffered with cp.async, one 4-warp block per 64-row (dq) or 64-key
// (dk/dv) tile; dk/dv computes S^T and dP^T directly so that the
// accumulators feed the next products.
//
// f32 is every config's default dtype (configs/base.py: param_dtype and
// compute_dtype), so a model trained at its own dtype with attn_impl "flash"
// runs the f32 kernels on every attention layer of every step (the full-size
// phases of chip_smoke.py choose bf16).  They must keep f32 accuracy, and
// the fastest f32-accurate route on this card is 3xTF32 on the tensor cores
// (three TF32 products a product, 495 / 3 = 165 TFLOP/s; f32 outside them
// is 67): at llama3.2-3b's training shape in f32 dq's 3.87e10 FLOP take
// 0.235 ms there and dk/dv's 5.16e10 0.313 ms, against ~0.19 GB (0.06 ms),
// so the operations bound both.  So: mma.sync m16n8k8 in 3xTF32
// (tf32_mma.cuh), in the pattern of the f32 forward (flash_fwd.cu), whose
// rules they keep: no sum runs long through the tensor cores, which truncate
// as they accumulate (scores summed 4 k steps at a time, the products into
// dQ, dK and dV one step's keys or rows at a time, each then added in f32);
// no warp holds more than 80 accumulator registers at Dh 320; and where the
// blocks would leave the card idle, the work is split across blocks and a
// second kernel sums the partials in one fixed order.
//   * dq (flash_bwd_dq_tf32_kernel): the forward's blocks, 64 q rows and two
//     warps a 16-row strip, each summing half of every S and dP score's head
//     dims and holding half of dQ's columns; the keys split across blocks
//     (flash_attention.f32_key_split; flash_bwd_dq_combine_kernel).
//   * dk/dv (flash_bwd_dkv_tf32_kernel): blocks of 64 keys (32 at Dh 320),
//     walking q rows in steps; a 16-key strip's warps split the work by
//     output (a warp forms S^T, P^T and dV, its partner dP^T, dS^T and dK,
//     P^T passing through shared memory) and at Dh 320 by columns too; the
//     group's heads and the rows split across blocks where the key tiles
//     alone leave the card idle (flash_attention.f32_dkv_split;
//     flash_bwd_dkv_combine_kernel).
// The SIMT kernels they replace (4 threads a row, 8 at Dh 320, a shuffle
// reduction a score, 44 and 22 blocks at B 1, H 4, Hk 2, S 333) took 2.3
// times as long as PyTorch's memory-efficient f32 backward there.
//
// A query row that sees no key (a window past the end of the keys): the
// reference's softmax over all -1e30 scores gives p = 1/Skv on every key,
// and the mask (a `where`) stops any gradient into those scores.  So such
// a row adds dO / Skv to every dv row and nothing to dq or dk.  Its lse from
// flash_fwd.cu is log(Skv), so p = exp(0 - lse) = 1/Skv exactly.  (The TPU
// backward takes p = 1 there; see flash_fwd.cu.)
//
// C interface (bound with ctypes): pointers, element strides, ints, the
// stream and, for the wgmma kernels, the tensor maps' geometry; each entry
// point returns the cudaError_t of its launch, or minus the CUresult of a
// failed map encode.

#include "flash_common.cuh"
#include "hopper.cuh"
#include "tf32_mma.cuh"

namespace {

using namespace flash;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // (B, H, Sq), contiguous
  const float* delta;  // (B, H, Sq), contiguous
  void* dq;
  void* dk;
  void* dv;
  int B, H, Hk, Sq, Skv, group;
  long long sqb, sqh, sqs, skb, skh, sks, svb, svh, svs, sdob, sdoh, sdos;
  long long sdqb, sdqh, sdqs, sdkb, sdkh, sdks, sdvb, sdvh, sdvs;
  float scale;
  int causal, has_window, window, q_offset;
  // f32: the splits across blocks (flash_attention.py, f32_key_split and
  // f32_dkv_split).  dq: p.chunk keys a split (a multiple of kTfChunk), p.splits
  // of them.  dk/dv: p.chunk q rows a split, p.splits of them, and
  // p.head_splits, 1 (a block walks the group's heads) or the group (a block
  // takes one).  With more than one split the partials go to `part`.
  int chunk, splits, head_splits;
  float* part;
};

// P of (row, key) from the row's lse, given the scaled score; `vis` says
// whether the pair's score is differentiable (dS is 0 elsewhere).
__device__ __forceinline__ float prob(const Params& p, float s, float lse, int row, int key,
                                      bool& vis) {
  const int qpos = row + p.q_offset;
  vis = row < p.Sq && visible(p, qpos, key);
  if (vis) return __expf(s - lse);
  if (row < p.Sq && key < p.Skv && sees_no_key(p, qpos)) return __expf(-lse);
  return 0.f;
}

// Query rows [q_lo, q_hi) that keys [n0, n1) take gradient from.
__device__ __forceinline__ void query_range(const Params& p, int n0, int n1, int& q_lo, int& q_hi) {
  q_lo = 0;
  q_hi = p.Sq;
  if (p.causal) q_lo = max(0, n0 - p.q_offset);  // rows with qpos >= n0
  // rows with qpos < key + window see the key; rows that see no key at all
  // (the last ones) take p = 1/Skv on every key, so they keep q_hi at Sq
  if (p.has_window && !sees_no_key(p, p.Sq - 1 + p.q_offset))
    q_hi = min(p.Sq, n1 - 1 + p.window - p.q_offset);
}

// ---------------------------------------------------------------------------
// bf16, Dh in {16, 32}: tensor cores through mma.sync
// ---------------------------------------------------------------------------

constexpr int kRows = 64;  // keys of a dk/dv block: 4 warps x 16 keys

// The tiles of the mma.sync kernels: 4 warps, a dq block of 64 q rows
// stepping 64 keys, a dk/dv block of 64 keys stepping 32 q rows.
template <int D>
struct MmaTiles {
  static constexpr int kDqRows = 64;  // q rows of a dq block, 16 a warp
  static constexpr int kBN = 64;      // keys per k step of dq
  static constexpr int kBQ = 32;      // q rows per q step of dk/dv
  static constexpr int kThreads = 128;
  static constexpr int kLD = D + 8;  // row pitch in shared memory (bank-conflict-free)
  // Q, dO, two K tiles, two V tiles
  static constexpr int kDqSmem = (2 * kDqRows + 4 * kBN) * kLD * 2;
  // K, V, two Q tiles, two dO tiles, two lse chunks, two delta chunks
  static constexpr int kDkvSmem = (2 * kRows + 4 * kBQ) * kLD * 2 + 4 * kBQ * 4;
};

template <int D>
__global__ void __launch_bounds__(MmaTiles<D>::kThreads) flash_bwd_dq_bf16_kernel(const Params p) {
  using T = MmaTiles<D>;
  constexpr int LD = T::kLD, BN = T::kBN, ROWS = T::kDqRows, THREADS = T::kThreads;
  constexpr int kTile = BN * LD;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sO = sQ + ROWS * LD;  // dO
  __nv_bfloat16* sK = sO + ROWS * LD;  // two K tiles, then two V tiles
  __nv_bfloat16* sV = sK + 2 * kTile;

  const int n_qtiles = (p.Sq + ROWS - 1) / ROWS;
  const int r0 = (n_qtiles - 1 - (int)blockIdx.x) * ROWS;  // longest causal rows first
  const int r1 = min(p.Sq, r0 + ROWS);
  const long long b = blockIdx.z, h = blockIdx.y, hk = h / p.group;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int quad = lane / 4, tq = lane % 4;

  const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(p.q) + b * p.sqb + h * p.sqh;
  const __nv_bfloat16* og = static_cast<const __nv_bfloat16*>(p.dout) + b * p.sdob + h * p.sdoh;
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(p.k) + b * p.skb + hk * p.skh;
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(p.v) + b * p.svb + hk * p.svh;
  __nv_bfloat16* dqg = static_cast<__nv_bfloat16*>(p.dq) + b * p.sdqb + h * p.sdqh;

  int k_lo, k_hi;
  key_range(p, r0, r1, k_lo, k_hi);
  const int n_first = (k_lo / BN) * BN;

  load_tile_bf16<D, ROWS, THREADS>(sQ, qg, p.sqs, r0, p.Sq);
  load_tile_bf16<D, ROWS, THREADS>(sO, og, p.sdos, r0, p.Sq);
  load_tile_bf16<D, BN, THREADS>(sK, kg, p.sks, n_first, p.Skv);
  load_tile_bf16<D, BN, THREADS>(sV, vg, p.svs, n_first, p.Skv);
  cp_async_commit();

  // this thread's rows: quad and quad + 8 of the warp's 16
  const int row[2] = {r0 + warp * 16 + quad, r0 + warp * 16 + quad + 8};
  const long long stat = (b * p.H + h) * p.Sq;
  float lse[2], delta[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    lse[i] = row[i] < p.Sq ? p.lse[stat + row[i]] : 0.f;
    delta[i] = row[i] < p.Sq ? p.delta[stat + row[i]] : 0.f;
  }
  float acc[D / 8][4];
#pragma unroll
  for (int d = 0; d < D / 8; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;

  for (int n0 = n_first, it = 0; n0 < k_hi; n0 += BN, ++it) {
    const int buf = it & 1;
    if (n0 + BN < k_hi) {
      load_tile_bf16<D, BN, THREADS>(sK + (buf ^ 1) * kTile, kg, p.sks, n0 + BN, p.Skv);
      load_tile_bf16<D, BN, THREADS>(sV + (buf ^ 1) * kTile, vg, p.svs, n0 + BN, p.Skv);
    }
    cp_async_commit();
    cp_async_wait<1>();  // all but the prefetch have landed
    __syncthreads();
    const __nv_bfloat16* tK = sK + buf * kTile;
    const __nv_bfloat16* tV = sV + buf * kTile;

    // S = Q K^T and dP = dO V^T for 16 rows x BN keys
    float s[BN / 8][4], dp[BN / 8][4];
#pragma unroll
    for (int t = 0; t < BN / 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[t][e] = dp[t][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qa[4], oa[4];
      load_a<LD>(qa, sQ, warp * 16, kk * 16, lane);
      load_a<LD>(oa, sO, warp * 16, kk * 16, lane);
#pragma unroll
      for (int j = 0; j < BN / 16; ++j) {
        uint32_t kb[4], vb[4];
        load_b_nk<LD>(kb, tK, j * 16, kk * 16, lane);
        mma_bf16(s[2 * j], qa, kb[0], kb[1]);
        mma_bf16(s[2 * j + 1], qa, kb[2], kb[3]);
        load_b_nk<LD>(vb, tV, j * 16, kk * 16, lane);
        mma_bf16(dp[2 * j], oa, vb[0], vb[1]);
        mma_bf16(dp[2 * j + 1], oa, vb[2], vb[3]);
      }
    }

    // dS = P o (dP - delta) on visible pairs, into s
#pragma unroll
    for (int t = 0; t < BN / 8; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        bool vis;
        const float pr = prob(p, s[t][e] * p.scale, lse[i], row[i],
                                    n0 + t * 8 + tq * 2 + (e & 1), vis);
        s[t][e] = vis ? pr * (dp[t][e] - delta[i]) : 0.f;
      }
    }

    // dq += dS K: the accumulators of two n-tiles are one A fragment
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) {
      const uint32_t da[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]),
                              pack_bf16(s[2 * j][2], s[2 * j][3]),
                              pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                              pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
#pragma unroll
      for (int d = 0; d < D / 16; ++d) {
        uint32_t kb[4];
        load_b_kn<LD>(kb, tK, j * 16, d * 16, lane);
        mma_bf16(acc[2 * d], da, kb[0], kb[1]);
        mma_bf16(acc[2 * d + 1], da, kb[2], kb[3]);
      }
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }
  cp_async_wait<0>();

#pragma unroll
  for (int d = 0; d < D / 8; ++d) {
    const int col = d * 8 + tq * 2;
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (row[i] < p.Sq)
        *reinterpret_cast<__nv_bfloat162*>(dqg + row[i] * p.sdqs + col) =
            __floats2bfloat162_rn(acc[d][2 * i] * p.scale, acc[d][2 * i + 1] * p.scale);
  }
}

template <int D>
__global__ void __launch_bounds__(MmaTiles<D>::kThreads) flash_bwd_dkv_bf16_kernel(const Params p) {
  using T = MmaTiles<D>;
  constexpr int LD = T::kLD, BQ = T::kBQ, THREADS = T::kThreads;
  constexpr int kQTile = BQ * LD;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sV = sK + kRows * LD;
  __nv_bfloat16* sQ = sV + kRows * LD;  // two Q tiles, then two dO tiles
  __nv_bfloat16* sO = sQ + 2 * kQTile;
  float* sL = reinterpret_cast<float*>(sO + 2 * kQTile);  // two lse chunks, then two delta chunks
  float* sD = sL + 2 * BQ;

  const int n0 = blockIdx.x * kRows;
  const int n1 = min(p.Skv, n0 + kRows);
  const long long b = blockIdx.z, hk = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int quad = lane / 4, tq = lane % 4;

  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(p.k) + b * p.skb + hk * p.skh;
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(p.v) + b * p.svb + hk * p.svh;
  __nv_bfloat16* dkg = static_cast<__nv_bfloat16*>(p.dk) + b * p.sdkb + hk * p.sdkh;
  __nv_bfloat16* dvg = static_cast<__nv_bfloat16*>(p.dv) + b * p.sdvb + hk * p.sdvh;

  int q_lo, q_hi;
  query_range(p, n0, n1, q_lo, q_hi);
  const int q_first = (q_lo / BQ) * BQ;
  const int n_chunks = q_hi > q_first ? (q_hi - q_first + BQ - 1) / BQ : 0;
  const int n_steps = n_chunks * p.group;  // (query head of the group, q tile) pairs

  // step c: query head hk * group + c / n_chunks, rows from q_first + (c % n_chunks) * BQ
  auto load_step = [&](int c, int buf) {
    const long long h = hk * p.group + c / n_chunks;
    const int r0 = q_first + (c % n_chunks) * BQ;
    load_tile_bf16<D, BQ, THREADS>(sQ + buf * kQTile,
                                   static_cast<const __nv_bfloat16*>(p.q) + b * p.sqb + h * p.sqh,
                                   p.sqs, r0, p.Sq);
    load_tile_bf16<D, BQ, THREADS>(
        sO + buf * kQTile, static_cast<const __nv_bfloat16*>(p.dout) + b * p.sdob + h * p.sdoh,
        p.sdos, r0, p.Sq);
    const long long stat = (b * p.H + h) * p.Sq;
    for (int i = threadIdx.x; i < BQ; i += THREADS) {
      const bool valid = r0 + i < p.Sq;
      sL[buf * BQ + i] = valid ? p.lse[stat + r0 + i] : 0.f;
      sD[buf * BQ + i] = valid ? p.delta[stat + r0 + i] : 0.f;
    }
  };

  load_tile_bf16<D, kRows, THREADS>(sK, kg, p.sks, n0, p.Skv);
  load_tile_bf16<D, kRows, THREADS>(sV, vg, p.svs, n0, p.Skv);
  if (n_steps > 0) load_step(0, 0);
  cp_async_commit();

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int d = 0; d < D / 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[d][e] = dv[d][e] = 0.f;
  // this thread's keys: quad and quad + 8 of the warp's 16
  const int key[2] = {n0 + warp * 16 + quad, n0 + warp * 16 + quad + 8};

  for (int c = 0; c < n_steps; ++c) {
    const int buf = c & 1;
    if (c + 1 < n_steps) load_step(c + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const __nv_bfloat16* tQ = sQ + buf * kQTile;
    const __nv_bfloat16* tO = sO + buf * kQTile;
    const float* tL = sL + buf * BQ;
    const float* tD = sD + buf * BQ;
    const int r0 = q_first + (c % n_chunks) * BQ;

    // S^T = K Q^T and dP^T = V dO^T for 16 keys x BQ rows
    float st[BQ / 8][4], dpt[BQ / 8][4];
#pragma unroll
    for (int t = 0; t < BQ / 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[t][e] = dpt[t][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t ka[4], va[4];
      load_a<LD>(ka, sK, warp * 16, kk * 16, lane);
      load_a<LD>(va, sV, warp * 16, kk * 16, lane);
#pragma unroll
      for (int j = 0; j < BQ / 16; ++j) {
        uint32_t qb[4], ob[4];
        load_b_nk<LD>(qb, tQ, j * 16, kk * 16, lane);
        mma_bf16(st[2 * j], ka, qb[0], qb[1]);
        mma_bf16(st[2 * j + 1], ka, qb[2], qb[3]);
        load_b_nk<LD>(ob, tO, j * 16, kk * 16, lane);
        mma_bf16(dpt[2 * j], va, ob[0], ob[1]);
        mma_bf16(dpt[2 * j + 1], va, ob[2], ob[3]);
      }
    }

    // P^T into st, dS^T = P^T o (dP^T - delta) into dpt
#pragma unroll
    for (int t = 0; t < BQ / 8; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = t * 8 + tq * 2 + (e & 1);
        bool vis;
        const float pr = prob(p, st[t][e] * p.scale, tL[col], r0 + col, key[e >> 1], vis);
        st[t][e] = pr;
        dpt[t][e] = vis ? pr * (dpt[t][e] - tD[col]) : 0.f;
      }
    }

    // dV += P^T dO and dK += dS^T Q
#pragma unroll
    for (int j = 0; j < BQ / 16; ++j) {
      const uint32_t pa[4] = {pack_bf16(st[2 * j][0], st[2 * j][1]),
                              pack_bf16(st[2 * j][2], st[2 * j][3]),
                              pack_bf16(st[2 * j + 1][0], st[2 * j + 1][1]),
                              pack_bf16(st[2 * j + 1][2], st[2 * j + 1][3])};
      const uint32_t da[4] = {pack_bf16(dpt[2 * j][0], dpt[2 * j][1]),
                              pack_bf16(dpt[2 * j][2], dpt[2 * j][3]),
                              pack_bf16(dpt[2 * j + 1][0], dpt[2 * j + 1][1]),
                              pack_bf16(dpt[2 * j + 1][2], dpt[2 * j + 1][3])};
#pragma unroll
      for (int d = 0; d < D / 16; ++d) {
        uint32_t ob[4], qb[4];
        load_b_kn<LD>(ob, tO, j * 16, d * 16, lane);
        mma_bf16(dv[2 * d], pa, ob[0], ob[1]);
        mma_bf16(dv[2 * d + 1], pa, ob[2], ob[3]);
        load_b_kn<LD>(qb, tQ, j * 16, d * 16, lane);
        mma_bf16(dk[2 * d], da, qb[0], qb[1]);
        mma_bf16(dk[2 * d + 1], da, qb[2], qb[3]);
      }
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }
  cp_async_wait<0>();

#pragma unroll
  for (int d = 0; d < D / 8; ++d) {
    const int col = d * 8 + tq * 2;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (key[i] < p.Skv) {
        *reinterpret_cast<__nv_bfloat162*>(dkg + key[i] * p.sdks + col) =
            __floats2bfloat162_rn(dk[d][2 * i] * p.scale, dk[d][2 * i + 1] * p.scale);
        *reinterpret_cast<__nv_bfloat162*>(dvg + key[i] * p.sdvs + col) =
            __floats2bfloat162_rn(dv[d][2 * i], dv[d][2 * i + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16, Dh in {64, 128, 320}: TMA, wgmma and warp specialisation
// ---------------------------------------------------------------------------

constexpr int kWgThreads = 384;  // producer warpgroup, then two consumers
constexpr float kLog2e = 1.4426950408889634f;

constexpr int kDqStages = 2;   // K/V ring depth of dq at Dh 64 / 128
constexpr int kDkvStages = 3;  // Q/dO ring depth of dk/dv at Dh 64 / 128

// The tiles of dq.  Dh 64 / 128: an item is 128 q rows, 64 a consumer, and
// both consumers read every 128-key tile.  Dh 320: a 64-row item whose key
// tiles (48 keys) the consumers split (dq_tile_mine), each accumulating a
// partial dQ of all 64 rows; the ring's stages alternate between them, so
// its depth is even: stage g % 2 is consumer g % 2's.
template <int D>
struct DqTiles {
  static constexpr bool kSplit = D > 128;               // the consumers split the key tiles
  static constexpr int kRows = kSplit ? 64 : 128;       // q rows of an item
  static constexpr int kKeys = kSplit ? 48 : 128;       // keys of a K/V tile
  static constexpr int kStages = kSplit ? 2 : kDqStages;  // K/V ring depth
  static_assert(!kSplit || kStages % 2 == 0, "a split ring's stages alternate between consumers");
};

// Whether K/V tile g of the ring (counted across items) is consumer c's.
template <int D>
__device__ __forceinline__ bool dq_tile_mine(int g, int c) {
  return !DqTiles<D>::kSplit || (g & 1) == c;
}

// Whether consumer c has a tile among ring tiles [g0, g1).
template <int D>
__device__ __forceinline__ bool dq_has_tile(int g0, int g1, int c) {
  for (int g = g0; g < g1; ++g)
    if (dq_tile_mine<D>(g, c)) return true;
  return false;
}

// The tiles of dk/dv.  Dh 64 / 128: an item is 128 keys, 64 a consumer, and
// each consumer runs every product of its keys; a step is 64 q rows.  Dh
// 320: dK and dV of 64 keys x 320 would be 320 f32 registers a thread, so
// the two consumers share an item of 64 keys and split the work by output
// (dkv_consumer_split); a step is 48 q rows, and K, V and a ring of two
// (Q, dO) stages take 200 KB (a first build with 32-row steps in a ring of
// three was slower: S^T as m64n32 reads more shared memory per product).
template <int D>
struct DkvTiles {
  static constexpr bool kSplit = D > 128;                  // consumer 0 owns dV, consumer 1 dK
  static constexpr int kKeys = kSplit ? 64 : 128;          // keys of an item
  static constexpr int kRows = kSplit ? 48 : 64;           // q rows per step
  static constexpr int kStages = kSplit ? 2 : kDkvStages;  // Q/dO ring depth
};

// Shared memory of the dq kernel, in bytes from a 1024-byte-aligned base:
// the Q tile, the dO tile, the K ring, the V ring, at Dh 320 the 64 x 64
// f32 slab that passes dQ between the consumers, then the mbarriers.  A
// tile is D / 64 slabs of 128 bytes a row: 193 KB at Dh 128, 217 KB at Dh
// 320.
template <int D>
struct DqSmem {
  using T = DqTiles<D>;
  static constexpr int kSlabs = D / 64;
  static constexpr int kQSlab = T::kRows * 128;
  static constexpr int kKVSlab = T::kKeys * 128;
  static constexpr int kQ = kSlabs * kQSlab;    // the Q tile; the dO tile alike
  static constexpr int kKV = kSlabs * kKVSlab;  // one K or V tile
  static constexpr int kDO = kQ;
  static constexpr int kK = kDO + kQ;
  static constexpr int kV = kK + T::kStages * kKV;
  static constexpr int kXchg = kV + T::kStages * kKV;
  static constexpr int kXchgBytes = T::kSplit ? 64 * 64 * 4 : 0;
  static constexpr int kBars = kXchg + kXchgBytes;
  // q_full, q_empty, then per stage k_full, v_full, k_empty, v_empty
  static constexpr int kNumBars = 2 + 4 * T::kStages;
  // the dynamic base is only 16-byte aligned: room to align it by hand
  static constexpr int kBytes = kBars + kNumBars * 8 + 1024;
};

// Shared memory of the dk/dv kernel: the K tile, the V tile, the ring of
// (Q, dO) stages, each stage's rows of lse * log2 e then delta (f32), at Dh
// 320 the two buffers that pass P^T between the consumers (f32, one
// accumulator fragment a thread), then the mbarriers: 162 KB at Dh 128,
// 225 KB at Dh 320.
template <int D>
struct DkvSmem {
  using T = DkvTiles<D>;
  static constexpr int kSlabs = D / 64;
  static constexpr int kKVSlab = T::kKeys * 128;
  static constexpr int kQSlab = T::kRows * 128;
  static constexpr int kKV = kSlabs * kKVSlab;  // the K tile; the V tile alike
  static constexpr int kQ = kSlabs * kQSlab;    // a stage's Q tile; its dO tile alike
  static constexpr int kStage = 2 * kQ;
  static constexpr int kV = kKV;
  static constexpr int kRing = 2 * kKV;
  static constexpr int kStats = kRing + T::kStages * kStage;
  static constexpr int kStatsStage = 2 * T::kRows * 4;
  static constexpr int kXchg = kStats + T::kStages * kStatsStage;
  static constexpr int kXchgBytes = T::kSplit ? 2 * 128 * (T::kRows / 2) * 4 : 0;
  static constexpr int kBars = kXchg + kXchgBytes;
  // kv_full, kv_empty, then per stage full, empty
  static constexpr int kNumBars = 2 + 2 * T::kStages;
  static constexpr int kBytes = kBars + kNumBars * 8 + 1024;
};

// The k-th item of this block, or -1 past the last: rounds of gridDim.x
// items, walked in snake order (forward in even rounds, backward in odd
// ones) so that a block's heavy and light items even out.
__device__ __forceinline__ int item_index(int k, int total) {
  const int g = gridDim.x, blk = blockIdx.x;
  const int w = k * g + ((k & 1) ? g - 1 - blk : blk);
  return w < total ? w : -1;
}

// A dq item: one (q tile, head, batch) and the key tiles it sees, numbered
// heaviest first across all heads (the last q tile, whose causal rows see
// the most keys, of every (head, batch), then the one before, ...).
struct DqItem {
  int r0, r1, h, b, hk, n_first, n_tiles;
};

template <int D>
__device__ __forceinline__ DqItem dq_item(const Params& p, int w) {
  using T = DqTiles<D>;
  const int n_qtiles = (p.Sq + T::kRows - 1) / T::kRows;
  const int rank = w / (p.H * p.B), hb = w % (p.H * p.B);
  DqItem t;
  t.r0 = (n_qtiles - 1 - rank) * T::kRows;
  t.r1 = min(p.Sq, t.r0 + T::kRows);
  t.h = hb % p.H;
  t.b = hb / p.H;
  t.hk = t.h / p.group;
  int k_lo, k_hi;
  key_range(p, t.r0, t.r1, k_lo, k_hi);
  t.n_first = (k_lo / T::kKeys) * T::kKeys;
  t.n_tiles = (k_hi - t.n_first + T::kKeys - 1) / T::kKeys;
  return t;
}

// A dk/dv item: one (key tile, kv head, batch) and its steps, the (query
// head of the group, q tile) pairs whose rows can see the keys; key tile 0
// first, which sees the most rows under a causal mask.
struct DkvItem {
  int n0, hk, b, q_first, n_chunks, n_steps;
};

template <int D>
__device__ __forceinline__ DkvItem dkv_item(const Params& p, int w) {
  using T = DkvTiles<D>;
  const int rank = w / (p.Hk * p.B), hb = w % (p.Hk * p.B);
  DkvItem t;
  t.n0 = rank * T::kKeys;
  t.hk = hb % p.Hk;
  t.b = hb / p.Hk;
  int q_lo, q_hi;
  query_range(p, t.n0, min(p.Skv, t.n0 + T::kKeys), q_lo, q_hi);
  t.q_first = (q_lo / T::kRows) * T::kRows;
  t.n_chunks = q_hi > t.q_first ? (q_hi - t.q_first + T::kRows - 1) / T::kRows : 0;
  t.n_steps = t.n_chunks * p.group;
  return t;
}

// dS = P o (dP - delta) of one dq step, in place in s: rows qrow and qrow +
// 8 (absolute), keys n0 + 8i + 2tq + (0, 1).  A tile that needs no mask
// takes one FFMA and one ex2 a score; an edge tile masks with selects, so
// its scores stay one block of straight-line code.  Rows past Sq load zero
// Q and dO and lse = delta = 0, so they give dS = 0 on either path.
template <int KEYS>
__device__ __forceinline__ void dq_ds(const Params& p, float (&s)[KEYS / 2],
                                      const float (&dp)[KEYS / 2], const float (&lse2)[2],
                                      const float (&dlt)[2], int qrow, int n0, int r0, int r1,
                                      int tq, float sl2) {
  if (tile_needs_mask(p, n0, KEYS, r0, r1)) {
#pragma unroll
    for (int i = 0; i < KEYS / 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e / 2, row = qrow + 8 * r, key = n0 + 8 * i + 2 * tq + (e & 1);
        const int qpos = row + p.q_offset;
        const bool vis = (row < p.Sq) & (key < p.Skv) & (!p.causal | (key <= qpos)) &
                         (!p.has_window | (key > qpos - p.window));
        const float pr = hopper::exp2_approx(fmaf(s[4 * i + e], sl2, -lse2[r]));
        s[4 * i + e] = vis ? pr * (dp[4 * i + e] - dlt[r]) : 0.f;
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < KEYS / 2; ++i) {
      const int r = (i % 4) / 2;
      s[i] = hopper::exp2_approx(fmaf(s[i], sl2, -lse2[r])) * (dp[i] - dlt[r]);
    }
  }
}

// P^T and dS^T of one dk/dv step, in place (s becomes P^T, dp dS^T): keys
// key and key + 8 (absolute, the fragment's rows), q rows r0 + 8i + 2tq +
// (0, 1) (its columns), whose lse * log2 e and delta are in shared memory
// (sl, sd).  Masks as in dq_ds; a row that sees no key takes p = exp(-lse)
// = 1/Skv on every key below Skv and dS = 0.  The mask test is on this
// consumer's 64 keys from kn0 and the step's rows [r0, r1).
template <int ROWS>
__device__ __forceinline__ void dkv_p_ds(const Params& p, float (&s)[ROWS / 2],
                                         float (&dp)[ROWS / 2], const float* sl,
                                         const float* sd, int key, int kn0, int r0, int r1,
                                         int tq, float sl2) {
  if (tile_needs_mask(p, kn0, 64, r0, r1)) {
#pragma unroll
    for (int i = 0; i < ROWS / 8; ++i) {
      const float2 l = *reinterpret_cast<const float2*>(sl + 8 * i + 2 * tq);
      const float2 dl = *reinterpret_cast<const float2*>(sd + 8 * i + 2 * tq);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = key + 8 * (e / 2), row = r0 + 8 * i + 2 * tq + (e & 1);
        const float lse2 = (e & 1) ? l.y : l.x, delta = (e & 1) ? dl.y : dl.x;
        const int qpos = row + p.q_offset;
        const bool in = (row < p.Sq) & (k < p.Skv);
        const bool vis = in & (!p.causal | (k <= qpos)) & (!p.has_window | (k > qpos - p.window));
        const bool no_key = in & (p.has_window != 0) & (qpos - p.window + 1 >= p.Skv);
        const float x = vis ? fmaf(s[4 * i + e], sl2, -lse2) : (no_key ? -lse2 : -INFINITY);
        const float pr = hopper::exp2_approx(x);
        s[4 * i + e] = pr;
        dp[4 * i + e] = vis ? pr * (dp[4 * i + e] - delta) : 0.f;
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < ROWS / 8; ++i) {
      const float2 l = *reinterpret_cast<const float2*>(sl + 8 * i + 2 * tq);
      const float2 dl = *reinterpret_cast<const float2*>(sd + 8 * i + 2 * tq);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pr = hopper::exp2_approx(fmaf(s[4 * i + e], sl2, (e & 1) ? -l.y : -l.x));
        s[4 * i + e] = pr;
        dp[4 * i + e] = pr * (dp[4 * i + e] - ((e & 1) ? dl.y : dl.x));
      }
    }
  }
}

// The halves of dkv_p_ds that the split consumers (Dh 320) run apart, with
// its masks: P^T in place in s (consumer 0), and dS^T = P^T o (dP^T -
// delta) in place in dp from consumer 0's P^T (consumer 1).
template <int ROWS>
__device__ __forceinline__ void dkv_p(const Params& p, float (&s)[ROWS / 2], const float* sl,
                                      int key, int r0, int tq, float sl2, bool edge) {
#pragma unroll
  for (int i = 0; i < ROWS / 8; ++i) {
    const float2 l = *reinterpret_cast<const float2*>(sl + 8 * i + 2 * tq);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float lse2 = (e & 1) ? l.y : l.x;
      float x = fmaf(s[4 * i + e], sl2, -lse2);
      if (edge) {
        const int k = key + 8 * (e / 2), row = r0 + 8 * i + 2 * tq + (e & 1);
        const int qpos = row + p.q_offset;
        const bool in = (row < p.Sq) & (k < p.Skv);
        const bool vis = in & (!p.causal | (k <= qpos)) & (!p.has_window | (k > qpos - p.window));
        const bool no_key = in & (p.has_window != 0) & (qpos - p.window + 1 >= p.Skv);
        x = vis ? x : (no_key ? -lse2 : -INFINITY);
      }
      s[4 * i + e] = hopper::exp2_approx(x);
    }
  }
}

template <int ROWS>
__device__ __forceinline__ void dkv_ds(const Params& p, float (&dp)[ROWS / 2],
                                       const float (&pt)[ROWS / 2], const float* sd, int key,
                                       int r0, int tq, bool edge) {
#pragma unroll
  for (int i = 0; i < ROWS / 8; ++i) {
    const float2 dl = *reinterpret_cast<const float2*>(sd + 8 * i + 2 * tq);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float ds = pt[4 * i + e] * (dp[4 * i + e] - ((e & 1) ? dl.y : dl.x));
      if (edge) {
        const int k = key + 8 * (e / 2), row = r0 + 8 * i + 2 * tq + (e & 1);
        const int qpos = row + p.q_offset;
        const bool vis = (row < p.Sq) & (k < p.Skv) & (!p.causal | (k <= qpos)) &
                         (!p.has_window | (k > qpos - p.window));
        ds = vis ? ds : 0.f;
      }
      dp[4 * i + e] = ds;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                              const __grid_constant__ CUtensorMap map_k,
                              const __grid_constant__ CUtensorMap map_v,
                              const __grid_constant__ CUtensorMap map_do, const Params p,
                              int total) {
  using L = DqSmem<D>;
  using T = DqTiles<D>;
  using namespace hopper;
  constexpr int ROWS = T::kRows, KEYS = T::kKeys, STAGES = T::kStages;
  extern __shared__ __align__(16) unsigned char wg_smem[];
  unsigned char* smem = wg_smem + ((1024 - (hopper::smem_u32(wg_smem) & 1023)) & 1023);
  unsigned char* sQ = smem;
  unsigned char* sdO = smem + L::kDO;
  unsigned char* sK = smem + L::kK;
  unsigned char* sV = smem + L::kV;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* q_empty = q_full + 1;
  uint64_t* k_full = q_full + 2;
  uint64_t* v_full = k_full + STAGES;
  uint64_t* k_empty = v_full + STAGES;
  uint64_t* v_empty = k_empty + STAGES;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, 8);  // lane 0 of each of the 8 consumer warps
    // a stage is released by the warps that read it: both consumers', or
    // (split) its owner's 4
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&k_empty[s], T::kSplit ? 4 : 8);
      mbar_init(&v_empty[s], T::kSplit ? 4 : 8);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer: one thread issues every copy, item after item; the K/V ring
    // runs on across items
    reg_dealloc<24>();
    if (threadIdx.x == 0) {
      int kv = 0;  // K/V tiles issued so far
      for (int k = 0;; ++k) {
        const int w = item_index(k, total);
        if (w < 0) break;
        const DqItem t = dq_item<D>(p, w);
        // the consumers' last Q K^T and dO V^T of the previous item have retired
        if (k > 0) mbar_wait(q_empty, (k - 1) & 1);
        mbar_arrive_expect_tx(q_full, 2 * L::kQ);
#pragma unroll
        for (int s = 0; s < L::kSlabs; ++s) {
          tma_load_4d(sQ + s * L::kQSlab, &map_q, q_full, s * 64, t.r0, t.h, t.b);
          tma_load_4d(sdO + s * L::kQSlab, &map_do, q_full, s * 64, t.r0, t.h, t.b);
        }
        for (int j = 0; j < t.n_tiles; ++j, ++kv) {
          const int st = kv % STAGES, n0 = t.n_first + j * KEYS;
          // the stage's previous V, then K, has been released by its readers
          const uint32_t released = (kv / STAGES - 1) & 1;
          if (kv >= STAGES) mbar_wait(&v_empty[st], released);
          mbar_arrive_expect_tx(&v_full[st], L::kKV);
#pragma unroll
          for (int s = 0; s < L::kSlabs; ++s)
            tma_load_4d(sV + st * L::kKV + s * L::kKVSlab, &map_v, &v_full[st], s * 64, n0,
                        t.hk, t.b);
          if (kv >= STAGES) mbar_wait(&k_empty[st], released);
          mbar_arrive_expect_tx(&k_full[st], L::kKV);
#pragma unroll
          for (int s = 0; s < L::kSlabs; ++s)
            tma_load_4d(sK + st * L::kKV + s * L::kKVSlab, &map_k, &k_full[st], s * 64, n0,
                        t.hk, t.b);
        }
      }
    }
  } else {
    // consumers: 64 q rows of each item each, or (split) all 64 rows of the
    // item over the key tiles that are theirs
    reg_alloc<240>();
    const int c = threadIdx.x / 128 - 1;
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int quad = lane / 4, tq = lane % 4;  // accumulator row / column pair
    const int c0 = T::kSplit ? 0 : c * 64;     // this consumer's first row in the item
    const int row = c0 + warp * 16 + quad;     // this thread's rows: row, row + 8
    const float sl2 = p.scale * kLog2e;
    const unsigned char* sQc = sQ + c0 * 128;    // this consumer's 64 rows of Q
    const unsigned char* sdOc = sdO + c0 * 128;  // and of dO
    int kv = 0, k = 0;  // K/V tiles of the ring so far; items so far
    for (;; ++k) {
      const int w = item_index(k, total);
      if (w < 0) break;
      const DqItem t = dq_item<D>(p, w);
      const int cr0 = t.r0 + c0, cr1 = min(p.Sq, cr0 + 64);
      // lse (in the log2 domain) and delta of rows row and row + 8
      const long long stat = ((long long)t.b * p.H + t.h) * p.Sq;
      float lse2[2], dlt[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int gr = t.r0 + row + 8 * r;
        lse2[r] = gr < p.Sq ? p.lse[stat + gr] * kLog2e : 0.f;
        dlt[r] = gr < p.Sq ? p.delta[stat + gr] : 0.f;
      }
      float acc[D / 2];  // dQ, 64 x D over the warpgroup (split: this consumer's keys only)
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

      mbar_wait(q_full, k & 1);
      // a consumer with no tile in this item is done with Q and dO at once
      if (lane == 0 && !dq_has_tile<D>(kv, kv + t.n_tiles, c)) mbar_arrive(q_empty);
      for (int j = 0; j < t.n_tiles; ++j) {
        const int g = kv + j, st = g % STAGES;
        if (!dq_tile_mine<D>(g, c)) continue;
        const uint32_t phase = (g / STAGES) & 1;
        float s[KEYS / 2], dp[KEYS / 2];
        mbar_wait(&k_full[st], phase);
        mbar_wait(&v_full[st], phase);
        wgmma_fence();
        wgmma_abt<D, KEYS, ROWS, KEYS>(s, sQc, sK + st * L::kKV);
        wgmma_abt<D, KEYS, ROWS, KEYS>(dp, sdOc, sV + st * L::kKV);
        wgmma_commit();
        wgmma_wait<0>();
        fence_operand(s);
        fence_operand(dp);
        __syncwarp();
        if (lane == 0) {
          mbar_arrive(&v_empty[st]);  // V is free: only dO V^T reads it
          // and after this consumer's last tile of the item, Q and dO
          if (!dq_has_tile<D>(g + 1, kv + t.n_tiles, c)) mbar_arrive(q_empty);
        }
        dq_ds<KEYS>(p, s, dp, lse2, dlt, t.r0 + row, t.n_first + j * KEYS, cr0, cr1, tq, sl2);
        uint32_t da[KEYS / 16][4];
        pack_a<KEYS>(s, da);
        fence_operand(acc);
        wgmma_fence();
        wgmma_ab<D, KEYS, KEYS>(acc, da, sK + st * L::kKV);
        wgmma_commit();
        wgmma_wait<0>();
        fence_operand(acc);
        __syncwarp();
        if (lane == 0) mbar_arrive(&k_empty[st]);  // K is free after dS K
      }
      kv += t.n_tiles;

      if constexpr (T::kSplit) {
        // consumer 1's partial dQ to consumer 0, one 64 x 64 slab (32
        // accumulators a thread, in the same fragment layout) at a time;
        // consumer 0 adds it to its own.  Named barrier 1 says the slab is
        // written, 2 that it has been read: each side arrives on each once a
        // slab, and consumer 1 waits out the last "read" before it ends.
        float4* xchg = reinterpret_cast<float4*>(smem + L::kXchg) + tid;  // float4 j at xchg[128 j]
#pragma unroll
        for (int s = 0; s < D / 64; ++s) {
          if (c == 1) {
            if (k > 0 || s > 0) named_barrier_sync(2, 256);
#pragma unroll
            for (int j = 0; j < 8; ++j)
              xchg[128 * j] = make_float4(acc[32 * s + 4 * j], acc[32 * s + 4 * j + 1],
                                          acc[32 * s + 4 * j + 2], acc[32 * s + 4 * j + 3]);
            named_barrier_arrive(1, 256);
          } else {
            named_barrier_sync(1, 256);
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const float4 x = xchg[128 * j];
              acc[32 * s + 4 * j] += x.x;
              acc[32 * s + 4 * j + 1] += x.y;
              acc[32 * s + 4 * j + 2] += x.z;
              acc[32 * s + 4 * j + 3] += x.w;
            }
            named_barrier_arrive(2, 256);
          }
        }
        if (c == 1) continue;  // consumer 0 stores the item's dQ
      }

      // the item again rather than its head and batch kept live across the
      // tile loop: two registers that the Dh-320 consumers lack
      const DqItem u = dq_item<D>(p, w);
      __nv_bfloat16* dqg = static_cast<__nv_bfloat16*>(p.dq) + (long long)u.b * p.sdqb +
                           (long long)u.h * p.sdqh;
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int gr = u.r0 + row + 8 * r;
          if (gr < p.Sq)
            *reinterpret_cast<__nv_bfloat162*>(dqg + (long long)gr * p.sdqs + 8 * i + 2 * tq) =
                __floats2bfloat162_rn(acc[4 * i + 2 * r] * p.scale,
                                      acc[4 * i + 2 * r + 1] * p.scale);
        }
      }
    }
    if (T::kSplit && c == 1 && k > 0) named_barrier_sync(2, 256);
  }
}

// Dh 64 / 128's consumers: each owns 64 keys of the item, and runs S^T =
// K Q^T and dP^T = V dO^T (m64n64), P^T and dS^T on the fragments, then dV
// += P^T dO and dK += dS^T Q (RS, Q and dO read MN-major).
template <int D>
__device__ __forceinline__ void dkv_consumer_keys(const Params& p, int total, int c, int tid,
                                                  const unsigned char* sK,
                                                  const unsigned char* sV,
                                                  const unsigned char* sRing,
                                                  const float* sStats, uint64_t* kv_full,
                                                  uint64_t* kv_empty, uint64_t* full,
                                                  uint64_t* empty) {
  using L = DkvSmem<D>;
  using T = DkvTiles<D>;
  using namespace hopper;
  constexpr int KEYS = T::kKeys, ROWS = T::kRows;
  const int warp = tid / 32, lane = tid % 32;
  const int quad = lane / 4, tq = lane % 4;
  const int krow = c * 64 + warp * 16 + quad;  // this thread's keys in the item: krow, krow + 8
  const float sl2 = p.scale * kLog2e;
  const unsigned char* sKc = sK + c * 64 * 128;  // this consumer's 64 keys of K
  const unsigned char* sVc = sV + c * 64 * 128;  // and of V
  int it = 0, kvi = 0;
  for (int k = 0;; ++k) {
    const int w = item_index(k, total);
    if (w < 0) break;
    const DkvItem t = dkv_item<D>(p, w);
    const int kn0 = t.n0 + c * 64;
    float dk[D / 2], dv[D / 2];  // 64 keys x D each over the warpgroup
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
    if (t.n_steps > 0) mbar_wait(kv_full, kvi & 1);
    for (int cs = 0; cs < t.n_steps; ++cs, ++it) {
      const int st = it % T::kStages;
      const int r0 = t.q_first + (cs % t.n_chunks) * ROWS;
      const unsigned char* tQ = sRing + st * L::kStage;
      const unsigned char* tdO = tQ + L::kQ;
      const float* sl = sStats + st * 2 * ROWS;
      float s[ROWS / 2], dp[ROWS / 2];
      mbar_wait(&full[st], (it / T::kStages) & 1);
      wgmma_fence();
      wgmma_abt<D, ROWS, KEYS, ROWS>(s, sKc, tQ);
      wgmma_abt<D, ROWS, KEYS, ROWS>(dp, sVc, tdO);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operand(s);
      fence_operand(dp);
      __syncwarp();
      if (lane == 0 && cs == t.n_steps - 1) mbar_arrive(kv_empty);  // K and V are free
      dkv_p_ds<ROWS>(p, s, dp, sl, sl + ROWS, t.n0 + krow, kn0, r0, min(p.Sq, r0 + ROWS), tq,
                     sl2);
      uint32_t pa[ROWS / 16][4], da[ROWS / 16][4];
      pack_a<ROWS>(s, pa);
      pack_a<ROWS>(dp, da);
      fence_operand(dv);
      fence_operand(dk);
      wgmma_fence();
      wgmma_ab<D, ROWS, ROWS>(dv, pa, tdO);
      wgmma_ab<D, ROWS, ROWS>(dk, da, tQ);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operand(dv);
      fence_operand(dk);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);  // the stage is free
    }
    if (t.n_steps > 0) ++kvi;

    __nv_bfloat16* dkg = static_cast<__nv_bfloat16*>(p.dk) + (long long)t.b * p.sdkb +
                         (long long)t.hk * p.sdkh;
    __nv_bfloat16* dvg = static_cast<__nv_bfloat16*>(p.dv) + (long long)t.b * p.sdvb +
                         (long long)t.hk * p.sdvh;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int key = t.n0 + krow + 8 * r;
        if (key < p.Skv) {
          *reinterpret_cast<__nv_bfloat162*>(dkg + (long long)key * p.sdks + 8 * i + 2 * tq) =
              __floats2bfloat162_rn(dk[4 * i + 2 * r] * p.scale,
                                    dk[4 * i + 2 * r + 1] * p.scale);
          *reinterpret_cast<__nv_bfloat162*>(dvg + (long long)key * p.sdvs + 8 * i + 2 * tq) =
              __floats2bfloat162_rn(dv[4 * i + 2 * r], dv[4 * i + 2 * r + 1]);
        }
      }
    }
  }
}

// Dh 320's consumers share the item's 64 keys and split the work by
// output, so that each keeps one 64 x 320 accumulator (160 registers a
// thread).  Consumer 0 computes S^T = K Q^T of the step's 48 rows and P^T,
// hands P^T (f32) to consumer 1 through shared memory, and runs dV += P^T
// dO; consumer 1 computes dP^T = V dO^T, takes P^T, forms dS^T and runs dK
// += dS^T Q.  Each executes 4 Dh of the 8 Dh FLOP of a visible pair, S^T /
// dP^T as m64n48 (both operands in shared memory), dV / dK as n128 + n128
// + n64 products on whole 64-column slabs.  The P^T buffers alternate by
// step: named barrier 1 + b says buffer b is written, 3 + b that it has
// been read; each side arrives on each once a step, so no barrier runs a
// phase ahead of its partner, and consumer 0 waits out the last two
// "read"s before the block ends.
template <int D>
__device__ __forceinline__ void dkv_consumer_split(const Params& p, int total, int c, int tid,
                                                   const unsigned char* sK,
                                                   const unsigned char* sV,
                                                   const unsigned char* sRing,
                                                   const float* sStats, float4* sX,
                                                   uint64_t* kv_full, uint64_t* kv_empty,
                                                   uint64_t* full, uint64_t* empty) {
  using L = DkvSmem<D>;
  using T = DkvTiles<D>;
  using namespace hopper;
  constexpr int KEYS = T::kKeys, ROWS = T::kRows, X4 = ROWS / 8;  // float4s of a fragment
  const int warp = tid / 32, lane = tid % 32;
  const int quad = lane / 4, tq = lane % 4;
  const int krow = warp * 16 + quad;  // this thread's keys in the item: krow, krow + 8
  const float sl2 = p.scale * kLog2e;
  const unsigned char* sA = c == 0 ? sK : sV;  // the A operand of S^T / dP^T
  int it = 0, kvi = 0;
  for (int k = 0;; ++k) {
    const int w = item_index(k, total);
    if (w < 0) break;
    const DkvItem t = dkv_item<D>(p, w);
    float acc[D / 2];  // dV (consumer 0) or dK (consumer 1), 64 keys x D
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    if (t.n_steps > 0) mbar_wait(kv_full, kvi & 1);
    for (int cs = 0; cs < t.n_steps; ++cs, ++it) {
      const int st = it % T::kStages, buf = it % 2;
      const int r0 = t.q_first + (cs % t.n_chunks) * ROWS;
      const unsigned char* tQ = sRing + st * L::kStage;
      const unsigned char* tdO = tQ + L::kQ;
      const float* sl = sStats + st * 2 * ROWS;  // lse * log2 e, then delta
      float4* x = sX + buf * X4 * 128 + tid;     // P^T, float4 j at x[128 j]
      float s[ROWS / 2];  // S^T (consumer 0) or dP^T (consumer 1)
      mbar_wait(&full[st], (it / T::kStages) & 1);
      wgmma_fence();
      wgmma_abt<D, ROWS, KEYS, ROWS>(s, sA, c == 0 ? tQ : tdO);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operand(s);
      __syncwarp();
      if (lane == 0 && cs == t.n_steps - 1) mbar_arrive(kv_empty);  // done with K or V
      const bool edge = tile_needs_mask(p, t.n0, KEYS, r0, min(p.Sq, r0 + ROWS));
      if (c == 0) {
        dkv_p<ROWS>(p, s, sl, t.n0 + krow, r0, tq, sl2, edge);
        if (it >= 2) named_barrier_sync(3 + buf, 256);  // consumer 1 has read step it - 2's
#pragma unroll
        for (int j = 0; j < X4; ++j)
          x[128 * j] = make_float4(s[4 * j], s[4 * j + 1], s[4 * j + 2], s[4 * j + 3]);
        named_barrier_arrive(1 + buf, 256);
      } else {
        float pt[ROWS / 2];
        named_barrier_sync(1 + buf, 256);
#pragma unroll
        for (int j = 0; j < X4; ++j) {
          const float4 v = x[128 * j];
          pt[4 * j] = v.x;
          pt[4 * j + 1] = v.y;
          pt[4 * j + 2] = v.z;
          pt[4 * j + 3] = v.w;
        }
        named_barrier_arrive(3 + buf, 256);
        dkv_ds<ROWS>(p, s, pt, sl + ROWS, t.n0 + krow, r0, tq, edge);
      }
      uint32_t a[ROWS / 16][4];  // P^T or dS^T as the A operand
      pack_a<ROWS>(s, a);
      fence_operand(acc);
      wgmma_fence();
      wgmma_ab<D, ROWS, ROWS>(acc, a, c == 0 ? tdO : tQ);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operand(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);  // this consumer is done with the stage
    }
    if (t.n_steps > 0) ++kvi;

    __nv_bfloat16* out = c == 0 ? static_cast<__nv_bfloat16*>(p.dv) + (long long)t.b * p.sdvb +
                                      (long long)t.hk * p.sdvh
                                : static_cast<__nv_bfloat16*>(p.dk) + (long long)t.b * p.sdkb +
                                      (long long)t.hk * p.sdkh;
    const long long stride = c == 0 ? p.sdvs : p.sdks;
    const float scale = c == 0 ? 1.f : p.scale;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int key = t.n0 + krow + 8 * r;
        if (key < p.Skv)
          *reinterpret_cast<__nv_bfloat162*>(out + (long long)key * stride + 8 * i + 2 * tq) =
              __floats2bfloat162_rn(acc[4 * i + 2 * r] * scale, acc[4 * i + 2 * r + 1] * scale);
      }
    }
  }
  if (c == 0)
    for (int j = max(0, it - 2); j < it; ++j) named_barrier_sync(3 + j % 2, 256);
}

template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                               const __grid_constant__ CUtensorMap map_k,
                               const __grid_constant__ CUtensorMap map_v,
                               const __grid_constant__ CUtensorMap map_do, const Params p,
                               int total) {
  using L = DkvSmem<D>;
  using T = DkvTiles<D>;
  using namespace hopper;
  constexpr int ROWS = T::kRows;
  extern __shared__ __align__(16) unsigned char wg_smem[];
  unsigned char* smem = wg_smem + ((1024 - (hopper::smem_u32(wg_smem) & 1023)) & 1023);
  unsigned char* sK = smem;
  unsigned char* sV = smem + L::kV;
  unsigned char* sRing = smem + L::kRing;
  float* sStats = reinterpret_cast<float*>(smem + L::kStats);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* kv_empty = kv_full + 1;
  uint64_t* full = kv_full + 2;
  uint64_t* empty = full + T::kStages;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    mbar_init(kv_empty, 8);  // lane 0 of each of the 8 consumer warps
    for (int s = 0; s < T::kStages; ++s) {
      mbar_init(&full[s], 32);  // the producer warp's lanes (lane 0 with the copies' bytes)
      mbar_init(&empty[s], 8);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer: warp 0.  Lane 0 issues every TMA copy; all 32 lanes write
    // the steps' lse and delta into the ring.  The ring runs on across items.
    // The staging's addresses do not fit 24 registers a thread: 40, and the
    // consumers 232, which the 40 give back exactly.
    reg_dealloc<40>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      int it = 0, kvi = 0;  // steps issued, items with steps issued
      for (int k = 0;; ++k) {
        const int w = item_index(k, total);
        if (w < 0) break;
        const DkvItem t = dkv_item<D>(p, w);
        if (t.n_steps == 0) continue;
        if (lane == 0) {
          // the consumers' last K Q^T and V dO^T of the previous item have retired
          if (kvi > 0) mbar_wait(kv_empty, (kvi - 1) & 1);
          mbar_arrive_expect_tx(kv_full, 2 * L::kKV);
#pragma unroll
          for (int s = 0; s < L::kSlabs; ++s) {
            tma_load_4d(sK + s * L::kKVSlab, &map_k, kv_full, s * 64, t.n0, t.hk, t.b);
            tma_load_4d(sV + s * L::kKVSlab, &map_v, kv_full, s * 64, t.n0, t.hk, t.b);
          }
        }
        ++kvi;
        for (int c = 0; c < t.n_steps; ++c, ++it) {
          const int st = it % T::kStages;
          if (it >= T::kStages) mbar_wait(&empty[st], (it / T::kStages - 1) & 1);
          const int h = t.hk * p.group + c / t.n_chunks;
          const int r0 = t.q_first + (c % t.n_chunks) * ROWS;
          const long long stat = ((long long)t.b * p.H + h) * p.Sq;
          float* sl = sStats + st * 2 * ROWS;
          for (int i = lane; i < ROWS; i += 32) {
            const bool ok = r0 + i < p.Sq;
            sl[i] = ok ? p.lse[stat + r0 + i] * kLog2e : 0.f;
            sl[ROWS + i] = ok ? p.delta[stat + r0 + i] : 0.f;
          }
          if (lane == 0) {
            unsigned char* tQ = sRing + st * L::kStage;
            mbar_arrive_expect_tx(&full[st], L::kStage);
#pragma unroll
            for (int s = 0; s < L::kSlabs; ++s) {
              tma_load_4d(tQ + s * L::kQSlab, &map_q, &full[st], s * 64, r0, h, t.b);
              tma_load_4d(tQ + L::kQ + s * L::kQSlab, &map_do, &full[st], s * 64, r0, h, t.b);
            }
          } else {
            mbar_arrive(&full[st]);
          }
        }
      }
    }
  } else {
    reg_alloc<232>();
    const int c = threadIdx.x / 128 - 1, tid = threadIdx.x % 128;
    if constexpr (T::kSplit)
      dkv_consumer_split<D>(p, total, c, tid, sK, sV, sRing, sStats,
                            reinterpret_cast<float4*>(smem + L::kXchg), kv_full, kv_empty, full,
                            empty);
    else
      dkv_consumer_keys<D>(p, total, c, tid, sK, sV, sRing, sStats, kv_full, kv_empty, full,
                           empty);
  }
}

// ---------------------------------------------------------------------------
// f32: 3xTF32 on the tensor cores (mma.sync m16n8k8, common/tf32_mma.cuh)
// ---------------------------------------------------------------------------

constexpr int kTfChunk = 32;  // a dq key split and a dk/dv row split are multiples of this
constexpr int kTfGroup = 4;   // k steps of a score's head-dim sum taken in the tensor cores

// A warp's 16 x (8 NT) scores X Y^T over HW head dims: X's 16-row strip at
// wA (rows g and g + 8 of its A fragments) against 8 NT rows of Y at wB,
// both in shared memory with rows of LD floats.  Y's rows are read permuted
// (column 2j of an 8-row n-tile is row j, column 2j + 1 row j + 4), so that
// n-tile t's C fragment holds Y rows 8t + q and 8t + q + 4 in columns 2q,
// 2q + 1: element for element the A fragment of k step t of a product with
// Y's rows as the k dimension (`accumulate`), with no shuffles.  The tensor
// cores truncate as they add into an accumulator, so the sum runs there for
// kTfGroup k steps at a time, the two small products of 3xTF32 in a chain of
// their own, and each group is added in f32 (the forward's rule, PERF.md).
template <int HW, int NT, int LD>
__device__ __forceinline__ void partial_scores(float (&s)[NT][4], const float* wA, const float* wB,
                                               int g, int q4) {
  constexpr int G = HW / 8 < kTfGroup ? HW / 8 : kTfGroup;
  static_assert((HW / 8) % G == 0, "whole groups of k steps");
#pragma unroll
  for (int t = 0; t < NT; ++t) s[t][0] = s[t][1] = s[t][2] = s[t][3] = 0.f;
#pragma unroll
  for (int k0 = 0; k0 < HW / 8; k0 += G) {
    float big[NT][4], small[NT][4];
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) big[t][e] = small[t][e] = 0.f;
#pragma unroll
    for (int kk = k0; kk < k0 + G; ++kk) {
      const float* xa = wA + g * LD + kk * 8 + q4;
      const tf32::AFrag a = tf32::a_frag(xa[0], xa[8 * LD], xa[4], xa[8 * LD + 4]);
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const float* yb = wB + (8 * t + (g >> 1) + 4 * (g & 1)) * LD + kk * 8 + q4;
        const tf32::BFrag bf = tf32::b_frag(yb[0], yb[4]);
        if (tf32::kPasses == 3) {
          tf32::mma1(small[t], a.v[0].lo, a.v[1].lo, a.v[2].lo, a.v[3].lo, bf.v[0].hi, bf.v[1].hi);
          tf32::mma1(small[t], a.v[0].hi, a.v[1].hi, a.v[2].hi, a.v[3].hi, bf.v[0].lo, bf.v[1].lo);
        }
        tf32::mma1(big[t], a.v[0].hi, a.v[1].hi, a.v[2].hi, a.v[3].hi, bf.v[0].hi, bf.v[1].hi);
      }
    }
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[t][e] += big[t][e] + small[t][e];
  }
}

// acc (16 x 8 NN) += F Z: F the 16 x (8 NT) C fragments of `partial_scores`
// (k step t is F's n-tile t), Z's rows 8t + q and 8t + q + 4 at wZ (shared,
// rows of LD floats), columns 8n + g.  Each n-tile's sum over the NT k steps
// runs in the tensor cores from zero (one step's rows or keys, as the
// forward's P V) and is then added to acc in f32.
template <int NN, int NT, int LD>
__device__ __forceinline__ void accumulate(float (&acc)[NN][4], const float (&f)[NT][4],
                                           const float* wZ, int g, int q4) {
  tf32::AFrag a[NT];
#pragma unroll
  for (int t = 0; t < NT; ++t) a[t] = tf32::a_frag(f[t][0], f[t][2], f[t][1], f[t][3]);
#pragma unroll
  for (int n = 0; n < NN; ++n) {
    float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const float* zb = wZ + (8 * t + q4) * LD + 8 * n + g;
      tf32::mma(d, a[t], tf32::b_frag(zb[0], zb[4 * LD]));
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] += d[e];
  }
}

// dq's tiles, in floats: the block's Q and dO rows, K and V tiles of a
// step's keys (two of each, one a step, where they fit), and each thread's
// partial S and dP.  A block is 8 warps: 4 strips of 16 q rows, two warps a
// strip, each of which sums half of every S and dP score's head dims and
// holds half of the strip's dQ (80 registers a thread at Dh 320).  Rows of
// D + 4 floats keep the fragment reads at (row g, column q) free of bank
// conflicts (K's reads as dS K's B operand, at (row q, column g), take two
// ways).  224 KB at Dh 320 (one K and one V tile), 168 KB at Dh 128: one
// block an SM.
template <int D>
struct DqTf32Tiles {
  static constexpr int kWarps = 8;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kRows = 64;
  // keys a step: at Dh 320 16, so that a Q, dO, K and V tile fit beside
  // each other in shared memory, as the forward's steps do
  static constexpr int kKeys = D > 128 ? 16 : 32;
  static constexpr int kBufs = D > 128 ? 1 : 2;  // K and V tiles of each
  static constexpr int kHalf = D / 2;
  static constexpr int kLd = D + 4;
  static constexpr int kO = kRows * kLd;
  static constexpr int kK = 2 * kRows * kLd;
  static constexpr int kV = kK + kBufs * kKeys * kLd;
  // partial S, then dP: float4 (w NT + t) 32 + lane
  static constexpr int kX = kV + kBufs * kKeys * kLd;
  static constexpr int kBytes = (kX + kThreads * kKeys) * 4;
  static_assert(kTfChunk % kKeys == 0, "a split starts on a step");
};

// Keys [lo, hi) of dq's key split s for the block of rows [r0, r1): the
// block's keys (key_range, from a multiple of the step) cut at multiples of
// p.chunk.  Empty where the split holds none of them.
template <int D>
__device__ __forceinline__ void dq_split_keys(const Params& p, int r0, int r1, int s, int& lo,
                                              int& hi) {
  constexpr int KEYS = DqTf32Tiles<D>::kKeys;
  int k_lo, k_hi;
  key_range(p, r0, r1, k_lo, k_hi);
  lo = max((k_lo / KEYS) * KEYS, s * p.chunk);
  hi = min(k_hi, (s + 1) * p.chunk);
}

// One block: 64 q rows of one (head, batch) over the keys of one split.  A
// step of KEYS keys: each warp sums its half of dP = dO V^T and of S = Q
// K^T (with two tiles of each, the next step's K and V load during the whole
// step; with one, at Dh 320, dP comes first, so V of the next step loads
// while S, dS and dS K run, K while the next dP does); the two warps of a
// strip swap their halves through shared memory (a barrier of the pair),
// both form P = exp2(S s log2 e - lse log2 e) (ex2.approx, within 2 ulp) and
// dS = P o (dP - delta) on the fragments (dS = 0 off the visible pairs:
// masked, past Skv, and every pair of a row that sees no key), and each
// adds dS K to its half of dQ, dS's C fragment serving as the A fragment.
// With one split it writes dq = scale dQ; with more, its rows' scale dQ go
// to p.part for flash_bwd_dq_combine_kernel.
template <int D>
__global__ void __launch_bounds__(DqTf32Tiles<D>::kThreads, 1)
    flash_bwd_dq_tf32_kernel(const Params p) {
  using T = DqTf32Tiles<D>;
  constexpr int LD = T::kLd, KEYS = T::kKeys, NT = KEYS / 8, HALF = T::kHalf;
  constexpr int ROWS = T::kRows, THREADS = T::kThreads;
  extern __shared__ __align__(16) float tf_smem[];
  float* sQ = tf_smem;
  float* sO = tf_smem + T::kO;
  float* sK = tf_smem + T::kK;
  float* sV = tf_smem + T::kV;
  float4* sXs = reinterpret_cast<float4*>(tf_smem + T::kX);
  float4* sXp = sXs + THREADS * NT;

  const int n_qtiles = (p.Sq + ROWS - 1) / ROWS;
  const int rank = blockIdx.z / p.splits, split = blockIdx.z % p.splits;
  const int r0 = (n_qtiles - 1 - rank) * ROWS;  // longest causal rows first
  const int r1 = min(p.Sq, r0 + ROWS);
  const long long h = blockIdx.x, b = blockIdx.y, hk = h / p.group;
  int k_lo, k_hi;
  dq_split_keys<D>(p, r0, r1, split, k_lo, k_hi);
  // no key of this block in this split: the combine skips it (one split
  // always writes its rows, zeros where they see no key)
  if (k_lo >= k_hi && p.splits > 1) return;
  const int n_steps = k_lo < k_hi ? (k_hi - k_lo + KEYS - 1) / KEYS : 0;

  const float* qg = static_cast<const float*>(p.q) + b * p.sqb + h * p.sqh;
  const float* og = static_cast<const float*>(p.dout) + b * p.sdob + h * p.sdoh;
  const float* kg = static_cast<const float*>(p.k) + b * p.skb + hk * p.skh;
  const float* vg = static_cast<const float*>(p.v) + b * p.svb + hk * p.svh;
  // rows are 16-byte aligned (the wrapper checks): whole 16-byte copies.
  // Q, dO and the first V in one group, the first K in the next
  tf32::load_tile<THREADS>(sQ, LD, qg + r0 * p.sqs, p.sqs, ROWS, D, p.Sq - r0, D, true);
  tf32::load_tile<THREADS>(sO, LD, og + r0 * p.sdos, p.sdos, ROWS, D, p.Sq - r0, D, true);
  // step j's K or V tile: rows from key k_lo + j KEYS, into buffer j % kBufs
  auto load_kv = [&](float* dst, const float* src, long long ld, int j) {
    const int n0 = k_lo + j * KEYS;
    tf32::load_tile<THREADS>(dst + (j % T::kBufs) * KEYS * LD, LD, src + n0 * ld, ld, KEYS, D,
                             p.Skv - n0, D, true);
  };
  if (n_steps > 0) load_kv(sV, vg, p.svs, 0);
  tf32::commit();
  if (n_steps > 0) load_kv(sK, kg, p.sks, 0);
  tf32::commit();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int strip = warp / 2, half = warp % 2;  // 16 q rows; which half of the head dims
  const int g = lane / 4, q4 = lane % 4;        // mma groupID, thread in group
  const int row_a = r0 + strip * 16 + g;        // rows row_a and row_a + 8
  const float sl2 = p.scale * kLog2e;
  const long long stat = (b * p.H + h) * p.Sq;
  float nl2[2], dl[2];  // -lse log2 e and delta of the two rows
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + 8 * r;
    nl2[r] = row < p.Sq ? -p.lse[stat + row] * kLog2e : 0.f;
    dl[r] = row < p.Sq ? p.delta[stat + row] : 0.f;
  }
  const float* wQ = sQ + strip * 16 * LD + half * HALF;
  const float* wO = sO + strip * 16 * LD + half * HALF;
  float acc[HALF / 8][4];  // this half of dQ: n-tile n holds columns half HALF + 8n + 2 q4 (+ 1)
#pragma unroll
  for (int n = 0; n < HALF / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  // dP and S of a step from this step's K and V tiles, then dS in place of
  // S, then dQ += dS K
  auto step = [&](int j, const float* tK, const float* tV) {
    const int n0 = k_lo + j * KEYS;
    float dp[NT][4], s[NT][4];
    partial_scores<HALF, NT, LD>(dp, wO, tV, g, q4);
    if constexpr (T::kBufs == 1) {
      tf32::wait<0>();  // K has landed
      __syncthreads();  // every warp is done with V
      if (j + 1 < n_steps) load_kv(sV, vg, p.svs, j + 1);
      tf32::commit();
    }
    partial_scores<HALF, NT, LD>(s, wQ, tK, g, q4);
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      sXp[(warp * NT + t) * 32 + lane] = make_float4(dp[t][0], dp[t][1], dp[t][2], dp[t][3]);
      sXs[(warp * NT + t) * 32 + lane] = make_float4(s[t][0], s[t][1], s[t][2], s[t][3]);
    }
    hopper::named_barrier_sync(1 + strip, 64);  // both halves of the strip's S and dP are written
    // the other half's sums (addition commutes: both warps get the same S, dP)
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const float4 os = sXs[((warp ^ 1) * NT + t) * 32 + lane];
      const float4 op = sXp[((warp ^ 1) * NT + t) * 32 + lane];
      s[t][0] += os.x, s[t][1] += os.y, s[t][2] += os.z, s[t][3] += os.w;
      dp[t][0] += op.x, dp[t][1] += op.y, dp[t][2] += op.z, dp[t][3] += op.w;
    }
    // dS in place of S: element e of n-tile t is row row_a + 8 (e >> 1), key
    // n0 + 8t + q4 + 4 (e & 1); masks on edge tiles only, as selects
    const bool edge = tile_needs_mask(p, n0, KEYS, r0, r1);
#pragma unroll
    for (int t = 0; t < NT; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float ds = hopper::exp2_approx(fmaf(s[t][e], sl2, nl2[r])) * (dp[t][e] - dl[r]);
        if (edge) {
          const int row = row_a + 8 * r;
          if (!(row < p.Sq && visible(p, row + p.q_offset, n0 + 8 * t + q4 + 4 * (e & 1))))
            ds = 0.f;
        }
        s[t][e] = ds;
      }
    }
    accumulate<HALF / 8, NT, LD>(acc, s, tK, g, q4);
  };

  for (int j = 0; j < n_steps; ++j) {
    const int buf = (j % T::kBufs) * KEYS * LD + half * HALF;
    if constexpr (T::kBufs == 2) {
      tf32::wait<0>();  // this step's K and V have landed
      __syncthreads();  // and every warp is done with the last step's
      if (j + 1 < n_steps) {
        load_kv(sV, vg, p.svs, j + 1);
        load_kv(sK, kg, p.sks, j + 1);
      }
      tf32::commit();
      step(j, sK + buf, sV + buf);
    } else {
      tf32::wait<1>();  // Q, dO and this step's V have landed; K may be in flight
      __syncthreads();
      step(j, sK + buf, sV + buf);
      __syncthreads();  // every warp is done with K
      if (j + 1 < n_steps) load_kv(sK, kg, p.sks, j + 1);
      tf32::commit();
    }
  }
  tf32::wait<0>();

  float* out = p.splits == 1
                   ? static_cast<float*>(p.dq) + b * p.sdqb + h * p.sdqh
                   : p.part + ((split * (long long)p.B + b) * p.H + h) * p.Sq * D;
  const long long ld_out = p.splits == 1 ? p.sdqs : D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + 8 * r;
    if (row >= p.Sq) continue;
    float* dst = out + row * ld_out + half * HALF + 2 * q4;
#pragma unroll
    for (int n = 0; n < HALF / 8; ++n)
      *reinterpret_cast<float2*>(dst + 8 * n) =
          make_float2(acc[n][2 * r] * p.scale, acc[n][2 * r + 1] * p.scale);
  }
}

// Sums dq's key splits, one thread a float4 of dq: the splits that hold keys
// of the row's block, in split order.
template <int D>
__global__ void __launch_bounds__(256) flash_bwd_dq_combine_kernel(const Params p) {
  constexpr int C4 = D / 4, ROWS = DqTf32Tiles<D>::kRows;
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= (long long)p.B * p.H * p.Sq * C4) return;
  const long long wi = i / C4, bh = wi / p.Sq;
  const int c = i % C4, row = wi % p.Sq;
  const long long h = bh % p.H, b = bh / p.H;
  const int r0 = row / ROWS * ROWS, r1 = min(p.Sq, r0 + ROWS);
  const long long stride = (long long)p.B * p.H * p.Sq * C4;  // float4s between splits
  const float4* part = reinterpret_cast<const float4*>(p.part) + i;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s = 0; s < p.splits; ++s) {
    int lo, hi;
    dq_split_keys<D>(p, r0, r1, s, lo, hi);
    if (lo >= hi) continue;
    const float4 v = part[s * stride];
    acc.x += v.x, acc.y += v.y, acc.z += v.z, acc.w += v.w;
  }
  *reinterpret_cast<float4*>(static_cast<float*>(p.dq) + b * p.sdqb + h * p.sdqh +
                             row * p.sdqs + 4 * c) = acc;
}

// dk/dv's tiles, in floats.  A strip is 16 keys, and its warps split the
// work by output: kCols warps hold dV (D / kCols columns each) and kCols hold
// dK, so that no warp holds more than 80 accumulator registers at Dh 320
// (dK and dV of 16 keys x 320 are 320 a thread).  A dV warp sums S^T = K Q^T
// over its part of the head dims, a dK warp dP^T = V dO^T over its part;
// at Dh 320 the two warps of an output swap their partial sums through
// shared memory.  8 warps: 4 strips (64 keys) at Dh <= 128, 2 (32 keys) at
// Dh 320.  A step is kRows q rows of one head; K and V stay for the block,
// Q, dO and the rows' lse and delta go through a ring of two stages.
// 144 KB at Dh 128, 176 KB at Dh 320: one block an SM.
template <int D>
struct DkvTf32Tiles {
  static constexpr int kCols = D > 128 ? 2 : 1;  // column parts of each output
  static constexpr int kStrips = D > 128 ? 2 : 4;
  static constexpr int kWarps = kStrips * 2 * kCols;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kKeys = 16 * kStrips;
  static constexpr int kRows = D > 128 ? 16 : 32;  // q rows a step
  static constexpr int kPart = D / kCols;          // head dims a warp sums, columns it holds
  static constexpr int kLd = D + 4;
  static constexpr int kStages = 2;
  static constexpr int kV = kKeys * kLd;
  static constexpr int kRing = 2 * kKeys * kLd;
  static constexpr int kStage = 2 * kRows * kLd + 2 * kRows;  // Q, dO, lse, delta
  static constexpr int kP = kRing + kStages * kStage;        // P^T: float4 (strip NT + t) 32 + lane
  // partial sums: float4 (w NT + t) 32 + lane
  static constexpr int kX = kP + kStrips * kRows * 16;
  static constexpr int kBytes = (kX + (kCols > 1 ? kThreads * kRows / 2 : 0)) * 4;
  static_assert(kTfChunk % kRows == 0, "a split starts on a step");
};

// Q rows [lo, hi) of dk/dv's row split s for the keys [n0, n1): the rows
// they take gradient from (query_range, from a multiple of the step) cut at
// multiples of p.chunk.  Empty where the split holds none of them.
template <int D>
__device__ __forceinline__ void dkv_split_rows(const Params& p, int n0, int n1, int s, int& lo,
                                               int& hi) {
  constexpr int ROWS = DkvTf32Tiles<D>::kRows;
  int q_lo, q_hi;
  query_range(p, n0, n1, q_lo, q_hi);
  lo = max((q_lo / ROWS) * ROWS, s * p.chunk);
  hi = min(q_hi, (s + 1) * p.chunk);
}

// One block: a tile of keys of one (kv head, batch), over the q rows of one
// row split and either every head of the group in turn (p.head_splits 1) or
// one of them (p.head_splits = group).  A step, in each strip: the dV warps
// form S^T and P^T = exp2(S^T s log2 e - lse log2 e) (lse and delta indexed
// by column; a row that sees no key takes p = 1/Skv on every key, a masked
// pair or a key past Skv 0) and pass P^T to the dK warps through shared
// memory (a barrier of the strip's warps); the dK warps form dP^T and dS^T
// = P^T o (dP^T - delta) (0 off the visible pairs); then dV += P^T dO and dK
// += dS^T Q, the C fragments serving as A fragments.  The GQA sum happens in
// the accumulators (p.head_splits 1) or in the combine.  The key tiles are
// the slowest grid dimension, so the heaviest causal ones start first.
// With one split of rows and heads it writes dk = scale dK and dv = dV;
// with more, the split's partials go to p.part for
// flash_bwd_dkv_combine_kernel.
template <int D>
__global__ void __launch_bounds__(DkvTf32Tiles<D>::kThreads, 1)
    flash_bwd_dkv_tf32_kernel(const Params p) {
  using T = DkvTf32Tiles<D>;
  constexpr int LD = T::kLd, KEYS = T::kKeys, R = T::kRows, NT = R / 8, PART = T::kPart;
  constexpr int THREADS = T::kThreads, COLS = T::kCols;
  extern __shared__ __align__(16) float tf_smem[];
  float* sK = tf_smem;
  float* sV = tf_smem + T::kV;
  float* ring = tf_smem + T::kRing;
  float4* sP = reinterpret_cast<float4*>(tf_smem + T::kP);
  float4* sX = reinterpret_cast<float4*>(tf_smem + T::kX);

  // the slowest grid dimension walks the key tiles: the heaviest causal
  // ones (the first) start first
  const int kt = blockIdx.z / p.splits, split = blockIdx.z % p.splits;
  const int hsel = blockIdx.x % p.head_splits;
  const long long hk = blockIdx.x / p.head_splits, b = blockIdx.y;
  const int n0 = kt * KEYS, n1 = min(p.Skv, n0 + KEYS);
  int q_lo, q_hi;
  dkv_split_rows<D>(p, n0, n1, split, q_lo, q_hi);
  const bool parts = p.splits * p.head_splits > 1;
  // no row of these keys in this split: the combine skips it (one split
  // always writes its keys, zeros where no row sees them)
  if (q_lo >= q_hi && parts) return;
  const int n_steps = q_lo < q_hi ? (q_hi - q_lo + R - 1) / R : 0;
  const int n_heads = p.head_splits == 1 ? p.group : 1;
  const long long h_first = hk * p.group + (p.head_splits == 1 ? 0 : hsel);
  const int total = n_heads * n_steps;

  const float* kg = static_cast<const float*>(p.k) + b * p.skb + hk * p.skh;
  const float* vg = static_cast<const float*>(p.v) + b * p.svb + hk * p.svh;
  tf32::load_tile<THREADS>(sK, LD, kg + n0 * p.sks, p.sks, KEYS, D, p.Skv - n0, D, true);
  tf32::load_tile<THREADS>(sV, LD, vg + n0 * p.svs, p.svs, KEYS, D, p.Skv - n0, D, true);
  // step c: head h_first + c / n_steps, rows from q_lo + (c % n_steps) R;
  // rows past Sq load as zeros (and add nothing: their dO and Q are 0)
  auto load_step = [&](int c) {
    const long long h = h_first + c / n_steps;
    const int r0 = q_lo + (c % n_steps) * R;
    float* st = ring + (c % T::kStages) * T::kStage;
    const float* qg = static_cast<const float*>(p.q) + b * p.sqb + h * p.sqh + r0 * p.sqs;
    const float* og = static_cast<const float*>(p.dout) + b * p.sdob + h * p.sdoh + r0 * p.sdos;
    tf32::load_tile<THREADS>(st, LD, qg, p.sqs, R, D, p.Sq - r0, D, true);
    tf32::load_tile<THREADS>(st + R * LD, LD, og, p.sdos, R, D, p.Sq - r0, D, true);
    const long long stat = (b * p.H + h) * p.Sq + r0;
    for (int i = threadIdx.x; i < 2 * R; i += THREADS) {
      const int r = i % R;
      const float* src = (i < R ? p.lse : p.delta) + stat;
      tf32::cp4(st + 2 * R * LD + i, src + (r0 + r < p.Sq ? r : 0), r0 + r < p.Sq);
    }
  };
  if (total > 0) load_step(0);
  tf32::commit();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int strip = warp / (2 * COLS), role = warp % (2 * COLS);
  const bool is_v = role < COLS;  // dV warps first in a strip, then dK warps
  const int cpart = role % COLS;  // which part of the head dims and of the output's columns
  const int g = lane / 4, q4 = lane % 4;
  const int key_a = n0 + strip * 16 + g;  // keys key_a and key_a + 8
  const float sl2 = p.scale * kLog2e;
  // a dV warp: S^T from K and Q, then dV += P^T dO; a dK warp: dP^T from V
  // and dO, then dK += dS^T Q
  const float* wA = (is_v ? sK : sV) + strip * 16 * LD + cpart * PART;
  float acc[PART / 8][4];  // n-tile n holds columns cpart PART + 8n + 2 q4 (+ 1)
#pragma unroll
  for (int n = 0; n < PART / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int c = 0; c < total; ++c) {
    tf32::wait<0>();  // this step's stage (and K, V) have landed
    __syncthreads();  // and every warp is done with the last step's
    if (c + 1 < total) load_step(c + 1);
    tf32::commit();
    const float* stQ = ring + (c % T::kStages) * T::kStage;
    const float* stO = stQ + R * LD;
    const float* stL = stQ + 2 * R * LD;  // lse, then delta
    const int r0 = q_lo + (c % n_steps) * R;
    float s[NT][4];
    partial_scores<PART, NT, LD>(s, wA, (is_v ? stQ : stO) + cpart * PART, g, q4);
    if constexpr (COLS > 1) {
#pragma unroll
      for (int t = 0; t < NT; ++t)
        sX[(warp * NT + t) * 32 + lane] = make_float4(s[t][0], s[t][1], s[t][2], s[t][3]);
      hopper::named_barrier_sync(1 + warp / 2, 64);  // the pair's partial sums are written
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const float4 o = sX[((warp ^ 1) * NT + t) * 32 + lane];
        s[t][0] += o.x, s[t][1] += o.y, s[t][2] += o.z, s[t][3] += o.w;
      }
    }
    // element e of n-tile t: key key_a + 8 (e >> 1), row r0 + 8t + q4 + 4 (e & 1)
    const bool edge = tile_needs_mask(p, n0, KEYS, r0, min(p.Sq, r0 + R));
    if (is_v) {
#pragma unroll
      for (int t = 0; t < NT; ++t) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ri = 8 * t + q4 + 4 * (e & 1);
          const float nl2 = -stL[ri] * kLog2e;
          float pr = hopper::exp2_approx(fmaf(s[t][e], sl2, nl2));
          if (edge) {
            const int row = r0 + ri, key = key_a + 8 * (e >> 1), qpos = row + p.q_offset;
            if (!(row < p.Sq && visible(p, qpos, key)))
              pr = row < p.Sq && key < p.Skv && sees_no_key(p, qpos) ? hopper::exp2_approx(nl2)
                                                                     : 0.f;
          }
          s[t][e] = pr;
        }
        if (cpart == 0)
          sP[(strip * NT + t) * 32 + lane] = make_float4(s[t][0], s[t][1], s[t][2], s[t][3]);
      }
    }
    // P^T is written: a barrier of the strip's warps
    hopper::named_barrier_sync(1 + T::kWarps / 2 + strip, 64 * COLS);
    if (!is_v) {
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const float4 pt = sP[(strip * NT + t) * 32 + lane];
        const float pe[4] = {pt.x, pt.y, pt.z, pt.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ri = 8 * t + q4 + 4 * (e & 1);
          float ds = pe[e] * (s[t][e] - stL[R + ri]);
          if (edge) {
            const int row = r0 + ri;
            if (!(row < p.Sq && visible(p, row + p.q_offset, key_a + 8 * (e >> 1)))) ds = 0.f;
          }
          s[t][e] = ds;
        }
      }
    }
    accumulate<PART / 8, NT, LD>(acc, s, (is_v ? stO : stQ) + cpart * PART, g, q4);
  }
  tf32::wait<0>();

  const long long plane = (long long)p.B * p.Hk * p.Skv * D;  // floats of one partial
  const long long at = (b * p.Hk + hk) * p.Skv * D;
  const long long pi = (long long)split * p.head_splits + hsel;
  float* out;
  long long ld_out;
  if (!parts) {
    out = is_v ? static_cast<float*>(p.dv) + b * p.sdvb + hk * p.sdvh
               : static_cast<float*>(p.dk) + b * p.sdkb + hk * p.sdkh;
    ld_out = is_v ? p.sdvs : p.sdks;
  } else {
    const long long n_parts = (long long)p.splits * p.head_splits;
    out = p.part + (is_v ? n_parts + pi : pi) * plane + at;
    ld_out = D;
  }
  const float sc = is_v ? 1.f : p.scale;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key_a + 8 * r;
    if (key >= p.Skv) continue;
    float* dst = out + key * ld_out + cpart * PART + 2 * q4;
#pragma unroll
    for (int n = 0; n < PART / 8; ++n)
      *reinterpret_cast<float2*>(dst + 8 * n) =
          make_float2(acc[n][2 * r] * sc, acc[n][2 * r + 1] * sc);
  }
}

// Sums dk/dv's partials, one thread a float4 of dk and of dv: the row splits
// that hold rows of the key's tile, each over its head splits, in one fixed
// order.
template <int D>
__global__ void __launch_bounds__(256) flash_bwd_dkv_combine_kernel(const Params p) {
  constexpr int C4 = D / 4, KEYS = DkvTf32Tiles<D>::kKeys;
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= (long long)p.B * p.Hk * p.Skv * C4) return;
  const long long wi = i / C4, bhk = wi / p.Skv;
  const int c = i % C4, key = wi % p.Skv;
  const long long hk = bhk % p.Hk, b = bhk / p.Hk;
  const int n0 = key / KEYS * KEYS, n1 = min(p.Skv, n0 + KEYS);
  const long long stride = (long long)p.B * p.Hk * p.Skv * C4;  // float4s between partials
  const long long n_parts = (long long)p.splits * p.head_splits;
  const float4* part = reinterpret_cast<const float4*>(p.part) + i;
  float4 dk = make_float4(0.f, 0.f, 0.f, 0.f), dv = dk;
  for (int s = 0; s < p.splits; ++s) {
    int lo, hi;
    dkv_split_rows<D>(p, n0, n1, s, lo, hi);
    if (lo >= hi) continue;
    for (int hs = 0; hs < p.head_splits; ++hs) {
      const long long pi = (long long)s * p.head_splits + hs;
      const float4 x = part[pi * stride], y = part[(n_parts + pi) * stride];
      dk.x += x.x, dk.y += x.y, dk.z += x.z, dk.w += x.w;
      dv.x += y.x, dv.y += y.y, dv.z += y.z, dv.w += y.w;
    }
  }
  *reinterpret_cast<float4*>(static_cast<float*>(p.dk) + b * p.sdkb + hk * p.sdkh +
                             key * p.sdks + 4 * c) = dk;
  *reinterpret_cast<float4*>(static_cast<float*>(p.dv) + b * p.sdvb + hk * p.sdvh +
                             key * p.sdvs + 4 * c) = dv;
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

// The f32 kernel over its splits (dq: p.splits of the keys; dk/dv: p.splits
// of the rows times p.head_splits), then, with more than one, its combine.
template <int D>
cudaError_t launch_tf32(const Params& p, bool dq, cudaStream_t stream) {
  cudaError_t err;
  if (dq) {
    using T = DqTf32Tiles<D>;
    err = cudaFuncSetAttribute(flash_bwd_dq_tf32_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, T::kBytes);
    if (err != cudaSuccess) return err;
    const dim3 grid(p.H, p.B, (p.Sq + T::kRows - 1) / T::kRows * p.splits);
    flash_bwd_dq_tf32_kernel<D><<<grid, T::kThreads, T::kBytes, stream>>>(p);
    if (p.splits > 1) {
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
      const long long n = (long long)p.B * p.H * p.Sq * (D / 4);
      flash_bwd_dq_combine_kernel<D><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(p);
    }
  } else {
    using T = DkvTf32Tiles<D>;
    err = cudaFuncSetAttribute(flash_bwd_dkv_tf32_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, T::kBytes);
    if (err != cudaSuccess) return err;
    const dim3 grid(p.Hk * p.head_splits, p.B, (p.Skv + T::kKeys - 1) / T::kKeys * p.splits);
    flash_bwd_dkv_tf32_kernel<D><<<grid, T::kThreads, T::kBytes, stream>>>(p);
    if (p.splits * p.head_splits > 1) {
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
      const long long n = (long long)p.B * p.Hk * p.Skv * (D / 4);
      flash_bwd_dkv_combine_kernel<D><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(p);
    }
  }
  return cudaGetLastError();
}

template <int D, bool DQ>
cudaError_t launch_mma(const Params& p, cudaStream_t stream) {
  using T = MmaTiles<D>;
  if constexpr (DQ) {
    cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_bf16_kernel<D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           T::kDqSmem);
    if (err != cudaSuccess) return err;
    const dim3 grid((p.Sq + T::kDqRows - 1) / T::kDqRows, p.H, p.B);
    flash_bwd_dq_bf16_kernel<D><<<grid, T::kThreads, T::kDqSmem, stream>>>(p);
  } else {
    cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_bf16_kernel<D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           T::kDkvSmem);
    if (err != cudaSuccess) return err;
    const dim3 grid((p.Skv + kRows - 1) / kRows, p.Hk, p.B);
    flash_bwd_dkv_bf16_kernel<D><<<grid, T::kThreads, T::kDkvSmem, stream>>>(p);
  }
  return cudaGetLastError();
}

// maps: the geometry of the q, k, v and dout maps (hopper::kMapFields
// each).  The boxes must be the tiles whose bytes the kernels' barriers
// count: dq loads Q and dO tiles of an item's rows and K and V tiles of a
// step's keys (DqTiles); dk/dv loads Q and dO tiles of a step's rows and K
// and V tiles of an item's keys (DkvTiles).  Returns a cudaError_t, or minus the CUresult of a failed
// encode.
template <int D, bool DQ>
int launch_wgmma(const Params& p, const long long* maps, cudaStream_t stream) {
  const void* base[4] = {p.q, p.k, p.v, p.dout};
  const long long q_rows = DQ ? DqTiles<D>::kRows : DkvTiles<D>::kRows;
  const long long kv_rows = DQ ? DqTiles<D>::kKeys : DkvTiles<D>::kKeys;
  const long long rows[4] = {q_rows, kv_rows, kv_rows, q_rows};
  const long long seq[4] = {p.Sq, p.Skv, p.Skv, p.Sq};
  const long long heads[4] = {p.H, p.Hk, p.Hk, p.H};
  CUtensorMap m[4];
  if (maps == nullptr) return cudaErrorInvalidValue;
  for (int i = 0; i < 4; ++i) {
    const long long* g = maps + hopper::kMapFields * i;
    if (g[0] != D || g[1] != seq[i] || g[2] != heads[i] || g[3] != p.B || g[7] != 64 ||
        g[8] != rows[i] || g[9] != 1 || g[10] != 1)
      return cudaErrorInvalidValue;
    const int r = hopper::encode_map(&m[i], base[i], g);
    if (r != 0) return -r;
  }
  // persistent: at most one block per SM, each walking its share of items
  int dev, sms;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if constexpr (DQ) {
    const int smem = DqSmem<D>::kBytes;
    err = cudaFuncSetAttribute(flash_bwd_dq_wgmma_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    constexpr int ROWS = DqTiles<D>::kRows;
    const int total = (p.Sq + ROWS - 1) / ROWS * p.H * p.B;
    flash_bwd_dq_wgmma_kernel<D><<<min(total, sms), kWgThreads, smem, stream>>>(
        m[0], m[1], m[2], m[3], p, total);
  } else {
    constexpr int KEYS = DkvTiles<D>::kKeys;
    const int smem = DkvSmem<D>::kBytes;
    err = cudaFuncSetAttribute(flash_bwd_dkv_wgmma_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const int total = (p.Skv + KEYS - 1) / KEYS * p.Hk * p.B;
    flash_bwd_dkv_wgmma_kernel<D><<<min(total, sms), kWgThreads, smem, stream>>>(
        m[0], m[1], m[2], m[3], p, total);
  }
  return cudaGetLastError();
}

// dtype 1 at Dh 64, 128 and 320 takes the TMA / wgmma kernels, Dh 16 / 32
// the mma.sync ones (no model of the repo has Dh < 64); dtype 0 the f32
// ones
template <bool DQ>
int launch(const Params& p, int dtype, int D, const long long* maps, cudaStream_t stream) {
  if (dtype == 1) {
    switch (D) {
      case 16: return launch_mma<16, DQ>(p, stream);
      case 32: return launch_mma<32, DQ>(p, stream);
      case 64: return launch_wgmma<64, DQ>(p, maps, stream);
      case 128: return launch_wgmma<128, DQ>(p, maps, stream);
      case 320: return launch_wgmma<320, DQ>(p, maps, stream);
    }
  } else if (dtype == 0) {
    if (p.chunk <= 0 || p.chunk % kTfChunk != 0 ||
        (p.head_splits != 1 && (DQ || p.head_splits != p.group)) ||
        (p.splits * p.head_splits > 1 && p.part == nullptr))
      return cudaErrorInvalidValue;
    switch (D) {
      case 16: return launch_tf32<16>(p, DQ, stream);
      case 32: return launch_tf32<32>(p, DQ, stream);
      case 64: return launch_tf32<64>(p, DQ, stream);
      case 128: return launch_tf32<128>(p, DQ, stream);
      case 320: return launch_tf32<320>(p, DQ, stream);
    }
  }
  return cudaErrorInvalidValue;
}

Params make_params(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, void* dq, void* dk, void* dv, int B,
                   int H, int Hk, int Sq, int Skv, const long long* strides, float scale,
                   int causal, int window, int q_offset, void* part, int chunk,
                   int head_splits, int split_extent) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.B = B;
  p.H = H;
  p.Hk = Hk;
  p.Sq = Sq;
  p.Skv = Skv;
  p.group = H / Hk;
  long long* dst[21] = {&p.sqb,  &p.sqh,  &p.sqs,  &p.skb,  &p.skh,  &p.sks,  &p.svb,
                        &p.svh,  &p.svs,  &p.sdob, &p.sdoh, &p.sdos, &p.sdqb, &p.sdqh,
                        &p.sdqs, &p.sdkb, &p.sdkh, &p.sdks, &p.sdvb, &p.sdvh, &p.sdvs};
  for (int i = 0; i < 21; ++i) *dst[i] = strides[i];
  p.scale = scale;
  p.causal = causal;
  p.has_window = window > 0;
  p.window = window;
  p.q_offset = q_offset;
  p.chunk = chunk;
  p.splits = chunk > 0 ? (split_extent + chunk - 1) / chunk : 0;
  p.head_splits = head_splits;
  p.part = static_cast<float*>(part);
  return p;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  `strides` holds 21 element strides,
// (batch, head, row) of q, k, v, dout, dq, dk, dv in that order; the last
// dimension of every tensor is contiguous.  lse and delta are contiguous
// (B, H, Sq) f32.  window <= 0 means no window.  maps: for the wgmma
// kernels (bf16 at Dh 64, 128 and 320), the geometry of the q, k, v and
// dout tensor maps (4 x 11 integers, see hopper::encode_map); else null.
// flash_bwd_dq writes dq; flash_bwd_dkv writes dk and dv, summed over each
// kv head's query group.  f32 only (flash_attention.py, f32_key_split and
// f32_dkv_split): `chunk`, the keys (dq) or q rows (dk/dv) of one split, a
// multiple of 32; `head_splits` (dk/dv; 1 for dq), 1 or H / Hk; `part`,
// scratch for the splits' partials: splits x B x H x Sq x D floats (dq,
// splits = ceil(Skv / chunk)), 2 x splits x head_splits x B x Hk x Skv x D
// (dk/dv, splits = ceil(Sq / chunk)), or null where that is one split.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, void* dq, int dtype, int B, int H,
                            int Hk, int Sq, int Skv, int D, const long long* strides, float scale,
                            int causal, int window, int q_offset, void* stream,
                            const long long* maps, void* part, int chunk, int head_splits) {
  const Params p = make_params(q, k, v, dout, lse, delta, dq, nullptr, nullptr, B, H, Hk, Sq, Skv,
                               strides, scale, causal, window, q_offset, part, chunk,
                               head_splits, Skv);
  return launch<true>(p, dtype, D, maps, static_cast<cudaStream_t>(stream));
}

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta, void* dk, void* dv, int dtype,
                             int B, int H, int Hk, int Sq, int Skv, int D,
                             const long long* strides, float scale, int causal, int window,
                             int q_offset, void* stream, const long long* maps, void* part,
                             int chunk, int head_splits) {
  const Params p = make_params(q, k, v, dout, lse, delta, nullptr, dk, dv, B, H, Hk, Sq, Skv,
                               strides, scale, causal, window, q_offset, part, chunk,
                               head_splits, Sq);
  return launch<false>(p, dtype, D, maps, static_cast<cudaStream_t>(stream));
}
