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
// accumulators feed the next products.  The f32 path (not on the training
// path; it lets a small f32 model be checked tightly on the card) is SIMT
// FMA with 4 threads per row, 8 at Dh 320.
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
};

// P of (row, key) from the row's lse, given the scaled score; `vis` says
// whether the pair's score is differentiable (dS is 0 elsewhere).
template <bool kFast>
__device__ __forceinline__ float prob(const Params& p, float s, float lse, int row, int key,
                                      bool& vis) {
  const int qpos = row + p.q_offset;
  vis = row < p.Sq && visible(p, qpos, key);
  if (vis) return kFast ? __expf(s - lse) : expf(s - lse);
  if (row < p.Sq && key < p.Skv && sees_no_key(p, qpos)) return kFast ? __expf(-lse) : expf(-lse);
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
        const float pr = prob<true>(p, s[t][e] * p.scale, lse[i], row[i],
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
        const float pr = prob<true>(p, st[t][e] * p.scale, tL[col], r0 + col, key[e >> 1], vis);
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
// f32: SIMT FMA, TPR threads per row (each holds D / TPR of it as float4s)
// ---------------------------------------------------------------------------

constexpr int kF32Threads = 256;

// Up to Dh 128: 4 threads a row, 64 rows (keys) a block, 32 keys (rows) a
// step.  Dh 320: 8 threads a row, so that a thread's share of q, dO and dQ
// (dq) or of k, v, dK and dV (dk/dv) stays within 160 registers, and 16 a
// step, so that the two tiles of a step (40 KB) fit the 48 KB of static
// shared memory, as the forward's f32 kernel does.
template <int D>
struct F32Tiles {
  static constexpr int kTPR = D > 128 ? 8 : 4;
  static constexpr int kRows = kF32Threads / kTPR;  // q rows of a dq block, keys of a dk/dv block
  static constexpr int kStep = D > 128 ? 16 : 32;   // keys (dq) or q rows (dk/dv) per step
  static constexpr int kChunks = D / (4 * kTPR);    // float4s of a row a thread holds
};

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

__device__ __forceinline__ void fma4(float4& acc, float s, float4 x) {
  acc.x += s * x.x;
  acc.y += s * x.y;
  acc.z += s * x.z;
  acc.w += s * x.w;
}

// sum over the TPR threads of a row
template <int TPR>
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int m = 1; m < TPR; m *= 2) x += __shfl_xor_sync(0xffffffffu, x, m);
  return x;
}

// rows [row0, row0 + STEP) of a (rows, D) f32 slab into shared memory; zero past `limit`
template <int D, int STEP>
__device__ __forceinline__ void load_tile_f32(float (*dst)[D], const float* src, long long stride,
                                              int row0, int limit) {
  for (int c = threadIdx.x; c < STEP * (D / 4); c += kF32Threads) {
    const int r = c / (D / 4), col = (c % (D / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < limit) x = *reinterpret_cast<const float4*>(src + (row0 + r) * stride + col);
    *reinterpret_cast<float4*>(&dst[r][col]) = x;
  }
}

template <int D>
__global__ void __launch_bounds__(kF32Threads) flash_bwd_dq_f32_kernel(const Params p) {
  using T = F32Tiles<D>;
  constexpr int C = T::kChunks, TPR = T::kTPR, ROWS = T::kRows, STEP = T::kStep;
  __shared__ __align__(16) float sK[STEP][D];
  __shared__ __align__(16) float sV[STEP][D];

  const int n_qtiles = (p.Sq + ROWS - 1) / ROWS;
  const int r0 = (n_qtiles - 1 - (int)blockIdx.x) * ROWS;
  const int r1 = min(p.Sq, r0 + ROWS);
  const long long b = blockIdx.z, h = blockIdx.y, hk = h / p.group;
  const int part = threadIdx.x % TPR;
  const int r = r0 + threadIdx.x / TPR;

  const float* qg = static_cast<const float*>(p.q) + b * p.sqb + h * p.sqh;
  const float* og = static_cast<const float*>(p.dout) + b * p.sdob + h * p.sdoh;
  const float* kg = static_cast<const float*>(p.k) + b * p.skb + hk * p.skh;
  const float* vg = static_cast<const float*>(p.v) + b * p.svb + hk * p.svh;
  float* dqg = static_cast<float*>(p.dq) + b * p.sdqb + h * p.sdqh;

  // chunk c of this thread is float4 c * TPR + part of the row
  float4 q[C], o[C], acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    q[c] = o[c] = acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < p.Sq) {
      q[c] = *reinterpret_cast<const float4*>(qg + r * p.sqs + (c * TPR + part) * 4);
      o[c] = *reinterpret_cast<const float4*>(og + r * p.sdos + (c * TPR + part) * 4);
    }
  }
  const long long stat = (b * p.H + h) * p.Sq;
  const float lse = r < p.Sq ? p.lse[stat + r] : 0.f;
  const float delta = r < p.Sq ? p.delta[stat + r] : 0.f;

  int k_lo, k_hi;
  key_range(p, r0, r1, k_lo, k_hi);
  for (int n0 = (k_lo / STEP) * STEP; n0 < k_hi; n0 += STEP) {
    __syncthreads();
    load_tile_f32<D, STEP>(sK, kg, p.sks, n0, p.Skv);
    load_tile_f32<D, STEP>(sV, vg, p.svs, n0, p.Skv);
    __syncthreads();
    for (int j = 0; j < STEP; ++j) {
      const float4* kr = reinterpret_cast<const float4*>(sK[j]);
      const float4* vr = reinterpret_cast<const float4*>(sV[j]);
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        s += dot4(q[c], kr[c * TPR + part]);
        dp += dot4(o[c], vr[c * TPR + part]);
      }
      s = row_sum<TPR>(s);
      dp = row_sum<TPR>(dp);
      bool vis;
      const float pr = prob<false>(p, s * p.scale, lse, r, n0 + j, vis);
      if (!vis) continue;
      const float ds = pr * (dp - delta);
#pragma unroll
      for (int c = 0; c < C; ++c) fma4(acc[c], ds, kr[c * TPR + part]);
    }
  }

  if (r >= p.Sq) return;
#pragma unroll
  for (int c = 0; c < C; ++c)
    *reinterpret_cast<float4*>(dqg + r * p.sdqs + (c * TPR + part) * 4) =
        make_float4(acc[c].x * p.scale, acc[c].y * p.scale, acc[c].z * p.scale,
                    acc[c].w * p.scale);
}

template <int D>
__global__ void __launch_bounds__(kF32Threads) flash_bwd_dkv_f32_kernel(const Params p) {
  using T = F32Tiles<D>;
  constexpr int C = T::kChunks, TPR = T::kTPR, ROWS = T::kRows, STEP = T::kStep;
  __shared__ __align__(16) float sQ[STEP][D];
  __shared__ __align__(16) float sO[STEP][D];
  __shared__ float sL[STEP], sD[STEP];

  const int n0 = blockIdx.x * ROWS;
  const int n1 = min(p.Skv, n0 + ROWS);
  const long long b = blockIdx.z, hk = blockIdx.y;
  const int part = threadIdx.x % TPR;
  const int key = n0 + threadIdx.x / TPR;

  const float* kg = static_cast<const float*>(p.k) + b * p.skb + hk * p.skh;
  const float* vg = static_cast<const float*>(p.v) + b * p.svb + hk * p.svh;
  float* dkg = static_cast<float*>(p.dk) + b * p.sdkb + hk * p.sdkh;
  float* dvg = static_cast<float*>(p.dv) + b * p.sdvb + hk * p.sdvh;

  float4 k[C], v[C], dk[C], dv[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    k[c] = v[c] = dk[c] = dv[c] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (key < p.Skv) {
      k[c] = *reinterpret_cast<const float4*>(kg + key * p.sks + (c * TPR + part) * 4);
      v[c] = *reinterpret_cast<const float4*>(vg + key * p.svs + (c * TPR + part) * 4);
    }
  }

  int q_lo, q_hi;
  query_range(p, n0, n1, q_lo, q_hi);
  for (int g = 0; g < p.group; ++g) {
    const long long h = hk * p.group + g;
    const float* qg = static_cast<const float*>(p.q) + b * p.sqb + h * p.sqh;
    const float* og = static_cast<const float*>(p.dout) + b * p.sdob + h * p.sdoh;
    const long long stat = (b * p.H + h) * p.Sq;
    for (int r0 = (q_lo / STEP) * STEP; r0 < q_hi; r0 += STEP) {
      __syncthreads();
      load_tile_f32<D, STEP>(sQ, qg, p.sqs, r0, p.Sq);
      load_tile_f32<D, STEP>(sO, og, p.sdos, r0, p.Sq);
      for (int i = threadIdx.x; i < STEP; i += kF32Threads) {
        sL[i] = r0 + i < p.Sq ? p.lse[stat + r0 + i] : 0.f;
        sD[i] = r0 + i < p.Sq ? p.delta[stat + r0 + i] : 0.f;
      }
      __syncthreads();
      for (int i = 0; i < STEP; ++i) {
        const float4* qr = reinterpret_cast<const float4*>(sQ[i]);
        const float4* orow = reinterpret_cast<const float4*>(sO[i]);
        float s = 0.f, dp = 0.f;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          s += dot4(k[c], qr[c * TPR + part]);
          dp += dot4(v[c], orow[c * TPR + part]);
        }
        s = row_sum<TPR>(s);
        dp = row_sum<TPR>(dp);
        bool vis;
        const float pr = prob<false>(p, s * p.scale, sL[i], r0 + i, key, vis);
        const float ds = vis ? pr * (dp - sD[i]) : 0.f;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          fma4(dv[c], pr, orow[c * TPR + part]);
          fma4(dk[c], ds, qr[c * TPR + part]);
        }
      }
    }
  }

  if (key >= p.Skv) return;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    *reinterpret_cast<float4*>(dkg + key * p.sdks + (c * TPR + part) * 4) =
        make_float4(dk[c].x * p.scale, dk[c].y * p.scale, dk[c].z * p.scale, dk[c].w * p.scale);
    *reinterpret_cast<float4*>(dvg + key * p.sdvs + (c * TPR + part) * 4) = dv[c];
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <int D>
cudaError_t launch_f32(const Params& p, bool dq, cudaStream_t stream) {
  constexpr int ROWS = F32Tiles<D>::kRows;
  if (dq) {
    const dim3 grid((p.Sq + ROWS - 1) / ROWS, p.H, p.B);
    flash_bwd_dq_f32_kernel<D><<<grid, kF32Threads, 0, stream>>>(p);
  } else {
    const dim3 grid((p.Skv + ROWS - 1) / ROWS, p.Hk, p.B);
    flash_bwd_dkv_f32_kernel<D><<<grid, kF32Threads, 0, stream>>>(p);
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
    switch (D) {
      case 16: return launch_f32<16>(p, DQ, stream);
      case 32: return launch_f32<32>(p, DQ, stream);
      case 64: return launch_f32<64>(p, DQ, stream);
      case 128: return launch_f32<128>(p, DQ, stream);
      case 320: return launch_f32<320>(p, DQ, stream);
    }
  }
  return cudaErrorInvalidValue;
}

Params make_params(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, void* dq, void* dk, void* dv, int B,
                   int H, int Hk, int Sq, int Skv, const long long* strides, float scale,
                   int causal, int window, int q_offset) {
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
// kv head's query group.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, void* dq, int dtype, int B, int H,
                            int Hk, int Sq, int Skv, int D, const long long* strides, float scale,
                            int causal, int window, int q_offset, void* stream,
                            const long long* maps) {
  const Params p = make_params(q, k, v, dout, lse, delta, dq, nullptr, nullptr, B, H, Hk, Sq, Skv,
                               strides, scale, causal, window, q_offset);
  return launch<true>(p, dtype, D, maps, static_cast<cudaStream_t>(stream));
}

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta, void* dk, void* dv, int dtype,
                             int B, int H, int Hk, int Sq, int Skv, int D,
                             const long long* strides, float scale, int causal, int window,
                             int q_offset, void* stream, const long long* maps) {
  const Params p = make_params(q, k, v, dout, lse, delta, nullptr, dk, dv, B, H, Hk, Sq, Skv,
                               strides, scale, causal, window, q_offset);
  return launch<false>(p, dtype, D, maps, static_cast<cudaStream_t>(stream));
}
