// Flash-attention forward for Hopper (sm_90a), written by hand.
//
// Replaces the TPU kernels `_flash_fwd_kernel` and `_flash_fwd_lse_kernel` of
// src/repro/kernels/flash_attention/flash_attention.py:35 and :79, reached
// there through `flash_attention_fwd` (:315) and `flash_attention_fwd_lse`
// (:200).  It computes the same function: blockwise causal / sliding-window
// GQA attention with an online softmax (running max m, running sum l, f32
// accumulator), a `q_offset` that places the q block in the kv timeline,
// scale defaulting to Dh**-0.5, output in the input dtype.  Query head h
// reads kv head h / (H / Hk).
//
// What bounds it on the H100.  At the serving prefill shape (B=4, H=24, Hk=8,
// S=1024, Dh=128, bf16, causal) the work is 2.58e10 FLOP over the visible
// (q, key) pairs, 0.0261 ms at 989 TFLOP/s, against 67 MB of q/k/v/o, 0.020
// ms at 3.35 TB/s: the operations bound it, and only wgmma reaches the
// tensor cores' rate on this card.  At gemma3-4b's prefill (B 4, H 8, Hk 4,
// S 2048, Dh 320, causal) it is 8.59e10 FLOP, 0.087 ms, against 126 MB,
// 0.038 ms: the operations again.
//
// The design for bf16 at Dh in {64, 128, 320} (the dense, MoE and vlm models
// have Dh 128, whisper 64, gemma3-4b 320): a persistent kernel, one block of
// three warpgroups per SM, walking work items of (128-row q tile, head,
// batch), heaviest first, in snake order over the blocks.  Warpgroup 0 is
// the producer: it gives back its registers (setmaxnreg 24) and one thread
// issues every TMA load, each item's Q tile and then its K and V tiles into
// a ring that runs on across items.  K and V each have `full` mbarriers
// (completed by the copies' bytes) and `empty` ones (released by the
// consumers), so K is refilled as soon as Q K^T has read it.  Warpgroups 1
// and 2 are the consumers (setmaxnreg 240), 64 q rows each.  S = Q K^T is
// wgmma with both operands in shared memory; the online softmax runs on the
// accumulator fragment in registers (one FFMA and one ex2 a score,
// branch-free masks on edge tiles only); P is packed to bf16 in registers,
// in the layout wgmma takes as its A operand, and O += P V reads V MN-major
// (transposed) from shared memory.  Tile j's Q K^T is issued together with
// tile j-1's P V, so the softmax of tile j runs while P V is on the tensor
// cores, and the two consumers take turns to issue (named barriers), so one's
// softmax runs beside the other's products.  Tiles are 64-column slabs,
// 128-byte swizzled by TMA and read so by wgmma.  The tensor maps are 4-D
// (Dh, S, H, B) with the S extent Sq or Skv, so TMA zero-fills rows past the
// end on load (and clips them on store), for contiguous tensors and for the
// transposed views of (B, S, H, Dh) that the model passes alike.
//   * Dh 64 / 128 (FwdTiles): 128-key tiles; O goes through shared memory
//     and a TMA store that overlaps the next item.  It reaches about 0.062
//     ms at the serving shape, 42 % of the bound, where the first design
//     (mma.sync, cp.async, every thread loading and computing, no overlap
//     of softmax and products) took 0.167 ms: PERF.md has the steps.
//   * Dh 320: a consumer's 64 x 320 O accumulator is 160 f32 registers a
//     thread, which leaves room beside it for S and the previous tile's
//     packed P of 48 keys (24 + 12 registers under 240).  So the key tiles
//     are 48 keys (S as wgmma m64n48, P V as n128 + n128 + n64 products
//     over V's five slabs; a first build with 32-key tiles in a ring of
//     three was slower, its m64n32 S reading more shared memory per
//     product), and Q (80 KB) and the ring (120 KB) leave no room for an O
//     tile: O is stored from registers.  The mma.sync design it replaces
//     (16 rows of O a warp, Q read again from shared memory for every
//     32-key tile by ldmatrix) reached 15 % of the bound at gemma3's
//     prefill.
// Not done: a cluster sharing K/V tiles between blocks (TMA multicast).

// bf16 at Dh in {16, 32} (card tests and small cases only) keeps the first
// design: mma.sync m16n8k16, ldmatrix, K/V tiles double-buffered with
// cp.async, one 4-warp block per 64 q rows.
//
// f32 (every Dh) is every config's default dtype (configs/base.py), so a
// model run at its own dtype with attn_impl "flash" takes this path (the
// full-size phases of chip_smoke.py choose bf16); it must keep f32
// accuracy.  The fastest f32-accurate route on this card is 3xTF32 on the
// tensor cores (three TF32 products a product, 495 / 3 = 165 TFLOP/s; f32 outside them
// is 67): at gemma3-4b's head geometry in f32 (B 1, H 8, Hk 4, S 2048, Dh
// 320, causal) 2.15e10 FLOP take 0.130 ms there against 63 MB (0.019 ms),
// so the operations bound it.  Its shapes are small, though: the card
// checks run B 1-4, H 2-8, S 100-2048.  So: mma.sync m16n8k8 in 3xTF32
// (tf32_mma.cuh); blocks
// of 64 q rows, two warps a 16-row strip each holding half of its O and
// summing half of each score, all 8 sharing K and V tiles of 32 keys (16
// at Dh 320) (flash_fwd_tf32_kernel); no sum run long through the tensor cores, which
// truncate as they accumulate; and where the blocks would not fill the card
// the keys are split across blocks (f32_key_split in flash_attention.py
// picks the split), each writing its partial (m, l, O) to scratch, and a
// second kernel sums the splits in one fixed order
// (flash_fwd_combine_kernel).  The SIMT kernel it replaces (4 threads a
// row, two shuffles a score, 24 blocks at B 1, H 4, S 333) took 3.6 times
// as long as PyTorch's memory-efficient attention there.
//
// Semantics kept from the TPU kernel: masked scores are -1e30, never -inf,
// so a query row that sees no key averages v over all keys, exactly as the
// TPU grid (which visits every k tile) and the reference do; a block holding
// such a row walks every key.  Keys past Skv (a ragged edge, which the TPU
// kernel never has) score -inf and read zero-filled v, so they never count.
//
// With a non-null `lse` it is also the TPU kernel `_flash_fwd_lse_kernel`:
// it writes lse = m + log(l) in f32 per (b, h, q row), contiguous (B, H,
// Sq), for the backward (csrc/flash_bwd.cu).  One departure: for a row that
// sees no key the TPU kernel stores -1e30 + log(Skv), which rounds to -1e30
// in f32 and makes its backward take p = 1 instead of 1/Skv.  Here such a
// row stores the logsumexp of its uniform scores taken as 0, log(Skv), from
// which the backward rebuilds p = 1/Skv exactly.
//
// C interface (bound with ctypes): pointers, element strides, ints, the
// stream and, for the wgmma path, the tensor maps' geometry; returns the
// cudaError_t of the launch, or minus the CUresult of a failed map encode.

#include "flash_common.cuh"
#include "hopper.cuh"
#include "tf32_mma.cuh"

namespace {

using namespace flash;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;  // (B, H, Sq) f32, or null
  int B, H, Hk, Sq, Skv, group;
  long long sqb, sqh, sqs, skb, skh, sks, svb, svh, svs, sob, soh, sos;
  float scale;
  int causal, has_window, window, q_offset;
  // f32: keys a split (a multiple of kTfChunk) and the number of splits; with
  // more than one, the splits' partial O (splits, B, H, Sq, D) and, from
  // ml_offset, their (m, l) pairs (splits, B, H, Sq, 2), f32
  int chunk, splits;
  float* part;
  long long ml_offset;
};

// written with selects, not branches, so that a tile's scores stay one
// block of straight-line code
__device__ __forceinline__ float masked_score(const Params& p, float s, int qpos, int key) {
  const bool masked = (p.causal & (key > qpos)) | (p.has_window & (key <= qpos - p.window));
  return key >= p.Skv ? -INFINITY : (masked ? kMasked : s);
}

// logsumexp of a row from its running max and sum; m stays at kMasked only
// for a row that sees no key, whose scores count as 0 (see the header)
__device__ __forceinline__ float row_lse(float m, float l) {
  return (m == kMasked ? 0.f : m) + logf(fmaxf(l, 1e-30f));
}

// the same from a running max of scores in the log2 domain (s * log2 e)
__device__ __forceinline__ float row_lse_log2(float m, float l) {
  return (m == kMasked ? 0.f : m * 0.6931471805599453f) + logf(fmaxf(l, 1e-30f));
}

// ---------------------------------------------------------------------------
// bf16, Dh in {16, 32}: tensor cores through mma.sync
// ---------------------------------------------------------------------------

constexpr int kBM = 64;        // q rows per block (4 warps x 16)
constexpr int kBN = 64;        // keys per k step
constexpr int kThreads = 128;

// 3 blocks per SM: at most 170 registers a thread, and the Q tile borrows
// the second K buffer so that a block needs only 4 K/V tiles of shared memory
template <int D>
__global__ void __launch_bounds__(kThreads, 3) flash_fwd_bf16_kernel(const Params p) {
  static_assert(kBM == kBN, "the Q tile borrows a K tile buffer");
  constexpr int LD = D + 8;
  constexpr int kTile = kBN * LD;  // elements of one K or V tile
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem);  // two K tiles, then two V tiles
  __nv_bfloat16* sV = sK + 2 * kTile;
  __nv_bfloat16* sQ = sK + kTile;  // until the Q fragments are in registers

  const int n_qtiles = (p.Sq + kBM - 1) / kBM;
  const int r0 = (n_qtiles - 1 - (int)blockIdx.x) * kBM;  // longest causal rows first
  const int r1 = min(p.Sq, r0 + kBM);
  const long long b = blockIdx.z, h = blockIdx.y, hk = h / p.group;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int quad = lane / 4, tq = lane % 4;  // mma groupID / thread in group

  const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(p.q) + b * p.sqb + h * p.sqh;
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(p.k) + b * p.skb + hk * p.skh;
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(p.v) + b * p.svb + hk * p.svh;
  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o) + b * p.sob + h * p.soh;

  int k_lo, k_hi;
  key_range(p, r0, r1, k_lo, k_hi);
  const int n_first = (k_lo / kBN) * kBN;

  // first copy group: the Q tile and the first K/V tile
  load_tile_bf16<D, kBM, kThreads>(sQ, qg, p.sqs, r0, p.Sq);
  load_tile_bf16<D, kBN, kThreads>(sK, kg, p.sks, n_first, p.Skv);
  load_tile_bf16<D, kBN, kThreads>(sV, vg, p.svs, n_first, p.Skv);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[D / 16][4];  // this warp's 16 q rows as mma A fragments
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    ldmatrix_x4(qf[kk], sQ + (warp * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * LD + kk * 16 +
                            (lane / 16) * 8);
  __syncthreads();  // the Q buffer is free for the first prefetch
  float acc[D / 8][4];
#pragma unroll
  for (int d = 0; d < D / 8; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
  float m_run[2] = {kMasked, kMasked};  // rows quad and quad + 8 of the warp
  float l_run[2] = {0.f, 0.f};          // partial over this thread's columns
  const int qpos0 = r0 + warp * 16 + quad + p.q_offset;

  for (int n0 = n_first, it = 0; n0 < k_hi; n0 += kBN, ++it) {
    const int buf = it & 1;
    // prefetch the next K/V tile into the other buffer while this one is used
    if (n0 + kBN < k_hi) {
      load_tile_bf16<D, kBN, kThreads>(sK + (buf ^ 1) * kTile, kg, p.sks, n0 + kBN, p.Skv);
      load_tile_bf16<D, kBN, kThreads>(sV + (buf ^ 1) * kTile, vg, p.svs, n0 + kBN, p.Skv);
    }
    cp_async_commit();
    cp_async_wait<1>();  // all but the prefetch have landed
    __syncthreads();
    const __nv_bfloat16* tK = sK + buf * kTile;
    const __nv_bfloat16* tV = sV + buf * kTile;

    // S = Q K^T for 16 rows x 64 keys: 8 n-tiles of 8 keys
    float s[kBN / 8][4];
#pragma unroll
    for (int t = 0; t < kBN / 8; ++t) s[t][0] = s[t][1] = s[t][2] = s[t][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < kBN / 16; ++j) {
        uint32_t kb[4];
        ldmatrix_x4(kb, tK + (j * 16 + (lane % 8) + (lane / 16) * 8) * LD + kk * 16 +
                            ((lane / 8) % 2) * 8);
        mma_bf16(s[2 * j], qf[kk], kb[0], kb[1]);
        mma_bf16(s[2 * j + 1], qf[kk], kb[2], kb[3]);
      }
    }

    const bool edge = tile_needs_mask(p, n0, kBN, r0, r1);
#pragma unroll
    for (int t = 0; t < kBN / 8; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[t][e] * p.scale;
        if (edge) x = masked_score(p, x, qpos0 + (e >= 2 ? 8 : 0), n0 + t * 8 + tq * 2 + (e & 1));
        s[t][e] = x;
      }
    }

    // online softmax: the 4 threads of a quad share a row
    float m_new[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int t = 0; t < kBN / 8; ++t) {
      m_new[0] = fmaxf(m_new[0], fmaxf(s[t][0], s[t][1]));
      m_new[1] = fmaxf(m_new[1], fmaxf(s[t][2], s[t][3]));
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m_new[i] = fmaxf(m_new[i], __shfl_xor_sync(0xffffffffu, m_new[i], 1));
      m_new[i] = fmaxf(m_new[i], __shfl_xor_sync(0xffffffffu, m_new[i], 2));
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      alpha[i] = __expf(m_run[i] - m_new[i]);
      m_run[i] = m_new[i];
      l_run[i] *= alpha[i];
    }
#pragma unroll
    for (int t = 0; t < kBN / 8; ++t) {
      s[t][0] = __expf(s[t][0] - m_new[0]);
      s[t][1] = __expf(s[t][1] - m_new[0]);
      s[t][2] = __expf(s[t][2] - m_new[1]);
      s[t][3] = __expf(s[t][3] - m_new[1]);
      l_run[0] += s[t][0] + s[t][1];
      l_run[1] += s[t][2] + s[t][3];
    }
#pragma unroll
    for (int d = 0; d < D / 8; ++d) {
      acc[d][0] *= alpha[0];
      acc[d][1] *= alpha[0];
      acc[d][2] *= alpha[1];
      acc[d][3] *= alpha[1];
    }

    // O += P V: the S accumulators of two n-tiles are one A fragment
#pragma unroll
    for (int j = 0; j < kBN / 16; ++j) {
      const uint32_t pa[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]),
                              pack_bf16(s[2 * j][2], s[2 * j][3]),
                              pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                              pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
#pragma unroll
      for (int d = 0; d < D / 16; ++d) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, tV + (j * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * LD + d * 16 +
                                  (lane / 16) * 8);
        mma_bf16(acc[2 * d], pa, vb[0], vb[1]);
        mma_bf16(acc[2 * d + 1], pa, vb[2], vb[3]);
      }
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }
  cp_async_wait<0>();

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 1);
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 2);
    inv[i] = 1.f / fmaxf(l_run[i], 1e-30f);
  }
  const int ra = r0 + warp * 16 + quad, rb = ra + 8;
  if (p.lse != nullptr && tq == 0) {
    float* lse = p.lse + (b * p.H + h) * p.Sq;
    if (ra < p.Sq) lse[ra] = row_lse(m_run[0], l_run[0]);
    if (rb < p.Sq) lse[rb] = row_lse(m_run[1], l_run[1]);
  }
#pragma unroll
  for (int d = 0; d < D / 8; ++d) {
    const int col = d * 8 + tq * 2;
    if (ra < p.Sq)
      *reinterpret_cast<__nv_bfloat162*>(og + ra * p.sos + col) =
          __floats2bfloat162_rn(acc[d][0] * inv[0], acc[d][1] * inv[0]);
    if (rb < p.Sq)
      *reinterpret_cast<__nv_bfloat162*>(og + rb * p.sos + col) =
          __floats2bfloat162_rn(acc[d][2] * inv[1], acc[d][3] * inv[1]);
  }
}

// ---------------------------------------------------------------------------
// bf16, Dh in {64, 128, 320}: TMA, wgmma and warp specialisation
// ---------------------------------------------------------------------------

constexpr int kWgBM = 128;      // q rows per work item: two consumer warpgroups of 64
constexpr int kWgORows = 64;    // rows of one consumer's O store
constexpr int kWgStages = 2;    // K/V ring depth
constexpr int kWgThreads = 384; // producer warpgroup, then two consumers

// The tiles of one head dim.  Dh 64 / 128: 128-key K/V tiles, O through
// shared memory and a TMA store.  Dh 320: a consumer's O accumulator alone
// is 160 registers a thread, so a key tile is 48 keys (S 24 registers, the
// previous tile's packed P 12 more); Q (80 KB) and the ring (120 KB) leave
// no room for an O tile, so O is stored from registers.
template <int D>
struct FwdTiles {
  static constexpr int kBN = D > 128 ? 48 : 128;  // keys per k step
  static constexpr bool kOTma = D <= 128;         // O through shared memory and TMA
};

// Shared memory, in bytes from a 1024-byte-aligned base: the Q tile, the O
// tile (where O goes through TMA), the K ring, the V ring, then the
// mbarriers.  A tile is D / 64 slabs of 128 bytes a row: 193 KB at Dh 128,
// 201 KB at Dh 320.
template <int D>
struct WgSmem {
  using T = FwdTiles<D>;
  static constexpr int kSlabs = D / 64;
  static constexpr int kQSlab = kWgBM * 128;
  static constexpr int kKVSlab = T::kBN * 128;
  static constexpr int kQ = kSlabs * kQSlab;    // the Q tile; the O tile alike
  static constexpr int kKV = kSlabs * kKVSlab;  // one K or V tile
  static constexpr int kO = kQ;
  static constexpr int kK = kO + (T::kOTma ? kQ : 0);
  static constexpr int kV = kK + kWgStages * kKV;
  static constexpr int kBars = kV + kWgStages * kKV;
  // q_full, q_empty, then per stage k_full, v_full, k_empty, v_empty
  static constexpr int kNumBars = 2 + 4 * kWgStages;
  // the dynamic base is only 16-byte aligned: room to align it by hand
  static constexpr int kBytes = kBars + kNumBars * 8 + 1024;
};

// A work item: one (128-row q tile, head, batch), and the BN-key tiles it sees.
struct WgItem {
  int r0, r1, h, b, hk, n_first, n_tiles;
};

// Items are numbered heaviest first across all heads: the last q tile (the
// longest causal rows) of every (head, batch), then the one before, ...
template <int BN>
__device__ __forceinline__ WgItem wg_item(const Params& p, int w) {
  const int n_qtiles = (p.Sq + kWgBM - 1) / kWgBM;
  const int rank = w / (p.H * p.B), hb = w % (p.H * p.B);
  WgItem t;
  t.r0 = (n_qtiles - 1 - rank) * kWgBM;
  t.r1 = min(p.Sq, t.r0 + kWgBM);
  t.h = hb % p.H;
  t.b = hb / p.H;
  t.hk = t.h / p.group;
  int k_lo, k_hi;
  key_range(p, t.r0, t.r1, k_lo, k_hi);
  t.n_first = (k_lo / BN) * BN;
  t.n_tiles = (k_hi - t.n_first + BN - 1) / BN;
  return t;
}

// The k-th item of this block, or -1 past the last: rounds of gridDim.x
// items, walked in snake order (forward in even rounds, backward in odd
// ones) so that a block's heavy and light items even out.
__device__ __forceinline__ int wg_item_index(int k, int total) {
  const int g = gridDim.x, blk = blockIdx.x;
  const int w = k * g + ((k & 1) ? g - 1 - blk : blk);
  return w < total ? w : -1;
}

// The online softmax of one tile on the S fragment, in place: s becomes
// exp2(s * scale * log2 e - m), m the new running max in the log2 domain,
// and alpha = exp2(m_old - m) rescales l here and O in rescale_o.  Edge
// tiles mask in the log2 domain (scores of -1e30, or -inf past Skv); the
// others fold the scale into one FFMA per score.  Rows row and row + 8 of
// the accumulator layout; the 4 threads of a quad share a row.
template <int BN>
__device__ __forceinline__ void softmax_tile(const Params& p, float (&s)[BN / 2],
                                             float (&m_run)[2], float (&l_run)[2],
                                             float (&alpha)[2], int n0, int r0, int r1,
                                             int qpos0, int tq, float scale_log2) {
  const bool edge = tile_needs_mask(p, n0, BN, r0, r1);
  float mx[2] = {-INFINITY, -INFINITY};
  if (edge) {
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = masked_score(p, s[4 * i + e] * scale_log2, qpos0 + (e >= 2 ? 8 : 0),
                                     n0 + i * 8 + tq * 2 + (e & 1));
        s[4 * i + e] = x;
        mx[e / 2] = fmaxf(mx[e / 2], x);
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      mx[0] = fmaxf(mx[0], fmaxf(s[4 * i], s[4 * i + 1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[4 * i + 2], s[4 * i + 3]));
    }
    mx[0] *= scale_log2;
    mx[1] *= scale_log2;
  }
  float m_new[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    m_new[r] = fmaxf(m_run[r], mx[r]);
    alpha[r] = hopper::exp2_approx(m_run[r] - m_new[r]);
    m_run[r] = m_new[r];
  }
  float sum[4] = {0.f, 0.f, 0.f, 0.f};  // two partial sums a row
  if (edge) {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      s[i] = hopper::exp2_approx(s[i] - m_new[(i % 4) / 2]);
      sum[i % 4] += s[i];
    }
  } else {
    // a row's max is real here: no sentinel meets the FFMA's rounding
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      s[i] = hopper::exp2_approx(fmaf(s[i], scale_log2, -m_new[(i % 4) / 2]));
      sum[i % 4] += s[i];
    }
  }
  l_run[0] = l_run[0] * alpha[0] + (sum[0] + sum[1]);
  l_run[1] = l_run[1] * alpha[1] + (sum[2] + sum[3]);
}

template <int D>
__device__ __forceinline__ void rescale_o(float (&acc)[D / 2], const float (&alpha)[2]) {
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    acc[4 * i] *= alpha[0];
    acc[4 * i + 1] *= alpha[0];
    acc[4 * i + 2] *= alpha[1];
    acc[4 * i + 3] *= alpha[1];
  }
}

template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                           const __grid_constant__ CUtensorMap map_k,
                           const __grid_constant__ CUtensorMap map_v,
                           const __grid_constant__ CUtensorMap map_o, const Params p, int total) {
  using L = WgSmem<D>;
  using T = FwdTiles<D>;
  using namespace hopper;
  constexpr int BN = T::kBN;
  extern __shared__ __align__(16) unsigned char wg_smem[];
  unsigned char* smem = wg_smem + ((1024 - (hopper::smem_u32(wg_smem) & 1023)) & 1023);
  unsigned char* sQ = smem;
  unsigned char* sO = smem + L::kO;
  unsigned char* sK = smem + L::kK;
  unsigned char* sV = smem + L::kV;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* q_empty = q_full + 1;
  uint64_t* k_full = q_full + 2;
  uint64_t* v_full = k_full + kWgStages;
  uint64_t* k_empty = v_full + kWgStages;
  uint64_t* v_empty = k_empty + kWgStages;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, 8);  // lane 0 of each of the 8 consumer warps
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&k_empty[s], 8);
      mbar_init(&v_empty[s], 8);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer: one thread issues every copy, item after item; the K/V ring
    // runs on across items, so the next item's tiles load while the
    // consumers finish this one
    reg_dealloc<24>();
    if (threadIdx.x == 0) {
      int kv = 0;  // K/V tiles issued so far
      for (int k = 0;; ++k) {
        const int w = wg_item_index(k, total);
        if (w < 0) break;
        const WgItem t = wg_item<BN>(p, w);
        // the consumers' last Q K^T of the previous item has retired
        if (k > 0) mbar_wait(q_empty, (k - 1) & 1);
        mbar_arrive_expect_tx(q_full, L::kQ);
#pragma unroll
        for (int s = 0; s < L::kSlabs; ++s)
          tma_load_4d(sQ + s * L::kQSlab, &map_q, q_full, s * 64, t.r0, t.h, t.b);
        for (int j = 0; j < t.n_tiles; ++j, ++kv) {
          const int st = kv % kWgStages, n0 = t.n_first + j * BN;
          // the stage's previous K, then V, has been released by both consumers
          const uint32_t released = (kv / kWgStages - 1) & 1;
          if (kv >= kWgStages) mbar_wait(&k_empty[st], released);
          mbar_arrive_expect_tx(&k_full[st], L::kKV);
#pragma unroll
          for (int s = 0; s < L::kSlabs; ++s)
            tma_load_4d(sK + st * L::kKV + s * L::kKVSlab, &map_k, &k_full[st], s * 64, n0,
                        t.hk, t.b);
          if (kv >= kWgStages) mbar_wait(&v_empty[st], released);
          mbar_arrive_expect_tx(&v_full[st], L::kKV);
#pragma unroll
          for (int s = 0; s < L::kSlabs; ++s)
            tma_load_4d(sV + st * L::kKV + s * L::kKVSlab, &map_v, &v_full[st], s * 64, n0,
                        t.hk, t.b);
        }
      }
    }
  } else {
    // consumers: 64 q rows of each item each
    reg_alloc<240>();
    const int c = threadIdx.x / 128 - 1;
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int quad = lane / 4, tq = lane % 4;     // accumulator row / column pair
    const int row = c * 64 + warp * 16 + quad;    // this thread's rows: row, row + 8
    const float scale_log2 = p.scale * 1.4426950408889634f;
    const unsigned char* sQc = sQ + c * 64 * 128;  // this consumer's 64 rows of Q
    unsigned char* sOc = sO + c * 64 * 128;        // and of O
    // Tile j's S = Q K^T goes to the tensor cores with tile j - 1's O += P V,
    // in that order, so that the softmax of tile j runs while P V is still on
    // them.  The two consumers take turns to issue their products (named
    // barriers 1 and 2 over both warpgroups), so that one's softmax runs
    // beside the other's products; consumer 0 goes first.  The first and
    // last tiles of an item are peeled off so that every batch in the loop
    // commits the same two groups.
    const int my_turn = 1 + c, other_turn = 2 - c;
    if (c == 1) named_barrier_arrive(1, 256);

    int kv = 0;  // K/V tiles consumed so far
    for (int k = 0;; ++k) {
      const int w = wg_item_index(k, total);
      if (w < 0) break;
      const WgItem t = wg_item<BN>(p, w);
      const bool last_item = wg_item_index(k + 1, total) < 0;
      const int qpos0 = t.r0 + row + p.q_offset;
      float acc[D / 2];  // O, 64 x D over the warpgroup
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
      float m_run[2] = {kMasked, kMasked};  // rows row and row + 8, log2 domain
      float l_run[2] = {0.f, 0.f};          // partial over this thread's columns
      uint32_t pa[BN / 16][4];  // P of the previous tile, bf16, as wgmma's A operand
      float alpha[2];

      mbar_wait(q_full, k & 1);
      {
        const int st = kv % kWgStages;
        float s[BN / 2];
        mbar_wait(&k_full[st], (kv / kWgStages) & 1);
        named_barrier_sync(my_turn, 256);
        wgmma_fence();
        wgmma_abt<D, BN, kWgBM, BN>(s, sQc, sK + st * L::kKV);
        wgmma_commit();
        named_barrier_arrive(other_turn, 256);
        wgmma_wait<0>();
        fence_operand(s);
        __syncwarp();
        if (lane == 0) {
          mbar_arrive(&k_empty[st]);  // this warp is done with K
          if (t.n_tiles == 1) mbar_arrive(q_empty);  // and with Q
        }
        softmax_tile<BN>(p, s, m_run, l_run, alpha, t.n_first, t.r0, t.r1, qpos0, tq,
                         scale_log2);
        pack_a<BN>(s, pa);  // O is still 0: nothing to rescale
      }
      for (int j = 1; j < t.n_tiles; ++j) {
        const int g = kv + j, st = g % kWgStages, pst = (g - 1) % kWgStages;
        float s[BN / 2];
        mbar_wait(&k_full[st], (g / kWgStages) & 1);
        mbar_wait(&v_full[pst], ((g - 1) / kWgStages) & 1);
        named_barrier_sync(my_turn, 256);
        fence_operand(acc);
        wgmma_fence();
        wgmma_abt<D, BN, kWgBM, BN>(s, sQc, sK + st * L::kKV);
        wgmma_commit();
        wgmma_fence();
        wgmma_ab<D, BN, BN>(acc, pa, sV + pst * L::kKV);
        wgmma_commit();
        named_barrier_arrive(other_turn, 256);
        wgmma_wait<1>();  // S is done; P V may still run
        fence_operand(s);
        __syncwarp();
        if (lane == 0) {
          mbar_arrive(&k_empty[st]);
          if (j == t.n_tiles - 1) mbar_arrive(q_empty);
        }
        softmax_tile<BN>(p, s, m_run, l_run, alpha, t.n_first + j * BN, t.r0, t.r1, qpos0, tq,
                         scale_log2);
        wgmma_wait<0>();
        fence_operand(acc);
        __syncwarp();
        if (lane == 0) mbar_arrive(&v_empty[pst]);
        rescale_o<D>(acc, alpha);
        pack_a<BN>(s, pa);
      }
      {
        const int g = kv + t.n_tiles - 1, pst = g % kWgStages;
        mbar_wait(&v_full[pst], (g / kWgStages) & 1);
        named_barrier_sync(my_turn, 256);
        fence_operand(acc);
        wgmma_fence();
        wgmma_ab<D, BN, BN>(acc, pa, sV + pst * L::kKV);
        wgmma_commit();
        // consumer 1's last turn of the block is the last one
        if (c == 0 || !last_item) named_barrier_arrive(other_turn, 256);
        wgmma_wait<0>();
        fence_operand(acc);
        __syncwarp();
        if (lane == 0) mbar_arrive(&v_empty[pst]);
      }
      kv += t.n_tiles;

      float inv[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
        l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
        inv[r] = 1.f / fmaxf(l_run[r], 1e-30f);
      }
      if (p.lse != nullptr && tq == 0) {
        float* lse = p.lse + ((long long)t.b * p.H + t.h) * p.Sq;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          if (t.r0 + row + 8 * r < p.Sq)
            lse[t.r0 + row + 8 * r] = row_lse_log2(m_run[r], l_run[r]);
        }
      }
      if constexpr (T::kOTma) {
        // O through shared memory, 128-byte swizzled as the O map's box
        // expects, then one TMA store a slab.  This consumer's previous
        // store has to have read its rows first.
        if (tid == 0) tma_store_wait_read();
        named_barrier_sync(3 + c, 128);
#pragma unroll
        for (int i = 0; i < D / 8; ++i) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int orow = warp * 16 + quad + 8 * r;
            const int chunk = (i % 8) ^ (orow % 8);
            *reinterpret_cast<uint32_t*>(sOc + (i / 8) * L::kQSlab + orow * 128 + chunk * 16 +
                                         tq * 4) =
                pack_bf16(acc[4 * i + 2 * r] * inv[r], acc[4 * i + 2 * r + 1] * inv[r]);
          }
        }
        fence_proxy_async();
        named_barrier_sync(3 + c, 128);  // this consumer's rows are all written
        if (tid == 0) {
#pragma unroll
          for (int s = 0; s < L::kSlabs; ++s)
            tma_store_4d(&map_o, sOc + s * L::kQSlab, s * 64, t.r0 + c * 64, t.h, t.b);
          tma_store_commit();
        }
      } else {
        __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o) + (long long)t.b * p.sob +
                            (long long)t.h * p.soh;
#pragma unroll
        for (int i = 0; i < D / 8; ++i) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int gr = t.r0 + row + 8 * r;
            if (gr < p.Sq)
              *reinterpret_cast<uint32_t*>(og + (long long)gr * p.sos + 8 * i + 2 * tq) =
                  pack_bf16(acc[4 * i + 2 * r] * inv[r], acc[4 * i + 2 * r + 1] * inv[r]);
          }
        }
      }
    }
    if constexpr (T::kOTma) {
      if (tid == 0) tma_store_wait_read();  // before the block's shared memory goes
    }
  }
}

// ---------------------------------------------------------------------------
// f32: 3xTF32 on the tensor cores (mma.sync m16n8k8, common/tf32_mma.cuh)
// ---------------------------------------------------------------------------

constexpr int kTfChunk = 32;  // a key split is a multiple of this
constexpr int kTfGroup = 4;   // k steps of S summed in the tensor cores
constexpr float kLog2e = 1.4426950408889634f;

// The f32 kernel's tiles, in floats: the block's Q rows, one K tile and one
// V tile of a step's keys, and each thread's partial S.  Q and K are read as
// mma A / B fragments at (row g, column q) and V at (row q, column g) (g =
// lane / 4, q = lane % 4): rows of D + 4 and D + 8 floats keep both free of
// bank conflicts.  A block is 8 warps: 4 strips of 16 q rows, two warps a
// strip, each of which holds half of the strip's O (80 registers a thread
// at Dh 320) and sums half of each score's head dims; 130 KB at Dh 320 (one
// block an SM), 83 KB at Dh 128.
template <int D>
struct Tf32Tiles {
  static constexpr int kWarps = 8;
  static constexpr int kRows = 64;  // q rows of a block, 16 a strip
  static constexpr int kThreads = 32 * kWarps;
  // keys a step: at Dh 320 16, so that S's sums (24 registers) and the
  // step's P V (80) fit beside O (80) without a spill
  static constexpr int kKeys = D > 128 ? 16 : 32;
  static constexpr int kHalf = D / 2;   // head dims a warp covers, of S's sums and of O
  static constexpr int kLdQK = D + 4;
  static constexpr int kLdV = D + 8;
  static constexpr int kK = kRows * kLdQK;
  static constexpr int kV = kK + kKeys * kLdQK;
  static constexpr int kX = kV + kKeys * kLdV;  // partial S: float4 (w NT + t) 32 + lane
  static constexpr int kBytes = (kX + kThreads * kKeys / 2) * 4;
  static_assert(kTfChunk % kKeys == 0, "a split starts on a step");
};

// Keys [lo, hi) of key split s for the block of rows [r0, r1): the block's
// keys (key_range, from a multiple of the step) cut at multiples of
// p.chunk.  Empty where the split holds none of them.
template <int D>
__device__ __forceinline__ void split_keys(const Params& p, int r0, int r1, int s, int& lo,
                                           int& hi) {
  constexpr int KEYS = Tf32Tiles<D>::kKeys;
  int k_lo, k_hi;
  key_range(p, r0, r1, k_lo, k_hi);
  lo = max((k_lo / KEYS) * KEYS, s * p.chunk);
  hi = min(k_hi, (s + 1) * p.chunk);
}

// One block: 64 q rows of one (head, batch) over the keys of one split.
// Per step of KEYS keys, each warp sums S = Q K^T over its half of the head
// dims (16 x KEYS), the two warps of a strip swap their halves through
// shared memory and each adds the other's (the same sum in both), both run
// the same online softmax on the fragments, and each adds P V to its half
// of O.  The K rows of S's B fragment are read permuted (column 2j of an
// 8-key n-tile is key j, column 2j + 1 key j + 4), so that S's accumulator
// fragment is, element for element, P's A fragment for P V: no shuffles.
// The tensor cores truncate as they add into an accumulator, so no sum runs
// through them for long: S takes kTfGroup k steps there, the two small
// products of 3xTF32 in a chain of their own (with them in the large ones'
// chain, or with S's whole sum or O's in the tensor cores, the card-vs-CPU
// training check at Dh 320 missed its bound on the params), and adds each
// group in f32 registers; P V of a step (2 or 4 k steps of 8 keys) is
// summed from zero there and added to O in f32.  K and V have one buffer
// each: K of step j + 1 loads while the softmax and P V of step j run, V of
// step j + 1 while S of step j + 1 does.  With one split it writes O and
// lse; with more, its unnormalised O and (m, l) go to p.part for the
// combine.
template <int D>
__global__ void __launch_bounds__(Tf32Tiles<D>::kThreads, 1) flash_fwd_tf32_kernel(const Params p) {
  using T = Tf32Tiles<D>;
  constexpr int LQ = T::kLdQK, LV = T::kLdV, KEYS = T::kKeys, NT = KEYS / 8, HALF = T::kHalf;
  constexpr int ROWS = T::kRows, THREADS = T::kThreads;
  constexpr int G = HALF / 8 < kTfGroup ? HALF / 8 : kTfGroup;
  static_assert((HALF / 8) % G == 0, "whole groups of k steps");
  extern __shared__ __align__(16) float tf_smem[];
  float* sQ = tf_smem;
  float* sK = tf_smem + T::kK;
  float* sV = tf_smem + T::kV;
  float4* sX = reinterpret_cast<float4*>(tf_smem + T::kX);

  const int n_qtiles = (p.Sq + ROWS - 1) / ROWS;
  const int rank = blockIdx.z / p.splits, split = blockIdx.z % p.splits;
  const int r0 = (n_qtiles - 1 - rank) * ROWS;  // longest causal rows first
  const int r1 = min(p.Sq, r0 + ROWS);
  const long long h = blockIdx.x, b = blockIdx.y, hk = h / p.group;
  int k_lo, k_hi;
  split_keys<D>(p, r0, r1, split, k_lo, k_hi);
  if (k_lo >= k_hi) return;  // no key of this block in this split: the combine skips it

  const float* qg = static_cast<const float*>(p.q) + b * p.sqb + h * p.sqh;
  const float* kg = static_cast<const float*>(p.k) + b * p.skb + hk * p.skh;
  const float* vg = static_cast<const float*>(p.v) + b * p.svb + hk * p.svh;
  // rows are 16-byte aligned (the wrapper checks): whole 16-byte copies
  tf32::load_tile<THREADS>(sQ, LQ, qg + r0 * p.sqs, p.sqs, ROWS, D, p.Sq - r0, D, true);
  tf32::load_tile<THREADS>(sK, LQ, kg + k_lo * p.sks, p.sks, KEYS, D, p.Skv - k_lo, D, true);
  tf32::commit();
  tf32::load_tile<THREADS>(sV, LV, vg + k_lo * p.svs, p.svs, KEYS, D, p.Skv - k_lo, D, true);
  tf32::commit();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int strip = warp / 2, half = warp % 2;  // 16 q rows; which half of the head dims
  const int g = lane / 4, q4 = lane % 4;        // mma groupID, thread in group
  const int qpos0 = r0 + strip * 16 + g + p.q_offset;  // rows g and g + 8 of the strip
  const float sl2 = p.scale * kLog2e;
  const float* wQ = sQ + strip * 16 * LQ + half * HALF;
  const float* wK = sK + half * HALF;
  const float* wV = sV + half * HALF;
  float acc[HALF / 8][4];  // this half of O: n-tile n holds columns half HALF + 8n + 2 q4 (+ 1)
#pragma unroll
  for (int n = 0; n < HALF / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_run[2] = {kMasked, kMasked};  // log2 domain
  float l_run[2] = {0.f, 0.f};          // partial over this thread's columns

  const int n_steps = (k_hi - k_lo + KEYS - 1) / KEYS;
  for (int j = 0; j < n_steps; ++j) {
    const int n0 = k_lo + j * KEYS;
    tf32::wait<1>();  // K (and Q) have landed; V may still be in flight
    __syncthreads();
    // this warp's half of S = Q K^T: n-tile t holds keys n0 + 8t + q4 and + 4
    // in columns 2 q4, 2 q4 + 1
    float s[NT][4];
#pragma unroll
    for (int t = 0; t < NT; ++t) s[t][0] = s[t][1] = s[t][2] = s[t][3] = 0.f;
#pragma unroll
    for (int k0 = 0; k0 < HALF / 8; k0 += G) {
      float big[NT][4], small[NT][4];
#pragma unroll
      for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) big[t][e] = small[t][e] = 0.f;
#pragma unroll
      for (int kk = k0; kk < k0 + G; ++kk) {
        const float* qa = wQ + g * LQ + kk * 8 + q4;
        const tf32::AFrag a = tf32::a_frag(qa[0], qa[8 * LQ], qa[4], qa[8 * LQ + 4]);
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          const float* kb = wK + (8 * t + (g >> 1) + 4 * (g & 1)) * LQ + kk * 8 + q4;
          const tf32::BFrag bf = tf32::b_frag(kb[0], kb[4]);
          if (tf32::kPasses == 3) {
            tf32::mma1(small[t], a.v[0].lo, a.v[1].lo, a.v[2].lo, a.v[3].lo, bf.v[0].hi,
                       bf.v[1].hi);
            tf32::mma1(small[t], a.v[0].hi, a.v[1].hi, a.v[2].hi, a.v[3].hi, bf.v[0].lo,
                       bf.v[1].lo);
          }
          tf32::mma1(big[t], a.v[0].hi, a.v[1].hi, a.v[2].hi, a.v[3].hi, bf.v[0].hi, bf.v[1].hi);
        }
      }
#pragma unroll
      for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[t][e] += big[t][e] + small[t][e];
    }
#pragma unroll
    for (int t = 0; t < NT; ++t)
      sX[(warp * NT + t) * 32 + lane] = make_float4(s[t][0], s[t][1], s[t][2], s[t][3]);
    __syncthreads();  // every warp is done with K, and every half of S is written
    if (j + 1 < n_steps)
      tf32::load_tile<THREADS>(sK, LQ, kg + (n0 + KEYS) * p.sks, p.sks, KEYS, D,
                               p.Skv - n0 - KEYS, D, true);
    tf32::commit();
    // the other half's sum (addition commutes: both warps get the same S)
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const float4 o = sX[((warp ^ 1) * NT + t) * 32 + lane];
      s[t][0] += o.x;
      s[t][1] += o.y;
      s[t][2] += o.z;
      s[t][3] += o.w;
    }

    // online softmax in the log2 domain; edge tiles masked (-1e30, or -inf past Skv)
    const bool edge = tile_needs_mask(p, n0, KEYS, r0, r1);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int t = 0; t < NT; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[t][e] * sl2;
        if (edge) x = masked_score(p, x, qpos0 + 8 * (e >> 1), n0 + 8 * t + q4 + 4 * (e & 1));
        s[t][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);
      alpha[r] = exp2f(m_run[r] - m_new);
      m_run[r] = m_new;
    }
#pragma unroll
    for (int t = 0; t < NT; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[t][e] = exp2f(s[t][e] - m_run[e >> 1]);
        sum[e >> 1] += s[t][e];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + sum[r];

    tf32::wait<1>();  // V has landed; the next K may still be in flight
    __syncthreads();
    // this half of O = alpha O + P V: the step's P V summed from zero in the
    // tensor cores (8 keys a k step; P's A fragment is S's accumulator
    // fragment), then added to O in f32
    float pv[HALF / 8][4];
#pragma unroll
    for (int n = 0; n < HALF / 8; ++n) pv[n][0] = pv[n][1] = pv[n][2] = pv[n][3] = 0.f;
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const tf32::AFrag a = tf32::a_frag(s[t][0], s[t][2], s[t][1], s[t][3]);
      const float* vb = wV + (8 * t + q4) * LV + g;
#pragma unroll
      for (int n = 0; n < HALF / 8; ++n)
        tf32::mma(pv[n], a, tf32::b_frag(vb[8 * n], vb[4 * LV + 8 * n]));
    }
#pragma unroll
    for (int n = 0; n < HALF / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = fmaf(acc[n][e], alpha[e >> 1], pv[n][e]);
    __syncthreads();  // every warp is done with V
    if (j + 1 < n_steps)
      tf32::load_tile<THREADS>(sV, LV, vg + (n0 + KEYS) * p.svs, p.svs, KEYS, D,
                               p.Skv - n0 - KEYS, D, true);
    tf32::commit();
  }
  tf32::wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
  const int rows[2] = {r0 + strip * 16 + g, r0 + strip * 16 + g + 8};
  if (p.splits == 1) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (rows[r] >= p.Sq) continue;
      if (p.lse != nullptr && half == 0 && q4 == 0)
        p.lse[(b * p.H + h) * p.Sq + rows[r]] = row_lse_log2(m_run[r], l_run[r]);
      const float inv = 1.f / fmaxf(l_run[r], 1e-30f);
      float* og = static_cast<float*>(p.o) + b * p.sob + h * p.soh + rows[r] * p.sos +
                  half * HALF + 2 * q4;
#pragma unroll
      for (int n = 0; n < HALF / 8; ++n)
        *reinterpret_cast<float2*>(og + 8 * n) =
            make_float2(acc[n][2 * r] * inv, acc[n][2 * r + 1] * inv);
    }
  } else {
    // the split's partial: O unnormalised, then (m, l) (see flash_fwd_combine_kernel)
    const long long bh = (split * p.B + b) * p.H + h;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (rows[r] >= p.Sq) continue;
      const long long at = bh * p.Sq + rows[r];
      if (half == 0 && q4 == 0)
        *reinterpret_cast<float2*>(p.part + p.ml_offset + 2 * at) = make_float2(m_run[r], l_run[r]);
      float* og = p.part + at * D + half * HALF + 2 * q4;
#pragma unroll
      for (int n = 0; n < HALF / 8; ++n)
        *reinterpret_cast<float2*>(og + 8 * n) = make_float2(acc[n][2 * r], acc[n][2 * r + 1]);
    }
  }
}

// Sums the key splits of flash_fwd_tf32_kernel, one warp a (b, h, row): M
// the largest split max, O = sum_s 2^(m_s - M) O_s / L with L = sum_s 2^(m_s
// - M) l_s, split by split in one fixed order, over the splits that hold
// keys of the row's block; lse from M and L.
template <int D>
__global__ void __launch_bounds__(256) flash_fwd_combine_kernel(const Params p) {
  const long long wi = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  if (wi >= (long long)p.B * p.H * p.Sq) return;
  const int lane = threadIdx.x % 32;
  const int row = wi % p.Sq;
  const long long bh = wi / p.Sq, h = bh % p.H, b = bh / p.H;
  constexpr int ROWS = Tf32Tiles<D>::kRows;
  const int r0 = row / ROWS * ROWS, r1 = min(p.Sq, r0 + ROWS);
  const long long stride = (long long)p.B * p.H * p.Sq;  // between splits, in rows
  const float2* ml = reinterpret_cast<const float2*>(p.part + p.ml_offset) + wi;
  float M = -INFINITY;
  for (int s = 0; s < p.splits; ++s) {
    int lo, hi;
    split_keys<D>(p, r0, r1, s, lo, hi);
    if (lo < hi) M = fmaxf(M, ml[s * stride].x);
  }
  float Lsum = 0.f;
  float4 o[(D / 4 + 31) / 32];
#pragma unroll
  for (int c = 0; c < (D / 4 + 31) / 32; ++c) o[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s = 0; s < p.splits; ++s) {
    int lo, hi;
    split_keys<D>(p, r0, r1, s, lo, hi);
    if (lo >= hi) continue;
    const float2 x = ml[s * stride];
    const float w = exp2f(x.x - M);
    Lsum += w * x.y;
    const float4* os = reinterpret_cast<const float4*>(p.part + (s * stride + wi) * D);
#pragma unroll
    for (int c = 0; c < (D / 4 + 31) / 32; ++c) {
      if (32 * c + lane < D / 4) {
        const float4 v = os[32 * c + lane];
        o[c].x += w * v.x;
        o[c].y += w * v.y;
        o[c].z += w * v.z;
        o[c].w += w * v.w;
      }
    }
  }
  const float inv = 1.f / fmaxf(Lsum, 1e-30f);
  float4* og = reinterpret_cast<float4*>(static_cast<float*>(p.o) + b * p.sob + h * p.soh +
                                         row * p.sos);
#pragma unroll
  for (int c = 0; c < (D / 4 + 31) / 32; ++c)
    if (32 * c + lane < D / 4)
      og[32 * c + lane] = make_float4(o[c].x * inv, o[c].y * inv, o[c].z * inv, o[c].w * inv);
  if (p.lse != nullptr && lane == 0) p.lse[wi] = row_lse_log2(M, Lsum);
}

template <int D>
cudaError_t launch_bf16(const Params& p, cudaStream_t stream) {
  const int smem = 4 * kBN * (D + 8) * (int)sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_bf16_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + kBM - 1) / kBM, p.H, p.B);
  flash_fwd_bf16_kernel<D><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// maps: the geometry of the q, k, v and o maps (hopper::kMapFields each).
// Returns a cudaError_t, or minus the CUresult of a failed encode.
template <int D>
int launch_wgmma(const Params& p, const long long* maps, cudaStream_t stream) {
  using L = WgSmem<D>;
  const void* base[4] = {p.q, p.k, p.v, p.o};
  // the boxes must be the tiles whose bytes the kernel's barriers count;
  // there is no o map where O is stored from registers
  const int n_maps = FwdTiles<D>::kOTma ? 4 : 3;
  const long long rows[4] = {kWgBM, FwdTiles<D>::kBN, FwdTiles<D>::kBN, kWgORows};
  const long long seq[4] = {p.Sq, p.Skv, p.Skv, p.Sq};
  const long long heads[4] = {p.H, p.Hk, p.Hk, p.H};
  CUtensorMap m[4] = {};
  if (maps == nullptr) return cudaErrorInvalidValue;
  for (int i = 0; i < n_maps; ++i) {
    const long long* g = maps + hopper::kMapFields * i;
    if (g[0] != D || g[1] != seq[i] || g[2] != heads[i] || g[3] != p.B || g[7] != 64 ||
        g[8] != rows[i] || g[9] != 1 || g[10] != 1)
      return cudaErrorInvalidValue;
    const int r = hopper::encode_map(&m[i], base[i], g);
    if (r != 0) return -r;
  }
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_wgmma_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (err != cudaSuccess) return err;
  // persistent: at most one block per SM, each walking its share of items
  int dev, sms;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  const int total = (p.Sq + kWgBM - 1) / kWgBM * p.H * p.B;
  flash_fwd_wgmma_kernel<D><<<min(total, sms), kWgThreads, L::kBytes, stream>>>(
      m[0], m[1], m[2], m[3], p, total);
  return cudaGetLastError();
}

// The f32 kernel over p.splits key splits (p.chunk keys each), then, with
// more than one, the combine.
template <int D>
cudaError_t launch_tf32(const Params& p, cudaStream_t stream) {
  constexpr int smem = Tf32Tiles<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_tf32_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  constexpr int ROWS = Tf32Tiles<D>::kRows;
  const dim3 grid(p.H, p.B, (p.Sq + ROWS - 1) / ROWS * p.splits);
  flash_fwd_tf32_kernel<D><<<grid, Tf32Tiles<D>::kThreads, smem, stream>>>(p);
  if (p.splits > 1) {
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    const long long rows = (long long)p.B * p.H * p.Sq;
    flash_fwd_combine_kernel<D><<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(p);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements; the last
// dimension of every tensor is contiguous.  window <= 0 means no window.
// lse: null, or a contiguous (B, H, Sq) f32 buffer to fill.  maps: for bf16
// at Dh in {64, 128, 320}, which take the wgmma kernel, the geometry of the
// q, k, v and (Dh 64 / 128) o tensor maps (11 integers each, see
// hopper::encode_map); else null.  f32 only: `chunk`, the keys of one key
// split (a multiple of 32), and `part`, scratch of splits x B x H x Sq x (D
// + 2) floats with splits = ceil(Skv / chunk), or null when that is 1
// (flash_attention.py, f32_key_split).
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                         int dtype, int B,
                         int H, int Hk, int Sq, int Skv, int D, long long sqb, long long sqh,
                         long long sqs, long long skb, long long skh, long long sks,
                         long long svb, long long svh, long long svs, long long sob,
                         long long soh, long long sos, float scale, int causal, int window,
                         int q_offset, void* stream, const long long* maps, void* part,
                         int chunk) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.lse = static_cast<float*>(lse);
  p.B = B;
  p.H = H;
  p.Hk = Hk;
  p.Sq = Sq;
  p.Skv = Skv;
  p.group = H / Hk;
  p.sqb = sqb;
  p.sqh = sqh;
  p.sqs = sqs;
  p.skb = skb;
  p.skh = skh;
  p.sks = sks;
  p.svb = svb;
  p.svh = svh;
  p.svs = svs;
  p.sob = sob;
  p.soh = soh;
  p.sos = sos;
  p.scale = scale;
  p.causal = causal;
  p.has_window = window > 0;
  p.window = window;
  p.q_offset = q_offset;
  p.chunk = chunk;
  p.splits = p.chunk > 0 ? (Skv + p.chunk - 1) / p.chunk : 0;
  p.part = static_cast<float*>(part);
  p.ml_offset = (long long)p.splits * B * H * Sq * D;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    switch (D) {
      // no model of the repo has Dh < 64: those stay on mma.sync
      case 16: return launch_bf16<16>(p, st);
      case 32: return launch_bf16<32>(p, st);
      case 64: return launch_wgmma<64>(p, maps, st);
      case 128: return launch_wgmma<128>(p, maps, st);
      case 320: return launch_wgmma<320>(p, maps, st);
    }
  } else if (dtype == 0) {
    if (p.chunk <= 0 || p.chunk % kTfChunk != 0 || (p.splits > 1 && part == nullptr))
      return cudaErrorInvalidValue;
    switch (D) {
      case 16: return launch_tf32<16>(p, st);
      case 32: return launch_tf32<32>(p, st);
      case 64: return launch_tf32<64>(p, st);
      case 128: return launch_tf32<128>(p, st);
      case 320: return launch_tf32<320>(p, st);
    }
  }
  return cudaErrorInvalidValue;
}
