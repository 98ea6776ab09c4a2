// Flash-attention backward for Hopper (sm_90a), written by hand: two kernels.
//
// Replaces the TPU kernels of src/repro/kernels/flash_attention/
// flash_attention.py reached through `flash_attention_bwd` (:242-312):
//   * flash_bwd_dq  <- `_flash_bwd_dq_kernel` (:121-156):
//       dq = scale * sum_k dS K,   dS = P o (dO V^T - delta)
//   * flash_bwd_dkv <- `_flash_bwd_dkv_kernel` (:159-197):
//       dV = P^T dO,   dK = scale * dS^T Q
// with P = exp(scale * Q K^T - lse) rebuilt from the forward's lse
// (csrc/flash_fwd.cu) and delta = rowsum(O o dO), which the wrapper computes
// outside the kernels as the reference does (:257-259).  Masking, GQA (query
// head h reads kv head h / (H / Hk)), q_offset, ragged Sq / Skv and the
// strides are those of flash_fwd.cu.
//
// Design.  The TPU grid carries dq (or dk/dv) in scratch across the
// sequential k (or q) grid axis; on Hopper blocks run in parallel, so a loop
// inside the block takes that axis' place and no state crosses blocks:
//   * dq: one block per (64-row q tile, head, batch), looping over the k
//     tiles that the causal / window limits allow;
//   * dk/dv: one block per (64-key tile, kv head, batch), looping over the
//     group's query heads and, for each, over the q tiles that can see the
//     keys.  The GQA sum into Hk heads thus happens in the block's
//     registers: no (B, H, Skv, Dh) intermediates (the reference's dk_h,
//     dv_h) and no atomics.
// What bounds it on the H100: at the training shape (B=4, H=24, Hk=8,
// S=1024, Dh=128, bf16, causal) dq does 6 Dh and dk/dv 8 Dh FLOP per visible
// (q, k) pair, 3.9e10 and 5.2e10 FLOP, 39 and 52 us at 989 TFLOP/s, against
// ~0.1 GB of operands (30 us at 3.35 TB/s): the operations bound both.  So
// the bf16 path runs every product on the tensor cores (mma.sync m16n8k16,
// f32 accumulate; P and dS are rounded to bf16 as operands, as in the
// forward's P V) and keeps S, P, dP and dS in registers.  dk/dv computes
// S^T = K Q^T and dP^T = V dO^T directly, so P^T and dS^T come out of the
// accumulators already in the A-operand layout of P^T dO and dS^T Q, and
// only plain (`ldmatrix`) and transposed (`ldmatrix .trans`) loads of Q,
// dO, K and V from shared memory are needed.  Each warp owns 16 rows (dq:
// q rows; dk/dv: keys) and its f32 accumulators (dk/dv: two 16 x Dh).
// Tiles are double-buffered with cp.async.  This is the simple design; no
// TMA or wgmma yet.  The f32 path (not on the training path; it lets a
// small f32 model be checked tightly on the card) is SIMT FMA with 4
// threads per row.
//
// A query row that sees no key (a window past the end of the keys): the
// reference's softmax over all -1e30 scores gives p = 1/Skv on every key,
// and the mask (a `where`) stops any gradient into those scores.  So such
// a row adds dO / Skv to every dv row and nothing to dq or dk.  Its lse from
// flash_fwd.cu is log(Skv), so p = exp(0 - lse) = 1/Skv exactly.  (The TPU
// backward takes p = 1 there; see flash_fwd.cu.)
//
// C interface (bound with ctypes): pointers, element strides, ints and the
// stream; each entry point returns the cudaError_t of its launch.

#include "flash_common.cuh"

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
// bf16: tensor cores through mma.sync
// ---------------------------------------------------------------------------

constexpr int kThreads = 128;  // 4 warps x 16 rows
constexpr int kRows = 64;      // q rows of a dq block, keys of a dk/dv block
constexpr int kBN = 64;        // keys per k step of dq
constexpr int kBQ = 32;        // q rows per q step of dk/dv

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_bf16_kernel(const Params p) {
  constexpr int LD = D + 8;
  constexpr int kTile = kBN * LD;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sO = sQ + kRows * LD;  // dO
  __nv_bfloat16* sK = sO + kRows * LD;  // two K tiles, then two V tiles
  __nv_bfloat16* sV = sK + 2 * kTile;

  const int n_qtiles = (p.Sq + kRows - 1) / kRows;
  const int r0 = (n_qtiles - 1 - (int)blockIdx.x) * kRows;  // longest causal rows first
  const int r1 = min(p.Sq, r0 + kRows);
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
  const int n_first = (k_lo / kBN) * kBN;

  load_tile_bf16<D, kRows, kThreads>(sQ, qg, p.sqs, r0, p.Sq);
  load_tile_bf16<D, kRows, kThreads>(sO, og, p.sdos, r0, p.Sq);
  load_tile_bf16<D, kBN, kThreads>(sK, kg, p.sks, n_first, p.Skv);
  load_tile_bf16<D, kBN, kThreads>(sV, vg, p.svs, n_first, p.Skv);
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

  for (int n0 = n_first, it = 0; n0 < k_hi; n0 += kBN, ++it) {
    const int buf = it & 1;
    if (n0 + kBN < k_hi) {
      load_tile_bf16<D, kBN, kThreads>(sK + (buf ^ 1) * kTile, kg, p.sks, n0 + kBN, p.Skv);
      load_tile_bf16<D, kBN, kThreads>(sV + (buf ^ 1) * kTile, vg, p.svs, n0 + kBN, p.Skv);
    }
    cp_async_commit();
    cp_async_wait<1>();  // all but the prefetch have landed
    __syncthreads();
    const __nv_bfloat16* tK = sK + buf * kTile;
    const __nv_bfloat16* tV = sV + buf * kTile;

    // S = Q K^T and dP = dO V^T for 16 rows x 64 keys
    float s[kBN / 8][4], dp[kBN / 8][4];
#pragma unroll
    for (int t = 0; t < kBN / 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[t][e] = dp[t][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qa[4], oa[4];
      load_a<LD>(qa, sQ, warp * 16, kk * 16, lane);
      load_a<LD>(oa, sO, warp * 16, kk * 16, lane);
#pragma unroll
      for (int j = 0; j < kBN / 16; ++j) {
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
    for (int t = 0; t < kBN / 8; ++t) {
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
    for (int j = 0; j < kBN / 16; ++j) {
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
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_bf16_kernel(const Params p) {
  constexpr int LD = D + 8;
  constexpr int kQTile = kBQ * LD;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sV = sK + kRows * LD;
  __nv_bfloat16* sQ = sV + kRows * LD;  // two Q tiles, then two dO tiles
  __nv_bfloat16* sO = sQ + 2 * kQTile;
  float* sL = reinterpret_cast<float*>(sO + 2 * kQTile);  // two lse chunks, then two delta chunks
  float* sD = sL + 2 * kBQ;

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
  const int q_first = (q_lo / kBQ) * kBQ;
  const int n_chunks = q_hi > q_first ? (q_hi - q_first + kBQ - 1) / kBQ : 0;
  const int n_steps = n_chunks * p.group;  // (query head of the group, q tile) pairs

  // step c: query head hk * group + c / n_chunks, rows from q_first + (c % n_chunks) * kBQ
  auto load_step = [&](int c, int buf) {
    const long long h = hk * p.group + c / n_chunks;
    const int r0 = q_first + (c % n_chunks) * kBQ;
    load_tile_bf16<D, kBQ, kThreads>(sQ + buf * kQTile,
                                     static_cast<const __nv_bfloat16*>(p.q) + b * p.sqb + h * p.sqh,
                                     p.sqs, r0, p.Sq);
    load_tile_bf16<D, kBQ, kThreads>(
        sO + buf * kQTile, static_cast<const __nv_bfloat16*>(p.dout) + b * p.sdob + h * p.sdoh,
        p.sdos, r0, p.Sq);
    const long long stat = (b * p.H + h) * p.Sq;
    for (int i = threadIdx.x; i < kBQ; i += kThreads) {
      const bool valid = r0 + i < p.Sq;
      sL[buf * kBQ + i] = valid ? p.lse[stat + r0 + i] : 0.f;
      sD[buf * kBQ + i] = valid ? p.delta[stat + r0 + i] : 0.f;
    }
  };

  load_tile_bf16<D, kRows, kThreads>(sK, kg, p.sks, n0, p.Skv);
  load_tile_bf16<D, kRows, kThreads>(sV, vg, p.svs, n0, p.Skv);
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
    const float* tL = sL + buf * kBQ;
    const float* tD = sD + buf * kBQ;
    const int r0 = q_first + (c % n_chunks) * kBQ;

    // S^T = K Q^T and dP^T = V dO^T for 16 keys x 32 rows
    float st[kBQ / 8][4], dpt[kBQ / 8][4];
#pragma unroll
    for (int t = 0; t < kBQ / 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[t][e] = dpt[t][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t ka[4], va[4];
      load_a<LD>(ka, sK, warp * 16, kk * 16, lane);
      load_a<LD>(va, sV, warp * 16, kk * 16, lane);
#pragma unroll
      for (int j = 0; j < kBQ / 16; ++j) {
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
    for (int t = 0; t < kBQ / 8; ++t) {
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
    for (int j = 0; j < kBQ / 16; ++j) {
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
// f32: SIMT FMA, 4 threads per row (each holds D / 4 of it as float4s)
// ---------------------------------------------------------------------------

constexpr int kF32Rows = 64;  // q rows of a dq block, keys of a dk/dv block
constexpr int kF32Step = 32;  // keys (dq) or q rows (dk/dv) per step
constexpr int kF32Threads = 4 * kF32Rows;

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

__device__ __forceinline__ void fma4(float4& acc, float s, float4 x) {
  acc.x += s * x.x;
  acc.y += s * x.y;
  acc.z += s * x.z;
  acc.w += s * x.w;
}

// sum over the 4 threads of a row
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// rows [row0, row0 + kF32Step) of a (rows, D) f32 slab into shared memory; zero past `limit`
template <int D>
__device__ __forceinline__ void load_tile_f32(float (*dst)[D], const float* src, long long stride,
                                              int row0, int limit) {
  for (int c = threadIdx.x; c < kF32Step * (D / 4); c += kF32Threads) {
    const int r = c / (D / 4), col = (c % (D / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < limit) x = *reinterpret_cast<const float4*>(src + (row0 + r) * stride + col);
    *reinterpret_cast<float4*>(&dst[r][col]) = x;
  }
}

template <int D>
__global__ void __launch_bounds__(kF32Threads) flash_bwd_dq_f32_kernel(const Params p) {
  constexpr int C = D / 16;  // float4 chunks per thread: chunk c * 4 + part
  __shared__ __align__(16) float sK[kF32Step][D];
  __shared__ __align__(16) float sV[kF32Step][D];

  const int n_qtiles = (p.Sq + kF32Rows - 1) / kF32Rows;
  const int r0 = (n_qtiles - 1 - (int)blockIdx.x) * kF32Rows;
  const int r1 = min(p.Sq, r0 + kF32Rows);
  const long long b = blockIdx.z, h = blockIdx.y, hk = h / p.group;
  const int part = threadIdx.x % 4;
  const int r = r0 + threadIdx.x / 4;

  const float* qg = static_cast<const float*>(p.q) + b * p.sqb + h * p.sqh;
  const float* og = static_cast<const float*>(p.dout) + b * p.sdob + h * p.sdoh;
  const float* kg = static_cast<const float*>(p.k) + b * p.skb + hk * p.skh;
  const float* vg = static_cast<const float*>(p.v) + b * p.svb + hk * p.svh;
  float* dqg = static_cast<float*>(p.dq) + b * p.sdqb + h * p.sdqh;

  float4 q[C], o[C], acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    q[c] = o[c] = acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < p.Sq) {
      q[c] = *reinterpret_cast<const float4*>(qg + r * p.sqs + (c * 4 + part) * 4);
      o[c] = *reinterpret_cast<const float4*>(og + r * p.sdos + (c * 4 + part) * 4);
    }
  }
  const long long stat = (b * p.H + h) * p.Sq;
  const float lse = r < p.Sq ? p.lse[stat + r] : 0.f;
  const float delta = r < p.Sq ? p.delta[stat + r] : 0.f;

  int k_lo, k_hi;
  key_range(p, r0, r1, k_lo, k_hi);
  for (int n0 = (k_lo / kF32Step) * kF32Step; n0 < k_hi; n0 += kF32Step) {
    __syncthreads();
    load_tile_f32<D>(sK, kg, p.sks, n0, p.Skv);
    load_tile_f32<D>(sV, vg, p.svs, n0, p.Skv);
    __syncthreads();
    for (int j = 0; j < kF32Step; ++j) {
      const float4* kr = reinterpret_cast<const float4*>(sK[j]);
      const float4* vr = reinterpret_cast<const float4*>(sV[j]);
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        s += dot4(q[c], kr[c * 4 + part]);
        dp += dot4(o[c], vr[c * 4 + part]);
      }
      s = quad_sum(s);
      dp = quad_sum(dp);
      bool vis;
      const float pr = prob<false>(p, s * p.scale, lse, r, n0 + j, vis);
      if (!vis) continue;
      const float ds = pr * (dp - delta);
#pragma unroll
      for (int c = 0; c < C; ++c) fma4(acc[c], ds, kr[c * 4 + part]);
    }
  }

  if (r >= p.Sq) return;
#pragma unroll
  for (int c = 0; c < C; ++c)
    *reinterpret_cast<float4*>(dqg + r * p.sdqs + (c * 4 + part) * 4) =
        make_float4(acc[c].x * p.scale, acc[c].y * p.scale, acc[c].z * p.scale,
                    acc[c].w * p.scale);
}

template <int D>
__global__ void __launch_bounds__(kF32Threads) flash_bwd_dkv_f32_kernel(const Params p) {
  constexpr int C = D / 16;
  __shared__ __align__(16) float sQ[kF32Step][D];
  __shared__ __align__(16) float sO[kF32Step][D];
  __shared__ float sL[kF32Step], sD[kF32Step];

  const int n0 = blockIdx.x * kF32Rows;
  const int n1 = min(p.Skv, n0 + kF32Rows);
  const long long b = blockIdx.z, hk = blockIdx.y;
  const int part = threadIdx.x % 4;
  const int key = n0 + threadIdx.x / 4;

  const float* kg = static_cast<const float*>(p.k) + b * p.skb + hk * p.skh;
  const float* vg = static_cast<const float*>(p.v) + b * p.svb + hk * p.svh;
  float* dkg = static_cast<float*>(p.dk) + b * p.sdkb + hk * p.sdkh;
  float* dvg = static_cast<float*>(p.dv) + b * p.sdvb + hk * p.sdvh;

  float4 k[C], v[C], dk[C], dv[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    k[c] = v[c] = dk[c] = dv[c] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (key < p.Skv) {
      k[c] = *reinterpret_cast<const float4*>(kg + key * p.sks + (c * 4 + part) * 4);
      v[c] = *reinterpret_cast<const float4*>(vg + key * p.svs + (c * 4 + part) * 4);
    }
  }

  int q_lo, q_hi;
  query_range(p, n0, n1, q_lo, q_hi);
  for (int g = 0; g < p.group; ++g) {
    const long long h = hk * p.group + g;
    const float* qg = static_cast<const float*>(p.q) + b * p.sqb + h * p.sqh;
    const float* og = static_cast<const float*>(p.dout) + b * p.sdob + h * p.sdoh;
    const long long stat = (b * p.H + h) * p.Sq;
    for (int r0 = (q_lo / kF32Step) * kF32Step; r0 < q_hi; r0 += kF32Step) {
      __syncthreads();
      load_tile_f32<D>(sQ, qg, p.sqs, r0, p.Sq);
      load_tile_f32<D>(sO, og, p.sdos, r0, p.Sq);
      for (int i = threadIdx.x; i < kF32Step; i += kF32Threads) {
        sL[i] = r0 + i < p.Sq ? p.lse[stat + r0 + i] : 0.f;
        sD[i] = r0 + i < p.Sq ? p.delta[stat + r0 + i] : 0.f;
      }
      __syncthreads();
      for (int i = 0; i < kF32Step; ++i) {
        const float4* qr = reinterpret_cast<const float4*>(sQ[i]);
        const float4* orow = reinterpret_cast<const float4*>(sO[i]);
        float s = 0.f, dp = 0.f;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          s += dot4(k[c], qr[c * 4 + part]);
          dp += dot4(v[c], orow[c * 4 + part]);
        }
        s = quad_sum(s);
        dp = quad_sum(dp);
        bool vis;
        const float pr = prob<false>(p, s * p.scale, sL[i], r0 + i, key, vis);
        const float ds = vis ? pr * (dp - sD[i]) : 0.f;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          fma4(dv[c], pr, orow[c * 4 + part]);
          fma4(dk[c], ds, qr[c * 4 + part]);
        }
      }
    }
  }

  if (key >= p.Skv) return;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    *reinterpret_cast<float4*>(dkg + key * p.sdks + (c * 4 + part) * 4) =
        make_float4(dk[c].x * p.scale, dk[c].y * p.scale, dk[c].z * p.scale, dk[c].w * p.scale);
    *reinterpret_cast<float4*>(dvg + key * p.sdvs + (c * 4 + part) * 4) = dv[c];
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <int D>
cudaError_t launch_dq(const Params& p, int dtype, cudaStream_t stream) {
  const int rows = dtype == 1 ? kRows : kF32Rows;
  const dim3 grid((p.Sq + rows - 1) / rows, p.H, p.B);
  if (dtype == 0) {
    flash_bwd_dq_f32_kernel<D><<<grid, kF32Threads, 0, stream>>>(p);
    return cudaGetLastError();
  }
  const int smem = (2 * kRows + 4 * kBN) * (D + 8) * (int)sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_bf16_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_bf16_kernel<D><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const Params& p, int dtype, cudaStream_t stream) {
  const int rows = dtype == 1 ? kRows : kF32Rows;
  const dim3 grid((p.Skv + rows - 1) / rows, p.Hk, p.B);
  if (dtype == 0) {
    flash_bwd_dkv_f32_kernel<D><<<grid, kF32Threads, 0, stream>>>(p);
    return cudaGetLastError();
  }
  const int smem = (2 * kRows + 4 * kBQ) * (D + 8) * (int)sizeof(__nv_bfloat16) +
                   4 * kBQ * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_bf16_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_bf16_kernel<D><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
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
// (B, H, Sq) f32.  window <= 0 means no window.  flash_bwd_dq writes dq;
// flash_bwd_dkv writes dk and dv, summed over each kv head's query group.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, void* dq, int dtype, int B, int H,
                            int Hk, int Sq, int Skv, int D, const long long* strides, float scale,
                            int causal, int window, int q_offset, void* stream) {
  const Params p = make_params(q, k, v, dout, lse, delta, dq, nullptr, nullptr, B, H, Hk, Sq, Skv,
                               strides, scale, causal, window, q_offset);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  switch (D) {
    case 16: return launch_dq<16>(p, dtype, st);
    case 32: return launch_dq<32>(p, dtype, st);
    case 64: return launch_dq<64>(p, dtype, st);
    case 128: return launch_dq<128>(p, dtype, st);
  }
  return cudaErrorInvalidValue;
}

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta, void* dk, void* dv, int dtype,
                             int B, int H, int Hk, int Sq, int Skv, int D,
                             const long long* strides, float scale, int causal, int window,
                             int q_offset, void* stream) {
  const Params p = make_params(q, k, v, dout, lse, delta, nullptr, dk, dv, B, H, Hk, Sq, Skv,
                               strides, scale, causal, window, q_offset);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  switch (D) {
    case 16: return launch_dkv<16>(p, dtype, st);
    case 32: return launch_dkv<32>(p, dtype, st);
    case 64: return launch_dkv<64>(p, dtype, st);
    case 128: return launch_dkv<128>(p, dtype, st);
  }
  return cudaErrorInvalidValue;
}
