// Flash-attention forward for Hopper (sm_90a), written by hand.
//
// Replaces the TPU kernel `_flash_fwd_kernel` of
// src/repro/kernels/flash_attention/flash_attention.py:35-76, reached there
// through `flash_attention_fwd` (:315-360).  It computes the same function:
// blockwise causal / sliding-window GQA attention with an online softmax
// (running max m, running sum l, f32 accumulator), a `q_offset` that places
// the q block in the kv timeline, scale defaulting to Dh**-0.5, output in the
// input dtype.  Query head h reads kv head h / (H / Hk).
//
// What bounds it on the H100.  At the serving prefill shape (B=4, H=24, Hk=8,
// S=1024, Dh=128, bf16, causal) the work is about 2.58e10 FLOP, 26 us at 989
// TFLOP/s, against 67 MB of q/k/v/o, 20 us at 3.35 TB/s: the operations bound
// it.  So the bf16 path runs both products on the tensor cores (mma.sync
// m16n8k16, f32 accumulate), keeps scores and probabilities in registers,
// never in device memory, and bounds each block's k loop by the causal and
// window limits instead of visiting masked tiles as the TPU grid does.  This
// is the simple design: one 4-warp block per (64-row q tile, head, batch),
// 16 q rows per warp, 64-key K/V tiles in padded (bank-conflict-free for
// ldmatrix) shared memory, double-buffered with cp.async so the next tile
// loads while this one is used, three blocks per SM (the Q tile is held in
// registers after a first pass through shared memory), heaviest causal
// tiles scheduled first.  No TMA or wgmma yet.  Tried and dropped: 32 q
// rows per warp (two m16 tiles sharing each K/V fragment) needs 255
// registers, spills, and was slower.
//
// The f32 path, which serving does not take, is SIMT FMA (4 threads per q
// row) so that it keeps f32 accuracy.
//
// Semantics kept from the TPU kernel: masked scores are -1e30, never -inf,
// so a query row that sees no key averages v over all keys, exactly as the
// TPU grid (which visits every k tile) and the reference do; a block holding
// such a row walks every key.  Keys past Skv (a ragged edge, which the TPU
// kernel never has) score -inf and read zero-filled v, so they never count.
//
// With a non-null `lse` it is also the TPU kernel `_flash_fwd_lse_kernel`
// (flash_attention.py:79-118, via `flash_attention_fwd_lse` :200): it writes
// lse = m + log(l) in f32 per (b, h, q row), contiguous (B, H, Sq), for the
// backward (csrc/flash_bwd.cu).  One departure: for a row that sees no key
// the TPU kernel stores -1e30 + log(Skv), which rounds to -1e30 in f32 and
// makes its backward take p = 1 instead of 1/Skv.  Here such a row stores
// the logsumexp of its uniform scores taken as 0, log(Skv), from which the
// backward rebuilds p = 1/Skv exactly.
//
// C interface (bound with ctypes): pointers, element strides, ints and the
// stream; returns the cudaError_t of the launch.

#include "flash_common.cuh"

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
};

__device__ __forceinline__ float masked_score(const Params& p, float s, int qpos, int key) {
  if (key >= p.Skv) return -INFINITY;
  if (p.causal && key > qpos) return kMasked;
  if (p.has_window && key <= qpos - p.window) return kMasked;
  return s;
}

// logsumexp of a row from its running max and sum; m stays at kMasked only
// for a row that sees no key, whose scores count as 0 (see the header)
__device__ __forceinline__ float row_lse(float m, float l) {
  return (m == kMasked ? 0.f : m) + logf(fmaxf(l, 1e-30f));
}

// ---------------------------------------------------------------------------
// bf16: tensor cores through mma.sync
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
// f32: SIMT FMA, 4 threads per q row
// ---------------------------------------------------------------------------

constexpr int kF32Rows = 64;
constexpr int kF32Keys = 32;
constexpr int kF32Threads = 4 * kF32Rows;

template <int D>
__global__ void __launch_bounds__(kF32Threads) flash_fwd_f32_kernel(const Params p) {
  constexpr int C = D / 16;  // float4 chunks per thread: chunk c * 4 + part
  __shared__ __align__(16) float sK[kF32Keys][D];
  __shared__ __align__(16) float sV[kF32Keys][D];

  const int n_qtiles = (p.Sq + kF32Rows - 1) / kF32Rows;
  const int r0 = (n_qtiles - 1 - (int)blockIdx.x) * kF32Rows;
  const int r1 = min(p.Sq, r0 + kF32Rows);
  const long long b = blockIdx.z, h = blockIdx.y, hk = h / p.group;
  const int part = threadIdx.x % 4;
  const int r = r0 + threadIdx.x / 4;
  const int qpos = r + p.q_offset;

  const float* qg = static_cast<const float*>(p.q) + b * p.sqb + h * p.sqh;
  const float* kg = static_cast<const float*>(p.k) + b * p.skb + hk * p.skh;
  const float* vg = static_cast<const float*>(p.v) + b * p.svb + hk * p.svh;
  float* og = static_cast<float*>(p.o) + b * p.sob + h * p.soh;

  float4 q[C], acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < p.Sq) x = *reinterpret_cast<const float4*>(qg + r * p.sqs + (c * 4 + part) * 4);
    q[c] = make_float4(x.x * p.scale, x.y * p.scale, x.z * p.scale, x.w * p.scale);
    acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float m_run = kMasked, l_run = 0.f;

  int k_lo, k_hi;
  key_range(p, r0, r1, k_lo, k_hi);
  for (int n0 = (k_lo / kF32Keys) * kF32Keys; n0 < k_hi; n0 += kF32Keys) {
    __syncthreads();
    for (int c = threadIdx.x; c < kF32Keys * (D / 4); c += kF32Threads) {
      const int rr = c / (D / 4), col = (c % (D / 4)) * 4;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (n0 + rr < p.Skv) {
        kv = *reinterpret_cast<const float4*>(kg + (n0 + rr) * p.sks + col);
        vv = *reinterpret_cast<const float4*>(vg + (n0 + rr) * p.svs + col);
      }
      *reinterpret_cast<float4*>(&sK[rr][col]) = kv;
      *reinterpret_cast<float4*>(&sV[rr][col]) = vv;
    }
    __syncthreads();

    float s[kF32Keys];
    float m_new = m_run;
#pragma unroll
    for (int j = 0; j < kF32Keys; ++j) {
      const float4* kr = reinterpret_cast<const float4*>(sK[j]);
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float4 kv = kr[c * 4 + part];
        dot += q[c].x * kv.x + q[c].y * kv.y + q[c].z * kv.z + q[c].w * kv.w;
      }
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      dot += __shfl_xor_sync(0xffffffffu, dot, 2);
      s[j] = masked_score(p, dot, qpos, n0 + j);
      m_new = fmaxf(m_new, s[j]);
    }
    const float alpha = expf(m_run - m_new);
    m_run = m_new;
    l_run *= alpha;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      acc[c].x *= alpha;
      acc[c].y *= alpha;
      acc[c].z *= alpha;
      acc[c].w *= alpha;
    }
#pragma unroll
    for (int j = 0; j < kF32Keys; ++j) {
      const float pj = expf(s[j] - m_new);
      l_run += pj;
      const float4* vr = reinterpret_cast<const float4*>(sV[j]);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float4 vv = vr[c * 4 + part];
        acc[c].x += pj * vv.x;
        acc[c].y += pj * vv.y;
        acc[c].z += pj * vv.z;
        acc[c].w += pj * vv.w;
      }
    }
  }

  if (r >= p.Sq) return;
  if (p.lse != nullptr && part == 0) p.lse[(b * p.H + h) * p.Sq + r] = row_lse(m_run, l_run);
  const float inv = 1.f / fmaxf(l_run, 1e-30f);
#pragma unroll
  for (int c = 0; c < C; ++c)
    *reinterpret_cast<float4*>(og + r * p.sos + (c * 4 + part) * 4) =
        make_float4(acc[c].x * inv, acc[c].y * inv, acc[c].z * inv, acc[c].w * inv);
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

template <int D>
cudaError_t launch_f32(const Params& p, cudaStream_t stream) {
  const dim3 grid((p.Sq + kF32Rows - 1) / kF32Rows, p.H, p.B);
  flash_fwd_f32_kernel<D><<<grid, kF32Threads, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements; the last
// dimension of every tensor is contiguous.  window <= 0 means no window.
// lse: null, or a contiguous (B, H, Sq) f32 buffer to fill.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                         int dtype, int B,
                         int H, int Hk, int Sq, int Skv, int D, long long sqb, long long sqh,
                         long long sqs, long long skb, long long skh, long long sks,
                         long long svb, long long svh, long long svs, long long sob,
                         long long soh, long long sos, float scale, int causal, int window,
                         int q_offset, void* stream) {
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    switch (D) {
      case 16: return launch_bf16<16>(p, st);
      case 32: return launch_bf16<32>(p, st);
      case 64: return launch_bf16<64>(p, st);
      case 128: return launch_bf16<128>(p, st);
    }
  } else if (dtype == 0) {
    switch (D) {
      case 16: return launch_f32<16>(p, st);
      case 32: return launch_f32<32>(p, st);
      case 64: return launch_f32<64>(p, st);
      case 128: return launch_f32<128>(p, st);
    }
  }
  return cudaErrorInvalidValue;
}
