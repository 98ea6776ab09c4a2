// Chunkwise mLSTM forward for Hopper (sm_90a), written by hand.
//
// Replaces the TPU kernel `_mlstm_kernel` of src/repro/kernels/mlstm/mlstm.py:26-72,
// reached there through `mlstm_fwd` (:75-104).  It computes the same function,
// the stabilised chunkwise xLSTM matrix memory: C (D, D), n (D,) and the
// stabiliser m (start -1e30) carried over the sequence; per tile of Q rows,
// with cumf the inclusive cumsum of log f,
//
//   b[t][s] = cumf_t - cumf_s + i_s  (s <= t),   c_t = cumf_t + m_in
//   m_t     = max(max_s b[t][s], c_t, -1e30)
//   w       = exp(b - m_t),  a_t = exp(c_t - m_t)
//   y       = (w o q k^T) v + a_t (q C)
//   q.n_t   = rowsum(w o q k^T) + a_t (q . n)          [= q . (w k + a_t n)]
//   h       = y / max(|q.n_t|, exp(-m_t))
//   e_s     = cumf_end - cumf_s + i_s,  m_out = max(m_in + cumf_end, max_s e_s)
//   C'      = C exp(m_in + cumf_end - m_out) + sum_s exp(e_s - m_out) k_s v_s^T
//   n'      = n exp(m_in + cumf_end - m_out) + sum_s exp(e_s - m_out) k_s
//
// with q pre-scaled by 1/sqrt(D).  m_t is the running maximum of the
// sequential recurrence whatever the tiling, so the output does not depend
// on where the rows are cut (only the rounding does): the kernels walk tiles
// of their own kQ = 64 rows whatever the caller's chunk.  The -1e30 sentinel
// keeps the plain version's meaning: a padded row (i = -1e30) gives b and e
// of -1e30 and weights exp(-1e30 - m) = 0; the first tile's m_in = -1e30 gives
// a_t = 0; where the plain version computes exp(-1e30 - (-1e30)) = 1 (a tile
// of padding before any real row), the split below computes the same 1.
//
// What bounds it on the H100.  At xlstm-125m (H = 4, D = 192) for 4 x 1024
// tokens the products are 3.22e9 FLOP counted at chunk 64, 0.0195 ms at the
// 3xTF32 rate (495 / 3 = 165 TFLOP/s; 0.048 ms at the f32 SIMT peak of 67),
// against 50.5 MB of f32 inputs and output, 0.015 ms at 3.35 TB/s.  So the
// products run on the tensor cores in 3xTF32 (mma.sync m16n8k8, see
// common/tf32_mma.cuh), f32-accurate; the gates, the stabiliser and the
// normaliser stay in f32.
//
// Design: the chunk states in parallel, in three kernels (the xLSTM
// chunkwise form, the same function with the sums in another order):
//   (a) mlstm_state_kernel, per (64-column value slice, tile, batch x head),
//       every tile but the last: the tile's own contribution, F = cumf_end,
//       mu = max_s e_s, dC = sum_s exp(e_s - mu) k_s v_s^T (D x 64) and
//       dn = sum_s exp(e_s - mu) k_s, into a scratch buffer of
//       (B H, nT, D, D + 1) f32 the wrapper allocates (9.5 M floats at
//       xlstm-125m).
//   (b) mlstm_combine_kernel, per (batch x head, slice of the D (D + 1)
//       entries): the serial combine over tiles, exactly the recurrence above,
//       m_out = max(m_in + F, mu), C' = C exp(m_in + F - m_out) +
//       dC exp(mu - m_out); elementwise, it overwrites each tile's dC with the
//       tile's incoming C (and dn, m_in likewise).
//   (c) mlstm_out_kernel, per (value slice, tile, batch x head): 768 blocks of
//       8 warps at xlstm-125m.  q k^T and q C accumulate together over the
//       head dimension in 32-wide steps (q, k, the incoming C's and n's
//       rows); then w o q k^T, its row sums and the normaliser, and
//       (w o q k^T) v.  Each slice's block recomputes q k^T (a third of its
//       products at D = 192): the price of 3x the blocks.  One stage of
//       loads: at 66 KB a block three blocks share an SM and hide each
//       other's loads, which a second stage (two blocks an SM) does not beat.
// kFuseState switches (a) and (b) for mlstm_state_walk_kernel, one serial
// walk per (64 x 64) slice of the state (the same sums in the same order);
// it and the other constants are the parts chip_profile.py scan_ablate
// switches.  Shared memory rows are padded so fragment loads are free of
// bank conflicts; (a) takes 70 KB at D = 192.
//
// Sizes: D up to 256, any chunk up to 256 with S a multiple of it; tiles of
// kQ rows zero-filled past S.  Inputs are contiguous: q, k, v, y (B, S, H, D);
// the gates (B, S, H); vec = D a multiple of 4 and aligned bases (16-byte
// loads).
//
// C interface (bound with ctypes): pointers, ints and the stream; returns the
// cudaError_t of the launches.  mlstm_fwd_scratch gives the scratch's size.

#include <math.h>

#include <cuda_runtime.h>

#include "tf32_mma.cuh"

namespace {

constexpr int kQ = 64;          // rows per tile
constexpr int kDV = 64;         // value columns per block
constexpr int kDK = 32;         // head-dimension step of (c)
constexpr int kStages = 1;      // (c)'s load ring: one stage, three blocks an SM
constexpr bool kFuseState = false;  // (a) and (b) as one serial walk per state slice
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxD = 256, kMaxChunk = 256;
constexpr float NEG = -1e30f;

struct Params {
  const float* q;
  const float* k;
  const float* v;
  const float* ig;
  const float* lf;
  float* y;
  float* dC;   // (B H, nT, D, D): dC, then the incoming C
  float* dn;   // (B H, nT, D): dn, then the incoming n
  float* sc;   // (B H, nT, 4): F, mu, m_in
  int B, S, H, D, vec;
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// warp 0: inclusive cumsum of log f over the tile (rows past `rows` add 0)
// into sCumf, and the input gate, -1e30 past `rows`, into sI
__device__ __forceinline__ void tile_gates(const float* sLf, const float* sIg, int rows,
                                           float* sCumf, float* sI) {
  const int lane = threadIdx.x % 32;
  float c0 = sLf[lane], c1 = sLf[lane + 32];
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u0 = __shfl_up_sync(0xffffffffu, c0, o);
    const float u1 = __shfl_up_sync(0xffffffffu, c1, o);
    if (lane >= o) {
      c0 += u0;
      c1 += u1;
    }
  }
  c1 += __shfl_sync(0xffffffffu, c0, 31);
  sCumf[lane] = c0;
  sCumf[lane + 32] = c1;
  sI[lane] = lane < rows ? sIg[lane] : NEG;
  sI[lane + 32] = lane + 32 < rows ? sIg[lane + 32] : NEG;
}

__host__ __device__ __forceinline__ int ld_k(int D) { return ((D + 31) / 32) * 32 + 8; }  // 8 mod 32

// (a) the tile's own contribution
__global__ void __launch_bounds__(kThreads) mlstm_state_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  const int D = p.D, H = p.H, ldk = ld_k(D), Dr = ldk - 8;
  constexpr int ldv = kDV + 8;
  float* sK = smem;               // [s][d]
  float* sV = sK + kQ * ldk;      // [s][j]
  float* sLf = sV + kQ * ldv;
  float* sIg = sLf + kQ;
  float* sCumf = sIg + kQ;
  float* sI = sCumf + kQ;
  float* sAmp = sI + kQ;          // exp(e_s - mu), 0 past the tile

  const int j0 = blockIdx.x * kDV, tile = blockIdx.y, bh = blockIdx.z;
  const int b = bh / H, h = bh % H, nT = (p.S + kQ - 1) / kQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, q = lane & 3;
  const int r0 = tile * kQ, rows = min(kQ, p.S - r0), jv = min(kDV, D - j0);
  const long long row = (long long)H * D;
  const long long base = ((long long)b * p.S + r0) * row + (long long)h * D;
  tf32::load_tile<kThreads>(sK, ldk, p.k + base, row, kQ, Dr, rows, D, p.vec);
  tf32::load_tile<kThreads>(sV, ldv, p.v + base + j0, row, kQ, kDV, rows, jv, p.vec);
  const long long gbase = ((long long)b * p.S + r0) * H + h;
  for (int i = threadIdx.x; i < kQ; i += kThreads) {
    const long long off = gbase + (long long)(i < rows ? i : 0) * H;
    tf32::cp4(sLf + i, p.lf + off, i < rows);
    tf32::cp4(sIg + i, p.ig + off, i < rows);
  }
  tf32::commit();
  tf32::wait<0>();
  __syncthreads();

  if (warp == 0) {
    tile_gates(sLf, sIg, rows, sCumf, sI);
    __syncwarp();
    const float F = sCumf[kQ - 1];
    const float e0 = lane < rows ? F - sCumf[lane] + sI[lane] : -INFINITY;
    const float e1 = lane + 32 < rows ? F - sCumf[lane + 32] + sI[lane + 32] : -INFINITY;
    const float mu = warp_max(fmaxf(e0, e1));
    sAmp[lane] = lane < rows ? expf(e0 - mu) : 0.f;
    sAmp[lane + 32] = lane + 32 < rows ? expf(e1 - mu) : 0.f;
    if (blockIdx.x == 0 && lane == 0) {
      float* sc = p.sc + ((long long)bh * nT + tile) * 4;
      sc[0] = F;
      sc[1] = mu;
    }
  }
  __syncthreads();

  float* dC = p.dC + ((long long)bh * nT + tile) * D * D;
  // dC[d][j] = sum_s (amp_s k[s][d]) v[s][j]: items of (16 rows d, 32 columns j)
  const int nMt = (D + 15) / 16;
  for (int item = warp; item < 2 * nMt; item += kWarps) {
    const int mt = item >> 1, jh = item & 1;
    const int d0 = mt * 16 + g, d1 = d0 + 8;
    float acc[4][4] = {};
#pragma unroll
    for (int ks = 0; ks < kQ / 8; ++ks) {
      const int s0 = ks * 8 + q, s1 = s0 + 4;
      const float w0 = sAmp[s0], w1 = sAmp[s1];
      const tf32::AFrag a = tf32::a_frag(sK[s0 * ldk + d0] * w0, sK[s0 * ldk + d1] * w0,
                                         sK[s1 * ldk + d0] * w1, sK[s1 * ldk + d1] * w1);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = jh * 32 + j * 8 + g;
        tf32::mma(acc[j], a, tf32::b_frag(sV[s0 * ldv + col], sV[s1 * ldv + col]));
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = jh * 32 + j * 8 + 2 * q;
      if (col >= jv) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int d = half ? d1 : d0;
        if (d >= D) continue;
        float* dst = dC + (long long)d * D + j0 + col;
        if (p.vec) {
          *reinterpret_cast<float2*>(dst) = make_float2(acc[j][2 * half], acc[j][2 * half + 1]);
        } else {
          dst[0] = acc[j][2 * half];
          if (col + 1 < jv) dst[1] = acc[j][2 * half + 1];
        }
      }
    }
  }
  if (blockIdx.x == 0) {  // dn = sum_s amp_s k_s, f32 FMA
    float* dn = p.dn + ((long long)bh * nT + tile) * D;
    for (int d = threadIdx.x; d < D; d += kThreads) {
      float acc = 0.f;
      for (int s = 0; s < kQ; ++s) acc = fmaf(sAmp[s], sK[s * ldk + d], acc);
      dn[d] = acc;
    }
  }
}

// (b) the serial combine over tiles, entry by entry, in place
__global__ void __launch_bounds__(256) mlstm_combine_kernel(const Params p) {
  const int bh = blockIdx.y, D = p.D, nT = (p.S + kQ - 1) / kQ;
  const long long DD = (long long)D * D;
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= DD + D) return;
  const bool writer = e == 0;  // writes m_in
  const float* sc = p.sc + (long long)bh * nT * 4;
  float* ptr = e < DD ? p.dC + (long long)bh * nT * DD + e
                      : p.dn + (long long)bh * nT * D + (e - DD);
  const long long stride = e < DD ? DD : D;
  float val = 0.f, m_in = NEG;
  float next = nT > 1 ? ptr[0] : 0.f;
  for (int c = 0; c < nT; ++c) {
    const float d = next;
    if (c + 2 < nT) next = ptr[(c + 1) * stride];  // one tile ahead
    ptr[c * stride] = val;
    if (writer) p.sc[((long long)bh * nT + c) * 4 + 2] = m_in;
    if (c + 1 < nT) {
      const float F = sc[c * 4], mu = sc[c * 4 + 1];
      const float m_out = fmaxf(m_in + F, mu);
      val = val * expf(m_in + F - m_out) + d * expf(mu - m_out);
      m_in = m_out;
    }
  }
}

// (a) and (b) in one kernel: per (64-column value slice j, 64-row slice d of
// the state, batch x head) the tiles in order, the state slice (64, 64) in
// registers; each tile writes the slice it starts from (the incoming C, n and
// m that (c) reads), then adds its own contribution
__global__ void __launch_bounds__(kThreads) mlstm_state_walk_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  constexpr int ld = 64 + 8;  // k [s][d] and v [s][j], read (row q, column g)
  constexpr int stage = 2 * kQ * ld + 2 * kQ;  // k, v, log f, i
  const int D = p.D, H = p.H;
  const int j0 = blockIdx.x * kDV, d0 = blockIdx.y * 64, bh = blockIdx.z;
  const int b = bh / H, h = bh % H, nT = (p.S + kQ - 1) / kQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, q = lane & 3;
  const int jv = min(kDV, D - j0), dv = min(64, D - d0);
  const long long row = (long long)H * D;
  float* sAmp = smem + kStages * stage + warp * kQ;  // this warp's exp(e_s - mu)

  auto load = [&](int c) {
    float* st = smem + (c % kStages) * stage;
    const int r0 = c * kQ, rows = min(kQ, p.S - r0);
    const long long base = ((long long)b * p.S + r0) * row + (long long)h * D;
    tf32::load_tile<kThreads>(st, ld, p.k + base + d0, row, kQ, 64, rows, dv, p.vec);
    tf32::load_tile<kThreads>(st + kQ * ld, ld, p.v + base + j0, row, kQ, kDV, rows, jv, p.vec);
    const long long gbase = ((long long)b * p.S + r0) * H + h;
    for (int i = threadIdx.x; i < kQ; i += kThreads) {
      const long long off = gbase + (long long)(i < rows ? i : 0) * H;
      tf32::cp4(st + 2 * kQ * ld + i, p.lf + off, i < rows);
      tf32::cp4(st + 2 * kQ * ld + kQ + i, p.ig + off, i < rows);
    }
    tf32::commit();
  };

  // warp (mt, jh): state rows d0 + 16 mt .., columns j0 + 32 jh ..
  const int mt = warp & 3, jh = warp >> 2;
  float cst[4][4] = {};
  float nval = 0.f, m_in = NEG;  // n: thread d - d0 < 64 of the blocks of slice j 0
  const bool n_owner = blockIdx.x == 0 && threadIdx.x < dv;
  load(0);
  for (int c = 0; c < nT; ++c) {
    if (kStages == 1 && c > 0) load(c);
    tf32::wait<0>();
    __syncthreads();
    if (kStages == 2 && c + 1 < nT) load(c + 1);
    const long long slot = (long long)bh * nT + c;
    // the state this tile starts from
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = jh * 32 + j * 8 + 2 * q;
      if (col >= jv) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int d = mt * 16 + g + 8 * half;
        if (d >= dv) continue;
        float* dst = p.dC + slot * D * D + (long long)(d0 + d) * D + j0 + col;
        if (p.vec) {
          *reinterpret_cast<float2*>(dst) = make_float2(cst[j][2 * half], cst[j][2 * half + 1]);
        } else {
          dst[0] = cst[j][2 * half];
          if (col + 1 < jv) dst[1] = cst[j][2 * half + 1];
        }
      }
    }
    if (n_owner) p.dn[slot * D + d0 + threadIdx.x] = nval;
    if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0) p.sc[slot * 4 + 2] = m_in;
    if (c + 1 < nT) {
      const float* st = smem + (c % kStages) * stage;
      const float* sK = st;
      const float* sV = st + kQ * ld;
      const float* sLf = st + 2 * kQ * ld;
      const int rows = min(kQ, p.S - c * kQ);
      // every warp: cumf, e_s = F - cumf_s + i_s, mu = max e_s, m_out
      float c0 = sLf[lane], c1 = sLf[lane + 32];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u0 = __shfl_up_sync(0xffffffffu, c0, o);
        const float u1 = __shfl_up_sync(0xffffffffu, c1, o);
        if (lane >= o) {
          c0 += u0;
          c1 += u1;
        }
      }
      c1 += __shfl_sync(0xffffffffu, c0, 31);
      const float F = __shfl_sync(0xffffffffu, c1, 31);
      const float e0 = lane < rows ? F - c0 + sLf[kQ + lane] : -INFINITY;
      const float e1 = lane + 32 < rows ? F - c1 + sLf[kQ + lane + 32] : -INFINITY;
      const float mu = warp_max(fmaxf(e0, e1));
      sAmp[lane] = lane < rows ? expf(e0 - mu) : 0.f;
      sAmp[lane + 32] = lane + 32 < rows ? expf(e1 - mu) : 0.f;
      __syncwarp();
      const float m_out = fmaxf(m_in + F, mu);
      const float keep = expf(m_in + F - m_out), add = expf(mu - m_out);
      // C = C keep + ((amp k)^T v) add
      float acc[4][4] = {};
      const int dl0 = mt * 16 + g, dl1 = dl0 + 8;
#pragma unroll
      for (int ks = 0; ks < kQ / 8; ++ks) {
        const int s0 = ks * 8 + q, s1 = s0 + 4;
        const float w0 = sAmp[s0], w1 = sAmp[s1];
        const tf32::AFrag a = tf32::a_frag(sK[s0 * ld + dl0] * w0, sK[s0 * ld + dl1] * w0,
                                           sK[s1 * ld + dl0] * w1, sK[s1 * ld + dl1] * w1);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = jh * 32 + j * 8 + g;
          tf32::mma(acc[j], a, tf32::b_frag(sV[s0 * ld + col], sV[s1 * ld + col]));
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) cst[j][i] = cst[j][i] * keep + acc[j][i] * add;
      if (n_owner) {  // n = n keep + (sum_s amp_s k_s) add, f32 FMA
        float dn = 0.f;
        for (int s = 0; s < kQ; ++s) dn = fmaf(sAmp[s], sK[s * ld + threadIdx.x], dn);
        nval = nval * keep + dn * add;
      }
      m_in = m_out;
    }
    if (kStages == 1) __syncthreads();
  }
}

// (c) the outputs from each tile's incoming state
struct OutLayout {
  static constexpr int ldQ = kDK + 4;   // q [t][d], read (row g, column q)
  static constexpr int ldKk = kDK + 4;  // k [s][d], read (row g, column q)
  static constexpr int ldC = kDV + 8;   // C [d][j], read (row q, column g)
  static constexpr int ldV = kDV + 8;   // v [s][j], read (row q, column g)
  static constexpr int ldW = kQ + 4;    // w o q k^T [t][s], read (row g, column q)
  static constexpr int Qo = 0, Ko = Qo + kQ * ldQ, Co = Ko + kQ * ldKk, No = Co + kDK * ldC,
                       stage = No + kDK;
  static constexpr int V = kStages * stage, W = V + kQ * ldV, Lf = W + kQ * ldW, Ig = Lf + kQ,
                       Cumf = Ig + kQ, I = Cumf + kQ, Mt = I + kQ, At = Mt + kQ, Qn = At + kQ,
                       Rs = Qn + kQ, total = Rs + 2 * kQ;
};

__global__ void __launch_bounds__(kThreads) mlstm_out_kernel(const Params p) {
  using L = OutLayout;
  extern __shared__ __align__(16) float smem[];
  const int D = p.D, H = p.H;
  const int j0 = blockIdx.x * kDV, tile = blockIdx.y, bh = blockIdx.z;
  const int b = bh / H, h = bh % H, nT = (p.S + kQ - 1) / kQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, q = lane & 3;
  const int r0 = tile * kQ, rows = min(kQ, p.S - r0), jv = min(kDV, D - j0);
  const long long row = (long long)H * D;
  const long long base = ((long long)b * p.S + r0) * row + (long long)h * D;
  const float* Cin = p.dC + ((long long)bh * nT + tile) * D * D + j0;
  const float* nin = p.dn + ((long long)bh * nT + tile) * D;
  const float m_in = p.sc[((long long)bh * nT + tile) * 4 + 2];
  const int nD = (D + kDK - 1) / kDK;

  auto load = [&](int db) {  // head-dimension step db into its stage
    float* st = smem + (db % kStages) * L::stage;
    const int d0 = db * kDK, dv = min(kDK, D - d0);
    tf32::load_tile<kThreads>(st + L::Qo, L::ldQ, p.q + base + d0, row, kQ, kDK, rows, dv, p.vec);
    tf32::load_tile<kThreads>(st + L::Ko, L::ldKk, p.k + base + d0, row, kQ, kDK, rows, dv,
                              p.vec);
    tf32::load_tile<kThreads>(st + L::Co, L::ldC, Cin + (long long)d0 * D, D, kDK, kDV, dv, jv,
                              p.vec);
    tf32::load_tile<kThreads>(st + L::No, kDK, nin + d0, 0, 1, kDK, 1, dv, p.vec);
  };

  // first group: the gates, v's slice and the first step
  {
    const long long gbase = ((long long)b * p.S + r0) * H + h;
    for (int i = threadIdx.x; i < kQ; i += kThreads) {
      const long long off = gbase + (long long)(i < rows ? i : 0) * H;
      tf32::cp4(smem + L::Lf + i, p.lf + off, i < rows);
      tf32::cp4(smem + L::Ig + i, p.ig + off, i < rows);
    }
    tf32::load_tile<kThreads>(smem + L::V, L::ldV, p.v + base + j0, row, kQ, kDV, rows, jv,
                              p.vec);
  }
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nD) load(s);
    tf32::commit();
  }

  // warp (mt, jh): rows 16 mt .. 16 mt + 15, columns 32 jh .. 32 jh + 31 of
  // q k^T (keys) and of y (values)
  const int mt = warp & 3, jh = warp >> 2;
  const int t0 = mt * 16 + g, t1 = t0 + 8;
  const bool has_s = 32 * jh <= 16 * mt + 15;  // any key of this half on or below the diagonal
  float sacc[4][4] = {}, yacc[4][4] = {};
  float qn = 0.f;  // lanes of jh == 0: row 16 mt + lane % 16, half lane / 16 of each step
  for (int db = 0; db < nD; ++db) {
    if (db + kStages - 1 < nD) load(db + kStages - 1);
    tf32::commit();
    tf32::wait<kStages - 1>();
    __syncthreads();
    if (db == 0 && warp == 0) tile_gates(smem + L::Lf, smem + L::Ig, rows, smem + L::Cumf,
                                         smem + L::I);
    const float* st = smem + (db % kStages) * L::stage;
    const float* sQ = st + L::Qo;
    const float* sK = st + L::Ko;
    const float* sC = st + L::Co;
#pragma unroll
    for (int ks = 0; ks < kDK / 8; ++ks) {
      const int c0 = ks * 8 + q, c1 = c0 + 4;
      const tf32::AFrag a = tf32::a_frag(sQ[t0 * L::ldQ + c0], sQ[t1 * L::ldQ + c0],
                                         sQ[t0 * L::ldQ + c1], sQ[t1 * L::ldQ + c1]);
      if (has_s) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int s = jh * 32 + j * 8;
          if (s > mt * 16 + 15) continue;  // above the diagonal
          tf32::mma(sacc[j], a, tf32::b_frag(sK[(s + g) * L::ldKk + c0],
                                             sK[(s + g) * L::ldKk + c1]));
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = jh * 32 + j * 8 + g;
        tf32::mma(yacc[j], a, tf32::b_frag(sC[c0 * L::ldC + col], sC[c1 * L::ldC + col]));
      }
    }
    if (jh == 0) {  // q . n_in, f32 FMA
      const int t = mt * 16 + (lane & 15), dh = (lane >> 4) * (kDK / 2);
#pragma unroll 4
      for (int d = dh; d < dh + kDK / 2; ++d) qn = fmaf(sQ[t * L::ldQ + d], st[L::No + d], qn);
    }
    __syncthreads();  // every read of this stage is done
  }

  // m_t, a_t per row (8 rows a warp), and q . n_in
  {
    const float* sCumf = smem + L::Cumf;
    const float* sI = smem + L::I;
    for (int t = warp; t < kQ; t += kWarps) {
      const float ct = sCumf[t] + m_in;
      float bmax = -INFINITY;
      for (int s = lane; s <= t; s += 32) bmax = fmaxf(bmax, sCumf[t] - sCumf[s] + sI[s]);
      const float m = fmaxf(fmaxf(warp_max(bmax), ct), NEG);
      if (lane == 0) {
        smem[L::Mt + t] = m;
        smem[L::At + t] = expf(ct - m);
      }
    }
    if (jh == 0) {
      qn += __shfl_xor_sync(0xffffffffu, qn, 16);
      if (lane < 16) smem[L::Qn + mt * 16 + lane] = qn;
    }
  }
  __syncthreads();

  // w o q k^T into shared memory, with its row sums
  const float* sCumf = smem + L::Cumf;
  const float* sI = smem + L::I;
  float* sW = smem + L::W;
  {
    const float m0 = smem[L::Mt + t0], m1 = smem[L::Mt + t1];
    const float cf0 = sCumf[t0], cf1 = sCumf[t1];
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int s = jh * 32 + j * 8 + 2 * q;
      float w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = i < 2 ? t0 : t1, ss = s + (i & 1);
        const float cf = i < 2 ? cf0 : cf1, m = i < 2 ? m0 : m1;
        w[i] = ss <= t ? expf(cf - sCumf[ss] + sI[ss] - m) * sacc[j][i] : 0.f;
      }
      rs0 += w[0] + w[1];
      rs1 += w[2] + w[3];
      *reinterpret_cast<float2*>(&sW[t0 * L::ldW + s]) = make_float2(w[0], w[1]);
      *reinterpret_cast<float2*>(&sW[t1 * L::ldW + s]) = make_float2(w[2], w[3]);
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      rs0 += __shfl_xor_sync(0xffffffffu, rs0, o);
      rs1 += __shfl_xor_sync(0xffffffffu, rs1, o);
    }
    if (q == 0) {
      smem[L::Rs + jh * kQ + t0] = rs0;
      smem[L::Rs + jh * kQ + t1] = rs1;
    }
  }
  __syncthreads();

  // h = ((w o q k^T) v + a_t (q C)) / max(|q.n_t|, exp(-m_t))
  {
    const float* sV = smem + L::V;
    const float a0 = smem[L::At + t0], a1 = smem[L::At + t1];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      yacc[j][0] *= a0;
      yacc[j][1] *= a0;
      yacc[j][2] *= a1;
      yacc[j][3] *= a1;
    }
    for (int ks = 0; ks < 2 * mt + 2; ++ks) {  // keys on or below the diagonal
      const int s0 = ks * 8 + q, s1 = s0 + 4;
      const tf32::AFrag a = tf32::a_frag(sW[t0 * L::ldW + s0], sW[t1 * L::ldW + s0],
                                         sW[t0 * L::ldW + s1], sW[t1 * L::ldW + s1]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = jh * 32 + j * 8 + g;
        tf32::mma(yacc[j], a, tf32::b_frag(sV[s0 * L::ldV + col], sV[s1 * L::ldV + col]));
      }
    }
    float den[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int t = half ? t1 : t0;
      const float qnt = smem[L::Rs + t] + smem[L::Rs + kQ + t] + smem[L::At + t] * smem[L::Qn + t];
      den[half] = fmaxf(fabsf(qnt), expf(-smem[L::Mt + t]));
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = jh * 32 + j * 8 + 2 * q;
      if (col >= jv) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int t = half ? t1 : t0;
        if (t >= rows) continue;
        float* dst = p.y + base + (long long)t * row + j0 + col;
        const float v0 = yacc[j][2 * half] / den[half], v1 = yacc[j][2 * half + 1] / den[half];
        if (p.vec) {
          *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
        } else {
          dst[0] = v0;
          if (col + 1 < jv) dst[1] = v1;
        }
      }
    }
  }
}

}  // namespace

// floats of scratch mlstm_fwd needs
extern "C" long long mlstm_fwd_scratch(int B, int S, int H, int D) {
  const long long nT = (S + kQ - 1) / kQ;
  return (long long)B * H * nT * ((long long)D * D + D + 4);
}

// q, k, v, y: (B, S, H, D) f32, contiguous, q pre-scaled; ig, lf: (B, S, H)
// f32 (input gate, log forget gate); scratch: mlstm_fwd_scratch floats.
// 0 < D <= 256, 0 < chunk <= 256, S % chunk == 0.
extern "C" int mlstm_fwd(const void* q, const void* k, const void* v, const void* ig,
                         const void* lf, void* y, void* scratch, int B, int S, int H, int D,
                         int chunk, int vec, void* stream) {
  if (chunk <= 0 || chunk > kMaxChunk || D <= 0 || D > kMaxD || S % chunk != 0)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nT = (S + kQ - 1) / kQ, BH = B * H, nS = (D + kDV - 1) / kDV;
  Params p;
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.ig = static_cast<const float*>(ig);
  p.lf = static_cast<const float*>(lf);
  p.y = static_cast<float*>(y);
  p.dC = static_cast<float*>(scratch);
  p.dn = p.dC + (long long)BH * nT * D * D;
  p.sc = p.dn + (long long)BH * nT * D;
  p.B = B;
  p.S = S;
  p.H = H;
  p.D = D;
  p.vec = vec;
  cudaError_t err;
  if (kFuseState) {
    const int smem = (kStages * (2 * kQ * 72 + 2 * kQ) + kWarps * kQ) * (int)sizeof(float);
    err = cudaFuncSetAttribute(mlstm_state_walk_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    mlstm_state_walk_kernel<<<dim3(nS, nS, BH), kThreads, smem, st>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (!kFuseState && nT > 1) {
    const int smem = (kQ * ld_k(D) + kQ * (kDV + 8) + 5 * kQ) * (int)sizeof(float);
    err = cudaFuncSetAttribute(mlstm_state_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    mlstm_state_kernel<<<dim3(nS, nT - 1, BH), kThreads, smem, st>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (!kFuseState) {
    const long long entries = (long long)D * D + D;
    mlstm_combine_kernel<<<dim3((unsigned)((entries + 255) / 256), BH), 256, 0, st>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  const int smem = OutLayout::total * (int)sizeof(float);
  err = cudaFuncSetAttribute(mlstm_out_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  mlstm_out_kernel<<<dim3(nS, nT, BH), kThreads, smem, st>>>(p);
  return cudaGetLastError();
}
