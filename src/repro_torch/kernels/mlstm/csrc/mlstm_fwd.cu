// Chunkwise mLSTM forward for Hopper (sm_90a), written by hand.
//
// Replaces the TPU kernel `_mlstm_kernel` of src/repro/kernels/mlstm/mlstm.py:26-72,
// reached there through `mlstm_fwd` (:75-104).  It computes the same function,
// the stabilised chunkwise xLSTM matrix memory: per (batch, head) the chunks
// are walked in order carrying C (D, D), n (D,) and the stabiliser m (start
// -1e30); per chunk of Q rows, with cumf the inclusive cumsum of log f,
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
// with q pre-scaled by 1/sqrt(D).  The TPU grid (B, H, nc) keeps the state in
// VMEM between grid steps; here one block walks its chunks in a loop.  The one
// rewrite is q.n_t: the TPU kernel forms n_t = w k + a_t n (a Q x Q x D
// product) and dots it with q; the sum of the row of w o q k^T is the same
// number and reuses the product the output needs.  The -1e30 stabiliser is
// kept as the plain version has it: a padded row (i = -1e30, which the model
// appends up to a multiple of the chunk) gives b and e of -1e30 and so weights
// exp(-1e30 - m) = 0, and the first chunk's m_in = -1e30 gives a_t = 0 and a
// state scale of 0.
//
// What bounds it on the H100.  At xlstm-125m (H = 4, D = 192, chunk 64) for
// 4 x 1024 tokens the products are 3.22e9 FLOP, 0.048 ms at the f32 SIMT peak
// of 67 TFLOP/s, against 50.5 MB of f32 inputs and output, 0.015 ms at 3.35
// TB/s: the operations bound it.  The path is f32 (the reference casts q, k
// and v to f32), so the products are f32 FMA, not TF32 tensor cores.  The
// state C at D = 192 is 144 KB: with the q and k tiles (48 KB each) it does
// not fit one block.  So the value dimension is split: grid (D / 64, H, B),
// and each block keeps C[:, 64-column slice] (48 KB) and recomputes the
// shared parts of each chunk in full (cumf, m_t, a_t, q k^T, q.n_t, n).  Each
// block has 256 threads, each owning 4 x 4 of every 64 x 64 product, from
// shared-memory rows of odd length (free of bank conflicts for row and column
// reads); 184 KB of opt-in dynamic shared memory at D = 192.  At xlstm-125m
// that is 48 blocks for 132 SMs: the parallelism is low and the q k^T work is
// done three times.  Not yet: tensor cores, more blocks per (batch, head), a
// parallel pass over chunk states.
//
// Sizes: D up to 192, chunk up to 64 (tiles zero-filled past them); S a
// multiple of chunk.  Inputs are contiguous: q, k, v, y (B, S, H, D); the
// gates (B, S, H).
//
// C interface (bound with ctypes): pointers, ints and the stream; returns the
// cudaError_t of the launch.

#include <math.h>

#include <cuda_runtime.h>

namespace {

constexpr int T = 64;          // the largest chunk
constexpr int DV = 64;         // value columns per block
constexpr int LDV = DV + 1;    // padded row length of the 64-column tiles
constexpr int kMaxD = 192;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float NEG = -1e30f;

struct Params {
  const float* q;
  const float* k;
  const float* v;
  const float* ig;
  const float* lf;
  float* y;
  int B, S, H, D, chunk;
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// odd row length for the (row, D) tiles: free of bank conflicts
__host__ __device__ __forceinline__ int ld_of(int D) { return D | 1; }

__host__ __device__ __forceinline__ int smem_floats(int D) {
  return 2 * T * ld_of(D) + 2 * T * LDV + D * LDV + D + 6 * T + 2;
}

__global__ void __launch_bounds__(kThreads, 1) mlstm_fwd_kernel(const Params p) {
  const int D = p.D, Q = p.chunk, H = p.H, ldq = ld_of(D);
  extern __shared__ float smem[];
  float* sQ = smem;              // (t, d)
  float* sK = sQ + T * ldq;      // (s, d)
  float* sV = sK + T * ldq;      // (s, j): v of this slice, then amp_s * v
  float* sW = sV + T * LDV;      // (t, s): w o q k^T
  float* sC = sW + T * LDV;      // (d, j): the state's slice
  float* sN = sC + D * LDV;      // (d,): n, whole
  float* sCumf = sN + D;         // (s,)
  float* sIg = sCumf + T;        // (s,)
  float* sAmp = sIg + T;         // (s,) exp(e_s - m_out), 0 past the chunk
  float* sMt = sAmp + T;         // (t,) m_t
  float* sInter = sMt + T;       // (t,) a_t
  float* sDen = sInter + T;      // (t,) a_t (q . n), then the denominator
  float* sScal = sDen + T;       // m_out, state scale

  const int j0 = blockIdx.x * DV, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int warp = tid / 32, lane = tid % 32;
  const long long row = (long long)H * D;  // q / k / v / y stride between positions
  const long long base = (long long)b * p.S * row + (long long)h * D;
  const float* qg = p.q + base;
  const float* kg = p.k + base;
  const float* vg = p.v + base + j0;
  float* yg = p.y + base + j0;
  const float* igg = p.ig + (long long)b * p.S * H + h;
  const float* lfg = p.lf + (long long)b * p.S * H + h;

  for (int i = tid; i < D * LDV; i += kThreads) sC[i] = 0.f;
  for (int i = tid; i < D; i += kThreads) sN[i] = 0.f;
  float m_in = NEG;

  const int nc = p.S / Q;
  for (int ic = 0; ic < nc; ++ic) {
    const int s0 = ic * Q;

    // (1) q and k rows, this slice of v, the input gate; zero past Q rows
    for (int i = tid; i < T * D; i += kThreads) {
      const int r = i / D, d = i % D;
      const long long off = (long long)(s0 + r) * row + d;
      sQ[r * ldq + d] = r < Q ? qg[off] : 0.f;
      sK[r * ldq + d] = r < Q ? kg[off] : 0.f;
    }
    for (int i = tid; i < T * DV; i += kThreads) {
      const int r = i / DV, j = i % DV;
      sV[r * LDV + j] = (r < Q && j0 + j < D) ? vg[(long long)(s0 + r) * row + j] : 0.f;
    }
    if (tid < T) sIg[tid] = tid < Q ? igg[(long long)(s0 + tid) * H] : NEG;

    // (2) warp 0: cumf, and the state update's exponents
    if (warp == 0) {
      float c0 = lane < Q ? lfg[(long long)(s0 + lane) * H] : 0.f;
      float c1 = lane + 32 < Q ? lfg[(long long)(s0 + lane + 32) * H] : 0.f;
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
      const float fe = __shfl_sync(0xffffffffu, Q - 1 < 32 ? c0 : c1, (Q - 1) % 32);
      const float i0 = lane < Q ? igg[(long long)(s0 + lane) * H] : 0.f;
      const float i1 = lane + 32 < Q ? igg[(long long)(s0 + lane + 32) * H] : 0.f;
      const float e0 = lane < Q ? fe - c0 + i0 : -INFINITY;
      const float e1 = lane + 32 < Q ? fe - c1 + i1 : -INFINITY;
      const float m_out = fmaxf(m_in + fe, warp_max(fmaxf(e0, e1)));
      sCumf[lane] = c0;
      sCumf[lane + 32] = c1;
      sAmp[lane] = lane < Q ? expf(e0 - m_out) : 0.f;
      sAmp[lane + 32] = lane + 32 < Q ? expf(e1 - m_out) : 0.f;
      if (lane == 0) {
        sScal[0] = m_out;
        sScal[1] = expf(m_in + fe - m_out);
      }
    }
    __syncthreads();
    const float m_out = sScal[0], scale = sScal[1];

    // (3) per row t: m_t, a_t and a_t (q . n)
    for (int t = warp; t < Q; t += kWarps) {
      const float ct = sCumf[t] + m_in;
      float bmax = -INFINITY;
      for (int s = lane; s <= t; s += 32) bmax = fmaxf(bmax, sCumf[t] - sCumf[s] + sIg[s]);
      const float mt = fmaxf(fmaxf(warp_max(bmax), ct), NEG);
      float qn = 0.f;
      for (int d = lane; d < D; d += 32) qn = fmaf(sQ[t * ldq + d], sN[d], qn);
      qn = warp_sum(qn);
      if (lane == 0) {
        const float amp = expf(ct - mt);
        sMt[t] = mt;
        sInter[t] = amp;
        sDen[t] = amp * qn;
      }
    }
    __syncthreads();

    // (4) w o q k^T
    {
      float acc[4][4] = {};
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float a[4], bv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) a[r] = sQ[(ty + 16 * r) * ldq + d];
#pragma unroll
        for (int c = 0; c < 4; ++c) bv[c] = sK[(tx + 16 * c) * ldq + d];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(a[r], bv[c], acc[r][c]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int t = ty + 16 * r;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int s = tx + 16 * c;
          sW[t * LDV + s] = (s <= t && t < Q)
              ? expf(sCumf[t] - sCumf[s] + sIg[s] - sMt[t]) * acc[r][c] : 0.f;
        }
      }
    }
    __syncthreads();

    // (5) per row t: the denominator max(|q.n_t|, exp(-m_t))
    for (int t = warp; t < Q; t += kWarps) {
      float rs = 0.f;
      for (int s = lane; s < Q; s += 32) rs += sW[t * LDV + s];
      rs = warp_sum(rs);
      if (lane == 0) sDen[t] = fmaxf(fabsf(rs + sDen[t]), expf(-sMt[t]));
    }
    __syncthreads();

    // (6) h = ((w o q k^T) v + a_t (q C)) / den, written to device memory
    {
      float acc[4][4] = {}, inter[4][4] = {};
#pragma unroll 4
      for (int s = 0; s < Q; ++s) {
        float a[4], bv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) a[r] = sW[(ty + 16 * r) * LDV + s];
#pragma unroll
        for (int c = 0; c < 4; ++c) bv[c] = sV[s * LDV + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(a[r], bv[c], acc[r][c]);
      }
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float a[4], bv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) a[r] = sQ[(ty + 16 * r) * ldq + d];
#pragma unroll
        for (int c = 0; c < 4; ++c) bv[c] = sC[d * LDV + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) inter[r][c] = fmaf(a[r], bv[c], inter[r][c]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int t = ty + 16 * r;
        if (t >= Q) continue;
        const float amp = sInter[t], den = sDen[t];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = tx + 16 * c;
          if (j0 + j < D) yg[(long long)(s0 + t) * row + j] = (acc[r][c] + amp * inter[r][c]) / den;
        }
      }
    }
    if (ic == nc - 1) break;  // the final state is not an output
    __syncthreads();          // every read of v, C and n is done

    // (7) v <- amp_s v; n = n scale + sum_s amp_s k_s
    for (int i = tid; i < T * DV; i += kThreads) sV[(i / DV) * LDV + i % DV] *= sAmp[i / DV];
    for (int d = tid; d < D; d += kThreads) {
      float acc = 0.f;
      for (int s = 0; s < Q; ++s) acc = fmaf(sAmp[s], sK[s * ldq + d], acc);
      sN[d] = sN[d] * scale + acc;
    }
    __syncthreads();

    // (8) C = C scale + k^T (amp v), in 64-row blocks of the D rows
    for (int d0 = 0; d0 < D; d0 += 64) {
      float acc[4][4] = {};
#pragma unroll 4
      for (int s = 0; s < Q; ++s) {
        float a[4], bv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int d = d0 + ty + 16 * r;
          a[r] = d < D ? sK[s * ldq + d] : 0.f;
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) bv[c] = sV[s * LDV + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(a[r], bv[c], acc[r][c]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int d = d0 + ty + 16 * r;
        if (d >= D) continue;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float* cell = &sC[d * LDV + tx + 16 * c];
          *cell = *cell * scale + acc[r][c];
        }
      }
    }
    m_in = m_out;
    __syncthreads();  // the next chunk overwrites q, k, v and the row values
  }
}

}  // namespace

// q, k, v, y: (B, S, H, D) f32, contiguous, q pre-scaled; ig, lf: (B, S, H)
// f32 (input gate, log forget gate).  0 < D <= 192, 0 < chunk <= 64,
// S % chunk == 0.
extern "C" int mlstm_fwd(const void* q, const void* k, const void* v, const void* ig,
                         const void* lf, void* y, int B, int S, int H, int D, int chunk,
                         void* stream) {
  if (chunk <= 0 || chunk > T || D <= 0 || D > kMaxD || S % chunk != 0)
    return cudaErrorInvalidValue;
  Params p;
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.ig = static_cast<const float*>(ig);
  p.lf = static_cast<const float*>(lf);
  p.y = static_cast<float*>(y);
  p.B = B;
  p.S = S;
  p.H = H;
  p.D = D;
  p.chunk = chunk;
  const int smem = smem_floats(D) * (int)sizeof(float);
  cudaError_t err =
      cudaFuncSetAttribute(mlstm_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((D + DV - 1) / DV, H, B);
  mlstm_fwd_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return cudaGetLastError();
}
