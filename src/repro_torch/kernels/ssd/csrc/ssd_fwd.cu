// Mamba2 SSD chunk scan for Hopper (sm_90a), written by hand.
//
// Replaces the TPU kernel `_ssd_kernel` of src/repro/kernels/ssd/ssd.py:29-65,
// reached there through `ssd_fwd` (:68-99).  It computes the same function:
// per (batch, head) the chunks are walked in order and a (P, N) f32 state is
// carried from one to the next; per chunk of Q rows
//
//   cum    = cumsum(dt * A)                              (Q,)
//   M      = (C B^T) o L,  L[t][s] = exp(cum_t - cum_s) for s <= t, else 0
//   y      = M (x dt) + exp(cum_t) (C state^T)           (Q, P)
//   state' = state exp(cum_end) + ((x dt) o exp(cum_end - cum_s))^T B
//
// with B and C (B, S, N) shared by every head, A (H,) negative, a zero
// initial state, and y in f32.  The TPU grid (B, H, nc) runs the chunk axis
// in order and keeps the state in VMEM between grid steps; blocks here run in
// no order, so one block per (head, batch) walks its chunks in a loop and
// keeps the state in shared memory instead.
//
// What bounds it on the H100.  At zamba2-7b (H = 112, P = N = 64, chunk 64)
// for 4 x 1024 tokens the products are 1.13e10 FLOP (C B^T counted once per
// (batch, chunk), as every head shares it), 0.169 ms at the f32 SIMT peak of
// 67 TFLOP/s, against 239 MB of f32 inputs and output,
// 0.071 ms at 3.35 TB/s: the operations bound it.  The model's path is f32
// (the reference casts x, B and C to f32 before the scan), and TF32 tensor
// cores would lose that accuracy, so the products are f32 FMA.  The design is
// the simple one: 256 threads, each owning a 4 x 4 tile of every 64 x 64
// product (rows ty + 16 r, columns tx + 16 c), operands read from shared
// memory rows padded to 65 floats so that row and column reads are both free
// of bank conflicts; x dt, B, C, M and the state take 5 x 16.6 KB, so two
// blocks fit an SM.  Not yet: tensor cores, splitting P across blocks, or a
// parallel pass over chunk states (the scan over chunks is serial here).
//
// Sizes: chunk, P and N are runtime values up to 64 (tiles are zero-filled
// past them); S is a multiple of chunk (the model pads).  Inputs are
// contiguous: x and y (B, S, H, P), dt (B, S, H), B and C (B, S, N).
//
// C interface (bound with ctypes): pointers, ints and the stream; returns the
// cudaError_t of the launch.

#include <cuda_runtime.h>

namespace {

constexpr int T = 64;         // the largest chunk, P and N
constexpr int LD = T + 1;     // padded row length of every tile
constexpr int kThreads = 256;

struct Params {
  const float* x;
  const float* dt;
  const float* Bm;
  const float* Cm;
  const float* A;
  float* y;
  int B, S, H, P, N, chunk;
};

__global__ void __launch_bounds__(kThreads, 2) ssd_fwd_kernel(const Params p) {
  extern __shared__ float smem[];
  float* sX = smem;            // (s, p): x, then x * dt
  float* sB = sX + T * LD;     // (s, n)
  float* sC = sB + T * LD;     // (t, n)
  float* sM = sC + T * LD;     // (t, s): (C B^T) o L
  float* sS = sM + T * LD;     // (p, n): the carried state
  float* sDt = sS + T * LD;    // (s,)
  float* sCum = sDt + T;       // (s,) inclusive cumsum of dt * A
  float* sW = sCum + T;        // (s,) exp(cum_end - cum_s), 0 past the chunk

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int warp = tid / 32, lane = tid % 32;
  const int P = p.P, N = p.N, Q = p.chunk, H = p.H;
  const float A = p.A[h];
  const long long xrow = (long long)H * P;  // x / y stride between positions
  const float* xg = p.x + (long long)b * p.S * xrow + (long long)h * P;
  float* yg = p.y + (long long)b * p.S * xrow + (long long)h * P;
  const float* dtg = p.dt + (long long)b * p.S * H + h;
  const float* Bg = p.Bm + (long long)b * p.S * N;
  const float* Cg = p.Cm + (long long)b * p.S * N;

  for (int i = tid; i < T * LD; i += kThreads) sS[i] = 0.f;

  const int nc = p.S / Q;
  for (int ic = 0; ic < nc; ++ic) {
    const int s0 = ic * Q;

    // (1) this chunk's x, B and C, zero past Q rows and P / N columns; warp 0
    //     scans dt * A and the decay of each row to the chunk's end
    for (int i = tid; i < T * T; i += kThreads) {
      const int r = i / T, col = i % T;
      const bool row = r < Q;
      const long long s = s0 + r;
      sX[r * LD + col] = (row && col < P) ? xg[s * xrow + col] : 0.f;
      sB[r * LD + col] = (row && col < N) ? Bg[s * N + col] : 0.f;
      sC[r * LD + col] = (row && col < N) ? Cg[s * N + col] : 0.f;
    }
    if (warp == 0) {
      const float d0 = lane < Q ? dtg[(long long)(s0 + lane) * H] : 0.f;
      const float d1 = lane + 32 < Q ? dtg[(long long)(s0 + lane + 32) * H] : 0.f;
      float c0 = d0 * A, c1 = d1 * A;
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
      const float end = __shfl_sync(0xffffffffu, Q - 1 < 32 ? c0 : c1, (Q - 1) % 32);
      sDt[lane] = d0;
      sDt[lane + 32] = d1;
      sCum[lane] = c0;
      sCum[lane + 32] = c1;
      sW[lane] = lane < Q ? expf(end - c0) : 0.f;
      sW[lane + 32] = lane + 32 < Q ? expf(end - c1) : 0.f;
    }
    __syncthreads();

    // (2) M = (C B^T) o L; x <- x * dt (no thread reads x in this step)
    {
      float acc[4][4] = {};
#pragma unroll 4
      for (int k = 0; k < N; ++k) {
        float a[4], bv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) a[r] = sC[(ty + 16 * r) * LD + k];
#pragma unroll
        for (int c = 0; c < 4; ++c) bv[c] = sB[(tx + 16 * c) * LD + k];
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
          sM[t * LD + s] = (s <= t && t < Q) ? acc[r][c] * expf(sCum[t] - sCum[s]) : 0.f;
        }
      }
      for (int i = tid; i < Q * T; i += kThreads) sX[(i / T) * LD + i % T] *= sDt[i / T];
    }
    __syncthreads();

    // (3) y = M (x dt) + exp(cum_t) (C state^T), written to device memory
    {
      float acc[4][4] = {}, inter[4][4] = {};
#pragma unroll 4
      for (int k = 0; k < Q; ++k) {
        float a[4], bv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) a[r] = sM[(ty + 16 * r) * LD + k];
#pragma unroll
        for (int c = 0; c < 4; ++c) bv[c] = sX[k * LD + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(a[r], bv[c], acc[r][c]);
      }
#pragma unroll 4
      for (int k = 0; k < N; ++k) {
        float a[4], bv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) a[r] = sC[(ty + 16 * r) * LD + k];
#pragma unroll
        for (int c = 0; c < 4; ++c) bv[c] = sS[(tx + 16 * c) * LD + k];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) inter[r][c] = fmaf(a[r], bv[c], inter[r][c]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int t = ty + 16 * r;
        if (t >= Q) continue;
        const float amp = expf(sCum[t]);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int col = tx + 16 * c;
          if (col < P) yg[(long long)(s0 + t) * xrow + col] = acc[r][c] + amp * inter[r][c];
        }
      }
    }
    if (ic == nc - 1) break;  // the final state is not an output
    __syncthreads();          // every read of the state is done

    // (4) state = state exp(cum_end) + ((x dt) o w)^T B
    {
      const float decay = expf(sCum[Q - 1]);
      float acc[4][4] = {};
#pragma unroll 4
      for (int k = 0; k < Q; ++k) {
        const float w = sW[k];
        float a[4], bv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) a[r] = sX[k * LD + ty + 16 * r] * w;
#pragma unroll
        for (int c = 0; c < 4; ++c) bv[c] = sB[k * LD + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(a[r], bv[c], acc[r][c]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float* s = &sS[(ty + 16 * r) * LD + tx + 16 * c];
          *s = *s * decay + acc[r][c];
        }
    }
    __syncthreads();  // the next chunk overwrites x and B
  }
}

}  // namespace

// x, y: (B, S, H, P); dt: (B, S, H); Bm, Cm: (B, S, N); A: (H,); all f32 and
// contiguous.  0 < chunk <= 64, P <= 64, N <= 64, S % chunk == 0.
extern "C" int ssd_fwd(const void* x, const void* dt, const void* Bm, const void* Cm,
                       const void* A, void* y, int B, int S, int H, int P, int N, int chunk,
                       void* stream) {
  if (chunk <= 0 || chunk > T || P <= 0 || P > T || N <= 0 || N > T || S % chunk != 0)
    return cudaErrorInvalidValue;
  Params p;
  p.x = static_cast<const float*>(x);
  p.dt = static_cast<const float*>(dt);
  p.Bm = static_cast<const float*>(Bm);
  p.Cm = static_cast<const float*>(Cm);
  p.A = static_cast<const float*>(A);
  p.y = static_cast<float*>(y);
  p.B = B;
  p.S = S;
  p.H = H;
  p.P = P;
  p.N = N;
  p.chunk = chunk;
  const int smem = (5 * T * LD + 3 * T) * (int)sizeof(float);
  cudaError_t err =
      cudaFuncSetAttribute(ssd_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  ssd_fwd_kernel<<<dim3(H, B), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return cudaGetLastError();
}
