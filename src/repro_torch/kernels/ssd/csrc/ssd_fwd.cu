// Mamba2 SSD chunk scan for Hopper (sm_90a), written by hand.
//
// Replaces the TPU kernel `_ssd_kernel` of src/repro/kernels/ssd/ssd.py:29-65,
// reached there through `ssd_fwd` (:68-99).  It computes the same function:
// per (batch, head) a (P, N) f32 state is carried over the sequence, and per
// tile of Q rows
//
//   cum    = cumsum(dt * A)                              (Q,)
//   M      = G o L,  G = C B^T,  L[t][s] = exp(cum_t - cum_s) for s <= t, else 0
//   y      = M (x dt) + exp(cum_t) (C state^T)           (Q, P)
//   state' = state exp(cum_end) + ((x dt) o exp(cum_end - cum_s))^T B
//
// with B and C (B, S, N) shared by every head, A (H,) negative, a zero
// initial state, and y in f32.  The scan's output does not depend on where
// the rows are cut into tiles (only the rounding does), so the kernel walks
// tiles of its own kQ = 32 rows whatever the caller's chunk (up to 256).
//
// What bounds it on the H100.  At zamba2-7b (H = 112, P = N = 64) for
// 4 x 1024 tokens the products are 1.13e10 FLOP counted at chunk 64 (C B^T
// once per (batch, chunk), as every head shares it), against 239 MB of f32
// inputs and output: 0.071 ms at 3.35 TB/s, 0.069 ms at the 3xTF32 rate of
// 495 / 3 = 165 TFLOP/s, 0.169 ms at the f32 SIMT peak of 67 TFLOP/s.  The
// model's path is f32 (the reference casts x, B and C to f32); one TF32 pass
// loses that accuracy (~1e-3 of max |y|), three keep it (see
// common/tf32_mma.cuh), so every product runs on the tensor cores in 3xTF32
// (mma.sync m16n8k8, fragments loaded by hand); the cumsum, the
// exponentials and the decays stay in f32.  What bounds this kernel is the
// issue rate: a tile's mma.sync are a tenth of its instructions, the rest
// being the operand splits, exponentials and addresses.
//
// Design.  Two kernels per call:
//   ssd_prep_kernel  per (tile, batch): G = C B^T, and C and B split into
//                    (hi, lo) pairs, into a scratch buffer the wrapper
//                    allocates (4.7 MB at zamba2-7b, read back from L2): the
//                    heads share all three, so each is formed once.
//   ssd_scan_kernel  one block of 4 warps per (64 columns of P, head, batch):
//                    448 blocks at zamba2-7b, each warp owning 16 columns of
//                    P.  A warp keeps its rows of the state (16, N) in
//                    registers as accumulator fragments and computes y^T
//                    (16, kQ) a tile, so that the state enters C S^T as an A
//                    fragment straight from its accumulators (its k columns
//                    in the order 2q, 2q + 1, C's pairs read to match): no
//                    copy of the state goes through shared memory.  C and B
//                    come through a 2-stage cp.async ring (the next tile's in
//                    flight while this one computes, one block barrier a
//                    tile); x, G and dt come straight into registers in
//                    fragment layout, loaded a tile ahead.  M = G o L is
//                    formed in the fragments of M^T (each warp its own, on or
//                    below the diagonal only); x dt and x dt exp(end - cum)
//                    likewise.  Each warp scans dt * A itself, in log2 units,
//                    so every exponential is one exp2.
// Shared memory rows of pairs are padded so the fragment loads are free of
// bank conflicts: 72 KB a block at N <= 64 (the 240 registers a thread allow
// two blocks an SM), 136 KB at N <= 128.
//
// Sizes: P and N up to 128 (N <= 64 and N <= 128 are two instantiations),
// chunk up to 256 with S a multiple of it (the model pads), tiles of kQ rows
// zero-filled past S.  Inputs are contiguous: x and y (B, S, H, P), dt
// (B, S, H), B and C (B, S, N); vec = B's and C's rows are 16-byte aligned (N
// a multiple of 4, aligned bases), so their loads go in 16-byte pieces.
//
// The constants below switch the design's parts for chip_profile.py
// scan_ablate (kGPre, kStages, kWarps; TF32_PASSES and TF32_RNA_SPLIT in
// common/tf32_mma.cuh).
//
// C interface (bound with ctypes): pointers, ints and the stream; returns the
// cudaError_t of the launches.  ssd_fwd_scratch gives the scratch's size.

#include <cuda_runtime.h>

#include "tf32_mma.cuh"

namespace {

constexpr int kQ = 32;               // rows per tile
constexpr int kWarps = 4;            // each warp owns 16 columns of P
constexpr int kThreads = 32 * kWarps;
constexpr int kPB = 16 * kWarps;     // P columns per block
constexpr int kStages = 2;           // the ring of C and B tiles
constexpr bool kGPre = true;         // G = C B^T in the pre-pass, once per (batch, tile)
constexpr int kMaxP = 128, kMaxN = 128, kMaxChunk = 256;
static_assert(kQ == 32, "the scan gives each lane one row of a tile");

struct Params {
  const float* x;
  const float* dt;
  const float* Bm;
  const float* Cm;
  const float* A;
  float* y;
  float* G;    // (B, nT, kQ, kQ) f32
  float2* C2;  // (B, nT kQ, NN) (hi, lo) pairs, zero past S and N
  float2* B2;  // the same for B
  int B, S, H, P, N, vec;
};

template <int NN>
struct Ld {
  static constexpr int C = NN + 8;  // C [t][n] pairs, read two at once as (row g, column 2q)
  static constexpr int B = NN + 4;  // B [s][n] pairs, read as (row q, column g)
  static constexpr int stage = kQ * (C + B);          // pairs
  static constexpr int G = kQ + 4;                    // G [t][s] f32 (no pre-pass)
  static constexpr int total_floats = 2 * kStages * stage + (kGPre ? 0 : kQ * G) +
                                      kWarps * 4 * kQ;
};

// out (kQ x kQ, row stride ldo) = C B^T over N columns, C [t][n] and B [s][n]
// f32 in shared memory with rows of 4 mod 32 floats.  Each warp takes m16n8
// tiles.
__device__ __forceinline__ void cb_tiles(const float* sC, int ldc, const float* sB, int ldb,
                                         float* out, int ldo, int N) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, q = lane & 3;
  constexpr int kMt = kQ / 16, kNt = kQ / 8;
  for (int tile = warp; tile < kMt * kNt; tile += kWarps) {
    const int t0 = (tile / kNt) * 16 + g, s = (tile % kNt) * 8 + g;
    float acc[4] = {};
    for (int k0 = 0; k0 < N; k0 += 8) {  // uniform over the warp: mma.sync needs all lanes
      const int n0 = k0 + q, n1 = n0 + 4;
      const tf32::AFrag a = tf32::a_frag(sC[t0 * ldc + n0], sC[(t0 + 8) * ldc + n0],
                                         sC[t0 * ldc + n1], sC[(t0 + 8) * ldc + n1]);
      tf32::mma(acc, a, tf32::b_frag(sB[s * ldb + n0], sB[s * ldb + n1]));
    }
    const int col = (tile % kNt) * 8 + 2 * q;
    out[t0 * ldo + col] = acc[0];
    out[t0 * ldo + col + 1] = acc[1];
    out[(t0 + 8) * ldo + col] = acc[2];
    out[(t0 + 8) * ldo + col + 1] = acc[3];
  }
}

// the pre-pass, per (tile, batch): G = C B^T, and C and B split into pairs
template <int NN>
__global__ void __launch_bounds__(kThreads) ssd_prep_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  constexpr int ld = NN + 4;
  float* sC = smem;
  float* sB = smem + kQ * ld;
  const int c = blockIdx.x, b = blockIdx.y, N = p.N;
  const int nT = (p.S + kQ - 1) / kQ, r0 = c * kQ, rows = min(kQ, p.S - r0);
  const long long off = ((long long)b * p.S + r0) * N;
  tf32::load_tile<kThreads>(sC, ld, p.Cm + off, N, kQ, NN, rows, N, p.vec);
  tf32::load_tile<kThreads>(sB, ld, p.Bm + off, N, kQ, NN, rows, N, p.vec);
  tf32::commit();
  tf32::wait<0>();
  __syncthreads();
  const long long tile = (long long)b * nT + c;
  if (kGPre) cb_tiles(sC, ld, sB, ld, p.G + tile * kQ * kQ, kQ, N);
  for (int i = threadIdx.x; i < kQ * NN; i += kThreads) {
    const int r = i / NN, n = i % NN;
    const tf32::Split cs = tf32::split(sC[r * ld + n]), bs = tf32::split(sB[r * ld + n]);
    p.C2[tile * kQ * NN + i] = make_float2(__uint_as_float(cs.hi), __uint_as_float(cs.lo));
    p.B2[tile * kQ * NN + i] = make_float2(__uint_as_float(bs.hi), __uint_as_float(bs.lo));
  }
}

// the scan, per (slice of kPB columns of P, head, batch): warp w owns the
// columns p0 + 16 w .. p0 + 16 w + 15, its rows of the state (16, N) in
// registers and its rows of y^T (16, kQ) a tile
template <int NN>
__global__ void __launch_bounds__(kThreads) ssd_scan_kernel(const Params p) {
  using L = Ld<NN>;
  extern __shared__ __align__(16) float smem[];
  float2* ring = reinterpret_cast<float2*>(smem);
  float* sG = smem + 2 * kStages * L::stage;
  float* sc = sG + (kGPre ? 0 : kQ * L::G);
  const int p0 = blockIdx.x * kPB, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, q = lane & 3;
  const int P = p.P, N = p.N, H = p.H, S = p.S;
  const int nT = (S + kQ - 1) / kQ;
  const int pw = p0 + 16 * warp;  // this warp's first column of P
  const float A2 = p.A[h] * 1.4426950408889634f;  // A log2(e): exponentials as exp2
  const long long xrow = (long long)H * P;  // x / y stride between positions
  const float* xg = p.x + (long long)b * S * xrow + (long long)h * P;
  float* yg = p.y + (long long)b * S * xrow + (long long)h * P;
  const float* dtg = p.dt + (long long)b * S * H + h;
  const float2* C2g = p.C2 + (long long)b * nT * kQ * NN;
  const float2* B2g = p.B2 + (long long)b * nT * kQ * NN;
  const float* Gg = p.G + (long long)b * nT * kQ * kQ;
  sc += warp * 4 * kQ;  // this warp's row scalars: cum (log2 units), exp(cum), dt, exp(end - cum)

  auto load_ring = [&](int c) {  // tile c's C and B pairs into its stage
    float2* st = ring + (c % kStages) * L::stage;
    const long long off = (long long)c * kQ * NN;
    for (int i = threadIdx.x; i < kQ * NN / 2; i += kThreads) {  // 16 bytes: two pairs
      const int r = (2 * i) / NN, n = (2 * i) % NN;
      tf32::cp16(st + r * L::C + n, C2g + off + 2 * i, 16);
      tf32::cp16(st + kQ * L::C + r * L::B + n, B2g + off + 2 * i, 16);
    }
    tf32::commit();
  };

  // registers of a tile: x in the A-fragment layout of (P x s) products
  // (k step ks: x(8 ks + q (+4), pw + g (+8))), G in the B-fragment layout
  // of M^T (n tile nt, k step ks <= nt: G(8 nt + g, 8 ks + q (+4))), dt of
  // row `lane`
  constexpr int kKs = kQ / 8, kPairs = kKs * (kKs + 1) / 2;
  float xr[kKs][4], gr[kPairs][2], dtr;
  auto load_regs = [&](int c, float (&x)[kKs][4], float (&gm)[kPairs][2], float& d) {
    const int r0 = c * kQ, rows = min(kQ, S - r0);
#pragma unroll
    for (int ks = 0; ks < kKs; ++ks)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int s = 8 * ks + q + 4 * (i >> 1), col = pw + g + 8 * (i & 1);
        x[ks][i] = s < rows && col < P ? xg[(long long)(r0 + s) * xrow + col] : 0.f;
      }
    if (kGPre) {
      const float* gt = Gg + (long long)c * kQ * kQ;
      int k = 0;
#pragma unroll
      for (int nt = 0; nt < kKs; ++nt)
#pragma unroll
        for (int ks = 0; ks <= nt; ++ks, ++k) {
          gm[k][0] = gt[(8 * nt + g) * kQ + 8 * ks + q];
          gm[k][1] = gt[(8 * nt + g) * kQ + 8 * ks + q + 4];
        }
    }
    d = lane < rows ? dtg[(long long)(r0 + lane) * H] : 0.f;
  };

  float st[NN / 8][4] = {};  // this warp's rows of the state: (16, NN), k step j = n tile j
  load_ring(0);
  load_regs(0, xr, gr, dtr);
  for (int c = 0; c < nT; ++c) {
    if (kStages == 1 && c > 0) load_ring(c);
    tf32::wait<0>();
    __syncthreads();  // tile c's C and B have landed; tile c - 1's are no longer read
    if (kStages == 2 && c + 1 < nT) load_ring(c + 1);
    const float2* sC = ring + (c % kStages) * L::stage;
    const float2* sB = sC + kQ * L::C;
    float xn[kKs][4], gn[kPairs][2], dn;  // tile c + 1, in flight while tile c computes
    if (c + 1 < nT) load_regs(c + 1, xn, gn, dn);

    // the scan of dt * A log2(e) over the tile's rows (zero past S)
    float end;
    {
      float v = dtr * A2;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, v, o);
        if (lane >= o) v += u;
      }
      end = __shfl_sync(0xffffffffu, v, 31);
      sc[lane] = v;
      sc[kQ + lane] = exp2f(v);
      sc[2 * kQ + lane] = dtr;
      sc[3 * kQ + lane] = exp2f(end - v);
      __syncwarp();
    }
    if (!kGPre) {  // G = C B^T from the ring's pairs, into shared memory
      constexpr int kNt = kQ / 8;
      for (int tile = warp; tile < (kQ / 16) * kNt; tile += kWarps) {
        const int t0 = (tile / kNt) * 16 + g, s = (tile % kNt) * 8 + g;
        float acc[4] = {};
        for (int k0 = 0; k0 < N; k0 += 8) {
          const int n0 = k0 + q, n1 = n0 + 4;
          tf32::mma(acc,
                    tf32::a_frag2(&sC[t0 * L::C + n0], &sC[(t0 + 8) * L::C + n0],
                                  &sC[t0 * L::C + n1], &sC[(t0 + 8) * L::C + n1]),
                    tf32::b_frag2(&sB[s * L::B + n0], &sB[s * L::B + n1]));
        }
        const int col = (tile % kNt) * 8 + 2 * q;
#pragma unroll
        for (int i = 0; i < 4; ++i) sG[(t0 + 8 * (i >> 1)) * L::G + col + (i & 1)] = acc[i];
      }
      __syncthreads();
      int k = 0;
#pragma unroll
      for (int nt = 0; nt < kKs; ++nt)
#pragma unroll
        for (int ks = 0; ks <= nt; ++ks, ++k) {
          gr[k][0] = sG[(8 * nt + g) * L::G + 8 * ks + q];
          gr[k][1] = sG[(8 * nt + g) * L::G + 8 * ks + q + 4];
        }
    }

    // y^T = (x dt)^T M^T + (S C^T) o exp(cum_t), M = G o L
    float yacc[kKs][4] = {}, inter[kKs][4] = {};
#pragma unroll
    for (int ks = 0; ks < kKs; ++ks) {
      const int s0 = 8 * ks + q, s1 = s0 + 4;
      const float d0 = sc[2 * kQ + s0], d1 = sc[2 * kQ + s1], c0 = sc[s0], c1 = sc[s1];
      const tf32::AFrag a = tf32::a_frag(xr[ks][0] * d0, xr[ks][1] * d0, xr[ks][2] * d1,
                                         xr[ks][3] * d1);  // (x dt)^T
#pragma unroll
      for (int nt = ks; nt < kKs; ++nt) {  // t >= s only
        const int t = 8 * nt + g, k = nt * (nt + 1) / 2 + ks;
        const float ct = sc[t];
        const float m0 = s0 <= t ? gr[k][0] * exp2f(ct - c0) : 0.f;
        const float m1 = s1 <= t ? gr[k][1] * exp2f(ct - c1) : 0.f;
        tf32::mma(yacc[nt], a, tf32::b_frag(m0, m1));
      }
    }
    if (c > 0) {  // the state is zero before the first tile
#pragma unroll
      for (int j = 0; j < NN / 8; ++j) {  // past N the operands are zero
        // the state's accumulator fragment is an A fragment with its k
        // columns in the order 2q, 2q + 1 (C's pairs are read in that order)
        const tf32::AFrag a = tf32::a_frag(st[j][0], st[j][2], st[j][1],
                                           st[j][3]);
#pragma unroll
        for (int nt = 0; nt < kKs; ++nt) {
          const float4 v =
              *reinterpret_cast<const float4*>(&sC[(8 * nt + g) * L::C + 8 * j + 2 * q]);
          const tf32::BFrag bb = {{{__float_as_uint(v.x), __float_as_uint(v.y)},
                                   {__float_as_uint(v.z), __float_as_uint(v.w)}}};
          tf32::mma(inter[nt], a, bb);
        }
      }
    }
    {  // y (t, p) from y^T's fragments: (p = g (+8), t = 8 nt + 2q (+1))
      const int r0 = c * kQ;
#pragma unroll
      for (int nt = 0; nt < kKs; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = 8 * nt + 2 * q + (i & 1), col = pw + g + 8 * (i >> 1);
          if (r0 + t < S && col < P)
            yg[(long long)(r0 + t) * xrow + col] =
                yacc[nt][i] + sc[kQ + t] * inter[nt][i];
        }
    }

    // state = state exp(cum_end) + (x dt exp(end - cum))^T B
    if (c + 1 < nT) {
      const float decay = exp2f(end);
#pragma unroll
      for (int j = 0; j < NN / 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) st[j][i] *= decay;
#pragma unroll
      for (int ks = 0; ks < kKs; ++ks) {
        const int s0 = 8 * ks + q, s1 = s0 + 4;
        const float w0 = sc[2 * kQ + s0] * sc[3 * kQ + s0], w1 = sc[2 * kQ + s1] * sc[3 * kQ + s1];
        const tf32::AFrag a = tf32::a_frag(xr[ks][0] * w0, xr[ks][1] * w0, xr[ks][2] * w1,
                                           xr[ks][3] * w1);
#pragma unroll
        for (int j = 0; j < NN / 8; ++j)
          tf32::mma(st[j], a, tf32::b_frag2(&sB[s0 * L::B + 8 * j + g], &sB[s1 * L::B + 8 * j + g]));
      }
#pragma unroll
      for (int ks = 0; ks < kKs; ++ks)
#pragma unroll
        for (int i = 0; i < 4; ++i) xr[ks][i] = xn[ks][i];
#pragma unroll
      for (int k = 0; k < kPairs; ++k) {
        gr[k][0] = gn[k][0];
        gr[k][1] = gn[k][1];
      }
      dtr = dn;
    }
    if (kStages == 1) __syncthreads();  // the next tile overwrites the one stage
  }
}

template <int NN>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const int nT = (p.S + kQ - 1) / kQ;
  const int prep_smem = 2 * kQ * (NN + 4) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_prep_kernel<NN>, cudaFuncAttributeMaxDynamicSharedMemorySize, prep_smem);
  if (err != cudaSuccess) return err;
  ssd_prep_kernel<NN><<<dim3(nT, p.B), kThreads, prep_smem, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int smem = Ld<NN>::total_floats * (int)sizeof(float);
  err = cudaFuncSetAttribute(ssd_scan_kernel<NN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  ssd_scan_kernel<NN><<<dim3((p.P + kPB - 1) / kPB, p.H, p.B), kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

int nn_of(int N) { return N <= 64 ? 64 : 128; }

}  // namespace

// floats of scratch ssd_fwd needs for B sequences of S positions and N
// columns of B and C: G, then C and B as (hi, lo) pairs
extern "C" long long ssd_fwd_scratch(int B, int S, int N) {
  const long long rows = (long long)B * ((S + kQ - 1) / kQ) * kQ;
  return rows * kQ + 4 * rows * nn_of(N);
}

// x, y: (B, S, H, P); dt: (B, S, H); Bm, Cm: (B, S, N); A: (H,); all f32 and
// contiguous; scratch: ssd_fwd_scratch(B, S, N) floats, 16-byte aligned.
// 0 < chunk <= 256, S % chunk == 0, P and N up to 128.
extern "C" int ssd_fwd(const void* x, const void* dt, const void* Bm, const void* Cm,
                       const void* A, void* y, void* scratch, int B, int S, int H, int P, int N,
                       int chunk, int vec, void* stream) {
  if (chunk <= 0 || chunk > kMaxChunk || P <= 0 || P > kMaxP || N <= 0 || N > kMaxN ||
      S % chunk != 0)
    return cudaErrorInvalidValue;
  const long long rows = (long long)B * ((S + kQ - 1) / kQ) * kQ;
  Params p;
  p.x = static_cast<const float*>(x);
  p.dt = static_cast<const float*>(dt);
  p.Bm = static_cast<const float*>(Bm);
  p.Cm = static_cast<const float*>(Cm);
  p.A = static_cast<const float*>(A);
  p.y = static_cast<float*>(y);
  p.G = static_cast<float*>(scratch);
  p.C2 = reinterpret_cast<float2*>(p.G + rows * kQ);
  p.B2 = p.C2 + rows * nn_of(N);
  p.B = B;
  p.S = S;
  p.H = H;
  p.P = P;
  p.N = N;
  p.vec = vec;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return N <= 64 ? launch<64>(p, s) : launch<128>(p, s);
}
