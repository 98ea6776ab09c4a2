// AdamW for Hopper (sm_90a), written by hand: the port's optimizer step
// (`repro_torch/train/optimizer.py` `apply`) as three multi-tensor kernels.
//
// It replaces no TPU kernel: the reference leaves the update to XLA, which
// fuses it (src/repro/train/optimizer.py).  In eager PyTorch the same
// update is some seventeen elementwise ops a chunk of a leaf, each a pass
// over device memory, and the clip norm four more: ~150 bytes of traffic a
// parameter.  Three kernels instead:
//
//   adamw_sum_sq_kernel     each block walks its tiles of the gradients,
//                           squares and sums each element in f64 (one sum a
//                           slot of the unrolled loop, added in a fixed
//                           order), reduces in the block, and writes one
//                           partial a block;
//   adamw_norm_finalize_kernel
//                           one block sums the partials in a fixed order
//                           and writes the sum in f32 (for a mesh step,
//                           which all-reduces it first) or its f32 square
//                           root: the same bits in every run, no float
//                           atomics;
//   adamw_update_kernel     reads the norm from device memory, computes the
//                           clip scale itself (no host sync, no scalar
//                           launches), and updates each element of p, mu and
//                           nu in place: g, p, mu, nu read once, p, mu, nu
//                           written once.
//
// The arithmetic is the plain version's (optimizer.py `_update_plain`), op
// for op, in f32, with the intrinsics that round each op as PyTorch's
// kernels do and let nvcc contract nothing else: scale = (1 / max(norm,
// 1e-12)) * clip, at most 1 (Tensor.__rtruediv__ is a reciprocal and a
// product); g * scale; mu * b1 + (1 - b1) g and nu * b2 + (1 - b2) g^2 (an
// add with alpha is one fma); sqrt(nu / b2c) + eps; (mu / b1c) / denom;
// + wd p where the leaf has ndim >= 2 (an fma); p - delta * lr; the param
// cast back with round-to-nearest-even.  IEEE division and sqrt throughout
// (no --use_fast_math, __fdividef or rsqrtf).
//
// The tensor table.  The launcher takes host arrays (pointers and numels of
// p, g, mu and nu a leaf, a decay flag a leaf) and copies them into a
// `__grid_constant__` kernel parameter, so a launch needs no copy to the
// device and no sync.  kMaxLeaves leaves fit the 4 KB of parameters; the
// wrapper splits a longer table across launches.  Each leaf is cut into
// tiles of kTile elements; a tile never straddles two leaves, and a leaf's
// last tile is ragged (element by element).  A block finds its tile's leaf
// by a binary search over the leaves' first tiles (uniform in the block).
//
// What bounds them on the H100.  Bytes: with bf16 params and f32 moments a
// parameter moves 2 (norm) + 2 + 2 + 2 + 8 + 8 bytes with bf16 gradients,
// 4 + 4 + 2 + 2 + 8 + 8 with f32 ones; 72.5 / 84.6 GB at the benchmark's
// 3.02 B parameters, 21.7 / 25.3 ms at 3.35 TB/s.  One f64 fma a gradient
// element in the norm is ~0.2 ms of the card's f64 rate.  So the design is
// about streaming: a persistent grid of kBlocksPerSm blocks an SM walks the
// tiles; a thread loads kUnroll slots of kVec elements of each array before
// it computes (~100 KB in flight an SM), as vectors (16 bytes for f32, 8
// for bf16: a warp's instruction covers one contiguous span), with
// streaming hints (ld/st .cs: each byte passes once through the 50 MB L2).
// A leaf whose pointers are not all 16-byte aligned runs element by element.
//
// C interface (bound with ctypes): dtype codes (0 bf16, 1 f32), host arrays,
// floats, the grid and the stream; each function returns the cudaError_t of
// its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;
constexpr int kUnroll = 4;
constexpr int kTile = kThreads * kVec * kUnroll;
constexpr int kBlocksPerSm = 2;
constexpr int kMaxLeaves = 64;

struct Leaf {
  void* p;
  const void* g;
  float* mu;
  float* nu;
  long long n;      // elements
  long long tile0;  // the leaf's first tile in the table
};

struct Table {
  Leaf leaf[kMaxLeaves];
  unsigned long long decay;    // bit l: leaf l is decayed (ndim >= 2)
  unsigned long long aligned;  // bit l: leaf l's pointers are 16-byte aligned
  long long tiles;
  int n_leaves;
};

struct Hyper {
  float clip, lr, b1, b2, omb1, omb2, b1c, b2c, eps, wd;
};

__device__ __forceinline__ int leaf_of(const Table& t, long long tile) {
  int lo = 0, hi = t.n_leaves - 1;  // the last leaf whose first tile is <= tile
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.leaf[mid].tile0 <= tile) lo = mid; else hi = mid - 1;
  }
  return lo;
}

__device__ __forceinline__ float bf16_bits_to_float(unsigned int bits) {
  return __uint_as_float(bits << 16);
}

__device__ __forceinline__ unsigned int float_to_bf16_bits(float x) {
  return static_cast<unsigned int>(__bfloat16_as_ushort(__float2bfloat16_rn(x)));
}

// kVec elements at an aligned address, streamed
__device__ __forceinline__ void load_vec(const float* ptr, float (&x)[kVec]) {
  const float4 v = __ldcs(reinterpret_cast<const float4*>(ptr));
  x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
}

__device__ __forceinline__ void load_vec(const __nv_bfloat16* ptr, float (&x)[kVec]) {
  const uint2 v = __ldcs(reinterpret_cast<const uint2*>(ptr));
  x[0] = bf16_bits_to_float(v.x & 0xffffu); x[1] = bf16_bits_to_float(v.x >> 16);
  x[2] = bf16_bits_to_float(v.y & 0xffffu); x[3] = bf16_bits_to_float(v.y >> 16);
}

__device__ __forceinline__ void store_vec(float* ptr, const float (&x)[kVec]) {
  __stcs(reinterpret_cast<float4*>(ptr), make_float4(x[0], x[1], x[2], x[3]));
}

__device__ __forceinline__ void store_vec(__nv_bfloat16* ptr, const float (&x)[kVec]) {
  uint2 v;
  v.x = float_to_bf16_bits(x[0]) | (float_to_bf16_bits(x[1]) << 16);
  v.y = float_to_bf16_bits(x[2]) | (float_to_bf16_bits(x[3]) << 16);
  __stcs(reinterpret_cast<uint2*>(ptr), v);
}

__device__ __forceinline__ float load_one(const float* ptr) { return *ptr; }
__device__ __forceinline__ float load_one(const __nv_bfloat16* ptr) {
  return __bfloat162float(*ptr);
}
__device__ __forceinline__ void store_one(float* ptr, float x) { *ptr = x; }
__device__ __forceinline__ void store_one(__nv_bfloat16* ptr, float x) {
  *ptr = __float2bfloat16_rn(x);
}

// the block's sum, in a fixed order (valid in thread 0)
__device__ __forceinline__ double block_sum(double x) {
  __shared__ double warp_sums[kThreads / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    x = lane < kThreads / 32 ? warp_sums[lane] : 0.0;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
  }
  return x;
}

template <typename G>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    adamw_sum_sq_kernel(const __grid_constant__ Table t, double* partials) {
  double acc[kUnroll] = {};
  for (long long tile = blockIdx.x; tile < t.tiles; tile += gridDim.x) {
    const int l = leaf_of(t, tile);
    const Leaf& L = t.leaf[l];
    const G* g = static_cast<const G*>(L.g);
    const long long base = (tile - L.tile0) * kTile;
    if ((t.aligned >> l & 1ull) && base + kTile <= L.n) {
      float x[kUnroll][kVec];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        load_vec(g + base + (u * kThreads + threadIdx.x) * kVec, x[u]);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          const double v = static_cast<double>(x[u][j]);
          acc[u] = __fma_rn(v, v, acc[u]);
        }
    } else {
      const long long end = base + kTile < L.n ? base + kTile : L.n;
      for (long long i = base + threadIdx.x; i < end; i += kThreads) {
        const double v = static_cast<double>(load_one(g + i));
        acc[0] = __fma_rn(v, v, acc[0]);
      }
    }
  }
  double sum = 0.0;
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) sum += acc[u];
  sum = block_sum(sum);
  if (threadIdx.x == 0) partials[blockIdx.x] = sum;
}

__global__ void __launch_bounds__(kThreads)
    adamw_norm_finalize_kernel(const double* partials, int count, float* out, int root) {
  double sum = 0.0;
  for (int i = threadIdx.x; i < count; i += kThreads) sum += partials[i];
  sum = block_sum(sum);
  // the root of the f32 sum, as torch.sqrt takes it of the sum a mesh step
  // all-reduces: a world of one gives the one-card step's norm bit for bit
  if (threadIdx.x == 0) {
    const float total = static_cast<float>(sum);
    out[0] = root ? __fsqrt_rn(total) : total;
  }
}

// one element of the update, as the plain version computes it
__device__ __forceinline__ void adamw_element(float& p, float g, float& mu, float& nu,
                                              float scale, bool decay, const Hyper& h) {
  g = __fmul_rn(g, scale);
  mu = __fmaf_rn(h.omb1, g, __fmul_rn(mu, h.b1));
  nu = __fmaf_rn(h.omb2, __fmul_rn(g, g), __fmul_rn(nu, h.b2));
  const float denom = __fadd_rn(__fsqrt_rn(__fdiv_rn(nu, h.b2c)), h.eps);
  float delta = __fdiv_rn(__fdiv_rn(mu, h.b1c), denom);
  if (decay) delta = __fmaf_rn(h.wd, p, delta);
  p = __fsub_rn(p, __fmul_rn(delta, h.lr));
}

template <typename P, typename G>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    adamw_update_kernel(const __grid_constant__ Table t, const float* norm, const Hyper h) {
  // clamp(clip / clamp(norm, min=1e-12), max=1), NaN kept as torch.clamp keeps it
  const float n = norm[0];
  const float clamped = n < 1e-12f ? 1e-12f : n;
  float scale = __fmul_rn(__frcp_rn(clamped), h.clip);
  scale = scale > 1.0f ? 1.0f : scale;
  for (long long tile = blockIdx.x; tile < t.tiles; tile += gridDim.x) {
    const int l = leaf_of(t, tile);
    const Leaf& L = t.leaf[l];
    P* p = static_cast<P*>(L.p);
    const G* g = static_cast<const G*>(L.g);
    const bool decay = t.decay >> l & 1ull;
    const long long base = (tile - L.tile0) * kTile;
    if ((t.aligned >> l & 1ull) && base + kTile <= L.n) {
      float pv[kUnroll][kVec], gv[kUnroll][kVec], mv[kUnroll][kVec], nv[kUnroll][kVec];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long i = base + (u * kThreads + threadIdx.x) * kVec;
        load_vec(g + i, gv[u]);
        load_vec(p + i, pv[u]);
        load_vec(L.mu + i, mv[u]);
        load_vec(L.nu + i, nv[u]);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int j = 0; j < kVec; ++j)
          adamw_element(pv[u][j], gv[u][j], mv[u][j], nv[u][j], scale, decay, h);
        const long long i = base + (u * kThreads + threadIdx.x) * kVec;
        store_vec(p + i, pv[u]);
        store_vec(L.mu + i, mv[u]);
        store_vec(L.nu + i, nv[u]);
      }
    } else {
      const long long end = base + kTile < L.n ? base + kTile : L.n;
      for (long long i = base + threadIdx.x; i < end; i += kThreads) {
        float pe = load_one(p + i), me = L.mu[i], ne = L.nu[i];
        adamw_element(pe, load_one(g + i), me, ne, scale, decay, h);
        store_one(p + i, pe);
        L.mu[i] = me;
        L.nu[i] = ne;
      }
    }
  }
}

bool aligned16(long long ptr) { return (static_cast<unsigned long long>(ptr) & 15ull) == 0; }

// the table of n leaves; false where it does not fit or a numel is negative
bool make_table(Table& t, int n, const long long* p, const long long* g, const long long* mu,
                const long long* nu, const long long* numel, const int* decay) {
  if (n < 1 || n > kMaxLeaves) return false;
  t = Table{};
  t.n_leaves = n;
  long long tiles = 0;
  for (int l = 0; l < n; ++l) {
    if (numel[l] < 0) return false;
    Leaf& L = t.leaf[l];
    L.p = p ? reinterpret_cast<void*>(p[l]) : nullptr;
    L.g = reinterpret_cast<const void*>(g[l]);
    L.mu = mu ? reinterpret_cast<float*>(mu[l]) : nullptr;
    L.nu = nu ? reinterpret_cast<float*>(nu[l]) : nullptr;
    L.n = numel[l];
    L.tile0 = tiles;
    tiles += (numel[l] + kTile - 1) / kTile;
    if (decay && decay[l]) t.decay |= 1ull << l;
    const bool ok = aligned16(g[l]) && (!p || aligned16(p[l])) && (!mu || aligned16(mu[l])) &&
                    (!nu || aligned16(nu[l]));
    if (ok) t.aligned |= 1ull << l;
  }
  t.tiles = tiles;
  return true;
}

}  // namespace

// partials[0, grid) <- each block's sum of the squares of the n gradients
// (dtype g_dtype); every block writes its partial, even with no tile.
extern "C" int adamw_sum_sq(int g_dtype, int n, const long long* g, const long long* numel,
                            void* partials, int grid, void* stream) {
  Table t;
  if (grid < 1 || !make_table(t, n, nullptr, g, nullptr, nullptr, numel, nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* out = static_cast<double*>(partials);
  if (g_dtype == 0)
    adamw_sum_sq_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(t, out);
  else if (g_dtype == 1)
    adamw_sum_sq_kernel<float><<<grid, kThreads, 0, s>>>(t, out);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// out[0] <- the sum of partials[0, count) in f32, or its square root (root)
extern "C" int adamw_norm_finalize(const void* partials, int count, void* out, int root,
                                   void* stream) {
  if (count < 1) return static_cast<int>(cudaErrorInvalidValue);
  adamw_norm_finalize_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(partials), count, static_cast<float*>(out), root);
  return static_cast<int>(cudaGetLastError());
}

// p, mu, nu of n leaves updated in place from g, clipped by the f32 norm at
// `norm` (device memory); params of p_dtype, gradients of g_dtype, f32
// moments.
extern "C" int adamw_update(int p_dtype, int g_dtype, int n, const long long* p,
                            const long long* g, const long long* mu, const long long* nu,
                            const long long* numel, const int* decay, const void* norm,
                            float clip, float lr, float b1, float b2, float omb1, float omb2,
                            float b1c, float b2c, float eps, float wd, int grid, void* stream) {
  Table t;
  if (grid < 1 || !make_table(t, n, p, g, mu, nu, numel, decay))
    return static_cast<int>(cudaErrorInvalidValue);
  const Hyper h{clip, lr, b1, b2, omb1, omb2, b1c, b2c, eps, wd};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* nrm = static_cast<const float*>(norm);
  if (p_dtype == 0 && g_dtype == 0)
    adamw_update_kernel<__nv_bfloat16, __nv_bfloat16><<<grid, kThreads, 0, s>>>(t, nrm, h);
  else if (p_dtype == 0 && g_dtype == 1)
    adamw_update_kernel<__nv_bfloat16, float><<<grid, kThreads, 0, s>>>(t, nrm, h);
  else if (p_dtype == 1 && g_dtype == 0)
    adamw_update_kernel<float, __nv_bfloat16><<<grid, kThreads, 0, s>>>(t, nrm, h);
  else if (p_dtype == 1 && g_dtype == 1)
    adamw_update_kernel<float, float><<<grid, kThreads, 0, s>>>(t, nrm, h);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
