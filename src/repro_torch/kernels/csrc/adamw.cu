// The LM training step's optimizer tail for Hopper (sm_90a), hand-written
// CUDA C++, in two passes over every leaf of the step:
//
//   norm    = sqrt(sum over leaves and elements of (g * inv)^2)
//   factor  = min(1, max_norm / (norm + 1e-9))
//   g'      = (g * inv) * factor                       (inv = 1 / divisor)
//   m       = m b1 + (1 - b1) g'
//   v       = v b2 + ((1 - b2) g') g'
//   w       = w - ((m / b1t) / (sqrt(v / b2t) + eps) + wd w) lr
//
// where g is a leaf's gradient summed over `divisor` microbatches, w its
// float32 master (or the parameter itself) and p, where a master exists,
// the parameter re-cast from it.  The first pass is the clip's global norm
// of the averaged gradients (`norm_launch`), the second AdamW with the
// division and the clip folded into its read of g (`update_launch`).
//
// No TPU kernel of src/repro/kernels/ is replaced: the JAX package leaves
// AdamW and the clip to XLA (src/repro/optim/optimizers.py::adamw and
// ::clip_by_global_norm), which fuses each leaf's update into one loop.
// The port ran them as PyTorch's per-leaf passes, about 16 a leaf for
// AdamW, 3 for the clip and 1 for the division, several of them writing a
// full-leaf temporary.  Plain twin: repro_torch.optim.optimizers (the
// per-leaf code that CPU leaves take).
//
// What bounds it on an H100: bytes.  A few float32 operations an element;
// the least is one read of g for the norm (4 B an element) and one pass
// that reads g, m, v and w and writes m, v and w (28 B; 30 with a bf16
// parameter beside a master), over the 3.35 TB/s of HBM: 27.1 ms at
// DeepSeek-V2-Lite's 5 layers (2,839,831,040 elements), where the PyTorch
// passes moved about 184 B an element.
//
// Design.  Both kernels walk a table of the step's leaves (pointers, size,
// first chunk, flags) that the wrapper builds on the host and copies to
// the device on the stream, so one launch covers every leaf whatever its
// size, from a 2,048-element norm to a 2 GB stacked expert leaf.  Each leaf
// is cut into chunks of kChunk elements, numbered across the step; a block
// takes chunks blockIdx.x, + gridDim.x, ... (one wave of resident blocks),
// finds a chunk's leaf by binary search over the table, and reads it with
// 16-byte loads (8 for four bf16 values) where every pointer of the leaf is
// so aligned, one element at a time where not, the chunk's ragged tail
// masked.  Loads and stores stream (ld.global.cs / st.global.cs): nothing
// is read twice within a pass.
//   - The norm writes one float32 partial a chunk (each thread's sum, then
//     a fixed xor butterfly within a warp and across the block's warps); a
//     second launch of one block adds the partials in a fixed order and
//     writes the norm and the factor to the device.  No atomics: the bits
//     repeat from run to run and do not depend on the grid.
//   - The update reads the factor, b1t and b2t from device memory (nothing
//     waits on the host) and computes every element with the rounded
//     intrinsics (__fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn), so nothing
//     is contracted into an FMA and each operation rounds where PyTorch's
//     per-leaf passes round on this card: the constants are float32 as
//     PyTorch rounds a Python number, the division by the microbatches a
//     multiply by the float32 reciprocal as PyTorch's CUDA `div_` by a
//     Python number computes it, `max_norm / x` as reciprocal-then-multiply
//     as `Tensor.__rtruediv__` does.  Given the same factor the update is
//     the plain path's bit for bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr int kFinishThreads = 1024;
// elements a block takes at a time; the wrapper's CHUNK
constexpr int64_t kChunk = 16384;

// a leaf's flags; the wrapper's _BF16, _MASTER, _ALIGNED
constexpr int64_t kParamBf16 = 1;   // p is bfloat16, else float32
constexpr int64_t kMaster = 2;      // a float32 master beside p
constexpr int64_t kAligned = 4;     // every pointer on a 4-element boundary

// One row of the wrapper's table (eight int64).  The norm reads g, n,
// chunk0 and kAligned alone.
struct Leaf {
  const float* g;
  float* m;
  float* v;
  void* p;
  float* master;
  int64_t n;
  int64_t chunk0;   // the leaf's first chunk in the step's numbering
  int64_t flags;
};
static_assert(sizeof(Leaf) == 64, "the wrapper writes eight int64 a leaf");

// Rounded as PyTorch's passes round; the wrapper passes each constant as a
// float32 rounded from the Python number.
struct Hyper {
  float lr, b1, c1, b2, c2, eps, wd, inv;   // c1 = 1 - b1, c2 = 1 - b2
};

// The leaf holding chunk c: the last whose chunk0 <= c (the table holds no
// empty leaf, and its chunk0 rise).
__device__ __forceinline__ int find_leaf(const Leaf* __restrict__ leaves,
                                         int n_leaves, int64_t c) {
  int lo = 0, hi = n_leaves - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (leaves[mid].chunk0 <= c) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

// Each step adds the same two values on both lanes, and IEEE addition
// commutes, so every lane ends with the same bits.
__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, off));
  return s;
}

// The block's sum in a fixed order; valid in warp 0.  red: kN / 32 floats.
template <int kN>
__device__ __forceinline__ float block_sum(float s, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  s = warp_sum(s);
  if (lane == 0) red[warp] = s;
  __syncthreads();
  float t = 0.0f;
  if (warp == 0) t = warp_sum(lane < kN / 32 ? red[lane] : 0.0f);
  __syncthreads();   // red is reused by the next chunk
  return t;
}

__device__ __forceinline__ float sq_add(float acc, float g, float inv) {
  const float x = __fmul_rn(g, inv);
  return __fmaf_rn(x, x, acc);
}

// One float32 partial a chunk: the sum of the squares of its gradients
// over the divisor.
__global__ void __launch_bounds__(kThreads)
sq_partials(const Leaf* __restrict__ leaves, int n_leaves, int64_t n_chunks,
            float inv, float* __restrict__ partials) {
  __shared__ float red[kThreads / 32];
  for (int64_t c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    const Leaf leaf = leaves[find_leaf(leaves, n_leaves, c)];
    const int64_t lo = (c - leaf.chunk0) * kChunk;
    const int len =
        static_cast<int>(leaf.n - lo < kChunk ? leaf.n - lo : kChunk);
    const float* __restrict__ g = leaf.g + lo;
    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
    int done = 0;
    if (leaf.flags & kAligned) {
      const int nvec = len >> 2;
      const float4* __restrict__ g4 = reinterpret_cast<const float4*>(g);
#pragma unroll 4
      for (int i = threadIdx.x; i < nvec; i += kThreads) {
        const float4 x = __ldcs(g4 + i);
        a0 = sq_add(a0, x.x, inv);
        a1 = sq_add(a1, x.y, inv);
        a2 = sq_add(a2, x.z, inv);
        a3 = sq_add(a3, x.w, inv);
      }
      done = nvec << 2;
    }
    for (int i = done + threadIdx.x; i < len; i += kThreads)
      a0 = sq_add(a0, __ldcs(g + i), inv);
    const float s = block_sum<kThreads>(
        __fadd_rn(__fadd_rn(a0, a1), __fadd_rn(a2, a3)), red);
    if (threadIdx.x == 0) partials[c] = s;
  }
}

// out[0] = the norm, out[1] = the clip's factor, from the partials added in
// a fixed order by one block.
__global__ void __launch_bounds__(kFinishThreads)
finish_norm(const float* __restrict__ partials, int64_t n, float max_norm,
            float* __restrict__ out) {
  __shared__ float red[kFinishThreads / 32];
  float s = 0.0f;
  for (int64_t i = threadIdx.x; i < n; i += kFinishThreads)
    s = __fadd_rn(s, partials[i]);
  s = block_sum<kFinishThreads>(s, red);
  if (threadIdx.x == 0) {
    const float norm = __fsqrt_rn(s);
    // torch.clamp(max_norm / (norm + 1e-9), max=1.0): the reciprocal of
    // norm + 1e-9, times max_norm; a NaN stays NaN, as clamp keeps it
    const float r =
        __fdiv_rn(1.0f, __fadd_rn(norm, static_cast<float>(1e-9)));
    const float f = __fmul_rn(r, max_norm);
    out[0] = norm;
    out[1] = f > 1.0f ? 1.0f : f;
  }
}

// One element of AdamW, in the plain path's order and roundings; returns
// the new w and updates m and v.
__device__ __forceinline__ float adam(float g, float& m, float& v, float w,
                                      float f, const Hyper& h, float b1t,
                                      float b2t) {
  g = __fmul_rn(__fmul_rn(g, h.inv), f);
  m = __fadd_rn(__fmul_rn(m, h.b1), __fmul_rn(h.c1, g));
  v = __fadd_rn(__fmul_rn(v, h.b2), __fmul_rn(__fmul_rn(h.c2, g), g));
  const float step = __fdiv_rn(
      __fdiv_rn(m, b1t), __fadd_rn(__fsqrt_rn(__fdiv_rn(v, b2t)), h.eps));
  return __fsub_rn(w, __fmul_rn(__fadd_rn(step, __fmul_rn(h.wd, w)), h.lr));
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ void load4(const float* p, float x[4]) {
  const float4 t = __ldcs(reinterpret_cast<const float4*>(p));
  x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float x[4]) {
  const uint2 raw = __ldcs(reinterpret_cast<const uint2*>(p));
  __nv_bfloat16 h[4];
  memcpy(h, &raw, sizeof(raw));
#pragma unroll
  for (int i = 0; i < 4; ++i) x[i] = __bfloat162float(h[i]);
}
__device__ __forceinline__ void store4(float* p, const float x[4]) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(x[0], x[1], x[2], x[3]));
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float x[4]) {
  __nv_bfloat16 h[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __float2bfloat16_rn(x[i]);
  uint2 raw;
  memcpy(&raw, h, sizeof(raw));
  __stcs(reinterpret_cast<uint2*>(p), raw);
}

// Elements lo .. lo + len - 1 of one leaf.  W is what w is read from and
// written to (the master, or the parameter where there is none); with a
// master, p (of type P) is written too.
template <typename W, typename P, bool kHasMaster>
__device__ __forceinline__ void update_chunk(const Leaf& leaf, int64_t lo,
                                             int len, float f,
                                             const Hyper& h, float b1t,
                                             float b2t) {
  const float* __restrict__ g = leaf.g + lo;
  float* __restrict__ m = leaf.m + lo;
  float* __restrict__ v = leaf.v + lo;
  W* __restrict__ w = static_cast<W*>(
      kHasMaster ? static_cast<void*>(leaf.master) : leaf.p) + lo;
  P* __restrict__ p = static_cast<P*>(leaf.p) + lo;
  int done = 0;
  if (leaf.flags & kAligned) {
    const int nvec = len >> 2;
#pragma unroll 2
    for (int i = threadIdx.x; i < nvec; i += kThreads) {
      const int e = i << 2;
      float gx[4], mx[4], vx[4], wx[4];
      load4(g + e, gx);
      load4(m + e, mx);
      load4(v + e, vx);
      load4(w + e, wx);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        wx[k] = adam(gx[k], mx[k], vx[k], wx[k], f, h, b1t, b2t);
      store4(m + e, mx);
      store4(v + e, vx);
      store4(w + e, wx);
      if (kHasMaster) store4(p + e, wx);
    }
    done = nvec << 2;
  }
  for (int e = done + threadIdx.x; e < len; e += kThreads) {
    float mm = m[e], vv = v[e];
    const float nw = adam(g[e], mm, vv, to_float(w[e]), f, h, b1t, b2t);
    m[e] = mm;
    v[e] = vv;
    w[e] = from_float<W>(nw);
    if (kHasMaster) p[e] = from_float<P>(nw);
  }
}

__global__ void __launch_bounds__(kThreads)
adamw_chunks(const Leaf* __restrict__ leaves, int n_leaves, int64_t n_chunks,
             const float* __restrict__ b1t_p, const float* __restrict__ b2t_p,
             const float* __restrict__ factor, Hyper h) {
  const float b1t = *b1t_p, b2t = *b2t_p;
  const float f = factor ? *factor : 1.0f;
  for (int64_t c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    const Leaf leaf = leaves[find_leaf(leaves, n_leaves, c)];
    const int64_t lo = (c - leaf.chunk0) * kChunk;
    const int len =
        static_cast<int>(leaf.n - lo < kChunk ? leaf.n - lo : kChunk);
    switch (leaf.flags & (kParamBf16 | kMaster)) {
      case 0:
        update_chunk<float, float, false>(leaf, lo, len, f, h, b1t, b2t);
        break;
      case kParamBf16:
        update_chunk<__nv_bfloat16, __nv_bfloat16, false>(leaf, lo, len, f,
                                                          h, b1t, b2t);
        break;
      case kMaster:
        update_chunk<float, float, true>(leaf, lo, len, f, h, b1t, b2t);
        break;
      default:
        update_chunk<float, __nv_bfloat16, true>(leaf, lo, len, f, h, b1t,
                                                 b2t);
    }
  }
}

// One wave of resident blocks of `kernel` on `device`, at most `chunks`.
template <typename K>
cudaError_t wave(K kernel, int device, int64_t chunks, int* grid) {
  int sms = 0, per_sm = 0;
  cudaError_t e =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, 0);
  if (e != cudaSuccess) return e;
  const int64_t resident =
      static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  *grid = static_cast<int>(chunks < resident ? chunks : resident);
  return cudaSuccess;
}

cudaError_t on_device(int device) {
  int current;
  cudaError_t e = cudaGetDevice(&current);
  if (e == cudaSuccess && current != device) e = cudaSetDevice(device);
  return e;
}

}  // namespace

// leaves: the device table of n_leaves rows (none empty, chunk0 rising,
// n_chunks in all); partials: float32[n_chunks]; out: float32[2], the norm
// and the factor.  With no chunk the norm is 0.  Returns cudaGetLastError()
// after the launches.
extern "C" int norm_launch(const void* leaves, int n_leaves,
                           long long n_chunks, float inv, float max_norm,
                           void* partials, void* out, int device,
                           void* stream) {
  if (n_chunks < 0 || (n_chunks > 0 && n_leaves <= 0))
    return cudaErrorInvalidValue;
  cudaError_t e = on_device(device);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_chunks > 0) {
    int grid;
    e = wave(sq_partials, device, n_chunks, &grid);
    if (e != cudaSuccess) return e;
    sq_partials<<<grid, kThreads, 0, s>>>(static_cast<const Leaf*>(leaves),
                                          n_leaves, n_chunks, inv,
                                          static_cast<float*>(partials));
  }
  finish_norm<<<1, kFinishThreads, 0, s>>>(
      static_cast<const float*>(partials), n_chunks, max_norm,
      static_cast<float*>(out));
  return cudaGetLastError();
}

// leaves: as norm_launch's, every field set; b1t, b2t: float32 scalars on
// the device; factor: a float32 scalar on the device, or null for 1.
extern "C" int update_launch(const void* leaves, int n_leaves,
                             long long n_chunks, const void* b1t,
                             const void* b2t, const void* factor, float lr,
                             float b1, float c1, float b2, float c2,
                             float eps, float wd, float inv, int device,
                             void* stream) {
  if (n_chunks <= 0 || n_leaves <= 0) return cudaErrorInvalidValue;
  cudaError_t e = on_device(device);
  if (e != cudaSuccess) return e;
  int grid;
  e = wave(adamw_chunks, device, n_chunks, &grid);
  if (e != cudaSuccess) return e;
  const Hyper h{lr, b1, c1, b2, c2, eps, wd, inv};
  adamw_chunks<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Leaf*>(leaves), n_leaves, n_chunks,
      static_cast<const float*>(b1t), static_cast<const float*>(b2t),
      static_cast<const float*>(factor), h);
  return cudaGetLastError();
}
