// MoE dispatch, the join side of the token -> expert relation, for Hopper
// (sm_90a), hand-written CUDA C++:
//
//   out[s, :] = gate[s] * x[idx[s], :]      for every slot s
//
// The router's output is the paper's {[i, j, v]} relation (token i goes to
// expert j with gate v); dispatch joins it with the token rows on i and
// applies v in the select clause, filling the expert-sorted slot buffer that
// the per-expert products read.  The combine side (group by token, sum) is
// relational_matmul's aggregation.
//
// Replaces the Pallas TPU kernel src/repro/kernels/moe_dispatch.py::
// moe_dispatch (a scalar-prefetched gather, one slot row per grid step).
// Plain twin: repro_torch.kernels.ref.moe_dispatch (x[idx] * gate cast to
// x's type).
//
// What bounds it on an H100: bytes.  One multiply per element; it reads the
// index and gate of each slot and one row of x per slot, and writes one row
// per slot.  The least time is the slot indices, the gates and x read once
// plus the output written once, over the 3.35 TB/s of HBM.  At
// DeepSeek-V2-Lite's prefill (x 8000 x 2048 bf16 = 32.8 MB into 60,416
// slots = 247.5 MB) that is 0.0838 ms.
//
// Design.  One warp per slot row, 8 rows per block of 256 threads; each lane
// moves 16 bytes at a time (4 float32 or 8 bf16 values), so a warp reads and
// writes 512 contiguous bytes of the row per step and loads and stores
// coalesce.  Against the first design:
//   - x (32.8 MB) fits in the 50 MB L2 while the output streams through it
//     at five times that size.  x is read with an L2 evict-last policy
//     (createpolicy + ld.global.nc.L2::cache_hint) and the output written
//     with streaming stores (st.global.cs, evict-first), so the output
//     cannot push x out.  On an H100 80GB HBM3 (700 W) the hints time no
//     faster than plain loads and stores: x was served from L2 before.
//     What is left above the bound is writing the output itself (a zero
//     fill of the same bytes alone takes most of the bound) and gathering
//     the same bytes of x from L2 beside it.
//   - Each lane issues four independent loads before their four stores (a
//     remainder loop takes what is left), at d = 2048 bf16 its whole share
//     of the row in two steps; the first design had one in flight.
//   - The error word cost a memset launch and a device-to-host copy per
//     call.  The flag now lives in pinned mapped host memory and the
//     launcher waits for this kernel alone (status_flag.cuh): one launch a
//     call and still one host wait, as before.
// The gate is rounded to x's type first, as the plain version casts it; a
// product of two bf16 values is exact in float32, so the bf16 result
// rounded to nearest equals the plain version's bit for bit, and the
// float32 result is one IEEE multiply, as there.  An index outside 0..t-1
// raises the flag and writes a zero row instead of reading out of bounds.
// d must be a multiple of 8 (16 bytes of bf16), so every row of x and out
// starts 16-byte aligned.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "status_flag.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;
constexpr int kUnroll = 4;              // 16-byte loads in flight per lane
constexpr int kBadIndex = -1;           // moe_dispatch_launch's return

__device__ __forceinline__ uint4 scale(uint4 v, float g, float) {
  float4 f = *reinterpret_cast<float4*>(&v);
  f.x *= g;
  f.y *= g;
  f.z *= g;
  f.w *= g;
  return *reinterpret_cast<uint4*>(&f);
}

__device__ __forceinline__ uint4 scale(uint4 v, float g, __nv_bfloat16) {
  __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&v);
#pragma unroll
  for (int i = 0; i < 8; ++i)
    h[i] = __float2bfloat16_rn(__bfloat162float(h[i]) * g);
  return v;
}

__device__ __forceinline__ float round_gate(float g, float) { return g; }
__device__ __forceinline__ float round_gate(float g, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(g));
}

// An L2 policy that keeps what it loads past lines loaded without one.
__device__ __forceinline__ uint64_t evict_last() {
  uint64_t policy;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(policy));
  return policy;
}

__device__ __forceinline__ uint4 load_kept(const uint4* p, uint64_t policy) {
  uint4 v;
  asm("ld.global.nc.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, [%4], %5;"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p), "l"(policy));
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dispatch_rows(const T* __restrict__ x, const int32_t* __restrict__ idx,
              const float* __restrict__ gates, T* __restrict__ out,
              int32_t slots, int32_t t, int32_t row_vecs,
              volatile int32_t* bad) {
  const int64_t s =
      static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + threadIdx.x / 32;
  if (s >= slots) return;
  const int lane = threadIdx.x % 32;
  const int32_t id = __ldg(idx + s);
  uint4* dst = reinterpret_cast<uint4*>(out) + s * row_vecs;
  if (id < 0 || id >= t) {
    if (lane == 0) *bad = 1;
    for (int c = lane; c < row_vecs; c += 32)
      __stcs(dst + c, make_uint4(0, 0, 0, 0));
    return;
  }
  const float g = round_gate(__ldg(gates + s), T{});
  const uint4* src =
      reinterpret_cast<const uint4*>(x) + static_cast<int64_t>(id) * row_vecs;
  const uint64_t policy = evict_last();
  int c = lane;
  for (; c + 32 * (kUnroll - 1) < row_vecs; c += 32 * kUnroll) {
    uint4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      v[u] = load_kept(src + c + 32 * u, policy);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      __stcs(dst + c + 32 * u, scale(v[u], g, T{}));
  }
  for (; c < row_vecs; c += 32)
    __stcs(dst + c, scale(load_kept(src + c, policy), g, T{}));
}

template <typename T>
void launch(const void* x, const void* idx, const void* gates, void* out,
            int slots, int t, int d, int32_t* bad, cudaStream_t s) {
  const int row_vecs = d * static_cast<int>(sizeof(T)) / 16;
  const int blocks = (slots + kRowsPerBlock - 1) / kRowsPerBlock;
  dispatch_rows<T><<<blocks, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const int32_t*>(idx),
      static_cast<const float*>(gates), static_cast<T*>(out), slots, t,
      row_vecs, bad);
}

}  // namespace

// x: [t, d] of dtype 0 = float32 or 1 = bfloat16, d a multiple of 8, base
// 16-byte aligned; idx: int32[slots]; gates: float32[slots]; out: [slots, d]
// of x's type.  Launches the fill, waits for it, and returns 0, a CUDA
// error, or -1 when an index lay outside 0..t-1 (its row is zeros).
extern "C" int moe_dispatch_launch(const void* x, const void* idx,
                                   const void* gates, void* out, int slots,
                                   int t, int d, int dtype, int device,
                                   void* stream) {
  if (d % 8 || slots <= 0 || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  Status* st;
  cudaError_t e = open_status(device, &st);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> hold(st->lock);
  e = ready(*st);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    launch<float>(x, idx, gates, out, slots, t, d, st->dev, s);
  else
    launch<__nv_bfloat16>(x, idx, gates, out, slots, t, d, st->dev, s);
  int bad;
  e = take_flags(*st, s, &bad);
  if (e != cudaSuccess) return e;
  return bad ? kBadIndex : 0;
}
