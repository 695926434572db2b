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
// plus the output written once, over the 3.35 TB/s of HBM (x rows that
// several slots share are read again, mostly from the 50 MB L2).
//
// Design.  One warp per slot row, 8 rows per block of 256 threads; each lane
// moves 16 bytes at a time (4 float32 or 8 bf16 values), so a warp reads and
// writes 512 contiguous bytes of the row per step and loads and stores
// coalesce.  The gate is rounded to x's type first, as the plain version
// casts it; a product of two bf16 values is exact in float32, so the bf16
// result rounded to nearest equals the plain version's bit for bit, and the
// float32 result is one IEEE multiply, as there.  An index outside 0..t-1
// sets the error word (the wrapper raises) and writes a zero row instead of
// reading out of bounds.  d must be a multiple of 8 (16 bytes of bf16), so
// every row of x and out starts 16-byte aligned.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
dispatch_rows(const T* __restrict__ x, const int32_t* __restrict__ idx,
              const float* __restrict__ gates, T* __restrict__ out,
              int32_t slots, int32_t t, int32_t row_vecs,
              int32_t* __restrict__ err) {
  const int64_t s =
      static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + threadIdx.x / 32;
  if (s >= slots) return;
  const int lane = threadIdx.x % 32;
  const int32_t id = idx[s];
  uint4* dst = reinterpret_cast<uint4*>(out) + s * row_vecs;
  if (id < 0 || id >= t) {
    if (lane == 0) atomicOr(err, 1);
    for (int c = lane; c < row_vecs; c += 32) dst[c] = make_uint4(0, 0, 0, 0);
    return;
  }
  const float g = round_gate(gates[s], T{});
  const uint4* src =
      reinterpret_cast<const uint4*>(x) + static_cast<int64_t>(id) * row_vecs;
  for (int c = lane; c < row_vecs; c += 32) dst[c] = scale(src[c], g, T{});
}

template <typename T>
void launch(const void* x, const void* idx, const void* gates, void* out,
            int slots, int t, int d, void* err, cudaStream_t s) {
  const int row_vecs = d * static_cast<int>(sizeof(T)) / 16;
  const int blocks = (slots + kRowsPerBlock - 1) / kRowsPerBlock;
  dispatch_rows<T><<<blocks, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const int32_t*>(idx),
      static_cast<const float*>(gates), static_cast<T*>(out), slots, t,
      row_vecs, static_cast<int32_t*>(err));
}

}  // namespace

// x: [t, d] of dtype 0 = float32 or 1 = bfloat16, d a multiple of 8, base
// 16-byte aligned; idx: int32[slots]; gates: float32[slots]; out: [slots, d]
// of x's type; err: int32[1], zeroed by the caller.  Returns
// cudaGetLastError().
extern "C" int moe_dispatch_launch(const void* x, const void* idx,
                                   const void* gates, void* out, int slots,
                                   int t, int d, int dtype, void* err,
                                   int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (d % 8 || slots <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    launch<float>(x, idx, gates, out, slots, t, d, err, s);
  else if (dtype == 1)
    launch<__nv_bfloat16>(x, idx, gates, out, slots, t, d, err, s);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}
