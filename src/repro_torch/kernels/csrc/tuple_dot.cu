// One dot product a tuple of a relation (a sampled dense-dense product,
// SDDMM) for Hopper (sm_90a), hand-written CUDA C++:
//
//   out[t] = sum_j a[rows[t], j] * b[cols[t], j]      for every tuple t
//
// In the paper's Algorithm 1 the gradient of a join + group-by with respect
// to the relation's values is one such product a tuple: for
// relational_matmul (out = R . b over the tuples (i, j, v)) dv[t] =
// dOut[i_t] . b[j_t]; for moe_dispatch (out[s] = g[s] x[idx[s]]) dg[s] =
// dOut[s] . x[idx[s]].  So it is the gates' gradient of the MoE layer.
//
// No TPU kernel of src/repro/kernels/ computes it: the JAX package gets
// this gradient from jax.grad of the gather and segment_sum in
// src/repro/nn/moe.py::_moe_sort_one.  Plain twin:
// repro_torch.kernels.ref.tuple_dot.
//
// What bounds it on an H100: bytes.  Two FLOPs a pair of values read; it
// reads the two rows each tuple names and writes one float32 a tuple.  The
// least time is the tuples' ids, the distinct rows of a and of b they name,
// each read once, and the output, over the 3.35 TB/s of HBM.  At the
// DeepSeek-V2-Lite combine's training shape (49,152 tuples, dOut 8192 x
// 2048 float32, the expert rows 61,440 x 2048 bf16) that is about 0.1 ms.
//
// Design, the simple one: one warp a tuple, 8 tuples a block of 256
// threads.  Lane l takes the 8 values c = 8 (l + 32 i) .. +7 of both rows:
// one 16-byte load of a bf16 row or two of a float32 row, so a warp reads
// 512 (bf16) or 1024 (float32) contiguous bytes a step.  Each lane sums its
// products in float32, in order, by fmaf; a xor butterfly over the 32 lanes
// (__shfl_xor_sync) then adds the lanes' sums in a fixed order (each step
// adds the same two values on both lanes, and IEEE addition commutes), so
// two calls give the same bits, and no atomic is used.  A bf16 value is
// widened to float32 exactly.  A row id outside 0..ma-1 (the padding,
// rows[t] == ma) writes 0; a col id outside 0..mb-1 writes a NaN rather
// than read out of bounds (the autograd Functions pass ids that their
// forward kernels checked).  d must be a multiple of 8 and both bases
// 16-byte aligned, so every row starts 16-byte aligned.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTuplesPerBlock = kThreads / 32;

__device__ __forceinline__ void load8(const float* p, float v[8]) {
  const float4 lo = __ldg(reinterpret_cast<const float4*>(p));
  const float4 hi = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
  v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float v[8]) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = __bfloat162float(h[i]);
}

template <typename A, typename B>
__global__ void __launch_bounds__(kThreads)
tuple_dot_rows(const A* __restrict__ a, const int32_t* __restrict__ rows,
               const B* __restrict__ b, const int32_t* __restrict__ cols,
               float* __restrict__ out, int32_t nnz, int32_t ma, int32_t mb,
               int32_t d) {
  const int64_t t =
      static_cast<int64_t>(blockIdx.x) * kTuplesPerBlock + threadIdx.x / 32;
  if (t >= nnz) return;
  const int lane = threadIdx.x % 32;
  const int32_t r = __ldg(rows + t);
  const int32_t c = __ldg(cols + t);
  if (r < 0 || r >= ma) {
    if (lane == 0) out[t] = 0.0f;
    return;
  }
  if (c < 0 || c >= mb) {
    if (lane == 0) out[t] = __int_as_float(0x7fc00000);
    return;
  }
  const A* ar = a + static_cast<int64_t>(r) * d;
  const B* br = b + static_cast<int64_t>(c) * d;
  float sum = 0.0f;
#pragma unroll 4
  for (int j = 8 * lane; j < d; j += 8 * 32) {
    float av[8], bv[8];
    load8(ar + j, av);
    load8(br + j, bv);
#pragma unroll
    for (int i = 0; i < 8; ++i) sum = fmaf(av[i], bv[i], sum);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) out[t] = sum;
}

template <typename A, typename B>
void launch(const void* a, const void* rows, const void* b, const void* cols,
            void* out, int nnz, int ma, int mb, int d, cudaStream_t s) {
  const int blocks = (nnz + kTuplesPerBlock - 1) / kTuplesPerBlock;
  tuple_dot_rows<A, B><<<blocks, kThreads, 0, s>>>(
      static_cast<const A*>(a), static_cast<const int32_t*>(rows),
      static_cast<const B*>(b), static_cast<const int32_t*>(cols),
      static_cast<float*>(out), nnz, ma, mb, d);
}

}  // namespace

// a: [ma, d], b: [mb, d], each of dtype 0 = float32 or 1 = bfloat16, d a
// multiple of 8, bases 16-byte aligned; rows, cols: int32[nnz]; out:
// float32[nnz].  Returns cudaGetLastError() after the launch.
extern "C" int tuple_dot_launch(const void* a, const void* rows, const void* b,
                                const void* cols, void* out, int nnz, int ma,
                                int mb, int d, int a_dtype, int b_dtype,
                                int device, void* stream) {
  if (d % 8 || nnz <= 0 || a_dtype < 0 || a_dtype > 1 || b_dtype < 0 ||
      b_dtype > 1)
    return cudaErrorInvalidValue;
  int current;
  cudaError_t e = cudaGetDevice(&current);
  if (e == cudaSuccess && current != device) e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a_dtype == 0 && b_dtype == 0)
    launch<float, float>(a, rows, b, cols, out, nnz, ma, mb, d, s);
  else if (a_dtype == 0)
    launch<float, __nv_bfloat16>(a, rows, b, cols, out, nnz, ma, mb, d, s);
  else if (b_dtype == 0)
    launch<__nv_bfloat16, float>(a, rows, b, cols, out, nnz, ma, mb, d, s);
  else
    launch<__nv_bfloat16, __nv_bfloat16>(a, rows, b, cols, out, nnz, ma, mb,
                                         d, s);
  return cudaGetLastError();
}
