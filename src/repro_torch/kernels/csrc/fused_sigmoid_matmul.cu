// sig(X . W) with the sigmoid applied in the epilogue, for Hopper (sm_90a),
// hand-written CUDA C++.  One forward layer of the paper's model (Eq. 4).
//
// Replaces the Pallas TPU kernel src/repro/kernels/fused_sigmoid_matmul.py::
// fused_sigmoid_matmul.  Plain twin: repro_torch.kernels.ref.
// fused_sigmoid_matmul (casts to float32, matmul, sigmoid, cast back).
//
// What bounds it on an H100: FLOPs.  2*m*k*n float32 operations against
// (m*k + k*n + m*n) elements moved; at the main-path shape (2000x784).(784x200)
// that is ~70 FLOP/byte, far above the ~20 FLOP/byte float32 ridge.  The
// reference accumulates in IEEE float32, so the kernel stays off the tensor
// cores (no TF32): its ceiling is the 67 TFLOP/s float32 FMA rate.
//
// Design (simple and correct first; wgmma/TMA are later work).  A classic
// shared-memory tiled SIMT matmul: a 64x64 output tile per block of 256
// threads, each thread holding a 4x4 float32 accumulator in registers
// (rows ty + 16i, columns tx + 16j, so shared-memory reads broadcast or hit
// distinct banks and the stores coalesce).  K advances in slices of 16:
// the block loads a 64x16 slice of x (stored transposed, padded against bank
// conflicts) and a 16x64 slice of w, converting bf16 to float32 on the way
// into shared memory.  All three edges are masked, so k = 784 or 4 and
// n = 200, 10 or 3 need no padding.  The epilogue applies 1/(1+expf(-z))
// (full-precision expf, no fast math) while the tile is in registers, so z
// never reaches device memory, and stores in x's type (bf16 rounds to
// nearest even, as torch's .to(bfloat16) does).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64, kBN = 64, kBK = 16;
constexpr int kThreads = 256;                  // 16 x 16
constexpr int kTM = kBM / 16, kTN = kBN / 16;  // 4 x 4 outputs per thread

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
sigmoid_matmul(const T* __restrict__ x, const T* __restrict__ w,
               T* __restrict__ out, int m, int k, int n) {
  __shared__ float xs[kBK][kBM + 1];           // transposed x slice
  __shared__ float ws[kBK][kBN];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < k; k0 += kBK) {
#pragma unroll
    for (int e = tid; e < kBM * kBK; e += kThreads) {
      const int r = e / kBK, c = e % kBK;
      const int gr = m0 + r, gc = k0 + c;
      xs[c][r] = (gr < m && gc < k)
                     ? to_float(x[static_cast<int64_t>(gr) * k + gc]) : 0.f;
    }
#pragma unroll
    for (int e = tid; e < kBK * kBN; e += kThreads) {
      const int r = e / kBN, c = e % kBN;
      const int gr = k0 + r, gc = n0 + c;
      ws[r][c] = (gr < k && gc < n)
                     ? to_float(w[static_cast<int64_t>(gr) * n + gc]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[kTM], bv[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) a[i] = xs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < kTN; ++j) bv[j] = ws[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int r = m0 + ty + 16 * i;
    if (r >= m) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int c = n0 + tx + 16 * j;
      if (c < n)
        store(out + static_cast<int64_t>(r) * n + c,
              1.f / (1.f + expf(-acc[i][j])));
    }
  }
}

}  // namespace

// x: [m, k], w: [k, n], out: [m, n], all row-major and of one type:
// dtype 0 = float32, 1 = bfloat16.  Returns cudaGetLastError().
extern "C" int fsm_launch(const void* x, const void* w, void* out, int m,
                          int k, int n, int dtype, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    sigmoid_matmul<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<float*>(out), m, k, n);
  } else if (dtype == 1) {
    sigmoid_matmul<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(w),
        static_cast<__nv_bfloat16*>(out), m, k, n);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
