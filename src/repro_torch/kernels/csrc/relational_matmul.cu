// The paper's join + group-by matmul over a sorted COO relation, for Hopper
// (sm_90a), hand-written CUDA C++.
//
//   out[i, :] = sum_{t : row_ids[t] = i} vals[t] * b[col_ids[t], :]
//
// Replaces the Pallas TPU kernel src/repro/kernels/relational_matmul.py::
// relational_matmul.  Plain twin: repro_torch.kernels.ref.relational_matmul.
//
// What bounds it on an H100.  Counted once, the work is 2*nnz*n float32
// FLOPs against 12*nnz + 4*k*n + 4*m*n bytes: on the main path
// ((2000x784).(784x200)) that is ~30 FLOP/byte, above the card's ~20
// FLOP/byte float32 (non-tensor-core) ridge, so the roofline bound is the
// 67 TFLOP/s FMA rate.  In practice the kernel is held by the gather: each
// FMA needs one 4-byte load of b, served from L1/L2 (b, at most 784 x 200
// floats on the main path, lives in the 50 MB L2), so load issue and
// L1/L2 bandwidth, not HBM, set its speed.
//
// Design.  The TPU kernel does the group-by as onehot(row_ids)^T . scaled on
// the MXU; on a GPU that is m-fold redundant work.  Here the group-by is a
// sorted-segment reduction instead: every RelTensor the engine builds has
// row_ids non-decreasing with the padding rows (row_ids == m) last, so
//   1. segment_offsets: offsets[r] = first t with row_ids[t] >= r, one
//      thread per tuple; it also validates the relation (sorted, rows in
//      0..m, cols in 0..k-1) into an error word the wrapper checks before
//      step 2 runs, so step 2 never reads out of bounds;
//   2. segment_spmm: one warp owns one output row x one 128-column tile of
//      b.  The warp loads 32 (col, val) tuples of its segment at once,
//      broadcasts them with shuffles, gathers the b row tile (coalesced:
//      lane l reads columns l, l+32, l+64, l+96), and accumulates in f32
//      registers.  It stores once.  Padding tuples lie past offsets[m] and
//      are never read.  No atomics: each output element has exactly one
//      owner and sums in tuple order, so the result is deterministic.  The
//      (nnz x n) join intermediate of the plain version never exists.
// Ragged n (200, 10, 3) and ragged segments are masked, not rejected.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowsPerBlock = 8;               // one warp per output row
constexpr int kColsPerLane = 4;
constexpr int kTileN = 32 * kColsPerLane;      // columns of b per warp

__global__ void segment_offsets(const int32_t* __restrict__ row_ids,
                                const int32_t* __restrict__ col_ids,
                                int32_t nnz, int32_t m, int32_t k,
                                int32_t* __restrict__ offsets,
                                int32_t* __restrict__ err) {
  const int32_t t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t > nnz) return;
  const int32_t prev = t == 0 ? -1 : row_ids[t - 1];
  const int32_t cur = t == nnz ? m : row_ids[t];
  if (t < nnz) {
    const int32_t c = col_ids[t];
    if (cur < 0 || cur > m || c < 0 || c >= k) {
      atomicOr(err, 1);
      return;
    }
  }
  if (cur < prev) {
    atomicOr(err, 2);
    return;
  }
  // Rows prev+1 .. cur start at tuple t (empty rows share it).  A prev out
  // of range was flagged by thread t-1; clamp it so no write strays.
  for (int32_t r = max(prev, -1) + 1; r <= cur; ++r) offsets[r] = t;
}

__global__ void __launch_bounds__(32 * kRowsPerBlock)
segment_spmm(const int32_t* __restrict__ offsets,
             const int32_t* __restrict__ col_ids,
             const float* __restrict__ vals, const float* __restrict__ b,
             float* __restrict__ out, int32_t m, int32_t n) {
  const int lane = threadIdx.x & 31;
  const int32_t row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= m) return;                        // the whole warp leaves
  const int32_t c0 = blockIdx.y * kTileN + lane;
  float acc[kColsPerLane];
#pragma unroll
  for (int q = 0; q < kColsPerLane; ++q) acc[q] = 0.f;

  const int32_t beg = offsets[row];
  const int32_t end = offsets[row + 1];
  for (int32_t base = beg; base < end; base += 32) {
    int32_t my_col = 0;
    float my_val = 0.f;
    if (base + lane < end) {
      my_col = col_ids[base + lane];
      my_val = vals[base + lane];
    }
    const int cnt = min(32, end - base);       // uniform across the warp
    for (int s = 0; s < cnt; ++s) {
      const int32_t c = __shfl_sync(0xffffffffu, my_col, s);
      const float v = __shfl_sync(0xffffffffu, my_val, s);
      const float* brow = b + static_cast<int64_t>(c) * n;
#pragma unroll
      for (int q = 0; q < kColsPerLane; ++q) {
        const int32_t col = c0 + 32 * q;
        if (col < n) acc[q] = fmaf(v, __ldg(brow + col), acc[q]);
      }
    }
  }
  float* orow = out + static_cast<int64_t>(row) * n;
#pragma unroll
  for (int q = 0; q < kColsPerLane; ++q) {
    const int32_t col = c0 + 32 * q;
    if (col < n) orow[col] = acc[q];
  }
}

}  // namespace

// Step 1.  offsets: int32[m + 1]; err: int32[1], zeroed by the caller.
// Returns cudaGetLastError() after the launch.
extern "C" int relmm_offsets(const void* row_ids, const void* col_ids,
                             int nnz, int m, int k, void* offsets, void* err,
                             int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const int threads = 256;
  const int blocks = (nnz + 1 + threads - 1) / threads;
  segment_offsets<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(row_ids), static_cast<const int32_t*>(col_ids),
      nnz, m, k, static_cast<int32_t*>(offsets), static_cast<int32_t*>(err));
  return cudaGetLastError();
}

// Step 2, after the caller has seen err == 0.  out: float32[m, n].
extern "C" int relmm_spmm(const void* offsets, const void* col_ids,
                          const void* vals, const void* b, void* out, int m,
                          int n, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const dim3 grid((m + kRowsPerBlock - 1) / kRowsPerBlock,
                  (n + kTileN - 1) / kTileN);
  segment_spmm<<<grid, 32 * kRowsPerBlock, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(offsets), static_cast<const int32_t*>(col_ids),
      static_cast<const float*>(vals), static_cast<const float*>(b),
      static_cast<float*>(out), m, n);
  return cudaGetLastError();
}
