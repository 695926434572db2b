// The paper's join + group-by matmul over a sorted COO relation, for Hopper
// (sm_90a), hand-written CUDA C++.
//
//   out[i, :] = sum_{t : row_ids[t] = i} vals[t] * b[col_ids[t], :]
//
// with b float32 or bf16 (each value widened to float32 exactly, as the JAX
// kernel's rhs[cols] * vals.astype(f32) widens it) and float32 sums.
// Replaces the Pallas TPU kernel src/repro/kernels/relational_matmul.py::
// relational_matmul.  Plain twin: repro_torch.kernels.ref.relational_matmul.
//
// What bounds it on an H100.  Counted once, the work is 2*nnz*n float32
// FLOPs against the tuples (12 bytes each), the rows of b they name and the
// float32 output.  On the paper's MLP step ((2000x784).(784x200) and its
// backward products) that is ~30 FLOP/byte, above the card's ~20 FLOP/byte
// float32 ridge, so the roofline bound is the 67 TFLOP/s FMA rate; at the
// MoE combine (48,000 tuples into 8000 x 2048 from 60,416 expert rows, 6
// tuples a row) it is bytes.  What holds a gather below either: every FMA
// needs its own value of b, so where b is read from L2 per tuple (the first
// design: one warp a row, a 4-byte load a FMA), L2 bandwidth sets the
// speed: 1.25 GB through L2 for the 313.6 M FMAs of the MLP's first layer.
//
// Design.  The TPU kernel does the group-by as onehot(row_ids)^T . scaled on
// the MXU; on a GPU that is m-fold redundant work.  Here the group-by is a
// sorted-segment reduction: every RelTensor the engine builds has row_ids
// non-decreasing with the padding rows (row_ids == m) last, so
//   1. segment_offsets: offsets[r] = first t with row_ids[t] >= r, one
//      thread per tuple; it also validates the relation (sorted, rows in
//      0..m, cols in 0..k-1) into two status flags that the launcher reads
//      after waiting for this kernel alone (status_flag.cuh: no memset, no
//      copy), so step 2 runs only on a checked relation and never reads out
//      of bounds.  Padding tuples lie past offsets[m] and are never read.
//      A third flag is information, not a fault: a col id smaller than the
//      one before it in the same row.  Schedule (c) needs every row's cols
//      non-decreasing (every relation the engines build has them
//      increasing: from_dense, transpose's sort by j*m + i).
//   2. one of three schedules, which the wrapper picks from the shape and
//      that flag (relational_matmul.schedule):
//      (a) slab_spmm, where a k x tile_n slab of b fits in shared memory,
//          the relation has at least k tuples and its segments average 32
//          or more (the MLP products but Eq8's 10 tuples a row).  A
//          block of 16 warps copies the slab b[:, c0 : c0 + tile_n] into
//          shared memory once (4-byte cp.async, widened for bf16), then
//          walks its rows' segments gathering b from shared memory: every
//          value comes from L2 once a block instead of once a tuple, and
//          the floor becomes shared-memory bandwidth (4 bytes a FMA, ~0.042
//          ms for the 313.6 M FMAs of the first layer).  tile_n is a power
//          of two from 4 to 256; each lane owns 4 or 8 columns (one or two
//          16-byte shared loads a tuple), `lanes` = tile_n / (4 or 8) lanes
//          share a tuple and the warp's 32 / lanes groups take tuples
//          g, g + groups, ... of the segment, so at n <= 32 lanes take
//          tuples, not columns.  At tile_n >= 32 the 8 lanes of one
//          shared-memory phase read 128 contiguous bytes of one row: no bank
//          conflict, whatever the rows.  Each warp stages 128 tuples at a
//          time in shared memory as (row offset in the slab, value) pairs,
//          which a group reads as one broadcast 8-byte word; the next 128
//          come from device memory into registers meanwhile.  A fixed-order
//          butterfly over the groups ends a segment.  Where rows are few and
//          segments long, `split` warps share one row, each a part cut at a
//          multiple of the group count, and their sums are added in part
//          order through shared memory, so enough warps work.
//      (c) kslab_spmm, where not even a 4-column slab of b fits (k above
//          13,504), the segments average 1024 tuples or more and every
//          row's cols are sorted: the MLP's Eq10 and Eq11 at 60,000 rows,
//          (200 x 60,000).(60,000 x 10) and (784 x 60,000).(60,000 x 200).
//          On (b) those ran one warp to each 60,000-tuple segment, 200 and
//          784 warps on 132 SMs.  Here a block of 16 warps owns 16 rows, a
//          column tile and a range of k, and walks its range in slabs of
//          k_chunk rows of b that two shared-memory buffers hold (half an
//          SM's shared memory, so two blocks share an SM): the next
//          slab's 16-byte cp.async copies (widened through registers for
//          bf16) are in flight while the warps sum over this one.  A warp
//          owns one row; a warp-wide 32-ary search finds the row's first
//          tuple in the range once, and from there the row's cols, sorted,
//          tell each slab's tuples apart as a prefix of the next 128 (a
//          ballot a 32), which are staged and summed as in (a), the sums
//          staying in registers across the slabs.  Each range writes its
//          (m x n) partial, the first into out and the others into a float32
//          scratch the wrapper allocates (at most 8 MB); add_ranges then
//          adds them into out in range order.  The wrapper picks the number
//          of ranges that fills the SMs' waves best, so the grid has
//          hundreds of blocks where (b) had 25 and 98.
//      (b) stream_spmm, otherwise (the MoE combine, Eq8).  One warp owns
//          one row x 512 columns; it loads up to 32 of its tuples at once,
//          broadcasts each with shuffles and reads the named row of b in
//          16-byte vectors (4 float32 or 8 bf16 values; one value a load
//          where n or b's base does not allow 16 bytes) with a streaming
//          (evict-first) load, since each row is read about once, two
//          tuples' loads in flight before their FMAs.
// No atomics: each output element has exactly one owner and sums in a fixed
// order (tuple order in (b); per group then a fixed tree in (a) and, in
// (c), per slab within a range, then the ranges in order), so the result is
// the same from run to run, and a bf16 b gives the bits of its float32
// widening: the schedule does not depend on b's type.  The (nnz x n) join
// intermediate of the plain version never exists.  Ragged n and ragged
// segments are masked, not rejected.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "status_flag.cuh"

namespace {

constexpr int kFlagRange = 0;     // a row id outside 0..m, a col outside 0..k-1
constexpr int kFlagUnsorted = 1;  // row_ids not sorted with the padding last
constexpr int kFlagColsDown = 2;  // a col below the one before it in a row
constexpr int kSlabWarps = 16;
constexpr int kStage = 128;         // tuples a warp stages at a time
constexpr int kStageBytes = kSlabWarps * kStage * 8;
constexpr int kSmemLimit = 232448;  // shared memory a block can have
constexpr int kStreamWarps = 8;
constexpr int kStreamCols = 512;    // columns a stream warp sums: 16 a lane

// bf16 is the high half of a float32: shifting its bits up widens it exactly
__device__ __forceinline__ float widen_bits(uint32_t bf16_bits) {
  return __uint_as_float(bf16_bits << 16);
}

__global__ void segment_offsets(const int32_t* __restrict__ row_ids,
                                const int32_t* __restrict__ col_ids,
                                int32_t nnz, int32_t m, int32_t k,
                                int32_t* __restrict__ offsets,
                                volatile int32_t* flags) {
  const int32_t t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t > nnz) return;
  const int32_t prev = t == 0 ? -1 : row_ids[t - 1];
  const int32_t cur = t == nnz ? m : row_ids[t];
  if (t < nnz) {
    const int32_t c = col_ids[t];
    if (cur < 0 || cur > m || c < 0 || c >= k) {
      flags[kFlagRange] = 1;
      return;
    }
    if (cur == prev && cur < m && c < col_ids[t - 1])
      flags[kFlagColsDown] = 1;
  }
  if (cur < prev) {
    flags[kFlagUnsorted] = 1;
    return;
  }
  // Rows prev+1 .. cur start at tuple t (empty rows share it).  A prev out
  // of range was flagged by thread t-1; clamp it so no write strays.
  for (int32_t r = max(prev, -1) + 1; r <= cur; ++r) offsets[r] = t;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(src));
}

// b[:, c0 : c0 + width] into slab rows of tile_n floats, zeros past width.
__device__ __forceinline__ void fill_slab(float* slab, const float* b,
                                          int32_t k, int32_t n, int32_t c0,
                                          int32_t width, int32_t tile_n) {
  const int shift = __ffs(tile_n) - 1;
  for (int32_t i = threadIdx.x; i < k * tile_n; i += blockDim.x) {
    const int32_t r = i >> shift, c = i & (tile_n - 1);
    if (c < width)
      cp_async4(slab + i, b + static_cast<int64_t>(r) * n + c0 + c);
    else
      slab[i] = 0.f;
  }
  asm volatile("cp.async.wait_all;" ::: "memory");
}

__device__ __forceinline__ void fill_slab(float* slab,
                                          const __nv_bfloat16* b, int32_t k,
                                          int32_t n, int32_t c0, int32_t width,
                                          int32_t tile_n) {
  const uint16_t* bits = reinterpret_cast<const uint16_t*>(b);
  const int shift = __ffs(tile_n) - 1;
  for (int32_t i = threadIdx.x; i < k * tile_n; i += blockDim.x) {
    const int32_t r = i >> shift, c = i & (tile_n - 1);
    slab[i] = c < width
        ? widen_bits(__ldg(bits + static_cast<int64_t>(r) * n + c0 + c))
        : 0.f;
  }
}

// Schedule (a).  P: 16-byte shared loads a lane per tuple (4 P columns).
template <typename T, int P>
__global__ void __launch_bounds__(32 * kSlabWarps)
slab_spmm(const int32_t* __restrict__ offsets,
          const int32_t* __restrict__ col_ids,
          const float* __restrict__ vals, const T* __restrict__ b,
          float* __restrict__ out, int32_t m, int32_t k, int32_t n,
          int32_t tile_n, int32_t rows_per_block, int32_t split) {
  extern __shared__ float4 smem[];
  float* slab = reinterpret_cast<float*>(smem);
  int2* stage = reinterpret_cast<int2*>(slab + k * tile_n);
  float* partial = reinterpret_cast<float*>(stage);  // the split's sums
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int32_t c0 = blockIdx.y * tile_n;
  const int32_t width = min(tile_n, n - c0);
  fill_slab(slab, b, k, n, c0, width, tile_n);
  __syncthreads();

  const int lanes = tile_n / (4 * P);          // lanes that share a tuple
  const int groups = 32 / lanes;
  const int g = lane / lanes, q = lane % lanes;
  const int per_round = kSlabWarps / split;
  const int part = warp % split;
  const int32_t row0 = blockIdx.x * rows_per_block;
  const int32_t rows = min(rows_per_block, m - row0);
  int2* my_stage = stage + warp * kStage;
  for (int32_t r0 = 0; r0 < rows; r0 += per_round) {
    const int32_t rl = r0 + warp / split;
    const bool live = rl < rows;               // uniform across the warp
    const int32_t row = row0 + rl;
    float acc[4 * P];
#pragma unroll
    for (int j = 0; j < 4 * P; ++j) acc[j] = 0.f;
    if (live) {
      const int32_t beg = offsets[row], end = offsets[row + 1];
      int32_t chunk = (end - beg + split - 1) / split;
      chunk = (chunk + groups - 1) / groups * groups;
      const int32_t pb = min(end, beg + part * chunk);
      const int32_t pe = min(end, pb + chunk);
      // Each lane holds its share of the next chunk's tuples in registers,
      // loaded while the warp works on the chunk before.
      int32_t next_col[kStage / 32];
      float next_val[kStage / 32];
      auto fetch = [&](int32_t from) {
#pragma unroll
        for (int j = 0; j < kStage / 32; ++j) {
          const int32_t t = from + lane + 32 * j;
          next_col[j] = t < pe ? __ldg(col_ids + t) : 0;
          next_val[j] = t < pe ? __ldg(vals + t) : 0.f;
        }
      };
      fetch(pb);
      for (int32_t base = pb; base < pe; base += kStage) {
        const int cnt = min(kStage, pe - base);
        __syncwarp();
#pragma unroll
        for (int j = 0; j < kStage / 32; ++j)
          my_stage[lane + 32 * j] = make_int2(next_col[j] * tile_n,
                                              __float_as_int(next_val[j]));
        __syncwarp();
        fetch(base + kStage);
#pragma unroll 4
        for (int i = g; i < cnt; i += groups) {
          const int2 tv = my_stage[i];
          const float v = __int_as_float(tv.y);
          const float* brow = slab + tv.x + 4 * q;
#pragma unroll
          for (int p = 0; p < P; ++p) {
            const float4 w =
                *reinterpret_cast<const float4*>(brow + 4 * lanes * p);
            acc[4 * p + 0] = fmaf(v, w.x, acc[4 * p + 0]);
            acc[4 * p + 1] = fmaf(v, w.y, acc[4 * p + 1]);
            acc[4 * p + 2] = fmaf(v, w.z, acc[4 * p + 2]);
            acc[4 * p + 3] = fmaf(v, w.w, acc[4 * p + 3]);
          }
        }
      }
      for (int off = lanes; off < 32; off <<= 1) {
#pragma unroll
        for (int j = 0; j < 4 * P; ++j)
          acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], off);
      }
    }
    if (split > 1) {                           // add the parts in order
      __syncthreads();                         // the stage is free
      if (live && g == 0) {
#pragma unroll
        for (int j = 0; j < 4 * P; ++j)
          partial[warp * tile_n + 4 * q + 4 * lanes * (j / 4) + j % 4] = acc[j];
      }
      __syncthreads();
      if (live && g == 0 && part == 0) {
        for (int s = 1; s < split; ++s) {
#pragma unroll
          for (int j = 0; j < 4 * P; ++j)
            acc[j] += partial[(warp + s) * tile_n + 4 * q +
                              4 * lanes * (j / 4) + j % 4];
        }
      }
      __syncthreads();                         // before the next staging
    }
    if (live && g == 0 && part == 0) {
      float* orow = out + static_cast<int64_t>(row) * n + c0;
#pragma unroll
      for (int j = 0; j < 4 * P; ++j) {
        const int col = 4 * q + 4 * lanes * (j / 4) + j % 4;
        if (col < width) orow[col] = acc[j];
      }
    }
  }
}

// Schedule (c)'s slab: b[r0 : r0 + rows, c0 : c0 + width] into slab rows of
// tile_n floats, as cp.async copies (16 bytes where vec: n and width
// multiples of 4, b's base 16-byte aligned) that the caller commits and
// waits for; the columns past width were zeroed once.
__device__ __forceinline__ void copy_kslab(float* slab, const float* b,
                                           int32_t r0, int32_t rows,
                                           int32_t n, int32_t c0,
                                           int32_t width, int32_t tile_n,
                                           bool vec) {
  const int32_t per = vec ? width / 4 : width;   // copies a slab row
  for (int32_t i = threadIdx.x; i < rows * per; i += blockDim.x) {
    const int32_t r = i / per, c = i - r * per;
    const float* src = b + static_cast<int64_t>(r0 + r) * n + c0;
    if (vec)
      cp_async16(slab + r * tile_n + 4 * c, src + 4 * c);
    else
      cp_async4(slab + r * tile_n + c, src + c);
  }
}

// bf16 goes through registers, widened: a plain load and a shared store.
__device__ __forceinline__ void copy_kslab(float* slab,
                                           const __nv_bfloat16* b, int32_t r0,
                                           int32_t rows, int32_t n,
                                           int32_t c0, int32_t width,
                                           int32_t tile_n, bool) {
  const uint16_t* bits = reinterpret_cast<const uint16_t*>(b);
  for (int32_t i = threadIdx.x; i < rows * width; i += blockDim.x) {
    const int32_t r = i / width, c = i - r * width;
    slab[r * tile_n + c] =
        widen_bits(__ldg(bits + static_cast<int64_t>(r0 + r) * n + c0 + c));
  }
}

// The first t in [beg, end) with col_ids[t] >= col (end if none), for a
// row whose cols are non-decreasing: each round the warp's 32 lanes probe
// 32 evenly spaced tuples and a ballot keeps the gap the answer lies in.
__device__ __forceinline__ int32_t first_col_at_least(
    const int32_t* __restrict__ col_ids, int32_t beg, int32_t end,
    int32_t col, int lane) {
  int32_t lo = beg, hi = end;           // cols before lo < col <= cols from hi
  while (hi - lo > 32) {
    const int32_t stride = (hi - lo + 31) / 32;
    const int32_t p = lo + lane * stride;
    const bool below = p < hi && __ldg(col_ids + p) < col;
    const int c = __popc(__ballot_sync(0xffffffffu, below));
    const int32_t new_hi = c < 32 ? min(hi, lo + c * stride) : hi;
    lo = c > 0 ? lo + (c - 1) * stride + 1 : lo;
    hi = new_hi;
  }
  const int32_t p = lo + lane;
  const bool below = p < hi && __ldg(col_ids + p) < col;
  return lo + __popc(__ballot_sync(0xffffffffu, below));
}

// Schedule (c).  P: 16-byte shared loads a lane per tuple (4 P columns).
// Block (x, y, z): rows 16 x .. 16 x + 15 (one a warp), columns
// y tile_n .. + tile_n, cols z range_k .. + range_k of the relation.
template <typename T, int P>
__global__ void __launch_bounds__(32 * kSlabWarps, 2)
kslab_spmm(const int32_t* __restrict__ offsets,
           const int32_t* __restrict__ col_ids,
           const float* __restrict__ vals, const T* __restrict__ b,
           float* __restrict__ out, float* __restrict__ partial, int32_t m,
           int32_t k, int32_t n, int32_t tile_n, int32_t k_chunk,
           int32_t range_k, bool vec) {
  extern __shared__ float4 smem[];
  float* slabs = reinterpret_cast<float*>(smem);    // two slab buffers
  const int32_t slab_floats = k_chunk * tile_n;
  int2* stage = reinterpret_cast<int2*>(slabs + 2 * slab_floats);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int32_t c0 = blockIdx.y * tile_n;
  const int32_t width = min(tile_n, n - c0);
  const int32_t k_lo = blockIdx.z * range_k;
  const int32_t k_hi = min(k, k_lo + range_k);
  const int32_t row = blockIdx.x * kSlabWarps + warp;
  const bool live = row < m;                   // uniform across the warp

  if (width < tile_n) {                        // never copied: zero once
    const int32_t pad = tile_n - width;
    for (int32_t i = threadIdx.x; i < 2 * k_chunk * pad; i += blockDim.x)
      slabs[(i / pad) * tile_n + width + i % pad] = 0.f;
  }
  copy_kslab(slabs, b, k_lo, min(k_chunk, k_hi - k_lo), n, c0, width, tile_n,
             vec);
  asm volatile("cp.async.commit_group;" ::: "memory");

  const int lanes = tile_n / (4 * P);          // lanes that share a tuple
  const int groups = 32 / lanes;
  const int g = lane / lanes, q = lane % lanes;
  int2* my_stage = stage + warp * kStage;
  int32_t cur = 0, end = 0;
  if (live) {
    end = offsets[row + 1];
    cur = first_col_at_least(col_ids, offsets[row], end, k_lo, lane);
  }
  // The next 128 tuples from cur, in registers; past the row's end, a col
  // no slab holds.
  int32_t next_col[kStage / 32];
  float next_val[kStage / 32];
  auto fetch = [&]() {
#pragma unroll
    for (int j = 0; j < kStage / 32; ++j) {
      const int32_t t = cur + lane + 32 * j;
      next_col[j] = t < end ? __ldg(col_ids + t) : 0x7fffffff;
      next_val[j] = t < end ? __ldg(vals + t) : 0.f;
    }
  };
  if (live) fetch();
  float acc[4 * P];
#pragma unroll
  for (int j = 0; j < 4 * P; ++j) acc[j] = 0.f;

  int it = 0;
  for (int32_t s0 = k_lo; s0 < k_hi; s0 += k_chunk, ++it) {
    const int32_t s1 = min(k_hi, s0 + k_chunk);
    const float* slab = slabs + (it & 1) * slab_floats;
    if (s1 < k_hi)                             // the next slab, in flight
      copy_kslab(slabs + ((it + 1) & 1) * slab_floats, b, s1,
                 min(k_chunk, k_hi - s1), n, c0, width, tile_n, vec);
    asm volatile("cp.async.commit_group;" ::: "memory");
    asm volatile("cp.async.wait_group 1;" ::: "memory");  // this slab's
    __syncthreads();
    while (live) {
      // The row's tuples in this slab are a prefix of the 128 held.
      int cnt = 0;
#pragma unroll
      for (int j = 0; j < kStage / 32; ++j)
        cnt += __popc(__ballot_sync(0xffffffffu, next_col[j] < s1));
      if (cnt == 0) break;
      __syncwarp();
#pragma unroll
      for (int j = 0; j < kStage / 32; ++j)
        my_stage[lane + 32 * j] = make_int2(
            next_col[j] < s1 ? (next_col[j] - s0) * tile_n : 0,
            __float_as_int(next_val[j]));
      __syncwarp();
      cur += cnt;
      fetch();
#pragma unroll 4
      for (int i = g; i < cnt; i += groups) {
        const int2 tv = my_stage[i];
        const float v = __int_as_float(tv.y);
        const float* brow = slab + tv.x + 4 * q;
#pragma unroll
        for (int p = 0; p < P; ++p) {
          if (4 * q + 4 * lanes * p < width) {
            const float4 w =
                *reinterpret_cast<const float4*>(brow + 4 * lanes * p);
            acc[4 * p + 0] = fmaf(v, w.x, acc[4 * p + 0]);
            acc[4 * p + 1] = fmaf(v, w.y, acc[4 * p + 1]);
            acc[4 * p + 2] = fmaf(v, w.z, acc[4 * p + 2]);
            acc[4 * p + 3] = fmaf(v, w.w, acc[4 * p + 3]);
          }
        }
      }
      if (cnt < kStage) break;
    }
    __syncthreads();             // every warp is done with this slab's buffer
  }
  if (!live) return;
  for (int off = lanes; off < 32; off <<= 1) {
#pragma unroll
    for (int j = 0; j < 4 * P; ++j)
      acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], off);
  }
  if (g == 0) {
    float* dst = blockIdx.z == 0
        ? out
        : partial + static_cast<int64_t>(blockIdx.z - 1) * m * n;
    float* orow = dst + static_cast<int64_t>(row) * n + c0;
#pragma unroll
    for (int j = 0; j < 4 * P; ++j) {
      const int col = 4 * q + 4 * lanes * (j / 4) + j % 4;
      if (col < width) orow[col] = acc[j];
    }
  }
}

// Schedule (c)'s second kernel: out += the partials of ranges 1.., in order.
__global__ void add_ranges(float* __restrict__ out,
                           const float* __restrict__ partial, int64_t count,
                           int32_t ranges) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       i < count; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    float acc = out[i];
    for (int32_t r = 1; r < ranges; ++r)
      acc += partial[static_cast<int64_t>(r - 1) * count + i];
    out[i] = acc;
  }
}

// Schedule (b)'s loads: R is what one load reads (16 bytes, or one value),
// unpacked into its float32 values.
template <typename R> struct Load;
template <> struct Load<float4> {
  static constexpr int kEl = 4;
  static __device__ __forceinline__ void get(const void* p, float* v) {
    const float4 w = __ldcs(static_cast<const float4*>(p));
    v[0] = w.x, v[1] = w.y, v[2] = w.z, v[3] = w.w;
  }
};
template <> struct Load<float> {
  static constexpr int kEl = 1;
  static __device__ __forceinline__ void get(const void* p, float* v) {
    v[0] = __ldcs(static_cast<const float*>(p));
  }
};
template <> struct Load<uint4> {                  // 8 bf16 values
  static constexpr int kEl = 8;
  static __device__ __forceinline__ void get(const void* p, float* v) {
    const uint4 w = __ldcs(static_cast<const uint4*>(p));
    const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = widen_bits(words[i] & 0xffffu);
      v[2 * i + 1] = __uint_as_float(words[i] & 0xffff0000u);
    }
  }
};
template <> struct Load<uint16_t> {               // one bf16 value
  static constexpr int kEl = 1;
  static __device__ __forceinline__ void get(const void* p, float* v) {
    v[0] = widen_bits(__ldcs(static_cast<const unsigned short*>(p)));
  }
};

// Schedule (b).  T: b's element type; R: one load.
template <typename T, typename R>
__global__ void __launch_bounds__(32 * kStreamWarps)
stream_spmm(const int32_t* __restrict__ offsets,
            const int32_t* __restrict__ col_ids,
            const float* __restrict__ vals, const T* __restrict__ b,
            float* __restrict__ out, int32_t m, int32_t n) {
  constexpr int kEl = Load<R>::kEl;
  constexpr int kLoads = kStreamCols / 32 / kEl;  // loads a lane per tuple
  const int lane = threadIdx.x % 32;
  const int32_t row = blockIdx.x * kStreamWarps + threadIdx.x / 32;
  if (row >= m) return;                          // the whole warp leaves
  const int32_t c0 = blockIdx.y * kStreamCols;
  const int32_t width = min(kStreamCols, n - c0);
  float acc[kStreamCols / 32];
#pragma unroll
  for (int j = 0; j < kStreamCols / 32; ++j) acc[j] = 0.f;

  const int32_t beg = offsets[row], end = offsets[row + 1];
  for (int32_t base = beg; base < end; base += 32) {
    int32_t my_col = 0;
    float my_val = 0.f;
    if (base + lane < end) {
      my_col = col_ids[base + lane];
      my_val = vals[base + lane];
    }
    const int cnt = min(32, end - base);       // uniform across the warp
    for (int s = 0; s < cnt; s += 2) {
      const bool two = s + 1 < cnt;
      const int32_t ca = __shfl_sync(0xffffffffu, my_col, s);
      const float va = __shfl_sync(0xffffffffu, my_val, s);
      const int32_t cb = __shfl_sync(0xffffffffu, my_col, two ? s + 1 : s);
      const float vb = __shfl_sync(0xffffffffu, my_val, two ? s + 1 : s);
      const T* rowa = b + static_cast<int64_t>(ca) * n + c0;
      const T* rowb = b + static_cast<int64_t>(cb) * n + c0;
      float wa[kStreamCols / 32], wb[kStreamCols / 32];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int32_t col = (u * 32 + lane) * kEl;
        if (col < width) {
          Load<R>::get(rowa + col, wa + u * kEl);
          if (two) Load<R>::get(rowb + col, wb + u * kEl);
        }
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        if ((u * 32 + lane) * kEl < width) {
#pragma unroll
          for (int e = 0; e < kEl; ++e)
            acc[u * kEl + e] = fmaf(va, wa[u * kEl + e], acc[u * kEl + e]);
          if (two) {
#pragma unroll
            for (int e = 0; e < kEl; ++e)
              acc[u * kEl + e] = fmaf(vb, wb[u * kEl + e], acc[u * kEl + e]);
          }
        }
      }
    }
  }
  float* orow = out + static_cast<int64_t>(row) * n + c0;
#pragma unroll
  for (int u = 0; u < kLoads; ++u) {
    const int32_t col = (u * 32 + lane) * kEl;
#pragma unroll
    for (int e = 0; e < kEl; ++e)
      if (col + e < width) orow[col + e] = acc[u * kEl + e];
  }
}

template <typename T, int P>
cudaError_t launch_slab(const void* offsets, const void* col_ids,
                        const void* vals, const void* b, void* out, int m,
                        int k, int n, int tile_n, int rows_per_block,
                        int split, cudaStream_t s) {
  const int smem = k * tile_n * 4 + kStageBytes;
  auto kernel = slab_spmm<T, P>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((m + rows_per_block - 1) / rows_per_block,
                  (n + tile_n - 1) / tile_n);
  kernel<<<grid, 32 * kSlabWarps, smem, s>>>(
      static_cast<const int32_t*>(offsets),
      static_cast<const int32_t*>(col_ids), static_cast<const float*>(vals),
      static_cast<const T*>(b), static_cast<float*>(out), m, k, n, tile_n,
      rows_per_block, split);
  return cudaGetLastError();
}

template <typename T, int P>
cudaError_t launch_kslab(const void* offsets, const void* col_ids,
                         const void* vals, const void* b, void* out,
                         void* partial, int m, int k, int n, int tile_n,
                         int k_chunk, int range_k, cudaStream_t s) {
  const int smem = 2 * k_chunk * tile_n * 4 + kStageBytes;
  auto kernel = kslab_spmm<T, P>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const int ranges = (k + range_k - 1) / range_k;
  const bool vec = sizeof(T) == 4 && n % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(b) % 16 == 0;
  const dim3 grid((m + kSlabWarps - 1) / kSlabWarps,
                  (n + tile_n - 1) / tile_n, ranges);
  kernel<<<grid, 32 * kSlabWarps, smem, s>>>(
      static_cast<const int32_t*>(offsets),
      static_cast<const int32_t*>(col_ids), static_cast<const float*>(vals),
      static_cast<const T*>(b), static_cast<float*>(out),
      static_cast<float*>(partial), m, k, n, tile_n, k_chunk, range_k, vec);
  e = cudaGetLastError();
  if (e != cudaSuccess || ranges == 1) return e;
  const int64_t count = static_cast<int64_t>(m) * n;
  const int threads = 256;
  const int blocks = static_cast<int>(
      std::min<int64_t>((count + threads - 1) / threads, 132 * 8));
  add_ranges<<<blocks, threads, 0, s>>>(static_cast<float*>(out),
                                       static_cast<const float*>(partial),
                                       count, ranges);
  return cudaGetLastError();
}

template <typename T, typename R>
cudaError_t launch_stream(const void* offsets, const void* col_ids,
                          const void* vals, const void* b, void* out, int m,
                          int n, cudaStream_t s) {
  const dim3 grid((m + kStreamWarps - 1) / kStreamWarps,
                  (n + kStreamCols - 1) / kStreamCols);
  stream_spmm<T, R><<<grid, 32 * kStreamWarps, 0, s>>>(
      static_cast<const int32_t*>(offsets),
      static_cast<const int32_t*>(col_ids), static_cast<const float*>(vals),
      static_cast<const T*>(b), static_cast<float*>(out), m, n);
  return cudaGetLastError();
}

}  // namespace

// Step 1.  offsets: int32[m + 1].  Launches the pass, waits for it, and
// returns 0, a CUDA error (> 0), or minus the status bits raised (1: an id
// out of range, 2: row_ids unsorted, 4: a row's cols not non-decreasing,
// which is no fault).
extern "C" int relmm_offsets(const void* row_ids, const void* col_ids,
                             int nnz, int m, int k, void* offsets, int device,
                             void* stream) {
  Status* st;
  cudaError_t e = open_status(device, &st);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> hold(st->lock);
  e = ready(*st);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  const int blocks = (nnz + 1 + threads - 1) / threads;
  segment_offsets<<<blocks, threads, 0, s>>>(
      static_cast<const int32_t*>(row_ids),
      static_cast<const int32_t*>(col_ids), nnz, m, k,
      static_cast<int32_t*>(offsets), st->dev);
  int bits;
  e = take_flags(*st, s, &bits);
  if (e != cudaSuccess) return e;
  return -bits;
}

// Step 2, schedule (a), on a relation step 1 passed.  b: [k, n] of dtype
// 0 = float32 or 1 = bfloat16; out: float32[m, n]; tile_n a power of two
// from 4 to 256 with k * tile_n * 4 + 16 KB within a block's shared memory.
// Returns cudaGetLastError().
extern "C" int relmm_slab(const void* offsets, const void* col_ids,
                          const void* vals, const void* b, void* out, int m,
                          int k, int n, int dtype, int tile_n,
                          int rows_per_block, int split, int device,
                          void* stream) {
  cudaError_t e = use_device(device);
  if (e != cudaSuccess) return e;
  if (tile_n < 4 || tile_n > 256 || (tile_n & (tile_n - 1)) ||
      split < 1 || split > kSlabWarps || kSlabWarps % split ||
      rows_per_block < 1 ||
      static_cast<int64_t>(k) * tile_n * 4 + kStageBytes > kSmemLimit)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool wide = tile_n >= 64;                // two 16-byte loads a lane
  if (dtype == 0)
    return wide ? launch_slab<float, 2>(offsets, col_ids, vals, b, out, m, k,
                                        n, tile_n, rows_per_block, split, s)
                : launch_slab<float, 1>(offsets, col_ids, vals, b, out, m, k,
                                        n, tile_n, rows_per_block, split, s);
  if (dtype == 1)
    return wide ? launch_slab<__nv_bfloat16, 2>(offsets, col_ids, vals, b,
                                                out, m, k, n, tile_n,
                                                rows_per_block, split, s)
                : launch_slab<__nv_bfloat16, 1>(offsets, col_ids, vals, b,
                                                out, m, k, n, tile_n,
                                                rows_per_block, split, s);
  return cudaErrorInvalidValue;
}

// Step 2, schedule (b).  vec: 16-byte loads (n a multiple of 16 bytes of
// b's type and b's base 16-byte aligned), else one value a load.
extern "C" int relmm_stream(const void* offsets, const void* col_ids,
                            const void* vals, const void* b, void* out, int m,
                            int n, int dtype, int vec, int device,
                            void* stream) {
  cudaError_t e = use_device(device);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return vec ? launch_stream<float, float4>(offsets, col_ids, vals, b, out,
                                              m, n, s)
               : launch_stream<float, float>(offsets, col_ids, vals, b, out,
                                             m, n, s);
  if (dtype == 1)
    return vec ? launch_stream<__nv_bfloat16, uint4>(offsets, col_ids, vals,
                                                     b, out, m, n, s)
               : launch_stream<__nv_bfloat16, uint16_t>(offsets, col_ids,
                                                        vals, b, out, m, n, s);
  return cudaErrorInvalidValue;
}

// Step 2, schedule (c), on a relation step 1 passed with every row's cols
// non-decreasing.  tile_n a power of two from 4 to 256 with
// 2 * k_chunk * tile_n * 4 + 16 KB within a block's shared memory;
// partial: float32[ranges - 1, m, n] with ranges = ceil(k / range_k) (null
// where that is 1).  Returns cudaGetLastError().
extern "C" int relmm_kslab(const void* offsets, const void* col_ids,
                           const void* vals, const void* b, void* out,
                           void* partial, int m, int k, int n, int dtype,
                           int tile_n, int k_chunk, int range_k, int device,
                           void* stream) {
  cudaError_t e = use_device(device);
  if (e != cudaSuccess) return e;
  if (tile_n < 4 || tile_n > 256 || (tile_n & (tile_n - 1)) ||
      k_chunk < 1 || range_k < 1 ||
      (k + static_cast<int64_t>(range_k) - 1) / range_k > 65535 ||
      ((k + static_cast<int64_t>(range_k) - 1) / range_k > 1 && !partial) ||
      2 * static_cast<int64_t>(k_chunk) * tile_n * 4 + kStageBytes >
          kSmemLimit)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool wide = tile_n >= 64;                // two 16-byte loads a lane
  if (dtype == 0)
    return wide ? launch_kslab<float, 2>(offsets, col_ids, vals, b, out,
                                         partial, m, k, n, tile_n, k_chunk,
                                         range_k, s)
                : launch_kslab<float, 1>(offsets, col_ids, vals, b, out,
                                         partial, m, k, n, tile_n, k_chunk,
                                         range_k, s);
  if (dtype == 1)
    return wide ? launch_kslab<__nv_bfloat16, 2>(offsets, col_ids, vals, b,
                                                 out, partial, m, k, n,
                                                 tile_n, k_chunk, range_k, s)
                : launch_kslab<__nv_bfloat16, 1>(offsets, col_ids, vals, b,
                                                 out, partial, m, k, n,
                                                 tile_n, k_chunk, range_k, s);
  return cudaErrorInvalidValue;
}
