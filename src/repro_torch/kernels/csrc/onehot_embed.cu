// onehot(ids) . table as a row gather, for Hopper (sm_90a), hand-written
// CUDA C++: out[t, :] = table[ids[t], :].  Section 4.1 of the paper builds
// the one-hot relation and multiplies it by a matrix; each product row
// touches exactly one row of the table.
//
// Replaces the Pallas TPU kernel src/repro/kernels/onehot_embed.py::
// onehot_embed (a scalar-prefetched DMA gather).  Plain twin:
// repro_torch.kernels.ref.onehot_embed (table[ids]).
//
// What bounds it on an H100: bytes.  No arithmetic at all; it reads the ids
// and one table row per id and writes one output row per id, so the least
// time is those bytes over the 3.35 TB/s of HBM.  At the main path's size
// (2000 labels into an 11 x 10 float32 table) that is 0.00003 ms: what a
// call costs is its launch and what the host does around it.
//
// Design.  A row copy is type-blind, so the kernel moves the widest word
// that divides the row's byte length and the two base addresses: 16-byte
// vectors (uint4) where d * sizeof allows, else 8, 4 or 2 bytes.  A row
// whose length is not a multiple of 16 bytes does not start 16-byte
// aligned, so a narrower word for the whole row replaces a vector body plus
// scalar tail.  Each warp copies whole rows: 32 / words rows at once when a
// row is under 32 words (lane l takes word l % words of row l / words, one
// 32-bit division a thread), else one row with its lanes striding over the
// words; so neighbouring lanes touch neighbouring words and the 2000 main-
// path rows of five 8-byte words go to 334 warps on 84 blocks, where a
// flat layout of 1024 words a block of 256 threads (a 64-bit division a
// word) runs 10.  Each id is checked against v; a bad id writes zeros
// instead of reading out of bounds, and raises the status flag.
//
// The status flag and the wait: status_flag.cuh.  A call is one kernel
// launch and one wait for that kernel, with no memset and no copy.
#include <cuda_runtime.h>
#include <stdint.h>

#include "status_flag.cuh"

namespace {

constexpr int kWarps = 4;                 // warps a block
constexpr int kBadId = -1;                // onehot_launch's return for a bad id

template <typename W>
__global__ void __launch_bounds__(32 * kWarps)
gather_rows(const int32_t* __restrict__ ids, const W* __restrict__ table,
            W* __restrict__ out, int32_t t, int32_t v, int32_t row_words,
            int32_t rows_per_warp, volatile int32_t* bad) {
  const int32_t lane = threadIdx.x % 32;
  const int64_t warp =
      static_cast<int64_t>(blockIdx.x) * kWarps + threadIdx.x / 32;
  const bool packed = rows_per_warp > 1;            // row_words < 32
  const int32_t sub = packed ? lane / row_words : 0;
  const int32_t first = packed ? lane - sub * row_words : lane;
  const int32_t step = packed ? row_words : 32;
  const int64_t r = warp * rows_per_warp + sub;
  if (sub >= rows_per_warp || r >= t) return;
  const int32_t id = ids[r];
  const bool ok = id >= 0 && id < v;
  if (!ok) *bad = 1;
  const W* src = table + static_cast<int64_t>(ok ? id : 0) * row_words;
  W* dst = out + r * row_words;
  for (int32_t c = first; c < row_words; c += step) dst[c] = ok ? src[c] : W{};
}

template <typename W>
void launch(const void* ids, const void* table, void* out, int t, int v,
            int row_bytes, int32_t* bad, cudaStream_t s) {
  const int row_words = row_bytes / static_cast<int>(sizeof(W));
  const int rows_per_warp = row_words < 32 ? 32 / row_words : 1;
  const int64_t warps = (static_cast<int64_t>(t) + rows_per_warp - 1) /
                        rows_per_warp;
  const unsigned blocks = static_cast<unsigned>((warps + kWarps - 1) / kWarps);
  gather_rows<W><<<blocks, 32 * kWarps, 0, s>>>(
      static_cast<const int32_t*>(ids), static_cast<const W*>(table),
      static_cast<W*>(out), t, v, row_words, rows_per_warp, bad);
}

}  // namespace

// ids: int32[t]; table: [v, row_bytes] bytes; out: [t, row_bytes] bytes;
// word: 16, 8, 4 or 2, dividing row_bytes and both base addresses.
// Launches the gather, waits for it, and returns 0, a CUDA error, or -1
// when an id lay outside 0..v-1 (its row is zeros).
extern "C" int onehot_launch(const void* ids, const void* table, void* out,
                             int t, int v, int row_bytes, int word,
                             int device, void* stream) {
  Status* st;
  cudaError_t e = open_status(device, &st);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> hold(st->lock);
  e = ready(*st);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int32_t* flag = st->dev;
  switch (word) {
    case 16: launch<uint4>(ids, table, out, t, v, row_bytes, flag, s); break;
    case 8: launch<uint2>(ids, table, out, t, v, row_bytes, flag, s); break;
    case 4: launch<uint32_t>(ids, table, out, t, v, row_bytes, flag, s); break;
    case 2: launch<uint16_t>(ids, table, out, t, v, row_bytes, flag, s); break;
    default: return cudaErrorInvalidValue;
  }
  int bad;
  e = take_flags(*st, s, &bad);
  if (e != cudaSuccess) return e;
  return bad ? kBadId : 0;
}
