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
// time is those bytes over the 3.35 TB/s of HBM (at tiny sizes, launch
// latency).
//
// Design.  A row copy is type-blind, so the kernel moves the widest word
// that divides the row's byte length and the two base addresses: 16-byte
// vectors (uint4) where d * sizeof allows, else 8, 4 or 2 bytes.  A row
// whose length is not a multiple of 16 bytes does not start 16-byte
// aligned, so a narrower word for the whole row replaces a vector body plus
// scalar tail.  One block of 256 threads copies a group of whole rows with
// a flat, strided loop over (row, word): neighbouring threads touch
// neighbouring words of a row, so loads and stores coalesce.  Each id is
// checked against v; a bad id sets the error word (the wrapper raises) and
// writes zeros instead of reading out of bounds.  The copy is exact for
// float32 and bfloat16 alike.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWordsPerBlock = 4 * kThreads;

template <typename W>
__global__ void __launch_bounds__(kThreads)
gather_rows(const int32_t* __restrict__ ids, const W* __restrict__ table,
            W* __restrict__ out, int32_t t, int32_t v, int32_t row_words,
            int32_t rows_per_block, int32_t* __restrict__ err) {
  const int64_t first = static_cast<int64_t>(blockIdx.x) * rows_per_block;
  const int64_t left = t - first;
  const int64_t rows = left < rows_per_block ? left : rows_per_block;
  const int64_t total = rows * row_words;
  for (int64_t e = threadIdx.x; e < total; e += kThreads) {
    const int64_t r = first + e / row_words;
    const int32_t c = static_cast<int32_t>(e % row_words);
    const int32_t id = ids[r];
    W word;
    if (id >= 0 && id < v) {
      word = table[static_cast<int64_t>(id) * row_words + c];
    } else {
      atomicOr(err, 1);
      word = W{};
    }
    out[r * row_words + c] = word;
  }
}

template <typename W>
void launch(const void* ids, const void* table, void* out, int t, int v,
            int row_bytes, void* err, cudaStream_t s) {
  const int row_words = row_bytes / static_cast<int>(sizeof(W));
  const int rows_per_block = max(1, kWordsPerBlock / row_words);
  const int blocks = (t + rows_per_block - 1) / rows_per_block;
  gather_rows<W><<<blocks, kThreads, 0, s>>>(
      static_cast<const int32_t*>(ids), static_cast<const W*>(table),
      static_cast<W*>(out), t, v, row_words, rows_per_block,
      static_cast<int32_t*>(err));
}

}  // namespace

// ids: int32[t]; table: [v, row_bytes] bytes; out: [t, row_bytes] bytes;
// word: 16, 8, 4 or 2, dividing row_bytes and both base addresses;
// err: int32[1], zeroed by the caller.  Returns cudaGetLastError().
extern "C" int onehot_launch(const void* ids, const void* table, void* out,
                             int t, int v, int row_bytes, int word, void* err,
                             int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (word) {
    case 16: launch<uint4>(ids, table, out, t, v, row_bytes, err, s); break;
    case 8: launch<uint2>(ids, table, out, t, v, row_bytes, err, s); break;
    case 4: launch<uint32_t>(ids, table, out, t, v, row_bytes, err, s); break;
    case 2: launch<uint16_t>(ids, table, out, t, v, row_bytes, err, s); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
