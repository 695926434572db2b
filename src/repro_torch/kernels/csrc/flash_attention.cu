// Causal or full GQA softmax attention on float32 operands, for Hopper's
// tensor cores (sm_90a), hand-written CUDA C++:
//
//   out[b, h, i, :] = sum_j softmax_j(scale * q[b,h,i,:] . k[b,h/G,j,:]) v[b,h/G,j,:]
//
// (G = Hq / Hkv query heads share one KV head; causal keeps j <= i.  q and
// k have head dim D, v and out Dv <= D: MLA's 192 / 128.)
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention for float32 operands; bf16 operands go to
// csrc/flash_attention_tc.cu.  Plain twin: repro_torch.kernels.ref.
// flash_attention (repeat K/V, float32 logits, -1e30 mask, softmax, cast
// to q's type).
//
// Float32 accuracy from the tensor cores: 3xTF32.  A TF32 value keeps 11
// significant bits, so one TF32 product is good to about 1e-3 and cannot
// meet the float32 tolerances (rtol 2e-4, atol 2e-5) or the float32
// prefill-vs-decode checks.  Each float32 operand a is split instead into
// hi = rna_tf32(a) and lo = rna_tf32(a - hi) (the subtraction is exact in
// float32), so |a - hi - lo| <= 2^-22 |a|, and a b is taken as
// lo_a hi_b + hi_a lo_b + hi_a hi_b, three wgmma products accumulated in
// float32, the small terms first (CUTLASS's 3xTF32).  The dropped lo_a lo_b
// is below 2^-22 |a b|: per product about ten float32 roundings, the size
// of the float32 sum's own rounding over D terms.  wgmma reads a TF32
// operand as the top 19 bits of the word and truncates the rest, so both
// parts are rounded here, to nearest, never by the hardware.
//
// What bounds it on an H100: operations.  The live score pairs need 131
// GFLOP (Yi-6B prefill: B=4, Hq=32, Hkv=4, S=2000, D=128, causal) and 82
// GFLOP (DeepSeek-V2-Lite's MLA: B=4, H=16, S=2000, D=192, Dv=128), three
// times that on the tensor cores: 0.795 ms and 0.497 ms at 495 TFLOP/s
// TF32 (1.957 and 1.223 ms at 67 TFLOP/s float32 outside them).
//
// Design.  Three launches:
//   - a pre-pass splits K once into hi and lo copies, and V into hi and lo
//     copies of V^T (32-bit wgmma has no transpose flag, so B must be
//     K-major: keys contiguous for P V).  Within each group of 8 keys V^T
//     holds the order 0 2 4 6 1 3 5 7: the float32 accumulator gives a
//     thread keys 2t and 2t + 1 of a group, where the TF32 A fragment
//     takes keys t and t + 4, so P's registers go in as they are.  Every
//     query tile of a head and every query head of a GQA group reads K and
//     V: split inside the attention kernel, they would be loaded and split
//     32 to 256 times over, and those loads, not the products, would bound
//     it; the pre-pass reads each once (41 MB at MLA's shape);
//   - the attention kernel: one block owns 64 query rows of one (b, h) and
//     walks 64-key tiles; nothing carries across blocks.  Its 160 threads
//     are one consumer warpgroup and one producer warp.  The consumers
//     first load, split and store their Q tile into the 128-byte-swizzled
//     layout that the wgmma descriptors name (D/32 slabs of 64 rows x 32
//     TF32 values, hi and lo).  The producer's first lane then streams
//     chunks by TMA (rank-4 tensor maps, the 128-byte swizzle), each 64
//     rows of 32 TF32 values in hi and lo (16 KB): a K tile is D/32
//     chunks (keys x columns), a V tile 2 x Dv/64 chunks of V^T (dv rows x
//     32 keys; 32-row chunks at Dv = 32), through a ring of 8 slots with a
//     "full" mbarrier (transaction bytes) and an "empty" one (4 consumer
//     warps) each;
//   - S = Q K^T: wgmma.m64n64k8 from shared memory, three a k-step.  A
//     phase (the K or the V chunks of a tile) waits for all its chunks,
//     then issues its wgmmas in one straight run and frees the slots after
//     them: ptxas serializes wgmmas (a wait after each) when a branch lies
//     between a wgmma and the wait for it;
//   - the online softmax runs on the accumulator registers: each quad of
//     lanes owns two rows, keeps m and a per-lane partial l in float32 and
//     takes full-precision expf; only tiles that cross the diagonal or the
//     ragged end of S are masked, to -1e30 as the reference masks;
//   - O = alpha O + P V: P is split in the registers and passed as
//     wgmma's A fragment, V^T read from shared memory; each tile's P V is
//     summed from zero in an accumulator of its own and added to O in
//     the registers (one FMA with the rescale), since the tensor cores
//     truncate every wgmma's float32 sum: O carried through all the
//     tiles' wgmmas shrank by 4.9e-6 of itself at 2000 keys, and
//     that bias, the same sign in every layer, set the float32 path's
//     distance from float64 at depth (1.26e-4 at Yi-6B's 32 layers; the
//     TF32 split, the softmax and S's own sums each moved it little: see
//     ref.flash_attention_emulated and ``chip_smoke.py --flash-margin``);
//   - out = O / l, stored from the registers.
// Query tiles go out longest first, the tiles of one head (and the heads
// of one GQA group) next to each other, so the blocks that run together
// share K and V in L2; when causal, tiles strictly in the future of the
// block's last query are never visited.  Shared memory at D = 192: Q in
// hi and lo is 96 KB and the ring 128 KB, 230,528 bytes with the barriers
// and 1 KB of alignment, of the 232,448 a block may have; whole K (96 KB)
// and V (64 KB) tiles beside Q would need 256 KB.  One block an SM.  Any
// S >= 1; (D, Dv) are template parameters: the nine pairs with D in
// {32, 64, 128, 192}, Dv in {32, 64, 128}, Dv <= D, and Zamba2's (80, 80).
// 80 is padded to 96, three 32-column chunks: the third K chunk's tensor
// map keeps the scratch's own width of 80, so TMA writes zeros into its
// columns 80-95; the consumers store zeros for Q's; V^T is cut into three
// 32-row blocks whose rows 80-95 TMA fills with zeros the same way.  So the
// scratch holds only what exists (``scratch_numel`` is unchanged).  Q K^T
// runs D / 8 = 10 k-steps, the work's own; P V runs 96 columns, 1.2x its
// products, and the epilogue stores 80.  Shared memory at 80 / 80: Q 48 KB,
// the ring 128 KB.  q, k and v are read
// by their batch, head and sequence strides (16-byte loads where base and
// strides allow, else 4-byte ones), so the model's head-split views go in
// without a copy.
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kBM = 64;                  // query rows per block
constexpr int kBN = 64;                  // keys per tile
constexpr int kSlots = 8;                // chunks in the ring
constexpr int kConsumers = 128;          // the products and the softmax
constexpr int kThreads = kConsumers + 32;  // and one producer warp
constexpr float kNegInf = -1e30f;        // the reference's mask value
// One part (hi or lo) of a chunk or of a Q slab: 64 rows of 32 TF32 values,
// 128 bytes a row, in the 128-byte swizzle.
constexpr uint32_t kPart = 64 * 128;
constexpr uint32_t kChunk = 2 * kPart;   // hi, then lo

// Shared memory, in bytes from a 1024-aligned base: Q hi [D/32][64][32],
// Q lo, the ring of kSlots chunks, then the mbarriers.
template <int D, int DV>
struct Plan {
  static_assert(D % 16 == 0 && DV % 16 == 0 && DV <= D && D <= 192,
                "D, Dv in {32, 64, 80, 128, 192}, Dv <= D");
  static constexpr int kKChunks = (D + 31) / 32;     // chunks of a K tile
  static constexpr int kVW = DV % 64 == 0 ? 64 : 32;  // dv rows a V chunk
  static constexpr int kVBlocks = (DV + kVW - 1) / kVW;
  static constexpr int kDVP = kVBlocks * kVW;        // P V's width
  static constexpr int kPerTile = kKChunks + 2 * kVBlocks;
  static constexpr uint32_t kQPart = kKChunks * kPart;
  static constexpr uint32_t kRing = 2 * kQPart;
  static constexpr uint32_t kBar = kRing + kSlots * kChunk;
  static constexpr size_t kSmem = kBar + 8 * 2 * kSlots + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// Returns once the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile("{\n.reg .pred p;\n"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// One box of a rank-4 tensor map into shared memory; completion is counted
// in bytes on the mbarrier.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Makes this thread's st.shared visible to the async proxy (wgmma).
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A wgmma shared-memory descriptor of a K-major operand in the 128-byte
// swizzle: start address, leading byte offset 16 (unused), stride byte
// offset 1024 (between groups of 8 rows), layout type 1.
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(1) << 16 | static_cast<uint64_t>(64) << 32 |
         static_cast<uint64_t>(1) << 62;
}

// Byte offset of 16-byte unit `unit` (0..7) of row `row` in a part: the
// swizzle XORs the unit with the row's place in its 1024-byte group (what
// TMA's 128-byte swizzle writes).
__device__ __forceinline__ uint32_t swz(int row, int unit) {
  return row * 128 + ((unit ^ (row & 7)) << 4);
}

__device__ __forceinline__ float recip(float x) {
  float r;
  asm("div.full.f32 %0, %1, %2;\n" : "=f"(r) : "f"(1.f), "f"(x));
  return r;
}

// x rounded to TF32 (10 explicit mantissa bits), to nearest with ties away
// from zero: cvt.rna.tf32.f32's rounding of a finite x, in two integer
// operations where ptxas expands cvt.rna into a longer sequence.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo to within 2^-22 |x|, both TF32 (rounded, not truncated).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// Four values, loaded with one 16-byte load where `vec`, else four 4-byte
// ones.
__device__ __forceinline__ void load4(const float* src, bool vec, float* x) {
  if (vec) {
    const float4 f = __ldg(reinterpret_cast<const float4*>(src));
    x[0] = f.x;
    x[1] = f.y;
    x[2] = f.z;
    x[3] = f.w;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = __ldg(src + i);
  }
}

// The pre-pass, K: rows of a (batch, heads, S, D) operand read by their
// strides, each value split and written to contiguous hi and lo copies.
__global__ void split_rows(const float* __restrict__ src, int64_t s_b,
                           int64_t s_h, int64_t s_s, int heads, int S, int D,
                           float* __restrict__ hi, float* __restrict__ lo,
                           int64_t units, int vec) {
  const int per_row = D / 4;
  for (int64_t u = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       u < units; u += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t row = u / per_row;
    const int c = 4 * static_cast<int>(u % per_row);
    const int s = static_cast<int>(row % S);
    const int64_t bh = row / S;
    float x[4];
    load4(src + (bh / heads) * s_b + (bh % heads) * s_h + s * s_s + c,
          vec != 0, x);
    uint32_t h[4], l[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) split(x[i], h[i], l[i]);
    *reinterpret_cast<uint4*>(hi + row * D + c) =
        make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(lo + row * D + c) =
        make_uint4(l[0], l[1], l[2], l[3]);
  }
}

// The pre-pass, V: a (batch, heads, S, Dv) operand written as V^T,
// (batch, heads, Dv, S_pad) in hi and lo, keys past S as zeros, each group
// of 8 keys in the order 0 2 4 6 1 3 5 7.  One block transposes 32 keys by
// 32 dv (fewer in the last block where 32 does not divide Dv) through
// shared memory, reading and writing whole rows.
__global__ void split_vt(const float* __restrict__ src, int64_t s_b,
                         int64_t s_h, int64_t s_s, int heads, int S,
                         int S_pad, int Dv, float* __restrict__ hi,
                         float* __restrict__ lo) {
  __shared__ float tile[32][33];
  const int k0 = blockIdx.x * 32, d0 = blockIdx.y * 32;
  const int64_t bh = blockIdx.z;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const float* base = src + (bh / heads) * s_b + (bh % heads) * s_h + d0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty + 8 * i;
    tile[ty + 8 * i][tx] =
        key < S && d0 + tx < Dv ? __ldg(base + key * s_s + tx) : 0.f;
  }
  __syncthreads();
  const int pos = k0 + tx;                       // place in the V^T row
  const int key = 8 * (tx / 8) + (tx % 8 < 4 ? 2 * (tx % 8)
                                             : 2 * (tx % 8 - 4) + 1);
  if (pos >= S_pad) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (d0 + ty + 8 * i >= Dv) break;
    const int64_t at = (bh * Dv + d0 + ty + 8 * i) * S_pad + pos;
    uint32_t h, l;
    split(tile[key][ty + 8 * i], h, l);
    hi[at] = __uint_as_float(h);
    lo[at] = __uint_as_float(l);
  }
}

// The consumers' share of 64 rows x 32 columns of q: rows r0 + p/8 + 16e,
// columns c0 + 4 (p % 8) .. + 3, e < 4; rows at or past S and columns at or
// past D (a multiple of 4) read as zeros.
__device__ __forceinline__ void load_rows(const float* base, int64_t rs,
                                          int r0, int S, int c0, int D,
                                          int p, bool vec, float (&x)[16]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int row = r0 + p / 8 + 16 * e;
    if (row < S && c0 + 4 * (p % 8) < D) {
      load4(base + row * rs + c0 + 4 * (p % 8), vec, &x[4 * e]);
    } else {
      x[4 * e] = x[4 * e + 1] = x[4 * e + 2] = x[4 * e + 3] = 0.f;
    }
  }
}

// Sixteen values split and stored, four at a time, into the hi part at
// `hi_base` and the lo part `lo_gap` bytes after it, rows p/8 + 16e.
__device__ __forceinline__ void store_rows(uint32_t hi_base, uint32_t lo_gap,
                                           int p, const float (&x)[16]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    uint32_t h[4], l[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) split(x[4 * e + i], h[i], l[i]);
    const uint32_t off = swz(p / 8 + 16 * e, p % 8);
    asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n"
                 :: "r"(hi_base + off), "r"(h[0]), "r"(h[1]), "r"(h[2]),
                    "r"(h[3]) : "memory");
    asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n"
                 :: "r"(hi_base + lo_gap + off), "r"(l[0]), "r"(l[1]),
                    "r"(l[2]), "r"(l[3]) : "memory");
  }
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of registers that an
// asynchronous wgmma owns across the fence, commit and wait.
template <int N>
__device__ __forceinline__ void hold(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void hold(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// wgmma, TF32 in and float32 accumulated; 32-bit operands in shared memory
// are K-major.  _ss: A and B from shared memory, scale_d = 0 overwrites d.
// _rs: A (four TF32 values a thread) from registers, adds to d.

__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n32(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int W>
__device__ __forceinline__ void wgmma_pv(float* o, const uint32_t* a,
                                         uint64_t db) {
  if constexpr (W == 32) wgmma_rs_n32(o, a, db);
  else wgmma_rs_n64(o, a, db);
}

template <int D, int DV>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd(const __grid_constant__ CUtensorMap tm_khi,
          const __grid_constant__ CUtensorMap tm_klo,
          const __grid_constant__ CUtensorMap tm_vhi,
          const __grid_constant__ CUtensorMap tm_vlo,
          const float* __restrict__ q, int64_t q_b, int64_t q_h, int64_t q_s,
          float* __restrict__ out, int S, int Hq, int group, float scale,
          int causal, int vec) {
  using P = Plan<D, DV>;
  constexpr int kVW = P::kVW;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base, ring = base + P::kRing;
  const uint32_t full0 = base + P::kBar;             // full[kSlots]
  const uint32_t empty0 = full0 + 8 * kSlots;        // empty[kSlots]

  const int tid = threadIdx.x;
  const int n_q = (S + kBM - 1) / kBM;
  // query tiles vary fastest (longest first), then the query heads of one
  // KV head: the blocks that run together share K and V in L2
  const int bh = static_cast<int>(blockIdx.x / n_q);
  const int q0 = (n_q - 1 - static_cast<int>(blockIdx.x % n_q)) * kBM;
  const int h = bh % Hq, b = bh / Hq, hk = h / group;
  const int n_kv_all = (S + kBN - 1) / kBN;
  // a tile is live iff its first key is not after the block's last query
  const int n_kv = causal ? min(n_kv_all, (q0 + kBM - 1) / kBN + 1)
                          : n_kv_all;

  if (tid == 0) {
    for (int s = 0; s < kSlots; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {               // the producer warp
    if (tid == kConsumers) {
      // chunk c: tile c / kPerTile; in it, the K chunks (32 columns each),
      // then the V^T chunks, key half by key half, dv block by dv block;
      // hi into the slot's first part, lo into its second
      const int total = n_kv * P::kPerTile;
      for (int c = 0; c < total; ++c) {
        const int slot = c % kSlots;
        if (c >= kSlots) mbar_wait(empty0 + 8 * slot, (c / kSlots - 1) & 1);
        const uint32_t dst = ring + slot * kChunk, full = full0 + 8 * slot;
        const int k0 = (c / P::kPerTile) * kBN, w = c % P::kPerTile;
        if (w < P::kKChunks) {
          mbar_expect_tx(full, 2 * kPart);
          tma_load(dst, &tm_khi, full, 32 * w, k0, hk, b);
          tma_load(dst + kPart, &tm_klo, full, 32 * w, k0, hk, b);
        } else {
          const int x = w - P::kKChunks;
          const int key = k0 + 32 * (x / P::kVBlocks);
          const int dv = kVW * (x % P::kVBlocks);
          mbar_expect_tx(full, 2 * kVW * 128);
          tma_load(dst, &tm_vhi, full, key, dv, hk, b);
          tma_load(dst + kPart, &tm_vlo, full, key, dv, hk, b);
        }
      }
    }
    return;
  }

  // the consumers split their own Q tile once: D/32 slabs of 64 rows
  {
    const float* qb = q + b * q_b + h * q_h;
    float x[P::kKChunks][16];
#pragma unroll
    for (int kc = 0; kc < P::kKChunks; ++kc)
      load_rows(qb, q_s, q0, S, 32 * kc, D, tid, vec != 0, x[kc]);
#pragma unroll
    for (int kc = 0; kc < P::kKChunks; ++kc)
      store_rows(sq + kc * kPart, P::kQPart, tid, x[kc]);
    fence_async_shared();
    asm volatile("bar.sync 1, %0;\n" :: "n"(kConsumers) : "memory");
  }

  // the consumer warpgroup: this thread's accumulator rows are qpos0 and
  // qpos0 + 8, its columns 8 i + col + {0, 1}
  const int warp = tid / 32, lane = tid % 32;
  const int qpos0 = q0 + warp * 16 + lane / 4, qpos1 = qpos0 + 8;
  const int col = 2 * (lane % 4);

  constexpr int DVP = P::kDVP;            // P V's width, zero rows of V^T too
  float o[DVP / 2];
#pragma unroll
  for (int i = 0; i < DVP / 2; ++i) o[i] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  int c = 0;                             // chunks consumed so far
  // frees the slots of chunks c0 .. c0 + n - 1, whose products have
  // finished
  auto release = [&](int c0, int n) {
    __syncwarp();
    if (lane == 0)
      for (int i = 0; i < n; ++i)
        mbar_arrive(empty0 + 8 * ((c0 + i) % kSlots));
  };

  // Each phase waits for all of its chunks, then issues its wgmmas in one
  // straight run with no branch: ptxas serializes wgmmas (a wait after
  // each) when a branch lies between a wgmma and the wait for it.
  for (int j = 0; j < n_kv; ++j) {
    for (int kc = 0; kc < P::kKChunks; ++kc)
      mbar_wait(full0 + 8 * ((c + kc) % kSlots), ((c + kc) / kSlots) & 1);
    float s[kBN / 2];
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) s[i] = 0.f;
    hold(s);
    wgmma_fence();
    // 8 columns (32 bytes) a k-step, four to a chunk; D / 8 of them, so
    // the zero columns of a part-filled last chunk are skipped
#pragma unroll
    for (int t = 0; t < D / 8; ++t) {
      const int kc = t / 4, kk = t % 4;
      const uint32_t kh = ring + ((c + kc) % kSlots) * kChunk;
      const uint32_t qh = sq + kc * kPart;
      const uint64_t q_hi = desc(qh + 32 * kk);
      const uint64_t q_lo = desc(qh + P::kQPart + 32 * kk);
      const uint64_t k_hi = desc(kh + 32 * kk);
      const uint64_t k_lo = desc(kh + kPart + 32 * kk);
      wgmma_ss_n64(s, q_lo, k_hi, t > 0);
      wgmma_ss_n64(s, q_hi, k_lo, 1);
      wgmma_ss_n64(s, q_hi, k_hi, 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    hold(s);
    release(c, P::kKChunks);
    c += P::kKChunks;

    // online softmax
    const int k0 = j * kBN;
    const bool edge = k0 + kBN > S || (causal && k0 + kBN - 1 > q0);
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int i = 0; i < kBN / 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[4 * i + e] * scale;
        if (edge) {
          const int kpos = k0 + 8 * i + col + (e & 1);
          if (kpos >= S || (causal && kpos > (e < 2 ? qpos0 : qpos1)))
            x = kNegInf;
        }
        s[4 * i + e] = x;
        if (e < 2) mx0 = fmaxf(mx0, x);
        else mx1 = fmaxf(mx1, x);
      }
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float alpha0 = expf(m0 - mn0), alpha1 = expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;

    // P split into TF32 hi and lo, as the A fragments of P V: for keys
    // 8 i .. 8 i + 7, registers 4 i .. 4 i + 3 hold (row0, key col),
    // (row0 + 8, col), (row0, col + 1), (row0 + 8, col + 1)
    uint32_t ph[kBN / 2], pl[kBN / 2];
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int i = 0; i < kBN / 8; ++i) {
      const float p00 = expf(s[4 * i] - mn0), p01 = expf(s[4 * i + 1] - mn0);
      const float p10 = expf(s[4 * i + 2] - mn1);
      const float p11 = expf(s[4 * i + 3] - mn1);
      sum0 += p00 + p01;
      sum1 += p10 + p11;
      split(p00, ph[4 * i], pl[4 * i]);
      split(p10, ph[4 * i + 1], pl[4 * i + 1]);
      split(p01, ph[4 * i + 2], pl[4 * i + 2]);
      split(p11, ph[4 * i + 3], pl[4 * i + 3]);
    }
    l0 = l0 * alpha0 + sum0;
    l1 = l1 * alpha1 + sum1;

    // this tile's P V, summed from zero in an accumulator of its own and
    // added to O in the registers: the tensor cores truncate each wgmma's
    // float32 sum, and O carried through every tile's wgmmas (24 a tile,
    // 768 at 2000 keys) shrank toward zero, by 4.9e-6 of itself on
    // average at Yi-6B's prefill shape
    float t[DVP / 2];
#pragma unroll
    for (int i = 0; i < DVP / 2; ++i) t[i] = 0.f;
    constexpr int kV = 2 * P::kVBlocks;    // V chunks a tile
    for (int i = 0; i < kV; ++i)
      mbar_wait(full0 + 8 * ((c + i) % kSlots), ((c + i) / kSlots) & 1);
    hold(t);
    hold(ph);
    hold(pl);
    wgmma_fence();
#pragma unroll
    for (int half = 0; half < 2; ++half) {
#pragma unroll
      for (int blk = 0; blk < P::kVBlocks; ++blk) {
        const int i = half * P::kVBlocks + blk;
        const uint32_t vh = ring + ((c + i) % kSlots) * kChunk;
        float* tt = &t[blk * kVW / 2];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {   // 8 keys a k-step
          const uint32_t* a_hi = &ph[4 * (4 * half + kk)];
          const uint32_t* a_lo = &pl[4 * (4 * half + kk)];
          const uint64_t v_hi = desc(vh + 32 * kk);
          const uint64_t v_lo = desc(vh + kPart + 32 * kk);
          wgmma_pv<kVW>(tt, a_lo, v_hi);
          wgmma_pv<kVW>(tt, a_hi, v_lo);
          wgmma_pv<kVW>(tt, a_hi, v_hi);
        }
      }
    }
    wgmma_commit();
    wgmma_wait_all();
    hold(t);
    release(c, kV);
    c += kV;
#pragma unroll
    for (int i = 0; i < DVP / 8; ++i) {
      o[4 * i] = fmaf(o[4 * i], alpha0, t[4 * i]);
      o[4 * i + 1] = fmaf(o[4 * i + 1], alpha0, t[4 * i + 1]);
      o[4 * i + 2] = fmaf(o[4 * i + 2], alpha1, t[4 * i + 2]);
      o[4 * i + 3] = fmaf(o[4 * i + 3], alpha1, t[4 * i + 3]);
    }
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  // 1 / l by div.full (2 ulp): an IEEE division has a slow path that
  // ptxas makes a subroutine call, and a call anywhere in the kernel makes
  // it wait for every wgmma before issuing the next
  const float inv0 = recip(l0), inv1 = recip(l1);
  float* ob = out + (static_cast<int64_t>(b) * Hq + h) * S * DV;
  if (qpos0 < S) {
    float* row = ob + static_cast<int64_t>(qpos0) * DV + col;
#pragma unroll
    for (int i = 0; i < DV / 8; ++i)
      *reinterpret_cast<float2*>(row + 8 * i) =
          make_float2(o[4 * i] * inv0, o[4 * i + 1] * inv0);
  }
  if (qpos1 < S) {
    float* row = ob + static_cast<int64_t>(qpos1) * DV + col;
#pragma unroll
    for (int i = 0; i < DV / 8; ++i)
      *reinterpret_cast<float2*>(row + 8 * i) =
          make_float2(o[4 * i + 2] * inv1, o[4 * i + 3] * inv1);
  }
}

// cuTensorMapEncodeTiled, reached through the runtime so that the library
// needs no -lcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The tensor map of a contiguous (batch, heads, rows, cols) float32 array
// read in boxes of 32 columns (128 bytes, the 128-byte swizzle) by
// `box_rows` rows; boxes past the end read zeros.
bool tensor_map(CUtensorMap* map, const float* ptr, int64_t batch,
                int64_t heads, int64_t rows, int64_t cols, int box_rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {
      static_cast<cuuint64_t>(cols * 4),
      static_cast<cuuint64_t>(rows * cols * 4),
      static_cast<cuuint64_t>(heads * rows * cols * 4)};
  const cuuint32_t box[4] = {32, static_cast<cuuint32_t>(box_rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode_tiled()(
             map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<float*>(ptr),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Whether an operand's base and batch, head and sequence strides allow
// 16-byte loads.
bool aligned(const void* p, const long long* st) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && st[0] % 4 == 0 &&
         st[1] % 4 == 0 && st[2] % 4 == 0;
}

template <int D, int DV>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int batch, int hq, int hkv, int s, const long long* st,
                   float scale, int causal, void* scratch,
                   cudaStream_t stream) {
  using P = Plan<D, DV>;
  if (!encode_tiled()) return cudaErrorNotSupported;
  const long long blocks =
      static_cast<long long>((s + kBM - 1) / kBM) * hq * batch;
  if (blocks > 0x7fffffffLL || static_cast<long long>(batch) * hkv > 65535)
    return cudaErrorInvalidValue;
  // the pre-pass: K in hi and lo, V^T in hi and lo, in the scratch
  const int s_pad = (s + 7) / 8 * 8;
  const int64_t n_k = static_cast<int64_t>(batch) * hkv * s * D;
  const int64_t n_v = static_cast<int64_t>(batch) * hkv * DV * s_pad;
  float* k_hi = static_cast<float*>(scratch);
  float* k_lo = k_hi + n_k;
  float* v_hi = k_lo + n_k;
  float* v_lo = v_hi + n_v;
  const int64_t units = n_k / 4;
  const int grid = static_cast<int>(
      std::min<int64_t>((units + 255) / 256, 132 * 16));
  split_rows<<<grid, 256, 0, stream>>>(
      static_cast<const float*>(k), st[3], st[4], st[5], hkv, s, D, k_hi,
      k_lo, units, aligned(k, st + 3));
  split_vt<<<dim3((s_pad + 31) / 32, (DV + 31) / 32, batch * hkv),
             dim3(32, 8), 0,
             stream>>>(static_cast<const float*>(v), st[6], st[7], st[8],
                       hkv, s, s_pad, DV, v_hi, v_lo);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  CUtensorMap m_khi, m_klo, m_vhi, m_vlo;
  if (!tensor_map(&m_khi, k_hi, batch, hkv, s, D, kBN) ||
      !tensor_map(&m_klo, k_lo, batch, hkv, s, D, kBN) ||
      !tensor_map(&m_vhi, v_hi, batch, hkv, DV, s_pad, P::kVW) ||
      !tensor_map(&m_vlo, v_lo, batch, hkv, DV, s_pad, P::kVW))
    return cudaErrorInvalidValue;
  e = cudaFuncSetAttribute(flash_fwd<D, DV>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(P::kSmem));
  if (e != cudaSuccess) return e;
  flash_fwd<D, DV><<<static_cast<unsigned>(blocks), kThreads, P::kSmem,
                     stream>>>(m_khi, m_klo, m_vhi, m_vlo,
                               static_cast<const float*>(q), st[0], st[1],
                               st[2], static_cast<float*>(out), s, hq,
                               hq / hkv, scale, causal, aligned(q, st));
  return cudaGetLastError();
}

}  // namespace

// q: [batch, hq, s, d], k: [batch, hkv, s, d], v: [batch, hkv, s, dv], all
// float32, each with unit stride in its last axis and the element strides
// of its batch, head and sequence axes in strides[0..2] (q), [3..5] (k),
// [6..8] (v); out: [batch, hq, s, dv] float32, contiguous; scratch:
// 2 batch hkv (s d + dv s_pad) floats, 16-byte aligned, s_pad = s rounded
// up to 8 (the split K and V^T).  hq % hkv == 0 and (d, dv) one of the
// ten pairs.  Three launches: the two halves of the pre-pass, then the
// attention.  Returns cudaGetLastError() after them, or the error that
// kept them from launching.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int batch,
                                      int hq, int hkv, int s, int d, int dv,
                                      const void* strides, float scale,
                                      int causal, void* scratch, int device,
                                      void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (hkv <= 0 || hq % hkv) return cudaErrorInvalidValue;
  const long long* st = static_cast<const long long*>(strides);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
#define FLASH_CASE(D, DV)                                                   \
  if (d == D && dv == DV)                                                   \
    return launch<D, DV>(q, k, v, out, batch, hq, hkv, s, st, scale,        \
                         causal, scratch, cs);
  FLASH_CASE(32, 32)
  FLASH_CASE(64, 32)
  FLASH_CASE(64, 64)
  FLASH_CASE(80, 80)
  FLASH_CASE(128, 32)
  FLASH_CASE(128, 64)
  FLASH_CASE(128, 128)
  FLASH_CASE(192, 32)
  FLASH_CASE(192, 64)
  FLASH_CASE(192, 128)
#undef FLASH_CASE
  return cudaErrorInvalidValue;
}
