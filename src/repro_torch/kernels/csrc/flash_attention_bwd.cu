// The gradient of causal or full GQA softmax attention, hand-written CUDA
// C++ for Hopper's tensor cores (sm_90a).  For
//
//   out[b, h, i, :] = sum_j P[i, j] v[b, h/G, j, :],
//   P[i, j] = softmax_j(scale * q[b,h,i,:] . k[b,h/G,j,:])  (causal: j <= i)
//
// (G = Hq / Hkv query heads share one KV head; q and k have head dim D, v
// and out Dv) and dO = dL/dout it returns
//
//   dV[j] = sum_{h in the group, i} P[i, j] dO[i]
//   dP[i, j] = dO[i] . v[j],  Delta[i] = sum_j P[i, j] dP[i, j],
//   dS = P o (dP - Delta)
//   dQ[i] = scale sum_j dS[i, j] k[j]
//   dK[j] = scale sum_{h in the group, i} dS[i, j] q[i]
//
// the derivative of repro_torch.kernels.ref.flash_attention(...,
// bf16_scores=False), whose plain twin is ref.flash_attention_bwd.  The
// gradients are rounded once, to nearest even, at the store.
//
// Replaces: the Pallas TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention has no backward of its own (no custom_vjp); the JAX
// package differentiates its jnp twin, src/repro/nn/layers.py::
// attend_flash, with jax.value_and_grad.  On the card the forward kernels
// (csrc/flash_attention.cu, csrc/flash_attention_tc.cu) are the only path,
// so training needs this kernel.
//
// Delta is sum_j P dP, not the usual rowsum(dO o): the forward's out is
// not the float32-P output this differentiates (the bf16 kernel rounds P
// before P V), and where dQ cancels to 0 (a causal row's first key) the
// o-based Delta leaves float32 noise of 1e-6 that the P dP form cancels
// exactly.  So the kernel takes no o.
//
// Arithmetic: all five products on wgmma, float32-grade.
//   - bf16 operands.  S = q k^T and dP = dO v^T have bf16 operands: exact
//     products, float32 sums.  dV = P^T dO, dK = dS^T q and dQ = dS k each
//     have one float32 operand, P or dS.  It is split in the registers into
//     hi = bf16(x) and lo = bf16(x - hi), |x - hi - lo| <= 2^-16 |x|, and
//     each product runs twice (lo, then hi) on the exact bf16 operand.  One
//     part (FlashAttention's bf16 P and dS) misses BF16_BWD (rtol 8.1e-3,
//     atol 2.1e-5, one bf16 ulp beyond float32's error) by up to 240 x at
//     (192, 128); two parts use 0.960 of it, as float32 arithmetic does
//     (tests/test_torch_flash_bwd_split.py emulates both on the CPU at the
//     card tests' shapes; a third part would buy nothing).
//   - float32 operands.  Every product is 3xTF32, as in the forward: each
//     float32 operand x split into hi = rna_tf32(x) and lo = rna_tf32(x -
//     hi) by integer rounding, a b taken as lo_a hi_b + hi_a lo_b + hi_a
//     hi_b.  The same emulation puts it at 0.097 of F32_TOL (rtol 2e-4,
//     atol 2e-5).  TF32 wgmma reads both operands K-major, so a pre-pass
//     writes q, k, v and dO split into hi and lo rows and q^T, dO^T and k^T
//     split and transposed (the B operands whose reduction runs along the
//     sequence), into a scratch buffer the wrapper allocates.  Within each
//     group of 8 positions the transposed rows hold the order 0 2 4 6 1 3 5
//     7: the float32 accumulator gives a thread columns 2t and 2t + 1 of a
//     group, where the TF32 A fragment takes t and t + 4, so P's and dS's
//     registers go in as they are.
//   - Sums.  wgmma's float32 accumulation is not round-to-nearest: in a
//     first version of this kernel a dK or dV accumulator carried on the
//     tensor cores across the 512 query tiles of Yi-6B's training shape
//     drifted past both tolerances, several times over, on the keys whose
//     sums cancel.  So each tile's gradient product is summed on the
//     tensor cores from zero (8 wgmmas in bf16, 24 in TF32) and added to
//     the gradient in IEEE float32 registers, as DeepSeek-V3 promotes its
//     FP8 partial sums; the S and dP products start from zero each tile
//     anyway.
//
// What bounds it on an H100: operations.  The least work is five products
// over the live (causal) score pairs, 2 pairs (3 D + 2 Dv) FLOPs: at
// Yi-6B's training microbatch (B = 2, Hq = 32, Hkv = 4, S = 4096, D = Dv =
// 128, causal) 0.687 TFLOP, 0.695 ms at 989 TFLOP/s bf16.  This design
// computes S in four kernels' walks (the statistics walk, the dQ walk, the
// dV and the dK kernel) and dP in three, so that no block needs another
// block's sums: in bf16 2 pairs (4 D + 3 Dv + 2 (Dv + 2 D)) with the split
// parts, 2.6 x the least; in float32 3 x 2 pairs (6 D + 4 Dv) TF32
// operations, at 495 TFLOP/s TF32.
//
// Design.  Tiles of 64 query rows and 64 keys; a block is one consumer
// warpgroup (128 threads) and one producer warp, whose first lane issues
// every copy by TMA (rank-4 tensor maps, the 128-byte swizzle) into a ring
// guarded by "full" (transaction bytes) and "empty" (4 consumer warps)
// mbarriers:
//   1. dQ, one block per (b, q head, query tile), longest causal walk
//      first.  Q and dO stay in shared memory.  A first walk over the key
//      tiles takes S and dP and folds them into each row's running max,
//      sum and P-weighted sum of dP (the logsumexp and Delta), which it
//      writes to the scratch for step 2 (two loops, the first ending
//      before dQ's accumulator is declared, so that it holds no registers
//      there: 3-30 % faster than one loop over both walks on an H100,
//      the same bits); a second walk takes S and dP
//      again, P = exp2(S scale log2 e - lse), dS = P (dP - Delta), split in
//      the registers, and dQ += dS K, with K read MN-major (bf16) or as the
//      k^T copy (TF32).
//   2. dV, then dK, one block per (b, KV head, key tile), the longest
//      causal walk (key tile 0) first.  K (and, for dK, V) stay in shared
//      memory; for each query head of the group and each query tile at or
//      after the key tile the block computes S^T = K Q^T (and dP^T = V
//      dO^T), so that the accumulators hold P^T (dS^T) with a row per key:
//      the A fragments of dV += P^T dO (dK += dS^T Q), straight from the
//      registers.  The tile's lse and Delta arrive by a bulk copy beside
//      it.  The group's sum stays in the block: no atomics, one fixed
//      order, the same bits from run to run.  dK and dV take a launch each:
//      both gradients with their per-tile partial sums and fragments would
//      need more than 255 registers a thread.
// bf16 streams whole tiles (a stage holds a K and a V tile, or a Q and a
// dO tile, 64-column slabs as the forward kernel lays them), two stages;
// float32 streams 16 KB chunks (64 rows x 32 TF32 values, hi and lo) one
// at a time, as many slots as shared memory holds beside the resident
// tiles (4 at 192 / 128).  ptxas gives 98-231 registers a thread and no
// spills up to D = 128; at D = 192 the float32 dQ and dK kernels spill
// 220-364 bytes (and bf16's dQ 4).  Each group of wgmmas is waited for
// before the next mbarrier wait or branch: ptxas serializes every wgmma of
// a kernel (C7520) when a branch or a subroutine call (an IEEE division)
// lies inside a group's flight, so 1 / l is div.full and log2 lg2.approx.
// Masked pairs (causal, the ragged end of S, and in step 2 query rows past
// S) get P = 0, as the reference's -1e30 mask gives them; rows and keys
// past S arrive as zeros from TMA's out-of-bounds fill and are never
// stored.  (D, Dv) are template parameters: the ten pairs of the forward
// kernels, and in bf16 alone Zamba2-7B's (224, 224): its tiles take four
// 64-column slabs (TMA fills columns 224-255 with zeros), 192 KB of shared
// memory, and each gradient product runs as two n128 rounds into an
// accumulator that keeps only the 224 columns that exist (the second
// round adds 48 of its 64 sums a thread), 112 registers, not 128.  The
// float32 path stops at D = 192.  80 is padded on chip, as the forward
// pads it: the bf16 tiles
// take two 64-column slabs whose columns 80-127 TMA fills with zeros, the
// float32 chunks three of 32.  bf16 operands are read in place by their
// batch, head and sequence strides (TMA's rules: a 16-byte base and
// strides); the gradients are written contiguous.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kBM = 64;                    // query rows a tile
constexpr int kBN = 64;                    // keys a tile
constexpr int kConsumers = 128;            // one warpgroup
constexpr int kThreads = kConsumers + 32;  // and one producer warp
constexpr float kNegInf = -1e30f;          // the reference's mask value
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kSmemMax = 232448;           // dynamic shared memory a block
constexpr uint32_t kStats = 2 * kBM * 4;   // a query tile's lse and Delta
// float32 streams chunks of 64 rows x 32 TF32 values (128 bytes a row, the
// 128-byte swizzle): the hi part, then the lo part
constexpr uint32_t kPart = 64 * 128;
constexpr uint32_t kChunk = 2 * kPart;

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

// `bytes` (a multiple of 16) from global memory into shared memory, counted
// on the mbarrier.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ float2 lds2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y) : "r"(addr));
  return v;
}

// A wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units), swizzle layout type (1: 128-byte, 2: 64-byte).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | layout << 62;
}

// A K-major TF32 part (rows of 128 bytes, the 128-byte swizzle).
__device__ __forceinline__ uint64_t tf_desc(uint32_t addr) {
  return smem_desc(addr, 16, 1024, 1);
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

template <int N>
__device__ __forceinline__ void zero(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = 0.f;
}

// 1 / x and log2 x without a subroutine call (div.full: 2 ulp;
// lg2.approx: 2^-22 absolute).
__device__ __forceinline__ float recip(float x) {
  float r;
  asm("div.full.f32 %0, %1, %2;\n" : "=f"(r) : "f"(1.f), "f"(x));
  return r;
}
__device__ __forceinline__ float lg2(float x) {
  float r;
  asm("lg2.approx.f32 %0, %1;\n" : "=f"(r) : "f"(x));
  return r;
}

// x rounded to TF32 (10 explicit mantissa bits), to nearest with ties away
// from zero, in two integer operations.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo to within 2^-22 |x|, both TF32 (rounded, not truncated: wgmma
// reads the top 19 bits of the word).
__device__ __forceinline__ void tf_split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// (a, b) = hi + lo to within 2^-16 of each, both packed bf16 pairs (a in the
// low half).
__device__ __forceinline__ void bf_split(float a, float b, uint32_t& hi,
                                         uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const __nv_bfloat162 l =
      __floats2bfloat162_rn(a - __low2float(h), b - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// A 64 x 64 float32 accumulator (this thread: rows r0 and r0 + 8, columns
// 8 i + 2 (lane % 4) + {0, 1}) as the A fragments of a product that
// reduces over its columns.  bf16 (k16 steps): frag[4 kk .. 4 kk + 3] =
// (r0, cols 16 kk + c), (r0 + 8, c), (r0, c + 8), (r0 + 8, c + 8), each a
// pair of neighbouring columns.  TF32 (k8 steps): frag[4 i .. 4 i + 3] =
// (r0, 2t), (r0 + 8, 2t), (r0, 2t + 1), (r0 + 8, 2t + 1), which the B
// operand's 0 2 4 6 1 3 5 7 order reads as k = t, t, t + 4, t + 4.
__device__ __forceinline__ void bf_frags(const float (&x)[32],
                                         uint32_t (&hi)[16],
                                         uint32_t (&lo)[16]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    bf_split(x[4 * i], x[4 * i + 1], hi[2 * i], lo[2 * i]);
    bf_split(x[4 * i + 2], x[4 * i + 3], hi[2 * i + 1], lo[2 * i + 1]);
  }
}
__device__ __forceinline__ void tf_frags(const float (&x)[32],
                                         uint32_t (&hi)[32],
                                         uint32_t (&lo)[32]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    tf_split(x[4 * i], hi[4 * i], lo[4 * i]);
    tf_split(x[4 * i + 2], hi[4 * i + 1], lo[4 * i + 1]);
    tf_split(x[4 * i + 1], hi[4 * i + 2], lo[4 * i + 2]);
    tf_split(x[4 * i + 3], hi[4 * i + 3], lo[4 * i + 3]);
  }
}

// wgmma, float32 accumulated, adding to d.  bf_: bf16 in; _ss: A and B from
// shared memory, both K-major; _rs: A (four packed registers a thread) from
// registers, B from shared memory MN-major (the transpose flag of 16-bit
// wgmma).  tf_: TF32 in, both operands K-major.

__device__ __forceinline__ void bf_ss_n64(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void bf_rs_n32(float* d, const uint32_t* a,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void bf_rs_n64(float* d, const uint32_t* a,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
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

__device__ __forceinline__ void bf_rs_n128(float* d, const uint32_t* a,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void tf_ss_n64(float* d, uint64_t da, uint64_t db) {
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
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void tf_rs_n32(float* d, const uint32_t* a,
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

__device__ __forceinline__ void tf_rs_n64(float* d, const uint32_t* a,
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

// The shapes and scalars every kernel reads.
struct Shape {
  int S, S64;         // sequence, and rounded up to whole tiles (the stats)
  int Hq, Hkv, group; // query heads, KV heads, Hq / Hkv
  int batch;
  float scale, sl2;   // scale, and scale log2 e
  int causal;
};

// The live pairs of a tile's element: query `q` and key `j` before s, and
// the key not after the query when causal.
__device__ __forceinline__ bool live(int q, int j, const Shape& sh) {
  return q < sh.S && j < sh.S && (!sh.causal || j <= q);
}

// ---------------------------------------------------------------------------
// The statistics of step 1's first walk, a thread's two rows r0 and r0 + 8.

struct Rows {
  float m[2], l[2], t[2];   // running max (log2 domain), sum, sum of P dP
};

// Masks a score tile (s: raw q k^T; out: the log2-domain logit, or -1e30),
// then folds it and dP into the running statistics.  l and t are per-lane
// partial sums; the max is the row's, across its quad of lanes.
__device__ __forceinline__ void fold(float (&s)[32], const float (&dp)[32],
                                     Rows& st, const Shape& sh, bool edge,
                                     int k0, int qpos0, int col) {
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[4 * i + e] * sh.sl2;
      if (edge) {
        const int key = k0 + 8 * i + col + (e & 1);
        const int row = qpos0 + (e < 2 ? 0 : 8);
        if (key >= sh.S || (sh.causal && key > row)) x = kNegInf;
      }
      s[4 * i + e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  }
  float sum[2] = {0.f, 0.f}, dot[2] = {0.f, 0.f}, mn[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    mn[r] = fmaxf(st.m[r], mx[r]);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = exp2f(s[4 * i + e] - mn[e >> 1]);
      sum[e >> 1] += p;
      dot[e >> 1] = fmaf(p, dp[4 * i + e], dot[e >> 1]);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float alpha = exp2f(st.m[r] - mn[r]);
    st.l[r] = st.l[r] * alpha + sum[r];
    st.t[r] = st.t[r] * alpha + dot[r];
    st.m[r] = mn[r];
  }
}

// After the first walk: lse (log2 domain) and Delta of the thread's rows,
// written to the scratch (rows past S as zeros) by the quad's first lane.
__device__ __forceinline__ void finish(Rows& st, float (&lse)[2],
                                       float (&delta)[2], float* lse_out,
                                       float* delta_out, const Shape& sh,
                                       int qpos0, int lane) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = st.l[r], t = st.t[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    t += __shfl_xor_sync(0xffffffffu, t, 1);
    t += __shfl_xor_sync(0xffffffffu, t, 2);
    lse[r] = st.m[r] + lg2(l);
    delta[r] = t * recip(l);
    const int row = qpos0 + 8 * r;
    if ((lane & 3) == 0) {
      lse_out[row] = row < sh.S ? lse[r] : 0.f;
      delta_out[row] = row < sh.S ? delta[r] : 0.f;
    }
  }
}

// Step 1's second walk on a tile: P = exp2(S sl2 - lse) (0 where masked)
// and dS = P (dP - Delta) into dp.
__device__ __forceinline__ void row_ds(const float (&s)[32], float (&dp)[32],
                                       const float (&lse)[2],
                                       const float (&delta)[2],
                                       const Shape& sh, bool edge, int k0,
                                       int qpos0, int col) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      float p = exp2f(s[4 * i + e] * sh.sl2 - lse[r]);
      if (edge) {
        const int key = k0 + 8 * i + col + (e & 1);
        const int row = qpos0 + 8 * r;
        if (key >= sh.S || (sh.causal && key > row)) p = 0.f;
      }
      dp[4 * i + e] = p * (dp[4 * i + e] - delta[r]);
    }
  }
}

// Step 2 on a tile, rows = keys and columns = queries: P^T into s and, if
// dk, dS^T into dp, lse and Delta of each column from the tile's stats in
// shared memory.
template <bool kDK>
__device__ __forceinline__ void col_pds(float (&s)[32], float (&dp)[32],
                                        uint32_t stats, const Shape& sh,
                                        bool edge, int q0, int kpos0,
                                        int col) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float2 lse = lds2(stats + (8 * i + col) * 4);
    const float2 delta = lds2(stats + (kBM + 8 * i + col) * 4);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int q = q0 + 8 * i + col + (e & 1);
      float p = exp2f(s[4 * i + e] * sh.sl2 - ((e & 1) ? lse.y : lse.x));
      if (edge && !live(q, kpos0 + (e < 2 ? 0 : 8), sh)) p = 0.f;
      s[4 * i + e] = p;
      if constexpr (kDK)
        dp[4 * i + e] = p * (dp[4 * i + e] - ((e & 1) ? delta.y : delta.x));
    }
  }
}

// Stores rows row0 and row0 + 8 (those before s) of a 64 x WP accumulator,
// times mul, as columns [0, W) of a contiguous (rows, W) slice.
template <int W, int WP, typename T>
__device__ __forceinline__ void store_acc(const float* acc, T* dst, int row0,
                                          int s, float mul, int col) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= s) continue;
    T* out = dst + static_cast<int64_t>(row) * W + col;
#pragma unroll
    for (int i = 0; i < WP / 8; ++i) {
      if (8 * i + col >= W) continue;
      const float a = acc[4 * i + 2 * r] * mul;
      const float b = acc[4 * i + 2 * r + 1] * mul;
      if constexpr (sizeof(T) == 2)
        *reinterpret_cast<__nv_bfloat162*>(out + 8 * i) =
            __floats2bfloat162_rn(a, b);
      else
        *reinterpret_cast<float2*>(out + 8 * i) = make_float2(a, b);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16.  Tiles of 64 rows as the forward kernel lays them: W-column slabs
// (W = 64, the 128-byte swizzle; 32, the 64-byte one), columns past D zero.

template <int D, int DV>
struct Bf {
  static_assert(D % 16 == 0 && DV % 16 == 0 && DV <= D &&
                    (D <= 192 || (D == 224 && DV == 224)),
                "D, Dv in {32, 64, 80, 128, 192}, Dv <= D, or 224 / 224");
  static constexpr int kW = D >= 64 ? 64 : 32, kWv = DV >= 64 ? 64 : 32;
  static constexpr int kSlabs = (D + kW - 1) / kW;
  static constexpr int kSlabsV = (DV + kWv - 1) / kWv;
  static constexpr int kDP = kSlabs * kW, kDVP = kSlabsV * kWv;
  // the accumulators' columns: every slab's, or past 192 the ones that exist
  static constexpr int kAcc = kDP > 192 ? D : kDP;
  static constexpr int kAccV = kDVP > 192 ? DV : kDVP;
  static constexpr uint32_t kTile = kSlabs * kBM * kW * 2;
  static constexpr uint32_t kTileV = kSlabsV * kBM * kWv * 2;
  // resident: a D-wide and a Dv-wide tile; then two stages of the same;
  // then two stats slots; then full[2], empty[2] and the resident barrier
  static constexpr uint32_t kStage = kTile + kTileV;
  static constexpr uint32_t kStats0 = 3 * kStage;
  static constexpr uint32_t kBar = kStats0 + 2 * kStats;
  static constexpr size_t kSmem = kBar + 8 * 5 + 1024;
  static_assert(kSmem <= kSmemMax, "bf16 tiles exceed shared memory");
};

// acc (64 x 64) += A (64 x KD tile at a) . B (64 x KD tile at b)^T, both
// K-major in W-column slabs: KD / 16 k-steps.
template <int KD, int W>
__device__ __forceinline__ void bf_scores(float (&acc)[32], uint32_t a,
                                          uint32_t b) {
  constexpr uint32_t row = W * 2, slab = kBM * row;
  constexpr uint64_t swz = W == 64 ? 1 : 2;
#pragma unroll
  for (int kk = 0; kk < KD / 16; ++kk) {
    const uint32_t off = (kk / (W / 16)) * slab + (kk % (W / 16)) * 32;
    bf_ss_n64(acc, smem_desc(a + off, 16, 8 * row, swz),
              smem_desc(b + off, 16, 8 * row, swz));
  }
}

// tmp (64 x N) += A (four registers: 64 rows x 16 k) . rows 16 kk .. 16 kk
// + 15 of a 64-row tile at `tile` (N columns in W-column slabs) read
// MN-major.
template <int N, int W>
__device__ __forceinline__ void bf_mma(float* tmp, const uint32_t* a,
                                       uint32_t tile, int kk) {
  constexpr uint32_t row = W * 2, slab = kBM * row;
  constexpr uint64_t swz = W == 64 ? 1 : 2;
  const uint64_t db = smem_desc(tile + kk * 16 * row, slab, 8 * row, swz);
  if constexpr (N == 32) bf_rs_n32(tmp, a, db);
  else if constexpr (N == 64) bf_rs_n64(tmp, a, db);
  else bf_rs_n128(tmp, a, db);
}

// acc (64 x N) += (hi + lo) . a 64-row tile at `tile`, N columns: the
// tile's product summed on the tensor cores from zero (the lo part first,
// k-step by k-step), then added to acc in IEEE float32 (the note at the
// top says why); only the first KEEP of this thread's N / 2 sums (the
// first 2 KEEP columns) are added.
template <int N, int W, int KEEP = N / 2>
__device__ __forceinline__ void bf_round(float* acc, uint32_t (&hi)[16],
                                         uint32_t (&lo)[16], uint32_t tile) {
  float tmp[N / 2];
  zero(tmp);
  hold(tmp);
  hold(hi);
  hold(lo);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    bf_mma<N, W>(tmp, &lo[4 * kk], tile, kk);
    bf_mma<N, W>(tmp, &hi[4 * kk], tile, kk);
  }
  wgmma_commit();
  wgmma_wait_all();
  hold(tmp);
  hold(hi);
  hold(lo);
#pragma unroll
  for (int i = 0; i < KEEP; ++i) acc[i] += tmp[i];
}

// acc (64 x ACC) += (hi + lo) . the 64-row tile at `tile` (WP columns in
// W-column slabs): one round, at 192 columns two (128, then 64), at 256
// two of 128, the second adding its columns below ACC.
template <int WP, int W, int ACC = WP>
__device__ __forceinline__ void bf_grad(float* acc, uint32_t (&hi)[16],
                                        uint32_t (&lo)[16], uint32_t tile) {
  if constexpr (WP == 192) {
    bf_round<128, W>(acc, hi, lo, tile);
    bf_round<64, W>(acc + 64, hi, lo, tile + 2 * kBM * W * 2);
  } else if constexpr (WP == 256) {
    constexpr uint32_t slab = kBM * W * 2;
    bf_round<128, W>(acc, hi, lo, tile);
    bf_round<128, W, (ACC - 128) / 2>(acc + 64, hi, lo, tile + 2 * slab);
  } else {
    bf_round<WP, W>(acc, hi, lo, tile);
  }
}

// The slabs of rows [r0, r0 + 64) of a bf16 operand into a tile.
template <int SLABS, int W>
__device__ __forceinline__ void bf_load(uint32_t dst, const CUtensorMap* map,
                                        uint32_t bar, int r0, int h, int b) {
#pragma unroll
  for (int i = 0; i < SLABS; ++i)
    tma_load(dst + i * kBM * W * 2, map, bar, i * W, r0, h, b);
}

// 1. dQ (and the logsumexp and Delta) of one query tile of one (b, q head).
template <int D, int DV>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_bf16_dq(const __grid_constant__ CUtensorMap tm_q,
      const __grid_constant__ CUtensorMap tm_k,
      const __grid_constant__ CUtensorMap tm_v,
      const __grid_constant__ CUtensorMap tm_do, __nv_bfloat16* dq,
      float* lse_out, float* delta_out, Shape sh) {
  using T = Bf<D, DV>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base, sdo = base + T::kTile;
  const uint32_t full0 = base + T::kBar, empty0 = full0 + 16;
  const uint32_t res_bar = empty0 + 16;
  const int tid = threadIdx.x;
  const int n_q = (sh.S + kBM - 1) / kBM, n_bh = sh.batch * sh.Hq;
  const int bh = static_cast<int>(blockIdx.x % n_bh);
  const int qt = n_q - 1 - static_cast<int>(blockIdx.x / n_bh);
  const int q0 = qt * kBM, h = bh % sh.Hq, b = bh / sh.Hq;
  const int hk = h / sh.group;
  const int n_kv = sh.causal ? qt + 1 : n_q;

  if (tid == 0) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumers / 32);
    }
    mbar_init(res_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {               // the producer warp
    if (tid == kConsumers) {
      mbar_expect_tx(res_bar, T::kStage);
      bf_load<T::kSlabs, T::kW>(sq, &tm_q, res_bar, q0, h, b);
      bf_load<T::kSlabsV, T::kWv>(sdo, &tm_do, res_bar, q0, h, b);
      for (int it = 0; it < 2 * n_kv; ++it) {
        const int st = it & 1, k0 = (it % n_kv) * kBN;
        if (it >= 2) mbar_wait(empty0 + 8 * st, ((it >> 1) - 1) & 1);
        const uint32_t full = full0 + 8 * st, sk = base + (1 + st) * T::kStage;
        mbar_expect_tx(full, T::kStage);
        bf_load<T::kSlabs, T::kW>(sk, &tm_k, full, k0, hk, b);
        bf_load<T::kSlabsV, T::kWv>(sk + T::kTile, &tm_v, full, k0, hk, b);
      }
    }
    return;
  }

  // this thread's accumulator rows are qpos0 and qpos0 + 8, its columns
  // 8 i + col + {0, 1}
  const int warp = tid / 32, lane = tid % 32;
  const int qpos0 = q0 + warp * 16 + lane / 4, col = 2 * (lane % 4);
  mbar_wait(res_bar, 0);

  Rows st;
#pragma unroll
  for (int r = 0; r < 2; ++r) st.m[r] = kNegInf, st.l[r] = 0.f, st.t[r] = 0.f;
  float lse[2], delta[2];
  // S and dP of walk step it (tile it % n_kv from stage it & 1)
  auto scores = [&](int it, float (&s)[32], float (&dp)[32]) {
    const int stg = it & 1;
    const uint32_t sk = base + (1 + stg) * T::kStage, sv = sk + T::kTile;
    mbar_wait(full0 + 8 * stg, (it >> 1) & 1);
    zero(s);
    zero(dp);
    hold(s);
    hold(dp);
    wgmma_fence();
    bf_scores<D, T::kW>(s, sq, sk);
    bf_scores<DV, T::kWv>(dp, sdo, sv);
    wgmma_commit();
    wgmma_wait_all();
    hold(s);
    hold(dp);
  };
  // the first walk (statistics) before dQ's accumulator exists
  for (int it = 0; it < n_kv; ++it) {
    const int k0 = it * kBN;
    float s[32], dp[32];
    scores(it, s, dp);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * (it & 1));
    fold(s, dp, st, sh, k0 + kBN > sh.S || (sh.causal && it == qt), k0,
         qpos0, col);
  }
  finish(st, lse, delta, lse_out + static_cast<int64_t>(bh) * sh.S64,
         delta_out + static_cast<int64_t>(bh) * sh.S64, sh, qpos0, lane);
  float dq_acc[T::kAcc / 2];
  zero(dq_acc);
  for (int it = n_kv; it < 2 * n_kv; ++it) {
    const int stg = it & 1, j = it - n_kv, k0 = j * kBN;
    const uint32_t sk = base + (1 + stg) * T::kStage;
    float s[32], dp[32];
    scores(it, s, dp);
    const bool edge = k0 + kBN > sh.S || (sh.causal && j == qt);
    row_ds(s, dp, lse, delta, sh, edge, k0, qpos0, col);
    uint32_t hi[16], lo[16];
    bf_frags(dp, hi, lo);
    bf_grad<T::kDP, T::kW, T::kAcc>(dq_acc, hi, lo, sk);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * stg);
  }
  store_acc<D, T::kAcc>(dq_acc,
                       dq + static_cast<int64_t>(bh) * sh.S * D, qpos0, sh.S,
                       sh.scale, col);
}

// 2. dK (kDK) or dV of one key tile of one (b, KV head).
template <int D, int DV, bool kDK>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_bf16_dkdv(const __grid_constant__ CUtensorMap tm_q,
        const __grid_constant__ CUtensorMap tm_k,
        const __grid_constant__ CUtensorMap tm_v,
        const __grid_constant__ CUtensorMap tm_do, __nv_bfloat16* out,
        const float* lse, const float* delta, Shape sh) {
  using T = Bf<D, DV>;
  constexpr int kW = kDK ? D : DV, kWP = kDK ? T::kDP : T::kDVP;
  constexpr int kSlabW = kDK ? T::kW : T::kWv;
  constexpr int kAcc = kDK ? T::kAcc : T::kAccV;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sk = base, sv = base + T::kTile;
  const uint32_t full0 = base + T::kBar, empty0 = full0 + 16;
  const uint32_t res_bar = empty0 + 16;
  const int tid = threadIdx.x;
  const int n_q = (sh.S + kBM - 1) / kBM, n_bkv = sh.batch * sh.Hkv;
  const int bkv = static_cast<int>(blockIdx.x % n_bkv);
  const int kt = static_cast<int>(blockIdx.x / n_bkv);   // longest first
  const int k0 = kt * kBN, hk = bkv % sh.Hkv, b = bkv / sh.Hkv;
  const int qt0 = sh.causal ? kt : 0;
  const int n_it = sh.group * (n_q - qt0);

  if (tid == 0) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumers / 32);
    }
    mbar_init(res_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {               // the producer warp
    if (tid == kConsumers) {
      mbar_expect_tx(res_bar, T::kTile + (kDK ? T::kTileV : 0));
      bf_load<T::kSlabs, T::kW>(sk, &tm_k, res_bar, k0, hk, b);
      if (kDK) bf_load<T::kSlabsV, T::kWv>(sv, &tm_v, res_bar, k0, hk, b);
      for (int it = 0; it < n_it; ++it) {
        const int st = it & 1, h = hk * sh.group + it / (n_q - qt0);
        const int q0 = (qt0 + it % (n_q - qt0)) * kBM;
        if (it >= 2) mbar_wait(empty0 + 8 * st, ((it >> 1) - 1) & 1);
        const uint32_t full = full0 + 8 * st, sq = base + (1 + st) * T::kStage;
        const uint32_t stats = base + T::kStats0 + st * kStats;
        const int64_t row = static_cast<int64_t>(b * sh.Hq + h) * sh.S64 + q0;
        mbar_expect_tx(full, T::kStage + kStats);
        bf_load<T::kSlabs, T::kW>(sq, &tm_q, full, q0, h, b);
        bf_load<T::kSlabsV, T::kWv>(sq + T::kTile, &tm_do, full, q0, h, b);
        bulk_load(stats, lse + row, kStats / 2, full);
        bulk_load(stats + kStats / 2, delta + row, kStats / 2, full);
      }
    }
    return;
  }

  // this thread's accumulator rows are keys kpos0 and kpos0 + 8, its
  // columns 8 i + col + {0, 1} (queries in the score tiles)
  const int warp = tid / 32, lane = tid % 32;
  const int kpos0 = k0 + warp * 16 + lane / 4, col = 2 * (lane % 4);
  mbar_wait(res_bar, 0);
  float acc[kAcc / 2];
  zero(acc);
  for (int it = 0; it < n_it; ++it) {
    const int stg = it & 1, qt = qt0 + it % (n_q - qt0), q0 = qt * kBM;
    const uint32_t sq = base + (1 + stg) * T::kStage, sdo = sq + T::kTile;
    const uint32_t stats = base + T::kStats0 + stg * kStats;
    mbar_wait(full0 + 8 * stg, (it >> 1) & 1);
    float s[32], dp[32];
    zero(s);
    zero(dp);
    hold(s);
    hold(dp);
    wgmma_fence();
    bf_scores<D, T::kW>(s, sk, sq);
    if constexpr (kDK) bf_scores<DV, T::kWv>(dp, sv, sdo);
    wgmma_commit();
    wgmma_wait_all();
    hold(s);
    hold(dp);
    const bool edge =
        q0 + kBM > sh.S || k0 + kBN > sh.S || (sh.causal && qt == kt);
    col_pds<kDK>(s, dp, stats, sh, edge, q0, kpos0, col);
    // dV += P^T dO, or dK += dS^T Q: the fragments from the registers
    uint32_t hi[16], lo[16];
    if constexpr (kDK) bf_frags(dp, hi, lo);
    else bf_frags(s, hi, lo);
    bf_grad<kWP, kSlabW, kAcc>(acc, hi, lo, kDK ? sq : sdo);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * stg);
  }
  store_acc<kW, kAcc>(acc, out + static_cast<int64_t>(bkv) * sh.S * kW, kpos0,
                     sh.S, kDK ? sh.scale : 1.f, col);
}

// ---------------------------------------------------------------------------
// float32: 3xTF32 on chunks of the split copies.

// The pre-pass: rows of a (batch, heads, S, W) operand read by their
// strides, each value split and written to contiguous hi and lo copies.
__global__ void flash_bwd_split_rows(const float* __restrict__ src,
                                     int64_t s_b, int64_t s_h, int64_t s_s,
                                     int heads, int S, int W,
                                     float* __restrict__ hi,
                                     float* __restrict__ lo, int64_t units,
                                     int vec) {
  const int per_row = W / 4;
  for (int64_t u = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       u < units; u += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t row = u / per_row;
    const int c = 4 * static_cast<int>(u % per_row);
    const int s = static_cast<int>(row % S);
    const int64_t bh = row / S;
    const float* p =
        src + (bh / heads) * s_b + (bh % heads) * s_h + s * s_s + c;
    float x[4];
    if (vec) {
      const float4 f = __ldg(reinterpret_cast<const float4*>(p));
      x[0] = f.x, x[1] = f.y, x[2] = f.z, x[3] = f.w;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) x[i] = __ldg(p + i);
    }
    uint32_t h[4], l[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) tf_split(x[i], h[i], l[i]);
    *reinterpret_cast<uint4*>(hi + row * W + c) =
        make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(lo + row * W + c) =
        make_uint4(l[0], l[1], l[2], l[3]);
  }
}

// The pre-pass, transposed: a (batch, heads, S, W) operand written as
// (batch, heads, W, S8) in hi and lo, positions past S as zeros, each group
// of 8 positions in the order 0 2 4 6 1 3 5 7.  One block transposes 32
// positions by 32 columns through shared memory.
__global__ void flash_bwd_split_t(const float* __restrict__ src, int64_t s_b,
                        int64_t s_h, int64_t s_s, int heads, int S, int S8,
                        int W, float* __restrict__ hi,
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
        key < S && d0 + tx < W ? __ldg(base + key * s_s + tx) : 0.f;
  }
  __syncthreads();
  const int pos = k0 + tx;
  const int key = 8 * (tx / 8) + (tx % 8 < 4 ? 2 * (tx % 8)
                                             : 2 * (tx % 8 - 4) + 1);
  if (pos >= S8) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (d0 + ty + 8 * i >= W) break;
    const int64_t at = (bh * W + d0 + ty + 8 * i) * S8 + pos;
    uint32_t h, l;
    tf_split(tile[key][ty + 8 * i], h, l);
    hi[at] = __uint_as_float(h);
    lo[at] = __uint_as_float(l);
  }
}

template <int D, int DV>
struct Tf {
  static_assert(D % 16 == 0 && DV % 16 == 0 && DV <= D && D <= 192,
                "D, Dv in {32, 64, 80, 128, 192}, Dv <= D");
  // 32-column chunks of a D- and a Dv-wide tile
  static constexpr int kQC = (D + 31) / 32, kVC = (DV + 31) / 32;
  // rows of a transposed block (the gradient's columns an instruction),
  // blocks, and the gradient's width with them
  static constexpr int kBW = D % 64 == 0 ? 64 : 32;
  static constexpr int kBWv = DV % 64 == 0 ? 64 : 32;
  static constexpr int kTB = (D + kBW - 1) / kBW;
  static constexpr int kTBv = (DV + kBWv - 1) / kBWv;
  static constexpr int kDP = kTB * kBW, kDVP = kTBv * kBWv;
};

// Ring slots beside `res` resident chunks: what shared memory holds, at
// most 8.
constexpr int ring_slots(int res) {
  return (kSmemMax - 1024 - 2 * static_cast<int>(kStats) - 8 * (16 + 5) -
          res * static_cast<int>(kChunk)) / static_cast<int>(kChunk) < 8
             ? (kSmemMax - 1024 - 2 * static_cast<int>(kStats) -
                8 * (16 + 5) - res * static_cast<int>(kChunk)) /
                   static_cast<int>(kChunk)
             : 8;
}

// Shared memory of a float32 kernel: the resident chunks, the ring, two
// stats slots, then full[N], empty[N], the stats' full[2] and empty[2],
// and the resident barrier.
template <int RES>
struct TfSmem {
  static constexpr int kN = ring_slots(RES);
  static_assert(kN >= 2, "no room for the ring");
  static constexpr uint32_t kRing = RES * kChunk;
  static constexpr uint32_t kStats0 = kRing + kN * kChunk;
  static constexpr uint32_t kBar = kStats0 + 2 * kStats;
  static constexpr size_t kSmem = kBar + 8 * (2 * kN + 5) + 1024;
  static_assert(kSmem <= kSmemMax, "float32 tiles exceed shared memory");
};

// The chunk ring, as the producer fills it and the consumers drain it: the
// same sequence of chunks on both sides, c counting them.
template <int N>
struct Ring {
  uint32_t slots, full0, empty0;
  int c;
  // the producer: the next slot, once free, armed for `bytes`
  __device__ __forceinline__ uint32_t acquire(uint32_t bytes, uint32_t& bar) {
    const int s = c % N;
    if (c >= N) mbar_wait(empty0 + 8 * s, ((c / N) - 1) & 1);
    bar = full0 + 8 * s;
    mbar_expect_tx(bar, bytes);
    ++c;
    return slots + s * kChunk;
  }
  // the consumers: the next chunk, once it has arrived
  __device__ __forceinline__ uint32_t wait() const {
    const int s = c % N;
    mbar_wait(full0 + 8 * s, (c / N) & 1);
    return slots + s * kChunk;
  }
  __device__ __forceinline__ void release(int lane) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * (c % N));
    ++c;
  }
};

// One box of a split copy, hi (batch b) and lo (batch b + B), into dst.
__device__ __forceinline__ void tf_box(uint32_t dst, const CUtensorMap* map,
                                       uint32_t bar, int c0, int c1, int h,
                                       int b, int batch) {
  tma_load(dst, map, bar, c0, c1, h, b);
  tma_load(dst + kPart, map, bar, c0, c1, h, b + batch);
}

template <int N>
__device__ __forceinline__ void tf_chunk(Ring<N>& ring, const CUtensorMap* map,
                                         int c0, int c1, int h, int b,
                                         int batch, int rows) {
  uint32_t bar;
  const uint32_t dst = ring.acquire(2 * rows * 128, bar);
  tf_box(dst, map, bar, c0, c1, h, b, batch);
}

// acc (64 x 64) += A (chunk at a) . B (chunk at b)^T over the chunk's first
// n k-steps of 8 columns, 3xTF32, the small terms first.
__device__ __forceinline__ void tf_scores(float (&acc)[32], uint32_t a,
                                          uint32_t b, int n) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if (kk < n) {
      const uint64_t a_hi = tf_desc(a + 32 * kk);
      const uint64_t a_lo = tf_desc(a + kPart + 32 * kk);
      const uint64_t b_hi = tf_desc(b + 32 * kk);
      const uint64_t b_lo = tf_desc(b + kPart + 32 * kk);
      tf_ss_n64(acc, a_lo, b_hi);
      tf_ss_n64(acc, a_hi, b_lo);
      tf_ss_n64(acc, a_hi, b_hi);
    }
  }
}

// The S-type product of a tile over KD columns: chunk by chunk from the
// ring (B) against resident chunks (A), each chunk's wgmmas waited for
// before the next chunk's wait.
template <int KD, int N>
__device__ __forceinline__ void tf_scores_tile(float (&acc)[32], uint32_t a,
                                               Ring<N>& ring, int lane) {
#pragma unroll
  for (int c = 0; c < (KD + 31) / 32; ++c) {
    const uint32_t b = ring.wait();
    hold(acc);
    wgmma_fence();
    tf_scores(acc, a + c * kChunk, b, KD / 8 - 4 * c < 4 ? KD / 8 - 4 * c : 4);
    wgmma_commit();
    wgmma_wait_all();
    hold(acc);
    ring.release(lane);
  }
}

// acc (64 x BW) += A (the fragments of k-steps 4 half .. 4 half + 3) . B
// (a transposed block at b: BW rows x 32 positions)^T, 3xTF32.
template <int BW>
__device__ __forceinline__ void tf_grad(float* acc, const uint32_t (&hi)[32],
                                        const uint32_t (&lo)[32], int half,
                                        uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t* a_hi = &hi[4 * (4 * half + kk)];
    const uint32_t* a_lo = &lo[4 * (4 * half + kk)];
    const uint64_t b_hi = tf_desc(b + 32 * kk);
    const uint64_t b_lo = tf_desc(b + kPart + 32 * kk);
    if constexpr (BW == 32) {
      tf_rs_n32(acc, a_lo, b_hi);
      tf_rs_n32(acc, a_hi, b_lo);
      tf_rs_n32(acc, a_hi, b_hi);
    } else {
      tf_rs_n64(acc, a_lo, b_hi);
      tf_rs_n64(acc, a_hi, b_lo);
      tf_rs_n64(acc, a_hi, b_hi);
    }
  }
}

// The gradient product of a tile, NB blocks of BW gradient columns, each
// block's two halves of 32 positions from the ring: a block's product is
// summed on the tensor cores from zero, then added to acc in IEEE float32
// (bf_round says why).
template <int NB, int BW, int N, int ACC>
__device__ __forceinline__ void tf_grad_tile(float (&acc)[ACC],
                                             uint32_t (&hi)[32],
                                             uint32_t (&lo)[32],
                                             Ring<N>& ring, int lane) {
#pragma unroll
  for (int blk = 0; blk < NB; ++blk) {
    float tmp[BW / 2];
    zero(tmp);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const uint32_t b = ring.wait();
      hold(tmp);
      hold(hi);
      hold(lo);
      wgmma_fence();
      tf_grad<BW>(tmp, hi, lo, half, b);
      wgmma_commit();
      wgmma_wait_all();
      hold(tmp);
      hold(hi);
      hold(lo);
      ring.release(lane);
    }
#pragma unroll
    for (int i = 0; i < BW / 2; ++i) acc[blk * BW / 2 + i] += tmp[i];
  }
}

// 1. dQ (and the logsumexp and Delta) of one query tile of one (b, q head).
template <int D, int DV>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_tf32_dq(const __grid_constant__ CUtensorMap tm_q,
      const __grid_constant__ CUtensorMap tm_k,
      const __grid_constant__ CUtensorMap tm_v,
      const __grid_constant__ CUtensorMap tm_do,
      const __grid_constant__ CUtensorMap tm_kt, float* dq, float* lse_out,
      float* delta_out, Shape sh) {
  using T = Tf<D, DV>;
  using M = TfSmem<T::kQC + T::kVC>;
  constexpr int kN = M::kN;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base, sdo = base + T::kQC * kChunk;
  const uint32_t full0 = base + M::kBar, empty0 = full0 + 8 * kN;
  const uint32_t res_bar = empty0 + 8 * kN + 32;
  const int tid = threadIdx.x;
  const int n_q = (sh.S + kBM - 1) / kBM, n_bh = sh.batch * sh.Hq;
  const int bh = static_cast<int>(blockIdx.x % n_bh);
  const int qt = n_q - 1 - static_cast<int>(blockIdx.x / n_bh);
  const int q0 = qt * kBM, h = bh % sh.Hq, b = bh / sh.Hq;
  const int hk = h / sh.group;
  const int n_kv = sh.causal ? qt + 1 : n_q;

  if (tid == 0) {
    for (int s = 0; s < kN; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumers / 32);
    }
    mbar_init(res_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  Ring<kN> ring{base + M::kRing, full0, empty0, 0};

  if (tid >= kConsumers) {               // the producer warp
    if (tid == kConsumers) {
      mbar_expect_tx(res_bar, (T::kQC + T::kVC) * kChunk);
      for (int c = 0; c < T::kQC; ++c)
        tf_box(sq + c * kChunk, &tm_q, res_bar, 32 * c, q0, h, b, sh.batch);
      for (int c = 0; c < T::kVC; ++c)
        tf_box(sdo + c * kChunk, &tm_do, res_bar, 32 * c, q0, h, b,
               sh.batch);
      for (int it = 0; it < 2 * n_kv; ++it) {
        const int k0 = (it % n_kv) * kBN;
        for (int c = 0; c < T::kQC; ++c)
          tf_chunk(ring, &tm_k, 32 * c, k0, hk, b, sh.batch, kBN);
        for (int c = 0; c < T::kVC; ++c)
          tf_chunk(ring, &tm_v, 32 * c, k0, hk, b, sh.batch, kBN);
        if (it >= n_kv)
          for (int blk = 0; blk < T::kTB; ++blk)
            for (int half = 0; half < 2; ++half)
              tf_chunk(ring, &tm_kt, k0 + 32 * half, blk * T::kBW, hk, b,
                       sh.batch, T::kBW);
      }
    }
    return;
  }

  const int warp = tid / 32, lane = tid % 32;
  const int qpos0 = q0 + warp * 16 + lane / 4, col = 2 * (lane % 4);
  mbar_wait(res_bar, 0);

  Rows st;
#pragma unroll
  for (int r = 0; r < 2; ++r) st.m[r] = kNegInf, st.l[r] = 0.f, st.t[r] = 0.f;
  float lse[2], delta[2];
  float dq_acc[T::kDP / 2];
  zero(dq_acc);
  for (int it = 0; it < 2 * n_kv; ++it) {
    const int j = it % n_kv, k0 = j * kBN;
    float s[32], dp[32];
    zero(s);
    zero(dp);
    tf_scores_tile<D>(s, sq, ring, lane);
    tf_scores_tile<DV>(dp, sdo, ring, lane);
    const bool edge = k0 + kBN > sh.S || (sh.causal && j == qt);
    if (it < n_kv) {                     // the first walk: statistics
      fold(s, dp, st, sh, edge, k0, qpos0, col);
      if (it == n_kv - 1)
        finish(st, lse, delta, lse_out + static_cast<int64_t>(bh) * sh.S64,
               delta_out + static_cast<int64_t>(bh) * sh.S64, sh, qpos0,
               lane);
      continue;
    }
    row_ds(s, dp, lse, delta, sh, edge, k0, qpos0, col);
    uint32_t hi[32], lo[32];
    tf_frags(dp, hi, lo);
    tf_grad_tile<T::kTB, T::kBW>(dq_acc, hi, lo, ring, lane);
  }
  store_acc<D, T::kDP>(dq_acc, dq + static_cast<int64_t>(bh) * sh.S * D,
                       qpos0, sh.S, sh.scale, col);
}

// 2. dK (kDK) or dV of one key tile of one (b, KV head).  tm_t is the
// transposed operand of the gradient product: q^T for dK, dO^T for dV.
template <int D, int DV, bool kDK>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_tf32_dkdv(const __grid_constant__ CUtensorMap tm_q,
        const __grid_constant__ CUtensorMap tm_k,
        const __grid_constant__ CUtensorMap tm_v,
        const __grid_constant__ CUtensorMap tm_do,
        const __grid_constant__ CUtensorMap tm_t, float* out,
        const float* lse, const float* delta, Shape sh) {
  using T = Tf<D, DV>;
  using M = TfSmem<T::kQC + (kDK ? T::kVC : 0)>;
  constexpr int kN = M::kN;
  constexpr int kNB = kDK ? T::kTB : T::kTBv, kBW = kDK ? T::kBW : T::kBWv;
  constexpr int kW = kDK ? D : DV, kWP = kDK ? T::kDP : T::kDVP;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sk = base, sv = base + T::kQC * kChunk;
  const uint32_t full0 = base + M::kBar, empty0 = full0 + 8 * kN;
  const uint32_t sfull0 = empty0 + 8 * kN, sempty0 = sfull0 + 16;
  const uint32_t res_bar = sempty0 + 16;
  const int tid = threadIdx.x;
  const int n_q = (sh.S + kBM - 1) / kBM, n_bkv = sh.batch * sh.Hkv;
  const int bkv = static_cast<int>(blockIdx.x % n_bkv);
  const int kt = static_cast<int>(blockIdx.x / n_bkv);   // longest first
  const int k0 = kt * kBN, hk = bkv % sh.Hkv, b = bkv / sh.Hkv;
  const int qt0 = sh.causal ? kt : 0;
  const int n_it = sh.group * (n_q - qt0);

  if (tid == 0) {
    for (int s = 0; s < kN; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumers / 32);
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(sfull0 + 8 * s, 1);
      mbar_init(sempty0 + 8 * s, kConsumers / 32);
    }
    mbar_init(res_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  Ring<kN> ring{base + M::kRing, full0, empty0, 0};

  if (tid >= kConsumers) {               // the producer warp
    if (tid == kConsumers) {
      mbar_expect_tx(res_bar, (T::kQC + (kDK ? T::kVC : 0)) * kChunk);
      for (int c = 0; c < T::kQC; ++c)
        tf_box(sk + c * kChunk, &tm_k, res_bar, 32 * c, k0, hk, b, sh.batch);
      if (kDK)
        for (int c = 0; c < T::kVC; ++c)
          tf_box(sv + c * kChunk, &tm_v, res_bar, 32 * c, k0, hk, b,
                 sh.batch);
      for (int it = 0; it < n_it; ++it) {
        const int h = hk * sh.group + it / (n_q - qt0);
        const int q0 = (qt0 + it % (n_q - qt0)) * kBM;
        const int ss = it & 1;
        if (it >= 2) mbar_wait(sempty0 + 8 * ss, ((it >> 1) - 1) & 1);
        const uint32_t stats = base + M::kStats0 + ss * kStats;
        const int64_t row = static_cast<int64_t>(b * sh.Hq + h) * sh.S64 + q0;
        mbar_expect_tx(sfull0 + 8 * ss, kStats);
        bulk_load(stats, lse + row, kStats / 2, sfull0 + 8 * ss);
        bulk_load(stats + kStats / 2, delta + row, kStats / 2,
                  sfull0 + 8 * ss);
        for (int c = 0; c < T::kQC; ++c)
          tf_chunk(ring, &tm_q, 32 * c, q0, h, b, sh.batch, kBM);
        if (kDK)
          for (int c = 0; c < T::kVC; ++c)
            tf_chunk(ring, &tm_do, 32 * c, q0, h, b, sh.batch, kBM);
        for (int blk = 0; blk < kNB; ++blk)
          for (int half = 0; half < 2; ++half)
            tf_chunk(ring, &tm_t, q0 + 32 * half, blk * kBW, h, b, sh.batch,
                     kBW);
      }
    }
    return;
  }

  const int warp = tid / 32, lane = tid % 32;
  const int kpos0 = k0 + warp * 16 + lane / 4, col = 2 * (lane % 4);
  mbar_wait(res_bar, 0);
  float acc[kWP / 2];
  zero(acc);
  for (int it = 0; it < n_it; ++it) {
    const int qt = qt0 + it % (n_q - qt0), q0 = qt * kBM, ss = it & 1;
    float s[32], dp[32];
    zero(s);
    zero(dp);
    tf_scores_tile<D>(s, sk, ring, lane);
    if constexpr (kDK) tf_scores_tile<DV>(dp, sv, ring, lane);
    const bool edge =
        q0 + kBM > sh.S || k0 + kBN > sh.S || (sh.causal && qt == kt);
    mbar_wait(sfull0 + 8 * ss, (it >> 1) & 1);
    col_pds<kDK>(s, dp, base + M::kStats0 + ss * kStats, sh, edge, q0, kpos0,
                 col);
    __syncwarp();
    if (lane == 0) mbar_arrive(sempty0 + 8 * ss);
    uint32_t hi[32], lo[32];
    if constexpr (kDK) tf_frags(dp, hi, lo);
    else tf_frags(s, hi, lo);
    tf_grad_tile<kNB, kBW>(acc, hi, lo, ring, lane);
  }
  store_acc<kW, kWP>(acc, out + static_cast<int64_t>(bkv) * sh.S * kW, kpos0,
                     sh.S, kDK ? sh.scale : 1.f, col);
}

// ---------------------------------------------------------------------------
// Host side.

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

// A rank-4 map (cols, rows, heads, batch) with the given byte strides of
// rows, heads and batch, read in boxes of `w` columns by `box_rows` rows
// with the swizzle of a `w`-element row of `elem` bytes.
bool tensor_map(CUtensorMap* map, const void* ptr, CUtensorMapDataType type,
                int elem, int64_t batch, int64_t heads, int64_t rows,
                int64_t cols, const int64_t (&strides)[3], int w,
                int box_rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t st[3] = {static_cast<cuuint64_t>(strides[0]),
                            static_cast<cuuint64_t>(strides[1]),
                            static_cast<cuuint64_t>(strides[2])};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(w),
                             static_cast<cuuint32_t>(box_rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode_tiled()(
             map, type, 4, const_cast<void*>(ptr), dims, st, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE,
             w * elem == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                             : CU_TENSOR_MAP_SWIZZLE_64B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A bf16 operand (batch, heads, s, dm) with element strides st[0..2] of its
// batch, head and sequence axes, in boxes of w columns by 64 rows.
bool bf_map(CUtensorMap* map, const void* ptr, int batch, int heads, int s,
            int dm, const long long* st, int w) {
  const int64_t strides[3] = {st[2] * 2, st[1] * 2, st[0] * 2};
  return tensor_map(map, ptr, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, batch,
                    heads, s, dm, strides, w, kBM);
}

// A contiguous split float32 copy (2 batch, heads, rows, cols): hi at
// batch b, lo at b + batch; boxes of 32 columns by `box_rows` rows.
bool tf_map(CUtensorMap* map, const float* ptr, int batch, int heads,
            int64_t rows, int64_t cols, int box_rows) {
  const int64_t strides[3] = {cols * 4, rows * cols * 4,
                              heads * rows * cols * 4};
  return tensor_map(map, ptr, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, 2 * batch,
                    heads, rows, cols, strides, 32, box_rows);
}

template <typename K>
cudaError_t allow(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

struct Operands {
  const void *q, *k, *v, *dout;
  void *dq, *dk, *dv;
  const long long* st;   // (batch, head, seq) strides of q, k, v, dO
  float* scratch;
};

template <int D, int DV>
cudaError_t launch_bf16(const Operands& o, const Shape& sh,
                        cudaStream_t stream) {
  using T = Bf<D, DV>;
  const int b = sh.batch;
  CUtensorMap mq, mk, mv, mdo;
  if (!bf_map(&mq, o.q, b, sh.Hq, sh.S, D, o.st, T::kW) ||
      !bf_map(&mk, o.k, b, sh.Hkv, sh.S, D, o.st + 3, T::kW) ||
      !bf_map(&mv, o.v, b, sh.Hkv, sh.S, DV, o.st + 6, T::kWv) ||
      !bf_map(&mdo, o.dout, b, sh.Hq, sh.S, DV, o.st + 9, T::kWv))
    return cudaErrorInvalidValue;
  float* lse = o.scratch;
  float* delta = lse + static_cast<int64_t>(b) * sh.Hq * sh.S64;
  const int n_q = (sh.S + kBM - 1) / kBM;
  cudaError_t e;
  if ((e = allow(flash_bwd_bf16_dq<D, DV>, T::kSmem)) != cudaSuccess ||
      (e = allow(flash_bwd_bf16_dkdv<D, DV, false>, T::kSmem)) !=
          cudaSuccess ||
      (e = allow(flash_bwd_bf16_dkdv<D, DV, true>, T::kSmem)) != cudaSuccess)
    return e;
  flash_bwd_bf16_dq<D, DV><<<n_q * b * sh.Hq, kThreads, T::kSmem, stream>>>(
      mq, mk, mv, mdo, static_cast<__nv_bfloat16*>(o.dq), lse, delta, sh);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const unsigned grid = n_q * b * sh.Hkv;
  flash_bwd_bf16_dkdv<D, DV, false><<<grid, kThreads, T::kSmem, stream>>>(
      mq, mk, mv, mdo, static_cast<__nv_bfloat16*>(o.dv), lse, delta, sh);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  flash_bwd_bf16_dkdv<D, DV, true><<<grid, kThreads, T::kSmem, stream>>>(
      mq, mk, mv, mdo, static_cast<__nv_bfloat16*>(o.dk), lse, delta, sh);
  return cudaGetLastError();
}

// Whether an operand's base and batch, head and sequence strides allow
// 16-byte loads.
bool aligned(const void* p, const long long* st) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && st[0] % 4 == 0 &&
         st[1] % 4 == 0 && st[2] % 4 == 0;
}

// The pre-pass of one operand: split rows into `rows` and, if `cols` is
// given, split and transposed into it.
cudaError_t split(const void* src, const long long* st, int batch, int heads,
                  int S, int S8, int W, float* rows, float* cols,
                  cudaStream_t stream) {
  const int64_t n = static_cast<int64_t>(batch) * heads * S * W;
  const int64_t units = n / 4;
  const int grid =
      static_cast<int>(std::min<int64_t>((units + 255) / 256, 132 * 16));
  const float* x = static_cast<const float*>(src);
  flash_bwd_split_rows<<<grid, 256, 0, stream>>>(
      x, st[0], st[1], st[2], heads, S, W, rows, rows + n, units,
      aligned(src, st));
  if (cols) {
    const int64_t nt = static_cast<int64_t>(batch) * heads * W * S8;
    const dim3 blocks((S8 + 31) / 32, (W + 31) / 32, batch * heads);
    flash_bwd_split_t<<<blocks, dim3(32, 8), 0, stream>>>(
        x, st[0], st[1], st[2], heads, S, S8, W, cols, cols + nt);
  }
  return cudaGetLastError();
}

template <int D, int DV>
cudaError_t launch_f32(const Operands& o, const Shape& sh,
                       cudaStream_t stream) {
  using T = Tf<D, DV>;
  if (!encode_tiled()) return cudaErrorNotSupported;
  const int b = sh.batch, S = sh.S, S8 = (S + 7) / 8 * 8;
  const int64_t nq = static_cast<int64_t>(b) * sh.Hq;
  const int64_t nk = static_cast<int64_t>(b) * sh.Hkv;
  float* lse = o.scratch;
  float* delta = lse + nq * sh.S64;
  float* q2 = delta + nq * sh.S64;
  float* k2 = q2 + 2 * nq * S * D;
  float* v2 = k2 + 2 * nk * S * D;
  float* do2 = v2 + 2 * nk * S * DV;
  float* qt2 = do2 + 2 * nq * S * DV;
  float* dot2 = qt2 + 2 * nq * D * S8;
  float* kt2 = dot2 + 2 * nq * DV * S8;
  cudaError_t e;
  if ((e = split(o.q, o.st, b, sh.Hq, S, S8, D, q2, qt2, stream)) !=
          cudaSuccess ||
      (e = split(o.k, o.st + 3, b, sh.Hkv, S, S8, D, k2, kt2, stream)) !=
          cudaSuccess ||
      (e = split(o.v, o.st + 6, b, sh.Hkv, S, S8, DV, v2, nullptr,
                 stream)) != cudaSuccess ||
      (e = split(o.dout, o.st + 9, b, sh.Hq, S, S8, DV, do2, dot2,
                 stream)) != cudaSuccess)
    return e;
  CUtensorMap mq, mk, mv, mdo, mqt, mdot, mkt;
  if (!tf_map(&mq, q2, b, sh.Hq, S, D, kBM) ||
      !tf_map(&mk, k2, b, sh.Hkv, S, D, kBN) ||
      !tf_map(&mv, v2, b, sh.Hkv, S, DV, kBN) ||
      !tf_map(&mdo, do2, b, sh.Hq, S, DV, kBM) ||
      !tf_map(&mqt, qt2, b, sh.Hq, D, S8, T::kBW) ||
      !tf_map(&mdot, dot2, b, sh.Hq, DV, S8, T::kBWv) ||
      !tf_map(&mkt, kt2, b, sh.Hkv, D, S8, T::kBW))
    return cudaErrorInvalidValue;
  using Mq = TfSmem<T::kQC + T::kVC>;
  using Mv = TfSmem<T::kQC>;
  if ((e = allow(flash_bwd_tf32_dq<D, DV>, Mq::kSmem)) != cudaSuccess ||
      (e = allow(flash_bwd_tf32_dkdv<D, DV, false>, Mv::kSmem)) !=
          cudaSuccess ||
      (e = allow(flash_bwd_tf32_dkdv<D, DV, true>, Mq::kSmem)) != cudaSuccess)
    return e;
  const int n_q = (S + kBM - 1) / kBM;
  const unsigned q_grid = static_cast<unsigned>(n_q * nq);
  flash_bwd_tf32_dq<D, DV><<<q_grid, kThreads, Mq::kSmem, stream>>>(
      mq, mk, mv, mdo, mkt, static_cast<float*>(o.dq), lse, delta, sh);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const unsigned grid = static_cast<unsigned>(n_q * nk);
  flash_bwd_tf32_dkdv<D, DV, false><<<grid, kThreads, Mv::kSmem, stream>>>(
      mq, mk, mv, mdo, mdot, static_cast<float*>(o.dv), lse, delta, sh);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  flash_bwd_tf32_dkdv<D, DV, true><<<grid, kThreads, Mq::kSmem, stream>>>(
      mq, mk, mv, mdo, mqt, static_cast<float*>(o.dk), lse, delta, sh);
  return cudaGetLastError();
}

template <int D, int DV>
cudaError_t launch(const Operands& o, const Shape& sh, int bf16,
                   cudaStream_t stream) {
  return bf16 ? launch_bf16<D, DV>(o, sh, stream)
              : launch_f32<D, DV>(o, sh, stream);
}

}  // namespace

// q: [batch, hq, s, d], k: [batch, hkv, s, d], v: [batch, hkv, s, dv],
// dout: [batch, hq, s, dv], all float32 (bf16 = 0) or all bf16 (bf16 = 1),
// each with unit stride in its last axis and the element strides of its
// batch, head and sequence axes in strides[0..2] (q), [3..5] (k), [6..8]
// (v), [9..11] (dout); bf16 operands also with a 16-byte-aligned base and
// strides of whole 16-byte units (TMA's rules).  dq: [batch, hq, s, d], dk:
// [batch, hkv, s, d], dv: [batch, hkv, s, dv], contiguous, in the
// operands' type.  scratch: 16-byte aligned, 2 batch hq s64 floats (s64 = s
// rounded up to 64: the logsumexp and Delta), and for float32 the split
// copies after them: 2 (batch hq s (d + dv) + batch hkv s (d + dv)) rows and
// 2 (batch hq (d + dv) + batch hkv d) s8 transposed (s8 = s rounded up to
// 8).  hq % hkv == 0 and (d, dv) one of the ten pairs, or in bf16
// (224, 224).  bf16: three
// launches (dQ, dV, dK); float32: ten (the pre-pass's seven, then the
// same three); returns cudaGetLastError() after them, or the error that
// kept them from launching.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* dout, void* dq,
    void* dk, void* dv, int batch, int hq, int hkv, int s, int d, int dv_dim,
    const void* strides, float scale, int causal, int bf16, void* scratch,
    int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (hkv <= 0 || hq % hkv || s <= 0 || batch <= 0 ||
      static_cast<long long>(batch) * hq > 65535)
    return cudaErrorInvalidValue;
  if (!encode_tiled()) return cudaErrorNotSupported;
  const long long n_q = (s + kBM - 1) / kBM;
  if (n_q * batch * hq > 0x7fffffffLL) return cudaErrorInvalidValue;
  Operands o{q, k, v, dout, dq, dk, dv, static_cast<const long long*>(strides),
             static_cast<float*>(scratch)};
  Shape sh;
  sh.S = s, sh.S64 = static_cast<int>(n_q) * kBM;
  sh.Hq = hq, sh.Hkv = hkv, sh.group = hq / hkv, sh.batch = batch;
  sh.scale = scale, sh.sl2 = scale * kLog2e, sh.causal = causal;
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
#define BWD_CASE(D, DV) \
  if (d == D && dv_dim == DV) return launch<D, DV>(o, sh, bf16, cs);
  BWD_CASE(32, 32)
  BWD_CASE(64, 32)
  BWD_CASE(64, 64)
  BWD_CASE(80, 80)
  BWD_CASE(128, 32)
  BWD_CASE(128, 64)
  BWD_CASE(128, 128)
  BWD_CASE(192, 32)
  BWD_CASE(192, 64)
  BWD_CASE(192, 128)
#undef BWD_CASE
  if (d == 224 && dv_dim == 224)
    return bf16 ? launch_bf16<224, 224>(o, sh, cs) : cudaErrorInvalidValue;
  return cudaErrorInvalidValue;
}
