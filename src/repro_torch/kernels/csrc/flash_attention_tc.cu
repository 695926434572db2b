// Causal or full GQA softmax attention on bf16 operands, for Hopper's
// tensor cores (sm_90a), hand-written CUDA C++:
//
//   out[b, h, i, :] = sum_j p_ij v[b,h/G,j,:] / sum_j p_ij,
//   p_ij = bf16(exp(scale * q[b,h,i,:] . k[b,h/G,j,:] - m_i))
//
// (G = Hq / Hkv query heads share one KV head; causal keeps j <= i; q and k
// have head dim D, v and out Dv <= D: MLA's 192 / 128.)  The scores are
// float32 products of the bf16 operands and P is rounded to bf16 before
// P V, with the normaliser summing the rounded P: the numerics of the JAX
// package's attend_flash(..., bf16_scores=True), and what the TPU's MXU does
// to the Pallas kernel's float32 jnp.dot(p, v) at default precision.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention for bf16 operands (csrc/flash_attention.cu keeps the
// float32 ones, in IEEE float32 SIMT).  Plain twins:
// repro_torch.kernels.ref.flash_attention, with and without bf16_scores.
//
// What bounds it on an H100: operations.  At the main path's shapes the live
// score pairs need 131 GFLOP (Yi-6B prefill: B=4, Hq=32, Hkv=4, S=2000,
// D=128, causal) and 82 GFLOP (DeepSeek-V2-Lite's MLA: B=4, H=16, S=2000,
// D=192, Dv=128) against 147 MB and 164 MB moved: 890 and 500 FLOP/byte,
// above the card's ridge of 295.  At 989 TFLOP/s bf16 that is 0.133 ms and
// 0.083 ms.  Only wgmma reaches that rate, so both products run there.
//
// Design.  One block owns 128 query rows of one (b, h) and walks the 128-row
// KV tiles; nothing carries across blocks.  Its 288 threads are two consumer
// warpgroups, each owning 64 query rows, and one producer warp:
//   - the producer's first lane issues every copy, by TMA
//     (cp.async.bulk.tensor.4d): Q once, then K and V tiles into a ring of
//     two stages, each with a "full" mbarrier (transaction bytes) and an
//     "empty" one that the 8 consumer warps arrive on when a stage's
//     products have read it.  The tensor maps are rank 4, (D, S, H, B) with
//     the operand's own byte strides, so the model's head-split views go in
//     without a copy and query head h reads KV head h / G in place.  Rows
//     of D are cut into 64-column slabs (32 at D = 32) that TMA lays down
//     with the 128-byte (64-byte) swizzle that wgmma's descriptors name;
//     rows past S arrive as zeros;
//   - S = Q K^T: wgmma.m64n128k16, A (Q) and B (K) both K-major in shared
//     memory, D / 16 instructions into 64 float32 registers a thread;
//   - the online softmax runs on those registers: each quad of lanes owns
//     two rows, keeps their running max m and (per-lane partial) normaliser
//     l in float32, scales by scale * log2 e and takes exp2; only the tiles
//     that cross the diagonal, or the ragged end of S (whose zero-filled
//     keys would score 0, not -inf), are masked, to -1e30 as the reference
//     masks; P is rounded to bf16 in the registers, l sums the rounded
//     values, and the accumulator layout of S is the A-fragment layout of
//     the next product, so P never touches shared memory;
//   - O += P V: wgmma.m64n{Dv}k16 with A = P from registers and B = the V
//     tile in shared memory read MN-major (the transpose flag of 16-bit
//     wgmma), so V is never transposed in memory;
//   - out = O / l, rounded to bf16, stored from the registers.
// When causal, tiles strictly in the future of the block's last query are
// never visited, and query tiles go out longest first (the block index
// walks the (b, h) pairs fastest and the query tiles from the last).  Any
// S >= 1; (D, Dv) are template parameters: the nine pairs with D in
// {32, 64, 128, 192}, Dv in {32, 64, 128}, Dv <= D, Zamba2-2.7B's (80, 80)
// and Zamba2-7B's (224, 224).
// 80 is no whole number of slabs.  Its Q, K and V tiles take two 64-column
// slabs each, whose tensor maps keep the operands' own inner extent of 80,
// so TMA writes zeros into columns 80-127 as it writes zeros into the rows
// past S.  Q K^T runs D / 16 = 5 k-steps, no more than the work needs; P V
// runs the (128, 128) instance's n128 product over V's zero columns (1.6x
// the products of P V) and the epilogue stores the 80 columns that exist.
// Shared memory is Q, two K and two V stages: 160 KB at D = Dv = 128 and
// at 80 / 80, 208 KB at 192 / 128 (plus 1 KB of alignment), so one block an
// SM; ptxas gives 128-168 registers a thread, no spills.  The two warpgroups are not synchronised with each
// other, so one's softmax runs under the other's products as the warp
// schedulers interleave them.  FlashAttention-3's further steps (a
// producer warpgroup with setmaxnreg 24 / 240, S of tile j + 1 issued with
// P V of tile j so that the softmax runs under the warpgroup's own
// products, ping-pong turns between the warpgroups on named barriers)
// gave the same outputs bit for bit but ran slower on an H100 at the two
// main shapes, so they are not in this kernel.
// (224, 224) takes 64-key tiles and one consumer warpgroup.  Its O
// accumulator is 64 rows x 256 columns (224 and TMA's zero columns, as 80
// takes 128), 128 float32 registers a thread: with 128-key tiles (64
// scores, 32 packed P registers) it cannot fit, and with 64 keys and two
// warpgroups ptxas holds a 288-thread block to 168 registers and spilled
// 284 bytes; one warpgroup of 64 query rows and the producer warp (160
// threads) take 209 registers and no spill, and ran 1.80-1.84 ms against
// 2.02 ms at (2, 32, 4096) causal on an H100.  Q K^T is m64n64k16, D / 16
// = 14 k-steps, and P V two m64n128k16 products a k-step, one over each
// half of V's four slabs.  Shared memory: Q 32 KB, two K and two V stages
// of 32 KB each, 160 KB in all.  The float32 kernel
// (csrc/flash_attention.cu) has no 224.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kStages = 2;               // depth of the K/V ring
constexpr float kNegInf = -1e30f;        // the reference's mask value
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory, in bytes from a 1024-aligned base (the swizzle repeats every
// 1024 bytes): Q [slabs][kBM rows][W], then kStages K tiles [slabs][kBN][W]
// and kStages V tiles [v slabs][kBN][Wv], then the mbarriers.  D and Dv are
// the operands' widths; a tile holds them rounded up to whole slabs (kDP,
// kDVP), the columns past them zeros.
template <int D, int DV>
struct Tile {
  static_assert(D % 16 == 0 && DV % 16 == 0 && DV <= D &&
                    (D <= 192 || (D == 224 && DV == 224)),
                "D, Dv in {32, 64, 80, 128, 192}, Dv <= D, or 224 / 224");
  // query rows a block: two consumer warpgroups of 64, or at 224 one
  static constexpr int kBM = D > 192 ? 64 : 128;
  static constexpr int kConsumers = 2 * kBM;         // 128 threads a 64 rows
  static constexpr int kThreads = kConsumers + 32;   // and a producer warp
  static constexpr int kBN = D > 192 ? 64 : 128;     // key rows per tile
  static constexpr int kW = D >= 64 ? 64 : 32;      // q/k columns a slab
  static constexpr int kWv = DV >= 64 ? 64 : 32;    // v columns a slab
  static constexpr int kSlabs = (D + kW - 1) / kW;
  static constexpr int kSlabsV = (DV + kWv - 1) / kWv;
  static constexpr int kDP = kSlabs * kW, kDVP = kSlabsV * kWv;
  static_assert(kDVP == 32 || kDVP == 64 || kDVP == 128 || kDVP == 256,
                "a P V width");
  static constexpr uint32_t kRow = kW * 2, kRowV = kWv * 2;  // slab row bytes
  static constexpr uint32_t kQSlab = kBM * kRow, kKSlab = kBN * kRow;
  static constexpr uint32_t kVSlab = kBN * kRowV;
  static constexpr uint32_t kQBytes = kBM * kDP * 2;
  static constexpr uint32_t kKBytes = kBN * kDP * 2, kVBytes = kBN * kDVP * 2;
  static constexpr uint32_t kK = kQBytes;
  static constexpr uint32_t kV = kK + kStages * kKBytes;
  static constexpr uint32_t kBar = kV + kStages * kVBytes;
  static constexpr size_t kSmem = kBar + 8 * (2 * kStages + 1) + 1024;
  // wgmma descriptor layout types: 1 = 128-byte swizzle, 2 = 64-byte
  static constexpr uint64_t kSwz = kW == 64 ? 1 : 2;
  static constexpr uint64_t kSwzV = kWv == 64 ? 1 : 2;
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

// A wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units), swizzle layout type.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | layout << 62;
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

// wgmma, bf16 in and float32 accumulated.  _ss: A and B from shared memory,
// both K-major; scale_d = 0 overwrites d.  _rs: A (four bf16 pairs a thread)
// from registers, B from shared memory MN-major (transposed), adds to d.

__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                              uint64_t db, int scale_d) {
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
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
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
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
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
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t* a,
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

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t* a,
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

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t* a,
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

// S = Q K^T for one k-step: n64 or n128 keys.
template <int BN>
__device__ __forceinline__ void wgmma_qk(float (&s)[BN / 2], uint64_t da,
                                         uint64_t db, int scale_d) {
  if constexpr (BN == 64) wgmma_ss_n64(s, da, db, scale_d);
  else wgmma_ss_n128(s, da, db, scale_d);
}

template <int DV>
__device__ __forceinline__ void wgmma_pv(float (&o)[DV / 2], const uint32_t* a,
                                         uint64_t db) {
  if constexpr (DV == 32) wgmma_rs_n32(o, a, db);
  else if constexpr (DV == 64) wgmma_rs_n64(o, a, db);
  else wgmma_rs_n128(o, a, db);
}

template <int D, int DV>
__global__ void __launch_bounds__(Tile<D, DV>::kThreads, 1)
flash_tc(const __grid_constant__ CUtensorMap tm_q,
         const __grid_constant__ CUtensorMap tm_k,
         const __grid_constant__ CUtensorMap tm_v,
         __nv_bfloat16* __restrict__ out, int S, int Hq, int group, int n_bh,
         float scale_log2, int causal) {
  using T = Tile<D, DV>;
  constexpr int kBM = T::kBM, kConsumers = T::kConsumers;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base, sk = base + T::kK, sv = base + T::kV;
  const uint32_t full0 = base + T::kBar;             // full[kStages]
  const uint32_t empty0 = full0 + 8 * kStages;       // empty[kStages]
  const uint32_t q_bar = empty0 + 8 * kStages;

  const int tid = threadIdx.x;
  const int n_q = (S + kBM - 1) / kBM;
  const int bh = static_cast<int>(blockIdx.x % n_bh);
  const int q0 = (n_q - 1 - static_cast<int>(blockIdx.x / n_bh)) * kBM;
  const int h = bh % Hq, b = bh / Hq, hk = h / group;
  constexpr int kBN = T::kBN;
  const int n_kv_all = (S + kBN - 1) / kBN;
  // a tile is live iff its first key is not after the block's last query
  const int n_kv = causal ? min(n_kv_all, (q0 + kBM - 1) / kBN + 1)
                          : n_kv_all;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumers / 32);
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {               // the producer warp
    if (tid == kConsumers) {
      mbar_expect_tx(q_bar, T::kQBytes);
      for (int i = 0; i < T::kSlabs; ++i)
        tma_load(sq + i * T::kQSlab, &tm_q, q_bar, i * T::kW, q0, h, b);
      for (int j = 0; j < n_kv; ++j) {
        const int st = j % kStages;
        if (j >= kStages) mbar_wait(empty0 + 8 * st, (j / kStages - 1) & 1);
        const uint32_t full = full0 + 8 * st;
        mbar_expect_tx(full, T::kKBytes + T::kVBytes);
        for (int i = 0; i < T::kSlabs; ++i)
          tma_load(sk + st * T::kKBytes + i * T::kKSlab, &tm_k, full,
                   i * T::kW, j * kBN, hk, b);
        for (int i = 0; i < T::kSlabsV; ++i)
          tma_load(sv + st * T::kVBytes + i * T::kVSlab, &tm_v, full,
                   i * T::kWv, j * kBN, hk, b);
      }
    }
    return;
  }

  // a consumer: warpgroup wg owns tile rows 64 wg .. 64 wg + 63; this
  // thread's accumulator rows are row0 and row0 + 8, its columns
  // 8 i + 2 (lane % 4) + {0, 1}
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int qpos0 = q0 + wg * 64 + warp * 16 + lane / 4, qpos1 = qpos0 + 8;
  const int col = 2 * (lane % 4);
  const uint32_t sq_wg = sq + wg * 64 * T::kRow;

  constexpr int DVP = T::kDVP;           // P V's width, zero columns included
  float o[DVP / 2];
#pragma unroll
  for (int i = 0; i < DVP / 2; ++i) o[i] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  mbar_wait(q_bar, 0);

  for (int j = 0; j < n_kv; ++j) {
    const int st = j % kStages;
    mbar_wait(full0 + 8 * st, (j / kStages) & 1);

    float s[kBN / 2];
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) s[i] = 0.f;
    hold(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      // slab kk / (W/16), then 16 columns (32 bytes) at a time inside it
      const int slab = kk / (T::kW / 16);
      const uint32_t off = (kk % (T::kW / 16)) * 32;
      wgmma_qk<kBN>(
          s,
          smem_desc(sq_wg + slab * T::kQSlab + off, 16, 8 * T::kRow, T::kSwz),
          smem_desc(sk + st * T::kKBytes + slab * T::kKSlab + off, 16,
                    8 * T::kRow, T::kSwz),
          kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    hold(s);

    // online softmax in the log2 domain
    const int k0 = j * kBN;
    const bool edge =
        k0 + kBN > S || (causal && k0 + kBN - 1 > q0 + wg * 64);
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int i = 0; i < kBN / 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[4 * i + e] * scale_log2;
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
    const float alpha0 = exp2f(m0 - mn0), alpha1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;

    // P in bf16, packed as the A fragments of P V: for keys 16 kk .. +15,
    // p[4 kk .. 4 kk + 3] = (row0, cols c), (row0+8, c), (row0, c+8),
    // (row0+8, c+8), each a pair of neighbouring columns
    uint32_t p[kBN / 4];
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int i = 0; i < kBN / 8; ++i) {
      const __nv_bfloat162 lo = __floats2bfloat162_rn(
          exp2f(s[4 * i] - mn0), exp2f(s[4 * i + 1] - mn0));
      const __nv_bfloat162 hi = __floats2bfloat162_rn(
          exp2f(s[4 * i + 2] - mn1), exp2f(s[4 * i + 3] - mn1));
      sum0 += __low2float(lo) + __high2float(lo);
      sum1 += __low2float(hi) + __high2float(hi);
      p[2 * i] = *reinterpret_cast<const uint32_t*>(&lo);
      p[2 * i + 1] = *reinterpret_cast<const uint32_t*>(&hi);
    }
    l0 = l0 * alpha0 + sum0;
    l1 = l1 * alpha1 + sum1;
#pragma unroll
    for (int i = 0; i < DVP / 8; ++i) {
      o[4 * i] *= alpha0;
      o[4 * i + 1] *= alpha0;
      o[4 * i + 2] *= alpha1;
      o[4 * i + 3] *= alpha1;
    }

    hold(o);
    hold(p);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      if constexpr (DVP == 256) {
        // two n128 products, one over each pair of V's slabs
        const uint32_t vrow = sv + st * T::kVBytes + kk * 16 * T::kRowV;
        wgmma_rs_n128(*reinterpret_cast<float(*)[64]>(o), &p[4 * kk],
                      smem_desc(vrow, T::kVSlab, 8 * T::kRowV, T::kSwzV));
        wgmma_rs_n128(*reinterpret_cast<float(*)[64]>(o + 64), &p[4 * kk],
                      smem_desc(vrow + 2 * T::kVSlab, T::kVSlab,
                                8 * T::kRowV, T::kSwzV));
      } else {
        wgmma_pv<DVP>(o, &p[4 * kk],
                      smem_desc(sv + st * T::kVBytes + kk * 16 * T::kRowV,
                                T::kVSlab, 8 * T::kRowV, T::kSwzV));
      }
    }
    wgmma_commit();
    wgmma_wait_all();
    hold(o);
    hold(p);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * st);   // this warp is done
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  __nv_bfloat16* ob = out + (static_cast<int64_t>(b) * Hq + h) * S * DV;
  if (qpos0 < S) {
    __nv_bfloat16* row = ob + static_cast<int64_t>(qpos0) * DV + col;
#pragma unroll
    for (int i = 0; i < DV / 8; ++i)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * i) =
          __floats2bfloat162_rn(o[4 * i] / l0, o[4 * i + 1] / l0);
  }
  if (qpos1 < S) {
    __nv_bfloat16* row = ob + static_cast<int64_t>(qpos1) * DV + col;
#pragma unroll
    for (int i = 0; i < DV / 8; ++i)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * i) =
          __floats2bfloat162_rn(o[4 * i + 2] / l1, o[4 * i + 3] / l1);
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

// The tensor map of a (batch, heads, s, dm) bf16 operand whose batch, head
// and sequence axes have the element strides st[0..2] (each a multiple of
// 8, the base 16-byte aligned: TMA's rules), read in boxes of w columns by
// `rows` rows with the swizzle of a w-column slab.
bool tensor_map(CUtensorMap* map, const void* ptr, int batch, int heads,
                int s, int dm, const long long* st, int w, int rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(dm),
                              static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st[2]) * 2,
                                 static_cast<cuuint64_t>(st[1]) * 2,
                                 static_cast<cuuint64_t>(st[0]) * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(w),
                             static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode_tiled()(
             map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             w == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, int DV>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int batch, int hq, int hkv, int s, const long long* st,
                   float scale, int causal, cudaStream_t stream) {
  using T = Tile<D, DV>;
  CUtensorMap mq, mk, mv;
  if (!encode_tiled()) return cudaErrorNotSupported;
  if (!tensor_map(&mq, q, batch, hq, s, D, st, T::kW, T::kBM) ||
      !tensor_map(&mk, k, batch, hkv, s, D, st + 3, T::kW, T::kBN) ||
      !tensor_map(&mv, v, batch, hkv, s, DV, st + 6, T::kWv, T::kBN))
    return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      flash_tc<D, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(T::kSmem));
  if (e != cudaSuccess) return e;
  const long long blocks =
      static_cast<long long>((s + T::kBM - 1) / T::kBM) * hq * batch;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  flash_tc<D, DV><<<static_cast<unsigned>(blocks), T::kThreads, T::kSmem,
                    stream>>>(mq, mk, mv, static_cast<__nv_bfloat16*>(out), s,
                              hq, hq / hkv, hq * batch, scale * kLog2e,
                              causal);
  return cudaGetLastError();
}

}  // namespace

// q: [batch, hq, s, d], k: [batch, hkv, s, d], v: [batch, hkv, s, dv], all
// bfloat16, each with unit stride in its last axis, a 16-byte-aligned base
// and the element strides of its batch, head and sequence axes (multiples
// of 8) in strides[0..2] (q), [3..5] (k), [6..8] (v); out: [batch, hq, s,
// dv] bfloat16, contiguous.  hq % hkv == 0 and (d, dv) one of the eleven
// pairs.  Returns cudaGetLastError() after the launch, or the error that
// kept it from launching (a tensor map the driver refused: invalid value).
extern "C" int flash_attention_tc_launch(const void* q, const void* k,
                                         const void* v, void* out, int batch,
                                         int hq, int hkv, int s, int d, int dv,
                                         const void* strides, float scale,
                                         int causal, int device,
                                         void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (hkv <= 0 || hq % hkv) return cudaErrorInvalidValue;
  const long long* st = static_cast<const long long*>(strides);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
#define FLASH_TC_CASE(D, DV)                                                \
  if (d == D && dv == DV)                                                   \
    return launch<D, DV>(q, k, v, out, batch, hq, hkv, s, st, scale, causal, \
                         cs);
  FLASH_TC_CASE(32, 32)
  FLASH_TC_CASE(64, 32)
  FLASH_TC_CASE(64, 64)
  FLASH_TC_CASE(80, 80)
  FLASH_TC_CASE(128, 32)
  FLASH_TC_CASE(128, 64)
  FLASH_TC_CASE(128, 128)
  FLASH_TC_CASE(192, 32)
  FLASH_TC_CASE(192, 64)
  FLASH_TC_CASE(192, 128)
  FLASH_TC_CASE(224, 224)
#undef FLASH_TC_CASE
  return cudaErrorInvalidValue;
}
