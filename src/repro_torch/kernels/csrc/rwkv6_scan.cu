// RWKV-6 (Finch) time-mix recurrence for Hopper (sm_90a), hand-written CUDA
// C++, with a per-head N x N float32 state S:
//
//   o_t[j] = sum_i r_t[i] (S[i,j] + u[i] k_t[i] v_t[j])
//   S[i,j] <- w_t[i] S[i,j] + k_t[i] v_t[j]
//
// Replaces the Pallas TPU kernel src/repro/kernels/rwkv6_scan.py:54
// (rwkv6_scan).  Plain twin: repro_torch.kernels.ref.rwkv6_scan (a Python
// loop over time on float32 state).
//
// What bounds it on an H100 (data-sheet peaks of the SXM part at 700 W):
// bytes, on paper.  At the main path's prefill shape (RWKV-6 7B, 4 prompts
// x 64 heads = 256 rows of state, S = 2000, N = 64) it moves 0.66 GB (r, k,
// v, w read once, o written once, 131 MB each, plus u, s0 and s_fin),
// 0.198 ms at 3.35 TB/s.  The u term factors, sum_i r_i u_i k_i v_j =
// a_t v_j with a_t = sum_i r_i u_i k_i, an O(N) sum a step, so a cell
// (t, i, j) needs three instructions: k_i v_j (a multiply), S <- w S + k v
// (an FMA) and o += r S (an FMA).  That is 6.3 G instructions at the main
// shape, 0.21 ms of issue on 132 SMs x 4 schedulers at 1.755 GHz: as long
// as the bytes take, so in practice the issue slots bind.  A decode step
// (S = 1) only reads s0 and writes s_fin: bytes.
//
// Design.  The TPU kernel walks a sequential time grid and carries S in
// VMEM scratch from one grid step to the next; GPU blocks run in no order,
// so the time loop lives inside the block that owns the state.  One block
// per (b, h) row of state, 2N threads (N / 16 warps), two blocks an SM at
// the main shape:
//   - a thread owns N/8 rows by 4 columns of S in registers (32 cells at
//     N = 64), the warp 8 row groups by 4 column groups: one 16-byte shared
//     load of r, k or w serves 16 cells, and the row groups read
//     neighbouring 16-byte units (rows 4g .. 4g + 3, then 32 + 4g .. ), so
//     no load conflicts on a bank;
//   - four steps at a time, each thread sums its rows' share of o for its
//     4 columns, then a reduce-scatter of shuffles over the 8 row groups
//     leaves one (step, column) sum a lane for two steps: 14 shuffles for
//     the 16 sums.  A thread's local column c is column col0 + (c ^ m), m
//     its row group's low two bits reversed, so that the two column levels
//     keep the same registers in every lane and need no select;
//     o_t[j] = that sum + a_t v_t[j];
//   - r, k, v, w arrive 32 time steps at a time through a 3-stage cp.async
//     ring in shared memory (16-byte copies where every base and stride
//     allows, else 4-byte ones), rows padded to N + 4 floats; one
//     __syncthreads a chunk, and the next chunk loads under this one;
//   - a_t of the next chunk is computed while this one runs: 8 lanes a
//     step, each over its rows (u in registers), then 3 shuffles, into
//     the stage beside the chunk;
//   - S is read from s0 once and written to s_fin once.
// The cells' 96 FP instructions a step a warp (32 cells x 3) are most of
// what the loop issues, the loads, shuffles and addresses the rest;
// variants with 8 columns or 16 row groups a thread, register
// double-buffering of a step's loads, deferred reductions or 16-step
// chunks ran slower on an H100.
// Any S >= 1: the last chunk is shorter, nothing is masked or padded.  The
// inputs are indexed by (b, h, t) strides, so the model's head-split views
// of its (B, S, H, N) projections go in without a copy; u may have a batch
// stride of 0.  IEEE float32 FMAs (no fast math).  The sums run in another
// order than the reference's: per cell fmaf(r, S, acc) and fmaf(w, S, k v),
// per step the u term once (prefill and decode use this kernel alike, so
// they agree with each other).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kL = 32;        // time steps a chunk
constexpr int kStages = 3;    // chunks in the ring
constexpr int kC = 4;         // columns of S a thread

// Element strides of the (b, h, t) axes of r, k, v, w and o (each with unit
// stride in N), then of u's (b, h) axes.
struct Strides {
  long long x[17];
};

// 8 row groups (lane bits 0 .. 2) by N/4 column groups.
template <int N>
struct Shape {
  static_assert(N == 16 || N == 32 || N == 64, "N in {16, 32, 64}");
  static constexpr int kThreads = 8 * N / kC;
  static constexpr int kR = N / 8;              // rows a thread
  static constexpr int kPitch = N + 4;          // floats a staged row
  static constexpr int kArr = kL * kPitch;      // floats an array of a stage
  static constexpr int kStage = 4 * kArr + kL;  // r, k, v, w, then a_t
  static constexpr size_t kSmem = kStages * kStage * sizeof(float);
};

// Row e of row group g, R rows a group: 4g .. 4g + 3, then 32 + 4g ..
// (R = 8), or R g .. R g + R - 1: neighbouring groups read neighbouring
// units, so a load has no bank conflict.
template <int R>
__device__ __forceinline__ int row_of(int g, int e) {
  if constexpr (R > 4) return 32 * (e / 4) + 4 * g + e % 4;
  else return R * g + e;
}

// The values of row group g's rows in one staged row.
template <int R>
__device__ __forceinline__ void rows(const float* row, int g, float (&x)[R]) {
  if constexpr (R >= 4) {
#pragma unroll
    for (int q = 0; q < R / 4; ++q) {
      const float4 f = *reinterpret_cast<const float4*>(
          row + row_of<R>(g, 4 * q));
      x[4 * q] = f.x;
      x[4 * q + 1] = f.y;
      x[4 * q + 2] = f.z;
      x[4 * q + 3] = f.w;
    }
  } else {                             // R = 2
    const float2 f = *reinterpret_cast<const float2*>(row + 2 * g);
    x[0] = f.x;
    x[1] = f.y;
  }
}

__device__ __forceinline__ void cp16(const float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
                  "l"(src) : "memory");
}
__device__ __forceinline__ void cp4(const float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
                  "l"(src) : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Returns once at most n of this thread's copy groups are in flight.
template <int n>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(n) : "memory");
}

template <int N, bool kVec>
__global__ void __launch_bounds__(Shape<N>::kThreads)
rwkv6_fwd(const float* __restrict__ r, const float* __restrict__ k,
          const float* __restrict__ v, const float* __restrict__ w,
          const float* __restrict__ u, const float* __restrict__ s0,
          float* __restrict__ o, float* __restrict__ s_fin, int heads,
          int seq, Strides st) {
  using Sh = Shape<N>;
  constexpr int kT = Sh::kThreads, kR = Sh::kR, kP = Sh::kPitch;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);

  const int bh = blockIdx.x;
  const long long b = bh / heads, h = bh % heads;
  const float* src[4] = {r + b * st.x[0] + h * st.x[1],
                         k + b * st.x[3] + h * st.x[4],
                         v + b * st.x[6] + h * st.x[7],
                         w + b * st.x[9] + h * st.x[10]};
  const long long ts[4] = {st.x[2], st.x[5], st.x[8], st.x[11]};
  float* op = o + b * st.x[12] + h * st.x[13];
  const long long os = st.x[14];
  const float* up = u + b * st.x[15] + h * st.x[16];

  const int tid = threadIdx.x;
  const int g = tid % 8;                         // row group
  const int col0 = kC * (tid / 8);
  // The thread's local column c is column col0 + (c ^ m): with the order
  // turned by the row group's two low bits, the first two levels of the
  // reduce-scatter below keep local columns {0, 1}, then {0}, in every
  // lane, and need no select.
  const int m = 2 * (g & 1) + ((g >> 1) & 1);
  const int n_chunks = (seq + kL - 1) / kL;

  // This thread's copies of a chunk: unit i of each array is time step
  // tt_of[i] of the chunk at column c_of[i]; 16-byte units where kVec,
  // else 4-byte ones.
  constexpr int kW = kVec ? 4 : 1;              // floats a unit
  constexpr int kUnits = kL * N / kW / kT;      // units an array
  int tt_of[kUnits], c_of[kUnits];
#pragma unroll
  for (int i = 0; i < kUnits; ++i) {
    const int x = tid + kT * i;
    tt_of[i] = x / (N / kW);
    c_of[i] = kW * (x % (N / kW));
  }
  // chunk cc into its stage (an empty group past the end keeps the count)
  auto issue = [&](int cc) {
    if (cc < n_chunks) {
      float* stage = smem + (cc % kStages) * Sh::kStage;
      const int t0 = cc * kL, len = min(kL, seq - t0);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
#pragma unroll
        for (int i = 0; i < kUnits; ++i) {
          if (tt_of[i] < len) {
            const float* from = src[a] + (t0 + tt_of[i]) * ts[a] + c_of[i];
            float* to = stage + a * Sh::kArr + tt_of[i] * kP + c_of[i];
            if constexpr (kVec) cp16(to, from);
            else cp4(to, from);
          }
        }
      }
    }
    cp_commit();
  };

  float uu[kR];
#pragma unroll
  for (int e = 0; e < kR; ++e) uu[e] = up[row_of<kR>(g, e)];

  // a_t = sum_i r_i u_i k_i for the steps of chunk cc: 8 lanes a step
  auto u_term = [&](int cc) {
    const float* stage = smem + (cc % kStages) * Sh::kStage;
    float* at = smem + (cc % kStages) * Sh::kStage + 4 * Sh::kArr;
    const int len = min(kL, seq - cc * kL);
    for (int t = tid / 8; t < kL; t += kT / 8) {
      float part = 0.f;
      if (t < len) {
        float rr[kR], kk[kR];
        rows<kR>(stage + t * kP, g, rr);
        rows<kR>(stage + Sh::kArr + t * kP, g, kk);
#pragma unroll
        for (int e = 0; e < kR; ++e) part = fmaf(rr[e], uu[e] * kk[e], part);
      }
#pragma unroll
      for (int bit = 1; bit < 8; bit <<= 1)
        part += __shfl_xor_sync(0xffffffffu, part, bit);
      if (g == 0 && t < len) at[t] = part;
    }
  };

  for (int cc = 0; cc < kStages - 1; ++cc) issue(cc);

  float s[kR][kC];
  const float* sp = s0 + static_cast<long long>(bh) * N * N;
#pragma unroll
  for (int e = 0; e < kR; ++e)
#pragma unroll
    for (int c = 0; c < kC; ++c)
      s[e][c] = sp[row_of<kR>(g, e) * N + col0 + (c ^ m)];

  cp_wait<kStages - 2>();                      // chunk 0 has landed
  __syncthreads();
  u_term(0);

  for (int cc = 0; cc < n_chunks; ++cc) {
    // chunk cc + 1 has landed, a_t of chunk cc is written, and every thread
    // is done with chunk cc - 1, whose stage the next issue refills
    cp_wait<kStages - 3>();
    __syncthreads();
    issue(cc + kStages - 1);
    if (cc + 1 < n_chunks) u_term(cc + 1);

    const float* stage = smem + (cc % kStages) * Sh::kStage;
    const float* at = stage + 4 * Sh::kArr;
    const int t0 = cc * kL, len = min(kL, seq - t0);
    // four steps at a time; a block inside the chunk has no guard, so the
    // loads of one step can move above the products of the one before
    auto four = [&](int tb, bool full) {
      // acc[q][c]: this thread's rows' share of o at step tb + q, local
      // column c
      float acc[4][kC];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int c = 0; c < kC; ++c) acc[q][c] = 0.f;
        if (full || tb + q < len) {
          const int tt = tb + q;
          float rr[kR], kk[kR], ww[kR], vc[kC];
          rows<kR>(stage + tt * kP, g, rr);
          rows<kR>(stage + Sh::kArr + tt * kP, g, kk);
          rows<kR>(stage + 3 * Sh::kArr + tt * kP, g, ww);
          const float* vrow = stage + 2 * Sh::kArr + tt * kP + col0;
#pragma unroll
          for (int c = 0; c < kC; ++c) vc[c] = vrow[c ^ m];
#pragma unroll
          for (int e = 0; e < kR; ++e) {
#pragma unroll
            for (int c = 0; c < kC; ++c) {
              acc[q][c] = fmaf(rr[e], s[e][c], acc[q][c]);
              s[e][c] = fmaf(ww[e], s[e][c], kk[e] * vc[c]);
            }
          }
        }
      }
      // reduce-scatter of the 16 sums over the 8 row groups, a bit of g a
      // level: two levels over local columns (keep {0, 1}, then {0}: the
      // column col0 + m), then one over steps (keep 2 b2, 2 b2 + 1); the
      // shuffles of a level are independent of each other
      float h1[4][2];
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          h1[q][c] = acc[q][c] +
                     __shfl_xor_sync(0xffffffffu, acc[q][c + 2], 1);
      float h2[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        h2[q] = h1[q][0] + __shfl_xor_sync(0xffffffffu, h1[q][1], 2);
      const bool b2 = (g >> 2) & 1;
      const int col = col0 + m;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const float sum = (b2 ? h2[q + 2] : h2[q]) +
                          __shfl_xor_sync(0xffffffffu,
                                          b2 ? h2[q] : h2[q + 2], 4);
        const int tt = tb + 2 * b2 + q;
        if (full || tt < len)
          op[(t0 + tt) * os + col] = fmaf(
              at[tt], stage[2 * Sh::kArr + tt * kP + col], sum);
      }
    };
    int tb = 0;
    for (; tb + 4 <= len; tb += 4) four(tb, true);
    if (tb < len) four(tb, false);
  }

  float* fp = s_fin + static_cast<long long>(bh) * N * N;
#pragma unroll
  for (int e = 0; e < kR; ++e)
#pragma unroll
    for (int c = 0; c < kC; ++c)
      fp[row_of<kR>(g, e) * N + col0 + (c ^ m)] = s[e][c];
}

template <int N>
cudaError_t launch(const float* r, const float* k, const float* v,
                   const float* w, const float* u, const float* s0, float* o,
                   float* s_fin, int batch, int heads, int seq,
                   const Strides& st, cudaStream_t stream) {
  using Sh = Shape<N>;
  // 16-byte copies where every base and (b, h, t) stride of r, k, v, w
  // keeps 16-byte units aligned
  bool vec = true;
  const float* ins[4] = {r, k, v, w};
  for (int a = 0; a < 4; ++a) {
    vec = vec && reinterpret_cast<uintptr_t>(ins[a]) % 16 == 0;
    for (int i = 0; i < 3; ++i) vec = vec && st.x[3 * a + i] % 4 == 0;
  }
  auto kernel = vec ? rwkv6_fwd<N, true> : rwkv6_fwd<N, false>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Sh::kSmem));
  if (e != cudaSuccess) return e;
  kernel<<<batch * heads, Sh::kThreads, Sh::kSmem, stream>>>(
      r, k, v, w, u, s0, o, s_fin, heads, seq, st);
  return cudaGetLastError();
}

}  // namespace

// r, k, v, w, o: [batch, heads, seq, n] float32 with unit stride in n and the
// element strides of their batch, head and time axes in strides[0..14]
// (three each, in that order); u: [batch, heads, n] with its batch and head
// strides in strides[15..16]; s0 and s_fin: [batch * heads, n, n]
// contiguous, s0 only read, s_fin 16-byte aligned.  n in {16, 32, 64},
// seq >= 1, batch * heads < 2^31.  Returns cudaGetLastError() after the
// launch (or the error of the shared-memory attribute).
extern "C" int rwkv6_scan_launch(const void* r, const void* k, const void* v,
                                 const void* w, const void* u, const void* s0,
                                 void* o, void* s_fin, int batch, int heads,
                                 int seq, int n, const void* strides,
                                 int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (batch <= 0 || heads <= 0 || seq <= 0) return cudaErrorInvalidValue;
  Strides st;
  const long long* src = static_cast<const long long*>(strides);
  for (int i = 0; i < 17; ++i) st.x[i] = src[i];
  const float* args[6] = {
      static_cast<const float*>(r), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<const float*>(s0)};
  float* out = static_cast<float*>(o);
  float* fin = static_cast<float*>(s_fin);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 16:
      return launch<16>(args[0], args[1], args[2], args[3], args[4], args[5],
                        out, fin, batch, heads, seq, st, cs);
    case 32:
      return launch<32>(args[0], args[1], args[2], args[3], args[4], args[5],
                        out, fin, batch, heads, seq, st, cs);
    case 64:
      return launch<64>(args[0], args[1], args[2], args[3], args[4], args[5],
                        out, fin, batch, heads, seq, st, cs);
    default:
      return cudaErrorInvalidValue;
  }
}
