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
// bytes.  At the main path's prefill shape (RWKV-6 7B, 4 prompts x 64 heads
// = 256 rows of state, S = 2000, N = 64) it moves 0.66 GB (r, k, v, w read
// once, o written once, 131 MB each, plus u, s0 and s_fin), 0.198 ms at
// 3.35 TB/s.  The recurrence needs 5 FLOPs for each (t, i, j): the u term
// factors, sum_i r_i u_i k_i v_j = v_j sum_i r_i u_i k_i, an O(N) sum a
// step, leaving S <- w S + k v (a multiply and an FMA) and o += r S (an
// FMA); 10.5 GFLOP, 0.157 ms at 67 TFLOP/s float32.  This kernel spends 7
// (a multiply and three FMAs: it keeps the reference's per-cell order),
// 14.7 GFLOP, 0.219 ms, more than the bytes take.  A decode step (S = 1)
// only reads s0 and writes s_fin: bytes.
//
// Design (simple and right first).  The TPU kernel walks a sequential time
// grid and carries S in VMEM scratch from one grid step to the next; GPU
// blocks run in no order, so the time loop lives inside the block that owns
// the state.  One block per (b, h) row of state.  Columns of S are
// independent of each other (column j sees only v_t[j] and the shared r_t,
// k_t, w_t, u), so no reduction crosses blocks and nothing is atomic:
//   - N / 16 threads own each column j, each 16 of its rows, in registers
//     (with u for those rows); the sum over i for o_t[j] is four partial
//     sums in each thread, then a butterfly of shuffles across the column's
//     threads.  The threads of one column sit C = 32 / (N/16) lanes apart,
//     so every quarter-warp reads one address of r, k and w (a broadcast);
//   - r, k, v, w of 32 time steps at a time are staged in shared memory,
//     with coalesced loads, and shared by every thread of the block;
//   - S is read from s0 once and written to s_fin once; o_t[j] is stored
//     by the column's first thread as it is made.
// Any S >= 1: the last chunk is shorter, nothing is masked or padded.  The
// inputs are indexed by (b, h, t) strides, so the model's head-split views
// of its (B, S, H, N) projections go in without a copy; u may have a batch
// stride of 0.  IEEE float32 throughout (fmaf, no fast math), in the
// reference's order per i: kv = k v, then r (S + u kv), then w S + kv.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 16;    // rows of a state column each thread owns
constexpr int kChunk = 32;   // time steps staged in shared memory at a time

// Element strides of the (b, h, t) axes of r, k, v, w and o (each with unit
// stride in N), then of u's (b, h) axes.
struct Strides {
  long long x[17];
};

__device__ __forceinline__ void cell(float r, float k, float w, float u,
                                     float vj, float& s, float& acc) {
  const float kv = k * vj;
  acc = fmaf(r, fmaf(u, kv, s), acc);
  s = fmaf(w, s, kv);
}

template <int N>
__global__ void __launch_bounds__(N * N / kRows)
rwkv6_fwd(const float* __restrict__ r, const float* __restrict__ k,
          const float* __restrict__ v, const float* __restrict__ w,
          const float* __restrict__ u, const float* __restrict__ s0,
          float* __restrict__ o, float* __restrict__ s_fin, int heads,
          int seq, Strides st) {
  constexpr int kThreads = N * N / kRows;
  constexpr int kC = 32 / (N / kRows);     // columns per warp
  static_assert(N % kRows == 0 && 32 % (N / kRows) == 0, "N in {16,32,64}");
  __shared__ __align__(16) float sr[kChunk][N];
  __shared__ __align__(16) float sk[kChunk][N];
  __shared__ __align__(16) float sv[kChunk][N];
  __shared__ __align__(16) float sw[kChunk][N];

  const int bh = blockIdx.x;
  const long long b = bh / heads, h = bh % heads;
  const float* rp = r + b * st.x[0] + h * st.x[1];
  const float* kp = k + b * st.x[3] + h * st.x[4];
  const float* vp = v + b * st.x[6] + h * st.x[7];
  const float* wp = w + b * st.x[9] + h * st.x[10];
  float* op = o + b * st.x[12] + h * st.x[13];
  const float* up = u + b * st.x[15] + h * st.x[16];
  const long long rs = st.x[2], ks = st.x[5], vs = st.x[8], ws = st.x[11],
                  os = st.x[14];

  const int lane = threadIdx.x & 31;
  const int q = lane / kC;                          // rows q*16 .. q*16+15
  const int j = (threadIdx.x >> 5) * kC + lane % kC;  // the column
  const int row0 = q * kRows;

  float s[kRows], uu[kRows];
  const float* sp = s0 + static_cast<long long>(bh) * N * N;
#pragma unroll
  for (int ii = 0; ii < kRows; ++ii) {
    s[ii] = sp[(row0 + ii) * N + j];
    uu[ii] = up[row0 + ii];
  }

  for (int t0 = 0; t0 < seq; t0 += kChunk) {
    const int len = min(kChunk, seq - t0);
    __syncthreads();                       // the last chunk is consumed
    for (int e = threadIdx.x; e < len * N; e += kThreads) {
      const int tt = e / N, n = e % N;
      const long long t = t0 + tt;
      sr[tt][n] = rp[t * rs + n];
      sk[tt][n] = kp[t * ks + n];
      sv[tt][n] = vp[t * vs + n];
      sw[tt][n] = wp[t * ws + n];
    }
    __syncthreads();
    for (int tt = 0; tt < len; ++tt) {
      const float vj = sv[tt][j];
      const float4* r4 = reinterpret_cast<const float4*>(&sr[tt][row0]);
      const float4* k4 = reinterpret_cast<const float4*>(&sk[tt][row0]);
      const float4* w4 = reinterpret_cast<const float4*>(&sw[tt][row0]);
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int c = 0; c < kRows / 4; ++c) {
        const float4 rr = r4[c], kk = k4[c], ww = w4[c];
        cell(rr.x, kk.x, ww.x, uu[4 * c + 0], vj, s[4 * c + 0], acc[0]);
        cell(rr.y, kk.y, ww.y, uu[4 * c + 1], vj, s[4 * c + 1], acc[1]);
        cell(rr.z, kk.z, ww.z, uu[4 * c + 2], vj, s[4 * c + 2], acc[2]);
        cell(rr.w, kk.w, ww.w, uu[4 * c + 3], vj, s[4 * c + 3], acc[3]);
      }
      float out = (acc[0] + acc[1]) + (acc[2] + acc[3]);
#pragma unroll
      for (int off = kC; off < 32; off <<= 1)
        out += __shfl_xor_sync(0xffffffffu, out, off);
      if (q == 0) op[(t0 + tt) * os + j] = out;
    }
  }

  float* fp = s_fin + static_cast<long long>(bh) * N * N;
#pragma unroll
  for (int ii = 0; ii < kRows; ++ii) fp[(row0 + ii) * N + j] = s[ii];
}

template <int N>
cudaError_t launch(const float* r, const float* k, const float* v,
                   const float* w, const float* u, const float* s0, float* o,
                   float* s_fin, int batch, int heads, int seq,
                   const Strides& st, cudaStream_t stream) {
  rwkv6_fwd<N><<<batch * heads, N * N / kRows, 0, stream>>>(
      r, k, v, w, u, s0, o, s_fin, heads, seq, st);
  return cudaGetLastError();
}

}  // namespace

// r, k, v, w, o: [batch, heads, seq, n] float32 with unit stride in n and the
// element strides of their batch, head and time axes in strides[0..14]
// (three each, in that order); u: [batch, heads, n] with its batch and head
// strides in strides[15..16]; s0 and s_fin: [batch * heads, n, n]
// contiguous, s0 only read.  n in {16, 32, 64}, seq >= 1,
// batch * heads < 2^31.  Returns cudaGetLastError() after the launch.
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
