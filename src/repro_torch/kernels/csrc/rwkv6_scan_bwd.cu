// The gradient of the RWKV-6 (Finch) time-mix recurrence for Hopper
// (sm_90a), hand-written CUDA C++, chunked, its products on the tensor cores
// in 3xTF32.  The forward (csrc/rwkv6_scan.cu), with a per-head N x N float32
// state S, is
//
//   o_t[j] = sum_i r_t[i] (S_{t-1}[i,j] + u_i k_t[i] v_t[j])
//   S_t    = diag(w_t) S_{t-1} + k_t v_t^T
//
// With G_t = dL/dS_t (G_T = ds_fin, 0 when absent), going back from t = T:
//
//   G_{t-1} = diag(w_t) G_t + r_t do_t^T;     ds0 = G_0
//   dr_t = S_{t-1} do_t + u k_t c_t,  dk_t = G_t v_t + u r_t c_t,
//   dv_t = G_t^T k_t + a_t do_t,      dw_t = rowsum(G_t o S_{t-1}),
//   du = sum_t r_t k_t c_t,  c_t = v_t . do_t,  a_t = sum_i u_i r_t[i] k_t[i]
//
// No TPU kernel computes it: the Pallas kernel src/repro/kernels/rwkv6_scan.py
// (:54, pallas_call :64) has no VJP, and the JAX package trains through
// jax.grad of the lax.scan in src/repro/nn/ssm.py (rwkv6_time_mix).  Plain
// twins: repro_torch.kernels.ref.rwkv6_scan_bwd (the sequential reverse
// loop, the oracle) and ref.rwkv6_scan_bwd_chunked (this kernel's algebra,
// step by step).
//
// What bounds it on an H100 (data-sheet peaks of the SXM part at 700 W): at
// the RWKV-6 7B training microbatch (2 x 64 heads = 128 rows of state,
// S = 4096, N = 64) reading r, k, v, w, do once and writing dr, dk, dv, dw
// once is 1.21 GB, 0.36 ms at 3.35 TB/s; the recurrence needs about 14 FLOPs
// a cell-step (t, i, j), 30 GFLOP, which on the tensor cores in 3xTF32, as
// here, are 90 GFLOP of TF32, 0.18 ms at 495 TFLOP/s (0.45 ms at 67 TFLOP/s
// on the float32 pipes): the bound is 0.36 ms, bytes.
//
// Design.  Columns of S and G evolve alone and the decay is diagonal, so a
// run of C steps is a few dense products.  Chunks of C = 64 steps, each cut
// into kNS = 4 sub-chunks of L = 16.  Three launches, no atomics (two calls
// give equal bits):
//
//  1. rwkv6_bwd_bounds, one block a (row of state, direction): the state S
//     before every chunk, from s0, S <- diag(prod w) S + Kt^T V with
//     Kt_s = k_s prod_{m>s} w_m, and G after every chunk, from ds_fin, G <-
//     diag(prod w) G + Rt^T dO with Rt_s = r_s prod_{m<s} w_m (products in
//     the chunk), each a (N x C)(C x N) product a chunk, written to a
//     scratch (2 N^2 floats a chunk: 268 MB at the microbatch).  ds0 is G
//     before chunk 0.  The chunk's inputs arrive through a 2-stage cp.async
//     ring; the walk over the chunks is the only serial chain, 64 steps.
//  2. rwkv6_bwd_chunk, one block a (row of state, chunk): 8192 independent
//     blocks at the microbatch.  The chunk's r, k, v, w, do and its two
//     boundary states go to shared memory (203 KB at N = 64); then, inside,
//     the same updates by sub-chunk give G at each sub-chunk's end (back
//     from the chunk's end) and, forward, the state P before each sub-chunk,
//     and with each sub-chunk's P and G the products Y = dO P^T, Z = V G^T,
//     U = Kh G (Kh_t = k_t prod_{t<m} w_m inside the sub-chunk), M = V dO^T
//     and bb = rowsum(P o G).  What is left lies inside one sub-chunk, in
//     float32 FMAs, a thread a (sub-chunk, row i), with D(s,t) = prod_{s<m<t}
//     w_m a running product (1 for t = s + 1), pre_t = prod_{m<t} w_m and
//     suf_t = prod_{m>t} w_m in the sub-chunk:
//
//       dr_t = pre_t Y_t + sum_{s<t} D(s,t) k_s M[s,t] + u k_t M[t,t]
//       dk_t = suf_t Z_t + sum_{s>t} D(t,s) r_s M[t,s] + u r_t M[t,t]
//       dw_t = pre_t suf_t bb + pre_t sum_{s>t} D(t,s) r_s Y_s
//              + suf_t sum_{s<t} D(s,t) k_s Z_s
//              + sum_{s<t<s'} D(s,t) D(t,s') k_s r_s' M[s,s']
//
//     dw_t's split is G_t = {boundary, in-sub-chunk} times S_{t-1} = {the
//     same}: none of its four parts holds w_t, so no decay is divided out
//     and no logarithm is taken (w = exp(-exp(x)) is exactly 0 in float32
//     for x above about 4.6; every decay factor here is a running product
//     of w).  The last sum runs as Q_t[s'] = sum_{s<t} D(s,t) k_s M[s,s'],
//     Q_{t+1} = w_t Q_t + k_t M[t], whose diagonal Q_t[t] is dr's in-chunk
//     sum.  dv_t = U_t + sum_{s>=t} Bm[s,t] do_s with Bm[s,t] = sum_i
//     D(t,s) r_s k_t for s > t and a_t on the diagonal: a thread a (sub-
//     chunk, t, quarter of the rows), the quarters summed by shuffles.
//     c_t comes from float32 FMAs, not from M's diagonal: du sums it over
//     every step, where the tensor cores' truncation adds up (1.3 x
//     SCAN_TOL at the microbatch on an H100).  du is summed a sub-chunk at
//     a time (Kahan) into one value a chunk.
//  3. rwkv6_bwd_du: du over the chunks in order, compensated (Kahan).
//
// The products: mma.sync.m16n8k8 TF32, 3xTF32 as csrc/flash_attention.cu
// does it: each float32 operand x split into hi = rna_tf32(x) and lo =
// rna_tf32(x - hi), a b taken as lo_a hi_b + hi_a lo_b + hi_a hi_b, every
// product summed from zero on the tensor cores (at most 24 MMAs) and added
// to the state in IEEE float32 FMAs.  mma.sync over wgmma: the operands are
// read straight from shared memory in any layout (rows of the inputs, or
// their transposes for the updates), so no transposed or pre-split copies
// are kept, and the tiles are 16 x 8, the sub-chunk's steps by 8 columns.
// Sizes: L = 16 is one MMA tile of steps, and the cell-by-cell work inside a
// sub-chunk grows as L^2 a row; C = 64 halves the boundary states against
// C = 32 (the scratch, written once and read once) and still fits one
// block's shared memory.  Timed at the microbatch on an H100 (700 W), C = 32
// (110 KB, two blocks an SM) took 1.38 ms in the second launch against
// C = 64's 1.51 ms, but 0.63 ms in the first against 0.41: 2.00 ms in all
// against 1.94.
//
// The design's own count at the microbatch: 28.9 GFLOP of products (8.5 in
// the boundary walk, 20.4 in the chunks), 86.8 GFLOP of TF32 MMAs, 0.18 ms
// at 495 TFLOP/s; 4.3 GFLOP on the float32 pipes inside the sub-chunks,
// 0.07 ms; 2.56 GB moved (the inputs read by both launches, the outputs,
// the boundary states written and read), 0.76 ms at 3.35 TB/s: bytes bound
// this design, at 2.1 x the function's 0.36 ms.
//
// The inputs and gradients are indexed by (b, h, t) strides, so the model's
// head-split views of its (B, S, H, N) projections go in as they are and
// the gradients come out in that memory; u may have a batch stride of 0 (du
// is written per row of state).  No fast math.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kL = 16;              // steps a sub-chunk
constexpr int kNS = 4;              // sub-chunks a chunk
constexpr int kC = kL * kNS;        // steps a chunk
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// Element strides of the (b, h, t) axes of r, k, v, w, do (x[0..14]), of dr,
// dk, dv, dw (x[15..26]), each with unit stride in N, then of u's (b, h)
// axes (x[27..28]).
struct Strides {
  long long x[29];
};

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
// Returns once at most one of this thread's copy groups is in flight.
__device__ __forceinline__ void cp_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
__device__ __forceinline__ void cp_wait0() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Steps t0 .. t0 + kC - 1 of one (b, h) row of N floats each (time stride
// ts) into dst[kC][kP]; steps at or past seq are written as `fill`.
template <int N, int kP, bool kVec>
__device__ __forceinline__ void stage(float* dst, const float* src,
                                      long long ts, int t0, int seq,
                                      float fill, int tid) {
  constexpr int kW = kVec ? 4 : 1;
  constexpr int kPer = N / kW;
  for (int x = tid; x < kC * kPer; x += kThreads) {
    const int tt = x / kPer, c = kW * (x % kPer);
    float* to = dst + tt * kP + c;
    if (t0 + tt < seq) {
      const float* from = src + (t0 + tt) * ts + c;
      if constexpr (kVec) cp16(to, from);
      else cp4(to, from);
    } else {
#pragma unroll
      for (int e = 0; e < kW; ++e) to[e] = fill;
    }
  }
}

// x rounded to TF32 (10 explicit mantissa bits), to nearest with ties away
// from zero, as csrc/flash_attention.cu rounds it.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo to within 2^-22 |x|, both TF32.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma8(float (&d)[4], const uint32_t (&a)[4],
                                     uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[q] += A B_q for NT n-tiles sharing one A, in 3xTF32, by one warp:
// A (16 x K) is A(m, k) = a[m am + k ak], B_q (K x 8) is B_q(k, n) =
// b[k bk + (8 q + n) bn], both in shared memory.  acc[q][e] holds row
// g + 8 (e / 2), column 2 t4 + e % 2 of tile q (g = lane / 4, t4 = lane % 4).
// The tensor cores' float32 accumulation truncates; each small cross term
// goes to an accumulator of its own, added once at the end, so that it does
// not round against the large sum at every step (and each chain of
// dependent MMAs is K / 8 long).
template <int K, int NT>
__device__ __forceinline__ void mma3(float (&acc)[NT][4], const float* a,
                                     int am, int ak, const float* b, int bk,
                                     int bn, int lane) {
  const int g = lane >> 2, t4 = lane & 3;
  float lo_hi[NT][4] = {}, hi_lo[NT][4] = {};
  const float* ap = a + g * am + t4 * ak;
  const float* bp = b + t4 * bk + g * bn;
#pragma unroll
  for (int k0 = 0; k0 < K; k0 += 8) {
    uint32_t ah[4], al[4];
    split(ap[k0 * ak], ah[0], al[0]);
    split(ap[8 * am + k0 * ak], ah[1], al[1]);
    split(ap[(k0 + 4) * ak], ah[2], al[2]);
    split(ap[8 * am + (k0 + 4) * ak], ah[3], al[3]);
#pragma unroll
    for (int q = 0; q < NT; ++q) {
      uint32_t bh0, bl0, bh1, bl1;
      split(bp[k0 * bk + 8 * q * bn], bh0, bl0);
      split(bp[(k0 + 4) * bk + 8 * q * bn], bh1, bl1);
      mma8(lo_hi[q], al, bh0, bh1);
      mma8(hi_lo[q], ah, bl0, bl1);
      mma8(acc[q], ah, bh0, bh1);
    }
  }
#pragma unroll
  for (int q = 0; q < NT; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[q][e] += lo_hi[q][e] + hi_lo[q][e];
}

// An N x N state over the warps: warp w < kGroups holds rows m0 .. m0 + 15
// and kNTW n-tiles of 8 columns from n0.
template <int N>
struct Tiles {
  static_assert(N == 16 || N == 32 || N == 64, "N in {16, 32, 64}");
  static constexpr int kNT = N / 8;
  static constexpr int kNTW = kNT < 4 ? kNT : 4;
  static constexpr int kPerRow = kNT / kNTW;          // warps an m-tile
  static constexpr int kGroups = (N / 16) * kPerRow;
  static_assert(kGroups <= kWarps, "state tiles");
  __device__ static int m0(int warp) { return 16 * (warp / kPerRow); }
  __device__ static int n0(int warp) { return 8 * kNTW * (warp % kPerRow); }
};

// ---------------------------------------------------------------------------
// launch 1: the state before each chunk and G after it
// ---------------------------------------------------------------------------

template <int N>
struct Bounds {
  static constexpr int kP = N + 8;                 // row stride (floats)
  static constexpr int kArr = kC * kP;
  static constexpr int kStage = 3 * kArr;          // x (k or r), w, y (v, do)
  static constexpr int kTP = kThreads / N;         // scan segments a row
  static constexpr int kSeg = kC / kTP;            // steps a segment
  static constexpr size_t kSmem =
      (2 * kStage + N + kThreads) * sizeof(float);
};

template <int N, bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
rwkv6_bwd_bounds(const float* __restrict__ r, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ w,
                 const float* __restrict__ dout,
                 const float* __restrict__ s0,
                 const float* __restrict__ ds_fin, float* __restrict__ ds0,
                 float* __restrict__ states, int heads, int seq,
                 int n_chunks, Strides st) {
  using B = Bounds<N>;
  using T = Tiles<N>;
  constexpr int kP = B::kP;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* decay = smem + 2 * B::kStage;             // [N]
  float* segp = decay + N;                         // [kTP][N]

  const int bh = blockIdx.x;
  const bool back = blockIdx.y == 1;   // G from the end, else S from s0
  const long long b = bh / heads, h = bh % heads;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* xs = back ? r + b * st.x[0] + h * st.x[1]
                         : k + b * st.x[3] + h * st.x[4];
  const long long xt = back ? st.x[2] : st.x[5];
  const float* wsrc = w + b * st.x[9] + h * st.x[10];
  const float* ys = back ? dout + b * st.x[12] + h * st.x[13]
                         : v + b * st.x[6] + h * st.x[7];
  const long long yt = back ? st.x[14] : st.x[8];
  const long long nn = static_cast<long long>(N) * N;
  float* out = states + (back ? static_cast<long long>(gridDim.x) : 0LL) *
                            n_chunks * nn +
               static_cast<long long>(bh) * n_chunks * nn;

  // chunk number it of the walk into stage s; a group is committed either
  // way, so the count stays in step
  auto issue = [&](int it, int s) {
    if (it < n_chunks) {
      const int t0 = (back ? n_chunks - 1 - it : it) * kC;
      float* at = smem + s * B::kStage;
      stage<N, kP, kVec>(at, xs, xt, t0, seq, 0.f, tid);
      stage<N, kP, kVec>(at + B::kArr, wsrc, st.x[11], t0, seq, 1.f, tid);
      stage<N, kP, kVec>(at + 2 * B::kArr, ys, yt, t0, seq, 0.f, tid);
    }
    cp_commit();
  };

  const bool holds = warp < T::kGroups;
  const int g = lane >> 2, t4 = lane & 3;
  const int m0 = T::m0(warp), n0 = T::n0(warp);
  float sv[T::kNTW][4];
  const float* init = back ? ds_fin : s0;
#pragma unroll
  for (int q = 0; q < T::kNTW; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = m0 + g + 8 * (e >> 1), col = n0 + 8 * q + 2 * t4 +
                                                   (e & 1);
      sv[q][e] = holds && init != nullptr ? init[bh * nn + row * N + col]
                                          : 0.f;
    }

  issue(0, 0);
  for (int it = 0; it < n_chunks; ++it) {
    const int c = back ? n_chunks - 1 - it : it;
    issue(it + 1, (it + 1) & 1);
    // this chunk's boundary: S before it, or G after it
    if (holds) {
#pragma unroll
      for (int q = 0; q < T::kNTW; ++q)
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          const int row = m0 + g + 4 * e, col = n0 + 8 * q + 2 * t4;
          *reinterpret_cast<float2*>(out + c * nn + row * N + col) =
              make_float2(sv[q][e], sv[q][e + 1]);
        }
    }
    if (!back && it == n_chunks - 1) {        // the state after S: unused
      cp_wait0();
      break;
    }
    cp_wait1();
    __syncthreads();
    float* xa = smem + (it & 1) * B::kStage;
    const float* wa = xa + B::kArr;
    const float* ya = xa + 2 * B::kArr;
    // x_s times its decay inside the chunk: Rt (prod_{m<s}) going back, Kt
    // (prod_{m>s}) going forward; first in kTP segments of kSeg steps, a
    // thread each, then times the other segments' products
    const int i = tid % N, part = tid / N, lo = part * B::kSeg;
    float run = 1.f;
    if (back) {
      for (int s = lo; s < lo + B::kSeg; ++s) {
        xa[s * kP + i] *= run;
        run *= wa[s * kP + i];
      }
    } else {
      for (int s = lo + B::kSeg - 1; s >= lo; --s) {
        xa[s * kP + i] *= run;
        run *= wa[s * kP + i];
      }
    }
    segp[part * N + i] = run;
    __syncthreads();
    float mult = 1.f, total = 1.f;
#pragma unroll
    for (int q = 0; q < B::kTP; ++q) {
      const float tq = segp[q * N + i];
      total *= tq;
      if (back ? q < part : q > part) mult *= tq;
    }
    for (int s = lo; s < lo + B::kSeg; ++s) xa[s * kP + i] *= mult;
    if (part == 0) decay[i] = total;
    __syncthreads();
    if (holds) {
      float acc[T::kNTW][4] = {};
      // acc(i, j) = sum_s x_s[i] y_s[j]
      mma3<kC, T::kNTW>(acc, xa + m0, 1, kP, ya + n0, kP, 1, lane);
#pragma unroll
      for (int q = 0; q < T::kNTW; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sv[q][e] = fmaf(decay[m0 + g + 8 * (e >> 1)], sv[q][e], acc[q][e]);
    }
    __syncthreads();                  // the stage is free for the next issue
  }
  if (back && ds0 != nullptr && holds) {
#pragma unroll
    for (int q = 0; q < T::kNTW; ++q)
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        const int row = m0 + g + 4 * e, col = n0 + 8 * q + 2 * t4;
        *reinterpret_cast<float2*>(ds0 + bh * nn + row * N + col) =
            make_float2(sv[q][e], sv[q][e + 1]);
      }
  }
}

// ---------------------------------------------------------------------------
// launch 2: one chunk of one row of state
// ---------------------------------------------------------------------------

template <int N>
struct Chunk {
  static constexpr int kP = N + 4;                 // row stride (floats)
  static constexpr int kArr = kC * kP;             // one input, a chunk
  static constexpr int kMat = N * kP;              // one N x N state
  static constexpr int kHat = 5 * kArr;            // after r, k, v, w, do
  static constexpr int kG = kHat + kArr;           // G at each sub-chunk end
  static constexpr int kPs = kG + kNS * kMat;      // the state P
  static constexpr int kM = kPs + kMat;            // M, a sub-chunk each
  static constexpr int kBm = kM + kNS * kL * kL;
  static constexpr int kDec = kBm + kNS * kL * kL;
  static constexpr int kBB = kDec + kNS * N;
  static constexpr int kDu = kBB + kNS * N;
  static constexpr int kCs = kDu + kNS * N;        // c_t = v_t . do_t
  // Y, Z, U of each sub-chunk: in its G slot once G is read, where they fit
  static constexpr bool kInG = 3 * kL <= N;
  static constexpr int kYZU = kCs + kC;
  static constexpr int kTotal = kYZU + (kInG ? 0 : kNS * 3 * kL * kP);
  static constexpr size_t kSmem = kTotal * sizeof(float);
  // the products of a sub-chunk, a job a warp: Y, Z and U in kJP jobs of
  // kJT n-tiles, M in one of 2
  static constexpr int kJT = N / 8 < 4 ? N / 8 : 4;
  static constexpr int kJP = N / 8 / kJT;
  static constexpr int kJobs = 3 * kJP + 1;
  static_assert(kJobs <= kWarps, "one job a warp");
  static_assert(kSmem <= 232448, "shared memory of one block");
  __device__ static float* yzu(float* sm, int q) {
    return kInG ? sm + kG + q * kMat : sm + kYZU + q * 3 * kL * kP;
  }
};

template <int N, bool kVec>
__global__ void __launch_bounds__(kThreads, 1)
rwkv6_bwd_chunk(const float* __restrict__ r, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ w,
                const float* __restrict__ u, const float* __restrict__ dout,
                const float* __restrict__ states, float* __restrict__ dr,
                float* __restrict__ dk, float* __restrict__ dv,
                float* __restrict__ dw, float* __restrict__ du_part,
                int heads, int seq, int n_chunks, Strides st) {
  using C = Chunk<N>;
  using T = Tiles<N>;
  constexpr int kP = C::kP;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* in_r = sm;
  float* in_k = sm + C::kArr;
  float* in_v = sm + 2 * C::kArr;
  float* in_w = sm + 3 * C::kArr;
  float* in_do = sm + 4 * C::kArr;
  float* hat = sm + C::kHat;
  float* ps = sm + C::kPs;
  float* mm = sm + C::kM;
  float* bm = sm + C::kBm;
  float* dec = sm + C::kDec;
  float* bbs = sm + C::kBB;
  float* dus = sm + C::kDu;
  float* cs = sm + C::kCs;
  auto gs = [&](int q) { return sm + C::kG + q * C::kMat; };

  const int c = blockIdx.x % n_chunks, bh = blockIdx.x / n_chunks;
  const long long b = bh / heads, h = bh % heads;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int t0 = c * kC;

  // 0. the chunk's inputs (past S: r, k, v, do 0 and w 1, which leave S
  // and G as they are) and its two boundary states
  {
    const float* src[5] = {r + b * st.x[0] + h * st.x[1],
                           k + b * st.x[3] + h * st.x[4],
                           v + b * st.x[6] + h * st.x[7],
                           w + b * st.x[9] + h * st.x[10],
                           dout + b * st.x[12] + h * st.x[13]};
#pragma unroll
    for (int a = 0; a < 5; ++a)
      stage<N, kP, kVec>(sm + a * C::kArr, src[a], st.x[3 * a + 2], t0, seq,
                         a == 3 ? 1.f : 0.f, tid);
    const long long nn = static_cast<long long>(N) * N;
    const float* s_start = states + (static_cast<long long>(bh) * n_chunks +
                                     c) * nn;
    const float* g_end = s_start + static_cast<long long>(gridDim.x) * nn;
    for (int x = tid; x < N * N / 4; x += kThreads) {
      const int row = x / (N / 4), col = 4 * (x % (N / 4));
      cp16(ps + row * kP + col, s_start + row * N + col);
      cp16(gs(kNS - 1) + row * kP + col, g_end + row * N + col);
    }
    cp_commit();
    cp_wait0();
    __syncthreads();
  }

  // 1. Rh_t = r_t prod_{m<t} w_m in each sub-chunk, and its decay
  for (int x = tid; x < kNS * N; x += kThreads) {
    const int q = x / N, i = x % N;
    float run = 1.f;
#pragma unroll
    for (int tt = q * kL; tt < (q + 1) * kL; ++tt) {
      hat[tt * kP + i] = in_r[tt * kP + i] * run;
      run *= in_w[tt * kP + i];
    }
    dec[q * N + i] = run;
  }
  // c_t = v_t . do_t in IEEE float32 FMAs, 4 lanes a step: du sums it over
  // every step, where the tensor cores' truncation would add up
  for (int x = tid; x < kC * 4; x += kThreads) {
    const int tt = x >> 2, part = x & 3;
    float p = 0.f;
#pragma unroll
    for (int e = 0; e < N / 4; ++e)
      p = fmaf(in_v[tt * kP + part + 4 * e], in_do[tt * kP + part + 4 * e],
               p);
    p += __shfl_xor_sync(0xffffffffu, p, 1);
    p += __shfl_xor_sync(0xffffffffu, p, 2);
    if (part == 0) cs[tt] = p;
  }
  __syncthreads();

  const int m0 = T::m0(warp), n0 = T::n0(warp);
  // 2. G at the end of each sub-chunk, back from the chunk's end
  for (int q = kNS - 1; q > 0; --q) {
    if (warp < T::kGroups) {
      float acc[T::kNTW][4] = {};
      mma3<kL, T::kNTW>(acc, hat + q * kL * kP + m0, 1, kP,
                        in_do + q * kL * kP + n0, kP, 1, lane);
      const float* gq = gs(q);
      float* gp = gs(q - 1);
#pragma unroll
      for (int qq = 0; qq < T::kNTW; ++qq)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = m0 + g + 8 * (e >> 1),
                    col = n0 + 8 * qq + 2 * t4 + (e & 1);
          gp[row * kP + col] = fmaf(dec[q * N + row], gq[row * kP + col],
                                    acc[qq][e]);
        }
    }
    __syncthreads();
  }

  // Kh_t = k_t prod_{m>t} w_m in each sub-chunk, over Rh
  for (int x = tid; x < kNS * N; x += kThreads) {
    const int q = x / N, i = x % N;
    float run = 1.f;
#pragma unroll
    for (int tt = (q + 1) * kL - 1; tt >= q * kL; --tt) {
      hat[tt * kP + i] = in_k[tt * kP + i] * run;
      run *= in_w[tt * kP + i];
    }
  }
  __syncthreads();

  // 3. forward over the sub-chunks with P: Y, Z, U, M, bb, then P's update
  for (int q = 0; q < kNS; ++q) {
    const float* gq = gs(q);
    const int base = q * kL * kP;
    const int prod = warp / C::kJP, nt0 = 8 * C::kJT * (warp % C::kJP);
    float jacc[C::kJT][4] = {};
    if (warp < 3 * C::kJP) {
      if (prod == 0)          // Y[t][i] = sum_j do_t[j] P[i][j]
        mma3<N, C::kJT>(jacc, in_do + base, kP, 1, ps + nt0 * kP, 1, kP,
                        lane);
      else if (prod == 1)     // Z[t][i] = sum_j v_t[j] G[i][j]
        mma3<N, C::kJT>(jacc, in_v + base, kP, 1, gq + nt0 * kP, 1, kP,
                        lane);
      else                    // U[t][j] = sum_i Kh_t[i] G[i][j]
        mma3<N, C::kJT>(jacc, hat + base, kP, 1, gq + nt0, kP, 1, lane);
    } else if (warp == 3 * C::kJP) {   // M[s][t] = v_s . do_t
      float macc[2][4] = {};
      mma3<N, 2>(macc, in_v + base, kP, 1, in_do + base, 1, kP, lane);
#pragma unroll
      for (int qq = 0; qq < 2; ++qq)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          mm[q * kL * kL + (g + 8 * (e >> 1)) * kL + 8 * qq + 2 * t4 +
             (e & 1)] = macc[qq][e];
    }
    float pacc[T::kNTW][4] = {};
    if (q + 1 < kNS && warp < T::kGroups)   // sum_t Kh_t[i] v_t[j]
      mma3<kL, T::kNTW>(pacc, hat + base + m0, 1, kP, in_v + base + n0, kP,
                        1, lane);
    {  // bb[i] = rowsum(P o G), kThreads / N lanes a row
      constexpr int kR = kThreads / N;
      const int i = tid / kR, part = tid % kR;
      float p = 0.f;
#pragma unroll
      for (int e = 0; e < N / kR; ++e) {
        const int col = part + kR * e;
        p = fmaf(ps[i * kP + col], gq[i * kP + col], p);
      }
#pragma unroll
      for (int m = 1; m < kR; m <<= 1)
        p += __shfl_xor_sync(0xffffffffu, p, m);
      if (part == 0) bbs[q * N + i] = p;
    }
    __syncthreads();                   // P and this G are read
    if (warp < 3 * C::kJP) {
      float* dst = C::yzu(sm, q) + prod * kL * kP;
#pragma unroll
      for (int qq = 0; qq < C::kJT; ++qq)
#pragma unroll
        for (int e = 0; e < 4; e += 2)
          *reinterpret_cast<float2*>(dst + (g + 4 * e) * kP + nt0 + 8 * qq +
                                     2 * t4) =
              make_float2(jacc[qq][e], jacc[qq][e + 1]);
    }
    if (q + 1 < kNS && warp < T::kGroups) {
#pragma unroll
      for (int qq = 0; qq < T::kNTW; ++qq)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = m0 + g + 8 * (e >> 1),
                    col = n0 + 8 * qq + 2 * t4 + (e & 1);
          ps[row * kP + col] = fmaf(dec[q * N + row], ps[row * kP + col],
                                    pacc[qq][e]);
        }
    }
    __syncthreads();
  }

  // 4. dr, dk, dw and du inside each sub-chunk: a thread a (sub-chunk, row)
  const float* uu = u + b * st.x[27] + h * st.x[28];
  for (int x = tid; x < kNS * N; x += kThreads) {
    const int q = x / N, i = x % N, base = q * kL;
    const float* yc = C::yzu(sm, q) + i;
    const float* zc = yc + kL * kP;
    const float* mq = mm + q * kL * kL;
    float wv[kL], rv[kL], kv[kL], yv[kL], suf[kL], qv[kL];
#pragma unroll
    for (int tt = 0; tt < kL; ++tt) {
      wv[tt] = in_w[(base + tt) * kP + i];
      rv[tt] = in_r[(base + tt) * kP + i];
      kv[tt] = in_k[(base + tt) * kP + i];
      yv[tt] = yc[tt * kP];
      qv[tt] = 0.f;
    }
    suf[kL - 1] = 1.f;
#pragma unroll
    for (int tt = kL - 2; tt >= 0; --tt) suf[tt] = suf[tt + 1] * wv[tt + 1];
    const float bb = bbs[q * N + i], ui = __ldg(uu + i);
    float* drp = dr + b * st.x[15] + h * st.x[16] + i;
    float* dkp = dk + b * st.x[18] + h * st.x[19] + i;
    float* dwp = dw + b * st.x[24] + h * st.x[25] + i;
    float pre = 1.f, bz = 0.f, du_acc = 0.f, du_lo = 0.f;
#pragma unroll
    for (int t = 0; t < kL; ++t) {
      const float zt = zc[t * kP], ct = cs[base + t];
      const float kt = kv[t], wt = wv[t];
      float om = 1.f, cd = 0.f, ds = 0.f, es = 0.f;
#pragma unroll
      for (int s2 = t + 1; s2 < kL; ++s2) {
        const float m = mq[t * kL + s2];
        const float y = om * rv[s2];           // D(t, s2) r_s2
        cd = fmaf(y, m, cd);
        ds = fmaf(y, yv[s2], ds);
        es = fmaf(y, qv[s2], es);
        qv[s2] = fmaf(wt, qv[s2], kt * m);     // Q_{t+1}
        om *= wv[s2];
      }
      const long long tg = t0 + base + t;
      if (tg < seq) {
        drp[tg * st.x[17]] = fmaf(pre, yv[t], qv[t]) + ui * kt * ct;
        dkp[tg * st.x[20]] = fmaf(suf[t], zt, cd) + ui * rv[t] * ct;
        dwp[tg * st.x[26]] =
            ((pre * suf[t] * bb + pre * ds) + suf[t] * bz) + es;
      }
      const float du_y = rv[t] * kt * ct - du_lo;
      const float du_t = du_acc + du_y;
      du_lo = (du_t - du_acc) - du_y;
      du_acc = du_t;
      bz = fmaf(wt, bz, kt * zt);
      pre *= wt;
    }
    dus[q * N + i] = du_acc;
  }

  // 5. Bm[s][t] = sum_i D(t, s) r_s[i] k_t[i] (s > t), a_t on the diagonal:
  // a thread a (sub-chunk, t, quarter of the rows i = iq + 4 ii)
  for (int x = tid; x < kNS * kL * 4; x += kThreads) {
    const int iq = x & 3, t = (x >> 2) % kL, q = x / (4 * kL);
    const int base = q * kL;
    float part[kL], dg = 0.f;
#pragma unroll
    for (int s2 = 0; s2 < kL; ++s2) part[s2] = 0.f;
    for (int ii = 0; ii < N / 4; ++ii) {
      const int i = iq + 4 * ii;
      const float kt = in_k[(base + t) * kP + i];
      dg = fmaf(__ldg(uu + i) * in_r[(base + t) * kP + i], kt, dg);
      float om = 1.f;
#pragma unroll
      for (int s2 = 1; s2 < kL; ++s2) {
        if (s2 > t) {
          part[s2] = fmaf(om * in_r[(base + s2) * kP + i], kt, part[s2]);
          om *= in_w[(base + s2) * kP + i];
        }
      }
    }
#pragma unroll
    for (int s2 = 0; s2 < kL; ++s2) {
      part[s2] += __shfl_xor_sync(0xffffffffu, part[s2], 1);
      part[s2] += __shfl_xor_sync(0xffffffffu, part[s2], 2);
    }
    dg += __shfl_xor_sync(0xffffffffu, dg, 1);
    dg += __shfl_xor_sync(0xffffffffu, dg, 2);
    if (iq == 0) {
      float* bq = bm + q * kL * kL;
      bq[t * kL + t] = dg;
#pragma unroll
      for (int s2 = 1; s2 < kL; ++s2)
        if (s2 > t) bq[s2 * kL + t] = part[s2];
    }
  }
  __syncthreads();

  // 6. dv_t[j] = U_t[j] + sum_{s>=t} Bm[s][t] do_s[j]; du of the chunk
  for (int x = tid; x < kNS * N; x += kThreads) {
    const int q = x / N, j = x % N, base = q * kL;
    const float* uc = C::yzu(sm, q) + 2 * kL * kP + j;
    const float* bq = bm + q * kL * kL;
    float dov[kL];
#pragma unroll
    for (int s2 = 0; s2 < kL; ++s2) dov[s2] = in_do[(base + s2) * kP + j];
    float* dvp = dv + b * st.x[21] + h * st.x[22] + j;
#pragma unroll
    for (int t = 0; t < kL; ++t) {
      float a = uc[t * kP];
#pragma unroll
      for (int s2 = t; s2 < kL; ++s2) a = fmaf(bq[s2 * kL + t], dov[s2], a);
      const long long tg = t0 + base + t;
      if (tg < seq) dvp[tg * st.x[23]] = a;
    }
  }
  for (int i = tid; i < N; i += kThreads) {
    float s = dus[i];
#pragma unroll
    for (int q = 1; q < kNS; ++q) s += dus[q * N + i];
    du_part[(static_cast<long long>(bh) * n_chunks + c) * N + i] = s;
  }
}

// ---------------------------------------------------------------------------
// launch 3: du over the chunks, in order, compensated
// ---------------------------------------------------------------------------

__global__ void rwkv6_bwd_du(const float* __restrict__ du_part,
                             float* __restrict__ du, long long cells,
                             int n_chunks, int n) {
  const long long x = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (x >= cells) return;
  const long long row = x / n, i = x % n;
  const float* p = du_part + row * n_chunks * n + i;
  float acc = 0.f, lo = 0.f;
  for (int c = 0; c < n_chunks; ++c) {
    const float y = p[static_cast<long long>(c) * n] - lo;
    const float t = acc + y;
    lo = (t - acc) - y;
    acc = t;
  }
  du[x] = acc;
}

long long n_chunks_of(int seq) { return (seq + kC - 1) / kC; }

template <int N>
cudaError_t launch(const float* r, const float* k, const float* v,
                   const float* w, const float* u, const float* s0,
                   const float* dout, const float* ds_fin, float* dr,
                   float* dk, float* dv, float* dw, float* du, float* ds0,
                   float* scratch, int batch, int heads, int seq,
                   const Strides& st, cudaStream_t stream) {
  // 16-byte copies where every base and (b, h, t) stride of r, k, v, w, do
  // keeps 16-byte units aligned
  bool vec = true;
  const float* ins[5] = {r, k, v, w, dout};
  for (int a = 0; a < 5; ++a) {
    vec = vec && reinterpret_cast<uintptr_t>(ins[a]) % 16 == 0;
    for (int x = 0; x < 3; ++x) vec = vec && st.x[3 * a + x] % 4 == 0;
  }
  auto bounds = vec ? rwkv6_bwd_bounds<N, true> : rwkv6_bwd_bounds<N, false>;
  auto chunk = vec ? rwkv6_bwd_chunk<N, true> : rwkv6_bwd_chunk<N, false>;
  cudaError_t e = cudaFuncSetAttribute(
      bounds, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Bounds<N>::kSmem));
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(chunk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(Chunk<N>::kSmem));
  if (e != cudaSuccess) return e;
  const int bh = batch * heads, nc = static_cast<int>(n_chunks_of(seq));
  float* states = scratch;
  float* du_part = scratch + 2LL * bh * nc * N * N;
  bounds<<<dim3(bh, 2), kThreads, Bounds<N>::kSmem, stream>>>(
      r, k, v, w, dout, s0, ds_fin, ds0, states, heads, seq, nc, st);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  chunk<<<bh * nc, kThreads, Chunk<N>::kSmem, stream>>>(
      r, k, v, w, u, dout, states, dr, dk, dv, dw, du_part, heads, seq, nc,
      st);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long long cells = static_cast<long long>(bh) * N;
  rwkv6_bwd_du<<<static_cast<unsigned>((cells + 255) / 256), 256, 0,
                 stream>>>(du_part, du, cells, nc, N);
  return cudaGetLastError();
}

}  // namespace

// r, k, v, w, do (the output's gradient), dr, dk, dv, dw: [batch, heads,
// seq, n] float32 with unit stride in n and the element strides of their
// batch, head and time axes in strides[0..26] (three each, in that order:
// r, k, v, w, do, dr, dk, dv, dw); u: [batch, heads, n] with its batch and
// head strides in strides[27..28]; s0, ds_fin (may be null: 0), ds0 (may be
// null: not written): [batch * heads, n, n] contiguous, ds0 8-byte aligned;
// du: [batch * heads, n] contiguous; scratch: rwkv6_scan_bwd_scratch(batch *
// heads, seq, n) bytes, 16-byte aligned.  n in {16, 32, 64}, seq >= 1,
// batch * heads * ceil(seq / 64) < 2^31.
// Launches three kernels; returns cudaGetLastError() after them (or the
// error of a shared-memory attribute).
extern "C" int rwkv6_scan_bwd_launch(
    const void* r, const void* k, const void* v, const void* w, const void* u,
    const void* s0, const void* dout, const void* ds_fin, void* dr, void* dk,
    void* dv, void* dw, void* du, void* ds0, void* scratch, int batch,
    int heads, int seq, int n, const void* strides, int device,
    void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (batch <= 0 || heads <= 0 || seq <= 0 ||
      static_cast<long long>(batch) * heads * n_chunks_of(seq) >= (1LL << 31))
    return cudaErrorInvalidValue;
  Strides st;
  const long long* from = static_cast<const long long*>(strides);
  for (int x = 0; x < 29; ++x) st.x[x] = from[x];
  const float* in[8] = {
      static_cast<const float*>(r), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<const float*>(dout), static_cast<const float*>(ds_fin)};
  float* out[6] = {static_cast<float*>(dr), static_cast<float*>(dk),
                   static_cast<float*>(dv), static_cast<float*>(dw),
                   static_cast<float*>(du), static_cast<float*>(ds0)};
  float* sc = static_cast<float*>(scratch);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 16:
      return launch<16>(in[0], in[1], in[2], in[3], in[4], in[5], in[6],
                        in[7], out[0], out[1], out[2], out[3], out[4], out[5],
                        sc, batch, heads, seq, st, cs);
    case 32:
      return launch<32>(in[0], in[1], in[2], in[3], in[4], in[5], in[6],
                        in[7], out[0], out[1], out[2], out[3], out[4], out[5],
                        sc, batch, heads, seq, st, cs);
    case 64:
      return launch<64>(in[0], in[1], in[2], in[3], in[4], in[5], in[6],
                        in[7], out[0], out[1], out[2], out[3], out[4], out[5],
                        sc, batch, heads, seq, st, cs);
    default:
      return cudaErrorInvalidValue;
  }
}

// The scratch a call needs, in bytes: the state before and G after every
// chunk of 64 steps (2 n^2 floats), and du's sum in each chunk (n floats),
// for each of `rows` rows of state.
extern "C" long long rwkv6_scan_bwd_scratch(int rows, int seq, int n) {
  return 4LL * rows * n_chunks_of(seq) * (2LL * n * n + n);
}
