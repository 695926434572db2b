// The gradient of the RWKV-6 (Finch) time-mix recurrence for Hopper
// (sm_90a), hand-written CUDA C++.  The forward (csrc/rwkv6_scan.cu), with
// a per-head N x N float32 state S, is
//
//   o_t[j] = sum_i r_t[i] (S_{t-1}[i,j] + u_i k_t[i] v_t[j])
//   S_t    = diag(w_t) S_{t-1} + k_t v_t^T
//
// With G_t = dL/dS_t (G_T = ds_fin, 0 when absent), going back from t = T:
//
//   G_{t-1}[i,j] = w_t[i] G_t[i,j] + r_t[i] do_t[j]
//   dr_t[i] = sum_j S_{t-1}[i,j] do_t[j] + u_i k_t[i] c_t,  c_t = v_t . do_t
//   dk_t[i] = sum_j G_t[i,j] v_t[j]     + u_i r_t[i] c_t
//   dv_t[j] = sum_i G_t[i,j] k_t[i]     + a_t do_t[j],
//             a_t = sum_i u_i r_t[i] k_t[i]
//   dw_t[i] = sum_j G_t[i,j] S_{t-1}[i,j]
//   du[i]   = sum_t r_t[i] k_t[i] c_t;   ds0 = G_0
//
// No TPU kernel computes it: the Pallas kernel src/repro/kernels/rwkv6_scan.py
// (:54, pallas_call :64) has no VJP, and the JAX package trains through
// jax.grad of the lax.scan in src/repro/nn/ssm.py (rwkv6_time_mix).  Plain
// twin: repro_torch.kernels.ref.rwkv6_scan_bwd (the same reverse loop).
//
// What bounds it on an H100 (data-sheet peaks of the SXM part at 700 W): at
// the RWKV-6 7B training microbatch (2 x 64 heads = 128 rows of state,
// S = 4096, N = 64) r, k, v, w and do are read once and dr, dk, dv, dw
// written once, 1.21 GB, 0.36 ms at 3.35 TB/s; a cell-step (t, i, j) needs
// about 14 FLOPs (the four gradient products, G's and S's updates), 30 GFLOP
// over 2.15 G cell-steps, 0.45 ms at 67 TFLOP/s: operations, by a little.
//
// Design, the simple one.  Both S_{t-1} and G_t are needed at each step of
// the walk back, and S_{t-1} is never recovered by dividing by w_t (the
// decay exp(-exp(.)) may underflow).  Every cell (i, j) of S and G evolves
// alone, since the decay is diagonal in i, so any partition of the state
// is exact.  Two kernels, one launch each:
//
//  - rwkv6_bwd_rows: 16 rows of one head's state a block (N / 16 blocks a
//    head: 512 blocks at the microbatch), a thread one row and N / 4
//    columns, 64 threads (columns 16 q + 4 g .. + 3 for column group g, so
//    the four groups' 16-byte shared loads are neighbours).  First a
//    forward pass writes S every 8 steps into a scratch buffer the wrapper
//    allocates (rows x N^2 floats an 8-step chunk: 1.07 GB at the
//    microbatch).  Then the chunks are walked in reverse: each chunk's 8
//    states are recomputed from its checkpoint into shared memory (each
//    thread its own cells, so no barrier), and the 8 steps are walked back
//    with G in registers.  dr, dk and dw sum over j: each thread sums its
//    columns in four chains, then a xor butterfly over the column groups
//    (the low lane bits) gives every lane the row's three sums, and lanes
//    0, 1 and 2 of the group write dr, dk and dw.  du is summed over t in
//    the thread, in order, with Kahan's compensation.  ds0 is G at the
//    end.  43 KB of shared memory a block, 5 blocks an SM.  Of the
//    variants timed at the microbatch on an H100 (cells a thread, steps a
//    chunk): (16, 16) 6.34 ms, (8, 16) 5.91, (4, 16) 6.12, (8, 8) 4.87,
//    this one (16, 8) 4.80, both kernels together: the states' shared
//    memory sets the warps an SM holds.
//  - rwkv6_bwd_cols: one head a block, 4N threads, a thread one column and
//    N / 4 rows (the same interleave).  dv sums over i, the direction that
//    cuts across the rows kernel's blocks; its own walk needs only G, not
//    S, so it runs G's reverse recurrence again (the same fmaf per cell, so
//    the same bits) with no checkpoint, and a butterfly over the 4 row
//    groups adds the partial sums.  No block sums another's partial
//    results, so no atomic and no third pass: two calls give equal bits.
//
// r, k, v, w, do arrive a chunk at a time (8 steps in the rows kernel, 16
// in the cols kernel) through a 2-stage cp.async ring (16-byte copies where
// every base and stride allows, else 4-byte ones);
// c_t and a_t of a chunk are summed by 4 to 16 lanes a step once it lands.
// The inputs and gradients are indexed by (b, h, t) strides, so the model's
// head-split views of its (B, S, H, N) projections go in as they are and
// the gradients come out in that memory; u may have a batch stride of 0 (du
// is written per row of state).  IEEE float32 FMAs, no fast math.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCWMax = 16;       // rows kernel: cells a thread, at most
constexpr int kL = 8;            // rows kernel: steps a chunk, and between
                                 // two checkpoints
constexpr int kLc = 16;          // cols kernel: steps a chunk
constexpr int kRB = 16;          // rows of state a rows block

// Element strides of the (b, h, t) axes of r, k, v, w, do (x[0..14]), of dr,
// dk, dv, dw (x[15..26]), each with unit stride in N, then of u's (b, h)
// axes (x[27..28]).
struct Strides {
  long long x[29];
};

// Element e of group g (N / G elements a group, G groups): 4 G (e / 4) +
// 4 g + e % 4, so the groups' 16-byte units are neighbours.
template <int G>
__device__ __forceinline__ int lane_col(int g, int e) {
  return 4 * G * (e / 4) + 4 * g + e % 4;
}

// Group g's N / G values of one staged row of N floats.
template <int N, int G>
__device__ __forceinline__ void group4(const float* row, int g,
                                       float (&x)[N / G]) {
#pragma unroll
  for (int q = 0; q < N / (4 * G); ++q) {
    const float4 f =
        *reinterpret_cast<const float4*>(row + 4 * (G * q + g));
    x[4 * q] = f.x;
    x[4 * q + 1] = f.y;
    x[4 * q + 2] = f.z;
    x[4 * q + 3] = f.w;
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
// Returns once at most one of this thread's copy groups is in flight.
__device__ __forceinline__ void cp_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Steps t0 .. t0 + len - 1 of kWidth floats each (time stride ts) into
// dst[kSteps][kWidth], by kThreads threads.
template <int kWidth, int kThreads, int kSteps, bool kVec>
__device__ __forceinline__ void stage_steps(float* dst, const float* src,
                                            long long ts, int t0, int len,
                                            int tid) {
  constexpr int kW = kVec ? 4 : 1;
  constexpr int kPer = kWidth / kW;
  for (int x = tid; x < kSteps * kPer; x += kThreads) {
    const int tt = x / kPer, c = kW * (x % kPer);
    if (tt < len) {
      const float* from = src + (t0 + tt) * ts + c;
      float* to = dst + tt * kWidth + c;
      if constexpr (kVec) cp16(to, from);
      else cp4(to, from);
    }
  }
}

__device__ __forceinline__ float sum4(const float (&a)[4]) {
  return (a[0] + a[1]) + (a[2] + a[3]);
}

template <int N>
struct Rows {
  static_assert(N == 16 || N == 32 || N == 64, "N in {16, 32, 64}");
  // columns (cells) a thread, in kQ float4
  static constexpr int kCW = kCWMax < N / 4 ? kCWMax : N / 4;
  static constexpr int kQ = kCW / 4;
  static constexpr int kG = N / kCW;          // column groups, lanes a row
  static constexpr int kT = kRB * kG;         // threads
  static constexpr int kP = kT / kL;          // lanes a step for c_t
  static_assert(kCW % 4 == 0 && kT % kL == 0 && kP <= 32 && N % kP == 0,
                "rows kernel shape");
  static constexpr int kNB = N / kRB;         // blocks a head
  // a stage: R, K, W [kL][kRB] (the block's rows), V, D [kL][N], C [kL]
  static constexpr int kK = kL * kRB, kW = 2 * kL * kRB, kV = 3 * kL * kRB;
  static constexpr int kD = kV + kL * N, kC = kD + kL * N;
  static constexpr int kStage = kC + kL;
  // then the chunk's states, [kL][kQ][kT] float4, each thread its own
  static constexpr size_t kSmem =
      (2 * kStage + kL * kQ * kT * 4) * sizeof(float);
};

template <int N, bool kVec>
__global__ void __launch_bounds__(Rows<N>::kT)
rwkv6_bwd_rows(const float* __restrict__ r, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ w,
               const float* __restrict__ u, const float* __restrict__ s0,
               const float* __restrict__ dout,
               const float* __restrict__ ds_fin, float* __restrict__ dr,
               float* __restrict__ dk, float* __restrict__ dw,
               float* __restrict__ du, float* __restrict__ ds0,
               float4* __restrict__ ckpt, int heads, int seq, Strides st) {
  using Sh = Rows<N>;
  constexpr int kCW = Sh::kCW, kQ = Sh::kQ, kG = Sh::kG, kT = Sh::kT;
  constexpr int kP = Sh::kP;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float4* hist = smem4 + 2 * Sh::kStage / 4;

  const int blk = blockIdx.x;
  const int bh = blk / Sh::kNB, i0 = kRB * (blk % Sh::kNB);
  const long long b = bh / heads, h = bh % heads;
  const int tid = threadIdx.x, cg = tid % kG, row = tid / kG, i = i0 + row;
  // r, k, w from the block's first row; v and do whole rows
  const float* src[5] = {r + b * st.x[0] + h * st.x[1] + i0,
                         k + b * st.x[3] + h * st.x[4] + i0,
                         w + b * st.x[9] + h * st.x[10] + i0,
                         v + b * st.x[6] + h * st.x[7],
                         dout + b * st.x[12] + h * st.x[13]};
  const long long ts[5] = {st.x[2], st.x[5], st.x[11], st.x[8], st.x[14]};
  float* drp = dr + b * st.x[15] + h * st.x[16] + i;
  float* dkp = dk + b * st.x[18] + h * st.x[19] + i;
  float* dwp = dw + b * st.x[24] + h * st.x[25] + i;
  const long long drs = st.x[17], dks = st.x[20], dws = st.x[26];
  const float uu = u[b * st.x[27] + h * st.x[28] + i];
  const int n_chunks = (seq + kL - 1) / kL;
  float4* ck = ckpt + static_cast<long long>(blk) * n_chunks * kQ * kT;

  // chunk cc into stage s: r, k, w, v, do, or (the forward pass) k, w, v;
  // a group is committed either way, so the count stays in step
  auto issue = [&](int cc, int s, bool all) {
    if (cc >= 0 && cc < n_chunks) {
      float* at = smem + s * Sh::kStage;
      const int t0 = cc * kL, len = min(kL, seq - t0);
      if (all)
        stage_steps<kRB, kT, kL, kVec>(at, src[0], ts[0], t0, len, tid);
      stage_steps<kRB, kT, kL, kVec>(at + Sh::kK, src[1], ts[1], t0, len,
                                     tid);
      stage_steps<kRB, kT, kL, kVec>(at + Sh::kW, src[2], ts[2], t0, len,
                                     tid);
      stage_steps<N, kT, kL, kVec>(at + Sh::kV, src[3], ts[3], t0, len, tid);
      if (all)
        stage_steps<N, kT, kL, kVec>(at + Sh::kD, src[4], ts[4], t0, len,
                                     tid);
    }
    cp_commit();
  };

  // the thread's cells of row i: columns lane_col<kG>(cg, e)
  const long long cell0 = (static_cast<long long>(bh) * N + i) * N;
  float s[kCW];
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    const float4 f =
        *reinterpret_cast<const float4*>(s0 + cell0 + 4 * (kG * q + cg));
    s[4 * q] = f.x;
    s[4 * q + 1] = f.y;
    s[4 * q + 2] = f.z;
    s[4 * q + 3] = f.w;
  }

  // forward: S at the start of every chunk into the scratch
  issue(0, 0, false);
  for (int it = 0; it < n_chunks; ++it) {
    issue(it + 1, (it + 1) & 1, false);
    cp_wait1();
    __syncthreads();
    const float* at = smem + (it & 1) * Sh::kStage;
#pragma unroll
    for (int q = 0; q < kQ; ++q)
      ck[(static_cast<long long>(it) * kQ + q) * kT + tid] =
          make_float4(s[4 * q], s[4 * q + 1], s[4 * q + 2], s[4 * q + 3]);
    if (it + 1 < n_chunks) {          // the last chunk's states come later
      for (int tt = 0; tt < kL; ++tt) {
        const float kk = at[Sh::kK + tt * kRB + row];
        const float ww = at[Sh::kW + tt * kRB + row];
        float vv[kCW];
        group4<N, kG>(at + Sh::kV + tt * N, cg, vv);
#pragma unroll
        for (int e = 0; e < kCW; ++e) s[e] = fmaf(ww, s[e], kk * vv[e]);
      }
    }
    __syncthreads();
  }

  // backward: the chunks in reverse
  float g[kCW];
  if (ds_fin != nullptr) {
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      const float4 f = *reinterpret_cast<const float4*>(
          ds_fin + cell0 + 4 * (kG * q + cg));
      g[4 * q] = f.x;
      g[4 * q + 1] = f.y;
      g[4 * q + 2] = f.z;
      g[4 * q + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < kCW; ++e) g[e] = 0.f;
  }
  // du over every step, compensated (Kahan): du_lo carries what each add
  // lost.  A plain float32 sum of 4096 terms of about 8 drifted 0.005 from
  // float64 where the sum cancels, past SCAN_TOL's 3e-4.
  float du_acc = 0.f, du_lo = 0.f;
  issue(n_chunks - 1, 0, true);
  for (int it = 0; it < n_chunks; ++it) {
    const int cc = n_chunks - 1 - it;
    issue(cc - 1, (it + 1) & 1, true);
    cp_wait1();
    __syncthreads();
    float* at = smem + (it & 1) * Sh::kStage;
    const int t0 = cc * kL, len = min(kL, seq - t0);
    {  // c_t = v_t . do_t, kP lanes a step, columns part + kP e
      const int tt = tid / kP, part = tid % kP;
      float p = 0.f;
      if (tt < len) {
#pragma unroll
        for (int e = 0; e < N / kP; ++e)
          p = fmaf(at[Sh::kV + tt * N + part + kP * e],
                   at[Sh::kD + tt * N + part + kP * e], p);
      }
#pragma unroll
      for (int m = 1; m < kP; m <<= 1)
        p += __shfl_xor_sync(0xffffffffu, p, m);
      if (part == 0 && tt < len) at[Sh::kC + tt] = p;
    }
    // the chunk's states S_{t0 + tt} (before step t0 + tt), from its
    // checkpoint
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      const float4 f = ck[(static_cast<long long>(cc) * kQ + q) * kT + tid];
      s[4 * q] = f.x;
      s[4 * q + 1] = f.y;
      s[4 * q + 2] = f.z;
      s[4 * q + 3] = f.w;
    }
    for (int tt = 0; tt < len; ++tt) {
#pragma unroll
      for (int q = 0; q < kQ; ++q)
        hist[(tt * kQ + q) * kT + tid] =
            make_float4(s[4 * q], s[4 * q + 1], s[4 * q + 2], s[4 * q + 3]);
      if (tt + 1 < len) {
        const float kk = at[Sh::kK + tt * kRB + row];
        const float ww = at[Sh::kW + tt * kRB + row];
        float vv[kCW];
        group4<N, kG>(at + Sh::kV + tt * N, cg, vv);
#pragma unroll
        for (int e = 0; e < kCW; ++e) s[e] = fmaf(ww, s[e], kk * vv[e]);
      }
    }
    __syncthreads();                  // every c_t is written
#pragma unroll 2
    for (int tt = len - 1; tt >= 0; --tt) {
      float sp[kCW], vv[kCW], dd[kCW];
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        const float4 f = hist[(tt * kQ + q) * kT + tid];
        sp[4 * q] = f.x;
        sp[4 * q + 1] = f.y;
        sp[4 * q + 2] = f.z;
        sp[4 * q + 3] = f.w;
      }
      group4<N, kG>(at + Sh::kV + tt * N, cg, vv);
      group4<N, kG>(at + Sh::kD + tt * N, cg, dd);
      const float rr = at[tt * kRB + row];
      const float kk = at[Sh::kK + tt * kRB + row];
      const float ww = at[Sh::kW + tt * kRB + row];
      const float ct = at[Sh::kC + tt];
      float a_r[4] = {0.f, 0.f, 0.f, 0.f}, a_k[4] = {0.f, 0.f, 0.f, 0.f},
            a_w[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int e = 0; e < kCW; ++e) {
        a_r[e % 4] = fmaf(sp[e], dd[e], a_r[e % 4]);
        a_k[e % 4] = fmaf(g[e], vv[e], a_k[e % 4]);
        a_w[e % 4] = fmaf(g[e], sp[e], a_w[e % 4]);
        g[e] = fmaf(ww, g[e], rr * dd[e]);
      }
      float p_r = sum4(a_r), p_k = sum4(a_k), p_w = sum4(a_w);
#pragma unroll
      for (int m = 1; m < kG; m <<= 1) {
        p_r += __shfl_xor_sync(0xffffffffu, p_r, m);
        p_k += __shfl_xor_sync(0xffffffffu, p_k, m);
        p_w += __shfl_xor_sync(0xffffffffu, p_w, m);
      }
      const long long t = t0 + tt;
      if (cg == 0) drp[t * drs] = fmaf(uu * kk, ct, p_r);
      else if (cg == 1) dkp[t * dks] = fmaf(uu * rr, ct, p_k);
      else if (cg == 2) dwp[t * dws] = p_w;
      const float du_y = (rr * kk) * ct - du_lo;
      const float du_t = du_acc + du_y;
      du_lo = (du_t - du_acc) - du_y;
      du_acc = du_t;
    }
    __syncthreads();                  // the stage is free for the next issue
  }

  if (ds0 != nullptr) {
#pragma unroll
    for (int q = 0; q < kQ; ++q)
      *reinterpret_cast<float4*>(ds0 + cell0 + 4 * (kG * q + cg)) =
          make_float4(g[4 * q], g[4 * q + 1], g[4 * q + 2], g[4 * q + 3]);
  }
  if (cg == 0) du[static_cast<long long>(bh) * N + i] = du_acc;
}

template <int N>
struct Cols {
  static constexpr int kT = 4 * N;            // N columns x 4 row groups
  static constexpr int kRR = N / 4;           // rows (cells) a thread
  // a stage: R, K, W, D [kLc][N], then A [kLc]
  static constexpr int kK = kLc * N, kW = 2 * kLc * N, kD = 3 * kLc * N;
  static constexpr int kA = 4 * kLc * N;
  static constexpr int kStage = kA + kLc;
  static constexpr size_t kSmem = 2 * kStage * sizeof(float);
};

template <int N, bool kVec>
__global__ void __launch_bounds__(Cols<N>::kT)
rwkv6_bwd_cols(const float* __restrict__ r, const float* __restrict__ k,
               const float* __restrict__ w, const float* __restrict__ u,
               const float* __restrict__ dout,
               const float* __restrict__ ds_fin, float* __restrict__ dv,
               int heads, int seq, Strides st) {
  using Sh = Cols<N>;
  constexpr int kT = Sh::kT, kRR = Sh::kRR, kLanes = N / 4;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);

  const int bh = blockIdx.x;
  const long long b = bh / heads, h = bh % heads;
  const int tid = threadIdx.x, rg = tid & 3, j = tid >> 2;
  const float* src[4] = {r + b * st.x[0] + h * st.x[1],
                         k + b * st.x[3] + h * st.x[4],
                         w + b * st.x[9] + h * st.x[10],
                         dout + b * st.x[12] + h * st.x[13]};
  const long long ts[4] = {st.x[2], st.x[5], st.x[11], st.x[14]};
  float* dvp = dv + b * st.x[21] + h * st.x[22] + j;
  const long long dvs = st.x[23];
  const int n_chunks = (seq + kLc - 1) / kLc;

  auto issue = [&](int cc, int s) {
    if (cc >= 0) {
      float* at = smem + s * Sh::kStage;
      const int t0 = cc * kLc, len = min(kLc, seq - t0);
#pragma unroll
      for (int a = 0; a < 4; ++a)
        stage_steps<N, kT, kLc, kVec>(at + a * kLc * N, src[a], ts[a], t0,
                                      len, tid);
    }
    cp_commit();
  };

  // a_t: kLanes lanes a step (4, 8 or 16, inside one warp), 4 rows each
  const int a_step = tid / kLanes, a_part = tid % kLanes;
  const float* up = u + b * st.x[27] + h * st.x[28] + 4 * a_part;
  const float ua[4] = {up[0], up[1], up[2], up[3]};

  float g[kRR];
#pragma unroll
  for (int e = 0; e < kRR; ++e) g[e] = 0.f;
  if (ds_fin != nullptr) {
    const float* gp = ds_fin + static_cast<long long>(bh) * N * N + j;
#pragma unroll
    for (int e = 0; e < kRR; ++e) g[e] = gp[lane_col<4>(rg, e) * N];
  }

  issue(n_chunks - 1, 0);
  for (int it = 0; it < n_chunks; ++it) {
    const int cc = n_chunks - 1 - it;
    issue(cc - 1, (it + 1) & 1);
    cp_wait1();
    __syncthreads();
    float* at = smem + (it & 1) * Sh::kStage;
    const int t0 = cc * kLc, len = min(kLc, seq - t0);
    {
      float p = 0.f;
      if (a_step < len) {
        const float* rr = at + a_step * N + 4 * a_part;
        const float* kk = at + Sh::kK + a_step * N + 4 * a_part;
#pragma unroll
        for (int e = 0; e < 4; ++e) p = fmaf(rr[e], ua[e] * kk[e], p);
      }
#pragma unroll
      for (int m = 1; m < kLanes; m <<= 1)
        p += __shfl_xor_sync(0xffffffffu, p, m);
      if (a_part == 0 && a_step < len) at[Sh::kA + a_step] = p;
    }
    __syncthreads();
#pragma unroll 2
    for (int tt = len - 1; tt >= 0; --tt) {
      float rr[kRR], kk[kRR], ww[kRR];
      group4<N, 4>(at + tt * N, rg, rr);
      group4<N, 4>(at + Sh::kK + tt * N, rg, kk);
      group4<N, 4>(at + Sh::kW + tt * N, rg, ww);
      const float dj = at[Sh::kD + tt * N + j];
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int e = 0; e < kRR; ++e) {
        acc[e % 4] = fmaf(g[e], kk[e], acc[e % 4]);
        g[e] = fmaf(ww[e], g[e], rr[e] * dj);
      }
      float p = sum4(acc);
      p += __shfl_xor_sync(0xffffffffu, p, 1);
      p += __shfl_xor_sync(0xffffffffu, p, 2);
      if (rg == 0) dvp[(t0 + tt) * dvs] = fmaf(at[Sh::kA + tt], dj, p);
    }
    __syncthreads();
  }
}

template <int N>
cudaError_t launch(const float* r, const float* k, const float* v,
                   const float* w, const float* u, const float* s0,
                   const float* dout, const float* ds_fin, float* dr,
                   float* dk, float* dv, float* dw, float* du, float* ds0,
                   float4* ckpt, int batch, int heads, int seq,
                   const Strides& st, cudaStream_t stream) {
  // 16-byte copies where every base and (b, h, t) stride of r, k, v, w, do
  // keeps 16-byte units aligned (a rows block starts 16 floats further)
  bool vec = true;
  const float* ins[5] = {r, k, v, w, dout};
  for (int a = 0; a < 5; ++a) {
    vec = vec && reinterpret_cast<uintptr_t>(ins[a]) % 16 == 0;
    for (int x = 0; x < 3; ++x) vec = vec && st.x[3 * a + x] % 4 == 0;
  }
  auto rows = vec ? rwkv6_bwd_rows<N, true> : rwkv6_bwd_rows<N, false>;
  auto cols = vec ? rwkv6_bwd_cols<N, true> : rwkv6_bwd_cols<N, false>;
  cudaError_t e = cudaFuncSetAttribute(
      rows, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Rows<N>::kSmem));
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(cols, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(Cols<N>::kSmem));
  if (e != cudaSuccess) return e;
  const int bh = batch * heads;
  rows<<<bh * Rows<N>::kNB, Rows<N>::kT, Rows<N>::kSmem, stream>>>(
      r, k, v, w, u, s0, dout, ds_fin, dr, dk, dw, du, ds0, ckpt, heads, seq,
      st);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  cols<<<bh, Cols<N>::kT, Cols<N>::kSmem, stream>>>(r, k, w, u, dout, ds_fin,
                                                     dv, heads, seq, st);
  return cudaGetLastError();
}

}  // namespace

// r, k, v, w, do (the output's gradient), dr, dk, dv, dw: [batch, heads,
// seq, n] float32 with unit stride in n and the element strides of their
// batch, head and time axes in strides[0..26] (three each, in that order:
// r, k, v, w, do, dr, dk, dv, dw); u: [batch, heads, n] with its batch and
// head strides in strides[27..28]; s0, ds_fin (may be null: 0), ds0 (may be
// null: not written): [batch * heads, n, n] contiguous, 16-byte aligned; du:
// [batch * heads, n] contiguous; ckpt: a scratch of batch * heads * n * n *
// ceil(seq / rwkv6_scan_bwd_chunk()) floats, 16-byte aligned.  n in {16,
// 32, 64}, seq >= 1.
// Launches two kernels; returns cudaGetLastError() after them (or the error
// of a shared-memory attribute).
extern "C" int rwkv6_scan_bwd_launch(
    const void* r, const void* k, const void* v, const void* w, const void* u,
    const void* s0, const void* dout, const void* ds_fin, void* dr, void* dk,
    void* dv, void* dw, void* du, void* ds0, void* ckpt, int batch,
    int heads, int seq, int n, const void* strides, int device,
    void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (batch <= 0 || heads <= 0 || seq <= 0) return cudaErrorInvalidValue;
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
  float4* scratch = static_cast<float4*>(ckpt);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 16:
      return launch<16>(in[0], in[1], in[2], in[3], in[4], in[5], in[6],
                        in[7], out[0], out[1], out[2], out[3], out[4], out[5],
                        scratch, batch, heads, seq, st, cs);
    case 32:
      return launch<32>(in[0], in[1], in[2], in[3], in[4], in[5], in[6],
                        in[7], out[0], out[1], out[2], out[3], out[4], out[5],
                        scratch, batch, heads, seq, st, cs);
    case 64:
      return launch<64>(in[0], in[1], in[2], in[3], in[4], in[5], in[6],
                        in[7], out[0], out[1], out[2], out[3], out[4], out[5],
                        scratch, batch, heads, seq, st, cs);
    default:
      return cudaErrorInvalidValue;
  }
}

// The steps between two checkpoints of the state, which sets the size of
// the scratch: batch * heads * n * n * ceil(seq / chunk) floats.
extern "C" int rwkv6_scan_bwd_chunk() { return kL; }
