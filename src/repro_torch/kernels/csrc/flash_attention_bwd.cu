// The gradient of causal or full GQA softmax attention, hand-written CUDA
// C++ for Hopper (sm_90a).  For
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
// bf16_scores=False), whose plain twin is ref.flash_attention_bwd.  All the
// arithmetic is float32: bf16 operands are widened on load and the three
// gradients rounded once, to nearest even, at the store.
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
// What bounds it on an H100: operations.  The least work is five products
// over the live (causal) score pairs, S, dP, dV, dK and dQ: 2 pairs
// (3 D + 2 Dv) FLOPs.  This design does more, 2 pairs (5 D + 4 Dv): the
// pre-pass computes S and dP for the logsumexp and Delta, and the dQ
// kernel recomputes S and dP, so that no block needs another block's
// sums.  At Yi-6B's training shape (B = 4, Hq = 32, Hkv = 4, S = 4096,
// D = Dv = 128, causal: 1.074e9 pairs) that is 1.37 TFLOP least and 2.47
// TFLOP done; on SIMT float32 (67 TFLOP/s) 20.5 ms and 36.9 ms.  The
// tensor cores (wgmma, bf16 or 3xTF32) are the later redesign; this first
// version is the simple one.
//
// Design.  Three kernels, 256 threads a block, tiles of 64 query rows and
// 64 keys, every operand widened into shared memory as float32 rows padded
// to W + 4 floats (so rows start 16 bytes apart modulo 128 and the float4
// reads of 8 lanes at 8 rows meet 8 different bank groups):
//   1. pre-pass, one block per (b, q head, query tile): the row's
//      logsumexp of scale q k^T and Delta, by an online max, sum and
//      P-weighted sum of dP over the key tiles, into a float32 scratch the
//      wrapper allocates.  Recording the logsumexp in the forward kernels
//      instead would save part of this pass; it keeps them, and serving's
//      numbers, as they are;
//   2. dK/dV, one block per (b, KV head, key tile): K and V stay in shared
//      memory; for each query head of the group and each query tile at or
//      after the key tile (causal), it loads Q, dO, the logsumexp and
//      Delta, recomputes S and P = exp(scale S - lse), takes dP = dO V^T
//      and dS = P (dP - Delta), and accumulates dV += P^T dO and dK +=
//      dS^T Q in registers.  The group's sum stays in the block: no
//      atomics, one fixed order, the same bits from run to run;
//   3. dQ, one block per (b, q head, query tile): Q, dO, the logsumexp and
//      Delta stay; over the key tiles at or before it, S, P, dP and dS
//      again, and dQ += dS K in registers.
// Each product is SIMT FFMA from shared memory: a thread owns a 4 x 4
// block of a score tile (rows ti + 16a, columns tj + 16b) or 4 rows by
// float4 column chunks of a gradient tile, and reads both operands as
// float4, one read for 8 FFMAs.  Masked pairs (causal, and the ragged end
// of S) get P = 0, as the reference's -1e30 mask gives them; rows and keys
// past S load as zeros and are never stored.  Shared memory at D = 192,
// Dv = 128: 203 KB for the dK/dV kernel, of the 227 KB a block may have.
// (D, Dv) are template parameters: the ten pairs of the forward kernels.
// Every operand is read through its batch, head and sequence strides
// (unit stride in the last axis), so the model's head-split views go in as
// they are; the gradients are written contiguous.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBM = 64;           // query rows a tile
constexpr int kBN = 64;           // keys a tile
constexpr int kThreads = 256;
constexpr int kLdp = kBN + 4;     // row stride of the P and dS tiles
constexpr float kMasked = -1e30f;  // the reference's mask value

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Row stride, in floats, of a shared tile W values wide.
template <int W>
struct Tile {
  static constexpr int kLd = W + 4;
  static constexpr int kFloats = kBM * kLd;
  static constexpr int kChunks = W / 4;                // float4 columns
  static constexpr int kPerThread = (kChunks + 15) / 16;
};

// rows [row0, row0 + 64) of one (b, h) slice, W values each, widened into
// a shared tile; rows at or past s are zero.
template <int W, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long row_stride, int row0,
                                          int s) {
  for (int idx = threadIdx.x; idx < kBM * W; idx += kThreads) {
    const int r = idx / W, c = idx % W, row = row0 + r;
    dst[r * Tile<W>::kLd + c] =
        row < s ? widen(src[static_cast<long long>(row) * row_stride + c])
                : 0.f;
  }
}

// acc[a][b] += sum_r A[ti + 16a][r] B[tj + 16b][r]: a 64 x 64 score tile
// from two tiles whose rows run along the reduction (q k^T, dO v^T).
template <int R>
__device__ __forceinline__ void product_nt(float (&acc)[4][4],
                                           const float* A, const float* B,
                                           int ti, int tj) {
  constexpr int ld = Tile<R>::kLd;
#pragma unroll 2
  for (int r = 0; r < R; r += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int x = 0; x < 4; ++x)
      a[x] = *reinterpret_cast<const float4*>(A + (ti + 16 * x) * ld + r);
#pragma unroll
    for (int y = 0; y < 4; ++y)
      b[y] = *reinterpret_cast<const float4*>(B + (tj + 16 * y) * ld + r);
#pragma unroll
    for (int x = 0; x < 4; ++x)
#pragma unroll
      for (int y = 0; y < 4; ++y) {
        float t = acc[x][y];
        t = fmaf(a[x].x, b[y].x, t);
        t = fmaf(a[x].y, b[y].y, t);
        t = fmaf(a[x].z, b[y].z, t);
        t = fmaf(a[x].w, b[y].w, t);
        acc[x][y] = t;
      }
  }
}

__device__ __forceinline__ void fma4(float4& acc, float a, const float4& b) {
  acc.x = fmaf(a, b.x, acc.x);
  acc.y = fmaf(a, b.y, acc.y);
  acc.z = fmaf(a, b.z, acc.z);
  acc.w = fmaf(a, b.w, acc.w);
}

// acc[x][k] += sum_i A[i][4 tr + x] B[i][chunk tc + 16k]: a (64 keys) x W
// gradient tile, the reduction over the 64 query rows of the P or dS tile
// A (dV += P^T dO, dK += dS^T q).
template <int W>
__device__ __forceinline__ void product_tn(
    float4 (&acc)[4][Tile<W>::kPerThread], const float* A, const float* B,
    int tr, int tc) {
  constexpr int ld = Tile<W>::kLd;
#pragma unroll 4
  for (int i = 0; i < kBM; ++i) {
    const float4 a = *reinterpret_cast<const float4*>(A + i * kLdp + 4 * tr);
#pragma unroll
    for (int k = 0; k < Tile<W>::kPerThread; ++k) {
      const int c = tc + 16 * k;
      if (c < Tile<W>::kChunks) {
        const float4 b =
            *reinterpret_cast<const float4*>(B + i * ld + 4 * c);
        fma4(acc[0][k], a.x, b);
        fma4(acc[1][k], a.y, b);
        fma4(acc[2][k], a.z, b);
        fma4(acc[3][k], a.w, b);
      }
    }
  }
}

// acc[x][k] += sum_j A[ti + 16x][j] B[j][chunk tc + 16k]: a (64 query rows)
// x W gradient tile, the reduction over the 64 keys of the dS tile A
// (dQ += dS k).
template <int W>
__device__ __forceinline__ void product_nn(
    float4 (&acc)[4][Tile<W>::kPerThread], const float* A, const float* B,
    int ti, int tc) {
  constexpr int ld = Tile<W>::kLd;
#pragma unroll 2
  for (int j = 0; j < kBN; j += 4) {
    float4 a[4];
#pragma unroll
    for (int x = 0; x < 4; ++x)
      a[x] = *reinterpret_cast<const float4*>(A + (ti + 16 * x) * kLdp + j);
#pragma unroll
    for (int k = 0; k < Tile<W>::kPerThread; ++k) {
      const int c = tc + 16 * k;
      if (c < Tile<W>::kChunks) {
        const float4 b0 =
            *reinterpret_cast<const float4*>(B + (j + 0) * ld + 4 * c);
        const float4 b1 =
            *reinterpret_cast<const float4*>(B + (j + 1) * ld + 4 * c);
        const float4 b2 =
            *reinterpret_cast<const float4*>(B + (j + 2) * ld + 4 * c);
        const float4 b3 =
            *reinterpret_cast<const float4*>(B + (j + 3) * ld + 4 * c);
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          fma4(acc[x][k], a[x].x, b0);
          fma4(acc[x][k], a[x].y, b1);
          fma4(acc[x][k], a[x].z, b2);
          fma4(acc[x][k], a[x].w, b3);
        }
      }
    }
  }
}

// The live pairs of a score tile: query q0 + ti + 16a and key k0 + tj + 16b
// both before s, and the key not after the query when causal.
__device__ __forceinline__ bool live(int i, int j, int s, int causal) {
  return i < s && j < s && (!causal || j <= i);
}

// P = exp(scale S - lse) and dS = P (dP - Delta) of a score tile, dS (and,
// if given, P) stored into shared tiles; S and dP are in the registers of
// the product_nt mapping.
__device__ __forceinline__ void scores_to_ds(
    const float (&s_acc)[4][4], const float (&dp_acc)[4][4],
    const float* lse, const float* delta, float scale, int q0, int k0,
    int s, int causal, int ti, int tj, float* p_tile, float* ds_tile) {
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    const int r = ti + 16 * x;
#pragma unroll
    for (int y = 0; y < 4; ++y) {
      const int c = tj + 16 * y;
      const float p = live(q0 + r, k0 + c, s, causal)
                          ? expf(scale * s_acc[x][y] - lse[r])
                          : 0.f;
      if (p_tile) p_tile[r * kLdp + c] = p;
      ds_tile[r * kLdp + c] = p * (dp_acc[x][y] - delta[r]);
    }
  }
}

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int x = 0; x < 4; ++x)
#pragma unroll
    for (int y = 0; y < 4; ++y) acc[x][y] = 0.f;
}

template <int N>
__device__ __forceinline__ void zero(float4 (&acc)[4][N]) {
#pragma unroll
  for (int x = 0; x < 4; ++x)
#pragma unroll
    for (int k = 0; k < N; ++k) acc[x][k] = make_float4(0.f, 0.f, 0.f, 0.f);
}

// rows (row of acc[x]) x float4 chunks of a W-wide gradient tile, times
// ``mul``, into rows [row0, row0 + 64) of a contiguous (rows, W) slice.
template <int W, typename T, int N>
__device__ __forceinline__ void store_rows(const float4 (&acc)[4][N],
                                           T* dst, int row0, int s,
                                           float mul, int row_of_x0,
                                           int row_step, int tc) {
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    const int row = row0 + row_of_x0 + row_step * x;
    if (row >= s) continue;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const int c = tc + 16 * k;
      if (c < Tile<W>::kChunks) {
        T* p = dst + static_cast<long long>(row) * W + 4 * c;
        store(p + 0, acc[x][k].x * mul);
        store(p + 1, acc[x][k].y * mul);
        store(p + 2, acc[x][k].z * mul);
        store(p + 3, acc[x][k].w * mul);
      }
    }
  }
}

struct Args {
  const void *q, *k, *v, *dout;
  void *dq, *dk, *dv;
  long long st[12];     // (batch, head, seq) strides of q, k, v, dO
  int hq, hkv, s, causal;
  float scale;
  float *lse, *delta;   // scratch: batch hq s floats each
};

// 1. The logsumexp of each query row's scaled scores, and Delta =
// sum_j P[i, j] dP[i, j], by one online pass over the key tiles: the row
// max m, l = sum_j exp(scale S - m) and t = sum_j exp(scale S - m) dP,
// both rescaled when m grows; lse = m + log l, Delta = t / l.
template <int D, int DV, typename T>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_prepass(Args args) {
  extern __shared__ __align__(16) float smem[];
  float* q_tile = smem;
  float* do_tile = q_tile + Tile<D>::kFloats;
  float* k_tile = do_tile + Tile<DV>::kFloats;
  float* v_tile = k_tile + Tile<D>::kFloats;
  const int n_tiles = (args.s + kBM - 1) / kBM;
  const int qt = n_tiles - 1 - static_cast<int>(blockIdx.x);
  const int bh = blockIdx.y, b = bh / args.hq, h = bh % args.hq;
  const int hk = h / (args.hq / args.hkv);
  const long long* st = args.st;
  const T* k = static_cast<const T*>(args.k) + b * st[3] + hk * st[4];
  const T* v = static_cast<const T*>(args.v) + b * st[6] + hk * st[7];
  const int q0 = qt * kBM, tid = threadIdx.x;
  const int ti = tid / 16, tj = tid % 16;
  load_tile<D>(q_tile, static_cast<const T*>(args.q) + b * st[0] + h * st[1],
               st[2], q0, args.s);
  load_tile<DV>(do_tile,
                static_cast<const T*>(args.dout) + b * st[9] + h * st[10],
                st[11], q0, args.s);
  float m[4], l[4], t[4];
#pragma unroll
  for (int x = 0; x < 4; ++x) m[x] = kMasked, l[x] = 0.f, t[x] = 0.f;
  const int last = args.causal ? qt : n_tiles - 1;
  for (int kt = 0; kt <= last; ++kt) {
    const int k0 = kt * kBN;
    __syncthreads();
    load_tile<D>(k_tile, k, st[5], k0, args.s);
    load_tile<DV>(v_tile, v, st[8], k0, args.s);
    __syncthreads();
    float s_acc[4][4], dp_acc[4][4];
    zero(s_acc);
    zero(dp_acc);
    product_nt<D>(s_acc, q_tile, k_tile, ti, tj);
    product_nt<DV>(dp_acc, do_tile, v_tile, ti, tj);
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      float sv[4], mx = kMasked;
#pragma unroll
      for (int y = 0; y < 4; ++y) {
        sv[y] = live(q0 + ti + 16 * x, k0 + tj + 16 * y, args.s, args.causal)
                    ? args.scale * s_acc[x][y]
                    : kMasked;
        mx = fmaxf(mx, sv[y]);
      }
      // the 16 lanes of a half-warp share a row
#pragma unroll
      for (int o = 8; o; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[x], mx);
      float sum = 0.f, dot = 0.f;
#pragma unroll
      for (int y = 0; y < 4; ++y) {
        const float e = expf(sv[y] - m_new);
        sum += e;
        dot = fmaf(e, dp_acc[x][y], dot);
      }
#pragma unroll
      for (int o = 8; o; o >>= 1) {
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
        dot += __shfl_xor_sync(0xffffffffu, dot, o);
      }
      const float alpha = expf(m[x] - m_new);
      l[x] = l[x] * alpha + sum;
      t[x] = t[x] * alpha + dot;
      m[x] = m_new;
    }
  }
  if (tj == 0) {
    const long long row_base = static_cast<long long>(bh) * args.s;
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int row = q0 + ti + 16 * x;
      if (row < args.s) {
        args.lse[row_base + row] = m[x] + logf(l[x]);
        args.delta[row_base + row] = t[x] / l[x];
      }
    }
  }
}

// lse and Delta of rows [q0, q0 + 64) into shared memory (0 past s).
__device__ __forceinline__ void load_rows(float* lse, float* delta,
                                          const Args& args, long long base,
                                          int q0) {
  for (int r = threadIdx.x; r < kBM; r += kThreads) {
    const int row = q0 + r;
    lse[r] = row < args.s ? args.lse[base + row] : 0.f;
    delta[r] = row < args.s ? args.delta[base + row] : 0.f;
  }
}

// 2. dK and dV of one key tile of one (b, KV head).
template <int D, int DV, typename T>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkdv(Args args) {
  extern __shared__ __align__(16) float smem[];
  float* k_tile = smem;
  float* v_tile = k_tile + Tile<D>::kFloats;
  float* q_tile = v_tile + Tile<DV>::kFloats;
  float* do_tile = q_tile + Tile<D>::kFloats;
  float* p_tile = do_tile + Tile<DV>::kFloats;
  float* ds_tile = p_tile + kBM * kLdp;
  float* lse = ds_tile + kBM * kLdp;
  float* delta = lse + kBM;
  const int n_tiles = (args.s + kBN - 1) / kBN;
  const int kt = blockIdx.x;           // the longest causal walks first
  const int bh = blockIdx.y, b = bh / args.hkv, hk = bh % args.hkv;
  const int group = args.hq / args.hkv;
  const long long* st = args.st;
  const int k0 = kt * kBN, tid = threadIdx.x;
  const int ti = tid / 16, tj = tid % 16;    // score tiles
  const int tr = tid % 16, tc = tid / 16;    // gradient tiles
  load_tile<D>(k_tile, static_cast<const T*>(args.k) + b * st[3] + hk * st[4],
               st[5], k0, args.s);
  load_tile<DV>(v_tile, static_cast<const T*>(args.v) + b * st[6] + hk * st[7],
                st[8], k0, args.s);
  float4 dk[4][Tile<D>::kPerThread], dv[4][Tile<DV>::kPerThread];
  zero(dk);
  zero(dv);
  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    const T* q = static_cast<const T*>(args.q) + b * st[0] + h * st[1];
    const T* dout = static_cast<const T*>(args.dout) + b * st[9] + h * st[10];
    const long long base = static_cast<long long>(b * args.hq + h) * args.s;
    for (int qt = args.causal ? kt : 0; qt < n_tiles; ++qt) {
      const int q0 = qt * kBM;
      __syncthreads();               // the last tile's readers are done
      load_tile<D>(q_tile, q, st[2], q0, args.s);
      load_tile<DV>(do_tile, dout, st[11], q0, args.s);
      load_rows(lse, delta, args, base, q0);
      __syncthreads();
      float s_acc[4][4], dp_acc[4][4];
      zero(s_acc);
      zero(dp_acc);
      product_nt<D>(s_acc, q_tile, k_tile, ti, tj);
      product_nt<DV>(dp_acc, do_tile, v_tile, ti, tj);
      scores_to_ds(s_acc, dp_acc, lse, delta, args.scale, q0, k0, args.s,
                   args.causal, ti, tj, p_tile, ds_tile);
      __syncthreads();
      product_tn<DV>(dv, p_tile, do_tile, tr, tc);
      product_tn<D>(dk, ds_tile, q_tile, tr, tc);
    }
  }
  const long long kv_base = static_cast<long long>(bh) * args.s;
  store_rows<D>(dk, static_cast<T*>(args.dk) + kv_base * D, k0, args.s,
                args.scale, 4 * tr, 1, tc);
  store_rows<DV>(dv, static_cast<T*>(args.dv) + kv_base * DV, k0, args.s,
                 1.f, 4 * tr, 1, tc);
}

// 3. dQ of one query tile of one (b, q head).
template <int D, int DV, typename T>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq(Args args) {
  extern __shared__ __align__(16) float smem[];
  float* q_tile = smem;
  float* do_tile = q_tile + Tile<D>::kFloats;
  float* k_tile = do_tile + Tile<DV>::kFloats;
  float* v_tile = k_tile + Tile<D>::kFloats;
  float* ds_tile = v_tile + Tile<DV>::kFloats;
  float* lse = ds_tile + kBM * kLdp;
  float* delta = lse + kBM;
  const int n_tiles = (args.s + kBM - 1) / kBM;
  const int qt = n_tiles - 1 - static_cast<int>(blockIdx.x);
  const int bh = blockIdx.y, b = bh / args.hq, h = bh % args.hq;
  const int hk = h / (args.hq / args.hkv);
  const long long* st = args.st;
  const int q0 = qt * kBM, tid = threadIdx.x;
  const int ti = tid / 16, tj = tid % 16;
  const T* k = static_cast<const T*>(args.k) + b * st[3] + hk * st[4];
  const T* v = static_cast<const T*>(args.v) + b * st[6] + hk * st[7];
  load_tile<D>(q_tile, static_cast<const T*>(args.q) + b * st[0] + h * st[1],
               st[2], q0, args.s);
  load_tile<DV>(do_tile,
                static_cast<const T*>(args.dout) + b * st[9] + h * st[10],
                st[11], q0, args.s);
  load_rows(lse, delta, args, static_cast<long long>(bh) * args.s, q0);
  float4 dq[4][Tile<D>::kPerThread];
  zero(dq);
  const int last = args.causal ? qt : n_tiles - 1;
  for (int kt = 0; kt <= last; ++kt) {
    const int k0 = kt * kBN;
    __syncthreads();
    load_tile<D>(k_tile, k, st[5], k0, args.s);
    load_tile<DV>(v_tile, v, st[8], k0, args.s);
    __syncthreads();
    float s_acc[4][4], dp_acc[4][4];
    zero(s_acc);
    zero(dp_acc);
    product_nt<D>(s_acc, q_tile, k_tile, ti, tj);
    product_nt<DV>(dp_acc, do_tile, v_tile, ti, tj);
    scores_to_ds(s_acc, dp_acc, lse, delta, args.scale, q0, k0, args.s,
                 args.causal, ti, tj, nullptr, ds_tile);
    __syncthreads();
    product_nn<D>(dq, ds_tile, k_tile, ti, tj);
  }
  store_rows<D>(dq, static_cast<T*>(args.dq) + static_cast<long long>(bh) *
                                                    args.s * D,
                q0, args.s, args.scale, ti, 16, tj);
}

template <int D, int DV>
struct Smem {
  static constexpr int kPrepass =
      (2 * Tile<D>::kFloats + 2 * Tile<DV>::kFloats) * 4;
  static constexpr int kDkdv =
      (2 * Tile<D>::kFloats + 2 * Tile<DV>::kFloats + 2 * kBM * kLdp +
       2 * kBM) * 4;
  static constexpr int kDq =
      (2 * Tile<D>::kFloats + 2 * Tile<DV>::kFloats + kBM * kLdp + 2 * kBM) *
      4;
};

template <typename K>
cudaError_t allow(K kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int D, int DV, typename T>
cudaError_t launch(const Args& args, int batch, cudaStream_t stream) {
  using M = Smem<D, DV>;
  static_assert(M::kDkdv <= 232448, "dK/dV tiles exceed shared memory");
  const unsigned n_tiles = (args.s + kBM - 1) / kBM;
  const dim3 per_q(n_tiles, batch * args.hq), per_kv(n_tiles,
                                                     batch * args.hkv);
  cudaError_t e;
  if ((e = allow(flash_bwd_prepass<D, DV, T>, M::kPrepass)) != cudaSuccess ||
      (e = allow(flash_bwd_dkdv<D, DV, T>, M::kDkdv)) != cudaSuccess ||
      (e = allow(flash_bwd_dq<D, DV, T>, M::kDq)) != cudaSuccess)
    return e;
  flash_bwd_prepass<D, DV, T><<<per_q, kThreads, M::kPrepass, stream>>>(args);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  flash_bwd_dkdv<D, DV, T><<<per_kv, kThreads, M::kDkdv, stream>>>(args);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  flash_bwd_dq<D, DV, T><<<per_q, kThreads, M::kDq, stream>>>(args);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Args& args, int batch, int d, int dv,
                     cudaStream_t stream) {
#define BWD_CASE(D, DV) \
  if (d == D && dv == DV) return launch<D, DV, T>(args, batch, stream);
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
  return cudaErrorInvalidValue;
}

}  // namespace

// q: [batch, hq, s, d], k: [batch, hkv, s, d], v: [batch, hkv, s, dv],
// dout: [batch, hq, s, dv], all float32 (bf16 = 0) or all bf16 (bf16 = 1),
// each with unit stride in its last axis and the element strides of its
// batch, head and sequence axes in strides[0..2] (q), [3..5] (k), [6..8]
// (v), [9..11] (dout).  dq: [batch, hq, s, d], dk:
// [batch, hkv, s, d], dv: [batch, hkv, s, dv], contiguous, in the
// operands' type.  scratch: 2 batch hq s floats (the logsumexp, then
// Delta).  hq % hkv == 0 and (d, dv) one of the ten pairs.  Three
// launches; returns cudaGetLastError() after them, or the error that kept
// them from launching.
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
  Args args;
  args.q = q, args.k = k, args.v = v, args.dout = dout;
  args.dq = dq, args.dk = dk, args.dv = dv;
  const long long* st = static_cast<const long long*>(strides);
  for (int i = 0; i < 12; ++i) args.st[i] = st[i];
  args.hq = hq, args.hkv = hkv, args.s = s, args.causal = causal;
  args.scale = scale;
  args.lse = static_cast<float*>(scratch);
  args.delta = args.lse + static_cast<long long>(batch) * hq * s;
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch<__nv_bfloat16>(args, batch, d, dv_dim, cs)
              : dispatch<float>(args, batch, d, dv_dim, cs);
}
