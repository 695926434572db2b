// Causal or full GQA softmax attention with an online softmax on float32
// operands, for Hopper (sm_90a), hand-written CUDA C++:
//
//   out[b, h, i, :] = sum_j softmax_j(scale * q[b,h,i,:] . k[b,h/G,j,:]) v[b,h/G,j,:]
//
// (G = Hq / Hkv query heads share one KV head; causal keeps j <= i.  q and
// k have head dim D, v and out Dv <= D: MLA's 192 / 128.)
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention for float32 operands; bf16 operands go to
// csrc/flash_attention_tc.cu, on the tensor cores.  Plain twin:
// repro_torch.kernels.ref.flash_attention (repeat K/V, float32 logits,
// -1e30 mask, softmax, cast to q's type).
//
// Why IEEE float32 SIMT and not the tensor cores: this path is what the
// serving checks hold prefill against decode with in float32, at 1e-4 on
// the logits of a 32-layer model; TF32 keeps about three decimal digits and
// cannot meet that.  So it is bounded by the card's 67 TFLOP/s float32: the
// Yi-6B prefill's live score pairs (B=4, Hq=32, Hkv=4, S=2000, D=128,
// causal) need about 131 GFLOP against 295 MB moved, 1.96 ms at that rate.
//
// Design (simple and right first).  One block of 256 threads owns one
// (b, h, 64-row query tile) and loops over 64-row KV tiles; nothing carries
// across blocks.  Inside the block, everything is float32 FMAs from shared
// memory:
//   - Q^T is staged once; each KV tile stages K^T, the block forms the
//     64x64 score tile (each thread a 4x4 register tile), scales it, and
//     masks future keys (causal) and keys past a ragged S to -1e30;
//   - four threads own each query row's running max m (from -1e30) and
//     normaliser l (from 0) in registers, turn the scores into p = exp(s - m)
//     in place and publish the rescale factor alpha = exp(m_old - m_new);
//   - V replaces K^T in the same buffer, and each thread updates its
//     4 x Dv/16 slice of the float32 accumulator: acc = acc * alpha + P V.
// When causal, KV tiles strictly in the future of the whole query tile are
// never visited (skipped, not masked), and query tiles are scheduled
// longest first.  Query head h reads KV head h / G in place: K/V are never
// repeated in memory.  The output is acc / l.  Ragged S is masked, not
// refused.  D (32, 64, 128, 192) and Dv (32, 64, 128, at most D) are
// template parameters, so P V costs Dv, not D, columns and v is never
// padded.  Shared memory at D = 128 is 83.7 KB (two blocks an SM); at
// D = 192, Dv = 128 it is 117.0 KB (one block an SM).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;                // query rows per block
constexpr int kBK = 64;                // key rows per tile
constexpr int kThreads = 256;          // 16 x 16
constexpr int kTR = kBQ / 16;          // rows of S and O per thread
constexpr int kTC = kBK / 16;          // columns of S per thread
constexpr float kNegInf = -1e30f;      // the reference's mask value

// Shared memory, in floats: Q^T [D][kBQ+1], the K^T [D][kBK+1] / V [kBK][Dv]
// buffer, S/P [kBQ][kBK+1], alpha [kBQ] and l [kBQ].  The +1 pads keep the
// transposed stores and the row-wise softmax off a single bank.
template <int D, int DV>
struct Layout {
  static constexpr int kQt = D * (kBQ + 1);
  static constexpr int kKV =
      D * (kBK + 1) > kBK * DV ? D * (kBK + 1) : kBK * DV;
  static constexpr int kS = kBQ * (kBK + 1);
  static constexpr size_t kBytes = (kQt + kKV + kS + 2 * kBQ) * sizeof(float);
};

template <int D, int DV>
__global__ void __launch_bounds__(kThreads)
flash_fwd(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, float* __restrict__ out, int S, int Hq,
          int group, int64_t q_b, int64_t q_h, int64_t q_s, int64_t k_b,
          int64_t k_h, int64_t k_s, int64_t v_b, int64_t v_h, int64_t v_s,
          float scale, int causal) {
  static_assert(D % 16 == 0 && DV % 16 == 0 && DV <= D,
                "D and DV multiples of 16, DV <= D");
  constexpr int kTD = DV / 16;         // columns of O per thread
  extern __shared__ float smem[];
  float* qt = smem;
  float* kv = qt + Layout<D, DV>::kQt;
  float* ss = kv + Layout<D, DV>::kKV;
  float* alpha_s = ss + Layout<D, DV>::kS;
  float* l_s = alpha_s + kBQ;

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int n_q = (S + kBQ - 1) / kBQ;
  const int q0 = (n_q - 1 - static_cast<int>(blockIdx.x)) * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / group;
  const float* qb = q + b * q_b + h * q_h;
  const float* kb = k + b * k_b + hk * k_h;
  const float* vb = v + b * v_b + hk * v_h;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D, d = e % D;
    const int pos = q0 + r;
    qt[d * (kBQ + 1) + r] = pos < S ? qb[pos * q_s + d] : 0.f;
  }

  // the softmax phase: threads 4r .. 4r+3 own query row r of the tile
  const int srow = tid >> 2, spart = tid & 3;
  constexpr int kSpan = kBK / 4;
  float m_run = kNegInf, l_run = 0.f;

  float acc[kTR][kTD];
#pragma unroll
  for (int i = 0; i < kTR; ++i)
#pragma unroll
    for (int j = 0; j < kTD; ++j) acc[i][j] = 0.f;

  const int n_kv_all = (S + kBK - 1) / kBK;
  // a tile is live iff its first key is not after the tile's last query
  const int n_kv = causal ? min(n_kv_all, (q0 + kBQ - 1) / kBK + 1)
                          : n_kv_all;

  for (int kt = 0; kt < n_kv; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();                   // the last tile's P and V are used up
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int r = e / D, d = e % D;
      const int pos = k0 + r;
      kv[d * (kBK + 1) + r] = pos < S ? kb[pos * k_s + d] : 0.f;
    }
    __syncthreads();

    float s[kTR][kTC];
#pragma unroll
    for (int i = 0; i < kTR; ++i)
#pragma unroll
      for (int j = 0; j < kTC; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[kTR], bk[kTC];
#pragma unroll
      for (int i = 0; i < kTR; ++i) a[i] = qt[d * (kBQ + 1) + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < kTC; ++j) bk[j] = kv[d * (kBK + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kTR; ++i)
#pragma unroll
        for (int j = 0; j < kTC; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < kTR; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < kTC; ++j) {
        const int c = tx + 16 * j;
        const int kpos = k0 + c;
        float val = s[i][j] * scale;
        if (kpos >= S || (causal && q0 + r < kpos)) val = kNegInf;
        ss[r * (kBK + 1) + c] = val;
      }
    }
    __syncthreads();

    {  // online softmax of this tile's rows; P overwrites S in place
      float* row = ss + srow * (kBK + 1) + spart * kSpan;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < kSpan; ++c) mx = fmaxf(mx, row[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run, mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < kSpan; ++c) {
        const float p = expf(row[c] - m_new);
        row[c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float alpha = expf(m_run - m_new);
      l_run = l_run * alpha + sum;
      m_run = m_new;
      if (spart == 0) alpha_s[srow] = alpha;
    }
    for (int e = tid; e < kBK * DV; e += kThreads) {  // V replaces K^T
      const int r = e / DV, d = e % DV;
      const int pos = k0 + r;
      kv[r * DV + d] = pos < S ? vb[pos * v_s + d] : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < kTR; ++i) {
      const float al = alpha_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < kTD; ++j) acc[i][j] *= al;
    }
#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float p[kTR], vv[kTD];
#pragma unroll
      for (int i = 0; i < kTR; ++i) p[i] = ss[(ty + 16 * i) * (kBK + 1) + c];
#pragma unroll
      for (int j = 0; j < kTD; ++j) vv[j] = kv[c * DV + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kTR; ++i)
#pragma unroll
        for (int j = 0; j < kTD; ++j) acc[i][j] = fmaf(p[i], vv[j], acc[i][j]);
    }
  }

  if (spart == 0) l_s[srow] = l_run;
  __syncthreads();
  float* ob = out + (static_cast<int64_t>(b) * Hq + h) * S * DV;
#pragma unroll
  for (int i = 0; i < kTR; ++i) {
    const int r = ty + 16 * i;
    const int pos = q0 + r;
    if (pos >= S) continue;
    const float l = l_s[r];
#pragma unroll
    for (int j = 0; j < kTD; ++j)
      ob[static_cast<int64_t>(pos) * DV + tx + 16 * j] = acc[i][j] / l;
  }
}

template <int D, int DV>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int batch, int hq, int hkv, int s, const long long* st,
                   float scale, int causal, cudaStream_t stream) {
  const size_t bytes = Layout<D, DV>::kBytes;
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd<D, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (e != cudaSuccess) return e;
  const dim3 grid((s + kBQ - 1) / kBQ, hq, batch);
  flash_fwd<D, DV><<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), s, hq, hq / hkv,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], scale,
      causal);
  return cudaGetLastError();
}

// The (D, Dv) pairs built: D in {32, 64, 128, 192}, Dv in {32, 64, 128},
// Dv <= D.
cudaError_t launch_d(const void* q, const void* k, const void* v, void* out,
                     int batch, int hq, int hkv, int s, int d, int dv,
                     const long long* st, float scale, int causal,
                     cudaStream_t stream) {
#define FLASH_CASE(D, DV)                                                   \
  if (d == D && dv == DV)                                                   \
    return launch<D, DV>(q, k, v, out, batch, hq, hkv, s, st, scale,        \
                         causal, stream);
  FLASH_CASE(32, 32)
  FLASH_CASE(64, 32)
  FLASH_CASE(64, 64)
  FLASH_CASE(128, 32)
  FLASH_CASE(128, 64)
  FLASH_CASE(128, 128)
  FLASH_CASE(192, 32)
  FLASH_CASE(192, 64)
  FLASH_CASE(192, 128)
#undef FLASH_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// q: [batch, hq, s, d], k: [batch, hkv, s, d], v: [batch, hkv, s, dv], all
// float32, each with unit stride in its last axis and the element strides
// of its batch, head and sequence axes in strides[0..2] (q), [3..5] (k),
// [6..8] (v); out: [batch, hq, s, dv] float32, contiguous.  hq % hkv == 0
// and (d, dv) one of launch_d's pairs.  Returns cudaGetLastError() after
// the launch (or the error of the shared-memory attribute).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int batch,
                                      int hq, int hkv, int s, int d, int dv,
                                      const void* strides, float scale,
                                      int causal, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (hkv <= 0 || hq % hkv) return cudaErrorInvalidValue;
  return launch_d(q, k, v, out, batch, hq, hkv, s, d, dv,
                  static_cast<const long long*>(strides), scale, causal,
                  static_cast<cudaStream_t>(stream));
}
