// sig(X . W) with the sigmoid applied in the epilogue, for Hopper (sm_90a),
// hand-written CUDA C++.  One forward layer of the paper's model (Eq. 4).
//
// Replaces the Pallas TPU kernel src/repro/kernels/fused_sigmoid_matmul.py::
// fused_sigmoid_matmul.  Plain twin: repro_torch.kernels.ref.
// fused_sigmoid_matmul (casts to float32, matmul, sigmoid, cast back).
//
// What bounds it on an H100: FLOPs.  2*m*k*n float32 operations against
// (m*k + k*n + m*n) elements moved; at the main path's first layer,
// (2000x784).(784x200), that is 627 MFLOP against 7.5 MB, ~80 FLOP/byte,
// far above the ~20 FLOP/byte float32 ridge: 0.0094 ms at 67 TFLOP/s.  The
// second layer, (2000x200).(200x10), is 8 MFLOP against 1.7 MB: a launch
// and one trip to memory.  The reference accumulates in IEEE float32, so
// the kernel stays off the tensor cores (no mma, wgmma or TF32): its
// ceiling is the SIMT FFMA rate, and the design is about keeping the FMA
// pipes fed on 132 SMs.
//
// Design.  A block computes a BM x BN output tile; its threads are KSPLIT
// groups of (BM / TM) x (BN / TN) threads, each thread holding a TM x TN
// float32 micro-tile in registers.  The wrapper picks one of two tile
// instances from the shape (fused_sigmoid_matmul.py::instance):
//   - wide, 40 x 40 (n > 16), 4 K groups of 8 x 10 threads with 5 x 4 sums
//     each: 320 threads, 45.5 KB of shared memory.  At (2000x784).(784x200)
//     that is 50 x 5 = 250 blocks with no ragged tile (40 divides both 2000
//     and 200), two resident on each SM, so one wave of 264 places and 20
//     warps an SM.  A single 64 x 64 tile gave 128 blocks, one of 8 warps
//     an SM, and its last column tile kept 8 of 64 columns (22 % of the
//     FMAs wasted);
//   - narrow, 16 x 16 (n <= 16), 4 K groups of 8 x 8 threads with 2 x 2
//     sums: all of n = 10 in one block and m spread over 125 blocks at m =
//     2000, where the 64 x 64 tile ran 32 blocks, left 100 SMs idle and
//     computed 84 % padding.
// Other tiles were timed against these on an H100 (80 x 40 at one block an
// SM, 20 x 40, 10 x 4 and 5 x 8 micro-tiles over 8 K groups, 2 K groups,
// K slices of 64, 2 or 3 stages): none was faster by more than the spread
// between runs at the main shapes, and several were slower.
// K advances in slices of BK (32 wide, 64 narrow) through a ring of 4
// shared-memory stages filled with cp.async: the copies of slice s + 3 are
// issued before the FMAs of slice s and awaited (cp.async.wait_group and
// one __syncthreads a slice) only when that slice comes up, so loads run
// under the FMAs, where a single-stage kernel loads each slice with scalar
// loads and stalls on two barriers a slice.  The copies are 16 bytes (cp.async.cg)
// where a row allows it (k or n a multiple of 4 and a 16-byte-aligned base:
// x rows of 784 x 4 B, w rows of 200 x 4 B), else 4 bytes (cp.async.ca; w
// rows of n = 10 are 40 B); copies past an edge are zero-fills (src-size
// 0), so every edge is masked with no branch in the inner loop.  x is kept
// in shared memory as [m][k] (rows padded by 16 B) and read 4 k-steps at a
// time, one 128-bit load a micro-tile row: a thread's TM rows are tm + i *
// (BM / TM), so the threads of a quarter warp read one row (broadcast) or
// neighbouring rows, 36 words apart (distinct banks); w is [k][n] and read
// as TN contiguous floats (one 128-bit load at TN = 4), neighbouring
// threads on neighbouring 16 B.  The wide tile does 80 FMAs per 9 shared
// loads of 128 bits (a 4 x 4 micro-tile: 16 per 8 scalar loads).
// The K groups split each slice: group g takes k-steps [g BK/KSPLIT,
// (g+1) BK/KSPLIT) of every slice, so a block has KSPLIT times the warps
// of one micro-tile grid while each thread keeps its micro-tile.  After the
// last slice the groups write their partial sums to shared memory (over
// the ring) and every thread sums its outputs' partials in group order,
// p0 + p1 + p2 + p3: one launch, no atomics, the same bits from run to
// run.  The epilogue applies 1/(1+expf(-z)) (full-precision expf, no fast
// math) and stores in x's type (bf16 rounds to nearest even, as torch's
// .to(bfloat16) does), the tile's elements in row-major order across the
// block, so stores coalesce.  The bf16 instance converts to float32 on the
// way into shared memory with plain loads (cp.async cannot convert); it
// has no main-path caller and only needs to be right.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <int BM_, int BN_, int BK_, int TM_, int TN_, int KSPLIT_,
          int STAGES_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, TM = TM_, TN = TN_;
  static constexpr int KSPLIT = KSPLIT_, STAGES = STAGES_;
  static constexpr int MT = BM / TM, NT = BN / TN;  // a group's thread grid
  static constexpr int GROUP = MT * NT;
  static constexpr int THREADS = GROUP * KSPLIT;
  static constexpr int KK = BK / KSPLIT;            // k-steps a group a slice
  static constexpr int XLD = BK + 4, WLD = BN + 4;  // stage row pitches
  static constexpr int XS = BM * XLD, WS = BK * WLD;
  static constexpr int RING = STAGES * (XS + WS);   // floats
  static constexpr int RED = KSPLIT * BM * BN;
  static constexpr int SMEM = 4 * (RING > RED ? RING : RED);   // bytes
  static_assert(BM % TM == 0 && BN % TN == 0 && BK % KSPLIT == 0, "tile");
  static_assert(KK % 4 == 0 && BN % 4 == 0 && (TN == 1 || TN % 2 == 0),
                "128-bit reads of x, 64/128-bit reads of w");
};

using Wide = Tile<40, 40, 32, 5, 4, 4, 4>;      // 320 threads, 45,568 B
using Narrow = Tile<16, 16, 64, 2, 2, 4, 4>;    // 256 threads, 37,888 B
static_assert(Wide::SMEM <= 48 * 1024 && Narrow::SMEM <= 48 * 1024,
              "no opt-in to more dynamic shared memory");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One chunk of V floats from global to shared memory, or V zeros when !ok
// (a src-size of 0 reads nothing).  float32: asynchronous, cp.async;
// bf16: a plain load converted to float32 (V = 1).
template <int V>
__device__ __forceinline__ void put(float* dst, const float* src, bool ok) {
  if constexpr (V == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst)), "l"(src), "r"(ok ? 16 : 0)
                 : "memory");
  } else {
    static_assert(V == 1, "4- or 16-byte chunks");
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     smem_addr(dst)), "l"(src), "r"(ok ? 4 : 0)
                 : "memory");
  }
}
template <int V>
__device__ __forceinline__ void put(float* dst, const __nv_bfloat16* src,
                                    bool ok) {
  static_assert(V == 1, "bf16 converts element by element");
  *dst = ok ? __bfloat162float(*src) : 0.f;
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The x slice [m0, m0 + BM) x [k0, k0 + BK) into xs[BM][XLD] and the w
// slice [k0, k0 + BK) x [n0, n0 + BN) into ws[BK][WLD], in chunks of XV and
// WV floats; past m, k or n, zeros.
template <class C, int XV, int WV, typename T>
__device__ __forceinline__ void fill(float* xs, float* ws, const T* x,
                                     const T* w, int m0, int n0, int k0,
                                     int m, int k, int n) {
  constexpr int XC = C::BK / XV, WC = C::BN / WV;   // chunks a row
#pragma unroll
  for (int e = threadIdx.x; e < C::BM * XC; e += C::THREADS) {
    const int r = e / XC, c = (e % XC) * XV;
    const bool ok = m0 + r < m && k0 + c < k;
    put<XV>(xs + r * C::XLD + c,
            ok ? x + static_cast<int64_t>(m0 + r) * k + k0 + c : x, ok);
  }
#pragma unroll
  for (int e = threadIdx.x; e < C::BK * WC; e += C::THREADS) {
    const int r = e / WC, c = (e % WC) * WV;
    const bool ok = k0 + r < k && n0 + c < n;
    put<WV>(ws + r * C::WLD + c,
            ok ? w + static_cast<int64_t>(k0 + r) * n + n0 + c : w, ok);
  }
}

__device__ __forceinline__ float lane4(const float4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <class C, int XV, int WV, typename T>
__global__ void __launch_bounds__(C::THREADS)
sigmoid_matmul(const T* __restrict__ x, const T* __restrict__ w,
               T* __restrict__ out, int m, int k, int n) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x;
  const int g = tid / C::GROUP, t = tid % C::GROUP;
  const int tm = t / C::NT, tn = t % C::NT;
  const int m0 = blockIdx.x * C::BM, n0 = blockIdx.y * C::BN;
  const int slices = (k + C::BK - 1) / C::BK;
  auto xs_of = [&](int s) { return smem + (s % C::STAGES) * (C::XS + C::WS); };

#pragma unroll
  for (int s = 0; s < C::STAGES - 1; ++s) {
    if (s < slices)
      fill<C, XV, WV>(xs_of(s), xs_of(s) + C::XS, x, w, m0, n0, s * C::BK,
                      m, k, n);
    cp_async_commit();
  }

  float acc[C::TM][C::TN];
#pragma unroll
  for (int i = 0; i < C::TM; ++i)
#pragma unroll
    for (int j = 0; j < C::TN; ++j) acc[i][j] = 0.f;

  for (int s = 0; s < slices; ++s) {
    // slice s has landed (this thread's copies; the barrier makes every
    // thread's visible), and every thread is done with slice s - 1, whose
    // stage the copies issued next overwrite
    cp_async_wait<C::STAGES - 2>();
    __syncthreads();
    const int next = s + C::STAGES - 1;
    if (next < slices)
      fill<C, XV, WV>(xs_of(next), xs_of(next) + C::XS, x, w, m0, n0,
                      next * C::BK, m, k, n);
    cp_async_commit();

    const float* xs = xs_of(s) + g * C::KK;
    const float* ws = xs_of(s) + C::XS + g * C::KK * C::WLD + tn * C::TN;
#pragma unroll
    for (int q = 0; q < C::KK; q += 4) {
      float4 a[C::TM];
#pragma unroll
      for (int i = 0; i < C::TM; ++i)
        a[i] = *reinterpret_cast<const float4*>(
            xs + (tm + i * C::MT) * C::XLD + q);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float b[C::TN];
        const float* wr = ws + (q + u) * C::WLD;
        if constexpr (C::TN % 4 == 0) {
#pragma unroll
          for (int j = 0; j < C::TN; j += 4) {
            const float4 v = *reinterpret_cast<const float4*>(wr + j);
            b[j] = v.x; b[j + 1] = v.y; b[j + 2] = v.z; b[j + 3] = v.w;
          }
        } else if constexpr (C::TN % 2 == 0) {
#pragma unroll
          for (int j = 0; j < C::TN; j += 2) {
            const float2 v = *reinterpret_cast<const float2*>(wr + j);
            b[j] = v.x; b[j + 1] = v.y;
          }
        } else {
          b[0] = wr[0];
        }
#pragma unroll
        for (int i = 0; i < C::TM; ++i)
#pragma unroll
          for (int j = 0; j < C::TN; ++j)
            acc[i][j] = fmaf(lane4(a[i], u), b[j], acc[i][j]);
      }
    }
  }

  // the K groups' partial sums, reduced in group order over the ring
  cp_async_wait<0>();
  __syncthreads();
  float* red = smem;
#pragma unroll
  for (int i = 0; i < C::TM; ++i)
#pragma unroll
    for (int j = 0; j < C::TN; ++j)
      red[(g * C::BM + tm + i * C::MT) * C::BN + tn * C::TN + j] = acc[i][j];
  __syncthreads();
  for (int e = tid; e < C::BM * C::BN; e += C::THREADS) {
    const int r = m0 + e / C::BN, c = n0 + e % C::BN;
    if (r >= m || c >= n) continue;
    float z = red[e];
#pragma unroll
    for (int p = 1; p < C::KSPLIT; ++p) z += red[p * C::BM * C::BN + e];
    store(out + static_cast<int64_t>(r) * n + c, 1.f / (1.f + expf(-z)));
  }
}

template <class C, int XV, int WV, typename T>
cudaError_t launch(const void* x, const void* w, void* out, int m, int k,
                   int n, cudaStream_t s) {
  const unsigned row_tiles = (m + C::BM - 1) / C::BM;
  const unsigned col_tiles = (n + C::BN - 1) / C::BN;
  if (col_tiles > 65535) return cudaErrorInvalidValue;
  sigmoid_matmul<C, XV, WV, T>
      <<<dim3(row_tiles, col_tiles), C::THREADS, C::SMEM, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(out),
      m, k, n);
  return cudaGetLastError();
}

template <class C>
cudaError_t launch_tile(const void* x, const void* w, void* out, int m, int k,
                        int n, int dtype, int vec, cudaStream_t s) {
  if (dtype == 1 && vec == 0)
    return launch<C, 1, 1, __nv_bfloat16>(x, w, out, m, k, n, s);
  if (dtype != 0) return cudaErrorInvalidValue;
  switch (vec) {
    case 0: return launch<C, 1, 1, float>(x, w, out, m, k, n, s);
    case 1: return launch<C, 4, 1, float>(x, w, out, m, k, n, s);
    case 2: return launch<C, 1, 4, float>(x, w, out, m, k, n, s);
    case 3: return launch<C, 4, 4, float>(x, w, out, m, k, n, s);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t use_device(int device) {
  int current;
  const cudaError_t e = cudaGetDevice(&current);
  if (e != cudaSuccess) return e;
  return current == device ? cudaSuccess : cudaSetDevice(device);
}

}  // namespace

// x: [m, k], w: [k, n], out: [m, n], all row-major and of one type:
// dtype 0 = float32, 1 = bfloat16.  tile: 0 = wide (40 x 40), 1 = narrow
// (16 x 16).  vec (float32 only): bit 0 copies x in 16-byte chunks (k % 4 ==
// 0 and x 16-byte aligned), bit 1 w (n % 4 == 0 and w aligned); else 4-byte
// chunks.  Returns cudaGetLastError().
extern "C" int fsm_launch(const void* x, const void* w, void* out, int m,
                          int k, int n, int dtype, int tile, int vec,
                          int device, void* stream) {
  const cudaError_t e = use_device(device);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tile) {
    case 0: return launch_tile<Wide>(x, w, out, m, k, n, dtype, vec, s);
    case 1: return launch_tile<Narrow>(x, w, out, m, k, n, dtype, vec, s);
    default: return cudaErrorInvalidValue;
  }
}
