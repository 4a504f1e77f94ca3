// Fused dequantize + matmul for int8 / fp8-e4m3 weights.
//
// Replaces: src/repro/kernels/quant.py::dequant_matmul_call (the
// pl.pallas_call of _dequant_matmul_kernel), reached through
// dequant_matmul_tpu from every projection of a quantized backbone.
//
//   y[m, n] = sum_k x[m, k] * values[k, n] * scales[n]
//   x: (M, K) fp32 or bf16; values: (K, N) int8 or e4m3; scales: (N,) fp32;
//   y: (M, N) in x's dtype; fp32 accumulation.
//
// Bound on the H100: memory, at every shape the quantized serving path
// gives it. A decode tick (M = 4 slots) reads K*N weight bytes for 8*K*N
// flops, and even a 128-token prefill of wi (1024 x 3072) is 0.8 us of bf16
// tensor-core time against 1.25 us to read its 3.15 MB of int8. So the one
// rule is the kernel's point: the weight streams once, 1 byte per element,
// and is widened in registers or shared memory; no fp32 or bf16 copy of it
// is ever written to device memory.
//
// The scale is one per output column, so it multiplies the finished fp32
// sum in the epilogue rather than every widened weight (the Pallas kernel
// scales the weight tile). The two differ by fp32 rounding only: a few ulps
// of each sum, held to 1e-5 of max |y| against the plain version.
//
// Two kernels, chosen by M:
//   M <= 8 (decode): one block per 128-column strip and K slice. Each
//     thread owns 4 adjacent columns, read as one 4-byte word per weight row
//     (neighbouring lanes on neighbouring words: a warp reads 128 bytes of
//     a row), and keeps M x 4 fp32 sums. The block's x rows sit in shared
//     memory as fp32. K is split over the 8 warps of a block and over the 8
//     blocks of a thread-block cluster, so that a 1024 x 1024 weight keeps
//     64 blocks streaming; the warps' partial sums are added in warp order
//     through shared memory, then the cluster's in rank order through
//     distributed shared memory.
//   M > 8 (prefill): a shared-memory tiled GEMM, 32 x 64 output tiles over
//     32-deep K chunks, 256 threads of 2 x 4 outputs each, scalar FMAs. The
//     weight tile is widened to fp32 as it lands in shared memory.
// Both mask ragged M, K and N themselves (the Pallas kernel needs no mask
// only because its K is whole), and neither uses atomics: every sum is
// taken in a fixed order, so a run repeats bit for bit.
#include <cooperative_groups.h>
#include <cuda_fp8.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

// -- widening one payload byte to fp32 ---------------------------------------

struct Int8Values {
  static __device__ __forceinline__ float widen(uint32_t byte) {
    return static_cast<float>(static_cast<int8_t>(static_cast<uint8_t>(byte)));
  }
};

struct E4M3Values {
  static __device__ __forceinline__ float widen(uint32_t byte) {
    __nv_fp8_e4m3 v;
    v.__x = static_cast<__nv_fp8_storage_t>(byte);
    return static_cast<float>(v);
  }
};

// -- M <= 8: strips of columns, K split over warps and cluster blocks --------

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 4;             // adjacent columns per thread
constexpr int kStrip = 32 * kCols;   // 128 columns per block
constexpr int kCluster = 8;          // blocks of one strip, splitting K
constexpr int kUnroll = 8;           // weight rows in flight per thread
constexpr int kMaxSmallM = 8;
constexpr int kMaxSmem = 227 * 1024;

// 4 adjacent payload bytes of one weight row, zero past column N. `vec`:
// the row and column are 4-byte aligned (N % 4 == 0), so one word load.
__device__ __forceinline__ uint32_t load_word(const uint8_t* row, int col, int N,
                                              bool vec) {
  if (vec) return col < N ? __ldg(reinterpret_cast<const unsigned int*>(row + col)) : 0u;
  uint32_t word = 0;
#pragma unroll
  for (int c = 0; c < kCols; ++c)
    if (col + c < N) word |= static_cast<uint32_t>(__ldg(row + col + c)) << (8 * c);
  return word;
}

// kc: weight rows per warp slice, ceil(K / (kCluster * kWarps)); a block
// covers kWarps * kc rows starting at its cluster rank times that.
template <typename T, typename V, int MR>
__global__ void __cluster_dims__(1, kCluster, 1) __launch_bounds__(kThreads)
dequant_matmul_small(const T* __restrict__ x, const uint8_t* __restrict__ w,
                     const float* __restrict__ scales, T* __restrict__ y, int M,
                     int K, int N, int kc, int vec) {
  extern __shared__ float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int kblk = kWarps * kc;
  const int kb0 = rank * kblk;
  float* xs = smem;                 // [MR][kblk] fp32 rows of x
  float* red = smem + MR * kblk;    // [kWarps][MR][kStrip] partial sums
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  for (int i = tid; i < MR * kblk; i += kThreads) {
    const int r = i / kblk, k = kb0 + i % kblk;
    xs[i] = (r < M && k < K) ? rt::to_f32(x[static_cast<long>(r) * K + k]) : 0.f;
  }
  __syncthreads();

  const int col = blockIdx.x * kStrip + lane * kCols;
  const int k_lo = kb0 + warp * kc;
  const int k_hi = min(k_lo + kc, K);
  float acc[MR][kCols];
#pragma unroll
  for (int r = 0; r < MR; ++r)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;

  for (int k = k_lo; k < k_hi; k += kUnroll) {
    uint32_t words[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      words[u] = k + u < k_hi
                     ? load_word(w + static_cast<long>(k + u) * N, col, N, vec)
                     : 0u;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (k + u >= k_hi) break;
      float wv[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) wv[c] = V::widen((words[u] >> (8 * c)) & 0xffu);
      const float* xk = xs + (k + u - kb0);
#pragma unroll
      for (int r = 0; r < MR; ++r) {
        const float xv = xk[r * kblk];
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[r][c] = fmaf(xv, wv[c], acc[r][c]);
      }
    }
  }

  // the warps' partials, added in warp order into warp 0's slot
#pragma unroll
  for (int r = 0; r < MR; ++r)
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      red[(warp * MR + r) * kStrip + lane * kCols + c] = acc[r][c];
  __syncthreads();
  for (int o = tid; o < MR * kStrip; o += kThreads) {
    float s = red[o];
    for (int v = 1; v < kWarps; ++v) s += red[v * MR * kStrip + o];
    red[o] = s;
  }

  // the cluster's block sums, added in rank order; each rank finishes a
  // share of the strip's outputs
  cluster.sync();
  for (int o = rank * kThreads + tid; o < MR * kStrip; o += kCluster * kThreads) {
    float s = 0.f;
    for (int q = 0; q < kCluster; ++q) s += cluster.map_shared_rank(red, q)[o];
    const int r = o / kStrip, n = blockIdx.x * kStrip + o % kStrip;
    if (r < M && n < N) y[static_cast<long>(r) * N + n] = rt::from_f32<T>(s * scales[n]);
  }
  cluster.sync();  // no block leaves while another still reads its sums
}

template <typename T, typename V, int MR>
cudaError_t launch_small(const void* x, const void* w, const float* scales, void* y,
                         int M, int K, int N, cudaStream_t stream) {
  const int kc = (K + kCluster * kWarps - 1) / (kCluster * kWarps);
  const size_t smem = sizeof(float) * (static_cast<size_t>(MR) * kWarps * kc
                                       + static_cast<size_t>(kWarps) * MR * kStrip);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  auto kernel = dequant_matmul_small<T, V, MR>;
  cudaError_t err = rt::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int vec = N % kCols == 0 && reinterpret_cast<uintptr_t>(w) % 4 == 0;
  dim3 grid((N + kStrip - 1) / kStrip, kCluster);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const uint8_t*>(w), scales,
      static_cast<T*>(y), M, K, N, kc, vec);
  return cudaGetLastError();
}

// -- M > 8: shared-memory tiled GEMM ------------------------------------------

constexpr int kBM = 32, kBN = 64, kBK = 32;

template <typename T, typename V>
__global__ void __launch_bounds__(kThreads)
dequant_matmul_tiled(const T* __restrict__ x, const uint8_t* __restrict__ w,
                     const float* __restrict__ scales, T* __restrict__ y, int M,
                     int K, int N) {
  __shared__ float xs[kBM][kBK + 1];  // +1: the column reads miss no bank
  __shared__ __align__(16) float ws[kBK][kBN];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  float acc[2][4] = {};

  for (int k0 = 0; k0 < K; k0 += kBK) {
    for (int i = tid; i < kBM * kBK; i += kThreads) {
      const int r = i / kBK, kk = i % kBK, m = m0 + r, k = k0 + kk;
      xs[r][kk] = (m < M && k < K) ? rt::to_f32(x[static_cast<long>(m) * K + k]) : 0.f;
    }
    for (int i = tid; i < kBK * kBN; i += kThreads) {
      const int kk = i / kBN, c = i % kBN, k = k0 + kk, n = n0 + c;
      ws[kk][c] = (k < K && n < N) ? V::widen(w[static_cast<long>(k) * N + n]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 b = *reinterpret_cast<const float4*>(&ws[kk][tx * 4]);
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float a = xs[ty * 2 + i][kk];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a, bv[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int m = m0 + ty * 2 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (m < M && n < N) y[static_cast<long>(m) * N + n] = rt::from_f32<T>(acc[i][j] * scales[n]);
    }
  }
}

template <typename T, typename V>
cudaError_t launch(const void* x, const void* w, const float* scales, void* y, int M,
                   int K, int N, cudaStream_t stream) {
  if (M <= 1) return launch_small<T, V, 1>(x, w, scales, y, M, K, N, stream);
  if (M <= 2) return launch_small<T, V, 2>(x, w, scales, y, M, K, N, stream);
  if (M <= 4) return launch_small<T, V, 4>(x, w, scales, y, M, K, N, stream);
  if (M <= kMaxSmallM) return launch_small<T, V, 8>(x, w, scales, y, M, K, N, stream);
  dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  dequant_matmul_tiled<T, V><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const uint8_t*>(w), scales,
      static_cast<T*>(y), M, K, N);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_values(const void* x, const void* w, int v_dtype, const float* scales,
                          void* y, int M, int K, int N, cudaStream_t stream) {
  if (v_dtype == rt::E4M3) return launch<T, E4M3Values>(x, w, scales, y, M, K, N, stream);
  return launch<T, Int8Values>(x, w, scales, y, M, K, N, stream);
}

}  // namespace

// x: (M, K) of x_dtype (F32 or BF16); values: (K, N) of v_dtype (I8 or
// E4M3); scales: (N,) fp32; y: (M, N) of x_dtype. All contiguous.
extern "C" int rt_dequant_matmul(const void* x, int x_dtype, const void* values,
                                 int v_dtype, const void* scales, void* y, int M,
                                 int K, int N, void* stream) {
  if (M == 0 || N == 0) return cudaSuccess;
  if ((x_dtype != rt::F32 && x_dtype != rt::BF16)
      || (v_dtype != rt::I8 && v_dtype != rt::E4M3))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scales);
  if (x_dtype == rt::BF16)
    return launch_values<__nv_bfloat16>(x, values, v_dtype, sc, y, M, K, N, s);
  return launch_values<float>(x, values, v_dtype, sc, y, M, K, N, s);
}
