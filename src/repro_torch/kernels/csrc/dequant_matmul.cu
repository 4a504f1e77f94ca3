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
// The kernel and its launch come from the wrapper's plan
// (`quant.dequant_matmul_plan`), passed in as a kernel code, a grid, a
// cluster size and the K rows of a part; a launcher takes them as they are
// and only refuses a plan that does not cover every output and K row once:
//
// fp32 x stays on the FFMA units: bf16 or TF32 tensor cores would break
// its 1e-5-of-max-|y| tolerance.
//   ffma_small, M <= 8: one block per 128-column strip and K
//     slice, a thread on 4 adjacent columns, x in shared memory as fp32,
//     K split over 8 warps and the 8 blocks of a cluster, kpp rows a warp.
//   ffma_tiled, M > 8: a shared-memory tiled GEMM, 32 x 64 output tiles,
//     2 x 4 outputs a thread, the weight tile widened to fp32 in shared
//     memory.
// bf16 x runs on the tensor cores. Every int8 value and every finite e4m3
// value is exact in bf16, so a bf16 x bf16 product with fp32 sums differs
// from the plain version in summation order only. A byte is widened
// without a cvt of its own: int8 through the fp32 magic number 0x4B000000
// | (b ^ 0x80), less 8388736, two at a time packed to bf16x2; e4m3 two at
// a time through the hardware cvt.rn.f16x2.e4m3x2, then through fp32.
//   mma_stream, M <= 8 (decode): the product taken transposed, y^T = W^T
//     x^T, so that N fills the MMA's 16-row side and M its 8-column side.
//     A warp owns a 128-column strip; a lane loads 16 weight bytes (16
//     adjacent columns) of each of 4 adjacent K rows, and those 64 bytes,
//     byte-permuted into pairs, are its A fragments of 8 m16n8k16 MMAs: K
//     and N are permuted inside the MMA (a lane's k slots 2t, 2t+1, 2t+8,
//     2t+9 are rows 4t..4t+3, its rows g and g+8 two adjacent columns),
//     which a sum does not see. Its B fragment is 4 adjacent bf16 of x row
//     g, read from global memory (x is a few KB and stays in L1): no
//     shared memory and no barrier stand before the weight loads. 4 MMA
//     steps of loads (16 x 16 bytes a lane) are issued before the first
//     is used. K is cut into contiguous parts over the warps of a block
//     and the ranks of a cluster; every sum goes to shared memory in an
//     order with no bank conflict, and each rank adds a share of them over
//     the warps and the ranks, in order, through distributed shared memory
//     (the rank pulls them: pushing every sum to its finishing rank timed
//     slower). (A second pass over more K parts, to fill the card where
//     N = 1024 leaves 8 strips, timed slower than the cluster alone.)
//   mma_tiled, M > 8 (prefill): 64 x 64 output tiles, 4 warps of 32 x 32,
//     K in 64-deep tiles through a 3-stage ring of
//     16-byte cp.async copies (x as bf16, the weight as raw bytes); each
//     weight tile is widened once a block into a bf16 tile in shared
//     memory, and ldmatrix feeds mma.sync from both. K is split over the
//     ranks of a cluster where the tiles alone leave the card empty, the
//     ranks' tiles summed in rank order through distributed shared memory.
// The scale multiplies each finished fp32 sum once, in the epilogue.
// Every kernel masks ragged M, K and N itself (16-byte copies where the
// rows are 16-byte aligned, byte loads where not), and none uses atomics:
// every sum runs in a fixed order, so a run repeats bit for bit.
#include <cooperative_groups.h>
#include <cuda_fp16.h>
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
                         int M, int K, int N, dim3 grid, int kc, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (static_cast<size_t>(MR) * kWarps * kc
                                       + static_cast<size_t>(kWarps) * MR * kStrip);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  auto kernel = dequant_matmul_small<T, V, MR>;
  cudaError_t err = rt::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int vec = N % kCols == 0 && reinterpret_cast<uintptr_t>(w) % 4 == 0;
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

// -- bf16 x on the tensor cores: shared pieces ------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when !pred
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c (16x8 fp32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma16816(float* c, const uint32_t* a, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 4 payload bytes [b0, b1, b2, b3] (b0 lowest) -> bf16x2 (b0, b1) in .x and
// (b2, b3) in .y, the lower byte in the lower half; exact
struct Int8Bf16 {
  static __device__ __forceinline__ uint2 widen(uint32_t q) {
    const uint32_t u = q ^ 0x80808080u;  // b + 128, unsigned
    const float magic = 8388736.f;       // 2^23 + 128
    const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - magic;
    const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - magic;
    const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - magic;
    const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - magic;
    return make_uint2(pack_bf16(f0, f1), pack_bf16(f2, f3));
  }
};

struct E4M3Bf16 {
  static __device__ __forceinline__ uint32_t pair(uint32_t two) {
    const __half2 h = __nv_cvt_fp8x2_to_halfraw2(
        static_cast<__nv_fp8x2_storage_t>(two & 0xffffu), __NV_E4M3);
    const float2 f = __half22float2(h);
    return pack_bf16(f.x, f.y);
  }
  static __device__ __forceinline__ uint2 widen(uint32_t q) {
    return make_uint2(pair(q), pair(q >> 16));
  }
};

template <typename V> struct Bf16Of;
template <> struct Bf16Of<Int8Values> { using type = Int8Bf16; };
template <> struct Bf16Of<E4M3Values> { using type = E4M3Bf16; };

__device__ __forceinline__ uint32_t word_of(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// 16 payload bytes of one weight row from column col, zero past column N.
// vec: N % 16 == 0 and the weight 16-byte aligned, so one 16-byte load.
__device__ __forceinline__ uint4 load_w16(const uint8_t* row, int col, int N, bool vec) {
  if (vec) return col < N ? __ldg(reinterpret_cast<const uint4*>(row + col))
                          : make_uint4(0, 0, 0, 0);
  uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int b = 0; b < 16; ++b)
    if (col + b < N) w[b >> 2] |= static_cast<uint32_t>(__ldg(row + col + b)) << (8 * (b & 3));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// 4 adjacent bf16 of an x row from k, zero from k_hi on. vec: K % 4 == 0
// and x 8-byte aligned.
__device__ __forceinline__ uint2 load_x4(const __nv_bfloat16* row, int k, int k_hi,
                                         bool vec) {
  if (vec && k + 3 < k_hi) return __ldg(reinterpret_cast<const uint2*>(row + k));
  const unsigned short* r16 = reinterpret_cast<const unsigned short*>(row);
  uint32_t h[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) h[e] = k + e < k_hi ? __ldg(r16 + k + e) : 0u;
  return make_uint2(h[0] | (h[1] << 16), h[2] | (h[3] << 16));
}

// -- mma_stream: M <= 8 ------------------------------------------------------

constexpr int kMaxCluster = 8;  // the portable cluster size
constexpr int kStreamWarps = 4;
constexpr int kStreamThreads = 32 * kStreamWarps;
constexpr int kSlots = 32 * 32;  // a warp's sums: 8 MMAs x 4 x 32 lanes
constexpr int kStepK = 16;  // K rows of one MMA step
constexpr int kSteps = 4;   // MMA steps whose loads are in flight together

// Slot (p, c, lane (g, t)) of a warp's sums: MMA p = 2d + h has its row g
// on column 16g + 4d + 2h of the strip and its row g + 8 on the next;
// accumulator c is its row g + 8 * (c >> 1) and column 2t + (c & 1), the
// latter a row m of y
__device__ __forceinline__ int slot_row(int slot) {
  return 2 * (slot & 3) + ((slot >> 5) & 1);
}
__device__ __forceinline__ int strip_column(int slot) {
  return blockIdx.x * kStrip + 16 * ((slot & 31) >> 2) + 2 * (slot >> 7)
         + ((slot >> 6) & 1);
}

// kpp: K rows of one part (a multiple of kStepK): part (rank, warp) takes
// rows [part * kpp, part * kpp + kpp). WVEC: N % 16 == 0 and the weight on
// 16 bytes; XVEC: K % 4 == 0 and x on 8 bytes (template flags, so that the
// loads run straight, with no branch between them).
template <typename V, bool WVEC, bool XVEC>
__global__ void __launch_bounds__(kStreamThreads) dequant_mma_stream(
    const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ w,
    const float* __restrict__ scales, __nv_bfloat16* __restrict__ y, int M, int K,
    int N, int kpp) {
  using W = typename Bf16Of<V>::type;
  // a warp's sums, lane-major by slot (p * 4 + c) * 32 + lane: no bank
  // conflict
  __shared__ float red[kStreamWarps][kSlots];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int C = static_cast<int>(cluster.num_blocks());
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int part = rank * kStreamWarps + warp;
  const int k_lo = part * kpp, k_hi = min(k_lo + kpp, K);
  const int n0 = blockIdx.x * kStrip + 16 * g;  // this lane's 16 columns
  const __nv_bfloat16* xr = x + static_cast<long>(min(g, M - 1)) * K;
  const bool xrow = g < M;

  float acc[8][4];
#pragma unroll
  for (int p = 0; p < 8; ++p)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[p][c] = 0.f;

  for (int kb = k_lo; kb < k_hi; kb += kStepK * kSteps) {
    uint4 wv[kSteps][4];
    uint2 xv[kSteps];
#pragma unroll
    for (int u = 0; u < kSteps; ++u) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int k = kb + u * kStepK + 4 * t + q;
        wv[u][q] = k < k_hi ? load_w16(w + static_cast<long>(k) * N, n0, N, WVEC)
                            : make_uint4(0, 0, 0, 0);
      }
      const int k = kb + u * kStepK + 4 * t;
      xv[u] = xrow && k < k_hi ? load_x4(xr, k, k_hi, XVEC) : make_uint2(0, 0);
    }
#pragma unroll
    for (int u = 0; u < kSteps; ++u) {
      if (kb + u * kStepK >= k_hi) break;  // the same for the whole warp
#pragma unroll
      for (int d = 0; d < 4; ++d) {  // word d: columns n0 + 4d .. n0 + 4d + 3
        const uint32_t r0 = word_of(wv[u][0], d), r1 = word_of(wv[u][1], d);
        const uint32_t r2 = word_of(wv[u][2], d), r3 = word_of(wv[u][3], d);
        // [r0.b0, r1.b0, r0.b1, r1.b1]: rows 4t, 4t+1 of columns 4d, 4d+1
        const uint2 lo01 = W::widen(__byte_perm(r0, r1, 0x5140));
        const uint2 lo23 = W::widen(__byte_perm(r2, r3, 0x5140));
        const uint2 hi01 = W::widen(__byte_perm(r0, r1, 0x7362));
        const uint2 hi23 = W::widen(__byte_perm(r2, r3, 0x7362));
        const uint32_t alo[4] = {lo01.x, lo01.y, lo23.x, lo23.y};
        const uint32_t ahi[4] = {hi01.x, hi01.y, hi23.x, hi23.y};
        mma16816(acc[2 * d], alo, xv[u].x, xv[u].y);
        mma16816(acc[2 * d + 1], ahi, xv[u].x, xv[u].y);
      }
    }
  }

#pragma unroll
  for (int p = 0; p < 8; ++p)
#pragma unroll
    for (int c = 0; c < 4; ++c) red[warp][(p * 4 + c) * 32 + lane] = acc[p][c];
  if (C > 1) cluster.sync(); else __syncthreads();
  // each rank finishes a share of the slots, reading every rank's sums
  // through distributed shared memory: the warps' sums added in warp order
  // within a rank, the ranks' in rank order
#pragma unroll
  for (int j = 0; j < kSlots / kStreamThreads; ++j) {
    const int slot = (rank + j * C) * kStreamThreads + threadIdx.x;
    if (slot >= kSlots) break;
    const int m = slot_row(slot), n = strip_column(slot);
    if (m >= M || n >= N) continue;
    float sums[kMaxCluster][kStreamWarps];  // all requested before any is added
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q) {
      const float* rq = cluster.map_shared_rank(&red[0][0], q < C ? q : 0);
#pragma unroll
      for (int v = 0; v < kStreamWarps; ++v) sums[q][v] = q < C ? rq[v * kSlots + slot] : 0.f;
    }
    float s = sums[0][0];
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q)
#pragma unroll
      for (int v = 0; v < kStreamWarps; ++v)
        if (q < C && q + v > 0) s += sums[q][v];
    y[static_cast<long>(m) * N + n] = __float2bfloat16_rn(s * scales[n]);
  }
  if (C > 1) cluster.sync();  // no block leaves while another reads its sums
}

// -- mma_tiled: M > 8 --------------------------------------------------------

constexpr int BK = 64;  // K depth of a tile
constexpr int ST = 3;   // tiles in the cp.async ring

// BM x BN output tiles, 4 warps of 32 x BN/2; K in BK-deep tiles through a
// ring of ST stages. Rows padded by 16 bytes, so that the 8 rows of an
// ldmatrix fall in 8 different bank groups
struct TiledLayout {
  static constexpr int BM = 64, BN = 64;
  static constexpr int Threads = 2 * BM;
  static constexpr int XLd = BK + 8;  // padded x row, in bf16
  static constexpr int WLd = BN + 8;  // padded widened-weight row, in bf16
  static constexpr int XBytes = BM * XLd * 2;
  static constexpr int RawBytes = BK * BN;
  static constexpr int StageBytes = XBytes + RawBytes;
  static constexpr int WideBytes = BK * WLd * 2;
  static constexpr int RLd = BN + 4;  // padded row of the fp32 sums
  static constexpr int RedBytes = BM * RLd * 4;
  static constexpr int Pipe = ST * StageBytes + WideBytes;
  static constexpr int Smem = Pipe > RedBytes ? Pipe : RedBytes;
  static constexpr int NT = BN / 16;  // n8 tiles of a warp's 32 x BN/2
};

// kpp: K rows of one cluster rank (a multiple of BK)
template <typename V>
__global__ void __launch_bounds__(TiledLayout::Threads) dequant_mma_tiled(
    const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ w,
    const float* __restrict__ scales, __nv_bfloat16* __restrict__ y, int M, int K,
    int N, int kpp, int wvec, int xvec) {
  using W = typename Bf16Of<V>::type;
  using L = TiledLayout;
  constexpr int BM = L::BM, BN = L::BN;
  extern __shared__ __align__(16) unsigned char tile_smem[];
  unsigned char* smem = tile_smem;
  __nv_bfloat16* wide = reinterpret_cast<__nv_bfloat16*>(smem + ST * L::StageBytes);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int C = static_cast<int>(cluster.num_blocks());
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;  // the warp's 32 x BN/2 quarter
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int k_lo = rank * kpp, k_hi = min(k_lo + kpp, K);
  const int nk = k_hi > k_lo ? (k_hi - k_lo + BK - 1) / BK : 0;

  // one K tile of x (64 x BK bf16) and of the weight (BK x BN bytes) into
  // stage st, zero past M, k_hi and N
  auto load = [&](int st, int kt) {
    const int k0 = k_lo + kt * BK;
    __nv_bfloat16* xd = reinterpret_cast<__nv_bfloat16*>(smem + st * L::StageBytes);
    for (int c = tid; c < BM * (BK / 8); c += L::Threads) {
      const int r = c / (BK / 8), kk = (c % (BK / 8)) * 8;
      const int m = m0 + r, k = k0 + kk;
      __nv_bfloat16* dst = xd + r * L::XLd + kk;
      const __nv_bfloat16* src = x + static_cast<long>(min(m, M - 1)) * K;
      if (xvec) {
        cp_async16(dst, src + min(k, K - 8), m < M && k < k_hi);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          dst[e] = m < M && k + e < k_hi ? src[k + e] : __float2bfloat16_rn(0.f);
      }
    }
    uint8_t* wd = smem + st * L::StageBytes + L::XBytes;
    for (int c = tid; c < BK * (BN / 16); c += L::Threads) {
      const int r = c / (BN / 16), nn = (c % (BN / 16)) * 16;
      const int k = k0 + r, n = n0 + nn;
      uint8_t* dst = wd + r * BN + nn;
      const uint8_t* src = w + static_cast<long>(min(k, K - 1)) * N;
      if (wvec) {
        cp_async16(dst, src + min(n, N - 16), k < k_hi && n < N);
      } else {
#pragma unroll
        for (int e = 0; e < 16; ++e) dst[e] = k < k_hi && n + e < N ? src[n + e] : 0;
      }
    }
  };

  float acc[2][L::NT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < L::NT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;

#pragma unroll
  for (int s = 0; s < ST - 1; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<ST - 2>();
    __syncthreads();  // tile kt has landed; tile kt - 1's reads are done
    if (kt + ST - 1 < nk) load((kt + ST - 1) % ST, kt + ST - 1);
    cp_async_commit();
    // widen the weight tile once, 16 bytes a thread at a time
    const uint8_t* rw = smem + (kt % ST) * L::StageBytes + L::XBytes;
    for (int c = tid; c < BK * (BN / 16); c += L::Threads) {
      const int r = c / (BN / 16), nn = (c % (BN / 16)) * 16;
      const uint4 b = *reinterpret_cast<const uint4*>(rw + r * BN + nn);
      const uint2 w0 = W::widen(b.x), w1 = W::widen(b.y);
      const uint2 w2 = W::widen(b.z), w3 = W::widen(b.w);
      uint4* dst = reinterpret_cast<uint4*>(wide + r * L::WLd + nn);
      dst[0] = make_uint4(w0.x, w0.y, w1.x, w1.y);
      dst[1] = make_uint4(w2.x, w2.y, w3.x, w3.y);
    }
    __syncthreads();
    const __nv_bfloat16* xt =
        reinterpret_cast<const __nv_bfloat16*>(smem + (kt % ST) * L::StageBytes);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldsm_x4(a[i], xt + (wm * 32 + i * 16 + (lane & 15)) * L::XLd + kk + (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j < L::NT; j += 2) {
        uint32_t b[4];
        ldsm_x4_t(b, wide + (kk + (lane & 15)) * L::WLd + wn * (BN / 2) + j * 8
                         + (lane >> 4) * 8);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma16816(acc[i][j], a[i], b[0], b[1]);
          mma16816(acc[i][j + 1], a[i], b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // accumulator (i, j, c): row wm*32 + i*16 + g + 8*(c >> 1), column
  // wn*BN/2 + j*8 + 2t + (c & 1) of the tile
  if (C == 1) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < L::NT; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int m = m0 + wm * 32 + i * 16 + g + (c >> 1) * 8;
          const int n = n0 + wn * (BN / 2) + j * 8 + 2 * t + (c & 1);
          if (m < M && n < N)
            y[static_cast<long>(m) * N + n] = __float2bfloat16_rn(acc[i][j][c] * scales[n]);
        }
    return;
  }
  __syncthreads();  // the ring is free: the tile's sums take its place
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < L::NT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        red[(wm * 32 + i * 16 + g + (c >> 1) * 8) * L::RLd + wn * (BN / 2) + j * 8 + 2 * t
            + (c & 1)] = acc[i][j][c];
  cluster.sync();
  // each rank finishes a share of the tile, reading every rank's sums
  // through distributed shared memory, in rank order
  for (int o = rank * L::Threads + tid; o < BM * BN; o += C * L::Threads) {
    const int m = m0 + o / BN, n = n0 + o % BN;
    if (m >= M || n >= N) continue;
    const int at = (o / BN) * L::RLd + o % BN;
    float sums[kMaxCluster];  // every rank's sum requested before any is added
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q)
      sums[q] = q < C ? cluster.map_shared_rank(red, q)[at] : 0.f;
    float s = sums[0];
#pragma unroll
    for (int q = 1; q < kMaxCluster; ++q)
      if (q < C) s += sums[q];
    y[static_cast<long>(m) * N + n] = __float2bfloat16_rn(s * scales[n]);
  }
  cluster.sync();  // no block leaves while another still reads its sums
}

template <typename Kernel, typename... Args>
cudaError_t launch_cluster(Kernel kernel, dim3 grid, int threads, size_t smem,
                           dim3 cluster, cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster.x;
  attr[0].val.clusterDim.y = cluster.y;
  attr[0].val.clusterDim.z = cluster.z;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

template <typename V, bool WVEC, bool XVEC>
cudaError_t launch_stream_vec(const void* x, const void* w, const float* scales, void* y,
                              int M, int K, int N, dim3 grid, int kpp,
                              cudaStream_t stream) {
  return launch_cluster(dequant_mma_stream<V, WVEC, XVEC>, grid, kStreamThreads, 0,
                        dim3(1, grid.y, 1), stream,
                        static_cast<const __nv_bfloat16*>(x),
                        static_cast<const uint8_t*>(w), scales,
                        static_cast<__nv_bfloat16*>(y), M, K, N, kpp);
}

template <typename V>
cudaError_t launch_stream(const void* x, const void* w, const float* scales, void* y,
                          int M, int K, int N, dim3 grid, int kpp, cudaStream_t stream) {
  const bool wvec = N % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const bool xvec = K % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 8 == 0;
  if (wvec && xvec)
    return launch_stream_vec<V, true, true>(x, w, scales, y, M, K, N, grid, kpp, stream);
  if (wvec)
    return launch_stream_vec<V, true, false>(x, w, scales, y, M, K, N, grid, kpp, stream);
  if (xvec)
    return launch_stream_vec<V, false, true>(x, w, scales, y, M, K, N, grid, kpp, stream);
  return launch_stream_vec<V, false, false>(x, w, scales, y, M, K, N, grid, kpp, stream);
}

template <typename V>
cudaError_t launch_tiled(const void* x, const void* w, const float* scales, void* y, int M,
                         int K, int N, dim3 grid, int kpp, cudaStream_t stream) {
  using L = TiledLayout;
  auto kernel = dequant_mma_tiled<V>;
  cudaError_t err = rt::allow_smem(kernel, L::Smem);
  if (err != cudaSuccess) return err;
  const int wvec = N % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const int xvec = K % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  return launch_cluster(kernel, grid, L::Threads, L::Smem, dim3(1, 1, grid.z), stream,
                        static_cast<const __nv_bfloat16*>(x),
                        static_cast<const uint8_t*>(w), scales,
                        static_cast<__nv_bfloat16*>(y), M, K, N, kpp, wvec, xvec);
}

// the plan's kernel codes (quant.KERNELS)
enum Kernel { FFMA_SMALL = 0, FFMA_TILED = 1, MMA_STREAM = 2, MMA_TILED = 3 };

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// Does the plan cover every output once and every K row? Its grid must be
// the kernel's: (N / BN, M / BM, split) for the tiled kernels, (N / BN,
// split, 1) for the decode ones (BM = 0: all M rows in each block); and its
// split x per_block parts of kpp rows (a multiple of step) must reach K.
inline bool covers(dim3 grid, int split, int kpp, int M, int K, int N, int BM, int BN,
                   int step, int per_block) {
  const dim3 want = BM ? dim3(cdiv(N, BN), cdiv(M, BM), split) : dim3(cdiv(N, BN), split, 1);
  return grid.x == want.x && grid.y == want.y && grid.z == want.z && kpp >= 0
         && kpp % step == 0 && static_cast<long>(kpp) * split * per_block >= K;
}

template <typename V>
cudaError_t launch_values(const void* x, int x_dtype, const void* w, const float* scales,
                          void* y, int M, int K, int N, int kernel, dim3 grid,
                          int cluster, int kpp, cudaStream_t stream) {
  if (cluster < 1 || cluster > kMaxCluster) return cudaErrorInvalidValue;
  if (kernel == FFMA_SMALL || kernel == FFMA_TILED) {
    // fp32 x only: the plan gives bf16 x the tensor cores
    if (x_dtype != rt::F32) return cudaErrorInvalidValue;
    if (kernel == FFMA_TILED) {
      if (!covers(grid, 1, kpp, M, K, N, kBM, kBN, 1, 1) || cluster != 1)
        return cudaErrorInvalidValue;
      dequant_matmul_tiled<float, V><<<grid, kThreads, 0, stream>>>(
          static_cast<const float*>(x), static_cast<const uint8_t*>(w), scales,
          static_cast<float*>(y), M, K, N);
      return cudaGetLastError();
    }
    if (!covers(grid, kCluster, kpp, M, K, N, 0, kStrip, 1, kWarps)
        || cluster != kCluster)
      return cudaErrorInvalidValue;
    if (M <= 1) return launch_small<float, V, 1>(x, w, scales, y, M, K, N, grid, kpp, stream);
    if (M <= 2) return launch_small<float, V, 2>(x, w, scales, y, M, K, N, grid, kpp, stream);
    if (M <= 4) return launch_small<float, V, 4>(x, w, scales, y, M, K, N, grid, kpp, stream);
    if (M <= kMaxSmallM)
      return launch_small<float, V, 8>(x, w, scales, y, M, K, N, grid, kpp, stream);
    return cudaErrorInvalidValue;
  }
  if (x_dtype != rt::BF16) return cudaErrorInvalidValue;
  if (kernel == MMA_STREAM) {
    if (M > kMaxSmallM
        || !covers(grid, cluster, kpp, M, K, N, 0, kStrip, kStepK, kStreamWarps))
      return cudaErrorInvalidValue;
    return launch_stream<V>(x, w, scales, y, M, K, N, grid, kpp, stream);
  }
  if (kernel != MMA_TILED
      || !covers(grid, cluster, kpp, M, K, N, TiledLayout::BM, TiledLayout::BN, BK, 1))
    return cudaErrorInvalidValue;
  return launch_tiled<V>(x, w, scales, y, M, K, N, grid, kpp, stream);
}

}  // namespace

// x: (M, K) of x_dtype (F32 or BF16); values: (K, N) of v_dtype (I8 or
// E4M3); scales: (N,) fp32; y: (M, N) of x_dtype. All contiguous. kernel,
// grid (gx, gy, gz), cluster and k_per_part: the plan
// (quant.dequant_matmul_plan), launched as it is.
extern "C" int rt_dequant_matmul(const void* x, int x_dtype, const void* values,
                                 int v_dtype, const void* scales, void* y, int M,
                                 int K, int N, int kernel, int gx, int gy, int gz,
                                 int cluster, int k_per_part, void* stream) {
  if (M == 0 || N == 0) return cudaSuccess;
  if ((x_dtype != rt::F32 && x_dtype != rt::BF16)
      || (v_dtype != rt::I8 && v_dtype != rt::E4M3))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scales);
  const dim3 grid(gx, gy, gz);
  if (v_dtype == rt::E4M3)
    return launch_values<E4M3Values>(x, x_dtype, values, sc, y, M, K, N, kernel, grid,
                                     cluster, k_per_part, s);
  return launch_values<Int8Values>(x, x_dtype, values, sc, y, M, K, N, kernel, grid,
                                   cluster, k_per_part, s);
}
