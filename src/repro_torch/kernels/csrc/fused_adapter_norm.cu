// Fused Hadamard adapter + residual add + norm, forward.
//
// Replaces: src/repro/kernels/hadamard.py::_fused_call (the pl.pallas_call
// of _fused_kernel), reached through fused_adapter_residual_norm.
//
//   xn = x*w + b + res                  (adapter, then the residual add)
//   h  = RMSNorm(xn)*scale              (bias == nullptr)
//   h  = LayerNorm(xn)*scale + bias     (bias given)
//
// Bound on the H100. Per row it reads x and res and writes xn and h (4 row
// transfers of d elements) against ~10 flops per element, far below the
// card's flop/byte balance point: at a train step's 4096 rows it is bound
// by bytes. At a decode tick's 4 rows it moves ~40 KB, whose byte time
// (~13 ns) is out of reach: there the time is the launch plus the chain of
// dependent steps (load, reduce, load again, reduce, store), so the design
// shortens that chain. Every element crosses device memory once in each
// direction, in fp32 arithmetic, rounded once to x's dtype; LayerNorm takes
// the variance from a second pass, as the reference does. No atomics: every
// sum runs in a fixed order, so a call repeats bit for bit.
//
// The wrapper's plan (hadamard.fused_norm_plan) picks one of two kernels
// and its launch, which the entry point takes as it is:
//
//   warp_row: a row held in registers, on warps_per_row (1, 2 or 4) warps
//     and at most 32 elements a lane, in 16-byte vectors (vec elements).
//     Lane g of the row owns vectors g, g + 32*warps_per_row, ... Every
//     load of the row (x, res, w, b, scale, bias) is issued before any
//     arithmetic, so the row's one trip to memory is the only one; the
//     parameters stay as loaded (bf16 packed) until used. The sums are
//     warp shuffles, then, with more than one warp a row, one exchange of
//     the per-warp sums through shared memory under a named barrier over
//     the row's threads alone: no block-wide barrier. rows_per_block rows
//     share a block, each on its own warps. RMSNorm and LayerNorm are
//     instances of their own (the bias a template flag), so neither
//     carries the other's code or a branch on it; the parameters' dtypes
//     stay runtime flags (fixed at compile time, they timed slower with
//     the row read from device memory).
//   split_row: d too wide or too ragged for that (or a pointer that takes no
//     16-byte access): one row a block of warps_per_row warps, a strided
//     pass over the row in vec-element loads that forms xn, keeps its fp32
//     copy in shared memory (each thread reads back only what it wrote)
//     and sends scale and bias ahead into L2 (the row's copy leaves no room
//     for them at MAX_D), then one shared-memory exchange per sum.
#include "common.cuh"

#include <type_traits>

namespace {

constexpr int kMaxLaneElems = 32;     // warp_row: elements of a row per lane
constexpr int kWarpRowThreads = 256;  // warp_row: threads of a block, at most
constexpr int kMaxThreads = 1024;

struct NormArgs {
  const void* x;
  const void* res;
  const void* w;
  const void* b;
  const void* scale;
  const void* bias;  // nullptr: RMSNorm
  bool w_bf16, b_bf16, scale_bf16, bias_bf16;
  void* xn;
  void* h;
  int n, d;
  float eps;
};

// bar.sync over the `threads` threads of one row: it orders their shared
// memory accesses as __syncthreads does, and waits for no other row
__device__ __forceinline__ void row_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// The row's sum, in every thread of it: shuffles within each warp, then,
// with more than one warp, the warps' sums through `slot` (one float a
// warp), added in warp order so that every thread gets the same bits.
__device__ __forceinline__ float row_sum(float v, float* slot, int warps,
                                         int warp, int bar_id) {
  v = rt::warp_sum(v);
  if (warps == 1) return v;
  if ((threadIdx.x & 31) == 0) slot[warp] = v;
  row_barrier(bar_id, warps * 32);
  float s = 0.f;
  for (int i = 0; i < warps; ++i) s += slot[i];
  return s;
}

// the sum of a lane's running sums, added pairwise
template <int N>
__device__ __forceinline__ float tree_sum(float* s) {
#pragma unroll
  for (int h = N / 2; h > 0; h /= 2)
#pragma unroll
    for (int i = 0; i < h; ++i) s[i] += s[i + h];
  return s[0];
}

// xn of vec elements: x*w + b + res, as the reference orders it
template <int VEC, bool BF16>
__device__ __forceinline__ void adapter_residual(
    const rt::Raw<VEC>& x, const rt::Raw<VEC>& res, const rt::Raw<VEC>& w,
    const rt::Raw<VEC>& b, const NormArgs& a, float* v) {
#pragma unroll
  for (int e = 0; e < VEC; ++e)
    v[e] = x.get(BF16, e) * w.get(a.w_bf16, e) + b.get(a.b_bf16, e)
           + res.get(BF16, e);
}

// at most kWarpRowThreads threads a block, so that a thread may hold its
// share of the row in up to 255 registers; LN: LayerNorm (bias given)
template <typename T, int VEC, int NV, bool LN>
__global__ void __launch_bounds__(kWarpRowThreads) warp_row_kernel(
    const NormArgs a, int warps_per_row, int rows_per_block) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  // per row of the block that spans 2 or 4 warps: one float a warp for
  // each of the two sums; the row's named barrier is 1 + its slot
  __shared__ float slots[kWarpRowThreads / 64][2][4];
  const int warp = threadIdx.x >> 5;
  const int slot = warp / warps_per_row;  // the row within the block
  const int rw = warp % warps_per_row;    // the warp within the row
  const long row = static_cast<long>(blockIdx.x) * rows_per_block + slot;
  if (row >= a.n) return;  // all of the row's warps leave together
  // the row's two sums, one float a warp, when it spans more than one
  float(*my)[4] = slots[warps_per_row > 1 ? slot : 0];
  const int G = warps_per_row * 32;
  const int g = rw * 32 + (threadIdx.x & 31);
  const long base = row * a.d;
  const T* x = static_cast<const T*>(a.x) + base;
  const T* res = static_cast<const T*>(a.res) + base;

  rt::Raw<VEC> xv[NV], rv[NV], wv[NV], bv[NV], sv[NV], cv[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int col = (g + j * G) * VEC;
    xv[j].load(x, kBf16, col);
    rv[j].load(res, kBf16, col);
    wv[j].load(a.w, a.w_bf16, col);
    bv[j].load(a.b, a.b_bf16, col);
    sv[j].load(a.scale, a.scale_bf16, col);
    if constexpr (LN) cv[j].load(a.bias, a.bias_bf16, col);
  }

  // the lane's sums run as VEC running sums over its vectors, then a tree:
  // a chain of NV + log2(VEC) adds, not NV * VEC
  float v[NV][VEC], acc[VEC] = {};
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    adapter_residual<VEC, kBf16>(xv[j], rv[j], wv[j], bv[j], a, v[j]);
    rt::store_vec<T, VEC>(static_cast<T*>(a.xn) + base + (g + j * G) * VEC,
                          v[j]);
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] += LN ? v[j][e] : v[j][e] * v[j][e];
  }
  const int bar = 1 + slot;
  const float total = row_sum(tree_sum<VEC>(acc), my[0], warps_per_row, rw, bar);

  float mu = 0.f, r;
  if constexpr (LN) {
    mu = total / a.d;
    float dev[VEC] = {};
#pragma unroll
    for (int j = 0; j < NV; ++j)
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float c = v[j][e] - mu;
        dev[e] += c * c;
      }
    r = rsqrtf(row_sum(tree_sum<VEC>(dev), my[1], warps_per_row, rw, bar) / a.d
               + a.eps);
  } else {
    r = rsqrtf(total / a.d + a.eps);
  }

#pragma unroll
  for (int j = 0; j < NV; ++j) {
    float hv[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      hv[e] = (v[j][e] - mu) * r * sv[j].get(a.scale_bf16, e);
      if constexpr (LN) hv[e] += cv[j].get(a.bias_bf16, e);
    }
    rt::store_vec<T, VEC>(static_cast<T*>(a.h) + base + (g + j * G) * VEC, hv);
  }
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kMaxThreads) split_row_kernel(const NormArgs a) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  extern __shared__ float smem[];
  float* row = smem;               // d floats: this row's xn in fp32
  float* slots = smem + a.d;       // 2 x 32: one float a warp for each sum
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5;
  const long base = static_cast<long>(blockIdx.x) * a.d;
  const bool layernorm = a.bias != nullptr;
  const T* x = static_cast<const T*>(a.x) + base;
  const T* res = static_cast<const T*>(a.res) + base;
  const int nvec = a.d / VEC;

  float part = 0.f;
  for (int c = threadIdx.x; c < nvec; c += blockDim.x) {
    const int col = c * VEC;
    rt::Raw<VEC> xv, rv, wv, bv;
    xv.load(x, kBf16, col);
    rv.load(res, kBf16, col);
    wv.load(a.w, a.w_bf16, col);
    bv.load(a.b, a.b_bf16, col);
    prefetch_l2(static_cast<const char*>(a.scale) + col * (a.scale_bf16 ? 2 : 4));
    if (layernorm)
      prefetch_l2(static_cast<const char*>(a.bias) + col * (a.bias_bf16 ? 2 : 4));
    float v[VEC];
    adapter_residual<VEC, kBf16>(xv, rv, wv, bv, a, v);
    rt::store_vec<T, VEC>(static_cast<T*>(a.xn) + base + col, v);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      row[col + e] = v[e];  // read back below only by this thread
      part += layernorm ? v[e] : v[e] * v[e];
    }
  }
  const float total = row_sum(part, slots, warps, warp, 1);

  float mu = 0.f, r;
  if (layernorm) {
    mu = total / a.d;
    float dev = 0.f;
    for (int c = threadIdx.x; c < nvec; c += blockDim.x)
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float cd = row[c * VEC + e] - mu;
        dev += cd * cd;
      }
    r = rsqrtf(row_sum(dev, slots + 32, warps, warp, 1) / a.d + a.eps);
  } else {
    r = rsqrtf(total / a.d + a.eps);
  }

  for (int c = threadIdx.x; c < nvec; c += blockDim.x) {
    const int col = c * VEC;
    rt::Raw<VEC> sv, cv;
    sv.load(a.scale, a.scale_bf16, col);
    if (layernorm) cv.load(a.bias, a.bias_bf16, col);
    float hv[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      hv[e] = (row[col + e] - mu) * r * sv.get(a.scale_bf16, e);
      if (layernorm) hv[e] += cv.get(a.bias_bf16, e);
    }
    rt::store_vec<T, VEC>(static_cast<T*>(a.h) + base + col, hv);
  }
}

// warp_row with NV vectors a lane: the instance for nv, NV from 32/VEC down
template <typename T, int VEC, int NV = kMaxLaneElems / VEC>
cudaError_t launch_warp_row(const NormArgs& a, int nv, int warps_per_row,
                            int rows_per_block, int blocks, cudaStream_t s) {
  if constexpr (NV == 0) {
    return cudaErrorInvalidValue;
  } else {
    if (nv != NV)
      return launch_warp_row<T, VEC, NV - 1>(a, nv, warps_per_row,
                                             rows_per_block, blocks, s);
    const int threads = rows_per_block * warps_per_row * 32;
    if (a.bias != nullptr)
      warp_row_kernel<T, VEC, NV, true><<<blocks, threads, 0, s>>>(
          a, warps_per_row, rows_per_block);
    else
      warp_row_kernel<T, VEC, NV, false><<<blocks, threads, 0, s>>>(
          a, warps_per_row, rows_per_block);
    return cudaGetLastError();
  }
}

template <typename T, int VEC>
cudaError_t launch_split_row(const NormArgs& a, int warps_per_row,
                             cudaStream_t s) {
  const size_t smem = (static_cast<size_t>(a.d) + 64) * sizeof(float);
  auto kernel = split_row_kernel<T, VEC>;
  cudaError_t err = rt::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<a.n, warps_per_row * 32, smem, s>>>(a);
  return cudaGetLastError();
}

// the plan checked, then launched as it is
template <typename T>
cudaError_t launch(const NormArgs& a, int kernel, int vec, int warps_per_row,
                   int rows_per_block, int blocks, cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(T);
  const void* ptrs[] = {a.x, a.res, a.w, a.b, a.scale, a.bias, a.xn, a.h};
  if (vec != 1 && vec != kVec) return cudaErrorInvalidValue;
  if (a.d % vec != 0) return cudaErrorInvalidValue;
  for (const void* p : ptrs)
    if (vec > 1 && p != nullptr && !rt::aligned16(p)) return cudaErrorInvalidValue;
  // every row once: the blocks cover the rows, and none is left idle
  if (rows_per_block < 1 || static_cast<long>(blocks) * rows_per_block < a.n ||
      static_cast<long>(blocks - 1) * rows_per_block >= a.n)
    return cudaErrorInvalidValue;
  if (kernel == 0) {  // warp_row: every element of a row once, in registers
    const int lanes = warps_per_row * 32;
    if (vec != kVec || (warps_per_row != 1 && warps_per_row != 2 &&
                        warps_per_row != 4) ||
        a.d % (lanes * vec) != 0 || rows_per_block * lanes > kWarpRowThreads)
      return cudaErrorInvalidValue;
    return launch_warp_row<T, kVec>(a, a.d / (lanes * vec), warps_per_row,
                                    rows_per_block, blocks, s);
  }
  if (kernel != 1 || rows_per_block != 1 || warps_per_row < 1 ||
      warps_per_row > kMaxThreads / 32)
    return cudaErrorInvalidValue;
  return vec == 1 ? launch_split_row<T, 1>(a, warps_per_row, s)
                  : launch_split_row<T, kVec>(a, warps_per_row, s);
}

}  // namespace

// kernel (0 warp_row, 1 split_row), vec, warps_per_row, rows_per_block,
// blocks: the plan (hadamard.fused_norm_plan), refused unless it covers
// every row, and every element of a row, once
extern "C" int rt_fused_adapter_norm(
    const void* x, const void* res, const void* w, int w_bf16, const void* b,
    int b_bf16, const void* scale, int scale_bf16, const void* bias,
    int bias_bf16, void* xn, void* h, int n, int d, float eps, int dtype,
    int kernel, int vec, int warps_per_row, int rows_per_block, int blocks,
    void* stream) {
  if (n == 0) return cudaSuccess;
  const NormArgs a{x, res, w, b, scale, bias, w_bf16 != 0, b_bf16 != 0,
                   scale_bf16 != 0, bias_bf16 != 0, xn, h, n, d, eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == rt::BF16)
    return launch<__nv_bfloat16>(a, kernel, vec, warps_per_row, rows_per_block,
                                 blocks, s);
  return launch<float>(a, kernel, vec, warps_per_row, rows_per_block, blocks, s);
}
