// Hadamard adapter affine, forward and backward.
//
// Replaces: src/repro/kernels/hadamard.py::_affine_call (forward, the
// pl.pallas_call of _affine_fwd_kernel) and ::_affine_bwd_call (its VJP,
// _affine_bwd_kernel), reached through hadamard_affine and, for the
// backward, through fused_adapter_residual_norm's _fused_bwd.
//
//   forward:  y  = x*w + b                          x, y: (n, d); w, b: (d,)
//   backward: dx = g*w;  dw = sum_rows g*x;  db = sum_rows g  (fp32 sums)
//
// Bound on the H100: memory. The forward moves 2*n*d elements for 2 flops
// each, the backward 3*n*d elements for ~5 flops each; both sit two orders
// of magnitude below the card's flop/byte balance point. The design reads
// each element once and writes each output once: a block covers a tile of
// 128 columns (32 lanes x 4 adjacent columns, one 16-byte fp32 load or
// 8-byte bf16 load per row) over a run of 64 rows (8 warps x 8 rows each),
// with the tile's w and b held in registers for all of its rows.
//
// The TPU kernel accumulates dw/db across its sequential row grid. Hopper
// blocks run in no order, so the backward takes two passes and no atomics
// (atomics would make dw/db differ from run to run): pass 1 writes dx and
// one fp32 partial (sum g*x, sum g) per (row chunk, column) into a scratch
// (n_chunks, 2, d) buffer, the 8 warps of a block added in a fixed order
// through shared memory; pass 2 sums the chunks of each column in chunk
// order. Rows past n are never read (the row loop stops at n), which is
// the Pallas kernel's pad-row mask. One C call launches both passes.
#include <initializer_list>
#include <utility>

#include "common.cuh"

namespace {

constexpr int kVec = 4;                // adjacent columns per thread
constexpr int kTx = 32;                // threads across a column tile
constexpr int kTy = 8;                 // threads down a row chunk
constexpr int kTileCols = kTx * kVec;  // 128
constexpr int kChunkRows = 64;         // rows per block (and per partial)
constexpr int kReduceThreads = 256;

__device__ __forceinline__ void load4(const float* p, float v[kVec]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[kVec]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
}

__device__ __forceinline__ void store4(float* p, const float v[kVec]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float v[kVec]) {
  uint2 raw;
  *reinterpret_cast<__nv_bfloat162*>(&raw.x) = __floats2bfloat162_rn(v[0], v[1]);
  *reinterpret_cast<__nv_bfloat162*>(&raw.y) = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) = raw;
}

// the kVec elements of row `off` starting at column c0; columns past d read 0
template <typename T>
__device__ __forceinline__ void load_row(const T* p, long off, int c0, int d,
                                         bool vec, float v[kVec]) {
  if (vec) {
    load4(p + off, v);
    return;
  }
#pragma unroll
  for (int j = 0; j < kVec; ++j) v[j] = c0 + j < d ? rt::to_f32(p[off + j]) : 0.f;
}

template <typename T>
__device__ __forceinline__ void store_row(T* p, long off, int c0, int d,
                                          bool vec, const float v[kVec]) {
  if (vec) {
    store4(p + off, v);
    return;
  }
#pragma unroll
  for (int j = 0; j < kVec; ++j)
    if (c0 + j < d) p[off + j] = rt::from_f32<T>(v[j]);
}

// one past the last row of row chunk `chunk`
__device__ __forceinline__ long chunk_end(unsigned chunk, long n) {
  const long e = (static_cast<long>(chunk) + 1) * kChunkRows;
  return e < n ? e : n;
}

// grid (row chunks, column tiles); block (kTx, kTy)
template <typename T>
__global__ void __launch_bounds__(kTx * kTy) affine_fwd_kernel(
    const T* __restrict__ x, const void* w, int w_bf16, const void* b,
    int b_bf16, T* __restrict__ y, long n, int d, int aligned) {
  const int c0 = (blockIdx.y * kTx + threadIdx.x) * kVec;
  if (c0 >= d) return;
  const bool vec = aligned && c0 + kVec <= d;
  float wv[kVec], bv[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    const bool in = c0 + j < d;
    wv[j] = in ? rt::load_vec(w, w_bf16, c0 + j) : 0.f;
    bv[j] = in ? rt::load_vec(b, b_bf16, c0 + j) : 0.f;
  }
  const long r_end = chunk_end(blockIdx.x, n);
  for (long r = static_cast<long>(blockIdx.x) * kChunkRows + threadIdx.y;
       r < r_end; r += kTy) {
    const long off = r * d + c0;
    float v[kVec];
    load_row(x, off, c0, d, vec, v);
    // separate multiply and add, rounded as the plain version rounds
#pragma unroll
    for (int j = 0; j < kVec; ++j) v[j] = __fadd_rn(__fmul_rn(v[j], wv[j]), bv[j]);
    store_row(y, off, c0, d, vec, v);
  }
}

// pass 1: dx, and per-chunk partial sums partial[chunk][0|1][col]
template <typename TG, typename TX>
__global__ void __launch_bounds__(kTx * kTy) affine_bwd_partial_kernel(
    const TG* __restrict__ g, const TX* __restrict__ x, const void* w,
    int w_bf16, TG* __restrict__ dx, float* __restrict__ partial, long n,
    int d, int aligned) {
  __shared__ float red[2][kTy][kTileCols];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int c0 = (blockIdx.y * kTx + tx) * kVec;
  const bool active = c0 < d;
  const bool vec = aligned && c0 + kVec <= d;
  float wv[kVec], sgx[kVec], sg[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    wv[j] = c0 + j < d ? rt::load_vec(w, w_bf16, c0 + j) : 0.f;
    sgx[j] = 0.f;
    sg[j] = 0.f;
  }
  if (active) {
    const long r_end = chunk_end(blockIdx.x, n);
    for (long r = static_cast<long>(blockIdx.x) * kChunkRows + ty; r < r_end;
         r += kTy) {
      const long off = r * d + c0;
      float gv[kVec], xv[kVec], dv[kVec];
      load_row(g, off, c0, d, vec, gv);
      load_row(x, off, c0, d, vec, xv);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        dv[j] = __fmul_rn(gv[j], wv[j]);
        sgx[j] += gv[j] * xv[j];
        sg[j] += gv[j];
      }
      store_row(dx, off, c0, d, vec, dv);
    }
  }
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    red[0][ty][tx * kVec + j] = sgx[j];
    red[1][ty][tx * kVec + j] = sg[j];
  }
  __syncthreads();
  // warp 0 adds the 8 warps' sums of g*x, warp 1 those of g, in warp order
  if (ty < 2 && active) {
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      if (c0 + j >= d) break;
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < kTy; ++k) s += red[ty][k][tx * kVec + j];
      partial[(2L * blockIdx.x + ty) * d + c0 + j] = s;
    }
  }
}

// pass 2: dw[c] = sum over chunks of partial[chunk][0][c], db from [1]
__global__ void affine_bwd_reduce_kernel(const float* __restrict__ partial,
                                         float* __restrict__ dw,
                                         float* __restrict__ db, int n_chunks,
                                         int d) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= d) return;
  float sw = 0.f, sb = 0.f;
  for (int k = 0; k < n_chunks; ++k) {
    sw += partial[(2L * k) * d + c];
    sb += partial[(2L * k + 1) * d + c];
  }
  dw[c] = sw;
  db[c] = sb;
}

dim3 tile_grid(long n, int d) {
  return dim3(static_cast<unsigned>((n + kChunkRows - 1) / kChunkRows),
              static_cast<unsigned>((d + kTileCols - 1) / kTileCols));
}

template <typename T>
cudaError_t launch_fwd(const void* x, const void* w, int w_bf16, const void* b,
                       int b_bf16, void* y, long n, int d, int aligned,
                       cudaStream_t stream) {
  affine_fwd_kernel<T><<<tile_grid(n, d), dim3(kTx, kTy), 0, stream>>>(
      static_cast<const T*>(x), w, w_bf16, b, b_bf16, static_cast<T*>(y), n, d,
      aligned);
  return cudaGetLastError();
}

template <typename TG, typename TX>
cudaError_t launch_bwd(const void* g, const void* x, const void* w, int w_bf16,
                       void* dx, float* dw, float* db, float* partial, long n,
                       int d, int aligned, cudaStream_t stream) {
  affine_bwd_partial_kernel<TG, TX><<<tile_grid(n, d), dim3(kTx, kTy), 0, stream>>>(
      static_cast<const TG*>(g), static_cast<const TX*>(x), w, w_bf16,
      static_cast<TG*>(dx), partial, n, d, aligned);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n_chunks = static_cast<int>((n + kChunkRows - 1) / kChunkRows);
  affine_bwd_reduce_kernel<<<(d + kReduceThreads - 1) / kReduceThreads,
                             kReduceThreads, 0, stream>>>(partial, dw, db,
                                                          n_chunks, d);
  return cudaGetLastError();
}

// vector loads need d a multiple of kVec and every row start on a boundary
// of kVec elements, which holds when each base pointer is so aligned
bool vec_aligned(int d, std::initializer_list<std::pair<const void*, int>> ptrs) {
  if (d % kVec) return false;
  for (const auto& p : ptrs)
    if (reinterpret_cast<uintptr_t>(p.first) % (kVec * p.second)) return false;
  return true;
}

int elem_size(int dtype) { return dtype == rt::BF16 ? 2 : 4; }

}  // namespace

extern "C" int rt_hadamard_affine_chunk_rows() { return kChunkRows; }

extern "C" int rt_hadamard_affine(const void* x, const void* w, int w_bf16,
                                  const void* b, int b_bf16, void* y, long n,
                                  int d, int dtype, void* stream) {
  if (n == 0 || d == 0) return cudaSuccess;
  const int es = elem_size(dtype);
  const int aligned = vec_aligned(d, {{x, es}, {y, es}});
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == rt::BF16)
    return launch_fwd<__nv_bfloat16>(x, w, w_bf16, b, b_bf16, y, n, d, aligned, s);
  return launch_fwd<float>(x, w, w_bf16, b, b_bf16, y, n, d, aligned, s);
}

// partial: fp32 scratch of (ceil(n / chunk_rows), 2, d); dw, db: fp32 (d,)
extern "C" int rt_hadamard_affine_bwd(const void* g, int g_dtype, const void* x,
                                      int x_dtype, const void* w, int w_bf16,
                                      void* dx, void* dw, void* db,
                                      void* partial, long n, int d,
                                      void* stream) {
  if (d == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dwf = static_cast<float*>(dw);
  float* dbf = static_cast<float*>(db);
  if (n == 0) {  // empty sums
    cudaError_t err = cudaMemsetAsync(dwf, 0, sizeof(float) * d, s);
    if (err != cudaSuccess) return err;
    return cudaMemsetAsync(dbf, 0, sizeof(float) * d, s);
  }
  float* part = static_cast<float*>(partial);
  const int ge = elem_size(g_dtype), xe = elem_size(x_dtype);
  const int aligned = vec_aligned(d, {{g, ge}, {dx, ge}, {x, xe}});
  const bool gb = g_dtype == rt::BF16, xb = x_dtype == rt::BF16;
  if (gb && xb)
    return launch_bwd<__nv_bfloat16, __nv_bfloat16>(g, x, w, w_bf16, dx, dwf, dbf,
                                                    part, n, d, aligned, s);
  if (gb)
    return launch_bwd<__nv_bfloat16, float>(g, x, w, w_bf16, dx, dwf, dbf, part,
                                            n, d, aligned, s);
  if (xb)
    return launch_bwd<float, __nv_bfloat16>(g, x, w, w_bf16, dx, dwf, dbf, part,
                                            n, d, aligned, s);
  return launch_bwd<float, float>(g, x, w, w_bf16, dx, dwf, dbf, part, n, d,
                                  aligned, s);
}
