// Helpers shared by the port's hand-written Hopper kernels.
//
// Every kernel takes its activations as float or __nv_bfloat16 (a template
// parameter) and accumulates in fp32. Small parameter vectors (adapter w/b,
// norm scales, bank rows) arrive as untyped pointers with a dtype flag, so a
// bf16 backbone can pass fp32 adapter rows without a conversion launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rt {

// dtype codes shared with the Python wrappers (kernels/_build.py)
enum Dtype { F32 = 0, BF16 = 1, I8 = 2 };

// the finite mask value of the Pallas kernels: a fully masked tile gives
// exp(0) weights that the next valid tile's correction factor wipes out,
// where -inf would give NaN
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
// round to nearest even, as torch's .to(torch.bfloat16)
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// element i of a parameter vector stored as fp32 (is_bf16 = 0) or bf16 (1)
__device__ __forceinline__ float load_vec(const void* p, int is_bf16, long i) {
  return is_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
                 : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Block-wide sum, returned to every thread. scratch: >= 32 floats of shared
// memory; the leading barrier lets consecutive calls reuse it.
__device__ __forceinline__ float block_sum(float v, float* scratch) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nw = (blockDim.x + 31) >> 5;
  v = warp_sum(v);
  __syncthreads();
  if (lane == 0) scratch[wid] = v;
  __syncthreads();
  return warp_sum(lane < nw ? scratch[lane] : 0.f);
}

// dynamic shared memory above the 48 KB default needs an opt-in per kernel
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace rt
