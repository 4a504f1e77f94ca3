// Helpers shared by the port's hand-written Hopper kernels.
//
// Every kernel takes its activations as float or __nv_bfloat16 (a template
// parameter) and accumulates in fp32. Small parameter vectors (adapter w/b,
// norm scales, bank rows) arrive as untyped pointers with a dtype flag, so a
// bf16 backbone can pass fp32 adapter rows without a conversion launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rt {

// dtype codes shared with the Python wrappers (kernels/_build.py)
enum Dtype { F32 = 0, BF16 = 1, I8 = 2, E4M3 = 3 };

// the finite mask value of the Pallas kernels: a fully masked tile gives
// exp(0) weights that the next valid tile's correction factor wipes out,
// where -inf would give NaN
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }
__device__ __forceinline__ float to_f32(__nv_fp8_e4m3 x) { return static_cast<float>(x); }

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

// a load through the read-only path, or (STREAM) an evict-first one, for
// data read once; a store, or (STREAM) an evict-first one, for data not
// read again soon
template <bool STREAM, typename V>
__device__ __forceinline__ V load_ro(const V* p) {
  if constexpr (STREAM) return __ldcs(p);
  else return __ldg(p);
}
template <bool STREAM, typename V>
__device__ __forceinline__ void store_to(V* p, V v) {
  if constexpr (STREAM) __stcs(p, v);
  else *p = v;
}

// BYTES bytes at p into 32-bit words, with the widest loads they allow (16
// bytes at most each) through the read-only path (STREAM: evict-first);
// the caller guarantees the alignment. BYTES == 2 fills the low half of w[0].
template <int BYTES, bool STREAM = false>
__device__ __forceinline__ void load_bytes(const void* p, uint32_t* w) {
  if constexpr (BYTES >= 16) {
    static_assert(BYTES % 16 == 0, "whole 16-byte loads");
#pragma unroll
    for (int i = 0; i < BYTES / 16; ++i) {
      const uint4 t = load_ro<STREAM>(static_cast<const uint4*>(p) + i);
      w[4 * i] = t.x; w[4 * i + 1] = t.y; w[4 * i + 2] = t.z; w[4 * i + 3] = t.w;
    }
  } else if constexpr (BYTES == 8) {
    const uint2 t = load_ro<STREAM>(static_cast<const uint2*>(p));
    w[0] = t.x; w[1] = t.y;
  } else if constexpr (BYTES == 4) {
    w[0] = load_ro<STREAM>(static_cast<const unsigned int*>(p));
  } else {
    static_assert(BYTES == 2, "2, 4, 8 or a multiple of 16 bytes");
    w[0] = load_ro<STREAM>(static_cast<const unsigned short*>(p));
  }
}

template <int BYTES, bool STREAM = false>
__device__ __forceinline__ void store_bytes(void* p, const uint32_t* w) {
  if constexpr (BYTES >= 16) {
#pragma unroll
    for (int i = 0; i < BYTES / 16; ++i)
      store_to<STREAM>(static_cast<uint4*>(p) + i,
                       make_uint4(w[4 * i], w[4 * i + 1], w[4 * i + 2],
                                  w[4 * i + 3]));
  } else if constexpr (BYTES == 8) {
    store_to<STREAM>(static_cast<uint2*>(p), make_uint2(w[0], w[1]));
  } else if constexpr (BYTES == 4) {
    store_to<STREAM>(static_cast<unsigned int*>(p), w[0]);
  } else {
    store_to<STREAM>(static_cast<unsigned short*>(p),
                     static_cast<unsigned short>(w[0]));
  }
}

// VEC consecutive elements of an fp32 or bf16 vector, held as loaded and
// widened only when read: fp32 as VEC words, bf16 as packed pairs (VEC == 1:
// the low half of one word). The dtype is branched on once per load and
// once per read, never inside the load; bf16 widens exactly by a shift.
template <int VEC>
struct Raw {
  uint32_t w[VEC];

  __device__ __forceinline__ void load(const void* p, bool bf16, long i) {
    if (bf16) load_bytes<VEC * 2>(static_cast<const __nv_bfloat16*>(p) + i, w);
    else load_bytes<VEC * 4>(static_cast<const float*>(p) + i, w);
  }
  __device__ __forceinline__ float get(bool bf16, int j) const {
    if (!bf16) return __uint_as_float(w[j]);
    const uint32_t pair = w[j >> 1];
    return __uint_as_float((j & 1) ? (pair & 0xffff0000u) : (pair << 16));
  }
};

// v[0..VEC) rounded once to T and stored as one access of VEC elements
// (STREAM: evict-first)
template <typename T, int VEC, bool STREAM = false>
__device__ __forceinline__ void store_vec(T* p, const float* v) {
  uint32_t w[(VEC * sizeof(T) + 3) / 4];
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) w[j] = __float_as_uint(v[j]);
  } else if constexpr (VEC == 1) {
    w[0] = __bfloat16_as_ushort(__float2bfloat16_rn(v[0]));
  } else {
#pragma unroll
    for (int j = 0; j < VEC; j += 2) {
      const __nv_bfloat162 pr = __floats2bfloat162_rn(v[j], v[j + 1]);
      w[j / 2] = *reinterpret_cast<const uint32_t*>(&pr);
    }
  }
  store_bytes<VEC * sizeof(T), STREAM>(p, w);
}

// host side: may a 16-byte access start at p?
inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// a row index clamped into [0, n), as jnp.take clamps
__device__ __forceinline__ int clamp_row(int t, int n) {
  return t < 0 ? 0 : (t >= n ? n - 1 : t);
}

// host side: the grid of a per-request elementwise plan
// (sparse.masked_plan): B requests of sd elements in rows of d, each
// request blocks / B blocks of `threads` threads along x (blockIdx.y the
// request), a thread `vec` consecutive elements, 1 or `full` (one 16-byte
// access of the activations). False where the plan does not cover every
// element of every request once, where 16-byte accesses would cross a row
// or start off the 16-byte grid (`aligned`: every pointer on it)
inline bool request_grid(long sd, int d, int B, int vec, int full, int threads,
                         int blocks, bool aligned, dim3* grid) {
  if (B > 65535 || (vec != 1 && vec != full)) return false;
  if (d % vec != 0 || (vec > 1 && !aligned)) return false;
  if (threads < 32 || threads > 1024 || threads % 32 != 0 || blocks % B != 0)
    return false;
  const long per_request = blocks / B;
  const long vecs = sd / vec;
  if (per_request * threads < vecs || (per_request - 1) * threads >= vecs)
    return false;
  *grid = dim3(static_cast<unsigned>(per_request), B);
  return true;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// dynamic shared memory above the 48 KB default needs an opt-in per kernel
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace rt
