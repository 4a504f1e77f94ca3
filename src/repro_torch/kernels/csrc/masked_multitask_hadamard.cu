// Masked (redundancy-aware) multi-task Hadamard adapter, forward.
//
// Replaces: src/repro/kernels/sparse.py::_call (the pl.pallas_call of
// masked_multitask_hadamard_tpu).
//
//   y[i] = x[i] + g[t] * (x[i] * (w_bank[tw] - 1) + b_bank[tb])
//   x: (B, S, d); t = task_ids[i]; g = gate[t]
//
// A pruned tenant's bank rows pass through as the identity inside the op
// (gate 0), so one launch serves a mixed sparse/dense batch with no branch
// and no gathered copy of the adapters.
//
// Shared-w banks. A shared-w bank stores ONE w row per layer but `size` b
// rows; the JAX serving tick gathers both leaves through `select_tasks`,
// which clamps the index per leaf. This kernel therefore takes the w, b
// and gate row counts separately and clamps the task id into each: that is
// what the serving path computes. (The Pallas kernel, given such a bank,
// would index its w BlockSpec out of range.)
//
// Bound on the H100: memory. Five flops per element against one element
// read and one written, two orders of magnitude below the card's flop/byte
// balance point. Grid: y covers the batch (one request per blockIdx.y),
// x strides over the request's S*d elements. Each block reads its row's
// task id and gate once; each thread moves 4 adjacent elements with one
// 16-byte (fp32) or 8-byte (bf16) load and store where d is a multiple of
// 4 and the rows are aligned, as hadamard_affine.cu does. The bank rows
// (kilobytes) stay in L1/L2. The formula is computed as written, in fp32,
// with separately rounded operations and no branch on g, so a non-finite
// input gives what the Pallas kernel gives; the result is rounded once to
// x's dtype.
#include "common.cuh"

namespace {

constexpr int kVec = 4;
constexpr int kThreads = 256;

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

__device__ __forceinline__ int clamp_row(int t, int n) {
  return t < 0 ? 0 : (t >= n ? n - 1 : t);
}

// x + g*(x*(w - 1) + b), each operation rounded on its own as the plain
// version rounds it
__device__ __forceinline__ float masked_affine(float x, float w, float b,
                                               float g) {
  return __fadd_rn(x, __fmul_rn(g, __fadd_rn(__fmul_rn(x, __fsub_rn(w, 1.f)), b)));
}

template <typename T>
__global__ void __launch_bounds__(kThreads) masked_multitask_kernel(
    const T* __restrict__ x, const void* w_bank, int w_bf16, int n_w,
    const void* b_bank, int b_bf16, int n_b, const float* __restrict__ gate,
    int n_gate, const int* __restrict__ task_ids, T* __restrict__ y, long sd,
    int d, int vec) {
  __shared__ int s_row[2];
  __shared__ float s_gate;
  const int req = blockIdx.y;
  if (threadIdx.x == 0) {
    const int t = task_ids[req];
    s_row[0] = clamp_row(t, n_w);
    s_row[1] = clamp_row(t, n_b);
    s_gate = gate[clamp_row(t, n_gate)];
  }
  __syncthreads();
  const long wofs = static_cast<long>(s_row[0]) * d;
  const long bofs = static_cast<long>(s_row[1]) * d;
  const float g = s_gate;
  const T* xr = x + req * sd;
  T* yr = y + req * sd;
  const long stride = static_cast<long>(gridDim.x) * blockDim.x;
  if (vec) {
    // d % 4 == 0: the 4 elements of a thread lie in one row of d
    for (long e = (static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x) * kVec;
         e < sd; e += stride * kVec) {
      const int c = static_cast<int>(e % d);
      float v[kVec];
      load4(xr + e, v);
#pragma unroll
      for (int j = 0; j < kVec; ++j)
        v[j] = masked_affine(v[j], rt::load_vec(w_bank, w_bf16, wofs + c + j),
                             rt::load_vec(b_bank, b_bf16, bofs + c + j), g);
      store4(yr + e, v);
    }
    return;
  }
  for (long e = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x; e < sd;
       e += stride) {
    const int c = static_cast<int>(e % d);
    yr[e] = rt::from_f32<T>(masked_affine(rt::to_f32(xr[e]),
                                          rt::load_vec(w_bank, w_bf16, wofs + c),
                                          rt::load_vec(b_bank, b_bf16, bofs + c), g));
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w_bank, int w_bf16, int n_w,
                   const void* b_bank, int b_bf16, int n_b, const float* gate,
                   int n_gate, const int* task_ids, void* y, int B, long sd,
                   int d, cudaStream_t stream) {
  const size_t align = kVec * sizeof(T);
  const int vec = d % kVec == 0 && reinterpret_cast<uintptr_t>(x) % align == 0 &&
                  reinterpret_cast<uintptr_t>(y) % align == 0;
  const long work = vec ? sd / kVec : sd;
  long blocks = (work + kThreads - 1) / kThreads;
  if (blocks > 1024) blocks = 1024;
  dim3 grid(static_cast<unsigned>(blocks), B);
  masked_multitask_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), w_bank, w_bf16, n_w, b_bank, b_bf16, n_b, gate,
      n_gate, task_ids, static_cast<T*>(y), sd, d, vec);
  return cudaGetLastError();
}

}  // namespace

extern "C" int rt_masked_multitask_hadamard(
    const void* x, const void* w_bank, int w_bf16, int n_w, const void* b_bank,
    int b_bf16, int n_b, const void* gate, int n_gate, const void* task_ids,
    void* y, int B, int S, int d, int dtype, void* stream) {
  if (B == 0 || S == 0 || d == 0) return cudaSuccess;
  const long sd = static_cast<long>(S) * d;
  const float* g = static_cast<const float*>(gate);
  const int* tids = static_cast<const int*>(task_ids);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == rt::BF16)
    return launch<__nv_bfloat16>(x, w_bank, w_bf16, n_w, b_bank, b_bf16, n_b, g,
                                 n_gate, tids, y, B, sd, d, s);
  return launch<float>(x, w_bank, w_bf16, n_w, b_bank, b_bf16, n_b, g, n_gate,
                       tids, y, B, sd, d, s);
}
