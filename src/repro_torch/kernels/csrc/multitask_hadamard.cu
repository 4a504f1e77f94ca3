// Batched multi-task Hadamard adapter, forward.
//
// Replaces: src/repro/kernels/multitask.py::multitask_hadamard_tpu.
//
//   y[i] = x[i] * w_bank[tid[i]] + b_bank[tid[i]]     x: (B, S, d)
//
// Bound on the H100: memory. Two flops per element against one element
// read and one written. The Pallas kernel uses scalar prefetch so the task
// id drives the BlockSpec index map; here each block reads its request's
// task id once and indexes the bank row directly, so no gathered (B, d)
// copy of the adapters is ever written to device memory. Grid: y covers
// the batch (one request per blockIdx.y), x strides over the request's S*d
// elements with neighbouring threads on neighbouring addresses. The bank
// rows (T*d*4 bytes, kilobytes) stay in L1/L2. An out-of-range task id is
// clamped, as jnp.take clamps; the engine validates ids on the host.
#include "common.cuh"

namespace {

template <typename T>
__global__ void multitask_hadamard_kernel(
    const T* __restrict__ x, const void* w_bank, int w_bf16, const void* b_bank,
    int b_bf16, const int* __restrict__ task_ids, T* __restrict__ y, long sd,
    int d, int n_tasks) {
  const int row = blockIdx.y;
  int t = task_ids[row];
  t = t < 0 ? 0 : (t >= n_tasks ? n_tasks - 1 : t);
  const long wofs = static_cast<long>(t) * d;
  const T* xr = x + row * sd;
  T* yr = y + row * sd;
  for (long e = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x; e < sd;
       e += static_cast<long>(gridDim.x) * blockDim.x) {
    const long c = wofs + e % d;
    yr[e] = rt::from_f32<T>(rt::to_f32(xr[e]) * rt::load_vec(w_bank, w_bf16, c)
                            + rt::load_vec(b_bank, b_bf16, c));
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w_bank, int w_bf16,
                   const void* b_bank, int b_bf16, const int* task_ids, void* y,
                   int B, long sd, int d, int n_tasks, cudaStream_t stream) {
  const int threads = 256;
  long blocks = (sd + threads - 1) / threads;
  if (blocks > 1024) blocks = 1024;
  dim3 grid(static_cast<unsigned>(blocks), B);
  multitask_hadamard_kernel<T><<<grid, threads, 0, stream>>>(
      static_cast<const T*>(x), w_bank, w_bf16, b_bank, b_bf16, task_ids,
      static_cast<T*>(y), sd, d, n_tasks);
  return cudaGetLastError();
}

}  // namespace

extern "C" int rt_multitask_hadamard(const void* x, const void* w_bank,
                                     int w_bf16, const void* b_bank, int b_bf16,
                                     const void* task_ids, void* y, int B, int S,
                                     int d, int n_tasks, int dtype, void* stream) {
  if (B == 0 || S == 0) return cudaSuccess;
  const long sd = static_cast<long>(S) * d;
  const int* tids = static_cast<const int*>(task_ids);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == rt::BF16)
    return launch<__nv_bfloat16>(x, w_bank, w_bf16, b_bank, b_bf16, tids, y, B,
                                 sd, d, n_tasks, s);
  return launch<float>(x, w_bank, w_bf16, b_bank, b_bf16, tids, y, B, sd, d,
                       n_tasks, s);
}
