// Batched multi-task Hadamard adapter, forward.
//
// Replaces: src/repro/kernels/multitask.py::multitask_hadamard_tpu.
//
//   y[i] = x[i] * w_bank[tid[i]] + b_bank[tid[i]]     x: (B, S, d)
//
// The Pallas kernel uses scalar prefetch so the task id drives the
// BlockSpec index map; here every thread reads its request's task id and
// indexes the bank rows directly, so no gathered (B, d) copy of the
// adapters is ever written to device memory. An out-of-range task id is
// clamped, as jnp.take clamps; the engine validates ids on the host.
//
// Bound on the H100. Two flops per element against one element read and
// one written: memory, at a prefill's 128 rows. At a decode tick's 4 rows
// of 1024 it moves ~16 KB, whose byte time is out of reach: the time is the
// launch plus the longest chain of dependent loads. The design is the
// masked multitask kernel's (masked_multitask_hadamard.cu), which keeps
// that chain to max(x, id -> bank rows): every thread owns one vector of
// `vec` elements (16 bytes of x: 8 bf16 or 4 fp32; 1 element where d is
// ragged or a pointer takes no 16-byte access), issues its x load first,
// then reads the task id itself (a broadcast load through L1: no shared
// memory, no barrier) and loads its w and b elements as 16-byte vectors of
// the bank rows (kilobytes, in L1/L2), widened only when used. The grid,
// from the wrapper's plan (sparse.masked_plan, shared with that kernel),
// gives each request blockIdx.y and blocks of `threads` threads that
// cover its S*d elements once. y = x*w + b is computed in fp32 as the
// plain version rounds it, a product and a sum each rounded (no FMA), and
// rounded once to x's dtype.
#include "common.cuh"

#include <type_traits>

namespace {

struct MultitaskArgs {
  const void* x;
  const void* w_bank;
  const void* b_bank;
  const int* task_ids;
  void* y;
  bool w_bf16, b_bf16;
  int n_tasks;
  int sd, d;  // elements of a request, and of a row
};

template <typename T, int VEC>
__global__ void multitask_hadamard_kernel(const MultitaskArgs a) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  const int req = blockIdx.y;
  const int e = (blockIdx.x * blockDim.x + threadIdx.x) * VEC;
  if (e >= a.sd) return;
  const long at = static_cast<long>(req) * a.sd + e;
  rt::Raw<VEC> xv;
  xv.load(a.x, kBf16, at);  // first: it does not wait for the task id
  const int t = rt::clamp_row(__ldg(a.task_ids + req), a.n_tasks);
  // d % VEC == 0: the vector lies in one row
  const long row = static_cast<long>(t) * a.d + e % a.d;
  rt::Raw<VEC> wv, bv;
  wv.load(a.w_bank, a.w_bf16, row);
  bv.load(a.b_bank, a.b_bf16, row);
  float v[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j)
    v[j] = __fadd_rn(__fmul_rn(xv.get(kBf16, j), wv.get(a.w_bf16, j)),
                     bv.get(a.b_bf16, j));
  rt::store_vec<T, VEC>(static_cast<T*>(a.y) + at, v);
}

// the plan checked (every element of every request once), then launched
template <typename T>
cudaError_t launch(const MultitaskArgs& a, int B, int vec, int threads,
                   int blocks, cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(T);
  const bool aligned = rt::aligned16(a.x) && rt::aligned16(a.y) &&
                       rt::aligned16(a.w_bank) && rt::aligned16(a.b_bank);
  dim3 grid;
  if (!rt::request_grid(a.sd, a.d, B, vec, kVec, threads, blocks, aligned,
                        &grid))
    return cudaErrorInvalidValue;
  if (vec == 1)
    multitask_hadamard_kernel<T, 1><<<grid, threads, 0, s>>>(a);
  else
    multitask_hadamard_kernel<T, kVec><<<grid, threads, 0, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

// vec, threads, blocks: the plan (sparse.masked_plan), refused unless its
// blocks (blocks / B along x for each request) cover every element once
extern "C" int rt_multitask_hadamard(const void* x, const void* w_bank,
                                     int w_bf16, const void* b_bank, int b_bf16,
                                     const void* task_ids, void* y, int B, int S,
                                     int d, int n_tasks, int dtype, int vec,
                                     int threads, int blocks, void* stream) {
  if (B == 0 || S == 0 || d == 0) return cudaSuccess;
  if (n_tasks < 1) return cudaErrorInvalidValue;
  const long sd = static_cast<long>(S) * d;
  // element offsets within a request are 32-bit, with room for a last block
  if (sd > 0x7fff0000L) return cudaErrorInvalidValue;
  const MultitaskArgs a{x, w_bank, b_bank, static_cast<const int*>(task_ids),
                        y, w_bf16 != 0, b_bf16 != 0, n_tasks,
                        static_cast<int>(sd), d};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == rt::BF16)
    return launch<__nv_bfloat16>(a, B, vec, threads, blocks, s);
  return launch<float>(a, B, vec, threads, blocks, s);
}
