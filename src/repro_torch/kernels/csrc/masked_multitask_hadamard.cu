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
// Bound on the H100. Five flops per element against one element read and
// one written: memory, at a prefill's 128 rows. At a decode tick's 4 rows
// of 1024 it moves ~16 KB, whose byte time is out of reach: the time is the
// launch plus the longest chain of dependent loads, which the design keeps
// to max(x, id -> bank rows). Every thread owns one vector of `vec`
// elements (16 bytes of x: 8 bf16 or 4 fp32; 1 element where d is ragged
// or a pointer takes no 16-byte access), issues its x load first, then
// reads the task id and the gate itself (a broadcast load through L1: no
// shared memory, no barrier) and loads its w and b elements as 16-byte
// vectors of the bank rows (kilobytes, in L1/L2). The grid, from the
// wrapper's plan (sparse.masked_plan), gives each request blockIdx.y and
// blocks of `threads` threads that cover its S*d elements once. The formula
// is computed as written, in fp32, with separately rounded operations and
// no branch on g, so a non-finite input gives what the Pallas kernel
// gives; the result is rounded once to x's dtype.
#include "common.cuh"

#include <type_traits>

namespace {

struct MaskedArgs {
  const void* x;
  const void* w_bank;
  const void* b_bank;
  const float* gate;
  const int* task_ids;
  void* y;
  bool w_bf16, b_bf16;
  int n_w, n_b, n_gate;
  int sd, d;  // elements of a request, and of a row
};

// x + g*(x*(w - 1) + b), each operation rounded on its own as the plain
// version rounds it
__device__ __forceinline__ float masked_affine(float x, float w, float b,
                                               float g) {
  return __fadd_rn(x, __fmul_rn(g, __fadd_rn(__fmul_rn(x, __fsub_rn(w, 1.f)), b)));
}

template <typename T, int VEC>
__global__ void masked_multitask_kernel(const MaskedArgs a) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  const int req = blockIdx.y;
  const int e = (blockIdx.x * blockDim.x + threadIdx.x) * VEC;
  if (e >= a.sd) return;
  const long at = static_cast<long>(req) * a.sd + e;
  rt::Raw<VEC> xv;
  xv.load(a.x, kBf16, at);  // first: it does not wait for the task id
  const int t = __ldg(a.task_ids + req);
  const int c = e % a.d;  // d % VEC == 0: the vector lies in one row
  rt::Raw<VEC> wv, bv;
  wv.load(a.w_bank, a.w_bf16, static_cast<long>(rt::clamp_row(t, a.n_w)) * a.d + c);
  bv.load(a.b_bank, a.b_bf16, static_cast<long>(rt::clamp_row(t, a.n_b)) * a.d + c);
  const float g = __ldg(a.gate + rt::clamp_row(t, a.n_gate));
  float v[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j)
    v[j] = masked_affine(xv.get(kBf16, j), wv.get(a.w_bf16, j),
                         bv.get(a.b_bf16, j), g);
  rt::store_vec<T, VEC>(static_cast<T*>(a.y) + at, v);
}

// the plan checked (every element of every request once), then launched
template <typename T>
cudaError_t launch(const MaskedArgs& a, int B, int vec, int threads,
                   int blocks, cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(T);
  const bool aligned = rt::aligned16(a.x) && rt::aligned16(a.y) &&
                       rt::aligned16(a.w_bank) && rt::aligned16(a.b_bank);
  dim3 grid;
  if (!rt::request_grid(a.sd, a.d, B, vec, kVec, threads, blocks,
                        aligned, &grid))
    return cudaErrorInvalidValue;
  if (vec == 1)
    masked_multitask_kernel<T, 1><<<grid, threads, 0, s>>>(a);
  else
    masked_multitask_kernel<T, kVec><<<grid, threads, 0, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

// vec, threads, blocks: the plan (sparse.masked_plan), refused unless its
// blocks (blocks / B along x for each request) cover every element once
extern "C" int rt_masked_multitask_hadamard(
    const void* x, const void* w_bank, int w_bf16, int n_w, const void* b_bank,
    int b_bf16, int n_b, const void* gate, int n_gate, const void* task_ids,
    void* y, int B, int S, int d, int dtype, int vec, int threads, int blocks,
    void* stream) {
  if (B == 0 || S == 0 || d == 0) return cudaSuccess;
  const long sd = static_cast<long>(S) * d;
  // element offsets within a request are 32-bit, with room for a last block
  if (sd > 0x7fff0000L) return cudaErrorInvalidValue;
  const MaskedArgs a{x, w_bank, b_bank, static_cast<const float*>(gate),
                     static_cast<const int*>(task_ids), y, w_bf16 != 0,
                     b_bf16 != 0, n_w, n_b, n_gate, static_cast<int>(sd), d};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == rt::BF16)
    return launch<__nv_bfloat16>(a, B, vec, threads, blocks, s);
  return launch<float>(a, B, vec, threads, blocks, s);
}
