// Fused Hadamard adapter + residual add + norm, forward.
//
// Replaces: src/repro/kernels/hadamard.py::_fused_call (the pl.pallas_call
// of _fused_kernel), reached through fused_adapter_residual_norm.
//
//   xn = x*w + b + res                  (adapter, then the residual add)
//   h  = RMSNorm(xn)*scale              (bias == nullptr)
//   h  = LayerNorm(xn)*scale + bias     (bias given)
//
// Bound on the H100: memory. Per row it reads x and res and writes xn and h
// (4 row transfers of d elements) against ~10 flops per element, far below
// the card's ~295 flop/byte balance point. The design keeps the row in
// shared memory as fp32 so each element crosses device memory exactly once
// in each direction: one block per row, a strided pass that forms xn,
// stores it and accumulates the row statistic, a block-wide fp32 reduction
// (warp shuffles, then one warp over the per-warp partials), and a second
// pass over the shared copy that writes h. LayerNorm takes the variance as
// the mean squared deviation from a second pass, as the reference does.
#include "common.cuh"

namespace {

template <typename T>
__global__ void fused_adapter_norm_kernel(
    const T* __restrict__ x, const T* __restrict__ res,
    const void* w, int w_bf16, const void* b, int b_bf16,
    const void* scale, int scale_bf16, const void* bias, int bias_bf16,
    T* __restrict__ xn_out, T* __restrict__ h_out, int d, float eps) {
  extern __shared__ float smem[];
  float* row = smem;          // d floats: this row's xn in fp32
  float* scratch = smem + d;  // 32 floats for the block reduction
  const long base = static_cast<long>(blockIdx.x) * d;
  const bool layernorm = bias != nullptr;

  float part = 0.f;
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    const float v = rt::to_f32(x[base + i]) * rt::load_vec(w, w_bf16, i)
                    + rt::load_vec(b, b_bf16, i) + rt::to_f32(res[base + i]);
    row[i] = v;  // read back below only by the thread that wrote it
    xn_out[base + i] = rt::from_f32<T>(v);
    part += layernorm ? v : v * v;
  }
  const float total = rt::block_sum(part, scratch);

  float mu = 0.f, r;
  if (layernorm) {
    mu = total / d;
    float dev = 0.f;
    for (int i = threadIdx.x; i < d; i += blockDim.x) {
      const float c = row[i] - mu;
      dev += c * c;
    }
    r = rsqrtf(rt::block_sum(dev, scratch) / d + eps);
  } else {
    r = rsqrtf(total / d + eps);
  }

  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    float hv = (row[i] - mu) * r * rt::load_vec(scale, scale_bf16, i);
    if (layernorm) hv += rt::load_vec(bias, bias_bf16, i);
    h_out[base + i] = rt::from_f32<T>(hv);
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* res, const void* w, int w_bf16,
                   const void* b, int b_bf16, const void* scale, int scale_bf16,
                   const void* bias, int bias_bf16, void* xn, void* h, int n,
                   int d, float eps, cudaStream_t stream) {
  const size_t smem = (static_cast<size_t>(d) + 32) * sizeof(float);
  auto kernel = fused_adapter_norm_kernel<T>;
  cudaError_t err = rt::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int threads = d >= 2048 ? 512 : 256;
  kernel<<<n, threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(res), w, w_bf16, b,
      b_bf16, scale, scale_bf16, bias, bias_bf16, static_cast<T*>(xn),
      static_cast<T*>(h), d, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" int rt_fused_adapter_norm(
    const void* x, const void* res, const void* w, int w_bf16, const void* b,
    int b_bf16, const void* scale, int scale_bf16, const void* bias,
    int bias_bf16, void* xn, void* h, int n, int d, float eps, int dtype,
    void* stream) {
  if (n == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == rt::BF16)
    return launch<__nv_bfloat16>(x, res, w, w_bf16, b, b_bf16, scale,
                                 scale_bf16, bias, bias_bf16, xn, h, n, d, eps, s);
  return launch<float>(x, res, w, w_bf16, b, b_bf16, scale, scale_bf16, bias,
                       bias_bf16, xn, h, n, d, eps, s);
}
