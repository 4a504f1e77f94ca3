// The RWKV6 WKV recurrence, forward, with the state in and out.
//
// Replaces: src/repro/kernels/rwkv6.py::wkv6_tpu.
//
// Per (batch b, head h), with an n x n fp32 state S that starts at s0
// (zeros when none is given), for t = 0 .. T-1:
//   o_t[j] = sum_i r_t[i] * (S[i][j] + u[i] * k_t[i] * v_t[j])
//   S[i][j] <- w_t[i] * S[i][j] + k_t[i] * v_t[j]
// r, k, v, w: (B, H, T, n) fp32 or bf16, addressed through their strides
// (the model hands (B, T, H, n) tensors transposed, so nothing is copied);
// u: (H, n) fp32; o: r's dtype; the final state: (B, H, n, n) fp32, which
// may be written over s0 (the decode cache is updated in place).
//
// Bound on the H100: neither bytes nor operations but the sweep's latency.
// A head's T steps run one after another; each step is n*n multiply-adds
// for o and as many for S, spread over only n threads. The Pallas kernel
// keeps S in VMEM across a sequential grid of time chunks; here one block
// of n threads owns one (b, h), thread j owns column j of S in n registers
// (the columns are independent, the only reduction runs over i inside a
// column), and the block walks T in chunks of CHUNK steps: a chunk's r, k,
// v and w are staged in shared memory with coalesced loads, one barrier,
// then its steps run with no barrier at all, every thread reading r_i,
// k_i, w_i and u_i as broadcasts. No atomics and a fixed summation order,
// so every run gives the same bits, and the chunk (a staging size only)
// does not change them. Each thread reads its state column before the
// first step and writes it after the last, so s0 and the output state may
// alias.
#include "common.cuh"

namespace {

constexpr int CHUNK = 32;  // time steps staged per barrier

// element strides of r, k, v, w and o over (b, h, t); the last dim is 1
struct Strides {
  long s[5][3];
};

template <typename T, int N>
__global__ void __launch_bounds__(N) wkv6_kernel(
    const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ w, const float* __restrict__ u, const float* s_in,
    float* s_out, T* __restrict__ o, int H, int T_len, Strides st) {
  __shared__ float sr[CHUNK][N], sk[CHUNK][N], sv[CHUNK][N], sw[CHUNK][N];
  __shared__ float su[N];
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int j = threadIdx.x;
  const T* src[4] = {r, k, v, w};
  long base[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) base[a] = b * st.s[a][0] + h * st.s[a][1];
  const long obase = b * st.s[4][0] + h * st.s[4][1];
  su[j] = u[h * N + j];

  float S[N];
  const long sofs = static_cast<long>(bh) * N * N;
#pragma unroll
  for (int i = 0; i < N; ++i) S[i] = s_in ? s_in[sofs + i * N + j] : 0.f;

  for (int t0 = 0; t0 < T_len; t0 += CHUNK) {
    const int len = min(CHUNK, T_len - t0);
    __syncthreads();  // the previous chunk's reads are done
    for (int e = j; e < len * N; e += N) {
      const int tt = e / N, i = e % N;
      const long t = t0 + tt;
      sr[tt][i] = rt::to_f32(src[0][base[0] + t * st.s[0][2] + i]);
      sk[tt][i] = rt::to_f32(src[1][base[1] + t * st.s[1][2] + i]);
      sv[tt][i] = rt::to_f32(src[2][base[2] + t * st.s[2][2] + i]);
      sw[tt][i] = rt::to_f32(src[3][base[3] + t * st.s[3][2] + i]);
    }
    __syncthreads();
    for (int tt = 0; tt < len; ++tt) {
      const float vj = sv[tt][j];
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const float kv = sk[tt][i] * vj;
        acc = fmaf(sr[tt][i], fmaf(su[i], kv, S[i]), acc);
        S[i] = fmaf(sw[tt][i], S[i], kv);
      }
      o[obase + (t0 + tt) * st.s[4][2] + j] = rt::from_f32<T>(acc);
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i) s_out[sofs + i * N + j] = S[i];
}

template <typename T, int N>
cudaError_t launch(const void* r, const void* k, const void* v, const void* w,
                   const float* u, const float* s_in, float* s_out, void* o,
                   int B, int H, int T_len, const Strides& st,
                   cudaStream_t stream) {
  wkv6_kernel<T, N><<<B * H, N, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(w), u, s_in, s_out,
      static_cast<T*>(o), H, T_len, st);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_n(const void* r, const void* k, const void* v,
                     const void* w, const float* u, const float* s_in,
                     float* s_out, void* o, int B, int H, int T_len, int n,
                     const Strides& st, cudaStream_t stream) {
  switch (n) {
    case 16:
      return launch<T, 16>(r, k, v, w, u, s_in, s_out, o, B, H, T_len, st, stream);
    case 32:
      return launch<T, 32>(r, k, v, w, u, s_in, s_out, o, B, H, T_len, st, stream);
    case 64:
      return launch<T, 64>(r, k, v, w, u, s_in, s_out, o, B, H, T_len, st, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// strides: 15 element strides, (b, h, t) of r, k, v, w, then of o.
// s_in may be null (zero state) or equal to s_out.
extern "C" int rt_wkv6(const void* r, const void* k, const void* v,
                       const void* w, const void* u, const void* s_in,
                       void* s_out, void* o, int B, int H, int T_len, int n,
                       const long* strides, int dtype, void* stream) {
  if (B == 0 || H == 0) return cudaSuccess;
  Strides st;
  for (int a = 0; a < 5; ++a)
    for (int c = 0; c < 3; ++c) st.s[a][c] = strides[a * 3 + c];
  const float* uf = static_cast<const float*>(u);
  const float* si = static_cast<const float*>(s_in);
  float* so = static_cast<float*>(s_out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == rt::BF16)
    return launch_n<__nv_bfloat16>(r, k, v, w, uf, si, so, o, B, H, T_len, n,
                                   st, s);
  return launch_n<float>(r, k, v, w, uf, si, so, o, B, H, T_len, n, st, s);
}
