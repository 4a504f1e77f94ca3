// Flash attention, forward.
//
// Replaces: src/repro/kernels/attention.py::flash_attention_tpu.
//
//   q (B, H, Sq, D), k/v (B, KH, Skv, D), H = KH*G -> o (B, H, Sq, D)
//   query i sits at position i + (Skv - Sq); query head h reads kv head h/G;
//   causal, local-window and tanh soft-cap masks; finite NEG_INF = -1e30.
//
// Bound on the H100: at the serve shapes (prefill, S <= 512, D = 128) the
// work is ~4*S*S*D/2 flops per head against 4*S*D elements moved, so the
// roofline says compute (tensor cores). This first kernel does its flops as
// scalar fp32 FMAs from shared memory, so it is bound by the FMA pipes and
// shared-memory bandwidth instead; wgmma tiles are later work.
//
// Design. One block of 4 warps per (q tile of 16 rows, head, batch); each
// warp owns 4 query rows, each lane owns D/32 output columns of them, so the
// fp32 accumulator lives in registers. The block sweeps K/V in tiles of 32
// keys staged in shared memory as fp32 (K rows padded to D+1 floats, so the
// 32 lanes, one key each, read 32 different banks). Per tile: lane j forms
// the 4 scores of key j, a warp max/sum gives the online-softmax update, and
// the P@V product broadcasts each key's weight with a shuffle. GQA is pure
// index arithmetic (kv head h/G), so K/V are never repeated in memory. Key
// tiles that are masked for every row of the block (above the causal
// diagonal, before the window) are skipped; every row keeps at least its
// own key, so skipping changes no result.
#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kRows = 4;              // query rows per warp
constexpr int kBQ = kWarps * kRows;   // query rows per block
constexpr int kBK = 32;               // keys per tile (one per lane)

struct Strides {
  long b, h, s;  // element strides of dims 0-2; dim 3 is contiguous
};

template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, int H, int KH, int Sq, int Skv, Strides qs_, Strides ks_,
    Strides vs_, Strides os_, float scale, float cap, int causal, int window) {
  constexpr int DL = D / 32;  // output columns per lane
  extern __shared__ float sm[];
  float* qsm = sm;                        // kBQ x D
  float* ksm = qsm + kBQ * D;             // kBK x (D + 1)
  float* vsm = ksm + kBK * (D + 1);       // kBK x D

  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KH);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int off = Skv - Sq;  // right alignment of the queries
  const T* qb = q + b * qs_.b + h * qs_.h;
  const T* kb = k + b * ks_.b + kh * ks_.h;
  const T* vb = v + b * vs_.b + kh * vs_.h;
  T* ob = o + b * os_.b + h * os_.h;

  for (int e = threadIdx.x; e < kBQ * D; e += blockDim.x) {
    const int i = e / D, c = e % D, qi = q0 + i;
    qsm[e] = qi < Sq ? rt::to_f32(qb[qi * qs_.s + c]) : 0.f;
  }

  float acc[kRows][DL], m[kRows], l[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = rt::NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int dd = 0; dd < DL; ++dd) acc[r][dd] = 0.f;
  }

  // the key range any row of this block can see
  const int qp_lo = q0 + off;
  const int qp_hi = min(q0 + kBQ, Sq) - 1 + off;
  const int k_end = causal ? min(Skv, qp_hi + 1) : Skv;
  int k_begin = window > 0 ? max(0, qp_lo - window + 1) : 0;
  k_begin = (k_begin / kBK) * kBK;

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile is consumed (and q is staged)
    for (int e = threadIdx.x; e < kBK * D; e += blockDim.x) {
      const int j = e / D, c = e % D, kj = k0 + j;
      float kv = 0.f, vv = 0.f;
      if (kj < Skv) {
        kv = rt::to_f32(kb[kj * ks_.s + c]);
        vv = rt::to_f32(vb[kj * vs_.s + c]);
      }
      ksm[j * (D + 1) + c] = kv;
      vsm[j * D + c] = vv;
    }
    __syncthreads();

    // scores: lane j takes key k0 + j against this warp's rows
    float s[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = 0.f;
    const float* krow = ksm + lane * (D + 1);
    const float* qrow = qsm + warp * kRows * D;
#pragma unroll 8
    for (int c = 0; c < D; ++c) {
      const float kc = krow[c];
#pragma unroll
      for (int r = 0; r < kRows; ++r) s[r] += qrow[r * D + c] * kc;
    }

    const int kj = k0 + lane;
    float p[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qp = q0 + warp * kRows + r + off;
      float sv = s[r] * scale;
      if (cap > 0.f) sv = tanhf(sv / cap) * cap;
      bool valid = kj < Skv;
      if (causal) valid = valid && kj <= qp;
      if (window > 0) valid = valid && (qp - kj < window);
      sv = valid ? sv : rt::NEG_INF;
      const float m_new = fmaxf(m[r], rt::warp_max(sv));
      p[r] = expf(sv - m_new);
      const float corr = expf(m[r] - m_new);
      l[r] = l[r] * corr + rt::warp_sum(p[r]);
      m[r] = m_new;
#pragma unroll
      for (int dd = 0; dd < DL; ++dd) acc[r][dd] *= corr;
    }

#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float vv[DL];
#pragma unroll
      for (int dd = 0; dd < DL; ++dd) vv[dd] = vsm[j * D + lane + 32 * dd];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float pj = __shfl_sync(0xffffffffu, p[r], j);
#pragma unroll
        for (int dd = 0; dd < DL; ++dd) acc[r][dd] += pj * vv[dd];
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qi = q0 + warp * kRows + r;
    if (qi >= Sq) continue;
    const float safe = l[r] > 0.f ? l[r] : 1.f;
#pragma unroll
    for (int dd = 0; dd < DL; ++dd)
      ob[qi * os_.s + lane + 32 * dd] = rt::from_f32<T>(acc[r][dd] / safe);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B,
                   int H, int KH, int Sq, int Skv, Strides qs, Strides ks,
                   Strides vs, Strides os, float scale, float cap, int causal,
                   int window, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (kBQ * D + kBK * (D + 1) + kBK * D);
  auto kernel = flash_fwd_kernel<T, D>;
  cudaError_t err = rt::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, KH, Sq, Skv, qs, ks, vs,
      os, scale, cap, causal, window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v,
                       void* o, int B, int H, int KH, int Sq, int Skv,
                       Strides qs, Strides ks, Strides vs, Strides os,
                       float scale, float cap, int causal, int window,
                       cudaStream_t stream) {
  switch (D) {
    case 64:
      return launch<T, 64>(q, k, v, o, B, H, KH, Sq, Skv, qs, ks, vs, os, scale,
                           cap, causal, window, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, B, H, KH, Sq, Skv, qs, ks, vs, os,
                            scale, cap, causal, window, stream);
    case 256:
      return launch<T, 256>(q, k, v, o, B, H, KH, Sq, Skv, qs, ks, vs, os,
                            scale, cap, causal, window, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// strides: 12 element strides, (b, h, s) for each of q, k, v, o
extern "C" int rt_flash_attention(const void* q, const void* k, const void* v,
                                  void* o, int B, int H, int KH, int Sq,
                                  int Skv, int D, const long* strides,
                                  float scale, float cap, int causal,
                                  int window, int dtype, void* stream) {
  if (B == 0 || Sq == 0) return cudaSuccess;
  const Strides qs{strides[0], strides[1], strides[2]};
  const Strides ks{strides[3], strides[4], strides[5]};
  const Strides vs{strides[6], strides[7], strides[8]};
  const Strides os{strides[9], strides[10], strides[11]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == rt::BF16)
    return dispatch_d<__nv_bfloat16>(D, q, k, v, o, B, H, KH, Sq, Skv, qs, ks,
                                     vs, os, scale, cap, causal, window, s);
  return dispatch_d<float>(D, q, k, v, o, B, H, KH, Sq, Skv, qs, ks, vs, os,
                           scale, cap, causal, window, s);
}
