// Paged decode attention, forward.
//
// Replaces: src/repro/kernels/attention.py::paged_attention_tpu (the
// pl.pallas_call of _paged_kernel).
//
//   q (B, H, Sq, D); pools (num_blocks, page, KH, D), optionally int8 with
//   per-token fp32 scales (num_blocks, page, KH, 1); tables (B, nbt) int32;
//   kv_lens (B,) int32 -> out (B, H, Sq, D) fp32.
//   Linear: query i sits at kv_len - Sq + i and sees logical keys li <= it.
//   Ring window: key li holds p = wp - ((wp - li) mod ring), floor mod, and
//   is valid when li < ring, p >= 0 and p <= the query's position.
//
// Bound on the H100: memory. A decode step reads every valid K/V element
// once for a handful of flops per element (2*G*Sq multiply-adds per K or V
// element), far below the card's flop/byte balance point.
//
// Design. One block per (kv head, sequence): the G*Sq query rows that share
// a kv head are staged once, so each K/V page crosses device memory once per
// sequence and kv head, and GQA costs no repeated reads. The block reads its
// own table row and walks only the pages that can hold a valid key
// (ceil(kv_len/page) for linear validity, ceil(ring/page) for a ring), so a
// 512-slot cache at kv_len 140 costs 9 pages, not 32. Per page: the page's
// K and V are widened to fp32 in shared memory (int8 times its per-token
// scale), one thread per (row, key) forms a score, one thread per row runs
// the online-softmax update in fp32, and one thread per (row, column)
// updates the accumulator, kept in shared memory so any G*Sq fits. Finite
// NEG_INF as in the Pallas kernel. C's % truncates toward zero, so the
// ring's floor mod is written ((x % r) + r) % r.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(kThreads) paged_attention_kernel(
    const TQ* __restrict__ q, const TKV* __restrict__ k_pool,
    const TKV* __restrict__ v_pool, const float* __restrict__ k_scales,
    const float* __restrict__ v_scales, const int* __restrict__ tables,
    const int* __restrict__ kv_lens, float* __restrict__ out, int H, int KH,
    int sq, int D, int page, int nbt, int window, int ring, float scale,
    float cap) {
  const int G = H / KH, R = G * sq;
  extern __shared__ float sm[];
  float* qsm = sm;                   // R x D
  float* acc = qsm + R * D;          // R x D
  float* ksm = acc + R * D;          // page x (D + 1)
  float* vsm = ksm + page * (D + 1);  // page x D
  float* psm = vsm + page * D;       // R x page: scores, then weights
  float* mrow = psm + R * page;      // R running maxima
  float* lrow = mrow + R;            // R running sums
  float* crow = lrow + R;            // R correction factors of this page

  const int kh = blockIdx.x, b = blockIdx.y;
  const int len = kv_lens[b];
  // row r = g*sq + i is query i of head kh*G + g; q and out are (B,H,sq,D)
  const long qbase = (static_cast<long>(b) * H + kh * G) * sq * D;

  for (int e = threadIdx.x; e < R * D; e += blockDim.x) {
    qsm[e] = rt::to_f32(q[qbase + e]);
    acc[e] = 0.f;
  }
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    mrow[r] = rt::NEG_INF;
    lrow[r] = 0.f;
  }

  const int n_pages = window > 0 ? (ring + page - 1) / page
                                 : min(nbt, (len + page - 1) / page);
  for (int j = 0; j < n_pages; ++j) {
    __syncthreads();  // the previous page is consumed (and q is staged)
    const long blk = tables[static_cast<long>(b) * nbt + j];
    for (int e = threadIdx.x; e < page * D; e += blockDim.x) {
      const int t = e / D, c = e % D;
      const long tok = (blk * page + t) * KH + kh;  // (block, token, head)
      float kv = rt::to_f32(k_pool[tok * D + c]);
      float vv = rt::to_f32(v_pool[tok * D + c]);
      if (k_scales != nullptr) {
        kv *= k_scales[tok];
        vv *= v_scales[tok];
      }
      ksm[t * (D + 1) + c] = kv;
      vsm[t * D + c] = vv;
    }
    __syncthreads();

    for (int e = threadIdx.x; e < R * page; e += blockDim.x) {
      const int r = e / page, t = e % page, i = r % sq;
      const float* qr = qsm + r * D;
      const float* kr = ksm + t * (D + 1);
      float s = 0.f;
      for (int c = 0; c < D; ++c) s += qr[c] * kr[c];
      s *= scale;
      if (cap > 0.f) s = tanhf(s / cap) * cap;
      const int li = j * page + t;
      bool valid;
      if (window > 0) {
        const int x = len - li;
        const int p = len - ((x % ring) + ring) % ring;
        valid = li < ring && p >= 0 && p <= len - (sq - 1) + i;
      } else {
        valid = li <= len - sq + i;
      }
      psm[e] = valid ? s : rt::NEG_INF;
    }
    __syncthreads();

    for (int r = threadIdx.x; r < R; r += blockDim.x) {
      float* pr = psm + r * page;
      float mx = mrow[r];
      for (int t = 0; t < page; ++t) mx = fmaxf(mx, pr[t]);
      float sum = 0.f;
      for (int t = 0; t < page; ++t) {
        const float p = expf(pr[t] - mx);
        pr[t] = p;
        sum += p;
      }
      const float corr = expf(mrow[r] - mx);
      lrow[r] = lrow[r] * corr + sum;
      mrow[r] = mx;
      crow[r] = corr;
    }
    __syncthreads();

    for (int e = threadIdx.x; e < R * D; e += blockDim.x) {
      const int r = e / D, c = e % D;
      const float* pr = psm + r * page;
      float a = acc[e] * crow[r];
      for (int t = 0; t < page; ++t) a += pr[t] * vsm[t * D + c];
      acc[e] = a;
    }
  }
  __syncthreads();

  for (int e = threadIdx.x; e < R * D; e += blockDim.x) {
    const float l = lrow[e / D];
    out[qbase + e] = acc[e] / (l > 0.f ? l : 1.f);
  }
}

template <typename TQ, typename TKV>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const float* k_scales, const float* v_scales,
                   const int* tables, const int* kv_lens, float* out, int B,
                   int H, int KH, int sq, int D, int page, int nbt, int window,
                   int ring, float scale, float cap, cudaStream_t stream) {
  const int R = (H / KH) * sq;
  const size_t smem = sizeof(float) * (2 * R * D + page * (D + 1) + page * D
                                       + R * page + 3 * R);
  auto kernel = paged_attention_kernel<TQ, TKV>;
  cudaError_t err = rt::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(KH, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k_pool),
      static_cast<const TKV*>(v_pool), k_scales, v_scales, tables, kv_lens, out,
      H, KH, sq, D, page, nbt, window, ring, scale, cap);
  return cudaGetLastError();
}

template <typename TQ>
cudaError_t dispatch_kv(int kv_dtype, const void* q, const void* k_pool,
                        const void* v_pool, const float* k_scales,
                        const float* v_scales, const int* tables,
                        const int* kv_lens, float* out, int B, int H, int KH,
                        int sq, int D, int page, int nbt, int window, int ring,
                        float scale, float cap, cudaStream_t stream) {
  switch (kv_dtype) {
    case rt::F32:
      return launch<TQ, float>(q, k_pool, v_pool, k_scales, v_scales, tables,
                               kv_lens, out, B, H, KH, sq, D, page, nbt, window,
                               ring, scale, cap, stream);
    case rt::BF16:
      return launch<TQ, __nv_bfloat16>(q, k_pool, v_pool, k_scales, v_scales,
                                       tables, kv_lens, out, B, H, KH, sq, D,
                                       page, nbt, window, ring, scale, cap,
                                       stream);
    case rt::I8:
      return launch<TQ, int8_t>(q, k_pool, v_pool, k_scales, v_scales, tables,
                                kv_lens, out, B, H, KH, sq, D, page, nbt, window,
                                ring, scale, cap, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int rt_paged_attention(const void* q, const void* k_pool,
                                  const void* v_pool, const void* k_scales,
                                  const void* v_scales, const void* tables,
                                  const void* kv_lens, void* out, int B, int H,
                                  int KH, int sq, int D, int page, int nbt,
                                  int window, int ring, float scale, float cap,
                                  int q_dtype, int kv_dtype, void* stream) {
  if (B == 0) return cudaSuccess;
  const float* ks = static_cast<const float*>(k_scales);
  const float* vs = static_cast<const float*>(v_scales);
  const int* tb = static_cast<const int*>(tables);
  const int* kl = static_cast<const int*>(kv_lens);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == rt::BF16)
    return dispatch_kv<__nv_bfloat16>(kv_dtype, q, k_pool, v_pool, ks, vs, tb,
                                      kl, o, B, H, KH, sq, D, page, nbt, window,
                                      ring, scale, cap, s);
  return dispatch_kv<float>(kv_dtype, q, k_pool, v_pool, ks, vs, tb, kl, o, B,
                            H, KH, sq, D, page, nbt, window, ring, scale, cap, s);
}
