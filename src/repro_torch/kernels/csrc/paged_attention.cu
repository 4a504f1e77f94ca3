// Paged decode attention, forward: split over the keys ("flash-decoding").
//
// Replaces: src/repro/kernels/attention.py::paged_attention_tpu (the
// pl.pallas_call of _paged_kernel).
//
//   q (B, H, Sq, D); pools (num_blocks, page, KH, D), optionally int8 or
//   fp8-e4m3 with per-token fp32 scales (num_blocks, page, KH, 1); tables
//   (B, nbt) int32;
//   kv_lens (B,) int32 -> out (B, H, Sq, D) fp32.
//   Linear: query i sits at kv_len - Sq + i and sees logical keys li <= it.
//   Ring window: key li holds p = wp - ((wp - li) mod ring), floor mod, and
//   is valid when li < ring, p >= 0 and p <= the query's position.
//
// Bound on the H100: memory. A decode step reads every valid K/V element
// once for 2*G*Sq multiply-adds per element, far below the card's
// flop/byte balance point. At the serve shape (4 slots, 8 kv heads, 140
// valid keys of 128 bf16) that is 1.2 MB, 0.4 us at 3.35 TB/s: what sets
// the time is latency, how many loads are in flight at once and on how
// many SMs.
//
// Design. The keys of a row are cut into splits of `pps` pages (32 keys),
// and the grid is (splits, KH x row chunks, B): at the serve shape 16 x 8
// x 4 = 512 blocks, of which the ~5 splits per row that hold valid keys
// do work. The grid is sized on the host from nbt and page alone (never
// from kv_lens, which lies on the card); a split past its row's last
// valid key exits at once, having read only kv_len and its block ids (no
// device-memory traffic). The first keys' block ids load beside kv_len,
// then the query rows and every K/V load of the split are in flight at
// once (4 keys per lane group at 2 rows a block): the loads stay raw until
// all are issued, since widening one as it is loaded would wait for it.
// Exponentials use the hardware's ex2 (__expf).
// Inside a split each warp takes keys in groups of LPK lanes, each lane a
// 16-byte load of K and of V (8 bf16, 4 fp32, 16 int8 or 16 e4m3 values;
// e4m3 widens two at a time through the hardware's cvt.rn.f16x2.e4m3x2,
// exact in fp16, then to fp32), so a
// 128-wide bf16 row is 16 lanes and a warp instruction reads two keys. The
// query rows of the kv head (G*Sq of them, up to RM per block) stay in
// registers in fp32; a score is the lane's partial dot product reduced by
// shuffles across its group; int8/e4m3 keys take their per-token scale
// after the dot product, their values theirs on the weight. Each lane group runs
// its own online softmax in registers over the keys it saw, skipping masked
// keys (they would add exp(NEG_INF - m) = 0 in the reference); the groups
// merge by shuffles, the warps through shared memory, in a fixed order.
// No K/V staging in shared memory and no barrier inside the key loop.
//
// The partials (acc, m, l) of the splits that hold keys go to an fp32
// scratch of (B, H, Sq, splits, D + 2) that the wrapper allocates; a
// second kernel, one block per query row, finds from kv_lens how many
// splits hold keys (a prefix) and folds them in index order, loading a
// chunk of 8 splits in one round trip. It is a programmatic dependent
// launch: its launch overlaps the split grid, and it waits for that grid's
// writes before it reads them. No atomics: a run repeats bit for bit. Both kernels start
// from the one C entry. C's % truncates toward zero, so the ring's floor
// mod is ((x % r) + r) % r.
//
// A query row that sees no key (linear: kv_len - Sq + i < 0; ring: no slot
// holds a position in [0, qpos]) gets what the Pallas kernel gives it:
// every one of its nbt*page scores is NEG_INF, every weight exp(0) = 1, so
// its output is the mean of V (dequantized) over every key its table names.
// The combine kernel finds such a row from kv_len alone and sums V over the
// table in key order, ignoring the partials; a row that sees a key takes
// the partials' path unchanged.
#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

// one 16-byte load, kept raw until it is widened to fp32: the loads of
// every key a lane takes are issued before any of them is used
__device__ __forceinline__ uint4 load16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void widen(uint4 v, float* out) {
    out[0] = __uint_as_float(v.x); out[1] = __uint_as_float(v.y);
    out[2] = __uint_as_float(v.z); out[3] = __uint_as_float(v.w);
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void widen(uint4 v, float* out) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};
template <> struct Vec<int8_t> {
  static constexpr int N = 16;
  __device__ static void widen(uint4 v, float* out) {
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        out[4 * i + j] = static_cast<float>(static_cast<int8_t>(w[i] >> (8 * j)));
  }
};
template <> struct Vec<__nv_fp8_e4m3> {
  static constexpr int N = 16;
  // byte 2j of a word to out[2j], byte 2j+1 to out[2j+1], as stored
  __device__ static void widen(uint4 v, float* out) {
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const __half2 h = __nv_cvt_fp8x2_to_halfraw2(
            static_cast<__nv_fp8x2_storage_t>((w[i] >> (16 * j)) & 0xffffu),
            __NV_E4M3);
        const float2 f = __half22float2(h);
        out[4 * i + 2 * j] = f.x;
        out[4 * i + 2 * j + 1] = f.y;
      }
  }
};

// the lane layout of a (TKV, D) instantiation, mirrored by
// kernels/attention.py::paged_split_plan
template <typename TKV, int D> struct Layout {
  static constexpr int VEC = Vec<TKV>::N;                       // values a lane loads
  static constexpr int LPK = (D / VEC < 32) ? D / VEC : 32;     // lanes per key
  static constexpr int CPL = D / (VEC * LPK);                   // loads per lane and row
  static constexpr int KPW = 32 / LPK;                          // keys per warp instruction
  static constexpr int RBIG = 64 / (VEC * CPL);                 // rows a block takes at most
};

template <typename TKV, int D, int RM>
__global__ void __launch_bounds__(kThreads) paged_split_kernel(
    const void* __restrict__ q, int q_bf16, const TKV* __restrict__ k_pool,
    const TKV* __restrict__ v_pool, const float* __restrict__ k_scales,
    const float* __restrict__ v_scales, const int* __restrict__ tables,
    const int* __restrict__ kv_lens, float* __restrict__ part, int H, int KH,
    int sq, int page, int nbt, int window, int ring, float scale, float cap,
    int pps, int splits, int row_chunks) {
  using L = Layout<TKV, D>;
  constexpr int VEC = L::VEC, LPK = L::LPK, CPL = L::CPL, KPW = L::KPW;
  constexpr int NG = kWarps * KPW;  // lane groups of the block
  constexpr int W = VEC * CPL;      // values of a row a lane holds
  constexpr int U = RM <= 2 ? 4 : 2;  // keys a lane group has in flight
  extern __shared__ float sm[];
  float* red_acc = sm;                          // kWarps x RM x D
  float* red_m = red_acc + kWarps * RM * D;     // kWarps x RM
  float* red_l = red_m + kWarps * RM;           // kWarps x RM

  const int split = blockIdx.x, kh = blockIdx.y / row_chunks;
  const int rc = blockIdx.y % row_chunks, b = blockIdx.z;
  const int G = H / KH, R = G * sq, r0 = rc * RM;
  const int nrows = min(RM, R - r0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // let the combine kernel launch now; it waits for this grid's writes
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int len = kv_lens[b];
  const int stride = splits * (D + 2);
  // row r of this block is query i = (r0 + r) % sq of head kh*G + (r0+r)/sq;
  // q, out and the partials are indexed by (b, head, i)
  auto row_index = [&](int r) {
    const int rr = r0 + r;
    return (static_cast<long>(b) * H + kh * G + rr / sq) * sq + rr % sq;
  };

  // the first keys' block ids load beside kv_len: they do not depend on
  // it, so the K/V loads start one L2 round trip after the launch
  const int grp = warp * KPW + lane / LPK;  // this lane's key group
  const int gl = lane % LPK;                // its lane within the group
  const int k0 = split * pps * page;
  const long tab = static_cast<long>(b) * nbt;
  int blk0[U];
#pragma unroll
  for (int u = 0; u < U; ++u)
    blk0[u] = tables[tab + min((k0 + grp + NG * u) / page, nbt - 1)];
  // the keys this split may hold: from its first page to page p1 of the
  // row, cut at the last key any query can see
  const int n_pages = window > 0 ? (ring + page - 1) / page
                                 : min(nbt, (len + page - 1) / page);
  const int p1 = min(split * pps + pps, n_pages);
  const int khi = min(p1 * page, window > 0 ? ring : len);
  if (k0 >= khi) {  // an empty partial: the combine reads none of it
    return;
  }
  // the query rows, unconditionally (a row past the block's last repeats
  // row 0 and is never used), so that every load issues before any widens
  float qr[RM][W];
  long qrow[RM];
#pragma unroll
  for (int r = 0; r < RM; ++r) qrow[r] = row_index(r < nrows ? r : 0) * D;
  if (q_bf16) {
    const __nv_bfloat16* qb = static_cast<const __nv_bfloat16*>(q);
    __nv_bfloat16 raw[RM][W];
#pragma unroll
    for (int r = 0; r < RM; ++r)
#pragma unroll
      for (int c = 0; c < CPL; ++c)
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          raw[r][c * VEC + e] = qb[qrow[r] + (gl + LPK * c) * VEC + e];
#pragma unroll
    for (int r = 0; r < RM; ++r)
#pragma unroll
      for (int e = 0; e < W; ++e) qr[r][e] = __bfloat162float(raw[r][e]);
  } else {
    const float* qf = static_cast<const float*>(q);
#pragma unroll
    for (int r = 0; r < RM; ++r)
#pragma unroll
      for (int c = 0; c < CPL; ++c)
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          qr[r][c * VEC + e] = qf[qrow[r] + (gl + LPK * c) * VEC + e];
  }
  // each row's query position, for the masks
  int qpos[RM];
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    const int i = (r0 + r) % sq;
    qpos[r] = window > 0 ? len - (sq - 1) + i : len - sq + i;
  }

  float m[RM], l[RM], acc[RM][W];
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    m[r] = rt::NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < W; ++e) acc[r][e] = 0.f;
  }

  for (int base = k0; base < khi; base += NG * U) {
    uint4 kraw[U][CPL], vraw[U][CPL];
    float ks[U], vs[U];
    int key[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      key[u] = base + grp + NG * u;
      ks[u] = vs[u] = 1.f;
      if (key[u] < khi) {
        const long blk = base == k0 ? blk0[u] : tables[tab + key[u] / page];
        const long tok = (blk * page + key[u] % page) * KH + kh;
#pragma unroll
        for (int c = 0; c < CPL; ++c) {
          const long off = tok * D + (gl + LPK * c) * VEC;
          kraw[u][c] = load16(k_pool + off);
          vraw[u][c] = load16(v_pool + off);
        }
        if (k_scales != nullptr) {
          ks[u] = __ldg(k_scales + tok);
          vs[u] = __ldg(v_scales + tok);
        }
      } else {
#pragma unroll
        for (int c = 0; c < CPL; ++c) kraw[u][c] = vraw[u][c] = make_uint4(0, 0, 0, 0);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kv[W], vv[W];
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        Vec<TKV>::widen(kraw[u][c], kv + c * VEC);
        Vec<TKV>::widen(vraw[u][c], vv + c * VEC);
      }
      float s[RM];
#pragma unroll
      for (int r = 0; r < RM; ++r) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < W; ++e) d = fmaf(qr[r][e], kv[e], d);
#pragma unroll
        for (int o = LPK / 2; o > 0; o >>= 1)
          d += __shfl_xor_sync(0xffffffffu, d, o);
        s[r] = d;
      }
      const int li = key[u];
      if (li >= khi) continue;  // the whole lane group agrees
      int kpos = 0;
      if (window > 0) {
        const int x = len - li;
        kpos = len - ((x % ring) + ring) % ring;
      }
#pragma unroll
      for (int r = 0; r < RM; ++r) {
        const bool valid = r < nrows &&
            (window > 0 ? (kpos >= 0 && kpos <= qpos[r]) : li <= qpos[r]);
        if (!valid) continue;
        float sv = s[r] * ks[u] * scale;
        if (cap > 0.f) sv = tanhf(sv / cap) * cap;
        const float m_new = fmaxf(m[r], sv);
        const float corr = __expf(m[r] - m_new);
        const float p = __expf(sv - m_new);
        l[r] = l[r] * corr + p;
        m[r] = m_new;
        const float pv = p * vs[u];
#pragma unroll
        for (int e = 0; e < W; ++e) acc[r][e] = fmaf(pv, vv[e], acc[r][e] * corr);
      }
    }
  }

  // merge the lane groups of the warp (butterfly, every lane ends with the
  // warp's sums), then the warps in order through shared memory
#pragma unroll
  for (int o = LPK; o < 32; o <<= 1) {
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[r], o);
      const float lo = __shfl_xor_sync(0xffffffffu, l[r], o);
      const float mx = fmaxf(m[r], mo);
      const float a = __expf(m[r] - mx), c = __expf(mo - mx);
      l[r] = l[r] * a + lo * c;
      m[r] = mx;
#pragma unroll
      for (int e = 0; e < W; ++e) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[r][e], o);
        acc[r][e] = acc[r][e] * a + ao * c;
      }
    }
  }
  if (lane < LPK) {
#pragma unroll
    for (int r = 0; r < RM; ++r) {
#pragma unroll
      for (int c = 0; c < CPL; ++c)
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          red_acc[(warp * RM + r) * D + (gl + LPK * c) * VEC + e] = acc[r][c * VEC + e];
      if (lane == 0) {
        red_m[warp * RM + r] = m[r];
        red_l[warp * RM + r] = l[r];
      }
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < nrows * (D + 2); e += blockDim.x) {
    const int r = e / (D + 2), c = e % (D + 2);
    float mx = rt::NEG_INF;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, red_m[w * RM + r]);
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wt = __expf(red_m[w * RM + r] - mx);
      v += (c < D ? red_acc[(w * RM + r) * D + c]
                  : c == D ? 0.f : red_l[w * RM + r]) * wt;
    }
    part[row_index(r) * stride + split * (D + 2) + c] = c == D ? mx : v;
  }
}

// the splits of a row that hold keys: a prefix, as the split kernel cuts
// them (the others wrote nothing)
__device__ __forceinline__ int active_splits(int len, int page, int nbt,
                                             int window, int ring, int pps,
                                             int splits) {
  const int n_pages = window > 0 ? (ring + page - 1) / page
                                 : min(nbt, (len + page - 1) / page);
  const int khi = min(n_pages * page, window > 0 ? ring : len);
  return min(splits, (khi + pps * page - 1) / (pps * page));
}

// does query i of Sq, the row's last at kv_len (linear) or write position
// kv_len (ring), see a key? Linear: key 0 once its position is >= 0. Ring:
// the slots hold positions kv_len - ring + 1 .. kv_len, those >= 0
__device__ __forceinline__ bool sees_a_key(int len, int i, int sq, int window,
                                           int ring) {
  if (window > 0) {
    const int qpos = len - (sq - 1) + i;
    return qpos >= 0 && qpos >= len - ring + 1;
  }
  return len - sq + i >= 0;
}

// one block per query row, a thread per output column: the row's active
// splits in chunks of kChunk, each chunk's m, l and acc loaded at once (one
// round trip for a chunk), folded in index order with the running max
// rescaled as in the split kernel. Every thread repeats the weights, so no
// barrier is needed. Launched as a programmatic dependent of the split
// kernel: its launch and its kv_len load overlap that grid. A row that
// sees no key takes the mean of V over its table instead
constexpr int kChunk = 8;

template <typename TKV>
__global__ void __launch_bounds__(kThreads) paged_combine_kernel(
    const float* __restrict__ part, const int* __restrict__ kv_lens,
    const int* __restrict__ tables, const TKV* __restrict__ v_pool,
    const float* __restrict__ v_scales, float* __restrict__ out, int H,
    int KH, int sq, int D, int page, int nbt, int window, int ring, int pps,
    int splits) {
  const long row = blockIdx.x;
  const int b = static_cast<int>(row / (static_cast<long>(H) * sq));
  const int len = kv_lens[b];
  const bool keyed = sees_a_key(len, static_cast<int>(row % sq), sq, window,
                                ring);
  const int n = active_splits(len, page, nbt, window, ring, pps, splits);
  const float* pr = part + row * splits * (D + 2);
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  if (!keyed) {
    // the mean of V over the row's nbt*page keys, summed in key order
    const int kh = static_cast<int>((row / sq) % H) / (H / KH);
    const long tab = static_cast<long>(b) * nbt;
    const int size = nbt * page;
    for (int c = threadIdx.x; c < D; c += blockDim.x) {
      float sum = 0.f;
      for (int li = 0; li < size; ++li) {
        const long tok =
            (static_cast<long>(tables[tab + li / page]) * page + li % page) * KH + kh;
        float v = rt::to_f32(v_pool[tok * D + c]);
        if (v_scales != nullptr) v = __fmul_rn(v, v_scales[tok]);
        sum = __fadd_rn(sum, v);
      }
      out[row * D + c] = __fdiv_rn(sum, static_cast<float>(size));
    }
    return;
  }
  for (int c = threadIdx.x; c < D; c += blockDim.x) {
    float mx = rt::NEG_INF, lsum = 0.f, a = 0.f;
    for (int s0 = 0; s0 < n; s0 += kChunk) {
      float ms[kChunk], ls[kChunk], av[kChunk];
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const float* ps = pr + (s0 + j) * (D + 2);
        const bool in = s0 + j < n;
        ms[j] = in ? ps[D] : rt::NEG_INF;
        ls[j] = in ? ps[D + 1] : 0.f;
        av[j] = in ? ps[c] : 0.f;
      }
      float cm = mx;
#pragma unroll
      for (int j = 0; j < kChunk; ++j)
        if (ls[j] > 0.f) cm = fmaxf(cm, ms[j]);
      const float corr = __expf(mx - cm);
      lsum *= corr;
      a *= corr;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const float w = ls[j] > 0.f ? __expf(ms[j] - cm) : 0.f;
        lsum = fmaf(w, ls[j], lsum);
        a = fmaf(w, av[j], a);
      }
      mx = cm;
    }
    out[row * D + c] = lsum > 0.f ? a / lsum : 0.f;
  }
}

template <typename TKV, int D>
cudaError_t launch(const void* q, int q_bf16, const void* k_pool,
                   const void* v_pool, const float* k_scales,
                   const float* v_scales, const int* tables, const int* kv_lens,
                   float* out, float* part, int B, int H, int KH, int sq,
                   int page, int nbt, int window, int ring, float scale,
                   float cap, int pps, int splits, int rows_per_block,
                   cudaStream_t stream) {
  using L = Layout<TKV, D>;
  const int R = (H / KH) * sq;
  const int row_chunks = (R + rows_per_block - 1) / rows_per_block;
  const dim3 grid(splits, KH * row_chunks, B);
  const size_t smem = sizeof(float) * kWarps * rows_per_block * (D + 2);
  const TKV* kp = static_cast<const TKV*>(k_pool);
  const TKV* vp = static_cast<const TKV*>(v_pool);
  if (rows_per_block == 2) {
    paged_split_kernel<TKV, D, 2><<<grid, kThreads, smem, stream>>>(
        q, q_bf16, kp, vp, k_scales, v_scales, tables, kv_lens, part, H, KH, sq,
        page, nbt, window, ring, scale, cap, pps, splits, row_chunks);
  } else if (rows_per_block == L::RBIG) {
    paged_split_kernel<TKV, D, L::RBIG><<<grid, kThreads, smem, stream>>>(
        q, q_bf16, kp, vp, k_scales, v_scales, tables, kv_lens, part, H, KH, sq,
        page, nbt, window, ring, scale, cap, pps, splits, row_chunks);
  } else {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * H * sq);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, paged_combine_kernel<TKV>, part, kv_lens,
                            tables, vp, v_scales, out, H, KH, sq, D, page, nbt,
                            window, ring, pps, splits);
}

template <typename TKV>
cudaError_t dispatch_d(int D, const void* q, int q_bf16, const void* k_pool,
                       const void* v_pool, const float* k_scales,
                       const float* v_scales, const int* tables,
                       const int* kv_lens, float* out, float* part, int B,
                       int H, int KH, int sq, int page, int nbt, int window,
                       int ring, float scale, float cap, int pps, int splits,
                       int rows_per_block, cudaStream_t s) {
#define RT_PAGED_LAUNCH(DD)                                                    \
  launch<TKV, DD>(q, q_bf16, k_pool, v_pool, k_scales, v_scales, tables,      \
                  kv_lens, out, part, B, H, KH, sq, page, nbt, window, ring,  \
                  scale, cap, pps, splits, rows_per_block, s)
  switch (D) {
    case 64: return RT_PAGED_LAUNCH(64);
    case 128: return RT_PAGED_LAUNCH(128);
    case 256: return RT_PAGED_LAUNCH(256);
    default: return cudaErrorInvalidValue;
  }
#undef RT_PAGED_LAUNCH
}

}  // namespace

// part: fp32 scratch of (B, H, sq, splits, D + 2); pps pages per split;
// rows_per_block: 2, or Layout<kv dtype, D>::RBIG
extern "C" int rt_paged_attention(const void* q, const void* k_pool,
                                  const void* v_pool, const void* k_scales,
                                  const void* v_scales, const void* tables,
                                  const void* kv_lens, void* out, void* part,
                                  int B, int H, int KH, int sq, int D, int page,
                                  int nbt, int window, int ring, float scale,
                                  float cap, int pps, int splits,
                                  int rows_per_block, int q_dtype,
                                  int kv_dtype, void* stream) {
  if (B == 0) return cudaSuccess;
  const float* ks = static_cast<const float*>(k_scales);
  const float* vs = static_cast<const float*>(v_scales);
  const int* tb = static_cast<const int*>(tables);
  const int* kl = static_cast<const int*>(kv_lens);
  float* o = static_cast<float*>(out);
  float* pt = static_cast<float*>(part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int q_bf16 = q_dtype == rt::BF16;
  switch (kv_dtype) {
    case rt::F32:
      return dispatch_d<float>(D, q, q_bf16, k_pool, v_pool, ks, vs, tb, kl, o,
                               pt, B, H, KH, sq, page, nbt, window, ring, scale,
                               cap, pps, splits, rows_per_block, s);
    case rt::BF16:
      return dispatch_d<__nv_bfloat16>(D, q, q_bf16, k_pool, v_pool, ks, vs, tb,
                                       kl, o, pt, B, H, KH, sq, page, nbt,
                                       window, ring, scale, cap, pps, splits,
                                       rows_per_block, s);
    case rt::I8:
      return dispatch_d<int8_t>(D, q, q_bf16, k_pool, v_pool, ks, vs, tb, kl, o,
                                pt, B, H, KH, sq, page, nbt, window, ring,
                                scale, cap, pps, splits, rows_per_block, s);
    case rt::E4M3:
      return dispatch_d<__nv_fp8_e4m3>(D, q, q_bf16, k_pool, v_pool, ks, vs, tb,
                                       kl, o, pt, B, H, KH, sq, page, nbt,
                                       window, ring, scale, cap, pps, splits,
                                       rows_per_block, s);
    default:
      return cudaErrorInvalidValue;
  }
}
