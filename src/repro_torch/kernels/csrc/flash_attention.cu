// Flash attention, forward.
//
// Replaces: src/repro/kernels/attention.py::flash_attention_tpu.
//
//   q (B, H, Sq, D), k/v (B, KH, Skv, D), H = KH*G -> o (B, H, Sq, D), and
//   optionally lse (B, H, Sq) fp32, each row's log-sum-exp (the residual of
//   the backward); query i sits at position i + (Skv - Sq); query head h
//   reads kv head h/G; causal, local-window and tanh soft-cap masks; finite
//   NEG_INF = -1e30, masked keys weigh exactly 0.
//
// Bound on the H100: at the serve prefill shape (one head of S = 128,
// D = 128) the work is 4*S*S*D/2 flops against 4*S*D elements moved, so
// the roofline says tensor cores, but the whole call is ~67 MFLOP: a few
// microseconds of load latency and one warp's chain of tiles set the time.
// At bert-base's train shape (fp32, S = 128, D = 64, 384 heads) it is 1.6
// GFLOP on the fp32 pipes (TF32 stays off), 24 us at their 67 TFLOP/s.
//
// bf16 design: tensor cores. A block of 4 warps takes 64 query rows of one
// head, 16 rows a warp (mma.sync m16n8k16, bf16 in, fp32 accumulate). Q and
// a double-buffered ring of K/V tiles (64 keys; 32 at D = 256) are staged
// by cp.async into shared memory with rows padded by 16 bytes, so ldmatrix
// reads 8 rows from 8 different bank groups. S = Q K^T comes from ldmatrix
// fragments of Q and K, the online softmax runs on the accumulator
// fragments in registers (row max and sum over the 4 lanes of a row by
// shuffles), P is rounded to bf16 for P V as FA2 does, with V's fragments
// from ldmatrix.trans. Query tiles are kept small (16 rows a warp) rather
// than packing a kv head's G query heads into one block: at the prefill
// shape the time is one warp's chain of key tiles and its loads, which
// packing does not shorten, and K/V's second read per kv head hits L2.
//
// fp32 design: register-tiled SIMT, full fp32 arithmetic. A block of 256
// threads takes 64 query rows of one head; Q^T, K^T (d-major) and V of a
// 64-key tile (32 at D = 256) sit in shared memory, and each thread forms
// a 4 x 4 micro-tile of S from two 16-byte reads per d (Q's broadcast) and
// then a 4 x D/16 micro-tile of O from P^T (padded rows) and V, 16 FMAs a
// read; its row max and sum reduce over the 16 threads of a row group by
// shuffles.
//
// Both: key tiles masked for every row of the block (above the causal
// diagonal, before the window) are skipped, which needs Sq <= Skv in a
// causal call (the wrapper checks it): every row keeps at least its own
// key. A non-causal call reads every key tile (key_range's end is Skv), so
// any Sq, more queries than keys included (a decoder of more tokens than
// the encoder's frames cross-attending); a tail tile past Skv is
// zero-filled and masked by kj < Skv.
#include "common.cuh"

namespace {

struct Strides {
  long b, h, s;  // element strides of dims 0-2; dim 3 is contiguous
};

// the key range any query of rows [q0, q0 + rows) can see, from a tile
// boundary of bk
struct KeyRange {
  int begin, end;
};
__device__ __forceinline__ KeyRange key_range(int q0, int rows, int Sq,
                                              int Skv, int causal, int window,
                                              int bk) {
  const int off = Skv - Sq;
  const int qp_lo = q0 + off, qp_hi = min(q0 + rows, Sq) - 1 + off;
  const int end = causal ? min(Skv, qp_hi + 1) : Skv;
  const int begin = window > 0 ? max(0, qp_lo - window + 1) : 0;
  return {(begin / bk) * bk, end};
}

// the scaled, capped score of key kj for the query at position qp, or
// NEG_INF where the masks hide the key
__device__ __forceinline__ float score(float s, float scale, float cap,
                                       int kj, int qp, int Skv, int causal,
                                       int window) {
  s *= scale;
  if (cap > 0.f) s = tanhf(s / cap) * cap;
  const bool valid =
      kj < Skv && (!causal || kj <= qp) && (window <= 0 || qp - kj < window);
  return valid ? s : rt::NEG_INF;
}

// ---------------------------------------------------------------------------
// bf16: mma.sync on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kWarps = 4;
constexpr int kBQ = 16 * kWarps;  // query rows of a block

template <int D> struct BfTile {
  static constexpr int BK = D == 256 ? 32 : 64;  // keys of a tile
  static constexpr int LD = D + 8;               // padded row, in elements
  static constexpr size_t smem = sizeof(__nv_bfloat16) * (kBQ + 4 * BK) * LD;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when !pred
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c (16x8 fp32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma16816(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int D>
__global__ void __launch_bounds__(kWarps * 32) flash_bf16_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
    float* __restrict__ lse, int H, int KH, int Sq, int Skv, Strides qs,
    Strides ks, Strides vs, Strides os, float scale, float cap, int causal,
    int window) {
  constexpr int BK = BfTile<D>::BK, LD = BfTile<D>::LD;
  constexpr int NT = BK / 8;   // 8-key column tiles of S
  constexpr int DT = D / 8;    // 8-wide column tiles of O
  constexpr int CH = D / 8;    // 16-byte chunks of a row
  constexpr float LOG2E = 1.4426950408889634f;
  extern __shared__ __align__(16) unsigned char smraw[];
  __nv_bfloat16* qsm = reinterpret_cast<__nv_bfloat16*>(smraw);  // kBQ x LD
  __nv_bfloat16* ksm = qsm + kBQ * LD;     // 2 stages x BK x LD
  __nv_bfloat16* vsm = ksm + 2 * BK * LD;  // 2 stages x BK x LD

  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KH);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const __nv_bfloat16* qb = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* kb = k + b * ks.b + kh * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + kh * vs.h;
  const KeyRange kr = key_range(q0, kBQ, Sq, Skv, causal, window, BK);
  const int n_tiles = (kr.end - kr.begin + BK - 1) / BK;

  for (int e = tid; e < kBQ * CH; e += blockDim.x) {
    const int r = e / CH, c = (e % CH) * 8, qi = q0 + r;
    cp_async16(qsm + r * LD + c, qb + static_cast<long>(qi < Sq ? qi : 0) * qs.s + c,
               qi < Sq);
  }
  auto load_kv = [&](int tile, int stage) {
    const int k0 = kr.begin + tile * BK;
    for (int e = tid; e < BK * CH; e += blockDim.x) {
      const int r = e / CH, c = (e % CH) * 8, kj = k0 + r;
      const long row = kj < Skv ? kj : 0;
      cp_async16(ksm + (stage * BK + r) * LD + c, kb + row * ks.s + c, kj < Skv);
      cp_async16(vsm + (stage * BK + r) * LD + c, vb + row * vs.s + c, kj < Skv);
    }
  };
  load_kv(0, 0);
  cp_async_commit();

  // this lane's rows of the warp's 16: g and g + 8
  const int g = lane >> 2, t4 = lane & 3;
  const int off = Skv - Sq;
  const int qi0 = q0 + warp * 16 + g;
  const int qp[2] = {qi0 + off, qi0 + 8 + off};
  float acc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m[2] = {rt::NEG_INF, rt::NEG_INF}, l[2] = {0.f, 0.f};

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int stage = tile & 1;
    if (tile + 1 < n_tiles) {
      load_kv(tile + 1, stage ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* kst = ksm + stage * BK * LD;
    const __nv_bfloat16* vst = vsm + stage * BK * LD;

    // S = Q K^T: 16 x BK per warp
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, qsm + (warp * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) * LD
                     + kk * 16 + 8 * (lane >> 4));
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bb[4];
        ldsm_x4(bb, kst + (np * 16 + (lane & 7) + 8 * (lane >> 4)) * LD
                        + kk * 16 + 8 * ((lane >> 3) & 1));
        mma16816(s[2 * np], a, bb[0], bb[1]);
        mma16816(s[2 * np + 1], a, bb[2], bb[3]);
      }
    }

    // masks and the online softmax on the fragments: element e of column
    // tile j is row g + 8*(e/2), key 8j + 2*t4 + e%2 of the tile
    const int k0 = kr.begin + tile * BK;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = score(s[j][e], scale, cap, k0 + 8 * j + 2 * t4 + (e & 1),
                        qp[e >> 1], Skv, causal, window);
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    float corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = exp2f((m[r] - mx[r]) * LOG2E);
      m[r] = mx[r];
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float sv = s[j][e];
        const float p = sv == rt::NEG_INF ? 0.f : exp2f((sv - m[e >> 1]) * LOG2E);
        s[j][e] = p;
        rs[e >> 1] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + rs[r];
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      acc[j][0] *= corr[0];
      acc[j][1] *= corr[0];
      acc[j][2] *= corr[1];
      acc[j][3] *= corr[1];
    }

    // O += P V, P rounded to bf16
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t bb[4];
        ldsm_x4_t(bb, vst + (kk * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) * LD
                          + dp * 16 + 8 * (lane >> 4));
        mma16816(acc[2 * dp], a, bb[0], bb[1]);
        mma16816(acc[2 * dp + 1], a, bb[2], bb[3]);
      }
    }
    __syncthreads();  // this stage is consumed before it is refilled
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  __nv_bfloat16* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = qi0 + 8 * r;
    if (qi >= Sq) continue;
    const float safe = l[r] > 0.f ? l[r] : 1.f, inv = 1.f / safe;
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      const __nv_bfloat162 pair = __floats2bfloat162_rn(acc[j][2 * r] * inv,
                                                        acc[j][2 * r + 1] * inv);
      *reinterpret_cast<__nv_bfloat162*>(ob + qi * os.s + 8 * j + 2 * t4) = pair;
    }
    if (lse != nullptr && t4 == 0)
      lse[(static_cast<long>(b) * H + h) * Sq + qi] = m[r] + logf(safe);
  }
}

// ---------------------------------------------------------------------------
// fp32: register-tiled SIMT
// ---------------------------------------------------------------------------

constexpr int kF32Threads = 256;
constexpr int kF32BQ = 64;  // query rows of a block: 16 row groups of 4

template <int D> struct F32Tile {
  static constexpr int BK = D == 256 ? 32 : 64;  // keys of a tile
  static constexpr int KT = BK / 16;             // keys of a thread
  static constexpr int CT = D / 16;              // output columns of a thread
  static constexpr int LP = kF32BQ + 4;          // padded row of P^T
  static constexpr size_t smem =
      sizeof(float) * (D * kF32BQ + D * BK + BK * D + BK * LP);
};

template <int KT> struct KeyVec;
template <> struct KeyVec<4> {
  __device__ static void load(const float* p, float* out) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
  }
};
template <> struct KeyVec<2> {
  __device__ static void load(const float* p, float* out) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    out[0] = x.x; out[1] = x.y;
  }
};

template <int D>
__global__ void __launch_bounds__(kF32Threads) flash_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ o,
    float* __restrict__ lse, int H, int KH, int Sq, int Skv, Strides qs,
    Strides ks, Strides vs, Strides os, float scale, float cap, int causal,
    int window) {
  using T = F32Tile<D>;
  constexpr int BQ = kF32BQ, BK = T::BK, KT = T::KT, CT = T::CT, LP = T::LP;
  extern __shared__ __align__(16) float fsm[];
  float* qt = fsm;             // D x BQ: Q^T
  float* kt = qt + D * BQ;     // D x BK: K^T
  float* vt = kt + D * BK;     // BK x D: V
  float* pt = vt + BK * D;     // BK x LP: P^T

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KH);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + kh * ks.h;
  const float* vb = v + b * vs.b + kh * vs.h;
  const KeyRange kr = key_range(q0, BQ, Sq, Skv, causal, window, BK);
  const int off = Skv - Sq;

  // Q^T: consecutive threads take consecutive rows of one 4-column chunk,
  // so the transposed stores hit consecutive banks
  for (int e = tid; e < BQ * (D / 4); e += blockDim.x) {
    const int r = e % BQ, c = (e / BQ) * 4, qi = q0 + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (qi < Sq) x = *reinterpret_cast<const float4*>(qb + qi * qs.s + c);
    qt[(c + 0) * BQ + r] = x.x;
    qt[(c + 1) * BQ + r] = x.y;
    qt[(c + 2) * BQ + r] = x.z;
    qt[(c + 3) * BQ + r] = x.w;
  }

  float acc[4][CT], m[4], l[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = rt::NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < CT; ++c) acc[r][c] = 0.f;
  }

  for (int k0 = kr.begin; k0 < kr.end; k0 += BK) {
    __syncthreads();  // the previous tile is consumed (and Q^T is staged)
    for (int e = tid; e < BK * (D / 4); e += blockDim.x) {
      const int r = e % BK, c = (e / BK) * 4, kj = k0 + r;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (kj < Skv) x = *reinterpret_cast<const float4*>(kb + kj * ks.s + c);
      kt[(c + 0) * BK + r] = x.x;
      kt[(c + 1) * BK + r] = x.y;
      kt[(c + 2) * BK + r] = x.z;
      kt[(c + 3) * BK + r] = x.w;
    }
    for (int e = tid; e < BK * (D / 4); e += blockDim.x) {
      const int r = e / (D / 4), c = (e % (D / 4)) * 4, kj = k0 + r;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (kj < Skv) x = *reinterpret_cast<const float4*>(vb + kj * vs.s + c);
      *reinterpret_cast<float4*>(vt + r * D + c) = x;
    }
    __syncthreads();

    // S: rows 4*ty.., keys tx*KT..
    float s[4][KT];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < KT; ++c) s[r][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(qt + d * BQ + 4 * ty);
      float kv[KT];
      KeyVec<KT>::load(kt + d * BK + KT * tx, kv);
      const float qa[4] = {qv.x, qv.y, qv.z, qv.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < KT; ++c) s[r][c] = fmaf(qa[r], kv[c], s[r][c]);
    }

    float corr[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qp = q0 + 4 * ty + r + off;
      float mx = m[r];
#pragma unroll
      for (int c = 0; c < KT; ++c) {
        s[r][c] = score(s[r][c], scale, cap, k0 + KT * tx + c, qp, Skv,
                        causal, window);
        mx = fmaxf(mx, s[r][c]);
      }
#pragma unroll
      for (int o2 = 8; o2 > 0; o2 >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o2));
      corr[r] = expf(m[r] - mx);
      m[r] = mx;
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < KT; ++c) {
        const float p = s[r][c] == rt::NEG_INF ? 0.f : expf(s[r][c] - mx);
        pt[(KT * tx + c) * LP + 4 * ty + r] = p;
        rs += p;
      }
      l[r] = l[r] * corr[r] + rs;
#pragma unroll
      for (int c = 0; c < CT; ++c) acc[r][c] *= corr[r];
    }
    __syncthreads();

    // O: rows 4*ty.., columns 4*tx + 64*j.. (8 threads read 128 bytes in a row)
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      const float4 pv = *reinterpret_cast<const float4*>(pt + kk * LP + 4 * ty);
      const float pa[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
      for (int j = 0; j < CT / 4; ++j) {
        const float4 x = *reinterpret_cast<const float4*>(vt + kk * D + 64 * j + 4 * tx);
        const float va[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc[r][4 * j + c] = fmaf(pa[r], va[c], acc[r][4 * j + c]);
      }
    }
  }

  float* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int o2 = 8; o2 > 0; o2 >>= 1)
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], o2);
    const int qi = q0 + 4 * ty + r;
    if (qi >= Sq) continue;
    const float safe = l[r] > 0.f ? l[r] : 1.f;
#pragma unroll
    for (int j = 0; j < CT / 4; ++j) {
      const float4 x = make_float4(acc[r][4 * j] / safe, acc[r][4 * j + 1] / safe,
                                   acc[r][4 * j + 2] / safe, acc[r][4 * j + 3] / safe);
      *reinterpret_cast<float4*>(ob + qi * os.s + 64 * j + 4 * tx) = x;
    }
    if (lse != nullptr && tx == 0)
      lse[(static_cast<long>(b) * H + h) * Sq + qi] = m[r] + logf(safe);
  }
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        float* lse, int B, int H, int KH, int Sq, int Skv,
                        Strides qs, Strides ks, Strides vs, Strides os,
                        float scale, float cap, int causal, int window,
                        cudaStream_t stream) {
  auto kernel = flash_bf16_kernel<D>;
  cudaError_t err = rt::allow_smem(kernel, BfTile<D>::smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, kWarps * 32, BfTile<D>::smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), lse,
      H, KH, Sq, Skv, qs, ks, vs, os, scale, cap, causal, window);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       float* lse, int B, int H, int KH, int Sq, int Skv,
                       Strides qs, Strides ks, Strides vs, Strides os,
                       float scale, float cap, int causal, int window,
                       cudaStream_t stream) {
  auto kernel = flash_f32_kernel<D>;
  cudaError_t err = rt::allow_smem(kernel, F32Tile<D>::smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kF32BQ - 1) / kF32BQ, H, B);
  kernel<<<grid, kF32Threads, F32Tile<D>::smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, H, KH, Sq,
      Skv, qs, ks, vs, os, scale, cap, causal, window);
  return cudaGetLastError();
}

}  // namespace

// strides: 12 element strides, (b, h, s) for each of q, k, v, o; lse: fp32
// (B, H, Sq) or null
extern "C" int rt_flash_attention(const void* q, const void* k, const void* v,
                                  void* o, void* lse, int B, int H, int KH,
                                  int Sq, int Skv, int D, const long* strides,
                                  float scale, float cap, int causal,
                                  int window, int dtype, void* stream) {
  if (B == 0 || Sq == 0) return cudaSuccess;
  const Strides qs{strides[0], strides[1], strides[2]};
  const Strides ks{strides[3], strides[4], strides[5]};
  const Strides vs{strides[6], strides[7], strides[8]};
  const Strides os{strides[9], strides[10], strides[11]};
  float* ls = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RT_FLASH(FN, DD) \
  FN<DD>(q, k, v, o, ls, B, H, KH, Sq, Skv, qs, ks, vs, os, scale, cap, causal, window, s)
  if (dtype == rt::BF16) {
    switch (D) {
      case 64: return RT_FLASH(launch_bf16, 64);
      case 128: return RT_FLASH(launch_bf16, 128);
      case 256: return RT_FLASH(launch_bf16, 256);
      default: return cudaErrorInvalidValue;
    }
  }
  switch (D) {
    case 64: return RT_FLASH(launch_f32, 64);
    case 128: return RT_FLASH(launch_f32, 128);
    case 256: return RT_FLASH(launch_f32, 256);
    default: return cudaErrorInvalidValue;
  }
#undef RT_FLASH
}
