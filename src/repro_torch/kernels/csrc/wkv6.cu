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
// Bound on the H100: neither bytes nor operations but the sweep's latency:
// step by step, a head's T steps run one after another, each n*n
// multiply-adds for o and as many for S. The Pallas kernel keeps S in VMEM
// across a sequential grid of time chunks. Here the wrapper's plan
// (`rwkv6.wkv6_plan`) picks one of two kernels:
//
// step (T below the plan's threshold; decode, T = 1): one block of n
// threads owns one (b, h), thread j owns column j of S in n registers (the
// columns are independent, the only reduction runs over i inside a
// column), and the block walks T in chunks of CHUNK steps: a chunk's r, k,
// v and w are staged in shared memory with coalesced loads, one barrier,
// then its steps run with no barrier at all, every thread reading r_i,
// k_i, w_i and u_i as broadcasts.
//
// chunked (longer T; prefill): the chunked form. Per chunk of L steps from
// t0, with the state S_c at t0, A_t = prod_{t0<=tau<t} w_tau and
// D[s,t] = prod_{s<tau<t} w_tau,
//   o_t     = (r_t A_t) S_c + sum_{t0<=s<t} (sum_i r_t k_s D[s,t]) v_s
//             + (sum_i r_t u k_t) v_t
//   S_{c+1} = diag(A_{t0+L}) S_c + sum_s diag(D[s,t0+L]) k_s v_s^T.
// Every term but the carry of S is computed for all chunks at once; the
// carry is elementwise (S_{c+1}[i][j] needs S_c[i][j] alone), so the
// sequential part is T/L fused multiply-adds a state element. A block owns
// (b, h, a group of 16 value columns), so a (1, 32, T, 64) prefill has 128
// blocks, not 32. It walks T in windows of 64 steps, each window's r, k, w
// and v (its columns) brought by 16-byte cp.async copies into one of two
// stages while the previous window is computed. The decays are running
// products, never exp of differences of cumulative logs: w = exp(-exp(x))
// underflows to exact zeros, where those would give NaN. All fp32 FMAs:
// the work is ~67 MFLOP at the prefill shape, so tensor cores buy nothing,
// and bf16 or TF32 would break the fp32 tolerance.
//
// Both: no atomics and a fixed summation order, so every run gives the
// same bits. Each thread reads its part of the state before the first step
// and writes it after the last, and no other thread touches it, so s0 and
// the output state may alias.
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
                   int H, int T_len, int blocks, const Strides& st,
                   cudaStream_t stream) {
  wkv6_kernel<T, N><<<blocks, N, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(w), u, s_in, s_out,
      static_cast<T*>(o), H, T_len, st);
  return cudaGetLastError();
}

// -- chunked: T >= the plan's threshold ---------------------------------------

constexpr int kChunkThreads = 256;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Q adjacent values from shared memory as fp32 (Q a multiple of 4; p on
// 16 bytes for fp32, 8 bytes for bf16)
template <int Q>
__device__ __forceinline__ void load_f32(const float* p, float* out) {
#pragma unroll
  for (int e = 0; e < Q; e += 4) {
    const float4 v = *reinterpret_cast<const float4*>(p + e);
    out[e] = v.x; out[e + 1] = v.y; out[e + 2] = v.z; out[e + 3] = v.w;
  }
}
template <int Q>
__device__ __forceinline__ void load_f32(const __nv_bfloat16* p, float* out) {
#pragma unroll
  for (int e = 0; e < Q; e += 4) {
    const uint2 v = *reinterpret_cast<const uint2*>(p + e);
    out[e] = __uint_as_float(v.x << 16); out[e + 1] = __uint_as_float(v.x & 0xffff0000u);
    out[e + 2] = __uint_as_float(v.y << 16); out[e + 3] = __uint_as_float(v.y & 0xffff0000u);
  }
}

// Shared memory of a chunked block: two stages of raw r, k, w (WT x N) and
// v (WT x J), then fp32 arrays (offsets in floats): r_t * A_t and
// k_s * D[s, chunk end] (WT x N); the pair sums per 16-wide slice of i
// (NQ x WT x L) and summed (WT x L), row t, column s - t0; each chunk's
// state term U and starting state S_c (NC x N x J); each chunk's decay
// A_{t0+L} (NC x N); u (N).
template <typename T, int N, int L>
struct ChunkLayout {
  static constexpr int WT = 64;              // steps a window
  static constexpr int NC = WT / L;          // chunks a window
  static constexpr int J = 16;               // value columns a block
  static constexpr int G = N / J;            // blocks a head
  static constexpr int NQ = N / 16;          // slices of i
  static constexpr int R0 = 0, K0 = WT * N, W0 = 2 * WT * N, V0 = 3 * WT * N;
  static constexpr int Stage = 3 * WT * N + WT * J;  // elements of T
  static constexpr size_t RawBytes = 2 * Stage * sizeof(T);
  static constexpr int RA = 0, KD = RA + WT * N, PP = KD + WT * N,
                       P = PP + NQ * WT * L, U = P + WT * L, SC = U + NC * N * J,
                       AE = SC + NC * N * J, US = AE + NC * N, F32 = US + N;
  static constexpr size_t Smem = RawBytes + sizeof(float) * F32;
};

template <typename T, int N, int L>
__global__ void __launch_bounds__(kChunkThreads) wkv6_chunked_kernel(
    const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ w, const float* __restrict__ u, const float* s_in,
    float* s_out, T* __restrict__ o, int H, int T_len, Strides st, int vec) {
  using CL = ChunkLayout<T, N, L>;
  constexpr int WT = CL::WT, J = CL::J, NQ = CL::NQ;
  extern __shared__ __align__(16) unsigned char smem[];
  T* raw = reinterpret_cast<T*>(smem);
  float* f = reinterpret_cast<float*>(smem + CL::RawBytes);
  float* rA = f + CL::RA;
  float* kd = f + CL::KD;
  float* Pp = f + CL::PP;
  float* P = f + CL::P;
  float* U = f + CL::U;
  float* Sc = f + CL::SC;
  float* Ae = f + CL::AE;
  float* us = f + CL::US;
  const int tid = threadIdx.x;
  const int bh = blockIdx.x / CL::G, j0 = (blockIdx.x % CL::G) * J;
  const int b = bh / H, h = bh % H;
  const long obase = b * st.s[4][0] + h * st.s[4][1] + j0;
  // the state: thread tid < N * J / 4 owns row si, columns sj .. sj + 3
  constexpr int SQ = J / 4;
  const bool owns = tid < N * SQ;
  const int si = tid / SQ, sj = 4 * (tid % SQ);
  const long sofs = static_cast<long>(bh) * N * N + static_cast<long>(si) * N + j0 + sj;
  float S[4];
#pragma unroll
  for (int x = 0; x < 4; ++x) S[x] = owns && s_in ? s_in[sofs + x] : 0.f;
  if (tid < N) us[tid] = u[h * N + tid];
  // the outputs: thread tid takes column oj of rows ot .. ot + 3 of a window
  const int oj = tid % J, ot = 4 * (tid / J), oc = ot / L;

  // one window of rows [tw, tw + lw) into stage `stage`: r, k, w whole,
  // v from this block's column j0
  auto load = [&](int tw, int lw, int stage) {
    T* dst0 = raw + stage * CL::Stage;
    constexpr int per16 = 16 / sizeof(T);
#pragma unroll
    for (int a = 0; a < 4; ++a) {  // unrolled: every index below is constant
      const T* sp = a == 0 ? r : a == 1 ? k : a == 2 ? w : v;
      const int sr = a == 0 ? 0 : a == 1 ? 1 : a == 2 ? 3 : 2;  // Strides row
      const int width = a < 3 ? N : J, pieces = width / per16;
      const long sb = b * st.s[sr][0] + h * st.s[sr][1] + (a == 3 ? j0 : 0);
      const long ts = st.s[sr][2];
      T* dst = dst0 + (a < 3 ? a * WT * N : CL::V0);
      for (int e = tid; e < lw * pieces; e += kChunkThreads) {
        const int t = e / pieces, piece = e % pieces;
        const T* s = sp + sb + static_cast<long>(tw + t) * ts + piece * per16;
        T* d = dst + t * width + piece * per16;
        if (vec) {
          cp_async16(d, s);
        } else {
#pragma unroll
          for (int x = 0; x < per16; ++x) d[x] = s[x];
        }
      }
    }
  };

  const int nwin = (T_len + WT - 1) / WT;
  load(0, min(WT, T_len), 0);
  cp_async_commit();
  for (int win = 0; win < nwin; ++win) {
    const int tw = win * WT, lw = min(WT, T_len - tw), ncw = (lw + L - 1) / L;
    if (win + 1 < nwin) {
      load(tw + WT, min(WT, T_len - tw - WT), (win + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this window has landed (and u, the first time)
    const T* R = raw + (win & 1) * CL::Stage + CL::R0;
    const T* Kr = raw + (win & 1) * CL::Stage + CL::K0;
    const T* Wr = raw + (win & 1) * CL::Stage + CL::W0;
    const T* V = raw + (win & 1) * CL::Stage + CL::V0;

    // r_t * A_t and each chunk's decay A_{t0+L}, per (chunk, i)
    for (int e = tid; e < ncw * N; e += kChunkThreads) {
      const int c = e / N, i = e % N, te = min(c * L + L, lw);
      float a = 1.f;
      for (int t = c * L; t < te; ++t) {
        rA[t * N + i] = rt::to_f32(R[t * N + i]) * a;
        a *= rt::to_f32(Wr[t * N + i]);
      }
      Ae[c * N + i] = a;
    }
    // per (chunk, slice q of 16 i, s): the pair sums over the slice for
    // every t > s of the chunk, the bonus at t = s, and k_s * D[s, end].
    // The lanes of a warp walk the same rows t, the ones with t <= s idle
    for (int e = tid; e < ncw * NQ * L; e += kChunkThreads) {
      const int s_ = e % L, q = (e / L) % NQ, c = e / (L * NQ);
      const int s = c * L + s_, te = min(c * L + L, lw);
      if (s >= te) continue;
      float kk[16], d[16], x[16];
      load_f32<16>(Kr + s * N + q * 16, kk);
      load_f32<16>(R + s * N + q * 16, x);
      // even and odd i summed apart, then added: two short chains
      float b0 = 0.f, b1 = 0.f;
#pragma unroll
      for (int ii = 0; ii < 16; ii += 2) {
        d[ii] = d[ii + 1] = 1.f;
        b0 = fmaf(x[ii] * us[q * 16 + ii], kk[ii], b0);
        b1 = fmaf(x[ii + 1] * us[q * 16 + ii + 1], kk[ii + 1], b1);
      }
      Pp[(q * WT + s) * L + s_] = b0 + b1;
      for (int t = c * L + 1; t < te; ++t) {
        if (t <= s) continue;  // lockstep rows: one address a slice
        load_f32<16>(R + t * N + q * 16, x);
        float p0 = 0.f, p1 = 0.f;
#pragma unroll
        for (int ii = 0; ii < 16; ii += 2) {
          p0 = fmaf(x[ii], kk[ii] * d[ii], p0);
          p1 = fmaf(x[ii + 1], kk[ii + 1] * d[ii + 1], p1);
        }
        Pp[(q * WT + t) * L + s_] = p0 + p1;
        load_f32<16>(Wr + t * N + q * 16, x);
#pragma unroll
        for (int ii = 0; ii < 16; ++ii) d[ii] *= x[ii];
      }
#pragma unroll
      for (int ii = 0; ii < 16; ++ii) kd[s * N + q * 16 + ii] = kk[ii] * d[ii];
    }
    __syncthreads();

    // each chunk's state term U[c][i][j] = sum_s kd[s][i] v_s[j], four
    // columns a task; the pair sums added over the slices in slice order
    // (the window's chunks side by side: NC x 4 independent sums a task)
    for (int e = tid; e < N * SQ; e += kChunkThreads) {
      const int jq = e % SQ, i = e / SQ;
      float acc[CL::NC][4], vv[4];
#pragma unroll
      for (int c = 0; c < CL::NC; ++c)
#pragma unroll
        for (int x = 0; x < 4; ++x) acc[c][x] = 0.f;
      for (int s_ = 0; s_ < L; ++s_) {
#pragma unroll
        for (int c = 0; c < CL::NC; ++c) {
          const int s = c * L + s_;
          if (s >= lw) continue;
          const float kv = kd[s * N + i];
          load_f32<4>(V + s * J + 4 * jq, vv);
#pragma unroll
          for (int x = 0; x < 4; ++x) acc[c][x] = fmaf(kv, vv[x], acc[c][x]);
        }
      }
#pragma unroll
      for (int c = 0; c < CL::NC; ++c)
#pragma unroll
        for (int x = 0; x < 4; ++x) U[(c * N + i) * J + 4 * jq + x] = acc[c][x];
    }
    for (int e = tid; e < lw * L; e += kChunkThreads) {
      const int t = e / L, s_ = e % L;
      if ((t / L) * L + s_ > t) continue;
      float p = Pp[t * L + s_];
#pragma unroll
      for (int q = 1; q < NQ; ++q) p += Pp[(q * WT + t) * L + s_];
      P[t * L + s_] = p;
    }
    __syncthreads();

    // the within-chunk outputs, and the carry from chunk to chunk
    float oacc[4] = {0.f, 0.f, 0.f, 0.f};
    if (ot < lw) {
      const int t_hi = min(ot + 3, lw - 1);
      for (int s = oc * L; s <= t_hi; ++s) {
        const float vs = rt::to_f32(V[s * J + oj]);
#pragma unroll
        for (int x = 0; x < 4; ++x)
          if (s <= ot + x && ot + x < lw)
            oacc[x] = fmaf(P[(ot + x) * L + s - oc * L], vs, oacc[x]);
      }
    }
    if (owns) {
      for (int c = 0; c < ncw; ++c) {
        const float a = Ae[c * N + si];
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          Sc[(c * N + si) * J + sj + x] = S[x];
          S[x] = fmaf(a, S[x], U[(c * N + si) * J + sj + x]);
        }
      }
    }
    __syncthreads();

    // the carried state's part: o_t += (r_t * A_t) S_c
    if (ot < lw) {
      const float* scol = Sc + oc * N * J + oj;
      const int rows = min(4, lw - ot);
      for (int i = 0; i < N; ++i) {
        const float sv = scol[i * J];
#pragma unroll
        for (int x = 0; x < 4; ++x)
          if (x < rows) oacc[x] = fmaf(rA[(ot + x) * N + i], sv, oacc[x]);
      }
      for (int x = 0; x < rows; ++x)
        o[obase + static_cast<long>(tw + ot + x) * st.s[4][2] + oj] =
            rt::from_f32<T>(oacc[x]);
    }
    __syncthreads();  // the stage and the arrays are free for the next window
  }
  if (owns) {
#pragma unroll
    for (int x = 0; x < 4; ++x) s_out[sofs + x] = S[x];
  }
}

template <typename T, int N, int L>
cudaError_t launch_chunked(const void* r, const void* k, const void* v, const void* w,
                           const float* u, const float* s_in, float* s_out, void* o,
                           int H, int T_len, int blocks, const Strides& st,
                           cudaStream_t stream) {
  using CL = ChunkLayout<T, N, L>;
  auto kernel = wkv6_chunked_kernel<T, N, L>;
  cudaError_t err = rt::allow_smem(kernel, CL::Smem);
  if (err != cudaSuccess) return err;
  // 16-byte copies: every row of r, k, w, v starts on 16 bytes
  constexpr int per16 = 16 / sizeof(T);
  int vec = 1;
  const void* ins[4] = {r, k, v, w};
  for (int a = 0; a < 4; ++a) {
    vec &= reinterpret_cast<uintptr_t>(ins[a]) % 16 == 0;
    for (int c = 0; c < 3; ++c) vec &= st.s[a][c] % per16 == 0;
  }
  kernel<<<blocks, kChunkThreads, CL::Smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(w), u, s_in, s_out, static_cast<T*>(o), H, T_len, st, vec);
  return cudaGetLastError();
}

// kernel, L, J, blocks: the plan's launch, taken as it is once it gives
// every (b, h) and every group of J value columns one block
template <typename T, int N>
cudaError_t launch_kernel(int kernel, int L, int J, int blocks, const void* r,
                          const void* k, const void* v, const void* w, const float* u,
                          const float* s_in, float* s_out, void* o, int B, int H,
                          int T_len, const Strides& st, cudaStream_t stream) {
  if (kernel == 0) {
    if (J != N || blocks != B * H) return cudaErrorInvalidValue;
    return launch<T, N>(r, k, v, w, u, s_in, s_out, o, H, T_len, blocks, st, stream);
  }
  using CL = ChunkLayout<T, N, 16>;
  if (kernel != 1 || L != 16 || J != CL::J || blocks != B * H * CL::G)
    return cudaErrorInvalidValue;
  return launch_chunked<T, N, 16>(r, k, v, w, u, s_in, s_out, o, H, T_len, blocks, st,
                                  stream);
}

template <typename T>
cudaError_t launch_n(int kernel, int L, int J, int blocks, const void* r, const void* k,
                     const void* v, const void* w, const float* u, const float* s_in,
                     float* s_out, void* o, int B, int H, int T_len, int n,
                     const Strides& st, cudaStream_t stream) {
  switch (n) {
    case 16:
      return launch_kernel<T, 16>(kernel, L, J, blocks, r, k, v, w, u, s_in, s_out, o, B,
                                  H, T_len, st, stream);
    case 32:
      return launch_kernel<T, 32>(kernel, L, J, blocks, r, k, v, w, u, s_in, s_out, o, B,
                                  H, T_len, st, stream);
    case 64:
      return launch_kernel<T, 64>(kernel, L, J, blocks, r, k, v, w, u, s_in, s_out, o, B,
                                  H, T_len, st, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// strides: 15 element strides, (b, h, t) of r, k, v, w, then of o.
// s_in may be null (zero state) or equal to s_out. kernel (0 step, 1
// chunked in chunks of L steps), col_group and blocks: the plan
// (rwkv6.wkv6_plan), launched as it is.
extern "C" int rt_wkv6(const void* r, const void* k, const void* v,
                       const void* w, const void* u, const void* s_in,
                       void* s_out, void* o, int B, int H, int T_len, int n,
                       const long* strides, int dtype, int kernel, int L,
                       int col_group, int blocks, void* stream) {
  if (B == 0 || H == 0) return cudaSuccess;
  Strides st;
  for (int a = 0; a < 5; ++a)
    for (int c = 0; c < 3; ++c) st.s[a][c] = strides[a * 3 + c];
  const float* uf = static_cast<const float*>(u);
  const float* si = static_cast<const float*>(s_in);
  float* so = static_cast<float*>(s_out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == rt::BF16)
    return launch_n<__nv_bfloat16>(kernel, L, col_group, blocks, r, k, v, w, uf, si, so,
                                   o, B, H, T_len, n, st, s);
  return launch_n<float>(kernel, L, col_group, blocks, r, k, v, w, uf, si, so, o, B, H,
                         T_len, n, st, s);
}
