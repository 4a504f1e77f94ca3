// Hadamard adapter affine, forward and backward.
//
// Replaces: src/repro/kernels/hadamard.py::_affine_call (forward, the
// pl.pallas_call of _affine_fwd_kernel) and ::_affine_bwd_call (its VJP,
// _affine_bwd_kernel), reached through hadamard_affine and, for the
// backward, through fused_adapter_residual_norm's _fused_bwd.
//
//   forward:  y  = x*w + b                          x, y: (n, d); w, b: (d,)
//   backward: dx = g*w;  dw = sum_rows g*x;  db = sum_rows g  (fp32 sums)
//
// Bound on the H100: memory. The forward moves 2*n*d elements for 2 flops
// each, the backward 3*n*d elements for ~5 flops each; both sit two orders
// of magnitude below the card's flop/byte balance point. Each element is
// read once and each output written once, so the design is about keeping
// enough bytes in flight to cover device-memory latency on all 132 SMs.
//
// Both kernels launch the plan the wrapper computes from the shapes
// (hadamard.affine_plan, hadamard.affine_bwd_plan), and the entry points
// refuse one that does not cover every (row, column) once. A block is
// kLanes threads across a column tile of kLanes vectors of `vec` elements
// (16 bytes of the wider activation dtype: 4 with any fp32 operand, 8 for
// bf16 alone; 1 where d or a pointer is off the 16-byte grid) by `warps`
// warps down rows_per_block rows: a decode tick of n < 8 rows takes n warps,
// so no warp is launched without a row. A thread walks rows ty, ty + warps,
// ... UNROLL rows at a time, every load of the UNROLL rows issued before any
// arithmetic, with its columns of w (and b) held in registers for all of
// them. The grid is a few blocks an SM, each a long run of rows.
//
// The TPU kernel accumulates dw/db across its sequential row grid. Hopper
// blocks run in no order, so the backward sums across blocks inside the
// same launch, in an order that does not depend on which block finishes
// when: the block of row chunk k adds its rows' g*x and g in row order per
// thread, then its warps in a fixed tree through shared memory, and writes
// the result as partial[k][0|1][column]. It then counts its arrival on its
// column tile (atomicInc after __threadfence). The block that arrives last
// sums the tile's partials in chunk order, chunk k on warp k % warps, then
// the warps in the same fixed tree, and writes dw and db. The counter only
// picks who sums, never the order, so dw/db are the same bits on every run.
// Rows past n are never read (a row loop stops at n), which is the Pallas
// kernel's pad-row mask; n == 0 is one chunk of no rows, whose sums are 0.
#include "common.cuh"

namespace {

constexpr int kLanes = 32;        // threads across a column tile
constexpr int kMaxWarps = 8;      // warps down a block's rows, at most
constexpr int kMaxTiles = 4096;   // column tiles of one backward launch

// The backward's arrival counters, one per column tile. They live in the
// library's own device memory, zero when the module loads, and every launch
// leaves them zero: the tile's last arrival wraps its counter to 0 in the
// same atomicInc that counts it, with no separate reset, so no call
// allocates or clears them and every replay of a CUDA graph that captured
// a launch finds them zero. A buffer from the wrapper would need a memset
// before each launch, a second operation on the stream per call. The cost:
// two backward launches running at once on one device (two streams) would
// share them; the port issues every kernel on one stream.
__device__ unsigned int g_tile_arrivals[kMaxTiles];

// VEC elements of T as loaded (one access of VEC * sizeof(T) bytes, aligned
// to that), widened to fp32 only when read: bf16 stays packed in pairs, so
// the rows in flight take half the registers. Activations are read once and
// outputs written once, so both go through L2 as evict-first (streaming)
// accesses, which leaves L2 to the backward's partials, w and b
template <typename T, int VEC>
struct Packed {
  uint32_t w[(VEC * sizeof(T) + 3) / 4];

  __device__ __forceinline__ void load(const T* p) {
    rt::load_bytes<static_cast<int>(VEC * sizeof(T)), true>(p, w);
  }
  __device__ __forceinline__ float operator[](int j) const {
    if constexpr (sizeof(T) == 4) return __uint_as_float(w[j]);
    const uint32_t pair = w[j >> 1];  // bf16 widens exactly by a shift
    return __uint_as_float((j & 1) ? (pair & 0xffff0000u) : (pair << 16));
  }
};

// VEC fp32 partial sums at p through L2 alone: other SMs wrote them in this
// launch, so this SM's L1 must not answer
template <int VEC>
__device__ __forceinline__ void load_partial(const float* p, float* v) {
  if constexpr (VEC == 1) {
    v[0] = __ldcg(p);
  } else {
#pragma unroll
    for (int i = 0; i < VEC / 4; ++i) {
      const float4 t = __ldcg(reinterpret_cast<const float4*>(p) + i);
      v[4 * i] = t.x; v[4 * i + 1] = t.y; v[4 * i + 2] = t.z; v[4 * i + 3] = t.w;
    }
  }
}

// The block's sums of its columns: each warp's two sums (g*x, g) of its
// VEC columns a lane go into red (warp w's at red[w * 2 * kLanes * VEC],
// g*x then g), then are added over the warps in
// a fixed tree order, leaving the block's at red[0..2 * kLanes * VEC).
// Every thread of the block calls it.
template <int VEC>
__device__ __forceinline__ void block_sums(float* red, const float* sgx,
                                           const float* sg, int tx, int ty,
                                           int warps) {
  constexpr int kRow = 2 * kLanes * VEC;
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    red[ty * kRow + tx * VEC + j] = sgx[j];
    red[ty * kRow + kLanes * VEC + tx * VEC + j] = sg[j];
  }
  for (int s = 1; s < warps; s <<= 1) {
    __syncthreads();
    if (ty % (2 * s) == 0 && ty + s < warps)
#pragma unroll
      for (int k = 0; k < 2; ++k)
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          red[ty * kRow + k * kLanes * VEC + tx * VEC + j] +=
              red[(ty + s) * kRow + k * kLanes * VEC + tx * VEC + j];
  }
  __syncthreads();
}

// grid (column tiles, row chunks); block (kLanes, warps)
template <typename T, int VEC, int UNROLL>
__global__ void __launch_bounds__(kLanes * kMaxWarps) affine_fwd_kernel(
    const T* __restrict__ x, const void* w, int w_bf16, const void* b,
    int b_bf16, T* __restrict__ y, long n, int d, long rows_per_block) {
  const int c0 = (blockIdx.x * kLanes + threadIdx.x) * VEC;
  if (c0 >= d) return;
  rt::Raw<VEC> wr, br;  // 16-byte aligned where VEC > 1 (the plan's check)
  wr.load(w, w_bf16, c0);
  br.load(b, b_bf16, c0);
  float wv[VEC], bv[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    wv[j] = wr.get(w_bf16, j);
    bv[j] = br.get(b_bf16, j);
  }
  const long r0 = blockIdx.y * rows_per_block;
  const long r_end = r0 + rows_per_block < n ? r0 + rows_per_block : n;
  const long step = blockDim.y;
  for (long r = r0 + threadIdx.y; r < r_end; r += step * UNROLL) {
    Packed<T, VEC> v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (r + u * step < r_end) v[u].load(x + (r + u * step) * d + c0);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (r + u * step >= r_end) break;
      // separate multiply and add, rounded as the plain version rounds
      float o[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) o[j] = __fadd_rn(__fmul_rn(v[u][j], wv[j]), bv[j]);
      rt::store_vec<T, VEC, true>(y + (r + u * step) * d + c0, o);
    }
  }
}

// grid (column tiles, row chunks); block (kLanes, warps). partial: fp32
// (row chunks, 2, d), written and read within the launch
template <typename TG, typename TX, int VEC, int UNROLL>
__global__ void __launch_bounds__(kLanes * kMaxWarps) affine_bwd_kernel(
    const TG* __restrict__ g, const TX* __restrict__ x, const void* w,
    int w_bf16, TG* __restrict__ dx, float* __restrict__ dw,
    float* __restrict__ db, float* __restrict__ partial, long n, int d,
    long rows_per_block) {
  __shared__ float red[kMaxWarps * 2 * kLanes * VEC];  // warps x 2 x a tile
  __shared__ bool last;
  const int tx = threadIdx.x, ty = threadIdx.y, warps = blockDim.y;
  const unsigned tile = blockIdx.x, chunk = blockIdx.y, chunks = gridDim.y;
  const int c0 = (tile * kLanes + tx) * VEC;
  const bool active = c0 < d;
  float sgx[VEC], sg[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) sgx[j] = sg[j] = 0.f;
  if (active) {
    rt::Raw<VEC> wr;
    wr.load(w, w_bf16, c0);
    float wv[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) wv[j] = wr.get(w_bf16, j);
    const long r0 = chunk * rows_per_block;
    const long r_end = r0 + rows_per_block < n ? r0 + rows_per_block : n;
    const long step = warps;
    for (long r = r0 + ty; r < r_end; r += step * UNROLL) {
      Packed<TG, VEC> gv[UNROLL];
      Packed<TX, VEC> xv[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (r + u * step < r_end) {
          const long off = (r + u * step) * d + c0;
          gv[u].load(g + off);
          xv[u].load(x + off);
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (r + u * step >= r_end) break;
        float dv[VEC];
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          dv[j] = __fmul_rn(gv[u][j], wv[j]);
          sgx[j] = __fmaf_rn(gv[u][j], xv[u][j], sgx[j]);
          sg[j] = __fadd_rn(sg[j], gv[u][j]);
        }
        rt::store_vec<TG, VEC, true>(dx + (r + u * step) * d + c0, dv);
      }
    }
  }
  block_sums<VEC>(red, sgx, sg, tx, ty, warps);
  const float* sum_gx = red + tx * VEC;
  const float* sum_g = red + kLanes * VEC + tx * VEC;
  if (chunks == 1) {  // the block's sums are the column sums
    if (ty == 0 && active) {
      rt::store_vec<float, VEC>(dw + c0, sum_gx);
      rt::store_vec<float, VEC>(db + c0, sum_g);
    }
    return;
  }
  // warp 0 writes the chunk's partials and alone waits for them to reach L2
  // before the arrival is counted; the other warps wait only for the count
  if (ty == 0) {
    if (active) {
      rt::store_vec<float, VEC>(partial + 2L * chunk * d + c0, sum_gx);
      rt::store_vec<float, VEC>(partial + (2L * chunk + 1) * d + c0, sum_g);
    }
    __threadfence();
  }
  __syncthreads();
  if (tx == 0 && ty == 0)
    // counts 0, 1, ..., chunks - 1; the last arrival sets it back to 0
    last = atomicInc(&g_tile_arrivals[tile], chunks - 1) == chunks - 1;
  __syncthreads();
  if (!last) return;
  // the tile's last block: chunk k on warp k % warps, in chunk order. Every
  // other block's partials reached L2 before its arrival was counted, and
  // they are read from L2 (as the CUDA guide's last-block sum reads them,
  // with no fence between the count and the reads)
#pragma unroll
  for (int j = 0; j < VEC; ++j) sgx[j] = sg[j] = 0.f;
  if (active) {
    // kBatch chunks' loads issued before any is added: one round trip to
    // L2 for up to 8 warps x kBatch chunks (32 at VEC 4)
    constexpr int kBatch = 16 / VEC;
    for (unsigned k0 = ty; k0 < chunks; k0 += warps * kBatch) {
      float p[kBatch][2][VEC];
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const unsigned k = k0 + i * warps;
        if (k < chunks) {
          load_partial<VEC>(partial + (2L * k) * d + c0, p[i][0]);
          load_partial<VEC>(partial + (2L * k + 1) * d + c0, p[i][1]);
        }
      }
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        if (k0 + i * warps >= chunks) break;
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          sgx[j] = __fadd_rn(sgx[j], p[i][0][j]);
          sg[j] = __fadd_rn(sg[j], p[i][1][j]);
        }
      }
    }
  }
  block_sums<VEC>(red, sgx, sg, tx, ty, warps);
  if (ty == 0 && active) {
    rt::store_vec<float, VEC>(dw + c0, sum_gx);
    rt::store_vec<float, VEC>(db + c0, sum_g);
  }
}

// The plan checked: `vec` 1 or `full` (16 bytes of the widest activation),
// d a multiple of it and, past 1, every activation pointer on the 16-byte
// grid; 1 to kMaxWarps warps and no more than a block's rows; an unroll
// with an instance; chunks of rows_per_block rows that cover the n rows
// once with none empty (n == 0: one chunk); and blocks = chunks x column
// tiles. False where it is not so.
bool plan_grid(long n, int d, int vec, int full, bool aligned, int warps,
               int unroll, long rows_per_block, int chunks, int blocks,
               dim3* grid) {
  if ((vec != 1 && vec != full) || d % vec != 0 || (vec > 1 && !aligned))
    return false;
  if (warps < 1 || warps > kMaxWarps || warps > rows_per_block) return false;
  if ((unroll != 2 && unroll != 4) || chunks < 1 || chunks > 65535) return false;
  if (n == 0 ? chunks != 1
             : chunks * rows_per_block < n || (chunks - 1) * rows_per_block >= n)
    return false;
  const long tiles = (d / vec + kLanes - 1) / kLanes;
  if (static_cast<long>(blocks) != tiles * chunks) return false;
  *grid = dim3(static_cast<unsigned>(tiles), static_cast<unsigned>(chunks));
  return true;
}

struct FwdArgs {
  const void* x;
  const void* w;
  int w_bf16;
  const void* b;
  int b_bf16;
  void* y;
  long n;
  int d;
  long rows;
};

template <typename T, int VEC>
cudaError_t launch_fwd(const FwdArgs& a, int unroll, dim3 grid, int warps,
                       cudaStream_t s) {
  auto kernel = unroll == 2 ? affine_fwd_kernel<T, VEC, 2>
                            : affine_fwd_kernel<T, VEC, 4>;
  kernel<<<grid, dim3(kLanes, warps), 0, s>>>(
      static_cast<const T*>(a.x), a.w, a.w_bf16, a.b, a.b_bf16,
      static_cast<T*>(a.y), a.n, a.d, a.rows);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_fwd_vec(const FwdArgs& a, int vec, int unroll, dim3 grid,
                           int warps, cudaStream_t s) {
  return vec == 1 ? launch_fwd<T, 1>(a, unroll, grid, warps, s)
                  : launch_fwd<T, 16 / sizeof(T)>(a, unroll, grid, warps, s);
}

struct BwdArgs {
  const void* g;
  const void* x;
  const void* w;
  int w_bf16;
  void* dx;
  float* dw;
  float* db;
  float* partial;
  long n;
  int d;
  long rows;
};

template <typename TG, typename TX, int VEC>
cudaError_t launch_bwd(const BwdArgs& a, int unroll, dim3 grid, int warps,
                       cudaStream_t s) {
  auto kernel = unroll == 2 ? affine_bwd_kernel<TG, TX, VEC, 2>
                            : affine_bwd_kernel<TG, TX, VEC, 4>;
  kernel<<<grid, dim3(kLanes, warps), 0, s>>>(
      static_cast<const TG*>(a.g), static_cast<const TX*>(a.x), a.w, a.w_bf16,
      static_cast<TG*>(a.dx), a.dw, a.db, a.partial, a.n, a.d, a.rows);
  return cudaGetLastError();
}

template <typename TG, typename TX>
cudaError_t launch_bwd_vec(const BwdArgs& a, int vec, int unroll, dim3 grid,
                           int warps, cudaStream_t s) {
  constexpr int kFull = 16 / (sizeof(TG) > sizeof(TX) ? sizeof(TG) : sizeof(TX));
  return vec == 1 ? launch_bwd<TG, TX, 1>(a, unroll, grid, warps, s)
                  : launch_bwd<TG, TX, kFull>(a, unroll, grid, warps, s);
}

}  // namespace

// vec, warps, unroll, rows_per_block, chunks, blocks: the plan
// (hadamard.affine_plan), refused unless it covers every (row, column) once
extern "C" int rt_hadamard_affine(const void* x, const void* w, int w_bf16,
                                  const void* b, int b_bf16, void* y, long n,
                                  int d, int dtype, int vec, int warps,
                                  int unroll, long rows_per_block, int chunks,
                                  int blocks, void* stream) {
  if (n == 0 || d == 0) return cudaSuccess;
  const int full = dtype == rt::BF16 ? 8 : 4;
  dim3 grid;
  const bool aligned = rt::aligned16(x) && rt::aligned16(y) &&
                       rt::aligned16(w) && rt::aligned16(b);
  if (!plan_grid(n, d, vec, full, aligned, warps, unroll, rows_per_block,
                 chunks, blocks, &grid))
    return cudaErrorInvalidValue;
  const FwdArgs a{x, w, w_bf16, b, b_bf16, y, n, d, rows_per_block};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == rt::BF16)
    return launch_fwd_vec<__nv_bfloat16>(a, vec, unroll, grid, warps, s);
  return launch_fwd_vec<float>(a, vec, unroll, grid, warps, s);
}

// partial: fp32 scratch of (chunks, 2, d); dw, db: fp32 (d,). The plan
// (hadamard.affine_bwd_plan) is refused unless it covers every (row,
// column) once, with no more column tiles than the counters hold. One
// launch; n == 0 gives zero sums.
extern "C" int rt_hadamard_affine_bwd(const void* g, int g_dtype, const void* x,
                                      int x_dtype, const void* w, int w_bf16,
                                      void* dx, void* dw, void* db,
                                      void* partial, long n, int d, int vec,
                                      int warps, int unroll,
                                      long rows_per_block, int chunks,
                                      int blocks, void* stream) {
  if (d == 0) return cudaSuccess;
  const bool gb = g_dtype == rt::BF16, xb = x_dtype == rt::BF16;
  const int full = gb && xb ? 8 : 4;
  const bool aligned = rt::aligned16(g) && rt::aligned16(x) &&
                       rt::aligned16(dx) && rt::aligned16(w) &&
                       rt::aligned16(partial);
  dim3 grid;
  if (!plan_grid(n, d, vec, full, aligned, warps, unroll, rows_per_block,
                 chunks, blocks, &grid) ||
      grid.x > static_cast<unsigned>(kMaxTiles))
    return cudaErrorInvalidValue;
  const BwdArgs a{g, x, w, w_bf16, dx, static_cast<float*>(dw),
                  static_cast<float*>(db), static_cast<float*>(partial), n, d,
                  rows_per_block};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (gb && xb)
    return launch_bwd_vec<__nv_bfloat16, __nv_bfloat16>(a, vec, unroll, grid,
                                                        warps, s);
  if (gb) return launch_bwd_vec<__nv_bfloat16, float>(a, vec, unroll, grid, warps, s);
  if (xb) return launch_bwd_vec<float, __nv_bfloat16>(a, vec, unroll, grid, warps, s);
  return launch_bwd_vec<float, float>(a, vec, unroll, grid, warps, s);
}
