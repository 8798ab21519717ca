// Hand-written SpMV/SpMM kernels for Hopper (sm_90a), bound with ctypes.
//
// Four kernels, each templated on float and double, each with one
// extern "C" launcher per type that launches on the caller's stream and
// returns cudaGetLastError(). The wrappers (repro_torch/kernels/*/kernel.py)
// check shapes, types and contiguity, allocate the outputs and raise on a
// nonzero return.
//
// Shared design points:
//   * The TPU kernels carried the output tile from one grid step to the next
//     and re-zeroed it when the row id changed. CUDA blocks run in no order,
//     so each slice or block row belongs to exactly one warp (per k-tile in
//     K2), which loops over that row's chunks or blocks and writes its
//     outputs once. A warp's partial sums meet in a fixed butterfly of
//     shuffles. The result is deterministic and needs no atomics and no
//     zero-fill.
//   * Every product is a scalar FMA in the accumulator type (the operand
//     type: float for f32, double for f64, so always >= f32). No tensor
//     core runs, so no TF32 rounding can enter.
//   * Offsets are 64-bit: T * C * W and T * bm * bn pass 2^31 on large
//     matrices.
//   * Sparse matrix-vector products move far more bytes than they compute
//     (2 flops per 8 stored bytes in f32), so all four are bounded by device
//     memory bandwidth (3.35 TB/s on an H100 SXM), not by arithmetic. All
//     four read the matrix with 16-byte loads, neighbouring lanes on
//     neighbouring addresses (512 contiguous bytes per warp load), streamed
//     past L1 (K2 copies them into shared memory with cp.async); K3 and K4
//     share one body; K2 also gathers each x row's k-tile as 16-byte
//     vectors kept in L1 (see its note). Each kernel has a scalar body for
//     the shapes and alignments its vector body does not take, chosen by
//     its launcher.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float fma_acc(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fma_acc(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

inline int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

inline bool aligned(const void* p, int64_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// One 16-byte load: 4 floats or 2 doubles, and as many int32 column ids.
template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  static constexpr int kN = 4;
  using V = float4;
  using I = int4;
};
template <>
struct Vec16<double> {
  static constexpr int kN = 2;
  using V = double2;
  using I = int2;
};

// Sum over aligned groups of `width` lanes (a power of two <= 32), every
// lane of the warp taking part; each lane of a group gets the group's sum.
template <typename T>
__device__ __forceinline__ T group_sum(T v, int width) {
  for (int off = width / 2; off > 0; off /= 2) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

constexpr int kWarps = 8;  // warps per thread block of K1, K3 and K4

// ---------------------------------------------------------------------------
// K1 sell_spmv — replaces the Pallas kernel sell_spmm (body _sell_kernel) in
// src/repro/kernels/sell_spmv/kernel.py.
//
// y[s, c, v] = sum over the chunks t of slice s and w < W of
//              vals[t, c, w] * x[cols[t, c, w], v]
// vals/cols [T, C, W]; slice_ptr [S + 1] (chunks of slice s are
// slice_ptr[s] .. slice_ptr[s + 1]); x [n, nv]; y [S, C, nv].
//
// Bound: bytes — each stored slot is read once (value + int32 column, 8
// bytes in f32) plus the x gathers, which stay in L2. One warp per slice:
// a chunk is C * W contiguous values and as many contiguous columns, and
// consecutive lanes read consecutive 16-byte vectors of values and as many
// columns (a 512-byte warp load of values per 32-lane step). With W a multiple of the vector width
// kN and g = W / kN a power of two <= 32, a vector lies inside one row and
// an aligned group of g lanes covers a row, so a step covers 32 / g rows.
// Each lane keeps one partial sum per step of its group of STEPS steps
// (rows r0 .. r0 + STEPS * 32 / g), adds its kN products in order, walks
// the slice's chunks, then each group of g lanes sums its row by shuffles
// and its first lane writes y. All STEPS loads of a chunk are issued
// before the gathers. grid.y walks the columns v of x.
template <typename T, int STEPS>
__global__ void __launch_bounds__(kWarps * 32)
    sell_spmv_kernel(const T* __restrict__ vals,
                     const int32_t* __restrict__ cols,
                     const int64_t* __restrict__ slice_ptr,
                     const T* __restrict__ x, T* __restrict__ y, int64_t S,
                     int64_t C, int64_t W, int64_t nv) {
  using V = typename Vec16<T>::V;
  using I = typename Vec16<T>::I;
  constexpr int kN = Vec16<T>::kN;
  const int64_t s = (int64_t)blockIdx.x * kWarps + threadIdx.x / 32;
  if (s >= S) return;
  const int lane = threadIdx.x % 32;
  const int g = (int)(W / kN);  // lanes per row
  const int rows = 32 / g;      // rows per step
  const int r_lane = lane / g;
  const int64_t w_lane = (int64_t)(lane % g) * kN;
  const int64_t t0 = slice_ptr[s], t1 = slice_ptr[s + 1];
  for (int64_t v = blockIdx.y; v < nv; v += gridDim.y) {
    for (int64_t r0 = 0; r0 < C; r0 += STEPS * rows) {
      T acc[STEPS];
#pragma unroll
      for (int i = 0; i < STEPS; ++i) acc[i] = 0;
      for (int64_t t = t0; t < t1; ++t) {
        V a[STEPS];
        I c[STEPS];
#pragma unroll
        for (int i = 0; i < STEPS; ++i) {
          const int64_t r = r0 + i * rows + r_lane;
          if (r < C) {
            const int64_t o = (t * C + r) * W + w_lane;
            a[i] = __ldcs(reinterpret_cast<const V*>(vals + o));
            c[i] = __ldcs(reinterpret_cast<const I*>(cols + o));
          }
        }
#pragma unroll
        for (int i = 0; i < STEPS; ++i) {
          if (r0 + i * rows + r_lane < C) {
            const T* av = reinterpret_cast<const T*>(&a[i]);
            const int* ci = reinterpret_cast<const int*>(&c[i]);
#pragma unroll
            for (int e = 0; e < kN; ++e) {
              acc[i] = fma_acc(av[e], __ldg(x + (int64_t)ci[e] * nv + v),
                               acc[i]);
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < STEPS; ++i) {
        const T sum = group_sum(acc[i], g);
        const int64_t r = r0 + i * rows + r_lane;
        if (r < C && lane % g == 0) y[(s * C + r) * nv + v] = sum;
      }
    }
  }
}

// K1 for every other shape (W not a multiple of kN, W / kN not a power of
// two <= 32, or a base not aligned for 16-byte loads): one warp per slice,
// a row at a time, lanes striding over W with scalar loads, then a sum over
// the warp.
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
    sell_spmv_rows_kernel(const T* __restrict__ vals,
                          const int32_t* __restrict__ cols,
                          const int64_t* __restrict__ slice_ptr,
                          const T* __restrict__ x, T* __restrict__ y,
                          int64_t S, int64_t C, int64_t W, int64_t nv) {
  const int64_t s = (int64_t)blockIdx.x * kWarps + threadIdx.x / 32;
  if (s >= S) return;
  const int lane = threadIdx.x % 32;
  const int64_t t0 = slice_ptr[s], t1 = slice_ptr[s + 1];
  for (int64_t v = blockIdx.y; v < nv; v += gridDim.y) {
    for (int64_t r = 0; r < C; ++r) {
      T acc = 0;
      for (int64_t t = t0; t < t1; ++t) {
        const int64_t base = (t * C + r) * W;
        for (int64_t w = lane; w < W; w += 32) {
          acc = fma_acc(vals[base + w], x[(int64_t)cols[base + w] * nv + v],
                        acc);
        }
      }
      acc = group_sum(acc, 32);
      if (lane == 0) y[(s * C + r) * nv + v] = acc;
    }
  }
}

// ---------------------------------------------------------------------------
// K2 sell_spmm — replaces the Pallas kernel sell_spmm_ktiled (body
// _sell_spmm_kernel) in src/repro/kernels/sell_spmm/kernel.py.
//
// y[s, c, j] = sum over the chunks t of slice s and w < W of
//              vals[t, c, w] * x[cols[t, c, w], j]
// as K1, with x [n, k] and y [S, C, k].
//
// Bound: bytes — each stored slot is read once per k-tile of KT columns
// (value + int32 column, 8 bytes in f32), x and y once. Each slot also
// gathers its x row's k-tile, at k = 8 in f32 a 32-byte sector, so a slot
// costs 8 bytes of matrix and 32 bytes of x: 1.07 GB of L2-to-SM traffic
// per call at the Fig. 1 shape, 4x the matrix. x (33.5 MB there) stays in
// L2, and on a banded order neighbouring rows gather the same x rows, so
// the gathers are laid out to touch few lines per warp load.
//
// Vector body (sell_spmm_kernel<T, KT, RPL>): one warp per slice and per
// k-tile (grid.y walks the k-tiles). The warp copies each sub-chunk of the
// slice (C rows x Wb slots, C * Wb <= 256) into shared memory with 16-byte
// cp.async loads that bypass L1 (consecutive lanes on consecutive
// addresses: 512 contiguous bytes per warp load at C = 8, W = 32), rows
// padded by 16 bytes. It then walks the slots column by column, z = w * C +
// r: lane group i = lane / NV (NV = KT / kN lanes, one 16-byte x vector
// each) takes slots z = i + NS * n (NS = 32 / NV), so one warp load gathers
// NS slots of C neighbouring rows at neighbouring w. On a banded order
// their x rows lie close together, so the load touches few lines (a lane
// that gathered one row's slots spread its warp load over the band). B = 4
// slots per lane are in flight at a time. A lane adds kN products per slot
// into acc[RPL][kN]: the rows i + NS * m (m < RPL = C / NS) when C > NS;
// the row i % C when C <= NS, whose NS / C lanes then sum by shuffles after
// the slice's last chunk. Each row's k-tile is stored as 16-byte vectors.
// What bounds a warp that walks one slice is its instruction count, not its
// loads, so every index is a shift or a mask of a power of two and none a
// division (PERF.md has the measurements; pipelining the next slice's
// chunk, or staging a window of x rows in shared memory, gained nothing).
//
// The body takes C a power of two <= 32, W a power of two >= 4, k a
// multiple of kN, and 16-byte-aligned values, columns, x and y; a k-tile
// past k loads and stores nothing.
//
// Scalar body (sell_spmm_rows_kernel) for every other shape: one warp per
// slice and k-tile, a row at a time; lane = wl * kt + jc takes column
// j0 + jc and the slots w = wl, wl + 32 / kt, ... of the row, with scalar
// loads (the value and column broadcast to the kt lanes of a w group, x
// coalesced over the columns), then a sum over the 32 / kt w groups by
// shuffles. The launcher chooses between the bodies, as launch_sell_spmv
// does for K1.

constexpr int kStage = 256;  // slots of one staged sub-chunk (C x Wb)

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n"
               "cp.async.wait_group 0;\n" ::
                   : "memory");
}

// Slots per row of a staged sub-chunk, and the bytes one warp stages (the
// values' rows padded by one 16-byte vector, the columns' rows by four
// ints); the launcher sizes the dynamic shared memory with the same sums.
__host__ __device__ inline int64_t spmm_stage_width(int64_t C, int64_t W) {
  return W < kStage / C ? W : kStage / C;
}
template <typename T>
__host__ __device__ inline int64_t spmm_stage_bytes(int64_t C, int64_t W) {
  const int64_t wb = spmm_stage_width(C, W);
  return C * ((wb + 16 / (int64_t)sizeof(T)) * (int64_t)sizeof(T) +
              (wb + 4) * 4);
}

template <typename T, int KT, int RPL, int B = (RPL > 4 ? RPL : 4)>
__global__ void __launch_bounds__(kWarps * 32)
    sell_spmm_kernel(const T* __restrict__ vals,
                     const int32_t* __restrict__ cols,
                     const int64_t* __restrict__ slice_ptr,
                     const T* __restrict__ x, T* __restrict__ y, int64_t S,
                     int64_t C, int64_t W, int64_t k) {
  using V = typename Vec16<T>::V;
  constexpr int kN = Vec16<T>::kN;
  constexpr int NV = KT / kN;  // lanes per slot, one x vector each
  constexpr int NS = 32 / NV;  // slots per warp load
  constexpr int kVP = 16 / (int)sizeof(T);
  static_assert(B % RPL == 0, "a batch covers whole rounds of rows");
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t s = (int64_t)blockIdx.x * kWarps + warp;
  if (s >= S) return;
  const int Ci = (int)C, lc = __ffs(Ci) - 1;
  const int Wb = (int)spmm_stage_width(C, W), lw = __ffs(Wb) - 1;
  const int pv = Wb + kVP, pc = Wb + 4;  // row pitches in shared memory
  T* sv = reinterpret_cast<T*>(smem + warp * spmm_stage_bytes<T>(C, W));
  int* sc = reinterpret_cast<int*>(sv + Ci * pv);
  // staging: the values as C * Wb / kN vectors, the columns as C * Wb / 4
  const int lvv = lw - __ffs(kN) + 1, nvv = Ci << lvv;
  const int lvc = lw - 2, nvc = Ci << lvc;
  // gathering: lane group i, vector v of each slot's x tile; slot n of the
  // lane is row r0 + NS * (n % RPL) at w = wl + wstep * (n / RPL)
  const int i = lane / NV, v = lane % NV;
  const int r0 = RPL > 1 ? i : (i & (Ci - 1));
  const int wl = RPL > 1 ? 0 : i >> lc;
  const int wstep = RPL > 1 ? 1 : NS >> lc;
  for (int64_t j0 = (int64_t)blockIdx.y * KT; j0 < k;
       j0 += (int64_t)gridDim.y * KT) {
    const bool on = j0 + v * kN < k;
    const T* xv = x + j0 + v * kN;
    T acc[RPL][kN];
#pragma unroll
    for (int m = 0; m < RPL; ++m) {
#pragma unroll
      for (int e = 0; e < kN; ++e) acc[m][e] = 0;
    }
    const int64_t t1 = slice_ptr[s + 1];
    for (int64_t t = slice_ptr[s]; t < t1; ++t) {
      for (int64_t wb = 0; wb < W; wb += Wb) {
        const int64_t base = t * C * W + wb;
        __syncwarp();  // the previous sub-chunk's reads are done
        for (int u = lane; u < nvv; u += 32) {
          const int r = u >> lvv, w = (u & ((1 << lvv) - 1)) * kN;
          cp_async16(sv + r * pv + w, vals + base + (int64_t)r * W + w);
        }
        for (int u = lane; u < nvc; u += 32) {
          const int r = u >> lvc, w = (u & ((1 << lvc) - 1)) * 4;
          cp_async16(sc + r * pc + w, cols + base + (int64_t)r * W + w);
        }
        cp_async_wait_all();
        __syncwarp();
        for (int n0 = 0; wstep * (n0 / RPL) < Wb; n0 += B) {
          T a[B];
          V xt[B];
#pragma unroll
          for (int b = 0; b < B; ++b) {
            const int w = wl + wstep * ((n0 + b) / RPL);
            const int r = r0 + NS * (b % RPL);
            if (w < Wb && on) {
              a[b] = sv[r * pv + w];
              xt[b] = __ldg(reinterpret_cast<const V*>(
                  xv + (int64_t)sc[r * pc + w] * k));
            }
          }
#pragma unroll
          for (int b = 0; b < B; ++b) {
            if (wl + wstep * ((n0 + b) / RPL) < Wb && on) {
              const T* xe = reinterpret_cast<const T*>(&xt[b]);
#pragma unroll
              for (int e = 0; e < kN; ++e) {
                acc[b % RPL][e] = fma_acc(a[b], xe[e], acc[b % RPL][e]);
              }
            }
          }
        }
      }
    }
    // when C < NS the lane groups i, i + C, ... share row i % C
    for (int off = Ci * NV; off < 32; off *= 2) {
#pragma unroll
      for (int e = 0; e < kN; ++e) {
        acc[0][e] += __shfl_xor_sync(0xffffffffu, acc[0][e], off);
      }
    }
    if (on && (RPL > 1 || i < Ci)) {
#pragma unroll
      for (int m = 0; m < RPL; ++m) {
        V out;
        T* oe = reinterpret_cast<T*>(&out);
#pragma unroll
        for (int e = 0; e < kN; ++e) oe[e] = acc[m][e];
        *reinterpret_cast<V*>(y + (s * C + r0 + NS * m) * k + j0 + v * kN) =
            out;
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
    sell_spmm_rows_kernel(const T* __restrict__ vals,
                          const int32_t* __restrict__ cols,
                          const int64_t* __restrict__ slice_ptr,
                          const T* __restrict__ x, T* __restrict__ y,
                          int64_t S, int64_t C, int64_t W, int64_t k,
                          int kt) {
  const int64_t s = (int64_t)blockIdx.x * kWarps + threadIdx.x / 32;
  if (s >= S) return;
  const int lane = threadIdx.x % 32;
  const int jc = lane % kt, wl = lane / kt, nw = 32 / kt;
  const int64_t t0 = slice_ptr[s], t1 = slice_ptr[s + 1];
  for (int64_t j0 = (int64_t)blockIdx.y * kt; j0 < k;
       j0 += (int64_t)gridDim.y * kt) {
    const int64_t j = j0 + jc;
    for (int64_t r = 0; r < C; ++r) {
      T acc = 0;
      if (j < k) {
        for (int64_t t = t0; t < t1; ++t) {
          const int64_t base = (t * C + r) * W;
          for (int64_t w = wl; w < W; w += nw) {
            acc = fma_acc(vals[base + w],
                          x[(int64_t)cols[base + w] * k + j], acc);
          }
        }
      }
      for (int off = kt; off < 32; off *= 2) {
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      }
      if (wl == 0 && j < k) y[(s * C + r) * k + j] = acc;
    }
  }
}

// ---------------------------------------------------------------------------
// K3 bcsr_spmv and K4 bell_spmv share their bodies: both walk the stored
// blocks g0 .. g1 of one block row r, each a dense [bm, bn] block at
// blocks + g * bm * bn whose block column is block_cols[g], and write
// y[r, :, :]. K4 (Block-ELL) gives every block row K slots, g = r * K + kk;
// K3 (BCSR) reads g0 and g1 from its row pointer.
//
// Bound: bytes (every stored block is read once; x2d, 4 MB at the Fig. 1
// shape, stays in L2). One warp per block row, kWarps block rows per
// thread block. For each block the warp reads the block column once (one
// broadcast load) and each lane loads its 16-byte share of the x segment
// x2d[col, :, 0] once; then, for each of the block's bm <= R rows, one
// 16-byte load per lane of that row (a 512-byte coalesced warp load in f32
// at bn = 128), all R issued before their FMAs and streamed past L1. Each
// lane keeps R partial sums; after the last block each row is summed over
// the warp and lane i writes y[r, i, 0]. This body takes nv = 1, bm <= 16
// and bn a multiple of kN with aligned bases (lanes stride by 32 vectors
// when bn > 32 * kN and idle when bn < 32 * kN). A block row with no block
// (g0 == g1) writes zeros. On power-law matrices a warp per block row is
// load-imbalanced: a long block row holds its warp while the others idle.
template <typename T, int R>
__device__ __forceinline__ void block_row_vec(const T* __restrict__ blocks,
                                              const int32_t* __restrict__ block_cols,
                                              const T* __restrict__ x,
                                              T* __restrict__ y, int64_t r,
                                              int64_t g0, int64_t g1,
                                              int64_t bm, int64_t bn) {
  using V = typename Vec16<T>::V;
  constexpr int kN = Vec16<T>::kN;
  const int lane = threadIdx.x % 32;
  T acc[R];
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = 0;
  for (int64_t g = g0; g < g1; ++g) {
    const T* blk = blocks + g * bm * bn;
    const T* xs = x + (int64_t)block_cols[g] * bn;
    for (int64_t j = (int64_t)lane * kN; j < bn; j += 32 * kN) {
      const V xv = __ldg(reinterpret_cast<const V*>(xs + j));
      V a[R];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        if (i < bm) a[i] = __ldcs(reinterpret_cast<const V*>(blk + i * bn + j));
      }
      const T* xe = reinterpret_cast<const T*>(&xv);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        if (i < bm) {
          const T* ae = reinterpret_cast<const T*>(&a[i]);
#pragma unroll
          for (int e = 0; e < kN; ++e) acc[i] = fma_acc(ae[e], xe[e], acc[i]);
        }
      }
    }
  }
  T out = 0;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const T sum = group_sum(acc[i], 32);
    if (lane == i) out = sum;
  }
  if (lane < bm) y[r * bm + lane] = out;
}

// The body for every other shape (nv > 1, bm > 16, bn not a multiple of
// kN, or a base not aligned for 16-byte loads): one warp per block row, one
// row at a time, lanes striding over bn with scalar loads, then a sum over
// the warp; grid.y walks the columns v.
template <typename T>
__device__ __forceinline__ void block_row_scalar(const T* __restrict__ blocks,
                                                 const int32_t* __restrict__ block_cols,
                                                 const T* __restrict__ x,
                                                 T* __restrict__ y, int64_t r,
                                                 int64_t g0, int64_t g1,
                                                 int64_t bm, int64_t bn,
                                                 int64_t nv) {
  const int lane = threadIdx.x % 32;
  for (int64_t v = blockIdx.y; v < nv; v += gridDim.y) {
    for (int64_t i = 0; i < bm; ++i) {
      T acc = 0;
      for (int64_t g = g0; g < g1; ++g) {
        const T* a = blocks + (g * bm + i) * bn;
        const T* xb = x + (int64_t)block_cols[g] * bn * nv + v;
        for (int64_t jj = lane; jj < bn; jj += 32) {
          acc = fma_acc(a[jj], xb[jj * nv], acc);
        }
      }
      acc = group_sum(acc, 32);
      if (lane == 0) y[(r * bm + i) * nv + v] = acc;
    }
  }
}

// K3 bcsr_spmv — replaces the Pallas kernel bcsr_spmm (body _bcsr_kernel) in
// src/repro/kernels/bcsr_spmv/kernel.py.
//
// y[r, i, v] = sum over blocks g of block row r (block_rowptr[r] ..
// block_rowptr[r + 1], int64) and jj < bn of
//              blocks[g, i, jj] * x2d[block_cols[g], jj, v]
// blocks [Tb, bm, bn]; block_cols [Tb] int32; x2d [ncb, bn, nv];
// y [nbr, bm, nv]. The bodies are block_row_vec and block_row_scalar.
template <typename T, int R>
__global__ void __launch_bounds__(kWarps * 32)
    bcsr_spmv_kernel(const T* __restrict__ blocks,
                     const int32_t* __restrict__ block_cols,
                     const int64_t* __restrict__ block_rowptr,
                     const T* __restrict__ x, T* __restrict__ y, int64_t nbr,
                     int64_t bm, int64_t bn) {
  const int64_t r = (int64_t)blockIdx.x * kWarps + threadIdx.x / 32;
  if (r >= nbr) return;
  block_row_vec<T, R>(blocks, block_cols, x, y, r, block_rowptr[r],
                      block_rowptr[r + 1], bm, bn);
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
    bcsr_spmv_rows_kernel(const T* __restrict__ blocks,
                          const int32_t* __restrict__ block_cols,
                          const int64_t* __restrict__ block_rowptr,
                          const T* __restrict__ x, T* __restrict__ y,
                          int64_t nbr, int64_t bm, int64_t bn, int64_t nv) {
  const int64_t r = (int64_t)blockIdx.x * kWarps + threadIdx.x / 32;
  if (r >= nbr) return;
  block_row_scalar<T>(blocks, block_cols, x, y, r, block_rowptr[r],
                      block_rowptr[r + 1], bm, bn, nv);
}

// ---------------------------------------------------------------------------
// K4 bell_spmv — replaces the Pallas kernel bell_spmm (body _bell_kernel) in
// src/repro/kernels/bell_spmv/kernel.py.
//
// y[r, i, v] = sum over kk < K and jj < bn of
//              blocks[r, kk, i, jj] * x2d[block_cols[r, kk], jj, v]
// blocks [nbr, K, bm, bn] (padding blocks are zero, and read like the
// rest); block_cols [nbr, K]. The bodies are block_row_vec and
// block_row_scalar over g = r * K .. r * K + K.
template <typename T, int R>
__global__ void __launch_bounds__(kWarps * 32)
    bell_spmv_kernel(const T* __restrict__ blocks,
                     const int32_t* __restrict__ block_cols,
                     const T* __restrict__ x, T* __restrict__ y, int64_t nbr,
                     int64_t K, int64_t bm, int64_t bn) {
  const int64_t r = (int64_t)blockIdx.x * kWarps + threadIdx.x / 32;
  if (r >= nbr) return;
  block_row_vec<T, R>(blocks, block_cols, x, y, r, r * K, r * K + K, bm, bn);
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
    bell_spmv_rows_kernel(const T* __restrict__ blocks,
                          const int32_t* __restrict__ block_cols,
                          const T* __restrict__ x, T* __restrict__ y,
                          int64_t nbr, int64_t K, int64_t bm, int64_t bn,
                          int64_t nv) {
  const int64_t r = (int64_t)blockIdx.x * kWarps + threadIdx.x / 32;
  if (r >= nbr) return;
  block_row_scalar<T>(blocks, block_cols, x, y, r, r * K, r * K + K, bm, bn,
                      nv);
}

// thread blocks of kWarps warps, one warp per item; grid.y walks nv
inline dim3 warp_grid(int64_t items, int64_t nv) {
  return dim3((unsigned)ceil_div(items, kWarps),
              (unsigned)(nv < 65535 ? nv : 65535));
}

template <typename T>
int launch_sell_spmv(const void* vals, const void* cols, const void* ptr,
                     const void* x, void* y, int64_t S, int64_t C, int64_t W,
                     int64_t nv, void* stream) {
  if (S * C * nv == 0) return 0;
  constexpr int kN = Vec16<T>::kN;
  const int64_t g = W / kN;
  const dim3 grid = warp_grid(S, nv);
  const cudaStream_t st = (cudaStream_t)stream;
  if (W % kN != 0 || g > 32 || (g & (g - 1)) != 0 || !aligned(vals, 16) ||
      !aligned(cols, 4 * kN)) {
    sell_spmv_rows_kernel<T><<<grid, kWarps * 32, 0, st>>>(
        (const T*)vals, (const int32_t*)cols, (const int64_t*)ptr,
        (const T*)x, (T*)y, S, C, W, nv);
    return (int)cudaGetLastError();
  }
  const int64_t steps = ceil_div(C, 32 / g);
  auto kernel = steps <= 1   ? sell_spmv_kernel<T, 1>
                : steps <= 2 ? sell_spmv_kernel<T, 2>
                : steps <= 4 ? sell_spmv_kernel<T, 4>
                             : sell_spmv_kernel<T, 8>;
  kernel<<<grid, kWarps * 32, 0, st>>>((const T*)vals, (const int32_t*)cols,
                                       (const int64_t*)ptr, (const T*)x,
                                       (T*)y, S, C, W, nv);
  return (int)cudaGetLastError();
}

template <typename T>
using SpmmBody = void (*)(const T*, const int32_t*, const int64_t*, const T*,
                          T*, int64_t, int64_t, int64_t, int64_t);

// K2's vector body for KT columns and RPL = rpl rows per lane (a power of
// two <= KT / kN)
template <typename T, int KT, int RPL = 1>
SpmmBody<T> sell_spmm_body(int64_t rpl) {
  if constexpr (2 * RPL <= KT / Vec16<T>::kN) {
    if (rpl > RPL) return sell_spmm_body<T, KT, 2 * RPL>(rpl);
  }
  return sell_spmm_kernel<T, KT, RPL>;
}

inline bool pow2(int64_t v) { return v > 0 && (v & (v - 1)) == 0; }

template <typename T>
int launch_sell_spmm(const void* vals, const void* cols, const void* ptr,
                     const void* x, void* y, int64_t S, int64_t C, int64_t W,
                     int64_t k, int64_t kt, void* stream) {
  if (S * C * k == 0) return 0;
  if (kt != 8 && kt != 16 && kt != 32) return (int)cudaErrorInvalidValue;
  constexpr int kN = Vec16<T>::kN;
  const dim3 grid = warp_grid(S, ceil_div(k, kt));
  const cudaStream_t st = (cudaStream_t)stream;
  if (!pow2(C) || C > 32 || !pow2(W) || W < 4 || k % kN != 0 ||
      !aligned(vals, 16) || !aligned(cols, 16) || !aligned(x, 16) ||
      !aligned(y, 16)) {
    sell_spmm_rows_kernel<T><<<grid, kWarps * 32, 0, st>>>(
        (const T*)vals, (const int32_t*)cols, (const int64_t*)ptr,
        (const T*)x, (T*)y, S, C, W, k, (int)kt);
    return (int)cudaGetLastError();
  }
  const int64_t ns = 32 / (kt / kN);  // slots per warp load
  const int64_t rpl = C > ns ? C / ns : 1;
  auto kernel = kt == 8    ? sell_spmm_body<T, 8>(rpl)
                : kt == 16 ? sell_spmm_body<T, 16>(rpl)
                           : sell_spmm_body<T, 32>(rpl);
  // at most 32 rows of 256 / C slots: 4 KB a warp, 32 KB a block
  const size_t smem = (size_t)(kWarps * spmm_stage_bytes<T>(C, W));
  kernel<<<grid, kWarps * 32, smem, st>>>(
      (const T*)vals, (const int32_t*)cols, (const int64_t*)ptr, (const T*)x,
      (T*)y, S, C, W, k);
  return (int)cudaGetLastError();
}

// true when the block-format bodies must take the scalar path
template <typename T>
bool block_rows_scalar(const void* blocks, const void* x, int64_t bm,
                       int64_t bn, int64_t nv) {
  return nv != 1 || bm > 16 || bn % Vec16<T>::kN != 0 ||
         !aligned(blocks, 16) || !aligned(x, 16);
}

template <typename T>
int launch_bcsr_spmv(const void* blocks, const void* cols, const void* rowptr,
                     const void* x, void* y, int64_t nbr, int64_t bm,
                     int64_t bn, int64_t nv, void* stream) {
  if (nbr * bm * nv == 0) return 0;
  const dim3 grid = warp_grid(nbr, nv);
  const cudaStream_t st = (cudaStream_t)stream;
  if (block_rows_scalar<T>(blocks, x, bm, bn, nv)) {
    bcsr_spmv_rows_kernel<T><<<grid, kWarps * 32, 0, st>>>(
        (const T*)blocks, (const int32_t*)cols, (const int64_t*)rowptr,
        (const T*)x, (T*)y, nbr, bm, bn, nv);
    return (int)cudaGetLastError();
  }
  auto kernel = bm <= 4   ? bcsr_spmv_kernel<T, 4>
                : bm <= 8 ? bcsr_spmv_kernel<T, 8>
                          : bcsr_spmv_kernel<T, 16>;
  kernel<<<grid, kWarps * 32, 0, st>>>((const T*)blocks, (const int32_t*)cols,
                                       (const int64_t*)rowptr, (const T*)x,
                                       (T*)y, nbr, bm, bn);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bell_spmv(const void* blocks, const void* cols, const void* x,
                     void* y, int64_t nbr, int64_t K, int64_t bm, int64_t bn,
                     int64_t nv, void* stream) {
  if (nbr * bm * nv == 0) return 0;
  const dim3 grid = warp_grid(nbr, nv);
  const cudaStream_t st = (cudaStream_t)stream;
  if (block_rows_scalar<T>(blocks, x, bm, bn, nv)) {
    bell_spmv_rows_kernel<T><<<grid, kWarps * 32, 0, st>>>(
        (const T*)blocks, (const int32_t*)cols, (const T*)x, (T*)y, nbr, K,
        bm, bn, nv);
    return (int)cudaGetLastError();
  }
  auto kernel = bm <= 4   ? bell_spmv_kernel<T, 4>
                : bm <= 8 ? bell_spmv_kernel<T, 8>
                          : bell_spmv_kernel<T, 16>;
  kernel<<<grid, kWarps * 32, 0, st>>>((const T*)blocks, (const int32_t*)cols,
                                       (const T*)x, (T*)y, nbr, K, bm, bn);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int sell_spmv_f32(const void* vals, const void* cols,
                             const void* ptr, const void* x, void* y,
                             long long S, long long C, long long W,
                             long long nv, void* stream) {
  return launch_sell_spmv<float>(vals, cols, ptr, x, y, S, C, W, nv, stream);
}
extern "C" int sell_spmv_f64(const void* vals, const void* cols,
                             const void* ptr, const void* x, void* y,
                             long long S, long long C, long long W,
                             long long nv, void* stream) {
  return launch_sell_spmv<double>(vals, cols, ptr, x, y, S, C, W, nv, stream);
}
extern "C" int bcsr_spmv_f32(const void* blocks, const void* cols,
                             const void* rowptr, const void* x, void* y,
                             long long nbr, long long bm, long long bn,
                             long long nv, void* stream) {
  return launch_bcsr_spmv<float>(blocks, cols, rowptr, x, y, nbr, bm, bn, nv,
                                 stream);
}
extern "C" int bcsr_spmv_f64(const void* blocks, const void* cols,
                             const void* rowptr, const void* x, void* y,
                             long long nbr, long long bm, long long bn,
                             long long nv, void* stream) {
  return launch_bcsr_spmv<double>(blocks, cols, rowptr, x, y, nbr, bm, bn, nv,
                                  stream);
}
extern "C" int sell_spmm_f32(const void* vals, const void* cols,
                             const void* ptr, const void* x, void* y,
                             long long S, long long C, long long W,
                             long long k, long long kt, void* stream) {
  return launch_sell_spmm<float>(vals, cols, ptr, x, y, S, C, W, k, kt,
                                 stream);
}
extern "C" int sell_spmm_f64(const void* vals, const void* cols,
                             const void* ptr, const void* x, void* y,
                             long long S, long long C, long long W,
                             long long k, long long kt, void* stream) {
  return launch_sell_spmm<double>(vals, cols, ptr, x, y, S, C, W, k, kt,
                                  stream);
}
extern "C" int bell_spmv_f32(const void* blocks, const void* cols,
                             const void* x, void* y, long long nbr,
                             long long K, long long bm, long long bn,
                             long long nv, void* stream) {
  return launch_bell_spmv<float>(blocks, cols, x, y, nbr, K, bm, bn, nv,
                                 stream);
}
extern "C" int bell_spmv_f64(const void* blocks, const void* cols,
                             const void* x, void* y, long long nbr,
                             long long K, long long bm, long long bn,
                             long long nv, void* stream) {
  return launch_bell_spmv<double>(blocks, cols, x, y, nbr, K, bm, bn, nv,
                                  stream);
}

extern "C" const char* spmv_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
