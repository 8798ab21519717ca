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
//     so each kernel instead gives every output element to exactly one
//     thread, which loops over that row's chunks or blocks and writes once.
//     The result is deterministic and needs no atomics and no zero-fill.
//   * Every product is a scalar FMA in the accumulator type (the operand
//     type: float for f32, double for f64, so always >= f32). No tensor
//     core runs, so no TF32 rounding can enter.
//   * Offsets are 64-bit: T * C * W and T * bm * bn pass 2^31 on large
//     matrices.
//   * Sparse matrix-vector products move far more bytes than they compute
//     (2 flops per 8 stored bytes in f32), so all four are bounded by device
//     memory bandwidth (3.35 TB/s on an H100 SXM), not by arithmetic. None of
//     them coalesces its matrix loads yet (see each note); shared-memory
//     staging of x, TMA and wgmma are later work.

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

// ---------------------------------------------------------------------------
// K1 sell_spmv and K2 sell_spmm — replace the Pallas kernels sell_spmm (body
// _sell_kernel) in src/repro/kernels/sell_spmv/kernel.py and
// sell_spmm_ktiled (body _sell_spmm_kernel) in
// src/repro/kernels/sell_spmm/kernel.py. One body serves both: K1 is K2
// with a k-tile of one column, and each keeps its own launcher and count.
//
// y[s, c, j] = sum over the chunks t of slice s and w < W of
//              vals[t, c, w] * x[cols[t, c, w], j]
// vals/cols [T, C, W]; slice_ptr [S + 1] (chunks of slice s are
// slice_ptr[s] .. slice_ptr[s + 1]); x [n, k]; y [S, C, k].
//
// One thread per (slice row, column j). A thread block is (kt columns) x
// (256 / kt rows); grid.x walks row groups, grid.y walks k-tiles of width
// kt. Bound: bytes — each stored slot is read once per k-tile (value +
// column, 8 bytes in f32) plus the x gathers.
//
// K1 (kt = 1) is known to be slow: in the [T, C, W] layout neighbouring
// threads (rows c, c + 1) read addresses W elements apart, so a warp's loads
// are not coalesced and lean on L1 to reuse each line across the w loop.
// Transposing the chunk to [T, W, C] (or giving a warp a chunk) is the first
// target of a later PR. In K2 the kt threads of one row read the same value
// and column (one broadcast load) and neighbouring x elements
// x[col, j .. j + kt), so the x gather is coalesced across the k-tile and
// the matrix is streamed ceil(k / kt) times instead of k times; its matrix
// loads are as uncoalesced across rows as K1's.
template <typename T>
__global__ void sell_spmm_kernel(const T* __restrict__ vals,
                                 const int32_t* __restrict__ cols,
                                 const int64_t* __restrict__ slice_ptr,
                                 const T* __restrict__ x, T* __restrict__ y,
                                 int64_t rows, int64_t C, int64_t W,
                                 int64_t k) {
  int64_t j = (int64_t)blockIdx.y * blockDim.x + threadIdx.x;
  int64_t row = (int64_t)blockIdx.x * blockDim.y + threadIdx.y;
  if (row >= rows || j >= k) return;
  int64_t s = row / C;
  int64_t c = row - s * C;
  T acc = 0;
  for (int64_t t = slice_ptr[s]; t < slice_ptr[s + 1]; ++t) {
    int64_t base = (t * C + c) * W;
    for (int64_t w = 0; w < W; ++w) {
      acc = fma_acc(vals[base + w], x[(int64_t)cols[base + w] * k + j], acc);
    }
  }
  y[row * k + j] = acc;  // flat index of y[s, c, j]
}

// ---------------------------------------------------------------------------
// K3 bcsr_spmv — replaces the Pallas kernel bcsr_spmm (body _bcsr_kernel) in
// src/repro/kernels/bcsr_spmv/kernel.py.
//
// y[r, i, v] = sum over blocks g of block row r (block_rowptr[r] ..
// block_rowptr[r + 1]) and jj < bn of blocks[g, i, jj] * x2d[cols[g], jj, v]
// blocks [Tb, bm, bn]; x2d [ncb, bn, nv]; y [nbr, bm, nv].
//
// One thread block per block row; its threads run over (bm x nv) and each
// loops over the row's blocks and over bn with scalar FMAs. Bound: bytes
// (each dense block read once: bm * bn values per block). With bm = 8 and
// nv = 1 only 8 threads of a warp work, and a block's rows are bn values
// apart, so loads are not coalesced; a warp per block, or wgmma on bm = 64
// tiles, is later work.
template <typename T>
__global__ void bcsr_spmv_kernel(const T* __restrict__ blocks,
                                 const int32_t* __restrict__ block_cols,
                                 const int64_t* __restrict__ block_rowptr,
                                 const T* __restrict__ x, T* __restrict__ y,
                                 int64_t bm, int64_t bn, int64_t nv) {
  int64_t r = blockIdx.x;
  int64_t g0 = block_rowptr[r];
  int64_t g1 = block_rowptr[r + 1];
  for (int64_t e = threadIdx.x; e < bm * nv; e += blockDim.x) {
    int64_t i = e / nv;
    int64_t v = e - i * nv;
    T acc = 0;
    for (int64_t g = g0; g < g1; ++g) {
      const T* a = blocks + (g * bm + i) * bn;
      const T* xb = x + (int64_t)block_cols[g] * bn * nv + v;
      for (int64_t jj = 0; jj < bn; ++jj) {
        acc = fma_acc(a[jj], xb[jj * nv], acc);
      }
    }
    y[(r * bm + i) * nv + v] = acc;
  }
}

// ---------------------------------------------------------------------------
// K4 bell_spmv — replaces the Pallas kernel bell_spmm (body _bell_kernel) in
// src/repro/kernels/bell_spmv/kernel.py.
//
// y[r, i, v] = sum over kk < K and jj < bn of
//              blocks[r, kk, i, jj] * x2d[block_cols[r, kk], jj, v]
// blocks [nbr, K, bm, bn] (padding blocks are zero); block_cols [nbr, K].
//
// One thread block per block row, looping over K, with K3's thread layout.
// Bound: bytes (every stored block, padding included, is read once). Same
// coalescing limits as K3.
template <typename T>
__global__ void bell_spmv_kernel(const T* __restrict__ blocks,
                                 const int32_t* __restrict__ block_cols,
                                 const T* __restrict__ x, T* __restrict__ y,
                                 int64_t K, int64_t bm, int64_t bn,
                                 int64_t nv) {
  int64_t r = blockIdx.x;
  for (int64_t e = threadIdx.x; e < bm * nv; e += blockDim.x) {
    int64_t i = e / nv;
    int64_t v = e - i * nv;
    T acc = 0;
    for (int64_t kk = 0; kk < K; ++kk) {
      int64_t g = r * K + kk;
      const T* a = blocks + (g * bm + i) * bn;
      const T* xb = x + (int64_t)block_cols[g] * bn * nv + v;
      for (int64_t jj = 0; jj < bn; ++jj) {
        acc = fma_acc(a[jj], xb[jj * nv], acc);
      }
    }
    y[(r * bm + i) * nv + v] = acc;
  }
}

constexpr int kThreads = 256;

// threads for the block-format kernels: bm * nv rounded up to a warp
inline int block_threads(int64_t bm, int64_t nv) {
  int64_t t = ceil_div(bm * nv, 32) * 32;
  return (int)(t < kThreads ? t : kThreads);
}

template <typename T>
int launch_sell_spmm(const void* vals, const void* cols, const void* ptr,
                     const void* x, void* y, int64_t S, int64_t C, int64_t W,
                     int64_t k, int64_t kt, void* stream) {
  int64_t rows = S * C;
  if (rows * k == 0) return 0;
  if (kt <= 0 || kt > kThreads || kThreads % kt != 0) {
    return (int)cudaErrorInvalidValue;
  }
  dim3 block((unsigned)kt, (unsigned)(kThreads / kt));
  dim3 grid((unsigned)ceil_div(rows, kThreads / kt),
            (unsigned)ceil_div(k, kt));
  sell_spmm_kernel<T><<<grid, block, 0, (cudaStream_t)stream>>>(
      (const T*)vals, (const int32_t*)cols, (const int64_t*)ptr,
      (const T*)x, (T*)y, rows, C, W, k);
  return (int)cudaGetLastError();
}

// K1: one vector per k-tile column, so K1 and K2 share one body
template <typename T>
int launch_sell_spmv(const void* vals, const void* cols, const void* ptr,
                     const void* x, void* y, int64_t S, int64_t C, int64_t W,
                     int64_t nv, void* stream) {
  return launch_sell_spmm<T>(vals, cols, ptr, x, y, S, C, W, nv, 1, stream);
}

template <typename T>
int launch_bcsr_spmv(const void* blocks, const void* cols, const void* rowptr,
                     const void* x, void* y, int64_t nbr, int64_t bm,
                     int64_t bn, int64_t nv, void* stream) {
  if (nbr * bm * nv == 0) return 0;
  bcsr_spmv_kernel<T><<<(unsigned)nbr, block_threads(bm, nv), 0,
                        (cudaStream_t)stream>>>(
      (const T*)blocks, (const int32_t*)cols, (const int64_t*)rowptr,
      (const T*)x, (T*)y, bm, bn, nv);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bell_spmv(const void* blocks, const void* cols, const void* x,
                     void* y, int64_t nbr, int64_t K, int64_t bm, int64_t bn,
                     int64_t nv, void* stream) {
  if (nbr * bm * nv == 0) return 0;
  bell_spmv_kernel<T><<<(unsigned)nbr, block_threads(bm, nv), 0,
                        (cudaStream_t)stream>>>(
      (const T*)blocks, (const int32_t*)cols, (const T*)x, (T*)y, K, bm, bn,
      nv);
  return (int)cudaGetLastError();
}

}  // namespace

#define SPMV_EXPORT(NAME, SUFFIX, TYPE)                                       \
  extern "C" int NAME##_##SUFFIX(                                             \
      const void* a, const void* b, const void* c, const void* d, void* e,    \
      long long p0, long long p1, long long p2, long long p3, void* stream) { \
    return launch_##NAME<TYPE>(a, b, c, d, e, p0, p1, p2, p3, stream);        \
  }

SPMV_EXPORT(sell_spmv, f32, float)
SPMV_EXPORT(sell_spmv, f64, double)
SPMV_EXPORT(bcsr_spmv, f32, float)
SPMV_EXPORT(bcsr_spmv, f64, double)

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
