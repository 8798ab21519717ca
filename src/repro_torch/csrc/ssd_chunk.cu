// K5 ssd_chunk — one fused Mamba2 SSD chunk, hand-written for Hopper (sm_90a),
// bound with ctypes like spmv_kernels.cu.
//
// Replaces the Pallas kernel ssd_chunk (body _ssd_chunk_kernel) in
// src/repro/kernels/ssd_chunk/kernel.py. For each (batch b, head h), over one
// chunk of T time steps:
//
//   cum_t     = la_0 + ... + la_t                       (log decay, f32)
//   S[t][i]   = (c_t . b_i) * exp(cum_t - cum_i)        for i <= t, else 0
//   y[t][p]   = sum_i S[t][i] xw[i][p] + exp(cum_t) * sum_n c[t][n] st[n][p]
//   st'[n][p] = st[n][p] exp(cum_{T-1})
//               + sum_t b[t][n] exp(cum_{T-1} - cum_t) xw[t][p]
//
// la [B, T, H] f32; xw [B, T, H, P], b and c [B, T, N], st [B, H, N, P] in the
// compute type (float or bf16); y and st' are stored in that type. B and C are
// shared by every head of one b, so they are indexed by b alone. All
// arithmetic is f32, as the TPU kernel casts.
//
// One thread block of 256 threads per (b, h): grid (H, B), 224 blocks on the
// Zamba2-7B prefill (B = 2, H = 112). The block stages the chunk in shared
// memory as f32 — cum [T], B and C [T][N + 1], xw [T][P], st [N][P] and the
// score tile S [T][T + 1] (rows padded to an odd stride so a warp's column
// reads fall in distinct banks): 178 KB at T = 128, N = P = 64, which needs
// the dynamic shared-memory opt-in that the launcher sets. Each of the three
// products is a register-tiled shared-memory product: the 16 x 16 threads
// each hold a 4 x 4 tile of a 64 x 64 output tile, 8 shared loads per 16
// FMAs. The masked upper triangle is never exponentiated: tiles wholly above
// the diagonal are skipped, entries above it are stored as 0, and the
// intra-chunk product stops at the tile's last row.
//
// The cumsum is a sequential f32 sum by one thread, the order torch.cumsum
// takes along a non-innermost dimension. On the model, a chunk's log decays
// sum to about -1400 at T = 128, where one f32 ulp is 1.2e-4: another
// summation order moves exp(cum_t - cum_i) by ~1e-4 relative, and the kernel
// could then not be held to its plain version at 1e-5. With the same bits for
// cum, the comparison measures the products alone.
//
// Bound on this card: per launch at B = 2, T = 128, H = 112, N = P = 64 the
// function moves 11.2 MB in bf16 (3.3 us at 3.35 TB/s) and needs 0.71 GFLOP
// (C B^T once per batch row, the triangle only: 0.7 us on bf16 tensor
// cores, 10.6 us on f32 CUDA cores). This kernel recomputes C B^T in every
// head's block and runs on the CUDA cores in f32, one block per SM (178 KB
// of shared memory), so it is bound by shared-memory load throughput and
// latency, well above both; wgmma on bf16 tiles with f32 accumulation, with
// C B^T shared across heads, is the later redesign.
//
// Offsets into xw and y are 64-bit. Every tensor's inner dimensions are
// packed; la, xw, b, c and y take a batch stride so that a chunk can be a
// view of the whole sequence.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSide = 16;              // 16 x 16 threads over an output tile
constexpr int kReg = 4;                // each thread: 4 x 4 outputs
constexpr int kTile = kSide * kReg;    // 64 x 64 output tile

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// acc[j][c] += sum_{k < K} A(r_j, k) * Bm(k, col_c) over the thread's rows
// r_j = row0 + ty + 16 j and columns col_c = col0 + tx + 16 c, with
// A(r, k) = a[r * a_r + k * a_k] and Bm(k, c) = bm[k * b_k + c * b_c];
// rows >= R and columns >= C read as 0.
__device__ __forceinline__ void mac_tile(float (&acc)[kReg][kReg],
                                         const float* a, int a_r, int a_k,
                                         const float* bm, int b_k, int b_c,
                                         int R, int C, int K, int row0,
                                         int col0) {
  const int tx = threadIdx.x % kSide, ty = threadIdx.x / kSide;
  int ra[kReg], cb[kReg];
  bool rv[kReg], cv[kReg];
#pragma unroll
  for (int j = 0; j < kReg; ++j) {
    const int r = row0 + ty + kSide * j, c = col0 + tx + kSide * j;
    rv[j] = r < R;
    cv[j] = c < C;
    ra[j] = rv[j] ? r * a_r : 0;
    cb[j] = cv[j] ? c * b_c : 0;
  }
  for (int k = 0; k < K; ++k) {
    float av[kReg], bv[kReg];
#pragma unroll
    for (int j = 0; j < kReg; ++j) {
      av[j] = rv[j] ? a[ra[j] + k * a_k] : 0.f;
      bv[j] = cv[j] ? bm[k * b_k + cb[j]] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kReg; ++j)
#pragma unroll
      for (int c = 0; c < kReg; ++c) acc[j][c] = fmaf(av[j], bv[c], acc[j][c]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ssd_chunk_kernel(const float* __restrict__ la, const T* __restrict__ xw,
                     const T* __restrict__ bmat, const T* __restrict__ cmat,
                     const T* __restrict__ state, T* __restrict__ y,
                     T* __restrict__ state_out, int H, int Tn, int N, int P,
                     long long la_bs, long long xw_bs, long long bc_bs,
                     long long y_bs) {
  extern __shared__ float smem[];
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int tx = tid % kSide, ty = tid / kSide;
  const int ldn = N + 1, ldt = Tn + 1;
  float* s_cum = smem;              // [T]
  float* s_b = s_cum + Tn;          // [T][N + 1]
  float* s_c = s_b + Tn * ldn;      // [T][N + 1]
  float* s_x = s_c + Tn * ldn;      // [T][P]
  float* s_st = s_x + Tn * P;       // [N][P]
  float* s_sc = s_st + N * P;       // [T][T + 1]

  const long long hp = (long long)H * P;
  const float* la_b = la + b * la_bs + h;                   // [t * H]
  const T* xw_b = xw + b * xw_bs + (long long)h * P;        // [t * H * P + p]
  const T* b_b = bmat + b * bc_bs;                          // [t * N + n]
  const T* c_b = cmat + b * bc_bs;
  const long long bh = (long long)b * H + h;
  const T* st_b = state + bh * N * P;                       // [n * P + p]
  T* y_b = y + b * y_bs + (long long)h * P;
  T* so_b = state_out + bh * N * P;

  for (int i = tid; i < Tn; i += kThreads) s_cum[i] = la_b[(long long)i * H];
  for (int i = tid; i < Tn * N; i += kThreads) {
    const int t = i / N, n = i % N;
    s_b[t * ldn + n] = to_f32(b_b[i]);
    s_c[t * ldn + n] = to_f32(c_b[i]);
  }
  for (int i = tid; i < Tn * P; i += kThreads) {
    const int t = i / P, p = i % P;
    s_x[i] = to_f32(xw_b[t * hp + p]);
  }
  for (int i = tid; i < N * P; i += kThreads) s_st[i] = to_f32(st_b[i]);
  __syncthreads();
  if (tid == 0) {
    float acc = 0.f;
    for (int t = 0; t < Tn; ++t) {
      acc += s_cum[t];
      s_cum[t] = acc;
    }
  }
  __syncthreads();

  // scores S = (C B^T) * decay on and below the diagonal
  for (int row0 = 0; row0 < Tn; row0 += kTile) {
    for (int col0 = 0; col0 <= row0; col0 += kTile) {
      float acc[kReg][kReg] = {};
      mac_tile(acc, s_c, ldn, 1, s_b, 1, ldn, Tn, Tn, N, row0, col0);
#pragma unroll
      for (int j = 0; j < kReg; ++j) {
        const int t = row0 + ty + kSide * j;
#pragma unroll
        for (int c = 0; c < kReg; ++c) {
          const int i = col0 + tx + kSide * c;
          if (t < Tn && i < Tn)
            s_sc[t * ldt + i] =
                i <= t ? acc[j][c] * expf(s_cum[t] - s_cum[i]) : 0.f;
        }
      }
    }
  }
  __syncthreads();

  // B rows scaled by exp(cum_last - cum_t) for the state update (the y
  // products below do not read s_b)
  const float cum_last = s_cum[Tn - 1];
  for (int i = tid; i < Tn * N; i += kThreads) {
    const int t = i / N, n = i % N;
    s_b[t * ldn + n] *= expf(cum_last - s_cum[t]);
  }

  // y = S xw + exp(cum) * (C st)
  for (int row0 = 0; row0 < Tn; row0 += kTile) {
    const int k_end = min(row0 + kTile, Tn);  // S[t][i] = 0 for i > t
    for (int col0 = 0; col0 < P; col0 += kTile) {
      float intra[kReg][kReg] = {}, inter[kReg][kReg] = {};
      mac_tile(intra, s_sc, ldt, 1, s_x, P, 1, Tn, P, k_end, row0, col0);
      mac_tile(inter, s_c, ldn, 1, s_st, P, 1, Tn, P, N, row0, col0);
#pragma unroll
      for (int j = 0; j < kReg; ++j) {
        const int t = row0 + ty + kSide * j;
        if (t >= Tn) continue;
        const float e = expf(s_cum[t]);
#pragma unroll
        for (int c = 0; c < kReg; ++c) {
          const int p = col0 + tx + kSide * c;
          if (p < P)
            y_b[t * hp + p] = from_f32<T>(intra[j][c] + e * inter[j][c]);
        }
      }
    }
  }
  __syncthreads();

  // st' = st * exp(cum_last) + (B * exp(cum_last - cum))^T xw
  const float e_last = expf(cum_last);
  for (int row0 = 0; row0 < N; row0 += kTile) {
    for (int col0 = 0; col0 < P; col0 += kTile) {
      float acc[kReg][kReg] = {};
      mac_tile(acc, s_b, 1, ldn, s_x, P, 1, N, P, Tn, row0, col0);
#pragma unroll
      for (int j = 0; j < kReg; ++j) {
        const int n = row0 + ty + kSide * j;
        if (n >= N) continue;
#pragma unroll
        for (int c = 0; c < kReg; ++c) {
          const int p = col0 + tx + kSide * c;
          if (p < P)
            so_b[n * P + p] =
                from_f32<T>(s_st[n * P + p] * e_last + acc[j][c]);
        }
      }
    }
  }
}

template <typename T>
int launch(const void* la, const void* xw, const void* bmat, const void* cmat,
           const void* state, void* y, void* state_out, long long B,
           long long Tn, long long H, long long N, long long P,
           long long la_bs, long long xw_bs, long long bc_bs, long long y_bs,
           long long smem, void* stream) {
  if (B == 0 || H == 0 || Tn == 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  ssd_chunk_kernel<T><<<dim3((unsigned)H, (unsigned)B), kThreads, (size_t)smem,
                        (cudaStream_t)stream>>>(
      (const float*)la, (const T*)xw, (const T*)bmat, (const T*)cmat,
      (const T*)state, (T*)y, (T*)state_out, (int)H, (int)Tn, (int)N, (int)P,
      la_bs, xw_bs, bc_bs, y_bs);
  return (int)cudaGetLastError();
}

}  // namespace

#define SSD_LAUNCHER(SUFFIX, TYPE)                                            \
  extern "C" int ssd_chunk_##SUFFIX(                                          \
      const void* la, const void* xw, const void* bmat, const void* cmat,     \
      const void* state, void* y, void* state_out, long long B, long long Tn, \
      long long H, long long N, long long P, long long la_bs,                 \
      long long xw_bs, long long bc_bs, long long y_bs, long long smem,       \
      void* stream) {                                                         \
    return launch<TYPE>(la, xw, bmat, cmat, state, y, state_out, B, Tn, H, N, \
                        P, la_bs, xw_bs, bc_bs, y_bs, smem, stream);          \
  }

SSD_LAUNCHER(f32, float)
SSD_LAUNCHER(bf16, __nv_bfloat16)
