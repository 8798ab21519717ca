// K5 ssd_chunk — the Mamba2 SSD over a whole sequence, one launch per layer,
// hand-written for Hopper (sm_90a), bound with ctypes like spmv_kernels.cu.
//
// Replaces the Pallas kernel ssd_chunk (body _ssd_chunk_kernel) in
// src/repro/kernels/ssd_chunk/kernel.py and the reference's lax.scan of it
// over the chunks of a sequence (ssd_scan in src/repro/kernels/ssd_chunk/
// ops.py). For each (batch b, head h) and each chunk of T time steps, in
// order, with st the state carried in from the chunk before:
//
//   cum_t     = la_0 + ... + la_t                       (log decay, f32; the
//                                                        sum restarts in
//                                                        every chunk)
//   S[t][i]   = (c_t . b_i) * exp(cum_t - cum_i)        for i <= t, else 0
//   y[t][p]   = sum_i S[t][i] xw[i][p] + exp(cum_t) * sum_n c[t][n] st[n][p]
//   st'[n][p] = st[n][p] exp(cum_{T-1})
//               + sum_t b[t][n] exp(cum_{T-1} - cum_t) xw[t][p]
//
// la [B, S, H] f32; xw [B, S, H, P], b and c [B, S, N], st [B, H, N, P] in
// the compute type (float or bf16); y and the final state are stored in that
// type. The carried state is rounded to the compute type at every chunk
// boundary, where the reference's scan rounds it: in bf16 it carries as
// bf16(f32(st) * exp(cum_last) + sum). B and C are shared by every head of
// one b, so they are indexed by b alone; they come from L2.
//
// The cumsum is a sequential left-to-right f32 sum, the order torch.cumsum
// takes along a non-innermost dimension. On the model a chunk's log decays
// sum to about -1400, where one f32 ulp is 1.2e-4: another summation order
// moves exp(cum_t - cum_i) by ~1e-4 relative, and the kernel could then not
// be held to its plain version at 1e-5. One warp sums it in registers: each
// lane loads one step of a group of 32 and the running sum passes from lane
// to lane by shuffle, in order (warp_cumsum). The decay is always
// exp(cum_t - cum_i), never exp(cum_t) * exp(-cum_i), which overflows f32 at
// -1400.
//
// Bound on this card, per layer of the Zamba2-7B bf16 prefill (B = 2,
// S = 4096, H = 112, N = P = 64, T = 128): 244 MB of la, xw, y, B, C and
// the state in and out (0.073 ms at 3.35 TB/s) against 22.7 GFLOP of least
// work (C B^T once per batch row and the two T x T products on the triangle
// only: 0.023 ms on bf16 tensor cores, 0.34 ms in f32 at 67 TFLOP/s). So
// the bf16 function is bound by bytes, and the f32 one by its operations
// (counted at the f32 rate, though its body runs on the tensor cores).
//
// Three bodies, chosen by the launcher:
//
// ssd_scan_tc_kernel (bf16, N = P = 64, T a multiple of 16 up to 128,
// 16-byte aligned operands): the products on the tensor cores, by
// mma.sync.m16n8k16 bf16 -> f32 with operands from shared memory by
// ldmatrix. mma.sync, not wgmma: the function is bound by bytes, with a
// third as much tensor-core work, and mma.sync's 16-row tiles give each warp
// 16 rows of the chunk, which keeps the causal triangle's skipped tiles
// per warp; wgmma's 64-row warpgroup tiles would not. One block of T / 16
// warps per (b, h), grid (H, B): 224 blocks at the main-path shape, two
// resident on each of 132 SMs (106 KB of shared memory and at most 128
// registers a thread each), so all run in one wave. Warp w owns rows
// 16w .. 16w + 15 of y: it keeps C's rows as A fragments, computes
// C st, scales it by exp(cum_t) in registers, then walks the causal column
// blocks i0 <= 16w of S: each 16 x 16 tile of C B^T is decayed and masked in
// registers, rounded to bf16 and used at once as the A operand of S xw, as
// flash-attention kernels pass P (no round trip through shared memory).
// The state update (B * exp(cum_last - cum))^T xw splits its 64 x 64 output
// over the warps; the decayed B is rounded to bf16 in registers on its way
// from ldmatrix to the mma, with the chunk's T decays computed once into
// shared memory. The exponentials are the fast ones (ex2.approx of the
// difference times log2 e, a few ulp, against bf16's 2^-9): the T^2 / 2
// decays of S are this body's largest work off the tensor cores. S and the
// decayed B are the two operands rounded to bf16, the same class of
// rounding the TPU kernel's default-precision f32 dots take. The next chunk's xw, B and C are copied
// in with cp.async into a second buffer while the current chunk's products
// run, and warp 0 sums the next chunk's cumsum after its own rows of y.
// Shared memory rows are 128 B with the 16-byte chunks XOR-swizzled by the
// row (sw), so ldmatrix and cp.async hit distinct banks.
//
// ssd_scan_tf32_kernel (f32, the same shapes and alignments): the bf16
// body's structure in f32, each product as three TF32 products (see its
// note); one TF32 product would break the 1e-5 gate.
//
// ssd_scan_simt_kernel (every other shape or alignment, f32 and bf16): the
// products on the CUDA cores in f32 FMAs, with the chunk loop inside the
// kernel. One block of 256 threads per (b, h) stages each chunk in shared
// memory as f32 (cum [T], B and C [T][N + 1], xw [T][P], st [N][P], scores
// [T][T + 1]); each product is a register-tiled shared-memory product
// (16 x 16 threads, 4 x 4 outputs each); tiles wholly above the diagonal
// are skipped.
//
// Offsets into xw and y are 64-bit. Every tensor's inner dimensions are
// packed; la, xw, b, c and y take a batch stride.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
using bf162 = __nv_bfloat162;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16(v);
}

// One group of 32 steps of a left-to-right f32 cumsum over a warp: lane l
// holds step l's log decay v; every lane gathers the group's 32 values by
// shuffle, then adds them in order onto acc, the sum of the groups before.
// Returns the sum through this lane's step, with exactly the sequential bits.
__device__ __forceinline__ float group_cumsum(float v, float& acc) {
  const int lane = threadIdx.x % 32;
  float w[32];
#pragma unroll
  for (int src = 0; src < 32; ++src) w[src] = __shfl_sync(0xffffffffu, v, src);
  float mine = 0.f;
#pragma unroll
  for (int src = 0; src < 32; ++src) {
    acc += w[src];  // + 0 past the chunk's end leaves acc
    if (lane == src) mine = acc;
  }
  return mine;
}

// cum[t] = la[0] + la[stride] + ... + la[t * stride] for t < Tn, by one
// warp, group by group.
__device__ __forceinline__ void warp_cumsum(const float* __restrict__ la,
                                            long long stride, int Tn,
                                            float* __restrict__ cum) {
  const int lane = threadIdx.x % 32;
  float acc = 0.f;
  for (int t0 = 0; t0 < Tn; t0 += 32) {
    const float v = t0 + lane < Tn ? la[(long long)(t0 + lane) * stride] : 0.f;
    const float mine = group_cumsum(v, acc);
    if (t0 + lane < Tn) cum[t0 + lane] = mine;
  }
}

// ---------------------------------------------------------------------------
// The CUDA-core body.

constexpr int kThreads = 256;
constexpr int kSide = 16;              // 16 x 16 threads over an output tile
constexpr int kReg = 4;                // each thread: 4 x 4 outputs
constexpr int kTile = kSide * kReg;    // 64 x 64 output tile

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
    ssd_scan_simt_kernel(const float* __restrict__ la,
                         const T* __restrict__ xw, const T* __restrict__ bmat,
                         const T* __restrict__ cmat,
                         const T* __restrict__ state, T* __restrict__ y,
                         T* __restrict__ state_out, int H, long long S,
                         int Tn, int N, int P, long long la_bs,
                         long long xw_bs, long long bc_bs, long long y_bs) {
  extern __shared__ float smem[];
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int tx = tid % kSide, ty = tid / kSide;
  const int ldn = N + 1, ldt = Tn + 1;
  float* s_cum = smem;              // [T]
  float* s_b = s_cum + Tn;          // [T][N + 1]
  float* s_c = s_b + Tn * ldn;      // [T][N + 1]
  float* s_x = s_c + Tn * ldn;      // [T][P]
  float* s_st = s_x + Tn * P;       // [N][P], the carried state
  float* s_sc = s_st + N * P;       // [T][T + 1]

  const long long hp = (long long)H * P;
  const long long bh = (long long)b * H + h;
  for (int i = tid; i < N * P; i += kThreads) {
    s_st[i] = to_f32(state[bh * N * P + i]);
  }
  for (long long c0 = 0; c0 < S; c0 += Tn) {
    const float* la_b = la + b * la_bs + c0 * H + h;         // [t * H]
    const T* xw_b = xw + b * xw_bs + c0 * hp + (long long)h * P;
    const T* b_b = bmat + b * bc_bs + c0 * N;                // [t * N + n]
    const T* c_b = cmat + b * bc_bs + c0 * N;
    T* y_b = y + b * y_bs + c0 * hp + (long long)h * P;
    if (tid < 32) warp_cumsum(la_b, H, Tn, s_cum);
    for (int i = tid; i < Tn * N; i += kThreads) {
      const int t = i / N, n = i % N;
      s_b[t * ldn + n] = to_f32(b_b[i]);
      s_c[t * ldn + n] = to_f32(c_b[i]);
    }
    for (int i = tid; i < Tn * P; i += kThreads) {
      const int t = i / P, p = i % P;
      s_x[i] = to_f32(xw_b[t * hp + p]);
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

    // st' = st * exp(cum_last) + (B * exp(cum_last - cum))^T xw, rounded to
    // the compute type; each thread reads and writes its own entries of s_st
    const float e_last = expf(cum_last);
    const bool last = c0 + Tn >= S;
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
            if (p >= P) continue;
            const T v = from_f32<T>(s_st[n * P + p] * e_last + acc[j][c]);
            s_st[n * P + p] = to_f32(v);
            if (last) state_out[bh * N * P + n * P + p] = v;
          }
        }
      }
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// The tensor-core body (bf16).

constexpr int kTcN = 64;    // d_state the tensor-core body takes
constexpr int kTcP = 64;    // head dim the tensor-core body takes
constexpr int kRow = 64;    // bf16 per shared-memory row (128 B)

// element offset of 16-byte chunk ch (0..7) of row r, XOR-swizzled by r
__device__ __forceinline__ int sw(int r, int ch) {
  return r * kRow + ((ch ^ (r & 7)) << 3);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const bf162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// a pair of bf16 scaled by (lo, hi) in f32, rounded back to bf16
__device__ __forceinline__ uint32_t scale2(uint32_t v, float lo, float hi) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const bf162*>(&v));
  return pack_bf16(f.x * lo, f.y * hi);
}

// Fragment layouts (PTX ISA, mma.m16n8k16): lane = 4 g + q; an f32
// accumulator holds (row g, cols 2q, 2q + 1) and (row g + 8, the same
// cols); A holds (row g | g + 8, k 2q, 2q + 1 | 2q + 8, 2q + 9); B holds
// (k 2q, 2q + 1 | 2q + 8, 2q + 9, col g). ldmatrix.x4 gives matrix m the
// row addresses of lanes 8m .. 8m + 7; .trans reads a k-major [k][n] tile
// as the col-major B (or a [k][m] tile as the row-major A).
__global__ void __launch_bounds__(256, 2)
    ssd_scan_tc_kernel(const float* __restrict__ la,
                       const bf16* __restrict__ xw,
                       const bf16* __restrict__ bmat,
                       const bf16* __restrict__ cmat,
                       const bf16* __restrict__ state, bf16* __restrict__ y,
                       bf16* __restrict__ state_out, int H, long long S,
                       int Tn, long long la_bs, long long xw_bs,
                       long long bc_bs, long long y_bs) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* s_c = reinterpret_cast<bf16*>(smem_raw);   // [2][T][64]
  bf16* s_b = s_c + 2 * Tn * kRow;                 // [2][T][64]
  bf16* s_x = s_b + 2 * Tn * kRow;                 // [2][T][64]
  bf16* s_st = s_x + 2 * Tn * kRow;                // [N][64]
  float* s_cum = reinterpret_cast<float*>(s_st + kTcN * kRow);  // [2][T]
  float* s_dec = s_cum + 2 * Tn;                   // [T]

  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, q = lane % 4;
  const int warps = Tn / 16, nthr = Tn * 2;
  const long long hp = (long long)H * kTcP;
  const long long bh = (long long)b * H + h;
  const float* la_b = la + b * la_bs + h;
  const bf16* xw_b = xw + b * xw_bs + (long long)h * kTcP;
  const bf16* b_b = bmat + b * bc_bs;
  const bf16* c_b = cmat + b * bc_bs;
  bf16* y_b = y + b * y_bs + (long long)h * kTcP;
  bf16* so_b = state_out + bh * kTcN * kTcP;
  const int nc = (int)(S / Tn);

  // chunk c's C, B and xw into buffer buf, 16 bytes a copy
  auto load_chunk = [&](int c, int buf) {
    const long long t0 = (long long)c * Tn;
    for (int i = tid; i < Tn * 8; i += nthr) {
      const int t = i / 8, ch = i % 8;
      const int o = buf * Tn * kRow + sw(t, ch);
      cp_async16(s_c + o, c_b + (t0 + t) * kTcN + ch * 8);
      cp_async16(s_b + o, b_b + (t0 + t) * kTcN + ch * 8);
      cp_async16(s_x + o, xw_b + (t0 + t) * hp + ch * 8);
    }
  };

  for (int i = tid; i < kTcN * 8; i += nthr) {
    cp_async16(s_st + sw(i / 8, i % 8),
               state + bh * kTcN * kTcP + (long long)i * 8);
  }
  load_chunk(0, 0);
  cp_async_commit();
  if (warp == 0) warp_cumsum(la_b, H, Tn, s_cum);
  cp_async_wait_all();
  __syncthreads();

  for (int c = 0; c < nc; ++c) {
    const int cur = c & 1;
    if (c + 1 < nc) {
      load_chunk(c + 1, cur ^ 1);
      cp_async_commit();
    }
    // warp 0: the next chunk's log decays, step 32 j + lane in lv[j]
    float lv[4] = {0.f, 0.f, 0.f, 0.f};
    if (warp == 0 && c + 1 < nc) {
      const float* la_n = la_b + (long long)(c + 1) * Tn * H;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (32 * j + lane < Tn) lv[j] = la_n[(long long)(32 * j + lane) * H];
    }
    const bf16* sc = s_c + cur * Tn * kRow;
    const bf16* sb = s_b + cur * Tn * kRow;
    const bf16* sx = s_x + cur * Tn * kRow;
    const float* cum = s_cum + cur * Tn;
    const float cum_last = cum[Tn - 1];
    // the state update's decays, once per chunk (read after the next sync)
    if (tid < Tn) s_dec[tid] = __expf(cum_last - cum[tid]);

    // rows r0 .. r0 + 15 of y. The causal triangle gives row block rb
    // rb + 1 column blocks; warps w and w + 4 share a sub-partition of the
    // SM (its tensor cores), so the second half of the warps takes the row
    // blocks in reverse and every sub-partition gets the same work.
    {
      const int rb = warp < warps / 2 ? warp : warps - 1 - (warp - warps / 2);
      const int r0 = rb * 16;
      uint32_t cf[4][4];  // C[r0 .., :] as A fragments, k = n in 4 steps
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        ldsm_x4(cf[kk], sc + sw(r0 + lane % 16, 2 * kk + lane / 16));
      float acc[8][4];  // y[16][64] as 8 tiles of 8 columns
#pragma unroll
      for (int j = 0; j < 8; ++j)
        acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
      // C st, scaled by exp(cum_t) per row
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int pj = 0; pj < 4; ++pj) {
          uint32_t bf[4];
          ldsm_x4_t(bf, s_st + sw(16 * kk + lane % 8 + (lane / 8 % 2) * 8,
                                  2 * pj + lane / 16));
          mma(acc[2 * pj], cf[kk], bf[0], bf[1]);
          mma(acc[2 * pj + 1], cf[kk], bf[2], bf[3]);
        }
      }
      const float ct0 = cum[r0 + g], ct1 = cum[r0 + g + 8];
      const float e0 = __expf(ct0), e1 = __expf(ct1);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        acc[j][0] *= e0;
        acc[j][1] *= e0;
        acc[j][2] *= e1;
        acc[j][3] *= e1;
      }
      // + S xw over the column blocks on and below the diagonal
      for (int i0 = 0; i0 <= r0; i0 += 16) {
        float s[2][4] = {};
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          uint32_t bb[4];
          ldsm_x4(bb, sb + sw(i0 + lane % 8 + (lane / 16) * 8,
                              2 * kk + lane / 8 % 2));
          mma(s[0], cf[kk], bb[0], bb[1]);
          mma(s[1], cf[kk], bb[2], bb[3]);
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int t = r0 + g + (e / 2) * 8;
            const int i = i0 + 8 * j + 2 * q + e % 2;
            s[j][e] = i <= t ? s[j][e] * __expf((e < 2 ? ct0 : ct1) - cum[i])
                             : 0.f;
          }
        }
        const uint32_t a[4] = {pack_bf16(s[0][0], s[0][1]),
                               pack_bf16(s[0][2], s[0][3]),
                               pack_bf16(s[1][0], s[1][1]),
                               pack_bf16(s[1][2], s[1][3])};
#pragma unroll
        for (int pj = 0; pj < 4; ++pj) {
          uint32_t bx[4];
          ldsm_x4_t(bx, sx + sw(i0 + lane % 8 + (lane / 8 % 2) * 8,
                                2 * pj + lane / 16));
          mma(acc[2 * pj], a, bx[0], bx[1]);
          mma(acc[2 * pj + 1], a, bx[2], bx[3]);
        }
      }
      const long long t = (long long)c * Tn + r0 + g;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int p = 8 * j + 2 * q;
        *reinterpret_cast<bf162*>(y_b + t * hp + p) =
            __floats2bfloat162_rn(acc[j][0], acc[j][1]);
        *reinterpret_cast<bf162*>(y_b + (t + 8) * hp + p) =
            __floats2bfloat162_rn(acc[j][2], acc[j][3]);
      }
    }
    // the next chunk's cumsum, while the other warps run their products
    // (warp 0 has the shortest row block)
    if (warp == 0 && c + 1 < nc) {
      float acc = 0.f;
      float* cum_n = s_cum + (cur ^ 1) * Tn;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (32 * j >= Tn) break;
        const float mine = group_cumsum(lv[j], acc);
        if (32 * j + lane < Tn) cum_n[32 * j + lane] = mine;
      }
    }
    __syncthreads();  // every warp has read s_st for C st

    // st' = st exp(cum_last) + (B exp(cum_last - cum))^T xw: 4 x 2 tiles of
    // 16 states x 32 columns over the warps; each warp reads and writes its
    // own entries of s_st
    const float e_last = __expf(cum_last);
    for (int pair = warp; pair < 8; pair += warps) {
      const int n0 = (pair % 4) * 16, pb = (pair / 4) * 32;
      float sa[4][4] = {};
      for (int k0 = 0; k0 < Tn; k0 += 16) {
        uint32_t a[4];
        ldsm_x4_t(a, sb + sw(k0 + lane % 8 + (lane / 16) * 8,
                             n0 / 8 + lane / 8 % 2));
        const float d0 = s_dec[k0 + 2 * q], d1 = s_dec[k0 + 2 * q + 1];
        const float d2 = s_dec[k0 + 2 * q + 8], d3 = s_dec[k0 + 2 * q + 9];
        a[0] = scale2(a[0], d0, d1);
        a[1] = scale2(a[1], d0, d1);
        a[2] = scale2(a[2], d2, d3);
        a[3] = scale2(a[3], d2, d3);
#pragma unroll
        for (int pj = 0; pj < 2; ++pj) {
          uint32_t bx[4];
          ldsm_x4_t(bx, sx + sw(k0 + lane % 8 + (lane / 8 % 2) * 8,
                                pb / 8 + 2 * pj + lane / 16));
          mma(sa[2 * pj], a, bx[0], bx[1]);
          mma(sa[2 * pj + 1], a, bx[2], bx[3]);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int n = n0 + g + 8 * half, p = pb + 8 * j + 2 * q;
          bf162* sp = reinterpret_cast<bf162*>(s_st + sw(n, p / 8) + p % 8);
          const float2 old = __bfloat1622float2(*sp);
          const bf162 v = __floats2bfloat162_rn(
              old.x * e_last + sa[j][2 * half],
              old.y * e_last + sa[j][2 * half + 1]);
          *sp = v;
          if (c == nc - 1)
            *reinterpret_cast<bf162*>(so_b + n * kTcP + p) = v;
        }
      }
    }
    cp_async_wait_all();
    __syncthreads();  // the next chunk, its cumsum and st' are in place
  }
}

// ---------------------------------------------------------------------------
// The tensor-core body in f32: three TF32 products per product.
//
// Each f32 operand x is split into hi = tf32(x) and lo = tf32(x - hi), and
// a * b is summed as lo_a hi_b + hi_a lo_b + hi_a hi_b (mma.sync.m16n8k8
// tf32 -> f32), which drops lo_a lo_b and the rounding of lo: about 2^-21
// of |a| |b| per term, the size of the f32 sum's own rounding, where one
// TF32 product (2^-11) would break the 1e-5 gate. The decays and the mask
// stay f32 with the accurate expf. The structure is the bf16 body's: warp w
// owns 16 rows of y, the score tile stays in registers and feeds S xw (its
// accumulator layout is used as the A operand with the k order permuted to
// 2q, 2q + 1, and xw's rows read in the same order), the state update
// splits its 64 x 64 output over the warps. C, B and xw are staged once
// (f32 rows of 64, 256 B, 16-byte chunks XOR-swizzled by the row): 113 KB,
// two blocks to an SM, so the 224 blocks run in one wave; the next chunk's
// C is copied in by cp.async while the state update runs, and warp 0 sums
// the next chunk's cumsum beside it.

constexpr int kRow32 = 64;  // f32 per shared-memory row (256 B)

// element offset of 16-byte chunk ch (0..15) of row r, XOR-swizzled by r
__device__ __forceinline__ int sw32(int r, int ch) {
  return r * kRow32 + ((ch ^ (r & 7)) << 2);
}
__device__ __forceinline__ int at32(int r, int c) {
  return sw32(r, c >> 2) + (c & 3);
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// an A fragment (16 x 8) split once, used against many B fragments
struct SplitA {
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ explicit SplitA(const float (&a)[4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(a[i], hi[i], lo[i]);
  }
};

// d += a * b (b: k rows q and q + 4 of column g) in three TF32 products
__device__ __forceinline__ void mma3(float (&d)[4], const SplitA& a, float b0,
                                     float b1) {
  uint32_t h0, l0, h1, l1;
  split_tf32(b0, h0, l0);
  split_tf32(b1, h1, l1);
  mma_tf32(d, a.lo, h0, h1);
  mma_tf32(d, a.hi, l0, l1);
  mma_tf32(d, a.hi, h0, h1);
}

// tf32 fragments (PTX ISA, mma.m16n8k8): A holds (row g | g + 8, k q |
// q + 4), B holds (k q | q + 4, col g), the accumulator as in bf16.
// ldmatrix.x4 on f32 rows gives each lane (row g, element q) of an 8 x 4
// block, which is A's layout.
__global__ void __launch_bounds__(256, 2)
    ssd_scan_tf32_kernel(const float* __restrict__ la,
                         const float* __restrict__ xw,
                         const float* __restrict__ bmat,
                         const float* __restrict__ cmat,
                         const float* __restrict__ state,
                         float* __restrict__ y, float* __restrict__ state_out,
                         int H, long long S, int Tn, long long la_bs,
                         long long xw_bs, long long bc_bs, long long y_bs) {
  extern __shared__ __align__(16) float sm[];
  float* s_c = sm;                          // [T][64]
  float* s_b = s_c + Tn * kRow32;           // [T][64]
  float* s_x = s_b + Tn * kRow32;           // [T][64]
  float* s_st = s_x + Tn * kRow32;          // [N][64]
  float* s_cum = s_st + kTcN * kRow32;      // [T]
  float* s_dec = s_cum + Tn;                // [T]

  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, q = lane % 4;
  const int warps = Tn / 16, nthr = Tn * 2;
  const long long hp = (long long)H * kTcP;
  const long long bh = (long long)b * H + h;
  const float* la_b = la + b * la_bs + h;
  const float* xw_b = xw + b * xw_bs + (long long)h * kTcP;
  const float* b_b = bmat + b * bc_bs;
  const float* c_b = cmat + b * bc_bs;
  float* y_b = y + b * y_bs + (long long)h * kTcP;
  float* so_b = state_out + bh * kTcN * kTcP;
  const int nc = (int)(S / Tn);

  // `rows` rows of 64 f32 from src (row stride `stride`) into dst
  auto load_rows = [&](float* dst, const float* src, long long stride,
                       int rows) {
    for (int i = tid; i < rows * 16; i += nthr) {
      const int r = i / 16, ch = i % 16;
      cp_async16(dst + sw32(r, ch), src + r * stride + ch * 4);
    }
  };

  load_rows(s_st, state + bh * kTcN * kTcP, kTcP, kTcN);
  load_rows(s_c, c_b, kTcN, Tn);
  load_rows(s_b, b_b, kTcN, Tn);
  load_rows(s_x, xw_b, hp, Tn);
  cp_async_commit();
  if (warp == 0) warp_cumsum(la_b, H, Tn, s_cum);
  cp_async_wait_all();
  __syncthreads();

  for (int c = 0; c < nc; ++c) {
    const long long t0 = (long long)c * Tn;
    const float cum_last = s_cum[Tn - 1];
    if (tid < Tn) s_dec[tid] = expf(cum_last - s_cum[tid]);

    // rows r0 .. r0 + 15 of y (row blocks balanced over the sub-partitions
    // as in the bf16 body)
    {
      const int rb = warp < warps / 2 ? warp : warps - 1 - (warp - warps / 2);
      const int r0 = rb * 16;
      auto c_frag = [&](int k0) {
        uint32_t r[4];
        ldsm_x4(r, reinterpret_cast<const bf16*>(
                       s_c + sw32(r0 + lane % 8 + (lane / 8 % 2) * 8,
                                  k0 / 4 + lane / 16)));
        const float f[4] = {__uint_as_float(r[0]), __uint_as_float(r[1]),
                            __uint_as_float(r[2]), __uint_as_float(r[3])};
        return SplitA(f);
      };
      float acc[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
      // C st, scaled by exp(cum_t) per row
      for (int k0 = 0; k0 < kTcN; k0 += 8) {
        const SplitA a = c_frag(k0);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          mma3(acc[j], a, s_st[at32(k0 + q, 8 * j + g)],
               s_st[at32(k0 + q + 4, 8 * j + g)]);
      }
      const float ct0 = s_cum[r0 + g], ct1 = s_cum[r0 + g + 8];
      const float e0 = expf(ct0), e1 = expf(ct1);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        acc[j][0] *= e0;
        acc[j][1] *= e0;
        acc[j][2] *= e1;
        acc[j][3] *= e1;
      }
      // + S xw over the column blocks on and below the diagonal
      for (int i0 = 0; i0 <= r0; i0 += 16) {
        float sc[2][4] = {};
        for (int k0 = 0; k0 < kTcN; k0 += 8) {
          const SplitA a = c_frag(k0);
          uint32_t bb[4];
          ldsm_x4(bb, reinterpret_cast<const bf16*>(
                          s_b + sw32(i0 + lane % 8 + (lane / 16) * 8,
                                     k0 / 4 + lane / 8 % 2)));
          mma3(sc[0], a, __uint_as_float(bb[0]), __uint_as_float(bb[1]));
          mma3(sc[1], a, __uint_as_float(bb[2]), __uint_as_float(bb[3]));
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int t = r0 + g + (e / 2) * 8;
            const int i = i0 + 8 * j + 2 * q + e % 2;
            sc[j][e] = i <= t
                           ? sc[j][e] * expf((e < 2 ? ct0 : ct1) - s_cum[i])
                           : 0.f;
          }
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          // k q <-> column 2q, k q + 4 <-> column 2q + 1 of this 8-block
          const float f[4] = {sc[j][0], sc[j][2], sc[j][1], sc[j][3]};
          const SplitA a(f);
          const int i = i0 + 8 * j + 2 * q;
#pragma unroll
          for (int jt = 0; jt < 8; ++jt)
            mma3(acc[jt], a, s_x[at32(i, 8 * jt + g)],
                 s_x[at32(i + 1, 8 * jt + g)]);
        }
      }
      const long long t = t0 + r0 + g;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int p = 8 * j + 2 * q;
        *reinterpret_cast<float2*>(y_b + t * hp + p) =
            make_float2(acc[j][0], acc[j][1]);
        *reinterpret_cast<float2*>(y_b + (t + 8) * hp + p) =
            make_float2(acc[j][2], acc[j][3]);
      }
    }
    __syncthreads();  // C, s_cum and s_st (for C st) are read

    // the next chunk's C and cumsum, while the state update runs
    if (c + 1 < nc) {
      load_rows(s_c, c_b + (t0 + Tn) * kTcN, kTcN, Tn);
      cp_async_commit();
      if (warp == 0) warp_cumsum(la_b + (t0 + Tn) * H, H, Tn, s_cum);
    }

    // st' = st exp(cum_last) + (B exp(cum_last - cum))^T xw: 4 x 2 tiles of
    // 16 states x 32 columns over the warps, each warp on its own entries
    const float e_last = expf(cum_last);
    for (int pair = warp; pair < 8; pair += warps) {
      const int n0 = (pair % 4) * 16, pb = (pair / 4) * 32;
      float sa[4][4] = {};
      for (int k0 = 0; k0 < Tn; k0 += 8) {
        const float d0 = s_dec[k0 + q], d1 = s_dec[k0 + q + 4];
        const float f[4] = {s_b[at32(k0 + q, n0 + g)] * d0,
                            s_b[at32(k0 + q, n0 + g + 8)] * d0,
                            s_b[at32(k0 + q + 4, n0 + g)] * d1,
                            s_b[at32(k0 + q + 4, n0 + g + 8)] * d1};
        const SplitA a(f);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma3(sa[j], a, s_x[at32(k0 + q, pb + 8 * j + g)],
               s_x[at32(k0 + q + 4, pb + 8 * j + g)]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int n = n0 + g + 8 * half, p = pb + 8 * j + 2 * q;
          float2* sp = reinterpret_cast<float2*>(s_st + at32(n, p));
          const float2 v = make_float2(sp->x * e_last + sa[j][2 * half],
                                       sp->y * e_last + sa[j][2 * half + 1]);
          *sp = v;
          if (c == nc - 1)
            *reinterpret_cast<float2*>(so_b + n * kTcP + p) = v;
        }
      }
    }
    __syncthreads();  // B and xw are read, st' is in place

    if (c + 1 < nc) {
      load_rows(s_b, b_b + (t0 + Tn) * kTcN, kTcN, Tn);
      load_rows(s_x, xw_b + (t0 + Tn) * hp, hp, Tn);
      cp_async_commit();
    }
    cp_async_wait_all();
    __syncthreads();  // the next chunk and its cumsum are in place
  }
}

inline bool aligned(const void* p, long long bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// shared memory of each body, as the wrappers compute it
inline long long simt_smem(long long T, long long N, long long P) {
  return 4 * (T + 2 * T * (N + 1) + T * P + N * P + T * (T + 1));
}
inline long long tc_smem(long long T) {
  return 2 * (3 * 2 * T * kRow + kTcN * kRow) + 4 * 3 * T;
}
inline long long tf32_smem(long long T) {
  return 4 * (3 * T * kRow32 + kTcN * kRow32) + 4 * 2 * T;
}

template <typename T>
int launch_simt(const void* la, const void* xw, const void* bmat,
                const void* cmat, const void* state, void* y,
                void* state_out, long long B, long long S, long long Tn,
                long long H, long long N, long long P, long long la_bs,
                long long xw_bs, long long bc_bs, long long y_bs,
                cudaStream_t stream) {
  const long long smem = simt_smem(Tn, N, P);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_simt_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  ssd_scan_simt_kernel<T><<<dim3((unsigned)H, (unsigned)B), kThreads,
                            (size_t)smem, stream>>>(
      (const float*)la, (const T*)xw, (const T*)bmat, (const T*)cmat,
      (const T*)state, (T*)y, (T*)state_out, (int)H, S, (int)Tn, (int)N,
      (int)P, la_bs, xw_bs, bc_bs, y_bs);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_tc(void (*kernel)(const float*, const T*, const T*, const T*,
                             const T*, T*, T*, int, long long, int, long long,
                             long long, long long, long long),
              long long smem, const void* la, const void* xw,
              const void* bmat, const void* cmat, const void* state, void* y,
              void* state_out, long long B, long long S, long long Tn,
              long long H, long long la_bs, long long xw_bs, long long bc_bs,
              long long y_bs, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3((unsigned)H, (unsigned)B), (unsigned)(2 * Tn), (size_t)smem,
           stream>>>((const float*)la, (const T*)xw, (const T*)bmat,
                     (const T*)cmat, (const T*)state, (T*)y, (T*)state_out,
                     (int)H, S, (int)Tn, la_bs, xw_bs, bc_bs, y_bs);
  return (int)cudaGetLastError();
}

// the tensor-core bodies' shapes and alignments (16-byte copies of xw, B, C
// and the state, 4-byte (bf16) or 8-byte (f32) stores of y)
bool tc_fits(const void* xw, const void* bmat, const void* cmat,
             const void* state, const void* y, long long Tn, long long N,
             long long P, long long xw_bs, long long bc_bs, long long y_bs,
             long long elem) {
  const long long vec = 16 / elem;
  return N == kTcN && P == kTcP && Tn % 16 == 0 && Tn >= 16 && Tn <= 128 &&
         aligned(xw, 16) && aligned(bmat, 16) && aligned(cmat, 16) &&
         aligned(state, 16) && aligned(y, 2 * elem) && xw_bs % vec == 0 &&
         bc_bs % vec == 0 && y_bs % 2 == 0;
}

}  // namespace

// y and the final state of the SSD over S time steps in chunks of Tn, one
// launch; S a multiple of Tn.
extern "C" int ssd_scan_f32(const void* la, const void* xw, const void* bmat,
                            const void* cmat, const void* state, void* y,
                            void* state_out, long long B, long long S,
                            long long Tn, long long H, long long N,
                            long long P, long long la_bs, long long xw_bs,
                            long long bc_bs, long long y_bs, void* stream) {
  if (B == 0 || H == 0 || S == 0) return 0;
  if (Tn <= 0 || S % Tn != 0) return (int)cudaErrorInvalidValue;
  if (tc_fits(xw, bmat, cmat, state, y, Tn, N, P, xw_bs, bc_bs, y_bs, 4)) {
    return launch_tc<float>(ssd_scan_tf32_kernel, tf32_smem(Tn), la, xw, bmat,
                            cmat, state, y, state_out, B, S, Tn, H, la_bs,
                            xw_bs, bc_bs, y_bs, (cudaStream_t)stream);
  }
  return launch_simt<float>(la, xw, bmat, cmat, state, y, state_out, B, S,
                            Tn, H, N, P, la_bs, xw_bs, bc_bs, y_bs,
                            (cudaStream_t)stream);
}

extern "C" int ssd_scan_bf16(const void* la, const void* xw, const void* bmat,
                             const void* cmat, const void* state, void* y,
                             void* state_out, long long B, long long S,
                             long long Tn, long long H, long long N,
                             long long P, long long la_bs, long long xw_bs,
                             long long bc_bs, long long y_bs, void* stream) {
  if (B == 0 || H == 0 || S == 0) return 0;
  if (Tn <= 0 || S % Tn != 0) return (int)cudaErrorInvalidValue;
  if (tc_fits(xw, bmat, cmat, state, y, Tn, N, P, xw_bs, bc_bs, y_bs, 2)) {
    return launch_tc<bf16>(ssd_scan_tc_kernel, tc_smem(Tn), la, xw, bmat,
                           cmat, state, y, state_out, B, S, Tn, H, la_bs,
                           xw_bs, bc_bs, y_bs, (cudaStream_t)stream);
  }
  return launch_simt<bf16>(la, xw, bmat, cmat, state, y, state_out, B, S, Tn,
                           H, N, P, la_bs, xw_bs, bc_bs, y_bs,
                           (cudaStream_t)stream);
}
