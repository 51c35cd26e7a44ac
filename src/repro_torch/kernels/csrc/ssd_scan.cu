// Mamba-2 SSD chunk scan (K4), forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan.py::
// ssd_scan_kernel (reached through ssd_scan_pallas). Per chunk of Q tokens,
// with a = -exp(a_log) and cum = cumsum(dt * a) over the chunk:
//   y_i   = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j   (intra)
//         + exp(cum_i) C_i . S                                   (inter)
//   S    <- exp(seg) S + sum_j x_j (B_j dt_j exp(seg - cum_j))     (state)
// where seg = cum_{Q-1} and the (P, N) state S is carried in fp32 from chunk
// to chunk; head h reads B/C group h / (H/G). Decay math is fp32; x, B, C
// are bf16 or fp32; y is written in x's dtype and the final state in fp32.
//
// Two routes, chosen by dtype (each dtype has one; neither falls back):
//   bf16 -> the tensor cores (namespace tc below): the serving path's route;
//   fp32 -> the CUDA cores (fmaf): kept for the fp32 references that hold
//           the card to the CPU within 1e-5, which bf16 products would not
//           meet.
//
// What bounds it on this card: at the serving prefill (B 1, S 512, H 64,
// P 64, N 128, G 1, Q 256, bf16) the function reads x, dt, B, C and writes y
// and the final state: 10.88 MB, 3.25 us at 3.35 TB/s. The two Q x Q products
// over the causal triangle and the two Q x N x P products of each
// (head, chunk) are 2.69 GFLOP in all: 2.7 us at the bf16 tensor-core peak,
// 40 us at the fp32 CUDA-core peak (67 TFLOP/s). So on the tensor cores the
// kernel is bound by its bytes; on the CUDA cores by its arithmetic. The
// bf16 route's own tensor work is larger: its bf16 parts (below) run W X
// and C S^T twice and the state update three times, and both blocks of a
// head compute the state, ~6.5 GFLOP in all, 6.6 us at the peak.
//
// Numerics of the bf16 route (tools/ssd_rounding.py, float64 emulation at
// the main shape, in units of the gates: y 1 bf16 ulp of its row, the state
// 1e-5 of its largest |ref|). Three operands are fp32 and enter the tensor
// cores as bf16 parts: W rounded once puts y 0.60-0.73 from the reference,
// split into hi and lo 0.001; the state fed to C S^T rounded once 0.80-1.56,
// split 0.002; x u in the state update rounded once puts the state 206-275
// from it, split in two 0.30-0.35, in three 0.0006. So W and S are split in
// two and x u in three. cum is summed in fp64 and rounded once to fp32, so
// it does not depend on the order of the scan; the plain version sums it
// the same way. No atomics and fixed summation orders: the same inputs give
// the same bits on every call.
//
// Measured by chip_smoke.py on one NVIDIA H100 80GB HBM3, 700.00 W (ms,
// with the wrapper; the first design's time beside it): bf16 at the main
// shape 0.03436 (first 0.34985; bound 0.00325); S 128, one chunk 0.01237;
// fp32 0.35390 (the first design's route, unchanged). ptxas at N 128: 255
// registers, 276 bytes spilled (address arithmetic of the copies), 152 KB
// of shared memory (one block an SM).
//
// The fp32 route is the first design, unchanged: one block of 256 threads
// per (P-slice of PS = min(P, 32) columns, head, batch): column p of y and
// row p of the state depend only on column p of x, so the split is exact.
// The chunk loop lives inside the block (the TPU kernel carries the state in
// VMEM scratch across a sequential grid axis; Hopper runs blocks in no
// order). Per chunk the block stages in shared memory, as fp32: dt, the
// cumulative decays, the chunk's x columns (Q x PS) and the state (PS x N).
// For each 64-row tile of C and each 64-row tile of B on or below it, the
// block forms the 64 x 64 tile of W = (C B^T) . L . dt (thread (ty, tx) owns
// entries (ty + 16 i, tx + 16 j)) and multiplies it into x's rows. The
// state's update for the chunk is summed in registers while the diagonal
// tiles of B are staged, and applied after the chunk's last row tile has
// read the old state. About 136 KB of shared memory at N 128.
//
// Both routes select the causal mask before the exponential: for j > i,
// cum_i - cum_j is positive and exp may overflow to inf, and inf * 0 would
// be NaN. The chunk length Q is any value up to 256, not only a power of
// two: rows and columns past Q are masked (x, B, C read as 0 there, dt as
// 0).
//
// Tensors are addressed through (batch, head-or-group, sequence) strides in
// elements with a unit stride on P and N, so the model's (B, S, H, P) and
// (B, S, G, N) activations need no transpose or copy; in bf16 their rows
// must start on 16-byte boundaries (checked here, and with a ValueError by
// kernels/ops.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_Q = 256;  // longest chunk
constexpr int R = 64;       // rows (and columns) of one W tile
constexpr int SCAN_PER_LANE = MAX_Q / 32;

__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }

// cum = cumsum(dt * a) over one chunk in fp64, rounded once to fp32, by the
// 32 lanes of one warp: each lane sums SCAN_PER_LANE consecutive products,
// then the lanes' totals are scanned with shuffles. s_dt holds 0 past the
// chunk's end, so those entries of s_cum hold cum_{Q-1}.
__device__ __forceinline__ void chunk_cum(const float* s_dt, float ah,
                                          float* s_cum, int lane) {
  double part[SCAN_PER_LANE];
  double run = 0.0;
#pragma unroll
  for (int k = 0; k < SCAN_PER_LANE; ++k) {
    run += (double)__fmul_rn(s_dt[lane * SCAN_PER_LANE + k], ah);
    part[k] = run;
  }
  double incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double up = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += up;
  }
  const double excl = incl - run;
#pragma unroll
  for (int k = 0; k < SCAN_PER_LANE; ++k)
    s_cum[lane * SCAN_PER_LANE + k] = (float)(excl + part[k]);
}

template <int N, int PS>
constexpr size_t smem_floats() {
  return 4 * MAX_Q                 // dt, cum, exp(cum), dt exp(seg - cum)
         + MAX_Q * PS              // x columns of the chunk
         + 2 * R * (N + 1)         // a tile of C, a tile of B
         + R * (R + 1)             // a tile of W
         + PS * (N + 1);           // the state
}

template <typename T, int N, int PS>
__global__ void __launch_bounds__(THREADS)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ a_log, const T* __restrict__ b,
                const T* __restrict__ c, T* __restrict__ y,
                float* __restrict__ state_out, int H, int G, int S, int Q,
                int P, int64_t x_sb, int64_t x_sh, int64_t x_ss,
                int64_t dt_sb, int64_t dt_sh, int64_t dt_ss, int64_t b_sb,
                int64_t b_sg, int64_t b_ss, int64_t c_sb, int64_t c_sg,
                int64_t c_ss, int64_t y_sb, int64_t y_sh, int64_t y_ss) {
  constexpr int NP = N + 1;                        // padded row of B, C, S
  constexpr int WP = R + 1;                        // padded row of W
  constexpr int YK = R * PS / THREADS;             // y entries per thread
  constexpr int SK = (PS * N + THREADS - 1) / THREADS;  // state entries
  static_assert(YK >= 1 && R * PS % THREADS == 0, "PS too small");
  static_assert(THREADS % N == 0, "N must divide the block");

  extern __shared__ float smem[];
  float* s_dt = smem;
  float* s_cum = s_dt + MAX_Q;
  float* s_ecum = s_cum + MAX_Q;
  float* s_u = s_ecum + MAX_Q;
  float* s_x = s_u + MAX_Q;
  float* s_c = s_x + MAX_Q * PS;
  float* s_b = s_c + R * NP;
  float* s_w = s_b + R * NP;
  float* s_st = s_w + R * WP;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int p0 = blockIdx.x * PS;
  const int h = blockIdx.y;
  const int bi = blockIdx.z;
  const int g = h / (H / G);
  const float ah = -expf(a_log[h]);

  const T* xb = x + bi * x_sb + h * x_sh + p0;
  const float* dtb = dt + bi * dt_sb + h * dt_sh;
  const T* bb = b + bi * b_sb + g * b_sg;
  const T* cb_ = c + bi * c_sb + g * c_sg;
  T* yb = y + bi * y_sb + h * y_sh + p0;

  // this thread's y entries: (row yr + 8 k... ) = e / PS, column e % PS with
  // e = tid + THREADS k; the column is the same for every k
  const int ycol = tid % PS;
  const int yrow0 = tid / PS;
  constexpr int YSTEP = THREADS / PS;
  // this thread's state entries: row p = e / N, column n = e % N with
  // e = tid + THREADS k; n is the same for every k
  const int sn = tid % N;
  const int sp0 = tid / N;
  constexpr int SSTEP = THREADS / N;

  for (int i = tid; i < PS * NP; i += THREADS) s_st[i] = 0.f;

  const int n_chunks = S / Q;
  const int n_tiles = (Q + R - 1) / R;
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int t0 = ch * Q;
    __syncthreads();  // the previous chunk is done with every buffer
    for (int i = tid; i < MAX_Q; i += THREADS)
      s_dt[i] = i < Q ? dtb[(int64_t)(t0 + i) * dt_ss] : 0.f;
    for (int e = tid; e < n_tiles * R * PS; e += THREADS) {
      const int j = e / PS, p = e % PS;
      s_x[e] = j < Q ? to_f32(xb[(int64_t)(t0 + j) * x_ss + p]) : 0.f;
    }
    __syncthreads();

    if (tid < 32) chunk_cum(s_dt, ah, s_cum, tid);
    __syncthreads();
    const float seg = s_cum[Q - 1];
    for (int i = tid; i < MAX_Q; i += THREADS) {
      s_ecum[i] = expf(s_cum[i]);
      s_u[i] = i < Q ? s_dt[i] * expf(seg - s_cum[i]) : 0.f;
    }

    float sacc[SK];
#pragma unroll
    for (int k = 0; k < SK; ++k) sacc[k] = 0.f;

    for (int it = 0; it < n_tiles; ++it) {
      const int i0 = it * R;
      __syncthreads();  // the previous tile is done with C, B and W
      for (int e = tid; e < R * N; e += THREADS) {
        const int r = e / N, n = e % N, row = i0 + r;
        s_c[r * NP + n] = row < Q ? to_f32(cb_[(int64_t)(t0 + row) * c_ss + n]) : 0.f;
      }
      __syncthreads();

      // inter-chunk: exp(cum_i) C_i . S, from the state before this chunk
      float yinter[YK], yintra[YK];
#pragma unroll
      for (int k = 0; k < YK; ++k) {
        const int r = yrow0 + YSTEP * k;
        float acc = 0.f;
#pragma unroll 8
        for (int n = 0; n < N; ++n) acc = fmaf(s_c[r * NP + n], s_st[ycol * NP + n], acc);
        yinter[k] = acc * s_ecum[i0 + r];
        yintra[k] = 0.f;
      }

      for (int jt = 0; jt <= it; ++jt) {
        const int j0 = jt * R;
        __syncthreads();  // W and B of the previous tile are no longer read
        for (int e = tid; e < R * N; e += THREADS) {
          const int r = e / N, n = e % N, row = j0 + r;
          s_b[r * NP + n] = row < Q ? to_f32(bb[(int64_t)(t0 + row) * b_ss + n]) : 0.f;
        }
        __syncthreads();

        float cbt[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) cbt[i][j] = 0.f;
#pragma unroll 4
        for (int n = 0; n < N; ++n) {
          float ca[4], ba[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) ca[i] = s_c[(ty + 16 * i) * NP + n];
#pragma unroll
          for (int j = 0; j < 4; ++j) ba[j] = s_b[(tx + 16 * j) * NP + n];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) cbt[i][j] = fmaf(ca[i], ba[j], cbt[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int gi = i0 + ty + 16 * i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int gj = j0 + tx + 16 * j;
            // select, then exponentiate: never exp of a positive difference
            const float wv = (gj <= gi && gi < Q)
                                 ? cbt[i][j] * expf(s_cum[gi] - s_cum[gj]) * s_dt[gj]
                                 : 0.f;
            s_w[(ty + 16 * i) * WP + tx + 16 * j] = wv;
          }
        }
        __syncthreads();

#pragma unroll 8
        for (int kk = 0; kk < R; ++kk) {
          const float xv = s_x[(j0 + kk) * PS + ycol];
#pragma unroll
          for (int k = 0; k < YK; ++k)
            yintra[k] = fmaf(s_w[(yrow0 + YSTEP * k) * WP + kk], xv, yintra[k]);
        }

        if (jt == it) {
          // this chunk's share of the new state: x_j (B_j dt_j exp(seg - cum_j))
#pragma unroll 4
          for (int kk = 0; kk < R; ++kk) {
            const float bu = s_b[kk * NP + sn] * s_u[j0 + kk];
#pragma unroll
            for (int k = 0; k < SK; ++k) {
              const int p = sp0 + SSTEP * k;
              if (p < PS) sacc[k] = fmaf(s_x[(j0 + kk) * PS + p], bu, sacc[k]);
            }
          }
        }
      }

#pragma unroll
      for (int k = 0; k < YK; ++k) {
        const int row = i0 + yrow0 + YSTEP * k;
        if (row < Q) yb[(int64_t)(t0 + row) * y_ss + ycol] = from_f32<T>(yintra[k] + yinter[k]);
      }
    }

    __syncthreads();  // every row tile has read the old state
    const float eseg = expf(seg);
#pragma unroll
    for (int k = 0; k < SK; ++k) {
      const int p = sp0 + SSTEP * k;
      if (p < PS) s_st[p * NP + sn] = s_st[p * NP + sn] * eseg + sacc[k];
    }
  }

  __syncthreads();
  float* so = state_out + ((int64_t)bi * H + h) * P * N;
  for (int e = tid; e < PS * N; e += THREADS) {
    const int p = e / N, n = e % N;
    so[(int64_t)(p0 + p) * N + n] = s_st[p * NP + n];
  }
}

template <typename T, int N, int PS>
cudaError_t launch(const void* x, const float* dt, const float* a_log,
                   const void* b, const void* c, void* y, float* state,
                   int B, int H, int G, int S, int Q, int P,
                   const int64_t* st, cudaStream_t stream) {
  constexpr size_t smem = smem_floats<N, PS>() * sizeof(float);
  auto kernel = ssd_scan_kernel<T, N, PS>;
  // set on every launch: the attribute is per device, and the call is cheap
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(P / PS, H, B);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), dt, a_log, static_cast<const T*>(b),
      static_cast<const T*>(c), static_cast<T*>(y), state, H, G, S, Q, P,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9],
      st[10], st[11], st[12], st[13], st[14]);
  return cudaGetLastError();
}

template <typename T, int PS>
cudaError_t by_n(const void* x, const float* dt, const float* a_log, const void* b,
                 const void* c, void* y, float* state, int B, int H, int G,
                 int S, int Q, int P, int N, const int64_t* st,
                 cudaStream_t stream) {
  switch (N) {
    case 16: return launch<T, 16, PS>(x, dt, a_log, b, c, y, state, B, H, G, S, Q, P, st, stream);
    case 32: return launch<T, 32, PS>(x, dt, a_log, b, c, y, state, B, H, G, S, Q, P, st, stream);
    case 64: return launch<T, 64, PS>(x, dt, a_log, b, c, y, state, B, H, G, S, Q, P, st, stream);
    case 128: return launch<T, 128, PS>(x, dt, a_log, b, c, y, state, B, H, G, S, Q, P, st, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t by_p(const void* x, const float* dt, const float* a_log, const void* b,
                 const void* c, void* y, float* state, int B, int H, int G,
                 int S, int Q, int P, int N, const int64_t* st,
                 cudaStream_t stream) {
  switch (P) {
    case 8: return by_n<T, 8>(x, dt, a_log, b, c, y, state, B, H, G, S, Q, P, N, st, stream);
    case 16: return by_n<T, 16>(x, dt, a_log, b, c, y, state, B, H, G, S, Q, P, N, st, stream);
    case 32:
    case 64: return by_n<T, 32>(x, dt, a_log, b, c, y, state, B, H, G, S, Q, P, N, st, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// bf16: every product on wgmma (warpgroup tensor-core products, bf16 in,
// fp32 accumulators), tiles streamed through shared memory by cp.async in
// wgmma's 128-byte swizzled layout (hopper.cuh).
//
// Two blocks per (head, batch), 128 blocks for the main shape's 64 units,
// each of two warpgroups. A chunk's row tiles (64 rows each, T <= 4 of
// them) are dealt to the two blocks in balanced pairs: (0, 3) and (1, 2)
// at T 4, five (row tile, column tile) products each. Warpgroup 0 of a
// block computes y for its row tiles; warpgroup 1 carries the (P, N) state
// in its registers across chunks. Each block computes the whole state
// itself (the two blocks need it for their inter-chunk products, and
// sharing it would cost a cluster barrier per chunk); block 1 writes it
// out, and block 0, whose last row tile runs every column tile anyway,
// skips it in the last chunk.
//
// Per chunk: the next chunk's C tiles and dt, and each column tile j's B_j
// and X_j, load one step ahead through two-stage rings. At the chunk's
// start warp 0 scans cum; warpgroup 1 writes the state before the chunk to
// shared memory as bf16 high and low tiles (rows p, K-major over n), then
// scales its registers by exp(seg); warpgroup 0 starts y_i as
// exp(cum_i) (C_i S^T) (two products, hi and lo). Then for each column tile
// j: warpgroup 0, for each of its row tiles i >= j, forms S = C_i B_j^T
// (A and B K-major from shared memory), W = S exp(cum_i - cum_j) dt_j in
// registers and y_i += W X_j with W as a bf16 high and low pair from
// registers and X_j MN-major from shared memory; warpgroup 1 adds
// (x u)_j^T B_j, u = dt exp(seg - cum), with (x u)^T in three bf16 parts
// from registers (read transposed from the X_j tile) and B_j MN-major from
// shared memory. On the diagonal tile W's exponent is selected to -1e30
// above the diagonal (exp gives 0; a select, not a branch: branches around
// each exponential serialised them, 13 us of the first version's 49);
// below it the decay factors through the tile's last column m as
// exp(cum_i - cum_m) exp(cum_m - cum_j), both at most 1, 18 exponentials a
// thread instead of 32.
//
// Where the time goes (tools/ssd_variants.py's clock trace of one block at
// the main shape): each step is the y warpgroup's chain, S = C B^T (~1000
// cycles to its wait), W (700 to 2,600), W X (~450), then ~900 cycles of
// barrier and copy issue; the state warpgroup's work, though off that
// chain, costs ~9 us of the kernel's ~33 (without it, ~25). Tried on the
// card and dropped (PERF.md): three warpgroups (a y warpgroup per row tile;
// 168 registers, spills, no faster), two column tiles a step (spills,
// slower), issuing the next copies after the barrier, __expf decays and x u
// in two parts (no faster).
//
// P < 64 and N < 64 are padded with zero columns in shared memory: the
// products run at width 64 (and N 128) and only real columns are stored.
// ---------------------------------------------------------------------------
namespace tc {

struct Params {
  const bf16* x;
  const float* dt;
  const float* a_log;
  const bf16* b;
  const bf16* c;
  bf16* y;
  float* state;
  int H, G, S, Q, P;
  int64_t x_sb, x_sh, x_ss, dt_sb, dt_sh, dt_ss, b_sb, b_sg, b_ss, c_sb,
      c_sg, c_ss, y_sb, y_sh, y_ss;
};

// Byte offsets into the dynamic shared memory, for B, C and the state
// padded to NB columns; every tile starts on a 1024-byte boundary.
template <int NB>
struct Smem {
  static constexpr int TB = TILE * NB * 2;         // a 64-row tile of B, C or S
  static constexpr int XB = TILE * TILE * 2;       // a 64-row tile of X
  static constexpr int C = 0;                      // [buffer][slot] C tiles
  static constexpr int RING = C + 4 * TB;          // [stage] B_j, then X_j
  static constexpr int S = RING + 2 * (TB + XB);   // the state: hi, then lo
  static constexpr int F = S + 2 * TB;             // dt[2], cum, ecum, u
  static constexpr int BYTES = F + 5 * MAX_Q * (int)sizeof(float);
};

// Rows [r0, r0 + TILE) of a chunk (row stride ss, 16-byte aligned) into a
// tile of CH 16-byte chunks a row in gmma_off's layout, by the block's
// 2 NT threads; rows at or past lim and chunks at or past cv are zeros.
template <int CH>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* base,
                                          int64_t ss, int r0, int lim,
                                          int cv, int t) {
#pragma unroll
  for (int k = 0; k < TILE * CH / (2 * NT); ++k) {
    const int i = t + k * 2 * NT, r = i / CH, ch = i % CH;
    const int row = r0 + r;
    cp_async16(saddr(dst + gmma_off<TILE>(r, ch)),
               base + (int64_t)min(row, lim - 1) * ss + min(ch, cv - 1) * 8,
               row < lim && ch < cv);
  }
}

// The row tiles of a chunk of T tiles that block `half` of a head takes
// (-1: none), in balanced pairs.
__device__ __forceinline__ void my_tiles(int T, int half, int (&tiles)[2]) {
  if (half == 0) {
    tiles[0] = 0;
    tiles[1] = T >= 3 ? T - 1 : -1;
  } else {
    tiles[0] = T >= 2 ? 1 : -1;
    tiles[1] = T == 4 ? 2 : -1;
  }
}

// One warpgroup's part of the kernel: the y warpgroup (STATE false) or the
// state warpgroup (STATE true). Both run the same loop of loads and
// barriers; only the products differ.
template <int N, bool STATE>
__device__ __forceinline__ void ssd_role(const Params p) {
  constexpr int NB = N <= 64 ? 64 : 128;  // B, C and S columns in shared memory
  constexpr int NO = NB / 8;              // n-tiles of the state
  constexpr int KN = N / 16;              // k-steps over N
  using L = Smem<NB>;
  extern __shared__ __align__(1024) unsigned char tc_smem[];
  bf16* s_c = reinterpret_cast<bf16*>(tc_smem + L::C);
  bf16* s_ring = reinterpret_cast<bf16*>(tc_smem + L::RING);
  bf16* s_shi = reinterpret_cast<bf16*>(tc_smem + L::S);
  bf16* s_slo = s_shi + TILE * NB;
  float* s_dt = reinterpret_cast<float*>(tc_smem + L::F);  // [buffer][MAX_Q]
  float* s_cum = s_dt + 2 * MAX_Q;
  float* s_ecum = s_cum + MAX_Q;
  float* s_u = s_ecum + MAX_Q;

  const int tid = threadIdx.x;
  const int warp = (tid % NT) >> 5, lane = tid & 31;
  const int r0 = warp * 16 + (lane >> 2), cq = 2 * (lane & 3);
  const int half = blockIdx.x, h = blockIdx.y, bi = blockIdx.z;
  const int grp = h / (p.H / p.G);
  const int Q = p.Q, P = p.P;
  const int T = (Q + TILE - 1) / TILE;
  int tiles[2];
  my_tiles(T, half, tiles);
  const int last_tile = max(tiles[0], tiles[1]);
  // the block that writes the final state: block 1, which has the fewer
  // column tiles in the last chunk, unless block 0 takes a one-tile chunk
  const int writer = T >= 2 ? 1 : 0;
  const float ah = -expf(p.a_log[h]);
  const bf16* xb = p.x + bi * p.x_sb + h * p.x_sh;
  const float* dtb = p.dt + bi * p.dt_sb + h * p.dt_sh;
  const bf16* bb = p.b + bi * p.b_sb + grp * p.b_sg;
  const bf16* cb = p.c + bi * p.c_sb + grp * p.c_sg;
  const int nch = p.S / Q;

  auto load_header = [&](int ch, int buf) {  // C tiles and dt of chunk ch
    const int64_t t0 = (int64_t)ch * Q;
#pragma unroll
    for (int k = 0; k < 2; ++k)
      if (tiles[k] >= 0)
        load_rows<NB / 8>(s_c + (buf * 2 + k) * TILE * NB,
                          cb + t0 * p.c_ss, p.c_ss, tiles[k] * TILE, Q,
                          N / 8, tid);
    static_assert(2 * NT == MAX_Q, "one dt a thread");
    const int i = tid;
    cp_async4(saddr(s_dt + buf * MAX_Q + i),
              dtb + (t0 + min(i, Q - 1)) * p.dt_ss, i < Q);
  };
  auto load_step = [&](int ch, int j, int stage) {  // B_j and X_j
    const int64_t t0 = (int64_t)ch * Q;
    bf16* dst = s_ring + stage * (TILE * NB + TILE * TILE);
    load_rows<NB / 8>(dst, bb + t0 * p.b_ss, p.b_ss, j * TILE, Q, N / 8,
                      tid);
    load_rows<TILE / 8>(dst + TILE * NB, xb + t0 * p.x_ss, p.x_ss,
                        j * TILE, Q, P / 8, tid);
  };

  // the state (rows p, columns n) in the state warpgroup; y of the two row
  // tiles (rows, columns p) in the y warpgroup
  float sa[STATE ? 4 * NO : 1];
  float ya[STATE ? 1 : 2][32];
  if constexpr (STATE) {
#pragma unroll
    for (int i = 0; i < 4 * NO; ++i) sa[i] = 0.f;
  }

  load_header(0, 0);
  load_step(0, 0, 0);
  cp_commit();
  int stage = 0;
  for (int ch = 0; ch < nch; ++ch) {
    const bool need_state = ch + 1 < nch || half == writer;
    const int steps = need_state ? T : last_tile + 1;
    const int hb = ch & 1;
    const bf16* sc = s_c + hb * 2 * TILE * NB;
    const float* sdt = s_dt + hb * MAX_Q;
    for (int j = 0; j < steps; ++j, stage ^= 1) {
      // the next step's tiles (at a chunk's last step, the next chunk's
      // first tiles, C tiles and dt) load while this step runs
      if (j + 1 < steps) {
        load_step(ch, j + 1, stage ^ 1);
        cp_commit();
        cp_wait<1>();
      } else if (ch + 1 < nch) {
        load_header(ch + 1, hb ^ 1);
        load_step(ch + 1, 0, stage ^ 1);
        cp_commit();
        cp_wait<1>();
      } else {
        cp_wait<0>();
      }
      fence_proxy_async();
      __syncthreads();

      if (j == 0) {  // the chunk's decays, the state before it, y's start
        if (!STATE && warp == 0) chunk_cum(sdt, ah, s_cum, lane);
        __syncthreads();
        const float seg = s_cum[Q - 1];
        for (int i = tid; i < MAX_Q; i += 2 * NT) {
          s_ecum[i] = expf(s_cum[i]);
          s_u[i] = i < Q ? sdt[i] * expf(seg - s_cum[i]) : 0.f;
        }
        if constexpr (STATE) {
          if (ch > 0) {
#pragma unroll
            for (int n = 0; n < NO; ++n)
#pragma unroll
              for (int e2 = 0; e2 < 2; ++e2) {
                uint32_t hi, lo;
                split(sa[4 * n + 2 * e2], sa[4 * n + 2 * e2 + 1], hi, lo);
                const int off = gmma_off<TILE>(r0 + 8 * e2, n) + cq;
                *reinterpret_cast<uint32_t*>(s_shi + off) = hi;
                *reinterpret_cast<uint32_t*>(s_slo + off) = lo;
              }
            fence_proxy_async();
          }
          if (need_state) {
            const float es = expf(seg);
#pragma unroll
            for (int i = 0; i < 4 * NO; ++i) sa[i] *= es;
          }
        }
        __syncthreads();
        if constexpr (!STATE) {
          // y_i = exp(cum_i) (C_i S^T), from the state before this chunk
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            float(&y)[32] = ya[k];
            if (tiles[k] < 0) continue;
            if (ch == 0) {
#pragma unroll
              for (int i = 0; i < 32; ++i) y[i] = 0.f;
              continue;
            }
            const bf16* ci = sc + k * TILE * NB;
            gmma_fence();
#pragma unroll
            for (int kk = 0; kk < KN; ++kk)
              wgmma_ss_n64(y, gmma_k_major(ci, kk), gmma_k_major(s_shi, kk),
                           kk > 0);
#pragma unroll
            for (int kk = 0; kk < KN; ++kk)
              wgmma_ss_n64(y, gmma_k_major(ci, kk), gmma_k_major(s_slo, kk),
                           1);
            gmma_commit();
            gmma_wait();
            fence_regs(y);
            const float e0 = s_ecum[tiles[k] * TILE + r0];
            const float e1 = s_ecum[tiles[k] * TILE + r0 + 8];
#pragma unroll
            for (int i = 0; i < 32; ++i) y[i] *= (i & 2) ? e1 : e0;
          }
        }
      }

      const bf16* sb = s_ring + stage * (TILE * NB + TILE * TILE);
      const bf16* sx = sb + TILE * NB;
      if constexpr (!STATE) {
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int it = tiles[k];
          if (it < j) continue;  // above the diagonal, or no tile
          float(&y)[32] = ya[k];
          const bf16* ci = sc + k * TILE * NB;
          float s[32];  // s[4 n + e]: C_i B_j^T
          gmma_fence();
#pragma unroll
          for (int kk = 0; kk < KN; ++kk)
            wgmma_ss_n64(s, gmma_k_major(ci, kk), gmma_k_major(sb, kk),
                         kk > 0);
          gmma_commit();
          gmma_wait();
          fence_regs(s);
          // W = S exp(cum_i - cum_j) dt_j, as bf16 high and low parts: the
          // C layout of n-tiles 2 m, 2 m + 1 is the A layout of k-step m
          const bool diag = it == j;
          const int gi0 = it * TILE + r0;
          const float ci0 = s_cum[gi0], ci1 = s_cum[gi0 + 8];
          uint32_t whi[4][4], wlo[4][4];
          auto put = [&](int n, float w0, float w1, float w2, float w3) {
            split(w0, w1, whi[n >> 1][2 * (n & 1)], wlo[n >> 1][2 * (n & 1)]);
            split(w2, w3, whi[n >> 1][2 * (n & 1) + 1],
                  wlo[n >> 1][2 * (n & 1) + 1]);
          };
          if (diag) {
#pragma unroll
            for (int n = 0; n < 8; ++n) {
              const int gj = j * TILE + 8 * n + cq;
              const float c0 = s_cum[gj], c1 = s_cum[gj + 1];
              const float d0 = sdt[gj], d1 = sdt[gj + 1];
              put(n, s[4 * n] * expf(gj > gi0 ? -1e30f : ci0 - c0) * d0,
                  s[4 * n + 1] * expf(gj + 1 > gi0 ? -1e30f : ci0 - c1) * d1,
                  s[4 * n + 2] * expf(gj > gi0 + 8 ? -1e30f : ci1 - c0) * d0,
                  s[4 * n + 3] * expf(gj + 1 > gi0 + 8 ? -1e30f : ci1 - c1)
                      * d1);
            }
          } else {
            const float cm = s_cum[j * TILE + TILE - 1];
            const float rf0 = expf(ci0 - cm), rf1 = expf(ci1 - cm);
#pragma unroll
            for (int n = 0; n < 8; ++n) {
              const int gj = j * TILE + 8 * n + cq;
              const float f0 = expf(cm - s_cum[gj]) * sdt[gj];
              const float f1 = expf(cm - s_cum[gj + 1]) * sdt[gj + 1];
              put(n, s[4 * n] * rf0 * f0, s[4 * n + 1] * rf0 * f1,
                  s[4 * n + 2] * rf1 * f0, s[4 * n + 3] * rf1 * f1);
            }
          }
          gmma_fence();
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            wgmma_rs_n64(y, whi[m], gmma_mn_major(sx, m));
            wgmma_rs_n64(y, wlo[m], gmma_mn_major(sx, m));
          }
          gmma_commit();
          gmma_wait();
          fence_regs(y);
          if (diag) {  // the row tile is complete
#pragma unroll
            for (int e2 = 0; e2 < 2; ++e2) {
              const int row = gi0 + 8 * e2;
              if (row >= Q) continue;
              bf16* yr = p.y + bi * p.y_sb + h * p.y_sh
                         + ((int64_t)ch * Q + row) * p.y_ss;
#pragma unroll
              for (int n = 0; n < 8; ++n)
                if (8 * n + cq < P)
                  *reinterpret_cast<__nv_bfloat162*>(yr + 8 * n + cq) =
                      __floats2bfloat162_rn(y[4 * n + 2 * e2],
                                            y[4 * n + 2 * e2 + 1]);
            }
          }
        }
      } else if (need_state) {
        // S += (x u)_j^T B_j: A (rows p, k-step m over the tile's rows)
        // read transposed from X_j, times u, in three bf16 parts
        uint32_t xa[4][3][4];
#pragma unroll
        for (int m = 0; m < 4; ++m)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int pp = r0 + 8 * (r & 1), jl = 16 * m + cq + 8 * (r >> 1);
            const int pc = pp >> 3, pe = pp & 7;
            const float v0 = __bfloat162float(sx[gmma_off<TILE>(jl, pc) + pe])
                             * s_u[j * TILE + jl];
            const float v1 =
                __bfloat162float(sx[gmma_off<TILE>(jl + 1, pc) + pe])
                * s_u[j * TILE + jl + 1];
            split3(v0, v1, xa[m][0][r], xa[m][1][r], xa[m][2][r]);
          }
        gmma_fence();
#pragma unroll
        for (int m = 0; m < 4; ++m)
#pragma unroll
          for (int part = 0; part < 3; ++part) {
            if constexpr (NB == 128)
              wgmma_rs_n128(sa, xa[m][part], gmma_mn_major(sb, m));
            else
              wgmma_rs_n64(sa, xa[m][part], gmma_mn_major(sb, m));
          }
        gmma_commit();
        gmma_wait();
        fence_regs(sa);
      }
      __syncthreads();  // this stage is refilled on the next step
    }
  }

  if constexpr (STATE) {
    if (half != writer) return;
    float* so = p.state + ((int64_t)bi * p.H + h) * P * N;
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        const int row = r0 + 8 * e2, col = 8 * n + cq;
        if (row < P && col < N)
          *reinterpret_cast<float2*>(so + row * N + col) =
              make_float2(sa[4 * n + 2 * e2], sa[4 * n + 2 * e2 + 1]);
      }
  }
}

template <int N>
__global__ void __launch_bounds__(2 * NT, 1) ssd_scan_bf16(const Params p) {
  int tiles[2];
  my_tiles((p.Q + TILE - 1) / TILE, blockIdx.x, tiles);
  if (tiles[0] < 0) return;  // a one-tile chunk: block 0 takes it all
  if (threadIdx.x < NT)
    ssd_role<N, false>(p);
  else
    ssd_role<N, true>(p);
}

template <int N>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  constexpr size_t smem = Smem<N <= 64 ? 64 : 128>::BYTES;
  auto kernel = ssd_scan_bf16<N>;
  // set on every launch: the attribute is per device, and the call is cheap
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(2, p.H, B), 2 * NT, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

// x (B, H, S, P), b and c (B, G, S, N) in dtype (0 fp32, 1 bf16), unit
// stride on P and N; dt (B, H, S) fp32; a_log (H,) fp32, contiguous (a =
// -exp(a_log) is formed here); y (B, H, S, P) in x's dtype, unit stride on
// P, written here; state (B, H, P, N) fp32, contiguous, written here. strides holds
// the (batch, head or group, sequence) strides, in elements, of x, dt, b,
// c, y in that order (15 values). Q divides S and is at most 256; P is 8,
// 16, 32 or 64 and N 16, 32, 64 or 128. In bf16 every row of x, b and c
// must start on a 16-byte boundary. Returns a cudaError_t.
extern "C" int ssd_scan_fwd(const void* x, const float* dt, const float* a_log,
                            const void* b, const void* c, void* y,
                            float* state, int dtype, int B, int H, int G,
                            int S, int Q, int P, int N,
                            const int64_t* strides, void* stream) {
  if (B <= 0 || H <= 0 || G <= 0 || H % G != 0 || S <= 0 || Q <= 0 ||
      Q > MAX_Q || S % Q != 0 || H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)by_p<float>(x, dt, a_log, b, c, y, state, B, H, G, S, Q, P, N, strides, st);
  if (dtype != 1 || !(P == 8 || P == 16 || P == 32 || P == 64)) return (int)cudaErrorInvalidValue;
  const int64_t* s = strides;
  if (!(tc::rows_aligned(x, s[0], s[1], s[2]) && tc::rows_aligned(b, s[6], s[7], s[8])
        && tc::rows_aligned(c, s[9], s[10], s[11])))
    return (int)cudaErrorInvalidValue;
  const tc::Params p{static_cast<const tc::bf16*>(x), dt, a_log, static_cast<const tc::bf16*>(b),
                     static_cast<const tc::bf16*>(c), static_cast<tc::bf16*>(y), state, H, G,
                     S, Q, P, s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], s[9],
                     s[10], s[11], s[12], s[13], s[14]};
  switch (N) {
    case 16: return (int)tc::launch<16>(p, B, st);
    case 32: return (int)tc::launch<32>(p, B, st);
    case 64: return (int)tc::launch<64>(p, B, st);
    case 128: return (int)tc::launch<128>(p, B, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
