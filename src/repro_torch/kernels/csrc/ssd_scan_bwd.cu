// Mamba-2 SSD chunk scan, backward (K4-bwd), for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package differentiates its plain
// ssd_chunked (src/repro/models/ssm.py:51) and has no Pallas backward. It
// was added so that the port trains the SSM family on the card: the
// gradients of K4's (y, final state) with respect to x, dt, a_log, B and C,
// given dy and the final state's gradient. kernels/ssd_scan.py::
// ssd_scan_bwd_ref is its spec; every step below is a step there.
//
// Per (batch, head) and chunk of Q tokens, with a = -exp(a_log), cum the
// chunk's cumsum of dt a (fp64, rounded once to fp32, as the forward),
// seg = cum_{Q-1}, L_ij = exp(cum_i - cum_j) for j <= i, u_j = dt_j
// exp(seg - cum_j), S_prev the fp32 (P, N) state entering the chunk and dS
// the gradient of the state leaving it:
//   dS_prev = exp(seg) dS + sum_i exp(cum_i) dy_i c_i^T
//   W = (C B^T) . L . dt_j,  dCB = (dY X^T) . L . dt_j,  K = (C B^T) . L . (dY X^T)
//   dx = W^T dY + u . (B dS^T)             dc = dCB B + exp(cum) . (dY S_prev)
//   db = dCB^T C + u . (X dS)              ddt = colsum(K) + exp(seg - cum) . x.(dS b)
//   dcum_i = rowsum(K dt)_i - colsum(K dt)_i + exp(cum_i) dy_i . (S_prev c_i),
//            and at i = Q-1 also exp(seg) <dS, S_prev>; the row and column
//            sums leave out K's diagonal, which enters both and cancels
//   r_j = u_j x_j . (dS b_j)  (from dcum_j to dcum_{Q-1})
//   d(dt a)_t = sum_{i >= t} dcum_i + sum_{j < t} r_j,
//   ddt += a d(dt a),  da_log = a sum_{b, t} dt_t d(dt a)_t.
// The two rearrangements are exact; they keep d(dt a) from cancelling
// large terms (with strong decays the diagonal dominates). dcum's row and
// column sums and every sum after them are fp64, rounded once to fp32 (the
// bf16 route sums each tile's pieces in fp32 first: a thread's 16 terms,
// a warp's 16 rows; at the training microbatch tools/ssd_bwd_variants.py
// measured da_log 0.32 of its gate (1e-5) from the spec with them, 0.09
// with every term in fp64, which cost ~0.02 ms more).
// db and dc are summed over the H / G heads of each group.
//
// Two routes, chosen by dtype (each dtype has one; neither falls back), as
// K4's (csrc/ssd_scan.cu):
//   bf16 -> the tensor cores (namespace tc below): the training path's;
//   fp32 -> the CUDA cores (fmaf), the first design, unchanged: kept for
//           the fp32 references that hold the card to the CPU within 1e-5.
// Both: no atomics, every sum in a fixed order (the same inputs give the
// same bits on every call).
//
// The fp32 route, three launches:
//   1. sweep: one block per (P-slice, head, batch, direction) runs the
//      chunks forward to recompute the state entering each chunk (the
//      forward saves none), or in reverse from d_final for the dS leaving
//      each; both into fp32 workspaces (B, H, n_chunks, P, N).
//   2. chunk: one block per (chunk, head, batch), 256 threads, on the CUDA
//      cores in fp32 (fmaf). For each 64-row column tile j of the chunk it
//      keeps dx_j and db_j in registers, adds the state terms, then runs
//      every row tile i >= j: the 64 x 64 tiles C_i B_j^T and dY_i X_j^T,
//      then W, dCB and K in shared memory (the causal mask selected before
//      the exponential: for j > i, cum_i - cum_j > 0 and exp may be inf,
//      and inf * 0 is NaN), then dx_j += W^T dY_i, db_j += dCB^T C_i and
//      dc_i += dCB B_j (dc_i in a per-head fp32 workspace, which only this
//      block touches), and K's row and column sums into dcum and ddt. Then
//      one warp scans dcum in reverse in fp64 and writes ddt and the
//      chunk's share of da_log (fp64).
//   3. reduce: db and dc summed over each group's heads in head order and
//      rounded once to b's dtype; da_log summed over (batch, chunk).
// The bf16 route (four launches: sweep, dx/db pass, dc pass, the same
// reduce) is described at namespace tc.
//
// What bounds it on this card: at the mamba2-1.3b training microbatch (B 8,
// S 512, H 64, P 64, N 128, G 1, Q 256, bf16) the function reads x, dy,
// dt, B, C, a_log and writes dx, ddt, da_log, dB, dC: 107.0 MB, 0.0319 ms
// at 3.35 TB/s. Its products (per (batch, head, chunk): C B^T, dY X^T,
// W^T dY, dCB B and dCB^T C over the causal triangle, and the state
// recompute, dS sweep, dY S_prev, B dS^T and X dS in full) are 56.0 GFLOP:
// 0.0566 ms at the bf16 tensor-core peak, 0.836 ms at the fp32 CUDA-core
// peak (67 TFLOP/s). So it is bound by its arithmetic. The fp32 route runs
// every product on the CUDA cores (a 4 x 4 or 4 x 8 register tile a
// thread, ~12 shared-memory loads for 32 fmaf). The bf16 route runs them
// on wgmma; with the bf16 parts of its fp32 operands and the 64-row tiles
// its tensor work is ~110 GFLOP, ~0.11 ms at the peak.
//
// Measured by tools/kernel_times.py on one NVIDIA H100 80GB HBM3, 700.00 W
// (ms, with the wrapper, by kernel): bf16 at the training microbatch
// 0.642 (sweep 0.074, dx/db pass 0.303, dc pass 0.237, reduce 0.028),
// against 4.924 for the first design (its sweep 0.662, chunk 4.164,
// reduce 0.098) in the same call. What holds it (tools/ssd_bwd_variants.py
// trace, one dx/db block): waiting for tiles, ~55% of its time (the dS
// parts, 48 KB, are copied anew for every (column tile, head): the ring
// takes their shared memory during the products), the elementwise step
// between the products ~19%, the products themselves ~25%. The fp32
// route 1.243 at B 2. ptxas, bf16 at N 128: the sweep 255 registers, no
// spills, 99 KB of shared memory; the dx/db pass 255 registers, 232 bytes
// spilled, 92 KB; the dc pass 255 registers, 4 bytes spilled, 88 KB (two
// blocks an SM each). fp32 at N 128, P 64: the chunk kernel 209
// registers, no spills, 194 KB (one block an SM); its sweep 99.
//
// Any chunk Q <= 256 that divides S, not only a power of two (rows past Q
// are masked: x, dy, B, C read as 0 there, dt as 0); P 8, 16, 32 or 64 and
// N 16, 32, 64 or 128 (the fp32 route pads P < 16 to 16, the bf16 route P
// to 64 and N to 64 or 128, with zero columns in shared memory). x, dy, B,
// C are bf16 or fp32, dt and a_log fp32; tensors are addressed through
// (batch, head-or-group, sequence) strides in elements with a unit stride
// on P and N. The fp32 route reads them elementwise (no alignment rule);
// the bf16 route copies rows 16 bytes at a time, so every row of x, dy, B
// and C starts on a 16-byte boundary (checked here; ops._SSDScan.backward
// copies a dy that is not).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_Q = 256;  // longest chunk
constexpr int R = 64;       // rows (and columns) of a tile
constexpr int SCAN_PER_LANE = MAX_Q / 32;
constexpr unsigned FULL = 0xffffffffu;

struct Args {
  const void* x;
  const float* dt;
  const float* a_log;
  const void* b;
  const void* c;
  const void* dy;
  const float* d_final;  // nullptr: zero
  void* dx;
  float* ddt;
  float* da_log;
  void* db;
  void* dc;
  // the state entering each chunk and dS of the state leaving it: (B, H,
  // n_chunks, P, N) fp32, or (bf16 route) three bf16 part tiles a chunk
  float* ws_s;
  float* ws_ds;
  float* ws_db;   // (B, H, S, N): db per head
  float* ws_dc;   // (B, H, S, N): dc per head
  double* ws_da;  // (B, H, n_chunks): each chunk's sum of dt d(dt a)
  float* ws_r;    // bf16 route: (B, H, S): r_j = u_j x_j . (dS b_j)
  double* ws_dA;  // bf16 route: (B, H, S): dcum's row and column sums of K dt
  int B, H, G, S, Q, P, N, bf16;
  int hw;         // heads a block walks (bf16 route; 1 on the fp32 route)
  int64_t x_sb, x_sh, x_ss, dt_sb, dt_sh, dt_ss, b_sb, b_sg, b_ss, c_sb,
      c_sg, c_ss, dy_sb, dy_sh, dy_ss, dx_sb, dx_sh, dx_ss, ddt_sb, ddt_sh,
      ddt_ss, db_sb, db_sg, db_ss, dc_sb, dc_sg, dc_ss;
};

__device__ __forceinline__ float ldv(const void* p, int64_t i, bool bf) {
  return bf ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
            : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void stv(void* p, int64_t i, float v, bool bf) {
  if (bf)
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
  else
    static_cast<float*>(p)[i] = v;
}

// cum = cumsum(dt * a) over one chunk in fp64, rounded once to fp32, by the
// 32 lanes of one warp, exactly as the forward (csrc/ssd_scan.cu) sums it.
// s_dt holds 0 past the chunk's end, so those entries of s_cum hold seg.
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
    const double up = __shfl_up_sync(FULL, incl, off);
    if (lane >= off) incl += up;
  }
  const double excl = incl - run;
#pragma unroll
  for (int k = 0; k < SCAN_PER_LANE; ++k)
    s_cum[lane * SCAN_PER_LANE + k] = (float)(excl + part[k]);
}

// the sum over the 16 lanes of a half warp (tx = lane % 16), in every lane
__device__ __forceinline__ float sum16(float v) {
#pragma unroll
  for (int off = 8; off >= 1; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

// acc[a][c] += sum_{k < K} A(ty + 16 a, k) B(k, tx + 16 c): a 64 x 16 NC
// product, thread (ty, tx) of 16 x 16 holding rows ty + 16 a and columns
// tx + 16 c. A and B read shared memory.
template <int K, int NC, typename FA, typename FB>
__device__ __forceinline__ void mm(float (&acc)[4][NC], int ty, int tx,
                                   FA A, FB B) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float av[4], bv[NC];
#pragma unroll
    for (int a = 0; a < 4; ++a) av[a] = A(ty + 16 * a, k);
#pragma unroll
    for (int c = 0; c < NC; ++c) bv[c] = B(k, tx + 16 * c);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[a][c] = fmaf(av[a], bv[c], acc[a][c]);
  }
}

template <int NC>
__device__ __forceinline__ void zero(float (&acc)[4][NC]) {
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[a][c] = 0.f;
}

// Rows [r0, r0 + R) of a chunk (row stride ss, base offset o) into a
// shared tile of R rows of `ld` floats: columns < cols from memory, columns
// in [cols, width) and rows at or past lim as zeros.
__device__ __forceinline__ void load_tile(float* dst, int ld, int width,
                                          const void* src, int64_t o,
                                          int64_t ss, int r0, int lim,
                                          int cols, bool bf, int tid) {
  for (int e = tid; e < R * width; e += THREADS) {
    const int r = e / width, col = e % width, row = r0 + r;
    dst[r * ld + col] =
        (row < lim && col < cols) ? ldv(src, o + row * ss + col, bf) : 0.f;
  }
}

// ---------------------------------------------------------------------------
// 1. sweep: the state entering each chunk (z < B), or dS leaving it (z >= B)
// ---------------------------------------------------------------------------
template <int N, int PS>
constexpr int sweep_floats() {
  return 3 * MAX_Q + R * PS + R * N;
}

template <int N, int PS>
__global__ void __launch_bounds__(THREADS) ssd_bwd_sweep(const Args p) {
  constexpr int SSTEP = THREADS / N;
  constexpr int SK = (PS * N + THREADS - 1) / THREADS;
  extern __shared__ float smem[];
  float* s_dt = smem;
  float* s_cum = s_dt + MAX_Q;
  float* s_w = s_cum + MAX_Q;
  float* s_v = s_w + MAX_Q;  // R x PS: x (forward) or dy (reverse)
  float* s_e = s_v + R * PS;  // R x N: B (forward) or C (reverse)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int p0 = blockIdx.x * PS, h = blockIdx.y;
  const bool back = (int)blockIdx.z >= p.B;
  const int bi = back ? blockIdx.z - p.B : blockIdx.z;
  const int H = p.H, Q = p.Q, P = p.P, nch = p.S / p.Q;
  const int g = h / (H / p.G);
  const float ah = -expf(p.a_log[h]);
  const bool bf = p.bf16 != 0;
  const void* vsrc = back ? p.dy : p.x;
  const int64_t vo = back ? bi * p.dy_sb + h * p.dy_sh + p0
                          : bi * p.x_sb + h * p.x_sh + p0;
  const int64_t vss = back ? p.dy_ss : p.x_ss;
  const void* esrc = back ? p.c : p.b;
  const int64_t eo = back ? bi * p.c_sb + g * p.c_sg : bi * p.b_sb + g * p.b_sg;
  const int64_t ess = back ? p.c_ss : p.b_ss;
  const int64_t dto = bi * p.dt_sb + h * p.dt_sh;
  float* ws = (back ? p.ws_ds : p.ws_s) + ((int64_t)bi * H + h) * nch * P * N;

  const int sn = tid % N, sp0 = tid / N;
  float z[SK];
#pragma unroll
  for (int k = 0; k < SK; ++k) {
    const int pp = sp0 + SSTEP * k;
    z[k] = (back && p.d_final != nullptr && pp < PS)
               ? p.d_final[(((int64_t)bi * H + h) * P + p0 + pp) * N + sn]
               : 0.f;
  }
  for (int step = 0; step < nch; ++step) {
    const int ch = back ? nch - 1 - step : step;
    const int64_t t0 = (int64_t)ch * Q;
    float* dst = ws + (int64_t)ch * P * N;
#pragma unroll
    for (int k = 0; k < SK; ++k) {
      const int pp = sp0 + SSTEP * k;
      if (pp < PS) dst[(int64_t)(p0 + pp) * N + sn] = z[k];
    }
    if (step + 1 == nch) break;  // the last chunk visited updates nothing
    __syncthreads();             // the previous chunk is done with s_dt, s_w
    for (int i = tid; i < MAX_Q; i += THREADS)
      s_dt[i] = i < Q ? p.dt[dto + (t0 + i) * p.dt_ss] : 0.f;
    __syncthreads();
    if (warp == 0) chunk_cum(s_dt, ah, s_cum, lane);
    __syncthreads();
    const float seg = s_cum[Q - 1];
    for (int i = tid; i < MAX_Q; i += THREADS)
      s_w[i] = i < Q ? (back ? expf(s_cum[i]) : s_dt[i] * expf(seg - s_cum[i]))
                     : 0.f;
    float acc[SK];
#pragma unroll
    for (int k = 0; k < SK; ++k) acc[k] = 0.f;
    for (int i0 = 0; i0 < Q; i0 += R) {
      __syncthreads();  // s_w is written; the previous tile is read
      load_tile(s_v, PS, PS, vsrc, vo + t0 * vss, vss, i0, Q, PS, bf, tid);
      load_tile(s_e, N, N, esrc, eo + t0 * ess, ess, i0, Q, N, bf, tid);
      __syncthreads();
#pragma unroll 4
      for (int r = 0; r < R; ++r) {
        const float we = s_w[i0 + r] * s_e[r * N + sn];
#pragma unroll
        for (int k = 0; k < SK; ++k) {
          const int pp = sp0 + SSTEP * k;
          if (pp < PS) acc[k] = fmaf(s_v[r * PS + pp], we, acc[k]);
        }
      }
    }
    const float es = expf(seg);
#pragma unroll
    for (int k = 0; k < SK; ++k) z[k] = z[k] * es + acc[k];
  }
}

// ---------------------------------------------------------------------------
// 2. chunk: every gradient of one (chunk, head, batch)
// ---------------------------------------------------------------------------
template <int N, int P>
struct ChunkSmem {
  static constexpr int PP = P < 16 ? 16 : P;  // x and dy columns, padded
  static constexpr int NP = N + 1;            // padded rows of B, C, S, dS
  static constexpr int XP = PP + 1;           // padded rows of x, dy
  static constexpr int WP = R + 1;            // padded rows of W, dCB, K
  // per-row arrays (two of them fp64) and a reduction
  static constexpr int ROWS = 11 * MAX_Q + 32;
  static constexpr int DS = ROWS;              // dS, PP x NP
  // S_prev (phase 1) shares its space with W and dCB (phase 2)
  static constexpr int U = DS + PP * NP;
  static constexpr int USIZE = P * NP > 2 * R * WP ? P * NP : 2 * R * WP;
  static constexpr int K = U + USIZE;          // K, R x WP
  static constexpr int C = K + R * WP;         // a row tile of C, R x NP
  static constexpr int B = C + R * NP;         // a column tile of B
  static constexpr int Y = B + R * NP;         // a row tile of dy, R x XP
  static constexpr int X = Y + R * XP;         // a column tile of x
  static constexpr int FLOATS = X + R * XP;
};

template <int N, int P>
__global__ void __launch_bounds__(THREADS, 1) ssd_bwd_chunk(const Args p) {
  using L = ChunkSmem<N, P>;
  constexpr int PP = L::PP, NP = L::NP, XP = L::XP, WP = L::WP;
  constexpr int CN = N / 16, CP = PP / 16;
  extern __shared__ float smem[];
  double* s_dcum = reinterpret_cast<double*>(smem);  // row sums, inter term
  double* s_dcol = s_dcum + MAX_Q;                    // minus column sums
  float* s_dt = smem + 4 * MAX_Q;
  float* s_cum = s_dt + MAX_Q;
  float* s_ecum = s_cum + MAX_Q;   // exp(cum)
  float* s_dec = s_ecum + MAX_Q;   // exp(seg - cum), 0 past Q
  float* s_u = s_dec + MAX_Q;      // dt exp(seg - cum)
  float* s_ddt = s_u + MAX_Q;      // ddt: the direct terms
  float* s_r = s_ddt + MAX_Q;      // u_j x_j . (dS b_j)
  float* s_red = s_r + MAX_Q;      // 32: a block reduction
  float* s_ds = smem + L::DS;
  float* s_sp = smem + L::U;
  float* s_w = smem + L::U;
  float* s_g = s_w + R * WP;
  float* s_k = smem + L::K;
  float* s_c = smem + L::C;
  float* s_b = smem + L::B;
  float* s_y = smem + L::Y;
  float* s_x = smem + L::X;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx = tid & 15, ty = tid >> 4;
  const int ch = blockIdx.x, h = blockIdx.y, bi = blockIdx.z;
  const int H = p.H, S = p.S, Q = p.Q, nch = S / Q;
  const int g = h / (H / p.G);
  const bool bf = p.bf16 != 0;
  const int64_t t0 = (int64_t)ch * Q;
  const float ah = -expf(p.a_log[h]);
  const int64_t xo = bi * p.x_sb + h * p.x_sh + t0 * p.x_ss;
  const int64_t dyo = bi * p.dy_sb + h * p.dy_sh + t0 * p.dy_ss;
  const int64_t bo = bi * p.b_sb + g * p.b_sg + t0 * p.b_ss;
  const int64_t co = bi * p.c_sb + g * p.c_sg + t0 * p.c_ss;
  const int64_t dto = bi * p.dt_sb + h * p.dt_sh + t0 * p.dt_ss;
  const int64_t dxo = bi * p.dx_sb + h * p.dx_sh + t0 * p.dx_ss;
  const int64_t ddto = bi * p.ddt_sb + h * p.ddt_sh + t0 * p.ddt_ss;
  const int64_t unit = (((int64_t)bi * H + h) * nch + ch) * P * N;
  const float* sp_g = p.ws_s + unit;
  const float* ds_g = p.ws_ds + unit;
  float* dc_g = p.ws_dc + (((int64_t)bi * H + h) * S + t0) * N;
  float* db_g = p.ws_db + (((int64_t)bi * H + h) * S + t0) * N;

  // ---- phase 0: the chunk's decays, S_prev, dS, <dS, S_prev> ----
  for (int i = tid; i < MAX_Q; i += THREADS) {
    s_dt[i] = i < Q ? p.dt[dto + i * p.dt_ss] : 0.f;
    s_dcum[i] = 0.0;
    s_dcol[i] = 0.0;
    s_ddt[i] = 0.f;
    s_r[i] = 0.f;
  }
  for (int e = tid; e < PP * N; e += THREADS) {
    const int r = e / N, n = e % N;
    s_ds[r * NP + n] = r < P ? ds_g[r * N + n] : 0.f;
    if (r < P) s_sp[r * NP + n] = sp_g[r * N + n];
  }
  __syncthreads();
  if (warp == 0) chunk_cum(s_dt, ah, s_cum, lane);
  float dot = 0.f;
  for (int e = tid; e < P * N; e += THREADS) {
    const int r = e / N, n = e % N;
    dot = fmaf(s_ds[r * NP + n], s_sp[r * NP + n], dot);
  }
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1) dot += __shfl_xor_sync(FULL, dot, off);
  if (lane == 0) s_red[warp] = dot;
  __syncthreads();  // cum and the warps' partial dots are ready
  dot = 0.f;
#pragma unroll
  for (int w = 0; w < THREADS / 32; ++w) dot += s_red[w];
  const float seg = s_cum[Q - 1];
  for (int i = tid; i < MAX_Q; i += THREADS) {
    s_ecum[i] = expf(s_cum[i]);
    const float d = i < Q ? expf(seg - s_cum[i]) : 0.f;
    s_dec[i] = d;
    s_u[i] = s_dt[i] * d;
  }
  const int T = (Q + R - 1) / R;

  // ---- phase 1: the inter-chunk terms, row tile by row tile ----
  // dc_i = exp(cum_i) dy_i S_prev (the per-head partial starts here);
  // dcum_i += dc_i . c_i = exp(cum_i) dy_i . (S_prev c_i)
  for (int it = 0; it < T; ++it) {
    const int i0 = it * R;
    __syncthreads();  // s_ecum is written; the previous tile is read
    load_tile(s_c, NP, N, p.c, co, p.c_ss, i0, Q, N, bf, tid);
    load_tile(s_y, XP, PP, p.dy, dyo, p.dy_ss, i0, Q, P, bf, tid);
    __syncthreads();
    float acc[4][CN];
    zero(acc);
    mm<P, CN>(acc, ty, tx, [&](int r, int k) { return s_y[r * XP + k]; },
              [&](int k, int c) { return s_sp[k * NP + c]; });
    float part[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int r = ty + 16 * a;
      const float e = s_ecum[i0 + r];
      part[a] = 0.f;
#pragma unroll
      for (int c = 0; c < CN; ++c) {
        acc[a][c] *= e;
        part[a] = fmaf(acc[a][c], s_c[r * NP + tx + 16 * c], part[a]);
      }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) part[a] = sum16(part[a]);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int row = i0 + ty + 16 * a;
      if (row >= Q) continue;
#pragma unroll
      for (int c = 0; c < CN; ++c) dc_g[(int64_t)row * N + tx + 16 * c] = acc[a][c];
      if (tx == 0) s_dcum[row] += (double)part[a];
    }
  }
  __syncthreads();  // S_prev is no longer read: its space holds W and dCB

  // ---- phase 2: column tile by column tile ----
  for (int jt = 0; jt < T; ++jt) {
    const int j0 = jt * R;
    load_tile(s_b, NP, N, p.b, bo, p.b_ss, j0, Q, N, bf, tid);
    load_tile(s_x, XP, PP, p.x, xo, p.x_ss, j0, Q, P, bf, tid);
    __syncthreads();
    float dxa[4][CP], dba[4][CN];
    // the state terms: dx_j = u_j dS b_j, db_j = u_j dS^T x_j, and
    // x_j . (dS b_j) for ddt and dcum
    {
      float dsb[4][CP];
      zero(dsb);
      mm<N, CP>(dsb, ty, tx, [&](int r, int k) { return s_b[r * NP + k]; },
                [&](int k, int c) { return s_ds[c * NP + k]; });
      float part[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int r = ty + 16 * a;
        const float u = s_u[j0 + r];
        part[a] = 0.f;
#pragma unroll
        for (int c = 0; c < CP; ++c) {
          part[a] = fmaf(s_x[r * XP + tx + 16 * c], dsb[a][c], part[a]);
          dxa[a][c] = u * dsb[a][c];
        }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) part[a] = sum16(part[a]);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int row = j0 + ty + 16 * a;
        if (tx == 0 && row < Q) {
          s_ddt[row] += s_dec[row] * part[a];
          s_r[row] = s_u[row] * part[a];
        }
      }
      float xds[4][CN];
      zero(xds);
      mm<P, CN>(xds, ty, tx, [&](int r, int k) { return s_x[r * XP + k]; },
                [&](int k, int c) { return s_ds[k * NP + c]; });
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float u = s_u[j0 + ty + 16 * a];
#pragma unroll
        for (int c = 0; c < CN; ++c) dba[a][c] = u * xds[a][c];
      }
    }
    // the intra-chunk terms, row tile by row tile on and below the diagonal
    for (int it = jt; it < T; ++it) {
      const int i0 = it * R;
      __syncthreads();  // the previous row tile's C, dy, W, dCB, K are read
      load_tile(s_c, NP, N, p.c, co, p.c_ss, i0, Q, N, bf, tid);
      load_tile(s_y, XP, PP, p.dy, dyo, p.dy_ss, i0, Q, P, bf, tid);
      __syncthreads();
      float cb[4][4], gm[4][4];
      zero(cb);
      zero(gm);
      mm<N, 4>(cb, ty, tx, [&](int r, int k) { return s_c[r * NP + k]; },
               [&](int k, int c) { return s_b[c * NP + k]; });
      mm<P, 4>(gm, ty, tx, [&](int r, int k) { return s_y[r * XP + k]; },
               [&](int k, int c) { return s_x[c * XP + k]; });
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int r = ty + 16 * a, gi = i0 + r;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int col = tx + 16 * c, gj = j0 + col;
          // select, then exponentiate: never exp of a positive difference
          const float l = (gj <= gi && gi < Q) ? expf(s_cum[gi] - s_cum[gj]) : 0.f;
          const float ld = l * s_dt[gj];
          s_w[r * WP + col] = cb[a][c] * ld;
          s_g[r * WP + col] = gm[a][c] * ld;
          s_k[r * WP + col] = cb[a][c] * l * gm[a][c];
        }
      }
      __syncthreads();
      // dx_j += W^T dy_i, db_j += dCB^T c_i
      mm<R, CP>(dxa, ty, tx, [&](int r, int k) { return s_w[k * WP + r]; },
                [&](int k, int c) { return s_y[k * XP + c]; });
      mm<R, CN>(dba, ty, tx, [&](int r, int k) { return s_g[k * WP + r]; },
                [&](int k, int c) { return s_c[k * NP + c]; });
      // dc_i += dCB b_j, into the per-head partial (this block's rows)
      {
        float tmp[4][CN];
        zero(tmp);
        mm<R, CN>(tmp, ty, tx, [&](int r, int k) { return s_g[r * WP + k]; },
                  [&](int k, int c) { return s_b[k * NP + c]; });
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int row = i0 + ty + 16 * a;
          if (row >= Q) continue;
#pragma unroll
          for (int c = 0; c < CN; ++c) dc_g[(int64_t)row * N + tx + 16 * c] += tmp[a][c];
        }
      }
      // K's column sums (ddt; and, without the diagonal, -dt_j colsum for
      // dcum) and K dt's row sums without the diagonal (dcum), in row and
      // column order
      const int diag = it == jt ? tid & (R - 1) : -1;
      if (tid < R) {
        const int gj = j0 + tid;
        const float dtj = s_dt[gj];
        float s = 0.f;
        double so = 0.0;
        for (int i = 0; i < R; ++i) {
          const float kv = s_k[i * WP + tid];
          s += kv;
          if (i != diag) so += (double)(kv * dtj);
        }
        if (gj < Q) {
          s_ddt[gj] += s;
          s_dcol[gj] -= so;
        }
      } else if (tid < 2 * R) {
        const int r = tid - R, gi = i0 + r;
        double s = 0.0;
        for (int j = 0; j < R; ++j)
          if (j != diag) s += (double)(s_k[r * WP + j] * s_dt[j0 + j]);
        if (gi < Q) s_dcum[gi] += s;
      }
    }
    // dx_j in x's dtype; db_j into the per-head partial
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int row = j0 + ty + 16 * a;
      if (row >= Q) continue;
#pragma unroll
      for (int c = 0; c < CP; ++c) {
        const int col = tx + 16 * c;
        if (col < P) stv(p.dx, dxo + row * p.dx_ss + col, dxa[a][c], bf);
      }
#pragma unroll
      for (int c = 0; c < CN; ++c) db_g[(int64_t)row * N + tx + 16 * c] = dba[a][c];
    }
    __syncthreads();  // B, x, K and the per-row sums are done with
  }

  // ---- phase 3: d(dt a) in fp64 (suffix sums of dcum, prefix sums of
  // r), ddt, the chunk's share of da_log ----
  if (warp == 0) {
    double suf[SCAN_PER_LANE], pre[SCAN_PER_LANE];
    double run = 0.0, runr = 0.0;
#pragma unroll
    for (int k = SCAN_PER_LANE - 1; k >= 0; --k) {
      const int t = lane * SCAN_PER_LANE + k;
      double dc = 0.0;
      if (t < Q) {
        dc = s_dcum[t] + s_dcol[t];
        if (t == Q - 1) dc += (double)(expf(seg) * dot);
      }
      run += dc;
      suf[k] = run;
    }
#pragma unroll
    for (int k = 0; k < SCAN_PER_LANE; ++k) {
      const int t = lane * SCAN_PER_LANE + k;
      pre[k] = runr;  // r over this lane's entries before t
      runr += t < Q ? (double)s_r[t] : 0.0;
    }
    double incl = run, inclr = runr;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const double dn = __shfl_down_sync(FULL, incl, off);
      const double up = __shfl_up_sync(FULL, inclr, off);
      if (lane + off < 32) incl += dn;
      if (lane >= off) inclr += up;
    }
    const double above = incl - run;    // dcum over the lanes above
    const double before = inclr - runr;  // r over the lanes below
    double da = 0.0;
#pragma unroll
    for (int k = 0; k < SCAN_PER_LANE; ++k) {
      const int t = lane * SCAN_PER_LANE + k;
      if (t < Q) {
        const double ddta = (above + suf[k]) + (before + pre[k]);
        da += (double)s_dt[t] * ddta;
        p.ddt[ddto + t * p.ddt_ss] = s_ddt[t] + ah * (float)ddta;
      }
    }
#pragma unroll
    for (int off = 16; off >= 1; off >>= 1) da += __shfl_xor_sync(FULL, da, off);
    if (lane == 0) p.ws_da[((int64_t)bi * H + h) * nch + ch] = da;
  }
}

// ---------------------------------------------------------------------------
// 3. reduce: db and dc over each group's heads, da_log over (batch, chunk)
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(THREADS) ssd_bwd_reduce(const Args p) {
  const int tid = threadIdx.x;
  const int H = p.H, G = p.G, S = p.S, N = p.N, nch = S / p.Q;
  if (blockIdx.y == 2) {
    if (blockIdx.x != 0) return;
    for (int h = tid; h < H; h += THREADS) {
      double s = 0.0;
      for (int b = 0; b < p.B; ++b)
        for (int ch = 0; ch < nch; ++ch) s += p.ws_da[((int64_t)b * H + h) * nch + ch];
      const float a = -expf(p.a_log[h]);
      p.da_log[h] = (float)((double)a * s);
    }
    return;
  }
  const bool dcp = blockIdx.y == 1;
  const float* ws = dcp ? p.ws_dc : p.ws_db;
  void* out = dcp ? p.dc : p.db;
  const int64_t sb = dcp ? p.dc_sb : p.db_sb, sg = dcp ? p.dc_sg : p.db_sg,
                ss = dcp ? p.dc_ss : p.db_ss;
  // the workspaces hold one partial per hw heads (H / hw of them)
  const int rep = H / G / p.hw, hp = H / p.hw;
  const int64_t total = (int64_t)p.B * G * S * N;
  for (int64_t e = (int64_t)blockIdx.x * THREADS + tid; e < total;
       e += (int64_t)gridDim.x * THREADS) {
    const int n = (int)(e % N);
    int64_t rest = e / N;
    const int s = (int)(rest % S);
    rest /= S;
    const int g = (int)(rest % G);
    const int b = (int)(rest / G);
    float acc = 0.f;
    for (int k = 0; k < rep; ++k)
      acc += ws[(((int64_t)b * hp + g * rep + k) * S + s) * N + n];
    stv(out, b * sb + g * sg + s * ss + n, acc, p.bf16 != 0);
  }
}

template <int N, int PS>
cudaError_t launch_sweep(const Args& p, cudaStream_t stream) {
  constexpr size_t smem = sweep_floats<N, PS>() * sizeof(float);
  auto kernel = ssd_bwd_sweep<N, PS>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(p.P / PS, p.H, 2 * p.B), THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int N, int P>
cudaError_t launch_chunk(const Args& p, cudaStream_t stream) {
  constexpr size_t smem = ChunkSmem<N, P>::FLOATS * sizeof(float);
  static_assert(smem <= 232448, "more shared memory than a block may use");
  auto kernel = ssd_bwd_chunk<N, P>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(p.S / p.Q, p.H, p.B), THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int N>
cudaError_t by_p(const Args& p, cudaStream_t stream) {
  cudaError_t err;
  switch (p.P) {
    case 8: err = launch_sweep<N, 8>(p, stream); break;
    case 16: err = launch_sweep<N, 16>(p, stream); break;
    case 32:
    case 64: err = launch_sweep<N, 32>(p, stream); break;
    default: return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  switch (p.P) {
    case 8: return launch_chunk<N, 8>(p, stream);
    case 16: return launch_chunk<N, 16>(p, stream);
    case 32: return launch_chunk<N, 32>(p, stream);
    case 64: return launch_chunk<N, 64>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// bf16: every product on wgmma (warpgroup tensor-core products, bf16 in,
// fp32 accumulators), tiles copied by cp.async into wgmma's 128-byte
// swizzled layout (hopper.cuh). Every block is one warpgroup, two blocks
// an SM. Three launches and the reduce:
//   1. sweep_bf16, one block per (head, batch, direction): the state
//      entering each chunk, S <- exp(seg) S + (x . u)^T B, forward, and dS
//      leaving each, dS <- exp(seg) dS + (dy . exp(cum))^T C, in reverse
//      from d_final: the (P, N) state in fp32 registers, the A operand
//      read transposed from the chunk's x (dy) tiles in three bf16 parts.
//      Each state is written as three bf16 part tiles, the image of the
//      tiles the passes below read, so they copy it 16 bytes at a time.
//   2. dxdb_bf16, one block per (chunk, hw heads of a group, batch): for
//      each 64-row column tile j, db_j is summed over the block's heads in
//      registers; for each head dx_j starts as u_j (B_j dS^T) and db_j
//      gains u_j (X_j dS) (dS's parts in shared memory), then for every
//      row tile i >= j: B_j C_i^T and X_j dY_i^T from the bf16 tiles (rows
//      j: so W^T, dCB^T and K^T come out in the accumulator's layout,
//      which is the A layout of the next two products), W^T, dCB^T and
//      K^T in registers (the causal mask selected before the exponential),
//      dx_j += W^T dY_i and db_j += dCB^T C_i with W^T and dCB^T as bf16
//      high and low parts. K's sums: over i (ddt's colsum, and dcum_j's
//      column part) within the thread and its quad; over j (dcum_i's row
//      part) by shuffles over the warp's rows, overlapping the products,
//      then a fixed-order pass over the four warps through shared memory.
//      C_i and dY_i come through a two-stage ring, one barrier a step.
//   3. dc_bf16, the same blocks, row tile i outer: dc_i (summed over the
//      block's heads in registers) starts as exp(cum_i) (dY_i S_prev)
//      (S_prev's three parts), which also gives dcum_i's inter-chunk term
//      with C_i; then for every j <= i, dCB = (dY_i X_j^T) . L . dt_j
//      (recomputed with rows i: one 64 x 64 x P product, cheaper than
//      staging dCB^T transposed or a global read-modify-write of dc_i per
//      tile) and dc_i += dCB B_j. Then one warp a head scans dcum in fp64
//      and writes ddt and the chunk's share of da_log.
//   4. the reduce above: db and dc over each group's H / G / hw partials.
// hw (kernels/ssd_scan.py::bwd_heads_per_block) is 4 at the training
// microbatch, which cuts the db and dc partials the reduce reads from 268
// to 67 MB (the reduce 0.093 -> 0.028 ms) and shares the B and C tiles.
// The part counts come from tools/ssd_bwd_rounding.py (float64 emulation
// at the training widths, in gate units): W^T, dCB^T and dCB in two parts
// (each output within 0.0013 of its gate from them), S_prev, dS, x . u
// and dy . exp(cum) in three (two put ddt or da_log 0.02-0.29 from its
// gate at the training widths, da_log 0.13 at narrow ones).
// P < 64 and N < 64 are padded with zero columns in shared memory, so
// every product runs its full k-steps and every wgmma loop unrolls (a
// loop with a run-time count put the products on a divergent path, and
// ptxas serialised them).
// ---------------------------------------------------------------------------
namespace tc {

constexpr int HW_MAX = 4;  // heads a block walks, at most

// d (64 x 64, fp32) (+)= A B, A K-major and B MN-major in shared memory
__device__ __forceinline__ void wgmma_ss_mn_n64(float d[32], uint64_t da,
                                                uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}
// d (64 x 128, fp32) (+)= A B, A K-major and B MN-major in shared memory
__device__ __forceinline__ void wgmma_ss_mn_n128(float d[64], uint64_t da,
                                                 uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// the products at width NB (the padded N: 64 or 128), B MN-major
template <int NB>
__device__ __forceinline__ void ss_mn(float (&d)[NB / 2], uint64_t da,
                                      uint64_t db, int accumulate) {
  if constexpr (NB == 128)
    wgmma_ss_mn_n128(d, da, db, accumulate);
  else
    wgmma_ss_mn_n64(d, da, db, accumulate);
}
template <int NB>
__device__ __forceinline__ void rs_mn(float (&d)[NB / 2], const uint32_t a[4],
                                      uint64_t db) {
  if constexpr (NB == 128)
    wgmma_rs_n128(d, a, db);
  else
    wgmma_rs_n64(d, a, db);
}

// Rows [r0, r0 + TILE) of a chunk (row stride ss, 16-byte aligned) into a
// tile of CH 16-byte chunks a row in gmma_off's layout, by the NT threads
// of the block; rows at or past lim and chunks at or past cv are zeros.
template <int CH>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* base,
                                          int64_t ss, int r0, int lim,
                                          int cv, int t) {
#pragma unroll
  for (int k = 0; k < TILE * CH / NT; ++k) {
    const int i = t + k * NT, r = i / CH, ch = i % CH;
    const int row = r0 + r;
    cp_async16(saddr(dst + gmma_off<TILE>(r, ch)),
               base + (int64_t)min(row, lim - 1) * ss + min(ch, cv - 1) * 8,
               row < lim && ch < cv);
  }
}

// A state's three bf16 part tiles as the sweep wrote them (the image of
// the tiles in shared memory: gmma_off's layout, TILE rows p by NB columns
// n, zero past P and N) into dst, by the NT threads of the block.
template <int NB>
__device__ __forceinline__ void load_parts(bf16* dst, const bf16* src, int t) {
  constexpr int CHUNKS = 3 * TILE * NB / 8;  // 16-byte copies
#pragma unroll
  for (int k = 0; k < CHUNKS / NT; ++k) {
    const int i = t + k * NT;
    cp_async16(saddr(dst + 8 * i), src + 8 * i, true);
  }
}

// the sum over the four lanes of a quad (lane / 4), in each of them
template <typename V>
__device__ __forceinline__ V quad_sum(V v) {
  v += __shfl_xor_sync(FULL, v, 1);
  v += __shfl_xor_sync(FULL, v, 2);
  return v;
}

// ---- 1. the sweep ----------------------------------------------------------
template <int NB>
struct SweepSmem {
  static constexpr int VB = TILE * TILE * 2;  // a tile of x or dy
  static constexpr int EB = TILE * NB * 2;    // a tile of B or C
  static constexpr int V = 0;                 // a chunk's x (dy) tiles
  static constexpr int E = V + 4 * VB;        // its B (C) tiles
  static constexpr int F = E + 4 * EB;        // dt, cum, the row weights
  static constexpr int BYTES = F + 3 * MAX_Q * (int)sizeof(float);
  static_assert(3 * TILE * NB * 2 <= 4 * EB, "the state's parts are staged in E");
};

template <int NB>
__global__ void __launch_bounds__(NT) sweep_bf16(const Args p) {
  constexpr int NO = NB / 8;  // 8-column n-tiles of the state
  using L = SweepSmem<NB>;
  extern __shared__ __align__(1024) unsigned char sm[];
  bf16* s_v = reinterpret_cast<bf16*>(sm + L::V);
  bf16* s_e = reinterpret_cast<bf16*>(sm + L::E);
  float* s_dt = reinterpret_cast<float*>(sm + L::F);
  float* s_cum = s_dt + MAX_Q;
  float* s_w = s_cum + MAX_Q;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r0 = warp * 16 + (lane >> 2), cq = 2 * (lane & 3);
  const int h = blockIdx.x;
  const bool back = (int)blockIdx.y >= p.B;
  const int bi = back ? blockIdx.y - p.B : blockIdx.y;
  const int H = p.H, Q = p.Q, P = p.P, N = p.N, nch = p.S / Q;
  const int g = h / (H / p.G);
  const int T = (Q + TILE - 1) / TILE;
  const float ah = -expf(p.a_log[h]);
  const bf16* vb = static_cast<const bf16*>(back ? p.dy : p.x)
                   + (back ? bi * p.dy_sb + h * p.dy_sh : bi * p.x_sb + h * p.x_sh);
  const int64_t vss = back ? p.dy_ss : p.x_ss;
  const bf16* eb = static_cast<const bf16*>(back ? p.c : p.b)
                   + (back ? bi * p.c_sb + g * p.c_sg : bi * p.b_sb + g * p.b_sg);
  const int64_t ess = back ? p.c_ss : p.b_ss;
  const float* dtb = p.dt + bi * p.dt_sb + h * p.dt_sh;
  // the states as three bf16 part tiles a chunk, the image of the tiles
  // the passes below read
  bf16* ws = reinterpret_cast<bf16*>(back ? p.ws_ds : p.ws_s)
             + ((int64_t)bi * H + h) * nch * 3 * TILE * NB;

  // the state (rows p, columns n) in wgmma's accumulator layout
  float acc[NB / 2];
#pragma unroll
  for (int i = 0; i < NB / 2; ++i) acc[i] = 0.f;
  if (back && p.d_final != nullptr) {
    const float* df = p.d_final + ((int64_t)bi * H + h) * P * N;
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        const int row = r0 + 8 * e2, col = 8 * n + cq;
        if (row < P && col < N) {
          const float2 v = *reinterpret_cast<const float2*>(df + row * N + col);
          acc[4 * n + 2 * e2] = v.x;
          acc[4 * n + 2 * e2 + 1] = v.y;
        }
      }
  }
  for (int step = 0; step < nch; ++step) {
    const int ch = back ? nch - 1 - step : step;
    // the parts staged in the (free) B or C tiles' space, then copied out
    // 16 bytes a thread
    __syncthreads();  // the previous chunk's tiles and weights are read
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        // rows past P and columns past N hold zeros: x (dy) and B (C)
        // are zero there
        uint32_t part[3];
        split3(acc[4 * n + 2 * e2], acc[4 * n + 2 * e2 + 1], part[0],
               part[1], part[2]);
        const int off = gmma_off<TILE>(r0 + 8 * e2, n) + cq;
#pragma unroll
        for (int k = 0; k < 3; ++k)
          *reinterpret_cast<uint32_t*>(s_e + k * TILE * NB + off) = part[k];
      }
    __syncthreads();
    {
      uint4* dst = reinterpret_cast<uint4*>(ws + (int64_t)ch * 3 * TILE * NB);
      const uint4* src = reinterpret_cast<const uint4*>(s_e);
#pragma unroll 4
      for (int i = tid; i < 3 * TILE * NB / 8; i += NT) dst[i] = src[i];
    }
    if (step + 1 == nch) break;  // the last chunk visited updates nothing
    const int64_t t0 = (int64_t)ch * Q;
    __syncthreads();  // the staged parts are copied out
    for (int it = 0; it < T; ++it) {
      load_rows<TILE / 8>(s_v + it * TILE * TILE, vb + t0 * vss, vss,
                          it * TILE, Q, P / 8, tid);
      load_rows<NB / 8>(s_e + it * TILE * NB, eb + t0 * ess, ess, it * TILE,
                        Q, N / 8, tid);
    }
    for (int i = tid; i < MAX_Q; i += NT)
      cp_async4(saddr(s_dt + i), dtb + (t0 + min(i, Q - 1)) * p.dt_ss, i < Q);
    cp_commit();
    cp_wait<0>();
    fence_proxy_async();
    __syncthreads();
    if (warp == 0) chunk_cum(s_dt, ah, s_cum, lane);
    __syncthreads();
    const float seg = s_cum[Q - 1];
    for (int i = tid; i < MAX_Q; i += NT)
      s_w[i] = i < Q ? (back ? expf(s_cum[i]) : s_dt[i] * expf(seg - s_cum[i]))
                     : 0.f;
    __syncthreads();
    const float es = expf(seg);
#pragma unroll
    for (int i = 0; i < NB / 2; ++i) acc[i] *= es;
    for (int it = 0; it < T; ++it) {
      const bf16* sv = s_v + it * TILE * TILE;
      // A (rows p, k-step m over the tile's rows t): v_t,p w_t, read
      // transposed from the tile, in three bf16 parts
      uint32_t va[4][3][4];
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int pp = r0 + 8 * (r & 1), jl = 16 * m + cq + 8 * (r >> 1);
          const int pc = pp >> 3, pe = pp & 7;
          const float v0 = __bfloat162float(sv[gmma_off<TILE>(jl, pc) + pe])
                           * s_w[it * TILE + jl];
          const float v1 = __bfloat162float(sv[gmma_off<TILE>(jl + 1, pc) + pe])
                           * s_w[it * TILE + jl + 1];
          split3(v0, v1, va[m][0][r], va[m][1][r], va[m][2][r]);
        }
      gmma_fence();
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int part = 0; part < 3; ++part)
          rs_mn<NB>(acc, va[m][part], gmma_mn_major(s_e + it * TILE * NB, m));
      gmma_commit();
      gmma_wait();
      fence_regs(acc);
    }
  }
}

// ---- 2. dx and db, column tile j outer -------------------------------------
template <int NB>
struct DxdbSmem {
  static constexpr int XB = TILE * TILE * 2;  // a tile of x or dy
  static constexpr int EB = TILE * NB * 2;    // a tile of B, C or a state part
  static constexpr int BJ = 0;                // B_j
  static constexpr int XJ = BJ + EB;          // X_j
  // dS's three parts, then the ring of (C_i, dY_i) stages
  static constexpr int RG = XJ + XB;
  static constexpr int RSIZE = 3 * EB > 2 * (EB + XB) ? 3 * EB : 2 * (EB + XB);
  static constexpr int F = RG + RSIZE;        // dt, cum [head][MAX_Q]
  static constexpr int D = F + 2 * HW_MAX * MAX_Q * (int)sizeof(float);
  // fp64: dcum's row part [head][MAX_Q], the column sums of two steps
  // [step & 1][warp][TILE]
  static constexpr int BYTES = D + (HW_MAX * MAX_Q + 8 * TILE) * (int)sizeof(double);
};

// The decays of the block's hw heads: dt (0 past Q) and cum, per head.
__device__ __forceinline__ void head_decays(const Args& p, int bi, int h0,
                                            int64_t t0, float* s_dt,
                                            float* s_cum, int tid) {
  for (int e = tid; e < p.hw * MAX_Q; e += NT) {
    const int hh = e / MAX_Q, i = e % MAX_Q;
    s_dt[e] = i < p.Q ? p.dt[bi * p.dt_sb + (h0 + hh) * p.dt_sh + (t0 + i) * p.dt_ss]
                      : 0.f;
  }
  __syncthreads();
  const int warp = tid >> 5;
  if (warp < p.hw)
    chunk_cum(s_dt + warp * MAX_Q, -expf(p.a_log[h0 + warp]),
              s_cum + warp * MAX_Q, tid & 31);
  // read after the caller's next barrier
}

// The elementwise step of a (j, i) tile pair of the dx/db pass, from
// B_j C_i^T (cbt) and X_j dY_i^T (gt), rows j and columns i (cum_i of
// the tile's columns at ci, cm = cum of the column tile's last row): W^T
// and dCB^T as bf16 high and low A fragments (the C layout of n-tiles
// 2 m, 2 m + 1 is the A layout of k-step m); K^T's row sums into ks
// (fp32: ddt) and kd (dcum_j's column part, the diagonal left out: the
// pair's 16 terms in fp32, added to kd in fp64); its column sums over this
// thread's two rows (dcum_i's row part) into cols, for col_sums. On the
// diagonal tile the exponent is selected to -1e30 above the diagonal
// (exp gives 0: never exp of a positive difference); below it the decay
// factors through row m as exp(cum_i - cum_m) exp(cum_m - cum_j), both at
// most 1, 18 exponentials a thread instead of 32.
template <bool DIAG>
__device__ __forceinline__ void pair_terms(
    const float (&cbt)[32], const float (&gt)[32], const float* ci, int r0,
    int cq, float cm, const float (&cj)[2], const float (&dtj)[2],
    uint32_t (&whi)[4][4], uint32_t (&wlo)[4][4], uint32_t (&ghi)[4][4],
    uint32_t (&glo)[4][4], float (&ks)[2], double (&kd)[2],
    float (&cols)[16]) {
  float rf[2], kp[2] = {0.f, 0.f};
#pragma unroll
  for (int e2 = 0; e2 < 2; ++e2) rf[e2] = DIAG ? 0.f : expf(cm - cj[e2]);
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    float wv[4], gv[4];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int il = 8 * n + cq + c;
      const float cf = DIAG ? 0.f : expf(ci[il] - cm);
      cols[2 * n + c] = 0.f;
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        const int e = 2 * e2 + c, jl = r0 + 8 * e2;
        const float l = DIAG ? expf(il >= jl ? ci[il] - cj[e2] : -1e30f)
                             : cf * rf[e2];
        const float ld = l * dtj[e2];
        const float kv = cbt[4 * n + e] * l * gt[4 * n + e];
        wv[e] = cbt[4 * n + e] * ld;
        gv[e] = gt[4 * n + e] * ld;
        ks[e2] += kv;
        // K's diagonal enters dcum by its row and by its column: left out
        const float d = DIAG && il == jl ? 0.f : kv * dtj[e2];
        kp[e2] += d;
        cols[2 * n + c] += d;
      }
    }
    split(wv[0], wv[1], whi[n >> 1][2 * (n & 1)], wlo[n >> 1][2 * (n & 1)]);
    split(wv[2], wv[3], whi[n >> 1][2 * (n & 1) + 1], wlo[n >> 1][2 * (n & 1) + 1]);
    split(gv[0], gv[1], ghi[n >> 1][2 * (n & 1)], glo[n >> 1][2 * (n & 1)]);
    split(gv[2], gv[3], ghi[n >> 1][2 * (n & 1) + 1], glo[n >> 1][2 * (n & 1) + 1]);
  }
#pragma unroll
  for (int e2 = 0; e2 < 2; ++e2) kd[e2] += (double)kp[e2];
}

// pair_terms' column sums (this thread's rows) over the warp's 16 rows,
// three rounds of 16 shuffles, into red (this warp's 64, written by lanes
// 0-3 in fp64)
__device__ __forceinline__ void col_sums(float (&cols)[16], double* red,
                                         int cq, int lane) {
#pragma unroll
  for (int off = 4; off <= 16; off <<= 1)
#pragma unroll
    for (int k = 0; k < 16; ++k) cols[k] += __shfl_xor_sync(FULL, cols[k], off);
  if (lane < 4) {
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      red[8 * n + cq] = (double)cols[2 * n];
      red[8 * n + cq + 1] = (double)cols[2 * n + 1];
    }
  }
}

template <int NB>
__global__ void __launch_bounds__(NT) dxdb_bf16(const Args p) {
  constexpr int NO = NB / 8;
  using L = DxdbSmem<NB>;
  extern __shared__ __align__(1024) unsigned char sm[];
  bf16* s_bj = reinterpret_cast<bf16*>(sm + L::BJ);
  bf16* s_xj = reinterpret_cast<bf16*>(sm + L::XJ);
  bf16* s_rg = reinterpret_cast<bf16*>(sm + L::RG);
  float* s_dt = reinterpret_cast<float*>(sm + L::F);
  float* s_cum = s_dt + HW_MAX * MAX_Q;
  double* s_dcum = reinterpret_cast<double*>(sm + L::D);
  double* s_red = s_dcum + HW_MAX * MAX_Q;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r0 = warp * 16 + (lane >> 2), cq = 2 * (lane & 3);
  const int ch = blockIdx.x, bi = blockIdx.z;
  const int H = p.H, S = p.S, Q = p.Q, P = p.P, N = p.N, hw = p.hw;
  const int nch = S / Q, h0 = blockIdx.y * hw, g = h0 / (H / p.G);
  // k-steps over N and P at their padded widths (the padding is zeros):
  // every wgmma loop unrolls, so none sits on a divergent path
  constexpr int KN = NB / 16, KP = TILE / 16;
  const int T = (Q + TILE - 1) / TILE;
  const int64_t t0 = (int64_t)ch * Q;
  const bf16* bb = static_cast<const bf16*>(p.b) + bi * p.b_sb + g * p.b_sg + t0 * p.b_ss;
  const bf16* cb = static_cast<const bf16*>(p.c) + bi * p.c_sb + g * p.c_sg + t0 * p.c_ss;

  for (int e = tid; e < hw * MAX_Q; e += NT) s_dcum[e] = 0.0;
  head_decays(p, bi, h0, t0, s_dt, s_cum, tid);

  for (int jt = 0; jt < T; ++jt) {
    const int j0 = jt * TILE;
    float db[NB / 2];  // db_j, rows j, summed over the block's heads
#pragma unroll
    for (int i = 0; i < NB / 2; ++i) db[i] = 0.f;
    for (int hh = 0; hh < hw; ++hh) {
      const int h = h0 + hh;
      const float* cum = s_cum + hh * MAX_Q;
      const float* dtv = s_dt + hh * MAX_Q;
      const bf16* xb = static_cast<const bf16*>(p.x) + bi * p.x_sb + h * p.x_sh + t0 * p.x_ss;
      const bf16* yb = static_cast<const bf16*>(p.dy) + bi * p.dy_sb + h * p.dy_sh + t0 * p.dy_ss;
      __syncthreads();  // the previous head's tiles are read
      if (hh == 0) load_rows<NB / 8>(s_bj, bb, p.b_ss, j0, Q, N / 8, tid);
      load_rows<TILE / 8>(s_xj, xb, p.x_ss, j0, Q, P / 8, tid);
      const int64_t unit = (((int64_t)bi * H + h) * nch + ch) * 3 * TILE * NB;
      load_parts<NB>(s_rg, reinterpret_cast<const bf16*>(p.ws_ds) + unit, tid);
      cp_commit();
      cp_wait<0>();
      fence_proxy_async();
      __syncthreads();

      const float seg = cum[Q - 1];
      float cj[2], dtj[2], dj[2], uj[2];  // this thread's rows j
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        const int jr = j0 + r0 + 8 * e2;
        cj[e2] = cum[jr];
        dtj[e2] = dtv[jr];
        dj[e2] = jr < Q ? expf(seg - cj[e2]) : 0.f;
        uj[e2] = dtj[e2] * dj[e2];
      }
      // the state terms: dx_j = u_j B_j dS^T, db_j += u_j X_j dS, and
      // x_j . (dS b_j) for ddt and dcum
      float dx[32], xdsb[2] = {0.f, 0.f};
      {
        float dsb[32];
        gmma_fence();
#pragma unroll
        for (int part = 0; part < 3; ++part)
#pragma unroll
          for (int kk = 0; kk < KN; ++kk)
            wgmma_ss_n64(dsb, gmma_k_major(s_bj, kk),
                         gmma_k_major(s_rg + part * TILE * NB, kk),
                         part > 0 || kk > 0);
        gmma_commit();
        gmma_wait();
        fence_regs(dsb);
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e2 = 0; e2 < 2; ++e2) {
            const float2 xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                s_xj + gmma_off<TILE>(r0 + 8 * e2, n) + cq));
            xdsb[e2] = fmaf(xv.x, dsb[4 * n + 2 * e2], xdsb[e2]);
            xdsb[e2] = fmaf(xv.y, dsb[4 * n + 2 * e2 + 1], xdsb[e2]);
            dx[4 * n + 2 * e2] = uj[e2] * dsb[4 * n + 2 * e2];
            dx[4 * n + 2 * e2 + 1] = uj[e2] * dsb[4 * n + 2 * e2 + 1];
          }
      }
      {
        float xds[NB / 2];
        gmma_fence();
#pragma unroll
        for (int part = 0; part < 3; ++part)
#pragma unroll
          for (int kk = 0; kk < KP; ++kk)
            ss_mn<NB>(xds, gmma_k_major(s_xj, kk),
                      gmma_mn_major(s_rg + part * TILE * NB, kk),
                      part > 0 || kk > 0);
        gmma_commit();
        gmma_wait();
        fence_regs(xds);
#pragma unroll
        for (int i = 0; i < NB / 2; ++i) db[i] = fmaf(uj[(i >> 1) & 1], xds[i], db[i]);
      }
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) xdsb[e2] = quad_sum(xdsb[e2]);

      float ks[2] = {0.f, 0.f};     // K's column sums (ddt), rows j
      double kd[2] = {0.0, 0.0};    // sum_{i != j} K_ij dt_j (dcum_j's column part)
      const int steps = T - jt;     // row tiles i = jt .. T - 1
      auto load_step = [&](int s, int stage) {
        bf16* d = s_rg + stage * (TILE * NB + TILE * TILE);
        load_rows<NB / 8>(d, cb, p.c_ss, (jt + s) * TILE, Q, N / 8, tid);
        load_rows<TILE / 8>(d + TILE * NB, yb, p.dy_ss, (jt + s) * TILE, Q,
                            P / 8, tid);
      };
      // dcum_i's row part for row tile it: the four warps' sums in order
      auto add_cols = [&](int it) {
        const double* red = s_red + (((it - jt) & 1) * 4) * TILE;
        if (tid < TILE)
          s_dcum[hh * MAX_Q + it * TILE + tid] +=
              ((red[tid] + red[TILE + tid]) + red[2 * TILE + tid]) + red[3 * TILE + tid];
      };
      __syncthreads();  // dS's parts are read: the ring takes their place
      load_step(0, 0);
      cp_commit();
      for (int s = 0; s < steps; ++s) {
        const int stage = s & 1;
        cp_wait<0>();
        fence_proxy_async();
        // stage s has landed; step s - 1 is done with the other stage and
        // has written its column sums
        __syncthreads();
        if (s + 1 < steps) {
          load_step(s + 1, stage ^ 1);
          cp_commit();
        }
        if (s > 0) add_cols(jt + s - 1);
        const int it = jt + s, i0 = it * TILE;
        const bf16* sc = s_rg + stage * (TILE * NB + TILE * TILE);
        const bf16* sy = sc + TILE * NB;
        float cbt[32], gt[32];  // B_j C_i^T and X_j dY_i^T: rows j, columns i
        gmma_fence();
#pragma unroll
        for (int kk = 0; kk < KN; ++kk)
          wgmma_ss_n64(cbt, gmma_k_major(s_bj, kk), gmma_k_major(sc, kk), kk > 0);
#pragma unroll
        for (int kk = 0; kk < KP; ++kk)
          wgmma_ss_n64(gt, gmma_k_major(s_xj, kk), gmma_k_major(sy, kk), kk > 0);
        gmma_commit();
        gmma_wait();
        fence_regs(cbt);
        fence_regs(gt);
        // W^T, dCB^T as bf16 high and low parts; K^T's sums
        uint32_t whi[4][4], wlo[4][4], ghi[4][4], glo[4][4];
        const float cm = cum[j0 + TILE - 1];
        float cols[16];
        if (it == jt)
          pair_terms<true>(cbt, gt, cum + i0, r0, cq, cm, cj, dtj, whi, wlo,
                           ghi, glo, ks, kd, cols);
        else
          pair_terms<false>(cbt, gt, cum + i0, r0, cq, cm, cj, dtj, whi, wlo,
                            ghi, glo, ks, kd, cols);
        // dx_j += W^T dY_i, db_j += dCB^T C_i (dY_i and C_i MN-major)
        gmma_fence();
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          wgmma_rs_n64(dx, whi[m], gmma_mn_major(sy, m));
          wgmma_rs_n64(dx, wlo[m], gmma_mn_major(sy, m));
        }
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          rs_mn<NB>(db, ghi[m], gmma_mn_major(sc, m));
          rs_mn<NB>(db, glo[m], gmma_mn_major(sc, m));
        }
        gmma_commit();
        // while the products run: dcum_i's row part over the warp's rows
        col_sums(cols, s_red + ((s & 1) * 4 + warp) * TILE, cq, lane);
        gmma_wait();
        fence_regs(dx);
        fence_regs(db);
      }
      __syncthreads();
      add_cols(T - 1);
      __syncthreads();  // the rows of tile j have every part of dcum
      // ddt's direct terms, r_j and dcum's row and column parts (the rows
      // of tile j have every part now); dx_j
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        ks[e2] = quad_sum(ks[e2]);
        kd[e2] = quad_sum(kd[e2]);
      }
      if ((lane & 3) == 0) {
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
          const int jr = j0 + r0 + 8 * e2;
          if (jr >= Q) continue;
          const int64_t o = ((int64_t)bi * H + h) * S + t0 + jr;
          p.ddt[bi * p.ddt_sb + h * p.ddt_sh + (t0 + jr) * p.ddt_ss] =
              ks[e2] + dj[e2] * xdsb[e2];
          p.ws_r[o] = uj[e2] * xdsb[e2];
          p.ws_dA[o] = s_dcum[hh * MAX_Q + jr] - kd[e2];
        }
      }
      bf16* dxo = static_cast<bf16*>(p.dx) + bi * p.dx_sb + h * p.dx_sh + t0 * p.dx_ss;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
          const int row = j0 + r0 + 8 * e2, col = 8 * n + cq;
          if (row < Q && col < P)
            *reinterpret_cast<__nv_bfloat162*>(dxo + row * p.dx_ss + col) =
                __floats2bfloat162_rn(dx[4 * n + 2 * e2], dx[4 * n + 2 * e2 + 1]);
        }
    }
    // db_j's partial over the block's heads
    float* dbo = p.ws_db + (((int64_t)bi * (H / hw) + blockIdx.y) * S + t0) * N;
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        const int row = j0 + r0 + 8 * e2, col = 8 * n + cq;
        if (row < Q && col < N)
          *reinterpret_cast<float2*>(dbo + (int64_t)row * N + col) =
              make_float2(db[4 * n + 2 * e2], db[4 * n + 2 * e2 + 1]);
      }
  }
}

// ---- 3. dc, row tile i outer; the decays' scan -----------------------------
template <int NB>
struct DcSmem {
  static constexpr int XB = TILE * TILE * 2;
  static constexpr int EB = TILE * NB * 2;
  static constexpr int YI = 0;                // dY_i
  static constexpr int CI = YI + XB;          // C_i
  // S_prev's three parts, then the ring of (B_j, X_j) stages
  static constexpr int RG = CI + EB;
  static constexpr int RSIZE = 3 * EB > 2 * (EB + XB) ? 3 * EB : 2 * (EB + XB);
  static constexpr int F = RG + RSIZE;        // dt, cum [head][MAX_Q]; dots
  static constexpr int D = F + (2 * HW_MAX * MAX_Q + 4 * HW_MAX) * (int)sizeof(float);
  // fp64: dcum's inter-chunk part [head][MAX_Q]
  static constexpr int BYTES = D + HW_MAX * MAX_Q * (int)sizeof(double);
};

// The elementwise step of an (i, j) tile pair of the dc pass: dCB = (dY_i
// X_j^T) . L . dt_j from gt (rows i, columns j; cum_j and dt_j of the
// tile's columns at cj and dtj, ci this thread's rows' cum) as bf16 high
// and low A fragments, the decays as in pair_terms.
template <bool DIAG>
__device__ __forceinline__ void dcb_terms(const float (&gt)[32],
                                          const float* cj, const float* dtj,
                                          int r0, int cq, float cm,
                                          const float (&ci)[2],
                                          uint32_t (&ghi)[4][4],
                                          uint32_t (&glo)[4][4]) {
  float rf[2];
#pragma unroll
  for (int e2 = 0; e2 < 2; ++e2) rf[e2] = DIAG ? 0.f : expf(ci[e2] - cm);
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    float gv[4];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int jl = 8 * n + cq + c;
      const float cf = DIAG ? 0.f : expf(cm - cj[jl]);
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        const int il = r0 + 8 * e2;
        const float l = DIAG ? expf(jl <= il ? ci[e2] - cj[jl] : -1e30f)
                             : rf[e2] * cf;
        gv[2 * e2 + c] = gt[4 * n + 2 * e2 + c] * (l * dtj[jl]);
      }
    }
    split(gv[0], gv[1], ghi[n >> 1][2 * (n & 1)], glo[n >> 1][2 * (n & 1)]);
    split(gv[2], gv[3], ghi[n >> 1][2 * (n & 1) + 1], glo[n >> 1][2 * (n & 1) + 1]);
  }
}

template <int NB>
__global__ void __launch_bounds__(NT) dc_bf16(const Args p) {
  constexpr int NO = NB / 8;
  using L = DcSmem<NB>;
  extern __shared__ __align__(1024) unsigned char sm[];
  bf16* s_yi = reinterpret_cast<bf16*>(sm + L::YI);
  bf16* s_ci = reinterpret_cast<bf16*>(sm + L::CI);
  bf16* s_rg = reinterpret_cast<bf16*>(sm + L::RG);
  float* s_dt = reinterpret_cast<float*>(sm + L::F);
  float* s_cum = s_dt + HW_MAX * MAX_Q;
  float* s_dot = s_cum + HW_MAX * MAX_Q;  // [head][warp]
  double* s_dci = reinterpret_cast<double*>(sm + L::D);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r0 = warp * 16 + (lane >> 2), cq = 2 * (lane & 3);
  const int ch = blockIdx.x, bi = blockIdx.z;
  const int H = p.H, S = p.S, Q = p.Q, P = p.P, N = p.N, hw = p.hw;
  const int nch = S / Q, h0 = blockIdx.y * hw, g = h0 / (H / p.G);
  constexpr int KP = TILE / 16;  // k-steps over P padded to 64
  const int T = (Q + TILE - 1) / TILE;
  const int64_t t0 = (int64_t)ch * Q;
  const bf16* bb = static_cast<const bf16*>(p.b) + bi * p.b_sb + g * p.b_sg + t0 * p.b_ss;
  const bf16* cb = static_cast<const bf16*>(p.c) + bi * p.c_sb + g * p.c_sg + t0 * p.c_ss;

  head_decays(p, bi, h0, t0, s_dt, s_cum, tid);

  for (int it = 0; it < T; ++it) {
    const int i0 = it * TILE;
    float dc[NB / 2];  // dc_i, rows i, summed over the block's heads
#pragma unroll
    for (int i = 0; i < NB / 2; ++i) dc[i] = 0.f;
    for (int hh = 0; hh < hw; ++hh) {
      const int h = h0 + hh;
      const float* cum = s_cum + hh * MAX_Q;
      const float* dtv = s_dt + hh * MAX_Q;
      const bf16* xb = static_cast<const bf16*>(p.x) + bi * p.x_sb + h * p.x_sh + t0 * p.x_ss;
      const bf16* yb = static_cast<const bf16*>(p.dy) + bi * p.dy_sb + h * p.dy_sh + t0 * p.dy_ss;
      __syncthreads();  // the previous head's tiles are read
      if (hh == 0) load_rows<NB / 8>(s_ci, cb, p.c_ss, i0, Q, N / 8, tid);
      load_rows<TILE / 8>(s_yi, yb, p.dy_ss, i0, Q, P / 8, tid);
      const int64_t unit = (((int64_t)bi * H + h) * nch + ch) * 3 * TILE * NB;
      load_parts<NB>(s_rg, reinterpret_cast<const bf16*>(p.ws_s) + unit, tid);
      cp_commit();
      cp_wait<0>();
      fence_proxy_async();
      __syncthreads();

      float ci[2], ei[2];  // this thread's rows i
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        ci[e2] = cum[i0 + r0 + 8 * e2];
        ei[e2] = expf(ci[e2]);
      }
      // the inter-chunk terms: dc_i += exp(cum_i) dY_i S_prev, and
      // dcum_i += exp(cum_i) dy_i . (S_prev c_i)
      {
        float inter[NB / 2];
        gmma_fence();
#pragma unroll
        for (int part = 0; part < 3; ++part)
#pragma unroll
          for (int kk = 0; kk < KP; ++kk)
            ss_mn<NB>(inter, gmma_k_major(s_yi, kk),
                      gmma_mn_major(s_rg + part * TILE * NB, kk),
                      part > 0 || kk > 0);
        gmma_commit();
        gmma_wait();
        fence_regs(inter);
        float dot[2] = {0.f, 0.f};
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
#pragma unroll
          for (int n = 0; n < NO; ++n) {
            const float v0 = inter[4 * n + 2 * e2] * ei[e2];
            const float v1 = inter[4 * n + 2 * e2 + 1] * ei[e2];
            dc[4 * n + 2 * e2] += v0;
            dc[4 * n + 2 * e2 + 1] += v1;
            // C_i is zero past Q and past N
            const float2 cv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                s_ci + gmma_off<TILE>(r0 + 8 * e2, n) + cq));
            dot[e2] = fmaf(v0, cv.x, dot[e2]);
            dot[e2] = fmaf(v1, cv.y, dot[e2]);
          }
          dot[e2] = quad_sum(dot[e2]);
        }
        if ((lane & 3) == 0) {
#pragma unroll
          for (int e2 = 0; e2 < 2; ++e2)
            s_dci[hh * MAX_Q + i0 + r0 + 8 * e2] = (double)dot[e2];
        }
      }

      const int steps = it + 1;  // column tiles j = 0 .. i
      auto load_step = [&](int s, int stage) {
        bf16* d = s_rg + stage * (TILE * NB + TILE * TILE);
        load_rows<NB / 8>(d, bb, p.b_ss, s * TILE, Q, N / 8, tid);
        load_rows<TILE / 8>(d + TILE * NB, xb, p.x_ss, s * TILE, Q, P / 8,
                            tid);
      };
      __syncthreads();  // S_prev's parts are read: the ring takes their place
      load_step(0, 0);
      cp_commit();
      for (int s = 0; s < steps; ++s) {
        const int stage = s & 1;
        cp_wait<0>();
        fence_proxy_async();
        __syncthreads();  // stage s has landed; step s - 1 is done with the other
        if (s + 1 < steps) {
          load_step(s + 1, stage ^ 1);
          cp_commit();
        }
        const int j0 = s * TILE;
        const bf16* sbj = s_rg + stage * (TILE * NB + TILE * TILE);
        const bf16* sxj = sbj + TILE * NB;
        float gt[32];  // dY_i X_j^T: rows i, columns j
        gmma_fence();
#pragma unroll
        for (int kk = 0; kk < KP; ++kk)
          wgmma_ss_n64(gt, gmma_k_major(s_yi, kk), gmma_k_major(sxj, kk), kk > 0);
        gmma_commit();
        gmma_wait();
        fence_regs(gt);
        // dCB = gt . L . dt_j as bf16 high and low parts
        uint32_t ghi[4][4], glo[4][4];
        const float cm = cum[j0 + TILE - 1];
        if (s == it)
          dcb_terms<true>(gt, cum + j0, dtv + j0, r0, cq, cm, ci, ghi, glo);
        else
          dcb_terms<false>(gt, cum + j0, dtv + j0, r0, cq, cm, ci, ghi, glo);
        gmma_fence();
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          rs_mn<NB>(dc, ghi[m], gmma_mn_major(sbj, m));
          rs_mn<NB>(dc, glo[m], gmma_mn_major(sbj, m));
        }
        gmma_commit();
        gmma_wait();
        fence_regs(dc);
      }
    }
    float* dco = p.ws_dc + (((int64_t)bi * (H / hw) + blockIdx.y) * S + t0) * N;
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        const int row = i0 + r0 + 8 * e2, col = 8 * n + cq;
        if (row < Q && col < N)
          *reinterpret_cast<float2*>(dco + (int64_t)row * N + col) =
              make_float2(dc[4 * n + 2 * e2], dc[4 * n + 2 * e2 + 1]);
      }
  }

  // <dS, S_prev> per head, in a fixed order, from their parts (three
  // bf16 parts sum back to the fp32 value)
  for (int hh = 0; hh < hw; ++hh) {
    const int64_t unit = (((int64_t)bi * H + h0 + hh) * nch + ch) * 3 * TILE * NB;
    const bf16* sd = reinterpret_cast<const bf16*>(p.ws_ds) + unit;
    const bf16* sp = reinterpret_cast<const bf16*>(p.ws_s) + unit;
    float d = 0.f;
    for (int e = tid; e < TILE * NB; e += NT) {
      const float vd = (__bfloat162float(sd[e]) + __bfloat162float(sd[TILE * NB + e]))
                       + __bfloat162float(sd[2 * TILE * NB + e]);
      const float vs = (__bfloat162float(sp[e]) + __bfloat162float(sp[TILE * NB + e]))
                       + __bfloat162float(sp[2 * TILE * NB + e]);
      d = fmaf(vd, vs, d);
    }
#pragma unroll
    for (int off = 16; off >= 1; off >>= 1) d += __shfl_xor_sync(FULL, d, off);
    if (lane == 0) s_dot[hh * 4 + warp] = d;
  }
  __syncthreads();
  if (warp >= hw) return;
  // one warp a head: d(dt a) in fp64 (suffix sums of dcum, prefix sums of
  // r), ddt, the chunk's share of da_log
  const int hh = warp, h = h0 + hh;
  const float* cum = s_cum + hh * MAX_Q;
  const float* dtv = s_dt + hh * MAX_Q;
  const float seg = cum[Q - 1], ah = -expf(p.a_log[h]);
  const float dot = ((s_dot[hh * 4] + s_dot[hh * 4 + 1]) + s_dot[hh * 4 + 2])
                    + s_dot[hh * 4 + 3];
  const int64_t o = ((int64_t)bi * H + h) * S + t0;
  double suf[SCAN_PER_LANE], pre[SCAN_PER_LANE];
  double run = 0.0, runr = 0.0;
#pragma unroll
  for (int k = SCAN_PER_LANE - 1; k >= 0; --k) {
    const int t = lane * SCAN_PER_LANE + k;
    double dcv = 0.0;
    if (t < Q) {
      dcv = p.ws_dA[o + t] + s_dci[hh * MAX_Q + t];
      if (t == Q - 1) dcv += (double)(expf(seg) * dot);
    }
    run += dcv;
    suf[k] = run;
  }
#pragma unroll
  for (int k = 0; k < SCAN_PER_LANE; ++k) {
    const int t = lane * SCAN_PER_LANE + k;
    pre[k] = runr;  // r over this lane's entries before t
    runr += t < Q ? (double)p.ws_r[o + t] : 0.0;
  }
  double incl = run, inclr = runr;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double dn = __shfl_down_sync(FULL, incl, off);
    const double up = __shfl_up_sync(FULL, inclr, off);
    if (lane + off < 32) incl += dn;
    if (lane >= off) inclr += up;
  }
  const double above = incl - run;     // dcum over the lanes above
  const double before = inclr - runr;  // r over the lanes below
  double da = 0.0;
#pragma unroll
  for (int k = 0; k < SCAN_PER_LANE; ++k) {
    const int t = lane * SCAN_PER_LANE + k;
    if (t < Q) {
      const double ddta = (above + suf[k]) + (before + pre[k]);
      da += (double)dtv[t] * ddta;
      float* d = p.ddt + bi * p.ddt_sb + h * p.ddt_sh + (t0 + t) * p.ddt_ss;
      *d = *d + ah * (float)ddta;  // pass 2 wrote the direct terms
    }
  }
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1) da += __shfl_xor_sync(FULL, da, off);
  if (lane == 0) p.ws_da[((int64_t)bi * H + h) * nch + ch] = da;
}

template <typename K>
cudaError_t launch_tc(K kernel, dim3 grid, size_t smem, const Args& p,
                      cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int NB>
cudaError_t run(const Args& p, cudaStream_t stream) {
  static_assert(DxdbSmem<NB>::BYTES <= 232448 && DcSmem<NB>::BYTES <= 232448
                    && SweepSmem<NB>::BYTES <= 232448,
                "more shared memory than a block may use");
  const int nch = p.S / p.Q;
  cudaError_t err = launch_tc(sweep_bf16<NB>, dim3(p.H, 2 * p.B),
                              SweepSmem<NB>::BYTES, p, stream);
  if (err != cudaSuccess) return err;
  const dim3 grid(nch, p.H / p.hw, p.B);
  err = launch_tc(dxdb_bf16<NB>, grid, DxdbSmem<NB>::BYTES, p, stream);
  if (err != cudaSuccess) return err;
  return launch_tc(dc_bf16<NB>, grid, DcSmem<NB>::BYTES, p, stream);
}

}  // namespace tc

}  // namespace

// x, dy (B, H, S, P) and b, c (B, G, S, N) in dtype (0 fp32, 1 bf16), unit
// stride on P and N; dt (B, H, S) fp32; a_log (H,) fp32, contiguous;
// d_final (B, H, P, N) fp32 contiguous, or null for zero. Writes dx (x's
// shape and dtype, unit stride on P), ddt (dt's shape, fp32), da_log (H,)
// fp32 contiguous, db and dc (b's shape and dtype, unit stride on N).
// strides holds the (batch, head or group, sequence) strides, in elements,
// of x, dt, b, c, dy, dx, ddt, db, dc in that order (27 values). Q divides
// S and is at most 256; P is 8, 16, 32 or 64 and N 16, 32, 64 or 128.
// fp32 (the CUDA cores): hw is 1; ws is an fp32 workspace of 2 B H (S / Q)
// P N + 2 B H S N floats, ws_da an fp64 one of B H (S / Q); three launches.
// bf16 (the tensor cores): a block walks hw (1, 2 or 4, dividing H / G)
// heads; ws holds 3 B H (S / Q) 64 NB + 2 B (H / hw) S N + B H S floats
// (NB: N padded to 64 or 128), ws_da B H (S / Q) + B H S doubles, both
// 16-byte aligned; every row of x, dy, b and c starts on
// a 16-byte boundary; four launches. All on `stream`; returns a
// cudaError_t.
extern "C" int ssd_scan_bwd(const void* x, const float* dt, const float* a_log,
                            const void* b, const void* c, const void* dy,
                            const float* d_final, void* dx, float* ddt,
                            float* da_log, void* db, void* dc, float* ws,
                            double* ws_da, int dtype, int B, int H, int G,
                            int S, int Q, int P, int N, int hw,
                            const int64_t* strides, void* stream) {
  if (B <= 0 || H <= 0 || G <= 0 || H % G != 0 || S <= 0 || Q <= 0 ||
      Q > MAX_Q || S % Q != 0 || H > 65535 || 2 * (int64_t)B > 65535 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (!(P == 8 || P == 16 || P == 32 || P == 64)) return (int)cudaErrorInvalidValue;
  if (!(N == 16 || N == 32 || N == 64 || N == 128)) return (int)cudaErrorInvalidValue;
  if (dtype == 0 ? hw != 1
                 : !((hw == 1 || hw == 2 || hw == 4) && (H / G) % hw == 0))
    return (int)cudaErrorInvalidValue;
  const int64_t* s = strides;
  if (dtype == 1 && !(tc::rows_aligned(x, s[0], s[1], s[2])
                      && tc::rows_aligned(b, s[6], s[7], s[8])
                      && tc::rows_aligned(c, s[9], s[10], s[11])
                      && tc::rows_aligned(dy, s[12], s[13], s[14])))
    return (int)cudaErrorInvalidValue;
  const int64_t nch = S / Q;
  // the states: fp32 (P, N) a chunk, or (bf16) three bf16 part tiles of 64
  // rows by N padded to 64 or 128, in floats
  const int64_t st_elems = (int64_t)B * H * nch
                           * (dtype == 0 ? P * N : 3 * 64 * (N <= 64 ? 64 : 128) / 2);
  const int64_t d_elems = (int64_t)B * (H / hw) * S * N;
  float* ws_db = ws + 2 * st_elems;
  float* ws_dc = ws_db + d_elems;
  Args p{x, dt, a_log, b, c, dy, d_final, dx, ddt, da_log, db, dc,
         ws, ws + st_elems, ws_db, ws_dc, ws_da,
         ws_dc + d_elems, ws_da + (int64_t)B * H * nch,
         B, H, G, S, Q, P, N, dtype, hw,
         s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], s[9], s[10],
         s[11], s[12], s[13], s[14], s[15], s[16], s[17], s[18], s[19], s[20],
         s[21], s[22], s[23], s[24], s[25], s[26]};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 1) {
    err = N <= 64 ? tc::run<64>(p, st) : tc::run<128>(p, st);
  } else {
    switch (N) {
      case 16: err = by_p<16>(p, st); break;
      case 32: err = by_p<32>(p, st); break;
      case 64: err = by_p<64>(p, st); break;
      default: err = by_p<128>(p, st); break;
    }
  }
  if (err != cudaSuccess) return (int)err;
  const int64_t blocks = ((int64_t)B * G * S * N + THREADS - 1) / THREADS;
  const int gx = (int)(blocks < 132 * 16 ? blocks : 132 * 16);
  ssd_bwd_reduce<<<dim3(gx, 3), THREADS, 0, st>>>(p);
  return (int)cudaGetLastError();
}
