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
// column sums and every sum after them are fp64, rounded once to fp32.
// db and dc are summed over the H / G heads of each group.
//
// Three launches, no atomics, every sum in a fixed order (the same inputs
// give the same bits on every call):
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
//
// What bounds it on this card: at the mamba2-1.3b training microbatch (B 8,
// S 512, H 64, P 64, N 128, G 1, Q 256, bf16) the function reads x, dy,
// dt, B, C, a_log and writes dx, ddt, da_log, dB, dC: 107.0 MB, 0.0319 ms
// at 3.35 TB/s. Its products (per (batch, head, chunk): C B^T, dY X^T,
// W^T dY, dCB B and dCB^T C over the causal triangle, and the state
// recompute, dS sweep, dY S_prev, B dS^T and X dS in full) are 56.0 GFLOP:
// 0.0566 ms at the bf16 tensor-core peak, 0.836 ms at the fp32 CUDA-core
// peak (67 TFLOP/s). So it is bound by its arithmetic. This first design
// runs every product on the CUDA cores in fp32 (a 4 x 4 or 4 x 8 register
// tile a thread, ~12 shared-memory loads for 32 fmaf): it is right, not
// fast. Its redesign on wgmma is queued (ROADMAP.md).
//
// Measured by chip_smoke.py on one NVIDIA H100 80GB HBM3, 700.00 W (ms,
// with the wrapper): 4.93447 at the training microbatch in bf16; 1.24231
// at B 2 in fp32. ptxas at N 128, P 64: the chunk kernel 209 registers, no
// spills, 194 KB of shared memory (one block an SM); the sweep 99.
//
// Any chunk Q <= 256 that divides S, not only a power of two (rows past Q
// are masked: x, dy, B, C read as 0 there, dt as 0); P 8, 16, 32 or 64 (P <
// 16 padded to 16 zero columns in shared memory); N 16, 32, 64 or 128. x,
// dy, B, C are bf16 or fp32 (read elementwise: no alignment rule), dt and
// a_log fp32; tensors are addressed through (batch, head-or-group,
// sequence) strides in elements with a unit stride on P and N.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
  float* ws_s;    // (B, H, n_chunks, P, N): the state entering each chunk
  float* ws_ds;   // (B, H, n_chunks, P, N): dS of the state leaving each chunk
  float* ws_db;   // (B, H, S, N): db per head
  float* ws_dc;   // (B, H, S, N): dc per head
  double* ws_da;  // (B, H, n_chunks): each chunk's sum of dt d(dt a)
  int B, H, G, S, Q, P, N, bf16;
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
  const int rep = H / G;
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
      acc += ws[(((int64_t)b * H + g * rep + k) * S + s) * N + n];
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

}  // namespace

// x, dy (B, H, S, P) and b, c (B, G, S, N) in dtype (0 fp32, 1 bf16), unit
// stride on P and N; dt (B, H, S) fp32; a_log (H,) fp32, contiguous;
// d_final (B, H, P, N) fp32 contiguous, or null for zero. Writes dx (x's
// shape and dtype, unit stride on P), ddt (dt's shape, fp32), da_log (H,)
// fp32 contiguous, db and dc (b's shape and dtype, unit stride on N).
// strides holds the (batch, head or group, sequence) strides, in elements,
// of x, dt, b, c, dy, dx, ddt, db, dc in that order (27 values). ws is an
// fp32 workspace of 2 B H (S / Q) P N + 2 B H S N floats, ws_da an fp64
// one of B H (S / Q). Q divides S and is at most 256; P is 8, 16, 32 or
// 64 and N 16, 32, 64 or 128. Three launches on `stream`; returns a
// cudaError_t.
extern "C" int ssd_scan_bwd(const void* x, const float* dt, const float* a_log,
                            const void* b, const void* c, const void* dy,
                            const float* d_final, void* dx, float* ddt,
                            float* da_log, void* db, void* dc, float* ws,
                            double* ws_da, int dtype, int B, int H, int G,
                            int S, int Q, int P, int N, const int64_t* strides,
                            void* stream) {
  if (B <= 0 || H <= 0 || G <= 0 || H % G != 0 || S <= 0 || Q <= 0 ||
      Q > MAX_Q || S % Q != 0 || H > 65535 || 2 * (int64_t)B > 65535 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (!(P == 8 || P == 16 || P == 32 || P == 64)) return (int)cudaErrorInvalidValue;
  const int64_t nch = S / Q;
  const int64_t st_elems = (int64_t)B * H * nch * P * N;
  const int64_t d_elems = (int64_t)B * H * S * N;
  const int64_t* s = strides;
  Args p{x, dt, a_log, b, c, dy, d_final, dx, ddt, da_log, db, dc,
         ws, ws + st_elems, ws + 2 * st_elems, ws + 2 * st_elems + d_elems,
         ws_da, B, H, G, S, Q, P, N, dtype,
         s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], s[9], s[10],
         s[11], s[12], s[13], s[14], s[15], s[16], s[17], s[18], s[19], s[20],
         s[21], s[22], s[23], s[24], s[25], s[26]};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (N) {
    case 16: err = by_p<16>(p, st); break;
    case 32: err = by_p<32>(p, st); break;
    case 64: err = by_p<64>(p, st); break;
    case 128: err = by_p<128>(p, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  const int64_t blocks = ((int64_t)B * G * S * N + THREADS - 1) / THREADS;
  const int gx = (int)(blocks < 132 * 16 ? blocks : 132 * 16);
  ssd_bwd_reduce<<<dim3(gx, 3), THREADS, 0, st>>>(p);
  return (int)cudaGetLastError();
}
