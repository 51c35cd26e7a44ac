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
// What bounds it on this card: at the serving prefill (B 1, S 512, H 64,
// P 64, N 128, G 1, Q 256, bf16) the function reads x, dt, B, C and writes y
// and the final state: 10.88 MB, 3.25 us at 3.35 TB/s. The two Q x Q products
// over the causal triangle and the two Q x N x P products of each
// (head, chunk) are 2.69 GFLOP in all: 2.7 us at the bf16 tensor-core peak,
// 40 us at the fp32 CUDA-core peak (67 TFLOP/s). So a kernel on the tensor
// cores would be bound by the bytes; one on the CUDA cores, like this one,
// by its arithmetic.
//
// What this first design does about it: it moves only those bytes (the
// Q x Q weights, the per-chunk states and the decays never leave the SM)
// and does the products in fp32 on the CUDA cores; tensor cores (mma.sync /
// wgmma) and TMA are later work. C.B^T is the same for all H/G heads of a
// group, and this kernel, like the TPU kernel, recomputes it per head (and
// per P-slice below): computing it once per group is a later saving.
//
// Layout. The TPU kernel carries the state in VMEM scratch across a
// sequential ("arbitrary") grid axis over chunks; Hopper runs blocks in no
// order, so here the chunk loop lives inside the block. One block of 256
// threads per (P-slice of PS = min(P, 32) columns, head, batch): column p of
// y and row p of the state depend only on column p of x, so the split is
// exact and needs no communication (B 1, H 64, P 64 gives 128 blocks for the
// 132 SMs). Per chunk the block stages in shared memory, as fp32: dt, the
// cumulative decays, the chunk's x columns (Q x PS) and the state (PS x N).
// A full fp32 Q x Q weight tile at Q 256 would be 256 KB, more than a block
// may hold (227 KB), so the intra-chunk product is tiled: for each 64-row
// tile of C and each 64-row tile of B on or below it, the block forms the
// 64 x 64 tile of W = (C B^T) . L . dt (thread (ty, tx) owns entries
// (ty + 16 i, tx + 16 j), as in the flash kernel) and multiplies it into
// x's rows. The state's update for the chunk is summed in registers while
// the diagonal tiles of B are staged, and applied after the chunk's last
// row tile has read the old state. About 136 KB of shared memory at N 128,
// one block per SM.
//
// The causal mask selects before the exponential: for j > i, cum_i - cum_j
// is positive and exp may overflow to inf, and inf * 0 would be NaN. The
// chunk length Q is any value up to 256, not only a power of two: rows and
// columns past Q are masked (x, B, C read as 0 there, dt as 0). cum is
// summed in fp64 and rounded once to fp32, so it does not depend on the
// order of the scan; the plain version sums it the same way.
//
// Tensors are addressed through (batch, head-or-group, sequence) strides in
// elements with a unit stride on P and N, so the model's (B, S, H, P) and
// (B, S, G, N) activations need no transpose or copy.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_Q = 256;  // longest chunk
constexpr int R = 64;       // rows (and columns) of one W tile
constexpr int SCAN_PER_LANE = MAX_Q / 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
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
                const float* __restrict__ a, const T* __restrict__ b,
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
  const float ah = a[h];

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

    // cum = cumsum(dt * a) in fp64 by warp 0: each lane sums 8 consecutive
    // products, then the lanes' totals are scanned with shuffles. Entries
    // past Q add 0, so they hold cum_{Q-1}.
    if (tid < 32) {
      double part[SCAN_PER_LANE];
      double run = 0.0;
#pragma unroll
      for (int k = 0; k < SCAN_PER_LANE; ++k) {
        run += (double)__fmul_rn(s_dt[tid * SCAN_PER_LANE + k], ah);
        part[k] = run;
      }
      double incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const double up = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += up;
      }
      const double excl = incl - run;
#pragma unroll
      for (int k = 0; k < SCAN_PER_LANE; ++k)
        s_cum[tid * SCAN_PER_LANE + k] = (float)(excl + part[k]);
    }
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
cudaError_t launch(const void* x, const float* dt, const float* a,
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
      static_cast<const T*>(x), dt, a, static_cast<const T*>(b),
      static_cast<const T*>(c), static_cast<T*>(y), state, H, G, S, Q, P,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9],
      st[10], st[11], st[12], st[13], st[14]);
  return cudaGetLastError();
}

template <typename T, int PS>
cudaError_t by_n(const void* x, const float* dt, const float* a, const void* b,
                 const void* c, void* y, float* state, int B, int H, int G,
                 int S, int Q, int P, int N, const int64_t* st,
                 cudaStream_t stream) {
  switch (N) {
    case 16: return launch<T, 16, PS>(x, dt, a, b, c, y, state, B, H, G, S, Q, P, st, stream);
    case 32: return launch<T, 32, PS>(x, dt, a, b, c, y, state, B, H, G, S, Q, P, st, stream);
    case 64: return launch<T, 64, PS>(x, dt, a, b, c, y, state, B, H, G, S, Q, P, st, stream);
    case 128: return launch<T, 128, PS>(x, dt, a, b, c, y, state, B, H, G, S, Q, P, st, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t by_p(const void* x, const float* dt, const float* a, const void* b,
                 const void* c, void* y, float* state, int B, int H, int G,
                 int S, int Q, int P, int N, const int64_t* st,
                 cudaStream_t stream) {
  switch (P) {
    case 8: return by_n<T, 8>(x, dt, a, b, c, y, state, B, H, G, S, Q, P, N, st, stream);
    case 16: return by_n<T, 16>(x, dt, a, b, c, y, state, B, H, G, S, Q, P, N, st, stream);
    case 32:
    case 64: return by_n<T, 32>(x, dt, a, b, c, y, state, B, H, G, S, Q, P, N, st, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x (B, H, S, P), b and c (B, G, S, N) in dtype (0 fp32, 1 bf16), unit
// stride on P and N; dt (B, H, S) fp32; a (H,) fp32, contiguous (a =
// -exp(a_log)); y (B, H, S, P) in x's dtype, unit stride on P, written
// here; state (B, H, P, N) fp32, contiguous, written here. strides holds
// the (batch, head or group, sequence) strides, in elements, of x, dt, b,
// c, y in that order (15 values). Q divides S and is at most 256. Returns a
// cudaError_t.
extern "C" int ssd_scan_fwd(const void* x, const float* dt, const float* a,
                            const void* b, const void* c, void* y,
                            float* state, int dtype, int B, int H, int G,
                            int S, int Q, int P, int N,
                            const int64_t* strides, void* stream) {
  if (B <= 0 || H <= 0 || G <= 0 || H % G != 0 || S <= 0 || Q <= 0 ||
      Q > MAX_Q || S % Q != 0 || H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)by_p<float>(x, dt, a, b, c, y, state, B, H, G, S, Q, P, N, strides, st);
  if (dtype == 1)
    return (int)by_p<__nv_bfloat16>(x, dt, a, b, c, y, state, B, H, G, S, Q, P, N, strides, st);
  return (int)cudaErrorInvalidValue;
}
