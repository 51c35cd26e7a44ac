// Causal GQA flash attention, forward (K2) and backward (K2-bwd), for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention_kernel (reached through flash_attention_pallas): the same
// function, online softmax (running max m, sum l, accumulator acc) in fp32,
// scale D^-0.5, KV head h / (H/KV) read in place, denominator max(l, 1e-30),
// output in q's dtype.
//
// What bounds it on this card: at the serving prefill shapes (B = 1, H = 16,
// KV = 2, D = 128, S = 128..512) the causal work is 2*S*(S+1)*D*H flops on
// (2*S*H*D + 2*S*KV*D) bf16 elements, 57 to 230 flops per byte: below the
// H100's ~295 bf16 flops per byte, so by the roofline the bound is the bytes
// (about 0.35 to 1.4 us at 3.35 TB/s), with the tensor-core time close
// behind at S = 512.
//
// What this first design does about it: it moves only those bytes — the
// S x S scores never leave the SM, tiles strictly above the diagonal are
// never loaded, K and V are read in place for all H/KV query heads, the
// output is written once. It does the products on the CUDA cores in fp32,
// not on the tensor cores (no wgmma, no TMA), so in practice its arithmetic,
// not memory, limits it, far from the bound. Tensor cores are later work.
//
// Layout: one block of 256 threads per (64-row query tile, head, batch).
// Q, K and V tiles are staged in shared memory as fp32 with rows padded to
// D + 1 floats, so the 16 threads that share a query row read 16 different
// key rows without bank conflicts. Thread (ty, tx) owns query rows ty + 16 i
// (i < 4), key columns tx + 16 j (j < 4) of the 64 x 64 score tile and
// output columns tx + 16 c (c < D / 16); the row max and row sum reduce over
// the 16 lanes of a half-warp with shuffles. Keys at or past S, and under
// causality keys past the query row, are masked to -1e30, so any S works.
// Tensors are addressed through (batch, sequence, head) strides in elements
// with a unit stride on D, so the model's (B, S, H, D) activations need no
// transpose.
//
// The backward has no Pallas counterpart (the JAX package differentiates
// its plain attention). At the training shapes (B = 8 microbatch rows,
// S = 256, H = 16, KV = 2, D = 128, bf16) it reads q, k, v, dO, the fp32
// output and LSE and writes dq, dk, dv: about 30 MB against 5 GFLOP of
// the five causal products, so by the roofline the bound is again the
// bytes (about 9 us), with the tensor-core time close behind. This first
// design recomputes P from the forward's LSE rather than storing it,
// never lets a score tile leave the SM, uses no atomics (each of dq, dk, dv
// is written once by one block, so the result does not depend on block
// order), and like the forward does its products in fp32 on the CUDA
// cores: its arithmetic, not memory, limits it. See the note above the
// backward kernels below.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)(BQ * (D + 1) + 2 * BK * (D + 1) + BQ * (BK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o,
                           int group, int S,
                           int64_t q_sb, int64_t q_ss, int64_t q_sh,
                           int64_t k_sb, int64_t k_ss, int64_t k_sh,
                           int64_t v_sb, int64_t v_ss, int64_t v_sh,
                           int64_t o_sb, int64_t o_ss, int64_t o_sh,
                           int causal, float scale, float* __restrict__ lse,
                           float* __restrict__ o32) {
  constexpr int DP = D + 1;   // padded fp32 row of Q, K, V
  constexpr int PP = BK + 1;  // padded fp32 row of P
  constexpr int CPT = D / 16; // output columns per thread
  extern __shared__ float smem[];
  float* sq = smem;
  float* sk = sq + BQ * DP;
  float* sv = sk + BK * DP;
  float* sp = sv + BK * DP;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / group;

  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + kvh * k_sh;
  const T* vb = v + b * v_sb + kvh * v_sh;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, c = i % D, row = q0 + r;
    sq[r * DP + c] = row < S ? to_f32(qb[row * q_ss + c]) : 0.f;
  }

  float m[4], l[4], acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }

  const int q_last = min(q0 + BQ, S) - 1;
  const int n_kt = causal ? q_last / BK + 1 : (S + BK - 1) / BK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's K, V and P are no longer read
    for (int i = tid; i < BK * D; i += THREADS) {
      const int r = i / D, c = i % D, row = k0 + r;
      const bool ok = row < S;
      sk[r * DP + c] = ok ? to_f32(kb[row * k_ss + c]) : 0.f;
      sv[r * DP + c] = ok ? to_f32(vb[row * v_ss + c]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qa[4], ka[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = sq[(ty + 16 * i) * DP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) ka[j] = sk[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], ka[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qrow = q0 + ty + 16 * i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kcol = k0 + tx + 16 * j;
        const bool valid = kcol < S && (!causal || kcol <= qrow);
        s[i][j] = valid ? s[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        rs += p;
        sp[(ty + 16 * i) * PP + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();  // P is complete

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pa[4], va[CPT];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = sp[(ty + 16 * i) * PP + kk];
#pragma unroll
      for (int c = 0; c < CPT; ++c) va[c] = sv[kk * DP + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[i][c] = fmaf(pa[i], va[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* ob = o + b * o_sb + row * o_ss + h * o_sh;
#pragma unroll
    for (int c = 0; c < CPT; ++c) ob[tx + 16 * c] = from_f32<T>(acc[i][c] / den);
    // the 16 lanes of a row hold the same m and l after the shuffles
    if (lse != nullptr && tx == 0)
      lse[((int64_t)b * gridDim.y + h) * S + row] = m[i] + logf(den);
    if (o32 != nullptr) {
      float* o32b = o32 + (((int64_t)b * S + row) * gridDim.y + h) * D;
#pragma unroll
      for (int c = 0; c < CPT; ++c) o32b[tx + 16 * c] = acc[i][c] / den;
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int H, int KV, int S,
                   int64_t q_sb, int64_t q_ss, int64_t q_sh,
                   int64_t k_sb, int64_t k_ss, int64_t k_sh,
                   int64_t v_sb, int64_t v_ss, int64_t v_sh,
                   int64_t o_sb, int64_t o_ss, int64_t o_sh,
                   int causal, float scale, float* lse, float* o32,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  auto kernel = flash_attention_fwd_kernel<T, D>;
  // set on every launch: the attribute is per device, and the call is cheap
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((S + BQ - 1) / BQ, H, B);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H / KV, S,
      q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh,
      causal, scale, lse, o32);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Backward (K2-bwd). Three launches, no atomics, so the result does not
// depend on the order blocks run in:
//   1. flash_attention_bwd_rowdot: D_i = rowsum(dO_i * O_i) in fp32 from the
//      forward's fp32 output (not its rounding to T, which would bias dS),
//      one thread per (batch, head, query row);
//   2. flash_attention_bwd_dkdv: one block per (64-key tile, KV head, batch)
//      loops over the group's H/KV query heads and the query tiles on or
//      below the diagonal, recomputes P = exp(S * scale - LSE) tile by tile
//      and keeps dK and dV for its keys in registers; each is written once;
//   3. flash_attention_bwd_dq: one block per (64-row query tile, head,
//      batch) loops over the key tiles on or below the diagonal and keeps
//      dQ for its rows in registers.
// With dP = dO V^T and dS = P * (dP - D): dV = P^T dO, dK = scale dS^T Q,
// dQ = scale dS K. Thread (ty, tx) owns score entries (ty + 16 i, tx + 16 j)
// and output rows ty + 16 i, columns tx + 16 c, as in the forward; tiles
// are fp32 in shared memory with padded rows.
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_attention_bwd_rowdot(const float* __restrict__ o32,
                           const T* __restrict__ dout,
                           float* __restrict__ dvec, int H, int S, int rows,
                           int64_t d_sb, int64_t d_ss, int64_t d_sh) {
  // one thread per (batch, head, query) row, d in order, one fused
  // multiply-add at a time: the order in which the other passes sum
  // dP = dO V^T, so a row whose P is one-hot gets dS = 0 exactly
  const int row = blockIdx.x * THREADS + threadIdx.x;
  if (row >= rows) return;
  const int i = row % S, h = (row / S) % H, b = row / (S * H);
  const float* ob = o32 + (((int64_t)b * S + i) * H + h) * D;
  const T* db = dout + b * d_sb + i * d_ss + h * d_sh;
  float acc = 0.f;
  for (int c = 0; c < D; ++c) acc = fmaf(to_f32(db[c]), ob[c], acc);
  dvec[row] = acc;  // row = (b * H + h) * S + i
}

template <int D>
constexpr size_t bwd_smem_bytes() {
  return sizeof(float) * (size_t)(4 * BQ * (D + 1) + 2 * BQ * (BK + 1) + 2 * BQ);
}

// Loads rows [r0, r0 + 64) of one head of x into an fp32 tile with padded
// rows; rows at or past S are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* base, int64_t ss,
                                          int r0, int S) {
  constexpr int DP = D + 1;
  for (int i = threadIdx.x; i < BQ * D; i += THREADS) {
    const int r = i / D, c = i % D, row = r0 + r;
    dst[r * DP + c] = row < S ? to_f32(base[row * ss + c]) : 0.f;
  }
}

// s = A_rows . B_rows^T and t = C_rows . E_rows^T over D for this thread's
// 4 x 4 entries of two 64 x 64 tiles.
template <int D>
__device__ __forceinline__ void two_products(const float* a, const float* bm,
                                             const float* c, const float* e,
                                             float s[4][4], float t[4][4],
                                             int ty, int tx) {
  constexpr int DP = D + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = t[i][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < D; ++d) {
    float aa[4], ba[4], ca[4], ea[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      aa[i] = a[(ty + 16 * i) * DP + d];
      ca[i] = c[(ty + 16 * i) * DP + d];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      ba[j] = bm[(tx + 16 * j) * DP + d];
      ea[j] = e[(tx + 16 * j) * DP + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(aa[i], ba[j], s[i][j]);
        t[i][j] = fmaf(ca[i], ea[j], t[i][j]);
      }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_attention_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ dvec, T* __restrict__ dk,
                         T* __restrict__ dv, int group, int H, int S,
                         int64_t q_sb, int64_t q_ss, int64_t q_sh,
                         int64_t k_sb, int64_t k_ss, int64_t k_sh,
                         int64_t v_sb, int64_t v_ss, int64_t v_sh,
                         int64_t d_sb, int64_t d_ss, int64_t d_sh,
                         int64_t dk_sb, int64_t dk_ss, int64_t dk_sh,
                         int64_t dv_sb, int64_t dv_ss, int64_t dv_sh,
                         int causal, float scale) {
  constexpr int DP = D + 1, PP = BK + 1, CPT = D / 16;
  extern __shared__ float smem[];
  float* sk = smem;
  float* sv = sk + BK * DP;
  float* sq = sv + BK * DP;
  float* sdo = sq + BQ * DP;
  float* sp = sdo + BQ * DP;
  float* sds = sp + BQ * PP;
  float* slse = sds + BQ * PP;
  float* sdv = slse + BQ;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int k0 = blockIdx.x * BK, kvh = blockIdx.y, b = blockIdx.z;
  load_tile<T, D>(sk, k + b * k_sb + kvh * k_sh, k_ss, k0, S);
  load_tile<T, D>(sv, v + b * v_sb + kvh * v_sh, v_ss, k0, S);

  float adk[4][CPT], adv[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) adk[i][c] = adv[i][c] = 0.f;

  const int n_qt = (S + BQ - 1) / BQ;
  const int qt0 = causal ? k0 / BQ : 0;
  for (int hh = 0; hh < group; ++hh) {
    const int h = kvh * group + hh;
    const float* lse_h = lse + ((int64_t)b * H + h) * S;
    const float* dvec_h = dvec + ((int64_t)b * H + h) * S;
    for (int qt = qt0; qt < n_qt; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();  // the previous tiles are no longer read
      load_tile<T, D>(sq, q + b * q_sb + h * q_sh, q_ss, q0, S);
      load_tile<T, D>(sdo, dout + b * d_sb + h * d_sh, d_ss, q0, S);
      if (tid < BQ) {
        const int row = q0 + tid;
        slse[tid] = row < S ? lse_h[row] : 0.f;
        sdv[tid] = row < S ? dvec_h[row] : 0.f;
      }
      __syncthreads();

      float s[4][4], dp[4][4];
      two_products<D>(sq, sk, sdo, sv, s, dp, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i, qrow = q0 + r;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j, kcol = k0 + c;
          const bool valid = qrow < S && kcol < S && (!causal || kcol <= qrow);
          const float p = valid ? expf(s[i][j] * scale - slse[r]) : 0.f;
          sp[r * PP + c] = p;
          sds[r * PP + c] = p * (dp[i][j] - sdv[r]);
        }
      }
      __syncthreads();

#pragma unroll 2
      for (int qq = 0; qq < BQ; ++qq) {
        float pa[4], da[4], oa[CPT], qa[CPT];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pa[i] = sp[qq * PP + ty + 16 * i];
          da[i] = sds[qq * PP + ty + 16 * i];
        }
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          oa[c] = sdo[qq * DP + tx + 16 * c];
          qa[c] = sq[qq * DP + tx + 16 * c];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < CPT; ++c) {
            adv[i][c] = fmaf(pa[i], oa[c], adv[i][c]);
            adk[i][c] = fmaf(da[i], qa[c], adk[i][c]);
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ty + 16 * i;
    if (row >= S) continue;
    T* dkb = dk + b * dk_sb + row * dk_ss + kvh * dk_sh;
    T* dvb = dv + b * dv_sb + row * dv_ss + kvh * dv_sh;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      dkb[tx + 16 * c] = from_f32<T>(adk[i][c] * scale);
      dvb[tx + 16 * c] = from_f32<T>(adv[i][c]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_attention_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const T* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ dvec, T* __restrict__ dq,
                       int group, int S,
                       int64_t q_sb, int64_t q_ss, int64_t q_sh,
                       int64_t k_sb, int64_t k_ss, int64_t k_sh,
                       int64_t v_sb, int64_t v_ss, int64_t v_sh,
                       int64_t d_sb, int64_t d_ss, int64_t d_sh,
                       int64_t dq_sb, int64_t dq_ss, int64_t dq_sh,
                       int causal, float scale) {
  constexpr int DP = D + 1, PP = BK + 1, CPT = D / 16;
  extern __shared__ float smem[];
  float* sq = smem;
  float* sdo = sq + BQ * DP;
  float* sk = sdo + BQ * DP;
  float* sv = sk + BK * DP;
  float* sds = sv + BK * DP;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / group;
  load_tile<T, D>(sq, q + b * q_sb + h * q_sh, q_ss, q0, S);
  load_tile<T, D>(sdo, dout + b * d_sb + h * d_sh, d_ss, q0, S);
  const float* lse_h = lse + ((int64_t)b * gridDim.y + h) * S;
  const float* dvec_h = dvec + ((int64_t)b * gridDim.y + h) * S;
  float rl[4], rd[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    rl[i] = row < S ? lse_h[row] : 0.f;
    rd[i] = row < S ? dvec_h[row] : 0.f;
  }

  float adq[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) adq[i][c] = 0.f;

  const int q_last = min(q0 + BQ, S) - 1;
  const int n_kt = causal ? q_last / BK + 1 : (S + BK - 1) / BK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous K, V and dS are no longer read
    load_tile<T, D>(sk, k + b * k_sb + kvh * k_sh, k_ss, k0, S);
    load_tile<T, D>(sv, v + b * v_sb + kvh * v_sh, v_ss, k0, S);
    __syncthreads();

    float s[4][4], dp[4][4];
    two_products<D>(sq, sk, sdo, sv, s, dp, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i, qrow = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j, kcol = k0 + c;
        const bool valid = qrow < S && kcol < S && (!causal || kcol <= qrow);
        const float p = valid ? expf(s[i][j] * scale - rl[i]) : 0.f;
        sds[r * PP + c] = p * (dp[i][j] - rd[i]);
      }
    }
    __syncthreads();

#pragma unroll 2
    for (int kk = 0; kk < BK; ++kk) {
      float da[4], ka[CPT];
#pragma unroll
      for (int i = 0; i < 4; ++i) da[i] = sds[(ty + 16 * i) * PP + kk];
#pragma unroll
      for (int c = 0; c < CPT; ++c) ka[c] = sk[kk * DP + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CPT; ++c) adq[i][c] = fmaf(da[i], ka[c], adq[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= S) continue;
    T* dqb = dq + b * dq_sb + row * dq_ss + h * dq_sh;
#pragma unroll
    for (int c = 0; c < CPT; ++c) dqb[tx + 16 * c] = from_f32<T>(adq[i][c] * scale);
  }
}

template <typename T, int D>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const float* o32, const void* dout, const float* lse,
                       float* dvec, void* dq, void* dk, void* dv,
                       int B, int H, int KV, int S, const int64_t* st,
                       int causal, float scale, cudaStream_t stream) {
  // st: (batch, sequence, head) strides of q, k, v, dout, dq, dk, dv
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tdo = static_cast<const T*>(dout);
  const int rows = B * H * S;
  flash_attention_bwd_rowdot<T, D><<<(rows + THREADS - 1) / THREADS, THREADS,
                                     0, stream>>>(
      o32, tdo, dvec, H, S, rows, st[9], st[10], st[11]);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  constexpr size_t smem_kv = bwd_smem_bytes<D>();
  auto kdkdv = flash_attention_bwd_dkdv<T, D>;
  err = cudaFuncSetAttribute(kdkdv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_kv);
  if (err != cudaSuccess) return err;
  kdkdv<<<dim3((S + BK - 1) / BK, KV, B), THREADS, smem_kv, stream>>>(
      tq, tk, tv, tdo, lse, dvec, static_cast<T*>(dk), static_cast<T*>(dv),
      H / KV, H, S, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], st[9], st[10], st[11], st[15], st[16], st[17], st[18], st[19],
      st[20], causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  constexpr size_t smem_q = sizeof(float) * (size_t)(4 * BQ * (D + 1) + BQ * (BK + 1));
  auto kdq = flash_attention_bwd_dq<T, D>;
  err = cudaFuncSetAttribute(kdq, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_q);
  if (err != cudaSuccess) return err;
  kdq<<<dim3((S + BQ - 1) / BQ, H, B), THREADS, smem_q, stream>>>(
      tq, tk, tv, tdo, lse, dvec, static_cast<T*>(dq), H / KV, S, st[0], st[1],
      st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11],
      st[12], st[13], st[14], causal, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; the stride of
// the last (D) axis must be 1. lse and o32, if not null, receive for the
// backward the fp32 log-sum-exp of each row's scaled scores, (B, H, S)
// contiguous, and the output before its rounding to T, (B, S, H, D)
// contiguous. Returns a cudaError_t (0 on success).
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype,
    int B, int H, int KV, int S, int D,
    int64_t q_sb, int64_t q_ss, int64_t q_sh,
    int64_t k_sb, int64_t k_ss, int64_t k_sh,
    int64_t v_sb, int64_t v_ss, int64_t v_sh,
    int64_t o_sb, int64_t o_ss, int64_t o_sh,
    int causal, float scale, float* lse, float* o32, void* stream) {
  if (B <= 0 || H <= 0 || KV <= 0 || S <= 0 || H % KV != 0 || H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FA_LAUNCH(T, DIM)                                                       \
  return (int)launch<T, DIM>(q, k, v, o, B, H, KV, S, q_sb, q_ss, q_sh, k_sb,   \
                             k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh,    \
                             causal, scale, lse, o32, st)
  if (dtype == 0 && D == 64) FA_LAUNCH(float, 64);
  if (dtype == 0 && D == 128) FA_LAUNCH(float, 128);
  if (dtype == 1 && D == 64) FA_LAUNCH(__nv_bfloat16, 64);
  if (dtype == 1 && D == 128) FA_LAUNCH(__nv_bfloat16, 128);
#undef FA_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// The backward of flash_attention_fwd. q, k, v, dout and dq, dk, dv
// (written here) in the forward's layout; o32 and lse from the forward
// ((B, S, H, D) and (B, H, S), fp32, contiguous); dvec is (B, H, S) fp32
// scratch. strides holds the (batch, sequence, head) strides, in elements,
// of q, k, v, dout, dq, dk, dv in that order (21 values). Returns a
// cudaError_t.
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const float* o32,
    const void* dout, const float* lse, float* dvec, void* dq, void* dk,
    void* dv, int dtype, int B, int H, int KV, int S, int D,
    const int64_t* strides, int causal, float scale, void* stream) {
  if (B <= 0 || H <= 0 || KV <= 0 || S <= 0 || H % KV != 0 || H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FA_BWD(T, DIM)                                                        \
  return (int)launch_bwd<T, DIM>(q, k, v, o32, dout, lse, dvec, dq, dk, dv, B, \
                                 H, KV, S, strides, causal, scale, st)
  if (dtype == 0 && D == 64) FA_BWD(float, 64);
  if (dtype == 0 && D == 128) FA_BWD(float, 128);
  if (dtype == 1 && D == 64) FA_BWD(__nv_bfloat16, 64);
  if (dtype == 1 && D == 128) FA_BWD(__nv_bfloat16, 128);
#undef FA_BWD
  return (int)cudaErrorInvalidValue;
}
