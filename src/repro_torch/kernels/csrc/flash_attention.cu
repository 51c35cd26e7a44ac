// Causal GQA flash attention, forward (K2) and backward (K2-bwd), for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention_kernel (reached through flash_attention_pallas): the same
// function, online softmax (running max m, sum l, accumulator acc) in fp32,
// scale D^-0.5, KV head h / (H/KV) read in place, denominator max(l, 1e-30),
// output in q's dtype. The backward has no Pallas counterpart (the JAX
// package differentiates its plain attention).
//
// Two routes, chosen by dtype (each dtype has one; neither falls back):
//   bf16 -> the tensor cores (namespace tc below): the main paths' route;
//   fp32 -> the CUDA cores (fmaf): kept for the fp32 references that hold
//           the card to the CPU within 1e-5, which TF32 would not meet.
//
// What bounds the bf16 kernels at the main paths' shapes (qwen2.5-3b:
// H 16, KV 2, D 128), by the roofline of one H100 SXM (3.35 TB/s, 989
// bf16 TFLOP/s dense):
//   forward, serving prefill B 1, S 512: 1.08 GFLOP of causal products on
//     4.7 MB of q, k, v, o: bytes 1.41 us, flops 1.09 us -> bytes;
//   forward, training B 8, S 256 (it also writes the fp32 output and the
//     LSE): 2.16 GFLOP on 35.7 MB: bytes 10.7 us, flops 2.2 us -> bytes;
//   backward, B 8, S 256: 5.4 GFLOP of five causal products on ~46 MB:
//     bytes 13.8 us, flops 5.4 us -> bytes.
// The first design did its products as fp32 fmaf on the CUDA cores (67
// TFLOP/s at best, ~5.5 reached) from fp32 tiles converted one element at
// a time and loaded synchronously: its arithmetic, not the bytes, set its
// time.
//
// What this design does about it:
//   - every product is a wgmma (HGMMA: the warpgroup's asynchronous
//     tensor-core product, bf16 in, fp32 accumulators), its B operand and
//     (for S = Q K^T and its kin) its A operand read straight from shared
//     memory through descriptors, P and dS fed from registers;
//   - K/V (forward, dQ pass) and Q/dO with their LSE and D_i rows (dK/dV
//     pass) stream through a two-stage ring in shared memory by cp.async,
//     16 bytes a thread: tile t + 1 is in flight while tile t is computed
//     on. Tiles are bf16 in wgmma's 128-byte swizzled layout (no padding,
//     no conversion, no transpose);
//   - tiles strictly above the diagonal are neither loaded nor computed;
//     only the diagonal tile and a ragged last tile are masked;
//   - the dK/dV pass has one 64-key tile per (KV head, batch) to share
//     among 8 heads' query tiles, 64 tiles at the training shape: a
//     cluster of two blocks of two warpgroups deals the steps among four
//     warpgroups and adds their sums in a fixed order, with no atomics.
// Tried and dropped, measured on the card (PERF.md): splitting the
// forward's key loop between two warpgroups or two clustered blocks, a
// third ring stage, and issuing the next tile's S = Q K^T before the
// softmax: each was slower at the main shapes.
//
// Numerics (bf16): scores and products accumulate in fp32; scores go to
// log2 units with scale * log2(e) folded in, for exp2f. In the forward, P
// enters the tensor cores as a bf16 high part plus the bf16 of the
// rounding's remainder (two products): rounded once, P would put the
// output up to ~0.49 of a bf16 ulp of its row's largest value from the
// fp32 reference before the output's own rounding, too close to the
// 1-ulp gate; split, under 0.001 (tools/flash_rounding.py). In the backward,
// P and dS are rounded to bf16 once (~0.6 ulp against a 2-ulp gate). No
// atomics and fixed summation orders: the same inputs give the same bits
// on every call.
//
// Head dims: 16, 32, 64 and 128 (the Pallas kernel takes any D; the
// configs reach 16 in the smoke configuration the launchers run, 64 and
// 128 at published width). wgmma's 128-byte swizzled layout, which the
// descriptors in hopper.cuh assume, holds rows of 64 bf16 columns; a D 16
// row is 32 bytes and a D 32 row 64. Of the two sound designs (narrower
// tiles in the 32- and 64-byte swizzle modes with descriptors to match,
// or the 128-byte layout zero-filled to 64 columns) the bf16 route takes
// the second: the tiles, the copies and every descriptor stay those of D
// 64, which the card has checked, and only the copies change, writing
// zeros (cp.async with no source bytes) into columns D .. 63. The
// products whose K is the head dim (S = Q K^T, dP = dO V^T and their
// transposes) take D's own one or two k-steps and read no padding; the
// ones whose N is the head dim (P V, dV, dK, dQ) run at N 64 and their
// columns D .. 63 are exact zeros, never written out. That is 4x (D 16)
// or 2x (D 32) the tensor-core work of those products, at shapes where
// the bytes, not the products, set the time. The fp32 route's thread
// layout (output columns tx + 16 c, c < D / 16) covers D 16 and 32 as it
// is; its padded rows are 17 and 33 floats, odd strides like 65 and 129,
// so its column reads stay free of bank conflicts.
//
// Layout: tensors are addressed through (batch, sequence, head) strides in
// elements with a unit stride on D, so the model's (B, S, H, D)
// activations need no transpose; bf16 rows must start on 16-byte
// boundaries (checked here, and with a ValueError by kernels/ops.py).
//
// Measured by chip_smoke.py on one NVIDIA H100 80GB HBM3, 700.00 W (ms;
// the first design's time beside it):
//   K2, B 1, S 512:        0.01484 (first 0.19709; SDPA 0.01277; bound
//                          0.00141)
//   K2, B 8, S 256, with the fp32 output and LSE: 0.02598 (SDPA forward
//                          0.01446; bound 0.01068)
//   K2-bwd, B 8, S 256:    0.06730 (first 1.15629; SDPA backward 0.07563;
//                          bound 0.01381)
// ptxas at D 128: forward 201 registers and 80 KB of shared memory (two
// blocks an SM), dQ 196 and 96 KB (two), dK/dV 228 and 162 KB (one); no
// spills.
//
// The fp32 route, below, is the first design unchanged: one block of 256
// threads per (64-row query tile, head, batch), Q, K and V tiles staged
// in shared memory as fp32 with rows padded to D + 1 floats; thread
// (ty, tx) owns query rows ty + 16 i (i < 4), key columns tx + 16 j
// (j < 4) and output columns tx + 16 c (c < D / 16), and the row max and
// sum reduce over the 16 lanes of a half-warp. Keys at or past S, and
// under causality keys past the query row, are masked to -1e30. Its
// backward recomputes P from the forward's LSE and sums dP = dO V^T in
// the order the row-dot pass sums D_i, so a one-key row gets dS = 0.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }

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

// ---------------------------------------------------------------------------
// bf16: every product on wgmma (warpgroup tensor-core products, fp32
// accumulators), tiles streamed through shared memory by cp.async.
//
// A warpgroup (4 warps, 128 threads) owns a block's 64-row tile (query rows
// in the forward and the dQ pass, key rows in the dK/dV pass) and keeps its
// accumulators in registers in wgmma's layout: warp w holds rows 16 w ..
// 16 w + 15; thread (g = lane / 4, t = lane % 4) holds rows g and g + 8,
// columns 8 n + 2 t and 8 n + 2 t + 1 of each 8-column n-tile n, as
// acc[4 n + e]. That layout, for two adjacent n-tiles, is also the layout
// of a 16-column A operand in registers: P and dS go from one product's
// accumulator to the next product's A operand without touching shared
// memory.
//
// Tiles are bf16 in shared memory in the layout wgmma reads with 128-byte
// swizzling (gmma_off). A product whose operand's contiguous axis (D) is
// its K reads it K-major (Q, K, V, dO in S = Q K^T, dP = dO V^T and their
// transposes); one whose contiguous axis is its N reads it MN-major, with
// wgmma's transpose bit, from the same tile (V in P V, dO in P^T dO, Q in
// dS^T Q, K in dS K): no tile is ever transposed.
//
// Blocks whose loops run longest are started first. In the dK/dV pass the
// first key tile's loop over every query tile of 8 heads is the critical
// path: two blocks of a cluster, two warpgroups each, deal its steps
// among them, and the partial sums are added at the end through shared
// memory (the cluster's distributed shared memory between the blocks), in
// a fixed order.
// ---------------------------------------------------------------------------
namespace tc {

namespace cg = cooperative_groups;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Whether score (row, col) of a tile is a real one: col < S and, under
// causality, col <= row; rows past S never reach the output.
__device__ __forceinline__ bool valid(int row, int col, int S, int causal) {
  return row < S && col < S && (!causal || col <= row);
}

// A row with a single key (query 0 under causality, or S == 1) has a
// softmax that is constant, so its dS is zero: set exactly, not as
// dP - D_i of two sums taken in different orders (the tensor cores' and
// the row-dot's), which would leave dq's row 0 a rounding error away from
// the exact zero autograd gives.
__device__ __forceinline__ bool single_key(int row, int S, int causal) {
  return causal ? row == 0 : S == 1;
}

// The width of a head's tiles in shared memory: D, or 64 for a narrower
// head (D 16, 32), whose columns D .. 63 are zero-filled (see the note at
// the top of the file). The products whose N is the head dim run at this
// width; the ones whose K is the head dim take only D's own k-steps.
template <int D>
__host__ __device__ constexpr int padded() {
  return D < 64 ? 64 : D;
}

// ---------------------------------------------------------------------------
// Forward: one block of 4 warps per (64-row query tile, head, batch), the
// longest rows' blocks first. Each warp keeps its 16 rows' running max,
// sum and accumulator across the key tiles on or below the diagonal,
// whose K and V stream through a two-stage ring.
// ---------------------------------------------------------------------------
template <int D>
constexpr size_t fwd_smem() {
  return sizeof(bf16) * (size_t)(5 * TILE * padded<D>());  // Q, 2 x (K, V)
}

template <int D>
__global__ void __launch_bounds__(NT, 2)
fa_fwd_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
            const bf16* __restrict__ v, bf16* __restrict__ o, int group, int S,
            int64_t q_sb, int64_t q_ss, int64_t q_sh,
            int64_t k_sb, int64_t k_ss, int64_t k_sh,
            int64_t v_sb, int64_t v_ss, int64_t v_sh,
            int64_t o_sb, int64_t o_ss, int64_t o_sh,
            int causal, float scale, float* __restrict__ lse,
            float* __restrict__ o32) {
  // n-tiles of the output and of the products' N (DP / 8: the padded
  // columns of a narrow head are computed as zeros and never written)
  constexpr int DP = padded<D>(), NO = D / 8, NP = DP / 8;
  extern __shared__ __align__(1024) unsigned char tc_smem[];
  bf16* sq = reinterpret_cast<bf16*>(tc_smem);
  bf16* ring = sq + TILE * DP;  // stage s: K at ring + 2 s TILE DP, V after

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * TILE;  // longest rows first
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / group;
  const bf16* qb = q + b * q_sb + h * q_sh;
  const bf16* kb = k + b * k_sb + kvh * k_sh;
  const bf16* vb = v + b * v_sb + kvh * v_sh;
  const int q_last = min(q0 + TILE, S) - 1;
  const int n_kt = causal ? q_last / TILE + 1 : (S + TILE - 1) / TILE;

  load_tile<D, TILE, NT, DP>(sq, qb, q_ss, q0, S, threadIdx.x);
  load_tile<D, TILE, NT, DP>(ring, kb, k_ss, 0, S, threadIdx.x);
  load_tile<D, TILE, NT, DP>(ring + TILE * DP, vb, v_ss, 0, S, threadIdx.x);
  cp_commit();

  const float sl2 = scale * LOG2E;  // scores in log2 units: exp2f below
  const int r0 = warp * 16 + (lane >> 2), cq = 2 * (lane & 3);
  float acc[4 * NP];  // acc[4 n + e]: the C layout's n-tile n, entry e
#pragma unroll
  for (int i = 0; i < 4 * NP; ++i) acc[i] = 0.f;
  float mrow[2] = {NEG_INF, NEG_INF}, lrow[2] = {0.f, 0.f};

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * TILE;
    const bf16* sk = ring + (kt & 1) * 2 * TILE * DP;
    const bf16* sv = sk + TILE * DP;
    if (kt + 1 < n_kt) {  // the next K and V tiles load while this one runs
      bf16* nk = ring + ((kt + 1) & 1) * 2 * TILE * DP;
      load_tile<D, TILE, NT, DP>(nk, kb, k_ss, k0 + TILE, S, threadIdx.x);
      load_tile<D, TILE, NT, DP>(nk + TILE * DP, vb, v_ss, k0 + TILE, S,
                                 threadIdx.x);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    fence_proxy_async();
    __syncthreads();

    float s[32];  // s[4 n + e]
    gmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(s, gmma_k_major(sq, kk), gmma_k_major(sk, kk), kk > 0);
    gmma_commit();
    gmma_wait();
    fence_regs(s);

    const bool edge = (causal && k0 + TILE - 1 > q0) || k0 + TILE > S;
    float mx[2] = {mrow[0], mrow[1]};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[4 * n + e] * sl2;
        if (edge && !valid(q0 + r0 + 8 * (e >> 1), k0 + 8 * n + cq + (e & 1),
                           S, causal))
          x = NEG_INF;
        s[4 * n + e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      alpha[i] = exp2f(mrow[i] - mx[i]);
      mrow[i] = mx[i];
      lrow[i] *= alpha[i];  // this thread's share of the row sum
    }
    // P in bf16 as the high part and the rounding's remainder: P V is two
    // products, so the weights that reach V are P to ~2^-16. The C layout
    // of n-tiles 2 j, 2 j + 1 is the A layout of k-step j.
    uint32_t phi[4][4], plo[4][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = exp2f(s[4 * n + e] - mx[e >> 1]);
        lrow[e >> 1] += p[e];
      }
      split(p[0], p[1], phi[n >> 1][2 * (n & 1)], plo[n >> 1][2 * (n & 1)]);
      split(p[2], p[3], phi[n >> 1][2 * (n & 1) + 1],
            plo[n >> 1][2 * (n & 1) + 1]);
    }
#pragma unroll
    for (int i = 0; i < 4 * NP; ++i) acc[i] *= alpha[(i >> 1) & 1];
    gmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint64_t dv = gmma_mn_major(sv, j);
      if constexpr (DP == 128) {
        wgmma_rs_n128(acc, phi[j], dv);
        wgmma_rs_n128(acc, plo[j], dv);
      } else {
        wgmma_rs_n64(acc, phi[j], dv);
        wgmma_rs_n64(acc, plo[j], dv);
      }
    }
    gmma_commit();
    gmma_wait();
    fence_regs(acc);
    __syncthreads();  // this stage is refilled on the next iteration
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    lrow[i] += __shfl_xor_sync(0xffffffffu, lrow[i], 1);
    lrow[i] += __shfl_xor_sync(0xffffffffu, lrow[i], 2);
    const int row = q0 + r0 + 8 * i;
    if (row >= S) continue;
    const float den = fmaxf(lrow[i], 1e-30f);
    bf16* ob = o + b * o_sb + row * o_ss + h * o_sh;
    float* o32b = o32 == nullptr
                      ? nullptr
                      : o32 + (((int64_t)b * S + row) * gridDim.y + h) * D;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const float x0 = acc[4 * n + 2 * i] / den;
      const float x1 = acc[4 * n + 2 * i + 1] / den;
      *reinterpret_cast<__nv_bfloat162*>(ob + 8 * n + cq) =
          __floats2bfloat162_rn(x0, x1);
      if (o32b != nullptr)
        *reinterpret_cast<float2*>(o32b + 8 * n + cq) = make_float2(x0, x1);
    }
    if (lse != nullptr && (lane & 3) == 0)
      lse[((int64_t)b * gridDim.y + h) * S + row] =
          (mrow[i] + log2f(den)) * LN2;
  }
}

// D_i = rowsum(dO_i * O_i) from the forward's fp32 output. Each warp takes
// ROWDOT_ROWS (batch, head, query) rows and loads all of them, one vector
// per lane and row, before it sums any (enough bytes in flight to keep the
// memory busy); each row reduces through a fixed shuffle tree, so the same
// bits come every run.
constexpr int ROWDOT_ROWS = 4;

template <int D>
__global__ void __launch_bounds__(256)
fa_rowdot_bf16(const float* __restrict__ o32, const bf16* __restrict__ dout,
               float* __restrict__ dvec, int H, int S, int rows,
               int64_t d_sb, int64_t d_ss, int64_t d_sh) {
  // D 128 and 64: one float4 or float2 per lane; D 32 and 16: one value
  // per lane for the first D lanes, the rest add zeros
  static_assert(D == 16 || D == 32 || D == 64 || D == 128, "head dim");
  constexpr int R = ROWDOT_ROWS, E = D >= 64 ? D / 32 : 1;
  const int lane = threadIdx.x & 31;
  const bool on = lane * E < D;
  const int row0 = (blockIdx.x * 8 + (threadIdx.x >> 5)) * R;
  float ov[R][E], dv[R][E];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int row = min(row0 + j, rows - 1);
    const int i = row % S, h = (row / S) % H, b = row / (S * H);
    const float* ob = o32 + (((int64_t)b * S + i) * H + h) * D + lane * E;
    const bf16* db = dout + b * d_sb + i * d_ss + h * d_sh + lane * E;
    if constexpr (E == 1) {
      ov[j][0] = on ? *ob : 0.f;
      dv[j][0] = on ? __bfloat162float(*db) : 0.f;
    } else if constexpr (E == 4) {
      const float4 x = *reinterpret_cast<const float4*>(ob);
      const uint2 y = *reinterpret_cast<const uint2*>(db);
      const float2 d01 = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&y.x));
      const float2 d23 = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&y.y));
      ov[j][0] = x.x, ov[j][1] = x.y, ov[j][2] = x.z, ov[j][3] = x.w;
      dv[j][0] = d01.x, dv[j][1] = d01.y, dv[j][2] = d23.x, dv[j][3] = d23.y;
    } else {
      const float2 x = *reinterpret_cast<const float2*>(ob);
      const float2 d01 = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(db));
      ov[j][0] = x.x, ov[j][1] = x.y;
      dv[j][0] = d01.x, dv[j][1] = d01.y;
    }
  }
#pragma unroll
  for (int j = 0; j < R; ++j) {
    float acc = dv[j][0] * ov[j][0];
#pragma unroll
    for (int e = 1; e < E; ++e) acc = fmaf(dv[j][e], ov[j][e], acc);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    // row = (b * H + h) * S + i
    if (lane == 0 && row0 + j < rows) dvec[row0 + j] = acc;
  }
}

// ---------------------------------------------------------------------------
// dK/dV: a cluster of two blocks of two warpgroups per (64-key tile, KV
// head, batch), warp w of a warpgroup owning keys 16 w .. 16 w + 15. The
// (query head, query tile) steps on or below the diagonal are dealt to the
// four warpgroups in turn; each streams its Q and dO tiles, LSE and D_i
// rows through its own ring. Per step: S^T = K Q^T and dP^T = V dO^T on
// wgmma from shared memory, then P^T and dS^T in registers as the A
// operand of dV += P^T dO and dK += dS^T Q. At the end the four partial
// sums meet in block 0's warpgroup 0, always added in the same order.
// ---------------------------------------------------------------------------
template <int D>
constexpr size_t dkdv_smem() {
  // K, V; per warpgroup 2 x (Q, dO) tiles; per warpgroup 2 x (LSE, D_i)
  return sizeof(bf16) * (size_t)(10 * TILE * padded<D>())
         + sizeof(float) * 8 * TILE;
}

template <int D>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(2 * NT, 1)
fa_bwd_dkdv_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ dvec, bf16* __restrict__ dk,
                 bf16* __restrict__ dv, int group, int H, int S,
                 int64_t q_sb, int64_t q_ss, int64_t q_sh,
                 int64_t k_sb, int64_t k_ss, int64_t k_sh,
                 int64_t v_sb, int64_t v_ss, int64_t v_sh,
                 int64_t d_sb, int64_t d_ss, int64_t d_sh,
                 int64_t dk_sb, int64_t dk_ss, int64_t dk_sh,
                 int64_t dv_sb, int64_t dv_ss, int64_t dv_sh,
                 int causal, float scale) {
  constexpr int DP = padded<D>(), NO = D / 8, NP = DP / 8;
  extern __shared__ __align__(1024) unsigned char tc_smem[];
  bf16* sk = reinterpret_cast<bf16*>(tc_smem);
  bf16* sv = sk + TILE * DP;
  const int wg = threadIdx.x / NT, wt = threadIdx.x % NT;
  const int warp = wt >> 5, lane = threadIdx.x & 31;
  // warpgroup wg's ring: stage s holds Q at ring + 2 s TILE DP, dO after
  // it, and LSE at rows + 2 s TILE, D_i after it
  bf16* ring = sv + TILE * DP + wg * 4 * TILE * DP;
  float* rows = reinterpret_cast<float*>(sv + 9 * TILE * DP) + wg * 4 * TILE;

  // the two blocks of a cluster share a key tile: block `rank` takes
  // steps 2 rank + wg, then every fourth
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int k0 = (blockIdx.x >> 1) * TILE, kvh = blockIdx.y, b = blockIdx.z;
  load_tile<D, TILE, 2 * NT, DP>(sk, k + b * k_sb + kvh * k_sh, k_ss, k0,
                                 S, threadIdx.x);
  load_tile<D, TILE, 2 * NT, DP>(sv, v + b * v_sb + kvh * v_sh, v_ss, k0,
                                 S, threadIdx.x);
  cp_commit();

  const int n_qt = (S + TILE - 1) / TILE;
  const int qt0 = causal ? (blockIdx.x >> 1) : 0;
  const int per_head = n_qt - qt0, n_it = group * per_head;
  auto fetch = [&](int it, int stage) {
    const int h = kvh * group + it / per_head;
    const int q0 = (qt0 + it % per_head) * TILE;
    bf16* dst = ring + stage * 2 * TILE * DP;
    load_tile<D, TILE, NT, DP>(dst, q + b * q_sb + h * q_sh, q_ss, q0, S,
                               wt);
    load_tile<D, TILE, NT, DP>(dst + TILE * DP, dout + b * d_sb + h * d_sh,
                               d_ss, q0, S, wt);
    const int row = q0 + (wt & (TILE - 1));
    const float* src = (wt < TILE ? lse : dvec) + ((int64_t)b * H + h) * S
                       + min(row, S - 1);
    cp_async4(saddr(rows + stage * 2 * TILE + wt), src, row < S);
  };
  const int first = 2 * rank + wg;
  if (first < n_it) fetch(first, 0);
  cp_commit();
  cp_wait<1>();  // K, V
  fence_proxy_async();
  __syncthreads();

  const float sl2 = scale * LOG2E;
  const int kr = warp * 16 + (lane >> 2), cq = 2 * (lane & 3);
  float adk[4 * NP], adv[4 * NP];  // [4 n + e]: n-tile n, entry e
#pragma unroll
  for (int i = 0; i < 4 * NP; ++i) adk[i] = adv[i] = 0.f;

  for (int it = first, st = 0; it < n_it; it += 4, st ^= 1) {
    if (it + 4 < n_it) {
      fetch(it + 4, st ^ 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    fence_proxy_async();
    group_sync(1 + wg, NT);
    const int q0 = (qt0 + it % per_head) * TILE;
    const bf16* sq = ring + st * 2 * TILE * DP;
    const bf16* sdo = sq + TILE * DP;
    const float* slse = rows + st * 2 * TILE;
    const float* sdv = slse + TILE;

    float sT[32], dpT[32];  // [4 n + e]
    gmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(sT, gmma_k_major(sk, kk), gmma_k_major(sq, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(dpT, gmma_k_major(sv, kk), gmma_k_major(sdo, kk), kk > 0);
    gmma_commit();
    gmma_wait();
    fence_regs(sT);
    fence_regs(dpT);

    const bool edge = (causal && q0 < k0 + TILE - 1) || q0 + TILE > S
                      || k0 + TILE > S;
    uint32_t pa[4][4], da[4][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      float p[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = 8 * n + cq + (e & 1);
        p[e] = exp2f(fmaf(sT[4 * n + e], sl2, -slse[qc] * LOG2E));
        ds[e] = p[e] * (dpT[4 * n + e] - sdv[qc]);
        if (edge) {
          const int qrow = q0 + qc, key = k0 + kr + 8 * (e >> 1);
          if (!valid(qrow, key, S, causal)) p[e] = ds[e] = 0.f;
          if (single_key(qrow, S, causal)) ds[e] = 0.f;
        }
      }
      pa[n >> 1][2 * (n & 1)] = pack(p[0], p[1]);
      pa[n >> 1][2 * (n & 1) + 1] = pack(p[2], p[3]);
      da[n >> 1][2 * (n & 1)] = pack(ds[0], ds[1]);
      da[n >> 1][2 * (n & 1) + 1] = pack(ds[2], ds[3]);
    }
    gmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if constexpr (DP == 128) {
        wgmma_rs_n128(adv, pa[j], gmma_mn_major(sdo, j));
        wgmma_rs_n128(adk, da[j], gmma_mn_major(sq, j));
      } else {
        wgmma_rs_n64(adv, pa[j], gmma_mn_major(sdo, j));
        wgmma_rs_n64(adk, da[j], gmma_mn_major(sq, j));
      }
    }
    gmma_commit();
    gmma_wait();
    fence_regs(adv);
    fence_regs(adk);
    group_sync(1 + wg, NT);  // this stage is refilled on the next step
  }

  // the rings are idle now. Warpgroup 1 hands its dK, dV to warpgroup 0
  // through its own ring; then block 1's warpgroup 0 hands the block's sum
  // to block 0's through the ring of block 0's warpgroup 0; block 0 adds
  // them in that order (the real n-tiles only)
  float* xch = reinterpret_cast<float*>(sv + TILE * DP) + wt;  // wg 0's ring
  float* xch1 = xch + 4 * TILE * DP / 2;                       // wg 1's ring
  if (wg == 1) {
#pragma unroll
    for (int i = 0; i < 4 * NO; ++i) {
      xch1[i * NT] = adk[i];
      xch1[(4 * NO + i) * NT] = adv[i];
    }
  }
  __syncthreads();
  if (wg == 0) {
#pragma unroll
    for (int i = 0; i < 4 * NO; ++i) {
      adk[i] += xch1[i * NT];
      adv[i] += xch1[(4 * NO + i) * NT];
    }
  }
  cluster.sync();  // block 0's warpgroup-0 ring is free
  if (rank == 1 && wg == 0) {
    float* to = cluster.map_shared_rank(xch, 0);
#pragma unroll
    for (int i = 0; i < 4 * NO; ++i) {
      to[i * NT] = adk[i];
      to[(4 * NO + i) * NT] = adv[i];
    }
  }
  cluster.sync();
  if (rank == 1 || wg == 1) return;
#pragma unroll
  for (int i = 0; i < 4 * NO; ++i) {
    adk[i] += xch[i * NT];
    adv[i] += xch[(4 * NO + i) * NT];
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = k0 + kr + 8 * i;
    if (row >= S) continue;
    bf16* dkb = dk + b * dk_sb + row * dk_ss + kvh * dk_sh;
    bf16* dvb = dv + b * dv_sb + row * dv_ss + kvh * dv_sh;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(dkb + 8 * n + cq) =
          __floats2bfloat162_rn(adk[4 * n + 2 * i] * scale,
                                adk[4 * n + 2 * i + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dvb + 8 * n + cq) =
          __floats2bfloat162_rn(adv[4 * n + 2 * i], adv[4 * n + 2 * i + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// dQ: one block (one warpgroup) per (64-row query tile, head, batch), the
// longest rows' blocks first: for each key tile on or below the diagonal,
// S = Q K^T and dP = dO V^T on wgmma from shared memory, then dS in
// registers as the A operand of dQ += dS K. The next K and V tiles load
// while this one runs.
// ---------------------------------------------------------------------------
template <int D>
constexpr size_t dq_smem() {
  return sizeof(bf16) * (size_t)(6 * TILE * padded<D>());  // Q, dO, 2 x (K, V)
}

template <int D>
__global__ void __launch_bounds__(NT, 2)
fa_bwd_dq_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const bf16* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ dvec,
               bf16* __restrict__ dq, int group, int S,
               int64_t q_sb, int64_t q_ss, int64_t q_sh,
               int64_t k_sb, int64_t k_ss, int64_t k_sh,
               int64_t v_sb, int64_t v_ss, int64_t v_sh,
               int64_t d_sb, int64_t d_ss, int64_t d_sh,
               int64_t dq_sb, int64_t dq_ss, int64_t dq_sh,
               int causal, float scale) {
  constexpr int DP = padded<D>(), NO = D / 8, NP = DP / 8;
  extern __shared__ __align__(1024) unsigned char tc_smem[];
  bf16* sq = reinterpret_cast<bf16*>(tc_smem);
  bf16* sdo = sq + TILE * DP;
  bf16* ring = sdo + TILE * DP;  // stage s: K at ring + 2 s TILE DP, V after

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * TILE;
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / group;
  const bf16* kb = k + b * k_sb + kvh * k_sh;
  const bf16* vb = v + b * v_sb + kvh * v_sh;
  load_tile<D, TILE, NT, DP>(sq, q + b * q_sb + h * q_sh, q_ss, q0, S,
                             threadIdx.x);
  load_tile<D, TILE, NT, DP>(sdo, dout + b * d_sb + h * d_sh, d_ss, q0, S,
                             threadIdx.x);
  load_tile<D, TILE, NT, DP>(ring, kb, k_ss, 0, S, threadIdx.x);
  load_tile<D, TILE, NT, DP>(ring + TILE * DP, vb, v_ss, 0, S, threadIdx.x);
  cp_commit();

  const float sl2 = scale * LOG2E;
  const int r0 = warp * 16 + (lane >> 2), cq = 2 * (lane & 3);
  const float* lse_h = lse + ((int64_t)b * gridDim.y + h) * S;
  const float* dvec_h = dvec + ((int64_t)b * gridDim.y + h) * S;
  float rl[2], rd[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + r0 + 8 * i;
    rl[i] = row < S ? lse_h[row] * LOG2E : 0.f;
    rd[i] = row < S ? dvec_h[row] : 0.f;
  }
  float adq[4 * NP];  // adq[4 n + e]: the C layout's n-tile n, entry e
#pragma unroll
  for (int i = 0; i < 4 * NP; ++i) adq[i] = 0.f;

  const int q_last = min(q0 + TILE, S) - 1;
  const int n_kt = causal ? q_last / TILE + 1 : (S + TILE - 1) / TILE;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * TILE;
    const bf16* sk = ring + (kt & 1) * 2 * TILE * DP;
    const bf16* sv = sk + TILE * DP;
    if (kt + 1 < n_kt) {
      bf16* nk = ring + ((kt + 1) & 1) * 2 * TILE * DP;
      load_tile<D, TILE, NT, DP>(nk, kb, k_ss, k0 + TILE, S, threadIdx.x);
      load_tile<D, TILE, NT, DP>(nk + TILE * DP, vb, v_ss, k0 + TILE, S,
                                 threadIdx.x);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    fence_proxy_async();
    __syncthreads();

    float s[32], dp[32];  // s[4 n + e], dp[4 n + e]
    gmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(s, gmma_k_major(sq, kk), gmma_k_major(sk, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(dp, gmma_k_major(sdo, kk), gmma_k_major(sv, kk), kk > 0);
    gmma_commit();
    gmma_wait();
    fence_regs(s);
    fence_regs(dp);

    const bool edge = (causal && k0 + TILE - 1 > q0) || k0 + TILE > S
                      || q0 + TILE > S;
    uint32_t da[4][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        ds[e] = exp2f(fmaf(s[4 * n + e], sl2, -rl[i]))
                * (dp[4 * n + e] - rd[i]);
        if (edge) {
          const int qrow = q0 + r0 + 8 * i, key = k0 + 8 * n + cq + (e & 1);
          if (!valid(qrow, key, S, causal) || single_key(qrow, S, causal))
            ds[e] = 0.f;
        }
      }
      da[n >> 1][2 * (n & 1)] = pack(ds[0], ds[1]);
      da[n >> 1][2 * (n & 1) + 1] = pack(ds[2], ds[3]);
    }
    gmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if constexpr (DP == 128)
        wgmma_rs_n128(adq, da[j], gmma_mn_major(sk, j));
      else
        wgmma_rs_n64(adq, da[j], gmma_mn_major(sk, j));
    }
    gmma_commit();
    gmma_wait();
    fence_regs(adq);
    __syncthreads();  // this stage is refilled on the next iteration
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + r0 + 8 * i;
    if (row >= S) continue;
    bf16* dqb = dq + b * dq_sb + row * dq_ss + h * dq_sh;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dqb + 8 * n + cq) =
          __floats2bfloat162_rn(adq[4 * n + 2 * i] * scale,
                                adq[4 * n + 2 * i + 1] * scale);
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  // set on every launch: the attribute is per device, and the call is cheap
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int H, int KV, int S,
                   int64_t q_sb, int64_t q_ss, int64_t q_sh,
                   int64_t k_sb, int64_t k_ss, int64_t k_sh,
                   int64_t v_sb, int64_t v_ss, int64_t v_sh,
                   int64_t o_sb, int64_t o_ss, int64_t o_sh,
                   int causal, float scale, float* lse, float* o32,
                   cudaStream_t stream) {
  constexpr size_t smem = fwd_smem<D>();
  auto kernel = fa_fwd_bf16<D>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((S + TILE - 1) / TILE, H, B), NT, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), H / KV, S,
      q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh,
      causal, scale, lse, o32);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const float* o32, const void* dout, const float* lse,
                       float* dvec, void* dq, void* dk, void* dv,
                       int B, int H, int KV, int S, const int64_t* st,
                       int causal, float scale, cudaStream_t stream) {
  // st: (batch, sequence, head) strides of q, k, v, dout, dq, dk, dv
  const bf16* tq = static_cast<const bf16*>(q);
  const bf16* tk = static_cast<const bf16*>(k);
  const bf16* tv = static_cast<const bf16*>(v);
  const bf16* tdo = static_cast<const bf16*>(dout);
  const int rows = B * H * S;
  constexpr int per_block = 8 * ROWDOT_ROWS;
  fa_rowdot_bf16<D><<<(rows + per_block - 1) / per_block, 256, 0, stream>>>(
      o32, tdo, dvec, H, S, rows, st[9], st[10], st[11]);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto kdkdv = fa_bwd_dkdv_bf16<D>;
  err = allow_smem(kdkdv, dkdv_smem<D>());
  if (err != cudaSuccess) return err;
  kdkdv<<<dim3(2 * ((S + TILE - 1) / TILE), KV, B), 2 * NT, dkdv_smem<D>(),
          stream>>>(
      tq, tk, tv, tdo, lse, dvec, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), H / KV, H, S, st[0], st[1], st[2], st[3], st[4],
      st[5], st[6], st[7], st[8], st[9], st[10], st[11], st[15], st[16],
      st[17], st[18], st[19], st[20], causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto kdq = fa_bwd_dq_bf16<D>;
  err = allow_smem(kdq, dq_smem<D>());
  if (err != cudaSuccess) return err;
  kdq<<<dim3((S + TILE - 1) / TILE, H, B), NT, dq_smem<D>(), stream>>>(
      tq, tk, tv, tdo, lse, dvec, static_cast<bf16*>(dq), H / KV, S, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10],
      st[11], st[12], st[13], st[14], causal, scale);
  return cudaGetLastError();
}

}  // namespace tc

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
  if (dtype == 1 && !(tc::rows_aligned(q, q_sb, q_ss, q_sh)
                      && tc::rows_aligned(k, k_sb, k_ss, k_sh)
                      && tc::rows_aligned(v, v_sb, v_ss, v_sh)
                      && tc::rows_aligned(o, o_sb, o_ss, o_sh)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FA_LAUNCH(T, DIM)                                                       \
  return (int)launch<T, DIM>(q, k, v, o, B, H, KV, S, q_sb, q_ss, q_sh, k_sb,   \
                             k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh,    \
                             causal, scale, lse, o32, st)
  if (dtype == 0 && D == 16) FA_LAUNCH(float, 16);
  if (dtype == 0 && D == 32) FA_LAUNCH(float, 32);
  if (dtype == 0 && D == 64) FA_LAUNCH(float, 64);
  if (dtype == 0 && D == 128) FA_LAUNCH(float, 128);
#undef FA_LAUNCH
#define FA_TC(DIM)                                                             \
  return (int)tc::launch<DIM>(q, k, v, o, B, H, KV, S, q_sb, q_ss, q_sh, k_sb, \
                              k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh,  \
                              causal, scale, lse, o32, st)
  if (dtype == 1 && D == 16) FA_TC(16);
  if (dtype == 1 && D == 32) FA_TC(32);
  if (dtype == 1 && D == 64) FA_TC(64);
  if (dtype == 1 && D == 128) FA_TC(128);
#undef FA_TC
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
  if (dtype == 1) {
    const void* ts[7] = {q, k, v, dout, dq, dk, dv};
    for (int i = 0; i < 7; ++i)
      if (!tc::rows_aligned(ts[i], strides[3 * i], strides[3 * i + 1],
                            strides[3 * i + 2]))
        return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FA_BWD(T, DIM)                                                        \
  return (int)launch_bwd<T, DIM>(q, k, v, o32, dout, lse, dvec, dq, dk, dv, B, \
                                 H, KV, S, strides, causal, scale, st)
  if (dtype == 0 && D == 16) FA_BWD(float, 16);
  if (dtype == 0 && D == 32) FA_BWD(float, 32);
  if (dtype == 0 && D == 64) FA_BWD(float, 64);
  if (dtype == 0 && D == 128) FA_BWD(float, 128);
#undef FA_BWD
#define FA_TC_BWD(DIM)                                                        \
  return (int)tc::launch_bwd<DIM>(q, k, v, o32, dout, lse, dvec, dq, dk, dv, \
                                  B, H, KV, S, strides, causal, scale, st)
  if (dtype == 1 && D == 16) FA_TC_BWD(16);
  if (dtype == 1 && D == 32) FA_TC_BWD(32);
  if (dtype == 1 && D == 64) FA_TC_BWD(64);
  if (dtype == 1 && D == 128) FA_TC_BWD(128);
#undef FA_TC_BWD
  return (int)cudaErrorInvalidValue;
}
