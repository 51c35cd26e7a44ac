// Causal GQA flash attention, forward, for Hopper (sm_90a).
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
                           int causal, float scale) {
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
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int H, int KV, int S,
                   int64_t q_sb, int64_t q_ss, int64_t q_sh,
                   int64_t k_sb, int64_t k_ss, int64_t k_sh,
                   int64_t v_sb, int64_t v_ss, int64_t v_sh,
                   int64_t o_sb, int64_t o_ss, int64_t o_sh,
                   int causal, float scale, cudaStream_t stream) {
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
      causal, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; the stride of
// the last (D) axis must be 1. Returns a cudaError_t (0 on success).
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype,
    int B, int H, int KV, int S, int D,
    int64_t q_sb, int64_t q_ss, int64_t q_sh,
    int64_t k_sb, int64_t k_ss, int64_t k_sh,
    int64_t v_sb, int64_t v_ss, int64_t v_sh,
    int64_t o_sb, int64_t o_ss, int64_t o_sh,
    int causal, float scale, void* stream) {
  if (B <= 0 || H <= 0 || KV <= 0 || S <= 0 || H % KV != 0 || H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FA_LAUNCH(T, DIM)                                                       \
  return (int)launch<T, DIM>(q, k, v, o, B, H, KV, S, q_sb, q_ss, q_sh, k_sb,   \
                             k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh,    \
                             causal, scale, st)
  if (dtype == 0 && D == 64) FA_LAUNCH(float, 64);
  if (dtype == 0 && D == 128) FA_LAUNCH(float, 128);
  if (dtype == 1 && D == 64) FA_LAUNCH(__nv_bfloat16, 64);
  if (dtype == 1 && D == 128) FA_LAUNCH(__nv_bfloat16, 128);
#undef FA_LAUNCH
  return (int)cudaErrorInvalidValue;
}
