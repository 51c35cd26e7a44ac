// Int8 error-feedback quantization for Hopper (sm_90a): K3a (absmax) and
// K3b (quantize + residual).
//
// Replaces the two Pallas TPU kernels of src/repro/kernels/int8_ef.py
// (int8_ef_absmax_kernel and int8_ef_quantize_kernel, reached through
// int8_ef_pallas): for x = grad + error in fp32,
//
//   scale = max|x| / 127,  safe = scale > 0 ? scale : 1,
//   q     = clip(round_half_even(x / safe), -127, 127)   (int8),
//   err   = x - q * scale                                 (fp32),
//
// with q and scale bit-identical to src/repro/kernels/ref.py::int8_ef_ref
// and err bit-identical to its op-by-op evaluation.
//
// What bounds it on this card: bytes. Per element the two passes read grad
// and error twice and write 1 byte of q and 4 of err for a handful of fp32
// operations: far below the H100's ~20 fp32 flops per byte of memory.
//
// What the design does about it: each pass reads every element once, in a
// grid-stride loop whose neighbouring threads touch neighbouring addresses;
// the TPU's per-tile maxima and host-side combine become one block
// reduction per block and one atomicMax per block on the uint32 bits of a
// device scalar (non-negative floats order like their bits, so the maximum
// is exact in any order). The scale never leaves the device: K3b reads the
// maximum and derives the scale itself, so there is no host sync between
// the passes. Any length works, with no padding to the TPU's (256, 128)
// tiles: zero padding never changes the maximum.
//
// Rounding is stated op by op so the result does not depend on the
// compiler: __fadd_rn, __fdiv_rn, __fmul_rn and __fsub_rn are never
// contracted into an FMA, rintf rounds half to even as jnp.round does
// (roundf would round half away from zero).
//
// A NaN or an infinity in x behaves as in the reference: the maximum keeps
// a NaN (nan_max; fmaxf would drop it), so the scale is NaN, or +inf for an
// infinity, and every residual is NaN: a bad gradient stays visible in the
// residual and in what the sync sends (q * scale). A NaN code becomes 0,
// as the reference's float-to-int8 conversion makes it (XLA's convert and
// PTX's cvt both take NaN to 0); clamping it with fmaxf/fminf would give
// -127.
//
// err may alias error (the residual is then updated in place): each
// element is read and written by the same thread, in that order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 132 * 8;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// The maximum that keeps a NaN from either side.
__device__ __forceinline__ float nan_max(float a, float b) {
  return (b > a || b != b) ? b : a;
}

int blocks_for(int64_t n) {
  int64_t b = (n + THREADS - 1) / THREADS;
  if (b < 1) b = 1;
  return (int)(b < MAX_BLOCKS ? b : MAX_BLOCKS);
}

template <typename G>
__global__ void __launch_bounds__(THREADS)
int8_ef_absmax_kernel(const G* __restrict__ g, const float* __restrict__ e,
                      int64_t n, unsigned int* __restrict__ amax_bits) {
  float m = 0.f;
  const int64_t stride = (int64_t)gridDim.x * THREADS;
  for (int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x; i < n; i += stride)
    m = nan_max(m, fabsf(__fadd_rn(to_f32(g[i]), e[i])));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, off));
  __shared__ float warp_max[THREADS / 32];
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x < 32) {
    m = threadIdx.x < THREADS / 32 ? warp_max[threadIdx.x] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, off));
    // fabsf cleared the sign, so a NaN's bits lie above +inf's and win
    if (threadIdx.x == 0) atomicMax(amax_bits, __float_as_uint(m));
  }
}

template <typename G>
__global__ void __launch_bounds__(THREADS)
int8_ef_quantize_kernel(const G* __restrict__ g, const float* e, int64_t n,
                        const unsigned int* __restrict__ amax_bits,
                        int8_t* __restrict__ q, float* err,
                        float* __restrict__ scale_out) {
  const float scale = __fdiv_rn(__uint_as_float(*amax_bits), 127.0f);
  const float safe = scale > 0.f ? scale : 1.0f;
  if (blockIdx.x == 0 && threadIdx.x == 0) *scale_out = scale;
  const int64_t stride = (int64_t)gridDim.x * THREADS;
  for (int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x; i < n; i += stride) {
    const float x = __fadd_rn(to_f32(g[i]), e[i]);
    // through an int, as the reference's q.astype(f32): rintf may give
    // -0.0, the int8 payload never does
    const float r = rintf(__fdiv_rn(x, safe));
    const int qi = r != r ? 0 : (int)fminf(fmaxf(r, -127.0f), 127.0f);
    q[i] = (int8_t)qi;
    err[i] = __fsub_rn(x, __fmul_rn((float)qi, scale));
  }
}

}  // namespace

// g_dtype: 0 = float32, 1 = bfloat16; error is float32. Writes the bits of
// max|g + error| to *amax_bits (zeroed here first). Returns a cudaError_t.
extern "C" int int8_ef_absmax(const void* g, int g_dtype, const float* e,
                              int64_t n, unsigned int* amax_bits,
                              void* stream) {
  if (n < 0 || (g_dtype != 0 && g_dtype != 1)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(amax_bits, 0, sizeof(unsigned int), st);
  if (err != cudaSuccess) return (int)err;
  const int blocks = blocks_for(n);
  if (g_dtype == 0)
    int8_ef_absmax_kernel<float><<<blocks, THREADS, 0, st>>>(
        static_cast<const float*>(g), e, n, amax_bits);
  else
    int8_ef_absmax_kernel<__nv_bfloat16><<<blocks, THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(g), e, n, amax_bits);
  return (int)cudaGetLastError();
}

// Reads *amax_bits (from int8_ef_absmax on the same stream), writes q, err
// (which may be e itself) and *scale. Returns a cudaError_t.
extern "C" int int8_ef_quantize(const void* g, int g_dtype, const float* e,
                                int64_t n, const unsigned int* amax_bits,
                                int8_t* q, float* err, float* scale,
                                void* stream) {
  if (n < 0 || (g_dtype != 0 && g_dtype != 1)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = blocks_for(n);
  if (g_dtype == 0)
    int8_ef_quantize_kernel<float><<<blocks, THREADS, 0, st>>>(
        static_cast<const float*>(g), e, n, amax_bits, q, err, scale);
  else
    int8_ef_quantize_kernel<__nv_bfloat16><<<blocks, THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(g), e, n, amax_bits, q, err, scale);
  return (int)cudaGetLastError();
}
