// RMSNorm forward for Hopper (sm_90a): K1.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rmsnorm.py::
// rmsnorm_kernel (reached through rmsnorm_pallas): per row of D,
//
//   y = (x * rsqrt(sum(x^2) / D + eps)) * w,
//
// with fp32 math and w fp32, y rounded to nearest in x's dtype (fp32,
// bf16 or fp16).
//
// What bounds it on this card: bytes. Each element is read once and
// written once (plus the fp32 weight row) for about four flops, far below
// the ~20 fp32 flops per byte at which the H100's arithmetic would become
// the limit. At the main paths' shapes the bytes take one to five
// microseconds at most, so the launch and one trip to memory are most of
// the time: at the decode shapes (8 rows of 2048 or 4096) the launch
// itself is the floor, and what is left to win there is the host's cost
// per call, which the ctypes binding keeps to one C call.
//
// What the design does about it:
// * A block per row, each thread CPT = 2 chunks of 16 bytes (at D 2048 in
//   bf16, 128 threads of 16 values), so a row's serial work is short: a
//   warp per row (64 values a lane at D 2048) is slower than the memory,
//   held up by each lane's chain of adds and products; one chunk a thread
//   spends more on the reduction across warps, four on each thread's
//   chain (tools/rmsnorm_variants.py times both).
// * All of a thread's loads are issued before any arithmetic: its x
//   chunks and their weights (through the read-only path, __ldg), so a
//   row pays one trip to memory.
// * The sum of squares: each thread adds its own values in index order,
//   __shfl_xor_sync reduces each warp (the butterfly leaves every lane
//   the same bits: each step adds the same two partial sums, in either
//   order), and every thread adds the warps' sums from shared memory in
//   warp order after one __syncthreads. The order is fixed, so a second
//   call gives the same bits.
// * Anything the 16-byte loads cannot take (a row that is not a multiple
//   of 16 bytes, a pointer off a 16-byte boundary, a row of more than
//   MAX_THREADS * CPT_MAX chunks) takes the scalar route: a warp per row,
//   one element a lane at a time, x read twice (the second time from the
//   caches). The Python wrapper picks the route (rmsnorm.rmsnorm_route);
//   the entry point refuses a vector route whose pointers or row do not
//   allow it.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_THREADS = 1024;   // threads of a row's block
constexpr int CPT_MAX = 4;          // chunks a thread, vector route
constexpr int SCALAR_WARPS = 4;     // rows per block, scalar route

enum Route { kVector = 0, kScalar = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}

// 16 bytes of a row, as raw words (members of trivial types only)
union Bits {
  uint4 u;
  float f[4];
  unsigned short h[8];
};

// E elements of T in 16 bytes, read from and written to Bits as fp32
template <typename T> struct Elt;
template <> struct Elt<float> {
  static constexpr int E = 4;
  static __device__ __forceinline__ float get(const Bits& b, int j) { return b.f[j]; }
  static __device__ __forceinline__ void put(Bits& b, int j, float v) { b.f[j] = v; }
};
template <> struct Elt<__nv_bfloat16> {
  static constexpr int E = 8;
  static __device__ __forceinline__ float get(const Bits& b, int j) {
    return __bfloat162float(__ushort_as_bfloat16(b.h[j]));
  }
  static __device__ __forceinline__ void put(Bits& b, int j, float v) {
    b.h[j] = __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
};
template <> struct Elt<__half> {
  static constexpr int E = 8;
  static __device__ __forceinline__ float get(const Bits& b, int j) {
    return __half2float(__ushort_as_half(b.h[j]));
  }
  static __device__ __forceinline__ void put(Bits& b, int j, float v) {
    b.h[j] = __half_as_ushort(__float2half_rn(v));
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// component k of q (k a constant once the loops are unrolled)
__device__ __forceinline__ float part_of(const float4& q, int k) {
  return k == 0 ? q.x : k == 1 ? q.y : k == 2 ? q.z : q.w;
}

// The scale of a row from its sum of squares, rounded op by op.
__device__ __forceinline__ float row_scale(float ss, int d, float eps) {
  return rsqrtf(__fadd_rn(__fdiv_rn(ss, (float)d), eps));
}

// Vector route: one block per row, CPT chunks a thread, in registers.
template <typename T, int CPT>
__global__ void __launch_bounds__(MAX_THREADS)
rmsnorm_vector(const T* __restrict__ x, const float* __restrict__ w,
               T* __restrict__ y, int d, float eps) {
  constexpr int E = Elt<T>::E;
  __shared__ float part[MAX_THREADS / 32];
  const int nchunks = d / E;
  const int64_t row = blockIdx.x;
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * d);
  const float4* w4 = reinterpret_cast<const float4*>(w);
  Bits v[CPT];
  float4 wq[CPT][E / 4];
#pragma unroll
  for (int i = 0; i < CPT; ++i) {
    const int c = threadIdx.x + i * blockDim.x;
    v[i].u = c < nchunks ? __ldg(xr + c) : make_uint4(0u, 0u, 0u, 0u);
  }
#pragma unroll
  for (int i = 0; i < CPT; ++i) {
    const int c = threadIdx.x + i * blockDim.x;
#pragma unroll
    for (int q = 0; q < E / 4; ++q)
      wq[i][q] = c < nchunks ? __ldg(w4 + c * (E / 4) + q)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < CPT; ++i)
#pragma unroll
    for (int j = 0; j < E; ++j) {
      const float f = Elt<T>::get(v[i], j);
      ss = __fadd_rn(ss, __fmul_rn(f, f));
    }
  ss = warp_sum(ss);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = ss;
  __syncthreads();
  float total = 0.f;
  for (int k = 0; k < (int)(blockDim.x >> 5); ++k) total = __fadd_rn(total, part[k]);
  const float r = row_scale(total, d, eps);
  uint4* yr = reinterpret_cast<uint4*>(y + row * d);
#pragma unroll
  for (int i = 0; i < CPT; ++i) {
    const int c = threadIdx.x + i * blockDim.x;
    if (c < nchunks) {
      Bits out;
#pragma unroll
      for (int j = 0; j < E; ++j)
        Elt<T>::put(out, j, __fmul_rn(__fmul_rn(Elt<T>::get(v[i], j), r),
                                      part_of(wq[i][j / 4], j % 4)));
      yr[c] = out.u;
    }
  }
}

// Scalar route: one warp per row, one element a lane at a time.
template <typename T>
__global__ void __launch_bounds__(SCALAR_WARPS * 32)
rmsnorm_scalar(const T* __restrict__ x, const float* __restrict__ w,
               T* __restrict__ y, int64_t rows, int d, float eps) {
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * SCALAR_WARPS + (threadIdx.x >> 5);
  if (row >= rows) return;
  const T* xr = x + row * d;
  float ss = 0.f;
#pragma unroll 4
  for (int i = lane; i < d; i += 32) {
    const float f = to_f32(xr[i]);
    ss = __fadd_rn(ss, __fmul_rn(f, f));
  }
  const float r = row_scale(warp_sum(ss), d, eps);
  T* yr = y + row * d;
#pragma unroll 4
  for (int i = lane; i < d; i += 32)
    yr[i] = from_f32<T>(__fmul_rn(__fmul_rn(to_f32(xr[i]), r), __ldg(w + i)));
}

template <typename T, int CPT>
void launch_vector(const T* x, const float* w, T* y, int64_t rows, int d,
                   int nchunks, float eps, cudaStream_t st) {
  const int threads = ((nchunks + CPT - 1) / CPT + 31) / 32 * 32;
  rmsnorm_vector<T, CPT><<<(unsigned)rows, threads, 0, st>>>(x, w, y, d, eps);
}

template <typename T>
cudaError_t launch(const void* xv, const float* w, void* yv, int64_t rows,
                   int d, int route, float eps, cudaStream_t st) {
  const T* x = static_cast<const T*>(xv);
  T* y = static_cast<T*>(yv);
  const int64_t row_bytes = (int64_t)d * sizeof(T);
  if (route == kScalar) {
    const unsigned blocks = (unsigned)((rows + SCALAR_WARPS - 1) / SCALAR_WARPS);
    rmsnorm_scalar<T><<<blocks, SCALAR_WARPS * 32, 0, st>>>(x, w, y, rows, d, eps);
    return cudaGetLastError();
  }
  // the vector route: every row, and w, on 16-byte boundaries
  if (route != kVector) return cudaErrorInvalidValue;
  if (row_bytes % 16 != 0 || ((uintptr_t)x | (uintptr_t)y | (uintptr_t)w) % 16 != 0)
    return cudaErrorMisalignedAddress;
  if (row_bytes / 16 > (int64_t)MAX_THREADS * CPT_MAX) return cudaErrorInvalidValue;
  // two chunks a thread, or four where two would take more than a block
  const int nchunks = (int)(row_bytes / 16);
  if (nchunks <= 2 * MAX_THREADS)
    launch_vector<T, 2>(x, w, y, rows, d, nchunks, eps, st);
  else
    launch_vector<T, 4>(x, w, y, rows, d, nchunks, eps, st);
  return cudaGetLastError();
}

}  // namespace

// x, y: (rows, d) contiguous, of one dtype (0 = float32, 1 = bfloat16,
// 2 = float16); w: (d,) float32. route: 0 = vector (a block per row; rows
// of a multiple of 16 bytes up to 64 KB, x, y and w on 16-byte
// boundaries), 1 = scalar (anything else). Launches on `stream`; returns
// a cudaError_t (0 on success).
extern "C" int rmsnorm_fwd(const void* x, const float* w, void* y,
                           int64_t rows, int d, int dtype, int route,
                           float eps, void* stream) {
  if (rows < 1 || rows > 0x7fffffff || d < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch<float>(x, w, y, rows, d, route, eps, st);
    case 1: return (int)launch<__nv_bfloat16>(x, w, y, rows, d, route, eps, st);
    case 2: return (int)launch<__half>(x, w, y, rows, d, route, eps, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
