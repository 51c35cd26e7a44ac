// Building blocks of the port's tensor-core kernels for Hopper (sm_90a):
// asynchronous 16-byte copies (cp.async) into tiles in the 128-byte
// swizzled layout that wgmma reads, wgmma descriptors for K-major and
// MN-major operands, the warpgroup products the kernels use, and the split
// of an fp32 pair into two or three bf16 parts. Included by
// flash_attention.cu (K2, K2-bwd), ssd_scan.cu (K4) and ssd_scan_bwd.cu
// (K4-bwd); a change here rebuilds all three (kernels/_build.py hashes
// every csrc/*.cuh).
//
// A warpgroup (4 warps, 128 threads) keeps a 64-row accumulator in
// registers in wgmma's layout: warp w holds rows 16 w .. 16 w + 15; thread
// (g = lane / 4, t = lane % 4) holds rows g and g + 8, columns 8 n + 2 t and
// 8 n + 2 t + 1 of each 8-column n-tile n, as acc[4 n + e]. That layout,
// for two adjacent n-tiles, is also the layout of a 16-column A operand in
// registers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {
namespace tc {

using bf16 = __nv_bfloat16;
constexpr int TILE = 64;  // rows of a tile
constexpr int NT = 128;   // threads of a warpgroup: 4 warps of 16 rows

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  // ok == false writes 16 zero bytes and reads nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// a barrier for the n threads (whole warps) of one group; id 0 is the
// block's own __syncthreads
__device__ __forceinline__ void group_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// Element offset of 16-byte chunk c of row r of a tile in the layout wgmma
// reads with 128-byte swizzling: D / 64 blocks of ROWS rows of 64 elements
// (128 bytes), chunk c % 8 of row r of a block at chunk (c % 8) ^ (r % 8).
// Every 8 rows of a block are one 1024-byte swizzle atom; tiles start on
// 1024-byte boundaries.
template <int ROWS>
__device__ __forceinline__ int gmma_off(int r, int c) {
  return (c >> 3) * ROWS * 64 + r * 64 + (((c & 7) ^ (r & 7)) << 3);
}

// Rows [r0, r0 + ROWS) of one head (row stride ss elements, 16-byte
// aligned, D columns) into a tile of DP >= D columns in gmma_off's layout,
// 16 bytes per copy, by THREADS threads of which this is thread t; rows at
// or past S, and columns D .. DP - 1, are zeros, so a masked probability
// never meets a NaN and a padded column adds exact zeros.
template <int D, int ROWS, int THREADS, int DP = D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* base,
                                          int64_t ss, int r0, int S, int t) {
  constexpr int CH = DP / 8, REAL = D / 8;
  static_assert(ROWS * CH % THREADS == 0, "whole copies per thread");
#pragma unroll
  for (int j = 0; j < ROWS * CH / THREADS; ++j) {
    const int i = t + j * THREADS, r = i / CH, c = i % CH;
    const int row = r0 + r;
    // a zero-filled copy reads nothing; its source stays inside the row
    cp_async16(saddr(dst + gmma_off<ROWS>(r, c)),
               base + (int64_t)min(row, S - 1) * ss + min(c, REAL - 1) * 8,
               row < S && c < REAL);
  }
}

// wgmma: a warpgroup's asynchronous product; operands in shared memory are
// named by a descriptor (start address, leading and stride byte offsets,
// 128-byte swizzle)
__device__ __forceinline__ uint64_t gmma_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((saddr(p) & 0x3FFFF) >> 4)
         | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16)
         | ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}
// k-step kk (columns 16 kk ..) of a K-major 64-row tile in gmma_off's
// layout: 32 bytes into a 128-byte row, 8-row atoms 1024 bytes apart
__device__ __forceinline__ uint64_t gmma_k_major(const bf16* tile, int kk) {
  return gmma_desc(tile + (kk >> 2) * TILE * 64 + (kk & 3) * 16, 16, 1024);
}
// k-step j (rows 16 j ..) of an MN-major 64-row tile in gmma_off's layout
// (rows are the product's K): 64-column blocks TILE * 128 bytes apart,
// 8-row atoms 1024 bytes apart
__device__ __forceinline__ uint64_t gmma_mn_major(const bf16* tile, int j) {
  return gmma_desc(tile + j * 16 * 64, TILE * 128, 1024);
}
__device__ __forceinline__ void gmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void gmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void gmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// the registers of an accumulator are written by wgmma behind the
// compiler's back: no read of them may move above the wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
// what this thread's cp.async wrote becomes visible to wgmma's reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d (64 x 64, fp32) (+)= A B^T, A and B K-major in shared memory: a product
// of one k-step; accumulate == 0 overwrites d
__device__ __forceinline__ void wgmma_ss_n64(float d[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
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
// d (64 x 64, fp32) += A B over one k-step: A (bf16) in registers, B
// MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_n64(float d[32], const uint32_t a[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
// d (64 x 128, fp32) += A B over one k-step: A (bf16) in registers, B
// MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_n128(float d[64], const uint32_t a[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  return bits(__floats2bfloat162_rn(lo, hi));
}
// (a, b) as a bf16 pair and the bf16 pair of what that rounding lost
__device__ __forceinline__ void split(float a, float b, uint32_t& hi,
                                      uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = pack(a - hf.x, b - hf.y);
}
// (a, b) as three bf16 pairs: the bf16 of each, then of what each rounding
// left (together within ~2^-24 of a and b)
__device__ __forceinline__ void split3(float a, float b, uint32_t& p0,
                                       uint32_t& p1, uint32_t& p2) {
  const __nv_bfloat162 h0 = __floats2bfloat162_rn(a, b);
  const float2 f0 = __bfloat1622float2(h0);
  const float ra = a - f0.x, rb = b - f0.y;
  const __nv_bfloat162 h1 = __floats2bfloat162_rn(ra, rb);
  const float2 f1 = __bfloat1622float2(h1);
  p0 = bits(h0);
  p1 = bits(h1);
  p2 = pack(ra - f1.x, rb - f1.y);
}

// The asynchronous copies read 16 bytes at a time: every row of q, k, v
// (and dout) must start on a 16-byte boundary.
__host__ inline bool rows_aligned(const void* p, int64_t sb, int64_t ss,
                                  int64_t sh) {
  const int64_t e = sizeof(bf16);
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0 && (sb * e) % 16 == 0
         && (ss * e) % 16 == 0 && (sh * e) % 16 == 0;
}

}  // namespace tc
}  // namespace
