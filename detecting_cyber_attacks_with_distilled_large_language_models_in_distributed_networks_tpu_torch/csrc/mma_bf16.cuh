// Tensor-core plumbing for bf16 tiles (sm_80 and later, built for sm_90a):
// 64-column bf16 tiles in shared memory with an XOR swizzle, 16-byte
// cp.async loads that zero-fill past the ragged edge, ldmatrix fragment
// loads, the mma.sync m16n8k16 product with fp32 accumulation, and the
// quad reductions over the accumulator's row owners.
//
// Fragment layout of mma.m16n8k16.row.col (lane = 4 * g + t):
//   A [16 x 16]: a0 = (row g, cols 2t, 2t+1),   a1 = (row g+8, cols 2t, 2t+1),
//                a2 = (row g, cols 2t+8, 2t+9), a3 = (row g+8, cols 2t+8, 2t+9)
//   B [16 x 8]:  b0 = (rows 2t, 2t+1, col g),   b1 = (rows 2t+8, 2t+9, col g)
//   C [16 x 8]:  c0, c1 = (row g, cols 2t, 2t+1); c2, c3 = (row g+8, same)
// so the four lanes of a quad (same g) own one row of C between them.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace mma {

constexpr int kCols = 64;                 // bf16 columns of a tile row
constexpr int kRowBytes = kCols * 2;      // 128: eight 16-byte chunks
constexpr int kTileRows = 64;
constexpr int kTileBytes = kTileRows * kRowBytes;  // 8 KB

// Byte offset of 16-byte chunk c (0..7) of row r in a [rows][64] bf16
// tile. Chunk c of row r is stored at chunk c ^ (r % 8): the eight rows
// an ldmatrix phase reads (same logical chunk, consecutive rows) then
// fall on eight different 4-bank groups, so fragment loads, cp.async
// stores and the epilogue's row writes are free of bank conflicts.
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (uint32_t)(r * kRowBytes + ((c ^ (r & 7)) << 4));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; writes zeros when !valid
// (src must still be a valid address).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(n));
}

// 4 bytes global -> shared, asynchronously; zeros when !valid.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [row0, row0 + 64) of a [rows, 64] bf16 matrix whose row r starts at
// src + r * ld (elements; 16-byte aligned) into a swizzled tile at `dst`,
// by kThreads threads (8 consecutive threads copy one 128-byte row).
// Rows past `rows` are zero.
template <int kThreads>
__device__ __forceinline__ void load_tile_async(uint32_t dst,
                                                const __nv_bfloat16* src,
                                                int64_t ld, int row0,
                                                int rows) {
#pragma unroll
  for (int it = 0; it < kTileRows * 8 / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int r = i >> 3, c = i & 7;
    const bool ok = row0 + r < rows;
    const __nv_bfloat16* p = ok ? src + (row0 + r) * ld + c * 8 : src;
    cp_async16(dst + swz(r, c), p, ok);
  }
}

// Four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i.
__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t r[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// The same, each matrix transposed (a B fragment from a row-major [k][n]
// tile).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t addr,
                                                  uint32_t r[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a . b on the tensor cores: bf16 inputs, fp32 accumulation.
__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4],
                                          uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two fp32 values -> one register of two bf16, each rounded to nearest
// even (lo in the low half), as JAX's astype(bfloat16).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __float22bfloat162_rn(make_float2(lo, hi));
  return *reinterpret_cast<uint32_t*>(&v);
}

// Max and sum over the four lanes of a quad (one accumulator row).
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

}  // namespace mma
