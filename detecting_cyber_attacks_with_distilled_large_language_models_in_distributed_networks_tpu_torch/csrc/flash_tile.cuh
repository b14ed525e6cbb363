// Tile plumbing shared by the flash kernels (flash_fwd.cu, flash_bwd.cu):
// 64 x 64 tiles of fp32 in shared memory, 256 threads as a 16 x 16 grid
// that each own a 4 x 4 register block, and loads that widen bf16 or fp32
// rows of a [rows, 64] matrix with 16-byte vector reads. Used by K2, K3 and
// the fp32 instantiation of K1; K1's bf16 instantiation runs on the tensor
// cores (mma_bf16.cuh).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

constexpr int kD = 64;         // head dim (the only one built)
constexpr int kTile = 64;      // rows of a query or key tile
constexpr int kLd = 68;        // shared row stride in floats (16-byte rows)
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int kTileFloats = kTile * kLd;

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static constexpr int kVec = 4;  // elements per 16-byte load
  __device__ static void load(const float* src, float* dst) {
    float4 v = *reinterpret_cast<const float4*>(src);
    dst[0] = v.x;
    dst[1] = v.y;
    dst[2] = v.z;
    dst[3] = v.w;
  }
  __device__ static float round(float x) { return x; }
  __device__ static float out(float x) { return x; }
};

template <>
struct Elem<__nv_bfloat16> {
  static constexpr int kVec = 8;
  __device__ static void load(const __nv_bfloat16* src, float* dst) {
    uint4 raw = *reinterpret_cast<const uint4*>(src);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 f = __bfloat1622float2(h[i]);
      dst[2 * i] = f.x;
      dst[2 * i + 1] = f.y;
    }
  }
  // Round to nearest even, as JAX's astype(bfloat16).
  __device__ static float round(float x) {
    return __bfloat162float(__float2bfloat16(x));
  }
  __device__ static __nv_bfloat16 out(float x) { return __float2bfloat16(x); }
};

// Rows [row0, row0 + kTile) of a [rows, kD] matrix whose row r starts at
// src + r * ld (elements; 16-byte aligned, last dim contiguous) into shared
// memory as fp32; rows past `rows` are zero. kTranspose stores dst[d][r].
template <typename T, bool kTranspose>
__device__ void load_tile(const T* __restrict__ src, int row0, int rows,
                          float* dst, int64_t ld = kD) {
  constexpr int V = Elem<T>::kVec;
  constexpr int kChunks = kD / V;
  for (int idx = threadIdx.x; idx < kTile * kChunks; idx += kThreads) {
    const int r = idx / kChunks;
    const int c = (idx % kChunks) * V;
    float vals[V];
    if (row0 + r < rows) {
      Elem<T>::load(src + (row0 + r) * ld + c, vals);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) vals[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < V; ++e) {
      if (kTranspose) {
        dst[(c + e) * kLd + r] = vals[e];
      } else {
        dst[r * kLd + c + e] = vals[e];
      }
    }
  }
}

__device__ __forceinline__ void load4(const float* p, float out[4]) {
  float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}

// acc[i][j] += sum_c a[c][row0 + i] * b[c][col0 + j] over c < kTile, with
// a and b stored [c][kLd]: the 4 x 4 outer-product step every product of
// the flash kernels is made of (row0 = 4 * ty, col0 = 4 * tx).
__device__ __forceinline__ void mma_4x4(const float* a, const float* b,
                                        int row0, int col0, float acc[4][4]) {
#pragma unroll 8
  for (int c = 0; c < kTile; ++c) {
    float x[4], y[4];
    load4(a + c * kLd + row0, x);
    load4(b + c * kLd + col0, y);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
  }
}

__device__ __forceinline__ void zero_4x4(float acc[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
}

}  // namespace flash
