// Flash attention forward for Hopper (sm_90a), with attention dropout.
//
// Replaces the TPU kernel ops/flash_attention.py::_fwd_kernel of the JAX
// package (launched by _flash_forward's pallas_call):
//
//   s   = (q . k^T) * scale + key_bias         fp32 accumulation
//   m,l = running row max and denominator      fp32, over the unrounded,
//                                              UNdropped p
//   p'  = p * keep * inv  (dropout only)       keep_mask.cuh, global coords
//   acc = acc * alpha + round(p') . v          p' rounded to the input dtype
//   O   = acc / l  (input dtype),  lse = m + log(l)  (fp32)
//
// Bound on the card. At the serving path's largest shape (B=128, H=12,
// L=128, D=64, bf16) the kernel must move q, k, v and O (12.6 M elements
// each, 2 bytes) plus lse: 101.5 MB, 30 us at 3.35 TB/s. It does 6.4 GFLOP,
// 6.5 us at the bf16 tensor-core peak. So it is bound by bytes: the design
// reads each q, k and v element from device memory once per (query tile,
// key tile) pair and writes O and lse once, and keeps the L x L scores in
// registers and shared memory only. Dropout adds no bytes: the keep bits
// are hashed in registers from the seed words and the coordinates.
//
// Design (simple and right first; tensor cores are later work):
//   * one CTA per (batch, head, 64-row query tile); 256 threads as a 16 x 16
//     grid, each thread owning a 4 x 4 register tile of the scores and of O;
//   * the CTA loops over 64-row key tiles in order, replacing the TPU's
//     sequential grid; q, k, v and p tiles are staged in shared memory as
//     fp32 (q, k and p transposed so every inner-loop read is a 16-byte
//     vector), 68 KB in all, above the 48 KB static limit, so it is dynamic;
//   * products of bf16 values are exact in fp32, so fp32 FMAs over the
//     widened inputs give the TPU kernel's "bf16 inputs, fp32 accumulation";
//   * the ragged edge is masked in the kernel: key columns past Lk score
//     -inf (weight exactly 0) and query rows past Lq are not stored, so any
//     L works;
//   * the key bias -1e9 is added as the finite number it is. A row whose
//     keys are all masked (the bucket's pad rows) then comes out uniform
//     with l > 0, as in the JAX kernel; no key tile is ever skipped;
//   * dropout is a template branch: at rate 0 (serving, evaluation) the
//     kernel is the same code as before, with no hash work at all.
// Only head_dim 64 is built; the wrapper raises for any other.

#include <math.h>

#include "flash_tile.cuh"
#include "keep_mask.cuh"

namespace {

using namespace flash;

constexpr int kSmemBytes = 4 * kTileFloats * (int)sizeof(float);

// Reduce over the 16 threads that share a row group (lanes differing in
// their low four bits).
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 1; off < 16; off <<= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 1; off < 16; off <<= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T, bool kDrop>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ bias,
                     T* __restrict__ o, float* __restrict__ lse, int H,
                     int Lq, int Lk, float scale, DropParams drop) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* qt = smem;               // [kD][kLd]     q tile, transposed
  float* kt = qt + kTileFloats;   // [kD][kLd]     k tile, transposed
  float* vs = kt + kTileFloats;   // [kTile][kLd]  v tile
  float* pt = vs + kTileFloats;   // [kTile][kLd]  p tile, transposed

  const int q0 = blockIdx.x * kTile;
  const int bh = blockIdx.y;  // b * H + h
  const int b = bh / H;
  const T* qb = q + (size_t)bh * Lq * kD;
  const T* kb = k + (size_t)bh * Lk * kD;
  const T* vb = v + (size_t)bh * Lk * kD;
  const float* biasb = bias + (size_t)b * Lk;

  const int tx = threadIdx.x % 16;  // key columns (scores) / dims (O)
  const int ty = threadIdx.x / 16;  // query rows ty*4 .. ty*4+3

  uint32_t s0 = 0, s1 = 0;
  if (kDrop) {
    s0 = (uint32_t)drop.seed[0];
    s1 = (uint32_t)drop.seed[1];
  }

  load_tile<T, true>(qb, q0, Lq, qt);

  float m[4], l[4], acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }
  zero_4x4(acc);

  for (int k0 = 0; k0 < Lk; k0 += kTile) {
    __syncthreads();  // the previous step is done with kt, vs and pt
    load_tile<T, true>(kb, k0, Lk, kt);
    load_tile<T, false>(vb, k0, Lk, vs);
    __syncthreads();

    float s[4][4];
    zero_4x4(s);
    mma_4x4(qt, kt, ty * 4, tx * 4, s);

    // Scale, key bias, and the ragged edge: a column past Lk is no key.
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = k0 + tx * 4 + j;
      const bool live = col < Lk;
      const float bj = live ? biasb[col] : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        s[i][j] = live ? s[i][j] * scale + bj : -INFINITY;
    }

    // Online softmax. Every row sees column k0 < Lk, so m_new is finite.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        rs += p;  // the denominator takes the undropped p
        float pv = p;
        if (kDrop) {
          const bool keep =
              keep_bit(s0, s1, (uint32_t)b, (uint32_t)(bh - b * H),
                       (uint32_t)(q0 + ty * 4 + i),
                       (uint32_t)(k0 + tx * 4 + j), drop.thresh);
          pv = keep ? p * drop.inv : 0.f;
        }
        pt[(tx * 4 + j) * kLd + ty * 4 + i] = Elem<T>::round(pv);
      }
      l[i] = l[i] * alpha + row_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    mma_4x4(pt, vs, ty * 4, tx * 4, acc);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= Lq) continue;
    T* orow = o + ((size_t)bh * Lq + row) * kD;
#pragma unroll
    for (int j = 0; j < 4; ++j) orow[tx * 4 + j] = Elem<T>::out(acc[i][j] / l[i]);
    if (tx == 0) lse[(size_t)bh * Lq + row] = m[i] + logf(l[i]);
  }
}

template <typename T, bool kDrop>
int launch_t(const void* q, const void* k, const void* v, const void* bias,
             void* o, void* lse, int B, int H, int Lq, int Lk, float scale,
             DropParams drop, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, kDrop>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Lq + kTile - 1) / kTile, B * H);
  flash_fwd_kernel<T, kDrop><<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(bias),
      static_cast<T*>(o), static_cast<float*>(lse), H, Lq, Lk, scale, drop);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* bias,
           void* o, void* lse, const void* seed, int B, int H, int Lq,
           int Lk, float scale, unsigned int thresh, float inv,
           void* stream) {
  DropParams drop{static_cast<const int64_t*>(seed), thresh, inv};
  cudaStream_t s = (cudaStream_t)stream;
  if (seed == nullptr)
    return launch_t<T, false>(q, k, v, bias, o, lse, B, H, Lq, Lk, scale,
                              drop, s);
  return launch_t<T, true>(q, k, v, bias, o, lse, B, H, Lq, Lk, scale, drop,
                           s);
}

}  // namespace

// q, k, v, o: contiguous [B, H, L, 64]; bias: contiguous fp32 [B, Lk];
// lse: fp32 [B, H, Lq]; seed: two int64 words on the device, or null for
// no dropout (then thresh and inv are unused). Returns the cudaError_t of
// the launch.
extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v,
                              const void* bias, void* o, void* lse,
                              const void* seed, int B, int H, int Lq, int Lk,
                              float scale, unsigned int thresh, float inv,
                              void* stream) {
  return launch<__nv_bfloat16>(q, k, v, bias, o, lse, seed, B, H, Lq, Lk,
                               scale, thresh, inv, stream);
}

extern "C" int flash_fwd_f32(const void* q, const void* k, const void* v,
                             const void* bias, void* o, void* lse,
                             const void* seed, int B, int H, int Lq, int Lk,
                             float scale, unsigned int thresh, float inv,
                             void* stream) {
  return launch<float>(q, k, v, bias, o, lse, seed, B, H, Lq, Lk, scale,
                       thresh, inv, stream);
}
