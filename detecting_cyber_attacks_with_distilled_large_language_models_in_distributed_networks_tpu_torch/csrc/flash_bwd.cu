// Flash attention backward for Hopper (sm_90a): K2 (dk, dv, dbias) and K3
// (dq), with attention dropout.
//
// Replaces the TPU kernels ops/flash_attention.py::_dkdv_kernel and
// ::_dq_kernel of the JAX package (the two pallas_calls of _flash_backward).
// Both recompute each score tile from (q, k, bias, lse) instead of reading
// an L x L matrix, in fp32 throughout: q, k, v and dO are widened and p is
// NOT rounded to the input dtype (unlike the forward's p . v):
//
//   p   = exp((q . k^T) * scale + bias - lse)   the undropped softmax
//   dpn = dO . v^T,  y = p                       (rate 0)
//   dpn = dpn * keep * inv, y = p * keep * inv   (dropout; keep_mask.cuh)
//   ds  = p * (dpn - delta)                      delta = rowsum(dO * O),
//                                                computed by the caller
//   K2, per key tile:   dv = y^T . dO,  dk = scale * ds^T . q,
//                       db = colsum(ds)   (per head; the caller sums heads)
//   K3, per query tile: dq = scale * ds . k
//
// Bound on the card. At the training shape (B=16, H=12, L=128, D=64, bf16)
// each kernel reads q, k, v and dO once (12.6 MB) plus lse, delta and the
// key bias, and writes dk, dv and db (K2) or dq (K3): 19.2 MB for K2 and
// 15.9 MB for K3, 5.7 and 4.8 us at 3.35 TB/s. K2 does 4 products of
// 2 L^2 D flops per (b, h), 1.6 GFLOP, K3 3 of them, 1.2 GFLOP: 1.6 and
// 1.2 us at the bf16 tensor-core peak. Both are bound by bytes, so the design keeps the L x L
// recompute in registers and shared memory and touches each input once
// per (query tile, key tile) pair.
//
// Design (simple and right first; tensor cores are later work):
//   * no atomics: K2 runs one CTA per (batch, head, 64-row key tile) and
//     owns its dk, dv and db rows; K3 runs one CTA per (batch, head, 64-row
//     query tile) and owns its dq rows, as the TPU grid did. Gradients are
//     then the same bits from run to run;
//   * each CTA loops over the other side's 64-row tiles in order (the TPU
//     kernel's fori_loop); 256 threads as a 16 x 16 grid own 4 x 4 register
//     blocks of the score tile, then of the output tile;
//   * operand tiles are staged in shared memory as fp32, transposed where a
//     product reads them by column, so every inner-loop read is a 16-byte
//     vector: K2 holds 8 tiles (136 KB), K3 6 tiles (102 KB), both dynamic;
//   * the keep bit of every (q, k) pair is rehashed from global coordinates
//     with the forward's function, so K2 (keys outer) and K3 (queries
//     outer) see exactly K1's mask;
//   * ragged edges and pad rows: an element whose query row is past Lq or
//     whose key column is past Lk is given p = 0 and ds = 0 explicitly
//     (the zero-filled tile rows would otherwise meet an arbitrary lse), so
//     it adds nothing to dk, dv, db or dq. A fully masked query row (a pad
//     row) has a finite -1e9 bias and a finite lse, and comes out with the
//     uniform p = 1/Lk, as in JAX; no tile is ever skipped.
// Only head_dim 64 is built; the wrapper raises for any other.

#include <math.h>

#include "flash_tile.cuh"
#include "keep_mask.cuh"

namespace {

using namespace flash;

constexpr int kDkdvSmemBytes = (8 * kTileFloats + 2 * kTile) * (int)sizeof(float);
constexpr int kDqSmemBytes = 6 * kTileFloats * (int)sizeof(float);

// p, y (dropped p) and ds of one 4 x 4 block of a score tile, from the raw
// products s = q . k^T and dp = dO . v^T. Rows are query rows, columns keys.
template <bool kDrop>
__device__ __forceinline__ void score_grads(
    const float s[4][4], const float dp[4][4], const float lse[4],
    const float dlt[4], const float bias[4], int qrow0, int kcol0, int Lq,
    int Lk, float scale, uint32_t s0, uint32_t s1, uint32_t b, uint32_t h,
    const DropParams& drop, float y[4][4], float ds[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int qg = qrow0 + i;
      const int kg = kcol0 + j;
      const bool live = qg < Lq && kg < Lk;
      const float p = live ? expf(s[i][j] * scale + bias[j] - lse[i]) : 0.f;
      float yv = p;
      float dpn = dp[i][j];
      if (kDrop) {
        const bool keep = keep_bit(s0, s1, b, h, (uint32_t)qg, (uint32_t)kg,
                                   drop.thresh);
        yv = keep ? p * drop.inv : 0.f;
        dpn = keep ? dpn * drop.inv : 0.f;
      }
      y[i][j] = yv;
      ds[i][j] = live ? p * (dpn - dlt[i]) : 0.f;
    }
  }
}

// K2: one CTA per (b*H + h, 64-row key tile); loops over query tiles.
template <typename T, bool kDrop>
__global__ void __launch_bounds__(kThreads)
    flash_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const float* __restrict__ bias,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      const T* __restrict__ dout, T* __restrict__ dk,
                      T* __restrict__ dv, float* __restrict__ db, int H,
                      int Lq, int Lk, float scale, DropParams drop) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* kT = smem;                 // [kD][kLd]     k tile, transposed
  float* vT = kT + kTileFloats;     // [kD][kLd]     v tile, transposed
  float* qT = vT + kTileFloats;     // [kD][kLd]     q tile, transposed
  float* doT = qT + kTileFloats;    // [kD][kLd]     dO tile, transposed
  float* qR = doT + kTileFloats;    // [kTile][kLd]  q tile, rows
  float* doR = qR + kTileFloats;    // [kTile][kLd]  dO tile, rows
  float* yS = doR + kTileFloats;    // [q][k]        dropped p
  float* dsS = yS + kTileFloats;    // [q][k]        ds
  float* lseS = dsS + kTileFloats;  // [kTile]
  float* dltS = lseS + kTile;       // [kTile]

  const int k0 = blockIdx.x * kTile;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const T* qb = q + (size_t)bh * Lq * kD;
  const T* kb = k + (size_t)bh * Lk * kD;
  const T* vb = v + (size_t)bh * Lk * kD;
  const T* dob = dout + (size_t)bh * Lq * kD;
  const float* lseb = lse + (size_t)bh * Lq;
  const float* dltb = delta + (size_t)bh * Lq;
  const float* biasb = bias + (size_t)b * Lk;

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  uint32_t s0 = 0, s1 = 0;
  if (kDrop) {
    s0 = (uint32_t)drop.seed[0];
    s1 = (uint32_t)drop.seed[1];
  }
  float bj[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = k0 + tx * 4 + j;
    bj[j] = col < Lk ? biasb[col] : 0.f;
  }

  load_tile<T, true>(kb, k0, Lk, kT);
  load_tile<T, true>(vb, k0, Lk, vT);

  float dk_acc[4][4], dv_acc[4][4];
  zero_4x4(dk_acc);
  zero_4x4(dv_acc);
  float db_acc = 0.f;  // key column threadIdx.x (threads 0..63)

  for (int q0 = 0; q0 < Lq; q0 += kTile) {
    __syncthreads();  // the previous step is done with every q-side tile
    load_tile<T, true>(qb, q0, Lq, qT);
    load_tile<T, true>(dob, q0, Lq, doT);
    load_tile<T, false>(qb, q0, Lq, qR);
    load_tile<T, false>(dob, q0, Lq, doR);
    if (threadIdx.x < kTile) {
      const int row = q0 + threadIdx.x;
      lseS[threadIdx.x] = row < Lq ? lseb[row] : 0.f;
      dltS[threadIdx.x] = row < Lq ? dltb[row] : 0.f;
    }
    __syncthreads();

    float s[4][4], dp[4][4], y[4][4], ds[4][4];
    zero_4x4(s);
    zero_4x4(dp);
    mma_4x4(qT, kT, ty * 4, tx * 4, s);
    mma_4x4(doT, vT, ty * 4, tx * 4, dp);
    float lse_i[4], dlt_i[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      lse_i[i] = lseS[ty * 4 + i];
      dlt_i[i] = dltS[ty * 4 + i];
    }
    score_grads<kDrop>(s, dp, lse_i, dlt_i, bj, q0 + ty * 4, k0 + tx * 4, Lq,
                       Lk, scale, s0, s1, (uint32_t)b, (uint32_t)(bh - b * H),
                       drop, y, ds);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = (ty * 4 + i) * kLd + tx * 4;
      *reinterpret_cast<float4*>(yS + r) =
          make_float4(y[i][0], y[i][1], y[i][2], y[i][3]);
      *reinterpret_cast<float4*>(dsS + r) =
          make_float4(ds[i][0], ds[i][1], ds[i][2], ds[i][3]);
    }
    __syncthreads();

    // Now each thread owns key rows ty*4.. and head dims tx*4.. .
    mma_4x4(yS, doR, ty * 4, tx * 4, dv_acc);
    mma_4x4(dsS, qR, ty * 4, tx * 4, dk_acc);
    if (threadIdx.x < kTile) {
#pragma unroll 8
      for (int r = 0; r < kTile; ++r) db_acc += dsS[r * kLd + threadIdx.x];
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ty * 4 + i;
    if (row >= Lk) continue;
    T* dkrow = dk + ((size_t)bh * Lk + row) * kD;
    T* dvrow = dv + ((size_t)bh * Lk + row) * kD;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      dkrow[tx * 4 + j] = Elem<T>::out(scale * dk_acc[i][j]);
      dvrow[tx * 4 + j] = Elem<T>::out(dv_acc[i][j]);
    }
  }
  if (threadIdx.x < kTile && k0 + (int)threadIdx.x < Lk)
    db[(size_t)bh * Lk + k0 + threadIdx.x] = db_acc;
}

// K3: one CTA per (b*H + h, 64-row query tile); loops over key tiles.
template <typename T, bool kDrop>
__global__ void __launch_bounds__(kThreads)
    flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const float* __restrict__ bias,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const T* __restrict__ dout, T* __restrict__ dq, int H,
                    int Lq, int Lk, float scale, DropParams drop) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* qT = smem;                // [kD][kLd]     q tile, transposed
  float* doT = qT + kTileFloats;   // [kD][kLd]     dO tile, transposed
  float* kT = doT + kTileFloats;   // [kD][kLd]     k tile, transposed
  float* vT = kT + kTileFloats;    // [kD][kLd]     v tile, transposed
  float* kR = vT + kTileFloats;    // [kTile][kLd]  k tile, rows
  float* dsT = kR + kTileFloats;   // [k][q]        ds, transposed

  const int q0 = blockIdx.x * kTile;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const T* qb = q + (size_t)bh * Lq * kD;
  const T* kb = k + (size_t)bh * Lk * kD;
  const T* vb = v + (size_t)bh * Lk * kD;
  const T* dob = dout + (size_t)bh * Lq * kD;
  const float* biasb = bias + (size_t)b * Lk;

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  uint32_t s0 = 0, s1 = 0;
  if (kDrop) {
    s0 = (uint32_t)drop.seed[0];
    s1 = (uint32_t)drop.seed[1];
  }
  float lse_i[4], dlt_i[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    lse_i[i] = row < Lq ? lse[(size_t)bh * Lq + row] : 0.f;
    dlt_i[i] = row < Lq ? delta[(size_t)bh * Lq + row] : 0.f;
  }

  load_tile<T, true>(qb, q0, Lq, qT);
  load_tile<T, true>(dob, q0, Lq, doT);

  float dq_acc[4][4];
  zero_4x4(dq_acc);

  for (int k0 = 0; k0 < Lk; k0 += kTile) {
    __syncthreads();  // the previous step is done with kT, vT, kR and dsT
    load_tile<T, true>(kb, k0, Lk, kT);
    load_tile<T, true>(vb, k0, Lk, vT);
    load_tile<T, false>(kb, k0, Lk, kR);
    __syncthreads();

    float s[4][4], dp[4][4], y[4][4], ds[4][4];
    zero_4x4(s);
    zero_4x4(dp);
    mma_4x4(qT, kT, ty * 4, tx * 4, s);
    mma_4x4(doT, vT, ty * 4, tx * 4, dp);
    float bj[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = k0 + tx * 4 + j;
      bj[j] = col < Lk ? biasb[col] : 0.f;
    }
    score_grads<kDrop>(s, dp, lse_i, dlt_i, bj, q0 + ty * 4, k0 + tx * 4, Lq,
                       Lk, scale, s0, s1, (uint32_t)b, (uint32_t)(bh - b * H),
                       drop, y, ds);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) dsT[(tx * 4 + j) * kLd + ty * 4 + i] = ds[i][j];
    __syncthreads();

    mma_4x4(dsT, kR, ty * 4, tx * 4, dq_acc);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= Lq) continue;
    T* dqrow = dq + ((size_t)bh * Lq + row) * kD;
#pragma unroll
    for (int j = 0; j < 4; ++j) dqrow[tx * 4 + j] = Elem<T>::out(scale * dq_acc[i][j]);
  }
}

template <typename T, bool kDrop>
int launch_dkdv_t(const void* q, const void* k, const void* v,
                  const void* bias, const void* lse, const void* delta,
                  const void* dout, void* dk, void* dv, void* db, int B,
                  int H, int Lq, int Lk, float scale, DropParams drop,
                  cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_dkdv_kernel<T, kDrop>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kDkdvSmemBytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Lk + kTile - 1) / kTile, B * H);
  flash_dkdv_kernel<T, kDrop><<<grid, kThreads, kDkdvSmemBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(bias),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const T*>(dout), static_cast<T*>(dk), static_cast<T*>(dv),
      static_cast<float*>(db), H, Lq, Lk, scale, drop);
  return (int)cudaGetLastError();
}

template <typename T, bool kDrop>
int launch_dq_t(const void* q, const void* k, const void* v,
                const void* bias, const void* lse, const void* delta,
                const void* dout, void* dq, int B, int H, int Lq, int Lk,
                float scale, DropParams drop, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_dq_kernel<T, kDrop>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kDqSmemBytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Lq + kTile - 1) / kTile, B * H);
  flash_dq_kernel<T, kDrop><<<grid, kThreads, kDqSmemBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(bias),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const T*>(dout), static_cast<T*>(dq), H, Lq, Lk, scale,
      drop);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dkdv(const void* q, const void* k, const void* v, const void* bias,
                const void* lse, const void* delta, const void* dout,
                const void* seed, void* dk, void* dv, void* db, int B, int H,
                int Lq, int Lk, float scale, unsigned int thresh, float inv,
                void* stream) {
  DropParams drop{static_cast<const int64_t*>(seed), thresh, inv};
  cudaStream_t s = (cudaStream_t)stream;
  if (seed == nullptr)
    return launch_dkdv_t<T, false>(q, k, v, bias, lse, delta, dout, dk, dv,
                                   db, B, H, Lq, Lk, scale, drop, s);
  return launch_dkdv_t<T, true>(q, k, v, bias, lse, delta, dout, dk, dv, db,
                                B, H, Lq, Lk, scale, drop, s);
}

template <typename T>
int launch_dq(const void* q, const void* k, const void* v, const void* bias,
              const void* lse, const void* delta, const void* dout,
              const void* seed, void* dq, int B, int H, int Lq, int Lk,
              float scale, unsigned int thresh, float inv, void* stream) {
  DropParams drop{static_cast<const int64_t*>(seed), thresh, inv};
  cudaStream_t s = (cudaStream_t)stream;
  if (seed == nullptr)
    return launch_dq_t<T, false>(q, k, v, bias, lse, delta, dout, dq, B, H,
                                 Lq, Lk, scale, drop, s);
  return launch_dq_t<T, true>(q, k, v, bias, lse, delta, dout, dq, B, H, Lq,
                              Lk, scale, drop, s);
}

}  // namespace

// q, dout, dq: contiguous [B, H, Lq, 64]; k, v, dk, dv: [B, H, Lk, 64];
// bias: fp32 [B, Lk]; lse, delta: fp32 [B, H, Lq]; db: fp32 [B, H, Lk];
// seed: two int64 words on the device, or null for no dropout. Each
// returns the cudaError_t of its launch.
extern "C" int flash_bwd_dkdv_bf16(const void* q, const void* k,
                                   const void* v, const void* bias,
                                   const void* lse, const void* delta,
                                   const void* dout, const void* seed,
                                   void* dk, void* dv, void* db, int B, int H,
                                   int Lq, int Lk, float scale,
                                   unsigned int thresh, float inv,
                                   void* stream) {
  return launch_dkdv<__nv_bfloat16>(q, k, v, bias, lse, delta, dout, seed, dk,
                                    dv, db, B, H, Lq, Lk, scale, thresh, inv,
                                    stream);
}

extern "C" int flash_bwd_dkdv_f32(const void* q, const void* k,
                                  const void* v, const void* bias,
                                  const void* lse, const void* delta,
                                  const void* dout, const void* seed,
                                  void* dk, void* dv, void* db, int B, int H,
                                  int Lq, int Lk, float scale,
                                  unsigned int thresh, float inv,
                                  void* stream) {
  return launch_dkdv<float>(q, k, v, bias, lse, delta, dout, seed, dk, dv, db,
                            B, H, Lq, Lk, scale, thresh, inv, stream);
}

extern "C" int flash_bwd_dq_bf16(const void* q, const void* k, const void* v,
                                 const void* bias, const void* lse,
                                 const void* delta, const void* dout,
                                 const void* seed, void* dq, int B, int H,
                                 int Lq, int Lk, float scale,
                                 unsigned int thresh, float inv,
                                 void* stream) {
  return launch_dq<__nv_bfloat16>(q, k, v, bias, lse, delta, dout, seed, dq,
                                  B, H, Lq, Lk, scale, thresh, inv, stream);
}

extern "C" int flash_bwd_dq_f32(const void* q, const void* k, const void* v,
                                const void* bias, const void* lse,
                                const void* delta, const void* dout,
                                const void* seed, void* dq, int B, int H,
                                int Lq, int Lk, float scale,
                                unsigned int thresh, float inv,
                                void* stream) {
  return launch_dq<float>(q, k, v, bias, lse, delta, dout, seed, dq, B, H, Lq,
                          Lk, scale, thresh, inv, stream);
}
