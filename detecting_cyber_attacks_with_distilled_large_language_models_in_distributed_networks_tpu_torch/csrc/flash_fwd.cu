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
// Layout. q, k and v are read through (batch, head, row) strides in
// elements, last dim contiguous, every row start 16-byte aligned: the
// model hands over views of its [B, L, H*D] projections (or of one fused
// [B, L, 3*H*D] product) and nothing copies them. O is written through its
// own strides; the wrapper allocates it as [B, L, H, D], so the model's
// merge of the heads is a view. lse is dense fp32 [B, H, Lq].
//
// Bound on the card (NVIDIA H100 SXM). At the serving path's largest shape
// (B=128, H=12, L=128, D=64, bf16) the kernel must move q, k, v and O
// (12.6 M elements each, 2 bytes) plus lse: 101.5 MB, 30 us at 3.35 TB/s. It does 6.4 GFLOP,
// 6.5 us at the bf16 tensor-core peak but 96 us at the 67 TFLOP/s of fp32
// FMA, so products on the CUDA cores alone would put it 3x over its byte
// bound. So the bf16 instantiation, which serving, evaluation and
// training run, is built for bytes:
//   * both products on the tensor cores (mma.sync m16n8k16, bf16 in, fp32
//     accumulation: the TPU kernel's bf16 MXU products with
//     preferred_element_type=float32); bf16 products are exact in fp32, so
//     only the order of the fp32 sums differs from the plain version;
//   * one CTA of 4 warps per (batch, head, 64-row query tile), the query
//     tile the fastest grid index so a (b, h)'s query tiles run side by
//     side and share k and v in L2; each warp owns 16 query rows;
//   * q, k and v tiles stay bf16 in shared memory (8 KB each, XOR-swizzled
//     against bank conflicts), loaded by 16-byte cp.async straight from
//     the strided rows; k, v and the key-bias tile are double-buffered.
//     The loads go out in three groups at once (q and key tile 0's k; its
//     v; key tile 1), so S of tile 0 is computed while tile 0's v and
//     tile 1 are still in flight, and later tiles refill a buffer as soon
//     as every warp is done with it. 40.5 KB of static shared memory in
//     all: no opt-in attribute; with registers capped at 128 a thread,
//     4 CTAs (16 warps) share an SM;
//   * q's fragments are loaded once into registers; S = q . k^T and
//     O += p . v accumulate in fp32 registers; the online softmax runs in
//     registers (row max and sum over the 4 lanes of a quad; exp(s - m)
//     as exp2((s - m) * log2 e), within ~2 ulp of expf), and the S
//     accumulator is rounded in registers into the bf16 A fragment of
//     p . v, so p never touches shared memory;
//   * dropout hashes each element's global (b, h, q, k) as the fragment
//     holds it: rows lane/4 and lane/4 + 8 of the warp's 16, columns
//     2*(lane%4) + {0, 1} of each 8-key block;
//   * the epilogue stages the warp's O rows through its own rows of the q
//     buffer and writes them with 16-byte stores through O's strides.
// The fp32 instantiation is a dtype-selected instantiation, not a
// fallback: it keeps exact fp32 products on the CUDA cores (fp32 FMA over
// fp32 tiles, flash_tile.cuh), because the tensor cores' fp32 mode is
// TF32, whose ~3 decimal digits would break the fp32 bound (atol 2e-5)
// that serving's and training's fp32 checks hold it to. It takes the same
// strides and writes the same O layout; its 68 KB of dynamic shared memory
// are allowed once per device, not per launch.
//
// Both: the ragged edge is masked in the kernel (key columns past Lk score
// -inf, weight exactly 0, and their k and v rows are zero; query rows past
// Lq are not stored), so any L works. The key bias -1e9 is added as the
// finite number it is: a row whose keys are all masked (the bucket's pad
// rows) comes out uniform with l > 0, as in the JAX kernel, and no key
// tile is ever skipped. No atomics: repeated calls give the same bits.
// Dropout is a template branch: at rate 0 (serving, evaluation) there is
// no hash work at all. Only head_dim 64 is built; the wrapper raises for
// any other.

#include <math.h>

#include <atomic>

#include "flash_tile.cuh"
#include "keep_mask.cuh"
#include "mma_bf16.cuh"

namespace {

using bf16 = __nv_bfloat16;

// (batch, head, row) strides of a [B, H, L, 64] operand, in elements.
struct Strides {
  int64_t b, h, r;
};

// ------------------------------------------------ bf16: tensor cores
constexpr int kTcWarps = 4;
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kTcBlock = 64;  // query rows per CTA, keys per tile
constexpr int kTcSmemBytes =
    5 * mma::kTileBytes + 2 * kTcBlock * (int)sizeof(float);
constexpr float kLog2e = 1.4426950408889634f;

// At most 128 registers a thread, so 4 CTAs (16 warps) share an SM
// whatever ptxas would pick: an earlier form of this kernel, left alone,
// took so many that only 2 CTAs fit, and ran markedly slower.
template <bool kDrop>
__global__ void __launch_bounds__(kTcThreads, 4)
    flash_fwd_tc_kernel(const bf16* __restrict__ q, Strides sq,
                        const bf16* __restrict__ k, Strides sk,
                        const bf16* __restrict__ v, Strides sv,
                        const float* __restrict__ bias, int64_t bias_b,
                        bf16* __restrict__ o,
                        Strides so, float* __restrict__ lse, int H, int Lq,
                        int Lk, float scale, DropParams drop) {
  // q | k[2] | v[2] | key bias[2][64]
  __shared__ __align__(128) unsigned char smem[kTcSmemBytes];
  const uint32_t s_q = mma::smem_addr(smem);
  const uint32_t s_k = s_q + mma::kTileBytes;
  const uint32_t s_v = s_q + 3 * mma::kTileBytes;
  float* s_bias = reinterpret_cast<float*>(smem + 5 * mma::kTileBytes);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = blockIdx.x * kTcBlock;
  const int bh = blockIdx.y;  // b * H + h
  const int b = bh / H, h = bh - b * H;
  const bf16* qb = q + b * sq.b + h * sq.h;
  const bf16* kb = k + b * sk.b + h * sk.h;
  const bf16* vb = v + b * sv.b + h * sv.h;
  const float* biasb = bias + b * bias_b;

  uint32_t s0 = 0, s1 = 0;
  if (kDrop) {
    s0 = (uint32_t)drop.seed[0];
    s1 = (uint32_t)drop.seed[1];
  }

  // Key tile at k0 into buffer buf: k and its key-bias row, then v.
  auto load_k = [&](int buf, int k0) {
    mma::load_tile_async<kTcThreads>(s_k + buf * mma::kTileBytes, kb, sk.r,
                                     k0, Lk);
    if (threadIdx.x < kTcBlock) {
      const bool ok = k0 + (int)threadIdx.x < Lk;
      mma::cp_async4(mma::smem_addr(s_bias + buf * kTcBlock + threadIdx.x),
                     ok ? biasb + k0 + threadIdx.x : biasb, ok);
    }
  };
  auto load_v = [&](int buf, int k0) {
    mma::load_tile_async<kTcThreads>(s_v + buf * mma::kTileBytes, vb, sv.r,
                                     k0, Lk);
  };

  // Three groups in flight at once: q with key tile 0's k; its v; all of
  // key tile 1 (empty when Lk <= 64). S of tile 0 starts when the first
  // has landed, while the rest are still on their way.
  const int n_tiles = (Lk + kTcBlock - 1) / kTcBlock;
  mma::load_tile_async<kTcThreads>(s_q, qb, sq.r, q0, Lq);
  load_k(0, 0);
  mma::cp_async_commit();
  load_v(0, 0);
  mma::cp_async_commit();
  if (n_tiles > 1) {
    load_k(1, kTcBlock);
    load_v(1, kTcBlock);
  }
  mma::cp_async_commit();
  mma::cp_async_wait<2>();
  __syncthreads();

  // This warp's 16 query rows as A fragments, one per 16 dims.
  const int wrow = warp * 16;
  uint32_t qf[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    mma::ldmatrix_x4(
        s_q + mma::swz(wrow + (lane & 7) + ((lane >> 3) & 1) * 8,
                       2 * kk + (lane >> 4)),
        qf[kk]);

  // Rows g and g + 8 of the warp's 16: i = 0, 1.
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[8][4];  // O: 8 blocks of 8 dims
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int cur = j & 1, k0 = j * kTcBlock;

    // S = q . k^T: 8 blocks of 8 keys, fp32.
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    const uint32_t kt = s_k + cur * mma::kTileBytes;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t r[4];
        mma::ldmatrix_x4(kt + mma::swz(16 * np + (lane & 7) + (lane >> 4) * 8,
                                       2 * kk + ((lane >> 3) & 1)),
                         r);
        mma::mma_16816(s[2 * np], qf[kk], r[0], r[1]);
        mma::mma_16816(s[2 * np + 1], qf[kk], r[2], r[3]);
      }

    // Scale, key bias, and the ragged edge: a column past Lk is no key.
    const float* bt = s_bias + cur * kTcBlock;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * n + 2 * t + e;
        const bool live = k0 + col < Lk;
        const float bj = bt[col];
        s[n][e] = live ? s[n][e] * scale + bj : -INFINITY;
        s[n][2 + e] = live ? s[n][2 + e] * scale + bj : -INFINITY;
      }

    // Online softmax. Every row sees column k0 < Lk, so m_new is finite.
    // exp(x) as exp2(x * log2 e), x = s - m formed first as in the plain
    // version: within ~2 ulp of expf, and one multiply and the hardware
    // exp2 in place of expf's range reduction (7% of the kernel's device
    // time at B=128 on an H100 SXM). Folding m * log2 e into an FMA instead
    // would round it: at the -1e9 of a pad row that is an error of up to 64
    // in the argument.
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < 8; ++n)
        mx = fmaxf(mx, fmaxf(s[n][2 * i], s[n][2 * i + 1]));
      const float m_new = fmaxf(m[i], mma::quad_max(mx));
      const float alpha = exp2f((m[i] - m_new) * kLog2e);
      float rs = 0.f;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = exp2f((s[n][2 * i + e] - m_new) * kLog2e);
          rs += p;  // the denominator takes the undropped p
          s[n][2 * i + e] = p;
        }
      l[i] = l[i] * alpha + mma::quad_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        acc[n][2 * i] *= alpha;
        acc[n][2 * i + 1] *= alpha;
      }
    }

    if (j == 0) {  // key tile 0's v has landed
      mma::cp_async_wait<1>();
      __syncthreads();
    }

    // O += p' . v: the S accumulator of keys 16kk..16kk+15 is the A
    // fragment of step kk, each value dropped and rounded to bf16 here.
    const uint32_t vt = s_v + cur * mma::kTileBytes;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int n = 2 * kk + half;
        float p00 = s[n][0], p01 = s[n][1], p10 = s[n][2], p11 = s[n][3];
        if (kDrop) {
          const uint32_t row = (uint32_t)(q0 + wrow + g);
          const uint32_t col = (uint32_t)(k0 + 8 * n + 2 * t);
          const uint32_t ub = (uint32_t)b, uh = (uint32_t)h;
          p00 = keep_bit(s0, s1, ub, uh, row, col, drop.thresh) ? p00 * drop.inv : 0.f;
          p01 = keep_bit(s0, s1, ub, uh, row, col + 1, drop.thresh) ? p01 * drop.inv : 0.f;
          p10 = keep_bit(s0, s1, ub, uh, row + 8, col, drop.thresh) ? p10 * drop.inv : 0.f;
          p11 = keep_bit(s0, s1, ub, uh, row + 8, col + 1, drop.thresh) ? p11 * drop.inv : 0.f;
        }
        a[2 * half] = mma::pack_bf16(p00, p01);      // row g
        a[2 * half + 1] = mma::pack_bf16(p10, p11);  // row g + 8
      }
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t r[4];
        mma::ldmatrix_x4_trans(
            vt + mma::swz(16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8,
                          2 * np + (lane >> 4)),
            r);
        mma::mma_16816(acc[2 * np], a, r[0], r[1]);
        mma::mma_16816(acc[2 * np + 1], a, r[2], r[3]);
      }
    }

    __syncthreads();  // every warp is done with buffer cur: refill it
    if (j + 2 < n_tiles) {
      load_k(cur, k0 + 2 * kTcBlock);
      load_v(cur, k0 + 2 * kTcBlock);
    }
    mma::cp_async_commit();
    mma::cp_async_wait<1>();  // key tile j + 1 has landed
    __syncthreads();
  }

  // Epilogue: O = acc / l in bf16 into this warp's own rows of the q
  // buffer (no other warp reads them), then 16-byte stores through O's
  // strides.
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    *reinterpret_cast<uint32_t*>(smem + mma::swz(wrow + g, n) + 4 * t) =
        mma::pack_bf16(acc[n][0] / l[0], acc[n][1] / l[0]);
    *reinterpret_cast<uint32_t*>(smem + mma::swz(wrow + g + 8, n) + 4 * t) =
        mma::pack_bf16(acc[n][2] / l[1], acc[n][3] / l[1]);
  }
  __syncwarp();
  bf16* ob = o + b * so.b + h * so.h;
#pragma unroll
  for (int it = 0; it < 4; ++it) {
    const int idx = lane + 32 * it;
    const int r = idx >> 3, c = idx & 7;
    const int row = q0 + wrow + r;
    if (row < Lq)
      *reinterpret_cast<uint4*>(ob + row * so.r + c * 8) =
          *reinterpret_cast<const uint4*>(smem + mma::swz(wrow + r, c));
  }
  if (t == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = q0 + wrow + g + 8 * i;
      if (row < Lq) lse[(size_t)bh * Lq + row] = m[i] + logf(l[i]);
    }
  }
}

// ----------------------------------------- fp32: exact FMA products
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

template <bool kDrop>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_f32_kernel(const float* __restrict__ q, Strides sq,
                         const float* __restrict__ k, Strides sk,
                         const float* __restrict__ v, Strides sv,
                         const float* __restrict__ bias, int64_t bias_b,
                         float* __restrict__ o, Strides so,
                         float* __restrict__ lse, int H, int Lq, int Lk,
                         float scale, DropParams drop) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* qt = smem;               // [kD][kLd]     q tile, transposed
  float* kt = qt + kTileFloats;   // [kD][kLd]     k tile, transposed
  float* vs = kt + kTileFloats;   // [kTile][kLd]  v tile
  float* pt = vs + kTileFloats;   // [kTile][kLd]  p tile, transposed

  const int q0 = blockIdx.x * kTile;
  const int bh = blockIdx.y;  // b * H + h
  const int b = bh / H, h = bh - b * H;
  const float* qb = q + b * sq.b + h * sq.h;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  const float* biasb = bias + b * bias_b;

  const int tx = threadIdx.x % 16;  // key columns (scores) / dims (O)
  const int ty = threadIdx.x / 16;  // query rows ty*4 .. ty*4+3

  uint32_t s0 = 0, s1 = 0;
  if (kDrop) {
    s0 = (uint32_t)drop.seed[0];
    s1 = (uint32_t)drop.seed[1];
  }

  load_tile<float, true>(qb, q0, Lq, qt, sq.r);

  float m[4], l[4], acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }
  zero_4x4(acc);

  for (int k0 = 0; k0 < Lk; k0 += kTile) {
    __syncthreads();  // the previous step is done with kt, vs and pt
    load_tile<float, true>(kb, k0, Lk, kt, sk.r);
    load_tile<float, false>(vb, k0, Lk, vs, sv.r);
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
              keep_bit(s0, s1, (uint32_t)b, (uint32_t)h,
                       (uint32_t)(q0 + ty * 4 + i),
                       (uint32_t)(k0 + tx * 4 + j), drop.thresh);
          pv = keep ? p * drop.inv : 0.f;
        }
        pt[(tx * 4 + j) * kLd + ty * 4 + i] = pv;
      }
      l[i] = l[i] * alpha + row_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    mma_4x4(pt, vs, ty * 4, tx * 4, acc);
  }

  float* ob = o + b * so.b + h * so.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= Lq) continue;
    *reinterpret_cast<float4*>(ob + row * so.r + tx * 4) =
        make_float4(acc[i][0] / l[i], acc[i][1] / l[i], acc[i][2] / l[i],
                    acc[i][3] / l[i]);
    if (tx == 0) lse[(size_t)bh * Lq + row] = m[i] + logf(l[i]);
  }
}

// Allow the fp32 kernel its dynamic shared memory on the current device,
// once per device and instantiation (the attribute is a property of the
// device's context, so later launches need not set it again).
template <bool kDrop>
cudaError_t allow_f32_smem() {
  static std::atomic<uint64_t> done{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? (uint64_t{1} << dev) : 0;
  if (bit != 0 && (done.load(std::memory_order_acquire) & bit)) return cudaSuccess;
  err = cudaFuncSetAttribute(flash_fwd_f32_kernel<kDrop>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

struct Args {
  const void *q, *k, *v, *bias;
  int64_t bias_b;
  void *o, *lse;
  Strides sq, sk, sv, so;
  int B, H, Lq, Lk;
  float scale;
  DropParams drop;
  cudaStream_t stream;
};

template <bool kDrop>
int launch_bf16(const Args& a) {
  dim3 grid((a.Lq + kTcBlock - 1) / kTcBlock, a.B * a.H);
  flash_fwd_tc_kernel<kDrop><<<grid, kTcThreads, 0, a.stream>>>(
      static_cast<const bf16*>(a.q), a.sq, static_cast<const bf16*>(a.k),
      a.sk, static_cast<const bf16*>(a.v), a.sv,
      static_cast<const float*>(a.bias), a.bias_b, static_cast<bf16*>(a.o),
      a.so,
      static_cast<float*>(a.lse), a.H, a.Lq, a.Lk, a.scale, a.drop);
  return (int)cudaGetLastError();
}

template <bool kDrop>
int launch_f32(const Args& a) {
  cudaError_t err = allow_f32_smem<kDrop>();
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.Lq + kTile - 1) / kTile, a.B * a.H);
  flash_fwd_f32_kernel<kDrop><<<grid, kThreads, kSmemBytes, a.stream>>>(
      static_cast<const float*>(a.q), a.sq, static_cast<const float*>(a.k),
      a.sk, static_cast<const float*>(a.v), a.sv,
      static_cast<const float*>(a.bias), a.bias_b, static_cast<float*>(a.o),
      a.so,
      static_cast<float*>(a.lse), a.H, a.Lq, a.Lk, a.scale, a.drop);
  return (int)cudaGetLastError();
}

Args make_args(const void* q, const void* k, const void* v, const void* bias,
               long long bias_b, void* o, void* lse, const void* seed, int B,
               int H, int Lq,
               int Lk, long long qb, long long qh, long long qr, long long kb,
               long long kh, long long kr, long long vb, long long vh,
               long long vr, long long ob, long long oh, long long orow,
               float scale, unsigned int thresh, float inv, void* stream) {
  return Args{q, k, v, bias, bias_b, o, lse,
              Strides{qb, qh, qr}, Strides{kb, kh, kr}, Strides{vb, vh, vr},
              Strides{ob, oh, orow}, B, H, Lq, Lk, scale,
              DropParams{static_cast<const int64_t*>(seed), thresh, inv},
              (cudaStream_t)stream};
}

}  // namespace

// q, k, v: [B, H, L, 64] read through (batch, head, row) strides in
// elements (last dim contiguous, 16-byte aligned rows); o: written through
// its own strides; bias: fp32 key bias, Lk contiguous values per batch row,
// rows bias_b elements apart (0: one row for every batch); lse: fp32
// [B, H, Lq];
// seed: two int64 words on the device, or null for no dropout (then
// thresh and inv are unused). Returns the cudaError_t of the launch.
#define FLASH_FWD_ARGS                                                      \
  const void *q, const void *k, const void *v, const void *bias,           \
      long long bias_b, void *o, void *lse, const void *seed, int B, int H,  \
      int Lq, int Lk,                                                       \
      long long qb, long long qh, long long qr, long long kb, long long kh, \
      long long kr, long long vb, long long vh, long long vr, long long ob, \
      long long oh, long long orow, float scale, unsigned int thresh,       \
      float inv, void *stream
#define FLASH_FWD_PASS                                                     \
  q, k, v, bias, bias_b, o, lse, seed, B, H, Lq, Lk, qb, qh, qr, kb, kh, kr, \
      vb, vh, vr, ob, oh, orow, scale, thresh, inv, stream

extern "C" int flash_fwd_bf16(FLASH_FWD_ARGS) {
  const Args a = make_args(FLASH_FWD_PASS);
  return seed == nullptr ? launch_bf16<false>(a) : launch_bf16<true>(a);
}

extern "C" int flash_fwd_f32(FLASH_FWD_ARGS) {
  const Args a = make_args(FLASH_FWD_PASS);
  return seed == nullptr ? launch_f32<false>(a) : launch_f32<true>(a);
}
