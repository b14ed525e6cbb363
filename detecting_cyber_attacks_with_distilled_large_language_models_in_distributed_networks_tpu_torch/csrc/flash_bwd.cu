// Flash attention backward for Hopper (sm_90a): K3 (dq, and delta) and K2
// (dk, dv, dbias), with attention dropout.
//
// Replaces the TPU kernels ops/flash_attention.py::_dq_kernel and
// ::_dkdv_kernel of the JAX package (the two pallas_calls of
// _flash_backward). Both recompute each score tile from (q, k, bias, lse)
// instead of reading an L x L matrix, with fp32 softmax arithmetic; p is
// NOT rounded to the input dtype (unlike the forward's p . v):
//
//   p   = exp((q . k^T) * scale + bias - lse)   the undropped softmax
//   dpn = dO . v^T,  y = p                       (rate 0)
//   dpn = dpn * keep * inv, y = p * keep * inv   (dropout; keep_mask.cuh)
//   ds  = p * (dpn - delta)                      delta = rowsum(dO * O)
//   K3, per query tile: delta (written for K2), dq = scale * ds . k
//   K2, per key tile:   dv = y^T . dO,  dk = scale * ds^T . q,
//                       db = colsum(ds)   (per head; the caller sums heads)
// K3 runs first: it computes delta from the dO and O rows of its query
// tile (the JAX wrapper's separate XLA op) and K2 reads it.
//
// Layout. q, k, v, dO and O are read through (batch, head, row) strides in
// elements, last dim contiguous, every row start 16-byte aligned: the
// model's q/k/v are views of its [B, L, H*D] projections (or of one fused
// [B, L, 3*H*D] product) and its dO is a view of O's [B, L, H, D] storage,
// so nothing is copied around the backward. dq, dk and dv are written
// through their own strides; the wrapper allocates them as [B, L, H, D],
// so the projections' backward merges the heads as a view. lse and delta
// are dense fp32 [B, H, Lq]; db is dense fp32 [B, H, Lk].
//
// Bound on the card (NVIDIA H100 SXM). At the training shape (B=16, H=12,
// L=128, D=64, bf16) K3 reads q, k, v, dO and O once (15.7 MB) plus lse
// and the key bias, and writes dq and delta: 19.1 MB, 5.7 us at
// 3.35 TB/s. K2 reads q, k, v and dO (12.6 MB) plus lse, delta and the key
// bias, and writes dk, dv and db: 19.2 MB, 5.7 us. K2 does 4 products of
// 2 L^2 D flops per (b, h), 1.6 GFLOP, K3 3 of them, 1.2 GFLOP: 1.6 and
// 1.2 us at the bf16 tensor-core peak, but 24 and 18 us at the 67 TFLOP/s
// of fp32 FMA. So the bf16 instantiations, which training runs, put every
// product on the tensor cores and are then bound by bytes and latency:
//   * mma.sync m16n8k16, bf16 in, fp32 accumulation. q, k, v and dO are
//     bf16 already, so S = q.k^T and dP = dO.v^T are exact products
//     summed in fp32. y and ds are fp32 in the plain version; they enter
//     their products as sums of bf16 terms (hi = bf16(x), lo = bf16(x -
//     hi), ..., one mma each into the same accumulator): y as two (~16
//     bits of mantissa), ds as three (all 24), which keeps the gradients
//     within the same bf16 bound as before. Those gradient products are
//     summed one k16 step at a time in a fresh accumulator, then added in
//     fp32 (add_step): the tensor cores truncate each step relative to the
//     accumulator it lands in;
//   * K3: one CTA of 4 warps per (batch, head, 64-row query tile), each
//     warp owning 16 query rows; S = q.k^T and dP = dO.v^T land in
//     registers in the A-fragment layout of dq += ds.k, with k a B operand
//     through ldmatrix.trans;
//   * K2: one CTA of 4 warps per (batch, head, 64-row key tile), each warp
//     owning 16 key rows. Keys are the M dimension: it computes S^T = k.q^T
//     and dP^T = v.dO^T, so y^T and ds^T land in registers already laid out
//     as the A operand of dv += y^T.dO and dk += ds^T.q (q and dO as B
//     operands through ldmatrix.trans); db = colsum(ds) is the row sum of
//     ds^T over the query columns (registers, then a quad sum);
//   * each 64-row tile of the other side is processed in two halves of 32
//     columns, so the S and dP fragments of one half (32 fp32 registers a
//     thread) sit beside the fp32 accumulators; A fragments are loaded
//     from shared memory as each k16 step needs them, and the two halves
//     are a rolled loop. Registers are capped at 168 a thread so 3 CTAs
//     share an SM: the training shape's 384 CTAs then run in one wave;
//   * tiles stay bf16 in shared memory (8 KB each, XOR-swizzled), loaded by
//     16-byte cp.async straight from the strided rows (zero-filled past
//     the ragged edge); the other side's tiles are double-buffered and the
//     next one is in flight while the current one is computed. 48 KB of
//     static shared memory, no opt-in attribute;
//   * dropout hashes each accumulator element's global (b, h, q, k) as the
//     fragment holds it: rows lane/4 and lane/4 + 8, columns 2*(lane%4) +
//     {0, 1} of each 8-column block. In K2 rows are keys and columns
//     queries, so the hash's q and k arguments are the swap of K3's;
//   * the epilogue stages the warp's output rows through its own rows of a
//     tile it no longer reads and writes them with 16-byte stores through
//     the output's strides.
// The fp32 instantiations are dtype-selected instantiations, not
// fallbacks: they keep exact fp32 products on the CUDA cores (flash_tile.cuh,
// 4 x 4 FMA outer products over fp32 tiles), because the tensor cores'
// fp32 mode is TF32, whose ~3 decimal digits would break the fp32 gradient
// bound (1e-4). They take the same strides, write the same layouts and
// compute delta in K3 the same way; their dynamic shared memory (136 KB
// for K2, 102 KB for K3) is allowed once per device, not per launch.
//
// Both: no atomics (each CTA owns its output rows), so repeated calls give
// the same bits. Ragged edges and pad rows: an element whose query row is
// past Lq or whose key column is past Lk is given p = 0 and ds = 0
// explicitly (the zero-filled tile rows would otherwise meet an arbitrary
// lse), so it adds nothing to any gradient. A fully masked query row (a
// pad row) has a finite -1e9 bias and a finite lse and comes out uniform,
// as in JAX; no tile is ever skipped. Only head_dim 64 is built; the
// wrapper raises for any other.

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

// Everything one launch of K2 or K3 reads: K3 ignores dk, dv and db; K2
// ignores o and dq (and reads delta, which K3 wrote).
struct BwdParams {
  const void *q, *k, *v;
  const float* bias;
  int64_t bias_b;  // key bias batch stride (0: one row for every batch)
  const void* o;
  const float* lse;
  float* delta;
  const void* dout;
  void *dq, *dk, *dv;
  float* db;
  Strides sq, sk, sv, so, sdo, sdq, sdk, sdv;
  int B, H, Lq, Lk;
  float scale;
  DropParams drop;
};

// ------------------------------------------------ bf16: tensor cores
constexpr int kTcWarps = 4;
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kTcBlock = 64;  // rows of a query or key tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;
// bf16 terms that y and ds enter their products as (see above): y as a
// hi/lo pair; ds as three (hi, mid, lo: its whole fp32 mantissa), since a
// pair leaves ~2^-17 of |ds| a term, which on a pad row (p = 1 for every
// key, |ds| ~ 10) cancels into more than one bf16 ulp of a small dq or dk.
constexpr int kYTerms = 2;
constexpr int kDsTerms = 3;
// Minimum CTAs an SM for __launch_bounds__: at the training shape each
// grid is 384 CTAs, so 3 an SM (at most 168 registers a thread) run it
// in one wave.
constexpr int kDqMinBlocks = 3;
constexpr int kDkdvMinBlocks = 3;

__device__ __forceinline__ int64_t off(const Strides& s, int b, int h) {
  return b * s.b + h * s.h;
}

// rowsum(dO * O) of row `row` in fp32, two lanes a row (`half` picks its
// 32 columns) and summed over the pair; 0 past `rows`. Every lane calls it.
__device__ __forceinline__ float row_delta(const bf16* dout, int64_t ldo,
                                           const bf16* o, int64_t lo, int row,
                                           int rows, int half) {
  float s = 0.f;
  if (row < rows) {
    const uint4* pd = reinterpret_cast<const uint4*>(dout + row * ldo + half * 32);
    const uint4* po = reinterpret_cast<const uint4*>(o + row * lo + half * 32);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint4 x = pd[i], y = po[i];
      const __nv_bfloat162* hx = reinterpret_cast<const __nv_bfloat162*>(&x);
      const __nv_bfloat162* hy = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 fx = __bfloat1622float2(hx[e]);
        const float2 fy = __bfloat1622float2(hy[e]);
        s += fx.x * fy.x + fx.y * fy.y;
      }
    }
  }
  return s + __shfl_xor_sync(kFull, s, 1);
}

template <int N>
__device__ __forceinline__ void zero_acc(float (&acc)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
}

// acc += step, an IEEE fp32 add. The gradient products (mma_xt_step) are
// summed one k16 step at a time in a fresh accumulator and added to the
// running sum here: the tensor cores truncate each step's sum relative to
// the accumulator it lands in, and over a pad row's large terms (p = 1 for
// every key) that drift reached twice the bf16 bound's atol on a small dk.
// S and dP sum only four steps and accumulate in place.
__device__ __forceinline__ void add_step(float acc[4], const float step[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += step[e];
}

// acc[0..3] = A . B^T for the warp's 16 rows of tile `a` (A, ldmatrix)
// against rows [c0, c0 + 32) of tile `b` (row-major [n][k], ldmatrix).
__device__ __forceinline__ void mma_abt_half(uint32_t a, int wrow, uint32_t b,
                                             int c0, int lane, float (&acc)[4][4]) {
  zero_acc(acc);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t af[4];
    mma::ldmatrix_x4(a + mma::swz(wrow + (lane & 7) + ((lane >> 3) & 1) * 8,
                                  2 * kk + (lane >> 4)),
                     af);
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      uint32_t r[4];
      mma::ldmatrix_x4(b + mma::swz(c0 + 16 * np + (lane & 7) + (lane >> 4) * 8,
                                    2 * kk + ((lane >> 3) & 1)),
                       r);
      mma::mma_16816(acc[2 * np], af, r[0], r[1]);
      mma::mma_16816(acc[2 * np + 1], af, r[2], r[3]);
    }
  }
}

// acc[0..7] += X . tile[r0 : r0 + 16] for the k16 step whose fp32 values
// sit in x[n0], x[n0 + 1] (the accumulator layout of a 16 x 16 block),
// fed as kTerms bf16 terms (x = hi + mid + lo, each the bf16 rounding of
// what the earlier ones left, summed smallest first); the B operand is the
// tile's rows r0.. as row-major [k][n] (ldmatrix.trans).
template <int kTerms>
__device__ __forceinline__ void mma_xt_step(const float x[4][4], int n0,
                                            uint32_t tile, int r0, int lane,
                                            float acc[8][4]) {
  uint32_t part[kTerms][4];
#pragma unroll
  for (int f = 0; f < 4; ++f) {
    // Fragment register f: row g (f even) or g + 8 (f odd) of n-block
    // n0 + f / 2, two neighbouring columns.
    float x0 = x[n0 + f / 2][2 * (f & 1)], x1 = x[n0 + f / 2][2 * (f & 1) + 1];
#pragma unroll
    for (int term = 0; term < kTerms; ++term) {
      part[term][f] = mma::pack_bf16(x0, x1);
      const float2 r = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&part[term][f]));
      x0 -= r.x;
      x1 -= r.y;
    }
  }
#pragma unroll
  for (int np = 0; np < 4; ++np) {
    uint32_t r[4];
    mma::ldmatrix_x4_trans(
        tile + mma::swz(r0 + (lane & 7) + ((lane >> 3) & 1) * 8, 2 * np + (lane >> 4)),
        r);
    float t0[4] = {0.f, 0.f, 0.f, 0.f}, t1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int term = kTerms - 1; term >= 0; --term) {
      mma::mma_16816(t0, part[term], r[0], r[1]);
      mma::mma_16816(t1, part[term], r[2], r[3]);
    }
    add_step(acc[2 * np], t0);
    add_step(acc[2 * np + 1], t1);
  }
}

// The warp's 16 output rows (acc * mul, bf16) through its own rows of a
// swizzled tile, then 16-byte stores through the output's row stride.
__device__ __forceinline__ void store_rows(const float acc[8][4], float mul,
                                           unsigned char* tile, int wrow,
                                           int lane, bf16* out, int64_t ld,
                                           int row0, int rows) {
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    *reinterpret_cast<uint32_t*>(tile + mma::swz(wrow + g, n) + 4 * t) =
        mma::pack_bf16(mul * acc[n][0], mul * acc[n][1]);
    *reinterpret_cast<uint32_t*>(tile + mma::swz(wrow + g + 8, n) + 4 * t) =
        mma::pack_bf16(mul * acc[n][2], mul * acc[n][3]);
  }
  __syncwarp();
#pragma unroll
  for (int it = 0; it < 4; ++it) {
    const int idx = lane + 32 * it;
    const int r = idx >> 3, c = idx & 7;
    const int row = row0 + wrow + r;
    if (row < rows)
      *reinterpret_cast<uint4*>(out + row * ld + c * 8) =
          *reinterpret_cast<const uint4*>(tile + mma::swz(wrow + r, c));
  }
}


// K3: one CTA per (64-row query tile, b * H + h); loops over key tiles.
template <bool kDrop>
__global__ void __launch_bounds__(kTcThreads, kDqMinBlocks)
    flash_dq_tc_kernel(const BwdParams a) {
  // q | dO | k[2] | v[2]
  __shared__ __align__(128) unsigned char smem[6 * mma::kTileBytes];
  const uint32_t s_q = mma::smem_addr(smem);
  const uint32_t s_do = s_q + mma::kTileBytes;
  const uint32_t s_k = s_q + 2 * mma::kTileBytes;
  const uint32_t s_v = s_q + 4 * mma::kTileBytes;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wrow = warp * 16;
  const int q0 = blockIdx.x * kTcBlock;
  const int bh = blockIdx.y;
  const int b = bh / a.H, h = bh - b * a.H;
  const int Lq = a.Lq, Lk = a.Lk;
  const bf16* qb = static_cast<const bf16*>(a.q) + off(a.sq, b, h);
  const bf16* kb = static_cast<const bf16*>(a.k) + off(a.sk, b, h);
  const bf16* vb = static_cast<const bf16*>(a.v) + off(a.sv, b, h);
  const bf16* ob = static_cast<const bf16*>(a.o) + off(a.so, b, h);
  const bf16* dob = static_cast<const bf16*>(a.dout) + off(a.sdo, b, h);
  const float* biasb = a.bias + b * a.bias_b;

  uint32_t s0 = 0, s1 = 0;
  if (kDrop) {
    s0 = (uint32_t)a.drop.seed[0];
    s1 = (uint32_t)a.drop.seed[1];
  }

  auto load_kv = [&](int buf, int k0) {
    mma::load_tile_async<kTcThreads>(s_k + buf * mma::kTileBytes, kb, a.sk.r, k0, Lk);
    mma::load_tile_async<kTcThreads>(s_v + buf * mma::kTileBytes, vb, a.sv.r, k0, Lk);
  };
  const int n_tiles = (Lk + kTcBlock - 1) / kTcBlock;
  mma::load_tile_async<kTcThreads>(s_q, qb, a.sq.r, q0, Lq);
  mma::load_tile_async<kTcThreads>(s_do, dob, a.sdo.r, q0, Lq);
  load_kv(0, 0);
  mma::cp_async_commit();
  if (n_tiles > 1) load_kv(1, kTcBlock);
  mma::cp_async_commit();

  // delta of the warp's 16 query rows, from global memory while the tiles
  // are in flight: lanes 2r and 2r + 1 own row r; rows g and g + 8 of the
  // accumulator are then lanes 2g and 2g + 16.
  const int drow = q0 + wrow + lane / 2;
  const float dlt_row = row_delta(dob, a.sdo.r, ob, a.so.r, drow, Lq, lane & 1);
  if ((lane & 1) == 0 && drow < Lq) a.delta[(size_t)bh * Lq + drow] = dlt_row;
  const float dlt[2] = {__shfl_sync(kFull, dlt_row, 2 * g),
                        __shfl_sync(kFull, dlt_row, 2 * g + 16)};
  float lse[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + wrow + g + 8 * i;
    lse[i] = row < Lq ? a.lse[(size_t)bh * Lq + row] : 0.f;
  }

  mma::cp_async_wait<1>();
  __syncthreads();

  float acc[8][4];  // dq: 8 blocks of 8 dims
  zero_acc(acc);

  for (int j = 0; j < n_tiles; ++j) {
    const int cur = j & 1, k0 = j * kTcBlock;
    const uint32_t kt = s_k + cur * mma::kTileBytes;
    const uint32_t vt = s_v + cur * mma::kTileBytes;
    // Not unrolled: both halves' fragments live at once spill under the cap.
#pragma unroll 1
    for (int half = 0; half < 2; ++half) {  // keys k0 + 32 * half + 0..31
      float s[4][4], dp[4][4];
      mma_abt_half(s_q, wrow, kt, 32 * half, lane, s);
      mma_abt_half(s_do, wrow, vt, 32 * half, lane, dp);
      // ds in place of s; a column past Lk or a row past Lq is 0.
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = k0 + 32 * half + 8 * n + 2 * t + c;
          const bool k_live = col < Lk;
          const float bias = k_live ? biasb[col] : 0.f;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int e = 2 * i + c;
            const int row = q0 + wrow + g + 8 * i;
            float ds = 0.f;
            if (k_live && row < Lq) {
              const float p = exp2f((s[n][e] * a.scale + bias - lse[i]) * kLog2e);
              float dpn = dp[n][e];
              if (kDrop)
                dpn = keep_bit(s0, s1, (uint32_t)b, (uint32_t)h, (uint32_t)row,
                               (uint32_t)col, a.drop.thresh)
                          ? dpn * a.drop.inv
                          : 0.f;
              ds = p * (dpn - dlt[i]);
            }
            s[n][e] = ds;
          }
        }
      // dq += ds . k over this half's two k16 steps.
      mma_xt_step<kDsTerms>(s, 0, kt, 32 * half, lane, acc);
      mma_xt_step<kDsTerms>(s, 2, kt, 32 * half + 16, lane, acc);
    }

    __syncthreads();  // every warp is done with buffer cur: refill it
    if (j + 2 < n_tiles) load_kv(cur, k0 + 2 * kTcBlock);
    mma::cp_async_commit();
    mma::cp_async_wait<1>();  // key tile j + 1 has landed
    __syncthreads();
  }

  // Only this warp reads its own rows of the q tile: stage dq there.
  store_rows(acc, a.scale, smem, wrow, lane,
             static_cast<bf16*>(a.dq) + off(a.sdq, b, h), a.sdq.r, q0, Lq);
}

// K2: one CTA per (64-row key tile, b * H + h); loops over query tiles.
template <bool kDrop>
__global__ void __launch_bounds__(kTcThreads, kDkdvMinBlocks)
    flash_dkdv_tc_kernel(const BwdParams a) {
  // k | v | q[2] | dO[2]
  __shared__ __align__(128) unsigned char smem[6 * mma::kTileBytes];
  const uint32_t s_k = mma::smem_addr(smem);
  const uint32_t s_v = s_k + mma::kTileBytes;
  const uint32_t s_q = s_k + 2 * mma::kTileBytes;
  const uint32_t s_do = s_k + 4 * mma::kTileBytes;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wrow = warp * 16;
  const int k0 = blockIdx.x * kTcBlock;
  const int bh = blockIdx.y;
  const int b = bh / a.H, h = bh - b * a.H;
  const int Lq = a.Lq, Lk = a.Lk;
  const bf16* qb = static_cast<const bf16*>(a.q) + off(a.sq, b, h);
  const bf16* kb = static_cast<const bf16*>(a.k) + off(a.sk, b, h);
  const bf16* vb = static_cast<const bf16*>(a.v) + off(a.sv, b, h);
  const bf16* dob = static_cast<const bf16*>(a.dout) + off(a.sdo, b, h);
  const float* lseb = a.lse + (size_t)bh * Lq;
  const float* dltb = a.delta + (size_t)bh * Lq;

  uint32_t s0 = 0, s1 = 0;
  if (kDrop) {
    s0 = (uint32_t)a.drop.seed[0];
    s1 = (uint32_t)a.drop.seed[1];
  }

  auto load_qdo = [&](int buf, int q0) {
    mma::load_tile_async<kTcThreads>(s_q + buf * mma::kTileBytes, qb, a.sq.r, q0, Lq);
    mma::load_tile_async<kTcThreads>(s_do + buf * mma::kTileBytes, dob, a.sdo.r, q0, Lq);
  };
  const int n_tiles = (Lq + kTcBlock - 1) / kTcBlock;
  mma::load_tile_async<kTcThreads>(s_k, kb, a.sk.r, k0, Lk);
  mma::load_tile_async<kTcThreads>(s_v, vb, a.sv.r, k0, Lk);
  load_qdo(0, 0);
  mma::cp_async_commit();
  if (n_tiles > 1) load_qdo(1, kTcBlock);
  mma::cp_async_commit();

  // The warp's key rows g and g + 8: their bias, and whether they exist.
  float bias[2];
  bool key_live[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k0 + wrow + g + 8 * i;
    key_live[i] = key < Lk;
    bias[i] = key_live[i] ? a.bias[b * a.bias_b + key] : 0.f;
  }

  mma::cp_async_wait<1>();
  __syncthreads();

  float dk[8][4], dv[8][4];
  zero_acc(dk);
  zero_acc(dv);
  float db[2] = {0.f, 0.f};

  for (int j = 0; j < n_tiles; ++j) {
    const int cur = j & 1, q0 = j * kTcBlock;
    const uint32_t qt = s_q + cur * mma::kTileBytes;
    const uint32_t dt = s_do + cur * mma::kTileBytes;
#pragma unroll 1
    for (int half = 0; half < 2; ++half) {  // queries q0 + 32 * half + 0..31
      float st[4][4], dpt[4][4];
      mma_abt_half(s_k, wrow, qt, 32 * half, lane, st);
      mma_abt_half(s_v, wrow, dt, 32 * half, lane, dpt);
      // y^T in place of S^T, ds^T in place of dP^T.
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = q0 + 32 * half + 8 * n + 2 * t + c;
          const bool q_live = col < Lq;
          const float lse = q_live ? lseb[col] : 0.f;
          const float dlt = q_live ? dltb[col] : 0.f;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int e = 2 * i + c;
            float y = 0.f, ds = 0.f;
            if (q_live && key_live[i]) {
              const float p = exp2f((st[n][e] * a.scale + bias[i] - lse) * kLog2e);
              float dpn = dpt[n][e];
              y = p;
              if (kDrop) {
                const bool keep = keep_bit(s0, s1, (uint32_t)b, (uint32_t)h,
                                           (uint32_t)col,
                                           (uint32_t)(k0 + wrow + g + 8 * i),
                                           a.drop.thresh);
                y = keep ? p * a.drop.inv : 0.f;
                dpn = keep ? dpn * a.drop.inv : 0.f;
              }
              ds = p * (dpn - dlt);
            }
            st[n][e] = y;
            dpt[n][e] = ds;
            db[i] += ds;
          }
        }
      // dv += y^T . dO and dk += ds^T . q over this half's two k16 steps.
      mma_xt_step<kYTerms>(st, 0, dt, 32 * half, lane, dv);
      mma_xt_step<kYTerms>(st, 2, dt, 32 * half + 16, lane, dv);
      mma_xt_step<kDsTerms>(dpt, 0, qt, 32 * half, lane, dk);
      mma_xt_step<kDsTerms>(dpt, 2, qt, 32 * half + 16, lane, dk);
    }

    __syncthreads();  // every warp is done with buffer cur: refill it
    if (j + 2 < n_tiles) load_qdo(cur, q0 + 2 * kTcBlock);
    mma::cp_async_commit();
    mma::cp_async_wait<1>();  // query tile j + 1 has landed
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float sum = mma::quad_sum(db[i]);
    if (t == 0 && key_live[i]) a.db[(size_t)bh * Lk + k0 + wrow + g + 8 * i] = sum;
  }
  // Only this warp reads its own rows of the k and v tiles: stage dk, dv
  // there.
  store_rows(dk, a.scale, smem, wrow, lane,
             static_cast<bf16*>(a.dk) + off(a.sdk, b, h), a.sdk.r, k0, Lk);
  store_rows(dv, 1.f, smem + mma::kTileBytes, wrow, lane,
             static_cast<bf16*>(a.dv) + off(a.sdv, b, h), a.sdv.r, k0, Lk);
}

// ----------------------------------------- fp32: exact FMA products
using namespace flash;

constexpr int kDkdvSmemBytes = (8 * kTileFloats + 2 * kTile) * (int)sizeof(float);
constexpr int kDqSmemBytes = (6 * kTileFloats + kTile) * (int)sizeof(float);

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

// K2, fp32: one CTA per (64-row key tile, b * H + h); loops over query tiles.
template <bool kDrop>
__global__ void __launch_bounds__(kThreads)
    flash_dkdv_kernel(const BwdParams a) {
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
  const int b = bh / a.H, h = bh - b * a.H;
  const int Lq = a.Lq, Lk = a.Lk;
  const float* qb = static_cast<const float*>(a.q) + off(a.sq, b, h);
  const float* kb = static_cast<const float*>(a.k) + off(a.sk, b, h);
  const float* vb = static_cast<const float*>(a.v) + off(a.sv, b, h);
  const float* dob = static_cast<const float*>(a.dout) + off(a.sdo, b, h);
  const float* lseb = a.lse + (size_t)bh * Lq;
  const float* dltb = a.delta + (size_t)bh * Lq;
  const float* biasb = a.bias + b * a.bias_b;

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  uint32_t s0 = 0, s1 = 0;
  if (kDrop) {
    s0 = (uint32_t)a.drop.seed[0];
    s1 = (uint32_t)a.drop.seed[1];
  }
  float bj[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = k0 + tx * 4 + j;
    bj[j] = col < Lk ? biasb[col] : 0.f;
  }

  load_tile<float, true>(kb, k0, Lk, kT, a.sk.r);
  load_tile<float, true>(vb, k0, Lk, vT, a.sv.r);

  float dk_acc[4][4], dv_acc[4][4];
  zero_4x4(dk_acc);
  zero_4x4(dv_acc);
  float db_acc = 0.f;  // key column threadIdx.x (threads 0..63)

  for (int q0 = 0; q0 < Lq; q0 += kTile) {
    __syncthreads();  // the previous step is done with every q-side tile
    load_tile<float, true>(qb, q0, Lq, qT, a.sq.r);
    load_tile<float, true>(dob, q0, Lq, doT, a.sdo.r);
    load_tile<float, false>(qb, q0, Lq, qR, a.sq.r);
    load_tile<float, false>(dob, q0, Lq, doR, a.sdo.r);
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
                       Lk, a.scale, s0, s1, (uint32_t)b, (uint32_t)h, a.drop,
                       y, ds);
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

  float* dkb = static_cast<float*>(a.dk) + off(a.sdk, b, h);
  float* dvb = static_cast<float*>(a.dv) + off(a.sdv, b, h);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ty * 4 + i;
    if (row >= Lk) continue;
    *reinterpret_cast<float4*>(dkb + row * a.sdk.r + tx * 4) =
        make_float4(a.scale * dk_acc[i][0], a.scale * dk_acc[i][1],
                    a.scale * dk_acc[i][2], a.scale * dk_acc[i][3]);
    *reinterpret_cast<float4*>(dvb + row * a.sdv.r + tx * 4) =
        make_float4(dv_acc[i][0], dv_acc[i][1], dv_acc[i][2], dv_acc[i][3]);
  }
  if (threadIdx.x < kTile && k0 + (int)threadIdx.x < Lk)
    a.db[(size_t)bh * Lk + k0 + threadIdx.x] = db_acc;
}

// K3, fp32: one CTA per (64-row query tile, b * H + h); loops over key
// tiles. Its prologue computes delta for K2.
template <bool kDrop>
__global__ void __launch_bounds__(kThreads)
    flash_dq_kernel(const BwdParams a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* qT = smem;                // [kD][kLd]     q tile, transposed
  float* doT = qT + kTileFloats;   // [kD][kLd]     dO tile, transposed
  float* kT = doT + kTileFloats;   // [kD][kLd]     k tile, transposed
  float* vT = kT + kTileFloats;    // [kD][kLd]     v tile, transposed
  float* kR = vT + kTileFloats;    // [kTile][kLd]  k tile, rows
  float* dsT = kR + kTileFloats;   // [k][q]        ds, transposed
  float* dltS = dsT + kTileFloats; // [kTile]

  const int q0 = blockIdx.x * kTile;
  const int bh = blockIdx.y;
  const int b = bh / a.H, h = bh - b * a.H;
  const int Lq = a.Lq, Lk = a.Lk;
  const float* qb = static_cast<const float*>(a.q) + off(a.sq, b, h);
  const float* kb = static_cast<const float*>(a.k) + off(a.sk, b, h);
  const float* vb = static_cast<const float*>(a.v) + off(a.sv, b, h);
  const float* ob = static_cast<const float*>(a.o) + off(a.so, b, h);
  const float* dob = static_cast<const float*>(a.dout) + off(a.sdo, b, h);
  const float* biasb = a.bias + b * a.bias_b;

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  uint32_t s0 = 0, s1 = 0;
  if (kDrop) {
    s0 = (uint32_t)a.drop.seed[0];
    s1 = (uint32_t)a.drop.seed[1];
  }

  // delta = rowsum(dO * O): four neighbouring lanes a row, 16 dims each.
  {
    const int r = threadIdx.x / 4, part = threadIdx.x % 4;
    const int row = q0 + r;
    float sum = 0.f;
    if (row < Lq) {
#pragma unroll
      for (int c = 0; c < 16; c += 4) {
        float x[4], y[4];
        load4(dob + row * a.sdo.r + part * 16 + c, x);
        load4(ob + row * a.so.r + part * 16 + c, y);
#pragma unroll
        for (int e = 0; e < 4; ++e) sum += x[e] * y[e];
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    if (part == 0) {
      dltS[r] = sum;
      if (row < Lq) a.delta[(size_t)bh * Lq + row] = sum;
    }
  }

  float lse_i[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    lse_i[i] = row < Lq ? a.lse[(size_t)bh * Lq + row] : 0.f;
  }

  load_tile<float, true>(qb, q0, Lq, qT, a.sq.r);
  load_tile<float, true>(dob, q0, Lq, doT, a.sdo.r);
  __syncthreads();  // dltS is written
  float dlt_i[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) dlt_i[i] = dltS[ty * 4 + i];

  float dq_acc[4][4];
  zero_4x4(dq_acc);

  for (int k0 = 0; k0 < Lk; k0 += kTile) {
    __syncthreads();  // the previous step is done with kT, vT, kR and dsT
    load_tile<float, true>(kb, k0, Lk, kT, a.sk.r);
    load_tile<float, true>(vb, k0, Lk, vT, a.sv.r);
    load_tile<float, false>(kb, k0, Lk, kR, a.sk.r);
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
                       Lk, a.scale, s0, s1, (uint32_t)b, (uint32_t)h, a.drop,
                       y, ds);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) dsT[(tx * 4 + j) * kLd + ty * 4 + i] = ds[i][j];
    __syncthreads();

    mma_4x4(dsT, kR, ty * 4, tx * 4, dq_acc);
  }

  float* dqb = static_cast<float*>(a.dq) + off(a.sdq, b, h);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= Lq) continue;
    *reinterpret_cast<float4*>(dqb + row * a.sdq.r + tx * 4) =
        make_float4(a.scale * dq_acc[i][0], a.scale * dq_acc[i][1],
                    a.scale * dq_acc[i][2], a.scale * dq_acc[i][3]);
  }
}

// Allow an fp32 kernel its dynamic shared memory on the current device,
// once per device (the attribute is a property of the device's context,
// so later launches need not set it again). `done` is the caller's own.
cudaError_t allow_smem(const void* kernel, int bytes,
                       std::atomic<uint64_t>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? (uint64_t{1} << dev) : 0;
  if (bit != 0 && (done.load(std::memory_order_acquire) & bit)) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

template <bool kDrop>
int launch_dq(const BwdParams& a, cudaStream_t stream, bool fp32) {
  if (fp32) {
    static std::atomic<uint64_t> done{0};
    cudaError_t err = allow_smem((const void*)flash_dq_kernel<kDrop>, kDqSmemBytes, done);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((a.Lq + kTile - 1) / kTile, a.B * a.H);
    flash_dq_kernel<kDrop><<<grid, kThreads, kDqSmemBytes, stream>>>(a);
  } else {
    dim3 grid((a.Lq + kTcBlock - 1) / kTcBlock, a.B * a.H);
    flash_dq_tc_kernel<kDrop><<<grid, kTcThreads, 0, stream>>>(a);
  }
  return (int)cudaGetLastError();
}

template <bool kDrop>
int launch_dkdv(const BwdParams& a, cudaStream_t stream, bool fp32) {
  if (fp32) {
    static std::atomic<uint64_t> done{0};
    cudaError_t err = allow_smem((const void*)flash_dkdv_kernel<kDrop>, kDkdvSmemBytes, done);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((a.Lk + kTile - 1) / kTile, a.B * a.H);
    flash_dkdv_kernel<kDrop><<<grid, kThreads, kDkdvSmemBytes, stream>>>(a);
  } else {
    dim3 grid((a.Lk + kTcBlock - 1) / kTcBlock, a.B * a.H);
    flash_dkdv_tc_kernel<kDrop><<<grid, kTcThreads, 0, stream>>>(a);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, O and dO: [B, H, L, 64] read through (batch, head, row) strides
// in elements (last dim contiguous, 16-byte aligned rows); dq, dk and dv:
// written through their own strides; bias: fp32 key bias, Lk contiguous
// values per batch row, rows bias_b elements apart (0: one row for every
// batch); lse: fp32 [B, H, Lq]; delta: fp32 [B, H, Lq], written by the dq
// launch and read by the dkdv launch, which must follow it on the stream;
// db: fp32 [B, H, Lk]; seed: two int64 words on the device, or null for
// no dropout (then thresh and inv are unused). The dq launch ignores dk,
// dv and db; the dkdv launch ignores o and dq. Each returns the
// cudaError_t of its launch.
#define FLASH_BWD_ARGS                                                        \
  const void *q, const void *k, const void *v, const void *bias,             \
      long long bias_b, const void *o, const void *lse, void *delta,         \
      const void *dout, const void *seed, void *dq, void *dk, void *dv,      \
      void *db, int B, int H, int Lq, int Lk, long long qb, long long qh,    \
      long long qr, long long kb, long long kh, long long kr, long long vb,  \
      long long vh, long long vr, long long ob, long long oh, long long orow, \
      long long dob, long long doh, long long dor, long long dqb,            \
      long long dqh, long long dqr, long long dkb, long long dkh,            \
      long long dkr, long long dvb, long long dvh, long long dvr,            \
      float scale, unsigned int thresh, float inv, void *stream

static BwdParams make_params(FLASH_BWD_ARGS) {
  return BwdParams{q, k, v, static_cast<const float*>(bias), bias_b, o,
                   static_cast<const float*>(lse), static_cast<float*>(delta),
                   dout, dq, dk, dv, static_cast<float*>(db),
                   Strides{qb, qh, qr}, Strides{kb, kh, kr}, Strides{vb, vh, vr},
                   Strides{ob, oh, orow}, Strides{dob, doh, dor},
                   Strides{dqb, dqh, dqr}, Strides{dkb, dkh, dkr},
                   Strides{dvb, dvh, dvr}, B, H, Lq, Lk, scale,
                   DropParams{static_cast<const int64_t*>(seed), thresh, inv}};
}

#define FLASH_BWD_PASS                                                        \
  q, k, v, bias, bias_b, o, lse, delta, dout, seed, dq, dk, dv, db, B, H, Lq, \
      Lk, qb, qh, qr, kb, kh, kr, vb, vh, vr, ob, oh, orow, dob, doh, dor,    \
      dqb, dqh, dqr, dkb, dkh, dkr, dvb, dvh, dvr, scale, thresh, inv, stream

#define FLASH_BWD_ENTRY(name, launch, fp32)                                   \
  extern "C" int name(FLASH_BWD_ARGS) {                                       \
    const BwdParams a = make_params(FLASH_BWD_PASS);                          \
    cudaStream_t s = (cudaStream_t)stream;                                    \
    return seed == nullptr ? launch<false>(a, s, fp32) : launch<true>(a, s, fp32); \
  }

FLASH_BWD_ENTRY(flash_bwd_dq_bf16, launch_dq, false)
FLASH_BWD_ENTRY(flash_bwd_dq_f32, launch_dq, true)
FLASH_BWD_ENTRY(flash_bwd_dkdv_bf16, launch_dkdv, false)
FLASH_BWD_ENTRY(flash_bwd_dkdv_f32, launch_dkdv, true)
