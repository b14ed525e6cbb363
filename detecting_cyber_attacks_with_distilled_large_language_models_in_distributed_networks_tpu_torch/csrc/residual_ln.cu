// Residual add + LayerNorm of a post-LN block for Hopper (sm_90a), forward
// and backward.
//
// Replaces no TPU kernel: the JAX package writes `LayerNorm(x + r)` as
// plain ops that XLA fuses into one pass. The port's plain version
// (ops/residual_ln.py::residual_layer_norm_reference, the expression of
// models/distilbert.py before this kernel) is four passes over the
// activations: the add in the activation dtype, `.float()`, an fp32
// LayerNorm and `.to(dtype)`, 26 bytes a bf16 element where one pass moves
// 6, and a backward of about 32 where one pass moves 6.
//
// Per row of n elements, in fp32 (T the activation dtype):
//
//   s    = T(x + r)                 rounded as PyTorch's add rounds it (an
//                                   fp32 sum, then round to nearest even)
//   mean = sum(s) / n, var = sum((s - mean)^2) / n,  rstd = rsqrt(var + eps)
//   y    = T((s - mean) * rstd * gamma + beta)       gamma, beta fp32
//
// In training the forward also writes s (T) and (mean, rstd) a row, and
// the backward recomputes x_hat from them:
//
//   g  = dy * gamma,  dx = T(rstd * (g - sum(g) / n - x_hat * sum(g * x_hat) / n))
//   dgamma = sum over rows of dy * x_hat,  dbeta = sum over rows of dy
//
// dx is the gradient of both x and r. dgamma and dbeta are summed in a
// fixed order with no atomics: each block writes one fp32 partial row of
// its rows' sums, and a second small kernel adds the blocks' rows in block
// order, so two runs on one card give the same bits.
//
// Bound on the card (NVIDIA H100 SXM): a bf16 forward reads x and r and
// writes y, 6 bytes an element (8 in training, with s); the backward reads
// dy and s and writes dx, 6. A few fp32 operations an element: far below
// the ridge line, so bytes bound both. At bert-large's 16,384 x 1,024 that
// is 30.0 us a forward at 3.35 TB/s. Nothing is reused, so shared memory
// and TMA have nothing to offer: the design keeps a row's loads in flight
// at once and touches each byte once.
//
// Two routes, chosen by the wrapper (ops/residual_ln.py) from the dtype,
// the width and the pointers, with no other knob:
//   * bf16 rows up to 1,024 wide whose width is a whole number of 16-byte
//     vectors and whose pointers are 16-byte aligned (every model path of
//     the card): one warp a row holds the row in registers, PER of its
//     vectors a lane (PER the least of 1, 2, 4 that covers the row: 3 or 4
//     a lane at 768 and 1,024 wide), 16-byte loads and stores; the backward
//     keeps each lane's column sums in registers over the rows its warp
//     walks, and its block adds its warps' sums in warp order;
//   * any other row (fp32, odd widths, misaligned views): one warp a row
//     walks the row with element loads, reading it again from L1 for each
//     pass; the backward's column sums come from a column-parallel kernel
//     over contiguous row chunks. Few template instances on purpose: the
//     library is built beside K1's on a cold start and must not take
//     longer to compile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kFwdWarps = 4;      // rows a forward block (one warp a row)
constexpr int kBwdWarps = 8;      // warps a backward block
constexpr int kSumWarps = 8;      // warps a block of the column sum
constexpr int kColThreads = 128;  // columns a block of the generic column sums
constexpr int kV = 8;             // bf16 elements of a 16-byte vector

__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(float v) { return v; }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16_rn(v); }
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }

// The sum of two activations, rounded to T and widened again.
template <typename T>
__device__ __forceinline__ float residual(T a, T b) { return to_f(from_f<T>(__fadd_rn(to_f(a), to_f(b)))); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Element i of a loaded bf16 vector, widened (i a constant once the loops
// are unrolled, so the selects fold away; a bf16 is the top half of its
// fp32).
__device__ __forceinline__ float elem(const uint4& raw, int i) {
  const int k = i >> 1;
  const unsigned w = k == 0 ? raw.x : k == 1 ? raw.y : k == 2 ? raw.z : raw.w;
  return __uint_as_float((i & 1) ? (w & 0xffff0000u) : (w << 16));
}

// Eight fp32 values rounded to bf16 and packed as one 16-byte vector.
__device__ __forceinline__ uint4 pack(const float (&v)[kV]) {
  unsigned w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const unsigned lo = __bfloat16_as_ushort(__float2bfloat16_rn(v[2 * k]));
    const unsigned hi = __bfloat16_as_ushort(__float2bfloat16_rn(v[2 * k + 1]));
    w[k] = lo | (hi << 16);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ void load_params(const float* __restrict__ p, int col, float (&out)[kV]) {
  const float4 a = *reinterpret_cast<const float4*>(p + col);
  const float4 b = *reinterpret_cast<const float4*>(p + col + 4);
  out[0] = a.x, out[1] = a.y, out[2] = a.z, out[3] = a.w;
  out[4] = b.x, out[5] = b.y, out[6] = b.z, out[7] = b.w;
}

// ------------------------------------------------------ bf16 rows in registers
template <int PER>
__global__ void __launch_bounds__(kFwdWarps * 32)
residual_layer_norm_fwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ r, const float* __restrict__ gamma,
                               const float* __restrict__ beta, bf16* __restrict__ y, bf16* __restrict__ s_out,
                               float2* __restrict__ stats, long long rows, int n, float eps) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kFwdWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int vectors = n / kV;
  const size_t base = (size_t)row * n;
  float s[PER][kV];
  float total = 0.0f;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int c = lane + 32 * j;
    uint4 a = make_uint4(0, 0, 0, 0), b = a;
    if (c < vectors) {
      a = *reinterpret_cast<const uint4*>(x + base + c * kV);
      b = *reinterpret_cast<const uint4*>(r + base + c * kV);
    }
#pragma unroll
    for (int i = 0; i < kV; ++i) {
      s[j][i] = to_f(__float2bfloat16_rn(__fadd_rn(elem(a, i), elem(b, i))));  // 0 past the row
      total += s[j][i];
    }
  }
  const float mean = warp_sum(total) / n;
  float sq = 0.0f;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    if (lane + 32 * j < vectors) {
#pragma unroll
      for (int i = 0; i < kV; ++i) {
        const float d = s[j][i] - mean;
        sq += d * d;
      }
    }
  }
  const float rstd = rsqrtf(warp_sum(sq) / n + eps);
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int c = lane + 32 * j;
    if (c < vectors) {
      float g[kV], b[kV], out[kV];
      load_params(gamma, c * kV, g);
      load_params(beta, c * kV, b);
#pragma unroll
      for (int i = 0; i < kV; ++i) out[i] = (s[j][i] - mean) * rstd * g[i] + b[i];
      *reinterpret_cast<uint4*>(y + base + c * kV) = pack(out);
      if (s_out != nullptr) *reinterpret_cast<uint4*>(s_out + base + c * kV) = pack(s[j]);
    }
  }
  if (stats != nullptr && lane == 0) stats[row] = make_float2(mean, rstd);
}

// dx of each row, and into partial[blockIdx.x] this block's fp32 sums of
// dy * x_hat (columns 0 .. n-1) and of dy (columns n .. 2n-1). A block's
// warps take rows blockIdx.x * kBwdWarps + warp, then every gridDim.x *
// kBwdWarps rows after it. A lane keeps its dy and s vectors as loaded and
// its column sums in fp32; gamma comes from L1 at each use. Dynamic
// shared memory: 2n floats.
template <int PER>
__global__ void __launch_bounds__(kBwdWarps * 32)
residual_layer_norm_bwd_kernel(const bf16* __restrict__ dy, const bf16* __restrict__ s,
                               const float2* __restrict__ stats, const float* __restrict__ gamma,
                               bf16* __restrict__ dx, float* __restrict__ partial, long long rows, int n) {
  extern __shared__ float block_sums[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int vectors = n / kV;
  const float inv_n = 1.0f / n;
  float acc_g[PER][kV], acc_b[PER][kV];
#pragma unroll
  for (int j = 0; j < PER; ++j) {
#pragma unroll
    for (int i = 0; i < kV; ++i) acc_g[j][i] = acc_b[j][i] = 0.0f;
  }
  for (long long row = (long long)blockIdx.x * kBwdWarps + warp; row < rows;
       row += (long long)gridDim.x * kBwdWarps) {
    const size_t base = (size_t)row * n;
    const float2 st = stats[row];
    uint4 d_raw[PER], s_raw[PER];
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int c = lane + 32 * j;
      d_raw[j] = s_raw[j] = make_uint4(0, 0, 0, 0);
      if (c < vectors) {
        d_raw[j] = *reinterpret_cast<const uint4*>(dy + base + c * kV);
        s_raw[j] = *reinterpret_cast<const uint4*>(s + base + c * kV);
      }
    }
    float sum_g = 0.0f, sum_gx = 0.0f;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int c = lane + 32 * j;
      if (c < vectors) {
        float gam[kV];
        load_params(gamma, c * kV, gam);
#pragma unroll
        for (int i = 0; i < kV; ++i) {
          const float d = elem(d_raw[j], i);
          const float xh = (elem(s_raw[j], i) - st.x) * st.y;
          const float g = d * gam[i];
          sum_g += g;
          sum_gx += g * xh;
          acc_g[j][i] += d * xh;
          acc_b[j][i] += d;
        }
      }
    }
    sum_g = warp_sum(sum_g) * inv_n;
    sum_gx = warp_sum(sum_gx) * inv_n;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int c = lane + 32 * j;
      if (c < vectors) {
        float gam[kV], out[kV];
        load_params(gamma, c * kV, gam);
#pragma unroll
        for (int i = 0; i < kV; ++i) {
          const float xh = (elem(s_raw[j], i) - st.x) * st.y;
          out[i] = st.y * (elem(d_raw[j], i) * gam[i] - sum_g - xh * sum_gx);
        }
        *reinterpret_cast<uint4*>(dx + base + c * kV) = pack(out);
      }
    }
  }
  // The block's sums, its warps added in warp order.
  for (int w = 0; w < kBwdWarps; ++w) {
    if (warp == w) {
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        const int c = lane + 32 * j;
        if (c < vectors) {
#pragma unroll
          for (int i = 0; i < kV; ++i) {
            const int col = c * kV + i;
            block_sums[col] = w == 0 ? acc_g[j][i] : block_sums[col] + acc_g[j][i];
            block_sums[n + col] = w == 0 ? acc_b[j][i] : block_sums[n + col] + acc_b[j][i];
          }
        }
      }
    }
    __syncthreads();
  }
  float* out = partial + (size_t)blockIdx.x * 2 * n;
  for (int col = threadIdx.x; col < 2 * n; col += blockDim.x) out[col] = block_sums[col];
}

// ------------------------------------------------------------------ any row
template <typename T>
__global__ void __launch_bounds__(kFwdWarps * 32)
residual_layer_norm_fwd_any_kernel(const T* __restrict__ x, const T* __restrict__ r, const float* __restrict__ gamma,
                                   const float* __restrict__ beta, T* __restrict__ y, T* __restrict__ s_out,
                                   float2* __restrict__ stats, long long rows, int n, float eps) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kFwdWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const size_t base = (size_t)row * n;
  float total = 0.0f;
  for (int i = lane; i < n; i += 32) total += residual(x[base + i], r[base + i]);
  const float mean = warp_sum(total) / n;
  float sq = 0.0f;
  for (int i = lane; i < n; i += 32) {
    const float d = residual(x[base + i], r[base + i]) - mean;
    sq += d * d;
  }
  const float rstd = rsqrtf(warp_sum(sq) / n + eps);
  for (int i = lane; i < n; i += 32) {
    const float v = residual(x[base + i], r[base + i]);
    y[base + i] = from_f<T>((v - mean) * rstd * gamma[i] + beta[i]);
    if (s_out != nullptr) s_out[base + i] = from_f<T>(v);
  }
  if (stats != nullptr && lane == 0) stats[row] = make_float2(mean, rstd);
}

// dx of each row, one warp a row, two passes.
template <typename T>
__global__ void __launch_bounds__(kFwdWarps * 32)
residual_layer_norm_bwd_any_kernel(const T* __restrict__ dy, const T* __restrict__ s, const float2* __restrict__ stats,
                                   const float* __restrict__ gamma, T* __restrict__ dx, long long rows, int n) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kFwdWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const size_t base = (size_t)row * n;
  const float2 st = stats[row];
  float sum_g = 0.0f, sum_gx = 0.0f;
  for (int i = lane; i < n; i += 32) {
    const float g = to_f(dy[base + i]) * gamma[i];
    sum_g += g;
    sum_gx += g * ((to_f(s[base + i]) - st.x) * st.y);
  }
  sum_g = warp_sum(sum_g) / n;
  sum_gx = warp_sum(sum_gx) / n;
  for (int i = lane; i < n; i += 32) {
    const float xh = (to_f(s[base + i]) - st.x) * st.y;
    dx[base + i] = from_f<T>(st.y * (to_f(dy[base + i]) * gamma[i] - sum_g - xh * sum_gx));
  }
}

// partial[blockIdx.y] = the sums over rows blockIdx.y * chunk .. + chunk,
// in row order, of dy * x_hat and of dy, one thread a column.
template <typename T>
__global__ void __launch_bounds__(kColThreads)
residual_layer_norm_bwd_cols_kernel(const T* __restrict__ dy, const T* __restrict__ s, const float2* __restrict__ stats,
                                    float* __restrict__ partial, long long rows, int n, long long chunk) {
  const int col = blockIdx.x * kColThreads + threadIdx.x;
  if (col >= n) return;
  const long long first = (long long)blockIdx.y * chunk;
  const long long last = first + chunk < rows ? first + chunk : rows;
  float acc_g = 0.0f, acc_b = 0.0f;
  for (long long row = first; row < last; ++row) {
    const float2 st = stats[row];
    const float d = to_f(dy[(size_t)row * n + col]);
    acc_g += d * ((to_f(s[(size_t)row * n + col]) - st.x) * st.y);
    acc_b += d;
  }
  partial[(size_t)blockIdx.y * 2 * n + col] = acc_g;
  partial[(size_t)blockIdx.y * 2 * n + n + col] = acc_b;
}

// out[col] = sum over b of partial[b][col], b ascending within each of a
// block's warps (warp w takes b = w, w + kSumWarps, ...), the warps' sums
// added in warp order. One lane a column, 32 columns a block.
__global__ void __launch_bounds__(kSumWarps * 32)
residual_layer_norm_dparams_kernel(const float* __restrict__ partial, int blocks, int cols, float* __restrict__ out) {
  __shared__ float sums[kSumWarps][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int col = blockIdx.x * 32 + lane;
  float acc = 0.0f;
  if (col < cols)
    for (int b = warp; b < blocks; b += kSumWarps) acc += partial[(size_t)b * cols + col];
  sums[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && col < cols) {
    float t = 0.0f;
#pragma unroll
    for (int w = 0; w < kSumWarps; ++w) t += sums[w][lane];
    out[col] = t;
  }
}

template <typename T>
int launch_fwd(const void* x, const void* r, const float* gamma, const float* beta, void* y, void* s_out, void* stats,
               long long rows, int n, float eps, int per, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((rows + kFwdWarps - 1) / kFwdWarps);
  const T* xt = static_cast<const T*>(x);
  const T* rt = static_cast<const T*>(r);
  T* yt = static_cast<T*>(y);
  T* st = static_cast<T*>(s_out);
  float2* stat = static_cast<float2*>(stats);
  if (per == 0) {
    residual_layer_norm_fwd_any_kernel<T><<<blocks, kFwdWarps * 32, 0, stream>>>(xt, rt, gamma, beta, yt, st, stat,
                                                                              rows, n, eps);
  } else if constexpr (sizeof(T) == 2) {
    switch (per) {
      case 1:
        residual_layer_norm_fwd_kernel<1><<<blocks, kFwdWarps * 32, 0, stream>>>(xt, rt, gamma, beta, yt, st, stat,
                                                                                 rows, n, eps);
        break;
      case 2:
        residual_layer_norm_fwd_kernel<2><<<blocks, kFwdWarps * 32, 0, stream>>>(xt, rt, gamma, beta, yt, st, stat,
                                                                                 rows, n, eps);
        break;
      case 4:
        residual_layer_norm_fwd_kernel<4><<<blocks, kFwdWarps * 32, 0, stream>>>(xt, rt, gamma, beta, yt, st, stat,
                                                                                 rows, n, eps);
        break;
      default:
        return (int)cudaErrorInvalidValue;
    }
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* dy, const void* s, const void* stats, const float* gamma, void* dx, float* partial,
               float* dparams, long long rows, int n, int blocks, int per, cudaStream_t stream) {
  const T* dyt = static_cast<const T*>(dy);
  const T* st = static_cast<const T*>(s);
  const float2* stat = static_cast<const float2*>(stats);
  T* dxt = static_cast<T*>(dx);
  if (per == 0) {
    const unsigned row_blocks = (unsigned)((rows + kFwdWarps - 1) / kFwdWarps);
    residual_layer_norm_bwd_any_kernel<T><<<row_blocks, kFwdWarps * 32, 0, stream>>>(dyt, st, stat, gamma, dxt, rows,
                                                                                     n);
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
    const dim3 grid((n + kColThreads - 1) / kColThreads, blocks);
    residual_layer_norm_bwd_cols_kernel<T><<<grid, kColThreads, 0, stream>>>(dyt, st, stat, partial, rows, n,
                                                                             (rows + blocks - 1) / blocks);
  } else if constexpr (sizeof(T) == 2) {
    const size_t smem = 2 * (size_t)n * sizeof(float);
    switch (per) {
      case 1:
        residual_layer_norm_bwd_kernel<1><<<blocks, kBwdWarps * 32, smem, stream>>>(dyt, st, stat, gamma, dxt,
                                                                                    partial, rows, n);
        break;
      case 2:
        residual_layer_norm_bwd_kernel<2><<<blocks, kBwdWarps * 32, smem, stream>>>(dyt, st, stat, gamma, dxt,
                                                                                    partial, rows, n);
        break;
      case 4:
        residual_layer_norm_bwd_kernel<4><<<blocks, kBwdWarps * 32, smem, stream>>>(dyt, st, stat, gamma, dxt,
                                                                                    partial, rows, n);
        break;
      default:
        return (int)cudaErrorInvalidValue;
    }
  } else {
    return (int)cudaErrorInvalidValue;
  }
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  const int cols = 2 * n;
  residual_layer_norm_dparams_kernel<<<(cols + 31) / 32, kSumWarps * 32, 0, stream>>>(partial, blocks, cols, dparams);
  return (int)cudaGetLastError();
}

}  // namespace

// x, r, y, s_out: [rows, n] of the activation dtype; gamma, beta: [n]
// fp32; stats: [rows] (mean, rstd) fp32 pairs. s_out and stats may be
// null (no backward to feed). per: 1, 2 or 4 vectors a lane for a bf16
// row held in registers (n a multiple of 8 up to 1,024, every pointer
// 16-byte aligned), 0 for any other row. Returns the cudaError_t of the
// launch.
#define RESIDUAL_LN_FWD_ARGS                                                     \
  const void *x, const void *r, const float *gamma, const float *beta, void *y, \
      void *s_out, void *stats, long long rows, int n, float eps, int per, void *stream

extern "C" int residual_ln_fwd_bf16(RESIDUAL_LN_FWD_ARGS) {
  return launch_fwd<bf16>(x, r, gamma, beta, y, s_out, stats, rows, n, eps, per, (cudaStream_t)stream);
}

extern "C" int residual_ln_fwd_f32(RESIDUAL_LN_FWD_ARGS) {
  return launch_fwd<float>(x, r, gamma, beta, y, s_out, stats, rows, n, eps, per, (cudaStream_t)stream);
}

// dy, s, dx: [rows, n] of the activation dtype; stats as the forward wrote
// them; partial: [blocks, 2n] fp32 scratch; dparams: [2n] fp32 out
// (dgamma, then dbeta); per as the forward's.
#define RESIDUAL_LN_BWD_ARGS                                                     \
  const void *dy, const void *s, const void *stats, const float *gamma, void *dx, \
      float *partial, float *dparams, long long rows, int n, int blocks, int per, void *stream

extern "C" int residual_ln_bwd_bf16(RESIDUAL_LN_BWD_ARGS) {
  return launch_bwd<bf16>(dy, s, stats, gamma, dx, partial, dparams, rows, n, blocks, per, (cudaStream_t)stream);
}

extern "C" int residual_ln_bwd_f32(RESIDUAL_LN_BWD_ARGS) {
  return launch_bwd<float>(dy, s, stats, gamma, dx, partial, dparams, rows, n, blocks, per, (cudaStream_t)stream);
}
