// Ordered weighted fold of K client leaves for Hopper (sm_90a): K4.
//
// Replaces the TPU kernel ops/fold.py::kernel of the JAX package (built by
// _build_pallas_fold, launched by fold_pallas <- fold_ordered <-
// comm/stream_agg.py StreamAgg._maybe_fold):
//
//   acc[i] = 0;  for k = 0 .. K-1 (ascending client id):
//                  acc[i] = acc[i] + float32(w[k]) * x[k][i]
//
// Contract: bit-exact with the numpy loop fold_naive, which is what every
// crc replay of a federated round pins. Each multiply and each add is
// rounded on its own (__fmul_rn, __fadd_rn): nvcc would otherwise contract
// a*b + c into one FMA, which rounds once where numpy rounds twice. The
// library is built without --use_fast_math and without -ftz, so subnormal
// inputs and products are kept as numpy keeps them. (A NaN input gives the
// card's canonical NaN, whose payload bits may differ from the host's.)
//
// Bound on the card. The fold reads each of the K leaves once and writes
// the result once: (K + 1) * n * 4 bytes, and does 2 * K * n fp32
// operations, far below the card's fp32 rate. It is bound by bytes: at
// K = 2 over the word-embedding leaf (n = 23,440,896) that is 281 MB,
// 84 us at 3.35 TB/s. The design streams: one thread per element (four
// per thread where rows allow 16-byte loads), neighbouring threads on
// neighbouring addresses, every byte read once, nothing staged.
//
// Layout: one stacked [K, n] buffer, row k the k-th client's leaf in fold
// order, and w[K] on the card. The wrapper copies each host leaf straight
// into its row, so stacking costs no extra pass on the card, and the
// kernel needs one pointer and one stride instead of a table of K pointers
// built and uploaded for every call. Rows start 16-byte aligned when n is
// a multiple of 4; then each thread folds a float4, else one float. Any
// n >= 1 works, n < 4 and ragged n included.
//
// Design (simple and right first): a grid-stride loop over elements, at
// most 8 blocks of 256 threads per SM; the K loop runs inside the thread
// in ascending order, so the TPU's sequential accumulation over K needs no
// cross-thread order at all.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

__device__ __forceinline__ float fold_step(float acc, float x, float w) {
  return __fadd_rn(acc, __fmul_rn(x, w));
}

__global__ void fold_scalar_kernel(const float* __restrict__ x,
                                   const float* __restrict__ w,
                                   float* __restrict__ out, int K,
                                   long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    float acc = 0.0f;
    for (int k = 0; k < K; ++k) acc = fold_step(acc, x[k * n + i], __ldg(w + k));
    out[i] = acc;
  }
}

// n4 = n / 4 float4 elements per row; rows are 16-byte aligned.
__global__ void fold_vec4_kernel(const float4* __restrict__ x,
                                 const float* __restrict__ w,
                                 float4* __restrict__ out, int K,
                                 long long n4) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += stride) {
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int k = 0; k < K; ++k) {
      const float4 v = x[k * n4 + i];
      const float wk = __ldg(w + k);
      acc.x = fold_step(acc.x, v.x, wk);
      acc.y = fold_step(acc.y, v.y, wk);
      acc.z = fold_step(acc.z, v.z, wk);
      acc.w = fold_step(acc.w, v.w, wk);
    }
    out[i] = acc;
  }
}

int grid_for(long long work) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long blocks = (work + kThreads - 1) / kThreads;
  const long long cap = (long long)sms * kBlocksPerSm;
  return (int)(blocks < cap ? blocks : cap);
}

}  // namespace

// x: contiguous fp32 [K, n] on the card, 16-byte aligned base; w: fp32 [K]
// on the card; out: fp32 [n]. K >= 1, n >= 1. Returns the cudaError_t of
// the launch.
extern "C" int fold_f32(const void* x, const void* w, void* out, int K,
                        long long n, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const float* wp = static_cast<const float*>(w);
  if (n % 4 == 0) {
    const long long n4 = n / 4;
    fold_vec4_kernel<<<grid_for(n4), kThreads, 0, s>>>(
        static_cast<const float4*>(x), wp, static_cast<float4*>(out), K, n4);
  } else {
    fold_scalar_kernel<<<grid_for(n), kThreads, 0, s>>>(
        static_cast<const float*>(x), wp, static_cast<float*>(out), K, n);
  }
  return (int)cudaGetLastError();
}
