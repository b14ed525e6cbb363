// One multi-tensor Adam update for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves its optimizer to optax,
// which XLA fuses into the train step. The port's plain version
// (ops/adam.py::adam_reference) is optax's clip -> Adam(W) -> lr -> warmup
// chain as a run of torch._foreach_* passes, each of which reads and
// writes the whole leaf set: about 132 bytes an element against the 28
// the update needs, plus four full-size temporaries. This kernel does the
// same arithmetic in one pass over every leaf of the step.
//
// Per element, in fp32, each operation rounded on its own as the chain's
// CUDA op rounds it (so __fmul_rn / __fadd_rn / __fdiv_rn / __fsqrt_rn:
// no FMA contraction, IEEE division and square root; the library is built
// without --use_fast_math and without -ftz, as PyTorch is):
//
//   g   = clip && !(g_norm < max) ? (g / g_norm) * max : g
//   mu  = mu * b1 + g * (1 - b1)
//   nu  = nu * b2 + (g * g) * (1 - b2)
//   u   = (mu * (1 / bc1)) / (sqrt(nu * (1 / bc2)) + eps)
//   u   = u + p * wd                         (weight decay only)
//   u   = u * (-lr)
//   u   = u * warmup                         (warmup only)
//   p   = p + u
//
// Every scalar arrives as the fp32 that PyTorch narrows a Python scalar
// to for an fp32 foreach op. PyTorch's CUDA foreach divide by a scalar
// multiplies by the scalar's reciprocal, taken in double and narrowed
// once (measured on the card: a true divide differs in 15-60% of
// elements), so the wrapper hands over 1 / bc1 and 1 / bc2 that way. The
// clip's g / g_norm divides by a device tensor, a true divide. g_norm is
// a device scalar, so the clip needs no host sync.
//
// Bound on the card (NVIDIA H100 SXM): p, g, mu and nu read once and p, mu
// and nu written once, 28 bytes an element, and 14 to 19 fp32 operations: far
// below the ridge line, so bytes bound it. BERT-large's 335 M elements
// are 9.4 GB, 2.80 ms at 3.35 TB/s; DistilBERT's 66.4 M, 0.555 ms.
// Nothing is reused, so shared memory and TMA have nothing to offer; the
// design keeps enough bytes in flight and launches once a step:
//   * the leaf table (four pointers, an element count, a chunk prefix and
//     a vector flag a leaf) travels in the kernel's parameter space
//     (__grid_constant__, up to 32,764 bytes since CUDA 12.1): no host
//     sync and no copy to the card per step. kMaxLeaves leaves fit one
//     launch; the wrapper splits a longer list into several launches;
//   * each leaf is cut into chunks of kChunk elements; a grid of as many
//     blocks as the SMs hold at once walks the launch's chunks in stride,
//     and a block finds its chunk's leaf by a binary search of the prefix;
//   * a leaf whose four pointers are 16-byte aligned moves as float4, 4 of
//     them a thread a chunk, all loads issued before the arithmetic, and
//     the ragged tail of its last chunk as scalars; any other leaf moves as
//     scalars throughout (the port's leaves are allocations of their own,
//     so aligned; a stacked federated row is misaligned only where its
//     leaf's size is not a multiple of 4).

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kMaxLeaves = 512;
constexpr int kThreads = 256;
constexpr int kVec = 4;                           // float4s a thread a chunk
constexpr int kChunk = kThreads * kVec * 4;       // elements a chunk

}  // namespace

// Mirrored field for field by ops/adam.py's AdamArgs (ctypes).
struct AdamArgs {
  const float* g_norm;  // device scalar; read only when clip != 0
  float b1, one_minus_b1, b2, one_minus_b2;
  float inv_bc1, inv_bc2, eps, weight_decay, neg_lr, warmup, max_norm;
  int clip, decay, warm;  // flags: the chain's optional steps
  int count;              // leaves in this launch, 1 .. kMaxLeaves
  float* p[kMaxLeaves];
  float* m[kMaxLeaves];
  float* v[kMaxLeaves];
  const float* g[kMaxLeaves];
  long long n[kMaxLeaves];
  int chunk_end[kMaxLeaves];  // inclusive prefix of each leaf's chunks
  int vec[kMaxLeaves];        // 1: all four pointers 16-byte aligned
};

static_assert(sizeof(AdamArgs) <= 32764, "the leaf table must fit the kernel's parameter space");
static_assert(offsetof(AdamArgs, p) == 72, "ops/adam.py mirrors this layout");

namespace {

struct Scalars {
  float b1, omb1, b2, omb2, inv_bc1, inv_bc2, eps, wd, neg_lr, warm, max_norm, g_norm;
  bool clipped, decay, warmup;
};

__device__ __forceinline__ void adam_element(float& p, float g, float& m, float& v, const Scalars& s) {
  if (s.clipped) g = __fmul_rn(__fdiv_rn(g, s.g_norm), s.max_norm);
  m = __fadd_rn(__fmul_rn(m, s.b1), __fmul_rn(g, s.omb1));
  v = __fadd_rn(__fmul_rn(v, s.b2), __fmul_rn(__fmul_rn(g, g), s.omb2));
  const float den = __fadd_rn(__fsqrt_rn(__fmul_rn(v, s.inv_bc2)), s.eps);
  float u = __fdiv_rn(__fmul_rn(m, s.inv_bc1), den);
  if (s.decay) u = __fadd_rn(u, __fmul_rn(p, s.wd));
  u = __fmul_rn(u, s.neg_lr);
  if (s.warmup) u = __fmul_rn(u, s.warm);
  p = __fadd_rn(p, u);
}

__device__ __forceinline__ void adam_element4(float4& p, const float4& g, float4& m, float4& v, const Scalars& s) {
  adam_element(p.x, g.x, m.x, v.x, s);
  adam_element(p.y, g.y, m.y, v.y, s);
  adam_element(p.z, g.z, m.z, v.z, s);
  adam_element(p.w, g.w, m.w, v.w, s);
}

__global__ void __launch_bounds__(kThreads)
adam_multi_tensor_kernel(const __grid_constant__ AdamArgs a) {
  Scalars s{a.b1, a.one_minus_b1, a.b2, a.one_minus_b2, a.inv_bc1, a.inv_bc2, a.eps,
            a.weight_decay, a.neg_lr, a.warmup, a.max_norm, 1.0f,
            false, a.decay != 0, a.warm != 0};
  if (a.clip) {
    s.g_norm = *a.g_norm;
    s.clipped = !(s.g_norm < s.max_norm);
  }
  const int total = a.chunk_end[a.count - 1];
  const int t = threadIdx.x;
  for (int chunk = blockIdx.x; chunk < total; chunk += gridDim.x) {
    int lo = 0, hi = a.count - 1;  // the first leaf whose prefix passes chunk
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (a.chunk_end[mid] > chunk) hi = mid; else lo = mid + 1;
    }
    const int leaf = lo;
    const long long base = (long long)(chunk - (leaf ? a.chunk_end[leaf - 1] : 0)) * kChunk;
    const long long rest = a.n[leaf] - base;
    const int len = rest < kChunk ? (int)rest : kChunk;
    float* p = a.p[leaf] + base;
    float* m = a.m[leaf] + base;
    float* v = a.v[leaf] + base;
    const float* g = a.g[leaf] + base;
    int done = 0;
    if (a.vec[leaf]) {
      const int n4 = len >> 2;
      float4 pr[kVec], gr[kVec], mr[kVec], vr[kVec];
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const int i = t + j * kThreads;
        if (i < n4) {
          pr[j] = reinterpret_cast<const float4*>(p)[i];
          gr[j] = reinterpret_cast<const float4*>(g)[i];
          mr[j] = reinterpret_cast<const float4*>(m)[i];
          vr[j] = reinterpret_cast<const float4*>(v)[i];
        }
      }
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const int i = t + j * kThreads;
        if (i < n4) {
          adam_element4(pr[j], gr[j], mr[j], vr[j], s);
          reinterpret_cast<float4*>(p)[i] = pr[j];
          reinterpret_cast<float4*>(m)[i] = mr[j];
          reinterpret_cast<float4*>(v)[i] = vr[j];
        }
      }
      done = n4 << 2;
    }
    for (int i = done + t; i < len; i += kThreads) {
      float pe = p[i], me = m[i], ve = v[i];
      adam_element(pe, g[i], me, ve, s);
      p[i] = pe;
      m[i] = me;
      v[i] = ve;
    }
  }
}

int blocks_for(int chunks) {
  static int resident = 0;  // blocks the whole card holds at once
  if (resident == 0) {
    int dev = 0, sms = 132, per_sm = 1;
    if (cudaGetDevice(&dev) == cudaSuccess)
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, adam_multi_tensor_kernel, kThreads, 0);
    resident = sms * (per_sm > 0 ? per_sm : 1);
  }
  return chunks < resident ? chunks : resident;
}

}  // namespace

extern "C" int adam_args_bytes() { return (int)sizeof(AdamArgs); }

extern "C" int adam_chunk_elements() { return kChunk; }

extern "C" int adam_max_leaves() { return kMaxLeaves; }

// args: one launch's table, filled by ops/adam.py (count >= 1, every leaf
// n >= 1, chunk_end[count - 1] >= 1). Returns the cudaError_t of the launch.
extern "C" int adam_f32(const AdamArgs* args, void* stream) {
  adam_multi_tensor_kernel<<<blocks_for(args->chunk_end[args->count - 1]), kThreads, 0,
                             (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}
