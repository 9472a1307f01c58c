// Fused flat-bucket optimizer updates for Hopper (sm_90a), bound through a
// plain C interface and loaded with ctypes (paddle_tpu_torch/ops/kernels/).
//
// Replaces the Pallas TPU kernels of paddle_tpu/ops/pallas/zero_update.py,
// reached from fused_flat_update (:151) through _run_fused (:128):
//   _sgd_kernel       (:89)   -> zero_sgd_kernel        (B6)
//   _momentum_kernel  (:94)   -> zero_momentum_kernel   (B7)
//   _adam_kernel      (:108)  -> zero_adam_kernel       (B8, adam and adamw)
//
// What it computes: the dense update rule of ops/optimizer_ops.py over one
// flat ZeRO bucket (every parameter of the bucket concatenated, padded with
// zeros to a multiple of 64), in place:
//   B6 sgd       p <- p - lr*g
//   B7 momentum  g' = g + l2*p (l2_decay only); v <- mu*v + g';
//                p <- p - lr*(g' + mu*v) (nesterov) or p - lr*v
//   B8 adam      m1 <- b1*m1 + (1-b1)*g; m2 <- b2*m2 + (1-b2)*(g*g);
//                p <- p - lr_t*m1/(sqrt(m2) + eps)
//                adamw then p <- p - (lr*coeff)*p_old
// lr, and for B8 the [1] tensors Beta1Pow and Beta2Pow, are read from
// device memory, so nothing synchronises with the host. B8 forms the
// bias-corrected lr_t = (lr * sqrt(1 - b2p)) / (1 - b1p) itself, with the
// operations and rounding of the plain rule's `adam_lr_t` on [1] tensors,
// so one launch is the whole update of a bucket. The Python-float constants
// arrive rounded to f32 as PyTorch rounds a scalar for an f32 tensor.
//
// Rounding: every operation is an explicitly rounded intrinsic (__fmul_rn,
// __fadd_rn, __fsub_rn, __fdiv_rn, __fsqrt_rn) in the reference's order, so
// nvcc's default -fmad=true cannot contract a multiply and an add into one
// FMA. The plain PyTorch rule launches one kernel per operation and rounds
// each result, so kernel and plain version agree bit for bit.
//
// Bound: a few flops per element against 12 (B6), 20 (B7) or 28 (B8) bytes
// moved, far below the card's flop/byte balance: device-memory bytes bound
// it. Each element of every input is read once and every output written
// once, with neighbouring threads on neighbouring addresses. B6 and B7: a
// grid-stride loop of 4-byte accesses, 8 blocks of 256 threads per SM. B8:
// 16-byte accesses, two float4 of each array in flight per thread, where
// the four arrays share one offset mod 16 bytes (a scalar head up to the
// first 16-byte boundary, a scalar tail of up to 3 elements); otherwise the
// same kernel runs a scalar grid-stride loop. B8's grid is one full wave:
// the blocks the occupancy calculator lets reside on an SM at B8's register
// count, times the SMs, found once per process.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

__global__ void zero_sgd_kernel(const float* __restrict__ lr,
                                float* __restrict__ p,
                                const float* __restrict__ g, int64_t n) {
  const float lr0 = lr[0];
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    p[i] = __fsub_rn(p[i], __fmul_rn(lr0, g[i]));
  }
}

__global__ void zero_momentum_kernel(const float* __restrict__ lr,
                                     float* __restrict__ p,
                                     const float* __restrict__ g,
                                     float* __restrict__ v, int64_t n,
                                     float mu, float l2, int use_l2,
                                     int nesterov) {
  const float lr0 = lr[0];
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const float pi = p[i];
    float gi = g[i];
    if (use_l2) gi = __fadd_rn(gi, __fmul_rn(l2, pi));
    const float vo = __fadd_rn(__fmul_rn(mu, v[i]), gi);
    const float step = nesterov ? __fadd_rn(gi, __fmul_rn(mu, vo)) : vo;
    p[i] = __fsub_rn(pi, __fmul_rn(lr0, step));
    v[i] = vo;
  }
}

// B8's constants for one launch
struct AdamConst {
  float lrt, lrc, b1, omb1, b2, omb2, eps;
  int decay;
};

// one element of adam / adamw, each operation rounded as the plain rule
// rounds it, in its order
__device__ __forceinline__ void adam_step(float& p, float g, float& m1,
                                          float& m2, const AdamConst& k) {
  const float m1o = __fadd_rn(__fmul_rn(k.b1, m1), __fmul_rn(k.omb1, g));
  const float m2o =
      __fadd_rn(__fmul_rn(k.b2, m2), __fmul_rn(k.omb2, __fmul_rn(g, g)));
  const float upd =
      __fdiv_rn(__fmul_rn(k.lrt, m1o), __fadd_rn(__fsqrt_rn(m2o), k.eps));
  float po = __fsub_rn(p, upd);
  if (k.decay) po = __fsub_rn(po, __fmul_rn(k.lrc, p));
  p = po;
  m1 = m1o;
  m2 = m2o;
}

__device__ __forceinline__ void adam_step4(float4& p, float4 g, float4& m1,
                                           float4& m2, const AdamConst& k) {
  adam_step(p.x, g.x, m1.x, m2.x, k);
  adam_step(p.y, g.y, m1.y, m2.y, k);
  adam_step(p.z, g.z, m1.z, m2.z, k);
  adam_step(p.w, g.w, m1.w, m2.w, k);
}

// 16-byte accesses of the vector body
__device__ __forceinline__ float4 ld4(const float* a, int64_t v) {
  return reinterpret_cast<const float4*>(a)[v];
}
__device__ __forceinline__ void st4(float* a, int64_t v, float4 x) {
  reinterpret_cast<float4*>(a)[v] = x;
}

__device__ __forceinline__ void adam_at(float* p, const float* g, float* m1,
                                        float* m2, int64_t i,
                                        const AdamConst& k) {
  float pi = p[i], m1i = m1[i], m2i = m2[i];
  adam_step(pi, g[i], m1i, m2i, k);
  p[i] = pi;
  m1[i] = m1i;
  m2[i] = m2i;
}

// head >= 0: elements [0, head) scalar, then float4 from p + head (16-byte
// aligned in all four arrays), then the tail scalar; head < 0: all scalar
__global__ void __launch_bounds__(kThreads)
    zero_adam_kernel(const float* __restrict__ lr,
                     const float* __restrict__ b1p,
                     const float* __restrict__ b2p, float* __restrict__ p,
                     const float* __restrict__ g, float* __restrict__ m1,
                     float* __restrict__ m2, int64_t n, int head, float b1,
                     float one_minus_b1, float b2, float one_minus_b2,
                     float eps, float coeff, int decay) {
  const float lr0 = lr[0];
  AdamConst k;
  // lr_t = (lr * sqrt(1 - b2p)) / (1 - b1p), adam_lr_t's operations
  k.lrt = __fdiv_rn(__fmul_rn(lr0, __fsqrt_rn(__fsub_rn(1.0f, b2p[0]))),
                    __fsub_rn(1.0f, b1p[0]));
  // adamw's (lr * coeff), the [1]-tensor product the plain rule forms first
  k.lrc = decay ? __fmul_rn(lr0, coeff) : 0.0f;
  k.b1 = b1;
  k.omb1 = one_minus_b1;
  k.b2 = b2;
  k.omb2 = one_minus_b2;
  k.eps = eps;
  k.decay = decay;
  const int64_t tid =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t nt = static_cast<int64_t>(gridDim.x) * blockDim.x;
  if (head < 0) {
    for (int64_t i = tid; i < n; i += nt) adam_at(p, g, m1, m2, i, k);
    return;
  }
  if (tid < head) adam_at(p, g, m1, m2, tid, k);
  float* pv = p + head;
  const float* gv = g + head;
  float* m1v = m1 + head;
  float* m2v = m2 + head;
  const int64_t nv = (n - head) / 4;
  for (int64_t v = tid; v < nv; v += 2 * nt) {
    const int64_t w = v + nt;
    const bool two = w < nv;
    float4 pa = ld4(pv, v), ga = ld4(gv, v), m1a = ld4(m1v, v),
           m2a = ld4(m2v, v);
    float4 pb, gb, m1b, m2b;
    if (two) {
      pb = ld4(pv, w);
      gb = ld4(gv, w);
      m1b = ld4(m1v, w);
      m2b = ld4(m2v, w);
    }
    adam_step4(pa, ga, m1a, m2a, k);
    st4(pv, v, pa);
    st4(m1v, v, m1a);
    st4(m2v, v, m2a);
    if (two) {
      adam_step4(pb, gb, m1b, m2b, k);
      st4(pv, w, pb);
      st4(m1v, w, m1b);
      st4(m2v, w, m2b);
    }
  }
  const int64_t tail = head + 4 * nv;
  if (tid < n - tail) adam_at(p, g, m1, m2, tail + tid, k);
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      sms = 132;
  }
  return sms;
}

int grid_for(int64_t n) {
  const int64_t want = (n + kThreads - 1) / kThreads;
  const int64_t cap = static_cast<int64_t>(sm_count()) * kBlocksPerSm;
  return static_cast<int>(want < cap ? (want > 0 ? want : 1) : cap);
}

// blocks of zero_adam_kernel resident on one SM at its register count,
// asked once per process
cudaError_t adam_blocks_per_sm(int* n) {
  static int cached = 0;
  if (cached <= 0) {
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &cached, zero_adam_kernel, kThreads, 0);
    if (e != cudaSuccess || cached <= 0) {
      cached = 0;
      return e != cudaSuccess ? e : cudaErrorInvalidConfiguration;
    }
  }
  *n = cached;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Each launches one kernel over n f32 elements on `stream` and returns
// cudaGetLastError() after it (0 = launched). p, v, m1, m2 are updated in
// place; lr, b1p and b2p are one-element device tensors.
int zero_sgd(const float* lr, float* p, const float* g, long long n,
             void* stream) {
  zero_sgd_kernel<<<grid_for(n), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(lr, p, g, n);
  return static_cast<int>(cudaGetLastError());
}

int zero_momentum(const float* lr, float* p, const float* g, float* v,
                  long long n, float mu, float l2, int use_l2, int nesterov,
                  void* stream) {
  zero_momentum_kernel<<<grid_for(n), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      lr, p, g, v, n, mu, l2, use_l2, nesterov);
  return static_cast<int>(cudaGetLastError());
}

// B8: lr, b1p, b2p are the [1] tensors LearningRate, Beta1Pow, Beta2Pow
int zero_adam(const float* lr, const float* b1p, const float* b2p, float* p,
              const float* g, float* m1, float* m2, long long n, float b1,
              float one_minus_b1, float b2, float one_minus_b2, float eps,
              float coeff, int decay, void* stream) {
  int per_sm = 0;
  const cudaError_t e = adam_blocks_per_sm(&per_sm);
  if (e != cudaSuccess) return static_cast<int>(e);
  // elements before the first 16-byte boundary, if all four arrays share
  // one offset mod 16 bytes; -1 otherwise
  const uintptr_t off = reinterpret_cast<uintptr_t>(p) % 16;
  int head = -1;
  if (reinterpret_cast<uintptr_t>(g) % 16 == off &&
      reinterpret_cast<uintptr_t>(m1) % 16 == off &&
      reinterpret_cast<uintptr_t>(m2) % 16 == off && off % 4 == 0) {
    const long long h = static_cast<long long>((16 - off) % 16 / 4);
    head = static_cast<int>(h < n ? h : n);
  }
  // one full wave at most; fewer blocks where the work is smaller
  const long long per_block =
      head < 0 ? kThreads : 2LL * kThreads * 4;
  const long long want = (n + per_block - 1) / per_block;
  const long long wave = static_cast<long long>(sm_count()) * per_sm;
  const int grid = static_cast<int>(want < wave ? (want > 0 ? want : 1) : wave);
  zero_adam_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      lr, b1p, b2p, p, g, m1, m2, n, head, b1, one_minus_b1, b2, one_minus_b2,
      eps, coeff, decay);
  return static_cast<int>(cudaGetLastError());
}

// resident blocks of zero_adam_kernel per SM (B8's grid is this times the
// SM count), or -cudaError if the query failed
int zero_adam_blocks_per_sm(void) {
  int n = 0;
  const cudaError_t e = adam_blocks_per_sm(&n);
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

const char* zero_update_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
