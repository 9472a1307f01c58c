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
// lr and the bias-corrected lr_t are read from device memory ([1] tensors
// the plain rule computes too), so nothing synchronises with the host. The
// Python-float constants arrive rounded to f32 as PyTorch rounds a scalar
// for an f32 tensor.
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
// once, in a grid-stride loop with neighbouring threads on neighbouring
// addresses (coalesced 4-byte accesses), 8 blocks of 256 threads per SM.
// Not done yet (later work): 16-byte vector loads, which need the bucket's
// alignment checked by the wrapper.

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

__global__ void zero_adam_kernel(const float* __restrict__ lr_t,
                                 const float* __restrict__ lr,
                                 float* __restrict__ p,
                                 const float* __restrict__ g,
                                 float* __restrict__ m1,
                                 float* __restrict__ m2, int64_t n, float b1,
                                 float one_minus_b1, float b2,
                                 float one_minus_b2, float eps, float coeff,
                                 int decay) {
  const float lrt0 = lr_t[0];
  // adamw's (lr * coeff), the [1]-tensor product the plain rule forms first
  const float lrc = decay ? __fmul_rn(lr[0], coeff) : 0.0f;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const float pi = p[i];
    const float gi = g[i];
    const float m1o =
        __fadd_rn(__fmul_rn(b1, m1[i]), __fmul_rn(one_minus_b1, gi));
    const float m2o = __fadd_rn(__fmul_rn(b2, m2[i]),
                                __fmul_rn(one_minus_b2, __fmul_rn(gi, gi)));
    const float upd =
        __fdiv_rn(__fmul_rn(lrt0, m1o), __fadd_rn(__fsqrt_rn(m2o), eps));
    float po = __fsub_rn(pi, upd);
    if (decay) po = __fsub_rn(po, __fmul_rn(lrc, pi));
    p[i] = po;
    m1[i] = m1o;
    m2[i] = m2o;
  }
}

int grid_for(int64_t n) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      sms = 132;
  }
  const int64_t want = (n + kThreads - 1) / kThreads;
  const int64_t cap = static_cast<int64_t>(sms) * kBlocksPerSm;
  return static_cast<int>(want < cap ? (want > 0 ? want : 1) : cap);
}

}  // namespace

extern "C" {

// Each launches one kernel over n f32 elements on `stream` and returns
// cudaGetLastError() after it (0 = launched). p, v, m1, m2 are updated in
// place; lr and lr_t are one-element device tensors.
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

int zero_adam(const float* lr_t, const float* lr, float* p, const float* g,
              float* m1, float* m2, long long n, float b1, float one_minus_b1,
              float b2, float one_minus_b2, float eps, float coeff, int decay,
              void* stream) {
  zero_adam_kernel<<<grid_for(n), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      lr_t, lr, p, g, m1, m2, n, b1, one_minus_b1, b2, one_minus_b2, eps,
      coeff, decay);
  return static_cast<int>(cudaGetLastError());
}

const char* zero_update_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
