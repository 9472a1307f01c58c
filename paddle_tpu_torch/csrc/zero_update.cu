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
// them. Each element of every input is read once and every output written
// once, with neighbouring threads on neighbouring addresses. B6: a
// grid-stride loop of 4-byte accesses, 8 blocks of 256 threads per SM.
//
// B7 (20 bytes an element: p, g, v read, p, v written; its bound 0.0490 ms
// at ResNet-50's widest stage-1 bucket of 8,208,384 elements, 0.1399 ms at
// 23,440,896, at 3.35 TB/s) has to keep enough bytes in flight to cover the
// device memory's latency, without spending issue slots or registers on
// them, and to read and write with little fixed cost a launch. Its body is
// a ring of shared-memory stages fed by Hopper's 1-D bulk copies
// (cp.async.bulk global -> shared, completion counted in bytes on one
// mbarrier a stage): one elected thread keeps kMomentumStages chunks of p,
// g and v in flight (up to 192 KB an SM at four resident blocks) while the
// block updates the oldest one and writes p and v back with 16-byte
// streaming stores (st.global.cs). The loads run under an L2 evict-first
// policy: each byte is used once. Block b takes chunks b, b + grid, ...;
// the grid is one full wave (the occupancy calculator at the instance's registers
// and the ring's 48 KB, asked once per process and instance) or fewer
// blocks where the bucket is smaller, and use_l2 and nesterov are template
// parameters, four instances picked on the host, so the loop has no
// branch on them. Bulk copies need 16-byte aligned ends: where p, g and v
// share one offset mod 16 bytes a scalar head runs up to the first
// 16-byte boundary and a scalar tail of up to 3 elements after the body;
// where the offsets differ a scalar grid-stride loop runs instead. Timed
// against the register body (16-byte ld.global.cs of four float4 of each
// array a thread, then the update and the stores: csrc/variants/
// zero_momentum_vec.cuh) and the scalar body of PRs 3-18
// (zero_momentum_scalar.cuh) by `python3 -m
// paddle_tpu_torch.ops.kernels.flash_variants`: PERF.md.
//
// B8: 16-byte accesses, two float4 of each array in flight per thread,
// where the four arrays share one offset mod 16 bytes (a scalar head up to
// the first 16-byte boundary, a scalar tail of up to 3 elements); otherwise
// the same kernel runs a scalar grid-stride loop. B8's grid is one full
// wave: the blocks the occupancy calculator lets reside on an SM at B8's
// register count, times the SMs, found once per process.

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

// ---- B7 ------------------------------------------------------------------

// B7's ring: kMomentumStages stages of kMomentumChunk elements of p, g and v
// in shared memory (48 KB: four blocks of 256 threads reside on an SM)
constexpr int kMomentumChunk = 1024;
constexpr int kMomentumStages = 4;
constexpr int kMomentumSmem = kMomentumStages * 3 * kMomentumChunk * 4;

// B7's constants for one launch
struct MomentumConst {
  float lr, mu, l2;
};

// one element of momentum, each operation rounded as the plain rule
// rounds it, in its order
template <bool kL2, bool kNesterov>
__device__ __forceinline__ void momentum_step(float& p, float g, float& v,
                                              const MomentumConst& k) {
  if (kL2) g = __fadd_rn(g, __fmul_rn(k.l2, p));
  const float vo = __fadd_rn(__fmul_rn(k.mu, v), g);
  const float step = kNesterov ? __fadd_rn(g, __fmul_rn(k.mu, vo)) : vo;
  p = __fsub_rn(p, __fmul_rn(k.lr, step));
  v = vo;
}

template <bool kL2, bool kNesterov>
__device__ __forceinline__ void momentum_step4(float4& p, float4 g,
                                               float4& v,
                                               const MomentumConst& k) {
  momentum_step<kL2, kNesterov>(p.x, g.x, v.x, k);
  momentum_step<kL2, kNesterov>(p.y, g.y, v.y, k);
  momentum_step<kL2, kNesterov>(p.z, g.z, v.z, k);
  momentum_step<kL2, kNesterov>(p.w, g.w, v.w, k);
}

template <bool kL2, bool kNesterov>
__device__ __forceinline__ void momentum_at(float* p, const float* g,
                                            float* v, int64_t i,
                                            const MomentumConst& k) {
  float pi = p[i], vi = v[i];
  momentum_step<kL2, kNesterov>(pi, g[i], vi, k);
  p[i] = pi;
  v[i] = vi;
}

// a streaming 16-byte store (st.global.cs): each byte is written once
__device__ __forceinline__ void st4_stream(float* a, int64_t v, float4 x) {
  __stcs(reinterpret_cast<float4*>(a) + v, x);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// a 1-D bulk copy of `bytes` (a multiple of 16, both ends on 16 bytes) from
// device memory into shared memory, its completion counted in bytes on the
// mbarrier `bar`; `policy` an L2 cache policy (createpolicy)
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar,
                                          uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], %4;\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar)), "l"(policy)
      : "memory");
}

// wait until the phase of parity `parity` of the mbarrier `bar` completed
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred P;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 P, [%1], %2;\n"
        " selp.u32 %0, 1, 0, P;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// head >= 0: elements [0, head) scalar, the body from p + head (16-byte
// aligned in all three arrays) through the ring, the tail of up to 3
// elements scalar; head < 0: all scalar. The body is cut into chunks of
// kMomentumChunk elements; block b takes chunks b, b + gridDim.x, ... For
// its chunk j thread 0 fills stage j % kMomentumStages by three bulk copies
// (p, g, v) on that stage's mbarrier, under an L2 evict-first policy (each
// byte is read once); every thread waits on the mbarrier, updates float4s
// of the stage and stores p and v with st.global.cs; after a block barrier
// thread 0 refills the stage with chunk j + kMomentumStages.
template <bool kL2, bool kNesterov>
__global__ void __launch_bounds__(kThreads)
    zero_momentum_kernel(const float* __restrict__ lr, float* __restrict__ p,
                         const float* __restrict__ g, float* __restrict__ v,
                         int64_t n, int head, float mu, float l2) {
  extern __shared__ __align__(128) float ring[];
  __shared__ __align__(8) uint64_t full[kMomentumStages];
  const MomentumConst k{lr[0], mu, l2};
  const int64_t tid =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t nt = static_cast<int64_t>(gridDim.x) * blockDim.x;
  if (head < 0) {
    for (int64_t i = tid; i < n; i += nt)
      momentum_at<kL2, kNesterov>(p, g, v, i, k);
    return;
  }
  if (tid < head) momentum_at<kL2, kNesterov>(p, g, v, tid, k);
  const int64_t body = (n - head) / 4 * 4;
  if (tid < n - head - body)
    momentum_at<kL2, kNesterov>(p, g, v, head + body + tid, k);
  // this block's chunk j: elements [base + j * stride, + kMomentumChunk) of
  // the body, cut at limit
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kMomentumChunk;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kMomentumChunk;
  const int64_t limit = body;
  const int chunks =
      base < limit ? static_cast<int>((limit - base + stride - 1) / stride)
                   : 0;
  float* pv = p + head;
  const float* gv = g + head;
  float* vv = v + head;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kMomentumStages; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                       smem_addr(&full[s]))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  uint64_t policy;
  asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
      : "=l"(policy));
  // thread 0: stage j % kMomentumStages <- chunk j
  auto fill = [&](int j) {
    if (j >= chunks) return;
    const int s = j % kMomentumStages;
    const int64_t at = base + j * stride;
    const uint32_t bytes = static_cast<uint32_t>(
        (limit - at < kMomentumChunk ? limit - at : kMomentumChunk) * 4);
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
            smem_addr(&full[s])),
        "r"(3 * bytes)
        : "memory");
    float* st = ring + s * 3 * kMomentumChunk;
    bulk_load(st, pv + at, bytes, &full[s], policy);
    bulk_load(st + kMomentumChunk, gv + at, bytes, &full[s], policy);
    bulk_load(st + 2 * kMomentumChunk, vv + at, bytes, &full[s], policy);
  };
  if (threadIdx.x == 0)
    for (int j = 0; j < kMomentumStages; ++j) fill(j);
  for (int j = 0; j < chunks; ++j) {
    const int s = j % kMomentumStages;
    bar_wait(&full[s], static_cast<uint32_t>((j / kMomentumStages) & 1));
    const int64_t at = base + j * stride;
    const int n4 = static_cast<int>(
        (limit - at < kMomentumChunk ? limit - at : kMomentumChunk) / 4);
    const float4* sp =
        reinterpret_cast<const float4*>(ring + s * 3 * kMomentumChunk);
    for (int e = threadIdx.x; e < n4; e += kThreads) {
      float4 pa = sp[e], va = sp[e + 2 * kMomentumChunk / 4];
      momentum_step4<kL2, kNesterov>(pa, sp[e + kMomentumChunk / 4], va, k);
      st4_stream(pv, at / 4 + e, pa);
      st4_stream(vv, at / 4 + e, va);
    }
    __syncthreads();  // every thread is done with stage s
    if (threadIdx.x == 0) fill(j + kMomentumStages);
  }
}

// ---- launch helpers -------------------------------------------------------

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

// resident blocks of B7's <kL2, kNesterov> instance on one SM at its
// register count and its ring's 48 KB of dynamic shared memory (the
// attribute that allows so much is set first), asked once per process and
// instance
template <bool kL2, bool kNesterov>
cudaError_t momentum_blocks_per_sm(int* n) {
  static int cached = 0;
  if (cached <= 0) {
    cudaError_t e = cudaFuncSetAttribute(
        zero_momentum_kernel<kL2, kNesterov>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kMomentumSmem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &cached, zero_momentum_kernel<kL2, kNesterov>, kThreads,
          kMomentumSmem);
    if (e != cudaSuccess || cached <= 0) {
      cached = 0;
      return e != cudaSuccess ? e : cudaErrorInvalidConfiguration;
    }
  }
  *n = cached;
  return cudaSuccess;
}

// B7's scalar head: the elements before the first 16-byte boundary if p, g
// and v share one offset mod 16 bytes (at most n); -1 otherwise
int momentum_head(const float* p, const float* g, const float* v,
                  long long n) {
  const uintptr_t off = reinterpret_cast<uintptr_t>(p) % 16;
  if (reinterpret_cast<uintptr_t>(g) % 16 != off ||
      reinterpret_cast<uintptr_t>(v) % 16 != off || off % 4 != 0)
    return -1;
  const long long h = static_cast<long long>((16 - off) % 16 / 4);
  return static_cast<int>(h < n ? h : n);
}

// one launch of B7's <kL2, kNesterov> instance: one full wave at most,
// fewer blocks where the bucket is smaller
template <bool kL2, bool kNesterov>
cudaError_t momentum_launch(const float* lr, float* p, const float* g,
                            float* v, long long n, float mu, float l2,
                            cudaStream_t stream) {
  int per_sm = 0;
  const cudaError_t e = momentum_blocks_per_sm<kL2, kNesterov>(&per_sm);
  if (e != cudaSuccess) return e;
  const int head = momentum_head(p, g, v, n);
  const long long per_block = head < 0 ? kThreads : kMomentumChunk;
  const long long want = (n + per_block - 1) / per_block;
  const long long wave = static_cast<long long>(sm_count()) * per_sm;
  const int grid = static_cast<int>(want < wave ? (want > 0 ? want : 1) : wave);
  zero_momentum_kernel<kL2, kNesterov><<<grid, kThreads, kMomentumSmem,
                                         stream>>>(lr, p, g, v, n, head, mu,
                                                   l2);
  return cudaGetLastError();
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

// B7: the <use_l2, nesterov> instance, so its loop has no branch on them
int zero_momentum(const float* lr, float* p, const float* g, float* v,
                  long long n, float mu, float l2, int use_l2, int nesterov,
                  void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (use_l2)
    e = nesterov ? momentum_launch<true, true>(lr, p, g, v, n, mu, l2, s)
                 : momentum_launch<true, false>(lr, p, g, v, n, mu, l2, s);
  else
    e = nesterov ? momentum_launch<false, true>(lr, p, g, v, n, mu, l2, s)
                 : momentum_launch<false, false>(lr, p, g, v, n, mu, l2, s);
  return static_cast<int>(e);
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

// resident blocks of B7's <use_l2, nesterov> instance per SM (its grid at
// most this times the SM count), or -cudaError if the query failed
int zero_momentum_blocks_per_sm(int use_l2, int nesterov) {
  int n = 0;
  cudaError_t e;
  if (use_l2)
    e = nesterov ? momentum_blocks_per_sm<true, true>(&n)
                 : momentum_blocks_per_sm<true, false>(&n);
  else
    e = nesterov ? momentum_blocks_per_sm<false, true>(&n)
                 : momentum_blocks_per_sm<false, false>(&n);
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

const char* zero_update_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
