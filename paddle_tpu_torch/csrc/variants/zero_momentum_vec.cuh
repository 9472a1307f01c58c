// B7's register body, timed against the shipped ring by
// `python3 -m paddle_tpu_torch.ops.kernels.flash_variants zero_momentum_vec`
// (ops/kernels/flash_variants.py inserts this text into the anonymous
// namespace of csrc/zero_update.cu and points zero_momentum at
// momentum_launch_vec). Not built on its own.
//
// 16-byte streaming loads and stores (ld.global.cs / st.global.cs) where
// p, g and v share one offset mod 16 bytes, the same scalar head and tail
// as the ring; each thread loads kMomentumVectors float4 of each array
// before any arithmetic, then updates and stores them, in a grid-stride
// loop over one full wave of blocks (the occupancy calculator at the
// instance's register count).

// float4 of each array a thread has in flight
constexpr int kMomentumVectors = 4;

__device__ __forceinline__ float4 ld4_stream(const float* a, int64_t v) {
  return __ldcs(reinterpret_cast<const float4*>(a) + v);
}

template <bool kL2, bool kNesterov>
__global__ void __launch_bounds__(kThreads)
    zero_momentum_vec_kernel(const float* __restrict__ lr,
                             float* __restrict__ p,
                             const float* __restrict__ g,
                             float* __restrict__ v, int64_t n, int head,
                             float mu, float l2) {
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
  float* pv = p + head;
  const float* gv = g + head;
  float* vv = v + head;
  const int64_t nv = (n - head) / 4;
  for (int64_t b = tid; b < nv; b += kMomentumVectors * nt) {
    float4 pa[kMomentumVectors], ga[kMomentumVectors], va[kMomentumVectors];
#pragma unroll
    for (int u = 0; u < kMomentumVectors; ++u) {
      const int64_t w = b + u * nt;
      if (w < nv) {
        pa[u] = ld4_stream(pv, w);
        ga[u] = ld4_stream(gv, w);
        va[u] = ld4_stream(vv, w);
      }
    }
#pragma unroll
    for (int u = 0; u < kMomentumVectors; ++u) {
      const int64_t w = b + u * nt;
      if (w < nv) {
        momentum_step4<kL2, kNesterov>(pa[u], ga[u], va[u], k);
        st4_stream(pv, w, pa[u]);
        st4_stream(vv, w, va[u]);
      }
    }
  }
  const int64_t tail = head + 4 * nv;
  if (tid < n - tail) momentum_at<kL2, kNesterov>(p, g, v, tail + tid, k);
}

template <bool kL2, bool kNesterov>
cudaError_t momentum_launch_vec(const float* lr, float* p, const float* g,
                                float* v, long long n, float mu, float l2,
                                cudaStream_t stream) {
  static int per_sm = 0;
  if (per_sm <= 0) {
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, zero_momentum_vec_kernel<kL2, kNesterov>, kThreads, 0);
    if (e != cudaSuccess) return e;
  }
  const int head = momentum_head(p, g, v, n);
  const long long per_block =
      head < 0 ? kThreads : 4LL * kMomentumVectors * kThreads;
  const long long want = (n + per_block - 1) / per_block;
  const long long wave = static_cast<long long>(sm_count()) * per_sm;
  const int grid = static_cast<int>(want < wave ? (want > 0 ? want : 1) : wave);
  zero_momentum_vec_kernel<kL2, kNesterov><<<grid, kThreads, 0, stream>>>(
      lr, p, g, v, n, head, mu, l2);
  return cudaGetLastError();
}
