// B7's earlier body (PRs 3-18), timed beside the shipped one by
// `python3 -m paddle_tpu_torch.ops.kernels.flash_variants
// zero_momentum_scalar` (ops/kernels/flash_variants.py inserts this text
// into the anonymous namespace of csrc/zero_update.cu and points
// zero_momentum at momentum_launch_scalar). Not built on its own.
//
// A grid-stride loop of 4-byte accesses, one element per thread and
// iteration, use_l2 and nesterov as runtime branches in the loop, 8 blocks
// of 256 threads per SM (grid_for).

__global__ void zero_momentum_scalar_kernel(const float* __restrict__ lr,
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

template <bool kL2, bool kNesterov>
cudaError_t momentum_launch_scalar(const float* lr, float* p, const float* g,
                                   float* v, long long n, float mu, float l2,
                                   cudaStream_t stream) {
  zero_momentum_scalar_kernel<<<grid_for(n), kThreads, 0, stream>>>(
      lr, p, g, v, n, mu, l2, kL2, kNesterov);
  return cudaGetLastError();
}
