// Fused paged-attention decode for Hopper (sm_90a), bound through a plain C
// interface and loaded with ctypes (paddle_tpu_torch/ops/kernels/).
//
// Replaces the Pallas TPU kernels of paddle_tpu/ops/pallas/paged_attention.py:
//   _paged_decode_kernel       (:98,  float pools: f32 / bf16)  -> KV = float / bf16
//   _paged_decode_kernel_int8  (:145, int8 pools, folded dequant) -> KV = int8_t
// both reached from fused_paged_attention (:188).
//
// What it computes (the contract of paddle_tpu/ops/paged_ops.paged_attend):
// single-token attention for every (slot, head). The slot's keys and values
// live in pool blocks named by its page-table row; position t is block
// page_table[b, t / bs], row t % bs. Positions past pos[b] are masked. The
// softmax is over the full row (no online rescale). Probabilities are cast to
// the value dtype before the context product, and the context is accumulated
// in f32 and written in the pool dtype (f32 for int8 pools). int8 pools keep
// the reference's folded dequant: scores * (scale * c), context * c, with
// c = kv_scale / 127, so int8 -> f32 is an exact convert inside both dots.
//
// Bound: decode attention does ~1 flop per byte of cache it reads, far below
// the H100's ~20 (f32 CUDA cores) to ~295 (bf16 tensor cores) flops per byte
// balance, so it is bound by device-memory bytes: K and V of every live
// position, read once. The design reads exactly those bytes once:
//   * one CUDA block per (slot, head), 128 threads; the block reads its own
//     page-table entries and pos (there is no scalar prefetch) and walks only
//     j < min(walk_blocks, pos / bs + 1): columns past the write frontier
//     point at the scratch block or at stale blocks and are never touched;
//   * scores go to a shared-memory f32 row (4 KB at max_len 1024); each key
//     row is read by one warp, lanes across head dims (coalesced);
//   * the context pass reads each value row once, hd consecutive threads on
//     hd consecutive elements, with ceil(128 / hd) position groups summed
//     through shared memory at the end;
//   * int8 blocks are read straight from device memory and converted in
//     registers. The Pallas int8 arm stages whole K and V rows as f32 in
//     VMEM (512 KB at max_len 1024, hd 128), which does not fit Hopper's
//     227 KB of shared memory per block.
// Not done yet (later work): wgmma / TMA staging and split-K across blocks.
// At batch 8 and 12 heads the grid is 96 blocks on 132 SMs, so one decode
// step leaves SMs idle.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr size_t kMaxSharedBytes = 232448;   // 227 KB per block on sm_90
constexpr size_t kDefaultSharedBytes = 48 * 1024;

enum Kind { kF32 = 0, kBF16 = 1, kI8 = 2 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) { return (float)x; }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);   // round to nearest even, as torch/XLA cast
}

// the probability as the context product sees it: cast to the value dtype
// (bf16 rounds; f32 pools and the int8 arm's f32 values keep it as is)
template <typename KV>
__device__ __forceinline__ float value_prob(float p) { return p; }
template <>
__device__ __forceinline__ float value_prob<__nv_bfloat16>(float p) {
  return __bfloat162float(__float2bfloat16(p));
}

template <typename KV> struct OutType { using type = KV; };
template <> struct OutType<int8_t> { using type = float; };

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// block-wide max (IS_MAX) or sum; `red` holds kWarps floats
template <bool IS_MAX>
__device__ float block_reduce(float v, float* red) {
  v = IS_MAX ? warp_max(v) : warp_sum(v);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < kWarps; ++w) r = IS_MAX ? fmaxf(r, red[w]) : r + red[w];
  __syncthreads();   // red is free for the next reduction
  return r;
}

__host__ __device__ inline int part_len(int hd) {
  return hd < kThreads ? kThreads : hd;
}

inline size_t shared_bytes(int mb, int bs, int hd) {
  return sizeof(float) * ((size_t)mb * bs + hd + part_len(hd) + kWarps) +
         sizeof(int) * (size_t)mb;
}

// q [B, nh, 1, hd]; pools [L, NB, nh, bs, hd]; page_table [B, mb] int32;
// pos [B] int32; out [B, nh, 1, hd]. One block per (slot, head).
template <typename KV, typename Q>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const Q* __restrict__ q, const KV* __restrict__ k_pool,
    const KV* __restrict__ v_pool, const int* __restrict__ page_table,
    const int* __restrict__ pos, typename OutType<KV>::type* __restrict__ out,
    int nh, int hd, int num_blocks, int bs, int mb, int layer,
    int walk_blocks, float score_scale, float ctx_scale) {
  extern __shared__ float smem[];
  float* scores = smem;                 // [mb * bs]
  float* qs = scores + mb * bs;         // [hd]
  float* part = qs + hd;                // [part_len(hd)]
  float* red = part + part_len(hd);     // [kWarps]
  int* blk = reinterpret_cast<int*>(red + kWarps);   // [mb]

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;            // = b * nh + h
  const int b = bh / nh, h = bh % nh;
  const int p = pos[b];
  const int n_walk = min(walk_blocks, p / bs + 1);
  const int n_valid = min(p + 1, n_walk * bs);   // positions 0 .. n_valid-1

  for (int d = tid; d < hd; d += kThreads) qs[d] = to_f32(q[(size_t)bh * hd + d]);
  for (int j = tid; j < n_walk; j += kThreads) blk[j] = page_table[(size_t)b * mb + j];
  __syncthreads();

  // position t of this (slot, head): pool[layer, blk[t / bs], h, t % bs, :]
  const size_t layer_base = (size_t)layer * num_blocks;
  auto row = [&](const KV* pool, int t) -> const KV* {
    const size_t tile = (layer_base + blk[t / bs]) * nh + h;
    return pool + (tile * bs + t % bs) * hd;
  };

  // 1. scores: one warp per position, lanes across the head dims
  const int warp = tid >> 5, lane = tid & 31;
  for (int t = warp; t < n_valid; t += kWarps) {
    const KV* kr = row(k_pool, t);
    float acc = 0.f;
    for (int d = lane; d < hd; d += 32) acc += qs[d] * to_f32(kr[d]);
    acc = warp_sum(acc);
    if (lane == 0) scores[t] = acc * score_scale;
  }
  __syncthreads();

  // 2. full-row softmax over the live positions (masked ones weigh 0)
  float m = -INFINITY;
  for (int t = tid; t < n_valid; t += kThreads) m = fmaxf(m, scores[t]);
  m = block_reduce<true>(m, red);
  float s = 0.f;
  for (int t = tid; t < n_valid; t += kThreads) {
    const float e = expf(scores[t] - m);
    scores[t] = e;
    s += e;
  }
  s = block_reduce<false>(s, red);
  for (int t = tid; t < n_valid; t += kThreads)
    scores[t] = value_prob<KV>(scores[t] / s);
  __syncthreads();

  // 3. context: thread (g, d) sums positions g, g + groups, ... of dim d
  const int groups = hd < kThreads ? kThreads / hd : 1;
  for (int i = tid; i < groups * hd; i += kThreads) {
    const int g = i / hd, d = i % hd;
    float acc = 0.f;
    for (int t = g; t < n_valid; t += groups)
      acc += scores[t] * to_f32(row(v_pool, t)[d]);
    part[i] = acc;
  }
  __syncthreads();
  using Out = typename OutType<KV>::type;
  for (int d = tid; d < hd; d += kThreads) {
    float acc = 0.f;
    for (int g = 0; g < groups; ++g) acc += part[g * hd + d];
    out[(size_t)bh * hd + d] = from_f32<Out>(acc * ctx_scale);
  }
}

template <typename KV, typename Q>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* page_table, const void* pos, void* out, int batch,
           int nh, int hd, int num_blocks, int bs, int mb, int layer,
           int walk_blocks, float score_scale, float ctx_scale,
           cudaStream_t stream) {
  const size_t smem = shared_bytes(mb, bs, hd);
  if (smem > kMaxSharedBytes) return (int)cudaErrorInvalidValue;
  auto kernel = paged_decode_kernel<KV, Q>;
  if (smem > kDefaultSharedBytes) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<batch * nh, kThreads, smem, stream>>>(
      static_cast<const Q*>(q), static_cast<const KV*>(k_pool),
      static_cast<const KV*>(v_pool), static_cast<const int*>(page_table),
      static_cast<const int*>(pos),
      static_cast<typename OutType<KV>::type*>(out), nh, hd, num_blocks, bs,
      mb, layer, walk_blocks, score_scale, ctx_scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory one block needs (the wrapper refuses shapes past 227 KB).
size_t paged_decode_shared_bytes(int mb, int bs, int hd) {
  return shared_bytes(mb, bs, hd);
}

// kv_kind / q_kind: 0 = f32, 1 = bf16, 2 = int8. Float pools take a query
// of their own dtype; int8 pools take an f32 or bf16 query. Returns the
// cudaError_t of the launch (0 on success); launches on `stream`.
int paged_decode(const void* q, const void* k_pool, const void* v_pool,
                 const void* page_table, const void* pos, void* out,
                 int kv_kind, int q_kind, int batch, int nh, int hd,
                 int num_blocks, int bs, int mb, int layer, int walk_blocks,
                 float score_scale, float ctx_scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kv_kind == kF32 && q_kind == kF32)
    return launch<float, float>(q, k_pool, v_pool, page_table, pos, out,
                                batch, nh, hd, num_blocks, bs, mb, layer,
                                walk_blocks, score_scale, ctx_scale, st);
  if (kv_kind == kBF16 && q_kind == kBF16)
    return launch<__nv_bfloat16, __nv_bfloat16>(
        q, k_pool, v_pool, page_table, pos, out, batch, nh, hd, num_blocks,
        bs, mb, layer, walk_blocks, score_scale, ctx_scale, st);
  if (kv_kind == kI8 && q_kind == kF32)
    return launch<int8_t, float>(q, k_pool, v_pool, page_table, pos, out,
                                 batch, nh, hd, num_blocks, bs, mb, layer,
                                 walk_blocks, score_scale, ctx_scale, st);
  if (kv_kind == kI8 && q_kind == kBF16)
    return launch<int8_t, __nv_bfloat16>(
        q, k_pool, v_pool, page_table, pos, out, batch, nh, hd, num_blocks,
        bs, mb, layer, walk_blocks, score_scale, ctx_scale, st);
  return (int)cudaErrorInvalidValue;
}

const char* paged_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
