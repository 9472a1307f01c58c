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
// page_table[b, t / bs], row t % bs. Positions past pos[b] are masked, and
// the walk stops at min(walk_blocks, pos / bs + 1) blocks (a frozen row at
// pos == max_len reads its whole table). The context is accumulated in f32
// and written in the pool dtype (f32 for int8 pools). int8 pools keep the
// reference's folded dequant: scores * (scale * c), context * c, with
// c = kv_scale / 127, so int8 -> f32 is an exact convert inside both dots.
//
// Bound: decode attention does ~1 flop per byte of cache it reads, far below
// the H100's ~20 (f32 CUDA cores) flops per byte balance, and one query per
// (slot, head) makes it a matrix-vector product that tensor cores do not
// help. It is bound by device-memory bytes: K and V of every live position,
// read once. What holds such a kernel back is loads in flight, so the design
// (flash-decoding) spreads every (slot, head) over many blocks:
//   * pass 1, paged_decode_kernel<KV, Q, HD>: grid (B·nh, ceil(walk·bs / P)).
//     Block (slot-head, c) takes positions [c·P, c·P + P) of its slot, P =
//     kChunk. Chunk boundaries depend on the position only, never on the
//     batch, the walk hint or the card, so a slot's result depends only on
//     its own pos and cache (every sufficient hint gives the same bits). A
//     chunk at or past the slot's frontier returns at once.
//   * the block reads the chunk's page-table entries once into shared memory;
//     each K/V row is read with 16-byte loads by kTpr threads side by side
//     (hd 64: 16 threads for f32, 8 for bf16, 4 for int8), and every thread
//     issues all its rows' K and V loads (kRows of each) before any math;
//   * a row's dot product is a shuffle sum over its kTpr threads; the chunk's
//     max m_c goes through shared memory; then l_c = sum exp(s - m_c) and the
//     unnormalised o_c = sum exp(s - m_c) · v, summed over a warp's rows by
//     shuffles and over the warps in warp order. The f32 weight multiplies V
//     unrounded (the plain version rounds the normalised probability to the
//     value dtype first: bf16 results differ from it by about a bf16 ulp).
//     Rows past pos get weight exp(-inf) = 0, and an empty chunk never runs,
//     so no -inf - -inf reaches the merge. The chunk writes (o_c, m_c, l_c)
//     in f32 to the scratch buffer [B·nh, n_chunks, hd + 2] the wrapper
//     allocates;
//   * pass 2, paged_decode_kernel_merge<Out, HD>: one block per (slot, head)
//     merges its live chunks in chunk order: m = max m_c, l = sum l_c e^(m_c - m),
//     out = (sum o_c e^(m_c - m)) / l · ctx_scale.
// No atomics, no order that changes between runs, no allocation and no host
// synchronisation; pos and the page table are read from device memory and
// the grid depends only on the host's walk, so a decode step can be captured
// in a CUDA graph at the full walk. int8 blocks are converted in registers
// (the Pallas int8 arm stages whole rows as f32 in VMEM, which a Hopper block
// has no room for).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// positions per chunk (one pass-1 block); a multiple of the pool block.
// 32, 64 and 128 were timed (PERF.md): 128 is the fastest
constexpr int kChunk = 128;
// warps of a pass-1 block per 64 head dims
constexpr int kWarps64 = 4;

enum Kind { kF32 = 0, kBF16 = 1, kI8 = 2 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);   // round to nearest even, as torch casts
}

template <typename KV> struct OutType { using type = KV; };
template <> struct OutType<int8_t> { using type = float; };

// 16 bytes of a row as f32 values (exact for every pool type)
__device__ __forceinline__ void unpack(uint4 r, float* x, float) {
  x[0] = __uint_as_float(r.x);
  x[1] = __uint_as_float(r.y);
  x[2] = __uint_as_float(r.z);
  x[3] = __uint_as_float(r.w);
}
__device__ __forceinline__ void unpack(uint4 r, float* x, __nv_bfloat16) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {   // element 2i in the low half
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
}
__device__ __forceinline__ void unpack(uint4 r, float* x, int8_t) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {   // byte j of a word is element 4i + j
    x[4 * i] = (float)((int32_t)(w[i] << 24) >> 24);
    x[4 * i + 1] = (float)((int32_t)(w[i] << 16) >> 24);
    x[4 * i + 2] = (float)((int32_t)(w[i] << 8) >> 24);
    x[4 * i + 3] = (float)((int32_t)w[i] >> 24);
  }
}

// How a pass-1 block covers its chunk: kVec elements per 16-byte load, kTpr
// threads across one row, kRpw rows per warp at a time, kRows rows (of K and
// of V) in flight per thread.
template <typename KV, int HD>
struct Geometry {
  static constexpr int kVec = 16 / (int)sizeof(KV);
  static constexpr int kTpr = HD / kVec;
  static constexpr int kRpw = 32 / kTpr;
  static constexpr int kWanted = kWarps64 * HD / 64;
  static constexpr int kWarps =
      kWanted < kChunk / kRpw ? kWanted : kChunk / kRpw;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kRows = kChunk / (kWarps * kRpw);
  static_assert(kTpr <= 32 && 32 % kTpr == 0, "a row within one warp");
  static_assert(kRows >= 1 && kChunk % (kWarps * kRpw) == 0,
                "the chunk splits evenly over the warps");
  static_assert(kThreads >= HD, "a thread per head dim in the epilogue");
};

// positions 0 .. n_valid - 1 of a slot are read (the Pallas kernel's
// frontier clamp, paged_attention.py:222-223)
__device__ __forceinline__ int live_positions(int p, int bs, int walk_blocks) {
  const int n_walk = min(walk_blocks, p / bs + 1);
  return min(p + 1, n_walk * bs);
}

// q [B, nh, 1, HD]; pools [L, NB, nh, bs, HD]; page_table [B, mb] int32;
// pos [B] int32; part [B·nh, gridDim.y, HD + 2] f32: o_c, m_c, l_c.
template <typename KV, typename Q, int HD>
__global__ void __launch_bounds__(Geometry<KV, HD>::kThreads)
    paged_decode_kernel(const Q* __restrict__ q, const KV* __restrict__ k_pool,
                        const KV* __restrict__ v_pool,
                        const int* __restrict__ page_table,
                        const int* __restrict__ pos, float* __restrict__ part,
                        int nh, int num_blocks, int bs, int mb, int layer,
                        int walk_blocks, float score_scale) {
  using G = Geometry<KV, HD>;
  constexpr int W = G::kWarps, V = G::kVec, TPR = G::kTpr, RPW = G::kRpw,
                R = G::kRows;
  __shared__ int blk[kChunk];           // page-table entries of the chunk
  __shared__ float red[W];              // each warp's max
  __shared__ float acc_w[W][HD + 1];    // each warp's o, then its l

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.x, c = blockIdx.y;
  const int b = bh / nh, h = bh - b * nh;
  const int t0 = c * kChunk;
  const int j0 = t0 / bs;               // < walk_blocks <= mb
  const int n_ent = min((t0 + kChunk - 1) / bs - j0 + 1, mb - j0);
  for (int i = tid; i < n_ent; i += G::kThreads)
    blk[i] = page_table[(size_t)b * mb + j0 + i];
  const int n_valid = live_positions(pos[b], bs, walk_blocks);
  if (t0 >= n_valid) return;            // the whole block: past the frontier
  __syncthreads();

  const int sub = lane / TPR;           // this thread's row in a warp step
  const int d0 = (lane % TPR) * V;      // its first head dim
  float qv[V];
#pragma unroll
  for (int e = 0; e < V; ++e) qv[e] = to_f32(q[(size_t)bh * HD + d0 + e]);

  // every K and V load of this thread in flight before any math
  const size_t layer_base = (size_t)layer * num_blocks;
  uint4 kr[R], vr[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int t = t0 + (warp * R + i) * RPW + sub;
    kr[i] = vr[i] = make_uint4(0u, 0u, 0u, 0u);
    if (t < n_valid) {
      const size_t tile = (layer_base + blk[t / bs - j0]) * nh + h;
      const size_t off = (tile * bs + t % bs) * HD + d0;
      kr[i] = __ldg(reinterpret_cast<const uint4*>(k_pool + off));
      vr[i] = __ldg(reinterpret_cast<const uint4*>(v_pool + off));
    }
  }

  // scores: a shuffle sum over the row's threads
  float s[R];
  float m = -INFINITY;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    float x[V];
    unpack(kr[i], x, KV());
    float dot = 0.f;
#pragma unroll
    for (int e = 0; e < V; ++e) dot = fmaf(qv[e], x[e], dot);
#pragma unroll
    for (int o = TPR / 2; o > 0; o >>= 1)
      dot += __shfl_xor_sync(0xffffffffu, dot, o);
    const int t = t0 + (warp * R + i) * RPW + sub;
    s[i] = t < n_valid ? dot * score_scale : -INFINITY;
    m = fmaxf(m, s[i]);
  }
#pragma unroll
  for (int o = TPR; o < 32; o <<= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  if (lane == 0) red[warp] = m;
  __syncthreads();
  m = red[0];                            // finite: position t0 is live
#pragma unroll
  for (int w = 1; w < W; ++w) m = fmaxf(m, red[w]);

  // l and the unnormalised context over this thread's rows, then the warp's
  float l = 0.f, o[V];
#pragma unroll
  for (int e = 0; e < V; ++e) o[e] = 0.f;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const float p = expf(s[i] - m);      // 0 for a masked row
    float x[V];
    unpack(vr[i], x, KV());
    l += p;
#pragma unroll
    for (int e = 0; e < V; ++e) o[e] = fmaf(p, x[e], o[e]);
  }
#pragma unroll
  for (int off = TPR; off < 32; off <<= 1) {
    l += __shfl_xor_sync(0xffffffffu, l, off);
#pragma unroll
    for (int e = 0; e < V; ++e) o[e] += __shfl_xor_sync(0xffffffffu, o[e], off);
  }
  if (sub == 0) {
#pragma unroll
    for (int e = 0; e < V; ++e) acc_w[warp][d0 + e] = o[e];
    if (lane == 0) acc_w[warp][HD] = l;
  }
  __syncthreads();

  // the chunk's partial: warps summed in warp order
  float* out = part + ((size_t)bh * gridDim.y + c) * (HD + 2);
  if (tid < HD) {
    float sum = acc_w[0][tid];
#pragma unroll
    for (int w = 1; w < W; ++w) sum += acc_w[w][tid];
    out[tid] = sum;
  }
  if (tid == 0) {
    float sum = acc_w[0][HD];
#pragma unroll
    for (int w = 1; w < W; ++w) sum += acc_w[w][HD];
    out[HD] = m;
    out[HD + 1] = sum;
  }
}

// One block of HD threads per (slot, head): the live chunks merged in chunk
// order, then normalised, scaled and cast.
template <typename Out, int HD>
__global__ void __launch_bounds__(HD) paged_decode_kernel_merge(
    const float* __restrict__ part, const int* __restrict__ pos,
    Out* __restrict__ out, int nh, int bs, int walk_blocks, int n_chunks,
    float ctx_scale) {
  const int bh = blockIdx.x, d = threadIdx.x;
  const int n_valid = live_positions(pos[bh / nh], bs, walk_blocks);
  const int n_live = (n_valid + kChunk - 1) / kChunk;
  const float* pc = part + (size_t)bh * n_chunks * (HD + 2);
  float m = -INFINITY;
  for (int c = 0; c < n_live; ++c) m = fmaxf(m, pc[c * (HD + 2) + HD]);
  float l = 0.f, o = 0.f;
  for (int c = 0; c < n_live; ++c) {
    const float* p = pc + c * (HD + 2);
    const float w = expf(p[HD] - m);
    l = fmaf(p[HD + 1], w, l);
    o = fmaf(p[d], w, o);
  }
  out[(size_t)bh * HD + d] = from_f32<Out>(o / l * ctx_scale);
}

template <typename KV, typename Q, int HD>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* page_table, const void* pos, void* part, void* out,
           int batch, int nh, int num_blocks, int bs, int mb, int layer,
           int walk_blocks, float score_scale, float ctx_scale,
           cudaStream_t stream) {
  using Out = typename OutType<KV>::type;
  const int n_chunks = (walk_blocks * bs + kChunk - 1) / kChunk;
  const dim3 grid(batch * nh, n_chunks);
  paged_decode_kernel<KV, Q, HD><<<grid, Geometry<KV, HD>::kThreads, 0,
                                   stream>>>(
      static_cast<const Q*>(q), static_cast<const KV*>(k_pool),
      static_cast<const KV*>(v_pool), static_cast<const int*>(page_table),
      static_cast<const int*>(pos), static_cast<float*>(part), nh,
      num_blocks, bs, mb, layer, walk_blocks, score_scale);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  paged_decode_kernel_merge<Out, HD><<<batch * nh, HD, 0, stream>>>(
      static_cast<const float*>(part), static_cast<const int*>(pos),
      static_cast<Out*>(out), nh, bs, walk_blocks, n_chunks, ctx_scale);
  return (int)cudaGetLastError();
}

template <typename KV, typename Q>
int launch_hd(int hd, const void* q, const void* k_pool, const void* v_pool,
              const void* page_table, const void* pos, void* part, void* out,
              int batch, int nh, int num_blocks, int bs, int mb, int layer,
              int walk_blocks, float score_scale, float ctx_scale,
              cudaStream_t stream) {
  if (hd == 64)
    return launch<KV, Q, 64>(q, k_pool, v_pool, page_table, pos, part, out,
                             batch, nh, num_blocks, bs, mb, layer,
                             walk_blocks, score_scale, ctx_scale, stream);
  if (hd == 128)
    return launch<KV, Q, 128>(q, k_pool, v_pool, page_table, pos, part, out,
                              batch, nh, num_blocks, bs, mb, layer,
                              walk_blocks, score_scale, ctx_scale, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Positions per chunk: the wrapper sizes the scratch buffer with it.
int paged_decode_chunk(void) { return kChunk; }

// kv_kind / q_kind: 0 = f32, 1 = bf16, 2 = int8. Float pools take a query
// of their own dtype, and bf16 pools also an f32 query (the int8-weight
// serving arm, whose activations are f32); int8 pools take an f32 or bf16
// query. The context is in the pool's dtype (f32 for int8). hd is 64 or 128.
// part: [batch·nh, ceil(walk_blocks·bs / kChunk), hd + 2] f32 scratch.
// Launches both passes on `stream`; returns the first cudaError_t (0 on
// success).
int paged_decode(const void* q, const void* k_pool, const void* v_pool,
                 const void* page_table, const void* pos, void* part,
                 void* out, int kv_kind, int q_kind, int batch, int nh,
                 int hd, int num_blocks, int bs, int mb, int layer,
                 int walk_blocks, float score_scale, float ctx_scale,
                 void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kv_kind == kF32 && q_kind == kF32)
    return launch_hd<float, float>(hd, q, k_pool, v_pool, page_table, pos,
                                   part, out, batch, nh, num_blocks, bs, mb,
                                   layer, walk_blocks, score_scale,
                                   ctx_scale, st);
  if (kv_kind == kBF16 && q_kind == kBF16)
    return launch_hd<__nv_bfloat16, __nv_bfloat16>(
        hd, q, k_pool, v_pool, page_table, pos, part, out, batch, nh,
        num_blocks, bs, mb, layer, walk_blocks, score_scale, ctx_scale, st);
  if (kv_kind == kBF16 && q_kind == kF32)
    return launch_hd<__nv_bfloat16, float>(
        hd, q, k_pool, v_pool, page_table, pos, part, out, batch, nh,
        num_blocks, bs, mb, layer, walk_blocks, score_scale, ctx_scale, st);
  if (kv_kind == kI8 && q_kind == kF32)
    return launch_hd<int8_t, float>(hd, q, k_pool, v_pool, page_table, pos,
                                    part, out, batch, nh, num_blocks, bs, mb,
                                    layer, walk_blocks, score_scale,
                                    ctx_scale, st);
  if (kv_kind == kI8 && q_kind == kBF16)
    return launch_hd<int8_t, __nv_bfloat16>(
        hd, q, k_pool, v_pool, page_table, pos, part, out, batch, nh,
        num_blocks, bs, mb, layer, walk_blocks, score_scale, ctx_scale, st);
  return (int)cudaErrorInvalidValue;
}

const char* paged_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
