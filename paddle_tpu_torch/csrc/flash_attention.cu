// Flash attention, forward and backward, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU Pallas kernels of paddle_tpu/ops/pallas/flash_attention.py:
//   flash_fwd_kernel      <- _flash_fwd_kernel      (:145, pallas_call :263)
//   flash_bwd_dq_kernel   <- _flash_bwd_dq_kernel   (:282, pallas_call :450)
//   flash_bwd_dkdv_kernel <- _flash_bwd_dkdv_kernel (:346, pallas_call :477)
// Wrapper, plain PyTorch version and launch counts:
// paddle_tpu_torch/ops/kernels/flash_attention.py.
//
// What each computes (layout [B*nh, S, hd], row-major, contiguous; f32 or
// bf16 operands, f32 accumulation; `mask` an additive f32 bias [Bm, Rm, S]
// whose leading index follows mask_mode, Rm in {1, S}):
//   fwd : O = dropout(softmax(Q K^T * scale + mask, causal)) V, online
//         softmax over key tiles; the probabilities are rounded to V's
//         dtype before P V, and dropout applies after the normaliser has
//         accumulated. Writes O (operand dtype) and lse [B*nh, S] f32.
//   dq  : delta = rowsum(f32(dO) * f32(O)), written to a [B*nh, S] f32
//         buffer for dkdv; P = exp(S - lse); dP = dropout-upscaled dO V^T;
//         dS = P (dP - delta) scale, rounded to K's dtype; dQ = dS K.
//   dkdv: dV += dropout(P)^T dO (P rounded to dO's dtype); dK += dS^T Q (dS
//         rounded to Q's dtype); delta read from dq's buffer, O not read;
//         with `causal` the q loop starts at the first q tile that reaches
//         this key tile.
// Dropout is the reference's counter hash (_keep_mask :73): bit (q, k) of
// head b*nh+h depends only on (seed, head, q, k), so all three kernels
// regenerate the forward's mask although they tile differently.
//
// Backward (B2, B3): at BERT shapes (S 512, hd 64) B2 does 6 and B3 8 x
// B*nh*S^2*hd operations on ~25-45 MB of operands, so operations bound
// them, as 4 x B*nh*S^2*hd bound the forward (B1): at the 3xTF32 rate (a
// third of 494.7 TFLOP/s) for f32 operands and at the bf16 tensor-core rate
// (989.4) for bf16. All three kernels share one design:
//   * Tensor cores through warp-level mma.sync (mma_tile.cuh): bf16 as
//     m16n8k16 with ldmatrix (.trans where a product contracts over the
//     tile's stored row axis); f32 as m16n8k8 TF32 in 3xTF32 (big = x
//     rounded to nearest TF32, small = x - big, split once per fragment
//     load, small*small dropped), which keeps the f32 accuracy the
//     card-vs-CPU gate and the 5e-4 gradient tolerance need.
//   * mma.sync and not wgmma: wgmma takes tf32 operands only K-major in
//     shared memory (the transpose flags exist for 16-bit types only), and
//     three of the products contract over the stored row axis (O = P V,
//     dQ = dS K, dV = P^T dO, dK = dS^T Q), so each would need a transposed,
//     split copy in shared memory. mma.sync fragments load at any index for
//     free.
//   * Four warps per 64-row tile, 16 rows each. B1 and B2 keep the scores
//     of their rows in registers and feed P (dS) to O += P V (dQ += dS K)
//     from there; B3 computes S^T = K Q^T and dP^T = V dO^T so P^T and dS^T
//     are register A operands of dV and dK. hd 128 doubles the warps, each
//     group of four owning half of the head dim of the output products
//     (both compute the scores).
//   * The streamed tiles (K/V in B1 and B2, Q/dO with lse/delta in B3)
//     arrive by 16-byte cp.async, rows past S zero-filled, through a
//     two-stage ring; rows are padded by 16 bytes, so fragment loads are
//     free of bank conflicts. A key-padding mask row is read once per key
//     tile.
//   * No atomics: every output element is written by one block, in a fixed
//     order, so the kernels are deterministic.
// B1 in particular: the online softmax runs in registers in log2 units
// (scores scaled by scale * log2 e, exp2f); a row's max is taken over the
// four threads of its quad (two shuffles), its sum kept per thread and
// reduced once at the end; dropout is a multiply by 1/keep_prob.
// Left for later work: wgmma for the bf16 path, warp specialisation with
// TMA.
//
// Unlike the TPU kernels, any S is taken (a tail tile is masked), and
// lse is stored [B*nh, S] rather than broadcast over 128 lanes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_tile.cuh"

namespace {

constexpr int BQ = 64;   // query rows of a resident tile (B1, B2)
constexpr int BK = 64;   // key rows of a resident tile (B3)

struct Params {
    const void* q;
    const void* k;
    const void* v;
    const void* o;      // forward output (backward only)
    const void* dout;   // dO (backward only)
    const float* mask;  // [Bm, Rm, S] or null
    float* lse;         // written by fwd, read by bwd
    float* delta;       // rowsum(dO * O) [B*nh, S]: written by dq, read by dkdv
    void* out;          // fwd: O; dq: dQ
    void* dk;
    void* dv;
    int B, nh, S;
    int mask_mode;      // 0 none, 1 shared, 2 per batch, 3 per head, 4 per (b,h)
    int mask_rows;      // 1 or S
    float scale;
    int causal;
    int dropout;        // 0 or 1
    uint32_t thresh;    // keep when hash >= thresh
    uint32_t seed;
    float keep_prob;    // 1 - rate
};

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
    return __bfloat162float(x);
}

__device__ __forceinline__ bool keep_bit(const Params& p, uint32_t head,
                                         uint32_t qpos, uint32_t kpos) {
    uint32_t x = (qpos * 0x85EBCA6Bu) ^ (kpos * 0xC2B2AE35u)
                 ^ (p.seed + head * 0x9E3779B9u);
    x ^= x >> 16;
    x *= 0x85EBCA6Bu;
    x ^= x >> 13;
    x *= 0xC2B2AE35u;
    x ^= x >> 16;
    return x >= p.thresh;
}

__device__ __forceinline__ const float* mask_base(const Params& p, int bh) {
    int mb = 0;
    if (p.mask_mode == 2) mb = bh / p.nh;
    else if (p.mask_mode == 3) mb = bh % p.nh;
    else if (p.mask_mode == 4) mb = bh;
    return p.mask + (size_t)mb * p.mask_rows * p.S;
}

__device__ __forceinline__ float warp_sum(float x) {
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    return x;
}

// ------------------------------------------------- tensor-core kernels --
// All three kernels multiply on the tensor cores (mma_tile.cuh): four warps
// per 64-row resident tile, each owning 16 rows, times HD / 64 warp groups
// that split the head dim of the output products (hd 128: 8 warps; both
// groups compute the scores). The other operands stream through a two-stage
// cp.async ring of BN-row tiles (BNF in the forward), so tile t+1 lands
// while tile t is multiplied. BN is 32 and not 64 in the backward: the ring
// then takes the shared memory of one 64-row stage, and at hd 64 three
// blocks fit on an SM where two did (measured: B2 ~20% faster at f32), with
// half the score registers.
constexpr int BN = 32;         // streamed rows per tile
constexpr int NJ = BN / 8;     // 8-column accumulator tiles of a score block
template <int HD> __host__ __device__ constexpr int tile_threads() { return 128 * (HD / 64); }
// shared row stride in elements: HD + 16 bytes
template <typename T, int HD> __host__ __device__ constexpr int tile_ld() {
    return HD + 16 / (int)sizeof(T);
}
// backward: two resident 64-row tiles, a ring of two stages of two BN-row
// tiles, and four 64-float rows
template <typename T, int HD> constexpr size_t bwd_smem() {
    return sizeof(T) * (2 * BQ + 4 * BN) * tile_ld<T, HD>() + 4 * sizeof(float) * BQ;
}

template <typename T> __device__ __forceinline__ void store2(T* dst, float a, float b);
template <> __device__ __forceinline__ void store2<float>(float* dst, float a, float b) {
    *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}
template <> __device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* dst, float a,
                                                                  float b) {
    *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
}

// exp(x) = exp2(x log2 e): one multiply before the ex2 unit, where expf
// reduces its range in software (within 2 ulp of expf on the scores here)
constexpr float kLog2e = 1.4426950408889634f;

// the scaled, masked score of (qpos, kpos) in the backward kernels, -inf
// past S and above the causal diagonal: a key-padding row (mask_rows 1)
// arrives as `mk`, read once per tile; a per-query mask is read per element
__device__ __forceinline__ float bwd_score(const Params& p, const float* mrow, float mk,
                                           float dot, int qpos, int kpos) {
    if (kpos >= p.S) return -INFINITY;
    float s = dot * p.scale;
    if (p.mask_rows == 1) s += mk;
    else if (mrow != nullptr && qpos < p.S) s += mrow[(size_t)qpos * p.S + kpos];
    if (p.causal && kpos > qpos) return -INFINITY;
    return s;
}

// -------------------------------------------------------- forward (B1) --
// One block per 64-row q tile, looping over BNF-key tiles of K and V. A
// warp's 16 q rows x BNF keys of scores stay in registers: scaled into log2
// units, the row max over the quad, P = exp2(s - max), the partial row sums
// per thread, dropout as a multiply, and P feeds O += P V from there. At f32
// Q is split into TF32 halves per fragment and key tile, as in B2: split once
// per block into a second shared tile, it cost a block per SM at hd 64 (4 ->
// 3) and gained nothing (measured on an H100). BNF is 32: 64-key tiles made
// the f32 kernel ~11% slower (measured).
constexpr int BNF = 32;        // streamed K/V rows per forward tile
// the Q tile, a ring of two stages of K and V BNF-row tiles, and two
// key-padding rows
template <typename T, int HD> constexpr size_t fwd_smem() {
    return sizeof(T) * (BQ + 4 * BNF) * tile_ld<T, HD>() + 2 * sizeof(float) * BNF;
}
constexpr float kLn2 = 0.6931471805599453f;

template <typename T, int HD>
__global__ void __launch_bounds__(128 * (HD / 64)) flash_fwd_kernel(Params p) {
    using namespace mma_tile;
    constexpr int NTB = tile_threads<HD>(), LD = tile_ld<T, HD>();
    constexpr int TILE = BQ * LD, STILE = BNF * LD, NJF = BNF / 8;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* sQ = reinterpret_cast<T*>(smem_raw);
    T* sRing = sQ + TILE;           // stage s: K at sRing + 2 s STILE, V after it
    float* sMk = reinterpret_cast<float*>(sRing + 4 * STILE);  // [2][BNF] key-padding rows

    const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4, wr = warp % 4, wc = warp / 4;
    const size_t base = (size_t)bh * p.S * HD;
    const T* K = static_cast<const T*>(p.k) + base;
    const T* V = static_cast<const T*>(p.v) + base;
    const float* mrow = p.mask_mode ? mask_base(p, bh) : nullptr;
    const bool mask1 = mrow != nullptr && p.mask_rows == 1;
    const float inv_keep = 1.f / p.keep_prob;
    const float sl2 = p.scale * kLog2e;        // scores in log2 units

    int n_kt = (p.S + BNF - 1) / BNF;
    if (p.causal) n_kt = min(n_kt, (min(q0 + BQ, p.S) + BNF - 1) / BNF);
    auto issue = [&](int stage, int kt) {
        const int k0 = kt * BNF;
        T* dst = sRing + 2 * stage * STILE;
        load_tile_async<T, HD, BNF, NTB>(dst, K, k0, p.S);
        load_tile_async<T, HD, BNF, NTB>(dst + STILE, V, k0, p.S);
        if (mask1 && tid < BNF)
            cp_async4(sMk + stage * BNF + tid, mrow + min(k0 + tid, p.S - 1), k0 + tid < p.S);
    };
    load_tile_async<T, HD, BQ, NTB>(sQ, static_cast<const T*>(p.q) + base, q0, p.S);
    issue(0, 0);
    cp_async_commit();

    const int r_lo = 16 * wr + g;   // this thread's rows: r_lo and r_lo + 8
    float m[2] = {-INFINITY, -INFINITY};   // row max so far, log2 units
    float l[2] = {0.f, 0.f};               // this thread's share of the row sum
    float acc[8][4] = {};
    for (int kt = 0; kt < n_kt; ++kt) {
        const int st = kt & 1, k0 = kt * BNF;
        if (kt + 1 < n_kt) issue(st ^ 1, kt + 1);
        cp_async_commit();
        cp_async_wait<1>();
        __syncthreads();
        const T* sK = sRing + 2 * st * STILE;
        const T* sV = sK + STILE;
        float s[NJF][4] = {};
        mma_abt<T, HD, LD, NJF>(s, sQ + 16 * wr * LD, sK, lane);
        // the masked score in log2 units; -inf past S and above the diagonal
        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int j = 0; j < NJF; ++j)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int h = i / 2, c = 8 * j + 2 * t + (i % 2);
                const int qpos = q0 + r_lo + 8 * h, kpos = k0 + c;
                float mk = 0.f;
                if (mask1) mk = sMk[st * BNF + c];
                else if (mrow != nullptr && qpos < p.S && kpos < p.S)
                    mk = mrow[(size_t)qpos * p.S + kpos];
                float sc = fmaf(s[j][i], sl2, mk * kLog2e);
                if (kpos >= p.S || (p.causal && kpos > qpos)) sc = -INFINITY;
                s[j][i] = sc;
                mx[h] = fmaxf(mx[h], sc);
            }
        float ms[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
            mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
            // the reference's guards: m_safe, alpha = 0 while the row is all -inf
            ms[h] = isfinite(mx[h]) ? mx[h] : 0.f;
            const float alpha = isfinite(m[h]) ? exp2f(m[h] - ms[h]) : 0.f;
            m[h] = mx[h];
            l[h] *= alpha;
#pragma unroll
            for (int n = 0; n < 8; ++n) {
                acc[n][2 * h] *= alpha;
                acc[n][2 * h + 1] *= alpha;
            }
        }
        // P = exp2(s - m_safe), 0 where s = -inf; the sum before dropout
#pragma unroll
        for (int j = 0; j < NJF; ++j)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int h = i / 2;
                float pr = exp2f(s[j][i] - ms[h]);
                l[h] += pr;
                if (p.dropout) {
                    const int qpos = q0 + r_lo + 8 * h, kpos = k0 + 8 * j + 2 * t + (i % 2);
                    pr = keep_bit(p, bh, qpos, kpos) ? pr * inv_keep : 0.f;
                }
                s[j][i] = pr;
            }
        // O += P V; the product rounds P to V's dtype
        mma_pb<T, LD, NJF>(acc, [&](int j, int i) { return s[j][i]; }, sV + 64 * wc, lane);
        __syncthreads();            // the stage is refilled next iteration
    }
    T* O = static_cast<T*>(p.out) + base;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
        const int qpos = q0 + r_lo + 8 * h;
        if (qpos >= p.S) continue;
        const float den = fmaxf(l[h], 1e-30f);
#pragma unroll
        for (int n = 0; n < 8; ++n)
            store2<T>(O + (size_t)qpos * HD + 64 * wc + 8 * n + 2 * t, acc[n][2 * h] / den,
                      acc[n][2 * h + 1] / den);
        if (t == 0 && wc == 0)
            p.lse[(size_t)bh * p.S + qpos] =
                isfinite(m[h]) ? m[h] * kLn2 + logf(den) : -INFINITY;
    }
}

// -------------------------------------------------------------- dq pass --
// One block per 64-row q tile, looping over BN-key tiles. A warp's 16 q rows
// x BN keys of S and dP stay in registers; dS feeds dQ += dS K from there.
// Writes delta = rowsum(f32(dO) * f32(O)) of its rows for B3.
template <typename T, int HD>
__global__ void __launch_bounds__(128 * (HD / 64)) flash_bwd_dq_kernel(Params p) {
    using namespace mma_tile;
    constexpr int NTB = tile_threads<HD>(), LD = tile_ld<T, HD>();
    constexpr int TILE = BQ * LD, STILE = BN * LD;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* sQ = reinterpret_cast<T*>(smem_raw);
    T* sDO = sQ + TILE;
    T* sRing = sDO + TILE;          // stage s: K at sRing + 2 s STILE, V after it
    float* sMk = reinterpret_cast<float*>(sRing + 4 * STILE);  // [2][BN] key-padding rows
    float* sLse = sMk + 2 * BN;
    float* sDelta = sLse + BQ;

    const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4, wr = warp % 4, wc = warp / 4;
    const size_t base = (size_t)bh * p.S * HD;
    const T* K = static_cast<const T*>(p.k) + base;
    const T* V = static_cast<const T*>(p.v) + base;
    const T* dO = static_cast<const T*>(p.dout) + base;
    const T* O = static_cast<const T*>(p.o) + base;
    const float* mrow = p.mask_mode ? mask_base(p, bh) : nullptr;
    const bool mask1 = mrow != nullptr && p.mask_rows == 1;
    const float inv_keep = 1.f / p.keep_prob;

    int n_kt = (p.S + BN - 1) / BN;
    if (p.causal) n_kt = min(n_kt, (min(q0 + BQ, p.S) + BN - 1) / BN);
    auto issue = [&](int stage, int kt) {
        const int k0 = kt * BN;
        T* dst = sRing + 2 * stage * STILE;
        load_tile_async<T, HD, BN, NTB>(dst, K, k0, p.S);
        load_tile_async<T, HD, BN, NTB>(dst + STILE, V, k0, p.S);
        if (mask1 && tid < BN)
            cp_async4(sMk + stage * BN + tid, mrow + min(k0 + tid, p.S - 1), k0 + tid < p.S);
    };
    load_tile_async<T, HD, BQ, NTB>(sQ, static_cast<const T*>(p.q) + base, q0, p.S);
    load_tile_async<T, HD, BQ, NTB>(sDO, dO, q0, p.S);
    issue(0, 0);
    cp_async_commit();

    // delta of this q tile, once, while the first tiles land; written out
    // for B3, with the finite-guarded lse beside it. One warp per row.
    for (int r = warp; r < BQ; r += NTB / 32) {
        const int qpos = q0 + r;
        float d = 0.f;
        if (qpos < p.S)
            for (int c = lane; c < HD; c += 32)
                d += to_f<T>(dO[(size_t)qpos * HD + c]) * to_f<T>(O[(size_t)qpos * HD + c]);
        d = warp_sum(d);
        if (lane == 0) {
            const float l = qpos < p.S ? p.lse[(size_t)bh * p.S + qpos] : 0.f;
            sLse[r] = isfinite(l) ? l : 0.f;
            sDelta[r] = d;
            if (qpos < p.S) p.delta[(size_t)bh * p.S + qpos] = d;
        }
    }

    const int r_lo = 16 * wr + g;   // this thread's rows: r_lo and r_lo + 8
    float lse[2], dl[2];
    float acc[8][4] = {};
    for (int kt = 0; kt < n_kt; ++kt) {
        const int st = kt & 1, k0 = kt * BN;
        if (kt + 1 < n_kt) issue(st ^ 1, kt + 1);
        cp_async_commit();
        cp_async_wait<1>();
        __syncthreads();
        if (kt == 0) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                lse[h] = sLse[r_lo + 8 * h];
                dl[h] = sDelta[r_lo + 8 * h];
            }
        }
        const T* sK = sRing + 2 * st * STILE;
        const T* sV = sK + STILE;
        float s[NJ][4] = {}, dp[NJ][4] = {};
        mma_abt<T, HD, LD, NJ>(s, sQ + 16 * wr * LD, sK, lane);
        mma_abt<T, HD, LD, NJ>(dp, sDO + 16 * wr * LD, sV, lane);
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int h = i / 2, c = 8 * j + 2 * t + (i % 2);
                const int qpos = q0 + r_lo + 8 * h, kpos = k0 + c;
                const float sc = bwd_score(p, mrow, mask1 ? sMk[st * BN + c] : 0.f, s[j][i],
                                           qpos, kpos);
                const float pr = isfinite(sc) ? exp2f((sc - lse[h]) * kLog2e) : 0.f;
                float dpv = dp[j][i];
                if (p.dropout) dpv = keep_bit(p, bh, qpos, kpos) ? dpv * inv_keep : 0.f;
                s[j][i] = pr * (dpv - dl[h]) * p.scale;   // dS; the product rounds it to T
            }
        mma_pb<T, LD, NJ>(acc, [&](int j, int i) { return s[j][i]; }, sK + 64 * wc, lane);
        __syncthreads();            // the stage is refilled next iteration
    }
    T* dQ = static_cast<T*>(p.out) + base;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int qpos = q0 + r_lo + 8 * h;
        if (qpos >= p.S) continue;
#pragma unroll
        for (int n = 0; n < 8; ++n)
            store2<T>(dQ + (size_t)qpos * HD + 64 * wc + 8 * n + 2 * t, acc[n][2 * h],
                      acc[n][2 * h + 1]);
    }
}

// ------------------------------------------------------------ dk/dv pass --
// One block per 64-row key tile, looping over BN-row q tiles. Computes the
// transposed scores S^T = K Q^T and dP^T = V dO^T, so P^T and dS^T land in
// registers with key rows and are the A operands of dV += P^T dO and dK +=
// dS^T Q. Reads delta from B2's buffer; O is not read.
template <typename T, int HD>
__global__ void __launch_bounds__(128 * (HD / 64)) flash_bwd_dkdv_kernel(Params p) {
    using namespace mma_tile;
    constexpr int NTB = tile_threads<HD>(), LD = tile_ld<T, HD>();
    constexpr int TILE = BK * LD, STILE = BN * LD;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* sK = reinterpret_cast<T*>(smem_raw);
    T* sV = sK + TILE;
    T* sRing = sV + TILE;           // stage s: Q at sRing + 2 s STILE, dO after it
    float* sLse = reinterpret_cast<float*>(sRing + 4 * STILE);  // [2][BN]
    float* sDelta = sLse + 2 * BN;                               // [2][BN]

    const int bh = blockIdx.y, k0 = blockIdx.x * BK;
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4, wr = warp % 4, wc = warp / 4;
    const size_t base = (size_t)bh * p.S * HD;
    const T* Q = static_cast<const T*>(p.q) + base;
    const T* dO = static_cast<const T*>(p.dout) + base;
    const float* lse = p.lse + (size_t)bh * p.S;
    const float* delta = p.delta + (size_t)bh * p.S;
    const float* mrow = p.mask_mode ? mask_base(p, bh) : nullptr;
    const bool mask1 = mrow != nullptr && p.mask_rows == 1;
    const float inv_keep = 1.f / p.keep_prob;

    const int n_qt = (p.S + BN - 1) / BN;
    const int qt0 = p.causal ? k0 / BN : 0;    // the first q tile that reaches k0
    auto issue = [&](int stage, int qt) {
        const int q0 = qt * BN;
        T* dst = sRing + 2 * stage * STILE;
        load_tile_async<T, HD, BN, NTB>(dst, Q, q0, p.S);
        load_tile_async<T, HD, BN, NTB>(dst + STILE, dO, q0, p.S);
        if (tid < 2 * BN) {
            const int r = tid % BN;
            const bool ok = q0 + r < p.S;
            cp_async4((tid < BN ? sLse : sDelta) + stage * BN + r,
                      (tid < BN ? lse : delta) + (ok ? q0 + r : 0), ok);
        }
    };
    load_tile_async<T, HD, BK, NTB>(sK, static_cast<const T*>(p.k) + base, k0, p.S);
    load_tile_async<T, HD, BK, NTB>(sV, static_cast<const T*>(p.v) + base, k0, p.S);
    issue(0, qt0);
    cp_async_commit();

    const int r_lo = 16 * wr + g;   // this thread's key rows: r_lo and r_lo + 8
    float mk[2] = {0.f, 0.f};       // the key-padding row, read once
    if (mask1) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int kpos = k0 + r_lo + 8 * h;
            mk[h] = kpos < p.S ? mrow[kpos] : 0.f;
        }
    }
    float dk[8][4] = {}, dv[8][4] = {};
    for (int qt = qt0; qt < n_qt; ++qt) {
        const int st = (qt - qt0) & 1, q0 = qt * BN;
        if (qt + 1 < n_qt) issue(st ^ 1, qt + 1);
        cp_async_commit();
        cp_async_wait<1>();
        __syncthreads();
        const T* sQ = sRing + 2 * st * STILE;
        const T* sDO = sQ + STILE;
        const float* tl = sLse + st * BN;
        const float* td = sDelta + st * BN;
        float s[NJ][4] = {};
        mma_abt<T, HD, LD, NJ>(s, sK + 16 * wr * LD, sQ, lane);
        uint32_t kept = 0;          // dropout keep bit of element (j, i) at 4j + i
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int c = 8 * j + 2 * t + (i % 2);
                const int kpos = k0 + r_lo + 8 * (i / 2), qpos = q0 + c;
                const float sc = bwd_score(p, mrow, mk[i / 2], s[j][i], qpos, kpos);
                const float l = tl[c];
                s[j][i] = (isfinite(sc) && qpos < p.S)
                              ? exp2f((sc - (isfinite(l) ? l : 0.f)) * kLog2e) : 0.f;   // P^T
                if (p.dropout && keep_bit(p, bh, qpos, kpos)) kept |= 1u << (4 * j + i);
            }
        // dV += dropout(P)^T dO; the product rounds P to dO's dtype
        mma_pb<T, LD, NJ>(dv, [&](int j, int i) {
            if (!p.dropout) return s[j][i];
            return (kept >> (4 * j + i)) & 1u ? s[j][i] * inv_keep : 0.f;
        }, sDO + 64 * wc, lane);
        float dp[NJ][4] = {};
        mma_abt<T, HD, LD, NJ>(dp, sV + 16 * wr * LD, sDO, lane);
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int c = 8 * j + 2 * t + (i % 2);
                float dpv = dp[j][i];
                if (p.dropout) dpv = (kept >> (4 * j + i)) & 1u ? dpv * inv_keep : 0.f;
                dp[j][i] = s[j][i] * (dpv - td[c]) * p.scale;   // dS^T, rounded to T by the product
            }
        mma_pb<T, LD, NJ>(dk, [&](int j, int i) { return dp[j][i]; }, sQ + 64 * wc, lane);
        __syncthreads();            // the stage is refilled next iteration
    }
    T* dK = static_cast<T*>(p.dk) + base;
    T* dV = static_cast<T*>(p.dv) + base;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int kpos = k0 + r_lo + 8 * h;
        if (kpos >= p.S) continue;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
            const size_t off = (size_t)kpos * HD + 64 * wc + 8 * n + 2 * t;
            store2<T>(dK + off, dk[n][2 * h], dk[n][2 * h + 1]);
            store2<T>(dV + off, dv[n][2 * h], dv[n][2 * h + 1]);
        }
    }
}

template <typename Kern>
int launch(Kern kern, size_t smem, dim3 grid, int threads, const Params& p,
           cudaStream_t st) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
    kern<<<grid, threads, smem, st>>>(p);
    return (int)cudaGetLastError();
}

// which: 0 fwd, 1 dq, 2 dkdv
template <typename T, int HD>
int run(int which, const Params& p, cudaStream_t st) {
    dim3 grid((p.S + BQ - 1) / BQ, p.B * p.nh);
    if (which == 0)
        return launch(flash_fwd_kernel<T, HD>, fwd_smem<T, HD>(), grid, tile_threads<HD>(),
                      p, st);
    if (which == 1)
        return launch(flash_bwd_dq_kernel<T, HD>, bwd_smem<T, HD>(), grid,
                      tile_threads<HD>(), p, st);
    grid.x = (p.S + BK - 1) / BK;
    return launch(flash_bwd_dkdv_kernel<T, HD>, bwd_smem<T, HD>(), grid,
                  tile_threads<HD>(), p, st);
}

int dispatch(int which, int dtype, int hd, const Params& p, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == 0 && hd == 64) return run<float, 64>(which, p, st);
    if (dtype == 0 && hd == 128) return run<float, 128>(which, p, st);
    if (dtype == 1 && hd == 64) return run<__nv_bfloat16, 64>(which, p, st);
    if (dtype == 1 && hd == 128) return run<__nv_bfloat16, 128>(which, p, st);
    return (int)cudaErrorInvalidValue;
}

Params make_params(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, const float* mask, float* lse, float* delta,
                   void* out, void* dk,
                   void* dv, int B, int nh, int S, int mask_mode, int mask_rows,
                   float scale, int causal, int dropout, unsigned thresh, unsigned seed,
                   float keep_prob) {
    Params p;
    p.q = q; p.k = k; p.v = v; p.o = o; p.dout = dout; p.mask = mask; p.lse = lse;
    p.delta = delta; p.out = out; p.dk = dk; p.dv = dv;
    p.B = B; p.nh = nh; p.S = S; p.mask_mode = mask_mode; p.mask_rows = mask_rows;
    p.scale = scale; p.causal = causal; p.dropout = dropout; p.thresh = thresh;
    p.seed = seed; p.keep_prob = keep_prob;
    return p;
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16; hd: 64 or 128. Each returns cudaGetLastError()
// after its one launch (0 = launched).
int flash_fwd(const void* q, const void* k, const void* v, const float* mask, void* o,
              float* lse, int dtype, int B, int nh, int S, int hd, int mask_mode,
              int mask_rows, float scale, int causal, int dropout, unsigned thresh,
              unsigned seed, float keep_prob, void* stream) {
    Params p = make_params(q, k, v, nullptr, nullptr, mask, lse, nullptr, o, nullptr,
                           nullptr, B, nh, S, mask_mode, mask_rows, scale, causal, dropout, thresh, seed,
                           keep_prob);
    return dispatch(0, dtype, hd, p, stream);
}

// B2 writes dQ and delta [B*nh, S] f32; B3 reads that delta (and not O)
int flash_bwd_dq(const void* q, const void* k, const void* v, const void* o,
                 const void* dout, float* lse, const float* mask, void* dq, float* delta,
                 int dtype, int B, int nh, int S, int hd, int mask_mode, int mask_rows,
                 float scale, int causal, int dropout, unsigned thresh, unsigned seed,
                 float keep_prob, void* stream) {
    Params p = make_params(q, k, v, o, dout, mask, lse, delta, dq, nullptr, nullptr, B, nh, S,
                           mask_mode, mask_rows, scale, causal, dropout, thresh, seed,
                           keep_prob);
    return dispatch(1, dtype, hd, p, stream);
}

int flash_bwd_dkdv(const void* q, const void* k, const void* v, float* delta,
                   const void* dout, float* lse, const float* mask, void* dk, void* dv,
                   int dtype, int B, int nh, int S, int hd, int mask_mode, int mask_rows,
                   float scale, int causal, int dropout, unsigned thresh, unsigned seed,
                   float keep_prob, void* stream) {
    Params p = make_params(q, k, v, nullptr, dout, mask, lse, delta, nullptr, dk, dv, B, nh,
                           S, mask_mode, mask_rows, scale, causal, dropout, thresh, seed,
                           keep_prob);
    return dispatch(2, dtype, hd, p, stream);
}

const char* flash_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
