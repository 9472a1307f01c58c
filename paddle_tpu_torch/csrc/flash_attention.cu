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
//   dq  : delta = rowsum(f32(dO) * f32(O)) in the kernel; P = exp(S - lse);
//         dP = dropout-upscaled dO V^T; dS = P (dP - delta) scale, rounded
//         to K's dtype; dQ = dS K.
//   dkdv: dV += dropout(P)^T dO (P rounded to dO's dtype); dK += dS^T Q (dS
//         rounded to Q's dtype); with `causal` the q loop starts at the
//         first q tile that reaches this key tile.
// Dropout is the reference's counter hash (_keep_mask :73): bit (q, k) of
// head b*nh+h depends only on (seed, head, q, k), so all three kernels
// regenerate the forward's mask although they tile differently.
//
// Bound on this card: at BERT shapes (S 512, hd 64) each kernel does
// 4-8 * BH*S^2*hd operations on ~25-45 MB of operands, so operations
// bound it (well above the ~295 FLOP/byte ridge in bf16). This first
// version is deliberately simple: 64 x 64 tiles staged in shared memory
// as f32, each of 256 threads owning a 4 x 4 score micro-tile and a
// 4 x (hd/16) output micro-tile, scalar FMAs on the CUDA cores. The
// score matrix never reaches device memory. Tensor cores (wgmma), TMA and
// warp specialisation are later work (PERF.md).
//
// Unlike the TPU kernels, any S is taken (a tail tile is masked), and
// lse is stored [B*nh, S] rather than broadcast over 128 lanes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;   // query rows per tile
constexpr int BK = 64;   // key rows per tile
constexpr int NT = 256;  // threads per block, viewed as 16 x 16
constexpr int LDS = BK + 1;  // padded row of a score tile

struct Params {
    const void* q;
    const void* k;
    const void* v;
    const void* o;      // forward output (backward only)
    const void* dout;   // dO (backward only)
    const float* mask;  // [Bm, Rm, S] or null
    float* lse;         // written by fwd, read by bwd
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
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
    return __float2bfloat16_rn(x);
}
// the reference's casts to an operand dtype before a product
template <typename T> __device__ __forceinline__ float round_to(float x) {
    return to_f<T>(from_f<T>(x));
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

// scaled, masked score of (qpos, kpos); -inf outside the key range and
// above the causal diagonal (the reference's -inf guards)
__device__ __forceinline__ float masked_score(const Params& p, const float* mrow,
                                              float dot, int qpos, int kpos) {
    if (kpos >= p.S) return -INFINITY;
    float s = dot * p.scale;
    if (mrow != nullptr && qpos < p.S)
        s += mrow[(size_t)(p.mask_rows == 1 ? 0 : qpos) * p.S + kpos];
    if (p.causal && kpos > qpos) return -INFINITY;
    return s;
}

__device__ __forceinline__ float warp_max(float x) {
    for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
    return x;
}
__device__ __forceinline__ float warp_sum(float x) {
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    return x;
}

// rows [r0, r0 + BQ) of a [S, HD] matrix into a padded f32 tile
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int r0, int S) {
    constexpr int LD = HD + 1;
    for (int i = threadIdx.x; i < BQ * HD; i += NT) {
        int r = i / HD, d = i % HD;
        dst[r * LD + d] = (r0 + r < S) ? to_f<T>(src[(size_t)(r0 + r) * HD + d]) : 0.f;
    }
}

// 4 x 4 micro-tile of A B^T: rows ty + 16 i of A, rows tx + 16 j of B
template <int HD>
__device__ __forceinline__ void dot_tile(float acc[4][4], const float* A, const float* Bm,
                                         int ty, int tx) {
    constexpr int LD = HD + 1;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = A[(ty + 16 * i) * LD + d];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = Bm[(tx + 16 * j) * LD + d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
}

// ---------------------------------------------------------------- forward --
template <typename T, int HD>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(Params p) {
    constexpr int LD = HD + 1, NC = HD / 16;
    extern __shared__ float smem[];
    float* sQ = smem;
    float* sK = sQ + BQ * LD;
    float* sV = sK + BK * LD;
    float* sS = sV + BK * LD;
    float* sM = sS + BQ * LDS;
    float* sL = sM + BQ;
    float* sA = sL + BQ;

    const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
    const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
    const int warp = tid / 32, lane = tid % 32;
    const size_t base = (size_t)bh * p.S * HD;
    const T* Q = static_cast<const T*>(p.q) + base;
    const T* K = static_cast<const T*>(p.k) + base;
    const T* V = static_cast<const T*>(p.v) + base;
    const float* mrow = p.mask_mode ? mask_base(p, bh) : nullptr;

    load_tile<T, HD>(sQ, Q, q0, p.S);
    for (int r = tid; r < BQ; r += NT) { sM[r] = -INFINITY; sL[r] = 0.f; }
    float acc[4][NC];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NC; ++j) acc[i][j] = 0.f;

    int n_kt = (p.S + BK - 1) / BK;
    if (p.causal) n_kt = min(n_kt, (min(q0 + BQ, p.S) + BK - 1) / BK);
    for (int kt = 0; kt < n_kt; ++kt) {
        const int k0 = kt * BK;
        __syncthreads();                       // previous tile fully used
        load_tile<T, HD>(sK, K, k0, p.S);
        load_tile<T, HD>(sV, V, k0, p.S);
        __syncthreads();
        float s[4][4] = {};
        dot_tile<HD>(s, sQ, sK, ty, tx);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                int r = ty + 16 * i, c = tx + 16 * j;
                sS[r * LDS + c] = masked_score(p, mrow, s[i][j], q0 + r, k0 + c);
            }
        __syncthreads();
        // online softmax: each warp owns 8 rows, each lane 2 columns
        for (int rr = 0; rr < BQ / 8; ++rr) {
            const int r = warp * (BQ / 8) + rr;
            float v0 = sS[r * LDS + lane], v1 = sS[r * LDS + lane + 32];
            float m_prev = sM[r];
            float m_new = fmaxf(m_prev, warp_max(fmaxf(v0, v1)));
            float m_safe = isfinite(m_new) ? m_new : 0.f;
            float p0 = isfinite(v0) ? expf(v0 - m_safe) : 0.f;
            float p1 = isfinite(v1) ? expf(v1 - m_safe) : 0.f;
            float rowsum = warp_sum(p0 + p1);
            float alpha = isfinite(m_prev) ? expf(m_prev - m_safe) : 0.f;
            if (p.dropout) {
                uint32_t qpos = q0 + r;
                p0 = keep_bit(p, bh, qpos, k0 + lane) ? p0 / p.keep_prob : 0.f;
                p1 = keep_bit(p, bh, qpos, k0 + lane + 32) ? p1 / p.keep_prob : 0.f;
            }
            sS[r * LDS + lane] = round_to<T>(p0);
            sS[r * LDS + lane + 32] = round_to<T>(p1);
            if (lane == 0) {
                sM[r] = m_new;
                sL[r] = alpha * sL[r] + rowsum;
                sA[r] = alpha;
            }
        }
        __syncthreads();
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            float a = sA[ty + 16 * i];
#pragma unroll
            for (int j = 0; j < NC; ++j) acc[i][j] *= a;
        }
#pragma unroll 4
        for (int kk = 0; kk < BK; ++kk) {
            float pr[4], vv[NC];
#pragma unroll
            for (int i = 0; i < 4; ++i) pr[i] = sS[(ty + 16 * i) * LDS + kk];
#pragma unroll
            for (int j = 0; j < NC; ++j) vv[j] = sV[kk * LD + tx + 16 * j];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < NC; ++j) acc[i][j] = fmaf(pr[i], vv[j], acc[i][j]);
        }
    }
    __syncthreads();
    T* O = static_cast<T*>(p.out) + base;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int qpos = q0 + ty + 16 * i;
        if (qpos >= p.S) continue;
        const float l = fmaxf(sL[ty + 16 * i], 1e-30f);
#pragma unroll
        for (int j = 0; j < NC; ++j)
            O[(size_t)qpos * HD + tx + 16 * j] = from_f<T>(acc[i][j] / l);
    }
    if (tid < BQ && q0 + tid < p.S) {
        const float m = sM[tid];
        p.lse[(size_t)bh * p.S + q0 + tid] =
            isfinite(m) ? m + logf(fmaxf(sL[tid], 1e-30f)) : -INFINITY;
    }
}

// delta = rowsum(f32(dO) * f32(O)) and the finite-guarded lse of rows
// [q0, q0 + BQ); one warp per row
template <typename T, int HD>
__device__ __forceinline__ void row_stats(const Params& p, int bh, int q0,
                                          float* sLse, float* sDelta) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const size_t base = (size_t)bh * p.S * HD;
    const T* O = static_cast<const T*>(p.o) + base;
    const T* dO = static_cast<const T*>(p.dout) + base;
    for (int r = warp; r < BQ; r += NT / 32) {
        const int qpos = q0 + r;
        float d = 0.f;
        if (qpos < p.S)
            for (int c = lane; c < HD; c += 32)
                d += to_f<T>(dO[(size_t)qpos * HD + c]) * to_f<T>(O[(size_t)qpos * HD + c]);
        d = warp_sum(d);
        if (lane == 0) {
            float l = qpos < p.S ? p.lse[(size_t)bh * p.S + qpos] : 0.f;
            sLse[r] = isfinite(l) ? l : 0.f;
            sDelta[r] = d;
        }
    }
}

// -------------------------------------------------------------- dq pass --
template <typename T, int HD>
__global__ void __launch_bounds__(NT) flash_bwd_dq_kernel(Params p) {
    constexpr int LD = HD + 1, NC = HD / 16;
    extern __shared__ float smem[];
    float* sQ = smem;
    float* sDO = sQ + BQ * LD;
    float* sK = sDO + BQ * LD;
    float* sV = sK + BK * LD;
    float* sS = sV + BK * LD;
    float* sLse = sS + BQ * LDS;
    float* sDelta = sLse + BQ;

    const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
    const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
    const size_t base = (size_t)bh * p.S * HD;
    const T* K = static_cast<const T*>(p.k) + base;
    const T* V = static_cast<const T*>(p.v) + base;
    const float* mrow = p.mask_mode ? mask_base(p, bh) : nullptr;

    load_tile<T, HD>(sQ, static_cast<const T*>(p.q) + base, q0, p.S);
    load_tile<T, HD>(sDO, static_cast<const T*>(p.dout) + base, q0, p.S);
    row_stats<T, HD>(p, bh, q0, sLse, sDelta);
    float acc[4][NC];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NC; ++j) acc[i][j] = 0.f;

    int n_kt = (p.S + BK - 1) / BK;
    if (p.causal) n_kt = min(n_kt, (min(q0 + BQ, p.S) + BK - 1) / BK);
    for (int kt = 0; kt < n_kt; ++kt) {
        const int k0 = kt * BK;
        __syncthreads();
        load_tile<T, HD>(sK, K, k0, p.S);
        load_tile<T, HD>(sV, V, k0, p.S);
        __syncthreads();
        float s[4][4] = {}, dp[4][4] = {};
        dot_tile<HD>(s, sQ, sK, ty, tx);
        dot_tile<HD>(dp, sDO, sV, ty, tx);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int r = ty + 16 * i, c = tx + 16 * j;
                const int qpos = q0 + r, kpos = k0 + c;
                float sc = masked_score(p, mrow, s[i][j], qpos, kpos);
                float pr = isfinite(sc) ? expf(sc - sLse[r]) : 0.f;
                float dpv = dp[i][j];
                if (p.dropout)
                    dpv = keep_bit(p, bh, qpos, kpos) ? dpv / p.keep_prob : 0.f;
                sS[r * LDS + c] = round_to<T>(pr * (dpv - sDelta[r]) * p.scale);
            }
        __syncthreads();
#pragma unroll 4
        for (int kk = 0; kk < BK; ++kk) {
            float ds[4], kv[NC];
#pragma unroll
            for (int i = 0; i < 4; ++i) ds[i] = sS[(ty + 16 * i) * LDS + kk];
#pragma unroll
            for (int j = 0; j < NC; ++j) kv[j] = sK[kk * LD + tx + 16 * j];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < NC; ++j) acc[i][j] = fmaf(ds[i], kv[j], acc[i][j]);
        }
    }
    T* dQ = static_cast<T*>(p.out) + base;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int qpos = q0 + ty + 16 * i;
        if (qpos >= p.S) continue;
#pragma unroll
        for (int j = 0; j < NC; ++j) dQ[(size_t)qpos * HD + tx + 16 * j] = from_f<T>(acc[i][j]);
    }
}

// ------------------------------------------------------------ dk/dv pass --
template <typename T, int HD>
__global__ void __launch_bounds__(NT) flash_bwd_dkdv_kernel(Params p) {
    constexpr int LD = HD + 1, NC = HD / 16;
    extern __shared__ float smem[];
    float* sK = smem;
    float* sV = sK + BK * LD;
    float* sQ = sV + BK * LD;
    float* sDO = sQ + BQ * LD;
    float* sP = sDO + BQ * LD;
    float* sDS = sP + BQ * LDS;
    float* sLse = sDS + BQ * LDS;
    float* sDelta = sLse + BQ;

    const int bh = blockIdx.y, k0 = blockIdx.x * BK;
    const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
    const size_t base = (size_t)bh * p.S * HD;
    const T* Q = static_cast<const T*>(p.q) + base;
    const T* dO = static_cast<const T*>(p.dout) + base;
    const float* mrow = p.mask_mode ? mask_base(p, bh) : nullptr;

    load_tile<T, HD>(sK, static_cast<const T*>(p.k) + base, k0, p.S);
    load_tile<T, HD>(sV, static_cast<const T*>(p.v) + base, k0, p.S);
    float dk[4][NC], dv[4][NC];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NC; ++j) { dk[i][j] = 0.f; dv[i][j] = 0.f; }

    const int n_qt = (p.S + BQ - 1) / BQ;
    const int qt0 = p.causal ? k0 / BQ : 0;
    for (int qt = qt0; qt < n_qt; ++qt) {
        const int q0 = qt * BQ;
        __syncthreads();
        load_tile<T, HD>(sQ, Q, q0, p.S);
        load_tile<T, HD>(sDO, dO, q0, p.S);
        row_stats<T, HD>(p, bh, q0, sLse, sDelta);
        __syncthreads();
        float s[4][4] = {}, dp[4][4] = {};
        dot_tile<HD>(s, sQ, sK, ty, tx);    // rows: q, cols: k
        dot_tile<HD>(dp, sDO, sV, ty, tx);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int r = ty + 16 * i, c = tx + 16 * j;
                const int qpos = q0 + r, kpos = k0 + c;
                float sc = masked_score(p, mrow, s[i][j], qpos, kpos);
                float pr = (isfinite(sc) && qpos < p.S) ? expf(sc - sLse[r]) : 0.f;
                float pd = pr, dpv = dp[i][j];
                if (p.dropout) {
                    const bool keep = keep_bit(p, bh, qpos, kpos);
                    pd = keep ? pr / p.keep_prob : 0.f;
                    dpv = keep ? dpv / p.keep_prob : 0.f;
                }
                sP[r * LDS + c] = round_to<T>(pd);
                sDS[r * LDS + c] = round_to<T>(pr * (dpv - sDelta[r]) * p.scale);
            }
        __syncthreads();
        // dV[c, :] += sum_r P[r, c] dO[r, :];  dK[c, :] += sum_r dS[r, c] Q[r, :]
#pragma unroll 2
        for (int r = 0; r < BQ; ++r) {
            float pc[4], dsc[4], dov[NC], qv[NC];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                pc[i] = sP[r * LDS + ty + 16 * i];
                dsc[i] = sDS[r * LDS + ty + 16 * i];
            }
#pragma unroll
            for (int j = 0; j < NC; ++j) {
                dov[j] = sDO[r * LD + tx + 16 * j];
                qv[j] = sQ[r * LD + tx + 16 * j];
            }
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < NC; ++j) {
                    dv[i][j] = fmaf(pc[i], dov[j], dv[i][j]);
                    dk[i][j] = fmaf(dsc[i], qv[j], dk[i][j]);
                }
        }
    }
    T* dK = static_cast<T*>(p.dk) + base;
    T* dV = static_cast<T*>(p.dv) + base;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int kpos = k0 + ty + 16 * i;
        if (kpos >= p.S) continue;
#pragma unroll
        for (int j = 0; j < NC; ++j) {
            dK[(size_t)kpos * HD + tx + 16 * j] = from_f<T>(dk[i][j]);
            dV[(size_t)kpos * HD + tx + 16 * j] = from_f<T>(dv[i][j]);
        }
    }
}

constexpr size_t fwd_smem(int hd) {
    return sizeof(float) * ((size_t)(BQ + 2 * BK) * (hd + 1) + BQ * LDS + 3 * BQ);
}
constexpr size_t dq_smem(int hd) {
    return sizeof(float) * ((size_t)(2 * BQ + 2 * BK) * (hd + 1) + BQ * LDS + 2 * BQ);
}
constexpr size_t dkdv_smem(int hd) {
    return sizeof(float) * ((size_t)(2 * BQ + 2 * BK) * (hd + 1) + 2 * BQ * LDS + 2 * BQ);
}

template <typename Kern>
int launch(Kern kern, size_t smem, dim3 grid, const Params& p, cudaStream_t st) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
    kern<<<grid, NT, smem, st>>>(p);
    return (int)cudaGetLastError();
}

// which: 0 fwd, 1 dq, 2 dkdv
template <typename T, int HD>
int run(int which, const Params& p, cudaStream_t st) {
    dim3 grid((p.S + BQ - 1) / BQ, p.B * p.nh);
    if (which == 0) return launch(flash_fwd_kernel<T, HD>, fwd_smem(HD), grid, p, st);
    if (which == 1) return launch(flash_bwd_dq_kernel<T, HD>, dq_smem(HD), grid, p, st);
    grid.x = (p.S + BK - 1) / BK;
    return launch(flash_bwd_dkdv_kernel<T, HD>, dkdv_smem(HD), grid, p, st);
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
                   const void* dout, const float* mask, float* lse, void* out, void* dk,
                   void* dv, int B, int nh, int S, int mask_mode, int mask_rows,
                   float scale, int causal, int dropout, unsigned thresh, unsigned seed,
                   float keep_prob) {
    Params p;
    p.q = q; p.k = k; p.v = v; p.o = o; p.dout = dout; p.mask = mask; p.lse = lse;
    p.out = out; p.dk = dk; p.dv = dv;
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
    Params p = make_params(q, k, v, nullptr, nullptr, mask, lse, o, nullptr, nullptr, B, nh,
                           S, mask_mode, mask_rows, scale, causal, dropout, thresh, seed,
                           keep_prob);
    return dispatch(0, dtype, hd, p, stream);
}

int flash_bwd_dq(const void* q, const void* k, const void* v, const void* o,
                 const void* dout, float* lse, const float* mask, void* dq, int dtype,
                 int B, int nh, int S, int hd, int mask_mode, int mask_rows, float scale,
                 int causal, int dropout, unsigned thresh, unsigned seed, float keep_prob,
                 void* stream) {
    Params p = make_params(q, k, v, o, dout, mask, lse, dq, nullptr, nullptr, B, nh, S,
                           mask_mode, mask_rows, scale, causal, dropout, thresh, seed,
                           keep_prob);
    return dispatch(1, dtype, hd, p, stream);
}

int flash_bwd_dkdv(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, float* lse, const float* mask, void* dk, void* dv,
                   int dtype, int B, int nh, int S, int hd, int mask_mode, int mask_rows,
                   float scale, int causal, int dropout, unsigned thresh, unsigned seed,
                   float keep_prob, void* stream) {
    Params p = make_params(q, k, v, o, dout, mask, lse, nullptr, dk, dv, B, nh, S,
                           mask_mode, mask_rows, scale, causal, dropout, thresh, seed,
                           keep_prob);
    return dispatch(2, dtype, hd, p, stream);
}

const char* flash_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
