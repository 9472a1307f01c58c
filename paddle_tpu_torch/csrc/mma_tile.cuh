// Tensor-core and asynchronous-copy building blocks for sm_90a kernels that
// run warp-level `mma.sync` on tiles staged in shared memory.
//
// Fragment layouts (PTX ISA, "Matrix fragments for mma.m16n8k8 / k16"),
// with g = lane / 4 and t = lane % 4:
//   C/D 16x8 f32     c0 (g, 2t)  c1 (g, 2t+1)  c2 (g+8, 2t)  c3 (g+8, 2t+1)
//   A 16x8 tf32      a0 (g, t)   a1 (g+8, t)   a2 (g, t+4)   a3 (g+8, t+4)
//   B 8x8 tf32       b0 (k t, n g)             b1 (k t+4, n g)
//   A 16x16 bf16     r0 (g, 2t..2t+1)  r1 (g+8, 2t..)  r2 (g, 2t+8..)  r3 (g+8, 2t+8..)
//   B 16x8 bf16      r0 (k 2t..2t+1, n g)      r1 (k 2t+8..2t+9, n g)
// A pair of bf16 values packs low element first.
//
// f32 operands run as 3xTF32: x = big + small with big = x rounded to
// nearest TF32 and small = x - big (split_tf32); a product accumulates
// small*big + big*small + big*big in f32 and drops small*small (as CUTLASS's
// OpMultiplyAddFastF32 does). That keeps f32 accuracy where one TF32
// product keeps ~3 decimal digits.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace mma_tile {

// ---------------------------------------------------------------- copies --
// 16 bytes global -> shared, zero-filled when !valid (src is not read then,
// but must still be a mapped address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
    const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
    const int n = valid ? 16 : 0;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(d), "l"(src), "r"(n) : "memory");
}

// 4 bytes global -> shared, zero-filled when !valid
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
    const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
    const int n = valid ? 4 : 0;
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(d), "l"(src), "r"(n) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Rows [r0, r0 + ROWS) of a row-major [S, HD] matrix into a shared tile of
// row stride LD elements (HD + 16 bytes: 16-byte aligned rows, and row r
// starts 4r words into the 32 banks, so 8 rows of a fragment load or an
// ldmatrix phase fall on distinct banks). Rows at or past S are zero.
template <typename T, int HD, int ROWS, int NT>
__device__ __forceinline__ void load_tile_async(T* dst, const T* src, int r0, int S) {
    constexpr int PER = 16 / sizeof(T);          // elements per 16 bytes
    constexpr int CPR = HD / PER;                // chunks per row
    constexpr int LD = HD + PER;
#pragma unroll
    for (int i = threadIdx.x; i < ROWS * CPR; i += NT) {
        const int r = i / CPR, c = (i % CPR) * PER;
        const bool ok = r0 + r < S;
        cp_async16(dst + r * LD + c, src + (size_t)(ok ? r0 + r : 0) * HD + c, ok);
    }
}

// ------------------------------------------------------------ fragments --
__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const void* p) {
    const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a) : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t r[4], const void* p) {
    const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

// x rounded to TF32 as cvt.rna.tf32.f32 rounds it (to nearest, ties away
// from zero, low 13 bits cleared), for finite x: half a TF32 ulp added to
// the magnitude bits, then cut. Two integer instructions, where cvt runs on
// a slower pipe (measured on an H100: the split with cvt made B2+B3 ~12%
// slower, with bit-identical results).
__device__ __forceinline__ uint32_t rna_tf32(float x) {
    return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = big + small: big = rna(x); small = x - big (exact in f32), passed as
// it is, so the tensor core, which reads the top 19 bits of a TF32 operand,
// takes it rounded toward zero. Rounding small to nearest instead changes
// a product by less than 2^-21 of its value and costs two more integer
// instructions per element, on the pipe that issues at half the FP32 rate
// (measured on an H100: B2+B3 8% slower, the same max error).
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
    big = rna_tf32(x);
    small = __float_as_uint(x - __uint_as_float(big));
}

// ------------------------------------------------------------- products --
__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a * b in 3xTF32 from split operands (small terms first)
__device__ __forceinline__ void mma_3xtf32(float c[4], const uint32_t ab[4],
                                           const uint32_t as[4], const uint32_t bb[2],
                                           const uint32_t bs[2]) {
    mma_tf32(c, as, bb[0], bb[1]);
    mma_tf32(c, ab, bs[0], bs[1]);
    mma_tf32(c, ab, bb[0], bb[1]);
}

// acc[j] (the 16 x 8 tile of columns 8j..8j+7) += A . B^T for one warp:
// A = 16 rows x HD at `sa`, B = 8 NJ rows x HD at `sb`, both row-major in
// shared memory with row stride LD; the contraction runs over HD, the axis
// both store contiguously.
template <typename T, int HD, int LD, int NJ>
__device__ __forceinline__ void mma_abt(float (&acc)[NJ][4], const T* sa, const T* sb,
                                        int lane) {
    const int g = lane / 4, t = lane % 4;
    if constexpr (sizeof(T) == 4) {
#pragma unroll 2
        for (int kk = 0; kk < HD; kk += 8) {
            const float* a = reinterpret_cast<const float*>(sa) + g * LD + kk + t;
            uint32_t ab[4], as[4];
            split_tf32(a[0], ab[0], as[0]);
            split_tf32(a[8 * LD], ab[1], as[1]);
            split_tf32(a[4], ab[2], as[2]);
            split_tf32(a[8 * LD + 4], ab[3], as[3]);
#pragma unroll
            for (int j = 0; j < NJ; ++j) {
                const float* b = reinterpret_cast<const float*>(sb) + (8 * j + g) * LD + kk + t;
                uint32_t bb[2], bs[2];
                split_tf32(b[0], bb[0], bs[0]);
                split_tf32(b[4], bb[1], bs[1]);
                mma_3xtf32(acc[j], ab, as, bb, bs);
            }
        }
    } else {
        const int ar = lane % 16, ac = (lane / 16) * 8;           // A: 4 8x8 quadrants
        const int br = (lane % 8) + 8 * (lane / 16), bc = 8 * ((lane / 8) % 2);
#pragma unroll
        for (int kk = 0; kk < HD; kk += 16) {
            uint32_t a[4];
            ldsm_x4(a, sa + ar * LD + kk + ac);
#pragma unroll
            for (int j = 0; j < NJ; j += 2) {
                uint32_t b[4];      // n-tiles j and j+1, k halves 0 and 1
                ldsm_x4(b, sb + (8 * j + br) * LD + kk + bc);
                mma_bf16(acc[j], a, b[0], b[1]);
                mma_bf16(acc[j + 1], a, b[2], b[3]);
            }
        }
    }
}

// acc[n] (the 16 x 8 tile of columns 8n..8n+7) += P . B for one warp: P is
// 16 x 8 NJ held in registers in the accumulator layout (p(j, i) gives
// element i of its tile j, already in the value the product takes), B = 8
// NJ rows x 64 columns at `sb` (row stride LD): the contraction runs over
// B's stored rows. tf32: the thread holding P columns (2t, 2t+1) of a tile
// uses them as k-slots (t, t+4), and reads B's rows in that same permuted
// order, so P needs no shuffle. bf16: two adjacent accumulator tiles are
// one m16n8k16 A fragment; B comes through ldmatrix.trans.
template <typename T, int LD, int NJ, typename PFn>
__device__ __forceinline__ void mma_pb(float (&acc)[8][4], PFn p, const T* sb, int lane) {
    const int g = lane / 4, t = lane % 4;
    if constexpr (sizeof(T) == 4) {
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
            uint32_t ab[4], as[4];
            split_tf32(p(j, 0), ab[0], as[0]);
            split_tf32(p(j, 2), ab[1], as[1]);
            split_tf32(p(j, 1), ab[2], as[2]);
            split_tf32(p(j, 3), ab[3], as[3]);
            const float* b = reinterpret_cast<const float*>(sb) + (8 * j + 2 * t) * LD + g;
#pragma unroll
            for (int n = 0; n < 8; ++n) {
                uint32_t bb[2], bs[2];
                split_tf32(b[8 * n], bb[0], bs[0]);
                split_tf32(b[LD + 8 * n], bb[1], bs[1]);
                mma_3xtf32(acc[n], ab, as, bb, bs);
            }
        }
    } else {
        const int br = (lane % 8) + 8 * ((lane / 8) % 2), bc = 8 * (lane / 16);
#pragma unroll
        for (int j = 0; j < NJ; j += 2) {
            const uint32_t a[4] = {pack_bf16(p(j, 0), p(j, 1)), pack_bf16(p(j, 2), p(j, 3)),
                                   pack_bf16(p(j + 1, 0), p(j + 1, 1)),
                                   pack_bf16(p(j + 1, 2), p(j + 1, 3))};
#pragma unroll
            for (int n = 0; n < 8; n += 2) {
                uint32_t b[4];      // k halves 0/1 of n-tile n, then of n+1
                ldsm_x4_trans(b, sb + (8 * j + br) * LD + 8 * n + bc);
                mma_bf16(acc[n], a, b[0], b[1]);
                mma_bf16(acc[n + 1], a, b[2], b[3]);
            }
        }
    }
}

}  // namespace mma_tile
