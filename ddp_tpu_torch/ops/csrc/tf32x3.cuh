// fp32-accurate products on the tensor cores (sm_80 and later): three-pass
// TF32 through mma.sync m16n8k8, with the pieces that feed it (16-byte
// cp.async loads into shared memory). PTX inline assembly only.
//
// Each fp32 operand x is split in registers into big = tf32(x) and small =
// tf32(x - big) (cvt.rna: round to nearest, ties away from zero), and
// a.b is summed as small(a).big(b) + big(a).small(b) + big(a).big(b) into
// one fp32 accumulator; the small.small term (~2^-22 relative) is
// dropped. Each product then carries about 2^-21 relative error, against
// 2^-11 for one TF32 pass.
//
// Fragments of mma.sync.m16n8k8.row.col.f32.tf32.tf32.f32, with g = lane/4
// and t = lane%4 (PTX ISA, "Matrix fragments for mma.m16n8k8"):
//   A (16 x 8): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
//   B (8 x 8):  b0 (t, g), b1 (t + 4, g)
//   C (16 x 8): c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
// A C fragment is therefore the A fragment of the next product over the
// same 8 columns once k is permuted: a = {c0, c2, c1, c3} puts column 2t at
// k = t and column 2t + 1 at k = t + 4, and the B operand's rows are read
// in that order (row 2t for b0, 2t + 1 for b1): see b_rows_paired.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32x3 {

// ---- cp.async ------------------------------------------------------------

// 16 bytes from global to shared memory, or zeros when `bytes` is 0.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
    asm volatile(
        "cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
        :: "r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
           "l"(src), "r"(bytes)
        : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Waits until at most `kPending` of this thread's groups are in flight.
template <int kPending> __device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending) : "memory");
}

// ---- the split and the product ---------------------------------------------

__device__ __forceinline__ uint32_t to_tf32(float x) {
    uint32_t r;
    asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
    return r;
}

// x -> (big, small), both TF32 bit patterns.
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
    big = to_tf32(x);
    small = to_tf32(x - __uint_as_float(big));
}

template <int N>
__device__ __forceinline__ void split(const float (&x)[N], uint32_t (&big)[N],
                                      uint32_t (&small)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) split(x[i], big[i], small[i]);
}

// d += a.b, one TF32 pass.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a.b in three passes: the small terms first, the big one last.
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ab)[4],
                                     const uint32_t (&as)[4],
                                     const uint32_t (&bb)[2],
                                     const uint32_t (&bs)[2]) {
    mma(d, as, bb);
    mma(d, ab, bs);
    mma(d, ab, bb);
}

// ---- fragments from shared memory (row-major tiles, `ld` floats a row) ----

// The A fragment of rows [0, 16) and columns [k, k + 8) of `p`.
__device__ __forceinline__ void a_rows(const float* p, int ld, int k,
                                       float (&a)[4]) {
    const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
    const float* r = p + g * ld + k + t;
    a[0] = r[0];
    a[1] = r[8 * ld];
    a[2] = r[4];
    a[3] = r[8 * ld + 4];
}

// The B fragment of B = X^T (8 x 8) for rows [0, 8) and columns [k, k + 8)
// of X: b0 = X[g][k + t], b1 = X[g][k + t + 4].
__device__ __forceinline__ void b_cols(const float* p, int ld, int k,
                                       float (&b)[2]) {
    const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
    const float* r = p + g * ld + k + t;
    b[0] = r[0];
    b[1] = r[4];
}

// The B fragment of B = X (8 x 8) for rows [0, 8) and columns [n, n + 8)
// of X, rows in the order of an A fragment made from a C fragment: b0 =
// X[2t][n + g], b1 = X[2t + 1][n + g].
__device__ __forceinline__ void b_rows_paired(const float* p, int ld, int n,
                                              float (&b)[2]) {
    const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
    const float* r = p + 2 * t * ld + n + g;
    b[0] = r[0];
    b[1] = r[ld];
}

// The A fragment of the next product from a C fragment (see above).
__device__ __forceinline__ void c_to_a(const float (&c)[4], float (&a)[4]) {
    a[0] = c[0];
    a[1] = c[2];
    a[2] = c[1];
    a[3] = c[3];
}

}  // namespace tf32x3
