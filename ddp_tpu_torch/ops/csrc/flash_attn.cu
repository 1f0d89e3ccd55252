// Flash attention for Hopper: the forward, dQ and dK/dV kernels of the
// causal-LM training step, in bf16 (tensor cores) and fp32 (plain FMA).
//
// Replaces the TPU kernels of ddp_tpu/ops/flash.py:
//   B1 _flash_forward (:293) -> pl.pallas_call (:306) -> _fwd_kernel (:88)
//   B2 _flash_backward (:344) -> pl.pallas_call (:369) -> _dq_kernel (:152)
//   B3 _flash_backward (:344) -> pl.pallas_call (:389) -> _dkv_kernel (:209)
// flash_attn_fwd is B1, flash_attn_dq is B2, flash_attn_dkv is B3; each
// has a bf16 and an fp32 variant (one template, two element types).
//
// What bounds them on an H100: operations. At the training shape (B 8,
// T = S 2048, H 8, D 128, causal) B1 does 2 tile products per live
// (q-tile, k-tile) pair, B2 3 and B3 4: 69, 103 and 137 GFLOP, which at
// 989 TFLOP/s (dense bf16) take 69-139 us, against ~40 us for the bytes
// each input and output moves once. The design answers that only in
// part, on purpose (a right kernel first; wgmma/TMA is later work):
//   - the [T, S] score matrix never reaches device memory: one block
//     owns a q-tile (B1, B2) or a k-tile (B3), streams the other side's
//     tiles through shared memory and keeps its accumulators there in
//     fp32 (B1's output is rescaled row by row by the online softmax);
//   - bf16 products run on the tensor cores through WMMA (16x16x16,
//     fp32 accumulate), P and dS rounded to bf16 for their products as
//     usual for flash attention; fp32 uses plain FMA, not TF32, so it
//     matches the fp32 plain version to ~1e-6;
//   - causal tiles past the diagonal are never visited: B1/B2 loop over
//     k-tiles only up to the last live key of their q-tile, B3 starts at
//     the first q-tile that sees its keys; blocks with the most tiles are
//     scheduled first;
//   - two backward kernels and no atomics, so gradients are
//     deterministic;
//   - q/k/v/dO are read in place through their strides (the fused qkv
//     projection's views, token stride 3*H*D), 16 bytes per thread; the
//     TPU path's transpose to [B*H, T, D] has no counterpart;
//   - the ragged tail is masked in the kernel (zero-filled rows, masked
//     keys), so any T and S work: no whole-length block fallback.
// What it does not do yet: no cp.async/TMA double buffering (loads and
// products do not overlap), WMMA fragments are loaded from shared memory
// for every product, and one or two blocks fit on an SM.
//
// Masks and empty rows follow the TPU kernel: the causal mask is
// end-anchored (key <= t + S - T); a row with no live key gives out 0
// and lse -inf, and B2/B3 replace such an lse by 0.5 * FLT_MAX so that
// P = 0 there, not NaN.
//
// Build (a plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libflash_attn.so flash_attn.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;  // 8 warps per block
constexpr int kWarps = kThreads / 32;
constexpr int kMaxHeadDim = 128;
constexpr int kPad = 8;    // elements added to a row of a Q/K/V/P tile
constexpr int kPadF = 4;   // floats added to a row of an fp32 tile
constexpr float kBigLse = 0.5f * FLT_MAX;

// Tile rows per element type: 64 for bf16 (4 WMMA tiles a side), 32
// for fp32 (its FMA tiles keep the shared memory of B3 under 130 KB).
template <typename T> struct Tiles;
template <> struct Tiles<bf16> { static constexpr int BQ = 64, BK = 64; };
template <> struct Tiles<float> { static constexpr int BQ = 32, BK = 32; };

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
    return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
    return x;
}

// A [B, rows, H, D] view whose last dim is contiguous; strides in elements.
struct View {
    void* p;
    int64_t sb, st, sh;
};

struct Args {
    View q, k, v, o;   // o: the output (B1) or dO (B2, B3)
    View dq, dk, dv;   // gradients (B2: dq; B3: dk, dv)
    float* lse;        // [B, T, H]
    const float* delta;  // [B, T, H]: rowsum(dO * O) - dLSE
    int B, T, S, H, D, causal;
    float scale;
};

// ---- shared memory layout ------------------------------------------

__host__ __device__ inline size_t align128(size_t x) {
    return (x + 127) & ~static_cast<size_t>(127);
}

// Hands out 128-byte aligned buffers from one dynamic allocation; on
// the host (base == nullptr) it only counts the bytes.
struct Carver {
    unsigned char* base;
    size_t off = 0;
    template <typename U> __host__ __device__ U* take(size_t n) {
        U* p = reinterpret_cast<U*>(base + off);
        off = align128(off + n * sizeof(U));
        return p;
    }
};

template <typename T> struct FwdSmem {
    T *q, *k, *v, *p;
    float *s, *o, *m, *l;
    __host__ __device__ size_t carve(unsigned char* base, int D) {
        constexpr int BQ = Tiles<T>::BQ, BK = Tiles<T>::BK;
        Carver c{base};
        q = c.take<T>(BQ * (D + kPad));
        k = c.take<T>(BK * (D + kPad));
        v = c.take<T>(BK * (D + kPad));
        p = c.take<T>(BQ * (BK + kPad));
        s = c.take<float>(BQ * (BK + kPadF));
        o = c.take<float>(BQ * (D + kPadF));
        m = c.take<float>(BQ);
        l = c.take<float>(BQ);
        return c.off;
    }
};

template <typename T> struct DqSmem {
    T *q, *dout, *k, *v, *ds;
    float *s, *dp, *dq, *lse, *dl;
    __host__ __device__ size_t carve(unsigned char* base, int D) {
        constexpr int BQ = Tiles<T>::BQ, BK = Tiles<T>::BK;
        Carver c{base};
        q = c.take<T>(BQ * (D + kPad));
        dout = c.take<T>(BQ * (D + kPad));
        k = c.take<T>(BK * (D + kPad));
        v = c.take<T>(BK * (D + kPad));
        ds = c.take<T>(BQ * (BK + kPad));
        s = c.take<float>(BQ * (BK + kPadF));
        dp = c.take<float>(BQ * (BK + kPadF));
        dq = c.take<float>(BQ * (D + kPadF));
        lse = c.take<float>(BQ);
        dl = c.take<float>(BQ);
        return c.off;
    }
};

template <typename T> struct DkvSmem {
    T *k, *v, *q, *dout, *p, *ds;
    float *s, *dp, *dk, *dv, *lse, *dl;
    __host__ __device__ size_t carve(unsigned char* base, int D) {
        constexpr int BQ = Tiles<T>::BQ, BK = Tiles<T>::BK;
        Carver c{base};
        k = c.take<T>(BK * (D + kPad));
        v = c.take<T>(BK * (D + kPad));
        q = c.take<T>(BQ * (D + kPad));
        dout = c.take<T>(BQ * (D + kPad));
        p = c.take<T>(BQ * (BK + kPad));
        ds = c.take<T>(BQ * (BK + kPad));
        s = c.take<float>(BQ * (BK + kPadF));
        dp = c.take<float>(BQ * (BK + kPadF));
        dk = c.take<float>(BK * (D + kPadF));
        dv = c.take<float>(BK * (D + kPadF));
        lse = c.take<float>(BQ);
        dl = c.take<float>(BQ);
        return c.off;
    }
};

// ---- tiles and products in shared memory ---------------------------

// Rows [r0, r0 + R) of one (b, h) slice into dst[R][ld], 16 bytes per
// thread per load; rows at or past `rows` are zero.
template <typename T>
__device__ void load_rows(T* dst, int ld, const T* src, int64_t st, int r0,
                          int R, int rows, int D) {
    constexpr int V = 16 / sizeof(T);
    const int chunks = D / V;
    for (int i = threadIdx.x; i < R * chunks; i += kThreads) {
        const int r = i / chunks;
        const int c = (i - r * chunks) * V;
        uint4 x = make_uint4(0u, 0u, 0u, 0u);
        if (r0 + r < rows)
            x = *reinterpret_cast<const uint4*>(src + (r0 + r) * st + c);
        *reinterpret_cast<uint4*>(dst + r * ld + c) = x;
    }
}

__device__ void zero(float* dst, int n) {
    for (int i = threadIdx.x; i < n; i += kThreads) dst[i] = 0.f;
}

// Offsets of element (m, k) of A [M x K] and (k, n) of B [K x N], each
// stored row-major or column-major (a transposed tile is read in place).
template <bool kCol> __device__ __forceinline__ int a_off(int m, int k, int ld) {
    return kCol ? m + k * ld : m * ld + k;
}
template <bool kCol> __device__ __forceinline__ int b_off(int k, int n, int ld) {
    return kCol ? k + n * ld : k * ld + n;
}

// C [M x N] fp32 (row-major, ldc) = (accumulate ? C : 0) + A . B.
// bf16: WMMA 16x16x16 on the tensor cores, one output tile per warp per
// pass (M, N, K multiples of 16).
template <bool kColA, bool kColB>
__device__ void gemm(const bf16* A, int lda, const bf16* B, int ldb, float* C,
                     int ldc, int M, int N, int K, bool accumulate) {
    using LA = typename std::conditional<kColA, wmma::col_major,
                                         wmma::row_major>::type;
    using LB = typename std::conditional<kColB, wmma::col_major,
                                         wmma::row_major>::type;
    const int warp = threadIdx.x >> 5;
    const int tiles_n = N / 16;
    for (int t = warp; t < (M / 16) * tiles_n; t += kWarps) {
        const int m0 = (t / tiles_n) * 16;
        const int n0 = (t % tiles_n) * 16;
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
        if (accumulate)
            wmma::load_matrix_sync(c, C + m0 * ldc + n0, ldc, wmma::mem_row_major);
        else
            wmma::fill_fragment(c, 0.f);
        for (int k0 = 0; k0 < K; k0 += 16) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, LA> a;
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, LB> b;
            wmma::load_matrix_sync(a, A + a_off<kColA>(m0, k0, lda), lda);
            wmma::load_matrix_sync(b, B + b_off<kColB>(k0, n0, ldb), ldb);
            wmma::mma_sync(c, a, b, c);
        }
        wmma::store_matrix_sync(C + m0 * ldc + n0, c, ldc, wmma::mem_row_major);
    }
}

// fp32: plain FMA, one output per thread per pass.
template <bool kColA, bool kColB>
__device__ void gemm(const float* A, int lda, const float* B, int ldb,
                     float* C, int ldc, int M, int N, int K, bool accumulate) {
    for (int i = threadIdx.x; i < M * N; i += kThreads) {
        const int m = i / N;
        const int n = i - m * N;
        float acc = accumulate ? C[m * ldc + n] : 0.f;
#pragma unroll 4
        for (int k = 0; k < K; ++k)
            acc = fmaf(A[a_off<kColA>(m, k, lda)], B[b_off<kColB>(k, n, ldb)], acc);
        C[m * ldc + n] = acc;
    }
}

template <typename T>
__device__ __forceinline__ const T* slice(const View& x, int b, int h) {
    return static_cast<const T*>(x.p) + b * x.sb + h * x.sh;
}
template <typename T>
__device__ __forceinline__ T* slice_out(const View& x, int b, int h) {
    return static_cast<T*>(x.p) + b * x.sb + h * x.sh;
}

// Key `key` is live for query row t (both in range, end-anchored mask).
__device__ __forceinline__ bool live(int t, int key, const Args& a) {
    return t < a.T && key < a.S && (!a.causal || key <= t + a.S - a.T);
}

// Per-row statistics of B2/B3: lse (non-finite -> 0.5 FLT_MAX, so that
// P = 0) and delta' for rows [q0, q0 + R); rows past T get lse big.
__device__ void load_row_stats(float* lse_s, float* dl_s, const Args& a,
                               int b, int h, int q0, int R) {
    for (int r = threadIdx.x; r < R; r += kThreads) {
        const int t = q0 + r;
        float lse = kBigLse, dl = 0.f;
        if (t < a.T) {
            const int64_t i = (static_cast<int64_t>(b) * a.T + t) * a.H + h;
            lse = a.lse[i];
            if (!isfinite(lse)) lse = kBigLse;
            dl = a.delta[i];
        }
        lse_s[r] = lse;
        dl_s[r] = dl;
    }
}

// ---- B1: forward ----------------------------------------------------

// grid (B*H, q-tiles): the last q-tile (most live k-tiles) first.
template <typename T>
__global__ void __launch_bounds__(kThreads) fwd_kernel(Args a) {
    constexpr int BQ = Tiles<T>::BQ, BK = Tiles<T>::BK;
    extern __shared__ __align__(128) unsigned char smem[];
    FwdSmem<T> sm;
    sm.carve(smem, a.D);
    const int D = a.D, ldt = D + kPad, lds = BK + kPadF, ldp = BK + kPad,
              ldo = D + kPadF;
    const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
    const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int kv_end = a.causal ? min(a.S, q0 + BQ + a.S - a.T) : a.S;

    load_rows(sm.q, ldt, slice<T>(a.q, b, h), a.q.st, q0, BQ, a.T, D);
    zero(sm.o, BQ * ldo);
    for (int r = threadIdx.x; r < BQ; r += kThreads) {
        sm.m[r] = -INFINITY;
        sm.l[r] = 0.f;
    }
    const T* kb = slice<T>(a.k, b, h);
    const T* vb = slice<T>(a.v, b, h);
    for (int k0 = 0; k0 < kv_end; k0 += BK) {
        __syncthreads();  // the previous tile's products are done
        load_rows(sm.k, ldt, kb, a.k.st, k0, BK, a.S, D);
        load_rows(sm.v, ldt, vb, a.v.st, k0, BK, a.S, D);
        __syncthreads();
        gemm<false, true>(sm.q, ldt, sm.k, ldt, sm.s, lds, BQ, BK, D, false);
        __syncthreads();
        // Online softmax, one warp per row.
        for (int r = warp; r < BQ; r += kWarps) {
            const int t = q0 + r;
            float* srow = sm.s + r * lds;
            float mx = -INFINITY;
            for (int c = lane; c < BK; c += 32) {
                const float x = live(t, k0 + c, a) ? srow[c] * a.scale : -INFINITY;
                srow[c] = x;
                mx = fmaxf(mx, x);
            }
            mx = warp_max(mx);
            const float m_old = sm.m[r];
            const float m_new = fmaxf(m_old, mx);
            // A row with no live key yet: exp(-inf - -inf) would be NaN.
            const float shift = isfinite(m_new) ? m_new : 0.f;
            float sum = 0.f;
            for (int c = lane; c < BK; c += 32) {
                const float e = expf(srow[c] - shift);
                sm.p[r * ldp + c] = from_f<T>(e);
                sum += e;
            }
            sum = warp_sum(sum);
            const float corr = isfinite(m_old) ? expf(m_old - shift) : 0.f;
            for (int d = lane; d < D; d += 32) sm.o[r * ldo + d] *= corr;
            if (lane == 0) {
                sm.m[r] = m_new;
                sm.l[r] = sm.l[r] * corr + sum;
            }
        }
        __syncthreads();
        gemm<false, false>(sm.p, ldp, sm.v, ldt, sm.o, ldo, BQ, D, BK, true);
    }
    __syncthreads();
    T* ob = slice_out<T>(a.o, b, h);
    for (int i = threadIdx.x; i < BQ * D; i += kThreads) {
        const int r = i / D, d = i - r * D;
        if (q0 + r < a.T)
            ob[(q0 + r) * a.o.st + d] =
                from_f<T>(sm.o[r * ldo + d] / fmaxf(sm.l[r], 1e-30f));
    }
    for (int r = threadIdx.x; r < BQ; r += kThreads) {
        const int t = q0 + r;
        if (t >= a.T) continue;
        const float l = sm.l[r], m = sm.m[r];
        a.lse[(static_cast<int64_t>(b) * a.T + t) * a.H + h] =
            l > 0.f ? (isfinite(m) ? m : 0.f) + logf(fmaxf(l, 1e-30f)) : -INFINITY;
    }
}

// ---- B2: dQ ------------------------------------------------------------

// dS = P * (dO.V^T - delta'), P = exp(scale * Q.K^T - lse) (0 where
// masked), into ds (element type) and, for B3, P into p.
template <typename T>
__device__ void scores_to_ds(const float* s, const float* dp, int lds,
                             const float* lse_s, const float* dl_s, T* p,
                             T* ds, int ldp, int q0, int k0, int BQ, int BK,
                             const Args& a) {
    for (int i = threadIdx.x; i < BQ * BK; i += kThreads) {
        const int r = i / BK, c = i - r * BK;
        const float pv = live(q0 + r, k0 + c, a)
                             ? expf(s[r * lds + c] * a.scale - lse_s[r])
                             : 0.f;
        if (p) p[r * ldp + c] = from_f<T>(pv);
        ds[r * ldp + c] = from_f<T>(pv * (dp[r * lds + c] - dl_s[r]));
    }
}

// grid (B*H, q-tiles): the last q-tile first.
template <typename T>
__global__ void __launch_bounds__(kThreads) dq_kernel(Args a) {
    constexpr int BQ = Tiles<T>::BQ, BK = Tiles<T>::BK;
    extern __shared__ __align__(128) unsigned char smem[];
    DqSmem<T> sm;
    sm.carve(smem, a.D);
    const int D = a.D, ldt = D + kPad, lds = BK + kPadF, ldp = BK + kPad,
              ldo = D + kPadF;
    const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
    const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
    const int kv_end = a.causal ? min(a.S, q0 + BQ + a.S - a.T) : a.S;

    load_rows(sm.q, ldt, slice<T>(a.q, b, h), a.q.st, q0, BQ, a.T, D);
    load_rows(sm.dout, ldt, slice<T>(a.o, b, h), a.o.st, q0, BQ, a.T, D);
    load_row_stats(sm.lse, sm.dl, a, b, h, q0, BQ);
    zero(sm.dq, BQ * ldo);
    const T* kb = slice<T>(a.k, b, h);
    const T* vb = slice<T>(a.v, b, h);
    for (int k0 = 0; k0 < kv_end; k0 += BK) {
        __syncthreads();
        load_rows(sm.k, ldt, kb, a.k.st, k0, BK, a.S, D);
        load_rows(sm.v, ldt, vb, a.v.st, k0, BK, a.S, D);
        __syncthreads();
        gemm<false, true>(sm.q, ldt, sm.k, ldt, sm.s, lds, BQ, BK, D, false);
        gemm<false, true>(sm.dout, ldt, sm.v, ldt, sm.dp, lds, BQ, BK, D, false);
        __syncthreads();
        scores_to_ds<T>(sm.s, sm.dp, lds, sm.lse, sm.dl, nullptr, sm.ds, ldp,
                        q0, k0, BQ, BK, a);
        __syncthreads();
        gemm<false, false>(sm.ds, ldp, sm.k, ldt, sm.dq, ldo, BQ, D, BK, true);
    }
    __syncthreads();
    T* out = slice_out<T>(a.dq, b, h);
    for (int i = threadIdx.x; i < BQ * D; i += kThreads) {
        const int r = i / D, d = i - r * D;
        if (q0 + r < a.T)
            out[(q0 + r) * a.dq.st + d] = from_f<T>(sm.dq[r * ldo + d] * a.scale);
    }
}

// ---- B3: dK, dV ---------------------------------------------------------

// grid (B*H, k-tiles): the first k-tile (most live q-tiles) first.
template <typename T>
__global__ void __launch_bounds__(kThreads) dkv_kernel(Args a) {
    constexpr int BQ = Tiles<T>::BQ, BK = Tiles<T>::BK;
    extern __shared__ __align__(128) unsigned char smem[];
    DkvSmem<T> sm;
    sm.carve(smem, a.D);
    const int D = a.D, ldt = D + kPad, lds = BK + kPadF, ldp = BK + kPad,
              ldo = D + kPadF;
    const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
    const int k0 = blockIdx.y * BK;
    // The first query row that sees key k0 is k0 - (S - T).
    const int q_lo = a.causal ? max(0, k0 - (a.S - a.T)) : 0;

    load_rows(sm.k, ldt, slice<T>(a.k, b, h), a.k.st, k0, BK, a.S, D);
    load_rows(sm.v, ldt, slice<T>(a.v, b, h), a.v.st, k0, BK, a.S, D);
    zero(sm.dk, BK * ldo);
    zero(sm.dv, BK * ldo);
    const T* qb = slice<T>(a.q, b, h);
    const T* db = slice<T>(a.o, b, h);
    for (int q0 = (q_lo / BQ) * BQ; q0 < a.T; q0 += BQ) {
        __syncthreads();
        load_rows(sm.q, ldt, qb, a.q.st, q0, BQ, a.T, D);
        load_rows(sm.dout, ldt, db, a.o.st, q0, BQ, a.T, D);
        load_row_stats(sm.lse, sm.dl, a, b, h, q0, BQ);
        __syncthreads();
        gemm<false, true>(sm.q, ldt, sm.k, ldt, sm.s, lds, BQ, BK, D, false);
        gemm<false, true>(sm.dout, ldt, sm.v, ldt, sm.dp, lds, BQ, BK, D, false);
        __syncthreads();
        scores_to_ds<T>(sm.s, sm.dp, lds, sm.lse, sm.dl, sm.p, sm.ds, ldp, q0,
                        k0, BQ, BK, a);
        __syncthreads();
        // dV += P^T . dO and dK += dS^T . Q: P and dS read transposed.
        gemm<true, false>(sm.p, ldp, sm.dout, ldt, sm.dv, ldo, BK, D, BQ, true);
        gemm<true, false>(sm.ds, ldp, sm.q, ldt, sm.dk, ldo, BK, D, BQ, true);
    }
    __syncthreads();
    T* dkb = slice_out<T>(a.dk, b, h);
    T* dvb = slice_out<T>(a.dv, b, h);
    for (int i = threadIdx.x; i < BK * D; i += kThreads) {
        const int r = i / D, d = i - r * D;
        if (k0 + r < a.S) {
            dkb[(k0 + r) * a.dk.st + d] = from_f<T>(sm.dk[r * ldo + d] * a.scale);
            dvb[(k0 + r) * a.dv.st + d] = from_f<T>(sm.dv[r * ldo + d]);
        }
    }
}

// ---- launch ---------------------------------------------------------

enum Kernel { kFwd = 0, kDq = 1, kDkv = 2 };

template <typename T> size_t smem_bytes(int kernel, int D) {
    switch (kernel) {
        case kFwd: { FwdSmem<T> s; return s.carve(nullptr, D); }
        case kDq: { DqSmem<T> s; return s.carve(nullptr, D); }
        default: { DkvSmem<T> s; return s.carve(nullptr, D); }
    }
}

View view(const void* p, const int64_t* st) {
    return View{const_cast<void*>(p), st[0], st[1], st[2]};
}

template <typename T>
int launch(int kernel, Args a, void* stream) {
    if (a.B < 1 || a.H < 1 || a.T < 1 || a.S < 1 || a.D < 16 ||
        a.D > kMaxHeadDim || a.D % 16 != 0 ||
        static_cast<int64_t>(a.B) * a.H > 0x7fffffff) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const int rows = kernel == kDkv ? a.S : a.T;
    const int tile = kernel == kDkv ? Tiles<T>::BK : Tiles<T>::BQ;
    const int tiles = (rows + tile - 1) / tile;
    if (tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid(a.B * a.H, tiles);
    const size_t smem = smem_bytes<T>(kernel, a.D);
    void (*fn)(Args) = kernel == kFwd  ? fwd_kernel<T>
                       : kernel == kDq ? dq_kernel<T>
                                       : dkv_kernel<T>;
    // Above 48 KB of dynamic shared memory only after an explicit opt-in.
    cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    fn<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
    return static_cast<int>(cudaGetLastError());
}

int dispatch(int is_bf16, int kernel, const Args& a, void* stream) {
    return is_bf16 ? launch<bf16>(kernel, a, stream)
                   : launch<float>(kernel, a, stream);
}

Args base_args(int B, int T, int S, int H, int D, int causal, float scale) {
    Args a{};
    a.B = B; a.T = T; a.S = S; a.H = H; a.D = D; a.causal = causal;
    a.scale = scale;
    return a;
}

}  // namespace

extern "C" {

// Shared memory one block of `kernel` (0 fwd, 1 dq, 2 dkv) needs (bytes).
size_t flash_attn_smem_bytes(int kernel, int is_bf16, int D) {
    return is_bf16 ? smem_bytes<bf16>(kernel, D) : smem_bytes<float>(kernel, D);
}

// B1. q [B,T,H,D], k/v [B,S,H,D] -> out [B,T,H,D] (input dtype), lse
// [B,T,H] fp32 (contiguous). `strides` holds (b, t, h) element strides
// of q, k, v, out; the last dim of every view is contiguous. Returns
// cudaGetLastError() after the launch (0 = launched).
int flash_attn_fwd(int is_bf16, const void* q, const void* k, const void* v,
                   void* out, void* lse, int B, int T, int S, int H, int D,
                   int causal, float scale, const int64_t* strides,
                   void* stream) {
    Args a = base_args(B, T, S, H, D, causal, scale);
    a.q = view(q, strides);
    a.k = view(k, strides + 3);
    a.v = view(v, strides + 6);
    a.o = view(out, strides + 9);
    a.lse = static_cast<float*>(lse);
    return dispatch(is_bf16, kFwd, a, stream);
}

// B2. + dout [B,T,H,D], lse and delta [B,T,H] fp32 -> dq [B,T,H,D].
// `strides`: q, k, v, dout, dq.
int flash_attn_dq(int is_bf16, const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* delta,
                  void* dq, int B, int T, int S, int H, int D, int causal,
                  float scale, const int64_t* strides, void* stream) {
    Args a = base_args(B, T, S, H, D, causal, scale);
    a.q = view(q, strides);
    a.k = view(k, strides + 3);
    a.v = view(v, strides + 6);
    a.o = view(dout, strides + 9);
    a.dq = view(dq, strides + 12);
    a.lse = const_cast<float*>(static_cast<const float*>(lse));
    a.delta = static_cast<const float*>(delta);
    return dispatch(is_bf16, kDq, a, stream);
}

// B3. -> dk, dv [B,S,H,D]. `strides`: q, k, v, dout, dk, dv.
int flash_attn_dkv(int is_bf16, const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dk, void* dv, int B, int T, int S, int H, int D,
                   int causal, float scale, const int64_t* strides,
                   void* stream) {
    Args a = base_args(B, T, S, H, D, causal, scale);
    a.q = view(q, strides);
    a.k = view(k, strides + 3);
    a.v = view(v, strides + 6);
    a.o = view(dout, strides + 9);
    a.dk = view(dk, strides + 12);
    a.dv = view(dv, strides + 15);
    a.lse = const_cast<float*>(static_cast<const float*>(lse));
    a.delta = static_cast<const float*>(delta);
    return dispatch(is_bf16, kDkv, a, stream);
}

}  // extern "C"
