// Flash-decode for Hopper: single-query banded attention over the
// serving engine's fixed-lane KV cache, fp32 or int8 K/V.
//
// Replaces the TPU kernel of ddp_tpu/ops/decode.py:
//   flash_decode_attention -> pl.pallas_call (decode.py:242)
//     -> _plain_kernel (:260) / _quantized_kernel (:270) -> _decode_body (:280)
// B4 is flash_decode_fp32, B5 is flash_decode_int8 (one template, two
// K/V element types).
//
// What bounds it on an H100: the bytes of K/V it reads. One call reads
// each live cache line once (S lanes x min(pos+1, L) keys x H_kv x Dh x 2
// tensors) and does 4 operations per (K, V) element pair and query head:
// 0.5 operations a byte in fp32 and 2 in int8, times G = H / H_kv, where
// the card does ~20 fp32 operations per byte of memory. So MHA and small
// G are bound by bytes; int8 with G >= 10 by operations.
//
// The design (flash-decoding):
//   - split-K over the cache: the grid is (chunk, kv head x query-head
//     block, lane). The host picks the chunk length from L and the SM
//     count (ops/decode.py split_plan), so that even the serving shape
//     (64 lane-head pairs) fills the card. A CTA whose chunk starts past
//     its lane's band (key > pos[s], pos read from device memory) exits
//     before it reads anything: the band skip stays on the device;
//   - each chunk leaves a partial (o, lse) in fp32, and a second small
//     kernel merges each (lane, head block)'s live chunks in chunk order
//     by the lse identity of parallel/ring.combine_attention_partials (no
//     float atomics: the result is the same bits on every run). A merge by
//     the last CTA to finish, found through a counter, in the same launch
//     measured slower (its fence and serial tail; PERF.md);
//   - 16-byte loads: a K/V row is split over R = Dh/16 (rounded up to a
//     power of two) threads of a "row group", 16 head-dim columns each
//     (four float4 of fp32, or one 16-byte vector of int8), so a warp
//     holds 32/R rows. The dot products reduce over the R threads of a
//     row by shuffles. Each row group keeps its own online-softmax state
//     and P.V accumulators for its columns; the row groups and warps are
//     merged through shared memory once per chunk, not per tile;
//   - a cp.async ring of kStages tiles of K and V (and, for int8, the
//     tile's per-key scales, loaded once per tile): the next tiles are in
//     flight while tile j is computed (3 stages of 32 KB in fp32, 2 of
//     20 KB in int8, the faster depths measured). Rows past the band are
//     not read: their slots are zero-filled;
//   - int8 rows stay int8 in device memory and shared memory and are
//     widened in registers (a byte permute into a float's mantissa, then
//     one subtraction: exact, and four times the rate of I2F); a key's K
//     scale multiplies its dot product once, its V scale its weight once;
//   - the G query heads of a kv head share every K/V row read (up to 4 a
//     CTA; more take further CTAs, whose reads hit L2);
//   - online softmax in fp32 in base 2 (q pre-scaled by log2(e) / sqrt(Dh),
//     ex2.approx), with the isfinite shift guard of decode.py:317, and the
//     divide by max(l, 1e-30), per chunk and after the merge;
//   - the cache is read in place through its strides, one layer's
//     [S, L, H_kv, Dh] slice; any L (the ragged tail is masked).
// CUDA cores, not tensor cores: one query row a head gives no product
// worth a tensor-core tile.
//
// Limits (ops/decode.py kernel_takes routes other shapes to the plain
// version): Dh <= 256, Dh % 4 == 0 (fp32) or % 16 == 0 (int8); K/V row
// strides and base on 16-byte boundaries.
//
// Build (a plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libflash_decode.so flash_decode.cu

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;           // 4 warps a CTA
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 16;               // head-dim columns a thread owns
constexpr int kMaxHeadDim = 256;        // R = Dh / 16 <= 16 threads a row
constexpr int kCopyBytes = 16;          // bytes one cp.async moves
constexpr int kMaxGroup = 4;            // query heads a CTA serves
constexpr float kLog2e = 1.4426950408889634f;

// kKeys: keys a row group takes from each tile, so a tile is kKeys x
// (kThreads / R) keys, kKeys x 2048 elements of K and as many of V,
// whatever Dh is. kStages: the depth of the cp.async ring.
template <typename KV> struct Traits;
template <> struct Traits<float> {
    static constexpr int kKeys = 2;
    static constexpr int kStages = 3;
    static constexpr bool kScaled = false;
};
template <> struct Traits<int8_t> {
    static constexpr int kKeys = 4;
    static constexpr int kStages = 2;
    static constexpr bool kScaled = true;
};

template <typename KV> __host__ __device__ constexpr int tile_elems() {
    return Traits<KV>::kKeys * kThreads * kCols;
}
// One ring stage: the K tile, the V tile, and for int8 the two tiles'
// per-key scales (room for the most keys a tile has, at R = 1).
template <typename KV> __host__ __device__ constexpr int stage_bytes() {
    return 2 * tile_elems<KV>() * static_cast<int>(sizeof(KV)) +
           (Traits<KV>::kScaled ? 2 * Traits<KV>::kKeys * kThreads * 4 : 0);
}
// The end-of-chunk merge of the warps reuses stage 0.
static_assert(kWarps * kMaxGroup * (kCols * 16 + 2) * 4 <= stage_bytes<int8_t>(),
              "the warp merge must fit one ring stage");

struct Params {
    const float* q;
    const void* k;
    const void* v;
    const float* k_scale;
    const float* v_scale;
    const int32_t* pos;
    float* out;
    float* part_o;    // [S, Y, n_chunks, GT, Dh], Y = H_kv x n_gb
    float* part_lse;  // [S, Y, n_chunks, GT], base 2
    int H, G, Dh, L;
    int R, log2R;     // threads a row, and its log2
    int chunk;        // keys a chunk, a multiple of the tile
    int n_chunks, n_gb, Y;
    int64_t q_ss, q_sh, kv_ss, kv_sl, kv_sh, sc_ss, sc_sl, sc_sh;
    float scale;      // log2(e) / sqrt(Dh)
};

// ---- small device helpers ---------------------------------------------------

template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool ok) {
    const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
    const int n = ok ? N : 0;  // 0: zero-fill, read nothing
    if constexpr (N == 16) {
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                     :: "r"(d), "l"(src), "r"(n) : "memory");
    } else {
        asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                     :: "r"(d), "l"(src), "n"(N), "r"(n) : "memory");
    }
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending> __device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending) : "memory");
}

__device__ __forceinline__ float ex2(float x) {  // ex2(-inf) = 0
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

// Weight of a state whose max is m, under a common shift: 0 for an empty
// state (m = -inf), as the isfinite guard of decode.py:317 gives.
__device__ __forceinline__ float weight(float m, float shift) {
    return isfinite(m) ? ex2(m - shift) : 0.f;
}
__device__ __forceinline__ float shift_of(float m) {
    return isfinite(m) ? m : 0.f;
}

// Head-dim column of a thread's element e (0..15), t = its place in the
// row group. fp32: four float4 at 4(t + R i), so the R threads of a row
// read 16 R contiguous bytes per load; int8: one 16-byte vector at 16 t.
template <typename KV> __device__ __forceinline__ int col_of(int t, int R, int e);
template <> __device__ __forceinline__ int col_of<float>(int t, int R, int e) {
    return 4 * (t + R * (e >> 2)) + (e & 3);
}
template <> __device__ __forceinline__ int col_of<int8_t>(int t, int, int e) {
    return 16 * t + e;
}

// A thread's 16 elements of one shared-memory row, as floats; columns
// past Dh give 0. int8 is widened exactly: the byte, offset by 128, is put
// in the mantissa of 2^23 by a byte permute, and 2^23 + 128 subtracted.
__device__ __forceinline__ void load_row(const float* row, int t, int R,
                                         int Dh, float (&f)[kCols]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int c = 4 * (t + R * i);
        const float4 x = c < Dh ? *reinterpret_cast<const float4*>(row + c)
                                : make_float4(0.f, 0.f, 0.f, 0.f);
        f[4 * i] = x.x;
        f[4 * i + 1] = x.y;
        f[4 * i + 2] = x.z;
        f[4 * i + 3] = x.w;
    }
}
__device__ __forceinline__ void load_row(const int8_t* row, int t, int,
                                         int Dh, float (&f)[kCols]) {
    const int c = 16 * t;
    const int4 x = c < Dh ? *reinterpret_cast<const int4*>(row + c)
                          : make_int4(0, 0, 0, 0);
    const uint32_t w[4] = {static_cast<uint32_t>(x.x), static_cast<uint32_t>(x.y),
                           static_cast<uint32_t>(x.z), static_cast<uint32_t>(x.w)};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const uint32_t u = w[i] ^ 0x80808080u;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
            f[4 * i + b] =
                __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540u | b)) -
                8388736.f;
        }
    }
}

// ---- the merge of a (lane, head block)'s chunks -------------------------------

// out = sum_c w_c o_c / max(sum_c w_c, 1e-30), w_c = 2^(lse_c - max lse),
// over the live chunks in chunk order (fixed: the same bits every run).
template <int GT>
__device__ void merge_chunks(const Params& p, int s, int y, int n_live) {
    const int kvh = y / p.n_gb;
    const int g0 = (y - kvh * p.n_gb) * GT;
    const int g_valid = min(GT, p.G - g0);
    const int64_t base = (static_cast<int64_t>(s) * p.Y + y) * p.n_chunks;
    const float* po = p.part_o + base * GT * p.Dh;
    const float* pl = p.part_lse + base * GT;
    float* ob = p.out + (static_cast<int64_t>(s) * p.H + kvh * p.G + g0) * p.Dh;
    for (int i = threadIdx.x; i < g_valid * p.Dh; i += blockDim.x) {
        const int g = i / p.Dh;
        const int d = i - g * p.Dh;
        float mx = -INFINITY;
        for (int c = 0; c < n_live; ++c) mx = fmaxf(mx, pl[c * GT + g]);
        const float sh = shift_of(mx);
        float num = 0.f, den = 0.f;
        for (int c = 0; c < n_live; ++c) {
            const float w = weight(pl[c * GT + g], sh);
            num = fmaf(w, po[(c * GT + g) * p.Dh + d], num);
            den += w;
        }
        ob[i] = num / fmaxf(den, 1e-30f);
    }
}

__device__ __forceinline__ int live_keys(const Params& p, int s) {
    // The lane's band: keys 0..pos[s]; an idle lane parked at the position
    // ceiling (pos == L) sees every key.
    return max(0, min(p.pos[s] + 1, p.L));
}

__device__ __forceinline__ int live_chunks(const Params& p, int n_keys) {
    // Chunk 0 always runs (with no key when pos < 0: out 0, as the TPU
    // kernel gives).
    return max(1, (n_keys + p.chunk - 1) / p.chunk);
}

// ---- the split kernel ------------------------------------------------------------

// grid (n_chunks, H_kv x n_gb, S), kThreads threads; dynamic shared
// memory: min(kStages, tiles a chunk) ring stages.
template <typename KV, int GT>
__global__ void __launch_bounds__(kThreads) flash_decode_split(const Params p) {
    using T_ = Traits<KV>;
    constexpr int kKeys = T_::kKeys;
    constexpr int kStages = T_::kStages;
    extern __shared__ __align__(16) unsigned char smem[];

    const int chunk_id = blockIdx.x;
    const int y = blockIdx.y;
    const int s = blockIdx.z;
    const int kvh = y / p.n_gb;
    const int g0 = (y - kvh * p.n_gb) * GT;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int R = p.R;
    const int t = lane & (R - 1);
    const int rg = tid >> p.log2R;         // row group
    const int NR = kThreads >> p.log2R;    // row groups a CTA
    const int T = kKeys * NR;              // keys a tile
    const int pitch = kCols * R;           // elements a shared-memory row
    const int Dh = p.Dh;

    const int n_keys = live_keys(p, s);
    const int n_live = live_chunks(p, n_keys);
    if (chunk_id >= n_live) return;  // past the band: nothing to read
    const int c0 = chunk_id * p.chunk;
    const int c1 = min(c0 + p.chunk, n_keys);
    const int n_tiles = c1 > c0 ? (c1 - c0 + T - 1) / T : 0;

    // q, pre-scaled, in registers: this thread's columns of each head.
    float qr[GT][kCols];
#pragma unroll
    for (int g = 0; g < GT; ++g) {
        const bool ok = g0 + g < p.G;
        const float* qrow = p.q + s * p.q_ss +
                            static_cast<int64_t>(kvh * p.G + g0 + g) * p.q_sh;
#pragma unroll
        for (int e = 0; e < kCols; ++e) {
            const int c = col_of<KV>(t, R, e);
            qr[g][e] = ok && c < Dh ? qrow[c] * p.scale : 0.f;
        }
    }

    float m[GT], l[GT], acc[GT][kCols];
#pragma unroll
    for (int g = 0; g < GT; ++g) {
        m[g] = -INFINITY;
        l[g] = 0.f;
#pragma unroll
        for (int e = 0; e < kCols; ++e) acc[g][e] = 0.f;
    }

    const KV* kb = static_cast<const KV*>(p.k) + s * p.kv_ss + kvh * p.kv_sh;
    const KV* vb = static_cast<const KV*>(p.v) + s * p.kv_ss + kvh * p.kv_sh;
    const float* ksb = T_::kScaled ? p.k_scale + s * p.sc_ss + kvh * p.sc_sh : nullptr;
    const float* vsb = T_::kScaled ? p.v_scale + s * p.sc_ss + kvh * p.sc_sh : nullptr;

    // Copies of one tile into a ring stage: chunks of kCopyBytes, each
    // row padded to `pitch` elements (padding columns are not copied).
    constexpr int kPerCopy = kCopyBytes / static_cast<int>(sizeof(KV));
    const int per_row = pitch / kPerCopy;  // a power of two
    const int live_row = Dh / kPerCopy;
    const int log2_per_row = __ffs(per_row) - 1;
    auto load_tile = [&](int j, int stage) {
        KV* k_s = reinterpret_cast<KV*>(smem + stage * stage_bytes<KV>());
        KV* v_s = k_s + tile_elems<KV>();
        const int key0 = c0 + j * T;
        for (int i = tid; i < T * per_row; i += kThreads) {
            const int r = i >> log2_per_row;
            const int cc = i & (per_row - 1);
            if (cc >= live_row) continue;
            const int key = key0 + r;
            const bool ok = key < c1;
            const int64_t off = static_cast<int64_t>(ok ? key : c0) * p.kv_sl +
                                cc * kPerCopy;
            cp_async<kCopyBytes>(k_s + r * pitch + cc * kPerCopy, kb + off, ok);
            cp_async<kCopyBytes>(v_s + r * pitch + cc * kPerCopy, vb + off, ok);
        }
        if constexpr (T_::kScaled) {
            float* ks_s = reinterpret_cast<float*>(v_s + tile_elems<KV>());
            float* vs_s = ks_s + kKeys * kThreads;
            for (int r = tid; r < T; r += kThreads) {
                const int key = key0 + r;
                const bool ok = key < c1;
                const int64_t off = static_cast<int64_t>(ok ? key : c0) * p.sc_sl;
                cp_async<4>(ks_s + r, ksb + off, ok);
                cp_async<4>(vs_s + r, vsb + off, ok);
            }
        }
    };

    // The ring: tiles 0..kStages-2 in flight before the loop; at step j,
    // tile j + kStages - 1 goes into the stage tile j - 1 has left.
#pragma unroll
    for (int st = 0; st < kStages - 1; ++st) {
        if (st < n_tiles) load_tile(st, st);
        cp_async_commit();
    }
    for (int j = 0; j < n_tiles; ++j) {
        if constexpr (kStages == 1) {
            __syncthreads();
            load_tile(j, 0);
            cp_async_commit();
            cp_async_wait<0>();
        } else {
            cp_async_wait<kStages - 2>();
        }
        __syncthreads();
        if constexpr (kStages > 1) {
            if (j + kStages - 1 < n_tiles) load_tile(j + kStages - 1, (j + kStages - 1) % kStages);
            cp_async_commit();
        }
        const int stage = kStages == 1 ? 0 : j % kStages;
        const KV* k_s = reinterpret_cast<const KV*>(smem + stage * stage_bytes<KV>());
        const KV* v_s = k_s + tile_elems<KV>();
        const float* ks_s = reinterpret_cast<const float*>(v_s + tile_elems<KV>());
        const float* vs_s = ks_s + kKeys * kThreads;
        const int key0 = c0 + j * T;

        // Scores of this row group's kKeys keys, for every query head.
        float sc[kKeys][GT];
#pragma unroll
        for (int kk = 0; kk < kKeys; ++kk) {
            float kf[kCols];
            load_row(k_s + (rg + kk * NR) * pitch, t, R, Dh, kf);
#pragma unroll
            for (int g = 0; g < GT; ++g) {
                float d = 0.f;
#pragma unroll
                for (int e = 0; e < kCols; ++e) d = fmaf(qr[g][e], kf[e], d);
                sc[kk][g] = d;
            }
        }
        for (int o = R >> 1; o > 0; o >>= 1) {
#pragma unroll
            for (int kk = 0; kk < kKeys; ++kk)
#pragma unroll
                for (int g = 0; g < GT; ++g)
                    sc[kk][g] += __shfl_xor_sync(0xffffffffu, sc[kk][g], o);
        }
        float vsc[kKeys];
#pragma unroll
        for (int kk = 0; kk < kKeys; ++kk) {
            const int r = rg + kk * NR;
            const bool live = key0 + r < c1;
            const float ksv = T_::kScaled ? ks_s[r] : 1.f;
            vsc[kk] = T_::kScaled ? vs_s[r] : 1.f;
#pragma unroll
            for (int g = 0; g < GT; ++g) sc[kk][g] = live ? sc[kk][g] * ksv : -INFINITY;
        }

        // Online softmax, this row group's own state.
#pragma unroll
        for (int g = 0; g < GT; ++g) {
            float mx = m[g];
#pragma unroll
            for (int kk = 0; kk < kKeys; ++kk) mx = fmaxf(mx, sc[kk][g]);
            const float sh = shift_of(mx);
            const float corr = weight(m[g], sh);
            float sum = 0.f;
#pragma unroll
            for (int kk = 0; kk < kKeys; ++kk) {
                sc[kk][g] = ex2(sc[kk][g] - sh);
                sum += sc[kk][g];
            }
            l[g] = l[g] * corr + sum;
            m[g] = mx;
#pragma unroll
            for (int e = 0; e < kCols; ++e) acc[g][e] *= corr;
        }
        // acc += p . V over this row group's keys (zero-filled past the band).
#pragma unroll
        for (int kk = 0; kk < kKeys; ++kk) {
            float vf[kCols];
            load_row(v_s + (rg + kk * NR) * pitch, t, R, Dh, vf);
#pragma unroll
            for (int g = 0; g < GT; ++g) {
                const float pv = sc[kk][g] * vsc[kk];
#pragma unroll
                for (int e = 0; e < kCols; ++e) acc[g][e] = fmaf(pv, vf[e], acc[g][e]);
            }
        }
    }
    cp_async_wait<0>();
    __syncthreads();  // the ring's shared memory is free from here

    // Merge the row groups of each warp (shuffles), then the warps (shared
    // memory): once per chunk.
    for (int o = R; o < 32; o <<= 1) {
#pragma unroll
        for (int g = 0; g < GT; ++g) {
            const float mo = __shfl_xor_sync(0xffffffffu, m[g], o);
            const float lo = __shfl_xor_sync(0xffffffffu, l[g], o);
            const float mn = fmaxf(m[g], mo);
            const float sh = shift_of(mn);
            const float a = weight(m[g], sh);
            const float b = weight(mo, sh);
            l[g] = l[g] * a + lo * b;
            m[g] = mn;
#pragma unroll
            for (int e = 0; e < kCols; ++e)
                acc[g][e] = acc[g][e] * a +
                            __shfl_xor_sync(0xffffffffu, acc[g][e], o) * b;
        }
    }
    float* red = reinterpret_cast<float*>(smem);   // [kWarps][GT][pitch]
    float* red_m = red + kWarps * GT * pitch;      // [kWarps][GT]
    float* red_l = red_m + kWarps * GT;
    if (lane < R) {
#pragma unroll
        for (int g = 0; g < GT; ++g) {
#pragma unroll
            for (int e = 0; e < kCols; ++e) {
                const int c = col_of<KV>(t, R, e);
                if (c < Dh) red[(warp * GT + g) * pitch + c] = acc[g][e];
            }
            if (t == 0) {
                red_m[warp * GT + g] = m[g];
                red_l[warp * GT + g] = l[g];
            }
        }
    }
    __syncthreads();

    const int g_valid = min(GT, p.G - g0);
    const int64_t base = (static_cast<int64_t>(s) * p.Y + y) * p.n_chunks + chunk_id;
    for (int i = tid; i < g_valid * Dh; i += kThreads) {
        const int g = i / Dh;
        const int d = i - g * Dh;
        float mx = -INFINITY;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, red_m[w * GT + g]);
        const float sh = shift_of(mx);
        float o = 0.f, ll = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
            const float a = weight(red_m[w * GT + g], sh);
            o = fmaf(red[(w * GT + g) * pitch + d], a, o);
            ll = fmaf(red_l[w * GT + g], a, ll);
        }
        const float val = o / fmaxf(ll, 1e-30f);
        if (p.n_chunks == 1) {
            p.out[(static_cast<int64_t>(s) * p.H + kvh * p.G + g0 + g) * Dh + d] = val;
        } else {
            p.part_o[(base * GT + g) * Dh + d] = val;
            if (d == 0) p.part_lse[base * GT + g] = ll > 0.f ? sh + log2f(ll) : -INFINITY;
        }
    }
}

// grid (Y, S), after the split kernel when it ran more than one chunk.
template <int GT>
__global__ void __launch_bounds__(kThreads) flash_decode_merge(const Params p) {
    const int s = blockIdx.y;
    merge_chunks<GT>(p, s, blockIdx.x, live_chunks(p, live_keys(p, s)));
}

int log2_int(int x) {
    int r = 0;
    while ((1 << r) < x) ++r;
    return r;
}

template <typename KV, int GT>
int launch_gt(Params p, int S, int tiles_per_chunk, cudaStream_t stream) {
    auto kernel = flash_decode_split<KV, GT>;
    constexpr int kStages = Traits<KV>::kStages;
    const int stages = tiles_per_chunk < kStages ? tiles_per_chunk : kStages;
    const int smem = stages * stage_bytes<KV>();
    if (smem > 48 * 1024) {  // past 48 KB only by opting in (per device)
        const cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    kernel<<<dim3(p.n_chunks, p.Y, S), kThreads, smem, stream>>>(p);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess || p.n_chunks == 1) return static_cast<int>(e);
    flash_decode_merge<GT><<<dim3(p.Y, S), kThreads, 0, stream>>>(p);
    return static_cast<int>(cudaGetLastError());
}

int threads_a_row(int Dh) {
    int R = 1;
    while (R * kCols < Dh) R *= 2;
    return R;
}

template <typename KV>
int tile_keys(int Dh) {
    return Traits<KV>::kKeys * (kThreads / threads_a_row(Dh));
}

int group_tile(int G) { return G == 1 ? 1 : G == 2 ? 2 : kMaxGroup; }

template <typename KV>
int launch(const void* q, const void* k, const void* v, const void* k_scale,
           const void* v_scale, const void* pos, void* out, int S, int H,
           int H_kv, int Dh, int L, int64_t q_ss, int64_t q_sh, int64_t kv_ss,
           int64_t kv_sl, int64_t kv_sh, int64_t sc_ss, int64_t sc_sl,
           int64_t sc_sh, float scale, void* partial, int chunk,
           void* stream) {
    constexpr int kPerCopy = 16 / static_cast<int>(sizeof(KV));
    const int T = Dh >= 1 && Dh <= kMaxHeadDim ? tile_keys<KV>(Dh) : 0;
    const auto on16 = [](int64_t stride) {
        return stride * static_cast<int64_t>(sizeof(KV)) % 16 == 0;
    };
    if (S < 1 || S > 65535 || H_kv < 1 || H % H_kv != 0 || T == 0 ||
        Dh % kPerCopy != 0 || L < 1 || chunk < T || chunk % T != 0 ||
        reinterpret_cast<uintptr_t>(k) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(v) % 16 != 0 || !on16(kv_ss) ||
        !on16(kv_sl) || !on16(kv_sh)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    Params p{};
    p.G = H / H_kv;
    const int GT = group_tile(p.G);
    p.q = static_cast<const float*>(q);
    p.k = k;
    p.v = v;
    p.k_scale = static_cast<const float*>(k_scale);
    p.v_scale = static_cast<const float*>(v_scale);
    p.pos = static_cast<const int32_t*>(pos);
    p.out = static_cast<float*>(out);
    p.H = H;
    p.Dh = Dh;
    p.L = L;
    p.R = threads_a_row(Dh);
    p.log2R = log2_int(p.R);
    p.chunk = chunk;
    p.n_chunks = (L + chunk - 1) / chunk;
    p.n_gb = (p.G + GT - 1) / GT;
    p.Y = H_kv * p.n_gb;
    if (p.Y > 65535) return static_cast<int>(cudaErrorInvalidValue);
    const int64_t n_part = static_cast<int64_t>(S) * p.Y * p.n_chunks * GT;
    p.part_o = static_cast<float*>(partial);
    p.part_lse = p.part_o ? p.part_o + n_part * Dh : nullptr;
    if (p.n_chunks > 1 && !partial) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    p.q_ss = q_ss;
    p.q_sh = q_sh;
    p.kv_ss = kv_ss;
    p.kv_sl = kv_sl;
    p.kv_sh = kv_sh;
    p.sc_ss = sc_ss;
    p.sc_sl = sc_sl;
    p.sc_sh = sc_sh;
    p.scale = scale * kLog2e;
    const int tiles_per_chunk = chunk / T;
    const auto st = static_cast<cudaStream_t>(stream);
    switch (GT) {
        case 1: return launch_gt<KV, 1>(p, S, tiles_per_chunk, st);
        case 2: return launch_gt<KV, 2>(p, S, tiles_per_chunk, st);
        default: return launch_gt<KV, kMaxGroup>(p, S, tiles_per_chunk, st);
    }
}

}  // namespace

extern "C" {

// Keys a tile of the kernel holds at head dim Dh (int8 when quantized):
// a chunk is a multiple of it (ops/decode.py tile_keys mirrors it).
int flash_decode_tile_keys(int quantized, int Dh) {
    if (Dh < 1 || Dh > kMaxHeadDim) return 0;
    return quantized ? tile_keys<int8_t>(Dh) : tile_keys<float>(Dh);
}

// B4: fp32 K/V. Strides are in elements; the last dim of q, k and v is
// contiguous. `partial` holds S x H_kv x n_gb x n_chunks x GT x (Dh + 1)
// floats (unused when one chunk covers L). Returns cudaGetLastError() after the
// launch (0 = launched).
int flash_decode_fp32(const void* q, const void* k, const void* v,
                      const void* pos, void* out, int S, int H, int H_kv,
                      int Dh, int L, int64_t q_ss, int64_t q_sh,
                      int64_t kv_ss, int64_t kv_sl, int64_t kv_sh,
                      float scale, void* partial, int chunk,
                      void* stream) {
    return launch<float>(q, k, v, nullptr, nullptr, pos, out, S, H, H_kv, Dh,
                         L, q_ss, q_sh, kv_ss, kv_sl, kv_sh, 0, 0, 0, scale,
                         partial, chunk, stream);
}

// B5: int8 K/V with per-(position, head) fp32 scales [S, L, H_kv].
int flash_decode_int8(const void* q, const void* k, const void* v,
                      const void* k_scale, const void* v_scale,
                      const void* pos, void* out, int S, int H, int H_kv,
                      int Dh, int L, int64_t q_ss, int64_t q_sh,
                      int64_t kv_ss, int64_t kv_sl, int64_t kv_sh,
                      int64_t sc_ss, int64_t sc_sl, int64_t sc_sh,
                      float scale, void* partial, int chunk,
                      void* stream) {
    return launch<int8_t>(q, k, v, k_scale, v_scale, pos, out, S, H, H_kv, Dh,
                          L, q_ss, q_sh, kv_ss, kv_sl, kv_sh, sc_ss, sc_sl,
                          sc_sh, scale, partial, chunk, stream);
}

}  // extern "C"
