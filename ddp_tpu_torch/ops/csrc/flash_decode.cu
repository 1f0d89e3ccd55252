// Flash-decode for Hopper: single-query banded attention over the
// serving engine's fixed-lane KV cache, fp32 or int8 K/V.
//
// Replaces the TPU kernel of ddp_tpu/ops/decode.py:
//   flash_decode_attention -> pl.pallas_call (decode.py:242)
//     -> _plain_kernel (:260) / _quantized_kernel (:270) -> _decode_body (:280)
// B4 is flash_decode_fp32, B5 is flash_decode_int8 (one template, two
// K/V element types).
//
// What bounds it on an H100: the bytes of K/V it reads. One decode step
// of one layer reads each live cache line once (S lanes x pos+1 keys x
// H_kv x Dh x 2 tensors) and does 4 flops per element read; at 3.35 TB/s
// the bytes take ~100x longer than the flops at the fp32 rate. The design
// answers that by reading only what the band needs, once:
//   - one thread block per (slot, kv-head); the G grouped queries sit in
//     shared memory, pre-scaled by Dh^-1/2, so every K/V row read from
//     device memory serves all G query heads of its group;
//   - the block loops over key tiles from 0 to pos[s] only (pos is read
//     from device memory, so the host never syncs): keys past the band
//     are never read, where the TPU grid visits every block and skips the
//     dead ones with pl.when;
//   - the cache is read in place through its strides, one layer's
//     [S, L, H_kv, Dh] slice; the TPU path's transpose to [S*H_kv, L, Dh]
//     (a copy of every lane) has no counterpart;
//   - the ragged tail is masked by the loop bound, so any L works;
//   - int8 rows and their per-(position, head) fp32 scales are loaded as
//     int8 and widened in registers: device-memory reads stay int8.
// Online softmax in fp32 with the isfinite shift guard of decode.py:317,
// and a final divide by max(l, 1e-30), as the TPU kernel does.
//
// This first version is plain on purpose: 64 blocks at full width leave
// half of the 132 SMs idle, loads are scalar (coalesced across a warp),
// and the only latency hiding is that a warp loads the K rows of several
// keys, and a thread several V rows, before using them; there is no
// cp.async or TMA pipeline. Split-K over L and vector loads are later
// work.
//
// Build (a plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libflash_decode.so flash_decode.cu

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;              // 4 warps per block
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;                  // keys per tile
constexpr int kMaxChunks = 8;              // Dh <= 32 * kMaxChunks
constexpr int kKeysPerWarp = 4;            // K rows a warp loads at once
constexpr int kGroupChunk = 8;             // query heads per register pass
constexpr size_t kMaxSmem = 48 * 1024;     // no opt-in attribute needed

__device__ __forceinline__ float widen(float x, float) { return x; }
__device__ __forceinline__ float widen(int8_t x, float scale) {
    return static_cast<float>(x) * scale;
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

// grid (H_kv, S), kThreads threads; dynamic shared memory holds
// q[G, Dh], acc[G, Dh], p[G, kTile] and the per-query m, l, correction.
template <typename KV>
__global__ void __launch_bounds__(kThreads) flash_decode_kernel(
    const float* __restrict__ q, const KV* __restrict__ k,
    const KV* __restrict__ v, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int32_t* __restrict__ pos,
    float* __restrict__ out, int H, int G, int Dh, int L, int64_t q_ss,
    int64_t q_sh, int64_t kv_ss, int64_t kv_sl, int64_t kv_sh,
    int64_t sc_ss, int64_t sc_sl, int64_t sc_sh, float scale) {
    extern __shared__ float smem[];
    float* q_s = smem;                 // [G, Dh]
    float* acc_s = q_s + G * Dh;       // [G, Dh]
    float* p_s = acc_s + G * Dh;       // [G, kTile]
    float* m_s = p_s + G * kTile;      // [G]
    float* l_s = m_s + G;              // [G]
    float* c_s = l_s + G;              // [G]

    const int kvh = blockIdx.x;
    const int s = blockIdx.y;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;

    // The lane's band: keys 0..pos[s]. An idle lane parked at the
    // position ceiling (pos == L) sees every key; key 0 is always live.
    const int n_keys = min(pos[s] + 1, L);

    const float* qb = q + s * q_ss + static_cast<int64_t>(kvh) * G * q_sh;
    for (int i = tid; i < G * Dh; i += kThreads) {
        const int g = i / Dh;
        const int d = i - g * Dh;
        q_s[i] = qb[g * q_sh + d] * scale;
        acc_s[i] = 0.f;
    }
    for (int g = tid; g < G; g += kThreads) {
        m_s[g] = -INFINITY;
        l_s[g] = 0.f;
    }
    __syncthreads();

    const KV* kb = k + s * kv_ss + kvh * kv_sh;
    const KV* vb = v + s * kv_ss + kvh * kv_sh;
    const float* ksb = k_scale ? k_scale + s * sc_ss + kvh * sc_sh : nullptr;
    const float* vsb = v_scale ? v_scale + s * sc_ss + kvh * sc_sh : nullptr;

    for (int t0 = 0; t0 < n_keys; t0 += kTile) {
        const int tn = min(kTile, n_keys - t0);

        // 1. Scores: each warp loads the rows of kKeysPerWarp keys
        //    before reducing any of them (their loads are in flight
        //    together); a row is read once and dotted with all G
        //    queries of the group.
        for (int j0 = warp * kKeysPerWarp; j0 < tn;
             j0 += kWarps * kKeysPerWarp) {
            float kr[kKeysPerWarp][kMaxChunks];
#pragma unroll
            for (int b = 0; b < kKeysPerWarp; ++b) {
                // Past the tile end, reload its last key: the result
                // is discarded and the read stays inside the band.
                const int64_t key = t0 + min(j0 + b, tn - 1);
                const KV* row = kb + key * kv_sl;
                const float ks = ksb ? ksb[key * sc_sl] : 1.f;
#pragma unroll
                for (int c = 0; c < kMaxChunks; ++c) {
                    const int d = lane + 32 * c;
                    kr[b][c] = d < Dh ? widen(row[d], ks) : 0.f;
                }
            }
            for (int g = 0; g < G; ++g) {
                float dot[kKeysPerWarp];
#pragma unroll
                for (int b = 0; b < kKeysPerWarp; ++b) {
                    dot[b] = 0.f;
#pragma unroll
                    for (int c = 0; c < kMaxChunks; ++c) {
                        const int d = lane + 32 * c;
                        if (d < Dh) dot[b] += kr[b][c] * q_s[g * Dh + d];
                    }
                }
#pragma unroll
                for (int b = 0; b < kKeysPerWarp; ++b) {
                    dot[b] = warp_sum(dot[b]);
                    if (lane == 0 && j0 + b < tn) p_s[g * kTile + j0 + b] = dot[b];
                }
            }
        }
        __syncthreads();

        // 2. Online-softmax statistics: one warp per query head.
        for (int g = warp; g < G; g += kWarps) {
            float* pg = p_s + g * kTile;
            float mx = -INFINITY;
            for (int j = lane; j < tn; j += 32) mx = fmaxf(mx, pg[j]);
            mx = warp_max(mx);
            const float m_old = m_s[g];
            const float m_new = fmaxf(m_old, mx);
            const float shift = isfinite(m_new) ? m_new : 0.f;
            float sum = 0.f;
            for (int j = lane; j < tn; j += 32) {
                const float e = expf(pg[j] - shift);
                pg[j] = e;
                sum += e;
            }
            sum = warp_sum(sum);
            if (lane == 0) {
                const float corr = isfinite(m_old) ? expf(m_old - shift) : 0.f;
                m_s[g] = m_new;
                l_s[g] = l_s[g] * corr + sum;
                c_s[g] = corr;
            }
        }
        __syncthreads();

        // 3. acc[g, d] = acc[g, d] * corr[g] + sum_j p[g, j] * V[j, d]:
        //    thread d reads V[j, d] once for every query of the group.
        for (int d = tid; d < Dh; d += kThreads) {
            for (int g0 = 0; g0 < G; g0 += kGroupChunk) {
                const int gn = min(kGroupChunk, G - g0);
                float a[kGroupChunk];
#pragma unroll
                for (int i = 0; i < kGroupChunk; ++i)
                    a[i] = i < gn ? acc_s[(g0 + i) * Dh + d] * c_s[g0 + i] : 0.f;
                // Unrolled so that several V loads are in flight at once.
#pragma unroll 8
                for (int j = 0; j < tn; ++j) {
                    const int64_t key = t0 + j;
                    const float vs = vsb ? vsb[key * sc_sl] : 1.f;
                    const float vv = widen(vb[key * kv_sl + d], vs);
#pragma unroll
                    for (int i = 0; i < kGroupChunk; ++i)
                        if (i < gn) a[i] += p_s[(g0 + i) * kTile + j] * vv;
                }
                for (int i = 0; i < gn; ++i) acc_s[(g0 + i) * Dh + d] = a[i];
            }
        }
        __syncthreads();
    }

    float* ob = out + (static_cast<int64_t>(s) * H + static_cast<int64_t>(kvh) * G) * Dh;
    for (int i = tid; i < G * Dh; i += kThreads) {
        ob[i] = acc_s[i] / fmaxf(l_s[i / Dh], 1e-30f);
    }
}

size_t smem_bytes(int G, int Dh) {
    return static_cast<size_t>(2 * G * Dh + G * kTile + 3 * G) * sizeof(float);
}

template <typename KV>
int launch(const void* q, const void* k, const void* v, const void* k_scale,
           const void* v_scale, const void* pos, void* out, int S, int H,
           int H_kv, int Dh, int L, int64_t q_ss, int64_t q_sh, int64_t kv_ss,
           int64_t kv_sl, int64_t kv_sh, int64_t sc_ss, int64_t sc_sl,
           int64_t sc_sh, float scale, void* stream) {
    if (S < 1 || H_kv < 1 || H % H_kv != 0 || Dh < 1 ||
        Dh > 32 * kMaxChunks || L < 1) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const int G = H / H_kv;
    const size_t smem = smem_bytes(G, Dh);
    if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid(H_kv, S);
    flash_decode_kernel<KV><<<grid, kThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(q), static_cast<const KV*>(k),
        static_cast<const KV*>(v), static_cast<const float*>(k_scale),
        static_cast<const float*>(v_scale),
        static_cast<const int32_t*>(pos), static_cast<float*>(out), H, G, Dh,
        L, q_ss, q_sh, kv_ss, kv_sl, kv_sh, sc_ss, sc_sl, sc_sh, scale);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Shared memory one block needs for G query heads of width Dh (bytes).
size_t flash_decode_smem_bytes(int G, int Dh) { return smem_bytes(G, Dh); }

// B4: fp32 K/V. Strides are in elements; the last dim of q, k and v is
// contiguous. Returns cudaGetLastError() after the launch (0 = launched).
int flash_decode_fp32(const void* q, const void* k, const void* v,
                      const void* pos, void* out, int S, int H, int H_kv,
                      int Dh, int L, int64_t q_ss, int64_t q_sh,
                      int64_t kv_ss, int64_t kv_sl, int64_t kv_sh,
                      float scale, void* stream) {
    return launch<float>(q, k, v, nullptr, nullptr, pos, out, S, H, H_kv, Dh,
                         L, q_ss, q_sh, kv_ss, kv_sl, kv_sh, 0, 0, 0, scale,
                         stream);
}

// B5: int8 K/V with per-(position, head) fp32 scales [S, L, H_kv].
int flash_decode_int8(const void* q, const void* k, const void* v,
                      const void* k_scale, const void* v_scale,
                      const void* pos, void* out, int S, int H, int H_kv,
                      int Dh, int L, int64_t q_ss, int64_t q_sh,
                      int64_t kv_ss, int64_t kv_sl, int64_t kv_sh,
                      int64_t sc_ss, int64_t sc_sl, int64_t sc_sh,
                      float scale, void* stream) {
    return launch<int8_t>(q, k, v, k_scale, v_scale, pos, out, S, H, H_kv, Dh,
                          L, q_ss, q_sh, kv_ss, kv_sl, kv_sh, sc_ss, sc_sl,
                          sc_sh, scale, stream);
}

}  // extern "C"
