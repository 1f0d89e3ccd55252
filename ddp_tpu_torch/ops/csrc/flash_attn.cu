// Flash attention for Hopper: the forward, dQ and dK/dV kernels of the
// causal-LM training step, in bf16 and fp32, all on the tensor cores.
//
// Replaces the TPU kernels of ddp_tpu/ops/flash.py:
//   B1 _flash_forward (:293) -> pl.pallas_call (:306) -> _fwd_kernel (:88)
//   B2 _flash_backward (:344) -> pl.pallas_call (:369) -> _dq_kernel (:152)
//   B3 _flash_backward (:344) -> pl.pallas_call (:389) -> _dkv_kernel (:209)
// flash_attn_fwd is B1, flash_attn_dq is B2, flash_attn_dkv is B3; each
// has a bf16 and an fp32 variant.
//
// What bounds them on an H100: operations. At the training shape (B 8,
// T = S 2048, H 8, D 128, causal) B1 does 2 tile products per live
// (query, key) pair, B2 3 and B3 4: 69, 103 and 137 GFLOP, which at 989
// TFLOP/s (dense bf16) take 69-139 us, against ~40 us for the bytes each
// input and output moves once. So the products have to run at the
// tensor cores' rate, which only wgmma reaches.
//
// bf16 B1, B2 and B3 (fwd_sm90, dq_sm90, dkv_sm90) are built for that,
// from the pieces of sm90.cuh:
//   - warp specialisation: one producer warp issues TMA loads (tensor
//     maps over the strided [B, T, H, D] views, 128-byte swizzle, zero
//     fill past T, S and D) into a ring of shared memory (3 K/V stages for
//     B1 and B2, 2 Q/dO stages for B3) with full/empty mbarriers, while
//     two consumer warpgroups (setmaxnreg: 24 registers for the producer,
//     240 for each consumer) run wgmma on the tiles that have arrived:
//     loads overlap products;
//   - every accumulator lives in registers: B1's S = Q.K^T (m64n128k16,
//     both operands in shared memory) and its output O; B2's S = Q.K^T
//     and dP = dO.V^T (m64n64k16) and its dQ across the whole key loop;
//     B3's transposed S^T = K.Q^T and dP^T = V.dO^T (m64n64k16) and its
//     dK, dV across the whole q loop. The online softmax (B1) and B2's dS =
//     P * (dP - delta') run on S in registers with exp2 (one MUFU.EX2) and
//     the scale folded in, B1's row max and sum over the 4 threads of a
//     quad;
//   - P (B1), dS (B2), P^T and dS^T (B3) never touch shared memory: the
//     fp32 accumulator layout, regrouped 16 columns at a time, is the A
//     fragment of the next product (O += P.V, dQ += dS.K, dV += P^T.dO,
//     dK += dS^T.Q), an RS wgmma (m64n128k16 at D 128) that reads V, K, dO
//     or Q MN-major (B2 reads its K tile K-major for S and MN-major for
//     dQ, as B3 reads its Q tile);
//   - the scores' epilogue runs while the tensor cores work: in B1 and B2
//     each warpgroup issues the score products of tile j and then the
//     accumulation of tile j - 1 (O += P.V, dQ += dS.K) and computes the
//     softmax or dS of tile j while the second product runs (the other
//     warpgroup's products fill the tensor cores too; making the two take
//     turns measured slower, flash_variants.py in PERF.md);
//   - B1 and B2: a work item is 128 query rows and streams K/V tiles (128
//     keys for B1, 64 for B2: S, dP and dQ take 128 registers a thread);
//     the kernels are persistent (one CTA per SM draws items from a
//     counter, the longest first), so that an item's epilogue overlaps the
//     next one's loads. B3: a CTA owns 128 keys (64 per warpgroup) and
//     streams 64-row Q/dO tiles with their lse and delta'. Heads are
//     scheduled in groups whose streamed tiles fit in a third of the L2
//     cache. The mask is evaluated only on tiles that straddle the
//     diagonal or the end of the keys, and a warpgroup skips the products
//     of a tile in which none of its rows is live;
//   - head dims up to 64 run a 64-column tile, up to 128 a 128-column one
//     (two TMA boxes); TMA fills the padding columns with zeros, which add
//     nothing to Q.K^T, and the epilogue does not store them.
//
// fp32 B1, B2 and B3 (fwd_tf32, dq_tf32, dkv_tf32) keep fp32 accuracy on
// the tensor cores: every product is three-pass TF32 (tf32x3.cuh: each
// operand split into a TF32 big part and a TF32 remainder, big.big +
// big.small + small.big into one fp32 accumulator, ~2^-21 relative error
// a product) through mma.sync m16n8k8, which reads its fragments from
// shared memory in any layout (tf32 wgmma takes K-major operands only, and
// V, K, dO and Q are read MN-major here). At 494.7 TFLOP/s dense TF32
// that is ~165 TFLOP/s of fp32-accurate products, 2.5x the 67 of the FMA
// units.
//   - a CTA is 8 warps; a warp owns 16 query rows (B1, B2) or 16 keys
//     (B3, computed transposed as dkv_sm90 is) and keeps every accumulator
//     in registers: S and O (B1), S, dP and dQ (B2), S^T, dP^T, dK and dV
//     (B3). The online softmax and dS run on the fragments (exp2, scale
//     folded in, quad shuffles);
//   - P (B1), dS (B2), P^T and dS^T (B3) stay in registers: an m16n8 C
//     fragment is the A fragment of the next product once k is permuted
//     inside each 8-column block, and the B operand (V, K, dO or Q) is
//     read in that order;
//   - tiles stream through a 2-stage cp.async ring (16-byte copies, zero
//     fill past T, S and D), one __syncthreads a tile; rows are padded to
//     D + 4 floats so that both reads of a tile (row-wise for S or S^T;
//     column-wise for O, dQ, dK, dV) hit 32 distinct banks;
//   - B1: 128 query rows a CTA, 64-key K/V tiles; B2: 128 query rows with
//     their dO, 32-key K/V tiles; B3: 128 keys a CTA, 32-row Q/dO tiles (at
//     D 128, ~200 KB of shared memory each; dK and dV take 128 registers a
//     thread, so B3's S^T and dP^T tiles are kept to 32 queries). The
//     schedule is fp32's as much as bf16's: the longest work first, masks
//     only on straddling tiles, a warp skips a tile with no live pair;
//     head dims up to 64 run a 64-column tile, up to 128 a 128-column one.
//
// Common to all: the [T, S] score matrix never reaches device memory;
// causal tiles past the diagonal are never visited (B1/B2 stop at the
// last live key of their q-tile, B3 starts at the first q-tile that sees
// its keys) and the tiles with the most work are scheduled first; two
// backward kernels and no atomics on the data, so every result is
// deterministic; q/k/v/dO are read in place through their strides (the
// fused qkv projection's views, token stride 3*H*D); ragged tails are
// masked in the kernel, so any T and S work.
//
// Masks and empty rows follow the TPU kernel: the causal mask is
// end-anchored (key <= t + S - T); a row with no live key gives out 0
// and lse -inf, and B2/B3 replace such an lse by 0.5 * FLT_MAX so that
// P = 0 there (dQ 0), not NaN.
//
// Build (a plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libflash_attn.so flash_attn.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "sm90.cuh"
#include "tf32x3.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMaxHeadDim = 128;
constexpr float kBigLse = 0.5f * FLT_MAX;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

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
    int group;  // heads per group of the grid
    int* ticket;  // B1 and B2 (sm90): the next work item, 0 at launch
};

template <typename T>
__device__ __forceinline__ const T* slice(const View& x, int b, int h) {
    return static_cast<const T*>(x.p) + b * x.sb + h * x.sh;
}
template <typename T>
__device__ __forceinline__ T* slice_out(const View& x, int b, int h) {
    return static_cast<T*>(x.p) + b * x.sb + h * x.sh;
}

// lse * log2(e) and delta' of query row t of (b, h): a non-finite
// lse (a row with no live key) and a row past T give 0.5 FLT_MAX, so that
// P = 0 there.
__device__ __forceinline__ void row_stats(const Args& a, int b, int h, int t,
                                          float& lse2, float& dl) {
    float lse = kBigLse, d = 0.f;
    if (t < a.T) {
        const int64_t i = (static_cast<int64_t>(b) * a.T + t) * a.H + h;
        lse = a.lse[i];
        d = a.delta[i];
    }
    lse2 = (isfinite(lse) ? lse : kBigLse) * kLog2e;
    dl = d;
}

// ---- bf16 B1, B2 and B3 for Hopper: TMA, mbarriers and wgmma --------------

constexpr int kConsumers = 2;  // consumer warpgroups, 64 rows each
constexpr int kSm90Threads = (kConsumers + 1) * 128;  // + the producer's
constexpr int kProducerRegs = 24, kConsumerRegs = 240;
// B1: 128 query rows a work item, 128-key K/V tiles. B2: 128 query rows a
// work item, 64-key K/V tiles. B3: 128 keys a CTA, 64-row Q/dO tiles.
constexpr int kFwdBQ = 128, kFwdBK = 128;
constexpr int kDqBQ = 128, kDqBK = 64;
constexpr int kDkvBK = 128, kDkvBQ = 64;
// Ring depth: 3 K/V stages for B1 (224 KB with Q at D 128), 2 Q/dO
// stages for B3 (~130 KB).
constexpr int kFwdStages = 3, kDkvStages = 2;
// 3 K/V stages for B2 (~162 KB with Q and dO at D 128).
constexpr int kDqStages = 3;
// Heads per group of the schedule: their streamed tiles (B1's and B2's
// K+V, B3's Q+dO) within 16 MB, a third of the H100's 50 MB L2.
constexpr int64_t kL2GroupBytes = 16LL << 20;

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
    return reinterpret_cast<unsigned char*>(
        (reinterpret_cast<uintptr_t>(p) + 1023) & ~static_cast<uintptr_t>(1023));
}

// A K-major operand: the 16 columns [16 kk, 16 kk + 16) of a tile of
// `rows` rows whose 64-column regions follow each other.
__device__ __forceinline__ uint64_t k_major(uint32_t base, int rows, int kk) {
    return sm90::desc_sw128(
        base + (kk / 4) * rows * sm90::kRowBytes + (kk % 4) * 32, 16,
        sm90::kAtomBytes);
}

// D[64 x DT] += A . B for the k16 A fragment `a` and B the rows [16 kk,
// 16 kk + 16) of an MN-major tile of `rows` rows and DT columns (DT/64
// regions of `rows` x 128 bytes): one m64n128k16 (or m64n64k16) RS wgmma.
template <int DT>
__device__ __forceinline__ void mma_mn(float (&d)[DT / 2],
                                       const uint32_t (&a)[4], uint32_t base,
                                       int rows, int kk) {
    const uint32_t addr = base + kk * 2 * sm90::kAtomBytes;
    if constexpr (DT == 128)
        sm90::wgmma_rs_n128(d, a, sm90::desc_sw128(addr, rows * sm90::kRowBytes,
                                                   sm90::kAtomBytes));
    else
        sm90::wgmma_rs_n64(d, a, sm90::desc_sw128(addr, sm90::kAtomBytes,
                                                  sm90::kAtomBytes));
}

__device__ __forceinline__ float quad_max(float x) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
    return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// B1's online softmax of one 128-key tile at key k0, in place on the
// scores S (this thread's two rows t0 and t0 + 8): masked keys to -inf
// (only on a tile where a key may be dead: past S, or past the diagonal
// of the warpgroup's first row qw), the running max m in log2 units (x =
// s * scale * log2 e), P = exp2(x - m) into S, and the row sums l (this
// thread's share) rescaled by corr = exp2(m_old - m).
__device__ __forceinline__ void fwd_softmax(float (&sc)[64], float (&m)[2],
                                            float (&l)[2], float (&corr)[2],
                                            int k0, int t0, int qw, int cq,
                                            float sl2, const Args& a) {
    const int diag = a.S - a.T;
    const bool mask = k0 + kFwdBK > a.S ||
                      (a.causal && k0 + kFwdBK - 1 > qw + diag);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 64; ++i) {
        if (mask) {
            const int key = k0 + (i / 4) * 8 + cq + (i & 1);
            const int t = t0 + ((i >> 1) & 1) * 8;
            if (key >= a.S || (a.causal && key > t + diag)) sc[i] = -INFINITY;
        }
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
    }
    float shift[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const float mn = fmaxf(m[r], quad_max(mx[r]) * sl2);
        // A row with no live key yet: exp2(-inf - -inf) would be NaN.
        shift[r] = mn == -INFINITY ? 0.f : mn;
        corr[r] = sm90::exp2_ftz(m[r] - shift[r]);
        m[r] = mn;
        l[r] *= corr[r];
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) {
        const float p = sm90::exp2_ftz(fmaf(sc[i], sl2, -shift[(i >> 1) & 1]));
        sc[i] = p;
        l[(i >> 1) & 1] += p;
    }
}

// The (b*h, tile rank) of work item `idx` of B*H*tiles, ordered
// group-major: heads are taken a.group at a time and every tile of a
// group's heads runs before the next group's, so that the tiles the
// group's CTAs all stream (K/V for B1, Q/dO for B3) stay in the L2
// cache; within a group, rank 0 (the most work) first.
__device__ __forceinline__ void grid_slot(const Args& a, int tiles, int idx,
                                          int& bh, int& rank) {
    const int bhs = a.B * a.H;
    const int per_group = a.group * tiles;
    const int g = idx / per_group;
    const int rem = idx - g * per_group;
    const int size = min(a.group, bhs - g * a.group);  // the last may be short
    rank = rem / size;
    bh = g * a.group + rem % size;
}

// Shared memory of fwd_sm90 at a head-dim tile DT (64 or 128): Q, then
// kFwdStages K tiles and as many V tiles, then the barriers; offsets from a
// 1024-byte aligned base.
template <int DT> struct FwdSm90 {
    static constexpr int kRegions = DT / 64;
    static constexpr int kQBytes = kRegions * kFwdBQ * sm90::kRowBytes;
    static constexpr int kKVBytes = kRegions * kFwdBK * sm90::kRowBytes;
    static constexpr int kQ = 0;
    static constexpr int kK = kQ + kQBytes;
    static constexpr int kV = kK + kFwdStages * kKVBytes;
    static constexpr int kBar = kV + kFwdStages * kKVBytes;
    static constexpr int kItem = kBar + 8 * (2 + 2 * kFwdStages);
    static constexpr int kBytes = kItem + 16 + 1024;
};

// One work item of B1 or B2: BQ query rows of one (b, h), and its tiles
// of BK keys.
template <int BQ, int BK> struct QItem {
    int b, h, q0, n_tiles;
    __device__ QItem(const Args& a, int q_tiles, int item) {
        int bh, rank;
        grid_slot(a, q_tiles, item, bh, rank);
        b = bh / a.H;
        h = bh % a.H;
        q0 = (q_tiles - 1 - rank) * BQ;  // the most k-tiles first
        const int end = a.causal ? min(a.S, q0 + BQ + a.S - a.T) : a.S;
        n_tiles = end > 0 ? (end + BK - 1) / BK : 0;
    }
};

// Persistent: a grid of at most one CTA per SM. Thread 256 (the
// producer) draws work items from a.ticket in the group-major order of
// grid_slot, the longest first, and hands each to the consumers through
// shared memory with its Q; threads 0-255 (warpgroup w owns rows q0 + 64w
// .. q0 + 64w + 63 of an item) compute it. The next item's first K/V
// tiles load while the consumers finish the last one, and its Q as soon
// as both warpgroups are done with the last Q, so that one item's
// epilogue overlaps the next one's loads. Item -1 ends the loop.
template <int DT>
__global__ void __launch_bounds__(kSm90Threads, 1)
fwd_sm90(const __grid_constant__ CUtensorMap tq,
         const __grid_constant__ CUtensorMap tk,
         const __grid_constant__ CUtensorMap tv, Args a) {
    using L = FwdSm90<DT>;
    using Item = QItem<kFwdBQ, kFwdBK>;
    extern __shared__ unsigned char smem_raw[];
    unsigned char* sm = align1024(smem_raw);
    uint64_t* qfull = reinterpret_cast<uint64_t*>(sm + L::kBar);
    uint64_t* qempty = qfull + 1;
    uint64_t* full = qempty + 1;
    uint64_t* empty = full + kFwdStages;
    volatile int* item_slot = reinterpret_cast<volatile int*>(sm + L::kItem);
    const int q_tiles = (a.T + kFwdBQ - 1) / kFwdBQ;
    const int items = a.B * a.H * q_tiles;
    const int diag = a.S - a.T;  // key k is live for row t iff k <= t + diag
    if (threadIdx.x == 0) {
        sm90::mbar_init(qfull, 1);
        sm90::mbar_init(qempty, kConsumers * 128);
        for (int s = 0; s < kFwdStages; ++s) {
            sm90::mbar_init(&full[s], 1);
            sm90::mbar_init(&empty[s], kConsumers * 128);
        }
        sm90::mbar_fence_init();
    }
    __syncthreads();
    const int wg = threadIdx.x / 128;
    if (wg == kConsumers) {
        sm90::regs_dealloc<kProducerRegs>();
        if (threadIdx.x == kConsumers * 128) {
            int it = 0;  // K/V tiles loaded so far, over all items
            for (int n = 0;; ++n) {
                const int item = atomicAdd(a.ticket, 1);
                if (item >= items) {
                    sm90::mbar_wait(qempty, (n & 1) ^ 1);
                    *item_slot = -1;
                    sm90::mbar_arrive(qfull);
                    break;
                }
                const Item w(a, q_tiles, item);
                auto load_kv = [&](int j) {
                    const int s = it % kFwdStages;
                    sm90::mbar_wait(&empty[s], ((it / kFwdStages) & 1) ^ 1);
                    sm90::mbar_arrive_expect_tx(&full[s], 2 * L::kKVBytes);
                    for (int r = 0; r < L::kRegions; ++r) {
                        const int off = s * L::kKVBytes + r * kFwdBK * sm90::kRowBytes;
                        sm90::tma_load_4d(sm + L::kK + off, &tk, &full[s],
                                          r * 64, w.h, j * kFwdBK, w.b);
                        sm90::tma_load_4d(sm + L::kV + off, &tv, &full[s],
                                          r * 64, w.h, j * kFwdBK, w.b);
                    }
                    ++it;
                };
                // The first K/V tiles go out while the consumers still read
                // the previous item's Q; this item's Q once they are done.
                const int early = min(w.n_tiles, kFwdStages - 1);
                for (int j = 0; j < early; ++j) load_kv(j);
                sm90::mbar_wait(qempty, (n & 1) ^ 1);
                *item_slot = item;
                sm90::mbar_arrive_expect_tx(qfull, L::kQBytes);
                for (int r = 0; r < L::kRegions; ++r)
                    sm90::tma_load_4d(sm + L::kQ + r * kFwdBQ * sm90::kRowBytes,
                                      &tq, qfull, r * 64, w.h, w.q0, w.b);
                for (int j = early; j < w.n_tiles; ++j) load_kv(j);
            }
        }
    } else {
        sm90::regs_alloc<kConsumerRegs>();
        const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
        const int cq = 2 * (lane & 3);  // first column of each pair
        const float sl2 = a.scale * kLog2e;
        const uint32_t q_base =
            sm90::smem_addr(sm + L::kQ) + wg * 64 * sm90::kRowBytes;
        int it = 0;  // K/V tiles consumed so far, over all items
        for (int n = 0;; ++n) {
            sm90::mbar_wait(qfull, n & 1);  // the item, and its Q
            const int item = *item_slot;
            if (item < 0) break;
            const Item w(a, q_tiles, item);
            const int qw = w.q0 + wg * 64;  // this warpgroup's first row
            const int t0 = qw + 16 * warp + lane / 4;  // rows t0 and t0 + 8
            float o[DT / 2];
#pragma unroll
            for (int i = 0; i < DT / 2; ++i) o[i] = 0.f;
            float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
            float sc[64];
            uint32_t pa[kFwdBK / 16][4];
            // Tiles past this warpgroup's last live key are only released.
            const int end_w = a.causal ? min(a.S, qw + 64 + diag) : a.S;
            const int n_live = end_w > 0 ? (end_w + kFwdBK - 1) / kFwdBK : 0;
            // Tile 0: S_0 = Q.K_0^T and its softmax. Tile j > 0: issue S_j,
            // then O += P_{j-1}.V_{j-1}; the softmax of S_j runs while the
            // second product is in flight. (No product sits in a branch of
            // its own: ptxas would serialise them.)
            if (n_live > 0) {
                const int s = it % kFwdStages;
                sm90::mbar_wait(&full[s], (it / kFwdStages) & 1);
                const uint32_t k_base = sm90::smem_addr(sm + L::kK + s * L::kKVBytes);
                sm90::wgmma_fence();
#pragma unroll
                for (int kk = 0; kk < DT / 16; ++kk)
                    sm90::wgmma_ss_n128(sc, k_major(q_base, kFwdBQ, kk),
                                        k_major(k_base, kFwdBK, kk), kk > 0);
                sm90::wgmma_commit();
                sm90::wgmma_wait<0>();
                sm90::fence_regs(sc);
                float corr[2];
                fwd_softmax(sc, m, l, corr, 0, t0, qw, cq, sl2, a);
#pragma unroll
                for (int kk = 0; kk < kFwdBK / 16; ++kk) sm90::acc_to_a(sc, kk, pa[kk]);
            }
            for (int j = 1; j < n_live; ++j) {
                const int s = (it + j) % kFwdStages;
                const int sp = (it + j - 1) % kFwdStages;
                sm90::mbar_wait(&full[s], ((it + j) / kFwdStages) & 1);
                const uint32_t k_base = sm90::smem_addr(sm + L::kK + s * L::kKVBytes);
                const uint32_t v_prev = sm90::smem_addr(sm + L::kV + sp * L::kKVBytes);
                sm90::wgmma_fence();
#pragma unroll
                for (int kk = 0; kk < DT / 16; ++kk)
                    sm90::wgmma_ss_n128(sc, k_major(q_base, kFwdBQ, kk),
                                        k_major(k_base, kFwdBK, kk), kk > 0);
                sm90::wgmma_commit();
#pragma unroll
                for (int kk = 0; kk < kFwdBK / 16; ++kk)
                    mma_mn<DT>(o, pa[kk], v_prev, kFwdBK, kk);
                sm90::wgmma_commit();
                sm90::wgmma_wait<1>();
                sm90::fence_regs(sc);
                float corr[2];
                fwd_softmax(sc, m, l, corr, j * kFwdBK, t0, qw, cq, sl2, a);
                sm90::wgmma_wait<0>();  // O += P_{j-1}.V_{j-1} is done
                sm90::fence_regs(o);
                sm90::mbar_arrive(&empty[sp]);
#pragma unroll
                for (int i = 0; i < DT / 2; ++i) o[i] *= corr[(i >> 1) & 1];
#pragma unroll
                for (int kk = 0; kk < kFwdBK / 16; ++kk) sm90::acc_to_a(sc, kk, pa[kk]);
            }
            if (n_live > 0) {  // the last tile's O += P.V
                const int sp = (it + n_live - 1) % kFwdStages;
                const uint32_t v_prev = sm90::smem_addr(sm + L::kV + sp * L::kKVBytes);
                sm90::wgmma_fence();
#pragma unroll
                for (int kk = 0; kk < kFwdBK / 16; ++kk)
                    mma_mn<DT>(o, pa[kk], v_prev, kFwdBK, kk);
                sm90::wgmma_commit();
                sm90::wgmma_wait<0>();
                sm90::fence_regs(o);
                sm90::mbar_arrive(&empty[sp]);
            }
            sm90::mbar_arrive(qempty);  // done with this item's Q
            for (int j = n_live; j < w.n_tiles; ++j) {
                const int s = (it + j) % kFwdStages;
                sm90::mbar_wait(&full[s], ((it + j) / kFwdStages) & 1);
                sm90::mbar_arrive(&empty[s]);
            }
            it += w.n_tiles;
            bf16* ob = static_cast<bf16*>(a.o.p) + w.b * a.o.sb + w.h * a.o.sh;
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const float lsum = quad_sum(l[half]);
                const int t = t0 + 8 * half;
                if (t >= a.T) continue;
                const float inv = 1.f / fmaxf(lsum, 1e-30f);
                bf16* row = ob + static_cast<int64_t>(t) * a.o.st;
#pragma unroll
                for (int jj = 0; jj < DT / 8; ++jj) {
                    const int col = jj * 8 + cq;
                    if (col < a.D)
                        *reinterpret_cast<uint32_t*>(row + col) = sm90::pack_bf16(
                            o[4 * jj + 2 * half] * inv, o[4 * jj + 2 * half + 1] * inv);
                }
                if ((lane & 3) == 0)
                    a.lse[(static_cast<int64_t>(w.b) * a.T + t) * a.H + w.h] =
                        lsum > 0.f ? m[half] * kLn2 + logf(lsum) : -INFINITY;
            }
        }
    }
}

// Shared memory of dq_sm90 at a head-dim tile DT: Q and dO (128 rows),
// then kDqStages K tiles and as many V tiles (64 rows), then the barriers;
// offsets from a 1024-byte aligned base.
template <int DT> struct DqSm90 {
    static constexpr int kRegions = DT / 64;
    static constexpr int kQBytes = kRegions * kDqBQ * sm90::kRowBytes;
    static constexpr int kKVBytes = kRegions * kDqBK * sm90::kRowBytes;
    static constexpr int kQ = 0;
    static constexpr int kDo = kQ + kQBytes;
    static constexpr int kK = kDo + kQBytes;
    static constexpr int kV = kK + kDqStages * kKVBytes;
    static constexpr int kBar = kV + kDqStages * kKVBytes;
    static constexpr int kItem = kBar + 8 * (2 + 2 * kDqStages);
    static constexpr int kBytes = kItem + 16 + 1024;
};

// D[64 x N] (+)= A . B, both K-major in shared memory: m64n64k16 or
// m64n128k16.
template <int N>
__device__ __forceinline__ void mma_ss(float (&d)[N / 2], uint64_t a,
                                       uint64_t b, int scale_d) {
    if constexpr (N == 128)
        sm90::wgmma_ss_n128(d, a, b, scale_d);
    else
        sm90::wgmma_ss_n64(d, a, b, scale_d);
}

// B2's S = Q.K^T and dP = dO.V^T of one K/V tile (`off` bytes into the
// rings of K and V tiles), every operand K-major in shared memory.
template <int DT>
__device__ __forceinline__ void dq_products(float (&sc)[kDqBK / 2],
                                            float (&dp)[kDqBK / 2],
                                            uint32_t q_base, uint32_t do_base,
                                            uint32_t k_ring, uint32_t v_ring,
                                            uint32_t off) {
#pragma unroll
    for (int kk = 0; kk < DT / 16; ++kk)
        mma_ss<kDqBK>(sc, k_major(q_base, kDqBQ, kk),
                      k_major(k_ring + off, kDqBK, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < DT / 16; ++kk)
        mma_ss<kDqBK>(dp, k_major(do_base, kDqBQ, kk),
                      k_major(v_ring + off, kDqBK, kk), kk > 0);
}

// B2's dQ += dS.K: dS from registers (the A fragments `da`), the K tile at
// `k_base` read MN-major.
template <int DT>
__device__ __forceinline__ void dq_accumulate(float (&dq)[DT / 2],
                                              const uint32_t (&da)[kDqBK / 16][4],
                                              uint32_t k_base) {
#pragma unroll
    for (int kk = 0; kk < kDqBK / 16; ++kk) mma_mn<DT>(dq, da[kk], k_base, kDqBK, kk);
}

// B2's dS of one kDqBK-key tile at key k0, in place on dP (this thread's
// rows t0 and t0 + 8, their lse2 = lse * log2 e and delta' dl): P =
// exp2(S * scale * log2 e - lse2), 0 for a dead key (looked at only on a
// tile where a key may be dead: past S, or past the diagonal of the
// warpgroup's first row qw), and dS = P * (dP - delta').
__device__ __forceinline__ void dq_scores(const float (&sc)[kDqBK / 2],
                                          float (&dp)[kDqBK / 2],
                                          const float (&lse2)[2],
                                          const float (&dl)[2], int k0,
                                          int t0, int qw, int cq, float sl2,
                                          const Args& a) {
    const int diag = a.S - a.T;
    const bool mask = k0 + kDqBK > a.S ||
                      (a.causal && k0 + kDqBK - 1 > qw + diag);
#pragma unroll
    for (int i = 0; i < kDqBK / 2; ++i) {
        const int r = (i >> 1) & 1;
        float p = sm90::exp2_ftz(fmaf(sc[i], sl2, -lse2[r]));
        if (mask) {
            const int key = k0 + (i / 4) * 8 + cq + (i & 1);
            if (key >= a.S || (a.causal && key > t0 + 8 * r + diag)) p = 0.f;
        }
        dp[i] = p * (dp[i] - dl[r]);
    }
}

// Persistent, as fwd_sm90: thread 256 (the producer) draws work items of
// 128 query rows from a.ticket (grid_slot order, the longest first), loads
// each item's Q and dO once and streams its K/V tiles through the ring;
// warpgroup w computes rows q0 + 64w .. q0 + 64w + 63 of an item. Per K/V
// tile j: S_j = Q.K_j^T and dP_j = dO.V_j^T (SS), then dQ += dS_{j-1}.K_{j-1}
// (RS, K_{j-1} read MN-major) while dS_j is computed on the registers.
// The epilogue stores dQ * scale; rows past T and columns past D are not
// stored.
template <int DT>
__global__ void __launch_bounds__(kSm90Threads, 1)
dq_sm90(const __grid_constant__ CUtensorMap tq,
        const __grid_constant__ CUtensorMap tk,
        const __grid_constant__ CUtensorMap tv,
        const __grid_constant__ CUtensorMap tdo, Args a) {
    using L = DqSm90<DT>;
    using Item = QItem<kDqBQ, kDqBK>;
    extern __shared__ unsigned char smem_raw[];
    unsigned char* sm = align1024(smem_raw);
    uint64_t* qfull = reinterpret_cast<uint64_t*>(sm + L::kBar);
    uint64_t* qempty = qfull + 1;
    uint64_t* full = qempty + 1;
    uint64_t* empty = full + kDqStages;
    volatile int* item_slot = reinterpret_cast<volatile int*>(sm + L::kItem);
    const int q_tiles = (a.T + kDqBQ - 1) / kDqBQ;
    const int items = a.B * a.H * q_tiles;
    const int diag = a.S - a.T;  // key k is live for row t iff k <= t + diag
    if (threadIdx.x == 0) {
        sm90::mbar_init(qfull, 1);
        sm90::mbar_init(qempty, kConsumers * 128);
        for (int s = 0; s < kDqStages; ++s) {
            sm90::mbar_init(&full[s], 1);
            sm90::mbar_init(&empty[s], kConsumers * 128);
        }
        sm90::mbar_fence_init();
    }
    __syncthreads();
    const int wg = threadIdx.x / 128;
    if (wg == kConsumers) {
        sm90::regs_dealloc<kProducerRegs>();
        if (threadIdx.x == kConsumers * 128) {
            int it = 0;  // K/V tiles loaded so far, over all items
            for (int n = 0;; ++n) {
                const int item = atomicAdd(a.ticket, 1);
                if (item >= items) {
                    sm90::mbar_wait(qempty, (n & 1) ^ 1);
                    *item_slot = -1;
                    sm90::mbar_arrive(qfull);
                    break;
                }
                const Item w(a, q_tiles, item);
                auto load_kv = [&](int j) {
                    const int s = it % kDqStages;
                    sm90::mbar_wait(&empty[s], ((it / kDqStages) & 1) ^ 1);
                    sm90::mbar_arrive_expect_tx(&full[s], 2 * L::kKVBytes);
                    for (int r = 0; r < L::kRegions; ++r) {
                        const int off = s * L::kKVBytes + r * kDqBK * sm90::kRowBytes;
                        sm90::tma_load_4d(sm + L::kK + off, &tk, &full[s],
                                          r * 64, w.h, j * kDqBK, w.b);
                        sm90::tma_load_4d(sm + L::kV + off, &tv, &full[s],
                                          r * 64, w.h, j * kDqBK, w.b);
                    }
                    ++it;
                };
                // The first K/V tiles go out while the consumers still read
                // the previous item's Q and dO; this item's once they are
                // done.
                const int early = min(w.n_tiles, kDqStages - 1);
                for (int j = 0; j < early; ++j) load_kv(j);
                sm90::mbar_wait(qempty, (n & 1) ^ 1);
                *item_slot = item;
                sm90::mbar_arrive_expect_tx(qfull, 2 * L::kQBytes);
                for (int r = 0; r < L::kRegions; ++r) {
                    const int off = r * kDqBQ * sm90::kRowBytes;
                    sm90::tma_load_4d(sm + L::kQ + off, &tq, qfull, r * 64,
                                      w.h, w.q0, w.b);
                    sm90::tma_load_4d(sm + L::kDo + off, &tdo, qfull, r * 64,
                                      w.h, w.q0, w.b);
                }
                for (int j = early; j < w.n_tiles; ++j) load_kv(j);
            }
        }
    } else {
        sm90::regs_alloc<kConsumerRegs>();
        const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
        const int cq = 2 * (lane & 3);  // first column of each pair
        const float sl2 = a.scale * kLog2e;
        const uint32_t q_base =
            sm90::smem_addr(sm + L::kQ) + wg * 64 * sm90::kRowBytes;
        const uint32_t do_base =
            sm90::smem_addr(sm + L::kDo) + wg * 64 * sm90::kRowBytes;
        int it = 0;  // K/V tiles consumed so far, over all items
        for (int n = 0;; ++n) {
            sm90::mbar_wait(qfull, n & 1);  // the item, its Q and dO
            const int item = *item_slot;
            if (item < 0) break;
            const Item w(a, q_tiles, item);
            const int qw = w.q0 + wg * 64;  // this warpgroup's first row
            const int t0 = qw + 16 * warp + lane / 4;  // rows t0 and t0 + 8
            float lse2[2], dl[2];
            row_stats(a, w.b, w.h, t0, lse2[0], dl[0]);
            row_stats(a, w.b, w.h, t0 + 8, lse2[1], dl[1]);
            float dq[DT / 2];
#pragma unroll
            for (int i = 0; i < DT / 2; ++i) dq[i] = 0.f;
            float sc[kDqBK / 2], dp[kDqBK / 2];
            uint32_t da[kDqBK / 16][4];
            // Tiles past this warpgroup's last live key are only released.
            const int end_w = a.causal ? min(a.S, qw + 64 + diag) : a.S;
            const int n_live = end_w > 0 ? (end_w + kDqBK - 1) / kDqBK : 0;
            const uint32_t k_ring = sm90::smem_addr(sm + L::kK);
            const uint32_t v_ring = sm90::smem_addr(sm + L::kV);
            // Tile 0: S_0, dP_0 and dS_0. Tile j > 0: issue S_j and dP_j,
            // then dQ += dS_{j-1}.K_{j-1}; dS_j is computed while the
            // second product is in flight. (No product sits in a branch of
            // its own: ptxas would serialise them.)
            if (n_live > 0) {
                sm90::mbar_wait(&full[it % kDqStages], (it / kDqStages) & 1);
                sm90::wgmma_fence();
                dq_products<DT>(sc, dp, q_base, do_base, k_ring, v_ring,
                                (it % kDqStages) * L::kKVBytes);
                sm90::wgmma_commit();
                sm90::wgmma_wait<0>();
                sm90::fence_regs(sc);
                sm90::fence_regs(dp);
                dq_scores(sc, dp, lse2, dl, 0, t0, qw, cq, sl2, a);
#pragma unroll
                for (int kk = 0; kk < kDqBK / 16; ++kk) sm90::acc_to_a(dp, kk, da[kk]);
            }
            for (int j = 1; j < n_live; ++j) {
                const int s = (it + j) % kDqStages;
                sm90::mbar_wait(&full[s], ((it + j) / kDqStages) & 1);
                sm90::wgmma_fence();
                dq_products<DT>(sc, dp, q_base, do_base, k_ring, v_ring,
                                s * L::kKVBytes);
                sm90::wgmma_commit();
                dq_accumulate<DT>(dq, da,
                                  k_ring + ((it + j - 1) % kDqStages) * L::kKVBytes);
                sm90::wgmma_commit();
                sm90::wgmma_wait<1>();
                sm90::fence_regs(sc);
                sm90::fence_regs(dp);
                dq_scores(sc, dp, lse2, dl, j * kDqBK, t0, qw, cq, sl2, a);
                sm90::wgmma_wait<0>();  // dQ += dS_{j-1}.K_{j-1} is done
                sm90::fence_regs(dq);
                sm90::mbar_arrive(&empty[(it + j - 1) % kDqStages]);
#pragma unroll
                for (int kk = 0; kk < kDqBK / 16; ++kk) sm90::acc_to_a(dp, kk, da[kk]);
            }
            if (n_live > 0) {  // the last tile's dQ += dS.K
                sm90::wgmma_fence();
                dq_accumulate<DT>(
                    dq, da, k_ring + ((it + n_live - 1) % kDqStages) * L::kKVBytes);
                sm90::wgmma_commit();
                sm90::wgmma_wait<0>();
                sm90::fence_regs(dq);
                sm90::mbar_arrive(&empty[(it + n_live - 1) % kDqStages]);
            }
            sm90::mbar_arrive(qempty);  // done with this item's Q and dO
            for (int j = n_live; j < w.n_tiles; ++j) {
                const int s = (it + j) % kDqStages;
                sm90::mbar_wait(&full[s], ((it + j) / kDqStages) & 1);
                sm90::mbar_arrive(&empty[s]);
            }
            it += w.n_tiles;
            bf16* qb = static_cast<bf16*>(a.dq.p) + w.b * a.dq.sb + w.h * a.dq.sh;
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int t = t0 + 8 * half;
                if (t >= a.T) continue;
                bf16* row = qb + static_cast<int64_t>(t) * a.dq.st;
#pragma unroll
                for (int jj = 0; jj < DT / 8; ++jj) {
                    const int col = jj * 8 + cq;
                    const int i = 4 * jj + 2 * half;
                    if (col < a.D)
                        *reinterpret_cast<uint32_t*>(row + col) = sm90::pack_bf16(
                            dq[i] * a.scale, dq[i + 1] * a.scale);
                }
            }
        }
    }
}

// Shared memory of dkv_sm90: K and V (128 rows), kDkvStages Q and dO tiles
// (64 rows), each stage's lse·log2(e) and delta', then the barriers.
template <int DT> struct DkvSm90 {
    static constexpr int kRegions = DT / 64;
    static constexpr int kKBytes = kRegions * kDkvBK * sm90::kRowBytes;
    static constexpr int kQBytes = kRegions * kDkvBQ * sm90::kRowBytes;
    static constexpr int kK = 0;
    static constexpr int kV = kK + kKBytes;
    static constexpr int kQ = kV + kKBytes;
    static constexpr int kDo = kQ + kDkvStages * kQBytes;
    static constexpr int kStats = kDo + kDkvStages * kQBytes;
    static constexpr int kBar = kStats + 2 * kDkvStages * kDkvBQ * 4;
    static constexpr int kBytes = kBar + 8 * (1 + 2 * kDkvStages) + 1024;
};

// grid B*H*k-tiles (grid_slot): within a group of heads the first k-tile
// (most live q-tiles) first.
// Consumer warpgroup w owns keys k0 + 64w .. k0 + 64w + 63 and computes
// transposed: S^T = K.Q^T and dP^T = V.dO^T with K and V resident, so
// P^T and dS^T are already the A operands of dV += P^T.dO and dK +=
// dS^T.Q. Warp 8 (the producer) streams Q/dO by TMA and each tile's row
// statistics with plain loads.
template <int DT>
__global__ void __launch_bounds__(kSm90Threads, 1)
dkv_sm90(const __grid_constant__ CUtensorMap tq,
         const __grid_constant__ CUtensorMap tk,
         const __grid_constant__ CUtensorMap tv,
         const __grid_constant__ CUtensorMap tdo, Args a) {
    using L = DkvSm90<DT>;
    extern __shared__ unsigned char smem_raw[];
    unsigned char* sm = align1024(smem_raw);
    float* stats = reinterpret_cast<float*>(sm + L::kStats);
    uint64_t* kvbar = reinterpret_cast<uint64_t*>(sm + L::kBar);
    uint64_t* full = kvbar + 1;
    uint64_t* empty = full + kDkvStages;
    int bh, rank;
    grid_slot(a, (a.S + kDkvBK - 1) / kDkvBK, blockIdx.x, bh, rank);
    const int b = bh / a.H, h = bh % a.H;
    const int k0 = rank * kDkvBK;
    const int diag = a.S - a.T;
    // The first query row that sees key k0 is k0 - diag.
    const int q_first = a.causal ? (max(0, k0 - diag) / kDkvBQ) * kDkvBQ : 0;
    const int n_tiles = (a.T - q_first + kDkvBQ - 1) / kDkvBQ;
    if (threadIdx.x == 0) {
        sm90::mbar_init(kvbar, 1);
        for (int s = 0; s < kDkvStages; ++s) {
            sm90::mbar_init(&full[s], 32);  // the producer warp's lanes
            sm90::mbar_init(&empty[s], kConsumers * 128);
        }
        sm90::mbar_fence_init();
    }
    __syncthreads();
    const int wg = threadIdx.x / 128;
    const int lane = threadIdx.x & 31;
    if (wg == kConsumers) {
        sm90::regs_dealloc<kProducerRegs>();
        if (threadIdx.x < kConsumers * 128 + 32) {
            if (lane == 0) {
                sm90::mbar_arrive_expect_tx(kvbar, 2 * L::kKBytes);
                for (int r = 0; r < L::kRegions; ++r) {
                    const int off = r * kDkvBK * sm90::kRowBytes;
                    sm90::tma_load_4d(sm + L::kK + off, &tk, kvbar, r * 64, h, k0, b);
                    sm90::tma_load_4d(sm + L::kV + off, &tv, kvbar, r * 64, h, k0, b);
                }
            }
            for (int j = 0; j < n_tiles; ++j) {
                const int s = j % kDkvStages;
                const int q0 = q_first + j * kDkvBQ;
                sm90::mbar_wait(&empty[s], ((j / kDkvStages) & 1) ^ 1);
                // lse (non-finite -> 0.5 FLT_MAX, so that P = 0; rows past
                // T likewise) in log2 units, and delta'.
                for (int r = lane; r < kDkvBQ; r += 32) {
                    const int t = q0 + r;
                    float lse = kBigLse, dl = 0.f;
                    if (t < a.T) {
                        const int64_t i = (static_cast<int64_t>(b) * a.T + t) * a.H + h;
                        lse = a.lse[i];
                        if (!isfinite(lse)) lse = kBigLse;
                        dl = a.delta[i];
                    }
                    stats[s * kDkvBQ + r] = lse * kLog2e;
                    stats[(kDkvStages + s) * kDkvBQ + r] = dl;
                }
                if (lane == 0) {
                    sm90::mbar_arrive_expect_tx(&full[s], 2 * L::kQBytes);
                    for (int r = 0; r < L::kRegions; ++r) {
                        const int off = s * L::kQBytes + r * kDkvBQ * sm90::kRowBytes;
                        sm90::tma_load_4d(sm + L::kQ + off, &tq, &full[s], r * 64,
                                          h, q0, b);
                        sm90::tma_load_4d(sm + L::kDo + off, &tdo, &full[s],
                                          r * 64, h, q0, b);
                    }
                } else {
                    sm90::mbar_arrive(&full[s]);
                }
            }
        }
    } else {
        sm90::regs_alloc<kConsumerRegs>();
        const int warp = (threadIdx.x >> 5) & 3;
        const int kw = k0 + wg * 64;  // this warpgroup's first key
        const int key0 = kw + 16 * warp + lane / 4;  // keys key0 and key0 + 8
        const int cq = 2 * (lane & 3);
        const float sl2 = a.scale * kLog2e;
        const uint32_t k_base =
            sm90::smem_addr(sm + L::kK) + wg * 64 * sm90::kRowBytes;
        const uint32_t v_base =
            sm90::smem_addr(sm + L::kV) + wg * 64 * sm90::kRowBytes;
        float dk[DT / 2], dv[DT / 2];
#pragma unroll
        for (int i = 0; i < DT / 2; ++i) dk[i] = dv[i] = 0.f;
        sm90::mbar_wait(kvbar, 0);
        for (int j = 0; j < n_tiles; ++j) {
            const int s = j % kDkvStages;
            const int q0 = q_first + j * kDkvBQ;
            sm90::mbar_wait(&full[s], (j / kDkvStages) & 1);
            if (a.causal && kw > q0 + kDkvBQ - 1 + diag) {  // no live pair
                sm90::mbar_arrive(&empty[s]);
                continue;
            }
            const uint32_t q_base = sm90::smem_addr(sm + L::kQ + s * L::kQBytes);
            const uint32_t do_base = sm90::smem_addr(sm + L::kDo + s * L::kQBytes);
            float st[32], dpt[32];
            sm90::wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < DT / 16; ++kk)
                sm90::wgmma_ss_n64(st, k_major(k_base, kDkvBK, kk),
                                   k_major(q_base, kDkvBQ, kk), kk > 0);
#pragma unroll
            for (int kk = 0; kk < DT / 16; ++kk)
                sm90::wgmma_ss_n64(dpt, k_major(v_base, kDkvBK, kk),
                                   k_major(do_base, kDkvBQ, kk), kk > 0);
            sm90::wgmma_commit();
            sm90::wgmma_wait<0>();
            sm90::fence_regs(st);
            sm90::fence_regs(dpt);
            const float* lse_s = stats + s * kDkvBQ;
            const float* dl_s = stats + (kDkvStages + s) * kDkvBQ;
            // The causal mask only where a key of ours passes the
            // diagonal of the tile's first row.
            const bool mask = a.causal && kw + 63 > q0 + diag;
#pragma unroll
            for (int i = 0; i < 32; ++i) {
                const int c = (i / 4) * 8 + cq + (i & 1);  // query q0 + c
                float p = sm90::exp2_ftz(fmaf(st[i], sl2, -lse_s[c]));
                if (mask && key0 + ((i >> 1) & 1) * 8 > q0 + c + diag) p = 0.f;
                dpt[i] = p * (dpt[i] - dl_s[c]);
                st[i] = p;
            }
            uint32_t pa[kDkvBQ / 16][4], da[kDkvBQ / 16][4];
#pragma unroll
            for (int kk = 0; kk < kDkvBQ / 16; ++kk) {
                sm90::acc_to_a(st, kk, pa[kk]);
                sm90::acc_to_a(dpt, kk, da[kk]);
            }
            sm90::wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < kDkvBQ / 16; ++kk)
                mma_mn<DT>(dv, pa[kk], do_base, kDkvBQ, kk);
#pragma unroll
            for (int kk = 0; kk < kDkvBQ / 16; ++kk)
                mma_mn<DT>(dk, da[kk], q_base, kDkvBQ, kk);
            sm90::wgmma_commit();
            sm90::wgmma_wait<0>();
            sm90::fence_regs(dv);
            sm90::fence_regs(dk);
            sm90::mbar_arrive(&empty[s]);
        }
        bf16* dkb = static_cast<bf16*>(a.dk.p) + b * a.dk.sb + h * a.dk.sh;
        bf16* dvb = static_cast<bf16*>(a.dv.p) + b * a.dv.sb + h * a.dv.sh;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const int key = key0 + 8 * half;
            if (key >= a.S) continue;
            bf16* krow = dkb + static_cast<int64_t>(key) * a.dk.st;
            bf16* vrow = dvb + static_cast<int64_t>(key) * a.dv.st;
#pragma unroll
            for (int jj = 0; jj < DT / 8; ++jj) {
                const int col = jj * 8 + cq;
                const int i = 4 * jj + 2 * half;
                if (col < a.D) {
                    *reinterpret_cast<uint32_t*>(krow + col) = sm90::pack_bf16(
                        dk[i] * a.scale, dk[i + 1] * a.scale);
                    *reinterpret_cast<uint32_t*>(vrow + col) =
                        sm90::pack_bf16(dv[i], dv[i + 1]);
                }
            }
        }
    }
}

// ---- fp32 B1, B2 and B3: three-pass TF32 with register accumulators -------

// 8 warps, 16 query rows (B1, B2) or keys (B3) each
constexpr int kTfThreads = 256;
// B1: 128 query rows a CTA, 64-key K/V tiles. B2: 128 query rows a CTA,
// 32-key K/V tiles (Q and dO take 135 KB at D 128). B3: 128 keys a CTA,
// 32-row Q/dO tiles.
constexpr int kTfFwdBQ = 128, kTfFwdBK = 64;
constexpr int kTfDqBQ = 128, kTfDqBK = 32;
constexpr int kTfDkvBK = 128, kTfDkvBQ = 32;
// Depth of the cp.async ring of streamed tiles (K/V for B1 and B2, Q/dO
// for B3); 1 loads each tile between two __syncthreads, with no overlap.
constexpr int kTfStages = 2;
// mma.sync adds its products to the fp32 accumulator with truncation, not
// round-to-nearest, so a long chain of products into one accumulator
// drifts toward zero (at T 2048 dK, dV and a non-causal O read 1.5-2.2e-5
// relative error through a chain over every key or query). So every chain
// is one tile long and starts from zero (S and dP over the head dim, O
// over a 64-key tile, dQ over a 32-key tile, dK and dV over a 32-query
// tile), and the tiles' sums are
// added with FADD, which rounds to nearest.

// Row stride of an fp32 tile of head-dim tile DT: DT + 4 floats, so that
// every fragment read of tf32x3.cuh hits 32 distinct banks.
template <int DT> __host__ __device__ constexpr int tf_ld() { return DT + 4; }

// Rows [r0, r0 + R) and columns [0, DT) of one (b, h) slice into dst by
// cp.async, 16 bytes a thread; rows at or past `rows` and columns at or
// past D arrive as zeros.
template <int DT>
__device__ __forceinline__ void tf_load(float* dst, const float* src,
                                        int64_t st, int r0, int R, int rows,
                                        int D) {
    constexpr int chunks = DT / 4;
    for (int i = threadIdx.x; i < R * chunks; i += kTfThreads) {
        const int r = i / chunks, c = (i - r * chunks) * 4;
        const bool in = r0 + r < rows && c < D;
        tf32x3::cp_async16(dst + r * tf_ld<DT>() + c,
                           in ? src + static_cast<int64_t>(r0 + r) * st + c : src,
                           in ? 16 : 0);
    }
}

// Waits for stream tile j of the ring (every thread's copies, then the
// block), after which the stage that tile j - 1 used is free.
__device__ __forceinline__ void tf_ring_wait() {
    tf32x3::cp_async_wait<(kTfStages > 1 ? kTfStages - 2 : 0)>();
    __syncthreads();
}

// Shared memory of fwd_tf32 (floats): Q (128 rows), then kTfStages K tiles
// and as many V tiles (64 rows each).
template <int DT> struct TfFwdSmem {
    static constexpr int kTile = kTfFwdBK * tf_ld<DT>();
    static constexpr int kQ = 0;
    static constexpr int kK = kTfFwdBQ * tf_ld<DT>();
    static constexpr int kV = kK + kTfStages * kTile;
    static constexpr size_t kBytes = (kV + kTfStages * kTile) * sizeof(float);
};

// grid B*H*q-tiles (grid_slot, one group of all heads): the last q-tiles
// (most live k-tiles) first. Warp w owns rows q0 + 16w .. q0 + 16w + 15
// and keeps S (16 x 64) and O (16 x DT) in registers.
template <int DT>
__global__ void __launch_bounds__(kTfThreads, 1) fwd_tf32(Args a) {
    using L = TfFwdSmem<DT>;
    constexpr int ld = tf_ld<DT>(), NT = DT / 8, NK = kTfFwdBK / 8;
    extern __shared__ __align__(128) float smf[];
    const int q_tiles = (a.T + kTfFwdBQ - 1) / kTfFwdBQ;
    int bh, rank;
    grid_slot(a, q_tiles, blockIdx.x, bh, rank);
    const int b = bh / a.H, h = bh % a.H;
    const int q0 = (q_tiles - 1 - rank) * kTfFwdBQ;
    const int diag = a.S - a.T;  // key k is live for row t iff k <= t + diag
    const int end = a.causal ? min(a.S, q0 + kTfFwdBQ + diag) : a.S;
    const int n_tiles = end > 0 ? (end + kTfFwdBK - 1) / kTfFwdBK : 0;
    const float* kb = slice<float>(a.k, b, h);
    const float* vb = slice<float>(a.v, b, h);
    auto load_kv = [&](int j) {  // one cp.async group, empty past the end
        if (j < n_tiles) {
            const int s = j % kTfStages;
            tf_load<DT>(smf + L::kK + s * L::kTile, kb, a.k.st, j * kTfFwdBK,
                        kTfFwdBK, a.S, a.D);
            tf_load<DT>(smf + L::kV + s * L::kTile, vb, a.v.st, j * kTfFwdBK,
                        kTfFwdBK, a.S, a.D);
        }
        tf32x3::cp_async_commit();
    };
    // Q rides in the first group.
    tf_load<DT>(smf + L::kQ, slice<float>(a.q, b, h), a.q.st, q0, kTfFwdBQ,
                a.T, a.D);
    for (int j = 0; j < kTfStages - 1; ++j) load_kv(j);

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int qw = q0 + 16 * warp;  // this warp's first row
    const int row0 = qw + g;        // this thread's rows row0 and row0 + 8
    const float sl2 = a.scale * kLog2e;
    const float* qs = smf + L::kQ + 16 * warp * ld;
    // Keys past end_w are dead for every row of this warp.
    const int end_w = qw >= a.T ? 0 : a.causal ? min(a.S, qw + 16 + diag) : a.S;
    float o[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    for (int j = 0; j < n_tiles; ++j) {
        if constexpr (kTfStages == 1) load_kv(j);
        tf_ring_wait();
        if constexpr (kTfStages > 1) load_kv(j + kTfStages - 1);
        const int k0 = j * kTfFwdBK;
        if (k0 < end_w) {
            const float* ks = smf + L::kK + (j % kTfStages) * L::kTile;
            const float* vs = smf + L::kV + (j % kTfStages) * L::kTile;
            // S = Q.K^T.
            float sc[NK][4] = {};
#pragma unroll
            for (int kd = 0; kd < DT; kd += 8) {
                float af[4];
                uint32_t ab[4], as[4];
                tf32x3::a_rows(qs, ld, kd, af);
                tf32x3::split(af, ab, as);
#pragma unroll
                for (int n = 0; n < NK; ++n) {
                    float bf[2];
                    uint32_t bb[2], bs[2];
                    tf32x3::b_cols(ks + 8 * n * ld, ld, kd, bf);
                    tf32x3::split(bf, bb, bs);
                    tf32x3::mma3(sc[n], ab, as, bb, bs);
                }
            }
            // Online softmax in log2 units (x = s * scale * log2 e); the mask
            // only on a tile where a key may be dead (past S, or past the
            // diagonal of the warp's first row).
            const bool mask = k0 + kTfFwdBK > a.S ||
                              (a.causal && k0 + kTfFwdBK - 1 > qw + diag);
            float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
            for (int n = 0; n < NK; ++n)
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    if (mask) {
                        const int key = k0 + 8 * n + 2 * t + (i & 1);
                        const int row = row0 + 8 * (i >> 1);
                        if (key >= a.S || (a.causal && key > row + diag))
                            sc[n][i] = -INFINITY;
                    }
                    mx[i >> 1] = fmaxf(mx[i >> 1], sc[n][i]);
                }
            float shift[2], corr[2];
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                const float mn = fmaxf(m[r], quad_max(mx[r]) * sl2);
                // A row with no live key yet: exp2(-inf - -inf) would be NaN.
                shift[r] = mn == -INFINITY ? 0.f : mn;
                corr[r] = sm90::exp2_ftz(m[r] - shift[r]);
                m[r] = mn;
                l[r] *= corr[r];
            }
#pragma unroll
            for (int n = 0; n < NK; ++n)
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const float p = sm90::exp2_ftz(fmaf(sc[n][i], sl2, -shift[i >> 1]));
                    sc[n][i] = p;
                    l[i >> 1] += p;
                }
#pragma unroll
            for (int n = 0; n < NT; ++n)
#pragma unroll
                for (int i = 0; i < 4; ++i) o[n][i] *= corr[i >> 1];
            // O += P.V, P from registers: one chain over the tile's keys
            // for each 8 columns of O.
            uint32_t pb[NK][4], ps[NK][4];
#pragma unroll
            for (int kk = 0; kk < NK; ++kk) {
                float af[4];
                tf32x3::c_to_a(sc[kk], af);
                tf32x3::split(af, pb[kk], ps[kk]);
            }
#pragma unroll
            for (int n = 0; n < NT; ++n) {
                float acc[4] = {};
#pragma unroll
                for (int kk = 0; kk < NK; ++kk) {
                    float bf[2];
                    uint32_t bb[2], bs[2];
                    tf32x3::b_rows_paired(vs + 8 * kk * ld, ld, 8 * n, bf);
                    tf32x3::split(bf, bb, bs);
                    tf32x3::mma3(acc, pb[kk], ps[kk], bb, bs);
                }
#pragma unroll
                for (int i = 0; i < 4; ++i) o[n][i] += acc[i];
            }
        }
        if constexpr (kTfStages == 1) __syncthreads();
    }
    tf32x3::cp_async_wait<0>();  // no copy in flight at exit (n_tiles 0)
    float* ob = slice_out<float>(a.o, b, h);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
        const float lsum = quad_sum(l[half]);
        const int row = row0 + 8 * half;
        if (row >= a.T) continue;
        const float inv = 1.f / fmaxf(lsum, 1e-30f);
        float* orow = ob + static_cast<int64_t>(row) * a.o.st;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
            const int col = 8 * n + 2 * t;
            if (col < a.D)
                *reinterpret_cast<float2*>(orow + col) =
                    make_float2(o[n][2 * half] * inv, o[n][2 * half + 1] * inv);
        }
        if (t == 0)
            a.lse[(static_cast<int64_t>(b) * a.T + row) * a.H + h] =
                lsum > 0.f ? m[half] * kLn2 + logf(lsum) : -INFINITY;
    }
}

// Shared memory of dq_tf32 (floats): Q and dO (128 rows), then kTfStages K
// tiles and as many V tiles (32 rows each).
template <int DT> struct TfDqSmem {
    static constexpr int kTile = kTfDqBK * tf_ld<DT>();
    static constexpr int kQ = 0;
    static constexpr int kDo = kTfDqBQ * tf_ld<DT>();
    static constexpr int kK = 2 * kDo;
    static constexpr int kV = kK + kTfStages * kTile;
    static constexpr size_t kBytes = (kV + kTfStages * kTile) * sizeof(float);
};

// grid B*H*q-tiles (grid_slot, one group of all heads): the last q-tiles
// (most live k-tiles) first. Warp w owns rows q0 + 16w .. q0 + 16w + 15
// and keeps S and dP (16 x 32) and dQ (16 x DT) in registers; dS =
// P * (dP - delta') is the A fragment of dQ += dS.K, whose B operand is
// read from the K tile in the order of a C fragment (b_rows_paired).
template <int DT>
__global__ void __launch_bounds__(kTfThreads, 1) dq_tf32(Args a) {
    using L = TfDqSmem<DT>;
    constexpr int ld = tf_ld<DT>(), NT = DT / 8, NK = kTfDqBK / 8;
    extern __shared__ __align__(128) float smf[];
    const int q_tiles = (a.T + kTfDqBQ - 1) / kTfDqBQ;
    int bh, rank;
    grid_slot(a, q_tiles, blockIdx.x, bh, rank);
    const int b = bh / a.H, h = bh % a.H;
    const int q0 = (q_tiles - 1 - rank) * kTfDqBQ;
    const int diag = a.S - a.T;  // key k is live for row t iff k <= t + diag
    const int end = a.causal ? min(a.S, q0 + kTfDqBQ + diag) : a.S;
    const int n_tiles = end > 0 ? (end + kTfDqBK - 1) / kTfDqBK : 0;
    const float* kb = slice<float>(a.k, b, h);
    const float* vb = slice<float>(a.v, b, h);
    auto load_kv = [&](int j) {  // one cp.async group, empty past the end
        if (j < n_tiles) {
            const int s = j % kTfStages;
            tf_load<DT>(smf + L::kK + s * L::kTile, kb, a.k.st, j * kTfDqBK,
                        kTfDqBK, a.S, a.D);
            tf_load<DT>(smf + L::kV + s * L::kTile, vb, a.v.st, j * kTfDqBK,
                        kTfDqBK, a.S, a.D);
        }
        tf32x3::cp_async_commit();
    };
    // Q and dO ride in the first group.
    tf_load<DT>(smf + L::kQ, slice<float>(a.q, b, h), a.q.st, q0, kTfDqBQ,
                a.T, a.D);
    tf_load<DT>(smf + L::kDo, slice<float>(a.o, b, h), a.o.st, q0, kTfDqBQ,
                a.T, a.D);
    for (int j = 0; j < kTfStages - 1; ++j) load_kv(j);

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int qw = q0 + 16 * warp;  // this warp's first row
    const int row0 = qw + g;        // this thread's rows row0 and row0 + 8
    const float sl2 = a.scale * kLog2e;
    const float* qs = smf + L::kQ + 16 * warp * ld;
    const float* dos = smf + L::kDo + 16 * warp * ld;
    // Keys past end_w are dead for every row of this warp.
    const int end_w = qw >= a.T ? 0 : a.causal ? min(a.S, qw + 16 + diag) : a.S;
    float lse2[2], dl[2];
    row_stats(a, b, h, row0, lse2[0], dl[0]);
    row_stats(a, b, h, row0 + 8, lse2[1], dl[1]);
    float dq[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;
    for (int j = 0; j < n_tiles; ++j) {
        if constexpr (kTfStages == 1) load_kv(j);
        tf_ring_wait();
        if constexpr (kTfStages > 1) load_kv(j + kTfStages - 1);
        const int k0 = j * kTfDqBK;
        if (k0 < end_w) {
            const float* ks = smf + L::kK + (j % kTfStages) * L::kTile;
            const float* vs = smf + L::kV + (j % kTfStages) * L::kTile;
            // S = Q.K^T and dP = dO.V^T.
            float sc[NK][4] = {}, dp[NK][4] = {};
#pragma unroll
            for (int kd = 0; kd < DT; kd += 8) {
                float qf[4], of[4];
                uint32_t qbig[4], qsmall[4], obig[4], osmall[4];
                tf32x3::a_rows(qs, ld, kd, qf);
                tf32x3::split(qf, qbig, qsmall);
                tf32x3::a_rows(dos, ld, kd, of);
                tf32x3::split(of, obig, osmall);
#pragma unroll
                for (int n = 0; n < NK; ++n) {
                    float bf[2];
                    uint32_t bb[2], bs[2];
                    tf32x3::b_cols(ks + 8 * n * ld, ld, kd, bf);
                    tf32x3::split(bf, bb, bs);
                    tf32x3::mma3(sc[n], qbig, qsmall, bb, bs);
                    tf32x3::b_cols(vs + 8 * n * ld, ld, kd, bf);
                    tf32x3::split(bf, bb, bs);
                    tf32x3::mma3(dp[n], obig, osmall, bb, bs);
                }
            }
            // dS = P * (dP - delta'); the mask only on a tile where a key
            // may be dead (past S, or past the diagonal of the warp's first
            // row).
            const bool mask = k0 + kTfDqBK > a.S ||
                              (a.causal && k0 + kTfDqBK - 1 > qw + diag);
#pragma unroll
            for (int n = 0; n < NK; ++n)
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    float p = sm90::exp2_ftz(fmaf(sc[n][i], sl2, -lse2[i >> 1]));
                    if (mask) {
                        const int key = k0 + 8 * n + 2 * t + (i & 1);
                        const int row = row0 + 8 * (i >> 1);
                        if (key >= a.S || (a.causal && key > row + diag)) p = 0.f;
                    }
                    dp[n][i] = p * (dp[n][i] - dl[i >> 1]);
                }
            // dQ += dS.K, dS from registers: one chain over the tile's keys
            // for each 8 columns of dQ.
            uint32_t gb[NK][4], gs[NK][4];
#pragma unroll
            for (int kk = 0; kk < NK; ++kk) {
                float af[4];
                tf32x3::c_to_a(dp[kk], af);
                tf32x3::split(af, gb[kk], gs[kk]);
            }
#pragma unroll
            for (int n = 0; n < NT; ++n) {
                float acc[4] = {};
#pragma unroll
                for (int kk = 0; kk < NK; ++kk) {
                    float bf[2];
                    uint32_t bb[2], bs[2];
                    tf32x3::b_rows_paired(ks + 8 * kk * ld, ld, 8 * n, bf);
                    tf32x3::split(bf, bb, bs);
                    tf32x3::mma3(acc, gb[kk], gs[kk], bb, bs);
                }
#pragma unroll
                for (int i = 0; i < 4; ++i) dq[n][i] += acc[i];
            }
        }
        if constexpr (kTfStages == 1) __syncthreads();
    }
    tf32x3::cp_async_wait<0>();  // no copy in flight at exit (n_tiles 0)
    float* qb = slice_out<float>(a.dq, b, h);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
        const int row = row0 + 8 * half;
        if (row >= a.T) continue;
        float* out = qb + static_cast<int64_t>(row) * a.dq.st;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
            const int col = 8 * n + 2 * t;
            if (col < a.D)
                *reinterpret_cast<float2*>(out + col) = make_float2(
                    dq[n][2 * half] * a.scale, dq[n][2 * half + 1] * a.scale);
        }
    }
}

// Shared memory of dkv_tf32 (floats): K and V (128 rows), kTfStages Q
// and dO tiles (32 rows), then each stage's lse·log2(e) and delta'.
template <int DT> struct TfDkvSmem {
    static constexpr int kTile = kTfDkvBQ * tf_ld<DT>();
    static constexpr int kK = 0;
    static constexpr int kV = kTfDkvBK * tf_ld<DT>();
    static constexpr int kQ = 2 * kV;
    static constexpr int kDo = kQ + kTfStages * kTile;
    static constexpr int kStats = kDo + kTfStages * kTile;
    static constexpr size_t kBytes =
        (kStats + kTfStages * 2 * kTfDkvBQ) * sizeof(float);
};

// grid B*H*k-tiles (grid_slot, one group of all heads): the first k-tiles
// (most live q-tiles) first. Warp w owns keys k0 + 16w .. k0 + 16w + 15 and
// computes transposed: S^T = K.Q^T and dP^T = V.dO^T, so that P^T and dS^T
// are the A operands of dV += P^T.dO and dK += dS^T.Q; dK and dV stay in
// registers across the whole q loop.
template <int DT>
__global__ void __launch_bounds__(kTfThreads, 1) dkv_tf32(Args a) {
    using L = TfDkvSmem<DT>;
    constexpr int ld = tf_ld<DT>(), NT = DT / 8, NQ = kTfDkvBQ / 8;
    extern __shared__ __align__(128) float smf[];
    int bh, rank;
    grid_slot(a, (a.S + kTfDkvBK - 1) / kTfDkvBK, blockIdx.x, bh, rank);
    const int b = bh / a.H, h = bh % a.H;
    const int k0 = rank * kTfDkvBK;
    const int diag = a.S - a.T;
    // The first query row that sees key k0 is k0 - diag.
    const int q_first = a.causal ? (max(0, k0 - diag) / kTfDkvBQ) * kTfDkvBQ : 0;
    const int n_tiles = max(0, (a.T - q_first + kTfDkvBQ - 1) / kTfDkvBQ);
    const float* qb = slice<float>(a.q, b, h);
    const float* db = slice<float>(a.o, b, h);
    float* stats = smf + L::kStats;
    auto load_q = [&](int j) {  // one cp.async group, empty past the end
        if (j < n_tiles) {
            const int s = j % kTfStages, q0 = q_first + j * kTfDkvBQ;
            tf_load<DT>(smf + L::kQ + s * L::kTile, qb, a.q.st, q0, kTfDkvBQ,
                        a.T, a.D);
            tf_load<DT>(smf + L::kDo + s * L::kTile, db, a.o.st, q0, kTfDkvBQ,
                        a.T, a.D);
            for (int r = threadIdx.x; r < kTfDkvBQ; r += kTfThreads)
                row_stats(a, b, h, q0 + r, stats[2 * s * kTfDkvBQ + r],
                          stats[(2 * s + 1) * kTfDkvBQ + r]);
        }
        tf32x3::cp_async_commit();
    };
    // K and V ride in the first group.
    tf_load<DT>(smf + L::kK, slice<float>(a.k, b, h), a.k.st, k0, kTfDkvBK,
                a.S, a.D);
    tf_load<DT>(smf + L::kV, slice<float>(a.v, b, h), a.v.st, k0, kTfDkvBK,
                a.S, a.D);
    for (int j = 0; j < kTfStages - 1; ++j) load_q(j);

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int kw = k0 + 16 * warp;  // this warp's first key
    const int key0 = kw + g;        // this thread's keys key0 and key0 + 8
    const float sl2 = a.scale * kLog2e;
    const float* ks = smf + L::kK + 16 * warp * ld;
    const float* vs = smf + L::kV + 16 * warp * ld;
    float dk[NT][4], dv[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) dk[n][i] = dv[n][i] = 0.f;
    for (int j = 0; j < n_tiles; ++j) {
        if constexpr (kTfStages == 1) load_q(j);
        tf_ring_wait();
        if constexpr (kTfStages > 1) load_q(j + kTfStages - 1);
        const int q0 = q_first + j * kTfDkvBQ;
        // Products only where one of this warp's keys is live for a row.
        if (kw < a.S && !(a.causal && kw > q0 + kTfDkvBQ - 1 + diag)) {
            const int s = j % kTfStages;
            const float* qs = smf + L::kQ + s * L::kTile;
            const float* dos = smf + L::kDo + s * L::kTile;
            const float* lse2 = stats + 2 * s * kTfDkvBQ;
            const float* dl = lse2 + kTfDkvBQ;
            // S^T = K.Q^T and dP^T = V.dO^T.
            float st[NQ][4], dpt[NQ][4];
#pragma unroll
            for (int n = 0; n < NQ; ++n)
#pragma unroll
                for (int i = 0; i < 4; ++i) st[n][i] = dpt[n][i] = 0.f;
#pragma unroll
            for (int kd = 0; kd < DT; kd += 8) {
                float kf[4], vf[4];
                uint32_t kbig[4], ksmall[4], vbig[4], vsmall[4];
                tf32x3::a_rows(ks, ld, kd, kf);
                tf32x3::split(kf, kbig, ksmall);
                tf32x3::a_rows(vs, ld, kd, vf);
                tf32x3::split(vf, vbig, vsmall);
#pragma unroll
                for (int n = 0; n < NQ; ++n) {
                    float bf[2];
                    uint32_t bb[2], bs[2];
                    tf32x3::b_cols(qs + 8 * n * ld, ld, kd, bf);
                    tf32x3::split(bf, bb, bs);
                    tf32x3::mma3(st[n], kbig, ksmall, bb, bs);
                    tf32x3::b_cols(dos + 8 * n * ld, ld, kd, bf);
                    tf32x3::split(bf, bb, bs);
                    tf32x3::mma3(dpt[n], vbig, vsmall, bb, bs);
                }
            }
            // P^T and dS^T = P^T * (dP^T - delta'); the causal mask only
            // where a key of ours passes the diagonal of the tile's first row.
            const bool mask = a.causal && kw + 15 > q0 + diag;
#pragma unroll
            for (int n = 0; n < NQ; ++n)
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const int c = 8 * n + 2 * t + (i & 1);  // query q0 + c
                    float p = sm90::exp2_ftz(fmaf(st[n][i], sl2, -lse2[c]));
                    if (mask && key0 + 8 * (i >> 1) > q0 + c + diag) p = 0.f;
                    dpt[n][i] = p * (dpt[n][i] - dl[c]);
                    st[n][i] = p;
                }
            // dV += P^T.dO and dK += dS^T.Q, both A operands from
            // registers: one chain over the tile's queries for each 8
            // columns of dK and dV.
            uint32_t pb[NQ][4], ps[NQ][4], gb[NQ][4], gs[NQ][4];
#pragma unroll
            for (int kk = 0; kk < NQ; ++kk) {
                float af[4];
                tf32x3::c_to_a(st[kk], af);
                tf32x3::split(af, pb[kk], ps[kk]);
                tf32x3::c_to_a(dpt[kk], af);
                tf32x3::split(af, gb[kk], gs[kk]);
            }
#pragma unroll
            for (int n = 0; n < NT; ++n) {
                float av[4] = {}, ak[4] = {};
#pragma unroll
                for (int kk = 0; kk < NQ; ++kk) {
                    float bf[2];
                    uint32_t bb[2], bs[2];
                    tf32x3::b_rows_paired(dos + 8 * kk * ld, ld, 8 * n, bf);
                    tf32x3::split(bf, bb, bs);
                    tf32x3::mma3(av, pb[kk], ps[kk], bb, bs);
                    tf32x3::b_rows_paired(qs + 8 * kk * ld, ld, 8 * n, bf);
                    tf32x3::split(bf, bb, bs);
                    tf32x3::mma3(ak, gb[kk], gs[kk], bb, bs);
                }
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    dv[n][i] += av[i];
                    dk[n][i] += ak[i];
                }
            }
        }
        if constexpr (kTfStages == 1) __syncthreads();
    }
    tf32x3::cp_async_wait<0>();  // no copy in flight at exit (n_tiles 0)
    float* dkb = slice_out<float>(a.dk, b, h);
    float* dvb = slice_out<float>(a.dv, b, h);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
        const int key = key0 + 8 * half;
        if (key >= a.S) continue;
        float* krow = dkb + static_cast<int64_t>(key) * a.dk.st;
        float* vrow = dvb + static_cast<int64_t>(key) * a.dv.st;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
            const int col = 8 * n + 2 * t;
            if (col < a.D) {
                *reinterpret_cast<float2*>(krow + col) = make_float2(
                    dk[n][2 * half] * a.scale, dk[n][2 * half + 1] * a.scale);
                *reinterpret_cast<float2*>(vrow + col) =
                    make_float2(dv[n][2 * half], dv[n][2 * half + 1]);
            }
        }
    }
}

// ---- launch ---------------------------------------------------------

enum Kernel { kFwd = 0, kDq = 1, kDkv = 2 };

// Every kernel has a bf16 design (sm90: TMA, mbarriers and wgmma) and an
// fp32 one (tf32: three-pass TF32 mma.sync), at a head-dim tile of 64 or
// 128 columns.
int head_tile(int D) { return D <= 64 ? 64 : 128; }

template <int DT> size_t smem_bytes_at(int is_bf16, int kernel) {
    if (is_bf16)
        return kernel == kFwd ? FwdSm90<DT>::kBytes
               : kernel == kDq ? DqSm90<DT>::kBytes : DkvSm90<DT>::kBytes;
    return kernel == kFwd ? TfFwdSmem<DT>::kBytes
           : kernel == kDq ? TfDqSmem<DT>::kBytes : TfDkvSmem<DT>::kBytes;
}

size_t smem_bytes(int is_bf16, int kernel, int D) {
    return head_tile(D) == 64 ? smem_bytes_at<64>(is_bf16, kernel)
                              : smem_bytes_at<128>(is_bf16, kernel);
}

View view(const void* p, const int64_t* st) {
    return View{const_cast<void*>(p), st[0], st[1], st[2]};
}

bool valid(const Args& a) {
    return a.B >= 1 && a.H >= 1 && a.T >= 1 && a.S >= 1 && a.D >= 16 &&
           a.D <= kMaxHeadDim && a.D % 16 == 0 &&
           static_cast<int64_t>(a.B) * a.H <= 0x7fffffff;
}

// Launches fn<<<grid, threads, smem, stream>>>(args...) after the opt-in
// that dynamic shared memory above 48 KB needs.
template <typename... P>
int launch(void (*fn)(P...), dim3 grid, int threads, int smem,
           cudaStream_t stream, P... args) {
    cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    fn<<<grid, threads, smem, stream>>>(args...);
    return static_cast<int>(cudaGetLastError());
}

// fp32: one CTA per item, B*H*tiles items, every head's longest tiles
// first (head groups measured no faster here: at ~1.7 and ~3.7 ms the
// products, not the L2, set the pace).
template <int DT>
int launch_tf32(int kernel, const Args& a, cudaStream_t stream) {
    const int rows = kernel == kDkv ? a.S : a.T;
    const int tile = kernel == kFwd ? kTfFwdBQ : kernel == kDq ? kTfDqBQ : kTfDkvBK;
    const int64_t items =
        static_cast<int64_t>(a.B) * a.H * ((rows + tile - 1) / tile);
    if (items > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
    Args g = a;
    g.group = a.B * a.H;
    const int smem = static_cast<int>(smem_bytes(0, kernel, a.D));
    void (*fn)(Args) = kernel == kFwd ? fwd_tf32<DT>
                       : kernel == kDq ? dq_tf32<DT> : dkv_tf32<DT>;
    return launch(fn, dim3(static_cast<unsigned>(items)), kTfThreads, smem,
                  stream, g);
}

// One operand's tensor map from the wrapper's geometry (11 values: dims,
// byte strides, box), whose box must be 64 columns by `rows` rows.
int tile_map(CUtensorMap* map, const void* base, const int64_t* geom,
             int rows) {
    if (geom[7] != sm90::kRegionCols || geom[8] != 1 || geom[9] != rows ||
        geom[10] != 1)
        return static_cast<int>(cudaErrorInvalidValue);
    return sm90::encode_tile_map(map, base, geom);
}

template <int DT>
int launch_sm90(int kernel, const Args& a, const int64_t* tma,
                cudaStream_t stream) {
    CUtensorMap mq, mk, mv, mdo;
    const int q_rows = kernel == kFwd ? kFwdBQ : kernel == kDq ? kDqBQ : kDkvBQ;
    const int kv_rows = kernel == kFwd ? kFwdBK : kernel == kDq ? kDqBK : kDkvBK;
    int err = tile_map(&mq, a.q.p, tma, q_rows);
    if (!err) err = tile_map(&mk, a.k.p, tma + 11, kv_rows);
    if (!err) err = tile_map(&mv, a.v.p, tma + 22, kv_rows);
    if (!err && kernel != kFwd) err = tile_map(&mdo, a.o.p, tma + 33, q_rows);
    if (err) return err;
    // A work item is 128 query rows (B1, B2) or 128 keys (B3).
    const int rows = kernel == kDkv ? a.S : a.T;
    const int64_t items = static_cast<int64_t>(a.B) * a.H * ((rows + 127) / 128);
    if (items > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
    // B1 and B2 are persistent (at most one CTA per SM), B3 one CTA per item.
    const bool persistent = kernel != kDkv;
    int64_t ctas = items;
    if (persistent) {
        int device = 0, sms = 0;
        cudaError_t e = cudaGetDevice(&device);
        if (e == cudaSuccess)
            e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
        if (e != cudaSuccess) return static_cast<int>(e);
        ctas = std::min<int64_t>(items, sms);
    }
    const dim3 grid(static_cast<unsigned>(ctas));
    // The streamed tiles of a head: K and V (B1, B2) or Q and dO (B3).
    const int64_t per_head = 2LL * (kernel == kDkv ? a.T : a.S) * a.D * sizeof(bf16);
    Args g = a;
    g.group = static_cast<int>(std::max<int64_t>(
        1, std::min<int64_t>(a.B * a.H, kL2GroupBytes / per_head)));
    const int smem = static_cast<int>(smem_bytes(1, kernel, a.D));
    if (kernel == kFwd)
        return launch(fwd_sm90<DT>, grid, kSm90Threads, smem, stream, mq, mk,
                      mv, g);
    return launch(kernel == kDq ? dq_sm90<DT> : dkv_sm90<DT>, grid,
                  kSm90Threads, smem, stream, mq, mk, mv, mdo, g);
}

int dispatch(int is_bf16, int kernel, const Args& a, const int64_t* tma,
             void* stream) {
    if (!valid(a)) return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const bool narrow = head_tile(a.D) == 64;
    if (!is_bf16)
        return narrow ? launch_tf32<64>(kernel, a, s)
                      : launch_tf32<128>(kernel, a, s);
    if (tma == nullptr || (kernel != kDkv && a.ticket == nullptr))
        return static_cast<int>(cudaErrorInvalidValue);
    return narrow ? launch_sm90<64>(kernel, a, tma, s)
                  : launch_sm90<128>(kernel, a, tma, s);
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
    return smem_bytes(is_bf16, kernel, D);
}

// B1. q [B,T,H,D], k/v [B,S,H,D] -> out [B,T,H,D] (input dtype), lse
// [B,T,H] fp32 (contiguous). `strides` holds (b, t, h) element strides
// of q, k, v, out; the last dim of every view is contiguous. For bf16,
// `tma` holds the tensor-map geometry of q, k, v (11 values each) and
// `ticket` one int32 on the device, 0 at launch (the work counter); both
// may be null for fp32. Returns cudaGetLastError() after the launch (0 =
// launched), or the error that kept it from launching.
int flash_attn_fwd(int is_bf16, const void* q, const void* k, const void* v,
                   void* out, void* lse, int B, int T, int S, int H, int D,
                   int causal, float scale, const int64_t* strides,
                   const int64_t* tma, void* ticket, void* stream) {
    Args a = base_args(B, T, S, H, D, causal, scale);
    a.ticket = static_cast<int*>(ticket);
    a.q = view(q, strides);
    a.k = view(k, strides + 3);
    a.v = view(v, strides + 6);
    a.o = view(out, strides + 9);
    a.lse = static_cast<float*>(lse);
    return dispatch(is_bf16, kFwd, a, tma, stream);
}

// B2. + dout [B,T,H,D], lse and delta [B,T,H] fp32 -> dq [B,T,H,D].
// `strides`: q, k, v, dout, dq; `tma`: the tensor-map geometry of q, k, v,
// dout, and `ticket` the work counter (bf16; both may be null for fp32).
int flash_attn_dq(int is_bf16, const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* delta,
                  void* dq, int B, int T, int S, int H, int D, int causal,
                  float scale, const int64_t* strides, const int64_t* tma,
                  void* ticket, void* stream) {
    Args a = base_args(B, T, S, H, D, causal, scale);
    a.ticket = static_cast<int*>(ticket);
    a.q = view(q, strides);
    a.k = view(k, strides + 3);
    a.v = view(v, strides + 6);
    a.o = view(dout, strides + 9);
    a.dq = view(dq, strides + 12);
    a.lse = const_cast<float*>(static_cast<const float*>(lse));
    a.delta = static_cast<const float*>(delta);
    return dispatch(is_bf16, kDq, a, tma, stream);
}

// B3. -> dk, dv [B,S,H,D]. `strides`: q, k, v, dout, dk, dv; `tma`: the
// tensor-map geometry of q, k, v, dout (bf16; may be null for fp32).
int flash_attn_dkv(int is_bf16, const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dk, void* dv, int B, int T, int S, int H, int D,
                   int causal, float scale, const int64_t* strides,
                   const int64_t* tma, void* stream) {
    Args a = base_args(B, T, S, H, D, causal, scale);
    a.q = view(q, strides);
    a.k = view(k, strides + 3);
    a.v = view(v, strides + 6);
    a.o = view(dout, strides + 9);
    a.dk = view(dk, strides + 12);
    a.dv = view(dv, strides + 15);
    a.lse = const_cast<float*>(static_cast<const float*>(lse));
    a.delta = static_cast<const float*>(delta);
    return dispatch(is_bf16, kDkv, a, tma, stream);
}

}  // extern "C"
