// GQA decode attention for Hopper (sm_90a): one query token per row over
// a [B, KvH, S, D] K/V cache, each row b attending exactly to its own live
// window pads[b]..pos[b]:
//
//   out[b, h] = softmax_s(q[b, h] . k[b, h / rep, s] / sqrt(D)) . v[b, h / rep, s]
//
// and, on an int8 cache with f32 per-token scales ks, vs [B, KvH, S]:
//
//   out[b, h] = sum_s p_s vs_s v_s / sum_s p_s,
//   p = exp(score - max), score_s = (q . k_s / sqrt(D)) ks_s.
//
// Replaces four Pallas TPU kernels of clearcam_tpu/ops/decode_attention.py:
// `decode_attention_batch` -> `_batch_kernel` (f32/bf16 caches) and
// `decode_attention_batch_q8` -> `_batch_kernel_q8` (int8 caches), batched
// decode; and, launched with B = 1 and no pads, `decode_attention` ->
// `_chunked_kernel` and `decode_attention_q8` -> `_chunked_kernel_q8`, the
// single-stream ones (the same function at B = 1).
//
// Layouts: q [B, H, D] and out [B, H, D] f32 or bf16 (out in q's type);
// k, v [B, KvH, S, D] f32, bf16 or int8, contiguous; with int8, ks and vs
// [B, KvH, S] f32; pos, pads [B] int32 on the card (or one value for every
// row). D any multiple of 8 up to 256; any rep = H / KvH; any S. The
// kernels are built at the widths of HeadDims below (64: Llama-3.2-1B,
// Qwen2.5-0.5B; 128: Qwen3, Llama-3.x 3B/8B; 256: Qwen3-Next's attention
// blocks), and a call runs on the smallest width W >= D: at D = W the exact
// instance, else the padded one (80 and 96: H2O-Danube2/3, 120: Danube3-4B,
// on W = 128), which walks rows W wide in shared memory with the dims past
// D zero-filled by the copies (q's too, so the scores are exact), reads D
// of each row in global memory, skips the k-steps and PV tiles wholly past
// D, and writes D dims of out. An int8 row of D bytes is only 8-byte
// aligned there, so it is copied 8 bytes at a time.
//
// What bounds it: the bytes of the live K and V. Per position and KV head a
// step reads 4 D bytes of bf16 K + V (2 D of int8, plus 8 of scales) and
// does 4 rep D FLOPs: rep FLOP/byte, 2 at Qwen3's rep 2, 7 at Qwen2.5's,
// 12 at GLM-4.5-Air's, 16 at Qwen3-235B's. The f32 CUDA cores' ridge is 67e12
// / 3.35e12 = 20 FLOP/byte, and a score there also costs a cross-lane
// reduction and its softmax, so from rep ~4 on the CUDA cores, not HBM,
// would bound the walk. The tensor cores' ridge (~295 in bf16) is far above
// every rep, so on them the bytes bound it again. The calls are small (a few
// MB of live K/V), so a call's fixed costs matter as much: one launch, and
// enough blocks reading enough bytes each.
//
// Design: flash-decoding in one launch a call. Grid (chunk x head group,
// KV head, row), 128 threads (4 warps). The host-side plan (`plan` in
// ops/decode_attention.py) picks, from the shapes alone (B, KvH, S, D, the
// cache's bytes, rep), never from pos or pads, so that a call can be
// captured in a CUDA graph and replayed with new positions:
//  - the path (below) and the query heads a block takes (`heads`; a KV
//    head's rep query heads take ceil(rep / heads) sibling blocks, next to
//    each other in grid.x so they read the same K/V tiles close in time,
//    from L2 after the first);
//  - the chunk: the cache's positions cut into `splits` chunks of `chunk`
//    positions (a multiple of the path's tile), each at least the path's
//    byte target of K/V; on path 1 also enough that the partials a row's
//    merge reads back are no more bytes than a chunk's K/V (16 heads' acc
//    a chunk would otherwise dominate the call), on path 2 halved while a
//    whole-cache window would not cover the SMs; larger where the splits
//    would pass MAX_SPLITS or the blocks the plan's cap.
// A block whose chunk misses its row's window exits at once. The others
// walk their part of the window in tiles, through a ring of STAGES slots
// in dynamic shared memory filled with cp.async (16 bytes a thread, 4 for
// a scale) in commit groups: STAGES - 1 tiles in flight while one is
// computed, one __syncthreads a tile. Positions outside the window are
// zero-filled, not read. Each warp owns a slice of every tile and its own
// online softmax (running max m in log2 units, sum l, acc), so warps never
// wait on each other inside the walk; q is pre-scaled by log2(e) / sqrt(D),
// so exp is exp2. Then the block merges its warps in shared memory (the
// ring is free by then) and finishes (`finish`):
//  - a window that meets one chunk only: the block writes out itself;
//  - else it writes f32 partials (m, l, acc) to the wrapper's scratch and
//    counts itself in on the counter of its (row, KV head, head group) in
//    global memory. The block that arrives last (how many chunks the
//    window meets, every block computes from pos and pads) reads the
//    partials back from L2 and writes out = sum_j 2^(m_j - M) acc_j /
//    sum_j 2^(m_j - M) l_j, M = max_j m_j, summed in chunk order (the
//    result does not depend on which block came last), then sets the
//    counter back to 0, so the next call and a graph replay find it
//    zeroed. The partials come back through shared memory by cp.async,
//    every load of a round in flight at once. A live chunk holds a live
//    column, so l_j >= 1 for the largest m_j: no 0/0. Calls on one device
//    share the counters: they run on one stream.
//  - a row with no live column (pads > pos) meets no chunk: the block of
//    its first chunk writes zeros.
// K's int8 scale multiplies the score and V's the probability before PV;
// l takes the unscaled probability, so the finish is the same for every
// cache type. The kernels allocate nothing: the wrapper passes the
// partials' scratch and the counters. `decode_attention_prepare` raises the
// dynamic shared-memory limit once per device; `decode_attention_forward`
// launches once and returns cudaGetLastError().
//
// Path 1, tensor cores (`decode_attn_tc`; bf16 and int8 caches at rep >=
// the plan's TC_MIN_REP = 4: timed on the H100, batched and single-stream,
// bf16 and int8, it took 5-31% longer than path 2 at Qwen3's rep 2 and
// 24-30% less time at Llama-3.2-1B's rep 4, PERF.md §6): a block holds up
// to 16 query heads of one KV head as the 16 rows of `mma.sync.m16n8k16`
// bf16 with f32 accumulators; tiles of 64 positions, 16 a warp.
//  - S = Q K^T. The f32 query is split into two bf16 terms, hi = bf16(q)
//    and lo = bf16(q - hi) (2^-18 of |q| left; one term for a bf16 q would
//    not do either, as the scaled q is not a bf16); the cache's tile is the
//    B operand: bf16 values are exact, int8 values widened to bf16 are
//    exact (|v| <= 127). A k-step's reduction index is permuted so that one
//    16-byte shared-memory load per lane gives its B fragments (a lane's
//    four dims of a k-step are consecutive), and q's A fragments, built once
//    a block, follow the same permutation.
//  - The online softmax runs on the S fragments: a row's max over the 4
//    lanes that hold it, one exp2f per (head, position); int8: K's scale on
//    the score column.
//  - PV = P V: P (times V's scale on int8) split into two bf16 terms, the
//    A fragments straight from the S registers; V's B fragments from
//    ldmatrix.trans (bf16) or byte permutes of 4-byte loads (int8).
//  - Each warp writes its 16 x D accumulators to shared memory at the end.
//  The rings are XOR-swizzled by 16-byte chunk so that these loads are free
//  of bank conflicts (K: by the row's lowest bit; V: as ldmatrix or the
//  int8 pattern reads it). At D = 256 q's fragments stay in shared memory
//  (the accumulators take 128 registers a lane). An f32 cache stays on
//  path 2: an f32 K or V is not exact in bf16.
//
// Path 2, CUDA cores (`decode_attn_cc`; f32 caches, and reps below
// TC_MIN_REP, where the 16-row tile would be mostly empty): a block walks
// RMAX = 1, 2, 4 or 8 query heads (4 at D > 128: a lane keeps D / 32 dims
// of each one's q and acc in registers); tiles of TILE = 32 positions, 8 a
// warp. A lane holds DL = D / 32 dims as NV vectors of W = 4, 2 or 1
// consecutive dims (the widest that divides DL), vector v at dim 32 W v + W
// lane: each vector load of a warp reads one contiguous run of the row,
// without bank conflicts. A lane scores the 8 positions with 8 independent
// partial dot products per query head, folded over the warp by a transposed
// reduction (9 shuffles for 8 scores, against 40 for one reduction each),
// which leaves position (lane >> 2) & 7 in every lane of its quad. The
// probabilities go through shared memory to the PV product, whose DL
// accumulators per query head and lane take 8 dependent FMAs a tile. int8
// is widened to f32 only in registers (the byte placed in the mantissa of
// 2^23, exact).

// This header holds both paths' kernels and their host-side dispatch. Four
// sources instantiate them, one part each, so that nvcc builds the parts
// side by side (one source of all 78 instances took 73 s on the H100's
// host): the exact instances of the narrow widths (64, 128) in
// decode_attention.cu, beside the C entry points, and of the wide one
// (256) in decode_attention_wide.cu; the padded ones in
// decode_attention_padded.cu and decode_attention_padded_wide.cu.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

#include "bf16_mma.cuh"

namespace decode_attention_cu {

// what every block of a call reads: the operands, the plan and the scratch
struct Params {
    const void* q; int q_bf16;
    const void* k; const void* v; const float* ks; const float* vs;
    const int* pos; const int* pads;    // per row, or null: pos0 and pad0 for every row
    int pos0, pad0;
    void* out; float* part_acc; float* part_ml; int* counters;
    int B, H, KvH, S, D, rep, heads, groups, chunk, splits;
    float scale;
};

// a source's part of the instances: the launch of one of them, and their
// shared-memory limits
struct Part {
    cudaError_t (*launch)(const Params& p, int cdtype, int tc, cudaStream_t st);
    cudaError_t (*prepare)();
};
extern const Part exact_narrow, exact_wide, padded_narrow, padded_wide;

}  // namespace decode_attention_cu

namespace {

using decode_attention_cu::Params;

// the widths the kernels are built at, in rising order; WIDTHS in
// ops/decode_attention.py names the same set. Each width has an exact and a
// padded instance of every kernel (28 instances, 22 at 256). A width here
// must be a multiple of 64 (path 1's whole loads of an int8 row)
template <int... Ds> struct Dims {};
using HeadDims = Dims<64, 128, 256>;
using Narrow = Dims<64, 128>;                 // the widths the narrow parts hold
using Wide = Dims<256>;
constexpr int NARROW_MAX = 128;
constexpr int MAX_D = 256;                    // head dims are multiples of 8 up to this
constexpr int D_STEP = 8;

constexpr int WARPS = 4;
constexpr int NTHREADS = 32 * WARPS;
constexpr int MAX_SPLITS = 64;                // chunks a cache at most (MAX_SPLITS in the plan)
constexpr int SMEM_MAX = 232448;              // bytes of shared memory a block may have
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

// path 2: positions a warp scores at once, positions per ring slot, slots
constexpr int GROUP = 8;
constexpr int TILE = WARPS * GROUP;
constexpr int STAGES = 3;                     // ring slots of path 2 (3 read faster than 4 on the H100)
// path 1: query heads a block (the MMA's rows), positions per ring slot,
// bf16 terms of q and of p
constexpr int TC_HEADS = 16;
constexpr int TC_TILE = 16 * WARPS;
constexpr int QT = 2, PT = 2;

// query heads a path-2 block walks at most at head dim D: a lane keeps
// D / 32 dims of each one's q and acc in registers
constexpr int rmax_cap(int D) { return D > 128 ? 4 : 8; }

// bytes a ring copy moves: 16, or 8 for an int8 row of a padded instance
// (D bytes, a multiple of 8: only 8-byte aligned)
template <typename TC, bool PAD> constexpr int COPY_BYTES = PAD && sizeof(TC) == 1 ? 8 : 16;
template <int CB> __device__ __forceinline__ void cp_ring(void* dst, const void* src, bool on) {
    if constexpr (CB == 16) cp16(dst, src, on);
    else cp8(dst, src, on);
}

static_assert(GROUP == 8, "the transposed reduction folds 8 scores over lane bits 4, 3, 2");

// ---- path 2 helpers --------------------------------------------------

// W consecutive cache elements in shared memory, as f32
template <typename TC> struct Cache;
template <> struct Cache<float> {
    static __device__ __forceinline__ void load(const float* p, float (&f)[4]) {
        const float4 x = *reinterpret_cast<const float4*>(p);
        f[0] = x.x; f[1] = x.y; f[2] = x.z; f[3] = x.w;
    }
    static __device__ __forceinline__ void load(const float* p, float (&f)[2]) {
        const float2 x = *reinterpret_cast<const float2*>(p);
        f[0] = x.x; f[1] = x.y;
    }
    static __device__ __forceinline__ void load(const float* p, float (&f)[1]) { f[0] = *p; }
};
template <> struct Cache<__nv_bfloat16> {
    // a bf16 is the top half of its f32
    static __device__ __forceinline__ void load(const __nv_bfloat16* p, float (&f)[4]) {
        const uint2 u = *reinterpret_cast<const uint2*>(p);
        f[0] = __uint_as_float(u.x << 16); f[1] = __uint_as_float(u.x & 0xffff0000u);
        f[2] = __uint_as_float(u.y << 16); f[3] = __uint_as_float(u.y & 0xffff0000u);
    }
    static __device__ __forceinline__ void load(const __nv_bfloat16* p, float (&f)[2]) {
        const unsigned u = *reinterpret_cast<const unsigned*>(p);
        f[0] = __uint_as_float(u << 16); f[1] = __uint_as_float(u & 0xffff0000u);
    }
    static __device__ __forceinline__ void load(const __nv_bfloat16* p, float (&f)[1]) {
        f[0] = __bfloat162float(*p);
    }
};
template <> struct Cache<int8_t> {
    // x ^ 0x80 is x + 128 as a byte; in the low mantissa byte of 2^23 it is
    // the float 2^23 + 128 + x, exactly, so one subtraction gives x
    static __device__ __forceinline__ float widen(unsigned u, unsigned sel) {
        return __uint_as_float(__byte_perm(u, 0x4b000000u, sel)) - 8388736.f;   // 2^23 + 128
    }
    static __device__ __forceinline__ void load(const int8_t* p, float (&f)[4]) {
        const unsigned u = *reinterpret_cast<const unsigned*>(p) ^ 0x80808080u;
        f[0] = widen(u, 0x7540); f[1] = widen(u, 0x7541);
        f[2] = widen(u, 0x7542); f[3] = widen(u, 0x7543);
    }
    static __device__ __forceinline__ void load(const int8_t* p, float (&f)[2]) {
        const unsigned u = *reinterpret_cast<const unsigned short*>(p) ^ 0x8080u;
        f[0] = widen(u, 0x7540); f[1] = widen(u, 0x7541);
    }
    static __device__ __forceinline__ void load(const int8_t* p, float (&f)[1]) {
        f[0] = static_cast<float>(*p);
    }
};

// how a lane holds its DL = D / 32 dims: NV vectors of W consecutive dims,
// vector v at dim STRIDE v + W lane
template <int D> struct Lane {
    static_assert(D % 32 == 0 && D <= MAX_D, "a lane holds D / 32 dims");
    static constexpr int DL = D / 32;
    static constexpr int W = DL % 4 == 0 ? 4 : DL % 2 == 0 ? 2 : 1;
    static constexpr int NV = DL / W;
    static constexpr int STRIDE = 32 * W;
    // this lane's DL dims of the row at p (p points at the row's dim 0)
    template <typename TC>
    static __device__ __forceinline__ void load(const TC* p, int lane, float (&f)[DL]) {
#pragma unroll
        for (int v = 0; v < NV; ++v) {
            float x[W];
            Cache<TC>::load(p + v * STRIDE + W * lane, x);
#pragma unroll
            for (int c = 0; c < W; ++c) f[v * W + c] = x[c];
        }
    }
    // the dim of this lane's i-th value
    static __device__ __forceinline__ int dim(int lane, int i) {
        return (i / W) * STRIDE + W * lane + i % W;
    }
    static __device__ __forceinline__ void store(float* p, int lane, const float (&f)[DL]) {
#pragma unroll
        for (int v = 0; v < NV; ++v) {
            float* o = p + v * STRIDE + W * lane;
            if constexpr (W == 4)
                *reinterpret_cast<float4*>(o) =
                    make_float4(f[4 * v], f[4 * v + 1], f[4 * v + 2], f[4 * v + 3]);
            else if constexpr (W == 2)
                *reinterpret_cast<float2*>(o) = make_float2(f[2 * v], f[2 * v + 1]);
            else
                *o = f[v];
        }
    }
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// 8 partial dot products (positions 0..7, this lane's dims) -> the full
// score of position (lane >> 2) & 7, in each lane of its quad. Each step
// halves the positions a lane keeps and adds its partner's sums of them.
__device__ __forceinline__ float fold8(float (&s)[GROUP], int lane) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const bool up = lane & 16;
        const float send = up ? s[i] : s[i + 4], keep = up ? s[i + 4] : s[i];
        s[i] = keep + __shfl_xor_sync(FULL, send, 16);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const bool up = lane & 8;
        const float send = up ? s[i] : s[i + 2], keep = up ? s[i + 2] : s[i];
        s[i] = keep + __shfl_xor_sync(FULL, send, 8);
    }
    {
        const bool up = lane & 4;
        const float send = up ? s[0] : s[1], keep = up ? s[1] : s[0];
        s[0] = keep + __shfl_xor_sync(FULL, send, 4);
    }
    s[0] += __shfl_xor_sync(FULL, s[0], 2);
    return s[0] + __shfl_xor_sync(FULL, s[0], 1);
}

// ---- both paths --------------------------------------------------------

// a block's place in its call
struct Block {
    int split, grp, g, b;   // its chunk, head group, KV head and row
    int h0, nr;             // its first query head, and how many it takes
    int lo, hi;             // the row's live window (none: lo > hi)
    int j0, j1;             // the chunks the window meets
};

__device__ __forceinline__ Block block_of(const Params& p) {
    Block k;
    k.split = blockIdx.x / p.groups;
    k.grp = blockIdx.x % p.groups;
    k.g = blockIdx.y;
    k.b = blockIdx.z;
    k.h0 = k.g * p.rep + k.grp * p.heads;
    k.nr = min(p.heads, p.rep - k.grp * p.heads);
    k.lo = max(p.pads ? __ldg(p.pads + k.b) : p.pad0, 0);
    k.hi = min(p.pos ? __ldg(p.pos + k.b) : p.pos0, p.S - 1);
    k.j0 = k.lo / p.chunk;
    k.j1 = k.hi / p.chunk;
    return k;
}

// counter += 1 at GPU scope with acquire-release semantics; the old value
__device__ __forceinline__ int add_acq_rel(int* counter) {
    int old;
    asm volatile("atom.add.acq_rel.gpu.global.s32 %0, [%1], 1;\n"
                 : "=r"(old) : "l"(counter) : "memory");
    return old;
}

__device__ __forceinline__ void store_out(const Params& p, size_t i, float x) {
    if (p.q_bf16) static_cast<__nv_bfloat16*>(p.out)[i] = __float2bfloat16(x);
    else static_cast<float*>(p.out)[i] = x;
}

// the head dim of an instance of width D: D itself, or the call's p.D < D
// when PAD (a constant in the exact instances)
template <int D, bool PAD> __device__ __forceinline__ int head_dim(const Params& p) {
    return PAD ? p.D : D;
}

// Whether the block's chunk meets its row's window. A row with no live
// column meets none: its first chunk's block writes its heads' zeros.
template <int D, bool PAD>
__device__ __forceinline__ bool live_block(const Params& p, const Block& k) {
    if (k.lo > k.hi) {
        const int d = head_dim<D, PAD>(p);
        if (k.split == 0)
            for (int i = threadIdx.x; i < k.nr * d; i += NTHREADS)
                store_out(p, ((size_t)k.b * p.H + k.h0) * d + i, 0.f);
        return false;
    }
    const int c0 = k.split * p.chunk;
    return c0 <= k.hi && c0 + p.chunk > k.lo;
}

// After the walk, the warps' states in shared memory for the block's nr
// query heads: red [WARPS][ROWS][D] (acc; dims past the head dim unused),
// red_m and red_l [WARPS][ROWS], all inside the first RING bytes of shared
// memory, which are free from the count on; wsm [ROWS][MAX_SPLITS] is
// shared memory for the merge's weights. Merges the warps, then writes out
// (the window meets this chunk only) or the partials ([B, H, splits, hd]
// at the call's head dim hd), and the last of the window's chunks to
// arrive merges them all.
template <int ROWS, int D, bool PAD, size_t RING>
__device__ void finish(const Params& p, const Block& k, unsigned char* smem, const float* red,
                       const float* red_m, const float* red_l, float* wsm) {
    const int nlive = k.j1 - k.j0 + 1;
    const int hd = head_dim<D, PAD>(p);
    for (int i = threadIdx.x; i < k.nr * hd; i += NTHREADS) {
        const int r = i / hd, d = i % hd;
        float mx = -CUDART_INF_F;                       // finite: some warp saw a live position
#pragma unroll
        for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, red_m[w * ROWS + r]);
        float a = 0.f, l = 0.f;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) {
            const float e = exp2f(red_m[w * ROWS + r] - mx);  // 0 for a warp with no live column
            a = fmaf(e, red[(w * ROWS + r) * D + d], a);
            l = fmaf(e, red_l[w * ROWS + r], l);
        }
        const size_t row = (size_t)k.b * p.H + k.h0 + r;
        if (nlive == 1) {
            store_out(p, row * hd + d, a / l);          // l >= 1: the largest m's warp
        } else {
            const size_t pr = row * p.splits + k.split;
            p.part_acc[pr * hd + d] = a;
            if (d == 0) {
                p.part_ml[2 * pr] = mx;
                p.part_ml[2 * pr + 1] = l;
            }
        }
    }
    if (nlive == 1) return;
    // count in: the barrier orders every thread's partials before thread
    // 0's add, whose release makes them visible with the count; its acquire
    // (and the barrier after it) orders the last block's reads after every
    // other block's partials
    __shared__ int last;
    __syncthreads();
    const int ci = (k.b * p.KvH + k.g) * p.groups + k.grp;
    if (threadIdx.x == 0) last = add_acq_rel(p.counters + ci) == nlive - 1;
    __syncthreads();
    if (!last) return;
    // the live chunks' acc into shared memory by cp.async, as many a round
    // as RING bytes hold (every load of a round in flight at once); the
    // first round's copies fly while the weights are computed
    constexpr int D4 = D / 4;
    const int hd4 = hd / 4;
    const int per = k.nr * hd4;                         // 16-byte pieces of a chunk's partial
    const int cap = min(nlive, (int)(RING / 16) / per);
    float* abuf = reinterpret_cast<float*>(smem);
    auto fetch_round = [&](int jf) {
        const int n = min(cap, nlive - jf) * per;
        for (int e = threadIdx.x; e < n; e += NTHREADS) {
            const int jj = e / per, rd = e % per, r = rd / hd4, d = 4 * (rd % hd4);
            const size_t pr = ((size_t)k.b * p.H + k.h0 + r) * p.splits + k.j0 + jf + jj;
            cp16(abuf + (jj * k.nr + r) * hd + d, p.part_acc + pr * hd + d, true);
        }
        cp_commit();
    };
    fetch_round(0);
    // each live chunk's weight 2^(m_j - M) / sum_j 2^(m_j - M) l_j, a warp
    // a query head, a lane a chunk (nlive <= MAX_SPLITS = 2 x 32)
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int r = warp; r < k.nr; r += WARPS) {
        const float* ml =
            p.part_ml + 2 * (((size_t)k.b * p.H + k.h0 + r) * p.splits + k.j0);
        float m[2], l[2], mx = -CUDART_INF_F;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
            const int j = lane + 32 * c;
            m[c] = j < nlive ? __ldcg(ml + 2 * j) : -CUDART_INF_F;
            l[c] = j < nlive ? __ldcg(ml + 2 * j + 1) : 0.f;
            mx = fmaxf(mx, m[c]);
        }
#pragma unroll
        for (int o = 16; o; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
        float e[2], ls = 0.f;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
            e[c] = exp2f(m[c] - mx);
            ls = fmaf(e[c], l[c], ls);
        }
#pragma unroll
        for (int o = 16; o; o >>= 1) ls += __shfl_xor_sync(FULL, ls, o);
        const float inv = 1.f / ls;                     // ls >= 1: the largest m_j's chunk
#pragma unroll
        for (int c = 0; c < 2; ++c)
            if (lane + 32 * c < nlive) wsm[r * MAX_SPLITS + lane + 32 * c] = e[c] * inv;
    }
    // out = sum_j w_j acc_j in chunk order, 4 dims of a head a thread
    constexpr int ITEMS = (ROWS * D4 + NTHREADS - 1) / NTHREADS;
    float4 s[ITEMS];
#pragma unroll
    for (int it = 0; it < ITEMS; ++it) s[it] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int jf = 0; jf < nlive; jf += cap) {
        cp_wait<0>();
        __syncthreads();                                // the round's acc and the weights
        const int n = min(cap, nlive - jf);
#pragma unroll
        for (int it = 0; it < ITEMS; ++it) {
            const int i = threadIdx.x + NTHREADS * it;
            if (i >= per) break;
            const int r = i / hd4, d = 4 * (i % hd4);
            const float* w = wsm + r * MAX_SPLITS + jf;
            for (int jj = 0; jj < n; ++jj) {
                const float4 x = *reinterpret_cast<const float4*>(abuf + (jj * k.nr + r) * hd + d);
                const float wj = w[jj];
                s[it].x = fmaf(wj, x.x, s[it].x);
                s[it].y = fmaf(wj, x.y, s[it].y);
                s[it].z = fmaf(wj, x.z, s[it].z);
                s[it].w = fmaf(wj, x.w, s[it].w);
            }
        }
        if (jf + cap < nlive) {
            __syncthreads();                            // the buffer is read
            fetch_round(jf + cap);
        }
    }
#pragma unroll
    for (int it = 0; it < ITEMS; ++it) {
        const int i = threadIdx.x + NTHREADS * it;
        if (i >= per) break;
        const int r = i / hd4, d = 4 * (i % hd4);
        const size_t o = ((size_t)k.b * p.H + k.h0 + r) * hd + d;
        if (p.q_bf16)
            *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(p.out) + o) =
                make_uint2(pack_bf16(s[it].x, s[it].y), pack_bf16(s[it].z, s[it].w));
        else
            *reinterpret_cast<float4*>(static_cast<float*>(p.out) + o) = s[it];
    }
    if (threadIdx.x == 0) p.counters[ci] = 0;           // zero for the next call
}

// ---- path 2: CUDA cores --------------------------------------------------

// dynamic shared memory: the K and V rings [STAGES][TILE][D], with int8 the
// scale rings [STAGES][TILE] for K and V, the probabilities each warp hands
// to its PV product [WARPS][RMAX][GROUP], the merge's weights
// [RMAX][MAX_SPLITS]; after the walk the rings hold the warps' states
template <typename TC, bool Q8, int RMAX, int D> struct Smem {
    static constexpr int ring_elems = STAGES * TILE * D;
    static constexpr size_t ring = ring_elems * sizeof(TC);
    static constexpr size_t scales = Q8 ? STAGES * TILE * sizeof(float) : 0;
    static constexpr size_t probs = WARPS * RMAX * GROUP * sizeof(float);
    static constexpr size_t weights = RMAX * MAX_SPLITS * sizeof(float);
    static constexpr size_t bytes = 2 * ring + 2 * scales + probs + weights;
    static_assert(WARPS * RMAX * (D + 2) * sizeof(float) <= 2 * ring,
                  "the warps' states fit in the rings");
    static_assert(bytes <= SMEM_MAX, "the rings fit in a block's shared memory");
};

// D the instance's width; PAD: the call's head dim p.D < D, the dims past
// it zero in the rings and in q
template <typename TC, bool Q8, int RMAX, int D, bool PAD>
__global__ void __launch_bounds__(NTHREADS) decode_attn_cc(const Params p) {
    using L = Smem<TC, Q8, RMAX, D>;
    using LN = Lane<D>;
    constexpr int DL = LN::DL;
    const int hd = head_dim<D, PAD>(p);                 // a K/V row's elements in global memory
    extern __shared__ __align__(16) unsigned char smem[];
    TC* kring = reinterpret_cast<TC*>(smem);
    TC* vring = kring + L::ring_elems;
    float* ksr = reinterpret_cast<float*>(smem + 2 * L::ring);
    float* vsr = ksr + STAGES * TILE;
    float* pw = reinterpret_cast<float*>(smem + 2 * L::ring + 2 * L::scales);
    float* wsm = pw + WARPS * RMAX * GROUP;

    const Block blk = block_of(p);
    if (!live_block<D, PAD>(p, blk)) return;
    const int b = blk.b, h0 = blk.h0, nr = blk.nr, lo = blk.lo, hi = blk.hi;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int c0 = blk.split * p.chunk;
    const int first = max(c0, lo) / TILE * TILE;
    const int ntiles = (min(c0 + p.chunk - 1, hi) - first) / TILE + 1;

    const size_t off = ((size_t)b * p.KvH + blk.g) * p.S;   // (b, g)'s position 0
    const TC* kb = static_cast<const TC*>(p.k) + off * hd;
    const TC* vb = static_cast<const TC*>(p.v) + off * hd;
    const float* ksb = Q8 ? p.ks + off : nullptr;
    const float* vsb = Q8 ? p.vs + off : nullptr;

    // tile i into ring slot i % STAGES; every thread commits one group per
    // call, empty past the last tile, so the wait counts stay uniform. The
    // pieces past the head dim are zero-filled like dead positions
    auto fetch = [&](int i) {
        if (i < ntiles) {
            const int t0 = first + i * TILE, slot = i % STAGES;
            constexpr int CB = COPY_BYTES<TC, PAD>;
            constexpr int PER_ROW = D * (int)sizeof(TC) / CB;     // pieces of a ring row
            constexpr int ELEMS = CB / (int)sizeof(TC);
            constexpr int CHUNKS = TILE * PER_ROW;
#pragma unroll
            for (int c = 0; c < (CHUNKS + NTHREADS - 1) / NTHREADS; ++c) {
                const int e = threadIdx.x + NTHREADS * c;
                if (CHUNKS % NTHREADS == 0 || e < CHUNKS) {
                    const int row = e / PER_ROW, col = (e % PER_ROW) * ELEMS;
                    const int t = t0 + row;
                    const bool in = !PAD || col < hd;
                    const bool live = t >= lo && t <= hi && in;
                    const size_t src = (size_t)(live ? t : lo) * hd + (in ? col : 0);
                    const int dst = (slot * TILE + row) * D + col;
                    cp_ring<CB>(kring + dst, kb + src, live);
                    cp_ring<CB>(vring + dst, vb + src, live);
                }
            }
            if (Q8 && threadIdx.x < 2 * TILE) {
                const int row = threadIdx.x % TILE, t = t0 + row;
                const bool live = t >= lo && t <= hi;
                const bool is_k = threadIdx.x < TILE;
                cp4((is_k ? ksr : vsr) + slot * TILE + row, (is_k ? ksb : vsb) + (live ? t : lo),
                    live);
            }
        }
        cp_commit();
    };
#pragma unroll
    for (int i = 0; i < STAGES - 1; ++i) fetch(i);

    // this lane's dims of the group's query heads, scaled by log2(e) / sqrt(D)
    const float qs = p.scale * LOG2E;
    float qr[RMAX][DL];
#pragma unroll
    for (int r = 0; r < RMAX; ++r)
#pragma unroll
        for (int c = 0; c < DL; ++c) {
            const int dim = LN::dim(lane, c);
            const size_t i = ((size_t)b * p.H + h0 + r) * hd + dim;
            const float x = r >= nr || (PAD && dim >= hd) ? 0.f
                            : p.q_bf16 ? to_f32(static_cast<const __nv_bfloat16*>(p.q)[i])
                                       : static_cast<const float*>(p.q)[i];
            qr[r][c] = x * qs;
        }

    float m[RMAX], l[RMAX], acc[RMAX][DL];              // this warp's softmax state
#pragma unroll
    for (int r = 0; r < RMAX; ++r) {
        m[r] = -CUDART_INF_F;
        l[r] = 0.f;
#pragma unroll
        for (int c = 0; c < DL; ++c) acc[r][c] = 0.f;
    }
    const int j_me = (lane >> 2) & 7;                   // the position this lane's quad scores

    for (int i = 0; i < ntiles; ++i) {
        cp_wait<STAGES - 2>();                          // tile i has landed (this thread's part)
        __syncthreads();                                // ... everyone's; slot (i-1) % STAGES is free
        fetch(i + STAGES - 1);
        const int slot = i % STAGES;
        const int tg = first + i * TILE + warp * GROUP; // this warp's first position
        if (tg > hi || tg + GROUP - 1 < lo) continue;   // no live position in the group
        const int base = slot * TILE + warp * GROUP;
        const TC* kt = kring + (size_t)base * D;
        float kf[GROUP][DL];
#pragma unroll
        for (int j = 0; j < GROUP; ++j) LN::load(kt + j * D, lane, kf[j]);
        const int t_me = tg + j_me;
        const bool live = t_me >= lo && t_me <= hi;
        const float kscale = Q8 ? ksr[base + j_me] : 1.f;

        float pr[RMAX];
#pragma unroll
        for (int r = 0; r < RMAX; ++r) {
            if (r >= nr) break;
            float s[GROUP];
#pragma unroll
            for (int j = 0; j < GROUP; ++j) {
                s[j] = qr[r][0] * kf[j][0];
#pragma unroll
                for (int c = 1; c < DL; ++c) s[j] = fmaf(qr[r][c], kf[j][c], s[j]);
            }
            float sc = fold8(s, lane);
            sc = live ? sc * kscale : -CUDART_INF_F;    // dequantize K on the score
            float mx = fmaxf(sc, __shfl_xor_sync(FULL, sc, 4));
            mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 8));
            mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 16));
            const float m_new = fmaxf(m[r], mx);        // finite: the group has a live position
            const float a = exp2f(m[r] - m_new);        // 0 at the warp's first live group
            pr[r] = exp2f(sc - m_new);                  // 0 for a dead position
            l[r] = l[r] * a + pr[r];
            m[r] = m_new;
#pragma unroll
            for (int c = 0; c < DL; ++c) acc[r][c] *= a;
        }
        if ((lane & 3) == 0) {
            const float vscale = Q8 ? vsr[base + j_me] : 1.f;
#pragma unroll
            for (int r = 0; r < RMAX; ++r)              // dequantize V on the probability
                if (r < nr) pw[(warp * RMAX + r) * GROUP + j_me] = pr[r] * vscale;
        }
        __syncwarp();
        const TC* vt = vring + (size_t)base * D;
#pragma unroll
        for (int j = 0; j < GROUP; ++j) {
            float vf[DL];
            LN::load(vt + j * D, lane, vf);
#pragma unroll
            for (int r = 0; r < RMAX; ++r) {
                if (r >= nr) break;
                const float pj = pw[(warp * RMAX + r) * GROUP + j];
#pragma unroll
                for (int c = 0; c < DL; ++c) acc[r][c] = fmaf(pj, vf[c], acc[r][c]);
            }
        }
    }

    // the warps' states into shared memory (the rings are free now)
    cp_wait<0>();
    __syncthreads();
    float* red = reinterpret_cast<float*>(smem);        // [WARPS][RMAX][D]
    float* red_m = red + WARPS * RMAX * D;              // [WARPS][RMAX]
    float* red_l = red_m + WARPS * RMAX;
#pragma unroll
    for (int r = 0; r < RMAX; ++r) {
        if (r >= nr) break;
        float lt = l[r];                                // the 8 quads' positions
        lt += __shfl_xor_sync(FULL, lt, 4);
        lt += __shfl_xor_sync(FULL, lt, 8);
        lt += __shfl_xor_sync(FULL, lt, 16);
        LN::store(red + (warp * RMAX + r) * D, lane, acc[r]);
        if (lane == 0) {
            red_m[warp * RMAX + r] = m[r];
            red_l[warp * RMAX + r] = lt;
        }
    }
    __syncthreads();
    finish<RMAX, D, PAD, 2 * L::ring>(p, blk, smem, red, red_m, red_l, wsm);
}

// ---- path 1: tensor cores ------------------------------------------------

// int8 -> bf16, exactly: the byte x ^ 0x80 = x + 128 in the low mantissa
// byte of 2^23 is the float 2^23 + 128 + x; one subtraction leaves x,
// whose f32 bits truncate exactly to its bf16. `ux` holds 4 bytes already
// ^ 0x80; the pair (byte i of ux, byte j of uy), i in the low half.
__device__ __forceinline__ uint32_t i8_f32(unsigned ux, unsigned i) {
    return __float_as_uint(__uint_as_float(__byte_perm(ux, 0x4b000000u, 0x7540u | i)) -
                           8388736.f);
}
__device__ __forceinline__ uint32_t i8_pair(unsigned ux, unsigned i, unsigned uy, unsigned j) {
    return __byte_perm(i8_f32(ux, i), i8_f32(uy, j), 0x7632);
}

// The shapes of path 1 for a cache of TC at head dim D, and its dynamic
// shared memory: the K and V rings [STAGES][TC_TILE][D], with int8 the
// scale rings [STAGES][TC_TILE] for K and V, q's A fragments where they
// do not stay in registers, the merge's weights [TC_HEADS][MAX_SPLITS];
// after the walk the rings hold the warps' states.
template <typename TC, int D> struct Tc {
    static constexpr bool Q8 = sizeof(TC) == 1;
    static constexpr int E = 16 / (int)sizeof(TC);      // dims in 16 bytes of a row
    static constexpr int KPS = E / 4;                   // k-steps one 16-byte load feeds
    static constexpr int SPANS = D / (4 * E);           // such loads a lane makes per row
    static constexpr int KS = D / 16;                   // k-steps of S
    static constexpr int NT = D / 8;                    // n-tiles of PV
    static constexpr int ROW = D * (int)sizeof(TC);     // bytes a position
    static constexpr int CHUNKS = ROW / 16;
    static constexpr int STAGES = D > 128 && !Q8 ? 2 : 3;
    static constexpr bool QREG = D <= 128;              // q's fragments in registers
    static constexpr size_t ring = (size_t)STAGES * TC_TILE * ROW;
    static constexpr size_t scales = Q8 ? STAGES * TC_TILE * sizeof(float) : 0;
    static constexpr size_t qfrag = QREG ? 0 : (size_t)QT * KS * 32 * sizeof(uint4);
    static constexpr size_t weights = TC_HEADS * MAX_SPLITS * sizeof(float);
    static constexpr size_t bytes = 2 * ring + 2 * scales + qfrag + weights;
    static_assert(D % (4 * E) == 0 && (TC_TILE * CHUNKS) % NTHREADS == 0, "whole loads");
    static_assert(WARPS * TC_HEADS * (D + 2) * sizeof(float) <= 2 * ring,
                  "the warps' states fit in the rings");
    static_assert(bytes <= SMEM_MAX, "the rings fit in a block's shared memory");
    // 16-byte chunk c of tile row r lies at chunk c ^ swz(r) of the row. K
    // (a lane reads 4 consecutive chunks of row r, a quad's neighbour
    // quad row r + 1): rows of one phase fall in the two halves of the
    // banks. V in bf16 (ldmatrix.trans: 8 rows at one chunk): 8 distinct
    // chunks. V in int8 (4-byte loads of rows 2t, 2t + 1, 2t + 8, 2t + 9,
    // 32 bytes of one row a quad-column): rows 2t apart by 32 bytes.
    static __device__ __forceinline__ int swz_k(int r) { return CHUNKS >= 8 ? (r & 1) << 2 : 0; }
    static __device__ __forceinline__ int swz_v(int r) {
        if constexpr (!Q8) return r & 7;
        else return CHUNKS >= 8 ? ((r >> 1) & 3) << 1 : ((r >> 1) & 1) << 1;
    }
    // the B fragments of k-step j of a 16-byte chunk x of a K row: in lane
    // t of each quad, the chunk's dims 4 j, 4 j + 1 stand for the MMA's
    // rows 2 t, 2 t + 1 and 4 j + 2, 4 j + 3 for rows 2 t + 8, 2 t + 9
    static __device__ __forceinline__ void kfrag(const uint4& x, int j, uint32_t& b0,
                                                 uint32_t& b1) {
        const unsigned w[4] = {x.x, x.y, x.z, x.w};
        if constexpr (!Q8) {
            b0 = w[2 * j];
            b1 = w[2 * j + 1];
        } else {
            const unsigned u = w[j] ^ 0x80808080u;
            b0 = i8_pair(u, 0, u, 1);
            b1 = i8_pair(u, 2, u, 3);
        }
    }
};

// 4 consecutive elements of q from element i, as f32 (zeros when !on)
__device__ __forceinline__ void q4(const Params& p, size_t i, bool on, float (&x)[4]) {
    x[0] = x[1] = x[2] = x[3] = 0.f;
    if (!on) return;
    if (p.q_bf16) {
        const uint2 u = *reinterpret_cast<const uint2*>(static_cast<const __nv_bfloat16*>(p.q) + i);
        x[0] = bf_lo(u.x); x[1] = bf_hi(u.x); x[2] = bf_lo(u.y); x[3] = bf_hi(u.y);
    } else {
        const float4 f = *reinterpret_cast<const float4*>(static_cast<const float*>(p.q) + i);
        x[0] = f.x; x[1] = f.y; x[2] = f.z; x[3] = f.w;
    }
}

// D the instance's width; PAD: the call's head dim p.D < D, the dims past
// it zero in the rings and in q's fragments, and the k-steps and PV tiles
// wholly past it skipped
template <typename TC, int D, bool PAD>
__global__ void __launch_bounds__(NTHREADS) decode_attn_tc(const Params p) {
    using C = Tc<TC, D>;
    constexpr bool Q8 = C::Q8;
    constexpr int E = C::E, KPS = C::KPS, KS = C::KS, NT = C::NT, ROW = C::ROW;
    constexpr int ST = C::STAGES;
    const int hd = head_dim<D, PAD>(p);
    const int grow = PAD ? hd * (int)sizeof(TC) : ROW;  // a K/V row's bytes in global memory
    extern __shared__ __align__(16) unsigned char smem[];
    unsigned char* kring = smem;
    unsigned char* vring = smem + C::ring;
    float* ksr = reinterpret_cast<float*>(smem + 2 * C::ring);
    float* vsr = ksr + ST * TC_TILE;
    uint4* qsm = reinterpret_cast<uint4*>(smem + 2 * C::ring + 2 * C::scales);
    float* wsm = reinterpret_cast<float*>(smem + 2 * C::ring + 2 * C::scales + C::qfrag);

    const Block blk = block_of(p);
    if (!live_block<D, PAD>(p, blk)) return;
    const int lo = blk.lo, hi = blk.hi;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, t = lane & 3;              // the MMA fragments' row and column pair
    const int c0 = blk.split * p.chunk;
    const int first = max(c0, lo) / TC_TILE * TC_TILE;
    const int ntiles = (min(c0 + p.chunk - 1, hi) - first) / TC_TILE + 1;

    const size_t off = ((size_t)blk.b * p.KvH + blk.g) * p.S;   // (b, g)'s position 0
    const unsigned char* kb = static_cast<const unsigned char*>(p.k) + off * grow;
    const unsigned char* vb = static_cast<const unsigned char*>(p.v) + off * grow;
    const float* ksb = Q8 ? p.ks + off : nullptr;
    const float* vsb = Q8 ? p.vs + off : nullptr;

    // tile i into ring slot i % ST, as in path 2, each 16-byte chunk at its
    // swizzled place (a piece of CB bytes keeps its place in its chunk)
    auto fetch = [&](int i) {
        if (i < ntiles) {
            const int t0 = first + i * TC_TILE, slot = i % ST;
            constexpr int CB = COPY_BYTES<TC, PAD>;
            constexpr int PIECES = ROW / CB;
#pragma unroll
            for (int c = 0; c < TC_TILE * PIECES / NTHREADS; ++c) {
                const int e = threadIdx.x + NTHREADS * c;
                const int row = e / PIECES, pc = e % PIECES, at = t0 + row;
                const int col = pc * CB / 16, in16 = pc * CB % 16;   // its chunk, its byte there
                const bool in = !PAD || pc * CB < grow;
                const bool live = at >= lo && at <= hi && in;
                const size_t src = (size_t)(live ? at : lo) * grow + (in ? pc * CB : 0);
                const size_t dst = (size_t)(slot * TC_TILE + row) * ROW + in16;
                cp_ring<CB>(kring + dst + ((col ^ C::swz_k(row)) << 4), kb + src, live);
                cp_ring<CB>(vring + dst + ((col ^ C::swz_v(row)) << 4), vb + src, live);
            }
            if (Q8 && threadIdx.x < 2 * TC_TILE) {
                const int row = threadIdx.x % TC_TILE, at = t0 + row;
                const bool live = at >= lo && at <= hi;
                const bool is_k = threadIdx.x < TC_TILE;
                cp4((is_k ? ksr : vsr) + slot * TC_TILE + row,
                    (is_k ? ksb : vsb) + (live ? at : lo), live);
            }
        }
        cp_commit();
    };
#pragma unroll
    for (int i = 0; i < ST - 1; ++i) fetch(i);

    // q's A fragments, QT bf16 terms of q scaled by log2(e) / sqrt(D): in
    // k-step kk, lane t of a quad holds dims d0 .. d0 + 3 of rows g and
    // g + 8, the dims its K fragments hold (Tc::kfrag)
    const float qs = p.scale * LOG2E;
    uint32_t qa[C::QREG ? QT : 1][C::QREG ? KS : 1][4];
    if (C::QREG || warp == 0) {
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
            const int d0 = (kk / KPS) * 4 * E + E * t + 4 * (kk % KPS);
            float x[2][4];
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
                const int r = g + 8 * hf;
                q4(p, ((size_t)blk.b * p.H + blk.h0 + r) * hd + d0,
                   r < blk.nr && (!PAD || d0 < hd), x[hf]);
#pragma unroll
                for (int c = 0; c < 4; ++c) x[hf][c] *= qs;
            }
            uint32_t a[4][QT];
            split2<QT>(x[0][0], x[0][1], a[0]);         // row g, MMA columns 2t, 2t + 1
            split2<QT>(x[1][0], x[1][1], a[1]);         // row g + 8
            split2<QT>(x[0][2], x[0][3], a[2]);         // row g, columns 2t + 8, 2t + 9
            split2<QT>(x[1][2], x[1][3], a[3]);
#pragma unroll
            for (int tt = 0; tt < QT; ++tt) {
                if constexpr (C::QREG) {
#pragma unroll
                    for (int f = 0; f < 4; ++f) qa[tt][kk][f] = a[f][tt];
                } else {
                    qsm[(tt * KS + kk) * 32 + lane] = make_uint4(a[0][tt], a[1][tt], a[2][tt],
                                                                 a[3][tt]);
                }
            }
        }
    }

    // this warp's softmax state for rows g and g + 8, and its PV
    // accumulators (n-tile n, the C fragment's 4 values)
    float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};
    float acc[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[n][c] = 0.f;

    for (int i = 0; i < ntiles; ++i) {
        cp_wait<ST - 2>();                              // tile i has landed (this thread's part)
        __syncthreads();                                // ... everyone's; slot (i-1) % ST is free
        fetch(i + ST - 1);
        const int slot = i % ST;
        const int tw = first + i * TC_TILE + 16 * warp; // this warp's first position
        if (tw > hi || tw + 15 < lo) continue;          // no live position among its 16
        const unsigned char* kt = kring + (size_t)slot * TC_TILE * ROW;
        const unsigned char* vt = vring + (size_t)slot * TC_TILE * ROW;

        // S = Q K^T: n-tile nt is the warp's positions 8 nt .. 8 nt + 7
        float s[2][4];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int c = 0; c < 4; ++c) s[nt][c] = 0.f;
#pragma unroll
        for (int sp = 0; sp < C::SPANS; ++sp) {
            if (PAD && sp * 4 * E >= hd) break;         // its dims are all zero
            uint4 x[2];
#pragma unroll
            for (int nt = 0; nt < 2; ++nt) {
                const int r = 16 * warp + 8 * nt + g;
                x[nt] = *reinterpret_cast<const uint4*>(
                    kt + r * ROW + (((4 * sp + t) ^ C::swz_k(r)) << 4));
            }
#pragma unroll
            for (int j = 0; j < KPS; ++j) {
                const int kk = sp * KPS + j;
                uint32_t kf[2][2];
#pragma unroll
                for (int nt = 0; nt < 2; ++nt) C::kfrag(x[nt], j, kf[nt][0], kf[nt][1]);
#pragma unroll
                for (int tt = QT - 1; tt >= 0; --tt) {  // the smaller term first
                    uint32_t a[4];
                    if constexpr (C::QREG) {
#pragma unroll
                        for (int f = 0; f < 4; ++f) a[f] = qa[tt][kk][f];
                    } else {
                        const uint4 u = qsm[(tt * KS + kk) * 32 + lane];
                        a[0] = u.x; a[1] = u.y; a[2] = u.z; a[3] = u.w;
                    }
                    mma(s[0], a, kf[0][0], kf[0][1]);
                    mma(s[1], a, kf[1][0], kf[1][1]);
                }
            }
        }

        // the online softmax on the fragments: value c of n-tile nt is row
        // g + 8 (c >> 1), position 8 nt + 2 t + (c & 1) of the warp's 16
        float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                const int col = 8 * nt + 2 * t + (c & 1);
                const int at = tw + col;
                float x = s[nt][c];
                if constexpr (Q8) x *= ksr[slot * TC_TILE + 16 * warp + col];   // K's scale
                s[nt][c] = at >= lo && at <= hi ? x : -CUDART_INF_F;
                mx[c >> 1] = fmaxf(mx[c >> 1], s[nt][c]);
            }
        float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
            mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(FULL, mx[hf], 1));
            mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(FULL, mx[hf], 2));
            const float mn = fmaxf(m[hf], mx[hf]);      // finite: a live position
            alpha[hf] = exp2f(m[hf] - mn);              // 0 at the warp's first live tile
            m[hf] = mn;
        }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                s[nt][c] = exp2f(s[nt][c] - m[c >> 1]); // 0 for a dead position
                rs[c >> 1] += s[nt][c];
                if constexpr (Q8)                       // V's scale on the probability
                    s[nt][c] *= vsr[slot * TC_TILE + 16 * warp + 8 * nt + 2 * t + (c & 1)];
            }
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) l[hf] = fmaf(l[hf], alpha[hf], rs[hf]);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
            acc[n][0] *= alpha[0];
            acc[n][1] *= alpha[0];
            acc[n][2] *= alpha[1];
            acc[n][3] *= alpha[1];
        }
        // P's A fragments in PT bf16 terms: n-tile 0 gives the MMA's
        // columns 2t, 2t + 1 (rows g, g + 8), n-tile 1 columns 2t + 8, 2t + 9
        uint32_t pf[4][PT], pa[PT][4];
        split2<PT>(s[0][0], s[0][1], pf[0]);
        split2<PT>(s[0][2], s[0][3], pf[1]);
        split2<PT>(s[1][0], s[1][1], pf[2]);
        split2<PT>(s[1][2], s[1][3], pf[3]);
#pragma unroll
        for (int tt = 0; tt < PT; ++tt)
#pragma unroll
            for (int f = 0; f < 4; ++f) pa[tt][f] = pf[f][tt];

        // PV: n-tile n's B fragments are positions (2t, 2t + 1) and (2t + 8,
        // 2t + 9) of one dim in each lane
        if constexpr (!Q8) {
            // bf16: n-tiles 2 cc, 2 cc + 1 (dims 16 cc .. 16 cc + 15) from
            // one ldmatrix.x4.trans: matrix mt is positions 8 (mt & 1) ..
            // + 7 at chunk 2 cc + (mt >> 1); n-tile column g is dim g
#pragma unroll
            for (int cc = 0; cc < D / 16; ++cc) {
                if (PAD && 16 * cc >= hd) break;        // dims past the head dim
                const int mt = lane >> 3;
                const int r = 16 * warp + 8 * (mt & 1) + (lane & 7);
                const int ch = 2 * cc + (mt >> 1);
                uint32_t bv[4];
                ldsm4t(bv, vt + r * ROW + ((ch ^ C::swz_v(r)) << 4));
#pragma unroll
                for (int tt = PT - 1; tt >= 0; --tt) {
                    mma(acc[2 * cc], pa[tt], bv[0], bv[1]);
                    mma(acc[2 * cc + 1], pa[tt], bv[2], bv[3]);
                }
            }
        } else {
            // int8: lane (g, t) reads 4 bytes, dims 32 s8 + 4 g .. + 3, of
            // positions 2t, 2t + 1, 2t + 8, 2t + 9; n-tile 4 s8 + i takes
            // byte i, so its column g is dim 32 s8 + 4 g + i
#pragma unroll
            for (int s8 = 0; s8 < D / 32; ++s8) {
                if (PAD && 32 * s8 >= hd) break;        // dims past the head dim
                const int ch = 2 * s8 + (g >> 2), in = 4 * (g & 3);
                unsigned u[4];
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int r = 16 * warp + 2 * t + (e & 1) + 8 * (e >> 1);
                    u[e] = *reinterpret_cast<const unsigned*>(
                               vt + r * ROW + ((ch ^ C::swz_v(r)) << 4) + in) ^ 0x80808080u;
                }
#pragma unroll
                for (int i8 = 0; i8 < 4; ++i8) {
                    const uint32_t b0 = i8_pair(u[0], i8, u[1], i8);
                    const uint32_t b1 = i8_pair(u[2], i8, u[3], i8);
#pragma unroll
                    for (int tt = PT - 1; tt >= 0; --tt) mma(acc[4 * s8 + i8], pa[tt], b0, b1);
                }
            }
        }
    }

    // the warps' states into shared memory (the rings are free now)
    cp_wait<0>();
    __syncthreads();
    float* red = reinterpret_cast<float*>(smem);        // [WARPS][TC_HEADS][D]
    float* red_m = red + WARPS * TC_HEADS * D;          // [WARPS][TC_HEADS]
    float* red_l = red_m + WARPS * TC_HEADS;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {                    // the quad's positions
        l[hf] += __shfl_xor_sync(FULL, l[hf], 1);
        l[hf] += __shfl_xor_sync(FULL, l[hf], 2);
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            const int col = 2 * t + (c & 1);
            const int dim = Q8 ? 32 * (n >> 2) + 4 * col + (n & 3) : 8 * n + col;
            red[(warp * TC_HEADS + g + 8 * (c >> 1)) * D + dim] = acc[n][c];
        }
    if (t == 0) {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
            red_m[warp * TC_HEADS + g + 8 * hf] = m[hf];
            red_l[warp * TC_HEADS + g + 8 * hf] = l[hf];
        }
    }
    __syncthreads();
    finish<TC_HEADS, D, PAD, 2 * C::ring>(p, blk, smem, red, red_m, red_l, wsm);
}

// ---- host side ------------------------------------------------------------

template <typename TC, bool Q8, int RMAX, int D, bool PAD>
cudaError_t launch_cc(const Params& p, cudaStream_t st) {
    decode_attn_cc<TC, Q8, RMAX, D, PAD><<<dim3(p.splits * p.groups, p.KvH, p.B), NTHREADS,
                                           Smem<TC, Q8, RMAX, D>::bytes, st>>>(p);
    return cudaGetLastError();
}

// path 2 at the plan's group size: 1, 2, 4 and, where registers allow, 8
template <typename TC, bool Q8, int D, bool PAD>
cudaError_t dispatch_cc(const Params& p, cudaStream_t st) {
    switch (p.heads) {
        case 1: return launch_cc<TC, Q8, 1, D, PAD>(p, st);
        case 2: return launch_cc<TC, Q8, 2, D, PAD>(p, st);
        case 4: return launch_cc<TC, Q8, 4, D, PAD>(p, st);
        case 8:
            if constexpr (rmax_cap(D) >= 8) return launch_cc<TC, Q8, 8, D, PAD>(p, st);
            break;
    }
    return cudaErrorInvalidValue;
}

template <typename TC, int D, bool PAD>
cudaError_t launch_tc(const Params& p, cudaStream_t st) {
    if (p.heads != TC_HEADS) return cudaErrorInvalidValue;
    decode_attn_tc<TC, D, PAD><<<dim3(p.splits * p.groups, p.KvH, p.B), NTHREADS,
                                 Tc<TC, D>::bytes, st>>>(p);
    return cudaGetLastError();
}

template <int D, bool PAD>
cudaError_t dispatch(const Params& p, int cdtype, int tc, cudaStream_t st) {
    if (tc) {
        if (cdtype == 1) return launch_tc<__nv_bfloat16, D, PAD>(p, st);
        if (cdtype == 2) return launch_tc<int8_t, D, PAD>(p, st);
        return cudaErrorInvalidValue;                   // an f32 cache is not exact in bf16
    }
    if (cdtype == 0) return dispatch_cc<float, false, D, PAD>(p, st);
    if (cdtype == 1) return dispatch_cc<__nv_bfloat16, false, D, PAD>(p, st);
    if (cdtype == 2) return dispatch_cc<int8_t, true, D, PAD>(p, st);
    return cudaErrorInvalidValue;
}

// the smallest width that holds p.D, its exact (PAD false: p.D is the
// width) or padded instance
template <bool PAD, int... Ds>
cudaError_t dispatch_width(const Params& p, int cdtype, int tc, cudaStream_t st, Dims<Ds...>) {
    cudaError_t e = cudaErrorInvalidValue;
    ((p.D <= Ds ? (e = dispatch<Ds, PAD>(p, cdtype, tc, st), true) : false) || ...);
    return e;
}

template <int... Ds>
constexpr bool has_dim(int d, Dims<Ds...>) { return ((d == Ds) || ...); }

// every instance of a width: path 2's group sizes for each cache type,
// path 1's bf16 and int8
template <int D, bool PAD>
cudaError_t set_smem_dim() {
    cudaError_t e = cudaSuccess;
    auto set = [&](auto kernel, size_t bytes) {
        if (e == cudaSuccess)
            e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     (int)bytes);
    };
    auto cc = [&](auto tc, auto q8) {
        using TC = decltype(tc);
        constexpr bool Q8 = decltype(q8)::value;
        set(decode_attn_cc<TC, Q8, 1, D, PAD>, Smem<TC, Q8, 1, D>::bytes);
        set(decode_attn_cc<TC, Q8, 2, D, PAD>, Smem<TC, Q8, 2, D>::bytes);
        set(decode_attn_cc<TC, Q8, 4, D, PAD>, Smem<TC, Q8, 4, D>::bytes);
        if constexpr (rmax_cap(D) >= 8)
            set(decode_attn_cc<TC, Q8, 8, D, PAD>, Smem<TC, Q8, 8, D>::bytes);
    };
    cc(float{}, std::false_type{});
    cc(__nv_bfloat16{}, std::false_type{});
    cc(int8_t{}, std::true_type{});
    set(decode_attn_tc<__nv_bfloat16, D, PAD>, Tc<__nv_bfloat16, D>::bytes);
    set(decode_attn_tc<int8_t, D, PAD>, Tc<int8_t, D>::bytes);
    return e;
}

template <bool PAD, int... Ds>
cudaError_t set_smem_all(Dims<Ds...>) {
    cudaError_t e = cudaSuccess;
    ((e == cudaSuccess ? (e = set_smem_dim<Ds, PAD>()) : e), ...);
    return e;
}

// a source's part: its instances of the widths Ws, exact or padded (PAD)
template <bool PAD, int... Ws>
constexpr decode_attention_cu::Part make_part(Dims<Ws...>) {
    return {[](const Params& p, int cdtype, int tc, cudaStream_t st) {
                return dispatch_width<PAD>(p, cdtype, tc, st, Dims<Ws...>{});
            },
            [] { return set_smem_all<PAD>(Dims<Ws...>{}); }};
}

}  // namespace

