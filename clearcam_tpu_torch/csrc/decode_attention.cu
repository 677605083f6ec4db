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
// [B, KvH, S] f32; pos, pads [B] int32 on the card. D one of HeadDims
// below (64: Llama-3.2-1B, Qwen2.5-0.5B; 128: Qwen3, Llama-3.x 3B/8B; 256:
// Qwen3-Next's attention blocks); any rep = H / KvH; any S.
//
// What bounds it: the bytes of the live K and V. Per position and KV head a
// step reads 4 D bytes of bf16 K + V (2 D of int8, plus 8 of scales) and
// does 4 rep D FLOPs: rep FLOP/byte, 2 at Qwen3's rep = 2, 16 at
// Qwen3-235B's, against the f32 CUDA cores' ridge of 67e12 / 3.35e12 = 20
// FLOP/byte. So HBM bandwidth bounds it, and the f32 CUDA cores do the
// math: tensor cores (mma / wgmma) would buy nothing here and would round
// the f32 query, the model's residual stream, to bf16.
//
// Design: flash-decoding, two launches per call.
// 1. `decode_split`, grid (split x head group, KV head, row), 128 threads.
//    The host-side plan (`plan` in ops/decode_attention.py) cuts the
//    cache's positions into `splits` chunks of `chunk` positions (a
//    multiple of TILE) from (B, KvH, S) alone, never from pos or pads, so a
//    call can be captured in a CUDA graph and replayed with new positions.
//    A KV head's rep query heads are walked in groups of at most RMAX (8,
//    4 at D > 128, where a lane's registers hold twice the dims): a group
//    is a block, next to its siblings in grid.x so they read the same K/V
//    tiles close in time (from L2 after the first). A block whose chunk
//    misses its row's window pads[b]..pos[b] exits at once and writes
//    nothing; the others walk their part of the window in tiles of TILE =
//    32 positions and write f32 partials for their group's query heads:
//    the running max m (log2 units), the sum l and acc[D]. The plan keeps
//    the grid near 2,048 blocks a head group, so the live blocks of a long
//    window cover the 132 SMs: at B = 1, KvH = 8, S = 2048, chunks of 64
//    (144 live blocks at pos 1100); at B = 8, KvH = 8, S = 8192, chunks of
//    256 (at most 8 tiles of serial walk per block).
// 2. `decode_merge`, grid (head, row), D threads (one per dim): over the
//    splits that meet the window, out = sum_j 2^(m_j - M) acc_j /
//    sum_j 2^(m_j - M) l_j with M = max_j m_j. A live split holds a live
//    column, so l_j >= 1 for the largest m_j: no 0/0 and no exp(-inf - -inf).
//    A row with no live column (pads > pos) meets no split and gets zeros.
//
// In a block, K and V tiles (and with int8 the scales) go through a ring of
// STAGES slots in dynamic shared memory, filled with cp.async (16 bytes a
// thread; 4 for a scale) in commit groups: STAGES - 1 tiles are in flight
// while one is computed, and one __syncthreads per tile guards the ring. At
// D = 256 on an f32 cache the K and V rings take 192 KB of the 227 KB a
// block may have. Positions outside the window are zero-filled, not read.
// Each warp owns 8 positions of a tile and its own online softmax (m, l,
// acc for every query head of the group), so warps never wait on each
// other inside the walk; they merge in shared memory at the end. A lane
// holds DL = D / 32 dims, as NV vectors of W = 4, 2 or 1 consecutive dims
// (the widest that divides DL), vector v at dim 32 W v + W lane: each
// vector load of a warp reads one contiguous run of the row, without bank
// conflicts (at D = 128 one float4 of dims 4 lane..4 lane + 3). A lane
// scores the 8 positions with 8 independent partial dot products per query
// head, folded over the warp by a transposed reduction (9 shuffles for 8
// scores, against 40 for one reduction each), which leaves position
// (lane >> 2) & 7 in every lane of its quad, whatever DL is. The
// probabilities go through shared memory to the PV product, whose DL
// accumulators per query head and lane take 8 dependent FMAs a tile. q is
// pre-scaled by log2(e) / sqrt(D), so exp is exp2. int8 is widened to f32
// only in registers (the byte placed in the mantissa of 2^23, exact): K's
// scale multiplies the reduced score, V's scale the probability written
// for PV, and l takes the unscaled probability, so the merge is the same
// for every cache type. The kernels allocate nothing: the wrapper passes
// the partials' scratch. `decode_attention_prepare` raises the dynamic
// shared-memory limit once per device; `decode_attention_forward` returns
// cudaGetLastError() after the two launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

// the head dims with an instance; HEAD_DIMS in ops/decode_attention.py
// names the same set. The kernel takes any multiple of 32 up to 256: each
// dim added here costs 12 more instances to build (9 above 128)
template <int... Ds> struct Dims {};
using HeadDims = Dims<64, 128, 256>;
constexpr int MAX_D = 256;                    // head dims are multiples of 32 up to this

constexpr int WARPS = 4;
constexpr int NTHREADS = 32 * WARPS;
constexpr int GROUP = 8;                      // positions a warp scores at once
constexpr int TILE = WARPS * GROUP;           // positions per ring slot
constexpr int STAGES = 3;                     // ring slots (3 read faster than 4 on the H100)
constexpr int SMEM_MAX = 232448;              // bytes of shared memory a block may have
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

// query heads a block walks at most at head dim D: a lane keeps D / 32 dims
// of each one's q and acc in registers
constexpr int rmax_cap(int D) { return D > 128 ? 4 : 8; }

static_assert(GROUP == 8, "the transposed reduction folds 8 scores over lane bits 4, 3, 2");

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
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// cp.async: `bytes` from global to shared memory, zero-filled when !on
// (nothing is read then)
__device__ __forceinline__ void cp16(void* dst, const void* src, bool on) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(s), "l"(src), "r"(on ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp4(void* dst, const void* src, bool on) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(s), "l"(src), "r"(on ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

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

// dynamic shared memory: the K and V rings [STAGES][TILE][D], with int8 the
// scale rings [STAGES][TILE] for K and V, then the probabilities each warp
// hands to its PV product [WARPS][RMAX][GROUP]; after the walk the rings
// hold the warps' states for the block's merge
template <typename TC, bool Q8, int RMAX, int D> struct Smem {
    static constexpr int ring_elems = STAGES * TILE * D;
    static constexpr size_t ring = ring_elems * sizeof(TC);
    static constexpr size_t scales = Q8 ? STAGES * TILE * sizeof(float) : 0;
    static constexpr size_t probs = WARPS * RMAX * GROUP * sizeof(float);
    static constexpr size_t bytes = 2 * ring + 2 * scales + probs;
    static_assert(WARPS * RMAX * (D + 2) * sizeof(float) <= 2 * ring,
                  "the warps' states fit in the rings");
    static_assert(bytes <= SMEM_MAX, "the rings fit in a block's shared memory");
};

template <typename TC, bool Q8, int RMAX, int D>
__global__ void __launch_bounds__(NTHREADS)
decode_split(const void* __restrict__ q, int q_bf16, const TC* __restrict__ k,
             const TC* __restrict__ v, const float* __restrict__ ks,
             const float* __restrict__ vsc, const int* __restrict__ pos,
             const int* __restrict__ pads, float* __restrict__ part_acc,
             float* __restrict__ part_ml, int H, int KvH, int rep, int groups, int S,
             int chunk, int splits, float scale) {
    using L = Smem<TC, Q8, RMAX, D>;
    using LN = Lane<D>;
    constexpr int DL = LN::DL;
    extern __shared__ __align__(16) unsigned char smem[];
    TC* kring = reinterpret_cast<TC*>(smem);
    TC* vring = kring + L::ring_elems;
    float* ksr = reinterpret_cast<float*>(smem + 2 * L::ring);
    float* vsr = ksr + STAGES * TILE;
    float* pw = reinterpret_cast<float*>(smem + 2 * L::ring + 2 * L::scales);

    // grid.x is (split, head group); rep = H / KvH and groups come from the host
    const int split = blockIdx.x / groups, grp = blockIdx.x % groups;
    const int g = blockIdx.y, b = blockIdx.z;
    const int h0 = g * rep + grp * RMAX;                // this block's first query head
    const int nr = min(RMAX, rep - grp * RMAX);         // ... and how many it walks
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int lo = max(__ldg(pads + b), 0);
    const int hi = min(__ldg(pos + b), S - 1);
    const int c0 = split * chunk;
    if (c0 > hi || c0 + chunk <= lo) return;            // the merge skips this split
    const int first = max(c0, lo) / TILE * TILE;
    const int ntiles = (min(c0 + chunk - 1, hi) - first) / TILE + 1;

    const size_t off = ((size_t)b * KvH + g) * S;       // (b, g)'s position 0
    const TC* kb = k + off * D;
    const TC* vb = v + off * D;
    const float* ksb = Q8 ? ks + off : nullptr;
    const float* vsb = Q8 ? vsc + off : nullptr;

    // tile i into ring slot i % STAGES; every thread commits one group per
    // call, empty past the last tile, so the wait counts stay uniform
    auto fetch = [&](int i) {
        if (i < ntiles) {
            const int t0 = first + i * TILE, slot = i % STAGES;
            constexpr int PER_ROW = D * (int)sizeof(TC) / 16;     // 16-byte chunks
            constexpr int ELEMS = 16 / (int)sizeof(TC);
            constexpr int CHUNKS = TILE * PER_ROW;
#pragma unroll
            for (int c = 0; c < (CHUNKS + NTHREADS - 1) / NTHREADS; ++c) {
                const int e = threadIdx.x + NTHREADS * c;
                if (CHUNKS % NTHREADS == 0 || e < CHUNKS) {
                    const int row = e / PER_ROW, col = (e % PER_ROW) * ELEMS;
                    const int t = t0 + row;
                    const bool live = t >= lo && t <= hi;
                    const size_t src = (size_t)(live ? t : lo) * D + col;
                    const int dst = (slot * TILE + row) * D + col;
                    cp16(kring + dst, kb + src, live);
                    cp16(vring + dst, vb + src, live);
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
    const float qs = scale * LOG2E;
    float qr[RMAX][DL];
#pragma unroll
    for (int r = 0; r < RMAX; ++r)
#pragma unroll
        for (int c = 0; c < DL; ++c) {
            const size_t i = ((size_t)b * H + h0 + r) * D + LN::dim(lane, c);
            const float x = r >= nr ? 0.f
                            : q_bf16 ? to_f32(static_cast<const __nv_bfloat16*>(q)[i])
                                     : static_cast<const float*>(q)[i];
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

        float p[RMAX];
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
            p[r] = exp2f(sc - m_new);                   // 0 for a dead position
            l[r] = l[r] * a + p[r];
            m[r] = m_new;
#pragma unroll
            for (int c = 0; c < DL; ++c) acc[r][c] *= a;
        }
        if ((lane & 3) == 0) {
            const float vscale = Q8 ? vsr[base + j_me] : 1.f;
#pragma unroll
            for (int r = 0; r < RMAX; ++r)              // dequantize V on the probability
                if (r < nr) pw[(warp * RMAX + r) * GROUP + j_me] = p[r] * vscale;
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

    // merge the warps' states in shared memory (the rings are free now)
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
    for (int r = 0; r < nr; ++r) {
        float mx = -CUDART_INF_F;                       // finite: some warp saw a live position
#pragma unroll
        for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, red_m[w * RMAX + r]);
        float ls = 0.f;
        float e[WARPS];
#pragma unroll
        for (int w = 0; w < WARPS; ++w) {
            e[w] = exp2f(red_m[w * RMAX + r] - mx);     // 0 for a warp with no live column
            ls = fmaf(e[w], red_l[w * RMAX + r], ls);
        }
        const size_t row = ((size_t)b * H + h0 + r) * splits + split;
#pragma unroll
        for (int d = threadIdx.x; d < D; d += NTHREADS) {
            float a = 0.f;
#pragma unroll
            for (int w = 0; w < WARPS; ++w) a = fmaf(e[w], red[(w * RMAX + r) * D + d], a);
            part_acc[row * D + d] = a;
        }
        if (threadIdx.x == 0) {
            part_ml[2 * row] = mx;
            part_ml[2 * row + 1] = ls;
        }
    }
}

// one thread per dim
template <typename TQ, int D>
__global__ void __launch_bounds__(D)
decode_merge(const float* __restrict__ part_acc, const float* __restrict__ part_ml,
             const int* __restrict__ pos, const int* __restrict__ pads, TQ* __restrict__ out,
             int H, int S, int chunk, int splits) {
    const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
    const int lo = max(__ldg(pads + b), 0);
    const int hi = min(__ldg(pos + b), S - 1);
    TQ* o = out + ((size_t)b * H + h) * D + d;
    if (lo > hi) {                                      // no live column
        store(o, 0.f);
        return;
    }
    const size_t row = ((size_t)b * H + h) * splits;
    const int j0 = lo / chunk, j1 = hi / chunk;         // the splits that meet the window
    float mx = -CUDART_INF_F;
    for (int j = j0; j <= j1; ++j) mx = fmaxf(mx, part_ml[2 * (row + j)]);
    float a = 0.f, ls = 0.f;
    for (int j = j0; j <= j1; ++j) {
        const float e = exp2f(part_ml[2 * (row + j)] - mx);
        a = fmaf(e, part_acc[(row + j) * D + d], a);
        ls = fmaf(e, part_ml[2 * (row + j) + 1], ls);
    }
    store(o, a / ls);                                   // ls >= 1: the largest m_j's split
}

// the group sizes of a head dim: 1, 2, 4 and, where registers allow, 8
template <typename TC, bool Q8, int D>
cudaError_t set_smem_dim() {
    cudaError_t e = cudaSuccess;
    auto set = [&](auto kernel, size_t bytes) {
        if (e == cudaSuccess)
            e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     (int)bytes);
    };
    set(decode_split<TC, Q8, 1, D>, Smem<TC, Q8, 1, D>::bytes);
    set(decode_split<TC, Q8, 2, D>, Smem<TC, Q8, 2, D>::bytes);
    set(decode_split<TC, Q8, 4, D>, Smem<TC, Q8, 4, D>::bytes);
    if constexpr (rmax_cap(D) >= 8) set(decode_split<TC, Q8, 8, D>, Smem<TC, Q8, 8, D>::bytes);
    return e;
}

template <typename TC, bool Q8, int... Ds>
cudaError_t set_smem_all(Dims<Ds...>) {
    cudaError_t e = cudaSuccess;
    ((e == cudaSuccess ? (e = set_smem_dim<TC, Q8, Ds>()) : e), ...);
    return e;
}

struct Args {
    const void* q; int q_bf16; const void* k; const void* v; const float* ks; const float* vs;
    const int* pos; const int* pads; float* part_acc; float* part_ml;
    int B, H, KvH, S, D, chunk, splits; float scale; cudaStream_t st;
};

template <typename TC, bool Q8, int RMAX, int D>
cudaError_t launch_split(const Args& a) {
    const int rep = a.H / a.KvH, groups = (rep + RMAX - 1) / RMAX;
    decode_split<TC, Q8, RMAX, D>
        <<<dim3(a.splits * groups, a.KvH, a.B), NTHREADS, Smem<TC, Q8, RMAX, D>::bytes,
           a.st>>>(a.q, a.q_bf16, static_cast<const TC*>(a.k), static_cast<const TC*>(a.v),
                   a.ks, a.vs, a.pos, a.pads, a.part_acc, a.part_ml, a.H, a.KvH, rep, groups,
                   a.S, a.chunk, a.splits, a.scale);
    return cudaGetLastError();
}

// the smallest group that holds rep, else the largest: rep 7 walks one
// group of 8 (one head idle), rep 16 two of 8 (four of 4 at D = 256)
template <typename TC, bool Q8, int D>
cudaError_t dispatch_rep(const Args& a) {
    const int rep = a.H / a.KvH;
    if (rep <= 1) return launch_split<TC, Q8, 1, D>(a);
    if (rep <= 2) return launch_split<TC, Q8, 2, D>(a);
    if constexpr (rmax_cap(D) >= 8) {
        if (rep > 4) return launch_split<TC, Q8, 8, D>(a);
    }
    return launch_split<TC, Q8, 4, D>(a);
}

template <typename TC, bool Q8, int... Ds>
cudaError_t dispatch_dim(const Args& a, Dims<Ds...>) {
    cudaError_t e = cudaErrorInvalidValue;
    ((a.D == Ds ? (e = dispatch_rep<TC, Q8, Ds>(a), true) : false) || ...);
    return e;
}

template <typename TQ, int D>
cudaError_t launch_merge(const Args& a, void* out) {
    decode_merge<TQ, D><<<dim3(a.H, a.B), D, 0, a.st>>>(
        a.part_acc, a.part_ml, a.pos, a.pads, static_cast<TQ*>(out), a.H, a.S, a.chunk,
        a.splits);
    return cudaGetLastError();
}

template <typename TQ, int... Ds>
cudaError_t merge_dim(const Args& a, void* out, Dims<Ds...>) {
    cudaError_t e = cudaErrorInvalidValue;
    ((a.D == Ds ? (e = launch_merge<TQ, Ds>(a, out), true) : false) || ...);
    return e;
}

template <int... Ds>
constexpr bool has_dim(int d, Dims<Ds...>) { return ((d == Ds) || ...); }

}  // namespace

// Once per device, before its first decode_attention_forward: the dynamic
// shared-memory limit of every instance (the bf16 and f32 rings pass 48 KB).
extern "C" int decode_attention_prepare() {
    cudaError_t e;
    if ((e = set_smem_all<float, false>(HeadDims{})) != cudaSuccess) return (int)e;
    if ((e = set_smem_all<__nv_bfloat16, false>(HeadDims{})) != cudaSuccess) return (int)e;
    return (int)set_smem_all<int8_t, true>(HeadDims{});
}

// q [B, H, D], k and v [B, KvH, S, D] contiguous, out [B, H, D]; ks and vs
// [B, KvH, S] f32 for an int8 cache (null otherwise); pos and pads [B] int32
// on the card; part_acc [B, H, splits, D] and part_ml [B, H, splits, 2] f32
// scratch; chunk a multiple of 32 and splits = max(1, ceil(S / chunk)) (the
// wrapper's plan); D one of HeadDims; H % KvH == 0. qdtype (q and out): 0 =
// f32, 1 = bf16; cdtype (k, v): 0 = f32, 1 = bf16, 2 = int8. Two launches
// on `stream`; returns a cudaError_t.
extern "C" int decode_attention_forward(const void* q, const void* k, const void* v,
                                        const void* ks, const void* vs, void* out,
                                        const void* pos, const void* pads, void* part_acc,
                                        void* part_ml, int B, int H, int KvH, int S, int D,
                                        int chunk, int splits, float scale, int qdtype,
                                        int cdtype, void* stream) {
    if (B <= 0) return (int)cudaSuccess;
    const int want_splits = S > chunk ? (S + chunk - 1) / chunk : 1;
    if (KvH <= 0 || H <= 0 || H % KvH || !has_dim(D, HeadDims{}) || S < 0 || chunk <= 0 ||
        chunk % TILE || splits != want_splits || part_acc == nullptr || part_ml == nullptr ||
        (qdtype != 0 && qdtype != 1) || (cdtype == 2 && (ks == nullptr || vs == nullptr)))
        return (int)cudaErrorInvalidValue;
    const Args a{q, qdtype, k, v, static_cast<const float*>(ks), static_cast<const float*>(vs),
                 static_cast<const int*>(pos), static_cast<const int*>(pads),
                 static_cast<float*>(part_acc), static_cast<float*>(part_ml),
                 B, H, KvH, S, D, chunk, splits, scale, static_cast<cudaStream_t>(stream)};
    cudaError_t e;
    if (cdtype == 0) e = dispatch_dim<float, false>(a, HeadDims{});
    else if (cdtype == 1) e = dispatch_dim<__nv_bfloat16, false>(a, HeadDims{});
    else if (cdtype == 2) e = dispatch_dim<int8_t, true>(a, HeadDims{});
    else return (int)cudaErrorInvalidValue;
    if (e != cudaSuccess) return (int)e;
    return (int)(qdtype == 0 ? merge_dim<float>(a, out, HeadDims{})
                             : merge_dim<__nv_bfloat16>(a, out, HeadDims{}));
}
