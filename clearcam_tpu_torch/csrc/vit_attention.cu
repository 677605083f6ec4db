// Non-causal multi-head attention for ViT towers, as one kernel for Hopper
// (sm_90a), on the tensor cores:
//
//   out[b,h] = softmax(q[b,h] k[b,h]^T * scale) v[b,h]      over all T keys
//
// Replaces: clearcam_tpu/ops/vit_attention.py `mha_flash` (the stock Pallas
// TPU flash kernel). The TPU wrapper pads T to a multiple of 128 and masks
// the pad with segment ids; the result is unpadded attention, and that is
// what this kernel computes, with the tail masked in the kernel and
// nothing padded in memory. T is 257 for CLIP ViT-L/14 (256 patches + cls)
// and up to 2040 for the Qwen3-VL vision tower (a 544x960 frame).
//
//   q, k, v  [B,H,T,64] views, f32 or bf16, any strides with the last one 1
//            and the others multiples of 16 bytes (so a head of the fused
//            qkv projection is read in place); 16-byte aligned base pointers
//   out      [B,H,T,64] view in the same type (the wrapper hands a
//            [B,T,H,64] buffer, so merging the heads afterwards is free)
//
// What bounds it: per (b, h) it does 4*T^2*64 FLOP on 4*T*64 elements
// moved; at T = 257 in bf16 that is ~500 FLOP per byte, above the ~295 at
// which the tensor cores, not HBM, become the limit, and at T = 2040 far
// above. f32 inputs cost ten bf16 products for one (below). On the H100
// this design does not reach the tensor pipe's rate: timed copies with
// half the f32 MMAs removed gained less than copies without the split, so
// the latency of each warp's dependent chains (ldmatrix -> MMA -> softmax
// -> MMA, two warps a scheduler at 229 registers) bounds it. wgmma with
// its B operand read from shared memory by a warpgroup, and
// warp-specialised loading, are the next step.
//
// Arithmetic. FlashAttention-2 in shape: `mma.sync.m16n8k16` bf16 with f32
// accumulators, one warp per 16 query rows, its Q fragments in registers
// for the whole walk over the keys, 64-key tiles.
//  - S = Q K^T (raw, unscaled) for a tile goes into fresh accumulator
//    fragments; the online softmax runs on them: the row max by quad
//    shuffles, p = exp2(s * c - m * c) with c = scale * log2(e) in one FFMA,
//    the running max m and the row sums l kept per thread (l summed over
//    the quad at the end).
//  - The probabilities become the A fragments of the PV product straight
//    from the S registers (no trip through shared memory). K fragments
//    come from ldmatrix, V fragments from ldmatrix.trans.
//  - bf16 inputs: one product each; p is rounded to bf16 before PV, as the
//    plain version rounds the probabilities to v's type; o is scaled by
//    the max's correction and PV summed into it.
//  - f32 inputs: each operand is split into bf16 terms. q, k and v take
//    three, cut toward zero (x0 = the top 16 bits of x, x1 those of x - x0,
//    x2 = x - x0 - x1: exact, and no conversion instructions), and S six
//    products (the pairs (i, j) with i + j <= 2); p, in [0, 1], takes two
//    terms rounded to nearest (p0 = bf16(p), p1 = bf16(p - p0)) and PV
//    four products (p0 v0, p0 v1, p1 v0, p0 v2). Two terms everywhere (three
//    products a side) was modelled first and misses the 2e-5 wanted (a
//    fifth of the f32 bound) at T = 7, where few keys carry a row and q's
//    and k's 2^-18 show directly; at T = 1 the output is v itself, so v's
//    own two-term error (2^-18 of |v|) shows: tests/test_torch_port_
//    attention.py models this arithmetic and holds both. Every chain of
//    MMAs adds its smallest products first.
//  - The tensor cores add into f32 with truncation. On the f32 route no
//    chain is long: an S fragment takes 4 k-steps x 6 products; each
//    tile's PV goes into a fresh fragment (at most 4 steps x 4 products),
//    then o = o * alpha + fresh, one rounded FFMA.
//  - Ragged tails: the last key tile runs in 16-key steps, so T = 257 pays
//    one 16-key step for its last key, not a 64-key tile; keys past T are
//    -inf before the max. Warps whose 16 rows lie past T skip the MMAs
//    (they still help load and split).
//
// K/V tiles come through a ring of STAGES slots in dynamic shared memory,
// filled with cp.async.cg 16-byte copies (zero-fill past T), so tile j+1
// loads while tile j multiplies. bf16 tiles are read from the ring as they
// are: rows of 128 bytes, 16-byte chunks XOR-swizzled by the row (chunk ^
// (row & 7)), so ldmatrix's eight row addresses fall in eight different
// bank groups. f32 tiles land in the ring as they are (256-byte rows); the
// block splits each once into six bf16 planes (K and V, three terms each,
// swizzled the same way) that all its warps read. There are two sets of
// planes: tile j + 1 is split into one while tile j is multiplied from the
// other, one barrier a tile, and half the warps split before their MMAs,
// half after, so the split's ALU work and the MMAs of two warps on one
// scheduler overlap: 160 KB of shared memory a block with 2 slots.
//
// Grid: (query blocks, B*H), 32 * warps threads a block; the wrapper's
// `plan` (ops/vit_attention.py) picks the warps (16 query rows each, 4 to
// 9) and the ring's slots from the shapes alone, so a call can be captured
// in a CUDA graph. Blocks of one head are neighbours in the grid and share
// its K/V in L2.
//
// The kernel allocates nothing; the caller passes the output buffer and
// the stream. `vit_attention_prepare` raises the dynamic shared-memory
// limit once per device; `vit_attention_forward` returns cudaGetLastError()
// after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bf16_mma.cuh"

namespace {

constexpr int D = 64;            // head dim (CLIP ViT-L/14: 1024 / 16)
constexpr int BK = 64;           // keys per tile
constexpr int PLANE = BK * D;    // bf16 elements of one plane (8 KB)
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

constexpr int NS = 6;             // f32: products of S (q term, k term)
constexpr int NPV = 4;            // f32: products of PV (p term, v term)

template <typename T> struct Route;
template <> struct Route<float> {
    static constexpr int TERMS = 3;          // q, k, v
    static constexpr int PTERMS = 2;         // p
    static constexpr int SPROD = NS, PVPROD = NPV;
    static constexpr int WARPS = 9;          // at most, a block: 2 blocks cover
                                             // T = 257's 17 row warps
    static constexpr int MIN_BLOCKS = 1;     // blocks an SM holds
    static constexpr int STAGES = 2;         // ring slots (3 timed no faster)
};
template <> struct Route<__nv_bfloat16> {
    static constexpr int TERMS = 1, PTERMS = 1, SPROD = 1, PVPROD = 1;
    static constexpr int WARPS = 8;
    static constexpr int MIN_BLOCKS = 2;     // at most 128 registers a thread
    static constexpr int STAGES = 3;         // ring slots (2 timed slower)
};

// product p's (left term, right term), smallest first, as compile-time
// constants (the loops over them unroll)
template <typename T> __device__ __forceinline__ constexpr int s_term(int p, int side) {
    constexpr int tab[NS][2] = {{2, 0}, {1, 1}, {0, 2}, {1, 0}, {0, 1}, {0, 0}};
    return Route<T>::SPROD == 1 ? 0 : tab[p][side];
}
template <typename T> __device__ __forceinline__ constexpr int pv_term(int p, int side) {
    constexpr int tab[NPV][2] = {{0, 2}, {1, 0}, {0, 1}, {0, 0}};
    return Route<T>::PVPROD == 1 ? 0 : tab[p][side];
}

template <typename T> struct Smem {
    static constexpr int slot = 2 * BK * D * (int)sizeof(T);     // K then V
    // f32: two sets of the six bf16 planes (K0 K1 K2 V0 V1 V2), one being
    // read while the next tile is split into the other
    static constexpr int planes = Route<T>::TERMS == 1 ? 0 : 2 * 3 * PLANE * 2;
    static constexpr int bytes = Route<T>::STAGES * slot + 2 * planes;
};

// byte offset of 16-byte chunk `c` (0..7) of row `r` in a swizzled bf16 tile
__device__ __forceinline__ int swz(int r, int c) { return r * 128 + ((c ^ (r & 7)) << 4); }

template <typename T> struct Io;
template <> struct Io<float> {
    // two consecutive elements -> N bf16 terms of the pair
    template <int N> static __device__ __forceinline__ void frag(const float* p, bool on,
                                                               uint32_t (&out)[N]) {
        float2 x = make_float2(0.f, 0.f);
        if (on) x = *reinterpret_cast<const float2*>(p);
        cut2<N>(x.x, x.y, out);
    }
    static __device__ __forceinline__ void store2(float* p, float x, float y) {
        *reinterpret_cast<float2*>(p) = make_float2(x, y);
    }
};
template <> struct Io<__nv_bfloat16> {
    template <int N> static __device__ __forceinline__ void frag(const __nv_bfloat16* p,
                                                               bool on, uint32_t (&out)[N]) {
        out[0] = on ? *reinterpret_cast<const uint32_t*>(p) : 0u;
    }
    static __device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
        *reinterpret_cast<uint32_t*>(p) = pack_bf16(x, y);
    }
};

__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

// One key tile for one warp's 16 query rows: S from the K planes, the
// online softmax, PV from the V planes into o. FULLT: all 64 keys lie
// inside T (no mask, no step guards, so the compiler sees every chain);
// else `nsteps` 16-key steps with the keys past T masked. The f32 route
// sums the tile's PV in a fresh fragment; the bf16 route scales o and
// accumulates into it (FlashAttention-2's order), a truncating chain of
// T/16 steps that the bf16 output's rounding dwarfs.
template <typename T, bool FULLT>
__device__ __forceinline__ void attend_tile(
        const uint32_t (&qf)[Route<T>::TERMS][4][4],
        const unsigned char* (&kpl)[Route<T>::TERMS],
        const unsigned char* (&vpl)[Route<T>::TERMS], int nsteps, int k0, int Tn,
        float c, int lane, float (&o)[8][4], float (&m)[2], float (&l)[2]) {
    using R = Route<T>;
    constexpr int NT = R::TERMS, NP = R::PTERMS;
    constexpr bool FRESH = NT > 1;
    const int t4 = lane & 3, mi = lane >> 3, mr = lane & 7;
    auto live = [&](int sp) { return FULLT || sp < nsteps; };

    // S = Q K^T: k-steps outer, so all eight n-tile chains advance together
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[n][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int sp = 0; sp < 4; ++sp) {
            if (!live(sp)) continue;
            // matrices: keys 16sp + 0..7 | + 8..15 (mi >> 1), dims 16kk + 0..7 | 8..15
            const int key = 16 * sp + (mi >> 1) * 8 + mr;
            uint32_t kf[NT][4];
#pragma unroll
            for (int t = 0; t < NT; ++t) ldsm4(kf[t], kpl[t] + swz(key, 2 * kk + (mi & 1)));
#pragma unroll
            for (int p = 0; p < R::SPROD; ++p) {
                const int qi = s_term<T>(p, 0), kj = s_term<T>(p, 1);
#pragma unroll
                for (int hf = 0; hf < 2; ++hf)
                    mma(s[2 * sp + hf], qf[qi][kk], kf[kj][2 * hf], kf[kj][2 * hf + 1]);
            }
        }
    }

    // online softmax on the fragments: c0, c1 row g; c2, c3 row g + 8
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < 8; ++n) {
        if (!live(n >> 1)) continue;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            if (!FULLT && k0 + 8 * n + 2 * t4 + (i & 1) >= Tn) s[n][i] = -INFINITY;
            mx[i >> 1] = fmaxf(mx[i >> 1], s[n][i]);
        }
    }
    float alpha[2], mc[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 2));
        const float mn = fmaxf(m[r], mx[r]);        // finite: every tile has a key
        mc[r] = mn * c;
        alpha[r] = ex2(fmaf(m[r], c, -mc[r]));      // 0 on the first tile
        m[r] = mn;
        l[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
        if (!live(n >> 1)) continue;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            s[n][i] = ex2(fmaf(s[n][i], c, -mc[i >> 1]));
            l[i >> 1] += s[n][i];
        }
    }

    // PV: f32 into a fresh fragment, then o = o * alpha + fresh; bf16 into o
    auto pv = [&](float (&acc)[8][4]) {
#pragma unroll
        for (int sp = 0; sp < 4; ++sp) {
            if (!live(sp)) continue;
            // A fragments: a0 (row g, keys 2t4..), a1 (row g + 8), a2 (row g,
            // keys + 8), a3 (row g + 8, keys + 8)
            uint32_t pa[NP][4];
#pragma unroll
            for (int a = 0; a < 4; ++a) {
                uint32_t terms[NP];
                split2<NP>(s[2 * sp + (a >> 1)][(a & 1) * 2],
                           s[2 * sp + (a >> 1)][(a & 1) * 2 + 1], terms);
#pragma unroll
                for (int t = 0; t < NP; ++t) pa[t][a] = terms[t];
            }
            // matrices: keys 16sp + 0..7 | + 8..15 (mi & 1), dims 16dp + 0..7 | 8..15
            const int key = 16 * sp + (mi & 1) * 8 + mr;
#pragma unroll
            for (int dp = 0; dp < 4; ++dp) {
                uint32_t vf[NT][4];
#pragma unroll
                for (int t = 0; t < NT; ++t) ldsm4t(vf[t], vpl[t] + swz(key, 2 * dp + (mi >> 1)));
#pragma unroll
                for (int p = 0; p < R::PVPROD; ++p) {
                    const int pi = pv_term<T>(p, 0), vj = pv_term<T>(p, 1);
#pragma unroll
                    for (int hf = 0; hf < 2; ++hf)
                        mma(acc[2 * dp + hf], pa[pi], vf[vj][2 * hf], vf[vj][2 * hf + 1]);
                }
            }
        }
    };
    if constexpr (FRESH) {
        float f[8][4];
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
            for (int i = 0; i < 4; ++i) f[n][i] = 0.f;
        pv(f);
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
            for (int i = 0; i < 4; ++i) o[n][i] = fmaf(o[n][i], alpha[i >> 1], f[n][i]);
    } else {
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
            for (int i = 0; i < 4; ++i) o[n][i] *= alpha[i >> 1];
        pv(o);
    }
}

// MAXW: the most warps a launch of this instance takes. A scheduler's
// registers are its own, so 9 warps (3 on one scheduler) hold at most 168
// registers a thread where 8 hold 255: the f32 route has an instance of each
template <typename T, int MAXW>
__global__ void __launch_bounds__(32 * MAXW, Route<T>::MIN_BLOCKS)
mha_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
        T* __restrict__ out, int H, int Tn,
        long long qsb, long long qsh, long long qst,
        long long ksb, long long ksh, long long kst,
        long long vsb, long long vsh, long long vst,
        long long osb, long long osh, long long ost, float c) {
    using R = Route<T>;
    using L = Smem<T>;
    constexpr int NT = R::TERMS, NP = R::PTERMS, STAGES = R::STAGES;
    constexpr int CH = D * (int)sizeof(T) / 16;       // 16-byte chunks per row
    extern __shared__ __align__(128) unsigned char smem[];

    const int nthreads = blockDim.x;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const int b = blockIdx.y / H, h = blockIdx.y % H;
    const int row0 = (blockIdx.x * (nthreads >> 5) + warp) * 16;
    const bool active = row0 < Tn;
    const T* kp = k + b * ksb + h * ksh;
    const T* vp = v + b * vsb + h * vsh;
    const int ntiles = (Tn + BK - 1) / BK;

    // tile j of K and V -> ring slot j % STAGES (one commit group, empty
    // past the last tile, so the wait counts stay uniform)
    auto load_tile = [&](int j) {
        if (j < ntiles) {
            unsigned char* slot = smem + (j % STAGES) * L::slot;
            const int k0 = j * BK;
            for (int i = threadIdx.x; i < 2 * BK * CH; i += nthreads) {
                const int which = i / (BK * CH), r = (i / CH) % BK, ch = i % CH;
                const bool on = k0 + r < Tn;
                const T* src = which ? vp + (on ? k0 + r : 0) * vst : kp + (on ? k0 + r : 0) * kst;
                unsigned char* dst = slot + which * (L::slot / 2) +
                                     (NT == 1 ? swz(r, ch) : r * 256 + ch * 16);
                cp16(dst, src + ch * (16 / (int)sizeof(T)), on);
            }
        }
        cp_commit();
    };
    // Q fragments, all terms, for the whole walk: a0 (row g, dims 16kk +
    // 2t4, +1), a1 (row g + 8), a2 (row g, dims + 8), a3 (row g + 8, + 8)
    uint32_t qf[NT][4][4];
    {
        const T* qp = q + b * qsb + h * qsh;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int a = 0; a < 4; ++a) {
                const int row = row0 + g + (a & 1) * 8, col = kk * 16 + (a >> 1) * 8 + 2 * t4;
                uint32_t terms[NT];
                Io<T>::template frag<NT>(qp + (long long)row * qst + col, row < Tn, terms);
#pragma unroll
                for (int i = 0; i < NT; ++i) qf[i][kk][a] = terms[i];
            }
    }

    float o[8][4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) o[n][i] = 0.f;

    auto attend = [&](int j, const unsigned char* (&kpl)[NT], const unsigned char* (&vpl)[NT]) {
        if (!active) return;
        const int k0 = j * BK, nk = min(BK, Tn - k0);
        if (nk == BK)
            attend_tile<T, true>(qf, kpl, vpl, 4, k0, Tn, c, lane, o, m, l);
        else
            attend_tile<T, false>(qf, kpl, vpl, (nk + 15) >> 4, k0, Tn, c, lane, o, m, l);
    };

    if constexpr (NT == 1) {
        // bf16: the warps read the ring slot as it landed
#pragma unroll
        for (int j = 0; j < STAGES - 1; ++j) load_tile(j);
        for (int j = 0; j < ntiles; ++j) {
            cp_wait<STAGES - 2>();
            __syncthreads();             // tile j landed; slot j - 1 is free
            load_tile(j + STAGES - 1);
            const unsigned char* slot = smem + (j % STAGES) * L::slot;
            const unsigned char* kpl[1] = {slot};
            const unsigned char* vpl[1] = {slot + L::slot / 2};
            attend(j, kpl, vpl);
        }
    } else {
        // f32: tile j + 1 is split into one set of planes while tile j is
        // multiplied from the other; one barrier a tile. Warps 4..7 split
        // after their MMAs, warps 0..3 before, so two warps sharing a
        // scheduler (w and w + 4) keep its tensor pipe and its ALUs busy
        unsigned char* planes = smem + STAGES * L::slot;
        auto split_tile = [&](int j) {
            if (j >= ntiles) return;
            const unsigned char* slot = smem + (j % STAGES) * L::slot;
            unsigned char* dst = planes + (j & 1) * L::planes;
            const int rows = 16 * ((min(BK, Tn - j * BK) + 15) >> 4);
            for (int i = threadIdx.x; i < 2 * rows * 16; i += nthreads) {
                const int which = i / (rows * 16), r = (i >> 4) % rows, c4 = i & 15;
                const float4 x = *reinterpret_cast<const float4*>(
                    slot + which * (L::slot / 2) + r * 256 + c4 * 16);
                uint32_t lo[NT], hi[NT];
                cut2<NT>(x.x, x.y, lo);
                cut2<NT>(x.z, x.w, hi);
                const int off = swz(r, c4 >> 1) + (c4 & 1) * 8;
#pragma unroll
                for (int t = 0; t < NT; ++t)
                    *reinterpret_cast<uint2*>(dst + (which * NT + t) * PLANE * 2 + off) =
                        make_uint2(lo[t], hi[t]);
            }
        };
#pragma unroll
        for (int j = 0; j < STAGES; ++j) load_tile(j);
        cp_wait<STAGES - 1>();
        __syncthreads();                 // tile 0 landed
        split_tile(0);
        const bool split_first = warp < 4;
        for (int j = 0; j < ntiles; ++j) {
            cp_wait<STAGES - 2>();
            // tile j + 1 landed; tile j's planes are written; tile j's slot
            // and tile j - 1's planes are free
            __syncthreads();
            load_tile(j + STAGES);
            const unsigned char* set = planes + (j & 1) * L::planes;
            const unsigned char* kpl[NT];
            const unsigned char* vpl[NT];
#pragma unroll
            for (int t = 0; t < NT; ++t) {
                kpl[t] = set + t * PLANE * 2;
                vpl[t] = set + (NT + t) * PLANE * 2;
            }
            if (split_first) split_tile(j + 1);
            attend(j, kpl, vpl);
            if (!split_first) split_tile(j + 1);
        }
    }
    cp_wait<0>();
    if (!active) return;

#pragma unroll
    for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(FULL, l[r], 1);
        l[r] += __shfl_xor_sync(FULL, l[r], 2);
        const float inv = 1.f / l[r];
        const int row = row0 + g + 8 * r;
        if (row < Tn) {
            T* op = out + b * osb + h * osh + (long long)row * ost + 2 * t4;
#pragma unroll
            for (int n = 0; n < 8; ++n)
                Io<T>::store2(op + 8 * n, o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
        }
    }
}

template <typename T, int MAXW>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int B, int H,
                   int Tn, const long long* st, float scale, int warps, cudaStream_t stream) {
    const int qblocks = ((Tn + 15) / 16 + warps - 1) / warps;
    const dim3 grid(qblocks, B * H);
    mha_fwd<T, MAXW><<<grid, 32 * warps, Smem<T>::bytes, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(out), H, Tn, st[0], st[1], st[2], st[3], st[4], st[5],
        st[6], st[7], st[8], st[9], st[10], st[11], scale * LOG2E);
    return cudaGetLastError();
}

// the instance for the plan: bf16 the one of up to 8 warps; f32 the 8-warp
// one up to 8 and the 9-warp one at 9. The plan's ring slots must be the
// route's.
template <typename T>
cudaError_t launch_plan(const void* q, const void* k, const void* v, void* out, int B, int H,
                        int Tn, const long long* st, float scale, int warps, int stages,
                        cudaStream_t stream) {
    if (warps < 1 || warps > Route<T>::WARPS || stages != Route<T>::STAGES)
        return cudaErrorInvalidValue;
    if (warps > 8)
        return launch<T, Route<T>::WARPS>(q, k, v, out, B, H, Tn, st, scale, warps, stream);
    return launch<T, 8>(q, k, v, out, B, H, Tn, st, scale, warps, stream);
}

template <typename T, int MAXW>
cudaError_t prepare_one() {
    return cudaFuncSetAttribute(mha_fwd<T, MAXW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                Smem<T>::bytes);
}

}  // namespace

// Once per device, before its first vit_attention_forward: the kernels use
// more than 48 KB of dynamic shared memory. Returns a cudaError_t.
extern "C" int vit_attention_prepare() {
    cudaError_t e;
    if ((e = prepare_one<float, 8>()) != cudaSuccess) return (int)e;
    if ((e = prepare_one<float, Route<float>::WARPS>()) != cudaSuccess) return (int)e;
    return (int)prepare_one<__nv_bfloat16, 8>();
}

// q, k, v, out: [B,H,T,64] views; strides: 12 element strides, (b, h, t)
// for q, k, v, out in that order. dtype 0 = f32, 1 = bf16; warps (16 query
// rows each: f32 1..9, bf16 1..8) and stages (ring slots: f32 2, bf16 3)
// from the wrapper's plan. Returns a cudaError_t.
extern "C" int vit_attention_forward(const void* q, const void* k, const void* v,
                                     void* out, int B, int H, int T,
                                     const long long* strides, float scale,
                                     int dtype, int warps, int stages, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (T <= 0 || B <= 0 || H <= 0) return (int)cudaSuccess;
    if (dtype == 1)
        return (int)launch_plan<__nv_bfloat16>(q, k, v, out, B, H, T, strides, scale, warps,
                                               stages, s);
    if (dtype == 0)
        return (int)launch_plan<float>(q, k, v, out, B, H, T, strides, scale, warps, stages, s);
    return (int)cudaErrorInvalidValue;
}
