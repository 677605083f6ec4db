// Weight-only quantized matrix product for Hopper (sm_90a), int8 (W8A16)
// and packed int4 (W4A16), on the tensor cores:
//
//   out[n, o] = sum_k x[n, k] * W[o, k] (+ bias[o]),  W = dequant(q, s)
//
// Replaces: clearcam_tpu/ops/quant_matmul.py `_quant_matmul`, both of its
// Pallas TPU kernels: `_kernel` (int8, one scale per output feature,
// applied once after the K sum) and `_kernel4` (two nibbles per byte,
// one scale per (group of 128 inputs, output), applied to each group's
// partial sum). The layouts are the ones `quantize_int8` / `quantize_int4`
// store, byte for byte the JAX package's, read as they are (no repacked
// copy of the weights):
//
//   int8  q [O_pad, I_pad] int8, s [1, O_pad] f32
//   int4  q [O_pad, I_pad/2] int8: in every 1024-wide K tile, byte j holds
//         element j in its low nibble and element j + 512 in its high
//         nibble (both two's complement); s [I_pad/128, O_pad] f32,
//         group-major
//   x     [N, in_features] f32 or bf16, row-major; N is any row count and
//         nothing is padded in memory: columns past in_features and rows
//         past N load as zero
//   out   [N, out_features] in x's type; bias [out_features] f32 or null
//
// What bounds it: at decode (N <= 16 rows) every weight byte is used for N
// multiply-adds, far below the ~295 operations per byte the card needs to
// leave the memory bound, so the weight bytes read from HBM bound it
// (int8: 1 byte, int4: 0.5 byte a weight). From a few hundred rows on
// (prefill) the tensor cores do: f32 x costs three bf16 products (below).
//
// Arithmetic, exact up to the f32 sums. `mma.sync.m16n8k16` bf16 with f32
// accumulation, "swapped": the weights are the 16-row side (16 output
// features an MMA) and the rows of x the 8-wide side, so decode's 1-16 rows
// fill one or two n-tiles. Every int8 and int4 value is exact in bf16; they
// are widened without I2F: an int8 byte goes into the low mantissa byte of
// 2^23 (x ^ 0x80 = x + 128, one subtraction gives x exactly, whose f32 bits
// truncate exactly to bf16), an int4 nibble into the mantissa of the bf16
// 128 (n ^ 8 = n + 8, one bf16x2 subtraction of 136). f32 x is split into
// three bf16 terms x = x1 + x2 + x3 (x1 = bf16(x), x2 = bf16(x - x1), x3 =
// bf16(x - x1 - x2)), one MMA each into the same f32 accumulator; each
// product of a term with an integer weight is exact. bf16 x is one term:
// the JAX kernel's `w.astype(x.dtype)` product with f32 accumulation. The
// int8 scale multiplies the K sum once, in the epilogue; int4 scales
// multiply f32 partial sums of a group (below). No scale is folded into a
// bf16 weight.
//
// Sums. The tensor cores add an MMA's products to its f32 accumulator with
// truncation, not rounding: a K = 6144 sum carried through one accumulator
// (1,152 MMAs with three terms) drifted 1.7e-5 of max|out| toward zero on
// the H100. So each warp's MMAs for at most 64 inputs (decode: its chunk
// of a stage; prefill: a stage; int4: a group's share of either) go into a
// fresh fragment, smallest term first, which is then added to the running
// f32 sum with an ordinary rounded add (int4: acc += s * part).
//
// K order. The MMA's reduction index is free to permute as long as both
// operands agree: lane t of a quad takes 16 consecutive weight bytes of a
// row (int4: 8 bytes = 16 low + 16 high nibbles), so the A fragment comes
// from one 16-byte (8-byte) shared-memory load, and the x fragment from the
// same K positions: in k-step j, lane t's pairs (k0, k2) and (k1, k3) of
// the four inputs 16t + 4j + 0..3 (int4: 8t + 4j, in the low and the high
// half) stand for MMA columns (2t, 2t+1) and (2t+8, 2t+9).
//
// Grid: (output tiles, row tiles, K splits). The wrapper's `plan`
// (ops/quant_matmul.py) sizes the splits from the shapes alone, so a call
// can be captured in a CUDA graph: split boundaries fall on
// multiples of 256 inputs (an int4 128-byte slice is one low and one high
// group, so no group is cut). Two kernels:
//  - `quant_mm_decode` (N <= 16): 64 outputs x 8 or 16 rows, a stage is
//    256 inputs and each of the 4 warps takes 64 of them (all 64 outputs),
//    so a warp splits only its own x; the warps' sums are added in shared
//    memory at the end.
//  - `quant_mm_prefill` (N > 16): 256 outputs x 32 (N <= 32) or 64 rows,
//    8 warps, a stage is 64 inputs; each warp owns 32 outputs over all the
//    rows, so each weight is widened once a block and read from memory
//    once per 64 rows,
//    and x, read once per 256 outputs, is split into its terms once a stage
//    into shared memory for all eight warps.
// Stages (weight bytes, int4 scales, x rows) come through a ring in
// dynamic shared memory (decode 3 slots, prefill 4) filled with
// `cp.async.cg` 16-byte copies (zero-fill past N and K); neighbouring
// lanes copy neighbouring 16 bytes of a row. Tiles are laid out (decode:
// XOR-swizzled in units of 16 bytes) so that the fragment loads are free
// of bank conflicts. With one split a block finishes its outputs itself.
// With more, each block
// writes its f32 sums to the wrapper's scratch; the last block to arrive
// at an output tile (a counter in global memory, which it resets to 0, so
// a graph replay needs no memset) adds the splits in split order, then
// applies the scale, the bias and the cast: one launch a call, and the
// result is bitwise the same from call to call.
//
// The kernel allocates nothing; `quant_matmul_prepare` raises the dynamic
// shared-memory limit once per device; `quant_matmul_forward` returns
// cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TI = 1024;        // the JAX layout's K tile (int4 nibble halves)
constexpr int GROUP = 128;      // int4 scale group along K
constexpr int UNIT = 256;       // split granularity, in inputs
constexpr int WARPS = 4;
constexpr int NTHREADS = 32 * WARPS;

__device__ __forceinline__ void cp16(void* dst, const void* src, bool on) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(s), "l"(src), "r"(on ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void mma(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                    uint32_t a3, uint32_t b0, uint32_t b1) {
    // not volatile: the compiler may interleave independent MMAs
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
                 "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                 : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
                 : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
}

// four int8 weights (one 32-bit word) -> bf16 pairs (k0, k2) and (k1, k3)
__device__ __forceinline__ void widen8(uint32_t u, uint32_t& p02, uint32_t& p13) {
    u ^= 0x80808080u;                                  // x + 128 as a byte
    const float bias = 8388736.f;                      // 2^23 + 128
    const float f0 = __uint_as_float(__byte_perm(u, 0x4b000000u, 0x7540)) - bias;
    const float f1 = __uint_as_float(__byte_perm(u, 0x4b000000u, 0x7541)) - bias;
    const float f2 = __uint_as_float(__byte_perm(u, 0x4b000000u, 0x7542)) - bias;
    const float f3 = __uint_as_float(__byte_perm(u, 0x4b000000u, 0x7543)) - bias;
    // |x| <= 128 has at most 8 significant bits: the top 16 bits are its bf16
    p02 = __byte_perm(__float_as_uint(f0), __float_as_uint(f2), 0x7632);
    p13 = __byte_perm(__float_as_uint(f1), __float_as_uint(f3), 0x7632);
}

// the low (HI = 0) or high (HI = 1) nibbles of four packed bytes -> bf16
// pairs (byte 0, byte 2) and (byte 1, byte 3)
template <int HI>
__device__ __forceinline__ void widen4(uint32_t u, uint32_t& p02, uint32_t& p13) {
    u ^= 0x88888888u;                                  // n + 8 in every nibble
    const uint32_t a = ((u >> (4 * HI)) & 0x000f000fu) | 0x43004300u;       // 128 + n + 8
    const uint32_t b = ((u >> (4 * HI + 8)) & 0x000f000fu) | 0x43004300u;
    const uint32_t k136u = 0x43084308u;                  // bf16 136, twice
    const __nv_bfloat162 k136 = *reinterpret_cast<const __nv_bfloat162*>(&k136u);
    const __nv_bfloat162 ra = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&a), k136);
    const __nv_bfloat162 rb = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&b), k136);
    p02 = *reinterpret_cast<const uint32_t*>(&ra);
    p13 = *reinterpret_cast<const uint32_t*>(&rb);
}

// x: the words of one quad (4 consecutive inputs) -> B fragments (k0, k2),
// (k1, k3) for each bf16 term
template <typename T> struct XFrag;
template <> struct XFrag<float> {
    static constexpr int TERMS = 3, WORDS = 4;         // words a quad
    static __device__ __forceinline__ void build(const uint32_t* w, uint32_t (&b)[3][2]) {
        float e[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) e[i] = __uint_as_float(w[i]);
#pragma unroll
        for (int h = 0; h < 2; ++h) {                  // pairs (e0, e2), (e1, e3)
            float lo = e[h], hi = e[h + 2];
#pragma unroll
            for (int term = 0; term < TERMS; ++term) {
                const uint32_t v = pack_bf16(lo, hi);
                b[term][h] = v;
                lo -= __uint_as_float(v << 16);         // exact: x minus its bf16
                hi -= __uint_as_float(v & 0xffff0000u);
            }
        }
    }
};
template <> struct XFrag<__nv_bfloat16> {
    static constexpr int TERMS = 1, WORDS = 2;
    static __device__ __forceinline__ void build(const uint32_t* w, uint32_t (&b)[1][2]) {
        b[0][0] = __byte_perm(w[0], w[1], 0x5410);
        b[0][1] = __byte_perm(w[0], w[1], 0x7632);
    }
};

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// the first input of stage st of SK inputs: int8 stage st covers inputs
// [st SK, +SK); int4 stage st covers packed bytes [st SK/2, +SK/2), i.e.
// inputs lo.. (low nibbles) and lo + 512.. (high nibbles), SK/2 of each
template <bool INT4, int SK>
__device__ __forceinline__ int lo_input(int st) {
    if constexpr (!INT4) return st * SK;
    const int pb = st * (SK / 2);
    return (pb / (TI / 2)) * TI + pb % (TI / 2);
}

// Copies stage st into a ring slot: BOT weight rows of SK (int4: SK/2)
// bytes from output o0, with int4 the stage's low- and high-group scales
// [2][BOT], and BNT rows of x from row n0, SK inputs (int4: the SK/2 low
// inputs, then the SK/2 high ones) zero-filled past N and K. Units of 16
// bytes go to the slots WSWZ(unit, row) and XSWZ(unit, row) of their row;
// vec = 0 (x rows not 16-byte aligned) copies x element by element.
template <typename T, bool INT4, int SK, int BOT, int BNT, int THREADS, class WSwz, class XSwz>
__device__ __forceinline__ void load_stage(
        unsigned char* base, int st, const T* __restrict__ x, const int8_t* __restrict__ q,
        const float* __restrict__ s, int o0, int n0, int N, int K, int Op, size_t qrow,
        int vec, WSwz wswz, XSwz xswz) {
    constexpr int WROW = INT4 ? SK / 2 : SK, WU = WROW / 16;
    constexpr int XROW = SK * (int)sizeof(T), XU = XROW / 16, EPU = 16 / (int)sizeof(T);
    constexpr int SBYTES = INT4 ? 2 * BOT * 4 : 0;
    const int8_t* qs = q + (size_t)o0 * qrow + (size_t)st * WROW;
    for (int i = threadIdx.x; i < BOT * WU; i += THREADS) {
        const int r = i / WU, c = i % WU;
        cp16(base + r * WROW + 16 * wswz(c, r), qs + r * qrow + 16 * c, true);
    }
    const int k0 = lo_input<INT4, SK>(st);
    if constexpr (INT4) {
        float* sc = reinterpret_cast<float*>(base + BOT * WROW);
        for (int i = threadIdx.x; i < 2 * BOT / 4; i += THREADS) {
            const int h = i / (BOT / 4), c = i % (BOT / 4);
            const int grp = (k0 + h * (TI / 2)) / GROUP;
            cp16(sc + h * BOT + 4 * c, s + (size_t)grp * Op + o0 + 4 * c, true);
        }
    }
    unsigned char* xs = base + BOT * WROW + SBYTES;
    for (int i = threadIdx.x; i < BNT * XU; i += THREADS) {
        const int r = i / XU, u = i % XU;
        const int e = u * EPU;                                 // element within the row
        const int k = INT4 ? k0 + (e < SK / 2 ? e : e - SK / 2 + TI / 2) : k0 + e;
        const int n = n0 + r;
        unsigned char* dst = xs + r * XROW + 16 * xswz(u, r);
        if (vec) {
            const bool on = n < N && k < K;
            cp16(dst, on ? x + (size_t)n * K + k : x, on);
        } else {
            T* d = reinterpret_cast<T*>(dst);
#pragma unroll
            for (int j = 0; j < EPU; ++j) {
                if (n < N && k + j < K) d[j] = x[(size_t)n * K + k + j];
                else store(d + j, 0.f);
            }
        }
    }
}

// The block's sums sum(n, o) for its BNT x BOT outputs, four consecutive
// outputs a thread: with one split, scale (int8), bias and cast into out;
// with more, into the scratch, and the last block of the output tile to
// arrive adds the splits in split order (all of a batch's loads in flight
// before the adds).
template <typename T, bool INT4, int BOT, int BNT, int THREADS, class Sum>
__device__ __forceinline__ void finish_tile(
        Sum sum, const float* __restrict__ s, const float* __restrict__ bias,
        T* __restrict__ out, float* __restrict__ part, int* __restrict__ counters,
        int o0, int n0, int N, int O, int Op, int splits) {
    auto finish = [&](int n, int o, float4 v) {
        const float vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            if (o + e >= O) return;
            float w = vs[e];
            if constexpr (!INT4) w *= __ldg(s + o + e);
            if (bias != nullptr) w += __ldg(bias + o + e);
            store(out + (size_t)n * O + o + e, w);
        }
    };
    const int sp = blockIdx.z;
    for (int i = 4 * threadIdx.x; i < BNT * BOT; i += 4 * THREADS) {
        const int n = i / BOT, o = i % BOT;
        if (n0 + n >= N) break;
        const float4 v = make_float4(sum(n, o), sum(n, o + 1), sum(n, o + 2), sum(n, o + 3));
        if (splits == 1) finish(n0 + n, o0 + o, v);
        else *reinterpret_cast<float4*>(part + ((size_t)sp * N + n0 + n) * Op + o0 + o) = v;
    }
    if (splits == 1) return;
    __shared__ int last;
    __threadfence();
    __syncthreads();
    const int tile = blockIdx.y * gridDim.x + blockIdx.x;
    if (threadIdx.x == 0) last = atomicAdd(counters + tile, 1) == splits - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
    constexpr int BATCH = 8;
    const size_t stride = (size_t)N * Op;
    for (int i = 4 * threadIdx.x; i < BNT * BOT; i += 4 * THREADS) {
        const int n = n0 + i / BOT, o = o0 + i % BOT;
        if (n >= N) break;
        const float* p = part + (size_t)n * Op + o;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int j0 = 0; j0 < splits; j0 += BATCH) {
            float4 a[BATCH];
#pragma unroll
            for (int j = 0; j < BATCH; ++j)
                if (j0 + j < splits) a[j] = __ldcg(reinterpret_cast<const float4*>(p + (j0 + j) * stride));
#pragma unroll
            for (int j = 0; j < BATCH; ++j)
                if (j0 + j < splits) {
                    v.x += a[j].x;
                    v.y += a[j].y;
                    v.z += a[j].z;
                    v.w += a[j].w;
                }
        }
        finish(n, o, v);
    }
    if (threadIdx.x == 0) counters[tile] = 0;
}

// the stages [st0, st0 + nst) of split blockIdx.z
template <int SK>
__device__ __forceinline__ void split_stages(int Kp, int splits, int& st0, int& nst) {
    const int units = Kp / UNIT, sp = blockIdx.z;
    st0 = (int)((long long)sp * units / splits) * (UNIT / SK);
    nst = (int)((long long)(sp + 1) * units / splits) * (UNIT / SK) - st0;
}

// ---- decode: N <= 16 ------------------------------------------------------
// 64 outputs x 8 NT rows; a stage is 256 inputs, warp w takes its 64-input
// chunk w (all 64 outputs, all rows): each warp splits only its own x. The
// four warps' sums are added in shared memory at the end.
constexpr int DBO = 64, DSK = 256, DSTAGES = 3;

template <typename T, bool INT4, int NT>
struct DCfg {
    static constexpr int BN = 8 * NT;
    static constexpr int WROW = INT4 ? DSK / 2 : DSK;
    static constexpr int WBYTES = DBO * WROW;
    static constexpr int SBYTES = INT4 ? 2 * DBO * 4 : 0;
    static constexpr int XROW = DSK * (int)sizeof(T);
    static constexpr int STAGE = WBYTES + SBYTES + BN * XROW;
    static constexpr int RS = DBO + 4;                         // row stride of the sums
    static constexpr int RED = WARPS * BN * RS * 4;
    static constexpr int SMEM = STAGE * DSTAGES > RED ? STAGE * DSTAGES : RED;
};

// 16-byte unit c of weight row r -> its slot: the 8 lanes of an int8
// 16-byte load (rows r, r+1) or the 16 of an int4 8-byte load (rows
// r..r+3) land in distinct banks
template <bool INT4>
__device__ __forceinline__ int dwswz(int c, int r) {
    return INT4 ? c ^ ((r & 3) << 1) : c ^ ((r & 1) << 2);
}
// 16-byte unit u of x row n -> its slot (rows n, n+1 of a load's 8 lanes)
template <typename T, bool INT4>
__device__ __forceinline__ int dxswz(int u, int n) {
    if constexpr (sizeof(T) == 4 && !INT4) return u ^ ((u >> 3) & 1) ^ ((n & 1) << 1);
    if constexpr (sizeof(T) == 2 && INT4) return u ^ ((n & 1) << 2);
    return u ^ (n & 1);
}

template <typename T, bool INT4, int NT>
__global__ void __launch_bounds__(NTHREADS)
quant_mm_decode(const T* __restrict__ x, const int8_t* __restrict__ q,
                const float* __restrict__ s, const float* __restrict__ bias,
                T* __restrict__ out, float* __restrict__ part, int* __restrict__ counters,
                int N, int K, int Kp, int O, int Op, int splits, int vec) {
    using C = DCfg<T, INT4, NT>;
    using XF = XFrag<T>;
    constexpr int TERMS = XF::TERMS, MT = DBO / 16;
    extern __shared__ __align__(16) unsigned char smem[];

    const int wk = threadIdx.x >> 5, lane = threadIdx.x & 31;   // warp = its K chunk
    const int g = lane >> 2, t = lane & 3;
    const int o0 = blockIdx.x * DBO, n0 = blockIdx.y * C::BN;
    int st0, nst;
    split_stages<DSK>(Kp, splits, st0, nst);
    const size_t qrow = INT4 ? (size_t)Kp / 2 : (size_t)Kp;
    auto load = [&](int st, int slot) {
        load_stage<T, INT4, DSK, DBO, C::BN, NTHREADS>(
            smem + slot * C::STAGE, st, x, q, s, o0, n0, N, K, Op, qrow, vec,
            [](int c, int r) { return dwswz<INT4>(c, r); },
            [](int u, int r) { return dxswz<T, INT4>(u, r); });
    };

    float acc[MT][NT][4] = {};
#pragma unroll
    for (int i = 0; i < DSTAGES - 1; ++i) {
        if (i < nst) load(st0 + i, i);
        cp_commit();
    }
    for (int i = 0; i < nst; ++i) {
        cp_wait<DSTAGES - 2>();
        __syncthreads();                       // stage i landed; slot i - 1 is free
        if (i + DSTAGES - 1 < nst) load(st0 + i + DSTAGES - 1, (i + DSTAGES - 1) % DSTAGES);
        cp_commit();

        const unsigned char* base = smem + (i % DSTAGES) * C::STAGE;
        const float* sc = reinterpret_cast<const float*>(base + C::WBYTES);
        const unsigned char* xs = base + C::WBYTES + C::SBYTES;
        // A: rows 16m + g and 16m + g + 8, this lane's 16 (int4: 8) bytes
        constexpr int AW = INT4 ? 2 : 4;
        uint32_t wa[MT][2][AW];
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int r = 16 * m + g + 8 * h;
                const int c = INT4 ? 2 * wk + (t >> 1) : 4 * wk + t;
                const unsigned char* p = base + r * C::WROW + 16 * dwswz<INT4>(c, r);
                if constexpr (INT4) {
                    const uint2 v = *reinterpret_cast<const uint2*>(p + 8 * (t & 1));
                    wa[m][h][0] = v.x;
                    wa[m][h][1] = v.y;
                } else {
                    const uint4 v = *reinterpret_cast<const uint4*>(p);
                    wa[m][h][0] = v.x;
                    wa[m][h][1] = v.y;
                    wa[m][h][2] = v.z;
                    wa[m][h][3] = v.w;
                }
            }
        // x: this lane's 16 inputs of the chunk for each n-tile, in quad
        // order (int8: k-steps 0..3; int4: low 0, 1, high 0, 1)
        constexpr int XW = 4 * XF::WORDS;
        uint32_t xr[NT][XW];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
            const int r = nt * 8 + g;
#pragma unroll
            for (int v = 0; v < XW / 4; ++v) {
                int u;
                if constexpr (sizeof(T) == 4)
                    u = INT4 ? (v >> 1) * (DSK / 8) + 8 * wk + 2 * t + (v & 1)
                             : 16 * wk + 4 * t + v;
                else
                    u = INT4 ? v * (DSK / 16) + 4 * wk + t : 8 * wk + 2 * t + v;
                const uint4 w = *reinterpret_cast<const uint4*>(
                    xs + r * C::XROW + 16 * dxswz<T, INT4>(u, r));
                xr[nt][4 * v] = w.x;
                xr[nt][4 * v + 1] = w.y;
                xr[nt][4 * v + 2] = w.z;
                xr[nt][4 * v + 3] = w.w;
            }
        }
        // the chunk's MMAs (the terms smallest first, each term's 4 NT
        // independent of each other) into fresh fragments (see "Sums")
#pragma unroll
        for (int hi = 0; hi < (INT4 ? 2 : 1); ++hi) {
            float d[MT][NT][4] = {};
#pragma unroll
            for (int j = 0; j < (INT4 ? 2 : 4); ++j) {
                uint32_t b[NT][TERMS][2], a[MT][4];
#pragma unroll
                for (int nt = 0; nt < NT; ++nt)
                    XF::build(&xr[nt][(INT4 ? 2 * hi + j : j) * XF::WORDS], b[nt]);
#pragma unroll
                for (int m = 0; m < MT; ++m) {
                    if constexpr (INT4) {
                        if (hi) {
                            widen4<1>(wa[m][0][j], a[m][0], a[m][2]);
                            widen4<1>(wa[m][1][j], a[m][1], a[m][3]);
                        } else {
                            widen4<0>(wa[m][0][j], a[m][0], a[m][2]);
                            widen4<0>(wa[m][1][j], a[m][1], a[m][3]);
                        }
                    } else {
                        widen8(wa[m][0][j], a[m][0], a[m][2]);
                        widen8(wa[m][1][j], a[m][1], a[m][3]);
                    }
                }
#pragma unroll
                for (int term = TERMS - 1; term >= 0; --term)
#pragma unroll
                    for (int m = 0; m < MT; ++m)
#pragma unroll
                        for (int nt = 0; nt < NT; ++nt)
                            mma(d[m][nt], a[m][0], a[m][1], a[m][2], a[m][3], b[nt][term][0],
                                b[nt][term][1]);
            }
#pragma unroll
            for (int m = 0; m < MT; ++m) {
                float s_g = 1.f, s_g8 = 1.f;
                if constexpr (INT4) {
                    s_g = sc[hi * DBO + 16 * m + g];
                    s_g8 = sc[hi * DBO + 16 * m + g + 8];
                }
#pragma unroll
                for (int nt = 0; nt < NT; ++nt) {
                    acc[m][nt][0] = fmaf(s_g, d[m][nt][0], acc[m][nt][0]);
                    acc[m][nt][1] = fmaf(s_g, d[m][nt][1], acc[m][nt][1]);
                    acc[m][nt][2] = fmaf(s_g8, d[m][nt][2], acc[m][nt][2]);
                    acc[m][nt][3] = fmaf(s_g8, d[m][nt][3], acc[m][nt][3]);
                }
            }
        }
    }
    cp_wait<0>();
    __syncthreads();                           // the ring is free for the sums

    // the warps' sums -> red [WARPS][BN][RS]; C fragment: c0, c1 output
    // 16m + g, rows 2t, 2t + 1; c2, c3 output 16m + g + 8
    float* red = reinterpret_cast<float*>(smem);
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int c = 0; c < 4; ++c)
                red[(wk * C::BN + nt * 8 + 2 * t + (c & 1)) * C::RS + 16 * m + g + 8 * (c >> 1)] =
                    acc[m][nt][c];
    __syncthreads();
    finish_tile<T, INT4, DBO, C::BN, NTHREADS>(
        [&](int n, int o) {
            float v = red[n * C::RS + o];
#pragma unroll
            for (int w = 1; w < WARPS; ++w) v += red[(w * C::BN + n) * C::RS + o];
            return v;
        },
        s, bias, out, part, counters, o0, n0, N, O, Op, splits);
}

// ---- prefill: N > 16 ------------------------------------------------------
// 256 outputs x 8 PNT rows (PNT = 4 up to 32 rows, else 8), 8 warps; a
// stage is 64 inputs; warp w owns outputs 32w.. 32w + 31 (two m-tiles)
// over all the block's rows (PNT n-tiles), so no weight is widened twice
// in a block. x is split into its bf16 terms once
// per stage, by all threads, into one of two planes laid out as the B
// fragments are read (row n, lane quad t, k-step j -> 8 bytes (k0, k2 |
// k1, k3); rows 144 bytes apart, so a 16-byte fragment load of two k-steps
// hits distinct banks): stage i + 1 is split while stage i is multiplied,
// with one barrier a stage.
constexpr int PWARPS = 8, PTHREADS = 32 * PWARPS;
constexpr int PBO = 32 * PWARPS, PSK = 64, PSTAGES = 4, PMT = 2;
constexpr int PROW = 16 * 8 + 16;                              // plane bytes a row

template <typename T, bool INT4, int PNT>
struct PCfg {
    static constexpr int PBN = 8 * PNT;
    static constexpr int WROW = INT4 ? PSK / 2 : PSK;
    static constexpr int WBYTES = PBO * WROW;
    static constexpr int SBYTES = INT4 ? 2 * PBO * 4 : 0;
    static constexpr int XROW = PSK * (int)sizeof(T);
    static constexpr int STAGE = WBYTES + SBYTES + PBN * XROW;
    static constexpr int PLANE = XFrag<T>::TERMS * PBN * PROW;  // a stage's terms
    static constexpr int RS = PBO + 4;
    static constexpr int RED = PBN * RS * 4;
    static constexpr int MAIN = STAGE * PSTAGES + 2 * PLANE;
    static constexpr int SMEM = MAIN > RED ? MAIN : RED;
};

template <typename T, bool INT4, int PNT>
__global__ void __launch_bounds__(PTHREADS, 1)
quant_mm_prefill(const T* __restrict__ x, const int8_t* __restrict__ q,
                 const float* __restrict__ s, const float* __restrict__ bias,
                 T* __restrict__ out, float* __restrict__ part, int* __restrict__ counters,
                 int N, int K, int Kp, int O, int Op, int splits, int vec) {
    using C = PCfg<T, INT4, PNT>;
    using XF = XFrag<T>;
    constexpr int TERMS = XF::TERMS, PBN = C::PBN;
    extern __shared__ __align__(16) unsigned char smem[];
    unsigned char* planes = smem + PSTAGES * C::STAGE;

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int o0 = blockIdx.x * PBO, n0 = blockIdx.y * PBN;
    int st0, nst;
    split_stages<PSK>(Kp, splits, st0, nst);
    const size_t qrow = INT4 ? (size_t)Kp / 2 : (size_t)Kp;
    auto load = [&](int i) {                   // the split's stage i, into its slot
        if (i < nst)
            load_stage<T, INT4, PSK, PBO, PBN, PTHREADS>(
                smem + (i % PSTAGES) * C::STAGE, st0 + i, x, q, s, o0, n0, N, K, Op, qrow, vec,
                [](int c, int) { return c; }, [](int u, int) { return u; });
        cp_commit();
    };
    // x of stage i -> plane i % 2: quad qi of row n holds the stage's inputs
    // 4qi..4qi+3 (int4: 32 low, then 32 high), lane quad t's k-step j
    auto split = [&](int i) {
        const unsigned char* xs = smem + (i % PSTAGES) * C::STAGE + C::WBYTES + C::SBYTES;
        unsigned char* pl = planes + (i % 2) * C::PLANE;
#pragma unroll
        for (int r = 0; r < PBN * (PSK / 4) / PTHREADS; ++r) {
            const int id = threadIdx.x + r * PTHREADS;
            const int n = id / (PSK / 4), qi = id % (PSK / 4);
            const int tq = INT4 ? (qi % 8) / 2 : qi / 4;
            const int j = INT4 ? 2 * (qi / 8) + qi % 2 : qi % 4;
            uint32_t w[XF::WORDS], b[TERMS][2];
            const unsigned char* src = xs + n * C::XROW + qi * 4 * (int)sizeof(T);
            if constexpr (XF::WORDS == 4) {
                const uint4 v = *reinterpret_cast<const uint4*>(src);
                w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
            } else {
                const uint2 v = *reinterpret_cast<const uint2*>(src);
                w[0] = v.x, w[1] = v.y;
            }
            XF::build(w, b);
#pragma unroll
            for (int term = 0; term < TERMS; ++term)
                *reinterpret_cast<uint2*>(pl + term * PBN * PROW + n * PROW + (4 * tq + j) * 8) =
                    make_uint2(b[term][0], b[term][1]);
        }
    };

    float acc[PMT][PNT][4] = {};
#pragma unroll
    for (int i = 0; i < PSTAGES - 1; ++i) load(i);
    cp_wait<PSTAGES - 2>();
    __syncthreads();
    split(0);
    for (int i = 0; i < nst; ++i) {
        cp_wait<PSTAGES - 3>();
        __syncthreads();   // plane i written, stage i + 1 landed, stage i - 1 done with
        load(i + PSTAGES - 1);
        // stage i + 1 (past the last stage: stale bytes into a plane that
        // is never read; no branch, so the split interleaves with the MMAs)
        split(i + 1);

        const unsigned char* base = smem + (i % PSTAGES) * C::STAGE;
        const float* sc = reinterpret_cast<const float*>(base + C::WBYTES);
        const unsigned char* pl = planes + (i % 2) * C::PLANE;
        // A: rows 32 warp + 16m + g (+ 8), this lane's 16 (int4: 8) bytes
        constexpr int AW = INT4 ? 2 : 4;
        uint32_t wa[PMT][2][AW];
#pragma unroll
        for (int m = 0; m < PMT; ++m)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const unsigned char* p = base + (32 * warp + 16 * m + 8 * h + g) * C::WROW;
                if constexpr (INT4) {
                    const uint2 v = *reinterpret_cast<const uint2*>(p + 8 * t);
                    wa[m][h][0] = v.x;
                    wa[m][h][1] = v.y;
                } else {
                    const uint4 v = *reinterpret_cast<const uint4*>(p + 16 * t);
                    wa[m][h][0] = v.x;
                    wa[m][h][1] = v.y;
                    wa[m][h][2] = v.z;
                    wa[m][h][3] = v.w;
                }
            }
        // k-steps in pairs (int4: the low pair, then the high one) into
        // fresh fragments (see "Sums"): int8 a stage's, int4 a pair's
        float d[PMT][PNT][4] = {};
#pragma unroll
        for (int hp = 0; hp < 2; ++hp) {
            uint32_t a[2][PMT][4];
#pragma unroll
            for (int jj = 0; jj < 2; ++jj)
#pragma unroll
                for (int m = 0; m < PMT; ++m) {
                    if constexpr (INT4) {
                        if (hp) {
                            widen4<1>(wa[m][0][jj], a[jj][m][0], a[jj][m][2]);
                            widen4<1>(wa[m][1][jj], a[jj][m][1], a[jj][m][3]);
                        } else {
                            widen4<0>(wa[m][0][jj], a[jj][m][0], a[jj][m][2]);
                            widen4<0>(wa[m][1][jj], a[jj][m][1], a[jj][m][3]);
                        }
                    } else {
                        widen8(wa[m][0][2 * hp + jj], a[jj][m][0], a[jj][m][2]);
                        widen8(wa[m][1][2 * hp + jj], a[jj][m][1], a[jj][m][3]);
                    }
                }
#pragma unroll
            for (int nt = 0; nt < PNT; ++nt) {
                uint4 b[TERMS];                // k-steps 2hp (x, y) and 2hp + 1 (z, w)
#pragma unroll
                for (int term = 0; term < TERMS; ++term)
                    b[term] = *reinterpret_cast<const uint4*>(
                        pl + term * PBN * PROW + (nt * 8 + g) * PROW + (4 * t + 2 * hp) * 8);
#pragma unroll
                for (int jj = 0; jj < 2; ++jj)
#pragma unroll
                    for (int term = TERMS - 1; term >= 0; --term)
#pragma unroll
                        for (int m = 0; m < PMT; ++m)
                            mma(d[m][nt], a[jj][m][0], a[jj][m][1], a[jj][m][2], a[jj][m][3],
                                jj ? b[term].z : b[term].x, jj ? b[term].w : b[term].y);
            }
            if (INT4 || hp == 1) {
#pragma unroll
                for (int m = 0; m < PMT; ++m) {
                    float s_g = 1.f, s_g8 = 1.f;
                    if constexpr (INT4) {
                        s_g = sc[hp * PBO + 32 * warp + 16 * m + g];
                        s_g8 = sc[hp * PBO + 32 * warp + 16 * m + g + 8];
                    }
#pragma unroll
                    for (int nt = 0; nt < PNT; ++nt) {
                        acc[m][nt][0] = fmaf(s_g, d[m][nt][0], acc[m][nt][0]);
                        acc[m][nt][1] = fmaf(s_g, d[m][nt][1], acc[m][nt][1]);
                        acc[m][nt][2] = fmaf(s_g8, d[m][nt][2], acc[m][nt][2]);
                        acc[m][nt][3] = fmaf(s_g8, d[m][nt][3], acc[m][nt][3]);
                        d[m][nt][0] = d[m][nt][1] = d[m][nt][2] = d[m][nt][3] = 0.f;
                    }
                }
            }
        }
    }
    cp_wait<0>();
    __syncthreads();

    float* red = reinterpret_cast<float*>(smem);
#pragma unroll
    for (int m = 0; m < PMT; ++m)
#pragma unroll
        for (int nt = 0; nt < PNT; ++nt)
#pragma unroll
            for (int c = 0; c < 4; ++c)
                red[(nt * 8 + 2 * t + (c & 1)) * C::RS + 32 * warp + 16 * m + g + 8 * (c >> 1)] =
                    acc[m][nt][c];
    __syncthreads();
    finish_tile<T, INT4, PBO, PBN, PTHREADS>([&](int n, int o) { return red[n * C::RS + o]; },
                                             s, bias, out, part, counters, o0, n0, N, O, Op,
                                             splits);
}

template <class F>
cudaError_t set_smem(F* kernel, int bytes) {
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <typename T, bool INT4>
cudaError_t prepare_all() {
    cudaError_t e;
    if ((e = set_smem(quant_mm_decode<T, INT4, 1>, DCfg<T, INT4, 1>::SMEM)) != cudaSuccess)
        return e;
    if ((e = set_smem(quant_mm_decode<T, INT4, 2>, DCfg<T, INT4, 2>::SMEM)) != cudaSuccess)
        return e;
    if ((e = set_smem(quant_mm_prefill<T, INT4, 4>, PCfg<T, INT4, 4>::SMEM)) != cudaSuccess)
        return e;
    return set_smem(quant_mm_prefill<T, INT4, 8>, PCfg<T, INT4, 8>::SMEM);
}

template <typename T, bool INT4>
cudaError_t dispatch(const void* x, const void* q, const void* s, const void* bias, void* out,
                     void* part, void* cnt, int N, int K, int Kp, int O, int Op, int splits,
                     cudaStream_t st) {
    const int vec = (K % (16 / (int)sizeof(T)) == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0);
    const T* xt = static_cast<const T*>(x);
    const int8_t* qt = static_cast<const int8_t*>(q);
    const float *st_ = static_cast<const float*>(s), *bt = static_cast<const float*>(bias);
    T* ot = static_cast<T*>(out);
    float* pt = static_cast<float*>(part);
    int* ct = static_cast<int*>(cnt);
    if (N <= 8)
        quant_mm_decode<T, INT4, 1><<<dim3(Op / DBO, (N + 7) / 8, splits), NTHREADS,
                                      DCfg<T, INT4, 1>::SMEM, st>>>(
            xt, qt, st_, bt, ot, pt, ct, N, K, Kp, O, Op, splits, vec);
    else if (N <= 16)
        quant_mm_decode<T, INT4, 2><<<dim3(Op / DBO, (N + 15) / 16, splits), NTHREADS,
                                      DCfg<T, INT4, 2>::SMEM, st>>>(
            xt, qt, st_, bt, ot, pt, ct, N, K, Kp, O, Op, splits, vec);
    else if (N <= 32)
        quant_mm_prefill<T, INT4, 4><<<dim3(Op / PBO, (N + 31) / 32, splits), PTHREADS,
                                       PCfg<T, INT4, 4>::SMEM, st>>>(
            xt, qt, st_, bt, ot, pt, ct, N, K, Kp, O, Op, splits, vec);
    else
        quant_mm_prefill<T, INT4, 8><<<dim3(Op / PBO, (N + 63) / 64, splits), PTHREADS,
                                       PCfg<T, INT4, 8>::SMEM, st>>>(
            xt, qt, st_, bt, ot, pt, ct, N, K, Kp, O, Op, splits, vec);
    return cudaGetLastError();
}

}  // namespace

// Once per device, before its first quant_matmul_forward: the rings take
// up to 183 KB of dynamic shared memory. Returns a cudaError_t.
extern "C" int quant_matmul_prepare() {
    cudaError_t e;
    if ((e = prepare_all<float, false>()) != cudaSuccess) return (int)e;
    if ((e = prepare_all<float, true>()) != cudaSuccess) return (int)e;
    if ((e = prepare_all<__nv_bfloat16, false>()) != cudaSuccess) return (int)e;
    return (int)prepare_all<__nv_bfloat16, true>();
}

// x [N, K], q (int8 [Op, Kp] | packed int4 [Op, Kp/2]), s (int8 [1, Op] |
// int4 [Kp/128, Op]), bias [O] f32 or null, out [N, O]; with splits > 1,
// part [splits, N, Op] f32 scratch and counters [tiles] int32, zero before
// the first call (each call leaves them zero). int4 = 0 | 1, dtype 0 = f32,
// 1 = bf16 (x and out). Kp % 1024 == 0, Op % 256 == 0, K <= Kp, O <= Op,
// 1 <= splits <= Kp / 256 (the wrapper checks). Returns a cudaError_t.
extern "C" int quant_matmul_forward(const void* x, const void* q, const void* s,
                                    const void* bias, void* out, void* part, void* counters,
                                    int N, int K, int Kp, int O, int Op, int splits,
                                    int int4, int dtype, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (N <= 0 || O <= 0) return (int)cudaSuccess;
    if (splits < 1 || splits > Kp / UNIT || Kp % TI || Op % PBO
            || (splits > 1 && (part == nullptr || counters == nullptr)))
        return (int)cudaErrorInvalidValue;
    if (dtype == 0)
        return (int)(int4 ? dispatch<float, true>(x, q, s, bias, out, part, counters, N, K, Kp, O, Op, splits, st)
                          : dispatch<float, false>(x, q, s, bias, out, part, counters, N, K, Kp, O, Op, splits, st));
    if (dtype == 1)
        return (int)(int4 ? dispatch<__nv_bfloat16, true>(x, q, s, bias, out, part, counters, N, K, Kp, O, Op, splits, st)
                          : dispatch<__nv_bfloat16, false>(x, q, s, bias, out, part, counters, N, K, Kp, O, Op, splits, st));
    return (int)cudaErrorInvalidValue;
}
