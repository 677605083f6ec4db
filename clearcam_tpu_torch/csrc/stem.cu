// YOLOv9 stem, blocks 0-1, as one kernel for Hopper (sm_90a):
//
//   conv 3x3 s2 p1 3->16 + bias + SiLU, then conv 3x3 s2 p1 16->32 + bias + SiLU
//
// Replaces: clearcam_tpu/ops/stem.py `stem_planes` (Pallas TPU kernel body
// `_make_kernel`). The TPU kernel's 4x4 space-to-depth planes, shift-
// permutation matmul and row-serial loop are Mosaic workarounds and are not
// carried over; this file keeps the `stem()` contract instead, for any H
// and W, rectangular and ragged included:
//
//   x    NHWC [B,H,W,3], contiguous (letterboxed, RGB, 0..1)
//   out  NHWC [B,H2,W2,32] in x's type, H1 = ceil(H/2), H2 = ceil(H1/2)
//        (the same for W)
//
// Two instances, one launch each:
//
// bf16 (the served route): an implicit GEMM on the tensor cores,
// `mma.sync.m16n8k16` bf16 with f32 accumulation. Its operands come from
// ops/stem.py `pack`: w1 [16][48] bf16, K = 16*dy + 4*dx + c (dx = 3 and
// c = 3 hold zero weights), w2 [32][144] bf16, K = 16*(3*dy + dx) + ci,
// b1 [16] and b2 [32] f32. Numerics (the TPU kernel's): bf16 products
// summed in f32, bias and SiLU in f32, the conv1 output rounded to bf16
// before conv2 reads it, the conv2 output rounded once on store.
//
// What bounds it: at [8,384,640,3] a call reads 11.8 MB and writes 7.9 MB,
// 5.9 us at 3.35 TB/s; its 778 M multiply-adds take 1.6 us at the bf16
// tensor-core peak, so HBM bytes set the bound (on the CUDA cores the
// multiply-adds alone took 4x the bytes' time). The design keeps the
// conv1 activation in shared memory (the plain pair writes and re-reads
// 16 channels at half resolution) and reads each input byte about once
// (a tile's halo re-reads 15% of its input, mostly from L2).
//
// Design: one block per (image, TH x TW = 8 x 16 tile of conv2 outputs),
// 8 warps, 47 KB of static shared memory and 64 registers a thread (4
// blocks an SM). The kernel issues more instructions than its bytes need
// (timed copies with parts removed: no single phase dominates), so each
// phase keeps its address arithmetic to per-thread bases and constants:
//   1. the (4TH+3) x (4TW+4) input halo goes to shared memory as 8-byte
//      pixels (c0, c1, c2, 0), zero outside the image (conv1's padding).
//      A thread loads one pixel pair of every seventh row, each pixel
//      with one 4-byte and one 2-byte load (its 6 bytes start 4-byte
//      aligned or 2 bytes past), so any W and any 2-byte-aligned x work
//      with no narrower path; all its loads are issued before the first
//      is used;
//   2. conv1 as a GEMM, M = the (2TH+1) x (2TW+1) conv1 pixels padded to
//      16s, N = 16, K = 48: with 8-byte pixels, taps (dy, 0..1) and
//      (dy, 2..3) of a conv1 pixel are two 16-byte runs of the halo, so
//      `ldmatrix.x4` gathers each 16-deep k-step's A tile (k-step = dy);
//      B stays in registers. Epilogue: f32 bias and SiLU, round to bf16,
//      0 outside [0,H1) x [0,W1) (conv2's padding lives in conv1-output
//      space, not silu(b1)); the tile is stored as planes of 16-byte
//      units, one per (row, column parity, 8-channel half), 18 units
//      apart, so that neither these stores nor conv2's stride-2 reads
//      conflict on banks;
//   3. conv2 as a GEMM, M = 128 outputs, N = 32, K = 144 = 9 taps x 16
//      channels: `ldmatrix.x4` with a row address per output pixel, at
//      conv1 pixel (2y+dy, 2x+dx), a lane base plus a constant in the
//      planes, so the stride-2 gather costs nothing;
//      B (w2, rows padded to 152 so ldmatrix is conflict-free) comes by
//      cp.async into shared memory while the halo and conv1 run. Each
//      warp takes 2 output rows x 16 channels; each dy's three k-steps sum
//      into a fresh fragment, added to the total in f32 (the tensor cores
//      truncate their additions);
//   4. epilogue: f32 bias and SiLU, bf16, staged in shared memory (over
//      the dead halo), then written as coalesced 16-byte stores, 64 bytes
//      a pixel.
// Launch sizes come from the shapes alone; nothing is allocated, so a
// call can be captured in a CUDA graph.
//
// f32 (not served; the f32 model on the card, which chip_smoke.py holds
// against the CPU): a direct convolution on the CUDA cores from f32 HWIO
// operands, ~84 KB of dynamic shared memory (allowed by `stem_prepare`):
// one thread per (output pixel, 16 channels), fmaf from shared memory.
//
// The caller passes the output buffer and the stream. `stem_forward`
// returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int C0 = 3, C1 = 16, C2 = 32;     // channels in, mid, out

__device__ __forceinline__ float silu(float v) { return v / (1.0f + expf(-v)); }

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&h);
}

// ---------------------------------------------------------------------------
// bf16: implicit GEMM on the tensor cores

namespace tc {

constexpr int TH = 8, TW = 16;                      // conv2 outputs a block
constexpr int WARPS = 8, NTHREADS = 32 * WARPS;
constexpr int R1H = 2 * TH + 1, R1W = 2 * TW + 1;   // conv1 region
constexpr int NP1 = R1H * R1W;                      // 561 conv1 pixels
constexpr int MT1 = (NP1 + 15) / 16;                // conv1 m-tiles
// the halo's 4TW+3 columns and one more, read by the zero-weight dx = 3
// taps, so every pixel pair is one 16-byte unit
constexpr int RIH = 4 * TH + 3, RIW = 4 * TW + 4;
constexpr int HU = RIW / 2;                         // halo units a row
constexpr int HG = NTHREADS / HU;                   // halo rows loaded at once
constexpr int HR = (RIH + HG - 1) / HG;             // halo rows a thread
constexpr int K1 = 48, K2 = 144;
constexpr int W2_ROW = 152;             // bf16 a w2 row in shared memory
constexpr int W2_ITERS = (C2 * K2 / 8 + NTHREADS - 1) / NTHREADS;
// conv1 tile: planes of 16-byte units, one per (row, column parity, channel
// half), of (R1W + 1) / 2 columns padded to 18 units
constexpr int C1_PLANE = 18;
constexpr int C1_UNITS = R1H * 4 * C1_PLANE;
constexpr int OUT_UNITS = TH * TW * 4;
constexpr int SMEM_BYTES = RIH * RIW * 8 + C1_UNITS * 16 + C2 * W2_ROW * 2;

static_assert(RIW % 2 == 0 && (W2_ROW * 2) % 16 == 0, "16-byte units");
static_assert(C1_PLANE >= (R1W + 1) / 2 && C1_PLANE % 4 == 2, "conflict-free planes");
static_assert(TW == 16 && TH == 2 * (WARPS / 2), "conv2 warp mapping");
static_assert(OUT_UNITS % NTHREADS == 0 && OUT_UNITS * 16 <= RIH * RIW * 8,
              "output staging fits in the halo");
static_assert(SMEM_BYTES <= 48 * 1024, "static shared memory");

// SiLU from the approximate ex2 and rcp (~2 ulp of f32 each, one MUFU
// instruction each): the result is rounded to bf16 (8 bits) after it
__device__ __forceinline__ float silu_fast(float v) {
    float e, r;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(v * -1.4426950408889634f));
    asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(1.0f + e));
    return v * r;
}

__device__ __forceinline__ void cp16(void* dst, const void* src) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_wait_all() {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const void* p) {
    const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(NTHREADS, 4)
stem_tc_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w1,
               const float* __restrict__ b1, const __nv_bfloat16* __restrict__ w2,
               const float* __restrict__ b2, __nv_bfloat16* __restrict__ out,
               int H, int W, int H1, int W1, int H2, int W2) {
    __shared__ __align__(128) uint4 s_in[RIH * HU];        // [RIH][RIW] 8-byte pixels
    __shared__ __align__(128) uint4 s_c1[C1_UNITS];        // [row][parity][half][col/2]
    __shared__ __align__(128) uint4 s_w2[C2 * W2_ROW / 8];  // [32][W2_ROW] bf16
    uint32_t* s_out = reinterpret_cast<uint32_t*>(s_in);   // [128 px][4] units, over the halo

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t = lane & 3;
    const int b = blockIdx.z;
    const int oy0 = blockIdx.y * TH, ox0 = blockIdx.x * TW;
    const int y1_0 = 2 * oy0 - 1, x1_0 = 2 * ox0 - 1;   // conv1 region origin
    const int iy0 = 2 * y1_0 - 1, ix0 = 2 * x1_0 - 1;   // input halo origin

    // w2 -> shared memory, waited for before conv2
#pragma unroll
    for (int k = 0; k < W2_ITERS; ++k) {
        const int i = tid + k * NTHREADS;
        const int n = i / (K2 / 8), u = i - n * (K2 / 8);
        if (i < C2 * K2 / 8)
            cp16(reinterpret_cast<char*>(s_w2) + (n * W2_ROW + u * 8) * 2, w2 + n * K2 + u * 8);
    }
    cp_commit();

    // 1. input halo: thread -> pixel pair q of rows r0, r0 + HG, ...; every
    //    load issued, then the stores. A pixel's 6 bytes start 4-byte
    //    aligned (o = 0) or 2 bytes past (o = 1); the next pixel, 6 bytes
    //    on, the other way
    const char* xb = reinterpret_cast<const char*>(x) + (size_t)b * H * W * (C0 * 2);
    const int q = tid % HU, r0 = tid / HU;
    const int gx = ix0 + 2 * q;
    const bool okx0 = (unsigned)gx < (unsigned)W, okx1 = (unsigned)(gx + 1) < (unsigned)W;
    uint32_t wv[HR][2], hv[HR][2];
    unsigned odd[HR];
#pragma unroll
    for (int k = 0; k < HR; ++k) {
        const int gy = iy0 + r0 + k * HG;
        const bool oky = r0 < HG && r0 + k * HG < RIH && (unsigned)gy < (unsigned)H;
        const char* p = xb + ((ptrdiff_t)gy * W + gx) * (C0 * 2);
        const unsigned o = (unsigned)(reinterpret_cast<uintptr_t>(p) >> 1) & 1u;
        odd[k] = o;
        wv[k][0] = hv[k][0] = wv[k][1] = hv[k][1] = 0u;
        if (oky && okx0) {
            wv[k][0] = __ldg(reinterpret_cast<const unsigned int*>(p + 2 * o));
            hv[k][0] = __ldg(reinterpret_cast<const unsigned short*>(p + 4 - 4 * o));
        }
        if (oky && okx1) {
            wv[k][1] = __ldg(reinterpret_cast<const unsigned int*>(p + 8 - 2 * o));
            hv[k][1] = __ldg(reinterpret_cast<const unsigned short*>(p + 6 + 4 * o));
        }
    }
#pragma unroll
    for (int k = 0; k < HR; ++k) {
        const int r = r0 + k * HG;
        if (r0 < HG && r < RIH) {
            const uint32_t w0 = wv[k][0], h0 = hv[k][0], w1v = wv[k][1], h1v = hv[k][1];
            s_in[r * HU + q] = odd[k] ? make_uint4(h0 | (w0 << 16), w0 >> 16, w1v, h1v)
                                      : make_uint4(w0, h0, h1v | (w1v << 16), w1v >> 16);
        }
    }

    // conv1's B fragments (n-tile j, k-step dy) and biases, in registers
    uint32_t bw1[2][3][2];
    float bias1[2][2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
        const __nv_bfloat16* row = w1 + (8 * j + g) * K1 + 2 * t;
#pragma unroll
        for (int s = 0; s < 3; ++s) {
            bw1[j][s][0] = __ldg(reinterpret_cast<const unsigned int*>(row + 16 * s));
            bw1[j][s][1] = __ldg(reinterpret_cast<const unsigned int*>(row + 16 * s + 8));
        }
        bias1[j][0] = __ldg(b1 + 8 * j + 2 * t);
        bias1[j][1] = __ldg(b1 + 8 * j + 2 * t + 1);
    }
    __syncthreads();

    // 2. conv1: each warp takes m-tiles warp, warp + 8, ...
    {
        // ldmatrix.x4 rows: lanes 0-7 rows 0-7 k 0-7, 8-15 rows 8-15 k 0-7,
        // 16-23 rows 0-7 k 8-15, 24-31 rows 8-15 k 8-15
        const int arow = (lane & 7) + ((lane >> 3) & 1) * 8, ah = lane >> 4;
        uint32_t* s_c1w = reinterpret_cast<uint32_t*>(s_c1);
        for (int mt = warp; mt < MT1; mt += WARPS) {
            const int pa = min(mt * 16 + arow, NP1 - 1);
            const int ry = pa / R1W, rx = pa - ry * R1W;
            float acc[2][4] = {};
#pragma unroll
            for (int dy = 0; dy < 3; ++dy) {
                uint32_t a[4];
                ldsm4(a, s_in + (2 * ry + dy) * HU + rx + ah);
                mma(acc[0], a, bw1[0][dy][0], bw1[0][dy][1]);
                mma(acc[1], a, bw1[1][dy][0], bw1[1][dy][1]);
            }
#pragma unroll
            for (int rh = 0; rh < 2; ++rh) {
                const int p = mt * 16 + g + 8 * rh;
                const int ry2 = p / R1W, rx2 = p - ry2 * R1W;
                const bool inside = (unsigned)(y1_0 + ry2) < (unsigned)H1 &&
                                    (unsigned)(x1_0 + rx2) < (unsigned)W1;
                uint32_t* dst = s_c1w + ((ry2 * 4 + 2 * (rx2 & 1)) * C1_PLANE + (rx2 >> 1)) * 4 + t;
#pragma unroll
                for (int j = 0; j < 2; ++j) {
                    const uint32_t v = pack_bf16x2(silu_fast(acc[j][2 * rh] + bias1[j][0]),
                                                   silu_fast(acc[j][2 * rh + 1] + bias1[j][1]));
                    if (p < NP1) dst[j * C1_PLANE * 4] = inside ? v : 0u;
                }
            }
        }
    }
    cp_wait_all();
    __syncthreads();

    // 3. conv2: warp -> output rows 2*mp, 2*mp+1, channels 16*nh .. +15
    const int mp = warp >> 1, nh = warp & 1;
    float acc[2][2][4] = {};
    {
        // A row address: conv1 pixel (2*ty + dy, 2*ox + dx), ox = the row
        // of the m-tile, in plane (row, dx & 1, channel half) at column
        // ox + dx / 2
        const int arow = (lane & 7) + ((lane >> 3) & 1) * 8, akh = lane >> 4;
        const uint4* abase = s_c1 + (16 * mp + akh) * C1_PLANE + arow;
        // B by ldmatrix.x4: lanes 0-7 n-tile 0 k 0-7, 8-15 n-tile 0 k 8-15,
        // 16-23 n-tile 1 k 0-7, 24-31 n-tile 1 k 8-15
        const char* bbase = reinterpret_cast<const char*>(s_w2) +
            ((16 * nh + 8 * (lane >> 4) + (lane & 7)) * W2_ROW + ((lane >> 3) & 1) * 8) * 2;
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
            float part[2][2][4] = {};
#pragma unroll
            for (int dx = 0; dx < 3; ++dx) {
                uint32_t bf[4];
                ldsm4(bf, bbase + (dy * 3 + dx) * 32);
#pragma unroll
                for (int mi = 0; mi < 2; ++mi) {
                    uint32_t a[4];
                    ldsm4(a, abase + ((2 * mi + dy) * 4 + 2 * (dx & 1)) * C1_PLANE + (dx >> 1));
                    mma(part[mi][0], a, bf[0], bf[1]);
                    mma(part[mi][1], a, bf[2], bf[3]);
                }
            }
#pragma unroll
            for (int mi = 0; mi < 2; ++mi)
#pragma unroll
                for (int ji = 0; ji < 2; ++ji)
#pragma unroll
                    for (int e = 0; e < 4; ++e) acc[mi][ji][e] += part[mi][ji][e];
        }
    }

    // 4. epilogue: bias + SiLU, bf16, staged as [pixel][4] units, unit c of
    //    pixel q at q * 4 + (c ^ ((q >> 1) & 3)) (conflict-free stores)
#pragma unroll
    for (int ji = 0; ji < 2; ++ji) {
        const int ch = 16 * nh + 8 * ji + 2 * t;
        const float c0 = __ldg(b2 + ch), c1 = __ldg(b2 + ch + 1);
        const int unit = 2 * nh + ji;
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int rh = 0; rh < 2; ++rh) {
                const int q = (2 * mp + mi) * TW + g + 8 * rh;
                s_out[(q * 4 + (unit ^ ((q >> 1) & 3))) * 4 + t] =
                    pack_bf16x2(silu_fast(acc[mi][ji][2 * rh] + c0),
                                silu_fast(acc[mi][ji][2 * rh + 1] + c1));
            }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < OUT_UNITS / NTHREADS; ++k) {
        const int u = tid + k * NTHREADS;
        const int q = u >> 2, c = u & 3;
        const int oy = oy0 + q / TW, ox = ox0 + q % TW;
        if (oy < H2 && ox < W2)
            reinterpret_cast<uint4*>(out + (((size_t)b * H2 + oy) * W2 + ox) * C2)[c] =
                s_in[q * 4 + (c ^ ((q >> 1) & 3))];
    }
}

cudaError_t launch(const void* x, const void* w1, const float* b1, const void* w2,
                   const float* b2, void* out, int B, int H, int W, cudaStream_t stream) {
    const int H1 = (H + 1) / 2, W1 = (W + 1) / 2;
    const int H2 = (H1 + 1) / 2, W2 = (W1 + 1) / 2;
    const dim3 grid((W2 + TW - 1) / TW, (H2 + TH - 1) / TH, B);
    stem_tc_kernel<<<grid, NTHREADS, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w1), b1,
        static_cast<const __nv_bfloat16*>(w2), b2, static_cast<__nv_bfloat16*>(out),
        H, W, H1, W1, H2, W2);
    return cudaGetLastError();
}

}  // namespace tc

// ---------------------------------------------------------------------------
// f32: direct convolution on the CUDA cores

namespace cc {

constexpr int TH = 8;                       // conv2 output rows per block
constexpr int TW = 16;                      // conv2 output cols per block
constexpr int NTHREADS = 2 * TH * TW;       // one thread per (pixel, 16 ch)
constexpr int R1H = 2 * TH + 1, R1W = 2 * TW + 1;   // conv1 region
constexpr int RIH = 4 * TH + 3, RIW = 4 * TW + 3;   // input halo
constexpr int W1N = 9 * C0 * C1;
constexpr int W2N = 9 * C1 * C2;

// shared-memory layout, in floats: w1 | w2 | b1 | b2 | input | conv1
constexpr int OFF_W1 = 0;
constexpr int OFF_W2 = OFF_W1 + W1N;
constexpr int OFF_B1 = OFF_W2 + W2N;
constexpr int OFF_B2 = OFF_B1 + C1;
constexpr int OFF_IN = OFF_B2 + C2;
constexpr int OFF_C1 = OFF_IN + RIH * RIW * C0;
constexpr int SMEM_FLOATS = OFF_C1 + C1 * R1H * R1W;
constexpr size_t SMEM_BYTES = SMEM_FLOATS * sizeof(float);

static_assert(OFF_W1 % 4 == 0 && OFF_W2 % 4 == 0, "float4 weight loads");
static_assert(NTHREADS == 256, "thread mapping of the conv2 phase");

// acc[0..15] += a * w[0..15], w 16-byte aligned in shared memory
__device__ __forceinline__ void fma16(float* acc, float a, const float* w) {
    const float4* w4 = reinterpret_cast<const float4*>(w);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        const float4 v = w4[q];
        acc[4 * q + 0] = fmaf(a, v.x, acc[4 * q + 0]);
        acc[4 * q + 1] = fmaf(a, v.y, acc[4 * q + 1]);
        acc[4 * q + 2] = fmaf(a, v.z, acc[4 * q + 2]);
        acc[4 * q + 3] = fmaf(a, v.w, acc[4 * q + 3]);
    }
}

// 16 channels to a 16-byte-aligned NHWC pixel (64 B)
__device__ __forceinline__ void store16(float* dst, const float* v) {
    float4* d = reinterpret_cast<float4*>(dst);
#pragma unroll
    for (int q = 0; q < 4; ++q)
        d[q] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
}

__global__ void __launch_bounds__(NTHREADS)
stem_cc_kernel(const float* __restrict__ x, const float* __restrict__ w1,
               const float* __restrict__ b1, const float* __restrict__ w2,
               const float* __restrict__ b2, float* __restrict__ out,
               int H, int W, int H1, int W1, int H2, int W2) {
    extern __shared__ float4 smem4[];
    float* smem = reinterpret_cast<float*>(smem4);
    float* s_w1 = smem + OFF_W1;
    float* s_w2 = smem + OFF_W2;
    float* s_b1 = smem + OFF_B1;
    float* s_b2 = smem + OFF_B2;
    float* s_in = smem + OFF_IN;    // [RIH][RIW][C0]
    float* s_c1 = smem + OFF_C1;    // [C1][R1H][R1W]

    const int tid = threadIdx.x;
    const int b = blockIdx.z;
    const int oy0 = blockIdx.y * TH, ox0 = blockIdx.x * TW;
    const int y1_0 = 2 * oy0 - 1, x1_0 = 2 * ox0 - 1;   // conv1 region origin
    const int iy0 = 2 * y1_0 - 1, ix0 = 2 * x1_0 - 1;   // input halo origin

    for (int i = tid; i < W1N; i += NTHREADS) s_w1[i] = w1[i];
    for (int i = tid; i < W2N; i += NTHREADS) s_w2[i] = w2[i];
    if (tid < C1) s_b1[tid] = b1[tid];
    if (tid < C2) s_b2[tid] = b2[tid];

    // 1. input halo; each row of the halo is one contiguous run of NHWC
    const float* xb = x + (size_t)b * H * W * C0;
    for (int i = tid; i < RIH * RIW * C0; i += NTHREADS) {
        const int r = i / (RIW * C0);
        const int e = i - r * (RIW * C0);
        const int ex = e / C0, c = e - ex * C0;
        const int gy = iy0 + r, gx = ix0 + ex;
        float v = 0.0f;
        if (gy >= 0 && gy < H && gx >= 0 && gx < W)
            v = xb[((size_t)gy * W + gx) * C0 + c];
        s_in[i] = v;
    }
    __syncthreads();

    // 2. conv1 + bias + SiLU; zero outside the conv1 image
    for (int p = tid; p < R1H * R1W; p += NTHREADS) {
        const int ry = p / R1W, rx = p - ry * R1W;
        const int y1 = y1_0 + ry, x1 = x1_0 + rx;
        float acc[C1];
        if (y1 >= 0 && y1 < H1 && x1 >= 0 && x1 < W1) {
#pragma unroll
            for (int co = 0; co < C1; ++co) acc[co] = s_b1[co];
#pragma unroll
            for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
                for (int dx = 0; dx < 3; ++dx) {
                    const float* src = s_in + ((2 * ry + dy) * RIW + 2 * rx + dx) * C0;
#pragma unroll
                    for (int c = 0; c < C0; ++c)
                        fma16(acc, src[c], s_w1 + ((dy * 3 + dx) * C0 + c) * C1);
                }
            }
#pragma unroll
            for (int co = 0; co < C1; ++co) acc[co] = silu(acc[co]);
        } else {
#pragma unroll
            for (int co = 0; co < C1; ++co) acc[co] = 0.0f;
        }
#pragma unroll
        for (int co = 0; co < C1; ++co) s_c1[(co * R1H + ry) * R1W + rx] = acc[co];
    }
    __syncthreads();

    // 3. conv2 + bias + SiLU: thread -> one output pixel, channels half*16..+16
    const int tx = tid % TW, ty = (tid / TW) % TH, half = tid / (TH * TW);
    const int oy = oy0 + ty, ox = ox0 + tx;
    float acc[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[j] = s_b2[half * 16 + j];
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
            const float* src = s_c1 + (2 * ty + dy) * R1W + 2 * tx + dx;
#pragma unroll 4
            for (int ci = 0; ci < C1; ++ci)
                fma16(acc, src[ci * R1H * R1W],
                      s_w2 + ((dy * 3 + dx) * C1 + ci) * C2 + half * 16);
        }
    }
    if (oy < H2 && ox < W2) {
#pragma unroll
        for (int j = 0; j < 16; ++j) acc[j] = silu(acc[j]);
        store16(out + (((size_t)b * H2 + oy) * W2 + ox) * C2 + half * 16, acc);
    }
}

cudaError_t launch(const void* x, const void* w1, const float* b1, const void* w2,
                   const float* b2, void* out, int B, int H, int W, cudaStream_t stream) {
    const int H1 = (H + 1) / 2, W1 = (W + 1) / 2;
    const int H2 = (H1 + 1) / 2, W2 = (W1 + 1) / 2;
    const dim3 grid((W2 + TW - 1) / TW, (H2 + TH - 1) / TH, B);
    stem_cc_kernel<<<grid, NTHREADS, SMEM_BYTES, stream>>>(
        static_cast<const float*>(x), static_cast<const float*>(w1), b1,
        static_cast<const float*>(w2), b2, static_cast<float*>(out), H, W, H1, W1, H2, W2);
    return cudaGetLastError();
}

}  // namespace cc

}  // namespace

extern "C" const char* cuda_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Once per device, before its first stem_forward: allow the f32 kernel's
// dynamic shared memory. Returns a cudaError_t (0 = success).
extern "C" int stem_prepare() {
    return (int)cudaFuncSetAttribute(cc::stem_cc_kernel,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     (int)cc::SMEM_BYTES);
}

// dtype 1 = bfloat16: x bf16, w1/w2 packed bf16 (see the top of this file);
// dtype 0 = float32: x f32, w1/w2 HWIO f32. b1, b2 f32 in both. Returns a
// cudaError_t (0 = success).
extern "C" int stem_forward(const void* x, const void* w1, const void* b1,
                            const void* w2, const void* b2, void* out,
                            int B, int H, int W, int dtype, void* stream) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float* fb1 = static_cast<const float*>(b1);
    const float* fb2 = static_cast<const float*>(b2);
    if (dtype == 1) return (int)tc::launch(x, w1, fb1, w2, fb2, out, B, H, W, s);
    if (dtype == 0) return (int)cc::launch(x, w1, fb1, w2, fb2, out, B, H, W, s);
    return (int)cudaErrorInvalidValue;
}
