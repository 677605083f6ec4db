// YOLOv9 stem, blocks 0-1, as one kernel for Hopper (sm_90a):
//
//   conv 3x3 s2 p1 3->16 + bias + SiLU, then conv 3x3 s2 p1 16->32 + bias + SiLU
//
// Replaces: clearcam_tpu/ops/stem.py `stem_planes` (Pallas TPU kernel body
// `_make_kernel`). The TPU kernel's 4x4 space-to-depth planes, packed
// weights, shift-permutation matmul and row-serial loop are Mosaic
// workarounds and are not carried over; this kernel keeps the `stem()`
// contract instead:
//
//   x    NHWC [B,H,W,3], bf16 or f32, contiguous (letterboxed, RGB, 0..1)
//   w1   HWIO [3,3,3,16] f32;  b1 [16] f32
//   w2   HWIO [3,3,16,32] f32; b2 [32] f32
//   out  NHWC [B,H2,W2,32] in x's type, H1 = ceil(H/2), H2 = ceil(H1/2)
//        (the same for W); any H and W, rectangular and ragged included.
//
// Numerics (the TPU kernel's): products and sums in f32, bias and SiLU in
// f32, the conv1 output rounded to the I/O type before conv2 reads it, the
// conv2 output rounded once on store.
//
// What bounds it: per 384x640 frame the stem is ~97 M MACs (26.5 M in
// conv1, 70.8 M in conv2) against ~2.5 MB read and written in bf16, about
// 79 FLOP per byte, so a direct kernel on the CUDA cores is bound by its
// FMAs and by the shared-memory loads that feed them, not by HBM. The
// design keeps the conv1 activation out of device memory (the plain pair
// writes and re-reads 16 channels at half resolution) and feeds each FMA
// from shared memory with 16-byte broadcast weight loads (one activation
// load per 16 FMAs). Implicit GEMM on the tensor cores (wgmma) is later work.
//
// Design: one block per (image, TH x TW tile of conv2 outputs), 256 threads.
//   1. stage the (4TH+3) x (4TW+3) x 3 input halo into shared memory,
//      zero outside the image (conv1's padding);
//   2. compute the (2TH+1) x (2TW+1) x 16 conv1 region into shared memory;
//      positions outside [0,H1) x [0,W1) are stored as 0, since conv2's
//      zero padding lives in conv1-output space (not silu(b1));
//   3. each thread computes 16 of the 32 conv2 channels of one output pixel
//      and writes them with 16-byte stores.
// Weights are staged into shared memory as f32 (5,040 floats). The block
// uses ~84 KB of dynamic shared memory, above the 48 KB static limit:
// `stem_prepare` raises cudaFuncAttributeMaxDynamicSharedMemorySize once per
// device, before the first launch there.
//
// The kernel allocates nothing; the caller passes the output buffer and the
// stream. `stem_forward` returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TH = 8;                       // conv2 output rows per block
constexpr int TW = 16;                      // conv2 output cols per block
constexpr int C0 = 3, C1 = 16, C2 = 32;     // channels in, mid, out
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

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
    return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float silu(float v) { return v / (1.0f + expf(-v)); }

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

// 16 channels to a 16-byte-aligned NHWC pixel: 64 B in f32, 32 B in bf16
__device__ __forceinline__ void store16(float* dst, const float* v) {
    float4* d = reinterpret_cast<float4*>(dst);
#pragma unroll
    for (int q = 0; q < 4; ++q)
        d[q] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ void store16(__nv_bfloat16* dst, const float* v) {
    uint4* d = reinterpret_cast<uint4*>(dst);
#pragma unroll
    for (int q = 0; q < 2; ++q)
        d[q] = make_uint4(pack_bf16x2(v[8 * q], v[8 * q + 1]),
                          pack_bf16x2(v[8 * q + 2], v[8 * q + 3]),
                          pack_bf16x2(v[8 * q + 4], v[8 * q + 5]),
                          pack_bf16x2(v[8 * q + 6], v[8 * q + 7]));
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
stem_kernel(const T* __restrict__ x, const float* __restrict__ w1,
            const float* __restrict__ b1, const float* __restrict__ w2,
            const float* __restrict__ b2, T* __restrict__ out,
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
    const T* xb = x + (size_t)b * H * W * C0;
    for (int i = tid; i < RIH * RIW * C0; i += NTHREADS) {
        const int r = i / (RIW * C0);
        const int e = i - r * (RIW * C0);
        const int ex = e / C0, c = e - ex * C0;
        const int gy = iy0 + r, gx = ix0 + ex;
        float v = 0.0f;
        if (gy >= 0 && gy < H && gx >= 0 && gx < W)
            v = to_f(xb[((size_t)gy * W + gx) * C0 + c]);
        s_in[i] = v;
    }
    __syncthreads();

    // 2. conv1 + bias + SiLU, rounded to T; zero outside the conv1 image
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
            for (int co = 0; co < C1; ++co) acc[co] = to_f(from_f<T>(silu(acc[co])));
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

template <typename T>
cudaError_t launch(const void* x, const float* w1, const float* b1,
                   const float* w2, const float* b2, void* out,
                   int B, int H, int W, cudaStream_t stream) {
    const int H1 = (H + 1) / 2, W1 = (W + 1) / 2;
    const int H2 = (H1 + 1) / 2, W2 = (W1 + 1) / 2;
    const dim3 grid((W2 + TW - 1) / TW, (H2 + TH - 1) / TH, B);
    stem_kernel<T><<<grid, NTHREADS, SMEM_BYTES, stream>>>(
        static_cast<const T*>(x), w1, b1, w2, b2, static_cast<T*>(out),
        H, W, H1, W1, H2, W2);
    return cudaGetLastError();
}

}  // namespace

extern "C" const char* cuda_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Once per device, before its first stem_forward: allow the kernel's
// dynamic shared memory. Returns a cudaError_t (0 = success).
extern "C" int stem_prepare() {
    cudaError_t err = cudaFuncSetAttribute(
        stem_kernel<float>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaFuncSetAttribute(
        stem_kernel<__nv_bfloat16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)SMEM_BYTES);
}

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = success).
extern "C" int stem_forward(const void* x, const void* w1, const void* b1,
                            const void* w2, const void* b2, void* out,
                            int B, int H, int W, int dtype, void* stream) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float* fw1 = static_cast<const float*>(w1);
    const float* fb1 = static_cast<const float*>(b1);
    const float* fw2 = static_cast<const float*>(w2);
    const float* fb2 = static_cast<const float*>(b2);
    if (dtype == 1)
        return (int)launch<__nv_bfloat16>(x, fw1, fb1, fw2, fb2, out, B, H, W, s);
    if (dtype == 0)
        return (int)launch<float>(x, fw1, fb1, fw2, fb2, out, B, H, W, s);
    return (int)cudaErrorInvalidValue;
}
