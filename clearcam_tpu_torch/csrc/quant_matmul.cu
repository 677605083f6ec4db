// Weight-only quantized matrix product for Hopper (sm_90a), int8 (W8A16)
// and packed int4 (W4A16):
//
//   out[n, o] = sum_k x[n, k] * W[o, k] (+ bias[o]),  W = dequant(q, s)
//
// Replaces: clearcam_tpu/ops/quant_matmul.py `_quant_matmul`, both of its
// Pallas TPU kernels: `_kernel` (int8, one scale per output feature,
// applied once after the K sum) and `_kernel4` (two nibbles per byte,
// one scale per (group of 128 inputs, output), applied to each group's
// partial sum). The layouts are the ones `quantize_int8` / `quantize_int4`
// store, byte for byte the JAX package's:
//
//   int8  q [O_pad, I_pad] int8, s [1, O_pad] f32
//   int4  q [O_pad, I_pad/2] int8: in every 1024-wide K tile, byte j holds
//         element j in its low nibble and element j + 512 in its high
//         nibble (both two's complement, sign-extended as the TPU kernel
//         does: (b << 28) >> 28 and b >> 4); s [I_pad/128, O_pad] f32,
//         group-major
//   x     [N, in_features] f32 or bf16, row-major; N is any row count and
//         nothing is padded in memory: columns past in_features and rows
//         past N load as zero
//   out   [N, out_features] in x's type; bias [out_features] f32 or null
//
// What bounds it: at decode (N <= 16 rows, the serving slots) every weight
// byte is used for N multiply-adds, far below the ~295 operations per byte
// the card needs to leave the memory bound, so the kernel is bound by the
// weight bytes read from HBM (int8: 1 byte, int4: 0.5 byte per weight).
// Each weight is read once, 16 bytes per load, and converted to f32 in
// registers; accumulation is f32.
//
// Design: one block of 256 threads (8 warps) per 32 output features and
// NB rows of x. Lane l of every warp owns output feature o0 + l; the 8
// warps split each 1024-wide K tile (int8: 128 bytes of the row per warp,
// int4: 64 packed bytes, i.e. 64 low and 64 high elements). The K tile of
// x for the block's NB rows is staged in shared memory as f32, and every
// lane of a warp reads the same x element at a time (a broadcast, no bank
// conflict). The 8 warps' partial sums are added through shared memory at
// the end, where the int8 scale and the bias are applied and the result
// is rounded to x's type. NB is 1, 2, 4, 8 or 16 (templated: decode at
// one slot does no work for absent rows); longer inputs (prefill chunks
// of 32 to 256 rows) take more blocks along y and read the weights again
// once per 16 rows, on the CUDA cores: correct, not fast. Tensor cores
// (mma / wgmma with dequant into fragments), TMA and split-K for the small
// projections are later work.
//
// Shared memory: NB x 1024 f32 = 64 KB at NB = 16, above the 48 KB static
// limit: `quant_matmul_prepare` raises the dynamic limit once per device.
// The kernel allocates nothing; `quant_matmul_forward` returns
// cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TI = 1024;        // K tile (the JAX layout's contraction tile)
constexpr int GROUP = 128;      // int4 scale group along K
constexpr int ROWS = 32;        // output features per block, one per lane
constexpr int WARPS = 8;
constexpr int NTHREADS = 32 * WARPS;

static_assert(TI % (16 * WARPS) == 0, "int8: whole 16-byte loads per warp");
static_assert((TI / 2) % (16 * WARPS) == 0, "int4: whole 16-byte loads per warp");
static_assert((TI / 2 / WARPS) <= GROUP, "int4: a warp's slice stays in one group");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// 16 int8 weights of a 16-byte word, as f32
__device__ __forceinline__ void unpack_i8(const uint4 w, float f[16]) {
    const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
            f[4 * i + j] = (float)(int8_t)((words[i] >> (8 * j)) & 0xffu);
}

// 16 bytes of packed nibbles: lo[t] = sign-extended low nibble of byte t,
// hi[t] = the high nibble (the byte's arithmetic shift right by 4)
__device__ __forceinline__ void unpack_i4(const uint4 w, float lo[16], float hi[16]) {
    const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int32_t b = (int32_t)(int8_t)((words[i] >> (8 * j)) & 0xffu);
            lo[4 * i + j] = (float)((b << 28) >> 28);
            hi[4 * i + j] = (float)(b >> 4);
        }
}

template <typename T, int NB, bool INT4>
__global__ void __launch_bounds__(NTHREADS)
quant_mm(const T* __restrict__ x, const int8_t* __restrict__ q,
         const float* __restrict__ s, const float* __restrict__ bias,
         T* __restrict__ out, int N, int K, int Kp, int O, int Op) {
    extern __shared__ float4 smem4[];
    float* xs = reinterpret_cast<float*>(smem4);          // [NB][TI]

    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int o = blockIdx.x * ROWS + lane;                 // < Op: Op % 256 == 0
    const int n0 = blockIdx.y * NB;
    const int8_t* qrow = q + (size_t)o * (INT4 ? Kp / 2 : Kp);

    float acc[NB];
#pragma unroll
    for (int n = 0; n < NB; ++n) acc[n] = 0.f;

    for (int k0 = 0; k0 < Kp; k0 += TI) {
        __syncthreads();                  // the last tile's reads of xs are done
        for (int i = threadIdx.x; i < NB * TI / 4; i += NTHREADS) {
            const int r = i / (TI / 4), c = (i % (TI / 4)) * 4;
            const int n = n0 + r;
            float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
            if (n < N) {
                const T* xr = x + (size_t)n * K + k0 + c;
                const int left = K - (k0 + c);
                if (left > 0) v.x = to_f32(xr[0]);
                if (left > 1) v.y = to_f32(xr[1]);
                if (left > 2) v.z = to_f32(xr[2]);
                if (left > 3) v.w = to_f32(xr[3]);
            }
            reinterpret_cast<float4*>(xs + r * TI)[c / 4] = v;
        }
        __syncthreads();

        if (!INT4) {
            constexpr int PER = TI / WARPS / 16;          // 16-byte words per lane
            const int kw = warp * (TI / WARPS);
            const uint4* src = reinterpret_cast<const uint4*>(qrow + k0 + kw);
            uint4 w[PER];
#pragma unroll
            for (int j = 0; j < PER; ++j) w[j] = __ldg(src + j);
#pragma unroll
            for (int j = 0; j < PER; ++j) {
                float f[16];
                unpack_i8(w[j], f);
#pragma unroll
                for (int n = 0; n < NB; ++n) {
                    const float4* xr = reinterpret_cast<const float4*>(xs + n * TI + kw + 16 * j);
                    float a = acc[n];
#pragma unroll
                    for (int t = 0; t < 4; ++t) {
                        const float4 xv = xr[t];
                        a = fmaf(xv.x, f[4 * t + 0], a);
                        a = fmaf(xv.y, f[4 * t + 1], a);
                        a = fmaf(xv.z, f[4 * t + 2], a);
                        a = fmaf(xv.w, f[4 * t + 3], a);
                    }
                    acc[n] = a;
                }
            }
        } else {
            constexpr int SLICE = TI / 2 / WARPS;          // packed bytes per warp
            constexpr int PER = SLICE / 16;
            const int pw = warp * SLICE;                   // byte offset in the tile
            const uint4* src = reinterpret_cast<const uint4*>(qrow + k0 / 2 + pw);
            uint4 w[PER];
#pragma unroll
            for (int j = 0; j < PER; ++j) w[j] = __ldg(src + j);
            // low nibbles are elements k0+pw.., high ones k0+512+pw..: one
            // group each, since a slice lies inside one group of 128
            const float s_lo = __ldg(s + (size_t)((k0 + pw) / GROUP) * Op + o);
            const float s_hi = __ldg(s + (size_t)((k0 + TI / 2 + pw) / GROUP) * Op + o);
            float t_lo[NB], t_hi[NB];
#pragma unroll
            for (int n = 0; n < NB; ++n) t_lo[n] = t_hi[n] = 0.f;
#pragma unroll
            for (int j = 0; j < PER; ++j) {
                float lo[16], hi[16];
                unpack_i4(w[j], lo, hi);
#pragma unroll
                for (int n = 0; n < NB; ++n) {
                    const float4* xl = reinterpret_cast<const float4*>(xs + n * TI + pw + 16 * j);
                    const float4* xh = reinterpret_cast<const float4*>(xs + n * TI + TI / 2 + pw + 16 * j);
                    float a = t_lo[n], c = t_hi[n];
#pragma unroll
                    for (int t = 0; t < 4; ++t) {
                        const float4 u = xl[t], v = xh[t];
                        a = fmaf(u.x, lo[4 * t + 0], a);
                        a = fmaf(u.y, lo[4 * t + 1], a);
                        a = fmaf(u.z, lo[4 * t + 2], a);
                        a = fmaf(u.w, lo[4 * t + 3], a);
                        c = fmaf(v.x, hi[4 * t + 0], c);
                        c = fmaf(v.y, hi[4 * t + 1], c);
                        c = fmaf(v.z, hi[4 * t + 2], c);
                        c = fmaf(v.w, hi[4 * t + 3], c);
                    }
                    t_lo[n] = a;
                    t_hi[n] = c;
                }
            }
#pragma unroll
            for (int n = 0; n < NB; ++n)
                acc[n] = fmaf(s_lo, t_lo[n], fmaf(s_hi, t_hi[n], acc[n]));
        }
    }

    // add the 8 warps' partial sums (xs is free again after the barrier)
    __syncthreads();
    float* red = xs;                                       // [WARPS][NB][32]
#pragma unroll
    for (int n = 0; n < NB; ++n) red[(warp * NB + n) * 32 + lane] = acc[n];
    __syncthreads();
    for (int i = threadIdx.x; i < NB * 32; i += NTHREADS) {
        const int n = i / 32, l = i % 32;
        float v = 0.f;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) v += red[(w * NB + n) * 32 + l];
        const int oo = blockIdx.x * ROWS + l, nn = n0 + n;
        if (nn < N && oo < O) {
            if (!INT4) v *= __ldg(s + oo);
            if (bias != nullptr) v += __ldg(bias + oo);
            from_f32(out + (size_t)nn * O + oo, v);
        }
    }
}

template <typename T, int NB, bool INT4>
constexpr size_t smem_bytes() { return (size_t)NB * TI * sizeof(float); }

template <typename T, int NB, bool INT4>
cudaError_t set_smem() {
    return cudaFuncSetAttribute(quant_mm<T, NB, INT4>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem_bytes<T, NB, INT4>());
}

template <typename T, bool INT4>
cudaError_t prepare_all() {
    cudaError_t e;
    if ((e = set_smem<T, 1, INT4>()) != cudaSuccess) return e;
    if ((e = set_smem<T, 2, INT4>()) != cudaSuccess) return e;
    if ((e = set_smem<T, 4, INT4>()) != cudaSuccess) return e;
    if ((e = set_smem<T, 8, INT4>()) != cudaSuccess) return e;
    return set_smem<T, 16, INT4>();
}

template <typename T, int NB, bool INT4>
cudaError_t launch(const void* x, const void* q, const void* s, const void* bias,
                   void* out, int N, int K, int Kp, int O, int Op, cudaStream_t stream) {
    const dim3 grid(Op / ROWS, (N + NB - 1) / NB);
    quant_mm<T, NB, INT4><<<grid, NTHREADS, smem_bytes<T, NB, INT4>(), stream>>>(
        static_cast<const T*>(x), static_cast<const int8_t*>(q),
        static_cast<const float*>(s), static_cast<const float*>(bias),
        static_cast<T*>(out), N, K, Kp, O, Op);
    return cudaGetLastError();
}

template <typename T, bool INT4>
cudaError_t dispatch(const void* x, const void* q, const void* s, const void* bias,
                     void* out, int N, int K, int Kp, int O, int Op, cudaStream_t st) {
    if (N <= 1) return launch<T, 1, INT4>(x, q, s, bias, out, N, K, Kp, O, Op, st);
    if (N <= 2) return launch<T, 2, INT4>(x, q, s, bias, out, N, K, Kp, O, Op, st);
    if (N <= 4) return launch<T, 4, INT4>(x, q, s, bias, out, N, K, Kp, O, Op, st);
    if (N <= 8) return launch<T, 8, INT4>(x, q, s, bias, out, N, K, Kp, O, Op, st);
    return launch<T, 16, INT4>(x, q, s, bias, out, N, K, Kp, O, Op, st);
}

}  // namespace

// Once per device, before its first quant_matmul_forward: the 16-row
// variants use 64 KB of dynamic shared memory. Returns a cudaError_t.
extern "C" int quant_matmul_prepare() {
    cudaError_t e;
    if ((e = prepare_all<float, false>()) != cudaSuccess) return (int)e;
    if ((e = prepare_all<float, true>()) != cudaSuccess) return (int)e;
    if ((e = prepare_all<__nv_bfloat16, false>()) != cudaSuccess) return (int)e;
    return (int)prepare_all<__nv_bfloat16, true>();
}

// x [N, K], q (int8 [Op, Kp] | packed int4 [Op, Kp/2]), s (int8 [1, Op] |
// int4 [Kp/128, Op]), bias [O] f32 or null, out [N, O]. int4 = 0 | 1,
// dtype 0 = f32, 1 = bf16 (x and out). Kp % 1024 == 0, Op % 256 == 0,
// K <= Kp, O <= Op (the wrapper checks). Returns a cudaError_t.
extern "C" int quant_matmul_forward(const void* x, const void* q, const void* s,
                                    const void* bias, void* out, int N, int K,
                                    int Kp, int O, int Op, int int4, int dtype,
                                    void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (N <= 0 || O <= 0) return (int)cudaSuccess;
    if (dtype == 0)
        return (int)(int4 ? dispatch<float, true>(x, q, s, bias, out, N, K, Kp, O, Op, st)
                          : dispatch<float, false>(x, q, s, bias, out, N, K, Kp, O, Op, st));
    if (dtype == 1)
        return (int)(int4 ? dispatch<__nv_bfloat16, true>(x, q, s, bias, out, N, K, Kp, O, Op, st)
                          : dispatch<__nv_bfloat16, false>(x, q, s, bias, out, N, K, Kp, O, Op, st));
    return (int)cudaErrorInvalidValue;
}
