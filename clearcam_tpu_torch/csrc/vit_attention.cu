// Non-causal multi-head attention for ViT towers, as one kernel for Hopper
// (sm_90a):
//
//   out[b,h] = softmax(q[b,h] k[b,h]^T * scale) v[b,h]      over all T keys
//
// Replaces: clearcam_tpu/ops/vit_attention.py `mha_flash` (the stock Pallas
// TPU flash kernel). The TPU wrapper pads T to a multiple of 128 and masks
// the pad with segment ids; the result is unpadded attention, and that is
// what this kernel computes, with the tail masked in the kernel and
// nothing padded in memory. T is 257 for CLIP ViT-L/14 (256 patches + cls)
// and 784 or 1600 for the Qwen3-VL vision tower.
//
//   q, k, v  [B,H,T,64] views, f32 or bf16, any strides with the last one 1
//            and the others multiples of 4 elements (so a head of the fused
//            qkv projection is read in place); 16-byte (f32) or 8-byte
//            (bf16) aligned base pointers
//   out      [B,H,T,64] view in the same type (the wrapper hands a
//            [B,T,H,64] buffer, so merging the heads afterwards is free)
//
// Numerics: products, the running max, the running sum and the output
// accumulate in f32; scale * log2(e) is folded into q as it is staged, and
// the exponentials are exp2f. The probabilities stay f32 (the plain version
// rounds them to v's type before the PV product, which in bf16 is one
// rounding more).
//
// What bounds it: per (b, h) it does 4*T^2*64 FLOP on 3*T*64 inputs; at
// T = 257 that is ~330 FLOP per f32 byte read, so it is bound by arithmetic,
// not by HBM. The plain version writes and re-reads the f32 [B,H,T,T]
// scores and probabilities (~17 MB per image for ViT-L/14's 16 heads,
// per layer); this kernel keeps them in registers and shared memory. On the
// CUDA cores (this version) it is bound by the FMA rate and by the
// shared-memory loads that feed it: every 64 FMAs of a thread take 8
// 16-byte shared loads, half of them broadcasts. Tensor cores (mma / wgmma),
// TMA and warp specialisation are later work.
//
// Design: one block of 256 threads per (b, h, 64 query rows).
//   1. stage the 64 x 64 Q tile into shared memory as f32, scaled;
//   2. for each 64-key tile: stage K and V (rows past T are zero), compute
//      the 64 x 64 scores, each thread a 4 x 4 patch (rows ty*4+i, columns
//      tx+16j: conflict-free float4 reads of K rows), mask columns past T to
//      -inf, update the running max over the 16 threads of a row (shuffles
//      within a half-warp), rescale the output and the partial sums, write
//      the probabilities to shared memory, then accumulate P V, each thread
//      4 rows x 4 output dims (float4 reads of P rows and V rows);
//   3. reduce the partial sums of each row over its 16 threads, divide, and
//      store the rows that lie inside T.
// Every key tile holds at least one key inside T, so every row max is
// finite and no masked tile makes a NaN; query rows past T compute on zero
// Q and are not stored.
// Shared memory: Q, K, V, P tiles of 64 x 68 floats = 69,632 bytes, above
// the 48 KB static limit: `vit_attention_prepare` raises
// cudaFuncAttributeMaxDynamicSharedMemorySize once per device.
//
// The kernel allocates nothing; the caller passes the output buffer and
// the stream. `vit_attention_forward` returns cudaGetLastError() after the
// launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int D = 64;           // head dim (CLIP ViT-L/14: 1024 / 16)
constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // keys per tile
constexpr int LD = D + 4;       // shared row stride in floats: float4-aligned,
                                // and rows 4 banks apart
constexpr int NTHREADS = 256;   // 16 x 16 threads: ty -> 4 rows, tx -> 4 columns
constexpr int TILE = BQ * LD;
constexpr size_t SMEM_BYTES = 4 * TILE * sizeof(float);
constexpr float LOG2E = 1.4426950408889634f;

static_assert(BQ == BK && BQ == 4 * 16 && D == 4 * 16, "thread mapping");
static_assert(LD % 4 == 0, "float4 shared loads");

__device__ __forceinline__ float4 load4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
    *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
    __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
    __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
    uint2 raw;
    raw.x = *reinterpret_cast<uint32_t*>(&lo);
    raw.y = *reinterpret_cast<uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(p) = raw;
}

// rows [0, nrows) of a 64 x 64 tile (row stride `st` elements) -> shared
// f32, times `mul`; rows past nrows are zero. 16 threads per row, 4
// elements each: coalesced reads, conflict-free float4 stores.
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* src, long long st,
                                      int nrows, float mul) {
#pragma unroll
    for (int it = 0; it < BQ * (D / 4) / NTHREADS; ++it) {
        const int i = threadIdx.x + it * NTHREADS;
        const int r = i >> 4, c = (i & 15) * 4;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (r < nrows) {
            v = load4(src + r * st + c);
            v.x *= mul; v.y *= mul; v.z *= mul; v.w *= mul;
        }
        store4(dst + r * LD + c, v);
    }
}

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
mha_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
        T* __restrict__ out, int H, int Tn,
        long long qsb, long long qsh, long long qst,
        long long ksb, long long ksh, long long kst,
        long long vsb, long long vsh, long long vst,
        long long osb, long long osh, long long ost, float q_mul) {
    extern __shared__ float4 smem4[];
    float* Qs = reinterpret_cast<float*>(smem4);
    float* Ks = Qs + TILE;
    float* Vs = Ks + TILE;
    float* Ps = Vs + TILE;

    const int b = blockIdx.y / H, h = blockIdx.y % H;
    const int q0 = blockIdx.x * BQ;
    const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
    const T* kp = k + b * ksb + h * ksh;
    const T* vp = v + b * vsb + h * vsh;

    stage(Qs, q + b * qsb + h * qsh + q0 * qst, qst, min(BQ, Tn - q0), q_mul);

    float o[4][4], m[4], l[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        m[i] = -INFINITY;
        l[i] = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) o[i][j] = 0.f;
    }

    for (int k0 = 0; k0 < Tn; k0 += BK) {
        const int nk = min(BK, Tn - k0);
        __syncthreads();                      // the last tile's K, V, P reads are done
        stage(Ks, kp + k0 * kst, kst, nk, 1.f);
        stage(Vs, vp + k0 * vst, vst, nk, 1.f);
        __syncthreads();

        // scores: rows ty*4+i, columns tx+16j (already in log2 units)
        float s[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll
        for (int d = 0; d < D; d += 4) {
            float4 qa[4], kb[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) qa[i] = load4(Qs + (ty * 4 + i) * LD + d);
#pragma unroll
            for (int j = 0; j < 4; ++j) kb[j] = load4(Ks + (tx + 16 * j) * LD + d);
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    float acc = s[i][j];
                    acc = fmaf(qa[i].x, kb[j].x, acc);
                    acc = fmaf(qa[i].y, kb[j].y, acc);
                    acc = fmaf(qa[i].z, kb[j].z, acc);
                    acc = fmaf(qa[i].w, kb[j].w, acc);
                    s[i][j] = acc;
                }
        }

        // online softmax over this tile
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            float mx = -INFINITY;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                if (tx + 16 * j >= nk) s[i][j] = -INFINITY;
                mx = fmaxf(mx, s[i][j]);
            }
            const float m_new = fmaxf(m[i], half_warp_max(mx));   // finite: nk >= 1
            const float alpha = exp2f(m[i] - m_new);               // 0 on the first tile
            float sum = 0.f;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const float p = exp2f(s[i][j] - m_new);
                sum += p;
                Ps[(ty * 4 + i) * LD + tx + 16 * j] = p;
            }
            l[i] = l[i] * alpha + sum;
            m[i] = m_new;
#pragma unroll
            for (int j = 0; j < 4; ++j) o[i][j] *= alpha;
        }
        __syncthreads();

        // o += P V: rows ty*4+i, output dims tx*4 .. tx*4+3
#pragma unroll 4
        for (int c = 0; c < BK; c += 4) {
            float4 pa[4], vb[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) pa[i] = load4(Ps + (ty * 4 + i) * LD + c);
#pragma unroll
            for (int cc = 0; cc < 4; ++cc) vb[cc] = load4(Vs + (c + cc) * LD + tx * 4);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const float p[4] = {pa[i].x, pa[i].y, pa[i].z, pa[i].w};
#pragma unroll
                for (int cc = 0; cc < 4; ++cc) {
                    o[i][0] = fmaf(p[cc], vb[cc].x, o[i][0]);
                    o[i][1] = fmaf(p[cc], vb[cc].y, o[i][1]);
                    o[i][2] = fmaf(p[cc], vb[cc].z, o[i][2]);
                    o[i][3] = fmaf(p[cc], vb[cc].w, o[i][3]);
                }
            }
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const float inv = 1.f / half_warp_sum(l[i]);
        const int row = q0 + ty * 4 + i;
        if (row < Tn)
            store4(out + b * osb + h * osh + row * ost + tx * 4,
                   make_float4(o[i][0] * inv, o[i][1] * inv, o[i][2] * inv, o[i][3] * inv));
    }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int H, int Tn, const long long* st, float scale,
                   cudaStream_t stream) {
    const dim3 grid((Tn + BQ - 1) / BQ, B * H);
    mha_fwd<T><<<grid, NTHREADS, SMEM_BYTES, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(out), H, Tn, st[0], st[1], st[2], st[3], st[4], st[5],
        st[6], st[7], st[8], st[9], st[10], st[11], scale * LOG2E);
    return cudaGetLastError();
}

}  // namespace

// Once per device, before its first vit_attention_forward: the kernel uses
// more than 48 KB of dynamic shared memory. Returns a cudaError_t.
extern "C" int vit_attention_prepare() {
    cudaError_t err = cudaFuncSetAttribute(
        mha_fwd<float>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaFuncSetAttribute(
        mha_fwd<__nv_bfloat16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)SMEM_BYTES);
}

// q, k, v, out: [B,H,T,64] views; strides: 12 element strides, (b, h, t)
// for q, k, v, out in that order. dtype 0 = f32, 1 = bf16. Returns a
// cudaError_t.
extern "C" int vit_attention_forward(const void* q, const void* k, const void* v,
                                     void* out, int B, int H, int T,
                                     const long long* strides, float scale,
                                     int dtype, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (T <= 0 || B <= 0 || H <= 0) return (int)cudaSuccess;
    if (dtype == 1)
        return (int)launch<__nv_bfloat16>(q, k, v, out, B, H, T, strides, scale, s);
    if (dtype == 0)
        return (int)launch<float>(q, k, v, out, B, H, T, strides, scale, s);
    return (int)cudaErrorInvalidValue;
}
