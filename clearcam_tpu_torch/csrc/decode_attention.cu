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
// Replaces: clearcam_tpu/ops/decode_attention.py `decode_attention_batch`
// -> `_batch_kernel` (f32/bf16 caches) and `decode_attention_batch_q8` ->
// `_batch_kernel_q8` (int8 caches), the Pallas TPU kernels of batched decode;
// and, launched with B = 1 and no pads, `decode_attention` ->
// `_chunked_kernel` and `decode_attention_q8` -> `_chunked_kernel_q8`, the
// single-stream ones (the same function at B = 1). The TPU's batch kernel
// walks every row from min(pads) to max(pos); here each block walks only
// its own row's window, so a slot parked at position 0 reads one tile and a
// long slot does not make the short ones read its length.
//
// Layouts: q [B, H, D] and out [B, H, D] f32 or bf16 (out in q's type);
// k, v [B, KvH, S, D] f32, bf16 or int8, contiguous; with int8, ks and vs
// [B, KvH, S] f32; pos, pads [B] int32 on the card. D = 128; rep = H / KvH
// <= 8. Any S (the TPU's S % 256 guarded its DMA, not the math).
//
// What bounds it: the bytes of the live K and V (a decode step reads each
// cached element once and does 2 * rep FLOPs per element), so HBM
// bandwidth. int8 halves those bytes against bf16 and adds 8 bytes of
// scales per position and KV head. At 8 slots x 8 KV heads there are 64
// blocks for 132 SMs, and one stream has 8: the card is not filled, and
// per-SM load concurrency sets the rate. The next design step is splitting
// each row's window over several blocks (flash-decoding) with a second pass
// to merge the partial softmaxes.
//
// Design: one block of 256 threads (8 warps) per (KV head, row). The
// window is walked in tiles of 64 positions. Each warp holds the rep
// query rows (pre-scaled, f32) in registers, 4 dims per lane, and scores
// 8 positions of the tile: 4 products per lane and a shuffle reduction.
// The V tile is staged in shared memory as f32. The next tile's K and V
// (and scales) are loaded into registers while this tile's softmax and PV
// product run. int8 is widened to f32 only in registers: K's scale
// multiplies the reduced score, V's scale the probability written for the
// PV product (the running sum l takes the unscaled probability), so no
// dequantized tile is written anywhere. Warp r keeps row r's running max
// and sum (online softmax in f32); the PV product runs with thread
// (d = tid % 128) owning output dim d of rows tid / 128, tid / 128 + 2, ...
// A tile always holds at least one live column (tiles run from the one
// holding pads[b] to the one holding pos[b]), and the max is still shifted
// by a finite value if not, so no exp(-inf - -inf) is taken. A row with no
// live column (pads > pos) gets zeros. Static shared memory (34.9 KB); the
// kernel allocates nothing; `decode_attention_forward` returns
// cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int D = 128;
constexpr int TILE = 64;
constexpr int WARPS = 8;
constexpr int NTHREADS = 32 * WARPS;
constexpr int MAXR = 8;                      // rep = H / KvH <= 8
constexpr int PER_WARP = TILE / WARPS;       // positions scored per warp
constexpr int VLOADS = TILE * D / 4 / NTHREADS;   // 4-element V loads per thread

static_assert(D == 4 * 32, "a warp covers D with 4 dims per lane");
static_assert(NTHREADS == 2 * D, "two row groups in the PV product");
static_assert(TILE == 64, "the softmax pass takes 2 scores per lane");

// 4 consecutive cache elements as loaded (16 bytes f32, 8 bytes bf16)
template <typename T> struct Raw4;
template <> struct Raw4<float> {
    float4 v;
    __device__ __forceinline__ void load(const float* p) { v = __ldg(reinterpret_cast<const float4*>(p)); }
    __device__ __forceinline__ void zero() { v = make_float4(0.f, 0.f, 0.f, 0.f); }
    __device__ __forceinline__ float4 f() const { return v; }
};
template <> struct Raw4<__nv_bfloat16> {
    uint2 v;
    __device__ __forceinline__ void load(const __nv_bfloat16* p) { v = __ldg(reinterpret_cast<const uint2*>(p)); }
    __device__ __forceinline__ void zero() { v = make_uint2(0u, 0u); }
    __device__ __forceinline__ float4 f() const {
        const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&v.x);
        const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&v.y);
        const float2 fa = __bfloat1622float2(a), fb = __bfloat1622float2(b);
        return make_float4(fa.x, fa.y, fb.x, fb.y);
    }
};

template <> struct Raw4<int8_t> {
    int v;
    __device__ __forceinline__ void load(const int8_t* p) { v = __ldg(reinterpret_cast<const int*>(p)); }
    __device__ __forceinline__ void zero() { v = 0; }
    __device__ __forceinline__ float4 f() const {
        const char4 c = *reinterpret_cast<const char4*>(&v);
        return make_float4((float)c.x, (float)c.y, (float)c.z, (float)c.w);
    }
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}

// K: warp w reads positions t0 + w + 8i (4 dims per lane); V: the tile's
// TILE x D elements, 4 per load, consecutive threads on consecutive dims.
// With Q8, each lane also takes K's scale of its warp's 8 positions and V's
// scale of positions t0 + lane and t0 + lane + 32 (the softmax pass's).
template <typename TC, bool Q8>
__device__ __forceinline__ void load_tile(const TC* kb, const TC* vb, const float* ksb,
                                          const float* vsb, int t0, int S, int warp, int lane,
                                          Raw4<TC> (&kr)[PER_WARP], Raw4<TC> (&vr)[VLOADS],
                                          float (&ksr)[PER_WARP], float (&vsr)[2]) {
#pragma unroll
    for (int i = 0; i < PER_WARP; ++i) {
        const int t = t0 + warp + WARPS * i;
        if (t < S) kr[i].load(kb + (size_t)t * D + 4 * lane);
        else kr[i].zero();
        if (Q8) ksr[i] = t < S ? __ldg(ksb + t) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < VLOADS; ++j) {
        const int e = threadIdx.x + NTHREADS * j;           // 4-element index
        const int t = t0 + e / (D / 4);
        if (t < S) vr[j].load(vb + (size_t)t * D + 4 * (e % (D / 4)));
        else vr[j].zero();                                  // 0 * garbage could be NaN
    }
    if (Q8) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
            const int t = t0 + lane + 32 * c;
            vsr[c] = t < S ? __ldg(vsb + t) : 0.f;
        }
    }
}

template <typename TQ, typename TC, bool Q8>
__global__ void __launch_bounds__(NTHREADS)
decode_attn(const TQ* __restrict__ q, const TC* __restrict__ k, const TC* __restrict__ v,
            const float* __restrict__ ks, const float* __restrict__ vs_scale,
            TQ* __restrict__ out, const int* __restrict__ pos, const int* __restrict__ pads,
            int H, int KvH, int S, float scale) {
    __shared__ __align__(16) float vs[TILE][D];
    __shared__ float ps[MAXR][TILE];
    __shared__ float alpha_s[MAXR], l_s[MAXR];

    const int g = blockIdx.x, b = blockIdx.y;
    const int rep = H / KvH;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int d = threadIdx.x % D, half = threadIdx.x / D;
    const int lo = max(__ldg(pads + b), 0);
    const int hi = min(__ldg(pos + b), S - 1);
    const size_t off = ((size_t)b * KvH + g) * S * D;
    const TC* kb = k + off;
    const TC* vb = v + off;
    const float* ksb = Q8 ? ks + off / D : nullptr;
    const float* vsb = Q8 ? vs_scale + off / D : nullptr;
    const TQ* qb = q + ((size_t)b * H + (size_t)g * rep) * D;
    TQ* ob = out + ((size_t)b * H + (size_t)g * rep) * D;

    if (lo > hi) {                                          // no live column
        for (int i = threadIdx.x; i < rep * D; i += NTHREADS) store(ob + i, 0.f);
        return;
    }

    float qr[MAXR][4];
#pragma unroll
    for (int r = 0; r < MAXR; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c)
            qr[r][c] = r < rep ? to_f32(qb[r * D + 4 * lane + c]) * scale : 0.f;

    float m = -CUDART_INF_F, l = 0.f;                       // row `warp`'s softmax state
    float acc[MAXR / 2];
#pragma unroll
    for (int i = 0; i < MAXR / 2; ++i) acc[i] = 0.f;

    Raw4<TC> kr[PER_WARP], vr[VLOADS];
    float ksr[PER_WARP], vsr[2];
    int t0 = lo / TILE * TILE;
    load_tile<TC, Q8>(kb, vb, ksb, vsb, t0, S, warp, lane, kr, vr, ksr, vsr);

    for (; t0 <= hi; t0 += TILE) {
#pragma unroll
        for (int j = 0; j < VLOADS; ++j) {
            const int e = threadIdx.x + NTHREADS * j;
            *reinterpret_cast<float4*>(&vs[e / (D / 4)][4 * (e % (D / 4))]) = vr[j].f();
        }
#pragma unroll
        for (int i = 0; i < PER_WARP; ++i) {
            const int tt = warp + WARPS * i, t = t0 + tt;
            const bool live = t >= lo && t <= hi;
            const float4 kv = kr[i].f();
#pragma unroll
            for (int r = 0; r < MAXR; ++r) {
                if (r < rep) {
                    float s = qr[r][0] * kv.x + qr[r][1] * kv.y + qr[r][2] * kv.z + qr[r][3] * kv.w;
                    s = warp_sum(s);
                    if (Q8) s *= ksr[i];                    // dequantize K on the score
                    if (lane == 0) ps[r][tt] = live ? s : -CUDART_INF_F;
                }
            }
        }
        // this tile's V scales, before the next tile's load takes vsr
        const float vs0 = Q8 ? vsr[0] : 1.f, vs1 = Q8 ? vsr[1] : 1.f;
        if (t0 + TILE <= hi)                                // next tile in flight
            load_tile<TC, Q8>(kb, vb, ksb, vsb, t0 + TILE, S, warp, lane, kr, vr, ksr, vsr);
        __syncthreads();

        if (warp < rep) {                                   // online softmax, row `warp`
            const float s0 = ps[warp][lane], s1 = ps[warp][lane + 32];
            const float m_new = fmaxf(m, warp_max(fmaxf(s0, s1)));
            const float m_safe = isfinite(m_new) ? m_new : 0.f;
            const float p0 = expf(s0 - m_safe), p1 = expf(s1 - m_safe);
            const float a = expf(m - m_safe);
            l = l * a + warp_sum(p0 + p1);
            m = m_new;
            ps[warp][lane] = Q8 ? p0 * vs0 : p0;        // dequantize V on the probability
            ps[warp][lane + 32] = Q8 ? p1 * vs1 : p1;
            if (lane == 0) alpha_s[warp] = a;
        }
        __syncthreads();

#pragma unroll
        for (int i = 0; i < MAXR / 2; ++i) {
            const int r = half + 2 * i;
            if (r < rep) {
                float a = acc[i] * alpha_s[r];
#pragma unroll 16
                for (int tt = 0; tt < TILE; ++tt) a = fmaf(ps[r][tt], vs[tt][d], a);
                acc[i] = a;
            }
        }
        __syncthreads();                                    // vs, ps free for the next tile
    }

    if (warp < rep && lane == 0) l_s[warp] = l;
    __syncthreads();
#pragma unroll
    for (int i = 0; i < MAXR / 2; ++i) {
        const int r = half + 2 * i;
        if (r < rep) store(ob + r * D + d, acc[i] / l_s[r]);
    }
}

template <typename TQ, typename TC, bool Q8>
cudaError_t launch(const void* q, const void* k, const void* v, const float* ks, const float* vs,
                   void* out, const int* pos, const int* pads, int B, int H, int KvH, int S,
                   float scale, cudaStream_t st) {
    decode_attn<TQ, TC, Q8><<<dim3(KvH, B), NTHREADS, 0, st>>>(
        static_cast<const TQ*>(q), static_cast<const TC*>(k), static_cast<const TC*>(v), ks, vs,
        static_cast<TQ*>(out), pos, pads, H, KvH, S, scale);
    return cudaGetLastError();
}

}  // namespace

// q [B, H, 128], k and v [B, KvH, S, 128] contiguous, out [B, H, 128];
// ks and vs [B, KvH, S] f32 for an int8 cache (null otherwise); pos and
// pads [B] int32 on the card; H % KvH == 0 and H / KvH <= 8 (the wrapper
// checks). qdtype (q and out): 0 = f32, 1 = bf16; cdtype (k, v): 0 = f32,
// 1 = bf16, 2 = int8. Returns a cudaError_t.
extern "C" int decode_attention_forward(const void* q, const void* k, const void* v,
                                        const void* ks, const void* vs, void* out,
                                        const void* pos, const void* pads, int B, int H,
                                        int KvH, int S, float scale, int qdtype, int cdtype,
                                        void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int* p = static_cast<const int*>(pos);
    const int* pd = static_cast<const int*>(pads);
    const float* fks = static_cast<const float*>(ks);
    const float* fvs = static_cast<const float*>(vs);
    if (B <= 0) return (int)cudaSuccess;
    if (cdtype == 2 && (fks == nullptr || fvs == nullptr)) return (int)cudaErrorInvalidValue;
#define CC_LAUNCH(TQ, TC, Q8) \
    return (int)launch<TQ, TC, Q8>(q, k, v, fks, fvs, out, p, pd, B, H, KvH, S, scale, st)
    if (qdtype == 0 && cdtype == 0) CC_LAUNCH(float, float, false);
    if (qdtype == 0 && cdtype == 1) CC_LAUNCH(float, __nv_bfloat16, false);
    if (qdtype == 1 && cdtype == 0) CC_LAUNCH(__nv_bfloat16, float, false);
    if (qdtype == 1 && cdtype == 1) CC_LAUNCH(__nv_bfloat16, __nv_bfloat16, false);
    if (qdtype == 0 && cdtype == 2) CC_LAUNCH(float, int8_t, true);
    if (qdtype == 1 && cdtype == 2) CC_LAUNCH(__nv_bfloat16, int8_t, true);
#undef CC_LAUNCH
    return (int)cudaErrorInvalidValue;
}
