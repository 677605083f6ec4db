// GQA decode attention for Hopper (sm_90a): the C entry points and the
// exact instances of the narrow widths (64, 128) of the kernels in
// decode_attention.cuh, which says what they compute, what bounds them and
// how. Replaces four Pallas TPU kernels of clearcam_tpu/ops/decode_attention.py
// (`decode_attention`, `decode_attention_q8`, `decode_attention_batch`,
// `decode_attention_batch_q8`).

#include "decode_attention.cuh"

using decode_attention_cu::Part;

const Part decode_attention_cu::exact_narrow = make_part<false>(Narrow{});

// Once per device, before its first decode_attention_forward: the dynamic
// shared-memory limit of every instance (most pass 48 KB).
extern "C" int decode_attention_prepare() {
    using namespace decode_attention_cu;
    for (const Part* part : {&exact_narrow, &exact_wide, &padded_narrow, &padded_wide})
        if (const cudaError_t e = part->prepare(); e != cudaSuccess) return (int)e;
    return (int)cudaSuccess;
}

// q [B, H, D], k and v [B, KvH, S, D] contiguous, out [B, H, D]; ks and vs
// [B, KvH, S] f32 for an int8 cache (null otherwise); pos and pads [B] int32
// on the card, or null for pos0 and pad0 in every row; part_acc [B, H, splits, D] and part_ml [B, H, splits, 2] f32
// scratch; counters int32, zero, at least B x KvH x ceil(rep / heads) of
// them (left zero); the wrapper's plan: chunk a multiple of the path's tile
// (32, tc: 64), splits = max(1, ceil(S / chunk)) <= 64, heads the query
// heads a block takes (1, 2, 4 or 8, 4 at most at D > 128; tc: 16), tc the
// path (1: tensor cores, bf16 and int8 caches only); D a multiple of 8 up to
// MAX_D; H % KvH == 0. qdtype (q and out): 0 = f32, 1 = bf16; cdtype (k, v): 0 =
// f32, 1 = bf16, 2 = int8. One launch on `stream`; returns a cudaError_t.
extern "C" int decode_attention_forward(const void* q, const void* k, const void* v,
                                        const void* ks, const void* vs, void* out,
                                        const void* pos, const void* pads, int pos0, int pad0,
                                        void* part_acc, void* part_ml, void* counters, int B,
                                        int H, int KvH,
                                        int S, int D, int chunk, int splits, int heads, int tc,
                                        float scale, int qdtype, int cdtype, void* stream) {
    if (B <= 0) return (int)cudaSuccess;
    const int tile = tc ? TC_TILE : TILE;
    const int want_splits = S > chunk ? (S + chunk - 1) / chunk : 1;
    if (KvH <= 0 || H <= 0 || H % KvH || D <= 0 || D > MAX_D || D % D_STEP || S < 0 ||
        chunk <= 0 || chunk % tile || splits != want_splits || splits > MAX_SPLITS || heads <= 0 ||
        part_acc == nullptr || part_ml == nullptr || counters == nullptr ||
        (qdtype != 0 && qdtype != 1) || (cdtype == 2 && (ks == nullptr || vs == nullptr)))
        return (int)cudaErrorInvalidValue;
    const int rep = H / KvH;
    const Params p{q, qdtype, k, v, static_cast<const float*>(ks), static_cast<const float*>(vs),
                   static_cast<const int*>(pos), static_cast<const int*>(pads), pos0, pad0, out,
                   static_cast<float*>(part_acc), static_cast<float*>(part_ml),
                   static_cast<int*>(counters), B, H, KvH, S, D, rep, heads,
                   (rep + heads - 1) / heads, chunk, splits, scale};
    using namespace decode_attention_cu;
    const bool wide = D > NARROW_MAX;
    const Part& part = has_dim(D, HeadDims{}) ? (wide ? exact_wide : exact_narrow)
                                             : (wide ? padded_wide : padded_narrow);
    return (int)part.launch(p, cdtype, tc, static_cast<cudaStream_t>(stream));
}
