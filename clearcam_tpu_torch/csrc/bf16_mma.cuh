// Helpers the port's tensor-core kernels share (vit_attention.cu,
// decode_attention.cu): cp.async copies into shared memory, ldmatrix,
// `mma.sync.m16n8k16` bf16 with f32 accumulators, and f32 values split
// into bf16 terms (an f32 product from bf16 products).
//
// Everything here is in an anonymous namespace: each .cu that includes it
// gets its own copy, and the sources compile apart (ops/_build.py).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// cp.async: 16 (cp16), 8 (cp8) or 4 (cp4) bytes from global to shared
// memory, zero-filled when !on (nothing is read then)
__device__ __forceinline__ void cp16(void* dst, const void* src, bool on) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(s), "l"(src), "r"(on ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp8(void* dst, const void* src, bool on) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
                 :: "r"(s), "l"(src), "r"(on ? 8 : 0) : "memory");
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

__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const void* p) {
    const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}
__device__ __forceinline__ void ldsm4t(uint32_t (&r)[4], const void* p) {
    const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
    // not volatile: the compiler may interleave independent MMAs
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ float bf_lo(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf_hi(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }

// (x, y) -> N bf16 terms, each a packed pair: term i is bf16 (rounded to
// nearest) of what the terms before it left. For p.
template <int N>
__device__ __forceinline__ void split2(float x, float y, uint32_t (&out)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
        out[i] = pack_bf16(x, y);
        if (i + 1 < N) {
            x -= bf_lo(out[i]);
            y -= bf_hi(out[i]);
        }
    }
}

// (x, y) -> N bf16 terms cut toward zero: term i is the top 16 bits of
// what the terms before it left, so with N = 3 the sum is exact (3 x 8
// significant bits hold an f32's 24) and nothing is converted: a byte
// permute packs each pair, an AND and a subtraction (exact) leave the rest.
// For q, k, v.
template <int N>
__device__ __forceinline__ void cut2(float x, float y, uint32_t (&out)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
        out[i] = __byte_perm(__float_as_uint(x), __float_as_uint(y), 0x7632);
        if (i + 1 < N) {
            x -= __uint_as_float(__float_as_uint(x) & 0xffff0000u);
            y -= __uint_as_float(__float_as_uint(y) & 0xffff0000u);
        }
    }
}

}  // namespace
