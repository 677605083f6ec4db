// FMA-rate probe for Hopper's CUDA cores (sm_90a): the output tile of the
// TPU's VPU probe,
//
//   acc_j = j;  ITERS / 8 times: acc_j = acc_j * c_j + x   (j = 0..7)
//   out = ((acc_0 + acc_1) + acc_2) + ... + acc_7          (in the tile's type)
//
// with c_j = 0.875 + 0.01 j rounded to the tile's type, over a [ROWS, 128]
// tile of f32 or bf16.
//
// Replaces: clearcam_tpu/tools/vpu_probe.py `measure` -> `_kernel`, the
// Pallas TPU kernel that measured the VPU's broadcast-FMA rate (a tile in
// VMEM, 8 independent chains). It computes the same tile; what it measures
// is the rate of the H100's CUDA cores, not the TPU's VPU layout.
//
// What bounds it: operations. One call is ROWS * 128 * ITERS multiply-adds
// (2.147 G at 512 x 128 x 32768) against 256 KB of input and output, so
// the data sheet's CUDA-core peak sets the least time: f32 67 TFLOP/s
// (33.5 T FMA/s, 0.064 ms a call), bf16 outside the tensor cores 133.8
// TFLOP/s (0.032 ms; one __hfma2 does two).
//
// Design: f32 takes one element per thread, 8 FFMA chains in registers
// with the constants as immediates; bf16 takes two elements per thread in
// an __nv_bfloat162 and runs 8 __hfma2 chains. 8 independent chains per
// thread cover the FMA pipe's latency, and 65,536 f32 (32,768 bf16x2)
// threads in blocks of 128 fill every SM with 15 (7) warps. The trip
// count is a runtime argument, so nvcc keeps the loop (unrolled 4 trips
// deep) rather than folding it; the chains are contractive (each converges
// to x / (1 - c_j), ~95 summed for x = 1), so no value runs away. The fold
// runs in the tile's type, left to right, and the tile is stored, so no
// chain is dead code.
//
// Numerics: FFMA rounds once, as XLA's CPU backend contracts the f32 body
// into an FMA; __hfma2 rounds once where the JAX package rounds the bf16
// product and the sum apart, so bf16 results may differ from the plain
// version by the last ulps of each chain's fixed point.
//
// The kernel allocates nothing; `vpu_probe_forward` returns
// cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int NTHREADS = 128;

__device__ __forceinline__ __nv_bfloat162 splat(float v) {
    return __bfloat162bfloat162(__float2bfloat16_rn(v));
}

}  // namespace

// c_j = 0.875 + 0.01 j, rounded from the double as jnp.asarray rounds it
#define PROBE_C(j) static_cast<float>(0.875 + 0.01 * (j))

// Unmangled names, so the SASS of each loop can be found by name
// (cuobjdump -sass -fun vpu_probe_f32).
extern "C" __global__ void __launch_bounds__(NTHREADS)
vpu_probe_f32(const float* __restrict__ x, float* __restrict__ out, int n, int trips) {
    const int i = blockIdx.x * NTHREADS + threadIdx.x;
    if (i >= n) return;
    const float xv = x[i];
    float a0 = 0.f, a1 = 1.f, a2 = 2.f, a3 = 3.f, a4 = 4.f, a5 = 5.f, a6 = 6.f, a7 = 7.f;
#pragma unroll 4
    for (int t = 0; t < trips; ++t) {
        a0 = fmaf(a0, PROBE_C(0), xv);
        a1 = fmaf(a1, PROBE_C(1), xv);
        a2 = fmaf(a2, PROBE_C(2), xv);
        a3 = fmaf(a3, PROBE_C(3), xv);
        a4 = fmaf(a4, PROBE_C(4), xv);
        a5 = fmaf(a5, PROBE_C(5), xv);
        a6 = fmaf(a6, PROBE_C(6), xv);
        a7 = fmaf(a7, PROBE_C(7), xv);
    }
    out[i] = ((((((a0 + a1) + a2) + a3) + a4) + a5) + a6) + a7;
}

// n2 = number of bf16 pairs
extern "C" __global__ void __launch_bounds__(NTHREADS)
vpu_probe_bf16(const __nv_bfloat162* __restrict__ x, __nv_bfloat162* __restrict__ out,
               int n2, int trips) {
    const int i = blockIdx.x * NTHREADS + threadIdx.x;
    if (i >= n2) return;
    const __nv_bfloat162 xv = x[i];
    const __nv_bfloat162 c0 = splat(PROBE_C(0)), c1 = splat(PROBE_C(1)),
                         c2 = splat(PROBE_C(2)), c3 = splat(PROBE_C(3)),
                         c4 = splat(PROBE_C(4)), c5 = splat(PROBE_C(5)),
                         c6 = splat(PROBE_C(6)), c7 = splat(PROBE_C(7));
    __nv_bfloat162 a0 = splat(0.f), a1 = splat(1.f), a2 = splat(2.f), a3 = splat(3.f),
                   a4 = splat(4.f), a5 = splat(5.f), a6 = splat(6.f), a7 = splat(7.f);
#pragma unroll 4
    for (int t = 0; t < trips; ++t) {
        a0 = __hfma2(a0, c0, xv);
        a1 = __hfma2(a1, c1, xv);
        a2 = __hfma2(a2, c2, xv);
        a3 = __hfma2(a3, c3, xv);
        a4 = __hfma2(a4, c4, xv);
        a5 = __hfma2(a5, c5, xv);
        a6 = __hfma2(a6, c6, xv);
        a7 = __hfma2(a7, c7, xv);
    }
    out[i] = __hadd2(__hadd2(__hadd2(__hadd2(__hadd2(__hadd2(__hadd2(a0, a1), a2), a3),
                                              a4), a5), a6), a7);
}

#undef PROBE_C

// x, out: n contiguous elements on the card; iters = FMAs per chain (a
// multiple of 8 per trip of the 8 chains: trips = iters / 8); dtype 0 =
// float32, 1 = bfloat16 (n even). Returns a cudaError_t (0 = success).
extern "C" int vpu_probe_forward(const void* x, void* out, int n, int iters, int dtype,
                                 void* stream) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (n <= 0 || iters < 0 || iters % 8 != 0) return (int)cudaErrorInvalidValue;
    const int trips = iters / 8;
    if (dtype == 0) {
        vpu_probe_f32<<<(n + NTHREADS - 1) / NTHREADS, NTHREADS, 0, s>>>(
            static_cast<const float*>(x), static_cast<float*>(out), n, trips);
    } else if (dtype == 1) {
        if (n % 2 != 0) return (int)cudaErrorInvalidValue;
        const int n2 = n / 2;
        vpu_probe_bf16<<<(n2 + NTHREADS - 1) / NTHREADS, NTHREADS, 0, s>>>(
            static_cast<const __nv_bfloat162*>(x), static_cast<__nv_bfloat162*>(out), n2,
            trips);
    } else {
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}
