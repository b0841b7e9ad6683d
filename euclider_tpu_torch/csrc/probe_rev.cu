// probe_rev.cu - the reversible-march probe for Hopper (sm_90a).
//
// Replaces tools/mosaic_probe.py::_rev_kernel (probe 6 of the JAX package):
// the reverse sweep of the march backward (K4, trace_adj.cuh) in isolation.
// Per element of x: y = 2 x_T + v_T at the end of a done-masked leapfrog
// march of R_STEPS steps of size R_H from (0.3 x, 0.2 x + 0.1),
//   v' = v + h * 0.3 sin(w x);  x' = x + h v';  done once x' > 1,
// out = cos(y) + 0.25 y, and the VJP of out under the cotangent g,
// accumulated twice (the probe's loop of two jax.vjp calls): dx per element
// and dw summed over every element.
//
// The reverse sweep stores no step: the forward keeps (x, v) at the start
// of every chunk of R_CB steps; the reverse walks the chunks backwards and,
// inside a chunk, rebuilds each earlier state from the chunk's end state by
// inverting the step (x = x1 - h v1, v = v1 - h a(x)).  A step i is live
// iff i < n, n = round(dist / h) the steps the element walked, so the
// reverse needs no side test.  ops/probes.py::rev_march_plain is the plain
// version (autograd through the march).
//
// dw is summed without atomics: each thread sums its elements, the block
// sums its threads with warp shuffles and shared memory in a fixed order.
// One block: the probe's input is one (8, 128) tile.  What bounds it: the
// sinf/cosf work of 3 x R_STEPS steps per element, far below the card.
//
// Built like trace_fwd.cu: nvcc -gencode arch=compute_90a,code=sm_90a
// -std=c++17 -O3 -fmad=false, without --use_fast_math.

#include <cuda_runtime.h>

namespace {

constexpr int R_STEPS = 24;
constexpr int R_CB = 8;
constexpr int R_NB = (R_STEPS + R_CB - 1) / R_CB;
constexpr float R_H = 0.11f;
constexpr int REPEATS = 2;
constexpr int THREADS = 256;

__device__ __forceinline__ float accel(float x, float w) {
    return 0.3f * sinf(w * x);
}

// dx of one element (twice the VJP) and its share of dw
__device__ void element(float x, float w, float g, float* dx, float* dw) {
    const float h = R_H;
    float ckx[R_NB], ckv[R_NB];
    float xx = x * 0.3f, v = __fadd_rn(__fmul_rn(x, 0.2f), 0.1f);
    float dist = 0.0f;
    bool done = false;
    for (int b = 0; b < R_NB; ++b) {
        ckx[b] = xx;
        ckv[b] = v;
        for (int k = 0; k < R_CB && b * R_CB + k < R_STEPS; ++k) {
            if (done) break;
            const float v1 = __fadd_rn(v, __fmul_rn(h, accel(xx, w)));
            const float x1 = __fadd_rn(xx, __fmul_rn(h, v1));
            done = x1 > 1.0f;
            xx = x1;
            v = v1;
            dist = dist + h;
        }
    }
    const int n = (int)rintf(dist / h);
    const float y = __fadd_rn(__fmul_rn(xx, 2.0f), v);
    const float gy = g * (0.25f - sinf(y));
    float gx = 2.0f * gy, gv = gy, gw = 0.0f;
    for (int b = R_NB - 1; b >= 0; --b) {
        const int wb = min(R_CB, R_STEPS - b * R_CB);
        const int live = min(max(n - b * R_CB, 0), wb);
        if (live == 0) continue;
        // the state after the chunk's last live step
        float xc = b + 1 < R_NB && n > (b + 1) * R_CB ? ckx[b + 1] : xx;
        float vc = b + 1 < R_NB && n > (b + 1) * R_CB ? ckv[b + 1] : v;
        for (int j = 0; j < live; ++j) {
            // rebuild the state before the step from the state after it
            const float xp = __fsub_rn(xc, __fmul_rn(h, vc));
            const float s = sinf(w * xp), c = cosf(w * xp);
            const float vp = __fsub_rn(vc, __fmul_rn(h, 0.3f * s));
            // adjoint of v1 = vp + h a(xp), x1 = xp + h v1
            const float gv1 = gv + h * gx;
            const float ga = h * gv1;
            gx = gx + ga * 0.3f * c * w;
            gw += ga * 0.3f * c * xp;
            gv = gv1;
            xc = xp;
            vc = vp;
        }
    }
    // x0 = 0.3 x, v0 = 0.2 x + 0.1
    *dx = REPEATS * (0.3f * gx + 0.2f * gv);
    *dw = REPEATS * gw;
}

__global__ void __launch_bounds__(THREADS)
probe_rev_kernel(const float* __restrict__ x, float w,
                 const float* __restrict__ g, int n,
                 float* __restrict__ dx, float* __restrict__ dw) {
    float acc = 0.0f;
    for (int i = threadIdx.x; i < n; i += THREADS) {
        float dwi;
        element(x[i], w, g[i], dx + i, &dwi);
        acc += dwi;
    }
    __shared__ float red[THREADS / 32];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, o);
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = acc;
    __syncthreads();
    if (threadIdx.x == 0) {
        float s = 0.0f;
#pragma unroll
        for (int k = 0; k < THREADS / 32; ++k) s += red[k];
        *dw = s;
    }
}

}  // namespace

extern "C" int euclider_probe_rev(const float* x, float w, const float* g,
                                  int n, float* dx, float* dw, int device,
                                  void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (n <= 0) return (int)cudaErrorInvalidValue;
    probe_rev_kernel<<<1, THREADS, 0, (cudaStream_t)stream>>>(x, w, g, n, dx,
                                                              dw);
    return (int)cudaGetLastError();
}
