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
// What bounds it: the sinf/cosf work of up to 3 x R_STEPS steps per
// element, far below the card; the probe's input is one (8, 128) tile, so
// its time is its longest lane's chain of dependent steps.  A lane a
// thread in one thread-block cluster of up to 8 blocks of 128
// (probe_cluster.cuh); dw is summed without atomics, in the cluster's
// fixed order (warp shuffles, the block's warps, the blocks' partials in
// rank order), so two launches give the same bits.  Measured on the H100
// (PERF.md §6) against its first design's one block of 256 threads
// walking 4 lanes each: 0.28x its time, within 1.1x of the tile's longest
// lane run alone; sincosf in the reverse step takes 12% off sinf and cosf
// apart (the same bits).  Not taken: 32 blocks of a warp whose last block
// adds the partials (2% slower), the chunk loops unrolled (13% slower:
// more local loads, not fewer).
//
// Built like trace_fwd.cu: nvcc -gencode arch=compute_90a,code=sm_90a
// -std=c++17 -O3 -fmad=false, without --use_fast_math.

#include "probe_cluster.cuh"

namespace {

constexpr int R_STEPS = 24;
constexpr int R_CB = 8;
constexpr int R_NB = (R_STEPS + R_CB - 1) / R_CB;
constexpr float R_H = 0.11f;
constexpr int REPEATS = 2;

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
            float s, c;   // one range reduction for both
            sincosf(w * xp, &s, &c);
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

// Lane blockIdx.x * CLUSTER_THREADS + threadIdx.x of the tile; the grid is
// one cluster.
__global__ void __launch_bounds__(CLUSTER_THREADS)
probe_rev_kernel(const float* __restrict__ x, float w,
                 const float* __restrict__ g, int n,
                 float* __restrict__ dx, float* __restrict__ dw) {
    const int i = blockIdx.x * CLUSTER_THREADS + threadIdx.x;
    float dwi = 0.0f;
    if (i < n) element(x[i], w, g[i], dx + i, &dwi);
    const float sum = cluster_sum(dwi);
    if (i == 0) *dw = sum;
}

}  // namespace

// One launch on the caller's stream: one cluster of at most CLUSTER_LANES
// lanes -> 0 or a cudaError.
extern "C" int euclider_probe_rev(const float* x, float w, const float* g,
                                  int n, float* dx, float* dw, int device,
                                  void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    return (int)launch_cluster(probe_rev_kernel, n, (cudaStream_t)stream, x,
                               w, g, n, dx, dw);
}
