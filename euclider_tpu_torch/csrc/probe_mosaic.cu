// probe_mosaic.cu - the Mosaic capability probes P2-P5 for Hopper (sm_90a).
//
// Replaces four Pallas kernels of tools/mosaic_probe.py, each a scalar
// recurrence on one (8, 128) tile that the JAX package used to pin down one
// mechanism of its in-kernel checkpointed backward (ops/pallas_vjp.py):
//   P2 _ckpt_kernel (probe_ckpt_kernel): 6 checkpoints of 4 steps of
//      x + 0.1 tanh(w x), then the reverse, chunk by chunk, each chunk
//      re-run forward from its checkpoint -> dx, dw;
//   P3 _cond_kernel (probe_cond_kernel): one tile-wide branch on
//      sum(x) > 0, y = 2 v + sin v or 0.5 v, and its VJP -> y, dx;
//   P4 _nested_kernel (probe_nested_kernel): an inner march of 12 such
//      steps from 1.5 x whose backward re-runs each chunk of CB = 4 steps
//      into its own scratch of CB states, inside the VJP of the outer
//      cos y + 0.25 y, accumulated over 2 trips -> dx, dw;
//   P5 _gated_kernel (probe_gated_kernel): the two-variable march
//      (x, v) -> (x + 0.1 tanh(w v), v + 0.05 sin x) from (1.2 x, 0.5 x),
//      y = 2 x_T + v_T, whose forward and reverse are gated tile-wide by
//      any(act > 0.5) (a dead tile returns y = x0 and the cotangent
//      (g, 0, 0), as gm_bwd's dead_sweep), inside the same outer VJP,
//      accumulated over 2 trips -> dx, dw.
// ops/probes.py holds their plain versions (autograd through the same
// recurrences) and the wrappers.
//
// The scratch of the TPU kernels (the checkpoint stack in VMEM, the inner
// backward's run_scoped buffer) is per-thread local arrays here.  What
// bounds them: the tanhf/sinf work of 24 to 72 steps per element, far
// below the card, so a launch's time is one lane's chain of dependent
// steps and the launch's fixed cost.  P2, P4 and P5 spread the tile as
// thinly as it goes: a lane a thread in one thread-block cluster of up to
// 8 blocks of 128 (probe_cluster.cuh), dw summed in the cluster's fixed
// order (P2 and P4 under one barrier after the lanes' work,
// cluster_push_sum), P5's any() decided cluster-wide before any lane
// marches.  P4's and P5's two trips have the same inputs (the tool's loop
// takes jax.vjp of the same outer at the same x, w, g twice), so each
// runs one and doubles it: in float 0 + t + t is 2 t exactly, the same
// bits.  P3 does almost no work: a lane a thread in one block of up to
// 1024 threads (a cluster's launch costs more than the whole chain), x and
// g held in registers across the tile's sum, so the tile is read once; its
// branch is decided by a fixed butterfly sum (block_sum; no atomics, so
// the sign of a sum near zero cannot change from run to run), and sincosf
// takes sin and cos in one range reduction, without the 32 B stack frame
// of sinf's and cosf's.  Every result is deterministic.  Measured on the
// H100 (PERF.md §6) against the first design, one block of 256 threads
// walking 4 elements each (P3 reading x twice) and both trips: P5 0.24x
// (one trip alone 0.51x), P2 0.52x, P4 0.53x (one trip alone 0.85x), P3
// 0.60x, each within 1.15x of one element run alone.  Not taken: for P5,
// 32 blocks of a warp whose last block adds the partials in order (2%
// faster on the live tile, 3% slower on the dead one, and its partials and
// counter are device-wide state in global memory that two streams'
// launches would share), the chunk loops unrolled (13% slower); for P2 and
// P4, cluster_sum (0.0006 ms slower); for P3, 256 threads of 4 elements
// in registers (1.13x, a 32 B stack), one cluster of 8 x 128 with
// cluster_push_sum (1.4x), sincosf before the sum (1.07-1.27x).
//
// Built like trace_fwd.cu: nvcc -gencode arch=compute_90a,code=sm_90a
// -std=c++17 -O3 -fmad=false, without --use_fast_math: every operation
// rounds as the plain version's separate torch operations do.

#include "probe_cluster.cuh"

namespace {

constexpr int K = 6;          // P2: checkpoints
constexpr int C = 4;          // P2: steps per chunk
constexpr int N_STEPS = 12;   // P4, P5: steps of the inner march
constexpr int CB = 4;         // P4, P5: steps per chunk
constexpr int NB = N_STEPS / CB;
constexpr int TRIPS = 2;      // P4, P5: the outer loop's VJPs, accumulated
constexpr int COND_LANES = 1024;  // P3: a lane a thread in its one block

// x + 0.1 tanh(w x)
__device__ __forceinline__ float step(float x, float w) {
    return x + 0.1f * tanhf(w * x);
}

// the adjoint of step at x: gx <- gx (1 + 0.1 (1 - t^2) w), gw += ...
__device__ __forceinline__ void step_adj(float x, float w, float* gx,
                                         float* gw) {
    const float t = tanhf(w * x);
    const float a = *gx * 0.1f * (1.0f - t * t);
    *gw += a * x;
    *gx = *gx + a * w;
}

// P5's step: (x, v) -> (x + 0.1 tanh(w v), v + 0.05 sin x)
__device__ __forceinline__ void step2(float* x, float* v, float w) {
    const float x1 = *x + 0.1f * tanhf(w * *v);
    *v = *v + 0.05f * sinf(*x);
    *x = x1;
}

__device__ __forceinline__ void step2_adj(float x, float v, float w,
                                          float* gx, float* gv, float* gw) {
    const float t = tanhf(w * v);
    const float a = *gx * 0.1f * (1.0f - t * t);
    *gw += a * v;
    const float gv1 = *gv;
    *gv = gv1 + a * w;
    *gx = *gx + gv1 * 0.05f * cosf(x);
}

// cotangent of y under out = cos y + 0.25 y
__device__ __forceinline__ float outer_adj(float y, float g) {
    return g * -sinf(y) + g * 0.25f;
}

// --- one element of each probe ------------------------------------------

// P2: the checkpointed forward, then the reverse chunk by chunk.
__device__ void ckpt_element(float x, float w, float g, float* dx,
                             float* dw) {
    float ck[K];
    for (int k = 0; k < K; ++k) {
        ck[k] = x;
        for (int c = 0; c < C; ++c) x = step(x, w);
    }
    float gx = g, gw = 0.0f;
    for (int k = K - 1; k >= 0; --k) {
        float st[C];                     // the chunk re-run from ck[k]
        float xc = ck[k];
        for (int c = 0; c < C; ++c) {
            st[c] = xc;
            xc = step(xc, w);
        }
        for (int c = C - 1; c >= 0; --c) step_adj(st[c], w, &gx, &gw);
    }
    *dx = gx;
    *dw = gw;
}

// P3: the branch the tile took (live: sum(x) > 0).
__device__ __forceinline__ void cond_element(float x, float g, bool live,
                                             float* y, float* dx) {
    if (live) {
        float s, c;
        sincosf(x, &s, &c);
        *y = x * 2.0f + s;
        *dx = g * 2.0f + g * c;
    } else {
        *y = x * 0.5f;
        *dx = g * 0.5f;
    }
}

// P4: one trip of the outer VJP through the inner march.
__device__ void nested_trip(float x, float w, float g, float* dx,
                            float* dw) {
    float ck[NB];
    float y = x * 1.5f;
    for (int b = 0; b < NB; ++b) {
        ck[b] = y;
        for (int i = 0; i < CB; ++i) y = step(y, w);
    }
    float gy = outer_adj(y, g), gw = 0.0f;
    for (int b = NB - 1; b >= 0; --b) {
        float st[CB];                    // the inner backward's scratch
        float xc = ck[b];
        for (int i = 0; i < CB; ++i) {
            st[i] = xc;
            xc = step(xc, w);
        }
        for (int i = CB - 1; i >= 0; --i) step_adj(st[i], w, &gy, &gw);
    }
    *dx = gy * 1.5f;
    *dw = gw;
}

// P4's TRIPS trips: one, scaled (every trip has the same inputs)
__device__ void nested_element(float x, float w, float g, float* dx,
                               float* dw) {
    float tx, tw;
    nested_trip(x, w, g, &tx, &tw);
    *dx = TRIPS * tx;
    *dw = TRIPS * tw;
}

// P5: one trip of the outer VJP through the gated march (live: the tile's
// any(act > 0.5)).
__device__ void gated_trip(float x, float w, float g, bool live, float* dx,
                           float* dw) {
    const float x0 = x * 1.2f, v0 = x * 0.5f;
    float ckx[NB], ckv[NB];
    float xc = x0, vc = v0;
    float y = x0;
    if (live) {
        for (int b = 0; b < NB; ++b) {
            ckx[b] = xc;
            ckv[b] = vc;
            for (int i = 0; i < CB; ++i) step2(&xc, &vc, w);
        }
        y = xc * 2.0f + vc;
    }
    const float gy = outer_adj(y, g);
    float gx = gy, gv = 0.0f, gw = 0.0f;   // the dead sweep: (g, 0, 0)
    if (live) {
        gx = 2.0f * gy;
        gv = gy;
        for (int b = NB - 1; b >= 0; --b) {
            float stx[CB], stv[CB];      // the backward's two scratches
            float sx = ckx[b], sv = ckv[b];
            for (int i = 0; i < CB; ++i) {
                stx[i] = sx;
                stv[i] = sv;
                step2(&sx, &sv, w);
            }
            for (int i = CB - 1; i >= 0; --i)
                step2_adj(stx[i], stv[i], w, &gx, &gv, &gw);
        }
    }
    *dx = gx * 1.2f + gv * 0.5f;
    *dw = gw;
}

// P5's TRIPS trips: one, scaled (every trip has the same inputs)
__device__ void gated_element(float x, float w, float g, bool live,
                              float* dx, float* dw) {
    float tx, tw;
    gated_trip(x, w, g, live, &tx, &tw);
    *dx = TRIPS * tx;
    *dw = TRIPS * tw;
}

// --- the kernels: P3 one block over the tile, P2, P4 and P5 one cluster ---

// The block's sum of v in a fixed order, the same bits in every thread: a
// butterfly over each warp's lanes, then one over the warps' partials
// from shared memory (float addition commutes, so the two partners of a
// pair add the same bits); a warp past the block adds 0.
__device__ __forceinline__ float block_sum(float v) {
    __shared__ float red[COND_LANES / 32];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    const int lane = threadIdx.x & 31;
    if (lane == 0) red[threadIdx.x >> 5] = v;
    __syncthreads();
    v = lane < (int)(blockDim.x >> 5) ? red[lane] : 0.0f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

// P3: element threadIdx.x; x and g stay in registers across the sum, so
// the tile is read once.
__global__ void __launch_bounds__(COND_LANES)
probe_cond_kernel(const float* __restrict__ x, const float* __restrict__ g,
                  int n, float* __restrict__ y, float* __restrict__ dx) {
    const int i = threadIdx.x;
    const bool in = i < n;
    const float xi = in ? x[i] : 0.0f;
    const float gi = in ? g[i] : 0.0f;
    const bool live = block_sum(xi) > 0.0f;
    if (in) cond_element(xi, gi, live, y + i, dx + i);
}

// P2, P4, P5: lane blockIdx.x * CLUSTER_THREADS + threadIdx.x of the tile;
// the grid is one cluster.
__global__ void __launch_bounds__(CLUSTER_THREADS)
probe_ckpt_kernel(const float* __restrict__ x, float w,
                  const float* __restrict__ g, int n, float* __restrict__ dx,
                  float* __restrict__ dw) {
    const int i = blockIdx.x * CLUSTER_THREADS + threadIdx.x;
    cluster_arrive();
    float dwi = 0.0f;
    if (i < n) ckpt_element(x[i], w, g[i], dx + i, &dwi);
    const float sum = cluster_push_sum(dwi);
    if (i == 0) *dw = sum;
}

__global__ void __launch_bounds__(CLUSTER_THREADS)
probe_nested_kernel(const float* __restrict__ x, float w,
                    const float* __restrict__ g, int n,
                    float* __restrict__ dx, float* __restrict__ dw) {
    const int i = blockIdx.x * CLUSTER_THREADS + threadIdx.x;
    cluster_arrive();
    float dwi = 0.0f;
    if (i < n) nested_element(x[i], w, g[i], dx + i, &dwi);
    const float sum = cluster_push_sum(dwi);
    if (i == 0) *dw = sum;
}

// No lane marches before the tile's any() is known.
__global__ void __launch_bounds__(CLUSTER_THREADS)
probe_gated_kernel(const float* __restrict__ x, float w,
                   const float* __restrict__ g,
                   const float* __restrict__ act, int n,
                   float* __restrict__ dx, float* __restrict__ dw) {
    const int i = blockIdx.x * CLUSTER_THREADS + threadIdx.x;
    const bool live = cluster_any(i < n && act[i] > 0.5f);
    float dwi = 0.0f;
    if (i < n) gated_element(x[i], w, g[i], live, dx + i, &dwi);
    const float sum = cluster_sum(dwi);
    if (i == 0) *dw = sum;
}

}  // namespace

// The entry points: one launch on the caller's stream (P3 one block; P2,
// P4 and P5 one cluster of at most CLUSTER_LANES lanes) -> 0 or a
// cudaError.

extern "C" int euclider_probe_ckpt(const float* x, float w, const float* g,
                                   int n, float* dx, float* dw, int device,
                                   void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    return (int)launch_cluster(probe_ckpt_kernel, n, (cudaStream_t)stream, x,
                               w, g, n, dx, dw);
}

extern "C" int euclider_probe_cond(const float* x, const float* g, int n,
                                   float* y, float* dx, int device,
                                   void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (n <= 0 || n > COND_LANES) return (int)cudaErrorInvalidValue;
    const int threads = (n + 31) / 32 * 32;
    probe_cond_kernel<<<1, threads, 0, (cudaStream_t)stream>>>(x, g, n, y, dx);
    return (int)cudaGetLastError();
}

extern "C" int euclider_probe_nested(const float* x, float w, const float* g,
                                     int n, float* dx, float* dw, int device,
                                     void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    return (int)launch_cluster(probe_nested_kernel, n, (cudaStream_t)stream,
                               x, w, g, n, dx, dw);
}

extern "C" int euclider_probe_gated(const float* x, float w, const float* g,
                                    const float* act, int n, float* dx,
                                    float* dw, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    return (int)launch_cluster(probe_gated_kernel, n, (cudaStream_t)stream,
                               x, w, g, act, n, dx, dw);
}
