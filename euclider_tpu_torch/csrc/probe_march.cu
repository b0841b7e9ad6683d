// probe_march.cu - the march-bisect probe P1 for Hopper (sm_90a).
//
// Replaces tools/march_bisect.py::kernel: the march custom VJP of the JAX
// package (ops/pallas_vjp.py::make_march_ckpt, the march backward K4) run
// stage by stage on one tile of rays in one attractor material.  Per lane:
//   fwd     val = p.x + dvec.y + u + v + n.z at the march's end: the
//           crossing point p (the origin where nothing was crossed), the
//           direction dvec of the crossing step (else the initial one), the
//           hit leaf's unoriented normal n and UV (0 on a uniform surface);
//   vjp     val + d org.x + sum(d shape_vec) under the cotangent 1 of val,
//           the march's backward rebuilt step by step from checkpoints, as
//           K4 does in the backward kernels;
//   finish  the same VJP through a stored tape: every pre-step state kept
//           in local memory and walked back, no rebuild;
//   loop    as vjp with val = dvec.y: the cotangent reaches only the
//           direction.
// sum(d shape_vec) is the tile's: the lanes' sums are reduced in a fixed
// order (each warp's by shuffles, then the block's warps in order, then
// the cluster's blocks in rank order: ops/march_probe.py::tile_sum) and
// added to every lane.  ops/march_probe.py::march_probe_plain is the plain
// version (autograd through ops/march.py).
//
// The kernel runs the device code of the render and its backward, not a
// copy of it: march and surface_at (trace_common.cuh, as trace_fwd does),
// march_replay, march_reverse (and its step adjoint TRACE_MARCH_STEP_ADJ),
// surface_uv_adj and leaf_normal_adj (trace_adj.cuh, as trace_bwd and
// trace_seg do), in the build with the march and the attractor field (no
// VM, no shapes).  The crossing's
// bisection parameter lambda is a chain of discrete halvings: its adjoint
// is zero, and p = sx0 (1 - lambda) + sx1 lambda sends (1 - lambda) dp and
// lambda dp to the crossing step's segment slots, as node_adj does.
//
// What bounds it: the FP32 work of 23 march steps a lane with five side
// tests each, forward and twice more in the reverse (the rebuild and the
// adjoint), far below the card; the probe's input is one (8, 128) tile, so
// its time is one lane's chain of dependent steps.  The design spreads the
// tile as thinly as it goes: a lane a thread, in a thread-block cluster of
// up to 8 blocks of 128 threads (one warp a scheduler on each of 8 SMs),
// whose blocks sum their partials through distributed shared memory, each
// block reading all of them in rank order, so every lane adds the same
// bits and none writes before the whole sum is known (probe_cluster.cuh's
// cluster_sum and launch_cluster, shared with P2, P4, P5 and P6).
// Measured on the H100 (PERF.md §6) against the first design's one block
// of 256 threads walking 4 lanes each: every stage 0.24-0.26x its time,
// within 1.0-1.2x of the tile's longest lane run alone, the floor of a
// lane a thread.  Not taken: one block of 1024 threads (0.52-0.63x: the
// launch bound's 64 registers, 32 warps on 4 schedulers), 32 blocks of a
// warp with the last block adding the sum (1.1-1.3x the cluster's), the
// finish tape in shared memory (no gain: its steps stay in L1).
//
// Built like trace_fwd.cu: nvcc -gencode arch=compute_90a,code=sm_90a
// -std=c++17 -O3 -fmad=false, without --use_fast_math.

#include "trace_adj.cuh"
#include "probe_cluster.cuh"

namespace {

constexpr int STAGE_FWD = 0, STAGE_VJP = 1, STAGE_FINISH = 2, STAGE_LOOP = 3;
constexpr int TAPE_STEPS = 32;   // the finish stage's tape: march_steps

// The adjoint of the n march steps from (org, d0) through a tape of their
// pre-step states: g_sx0, g_sx1, g_sv the cotangents of the crossing
// step's segment slots -> d_org, d_dir.  Each step's adjoint is
// march_reverse's (TRACE_MARCH_STEP_ADJ), on the stored state instead of
// the rebuilt one.
template <bool kExpr>
__device__ void tape_reverse(const Field<kExpr>& f, V4 org, V4 d0, int n,
                             V4 g_sx0, V4 g_sx1, V4 g_sv, V4* d_org,
                             V4* d_dir) {
    static_assert(!kExpr, "the tape holds no VM values");
    V4 tx[TAPE_STEPS], tv[TAPE_STEPS];
    V4 x = org, v = d0;
    for (int i = 0; i < n; ++i) {
        tx[i] = x;
        tv[i] = v;
        V4 x1, v1;
        march_step<kExpr>(f, x, v, &x1, &v1);
        x = x1;
        v = v1;
    }
    const float h = f.h;
    const bool expr = false;
    V4 gx = vzero(), gv = vzero(), gc = vzero();
    float gs = 0.0f, gh = 0.0f, gt = 0.0f;
    float val[1], adj[1];
    float gp[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    for (int i = n - 1; i >= 0; --i) {
        const V4 xp = tx[i], vp = tv[i];
        const V4 a = attractor(f.c, f.strength, xp);
        V4 g_x1 = gx, g_v1 = gv, g_xp = vzero();
        if (i == n - 1) {
            g_x1 = add(g_x1, g_sx1);
            g_v1 = add(g_v1, g_sv);
            g_xp = g_sx0;
        }
        TRACE_MARCH_STEP_ADJ
    }
    *d_org = gx;
    *d_dir = gv;
}

// One lane of the stage: its tile value without the tile's sum, the steps
// its march walked and the entity it crossed (-1: none), and its share of
// sum(d shape_vec).
__device__ void probe_lane(const Scene& s, int stage, int mat, V4 o, V4 d,
                           float* out, int* steps, int* ent, float* dsv) {
    const MarchHit m = march<false, false>(s, o, d, mat);
    V4 n = vzero();
    float u = 0.0f, v = 0.0f;
    if (m.ent >= 0)
        surface_at<false>(s, m.ent, hit_leaf<false>(s, m.ent, m.leaf << 1),
                          m.p, &n, &u, &v);
    const bool loop = stage == STAGE_LOOP;
    const float val = loop ? m.dir.y : m.p.x + m.dir.y + u + v + n.z;
    *steps = m.n;
    *ent = m.ent;
    *dsv = 0.0f;
    if (stage == STAGE_FWD) {
        *out = val;
        return;
    }
    // the cotangents of p, dvec, n and u, v
    V4 dp = loop ? vzero() : V4{1.0f, 0.0f, 0.0f, 0.0f};
    const V4 dd = {0.0f, 1.0f, 0.0f, 0.0f};
    V4 d_org = dp;   // nothing crossed: p is the origin, dvec d
    if (m.ent >= 0) {
        const int leaf = hit_leaf<false>(s, m.ent, m.leaf << 1);
        const int row = s.node_row[leaf];
        const V4 c = load4(s.shape_vec + 4 * row);
        const bool sphere = s.node_kind[leaf] == NODE_SPHERE;
        V4 dc = vzero(), da = vzero();
        if (!loop) {   // the loop stage's cotangent leaves p, n, u, v alone
            if (s.surf_kind[s.ent_surf[m.ent]] != SURF_UNIFORM)
                surface_uv_adj(s, sphere, false, m.p, c, vzero(), 1.0f, 1.0f,
                               &dp, &dc, &da);
            leaf_normal_adj(sphere, false, m.p, c, vzero(),
                            V4{0.0f, 0.0f, 1.0f, 0.0f}, &dp, &dc, &da);
        }
        const Field<false> f = field<false>(s, mat);
        const V4 g_sx0 = scale(dp, 1.0f - m.lam), g_sx1 = scale(dp, m.lam);
        V4 d_dir;
        if (stage == STAGE_FINISH) {
            tape_reverse<false>(f, o, d, m.n, g_sx0, g_sx1, dd, &d_org,
                                &d_dir);
        } else {
            // march_reverse adds the field's gradients into grad at off's
            // offsets for material 0: kept here, not reported
            Offs off{};
            off.ws = 4;
            off.wh = 5;
            float grad[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
            MarchTape mt;
            march_replay<false>(f, o, d, m.n, &mt);
            march_reverse<false, ACC_LOCAL>(off, 0, f, mt, m.n, g_sx0, g_sx1, dd,
                                        grad, &d_org, &d_dir);
        }
        *dsv = dc.x + dc.y + dc.z + dc.w;
    }
    *out = val + d_org.x;
}

// Lane blockIdx.x * CLUSTER_THREADS + threadIdx.x of the tile; the grid is
// one cluster (probe_cluster.cuh).  check, when given: each lane's share
// of sum(d shape_vec) at check[i] and the tile's sum it added at
// check[n + i].
__global__ void __launch_bounds__(CLUSTER_THREADS)
probe_march_kernel(Scene s, int stage, int mat, const float* __restrict__ org,
                   const float* __restrict__ dir, int n,
                   float* __restrict__ out, int* __restrict__ steps,
                   int* __restrict__ ent, float* __restrict__ dsv,
                   float* __restrict__ check) {
    stage_sides<BUILD_WARP>(s);
    const int i = blockIdx.x * CLUSTER_THREADS + threadIdx.x;
    float val = 0.0f, part = 0.0f;
    if (i < n)
        probe_lane(s, stage, mat, load4(org + 4 * i), load4(dir + 4 * i),
                   &val, steps + i, ent + i, &part);
    // fwd has no sum: the stage is the launch's, so every block skips it
    const float sum = stage == STAGE_FWD ? 0.0f : cluster_sum(part);
    if (i < n) {
        out[i] = stage == STAGE_FWD ? val : val + sum;
        if (check) {
            check[i] = part;
            check[n + i] = sum;
        }
    }
    if (i == 0) *dsv = sum;
}

// An empty kernel: the floor of any one-tile launch, timed beside P1.
__global__ void probe_empty_kernel() {}

}  // namespace

// ints, floats, params, t_max and cam as trace_fwd.cu's entry point takes
// them (cam: only its scene time, cam[17], is read); org and dir [n, 4],
// n <= CLUSTER_LANES; mat the material every lane marches in; check null or
// 2 n floats (probe_march_kernel) -> 0 or a cudaError.  The launch is one
// cluster of ceil(n / CLUSTER_THREADS) blocks (launch_cluster); a refused
// launch is an error.
extern "C" int euclider_probe_march(const int32_t* const* ints,
                                    const float* const* floats,
                                    const int* params, float t_max,
                                    const float* cam, int stage, int mat,
                                    const float* org, const float* dir, int n,
                                    float* out, int* steps, int* ent,
                                    float* dsv, float* check, int device,
                                    void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    const Scene s = make_scene(ints, floats, params, t_max, cam);
    if (stage < STAGE_FWD || stage > STAGE_LOOP ||
        scene_build(params) != BUILD_WARP || s.march_steps > TAPE_STEPS ||
        s.n_ent > MAX_MARCH_ENTITIES)
        return (int)cudaErrorInvalidValue;
    return (int)launch_cluster(probe_march_kernel, n, (cudaStream_t)stream,
                               s, stage, mat, org, dir, n, out, steps, ent,
                               dsv, check);
}

// One launch of the empty kernel, one warp.
extern "C" int euclider_probe_empty(int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    probe_empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
    return (int)cudaGetLastError();
}
