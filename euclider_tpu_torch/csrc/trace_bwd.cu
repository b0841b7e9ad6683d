// trace_bwd.cu - the backward ray-tracing kernel for Hopper (sm_90a): the
// tape kernel.
//
// Replaces three Pallas kernels that compute one function, the reverse-mode
// VJP of the render:
//   - euclider_tpu/ops/pallas_vjp.py::_ckpt_kernel with fused=False (K3,
//     launched by vjp_pallas_ckpt) and pallas_kernel.py::_bwd_kernel (K5,
//     launched by vjp_pallas): the caller gives the cotangent g [R, W, 3]
//     ("vjp" mode);
//   - the same _ckpt_kernel with fused=True (K2, launched by
//     train_step_pallas): the caller gives the target image, and the kernel
//     renders, forms the MSE term norm * |img - target|^2 and its cotangent
//     2 * norm * (img - target) in registers, and runs the reverse sweep
//     ("fused" mode, one training step's gradient in one launch).
// The TPU kernels differ only in how they fit VMEM (fully unrolled tiles,
// chunk checkpoints); on Hopper one thread per pixel keeps its whole ray
// tree, up to MAX_TAPE nodes, in one tape, so one kernel serves all three
// and, inside both modes, the march backward K4.  Trees of more nodes go to
// the segmented kernels (trace_seg.cu).  The device code of the adjoints,
// the gradient vector and its sums: trace_adj.cuh.
//
// What bounds it: FP32 ALU work, warp divergence and the local-memory
// traffic of the tape (at most MAX_TAPE entries of 17 words per thread, 19
// in the builds that march), not device-memory bytes: it reads 12 B and
// writes nothing per pixel.  Measured on the H100 (PERF.md §6), the
// parent design lost most of its time elsewhere in local memory: zeroing,
// accumulating and reading back a gradient vector of 77-142 floats a
// thread took 54% of grad_probe's kernel and 27% of config5's.  Its
// five-shuffle block sum was not the cost (summed through shared memory
// instead, a local vector cost as much as before), and neither was the
// expression VM's local memory (its values in shared memory bought config6
// nothing, 1%): the VM's cost is its instructions, four evaluations of the
// field a marched step.  So the launch (bwd_plan) puts each thread's
// gradient vector in a column of the block's dynamic shared memory
// (ACC_SHARED) where that keeps the two blocks an SM that 128 registers a
// thread allow (grad_probe, config2, config3, perlin_probe), or where one
// block fits and the build has no VM (config5: one block an SM cost it
// 4.8%, config6 34%); else it stays local (ACC_LOCAL, or ACC_WIDE past
// MAX_PARAMS entries), summed through small warp tiles so that L1 keeps
// what the tape spills.  The choice is made by size at each launch and
// reported (euclider_trace_bwd_config).  And the forward sweep records
// each marched node's checkpoints (BUILD_TAPE, MARCH_REC), so the reverse
// no longer re-marches: three evaluations of a step's field instead of
// four.
//
// Built like trace_fwd.cu: nvcc -gencode arch=compute_90a,code=sm_90a
// -std=c++17 -O3 -fmad=false, without --use_fast_math, twice (the
// BUILD_SHAPES builds with -DTRACE_SHAPES_BUILDS).

#include "trace_adj.cuh"

namespace {

// The first MARCH_REC marched nodes of a pixel keep the checkpoints their
// forward sweep recorded (BUILD_TAPE); later ones re-march in the reverse.
// This takes one of a marched step's four evaluations of its field (the
// forward sweep, the replay, the reverse's rebuild and adjoint) out of the
// backward, for 2.1 KB of stack.
constexpr int MARCH_REC = 2;

// Node mat's slot of recorded checkpoints, counting the pixel's marched
// nodes in *count: forward, the next one (nullptr past MARCH_REC or for a
// node that does not march); in the reverse sweep (back) the node's own.
template <int kB>
__device__ __forceinline__ MarchTape* rec_slot(const Scene& s, int mat,
                                               MarchTape* mrec, int* count,
                                               bool back) {
    if constexpr (has_march_rec(kB)) {
        if (s.mat_warp[mat] == MAT_STRAIGHT) return nullptr;
        const int k = back ? --*count : (*count)++;
        return k < MARCH_REC ? mrec + k : nullptr;
    }
    return nullptr;
}

// Forward sweep, seed, reverse sweep for one pixel; adds its gradient (and,
// fused, its loss term) into grad, the textures' into gtex.
template <int kB, int kAcc>
__device__ void pixel_backward(const Scene& s, const Offs& off,
                               const float* cam, int x, int y, int H, int W,
                               const float* gin, float norm, bool fused,
                               float* grad, float* gtex) {
    using Tape = TapeNode<has_march(kB)>;
    const V4 d0 = camera_ray(cam, x, y, H, W, nullptr);
    float acc[3] = {0.0f, 0.0f, 0.0f};
    Slot stack[MAX_SLOTS];
    int sp = 0;
    Tape tape[MAX_TAPE];
    MarchTape mrec[has_march_rec(kB) ? MARCH_REC : 1];
    int marched = 0;
    const Slot root{load4(cam), d0, 1.0f, s.ambient, s.max_depth, -1, 0};
    tape[0] = Tape{root.org, root.dir, root.w, root.mat, root.depth,
                   {-1, -1}, {}};
    shade<kB>(s, root, 0, acc, stack, &sp, &tape[0].rec,
              rec_slot<kB>(s, root.mat, mrec, &marched, false));
    int n = 1;
    for (int it = 0; it < s.max_nodes - 1 && sp > 0; ++it, ++n) {
        --sp;
        const Slot nd = stack[sp];
        tape[n] = Tape{nd.org, nd.dir, nd.w, nd.mat, nd.depth, {-1, -1}, {}};
        tape[nd.parent].child[nd.branch] = n;
        shade<kB>(s, nd, n, acc, stack, &sp, &tape[n].rec,
                  rec_slot<kB>(s, nd.mat, mrec, &marched, false));
    }
    float G[3];
    seed<kAcc>(off, gin, x, y, W, acc, norm, fused, grad, G);
    for (int i = n - 1; i >= 0; --i) {
        V4 dorg, ddir;
        float dw;
        node_adj<kB, kAcc>(s, off, tape[i], G, tape, grad, gtex, &dorg,
                           &ddir, &dw,
                           rec_slot<kB>(s, tape[i].mat, mrec, &marched,
                                        true));
        tape[i].org = dorg;
        tape[i].dir = ddir;
        tape[i].w = dw;
    }
    gadd4<kAcc>(grad, 0, tape[0].org);
    camera_adj<kAcc>(cam, x, y, H, W, tape[0].dir, grad);
}

// One thread per pixel of the row slab; one column of partial sums per
// block into partials; the textures' gradient into gtex.  The block's
// dynamic shared memory holds the threads' gradient columns (ACC_SHARED)
// or what block_partials needs to sum their local vectors.
template <int kB, int kAcc>
__global__ void __launch_bounds__(NTHREADS)
trace_bwd_kernel(Scene s, Offs off, const float* __restrict__ cam, int H,
                 int W, int rows, const float* __restrict__ gin, float norm,
                 int fused, float* __restrict__ partials, float* gtex) {
    const int x = blockIdx.x * BLOCK_X + threadIdx.x;
    const int y = blockIdx.y * BLOCK_Y + threadIdx.y;
    const int tid = threadIdx.y * BLOCK_X + threadIdx.x;
    float grad_l[kAcc == ACC_SHARED ? 1 : MAX_PARAMS];
    float* const grad = kAcc == ACC_SHARED ? dyn_smem() + tid : grad_l;
    thread_grad<kAcc>(off, grad, partials);
    stage_sides<kB>(s);
    if (x < W && y < rows)
        pixel_backward<kB, kAcc>(s, off, cam, x, y, H, W, gin, norm,
                                 fused != 0, grad, gtex);
    block_partials<kAcc>(off, grad, partials, dyn_smem());
}

// The plan's kernel: the tape kernel's builds carry BUILD_TAPE.
struct TapeKernel {
    template <int kB, int kAcc>
    static auto fn() { return trace_bwd_kernel<kB | BUILD_TAPE, kAcc>; }
};

}  // namespace

// The launch configuration the tape kernel takes for a scene (params and
// sizes as euclider_trace_bwd's) on the current device: out[0] threads a
// block, out[1] bytes of dynamic shared memory, out[2] active blocks an SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), out[3] where the
// gradient vector lives (1 shared memory, 2 local memory).
extern "C" int euclider_trace_bwd_config(const int* params, const int* sizes,
                                         int* out) {
    const Offs off = make_offs(sizes);
    const int build = scene_build(params);
    BwdPlan plan;
    int rc;
#define TRACE_BWD_CASE(kB)                                                 \
    case kB:                                                               \
        if ((rc = bwd_plan<TapeKernel, kB>(off, &plan)) != 0) return rc;   \
        break;
    TRACE_BWD_BUILDS(TRACE_BWD_CASE)
#undef TRACE_BWD_CASE
    out[0] = NTHREADS;
    out[1] = plan.bytes;
    out[2] = plan.blocks;
    out[3] = plan.acc == ACC_SHARED ? 1 : 2;
    return 0;
}

namespace {

// Launch the kernel of the plan, <kB | BUILD_TAPE, plan.acc> (after the
// first extern "C", where the CPU harness cuts the source).
#define TRACE_BWD_ARGS                                                     \
    s, off, cam, H, W, rows, gin, norm, fused, partials, gtex
template <int kB>
void launch_plan(const BwdPlan& p, dim3 grid, cudaStream_t st,
                 const Scene& s, const Offs& off, const float* cam, int H,
                 int W, int rows, const float* gin, float norm, int fused,
                 float* partials, float* gtex) {
    constexpr int kT = kB | BUILD_TAPE;
    const dim3 block(BLOCK_X, BLOCK_Y);
    if (p.acc == ACC_SHARED)
        trace_bwd_kernel<kT, ACC_SHARED>
            <<<grid, block, p.bytes, st>>>(TRACE_BWD_ARGS);
    else if (p.acc == ACC_LOCAL)
        trace_bwd_kernel<kT, ACC_LOCAL>
            <<<grid, block, p.bytes, st>>>(TRACE_BWD_ARGS);
    else
        trace_bwd_kernel<kT, ACC_WIDE>
            <<<grid, block, p.bytes, st>>>(TRACE_BWD_ARGS);
}
#undef TRACE_BWD_ARGS

}  // namespace

// The gradient vector out[n_params + 1]: the camera row [0, 24) (the
// scene time's gradient at 17), then the float tables in FLOAT_FIELDS order
// (shape_vec, shape_sc, mat_ior, surf_color, surf_color2, surf_refl,
// surf_fresnel, surf_uv_scale, background, mat_warp_center,
// mat_warp_strength, mat_warp_step, portal_lin, portal_tr, mat_expr_params),
// then the loss (fused mode; 0 in vjp mode).  A table the scene's build
// never reads takes no entries (its gradient is zero): every thread
// zeroes and reduces its own vector, so its length is paid per pixel.
// The entries from MAX_PARAMS = 160 on (a scene of more parameters) are
// added by atomicAdd into the block's partial sums: within a block they
// are summed in no fixed order, across blocks in the fixed one.  ints,
// floats, params: the scene (trace_common.cuh make_scene); sizes: the rows
// of shape_vec, mat_ior and surf_color, and the rows in the gradient of
// the march's tables (mat_warp_*: n_mat, or 0 in the straight build), of
// the portals' (portal_*: their rows, or 0 in the straight build) and of
// mat_expr_params (n_mat in the VM build, else 0).  partials: scratch of
// (n_params + 1) * n_blocks floats, n_blocks = ceil(W/32) * ceil(rows/8).
// gtex: the textures' gradient, shaped like their texels (floats[15]),
// zeroed by the caller; the kernel adds into it.
extern "C" int euclider_trace_bwd(
    const int32_t* const* ints, const float* const* floats, const int* params,
    float t_max, const int* sizes, const float* cam, int H, int W, int rows,
    const float* gin, float norm, int fused, float* partials,
    long long partials_len, float* out, float* gtex, int device,
    void* stream) {
    const Scene s = make_scene(ints, floats, params, t_max, cam);
    Offs off;
    int rc = check_scene(s, params, sizes, &off);
    if (rc != 0) return rc;
    if (s.max_nodes > MAX_TAPE) return (int)cudaErrorInvalidValue;
    const int build = scene_build(params);
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (rows <= 0 || W <= 0) return 0;
    const dim3 grid((W + BLOCK_X - 1) / BLOCK_X, (rows + BLOCK_Y - 1) / BLOCK_Y);
    const long long n_blocks = (long long)grid.x * grid.y;
    if (partials_len < n_blocks * off.n) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    if ((rc = zero_ext(partials, off, n_blocks, st)) != 0) return rc;
    BwdPlan plan;
#define TRACE_BWD_CASE(kB)                                                 \
    case kB:                                                               \
        if ((rc = bwd_plan<TapeKernel, kB>(off, &plan)) != 0) return rc;   \
        launch_plan<kB>(plan, grid, st, s, off, cam, H, W, rows, gin,      \
                        norm, fused, partials, gtex);                      \
        break;
    TRACE_BWD_BUILDS(TRACE_BWD_CASE)
#undef TRACE_BWD_CASE
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    sum_partials_kernel<<<off.n, RED_THREADS, 0, st>>>(
        partials, (int)n_blocks, out);
    return (int)cudaGetLastError();
}

