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
// in the builds that march) and, in the expression build, of the VM's
// value and adjoint arrays (one float each per instruction), not
// device-memory bytes: it reads 12 B and writes nothing per pixel.
//
// Built like trace_fwd.cu: nvcc -gencode arch=compute_90a,code=sm_90a
// -std=c++17 -O3 -fmad=false, without --use_fast_math, twice (the
// BUILD_SHAPES builds with -DTRACE_SHAPES_BUILDS).

#include "trace_adj.cuh"

namespace {

// Forward sweep, seed, reverse sweep for one pixel; adds its gradient (and,
// fused, its loss term) into grad, the textures' into gtex.
template <int kB, bool kWide>
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
    const Slot root{load4(cam), d0, 1.0f, s.ambient, s.max_depth, -1, 0};
    tape[0] = Tape{root.org, root.dir, root.w, root.mat, root.depth,
                   {-1, -1}, {}};
    shade<kB>(s, root, 0, acc, stack, &sp, &tape[0].rec);
    int n = 1;
    for (int it = 0; it < s.max_nodes - 1 && sp > 0; ++it, ++n) {
        --sp;
        const Slot nd = stack[sp];
        tape[n] = Tape{nd.org, nd.dir, nd.w, nd.mat, nd.depth, {-1, -1}, {}};
        tape[nd.parent].child[nd.branch] = n;
        shade<kB>(s, nd, n, acc, stack, &sp, &tape[n].rec);
    }
    float G[3];
    seed<kWide>(off, gin, x, y, W, acc, norm, fused, grad, G);
    for (int i = n - 1; i >= 0; --i) {
        V4 dorg, ddir;
        float dw;
        node_adj<kB, kWide>(s, off, tape[i], G, tape, grad, gtex, &dorg,
                            &ddir, &dw);
        tape[i].org = dorg;
        tape[i].dir = ddir;
        tape[i].w = dw;
    }
    gadd4<kWide>(grad, 0, tape[0].org);
    camera_adj<kWide>(cam, x, y, H, W, tape[0].dir, grad);
}

// One thread per pixel of the row slab; one column of partial sums per
// block into partials; the textures' gradient into gtex.
template <int kB, bool kWide>
__global__ void __launch_bounds__(BLOCK_X * BLOCK_Y)
trace_bwd_kernel(Scene s, Offs off, const float* __restrict__ cam, int H,
                 int W, int rows, const float* __restrict__ gin, float norm,
                 int fused, float* __restrict__ partials, float* gtex) {
    const int x = blockIdx.x * BLOCK_X + threadIdx.x;
    const int y = blockIdx.y * BLOCK_Y + threadIdx.y;
    float grad[MAX_PARAMS];
    thread_grad<kWide>(off, grad, partials);
    if (x < W && y < rows)
        pixel_backward<kB, kWide>(s, off, cam, x, y, H, W, gin, norm,
                                  fused != 0, grad, gtex);
    block_partials<kWide>(off, grad, partials);
}

}  // namespace

// The gradient vector out[n_params + 1]: the camera row [0, 24) (the
// scene time's gradient at 17), then the float tables in FLOAT_FIELDS order
// (shape_vec, shape_sc, mat_ior, surf_color, surf_color2, surf_refl,
// surf_fresnel, surf_uv_scale, background, mat_warp_center,
// mat_warp_strength, mat_warp_step, portal_lin, portal_tr, mat_expr_params),
// then the loss (fused mode; 0 in vjp mode).  A table the scene's build
// never reads takes no entries (its gradient is zero): every thread
// reduces its own part of the vector, so its length is paid per pixel.
// The entries from MAX_PARAMS = 160 on (a scene of more parameters) are
// added by atomicAdd into the block's partial sums: within a block they
// are summed in no fixed order, across blocks in the fixed one.  ints,
// floats, params: the scene (trace_common.cuh make_scene); sizes: the rows
// of shape_vec, mat_ior and surf_color, and the rows in the gradient of
// the march's tables (mat_warp_*: n_mat, or 0 in the straight build), of
// the portals' (portal_*: their rows, or 0 in the straight build) and of
// mat_expr_params (n_mat in the VM build, else 0).  partials:
// scratch of (n_params + 1) * n_blocks floats, n_blocks = ceil(W/32) *
// ceil(rows/8).  gtex: the textures' gradient, shaped like their texels
// (floats[15]), zeroed by the caller; the kernel adds into it.
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
    const dim3 block(BLOCK_X, BLOCK_Y);
    const dim3 grid((W + BLOCK_X - 1) / BLOCK_X, (rows + BLOCK_Y - 1) / BLOCK_Y);
    const long long n_blocks = (long long)grid.x * grid.y;
    if (partials_len < n_blocks * off.n) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    if ((rc = zero_ext(partials, off, n_blocks, st)) != 0) return rc;
#define TRACE_BWD_CASE(kB)                                                 \
    case kB:                                                               \
        if (off.n > MAX_PARAMS)                                            \
            trace_bwd_kernel<kB, true><<<grid, block, 0, st>>>(            \
                s, off, cam, H, W, rows, gin, norm, fused, partials, gtex);\
        else                                                               \
            trace_bwd_kernel<kB, false><<<grid, block, 0, st>>>(           \
                s, off, cam, H, W, rows, gin, norm, fused, partials, gtex);\
        break;
    TRACE_BWD_BUILDS(TRACE_BWD_CASE)
#undef TRACE_BWD_CASE
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    sum_partials_kernel<<<off.n, RED_THREADS, 0, st>>>(
        partials, (int)n_blocks, out);
    return (int)cudaGetLastError();
}

