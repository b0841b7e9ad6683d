// trace_fwd.cu - the forward ray-tracing kernel for Hopper (sm_90a).
//
// Replaces euclider_tpu/ops/pallas_kernel.py::_kernel, the Pallas forward
// megakernel launched by render_image_pallas.  It computes exactly
// euclider_tpu_torch/ops/trace.py::render_image (the port of
// ops/trace.py::trace_batch with differentiable=False): pinhole rays per
// pixel, the peeled primary node, then a depth-first stack loop capped at
// max_nodes - 1 trips.  Each node finds the nearest hit over the entities
// (strict '<' in entity order; a CSG entity's leaf crossings kept where its
// membership flips), shades it (uniform, checker, smooth, perlin or
// texture surface, Schlick reflection ratio) and pushes the transmission
// child, then the reflection child.  A node whose material is warped space
// marches instead of flying straight (ops/march.py): up to march_steps
// steps per thread, each testing every entity's side, ended at the first
// flip (or after the step that starts beyond t_max) and refined by
// bisection; the thread's loop stops where its ray is done, which gives the
// JAX package's early-exit while loop the same value.  The step's field is
// the attractor of a 'warp' material or, for an 'expr' material, its
// expression program run by a per-thread VM over the material's four
// component programs (the field of ops/trace.py::make_accel, the scene
// time read from the camera row).  A portal's transmitted ray is
// teleported.  The node's device code lives in trace_common.cuh, which the
// backward kernels (trace_bwd.cu, trace_seg.cu) share.
//
// What bounds it: FP32 ALU work and warp divergence, not bytes.  The output
// is 12 B per pixel and the scene tables are under 1 KB (a texture is 48 KB
// at 64 x 64, read four texels a textured node from L1/L2).  The design keeps a
// pixel's whole ray tree in one thread's registers and local memory (a DFS
// stack of at most MAX_SLOTS branches) and writes each pixel once.  The
// scene is data, not code: the entity, node and surface-kind arrays and the
// float tables are read from global memory, so one compiled kernel serves
// every scene and branches on the scene are uniform across a warp.  In the
// scenes that march, the few pixels whose rays march (6-8% of config5,
// config6 and config7, up to 960 steps each) set the kernel's time, each
// step waiting on its side tests: those read a table the block stages in
// shared memory (trace_common.cuh stage_sides), and the builds that march
// launch blocks of 8 x 32 threads, whose warps hold tiles of 8 x 4 pixels
// that march more alike than rows of 32 (the march's SIMT efficiency on
// config5 81% -> 90%, tools/march_simt.py).  Measured on the H100 against
// the 32 x 8 blocks reading the scene's arrays (PERF.md §6): config5
// 0.449 -> 0.285 ms, config7 0.414 -> 0.251; the straight builds keep
// 32 x 8 blocks, where the tiles bought nothing.
//
// Built with nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// -fmad=false, without --use_fast_math: sqrtf, division and floorf stay
// IEEE float32, and no multiply and add contract into an FMA; built twice,
// the second library holding the BUILD_SHAPES builds with
// -DTRACE_SHAPES_BUILDS (trace_common.cuh).

#include "trace_common.cuh"

using namespace trace;

namespace {

// One thread per pixel of the row slab [y0, y0 + rows) of the H x W frame.
// cam: the 24-float row of pallas_kernel._pack_camera (position, forward,
// up, right, tan_half_fov, time, y0, padding).
template <int kB>
__global__ void trace_fwd_kernel(Scene s, const float* __restrict__ cam,
                                 int H, int W, int rows,
                                 float* __restrict__ out) {
    stage_sides<kB>(s);
    const int x = blockIdx.x * blockDim.x + threadIdx.x;
    const int y = blockIdx.y * blockDim.y + threadIdx.y;
    if (x >= W || y >= rows) return;

    const V4 d = camera_ray(cam, x, y, H, W, nullptr);
    float acc[3] = {0.0f, 0.0f, 0.0f};
    Slot stack[MAX_SLOTS];
    int sp = 0;
    const Slot root{load4(cam), d, 1.0f, s.ambient, s.max_depth, -1, 0};
    shade<kB>(s, root, 0, acc, stack, &sp, nullptr);
    for (int it = 0; it < s.max_nodes - 1 && sp > 0; ++it) {
        --sp;
        const Slot node = stack[sp];
        shade<kB>(s, node, it + 1, acc, stack, &sp, nullptr);
    }
    float* o = out + 3 * ((size_t)y * W + x);
    o[0] = acc[0];
    o[1] = acc[1];
    o[2] = acc[2];
}

// The launch's block for a build: 256 threads, 8 x 32 for the builds that
// march (each warp a tile of 8 x 4 pixels, which march more alike than a
// row of 32: PERF.md §6), else 32 x 8 (a warp a row of 32 pixels).
inline dim3 fwd_block(int build) {
    return has_march(build) ? dim3(8, 32) : dim3(32, 8);
}

}  // namespace

// ints, floats, params: the scene (trace_common.cuh make_scene).
extern "C" int euclider_trace_fwd(
    const int32_t* const* ints, const float* const* floats, const int* params,
    float t_max, const float* cam, int H, int W, int rows, float* out,
    int device, void* stream) {
    const Scene s = make_scene(ints, floats, params, t_max, cam);
    const int build = scene_build(params);
    if (s.max_depth + 1 > MAX_SLOTS ||
        (has_march(build) && s.n_ent > MAX_MARCH_ENTITIES))
        return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (rows <= 0 || W <= 0) return 0;
    const dim3 block = fwd_block(build);
    const dim3 grid((W + block.x - 1) / block.x,
                    (rows + block.y - 1) / block.y);
    const cudaStream_t st = (cudaStream_t)stream;
#define TRACE_FWD_CASE(kB)                                                 \
    case kB:                                                               \
        trace_fwd_kernel<kB><<<grid, block, 0, st>>>(s, cam, H, W, rows, out); \
        break;
    switch (build) {  // this library's builds (trace_common.cuh)
#ifdef TRACE_SHAPES_BUILDS
        TRACE_FWD_CASE(BUILD_SHAPES)
        TRACE_FWD_CASE(BUILD_SHAPES | BUILD_WARP)
        TRACE_FWD_CASE(BUILD_SHAPES | BUILD_EXPR)
#else
        TRACE_FWD_CASE(BUILD_STRAIGHT)
        TRACE_FWD_CASE(BUILD_WARP)
        TRACE_FWD_CASE(BUILD_EXPR)
#endif
        default: return (int)cudaErrorInvalidValue;
    }
#undef TRACE_FWD_CASE
    return (int)cudaGetLastError();
}
