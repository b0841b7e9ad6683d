// trace_seg.cu - the segmented backward ray-tracing kernels for Hopper
// (sm_90a), K6 and K7.
//
// Replaces euclider_tpu/ops/pallas_kernel.py::_seg_fwd_kernel (K6) and
// _seg_bwd_kernel (K7), launched by vjp_pallas_segmented: the same VJP
// (both modes), for trees of any max_nodes.  The trips = max_nodes - 1
// bounce trips are cut into K chunks of c trips, the last one taking the
// rest, so that the chunks sum to trips exactly (Chunks).  K6 runs a
// pixel's shading loop without a tape and stores the boundary carry before
// each chunk's first trip that starts with a nonempty stack, the final
// colour sums and the count of those chunks.  K7 walks them backwards,
// from the last one: from a chunk's carry it re-runs the chunk's trips
// with the same device code, which takes the same decisions bit for bit,
// records a tape of at most c nodes and sweeps it with node_adj; the peel
// (the primary node) and the camera ray come last.  Unlike the TPU
// kernels, K7 is one launch: a thread keeps the carry's adjoint (9 floats
// a slot; the colour sums' adjoint is G at every boundary) between chunks
// in local memory, and only the forward carry goes through device memory.
//
// The chunk tape's first MAX_SLOTS entries are virtual: entry j holds the
// adjoint of the carry's slot at stack position j.  A slot carried into a
// chunk has parent j, so popping it links entry j to the node shaded from
// it; a slot still on the stack at the chunk's end and pushed by a node of
// the chunk links that node to entry j (link_to_carry).  Before the sweep
// entry j holds the adjoint of the slot at j at the chunk's end, read by
// the nodes of the chunk; after it, of the slot at j at its start: the
// input adjoint of the node shaded from it, or, for a slot the chunk
// never popped (below its lowest pop), the same slot's adjoint unchanged.
// Only the last chunk of the tree (chunk K - 1) can end with slots on the
// stack, which no trip shaded: their entries are zeroed there, and no
// other entry is ever read before a later chunk has written it.
//
// The carry goes through one buffer of K carries a pixel, word-major over
// the slab's pixels so that a warp's stores and loads coalesce: word w of
// chunk k's carry at carry[(k * CW + w) * npix + pixel], CW = 1 + 11 S with
// S = max_depth + 1 slots: sp, then slot j's (org[4], dir[4], w, mat,
// depth) at 1 + 11 j.  Only the live slots j < sp are stored and loaded.
//
// What bounds them: the tape kernel's work (trace_bwd.cu), K6's forward
// sweep once more, and the carry's bytes: per pixel and stored chunk K6
// stores and K7 loads the stack pointer and 11 words a live slot.
// Measured on the H100 (PERF.md §6), what K7 paid beyond the tape kernel
// was local memory and exposed latency, not arithmetic: zeroing all 16
// virtual entries up front (144 local stores a thread, which L1 cannot
// hold beside the block's shared gradient columns) took 31% of its time
// on config2, and reading the stack pointer of every chunk (K - 1 of
// them empty for most pixels) left a device-memory load exposed per
// chunk.  So the entries are zeroed only where the last chunk needs them,
// and K6 writes each pixel's count of stored chunks, so that K7 loads no
// empty chunk's stack pointer; its loop still runs over every chunk, so
// that a warp's threads re-run a chunk together (a loop started from each
// thread's own last chunk re-ran different chunks in one pass of a warp:
// 0.32 ms on config2 against 0.29).  K7 went from 0.446 to 0.289 ms on
// config2 and from 0.567 to 0.350 on config2_deep.  A per-thread tape
// sized to the chunk (MAX_SLOTS + c nodes instead of MAX_SLOTS +
// MAX_TAPE) measured the same: local memory interleaves the threads word
// by word, so only the touched entries cost.
//
// K6 is trace_fwd's loop with the carry's stores, and costs about what
// trace_fwd does.  Measured on the H100 (PERF.md §6): the stores are 2-4%
// of it.  Its builds that march, held to 64 registers by a launch bound
// of 256 threads alone, took config5 1.18x trace_fwd's time; in blocks of
// 8 x 4-pixel warps as trace_fwd's and a bound of one block an SM (72
// registers) K6 takes 0.87x its old time on config5, without any bound
// (86-88 registers) 0.82x, but then its straight builds take 72 registers
// and 1.4% more time on config2 and config2_deep, and under a register
// cap of 64 2.5% more.  So the bound asks for four blocks an SM where the
// build does not march: 1.3-1.9% less than the old kernel.  Each thread's
// stack stays in local memory: as columns of the block's shared memory
// (11 words a slot, max_depth + 1 slots) it cost config2 15% and
// config2_deep 21% (two blocks an SM instead of four) and bought config5
// nothing.
//
// Built like trace_bwd.cu, twice (the BUILD_SHAPES builds with
// -DTRACE_SHAPES_BUILDS).

#include "trace_adj.cuh"

namespace {

constexpr int SLOT_WORDS = 11;

struct Chunks {
    int trips, K, c;
    __host__ __device__ int size(int k) const {
        return k < K - 1 ? c : trips - (K - 1) * c;
    }
};

// trips = max_nodes - 1 in K = ceil(trips / chunk_trips) chunks of
// c = ceil(trips / K) trips, the last one trips - (K - 1) c (>= 1)
inline Chunks make_chunks(int max_nodes, int chunk_trips) {
    Chunks ch;
    ch.trips = max_nodes - 1;
    ch.K = (ch.trips + chunk_trips - 1) / chunk_trips;
    ch.c = ch.K > 0 ? (ch.trips + ch.K - 1) / ch.K : 0;
    return ch;
}

__host__ __device__ inline int carry_words(int max_depth) {
    return 1 + SLOT_WORDS * (max_depth + 1);
}

// chunk k's carry of one pixel: its word w at c[w * npix]
__device__ __forceinline__ void store_carry(float* c, size_t npix,
                                            const Slot* stack, int sp) {
    c[0] = __int_as_float(sp);
    for (int j = 0; j < sp; ++j) {
        const Slot& sl = stack[j];
        const float v[SLOT_WORDS] = {
            sl.org.x, sl.org.y, sl.org.z, sl.org.w, sl.dir.x, sl.dir.y,
            sl.dir.z, sl.dir.w, sl.w, __int_as_float(sl.mat),
            __int_as_float(sl.depth)};
        float* q = c + (size_t)(1 + SLOT_WORDS * j) * npix;
#pragma unroll
        for (int w = 0; w < SLOT_WORDS; ++w) q[w * npix] = v[w];
    }
}

// slot j of a carry, with parent j (its virtual tape entry)
__device__ __forceinline__ Slot load_slot(const float* c, size_t npix,
                                          int j) {
    const float* q = c + (size_t)(1 + SLOT_WORDS * j) * npix;
    float v[SLOT_WORDS];
#pragma unroll
    for (int w = 0; w < SLOT_WORDS; ++w) v[w] = q[w * npix];
    return Slot{{v[0], v[1], v[2], v[3]}, {v[4], v[5], v[6], v[7]}, v[8],
                __float_as_int(v[9]), __float_as_int(v[10]), j, 0};
}

// K6 for one pixel: the shading loop, chunk k's carry stored before its
// first trip while the stack is nonempty, the final colour sums into
// acc_out[ch * npix + pixel] (ch < 3) and the count of stored chunks
// into acc_out[3 * npix + pixel].
template <int kB>
__device__ void pixel_seg_fwd(const Scene& s, const float* cam, int x, int y,
                              int H, int W, int rows, Chunks ch, float* carry,
                              float* acc_out) {
    const size_t npix = (size_t)rows * W, pix = (size_t)y * W + x;
    const size_t cstride = (size_t)carry_words(s.max_depth) * npix;
    const V4 d0 = camera_ray(cam, x, y, H, W, nullptr);
    float acc[3] = {0.0f, 0.0f, 0.0f};
    Slot stack[MAX_SLOTS];
    int sp = 0;
    const Slot root{load4(cam), d0, 1.0f, s.ambient, s.max_depth, -1, 0};
    shade<kB>(s, root, 0, acc, stack, &sp, nullptr);
    int k = 0;
    for (int it = 0; it < ch.trips && sp > 0; ++it) {
        if (it == k * ch.c) {
            store_carry(carry + k * cstride + pix, npix, stack, sp);
            ++k;
        }
        --sp;
        const Slot nd = stack[sp];
        shade<kB>(s, nd, it + 1, acc, stack, &sp, nullptr);
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) acc_out[c * npix + pix] = acc[c];
    acc_out[3 * npix + pix] = __int_as_float(k);
}

// A chunk's end: each slot still on the stack that a node of the chunk
// pushed takes its adjoint from the virtual entry of its position.
template <class Tape>
__device__ __forceinline__ void link_to_carry(Tape* tape, const Slot* stack,
                                              int sp) {
    for (int j = 0; j < sp; ++j)
        if (stack[j].parent >= MAX_SLOTS)
            tape[stack[j].parent].child[stack[j].branch] = j;
}

// K7 for one pixel: seed, the stored chunks in reverse from their
// carries, then the peel and the camera ray; adds its gradient (and,
// fused, its loss term) into grad, the textures' into gtex.
template <int kB, int kAcc>
__device__ void pixel_seg_bwd(const Scene& s, const Offs& off,
                              const float* cam, int x, int y, int H, int W,
                              int rows, Chunks ch, const float* carry,
                              const float* acc_in, const float* gin,
                              float norm, bool fused, float* grad,
                              float* gtex) {
    using Tape = TapeNode<has_march(kB)>;
    const size_t npix = (size_t)rows * W, pix = (size_t)y * W + x;
    const size_t cstride = (size_t)carry_words(s.max_depth) * npix;
    float acc[3] = {acc_in[pix], acc_in[npix + pix], acc_in[2 * npix + pix]};
    const int stored = __float_as_int(acc_in[3 * npix + pix]);
    float G[3];
    seed<kAcc>(off, gin, x, y, W, acc, norm, fused, grad, G);
    float scratch[3];   // the re-runs' colour sums, not needed
    Tape tape[MAX_SLOTS + MAX_TAPE];
    Slot stack[MAX_SLOTS];
    // the chunks, last first, then (k = -1) the peel: the primary node,
    // whose children are the first carry's slots.  k runs over every
    // chunk, so that a warp's threads re-run the same chunk together.
    for (int k = ch.K - 1; k >= -1; --k) {
        if (k >= stored) continue;
        int sp0 = 0, sp = 0, n = MAX_SLOTS;
        if (k >= 0) {
            const float* c = carry + k * cstride + pix;
            sp0 = __float_as_int(c[0]);
            for (int j = 0; j < sp0; ++j) {
                stack[j] = load_slot(c, npix, j);
                tape[j].child[0] = -1;
            }
            sp = sp0;
            for (int it = 0; it < ch.size(k) && sp > 0; ++it, ++n) {
                --sp;
                const Slot nd = stack[sp];
                tape[n] = Tape{nd.org, nd.dir, nd.w, nd.mat, nd.depth,
                               {-1, -1}, {}};
                tape[nd.parent].child[nd.branch] = n;
                shade<kB>(s, nd, n, scratch, stack, &sp, &tape[n].rec);
            }
        } else {
            const V4 d0 = camera_ray(cam, x, y, H, W, nullptr);
            const Slot root{load4(cam), d0, 1.0f, s.ambient, s.max_depth, -1,
                            0};
            tape[n] = Tape{root.org, root.dir, root.w, root.mat, root.depth,
                           {-1, -1}, {}};
            shade<kB>(s, root, n, scratch, stack, &sp, &tape[n].rec);
            ++n;
            if (ch.K == 0) sp = 0;   // no trip shades the root's children
        }
        if (k == ch.K - 1)   // the tree's last chunk: slots left unshaded
            for (int j = 0; j < sp; ++j) {
                tape[j].org = vzero();
                tape[j].dir = vzero();
                tape[j].w = 0.0f;
            }
        link_to_carry(tape, stack, sp);
        for (int i = n - 1; i >= MAX_SLOTS; --i) {
            V4 dorg, ddir;
            float dw;
            node_adj<kB, kAcc>(s, off, tape[i], G, tape, grad, gtex,
                               &dorg, &ddir, &dw);
            tape[i].org = dorg;
            tape[i].dir = ddir;
            tape[i].w = dw;
        }
        for (int j = 0; j < sp0; ++j) {
            const int i = tape[j].child[0];
            if (i < 0) continue;
            tape[j].org = tape[i].org;
            tape[j].dir = tape[i].dir;
            tape[j].w = tape[i].w;
        }
    }
    gadd4<kAcc>(grad, 0, tape[MAX_SLOTS].org);
    camera_adj<kAcc>(cam, x, y, H, W, tape[MAX_SLOTS].dir, grad);
}

// K6: one thread per pixel of the row slab, in blocks of seg_fwd_block's
// shape, under a launch bound of four such blocks an SM in the straight
// builds (64 registers) and one in the builds that march (72, no spills).
template <int kB>
__global__ void __launch_bounds__(NTHREADS, has_march(kB) ? 1 : 4)
trace_seg_fwd_kernel(Scene s, const float* __restrict__ cam, int H, int W,
                     int rows, Chunks ch, float* __restrict__ carry,
                     float* __restrict__ acc) {
    const int x = blockIdx.x * blockDim.x + threadIdx.x;
    const int y = blockIdx.y * blockDim.y + threadIdx.y;
    stage_sides<kB>(s);
    if (x < W && y < rows)
        pixel_seg_fwd<kB>(s, cam, x, y, H, W, rows, ch, carry, acc);
}

// K6's block for a build, as trace_fwd.cu's fwd_block: 8 x 32 for the
// builds that march (each warp a tile of 8 x 4 pixels), else 32 x 8.
inline dim3 seg_fwd_block(int build) {
    return has_march(build) ? dim3(8, 32) : dim3(BLOCK_X, BLOCK_Y);
}

// K7: one thread per pixel of the row slab, partial sums as trace_bwd's:
// the threads' gradient vectors in the block's dynamic shared memory
// (ACC_SHARED) or local, as bwd_plan takes them for the tape kernel.
template <int kB, int kAcc>
__global__ void __launch_bounds__(BLOCK_X * BLOCK_Y)
trace_seg_bwd_kernel(Scene s, Offs off, const float* __restrict__ cam, int H,
                     int W, int rows, Chunks ch,
                     const float* __restrict__ carry,
                     const float* __restrict__ acc,
                     const float* __restrict__ gin, float norm, int fused,
                     float* __restrict__ partials, float* gtex) {
    const int x = blockIdx.x * BLOCK_X + threadIdx.x;
    const int y = blockIdx.y * BLOCK_Y + threadIdx.y;
    const int tid = threadIdx.y * BLOCK_X + threadIdx.x;
    float grad_l[kAcc == ACC_SHARED ? 1 : MAX_PARAMS];
    float* const grad = kAcc == ACC_SHARED ? dyn_smem() + tid : grad_l;
    thread_grad<kAcc>(off, grad, partials);
    stage_sides<kB>(s);
    if (x < W && y < rows)
        pixel_seg_bwd<kB, kAcc>(s, off, cam, x, y, H, W, rows, ch, carry,
                                acc, gin, norm, fused != 0, grad, gtex);
    block_partials<kAcc>(off, grad, partials, dyn_smem());
}

// The plan's kernel (trace_adj.cuh bwd_plan): K7.
struct SegKernel {
    template <int kB, int kAcc>
    static auto fn() { return trace_seg_bwd_kernel<kB, kAcc>; }
};

}  // namespace

// The segmented backward (K6, then K7, then the partials' sum): the same
// arguments and gradient vector as euclider_trace_bwd, for any max_nodes,
// and chunk_trips (1 .. 63), carry: scratch of K * carry_words(max_depth)
// * rows * W floats (K = ceil((max_nodes - 1) / chunk_trips)), acc:
// scratch of 4 * rows * W floats (the rendered slab, channel-major, then
// each pixel's count of stored chunks).
extern "C" int euclider_trace_seg(
    const int32_t* const* ints, const float* const* floats, const int* params,
    float t_max, const int* sizes, const float* cam, int H, int W, int rows,
    const float* gin, float norm, int fused, int chunk_trips, float* carry,
    long long carry_len, float* acc, long long acc_len, float* partials,
    long long partials_len, float* out, float* gtex, int device,
    void* stream) {
    const Scene s = make_scene(ints, floats, params, t_max, cam);
    Offs off;
    int rc = check_scene(s, params, sizes, &off);
    if (rc != 0) return rc;
    if (chunk_trips < 1 || chunk_trips > MAX_TAPE)
        return (int)cudaErrorInvalidValue;
    const Chunks ch = make_chunks(s.max_nodes, chunk_trips);
    const int build = scene_build(params);
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (rows <= 0 || W <= 0) return 0;
    const long long npix = (long long)rows * W;
    const dim3 block(BLOCK_X, BLOCK_Y);
    const dim3 grid((W + BLOCK_X - 1) / BLOCK_X, (rows + BLOCK_Y - 1) / BLOCK_Y);
    const long long n_blocks = (long long)grid.x * grid.y;
    if (partials_len < n_blocks * off.n || acc_len < 4 * npix ||
        carry_len < (long long)ch.K * carry_words(s.max_depth) * npix)
        return (int)cudaErrorInvalidValue;
    const dim3 fblock = seg_fwd_block(build);
    const dim3 fgrid((W + fblock.x - 1) / fblock.x,
                     (rows + fblock.y - 1) / fblock.y);
    cudaStream_t st = (cudaStream_t)stream;
    if ((rc = zero_ext(partials, off, n_blocks, st)) != 0) return rc;
    BwdPlan plan;
#define TRACE_SEG_ARGS                                                     \
    s, off, cam, H, W, rows, ch, carry, acc, gin, norm, fused, partials, gtex
#define TRACE_SEG_CASE(kB)                                                 \
    case kB:                                                               \
        trace_seg_fwd_kernel<kB><<<fgrid, fblock, 0, st>>>(                \
            s, cam, H, W, rows, ch, carry, acc);                           \
        err = cudaGetLastError();                                          \
        if (err != cudaSuccess) return (int)err;                           \
        if ((rc = bwd_plan<SegKernel, kB>(off, &plan)) != 0) return rc;    \
        if (plan.acc == ACC_SHARED)                                        \
            trace_seg_bwd_kernel<kB, ACC_SHARED>                           \
                <<<grid, block, plan.bytes, st>>>(TRACE_SEG_ARGS);         \
        else if (plan.acc == ACC_LOCAL)                                    \
            trace_seg_bwd_kernel<kB, ACC_LOCAL>                            \
                <<<grid, block, plan.bytes, st>>>(TRACE_SEG_ARGS);         \
        else                                                               \
            trace_seg_bwd_kernel<kB, ACC_WIDE>                             \
                <<<grid, block, plan.bytes, st>>>(TRACE_SEG_ARGS);         \
        break;
    TRACE_BWD_BUILDS(TRACE_SEG_CASE)
#undef TRACE_SEG_CASE
#undef TRACE_SEG_ARGS
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    sum_partials_kernel<<<off.n, RED_THREADS, 0, st>>>(
        partials, (int)n_blocks, out);
    return (int)cudaGetLastError();
}
