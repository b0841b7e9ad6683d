// probe_cluster.cuh - one thread-block cluster over a probe's tile, for
// Hopper (sm_90a): the tile's sum in a fixed order, the tile's any(), and
// the launch.  Included by probe_march.cu (P1), probe_mosaic.cu (P2, P4
// and P5) and probe_rev.cu (P6).
//
// A probe's input is one (8, 128) tile, and its time is one lane's chain
// of dependent steps: the work is far below the card, so the tile is
// spread as thinly as it goes, a lane a thread, in one cluster of up to
// CLUSTER_BLOCKS blocks of CLUSTER_THREADS threads (one warp a scheduler
// on each of 8 SMs).  A cluster's barrier and distributed shared memory
// let every block read every block's partial in rank order, so every lane
// gets the same bits, and none acts before the whole tile is known.  A
// lane at or past n still reaches every barrier and adds 0 (or false).
// cluster_sum reads the other blocks' partials after one barrier and
// waits at a second before any block leaves; cluster_push_sum (P2, P4)
// gives the same bits under one barrier after the lanes' work, each block
// writing its partial into every block's shared memory before it (on the
// H100 0.0006 ms less a launch, PERF.md §6).
//
// Off the card (tools/kernel_harness.py) the stand-in of
// tools/cuda_stub/cooperative_groups.h only compiles these (without the
// barrier's PTX, under __CUDA_ARCH__): the harness runs the lanes' device
// functions and takes the tile's sums itself.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int CLUSTER_THREADS = 128;   // lanes a block
constexpr int CLUSTER_BLOCKS = 8;      // blocks a cluster: the portable most
constexpr int CLUSTER_LANES = CLUSTER_THREADS * CLUSTER_BLOCKS;

// The tile's sum of the lanes' values v in the fixed order: warp
// shuffles, the block's warps in order, then after the cluster's barrier
// the blocks' partials in rank order, read from each block's shared
// memory; every thread of the cluster returns the same bits.
__device__ __forceinline__ float cluster_sum(float v) {
    __shared__ float red[CLUSTER_THREADS / 32];
    __shared__ float part;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
    __syncthreads();
    if (threadIdx.x == 0) {
        float b = 0.0f;
#pragma unroll
        for (int k = 0; k < CLUSTER_THREADS / 32; ++k) b += red[k];
        part = b;
    }
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    float sum = 0.0f;
    const int nb = (int)cluster.num_blocks();
    for (int r = 0; r < nb; ++r) sum += *cluster.map_shared_rank(&part, r);
    cluster.sync();   // no block leaves while another reads its partial
    return sum;
}

// The cluster barrier's arrival at a kernel's start (relaxed: it orders no
// memory).  cluster_push_sum waits on it before it writes into another
// block's shared memory, which is safe only once every block has started.
__device__ __forceinline__ void cluster_arrive() {
#ifdef __CUDA_ARCH__
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
#endif
}

// cluster_sum's value, in its order, under one cluster barrier after the
// lanes' work: each block pushes its partial into slot rank of every
// block's shared memory before the barrier, and after it reads only its
// own slots, in rank order.  The kernel calls cluster_arrive() first.
__device__ __forceinline__ float cluster_push_sum(float v) {
    __shared__ float red[CLUSTER_THREADS / 32];
    __shared__ float slot[CLUSTER_BLOCKS];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
    __syncthreads();
#ifdef __CUDA_ARCH__
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
#endif
    cg::cluster_group cluster = cg::this_cluster();
    const int nb = (int)cluster.num_blocks();
    if ((int)threadIdx.x < nb) {   // thread r pushes to block r
        float b = 0.0f;
#pragma unroll
        for (int k = 0; k < CLUSTER_THREADS / 32; ++k) b += red[k];
        *cluster.map_shared_rank(&slot[cluster.block_rank()],
                                 (int)threadIdx.x) = b;
    }
    cluster.sync();
    float sum = 0.0f;
    for (int r = 0; r < nb; ++r) sum += slot[r];
    return sum;
}

// Whether p holds on any lane of the tile, the same in every thread: each
// block's __syncthreads_or, then after the cluster's barrier every
// block's flag.  No block may leave before the cluster's next barrier
// (cluster_sum's), which keeps its flag readable.
__device__ __forceinline__ bool cluster_any(bool p) {
    __shared__ int flag;
    const int b = __syncthreads_or(p);
    if (threadIdx.x == 0) flag = b;
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    int any = 0;
    const int nb = (int)cluster.num_blocks();
    for (int r = 0; r < nb; ++r) any |= *cluster.map_shared_rank(&flag, r);
    return any != 0;
}

// One launch of kernel(args...) over n lanes: one cluster of
// ceil(n / CLUSTER_THREADS) blocks of CLUSTER_THREADS threads, on the
// stream -> 0 or a cudaError (cudaErrorInvalidValue for n outside 1 to
// CLUSTER_LANES; a refused launch is an error, never another shape).
template <class... Params, class... Args>
cudaError_t launch_cluster(void (*kernel)(Params...), int n,
                           cudaStream_t stream, Args... args) {
    if (n <= 0 || n > CLUSTER_LANES) return cudaErrorInvalidValue;
    const unsigned blocks = (n + CLUSTER_THREADS - 1) / CLUSTER_THREADS;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(blocks);
    cfg.blockDim = dim3(CLUSTER_THREADS);
    cfg.dynamicSmemBytes = 0;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = blocks;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}

}  // namespace
