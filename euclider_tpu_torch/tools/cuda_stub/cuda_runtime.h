// Host stand-ins for the CUDA device code of csrc/, so that g++ compiles
// its sources (cut at their extern "C" entry points) into CPU libraries:
// tools/kernel_harness.py.  The intrinsics round as on the card (__fmul_rn
// and friends are plain IEEE operations; the harness builds with
// -ffp-contract=off, as nvcc builds with -fmad=false).  The block-wide
// operations stand in for one thread only: the harness's entries reduce
// over a tile themselves, or run a block's phases (the code between two
// __syncthreads) over every thread in turn, on buffers of their own: the
// block's dynamic shared memory (extern __shared__ on the card, which the
// device code takes through dyn_smem()) has no host stand-in, and the
// launch attributes and the occupancy query are the card's alone.
#pragma once
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
using std::max;
using std::min;
#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(...)
#define __shared__ static
struct dim3 {
    unsigned x = 1, y = 1, z = 1;
    dim3() {}
    dim3(unsigned a, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
static thread_local dim3 blockIdx, threadIdx, blockDim, gridDim;
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1,
       cudaErrorInvalidDevice = 101 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
inline int cudaSetDevice(int) { return 0; }
inline int cudaGetDevice(int* d) {
    *d = 0;
    return 0;
}
template <class F>
inline int cudaFuncSetAttribute(F, cudaFuncAttribute, int) {
    return cudaErrorInvalidValue;
}
// the cluster launch of csrc/probe_cluster.cuh: declared, never launched
struct cudaLaunchAttribute {
    int id;
    struct {
        dim3 clusterDim;
    } val;
};
enum { cudaLaunchAttributeClusterDimension = 4 };
struct cudaLaunchConfig_t {
    dim3 gridDim, blockDim;
    size_t dynamicSmemBytes;
    cudaStream_t stream;
    cudaLaunchAttribute* attrs;
    unsigned numAttrs;
};
template <class F, class... A>
inline int cudaLaunchKernelEx(const cudaLaunchConfig_t*, F, A...) {
    return cudaErrorInvalidValue;
}
template <class F>
inline int cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F, int,
                                                        size_t) {
    *n = 0;
    return cudaErrorInvalidValue;
}
inline float* dyn_smem() { return nullptr; }
inline int cudaGetLastError() { return 0; }
inline void __syncthreads() {}
inline void __syncwarp(unsigned = 0xffffffffu) {}
inline int __syncthreads_or(int p) { return p; }
inline float __shfl_down_sync(unsigned, float v, int) { return v; }
inline float __shfl_xor_sync(unsigned, float v, int) { return v; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float rsqrtf(float x) { return 1.0f / std::sqrt(x); }
inline float __int_as_float(int i) {
    float f;
    std::memcpy(&f, &i, 4);
    return f;
}
inline float __ldg(const float* p) { return *p; }
inline float atomicAdd(float* p, float v) {
    const float o = *p;
    *p += v;
    return o;
}
inline int __float_as_int(float f) {
    int i;
    std::memcpy(&i, &f, 4);
    return i;
}
inline int cudaMemsetAsync(void* p, int v, size_t n, cudaStream_t) {
    std::memset(p, v, n);
    return 0;
}
