// Host stand-ins for the CUDA device code of csrc/, so that g++ compiles
// trace_fwd.cu and trace_bwd.cu (cut at their extern "C" entry points) into
// a CPU library: tools/kernel_harness.py.  The intrinsics round as on the
// card (__fmul_rn and friends are plain IEEE operations); with FMA_EMU
// they are kept out of line so that -ffp-contract=fast contracts only what
// nvcc's default -fmad=true could.
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
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline int cudaSetDevice(int) { return 0; }
inline int cudaGetLastError() { return 0; }
inline void __syncthreads() {}
inline float __shfl_down_sync(unsigned, float v, int) { return v; }
#ifdef FMA_EMU
#define RN_ATTR __attribute__((noinline))
#else
#define RN_ATTR inline
#endif
RN_ATTR float __fmul_rn(float a, float b) { return a * b; }
RN_ATTR float __fadd_rn(float a, float b) { return a + b; }
RN_ATTR float __fsub_rn(float a, float b) { return a - b; }
RN_ATTR float __fdiv_rn(float a, float b) { return a / b; }
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
