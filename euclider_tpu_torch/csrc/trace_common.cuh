// trace_common.cuh - the device code of one ray-tree node, shared by the
// forward kernel (trace_fwd.cu) and the backward kernels (trace_bwd.cu,
// trace_seg.cu).
//
// All of them shade nodes with these functions, so the backward's forward
// sweep takes the branches the forward kernel took: a rounding that flips
// a hit, a total internal reflection or a path-weight cut flips it in both.
// Every expression keeps the arithmetic order of the JAX package
// (euclider_tpu/ops/trace.py, geometry.py, shading.py, mathx.py) and of the
// port's plain version (euclider_tpu_torch/ops/), so the kernels agree with
// them to float32 rounding.  Compiled without --use_fast_math: sqrtf,
// division, floorf and sinf stay IEEE float32 / full-range libm.
//
// Supported: every feature of the JAX package's render: sphere, half-space,
// hyperplane and cylinder leaves with their UV maps and CSG composites of
// them (union, intersection, difference, symdiff, complement); uniform,
// checker, smooth, perlin and texture surfaces; vacuum, dielectric,
// attractor ('warp') and expression ('expr') materials, whose rays march
// (ops/march.py); portals; textures of any size on a side.  The Python
// wrappers cast every table and the camera to float32 and refuse, before
// launching, only textures of 2^31 floats or more together (tex_cell's
// int32 offsets); a scene past a capacity of the default build takes a
// wider build (below).
//
// A CSG entity's shape tree is one post-order range of nodes
// [ent_first, ent_root]; membership is one pass over it with one bit per
// node (no recursion), in the words of a Bits.  A leaf's crossing is a
// boundary of the composite where membership flips between t - PROBE and
// t + PROBE, probed with uncontracted arithmetic as the plain version
// computes the probe points.
// The perlin lattice hash is native uint32 wraparound; the lattice and
// texel coordinates, whose floorf decides a discrete cell, are uncontracted
// too.  A texture is sampled by gathering its four texels from global
// memory (__ldg) and weighting them in float32, as the plain version's
// gather does (no texture objects: their filter weights are 9-bit fixed
// point).
//
// The march repeats its step up to 320 times, which would amplify any
// rounding difference from the plain version: its arithmetic (the step,
// the side tests, the bisection, the expression VM) is written with
// __fmul_rn / __fadd_rn / __fdiv_rn, so nvcc contracts nothing into an FMA
// and every operation rounds as the plain version's separate torch
// operations do; the VM's sinf, cosf, tanhf, expf, logf and sqrtf are the
// libm functions torch's CUDA operators call.  Every library is compiled
// with -fmad=false besides (ops/cuda_kernel.py), so the rest of the device
// code is not contracted either.
//
// A march step tests every entity's side.  Read through the scene's
// pointers, that is a chain of dependent loads an entity (ent_root, then
// node_kind and node_row, then shape_vec and shape_sc), the same for every
// thread of the grid, and the longest marches (up to 960 steps a thread on
// config5) wait on it step after step: measured on the H100 (PERF.md §6),
// the march's share of a warp's lanes that step is 73-85% under warps of
// a pixel row, so the cost is each step's latency, not divergence.  Every
// kernel that marches therefore stages a side table (per entity: the root's
// kind, centre or normal row and scalar) into the block's shared memory
// once (stage_sides), and side() and bisect() read it: the same values in
// the same arithmetic, so every result keeps its bits.  A build of more
// than SIDE_TABLE_MAX entities reads each row from the scene's arrays
// instead (side_row), so that no block's shared memory limits a scene.
//
// Six builds of every kernel (the template parameter kB, a set of BUILD_*
// bits): straight space, + the march with the attractor field and the
// portal teleport, + the expression VM; each with or without the shapes
// and surfaces beyond spheres, planes and uniform, checker and smooth
// colour (BUILD_SHAPES: CSG, cylinders, perlin, textures).  Each launch
// takes the smallest build that renders its scene, so a scene runs no code
// of a feature it does not have.  The BUILD_SHAPES builds live in a second
// library of each kernel (TRACE_SHAPES_BUILDS).  The tape backward adds a
// bit of its own, which no other kernel takes: BUILD_TAPE, its forward
// sweep recording each marched node's checkpoints (march).  A texture or
// a noise
// surface multiplies any rounding of the hit point or its UV by its UV
// scale (up to 32 cells a unit in perlin_probe): contracted, 0.1% of
// config3's pixels moved past 1e-4 and perlin_probe's camera gradient past
// its tolerance, and deep mirror-glass trees moved pixels of config2,
// grad_probe and fresnel_probe (PERF.md §6), hence -fmad=false everywhere.
//
// Five capacities size a thread's arrays: the DFS stack's slots, the shape
// nodes of one entity (membership's bits), the VM instructions of one
// material (its values), the entities of a marching scene (the side
// masks' bits and the side table) and the march checkpoints of the
// backward (MarchTape).  Each is a compile-time parameter of the build,
// today's value unless the library is built with -DTRACE_MAX_* (the
// macros below): a scene past one takes, at first use, a build whose
// capacity is the next power of two that holds it
// (ops/cuda_kernel.py::capacities), so the default builds stay exactly as
// they were and only a wider scene pays for its wider arrays.

#pragma once

#include <cuda_runtime.h>
#include <cstdint>

namespace trace {

#ifndef TRACE_MAX_SLOTS
#define TRACE_MAX_SLOTS 16
#endif
#ifndef TRACE_MAX_EXPR
#define TRACE_MAX_EXPR 128
#endif
#ifndef TRACE_MAX_NODES
#define TRACE_MAX_NODES 32
#endif
#ifndef TRACE_MAX_MARCH_ENTITIES
#define TRACE_MAX_MARCH_ENTITIES 32
#endif
#ifndef TRACE_MAX_MARCH_CK
#define TRACE_MAX_MARCH_CK 32
#endif
constexpr int MAX_SLOTS = TRACE_MAX_SLOTS;  // DFS stack: max_depth + 1 slots
constexpr int MAX_EXPR = TRACE_MAX_EXPR;    // VM instructions of a material
constexpr int MAX_NODES = TRACE_MAX_NODES;  // shape nodes of one entity
// a marching scene's entities: a side bit each
constexpr int MAX_MARCH_ENTITIES = TRACE_MAX_MARCH_ENTITIES;
// the most entities whose side table a block stages in shared memory (32 KB)
constexpr int SIDE_TABLE_MAX = 1024;
constexpr float PROBE = 2e-4f;    // CSG membership probe offset
constexpr float EPS_T = 1e-4f;    // minimum accepted hit distance
constexpr float PUSH = 1e-3f;     // offset of a secondary ray's origin
constexpr float W_EPS = 1e-4f;    // path-weight cutoff for a push

// codes of oracle/native_oracle.py NODE_KINDS / SURF_KINDS
enum : int {
    NODE_SPHERE = 0, NODE_HYPERPLANE, NODE_HALFSPACE, NODE_CYLINDER,
    NODE_UNION, NODE_INTERSECTION, NODE_DIFFERENCE, NODE_SYMDIFF,
    NODE_COMPLEMENT
};
constexpr int SURF_UNIFORM = 0;
constexpr int SURF_CHECKER = 1;
constexpr int SURF_SMOOTH = 2;
constexpr int SURF_TEXTURE = 3;
constexpr int SURF_PERLIN = 4;
// Scene::mat_warp: how a material's rays travel
constexpr int MAT_STRAIGHT = 0;
constexpr int MAT_ATTRACTOR = 1;
constexpr int MAT_EXPR = 2;

// the builds (template parameter kB of shade and the kernels): bits
constexpr int BUILD_STRAIGHT = 0;  // no march, no portal
constexpr int BUILD_MARCH = 1;     // + the march (attractor field), portals
constexpr int BUILD_VM = 2;        // + the expression VM (with BUILD_MARCH)
constexpr int BUILD_SHAPES = 4;    // + CSG, cylinders, perlin, textures
constexpr int BUILD_TAPE = 8;      // the march records its checkpoints
constexpr int BUILD_WARP = BUILD_MARCH;
constexpr int BUILD_EXPR = BUILD_MARCH | BUILD_VM;
__host__ __device__ constexpr bool has_march(int kB) {
    return (kB & BUILD_MARCH) != 0;
}
__host__ __device__ constexpr bool has_vm(int kB) {
    return (kB & BUILD_VM) != 0;
}
__host__ __device__ constexpr bool has_shapes(int kB) {
    return (kB & BUILD_SHAPES) != 0;
}
__host__ __device__ constexpr bool has_march_rec(int kB) {
    return (kB & BUILD_TAPE) != 0 && has_march(kB);
}

constexpr float PI_F = 3.141592653589793f;
constexpr float HALF_PI_F = 1.5707963267948966f;
constexpr float TWO_PI_F = 6.283185307179586f;
constexpr float INV_TWO_PI_F = (float)(0.5 / 3.141592653589793);
constexpr float CZ_LO = (float)(-1.0 + 1e-6);   // pole clip of sphere UV
constexpr float CZ_HI = (float)(1.0 - 1e-6);

struct V4 {
    float x, y, z, w;
};

__device__ __forceinline__ V4 add(V4 a, V4 b) {
    return {a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w};
}
__device__ __forceinline__ V4 sub(V4 a, V4 b) {
    return {a.x - b.x, a.y - b.y, a.z - b.z, a.w - b.w};
}
__device__ __forceinline__ V4 scale(V4 a, float s) {
    return {a.x * s, a.y * s, a.z * s, a.w * s};
}
__device__ __forceinline__ V4 madd(V4 a, float s, V4 b) {  // a + s * b
    return {a.x + s * b.x, a.y + s * b.y, a.z + s * b.z, a.w + s * b.w};
}
__device__ __forceinline__ float dot(V4 a, V4 b) {
    return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}
__device__ __forceinline__ V4 normalize(V4 a) {
    return scale(a, rsqrtf(dot(a, a) + 1e-20f));
}
__device__ __forceinline__ V4 load4(const float* p) {
    return {p[0], p[1], p[2], p[3]};
}
__device__ __forceinline__ V4 axis(int i) {
    return {i == 0 ? 1.0f : 0.0f, i == 1 ? 1.0f : 0.0f,
            i == 2 ? 1.0f : 0.0f, i == 3 ? 1.0f : 0.0f};
}
__device__ __forceinline__ float comp(V4 a, int i) {
    return i == 0 ? a.x : i == 1 ? a.y : i == 2 ? a.z : a.w;
}
// y = m x for a row-major 4x4 matrix m
__device__ __forceinline__ V4 matvec(const float* m, V4 v) {
    return {m[0] * v.x + m[1] * v.y + m[2] * v.z + m[3] * v.w,
            m[4] * v.x + m[5] * v.y + m[6] * v.z + m[7] * v.w,
            m[8] * v.x + m[9] * v.y + m[10] * v.z + m[11] * v.w,
            m[12] * v.x + m[13] * v.y + m[14] * v.z + m[15] * v.w};
}
// y = m^T x
__device__ __forceinline__ V4 matvec_t(const float* m, V4 v) {
    return {m[0] * v.x + m[4] * v.y + m[8] * v.z + m[12] * v.w,
            m[1] * v.x + m[5] * v.y + m[9] * v.z + m[13] * v.w,
            m[2] * v.x + m[6] * v.y + m[10] * v.z + m[14] * v.w,
            m[3] * v.x + m[7] * v.y + m[11] * v.z + m[15] * v.w};
}

// --- uncontracted arithmetic: the march's (see the note at the top) -------

__device__ __forceinline__ float dot_rn(V4 a, V4 b) {
    return __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(a.x, b.x),
                                         __fmul_rn(a.y, b.y)),
                               __fmul_rn(a.z, b.z)),
                     __fmul_rn(a.w, b.w));
}
__device__ __forceinline__ V4 scale_rn(V4 a, float s) {
    return {__fmul_rn(a.x, s), __fmul_rn(a.y, s), __fmul_rn(a.z, s),
            __fmul_rn(a.w, s)};
}
__device__ __forceinline__ V4 madd_rn(V4 a, float s, V4 b) {  // a + s * b
    return {__fadd_rn(a.x, __fmul_rn(s, b.x)), __fadd_rn(a.y, __fmul_rn(s, b.y)),
            __fadd_rn(a.z, __fmul_rn(s, b.z)), __fadd_rn(a.w, __fmul_rn(s, b.w))};
}
__device__ __forceinline__ V4 normalize_rn(V4 a) {
    return scale_rn(a, rsqrtf(__fadd_rn(dot_rn(a, a), 1e-20f)));
}
// a (1 - l) + b l, the point of a march segment at parameter l
__device__ __forceinline__ V4 lerp_rn(V4 a, V4 b, float l) {
    const float k = 1.0f - l;
    return {__fadd_rn(__fmul_rn(a.x, k), __fmul_rn(b.x, l)),
            __fadd_rn(__fmul_rn(a.y, k), __fmul_rn(b.y, l)),
            __fadd_rn(__fmul_rn(a.z, k), __fmul_rn(b.z, l)),
            __fadd_rn(__fmul_rn(a.w, k), __fmul_rn(b.w, l))};
}

// --- ops/mathx.py: the polynomial atan family -----------------------------

// the coefficients of mathx._ATAN_COEFFS, lowest order first
#define TRACE_ATAN_COEFFS                                                  \
    9.999999975460e-01f, -3.333328229551e-01f, 1.999823064038e-01f,       \
        -1.426157368032e-01f, 1.094019896528e-01f, -8.372063948415e-02f,  \
        5.746355785479e-02f, -3.071750891086e-02f, 1.068071944976e-02f,   \
        -1.743701144660e-03f

// atan on |x| <= 1: x * P(x^2), Horner from the highest coefficient
__device__ __forceinline__ float atan_core(float x) {
    constexpr float C[10] = {TRACE_ATAN_COEFFS};
    const float t = x * x;
    float acc = C[9];
#pragma unroll
    for (int i = 8; i >= 0; --i) acc = acc * t + C[i];
    return x * acc;
}
__device__ __forceinline__ float atan_p(float x) {
    const float ax = fabsf(x);
    const bool big = ax > 1.0f;
    const float inv = 1.0f / (big ? ax : 1.0f);
    const float core = atan_core(big ? inv : ax);
    const float res = big ? HALF_PI_F - core : core;
    return x < 0.0f ? -res : res;
}
__device__ __forceinline__ float atan2_p(float y, float x) {
    const float safe_x = x == 0.0f ? 1.0f : x;
    const float base = atan_p(y / safe_x);
    if (x > 0.0f) return base;
    if (x < 0.0f) return base + (y < 0.0f ? -PI_F : PI_F);
    return y == 0.0f ? 0.0f : (y < 0.0f ? -HALF_PI_F : HALF_PI_F);
}
__device__ __forceinline__ float acos_p(float x) {  // callers clip |x| < 1
    const float s = sqrtf(fmaxf(1.0f - x * x, 1e-12f));
    return HALF_PI_F - atan_p(x / s);
}
// mathx.asin, uncontracted (the VM's): atan(x / sqrt(max(1 - x^2, 1e-12)))
__device__ __forceinline__ float asin_p(float x) {
    const float s = sqrtf(fmaxf(__fsub_rn(1.0f, __fmul_rn(x, x)), 1e-12f));
    return atan_p(__fdiv_rn(x, s));
}

// --- the scene --------------------------------------------------------------

struct Scene {
    const int32_t *ent_root, *ent_mat, *ent_surf;  // per entity
    const int32_t *ent_portal;                     // portal row, -1 for none
    const int32_t *node_kind, *node_row;           // per shape node
    const int32_t *surf_kind;                      // per surface
    const int32_t *mat_warp;                       // per material: MAT_*
    const int32_t *expr_off;   // [4 M + 1] start of material m's component
                               // program c at 4 m + c (expressions only)
    const int32_t *expr_code;  // [L, 4] VM instructions (see vm_eval)
    const int32_t *node_cstart, *node_ccount;      // a composite's children:
    const int32_t *child_idx;  // child_idx[cstart .. cstart + ccount)
    const int32_t *ent_first;  // first node of the entity's post-order range
    const int32_t *surf_aux;   // [U, 2]: perlin (octaves, seed * 974711 mod
                               // 2^32), texture (texture id, 0)
    const int32_t *tex_info;   // [T, 3]: offset in tex, height, width
    const float *shape_vec, *shape_sc;             // [S, 4], [S]
    const float *mat_ior;                          // [M]
    const float *surf_color, *surf_color2;         // [U, 4]
    const float *surf_refl, *surf_fresnel, *surf_uv_scale;  // [U]
    const float *background;                       // [3]
    const float *warp_center, *warp_strength, *warp_step;  // [M, 4], [M], [M]
    const float *portal_lin, *portal_tr;           // [P, 4, 4], [P, 4]
    const float *expr_params;                      // [M, 8] p0..p7
    const float *tex;    // the textures' [h, w, 3] texels, back to back
    const float *time;   // the scene time t: &cam[17], set by the entry point
    int n_ent, ambient, max_depth, max_nodes, dim, march_steps;
    float t_max;
};

// The entry points' scene arguments, as host arrays of device pointers:
//   ints:   ent_root, ent_mat, ent_surf, ent_portal, node_kind, node_row,
//           surf_kind, mat_warp, expr_off, expr_code, node_cstart,
//           node_ccount, child_idx, ent_first, surf_aux, tex_info
//           (ops/cuda_kernel.py::encode_scene);
//   floats: the tables in ops/cuda_kernel.py FLOAT_FIELDS order, then the
//           textures' texels;
//   params: n_ent, ambient, max_depth, max_nodes, dim, march_steps (0 when
//           no material marches and no entity is a portal), expr (1 when a
//           material is an expression), shapes (1 when the scene has a CSG
//           node, a cylinder, or a perlin or texture surface).
constexpr int N_INTS = 16, N_FLOATS = 16, N_PARAMS = 8;

inline Scene make_scene(const int32_t* const* i, const float* const* f,
                        const int* prm, float t_max, const float* cam) {
    return Scene{i[0], i[1], i[2], i[3], i[4], i[5], i[6], i[7], i[8], i[9],
                 i[10], i[11], i[12], i[13], i[14], i[15],
                 f[0], f[1], f[2], f[3], f[4], f[5], f[6], f[7], f[8],
                 f[9], f[10], f[11], f[12], f[13], f[14], f[15], cam + 17,
                 prm[0], prm[1], prm[2], prm[3], prm[4], prm[5], t_max};
}

// The build that renders a scene of these params.
inline int scene_build(const int* prm) {
    const int warp = prm[5] == 0 ? BUILD_STRAIGHT
                                 : prm[6] ? BUILD_EXPR : BUILD_WARP;
    return warp | (prm[7] ? BUILD_SHAPES : 0);
}

struct Slot {  // one deferred branch of the ray tree
    V4 org, dir;
    float w;
    int mat, depth;
    int parent, branch;  // the node that pushed it; 0 transmit, 1 reflect
};

// The discrete decisions of one shaded node: what the backward sweep must
// not decide again.  Only the builds that march record a march's end, so
// the straight build's tape entry carries no march words.
template <bool kWarp>
struct NodeRec {
    int ent;    // winning entity, -1 on a miss
    int root;   // (winning leaf - ent_first) << 1 | which root of a sphere
                // or cylinder won (0: -b - sq, 1: -b + sq)
    int flip;   // the normal was turned against the ray
    int m_to;   // material past the surface (transmission only)
};
template <>
struct NodeRec<true> {
    int ent, root, flip, m_to;
    int n;      // marched node: steps walked, round(dist / h)
    float lam;  // marched node: bisection parameter of the winning crossing
};

__device__ __forceinline__ void set_rec(NodeRec<false>* r, int ent, int root,
                                        int, float) {
    *r = NodeRec<false>{ent, root, 0, 0};
}
__device__ __forceinline__ void set_rec(NodeRec<true>* r, int ent, int root,
                                        int n, float lam) {
    *r = NodeRec<true>{ent, root, 0, 0, n, lam};
}

// Two orthonormal tangents of a plane: Gram-Schmidt the coordinate axes of
// the two smallest |n| components among the first dim (strict '<' argmin).
__device__ __forceinline__ void tangent_axes(V4 n, int dim, int* a, int* b) {
    const float big = 1e9f;
    const float c[4] = {fabsf(n.x), fabsf(n.y), fabsf(n.z), fabsf(n.w)};
    *a = 0;
    *b = 0;
    float best = big + 1.0f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const float v = i < dim ? c[i] : big;
        if (v < best) { best = v; *a = i; }
    }
    best = big + 1.0f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const float v = (i < dim && i != *a) ? c[i] : big;
        if (v < best) { best = v; *b = i; }
    }
}

__device__ __forceinline__ void tangent_frame(V4 n, int dim, V4* t1, V4* t2) {
    int a, b;
    tangent_axes(n, dim, &a, &b);
    const V4 ea = axis(a), eb = axis(b);
    *t1 = normalize(madd(ea, -dot(n, ea), n));
    const V4 t = madd(eb, -dot(n, eb), n);
    *t2 = normalize(madd(t, -dot(*t1, t), *t1));
}

// One bit for each of kW * 32 items: bit k in word k / 32 (get: 0 or 1).
// One word is a plain uint32_t (no division, no array), and the default
// builds' expressions on it are the old single-word code's.
template <int kW>
struct Bits {
    uint32_t w[kW];
    __device__ __forceinline__ void clear() {
        for (int i = 0; i < kW; ++i) w[i] = 0u;
    }
    __device__ __forceinline__ uint32_t get(int k) const {
        return w[k >> 5] >> (k & 31) & 1u;
    }
    __device__ __forceinline__ void put(int k, bool v) {
        w[k >> 5] |= (uint32_t)v << (k & 31);
    }
    __device__ __forceinline__ bool differs(const Bits& o) const {
        for (int i = 0; i < kW; ++i)
            if (w[i] != o.w[i]) return true;
        return false;
    }
    __device__ __forceinline__ bool any() const {
        for (int i = 0; i < kW; ++i)
            if (w[i]) return true;
        return false;
    }
    __device__ __forceinline__ Bits operator^(const Bits& o) const {
        Bits r;
        for (int i = 0; i < kW; ++i) r.w[i] = w[i] ^ o.w[i];
        return r;
    }
};
template <>
struct Bits<1> {
    uint32_t w;
    __device__ __forceinline__ void clear() { w = 0u; }
    __device__ __forceinline__ uint32_t get(int k) const {
        return w >> k & 1u;
    }
    __device__ __forceinline__ void put(int k, bool v) {
        w |= (uint32_t)v << k;
    }
    __device__ __forceinline__ bool differs(const Bits& o) const {
        return w != o.w;
    }
    __device__ __forceinline__ bool any() const { return w != 0u; }
    __device__ __forceinline__ Bits operator^(const Bits& o) const {
        return Bits{w ^ o.w};
    }
};
using NodeBits = Bits<(MAX_NODES + 31) / 32>;
using SideMask = Bits<(MAX_MARCH_ENTITIES + 31) / 32>;

// --- membership (geometry.py::member), uncontracted as the plain version's
// separate operations round (cylinders and composites exist only in the
// BUILD_SHAPES builds) ------------------------------------------------------

// (p - c) less its component along the unit axis a: a cylinder's radial part
__device__ __forceinline__ V4 cyl_radial(V4 p, V4 c, V4 a) {
    const V4 pc = sub(p, c);
    return madd(pc, -dot(pc, a), a);
}

// Is p inside leaf `node`?  A hyperplane contains no point.
template <bool kShapes>
__device__ __forceinline__ bool leaf_member(const Scene& s, int node, V4 p) {
    const int row = s.node_row[node];
    const int kind = s.node_kind[node];
    const V4 c = load4(s.shape_vec + 4 * row);
    const float sc = s.shape_sc[row];
    if (kind == NODE_SPHERE) {
        const V4 q = sub(p, c);
        return dot_rn(q, q) < __fmul_rn(sc, sc);
    }
    if (kind == NODE_HYPERPLANE) return false;
    if (kShapes && kind == NODE_CYLINDER) {
        const V4 q = cyl_radial(p, c, load4(s.shape_vec + 4 * row + 4));
        return dot(q, q) < sc * sc;
    }
    return dot_rn(c, p) < sc;  // NODE_HALFSPACE
}

// Is p inside entity e's shape?  A composite is one pass over its
// post-order node range with one bit per node (MAX_NODES of them): every
// child precedes its parent, so a composite combines bits already set.
template <bool kShapes>
__device__ __forceinline__ bool member(const Scene& s, int e, V4 p) {
    const int root = s.ent_root[e];
    if constexpr (kShapes) {
        const int first = s.ent_first[e];
        if (first != root) {
            NodeBits bits;
            bits.clear();
            for (int i = first; i <= root; ++i) {
                const int kind = s.node_kind[i];
                bool in;
                if (kind <= NODE_CYLINDER) {
                    in = leaf_member<true>(s, i, p);
                } else {
                    const int32_t* ch = s.child_idx + s.node_cstart[i];
                    const int nc = s.node_ccount[i];
                    in = bits.get(ch[0] - first);
                    switch (kind) {
                        case NODE_UNION:
                            for (int j = 1; j < nc; ++j)
                                in = in || bits.get(ch[j] - first);
                            break;
                        case NODE_INTERSECTION:
                            for (int j = 1; j < nc; ++j)
                                in = in && bits.get(ch[j] - first);
                            break;
                        case NODE_DIFFERENCE:
                            in = in && !bits.get(ch[1] - first);
                            break;
                        case NODE_SYMDIFF:
                            for (int j = 1; j < nc; ++j)
                                in = in != (bits.get(ch[j] - first) != 0);
                            break;
                        default:  // NODE_COMPLEMENT
                            in = !in;
                    }
                }
                bits.put(i - first, in);
            }
            return bits.get(root - first);
        }
    }
    return leaf_member<kShapes>(s, root, p);
}

// first entity (scene order) containing p, else the ambient material
template <bool kShapes>
__device__ __forceinline__ int material_at(const Scene& s, V4 p) {
    for (int e = 0; e < s.n_ent; ++e)
        if (member<kShapes>(s, e, p)) return s.ent_mat[e];
    return s.ambient;
}

// --- the march (ops/march.py) -----------------------------------------------

constexpr int BISECT_ITERS = 10;

// The march's side table: what side() reads of each entity, staged into
// the block's shared memory once a launch (stage_sides), in the builds of
// at most SIDE_TABLE_MAX entities.
struct SideRow {
    V4 c;       // the root's centre or normal row (a leaf; else zero)
    float sc;   // its scalar
    int kind;   // the root's node kind
    int pad[2];
};
constexpr bool SIDE_TABLE = MAX_MARCH_ENTITIES <= SIDE_TABLE_MAX;
__shared__ SideRow side_rows[SIDE_TABLE ? MAX_MARCH_ENTITIES : 1];

// Entity e's row of the side table, from the scene's arrays.
__device__ __forceinline__ SideRow side_row(const Scene& s, int e) {
    const int node = s.ent_root[e];
    SideRow r{{0.0f, 0.0f, 0.0f, 0.0f}, 0.0f, s.node_kind[node], {0, 0}};
    if (r.kind <= NODE_CYLINDER) {
        const int row = s.node_row[node];
        r.c = load4(s.shape_vec + 4 * row);
        r.sc = s.shape_sc[row];
    }
    return r;
}

// Entities t, t + nt, ... of the scene into the side table.
__device__ __forceinline__ void load_side_rows(const Scene& s, int t,
                                               int nt) {
    if constexpr (SIDE_TABLE)
        for (int e = t; e < s.n_ent; e += nt) side_rows[e] = side_row(s, e);
}

// The block's threads stage the side table (the builds that march).
template <int kB>
__device__ __forceinline__ void stage_sides(const Scene& s) {
    if constexpr (has_march(kB) && SIDE_TABLE) {
        load_side_rows(s, threadIdx.y * blockDim.x + threadIdx.x,
                       blockDim.x * blockDim.y);
        __syncthreads();
    }
}

// Entity e's side table row: staged, or read from the scene's arrays.
__device__ __forceinline__ SideRow side_table(const Scene& s, int e) {
    if constexpr (SIDE_TABLE) return side_rows[e];
    return side_row(s, e);
}

// geometry.py::side of entity ent, whose table row is r: membership, or
// the half-space side of a bare hyperplane, whose flips mark the march's
// crossings
template <bool kShapes>
__device__ __forceinline__ bool side_of(const Scene& s, int ent,
                                        const SideRow& r, V4 p) {
    if (r.kind == NODE_SPHERE) {
        const V4 q = sub(p, r.c);
        return dot_rn(q, q) < __fmul_rn(r.sc, r.sc);
    }
    if (kShapes && r.kind != NODE_HYPERPLANE && r.kind != NODE_HALFSPACE)
        return member<true>(s, ent, p);
    return dot_rn(r.c, p) < r.sc;
}

template <bool kShapes>
__device__ __forceinline__ bool side(const Scene& s, int ent, V4 p) {
    if constexpr (SIDE_TABLE)
        return side_of<kShapes>(s, ent, side_rows[ent], p);
    return side_of<kShapes>(s, ent, side_row(s, ent), p);
}

// bit e set: p lies on the inner side of entity e (the builds that
// march take n_ent <= MAX_MARCH_ENTITIES)
template <bool kShapes>
__device__ __forceinline__ SideMask sides(const Scene& s, V4 p) {
    SideMask m;
    m.clear();
    for (int e = 0; e < s.n_ent; ++e)
        if (side<kShapes>(s, e, p)) m.put(e, true);
    return m;
}

// geometry.py::boundary_abs of a leaf: picks the leaf whose boundary a
// marched crossing of a composite lies on (BUILD_SHAPES only)
__device__ __forceinline__ float boundary_abs(const Scene& s, int leaf, V4 p) {
    const int row = s.node_row[leaf];
    const V4 c = load4(s.shape_vec + 4 * row);
    const float sc = s.shape_sc[row];
    switch (s.node_kind[leaf]) {
        case NODE_SPHERE: {
            const V4 q = sub(p, c);
            return fabsf(sqrtf(dot(q, q)) - sc);
        }
        case NODE_CYLINDER: {
            const V4 q = cyl_radial(p, c, load4(s.shape_vec + 4 * row + 4));
            return fabsf(sqrtf(dot(q, q)) - sc);
        }
        default: return fabsf(dot(c, p) - sc);
    }
}

// The field of one marching material: the attractor of a 'warp' material,
//   a = (c - x) * (strength * (|c - x|^2 + 1e-4)^-1.5)        (warp_accel),
// or, in BUILD_EXPR, the expression program of an 'expr' material.  The
// builds without expressions keep the attractor's three members only.
template <bool kExpr>
struct Field {
    V4 c;
    float strength, h;
};
template <>
struct Field<true> {
    V4 c;
    float strength, h;
    const int32_t* code;  // the material's VM program, nullptr: attractor
    int end[4];           // one past component c's last instruction
    const float* prm;     // p0..p7
    float t;              // the scene time
};

template <bool kExpr>
__device__ __forceinline__ Field<kExpr> field(const Scene& s, int mat) {
    Field<kExpr> f;
    f.c = load4(s.warp_center + 4 * mat);
    f.strength = s.warp_strength[mat];
    f.h = s.warp_step[mat];
    if constexpr (kExpr) {
        f.code = nullptr;
        f.prm = nullptr;
        f.t = 0.0f;
#pragma unroll
        for (int c = 0; c < 4; ++c) f.end[c] = 0;
        if (s.mat_warp[mat] == MAT_EXPR) {
            const int base = s.expr_off[4 * mat];
            f.code = s.expr_code + 4 * base;
#pragma unroll
            for (int c = 0; c < 4; ++c)
                f.end[c] = s.expr_off[4 * mat + c + 1] - base;
            f.prm = s.expr_params + 8 * mat;
            f.t = *s.time;
        }
    }
    return f;
}

// --- the expression VM (scene/expr.py, the kernels' encoding of
// ops/cuda_kernel.py::expr_program) ------------------------------------------
//
// A material's four component programs lie back to back, each in postfix
// order; instruction i is (op, a, b, c): op an opcode of scene/expr.py
// OPS, a and b the indices of the instructions that computed its operands
// (worked out on the host by replaying the postfix stack; 0 where it has
// fewer, so val[b] is always an earlier value), a the variable index for
// OP_VAR (x y z w p0..p7 t), c the float32 bits of OP_CONST's value or
// OP_POWI's exponent.  The VM evaluates the
// instructions in order into one value per instruction, which is also what
// the adjoint (trace_adj.cuh vm_adjoint) reads.  Every operation is that of
// scene/expr.py::torch_lib(safe=True): the partial-domain functions are
// guarded (sqrt and log: x > 0, fallback 0; asin and acos: |x| < 1,
// fallbacks sign(x) pi/2 and x > 0 ? 0 : pi; div: b == 0 gives 0), powi is
// repeated multiplication (a negative exponent takes the guarded
// reciprocal, 0 gives 1), powf is exp(b * guarded log(a)), and the arc
// functions are the mathx polynomials.

enum : int {
    OP_CONST = 0, OP_VAR, OP_ADD, OP_SUB, OP_MUL, OP_DIV, OP_NEG, OP_POWI,
    OP_POWF, OP_SIN, OP_COS, OP_TANH, OP_EXP, OP_LOG, OP_SQRT, OP_ABS,
    OP_FLOOR, OP_SIGN, OP_ATAN, OP_ASIN, OP_ACOS, OP_MIN, OP_MAX, OP_ATAN2
};

__device__ __forceinline__ float safe_div(float a, float b) {
    return b != 0.0f ? __fdiv_rn(a, b) : 0.0f;
}
__device__ __forceinline__ float safe_log(float a) {
    return a > 0.0f ? logf(a) : 0.0f;
}
// a^|n| by repeated multiplication (n != 0)
__device__ __forceinline__ float powi_abs(float a, int n) {
    float acc = a;
    for (int k = 1; k < abs(n); ++k) acc = __fmul_rn(acc, a);
    return acc;
}

// One instruction's value from its operands' values (n: OP_POWI's
// exponent).
__device__ __forceinline__ float vm_op(int op, float A, float B, int n) {
    switch (op) {
        case OP_ADD: return __fadd_rn(A, B);
        case OP_SUB: return __fsub_rn(A, B);
        case OP_MUL: return __fmul_rn(A, B);
        case OP_DIV: return safe_div(A, B);
        case OP_NEG: return -A;
        case OP_POWI:
            if (n == 0) return 1.0f;
            return n > 0 ? powi_abs(A, n) : safe_div(1.0f, powi_abs(A, n));
        case OP_POWF: return expf(__fmul_rn(B, safe_log(A)));
        case OP_SIN: return sinf(A);
        case OP_COS: return cosf(A);
        case OP_TANH: return tanhf(A);
        case OP_EXP: return expf(A);
        case OP_LOG: return safe_log(A);
        case OP_SQRT: return A > 0.0f ? sqrtf(A) : 0.0f;
        case OP_ABS: return fabsf(A);
        case OP_FLOOR: return floorf(A);
        case OP_SIGN: return A > 0.0f ? 1.0f : A < 0.0f ? -1.0f : A;
        case OP_ATAN: return atan_p(A);
        case OP_ASIN:
            if (fabsf(A) < 1.0f) return asin_p(A);
            return A > 0.0f ? HALF_PI_F : -HALF_PI_F;
        case OP_ACOS:
            if (fabsf(A) < 1.0f) return __fsub_rn(HALF_PI_F, asin_p(A));
            return A > 0.0f ? 0.0f : PI_F;
        case OP_MIN: return fminf(A, B);
        case OP_MAX: return fmaxf(A, B);
        default: return atan2_p(A, B);  // OP_ATAN2
    }
}

// Evaluate the material's field at x; val[i] receives instruction i's value.
__device__ __forceinline__ V4 vm_eval(const Field<true>& f, V4 x,
                                      float* val) {
    for (int i = 0; i < f.end[3]; ++i) {
        const int32_t* in = f.code + 4 * i;
        const int op = in[0], a = in[1];
        float r;
        if (op == OP_CONST) {
            r = __int_as_float(in[3]);
        } else if (op == OP_VAR) {
            r = a < 4 ? comp(x, a) : a < 12 ? f.prm[a - 4] : f.t;
        } else {
            r = vm_op(op, val[a], val[in[2]], in[3]);
        }
        val[i] = r;
    }
    return {val[f.end[0] - 1], val[f.end[1] - 1], val[f.end[2] - 1],
            val[f.end[3] - 1]};
}

__device__ __forceinline__ V4 attractor(V4 c, float strength, V4 x) {
    const V4 d = sub(c, x);
    const float r2 = __fadd_rn(dot_rn(d, d), 1e-4f);
    return scale_rn(d, __fmul_rn(strength, powf(r2, -1.5f)));
}

template <bool kExpr>
__device__ __forceinline__ V4 accel(const Field<kExpr>& f, V4 x) {
    if constexpr (kExpr) {
        if (f.code) {
            float val[MAX_EXPR];   // one value an instruction
            return vm_eval(f, x, val);
        }
    }
    return attractor(f.c, f.strength, x);
}

// one march step: v1 = normalize(v + h a(x)), x1 = x + h v1
template <bool kExpr>
__device__ __forceinline__ void march_step(const Field<kExpr>& f, V4 x, V4 v,
                                           V4* x1, V4* v1) {
    *v1 = normalize_rn(madd_rn(v, f.h, accel<kExpr>(f, x)));
    *x1 = madd_rn(x, f.h, *v1);
}

// What the backward's reverse march (K4, trace_adj.cuh march_reverse)
// needs of a marched node: the state at the start of every chunk of
// MARCH_CB steps and around the last step.  The tape backward's forward
// sweep records it (march with kRec); otherwise march_replay re-marches.
constexpr int MARCH_CB = 16;      // march steps per checkpoint (K4)
constexpr int MAX_MARCH_CK = TRACE_MAX_MARCH_CK;  // checkpoints: march_steps
                                  // <= MARCH_CB * MAX_MARCH_CK
struct MarchTape {
    V4 ckx[MAX_MARCH_CK], ckv[MAX_MARCH_CK];  // state at each chunk's start
    V4 xb, xe, ve;   // state before the last step (sx0), after it (sx1, sv)
};

// The end of a march: where and in which direction it crossed a boundary.
struct MarchHit {
    int ent;           // winning entity, -1 when nothing was crossed
    int leaf;          // its leaf nearest the crossing, less ent_first
    int n;             // steps walked, round(dist / h)
    float lam;         // bisection parameter of the winning crossing
    V4 p, dir;         // the crossing point, the direction of its step
};

// Bisection of entity e's crossing on the segment [x0, x1] -> lambda.
template <bool kShapes>
__device__ __forceinline__ float bisect(const Scene& s, int e, V4 x0, V4 x1) {
    const SideRow r = side_table(s, e);
    const bool s0 = side_of<kShapes>(s, e, r, x0);
    float lo = 0.0f, hi = 1.0f;
    for (int k = 0; k < BISECT_ITERS; ++k) {
        const float mid = 0.5f * (lo + hi);
        if (side_of<kShapes>(s, e, r, lerp_rn(x0, x1, mid)) == s0) lo = mid;
        else hi = mid;
    }
    return hi;
}

// March the ray (org, d0) through material mat: at most march_steps steps,
// stopping at the first step that flips a side (or after the step that
// starts beyond t_max), then bisect every flipped entity and keep the
// smallest lambda (strict '<' in entity order).  The crossing's leaf is
// the one nearest it by boundary_abs (strict '<' in leaf order), as
// march_finish picks it; a primitive entity is its own leaf.  kRec: the
// states the reverse march needs go to *rec (when given) as they pass, the
// n = round(dist / h) steps walked being those march_replay re-marches.
template <bool kExpr, bool kShapes, bool kRec = false>
__device__ __forceinline__ MarchHit march(const Scene& s, V4 org, V4 d0,
                                          int mat,
                                          MarchTape* rec = nullptr) {
    const Field<kExpr> f = field<kExpr>(s, mat);
    SideMask sd = sides<kShapes>(s, org), crossed;
    crossed.clear();
    V4 x = org, v = d0, sx0 = org, sx1 = org, sv = d0;
    V4 xb = org;   // kRec: the state before the last step walked
    float dist = 0.0f;
    for (int i = 0; i < s.march_steps; ++i) {
        if constexpr (kRec) {
            if (rec && i % MARCH_CB == 0) {
                rec->ckx[i / MARCH_CB] = x;
                rec->ckv[i / MARCH_CB] = v;
            }
            xb = x;
        }
        V4 x1, v1;
        march_step<kExpr>(f, x, v, &x1, &v1);
        const SideMask nsd = sides<kShapes>(s, x1);
        const bool beyond = dist > s.t_max;
        dist = dist + f.h;
        if (nsd.differs(sd)) {
            crossed = nsd ^ sd;
            sx0 = x;
            sx1 = x1;
            sv = v1;
            break;
        }
        x = x1;
        v = v1;
        sd = nsd;
        if (beyond) break;
    }
    if constexpr (kRec) {
        if (rec) {
            const bool crossing = crossed.any();
            rec->xb = crossing ? sx0 : xb;
            rec->xe = crossing ? sx1 : x;
            rec->ve = crossing ? sv : v;
        }
    }
    MarchHit m{-1, 0, (int)rintf(dist / fmaxf(f.h, 1e-12f)), 2.0f, org, sv};
    for (int e = 0; e < s.n_ent; ++e) {
        if (!crossed.get(e)) continue;
        const float lam = bisect<kShapes>(s, e, sx0, sx1);
        if (lam < m.lam) {
            m.lam = lam;
            m.ent = e;
        }
    }
    if (m.ent >= 0) {
        m.p = lerp_rn(sx0, sx1, m.lam);
        if constexpr (kShapes) {
            const int first = s.ent_first[m.ent], root = s.ent_root[m.ent];
            float best = 0.0f;
            for (int i = first, n = 0; i <= root; ++i) {
                if (s.node_kind[i] > NODE_CYLINDER) continue;
                const float b = boundary_abs(s, i, m.p);
                if (n++ == 0 || b < best) {
                    best = b;
                    m.leaf = i - first;
                }
            }
        }
    }
    return m;
}

struct Hit {
    float t;
    int ent, root;  // root: NodeRec::root
};

// The roots of |q + t w|^2 = r^2, q and w the radial parts of o - c and d
// about the unit axis a (geometry.py::leaf_crossings); false where the ray
// misses or runs parallel to the axis.
__device__ __forceinline__ bool cyl_roots(V4 o, V4 d, V4 c, V4 a, float r,
                                          float ts[2]) {
    const V4 oc = sub(o, c);
    const V4 q = madd(oc, -dot(oc, a), a);
    const V4 w = madd(d, -dot(d, a), a);
    const float w2 = dot(w, w);
    if (!(w2 >= 1e-12f)) return false;
    const float b = dot(q, w) / w2;
    const float cc = (dot(q, q) - r * r) / w2;
    const float disc = b * b - cc;
    if (!(disc > 0.0f)) return false;
    const float sq = sqrtf(disc);
    ts[0] = -b - sq;
    ts[1] = -b + sq;
    return true;
}

// Does entity e's membership flip across o + t d?  The probe points
// o + (t -+ PROBE) d are computed as the plain version computes them.
__device__ __forceinline__ bool csg_flips(const Scene& s, int e, V4 o, V4 d,
                                          float t) {
    return member<true>(s, e, madd_rn(o, __fsub_rn(t, PROBE), d))
        != member<true>(s, e, madd_rn(o, __fadd_rn(t, PROBE), d));
}

// Nearest valid boundary crossing over the entities: strict '<' in entity
// order, then leaf order, then root order, within (EPS_T, t_max); a leaf
// crossing of a composite counts where its membership flips.
template <bool kShapes>
__device__ __forceinline__ Hit nearest(const Scene& s, V4 o, V4 d) {
    Hit h{s.t_max, -1, 0};
    for (int e = 0; e < s.n_ent; ++e) {
        const int root = s.ent_root[e];
        const int first = kShapes ? s.ent_first[e] : root;
        for (int leaf = first; leaf <= root; ++leaf) {
            const int kind = s.node_kind[leaf];
            if (kShapes && kind > NODE_CYLINDER)
                continue;  // a composite (no row): its leaves carry the crossings
            const int row = s.node_row[leaf];
            const V4 c = load4(s.shape_vec + 4 * row);
            const float sc = s.shape_sc[row];
            float ts[2];
            int nt = 2;
            if (kind == NODE_SPHERE) {
                const V4 oc = sub(o, c);
                const float b = dot(oc, d);
                const float q = dot(oc, oc) - sc * sc;
                const float disc = b * b - q;
                if (!(disc > 0.0f)) continue;
                const float sq = sqrtf(disc);
                ts[0] = -b - sq;
                ts[1] = -b + sq;
            } else if (kShapes && kind == NODE_CYLINDER) {
                if (!cyl_roots(o, d, c, load4(s.shape_vec + 4 * row + 4), sc,
                               ts))
                    continue;
            } else {
                const float nd = dot(c, d);
                if (!(fabsf(nd) > 1e-12f)) continue;
                ts[0] = (sc - dot(c, o)) / nd;
                nt = 1;
            }
#pragma unroll
            for (int k = 0; k < 2; ++k) {
                if (k < nt && ts[k] > EPS_T && ts[k] < s.t_max && ts[k] < h.t) {
                    if (kShapes && first != root && !csg_flips(s, e, o, d, ts[k]))
                        continue;
                    h.t = ts[k];
                    h.ent = e;
                    h.root = (leaf - first) << 1 | k;
                }
            }
        }
    }
    return h;
}

// Longitude/latitude of p on the sphere centred at c, with the pole guards
// of geometry.py::leaf_uv (the atan2 guard and the 1e-6 clip).
__device__ __forceinline__ void sphere_uv(V4 p, V4 c, float* u, float* v) {
    const V4 loc = sub(p, c);
    const float safe_x = (fabsf(loc.x) + fabsf(loc.y)) < 1e-12f ? 1.0f : loc.x;
    *u = atan2_p(loc.y, safe_x) * INV_TWO_PI_F + 0.5f;
    const float rlen = sqrtf(dot(loc, loc));
    const float cz = fminf(fmaxf(loc.z / fmaxf(rlen, 1e-12f), CZ_LO), CZ_HI);
    *v = acos_p(cz) / PI_F;
}

// The angle of p around the cylinder's axis a in the axis's tangent frame
// (the atan2 pole guard of the sphere) and its axial coordinate.
__device__ __forceinline__ void cyl_uv(V4 p, V4 c, V4 a, int dim, float* u,
                                       float* v) {
    const V4 pc = sub(p, c);
    const float ax = dot(pc, a);
    const V4 q = madd(pc, -ax, a);
    V4 t1, t2;
    tangent_frame(a, dim, &t1, &t2);
    const float qx = dot(q, t1), qy = dot(q, t2);
    const float safe_x = (fabsf(qx) + fabsf(qy)) < 1e-12f ? 1.0f : qx;
    *u = atan2_p(qy, safe_x) * INV_TWO_PI_F + 0.5f;
    *v = ax;
}

// The leaf of entity ent that a Hit's or NodeRec's root names.
template <bool kShapes>
__device__ __forceinline__ int hit_leaf(const Scene& s, int ent, int root) {
    if constexpr (kShapes) return s.ent_first[ent] + (root >> 1);
    return s.ent_root[ent];
}

// Unoriented unit normal and UV of the leaf at the point p of its surface
// (UV only where the entity's surface reads it: zero on a uniform one).
template <bool kShapes>
__device__ __forceinline__ void surface_at(const Scene& s, int ent, int leaf,
                                           V4 p, V4* n, float* u, float* v) {
    const int row = s.node_row[leaf];
    const int kind = s.node_kind[leaf];
    const V4 c = load4(s.shape_vec + 4 * row);
    const bool sphere = kind == NODE_SPHERE;
    const bool cyl = kShapes && kind == NODE_CYLINDER;
    const V4 a = cyl ? load4(s.shape_vec + 4 * row + 4) : c;
    *n = sphere ? normalize(sub(p, c)) : cyl ? normalize(cyl_radial(p, c, a))
                                             : c;
    *u = 0.0f;
    *v = 0.0f;
    if (s.surf_kind[s.ent_surf[ent]] == SURF_UNIFORM) return;
    if (sphere) {
        sphere_uv(p, c, u, v);
    } else if (cyl) {
        cyl_uv(p, c, a, s.dim, u, v);
    } else {
        V4 t1, t2;
        tangent_frame(c, s.dim, &t1, &t2);
        *u = dot(p, t1);
        *v = dot(p, t2);
    }
}

// Smooth surface: f = 1/4 (1 + sin 2 pi u sc)(1 + sin 2 pi v sc).
__device__ __forceinline__ float smooth_f(float u, float v, float sc) {
    return 0.25f * (1.0f + sinf(TWO_PI_F * u * sc))
                 * (1.0f + sinf(TWO_PI_F * v * sc));
}

// --- perlin noise (shading.py::perlin2, perlin_field) ----------------------

// the gradient direction (gx, gy) of a 3-bit hash: (1, 0), (-1, 0), (0, 1),
// (0, -1), then (+-1, +-1) / sqrt 2 with gx's sign in bit 0, gy's in bit 1
constexpr float INV_SQRT2_F = 0.7071067811865476f;
__device__ __forceinline__ float perlin_gx(uint32_t h) {
    return h < 2u ? (h == 0u ? 1.0f : -1.0f)
         : h < 4u ? 0.0f : (h & 1u ? -INV_SQRT2_F : INV_SQRT2_F);
}
__device__ __forceinline__ float perlin_gy(uint32_t h) {
    return h < 2u ? 0.0f
         : h < 4u ? (h == 2u ? 1.0f : -1.0f)
                  : (h & 2u ? -INV_SQRT2_F : INV_SQRT2_F);
}

// The lattice hash; seedk is the octave's seed times 974711 (mod 2^32).
__device__ __forceinline__ uint32_t hash2(uint32_t xi, uint32_t yi,
                                          uint32_t seedk) {
    uint32_t n = xi * 374761393u + yi * 668265263u + seedk;
    n = (n ^ (n >> 13)) * 1274126177u;
    return n ^ (n >> 16);
}

// gradient(h) . (dx, dy)
__device__ __forceinline__ float grad_dot(uint32_t h, float dx, float dy) {
    return __fadd_rn(__fmul_rn(perlin_gx(h), dx), __fmul_rn(perlin_gy(h), dy));
}

__device__ __forceinline__ float fade(float t) {  // t^3 (t (6 t - 15) + 10)
    return __fmul_rn(__fmul_rn(__fmul_rn(t, t), t),
                     __fadd_rn(__fmul_rn(t, __fsub_rn(__fmul_rn(t, 6.0f),
                                                      15.0f)), 10.0f));
}

// One octave's lattice cell: the fractional coordinates and the 3-bit
// hashes of its corners (00, 01 = x + 1, 10 = y + 1, 11).
struct PerlinCell {
    float xf, yf;
    uint32_t h[4];
};

__device__ __forceinline__ PerlinCell perlin_cell(float pu, float pv,
                                                  uint32_t seedk) {
    const float x0f = floorf(pu), y0f = floorf(pv);
    const uint32_t x0 = (uint32_t)(int32_t)x0f, y0 = (uint32_t)(int32_t)y0f;
    return {__fsub_rn(pu, x0f), __fsub_rn(pv, y0f),
            {hash2(x0, y0, seedk) & 7u, hash2(x0 + 1u, y0, seedk) & 7u,
             hash2(x0, y0 + 1u, seedk) & 7u,
             hash2(x0 + 1u, y0 + 1u, seedk) & 7u}};
}

__device__ __forceinline__ float lerp_p(float a, float b, float s) {
    return __fadd_rn(a, __fmul_rn(s, __fsub_rn(b, a)));  // a + s (b - a)
}

__device__ __forceinline__ float perlin2(float pu, float pv, uint32_t seedk) {
    const PerlinCell k = perlin_cell(pu, pv, seedk);
    const float xm = __fsub_rn(k.xf, 1.0f), ym = __fsub_rn(k.yf, 1.0f);
    const float sx = fade(k.xf), sy = fade(k.yf);
    const float nx0 = lerp_p(grad_dot(k.h[0], k.xf, k.yf),
                             grad_dot(k.h[1], xm, k.yf), sx);
    const float nx1 = lerp_p(grad_dot(k.h[2], k.xf, ym),
                             grad_dot(k.h[3], xm, ym), sx);
    return lerp_p(nx0, nx1, sy);
}

// fBm over the octaves (lacunarity 2, gain 0.5) before the clip to [0, 1]:
// 0.5 + 0.5 sum_o 0.5^o perlin2(u sc 2^o, v sc 2^o, seed + o)
__device__ __forceinline__ float perlin_sum(float u, float v, float sc,
                                            int octaves, uint32_t seedk) {
    float acc = 0.0f, amp = 1.0f, freq = 1.0f;
    const float us = __fmul_rn(u, sc), vs = __fmul_rn(v, sc);
    for (int o = 0; o < octaves; ++o) {
        acc = __fadd_rn(acc, __fmul_rn(amp, perlin2(
            __fmul_rn(us, freq), __fmul_rn(vs, freq), seedk + 974711u * o)));
        amp *= 0.5f;
        freq *= 2.0f;
    }
    return __fadd_rn(0.5f, __fmul_rn(0.5f, acc));
}

// --- textures (shading.py::sample_texture, the gather filter) --------------

// jnp.mod(x, 1): fmod (exact), plus 1 where negative
__device__ __forceinline__ float mod1(float x) {
    const float r = fmodf(x, 1.0f);
    return r < 0.0f ? __fadd_rn(r, 1.0f) : r;
}

// A bilinear sample's texels and weights: the [h, w, 3] texture at offset
// off, its texel coordinates fu = mod(u sc, 1) (w - 1), fv alike.
struct TexCell {
    int i00, i01, i10, i11;  // offsets of texels (y0, x0) (y0, x1) (y1, x0)
                             // (y1, x1), x1 = min(x0 + 1, w - 1), y1 alike
    float dx, dy;            // fu - x0, fv - y0
};

__device__ __forceinline__ TexCell tex_cell(const Scene& s, int tid, float u,
                                            float v, float sc) {
    const int off = s.tex_info[3 * tid], th = s.tex_info[3 * tid + 1],
              tw = s.tex_info[3 * tid + 2];
    const float fu = __fmul_rn(mod1(__fmul_rn(u, sc)), (float)(tw - 1));
    const float fv = __fmul_rn(mod1(__fmul_rn(v, sc)), (float)(th - 1));
    const float x0 = floorf(fu), y0 = floorf(fv);
    const int xi = (int)x0, yi = (int)y0;
    const int xj = min(xi + 1, tw - 1), yj = min(yi + 1, th - 1);
    return {off + 3 * (yi * tw + xi), off + 3 * (yi * tw + xj),
            off + 3 * (yj * tw + xi), off + 3 * (yj * tw + xj),
            __fsub_rn(fu, x0), __fsub_rn(fv, y0)};
}

// (v00 (1 - dx) + v01 dx) (1 - dy) + (v10 (1 - dx) + v11 dx) dy
__device__ __forceinline__ float bilinear(float v00, float v01, float v10,
                                          float v11, float dx, float dy) {
    const float ex = __fsub_rn(1.0f, dx), ey = __fsub_rn(1.0f, dy);
    return __fadd_rn(
        __fmul_rn(__fadd_rn(__fmul_rn(v00, ex), __fmul_rn(v01, dx)), ey),
        __fmul_rn(__fadd_rn(__fmul_rn(v10, ex), __fmul_rn(v11, dx)), dy));
}

// RGBA of surface sf at (u, v).
template <bool kShapes>
__device__ __forceinline__ void surface_color(const Scene& s, int sf, float u,
                                              float v, float col[4]) {
    const float* c1 = s.surf_color + 4 * sf;
    const float* c2 = s.surf_color2 + 4 * sf;
    const int kind = s.surf_kind[sf];
    if (kShapes && kind == SURF_TEXTURE) {
        const TexCell k = tex_cell(s, s.surf_aux[2 * sf], u, v,
                                   s.surf_uv_scale[sf]);
#pragma unroll
        for (int ch = 0; ch < 3; ++ch)
            col[ch] = bilinear(__ldg(s.tex + k.i00 + ch),
                               __ldg(s.tex + k.i01 + ch),
                               __ldg(s.tex + k.i10 + ch),
                               __ldg(s.tex + k.i11 + ch), k.dx, k.dy);
        col[3] = c1[3];
        return;
    }
    if (kind == SURF_SMOOTH || (kShapes && kind == SURF_PERLIN)) {
        float f;
        if (kShapes && kind == SURF_PERLIN) {
            f = fminf(fmaxf(perlin_sum(u, v, s.surf_uv_scale[sf],
                                       s.surf_aux[2 * sf],
                                       (uint32_t)s.surf_aux[2 * sf + 1]),
                            0.0f), 1.0f);
        } else {
            f = smooth_f(u, v, s.surf_uv_scale[sf]);
        }
#pragma unroll
        for (int ch = 0; ch < 4; ++ch) col[ch] = c1[ch] + (c2[ch] - c1[ch]) * f;
        return;
    }
    const float* pick = c1;
    if (kind == SURF_CHECKER) {
        const float uvs = s.surf_uv_scale[sf];
        const float sum = floorf(u * uvs) + floorf(v * uvs);
        // floor-mod, the sign of the divisor: fmodf would give -1 for a
        // negative odd sum and pick the wrong colour
        const float par = sum - 2.0f * floorf(sum * 0.5f);
        if (par >= 0.5f) pick = c2;
    }
#pragma unroll
    for (int ch = 0; ch < 4; ++ch) col[ch] = pick[ch];
}

__device__ __forceinline__ void push(Slot* stack, int* sp, V4 org, V4 dir,
                                     float w, int mat, int depth, int parent,
                                     int branch) {
    if (*sp < MAX_SLOTS)
        stack[*sp] = Slot{org, dir, w, mat, depth, parent, branch};
    ++*sp;
}

// Shade one DFS node: accumulate its colour term into acc and push up to
// two children (transmission first, then reflection).  `self` is the
// node's index in shading order (the children's parent); rec, when given,
// receives the node's discrete decisions.  The build kB (BUILD_* bits)
// compiles out what the scene does not have: without BUILD_MARCH the march
// and the portal teleport (the entry points drop it when march_steps is 0),
// without BUILD_VM the expression VM, without BUILD_SHAPES composites,
// cylinders, perlin and textures; with BUILD_TAPE a marched node's
// checkpoints go to *mrec (when given).
template <int kB>
__device__ __forceinline__ void shade(const Scene& s, const Slot& r, int self,
                                      float acc[3], Slot* stack, int* sp,
                                      NodeRec<has_march(kB)>* rec,
                                      MarchTape* mrec = nullptr) {
    constexpr bool kWarp = has_march(kB);
    constexpr bool kShapes = has_shapes(kB);
    // propagate: a ray in a warped material marches, any other flies
    // straight to its nearest hit
    int ent, root;
    V4 p, d;
    if (kWarp && s.mat_warp[r.mat] != MAT_STRAIGHT) {
        const MarchHit m = march<has_vm(kB), kShapes, has_march_rec(kB)>(
            s, r.org, r.dir, r.mat, mrec);
        root = m.leaf << 1;
        if (rec) set_rec(rec, m.ent, root, m.n, m.lam);
        ent = m.ent;
        p = m.p;
        d = m.dir;
    } else {
        const Hit h = nearest<kShapes>(s, r.org, r.dir);
        if (rec) set_rec(rec, h.ent, h.root, 0, 0.0f);
        ent = h.ent;
        root = h.root;
        d = r.dir;
        p = madd(r.org, h.t, d);
    }
    if (ent < 0) {
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) acc[ch] += r.w * s.background[ch];
        return;
    }
    V4 n;
    float u, v;
    surface_at<kShapes>(s, ent, hit_leaf<kShapes>(s, ent, root), p, &n, &u,
                        &v);
    if (dot(n, d) > 0.0f) {
        n = scale(n, -1.0f);
        if (rec) rec->flip = 1;
    }

    const int sf = s.ent_surf[ent];
    float col[4];
    surface_color<kShapes>(s, sf, u, v, col);
    const float alpha = col[3];
    float refl = s.surf_refl[sf];
    const float fres = s.surf_fresnel[sf];
    if (fres != 0.0f) {  // fres == 0 leaves refl unchanged exactly
        const float cos_i = fminf(fmaxf(-dot(d, n), 0.0f), 1.0f);
        const float m1 = 1.0f - cos_i;
        const float m2 = m1 * m1;
        refl = refl + (1.0f - refl) * fres * (m2 * m2 * m1);
    }
    const float lw = r.w * (1.0f - refl) * alpha;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) acc[ch] += lw * col[ch];
    if (r.depth < 2) return;

    const float w_t = r.w * (1.0f - refl) * (1.0f - alpha);
    const int portal = kWarp ? s.ent_portal[ent] : -1;
    if (w_t > W_EPS && portal >= 0) {
        // a portal teleports the transmitted ray, which always transmits:
        // p' = lin p + tr, d' = normalize(lin d), then the material at
        // its new origin
        const float* lin = s.portal_lin + 16 * portal;
        const V4 pd = normalize(matvec(lin, d));
        const V4 t_org = madd(add(matvec(lin, p),
                                  load4(s.portal_tr + 4 * portal)), PUSH, pd);
        push(stack, sp, t_org, pd, w_t, material_at<kShapes>(s, t_org),
             r.depth - 1, self, 0);
    } else if (w_t > W_EPS) {
        const int m_to = material_at<kShapes>(s, madd(p, PUSH, d));
        if (rec) rec->m_to = m_to;
        const float eta = s.mat_ior[r.mat] / s.mat_ior[m_to];
        const float cos_i = -dot(d, n);
        const float k = 1.0f - eta * eta * (1.0f - cos_i * cos_i);
        if (k > 0.0f) {  // else total internal reflection: no transmission
            const float coef = eta * cos_i - sqrtf(k);
            const V4 td = normalize({eta * d.x + coef * n.x,
                                     eta * d.y + coef * n.y,
                                     eta * d.z + coef * n.z,
                                     eta * d.w + coef * n.w});
            push(stack, sp, madd(p, PUSH, td), td, w_t, m_to, r.depth - 1,
                 self, 0);
        }
    }
    const float w_r = r.w * refl;
    if (w_r > W_EPS) {
        const float k = 2.0f * dot(d, n);
        const V4 rd = {d.x - k * n.x, d.y - k * n.y, d.z - k * n.z,
                       d.w - k * n.w};
        push(stack, sp, madd(p, PUSH, rd), rd, w_r, r.mat, r.depth - 1, self,
             1);
    }
}

// The camera row of pallas_kernel._pack_camera: position [0:4], forward
// [4:8], up [8:12], right [12:16], tan_half_fov [16], time [17], y0 [18].
struct CamFrame {
    V4 f, rt, uu;
    float ndx, ndy;
};

// Pinhole ray direction of pixel (x, y) of the slab, with the camera frame
// re-orthonormalised (Gram-Schmidt) as ops/trace.py::camera_rays does.
__device__ __forceinline__ V4 camera_ray(const float* cam, int x, int y,
                                         int H, int W, CamFrame* fr) {
    const V4 f = normalize(load4(cam + 4));
    const V4 up = load4(cam + 8), r0 = load4(cam + 12);
    const V4 rt = normalize(madd(r0, -dot(r0, f), f));
    const V4 u1 = madd(up, -dot(up, f), f);
    const V4 uu = normalize(madd(u1, -dot(u1, rt), rt));
    const float thf = cam[16];
    const float aspect = (float)((double)W / (double)H);
    const float xi = (float)x;
    const float yi = (float)y + cam[18];
    const float ndx = ((xi + 0.5f) / (float)W * 2.0f - 1.0f) * (aspect * thf);
    const float ndy = (1.0f - (yi + 0.5f) / (float)H * 2.0f) * thf;
    if (fr) *fr = CamFrame{f, rt, uu, ndx, ndy};
    return normalize({f.x + ndx * rt.x + ndy * uu.x,
                      f.y + ndx * rt.y + ndy * uu.y,
                      f.z + ndx * rt.z + ndy * uu.z,
                      f.w + ndx * rt.w + ndy * uu.w});
}

}  // namespace trace
