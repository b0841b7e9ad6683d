// trace_fwd.cu - the forward ray-tracing kernel for Hopper (sm_90a).
//
// Replaces euclider_tpu/ops/pallas_kernel.py::_kernel, the Pallas forward
// megakernel launched by render_image_pallas.  It computes exactly
// euclider_tpu_torch/ops/trace.py::render_image (the port of
// ops/trace.py::trace_batch with differentiable=False): pinhole rays per
// pixel, the peeled primary node, then a depth-first stack loop capped at
// max_nodes - 1 trips.  Each node finds the nearest hit over the entities
// (strict '<' in entity order), shades it (uniform or checker surface,
// Schlick reflection ratio) and pushes the transmission child, then the
// reflection child.
//
// What bounds it: FP32 ALU work and warp divergence, not bytes.  The output
// is 12 B per pixel and the scene tables are under 1 KB.  The design keeps a
// pixel's whole ray tree in one thread's registers and local memory (a DFS
// stack of at most MAX_SLOTS branches) and writes each pixel once.  The
// scene is data, not code: the entity, node and surface-kind arrays and the
// float tables are read from global memory, so one compiled kernel serves
// every scene and branches on the scene are uniform across a warp.
//
// Supported: sphere, half-space and hyperplane leaves; uniform and checker
// surfaces; vacuum and dielectric materials.  The Python wrapper
// (ops/cuda_kernel.py) refuses every other feature before launching.
//
// Built with nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3,
// without --use_fast_math: sqrtf, division and floorf stay IEEE float32.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int MAX_SLOTS = 16;     // DFS stack capacity (max_depth + 1 <= 16)
constexpr float EPS_T = 1e-4f;    // minimum accepted hit distance
constexpr float PUSH = 1e-3f;     // offset of a secondary ray's origin
constexpr float W_EPS = 1e-4f;    // path-weight cutoff for a push

// codes of oracle/native_oracle.py NODE_KINDS / SURF_KINDS
constexpr int NODE_SPHERE = 0;
constexpr int NODE_HYPERPLANE = 1;
constexpr int SURF_CHECKER = 1;

struct V4 {
    float x, y, z, w;
};

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

struct Scene {
    const int32_t *ent_root, *ent_mat, *ent_surf;  // per entity
    const int32_t *node_kind, *node_row;           // per shape node
    const int32_t *surf_kind;                      // per surface
    const float *shape_vec, *shape_sc;             // [S, 4], [S]
    const float *mat_ior;                          // [M]
    const float *surf_color, *surf_color2;         // [U, 4]
    const float *surf_refl, *surf_fresnel, *surf_uv_scale;  // [U]
    const float *background;                       // [3]
    int n_ent, ambient, max_depth, max_nodes, dim;
    float t_max;
};

struct Slot {  // one deferred branch of the ray tree
    V4 org, dir;
    float w;
    int mat, depth;
};

// Two orthonormal tangents of a plane: Gram-Schmidt the coordinate axes of
// the two smallest |n| components among the first dim (strict '<' argmin).
__device__ void tangent_frame(V4 n, int dim, V4* t1, V4* t2) {
    const float big = 1e9f;
    const float c[4] = {fabsf(n.x), fabsf(n.y), fabsf(n.z), fabsf(n.w)};
    int a = 0, b = 0;
    float best = big + 1.0f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const float v = i < dim ? c[i] : big;
        if (v < best) { best = v; a = i; }
    }
    best = big + 1.0f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const float v = (i < dim && i != a) ? c[i] : big;
        if (v < best) { best = v; b = i; }
    }
    const V4 ea = axis(a), eb = axis(b);
    *t1 = normalize(madd(ea, -dot(n, ea), n));
    const V4 t = madd(eb, -dot(n, eb), n);
    *t2 = normalize(madd(t, -dot(*t1, t), *t1));
}

__device__ bool member(const Scene& s, int node, V4 p) {
    const int row = s.node_row[node];
    const V4 c = load4(s.shape_vec + 4 * row);
    const float sc = s.shape_sc[row];
    switch (s.node_kind[node]) {
        case NODE_SPHERE: { const V4 q = sub(p, c); return dot(q, q) < sc * sc; }
        case NODE_HYPERPLANE: return false;
        default: return dot(c, p) < sc;  // half-space
    }
}

// first entity (scene order) containing p, else the ambient material
__device__ int material_at(const Scene& s, V4 p) {
    for (int e = 0; e < s.n_ent; ++e)
        if (member(s, s.ent_root[e], p)) return s.ent_mat[e];
    return s.ambient;
}

// Nearest valid crossing of one primitive entity closer than *t; on a take
// updates *t, *n (unoriented normal) and, for a checker plane, *u, *v.
__device__ bool entity_hit(const Scene& s, int e, V4 o, V4 d, float* t,
                           V4* n, float* u, float* v) {
    const int node = s.ent_root[e];
    const int row = s.node_row[node];
    const V4 c = load4(s.shape_vec + 4 * row);
    const float sc = s.shape_sc[row];
    bool took = false;
    if (s.node_kind[node] == NODE_SPHERE) {
        const V4 oc = sub(o, c);
        const float b = dot(oc, d);
        const float q = dot(oc, oc) - sc * sc;
        const float disc = b * b - q;
        if (!(disc > 0.0f)) return false;
        const float sq = sqrtf(disc);
        const float ts[2] = {-b - sq, -b + sq};
#pragma unroll
        for (int k = 0; k < 2; ++k) {
            if (ts[k] > EPS_T && ts[k] < s.t_max && ts[k] < *t) {
                *t = ts[k];
                *n = normalize(sub(madd(o, ts[k], d), c));
                *u = 0.0f;
                *v = 0.0f;
                took = true;
            }
        }
        return took;
    }
    const float nd = dot(c, d);
    if (!(fabsf(nd) > 1e-12f)) return false;
    const float tp = (sc - dot(c, o)) / nd;
    if (!(tp > EPS_T && tp < s.t_max && tp < *t)) return false;
    *t = tp;
    *n = c;
    *u = 0.0f;
    *v = 0.0f;
    if (s.surf_kind[s.ent_surf[e]] == SURF_CHECKER) {
        const V4 p = madd(o, tp, d);
        V4 t1, t2;
        tangent_frame(c, s.dim, &t1, &t2);
        *u = dot(p, t1);
        *v = dot(p, t2);
    }
    return true;
}

__device__ __forceinline__ void push(Slot* stack, int* sp, V4 org, V4 dir,
                                     float w, int mat, int depth) {
    if (*sp < MAX_SLOTS) stack[*sp] = Slot{org, dir, w, mat, depth};
    ++*sp;
}

// Shade one DFS node: accumulate its colour term into acc and push up to
// two children (transmission first, then reflection).
__device__ void shade(const Scene& s, const Slot& r, float acc[3],
                      Slot* stack, int* sp) {
    float t = s.t_max, u = 0.0f, v = 0.0f;
    V4 n = {0.0f, 0.0f, 0.0f, 0.0f};
    int ent = -1;
    for (int e = 0; e < s.n_ent; ++e)
        if (entity_hit(s, e, r.org, r.dir, &t, &n, &u, &v)) ent = e;
    if (ent < 0) {
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) acc[ch] += r.w * s.background[ch];
        return;
    }
    const V4 d = r.dir;
    const V4 p = madd(r.org, t, d);
    if (dot(n, d) > 0.0f) n = scale(n, -1.0f);

    const int sf = s.ent_surf[ent];
    const float* col = s.surf_color + 4 * sf;
    if (s.surf_kind[sf] == SURF_CHECKER) {
        const float uvs = s.surf_uv_scale[sf];
        const float sum = floorf(u * uvs) + floorf(v * uvs);
        // floor-mod, the sign of the divisor: fmodf would give -1 for a
        // negative odd sum and pick the wrong colour
        const float par = sum - 2.0f * floorf(sum * 0.5f);
        if (par >= 0.5f) col = s.surf_color2 + 4 * sf;
    }
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
    if (w_t > W_EPS) {
        const int m_to = material_at(s, madd(p, PUSH, d));
        const float eta = s.mat_ior[r.mat] / s.mat_ior[m_to];
        const float cos_i = -dot(d, n);
        const float k = 1.0f - eta * eta * (1.0f - cos_i * cos_i);
        if (k > 0.0f) {  // else total internal reflection: no transmission
            const float coef = eta * cos_i - sqrtf(k);
            const V4 td = normalize({eta * d.x + coef * n.x,
                                     eta * d.y + coef * n.y,
                                     eta * d.z + coef * n.z,
                                     eta * d.w + coef * n.w});
            push(stack, sp, madd(p, PUSH, td), td, w_t, m_to, r.depth - 1);
        }
    }
    const float w_r = r.w * refl;
    if (w_r > W_EPS) {
        const float k = 2.0f * dot(d, n);
        const V4 rd = {d.x - k * n.x, d.y - k * n.y, d.z - k * n.z,
                       d.w - k * n.w};
        push(stack, sp, madd(p, PUSH, rd), rd, w_r, r.mat, r.depth - 1);
    }
}

// One thread per pixel of the row slab [y0, y0 + rows) of the H x W frame.
// cam: the 24-float row of pallas_kernel._pack_camera (position, forward,
// up, right, tan_half_fov, time, y0, padding).
__global__ void trace_fwd_kernel(Scene s, const float* __restrict__ cam,
                                 int H, int W, int rows,
                                 float* __restrict__ out) {
    const int x = blockIdx.x * blockDim.x + threadIdx.x;
    const int y = blockIdx.y * blockDim.y + threadIdx.y;
    if (x >= W || y >= rows) return;

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
    const V4 d = normalize({f.x + ndx * rt.x + ndy * uu.x,
                            f.y + ndx * rt.y + ndy * uu.y,
                            f.z + ndx * rt.z + ndy * uu.z,
                            f.w + ndx * rt.w + ndy * uu.w});

    float acc[3] = {0.0f, 0.0f, 0.0f};
    Slot stack[MAX_SLOTS];
    int sp = 0;
    shade(s, Slot{load4(cam), d, 1.0f, s.ambient, s.max_depth}, acc, stack,
          &sp);
    for (int it = 0; it < s.max_nodes - 1 && sp > 0; ++it) {
        --sp;
        const Slot node = stack[sp];
        shade(s, node, acc, stack, &sp);
    }
    float* o = out + 3 * ((size_t)y * W + x);
    o[0] = acc[0];
    o[1] = acc[1];
    o[2] = acc[2];
}

}  // namespace

extern "C" int euclider_trace_fwd(
    const int32_t* ent_root, const int32_t* ent_mat, const int32_t* ent_surf,
    const int32_t* node_kind, const int32_t* node_row,
    const int32_t* surf_kind,
    const float* shape_vec, const float* shape_sc, const float* mat_ior,
    const float* surf_color, const float* surf_color2,
    const float* surf_refl, const float* surf_fresnel,
    const float* surf_uv_scale, const float* background, const float* cam,
    int n_ent, int ambient, int max_depth, int max_nodes, int dim,
    float t_max, int H, int W, int rows, float* out, int device,
    void* stream) {
    if (max_depth + 1 > MAX_SLOTS) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (rows <= 0 || W <= 0) return 0;
    const Scene s{ent_root, ent_mat, ent_surf, node_kind, node_row,
                  surf_kind, shape_vec, shape_sc, mat_ior, surf_color,
                  surf_color2, surf_refl, surf_fresnel, surf_uv_scale,
                  background, n_ent, ambient, max_depth, max_nodes, dim,
                  t_max};
    const dim3 block(32, 8);
    const dim3 grid((W + block.x - 1) / block.x,
                    (rows + block.y - 1) / block.y);
    trace_fwd_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        s, cam, H, W, rows, out);
    return (int)cudaGetLastError();
}
