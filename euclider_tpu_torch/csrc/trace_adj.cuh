// trace_adj.cuh - the reverse-mode device code of one ray-tree node, shared
// by the backward kernels: trace_bwd.cu (the tape kernel, K2/K3/K5) and
// trace_seg.cu (the segmented kernels, K6/K7).
//
// A backward kernel's forward sweep shades a pixel's tree with the forward
// kernel's own device code (trace_common.cuh) and writes a tape, one entry
// per shaded node: its input slot (origin, direction, weight, material,
// depth), its discrete decisions (winning entity and root, normal flip,
// material past the surface) and the indices of the children it shaded.
// The reverse sweep walks the tape backwards, recomputes each node from
// its slot under the recorded decisions and applies hand-written adjoints
// (node_adj: nearest hit or march over the winning leaf, a CSG node adding
// none: the probe's validity is discrete; normal and flip, UV through the
// mathx polynomials, the surface colour: smooth, perlin through its fade
// and fractional coordinates, the texture through its bilinear weights and
// its texels; Schlick always, the local term, refraction or the portal,
// reflection, the PUSH offsets), leaving the node's input adjoint in its
// tape entry for its parent.  The camera-ray adjoint comes last
// (camera_adj).  The adjoint of the ray origin of the primary node is
// d(position).  Inside node_adj it also replaces the march backward nested
// in K2/K3 (K4, euclider_tpu/ops/pallas_vjp.py::make_march_ckpt ->
// march_bwd_rev): the reversible reverse sweep of a marched node
// (march_reverse), through the attractor field or an expression material's
// VM program (vm_adjoint: the gradients of the field's position, of
// p0..p7 and of the scene time), and the adjoint of the portal teleport.
//
// Gradient sums across pixels: each thread accumulates its gradient of
// every parameter (the 24-float camera row, then the float tables in the
// order of ops/cuda_kernel.py FLOAT_FIELDS, then the loss) in its own
// vector; the block sums the vectors in a fixed order and writes one
// column of partial sums per block; a second small kernel sums the blocks,
// again in a fixed order.  The first MAX_PARAMS entries use no atomics and
// are deterministic.  Where the thread's vector lives is the template
// parameter kAcc, which the launch picks by size (bwd_plan, below):
// ACC_SHARED, a column of the block's dynamic shared memory (entry i of
// thread t at acc[i * ACC_STRIDE + t]); ACC_LOCAL, the thread's local
// memory; ACC_WIDE, local up to MAX_PARAMS entries.  A local vector costs
// its bytes: zeroing, accumulating and reading back up to 160 floats a
// thread in local memory took 27-54% of the tape kernel's time on the
// H100 (PERF.md §6).  The block's sum (block_partials) runs on
// shared memory in both: lane l of each warp sums row l over the warp's
// 32 threads in order, then one thread a row sums the warps in order; a
// local vector goes through its warp's small tile first.  Two kinds of
// entries are summed with atomicAdd, in an order that may change from run
// to run: the entries from MAX_PARAMS on of a scene with more parameters
// (each thread adds them into its block's column of partial sums, which
// the second kernel then sums in its fixed order), and the textures'
// gradient (12,288 floats for one 64 x 64 texture): each textured node
// adds its four texels' 3 channels into a separate device buffer, which
// stays in L2 (48 KB per 64 x 64 texture).  The vector holds only the
// tables the build reads, since every thread zeroes and reduces all of
// it.
//
// Each of the two kernel sources is its own translation unit, so that
// each kernel inlines these functions at its one call site.

#pragma once

#include "trace_common.cuh"

using namespace trace;

namespace {

constexpr int MAX_TAPE = 63;      // nodes of a tape: the tape kernel's
                                  // max_nodes, the segmented one's chunk
constexpr int MAX_PARAMS = 160;   // gradient entries a thread holds itself
constexpr int BLOCK_X = 32, BLOCK_Y = 8;
constexpr int NTHREADS = BLOCK_X * BLOCK_Y;
constexpr int NWARPS = NTHREADS / 32;
// rows of the block's gradient sums in shared memory: a column a thread
// and one padding word, so that a warp's lanes reading row l + k of their
// own warp's columns hit 32 banks
constexpr int ACC_STRIDE = NTHREADS + 1;
// where a thread's gradient vector lives (kAcc)
constexpr int ACC_LOCAL = 0;      // local memory, at most MAX_PARAMS entries
constexpr int ACC_WIDE = 1;       // local, entries past MAX_PARAMS atomic
constexpr int ACC_SHARED = 2;     // a column of the block's shared memory

// offsets of each table in the gradient vector (the camera row is [0, 24))
struct Offs {
    int sv, ssc, ior, col, col2, refl, fres, uvs, bg, wc, ws, wh, plin, ptr,
        ep, loss, n;
};
constexpr int CAM_TIME = 17;      // the time's slot in the camera row

// The gradient vector's layout from the table sizes of the entry points
// (n_shape, n_mat, n_surf, n_warp, n_portal, n_expr).
inline Offs make_offs(const int* sizes) {
    const int n_shape = sizes[0], n_mat = sizes[1], n_surf = sizes[2],
              n_warp = sizes[3], n_portal = sizes[4], n_expr = sizes[5];
    Offs off;
    off.sv = 24;
    off.ssc = off.sv + 4 * n_shape;
    off.ior = off.ssc + n_shape;
    off.col = off.ior + n_mat;
    off.col2 = off.col + 4 * n_surf;
    off.refl = off.col2 + 4 * n_surf;
    off.fres = off.refl + n_surf;
    off.uvs = off.fres + n_surf;
    off.bg = off.uvs + n_surf;
    off.wc = off.bg + 3;
    off.ws = off.wc + 4 * n_warp;
    off.wh = off.ws + n_warp;
    off.plin = off.wh + n_warp;
    off.ptr = off.plin + 16 * n_portal;
    off.ep = off.ptr + 4 * n_portal;
    off.loss = off.ep + 8 * n_expr;
    off.n = off.loss + 1;
    return off;
}

// A thread's gradient vector: entries [0, MAX_PARAMS) at grad[i] (its own
// local array) or grad[i * ACC_STRIDE] (its column of shared memory),
// summed over the block in a fixed order.  A scene of more parameters
// takes ACC_WIDE: there an entry i from MAX_PARAMS on goes by atomicAdd
// straight into the block's partial sum, ext_col[(i - MAX_PARAMS) *
// ext_stride], which the kernel sets before its threads start
// (thread_grad).
__shared__ float* ext_col;
__shared__ long long ext_stride;

template <int kAcc>
__device__ __forceinline__ void gadd(float* grad, int i, float v) {
    if constexpr (kAcc == ACC_SHARED) grad[i * ACC_STRIDE] += v;
    else if (kAcc == ACC_LOCAL || i < MAX_PARAMS) grad[i] += v;
    else atomicAdd(ext_col + (i - MAX_PARAMS) * ext_stride, v);
}

// The block's dynamic shared memory (the CPU harness's stand-in has none:
// it runs the block's phases on buffers of its own).
#ifdef __CUDACC__
__device__ __forceinline__ float* dyn_smem() {
    extern __shared__ float4 trace_smem[];
    return reinterpret_cast<float*>(trace_smem);
}
#endif

template <int kAcc>
__device__ __forceinline__ void gadd4(float* grad, int i, V4 v) {
    gadd<kAcc>(grad, i, v.x);
    gadd<kAcc>(grad, i + 1, v.y);
    gadd<kAcc>(grad, i + 2, v.z);
    gadd<kAcc>(grad, i + 3, v.w);
}

template <bool kWarp>
struct TapeNode {
    V4 org, dir;   // the input slot; after the reverse sweep, its adjoint
    float w;       // the input weight; after the reverse sweep, its adjoint
    int mat, depth;
    int child[2];  // shading index of the transmission / reflection child
    NodeRec<kWarp> rec;
};

__device__ __forceinline__ V4 vzero() { return {0.0f, 0.0f, 0.0f, 0.0f}; }

// adjoint of y = normalize(a): da = s dy - s^3 (dy . a) a, s = 1/|a|
__device__ __forceinline__ V4 normalize_adj(V4 a, V4 dy) {
    const float s = rsqrtf(dot(a, a) + 1e-20f);
    return madd(scale(dy, s), -s * s * s * dot(dy, a), a);
}

// d atan_p / dx, the derivative of the polynomial itself (as autograd of
// ops/mathx.py and jax give it; at x == 0 the first coefficient, since
// both differentiate |x| as select(x >= 0, 1, -1))
__device__ __forceinline__ float atan_p_grad(float x) {
    constexpr float C[10] = {TRACE_ATAN_COEFFS};
    const float ax = fabsf(x);
    const bool big = ax > 1.0f;
    const float z = big ? 1.0f / ax : ax;
    const float t = z * z;
    float p = C[9], dp = 0.0f;
#pragma unroll
    for (int i = 8; i >= 0; --i) {
        dp = dp * t + p;
        p = p * t + C[i];
    }
    const float core_d = p + 2.0f * t * dp;   // d/dz of z * P(z^2)
    return big ? core_d / (ax * ax) : core_d;
}

// --- sphere UV ------------------------------------------------------------

// adjoint of sphere_uv(p, c): returns d loc (add to p, subtract from c)
__device__ __forceinline__ V4 sphere_uv_adj(V4 p, V4 c, float du, float dv) {
    const V4 loc = sub(p, c);
    V4 dloc = vzero();
    // u = atan2(loc.y, safe_x) / (2 pi) + 1/2
    const bool guard = (fabsf(loc.x) + fabsf(loc.y)) < 1e-12f;
    const float X = guard ? 1.0f : loc.x;
    if (X != 0.0f) {
        const float z = loc.y / X;
        const float dz = atan_p_grad(z) * (du * INV_TWO_PI_F);
        dloc.y += dz / X;
        if (!guard) dloc.x += -dz * z / X;
    }
    // v = acos(clip(loc.z / max(|loc|, 1e-12), lo, hi)) / pi
    const float rlen = sqrtf(dot(loc, loc));
    const float m = fmaxf(rlen, 1e-12f);
    const float q = loc.z / m;
    if (q >= CZ_LO && q <= CZ_HI) {
        const float one_m = 1.0f - q * q;
        const float s = sqrtf(fmaxf(one_m, 1e-12f));
        const float a = q / s;
        const float da = -(dv / PI_F) * atan_p_grad(a);   // acos = pi/2 - atan
        float dq = da / s;
        if (one_m >= 1e-12f) {
            const float ds = -da * a / s;
            dq += ds * (0.5f / s) * (-2.0f * q);
        }
        dloc.z += dq / m;
        if (rlen >= 1e-12f) dloc = madd(dloc, -dq * q / m / rlen, loc);
    }
    return dloc;
}

// adjoint of (t1, t2) = tangent_frame(n, dim): from dt1, dt2 -> dn
__device__ __forceinline__ V4 frame_adj(V4 n, int dim, V4 dt1, V4 dt2) {
    int a, b;
    tangent_axes(n, dim, &a, &b);
    const V4 ea = axis(a), eb = axis(b);
    const V4 a1 = madd(ea, -dot(n, ea), n);
    const V4 t1 = normalize(a1);
    const V4 b1 = madd(eb, -dot(n, eb), n);
    const float kb = dot(t1, b1);
    const V4 b2 = madd(b1, -kb, t1);
    const V4 db2 = normalize_adj(b2, dt2);
    V4 db1 = db2;
    dt1 = madd(dt1, -kb, db2);
    const float dkb = -dot(db2, t1);
    dt1 = madd(dt1, dkb, b1);
    db1 = madd(db1, dkb, t1);
    const V4 da1 = normalize_adj(a1, dt1);
    // a1 = ea - n[a] n and b1 = eb - n[b] n
    V4 g = madd(scale(da1, -comp(n, a)), -comp(n, b), db1);
    const float ga = -dot(da1, n), gb = -dot(db1, n);
    g = add(g, scale(ea, ga));
    return add(g, scale(eb, gb));
}

// adjoint of (u, v) = (p . t1, p . t2) with (t1, t2) = tangent_frame(c):
// adds to dp and dc
__device__ __forceinline__ void plane_uv_adj(V4 p, V4 c, int dim, float du,
                                             float dv, V4* dp, V4* dc) {
    V4 t1, t2;
    tangent_frame(c, dim, &t1, &t2);
    *dp = madd(madd(*dp, du, t1), dv, t2);
    *dc = add(*dc, frame_adj(c, dim, scale(p, du), scale(p, dv)));
}

// --- cylinders -------------------------------------------------------------

// adjoint of cyl_uv(p, c, a): u = atan2(qy, qx) / (2 pi) + 1/2 with
// (qx, qy) = (q . t1, q . t2), q = pc - (pc . a) a, pc = p - c,
// (t1, t2) = tangent_frame(a); v = pc . a.  Adds to dp, dc and da.
__device__ __forceinline__ void cyl_uv_adj(V4 p, V4 c, V4 a, int dim,
                                           float du, float dv, V4* dp,
                                           V4* dc, V4* da) {
    const V4 pc = sub(p, c);
    const float ax = dot(pc, a);
    const V4 q = madd(pc, -ax, a);
    V4 t1, t2;
    tangent_frame(a, dim, &t1, &t2);
    const float qx = dot(q, t1), qy = dot(q, t2);
    // the atan2 pole guard of sphere_uv_adj
    const bool guard = (fabsf(qx) + fabsf(qy)) < 1e-12f;
    const float X = guard ? 1.0f : qx;
    float dqx = 0.0f, dqy = 0.0f;
    if (X != 0.0f) {
        const float z = qy / X;
        const float dz = atan_p_grad(z) * (du * INV_TWO_PI_F);
        dqy = dz / X;
        if (!guard) dqx = -dz * z / X;
    }
    const V4 dq = madd(scale(t1, dqx), dqy, t2);
    *da = add(*da, frame_adj(a, dim, scale(q, dqx), scale(q, dqy)));
    const float dax = dv - dot(dq, a);
    *da = madd(*da, -ax, dq);
    *da = madd(*da, dax, pc);
    const V4 dpc = madd(dq, dax, a);
    *dp = add(*dp, dpc);
    *dc = sub(*dc, dpc);
}

// adjoint of n0 = normalize(q), q = pc - (pc . a) a, pc = p - c: adds to
// dp, dc and da
__device__ __forceinline__ void cyl_normal_adj(V4 p, V4 c, V4 a, V4 dn0,
                                               V4* dp, V4* dc, V4* da) {
    const V4 pc = sub(p, c);
    const float k = dot(pc, a);
    const V4 dq = normalize_adj(madd(pc, -k, a), dn0);
    const float dk = -dot(dq, a);
    *da = madd(madd(*da, -k, dq), dk, pc);
    const V4 dpc = madd(dq, dk, a);
    *dp = add(*dp, dpc);
    *dc = sub(*dc, dpc);
}

// --- perlin and texture surfaces ---------------------------------------------

// d fade / dt = 30 t^2 (t - 1)^2
__device__ __forceinline__ float fade_grad(float t) {
    const float m = t - 1.0f;
    return 30.0f * t * t * m * m;
}

// gradient of perlin2 at (pu, pv) (the hash and floor are piecewise
// constant: only the fractional coordinates carry it)
__device__ __forceinline__ void perlin2_grad(float pu, float pv,
                                             uint32_t seedk, float* gx,
                                             float* gy) {
    const PerlinCell k = perlin_cell(pu, pv, seedk);
    const float xm = k.xf - 1.0f, ym = k.yf - 1.0f;
    const float n00 = grad_dot(k.h[0], k.xf, k.yf);
    const float n01 = grad_dot(k.h[1], xm, k.yf);
    const float n10 = grad_dot(k.h[2], k.xf, ym);
    const float n11 = grad_dot(k.h[3], xm, ym);
    const float sx = fade(k.xf), sy = fade(k.yf);
    const float dsx = fade_grad(k.xf), dsy = fade_grad(k.yf);
    const float gx0 = perlin_gx(k.h[0]), gx1 = perlin_gx(k.h[1]),
                gx2 = perlin_gx(k.h[2]), gx3 = perlin_gx(k.h[3]);
    const float gy0 = perlin_gy(k.h[0]), gy1 = perlin_gy(k.h[1]),
                gy2 = perlin_gy(k.h[2]), gy3 = perlin_gy(k.h[3]);
    // nx0 = n00 + sx (n01 - n00), nx1 = n10 + sx (n11 - n10),
    // r = nx0 + sy (nx1 - nx0)
    const float ax0 = gx0 + dsx * (n01 - n00) + sx * (gx1 - gx0);
    const float ax1 = gx2 + dsx * (n11 - n10) + sx * (gx3 - gx2);
    const float ay0 = gy0 + sx * (gy1 - gy0);
    const float ay1 = gy2 + sx * (gy3 - gy2);
    const float nx0 = n00 + sx * (n01 - n00), nx1 = n10 + sx * (n11 - n10);
    *gx = ax0 + sy * (ax1 - ax0);
    *gy = ay0 + dsy * (nx1 - nx0) + sy * (ay1 - ay0);
}

// adjoint of f = clip(perlin_sum(u, v, sc), 0, 1) under df -> du, dv, dsc.
// jnp.clip is maximum then minimum: its gradient is 1 inside (0, 1), half
// at either bound, 0 outside.
__device__ __forceinline__ void perlin_adj(float u, float v, float sc,
                                           int octaves, uint32_t seedk,
                                           float df, float* du, float* dv,
                                           float* dsc) {
    const float x = perlin_sum(u, v, sc, octaves, seedk);
    const float clip = (x > 0.0f && x < 1.0f) ? 1.0f
                     : (x == 0.0f || x == 1.0f) ? 0.5f : 0.0f;
    const float dacc = df * clip * 0.5f;
    const float us = __fmul_rn(u, sc), vs = __fmul_rn(v, sc);
    float amp = 1.0f, freq = 1.0f;
    *du = 0.0f;
    *dv = 0.0f;
    *dsc = 0.0f;
    for (int o = 0; o < octaves; ++o) {
        float gx, gy;
        perlin2_grad(__fmul_rn(us, freq), __fmul_rn(vs, freq),
                     seedk + 974711u * o, &gx, &gy);
        const float g = dacc * amp * freq;  // pu = u sc freq
        *du += g * gx * sc;
        *dv += g * gy * sc;
        *dsc += g * (gx * u + gy * v);
        amp *= 0.5f;
        freq *= 2.0f;
    }
}

// adjoint of the bilinear texture sample of surface sf at (u, v) under the
// colour cotangent dcol[0..2] -> du, dv, dsc; the texels' gradients are
// added into gtex (atomically: neighbouring pixels share texels).  The
// texel indices are discrete; jnp.mod's gradient is 1.
__device__ __forceinline__ void texture_adj(const Scene& s, int sf, float u,
                                            float v, const float dcol[4],
                                            float* gtex, float* du,
                                            float* dv, float* dsc) {
    const int tid = s.surf_aux[2 * sf];
    const float sc = s.surf_uv_scale[sf];
    const TexCell k = tex_cell(s, tid, u, v, sc);
    const float ex = 1.0f - k.dx, ey = 1.0f - k.dy;
    float ddx = 0.0f, ddy = 0.0f;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
        const float g = dcol[ch];
        if (g == 0.0f) continue;
        const float v00 = __ldg(s.tex + k.i00 + ch);
        const float v01 = __ldg(s.tex + k.i01 + ch);
        const float v10 = __ldg(s.tex + k.i10 + ch);
        const float v11 = __ldg(s.tex + k.i11 + ch);
        ddx += g * ((v01 - v00) * ey + (v11 - v10) * k.dy);
        ddy += g * ((v10 * ex + v11 * k.dx) - (v00 * ex + v01 * k.dx));
        atomicAdd(gtex + k.i00 + ch, g * ex * ey);
        atomicAdd(gtex + k.i01 + ch, g * k.dx * ey);
        atomicAdd(gtex + k.i10 + ch, g * ex * k.dy);
        atomicAdd(gtex + k.i11 + ch, g * k.dx * k.dy);
    }
    // fu = mod(u sc, 1) (w - 1), fv = mod(v sc, 1) (h - 1)
    const float wu = (float)(s.tex_info[3 * tid + 2] - 1);
    const float wv = (float)(s.tex_info[3 * tid + 1] - 1);
    *du = ddx * wu * sc;
    *dv = ddy * wv * sc;
    *dsc = ddx * wu * u + ddy * wv * v;
}

// --- the expression VM's adjoint ----------------------------------------
//
// The derivatives are jax autodiff's of scene/expr.py::jax_lib(safe=True)
// (and autograd's of torch_lib, which agree): zero on a guarded lane and
// for floor and sign, select(x >= 0, 1, -1) for abs, half to each side of
// a tie of min and max, and the arc functions through their polynomials
// (atan_p_grad), not the analytic 1 / (1 + x^2).

// d asin_p / dx through the polynomial: asin_p = atan(x / s),
// s = sqrt(max(1 - x^2, 1e-12))
__device__ __forceinline__ float asin_p_grad(float x) {
    const float one_m = 1.0f - x * x;
    const float s = sqrtf(fmaxf(one_m, 1e-12f));
    const float dq = one_m >= 1e-12f ? 1.0f / s + x * x / (s * s * s)
                                     : 1.0f / s;
    return atan_p_grad(x / s) * dq;
}

// Adjoint of vm_eval(f, x, val) at the values val it left: from the
// cotangent ga of the field to those of x (added to *gx), p0..p7 (gp) and
// the time (*gt).  Each instruction's value feeds exactly one consumer (the
// programs are trees), so one sweep from the last instruction down carries
// every adjoint; adj is scratch of one float per instruction.
__device__ void vm_adjoint(const Field<true>& f, V4 ga, const float* val,
                           float* adj, V4* gx, float gp[8], float* gt) {
    const int n = f.end[3];
    for (int i = 0; i < n; ++i) adj[i] = 0.0f;
    adj[f.end[0] - 1] += ga.x;
    adj[f.end[1] - 1] += ga.y;
    adj[f.end[2] - 1] += ga.z;
    adj[f.end[3] - 1] += ga.w;
    float gxs[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int i = n - 1; i >= 0; --i) {
        const int32_t* in = f.code + 4 * i;
        const int op = in[0], a = in[1], b = in[2];
        const float g = adj[i];
        if (op == OP_CONST) continue;
        if (op == OP_VAR) {
            if (a < 4) gxs[a] += g;
            else if (a < 12) gp[a - 4] += g;
            else *gt += g;
            continue;
        }
        const float A = val[a], r = val[i];
        switch (op) {
            case OP_ADD: adj[a] += g; adj[b] += g; break;
            case OP_SUB: adj[a] += g; adj[b] -= g; break;
            case OP_MUL: adj[a] += g * val[b]; adj[b] += g * A; break;
            case OP_DIV: {
                const float B = val[b];
                if (B != 0.0f) {
                    adj[a] += g / B;
                    adj[b] += -g * A / (B * B);
                }
                break;
            }
            case OP_NEG: adj[a] -= g; break;
            case OP_POWI: {
                const int n = in[3];
                if (n == 0) break;
                // d a^|n| / da = |n| a^(|n| - 1)
                const float d = abs(n) > 1 ? abs(n) * powi_abs(A, abs(n) - 1)
                                           : 1.0f;
                if (n > 0) {
                    adj[a] += g * d;
                } else {
                    const float acc = powi_abs(A, n);
                    if (acc != 0.0f) adj[a] += -g * d / (acc * acc);
                }
                break;
            }
            case OP_POWF: {  // r = exp(B L), L = safe_log(A)
                const float B = val[b];
                adj[b] += g * r * safe_log(A);
                if (A > 0.0f) adj[a] += g * r * B / A;
                break;
            }
            case OP_SIN: adj[a] += g * cosf(A); break;
            case OP_COS: adj[a] -= g * sinf(A); break;
            case OP_TANH: adj[a] += g * (1.0f - r * r); break;
            case OP_EXP: adj[a] += g * r; break;
            case OP_LOG: if (A > 0.0f) adj[a] += g / A; break;
            case OP_SQRT: if (A > 0.0f) adj[a] += g * 0.5f / r; break;
            case OP_ABS: adj[a] += A >= 0.0f ? g : -g; break;
            case OP_ATAN: adj[a] += g * atan_p_grad(A); break;
            case OP_ASIN:
                if (fabsf(A) < 1.0f) adj[a] += g * asin_p_grad(A);
                break;
            case OP_ACOS:
                if (fabsf(A) < 1.0f) adj[a] -= g * asin_p_grad(A);
                break;
            case OP_MIN:
            case OP_MAX: {
                const float B = val[b];
                // jax's balanced rule: the side equal to the result takes
                // all of g, half when both are
                const float wa = A == B ? 0.5f : (A == r ? 1.0f : 0.0f);
                adj[a] += g * wa;
                adj[b] += g * (A == B ? 0.5f : 1.0f - wa);
                break;
            }
            case OP_ATAN2: {  // atan(A / B) for B != 0, constant otherwise
                const float B = val[b];
                if (B != 0.0f) {
                    const float dq = g * atan_p_grad(A / B);
                    adj[a] += dq / B;
                    adj[b] += -dq * A / (B * B);
                }
                break;
            }
            default: break;  // OP_FLOOR, OP_SIGN: zero
        }
    }
    *gx = add(*gx, V4{gxs[0], gxs[1], gxs[2], gxs[3]});
}

// The adjoints of surface_at (trace_common.cuh) at the hit point p of a
// leaf (centre or normal row c, a cylinder's axis ca), adding to dp, to dc
// and to da (the axis): surface_uv_adj the UV's under (du, dv),
// leaf_normal_adj the unoriented normal's under dn0.  node_adj runs them
// for every hit (the UV's where the colour reads it); they are also
// march_finish's adjoint of a marched crossing's normal and UV.
__device__ __forceinline__ void surface_uv_adj(const Scene& s, bool sphere,
                                               bool cyl, V4 p, V4 c, V4 ca,
                                               float du, float dv, V4* dp,
                                               V4* dc, V4* da) {
    if (sphere) {
        const V4 dloc = sphere_uv_adj(p, c, du, dv);
        *dp = add(*dp, dloc);
        *dc = sub(*dc, dloc);
    } else if (cyl) {
        cyl_uv_adj(p, c, ca, s.dim, du, dv, dp, dc, da);
    } else {
        plane_uv_adj(p, c, s.dim, du, dv, dp, dc);
    }
}

__device__ __forceinline__ void leaf_normal_adj(bool sphere, bool cyl, V4 p,
                                                V4 c, V4 ca, V4 dn0, V4* dp,
                                                V4* dc, V4* da) {
    if (sphere) {
        const V4 dq = normalize_adj(sub(p, c), dn0);
        *dp = add(*dp, dq);
        *dc = sub(*dc, dq);
    } else if (cyl) {
        cyl_normal_adj(p, c, ca, dn0, dp, dc, da);
    } else {
        *dc = add(*dc, dn0);
    }
}

// --- the march backward (K4) ------------------------------------------------
//
// The forward sweep records, per marched node, its input (the tape slot:
// origin, direction, material, hence h) and its end (the winning entity,
// lambda, n = round(dist / h)); a hit crossed at step n - 1.  The reverse
// re-marches the n steps from the input keeping (x, v) at the start of
// every chunk of MARCH_CB steps, then walks the chunks backwards: inside a
// chunk it rebuilds each earlier state from the chunk's end state by
// inverting the step (ops/pallas_vjp.py::march_bwd_rev),
//   x = x1 - h v1,
//   s = h (v1 . a) + sqrt(max((h v1 . a)^2 - h^2 |a|^2 + 1, 0)),  a = a(x),
//   v = s v1 - h a            (|v| = 1 fixes s),
// and applies the adjoint of the step v1 = normalize(v + h a(x)),
// x1 = x + h v1 there.  Every step i < n is live; the last one also wrote
// the segment slots (sx0, sx1, sv) = (x, x1, v1) that the finish reads.
// Rebuilding restarts at every checkpoint, so rounding drifts over at most
// MARCH_CB steps.  No side test runs in the reverse: the decisions (which
// step crossed, lambda, the entity) are the tape's.  An expression
// material's a(x) is its VM program: the rebuild evaluates it (keeping
// every instruction's value) and vm_adjoint takes the step's field
// cotangent back through it.

// Re-march the n steps of a marched node from its input (what the tape
// backward's forward sweep records, trace_common.cuh march with kRec).
template <bool kExpr>
__device__ __forceinline__ void march_replay(const Field<kExpr>& f, V4 org,
                                             V4 d0, int n, MarchTape* mt) {
    V4 x = org, v = d0;
    mt->xb = org;
    for (int i = 0; i < n; ++i) {
        if (i % MARCH_CB == 0) {
            mt->ckx[i / MARCH_CB] = x;
            mt->ckv[i / MARCH_CB] = v;
        }
        V4 x1, v1;
        march_step<kExpr>(f, x, v, &x1, &v1);
        mt->xb = x;
        x = x1;
        v = v1;
    }
    mt->xe = x;
    mt->ve = v;
}

// The adjoint of one march step, x1 = xp + h v1, v1 = normalize(u),
// u = vp + h a, a = a(xp): from the cotangents g_x1, g_v1 of the step's
// outputs and g_xp of xp itself (the crossing step's sx0 slot) to gx (xp's)
// and gv (vp's), adding the field's gradients into gc and gs (an
// attractor's centre and strength), gp and gt (an expression's p0..p7 and
// the scene time, through vm_adjoint, which reads val, the VM's values at
// xp) and gh (the step h).  A statement macro over the names of the
// function it expands in (f, h, expr, xp, vp, a, val, adj, kExpr and the
// cotangents), not a function: expanded, march_reverse is token for token
// the loop body written out, while an inlined function moved the
// backward kernels' spills (PERF.md §6).  march_reverse runs it on rebuilt
// states, probe_march.cu on a stored tape of states.
#define TRACE_MARCH_STEP_ADJ                                                 \
    const V4 u = madd(vp, h, a);                                             \
    const V4 v1 = normalize(u);                                              \
    gh += dot(g_x1, v1);                                                     \
    g_v1 = madd(g_v1, h, g_x1);                                              \
    const V4 g_u = normalize_adj(u, g_v1);                                   \
    gh += dot(g_u, a);                                                       \
    const V4 g_a = scale(g_u, h);                                            \
    if (expr) {                                                              \
        /* a = the material's program at xp */                               \
        V4 g_f = vzero();                                                    \
        if constexpr (kExpr) vm_adjoint(f, g_a, val, adj, &g_f, gp, &gt);    \
        gx = add(add(g_x1, g_xp), g_f);                                      \
    } else {                                                                 \
        /* a = dd * k, dd = c - xp, k = strength r2^-1.5,                    \
           r2 = |dd|^2 + 1e-4 */                                             \
        const V4 dd = sub(f.c, xp);                                          \
        const float r2 = dot(dd, dd) + 1e-4f;                                \
        const float inv = powf(r2, -1.5f);                                   \
        const float k = f.strength * inv;                                    \
        const float g_k = dot(g_a, dd);                                      \
        gs += g_k * inv;                                                     \
        const float g_r2 = g_k * f.strength * (-1.5f) * inv / r2;            \
        const V4 g_dd = madd(scale(g_a, k), 2.0f * g_r2, dd);                \
        gc = add(gc, g_dd);                                                  \
        gx = sub(add(g_x1, g_xp), g_dd);                                     \
    }                                                                        \
    gv = g_u;

// Adjoint of the march of material mat: from the cotangents of the segment
// slots (g_sx0, g_sx1, g_sv) to those of its input (d_org, d_dir), adding
// the field's gradients into grad: centre and strength of an attractor,
// p0..p7 and the scene time of an expression, the step h of both.
template <bool kExpr, int kAcc>
__device__ void march_reverse(const Offs& off, int mat, const Field<kExpr>& f,
                              const MarchTape& mt, int n, V4 g_sx0, V4 g_sx1,
                              V4 g_sv, float* grad, V4* d_org, V4* d_dir) {
    const float h = f.h;
    V4 gx = vzero(), gv = vzero(), gc = vzero();
    float gs = 0.0f, gh = 0.0f;
    bool expr = false;
    if constexpr (kExpr) expr = f.code != nullptr;
    float val[kExpr ? MAX_EXPR : 1], adj[kExpr ? MAX_EXPR : 1];
    float gp[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    float gt = 0.0f;
    const int nb = (n + MARCH_CB - 1) / MARCH_CB;
    for (int b = nb - 1; b >= 0; --b) {
        const int i0 = b * MARCH_CB, i1 = min(i0 + MARCH_CB, n);
        V4 xc = b + 1 < nb ? mt.ckx[b + 1] : mt.xe;
        V4 vc = b + 1 < nb ? mt.ckv[b + 1] : mt.ve;
        for (int i = i1 - 1; i >= i0; --i) {
            // the state before step i, rebuilt from the state after it
            const V4 xp = madd(xc, -h, vc);
            V4 a;
            if constexpr (kExpr) {
                a = expr ? vm_eval(f, xp, val) : attractor(f.c, f.strength, xp);
            } else {
                a = attractor(f.c, f.strength, xp);
            }
            const float va = h * dot(vc, a);
            const float disc = fmaxf(va * va - h * h * dot(a, a) + 1.0f, 0.0f);
            const V4 vp = madd(scale(vc, va + sqrtf(disc)), -h, a);
            // cotangents of the step's outputs; the crossing step also
            // wrote the segment slots
            V4 g_x1 = gx, g_v1 = gv, g_xp = vzero();
            if (i == n - 1) {
                g_x1 = add(g_x1, g_sx1);
                g_v1 = add(g_v1, g_sv);
                g_xp = g_sx0;
            }
            // x1 = xp + h v1, v1 = normalize(u), u = vp + h a
            TRACE_MARCH_STEP_ADJ
            xc = xp;
            vc = vp;
        }
    }
    if (expr) {
#pragma unroll
        for (int k = 0; k < 8; ++k)
            gadd<kAcc>(grad, off.ep + 8 * mat + k, gp[k]);
        gadd<kAcc>(grad, CAM_TIME, gt);
    } else {
        gadd4<kAcc>(grad, off.wc + 4 * mat, gc);
        gadd<kAcc>(grad, off.ws + mat, gs);
    }
    gadd<kAcc>(grad, off.wh + mat, gh);
    *d_org = gx;
    *d_dir = gv;
}

// --- one node ---------------------------------------------------------------

// a marched node's recorded end (the straight build records none)
__device__ __forceinline__ int rec_n(const NodeRec<true>& r) { return r.n; }
__device__ __forceinline__ int rec_n(const NodeRec<false>&) { return 0; }
__device__ __forceinline__ float rec_lam(const NodeRec<true>& r) {
    return r.lam;
}
__device__ __forceinline__ float rec_lam(const NodeRec<false>&) {
    return 0.0f;
}

// Recompute node `in` under its recorded decisions and return the adjoint
// of its input slot (origin, direction, weight), given the cotangent G of
// the pixel colour and the input adjoints of the children it shaded; the
// textures' gradient goes to gtex.  A marched node's checkpoints are
// re-marched (march_replay) unless the forward sweep recorded them in
// *mrec (BUILD_TAPE).
template <int kB, int kAcc>
__device__ void node_adj(const Scene& s, const Offs& off,
                         const TapeNode<has_march(kB)>& T,
                         const float G[3],
                         const TapeNode<has_march(kB)>* tape,
                         float* grad, float* gtex, V4* d_org, V4* d_dir,
                         float* d_w, const MarchTape* mrec = nullptr) {
    constexpr bool kWarp = has_march(kB);
    constexpr bool kExpr = has_vm(kB);
    constexpr bool kShapes = has_shapes(kB);
    using Tape = TapeNode<kWarp>;
    const V4 o = T.org;
    const float w = T.w;
    *d_org = vzero();
    *d_dir = vzero();
    *d_w = 0.0f;
    if (T.rec.ent < 0) {  // miss: w * background
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
            gadd<kAcc>(grad, off.bg + ch, w * G[ch]);
            *d_w += G[ch] * s.background[ch];
        }
        return;
    }
    // the winning leaf (a CSG node adds no adjoint: the gradient flows
    // through the leaf, and the probe's validity is discrete)
    const int ent = T.rec.ent;
    const int leaf = hit_leaf<kShapes>(s, ent, T.rec.root);
    const int row = s.node_row[leaf];
    const int lkind = s.node_kind[leaf];
    const V4 c = load4(s.shape_vec + 4 * row);
    const float sc = s.shape_sc[row];
    const bool sphere = lkind == NODE_SPHERE;
    const bool cyl = kShapes && lkind == NODE_CYLINDER;
    const V4 ca = cyl ? load4(s.shape_vec + 4 * row + 4) : vzero();  // axis
    const bool root1 = T.rec.root & 1;

    // ---- recompute: the hit point p and the direction d there ----
    const bool marched = kWarp && s.mat_warp[T.mat] != MAT_STRAIGHT;
    float t = 0.0f, b = 0.0f, sq = 1.0f, nd = 1.0f;
    float w2 = 1.0f, cc = 0.0f, ka = 0.0f, kd = 0.0f;  // cylinder
    V4 oc = vzero(), cq = vzero(), cw = vzero(), p, d;
    Field<kExpr> f;
    MarchTape replayed;
    const MarchTape* mt = &replayed;
    if (marched) {
        f = field<kExpr>(s, T.mat);
        if (has_march_rec(kB) && mrec)
            mt = mrec;
        else
            march_replay<kExpr>(f, o, T.dir, rec_n(T.rec), &replayed);
        p = lerp_rn(mt->xb, mt->xe, rec_lam(T.rec));
        d = mt->ve;
    } else {
        d = T.dir;
        if (sphere) {
            oc = sub(o, c);
            b = dot(oc, d);
            const float q = dot(oc, oc) - sc * sc;
            sq = sqrtf(b * b - q);
            t = root1 ? -b + sq : -b - sq;
        } else if (cyl) {
            // the roots of cyl_roots: b = q . w / w2, cc = (q . q - r^2) / w2
            oc = sub(o, c);
            ka = dot(oc, ca);
            cq = madd(oc, -ka, ca);
            kd = dot(d, ca);
            cw = madd(d, -kd, ca);
            w2 = dot(cw, cw);
            b = dot(cq, cw) / w2;
            cc = (dot(cq, cq) - sc * sc) / w2;
            sq = sqrtf(b * b - cc);
            t = root1 ? -b + sq : -b - sq;
        } else {
            nd = dot(c, d);
            t = (sc - dot(c, o)) / nd;
        }
        p = madd(o, t, d);
    }
    const V4 n0 = sphere ? normalize(sub(p, c))
                  : cyl ? normalize(cyl_radial(p, c, ca)) : c;
    const V4 n = T.rec.flip ? scale(n0, -1.0f) : n0;
    const int sf = s.ent_surf[ent];
    const int skind = s.surf_kind[sf];
    float u = 0.0f, v = 0.0f;
    if (skind != SURF_UNIFORM) {
        if (sphere) {
            sphere_uv(p, c, &u, &v);
        } else if (cyl) {
            cyl_uv(p, c, ca, s.dim, &u, &v);
        } else {
            V4 t1, t2;
            tangent_frame(c, s.dim, &t1, &t2);
            u = dot(p, t1);
            v = dot(p, t2);
        }
    }
    float col[4];
    surface_color<kShapes>(s, sf, u, v, col);
    const float alpha = col[3];
    const float refl0 = s.surf_refl[sf];
    const float fres = s.surf_fresnel[sf];
    const float cos_raw = -dot(d, n);
    const float cos_c = fminf(fmaxf(cos_raw, 0.0f), 1.0f);
    const float m1 = 1.0f - cos_c;
    const float m2 = m1 * m1;
    const float m5 = m2 * m2 * m1;
    const float refl = refl0 + (1.0f - refl0) * fres * m5;  // Schlick always
    const float lw = w * (1.0f - refl) * alpha;

    float dw = 0.0f, drefl = 0.0f, dcol[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    V4 dn = vzero(), dp = vzero(), dd = vzero(), dorg = vzero(), dc = vzero();
    V4 da = vzero();  // a cylinder's axis

    // ---- local term: lw * col ----
    const float dlw = G[0] * col[0] + G[1] * col[1] + G[2] * col[2];
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) dcol[ch] += lw * G[ch];
    dw += dlw * (1.0f - refl) * alpha;
    drefl += -dlw * w * alpha;
    dcol[3] += dlw * w * (1.0f - refl);

    // ---- transmission child through a portal: pp = lin p + tr,
    //      pd = normalize(q), q = lin d, origin pp + PUSH pd ----
    const int portal = kWarp ? s.ent_portal[ent] : -1;
    if (T.child[0] >= 0 && portal >= 0) {
        const Tape& C = tape[T.child[0]];
        const float* lin = s.portal_lin + 16 * portal;
        const V4 q = matvec(lin, d);
        const V4 dq = normalize_adj(q, madd(C.dir, PUSH, C.org));
        const V4 dpp = C.org;
        gadd4<kAcc>(grad, off.ptr + 4 * portal, dpp);
        const int gl = off.plin + 16 * portal;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
            for (int j = 0; j < 4; ++j)
                gadd<kAcc>(grad, gl + 4 * i + j, comp(dpp, i) * comp(p, j)
                                         + comp(dq, i) * comp(d, j));
        }
        dp = add(dp, matvec_t(lin, dpp));
        dd = add(dd, matvec_t(lin, dq));
        dw += C.w * (1.0f - refl) * (1.0f - alpha);
        drefl += -C.w * w * (1.0f - alpha);
        dcol[3] += -C.w * w * (1.0f - refl);
    }

    // ---- transmission child: refract, PUSH offset, w (1-refl)(1-alpha) ----
    if (T.child[0] >= 0 && portal < 0) {
        const Tape& C = tape[T.child[0]];
        const int m_to = T.rec.m_to;
        const float ia = s.mat_ior[T.mat], ib = s.mat_ior[m_to];
        const float eta = ia / ib;
        const float ci = -dot(d, n);
        const float k = 1.0f - eta * eta * (1.0f - ci * ci);
        const float sk = sqrtf(k);
        const float coef = eta * ci - sk;
        const V4 out = {eta * d.x + coef * n.x, eta * d.y + coef * n.y,
                        eta * d.z + coef * n.z, eta * d.w + coef * n.w};
        dp = add(dp, C.org);
        const V4 dout = normalize_adj(out, madd(C.dir, PUSH, C.org));
        float deta = dot(dout, d);
        dd = madd(dd, eta, dout);
        const float dcoef = dot(dout, n);
        dn = madd(dn, coef, dout);
        deta += dcoef * ci;
        float dci = dcoef * eta;
        const float dk = -dcoef * 0.5f / sk;
        deta += dk * (-2.0f * eta * (1.0f - ci * ci));
        dci += dk * (eta * eta * 2.0f * ci);
        dd = madd(dd, -dci, n);
        dn = madd(dn, -dci, d);
        gadd<kAcc>(grad, off.ior + T.mat, deta / ib);
        gadd<kAcc>(grad, off.ior + m_to, -deta * ia / (ib * ib));
        dw += C.w * (1.0f - refl) * (1.0f - alpha);
        drefl += -C.w * w * (1.0f - alpha);
        dcol[3] += -C.w * w * (1.0f - refl);
    }

    // ---- reflection child: reflect, PUSH offset, w refl ----
    if (T.child[1] >= 0) {
        const Tape& C = tape[T.child[1]];
        const float kk = 2.0f * dot(d, n);
        dp = add(dp, C.org);
        const V4 drd = madd(C.dir, PUSH, C.org);
        dd = add(dd, drd);
        const float dkk = -dot(drd, n);
        dn = madd(dn, -kk, drd);
        dd = madd(dd, 2.0f * dkk, n);
        dn = madd(dn, 2.0f * dkk, d);
        dw += C.w * refl;
        drefl += C.w * w;
    }

    // ---- Schlick: refl = refl0 + (1 - refl0) fres (1 - cos)^5 ----
    gadd<kAcc>(grad, off.refl + sf, drefl * (1.0f - fres * m5));
    gadd<kAcc>(grad, off.fres + sf, drefl * (1.0f - refl0) * m5);
    const float dm1 = drefl * (1.0f - refl0) * fres * 5.0f * (m2 * m2);
    if (cos_raw >= 0.0f && cos_raw <= 1.0f) {   // the clamp passes it
        const float dcos = -dm1;
        dd = madd(dd, -dcos, n);
        dn = madd(dn, -dcos, d);
    }

    // ---- surface colour ----
    float du = 0.0f, dv = 0.0f;
    const float* c1 = s.surf_color + 4 * sf;
    const float* c2 = s.surf_color2 + 4 * sf;
    if (skind == SURF_SMOOTH) {
        const float uvs = s.surf_uv_scale[sf];
        const float A = TWO_PI_F * u * uvs, B = TWO_PI_F * v * uvs;
        const float sa = sinf(A), sb = sinf(B);
        const float f = 0.25f * (1.0f + sa) * (1.0f + sb);
        float df = 0.0f;
#pragma unroll
        for (int ch = 0; ch < 4; ++ch) {
            gadd<kAcc>(grad, off.col + 4 * sf + ch, dcol[ch] * (1.0f - f));
            gadd<kAcc>(grad, off.col2 + 4 * sf + ch, dcol[ch] * f);
            df += dcol[ch] * (c2[ch] - c1[ch]);
        }
        const float dA = df * 0.25f * (1.0f + sb) * cosf(A);
        const float dB = df * 0.25f * (1.0f + sa) * cosf(B);
        du = dA * TWO_PI_F * uvs;
        dv = dB * TWO_PI_F * uvs;
        gadd<kAcc>(grad, off.uvs + sf, dA * TWO_PI_F * u + dB * TWO_PI_F * v);
    } else if (kShapes && skind == SURF_PERLIN) {
        // col = c1 + (c2 - c1) f, f the clipped fBm
        const float uvs = s.surf_uv_scale[sf];
        const int oct = s.surf_aux[2 * sf];
        const uint32_t seedk = (uint32_t)s.surf_aux[2 * sf + 1];
        const float f = fminf(fmaxf(perlin_sum(u, v, uvs, oct, seedk), 0.0f),
                              1.0f);
        float df = 0.0f;
#pragma unroll
        for (int ch = 0; ch < 4; ++ch) {
            gadd<kAcc>(grad, off.col + 4 * sf + ch, dcol[ch] * (1.0f - f));
            gadd<kAcc>(grad, off.col2 + 4 * sf + ch, dcol[ch] * f);
            df += dcol[ch] * (c2[ch] - c1[ch]);
        }
        float dsc;
        perlin_adj(u, v, uvs, oct, seedk, df, &du, &dv, &dsc);
        gadd<kAcc>(grad, off.uvs + sf, dsc);
    } else if (kShapes && skind == SURF_TEXTURE) {
        // rgb the bilinear sample, alpha surf_color[3]
        gadd<kAcc>(grad, off.col + 4 * sf + 3, dcol[3]);
        float dsc;
        texture_adj(s, sf, u, v, dcol, gtex, &du, &dv, &dsc);
        gadd<kAcc>(grad, off.uvs + sf, dsc);
    } else {
        int base = off.col;
        if (skind == SURF_CHECKER) {
            const float uvs = s.surf_uv_scale[sf];
            const float sum = floorf(u * uvs) + floorf(v * uvs);
            if (sum - 2.0f * floorf(sum * 0.5f) >= 0.5f) base = off.col2;
        }
#pragma unroll
        for (int ch = 0; ch < 4; ++ch)
            gadd<kAcc>(grad, base + 4 * sf + ch, dcol[ch]);
    }
    if (skind == SURF_SMOOTH ||
        (kShapes && (skind == SURF_PERLIN || skind == SURF_TEXTURE)))
        surface_uv_adj(s, sphere, cyl, p, c, ca, du, dv, &dp, &dc, &da);

    // ---- normal: orientation flip, then the leaf normal ----
    const V4 dn0 = T.rec.flip ? scale(dn, -1.0f) : dn;
    leaf_normal_adj(sphere, cyl, p, c, ca, dn0, &dp, &dc, &da);

    if (marched) {
        // ---- p = sx0 (1 - lambda) + sx1 lambda, d = sv: the march (K4) ----
        const float lam = rec_lam(T.rec);
        march_reverse<kExpr, kAcc>(off, T.mat, f, *mt, rec_n(T.rec),
                                   scale(dp, 1.0f - lam), scale(dp, lam), dd,
                                   grad, &dorg, &dd);
        gadd4<kAcc>(grad, off.sv + 4 * row, dc);
        if (cyl) gadd4<kAcc>(grad, off.sv + 4 * row + 4, da);
        *d_org = dorg;
        *d_dir = dd;
        *d_w = dw;
        return;
    }

    // ---- hit point p = o + t d ----
    dorg = add(dorg, dp);
    const float dt = dot(dp, d);
    dd = madd(dd, t, dp);

    // ---- hit distance ----
    if (sphere) {
        float db = -dt;
        const float dsq = root1 ? dt : -dt;
        const float ddisc = dsq * 0.5f / sq;
        db += 2.0f * b * ddisc;
        const float dq = -ddisc;
        V4 doc = scale(oc, 2.0f * dq);
        gadd<kAcc>(grad, off.ssc + row, -2.0f * sc * dq);
        doc = madd(doc, db, d);
        dd = madd(dd, db, oc);
        dorg = add(dorg, doc);
        dc = sub(dc, doc);
    } else if (cyl) {
        // t = -b -+ sq, sq = sqrt(b^2 - cc), b = q . w / w2,
        // cc = (q . q - r^2) / w2, w2 = w . w, q = oc - ka a, ka = oc . a,
        // w = d - kd a, kd = d . a
        float db = -dt;
        const float ddisc = (root1 ? dt : -dt) * 0.5f / sq;
        db += 2.0f * b * ddisc;
        const float dcc = -ddisc;
        const float dqw = db / w2;
        const float dqq = dcc / w2;
        const float dw2 = -(db * b + dcc * cc) / w2;
        gadd<kAcc>(grad, off.ssc + row, -2.0f * sc * dqq);
        const V4 dq = madd(scale(cw, dqw), 2.0f * dqq, cq);
        const V4 dcw = madd(scale(cq, dqw), 2.0f * dw2, cw);
        const float dkd = -dot(dcw, ca);
        dd = madd(add(dd, dcw), dkd, ca);
        da = madd(madd(da, -kd, dcw), dkd, d);
        const float dka = -dot(dq, ca);
        const V4 doc = madd(dq, dka, ca);
        da = madd(madd(da, -ka, dq), dka, oc);
        dorg = add(dorg, doc);
        dc = sub(dc, doc);
    } else {
        const float dnum = dt / nd;
        const float dnd = -dt * t / nd;
        gadd<kAcc>(grad, off.ssc + row, dnum);
        dc = madd(dc, -dnum, o);
        dorg = madd(dorg, -dnum, c);
        dc = madd(dc, dnd, d);
        dd = madd(dd, dnd, c);
    }
    gadd4<kAcc>(grad, off.sv + 4 * row, dc);
    if (cyl) gadd4<kAcc>(grad, off.sv + 4 * row + 4, da);
    *d_org = dorg;
    *d_dir = dd;
    *d_w = dw;
}

// Adjoint of camera_ray for pixel (x, y): d(direction) -> the camera row.
template <int kAcc>
__device__ void camera_adj(const float* cam, int x, int y, int H, int W,
                           V4 dd0, float* grad) {
    const V4 F = load4(cam + 4), U = load4(cam + 8), R = load4(cam + 12);
    const V4 f = normalize(F);
    const float k1 = dot(R, f);
    const V4 r1 = madd(R, -k1, f);
    const V4 rt = normalize(r1);
    const float k3 = dot(U, f);
    const V4 u1 = madd(U, -k3, f);
    const float k2 = dot(u1, rt);
    const V4 w2 = madd(u1, -k2, rt);
    const V4 uu = normalize(w2);
    const float thf = cam[16];
    const float aspect = (float)((double)W / (double)H);
    const float sx = ((float)x + 0.5f) / (float)W * 2.0f - 1.0f;
    const float sy = 1.0f - ((float)y + cam[18] + 0.5f) / (float)H * 2.0f;
    const float ndx = sx * (aspect * thf), ndy = sy * thf;
    const V4 D = {f.x + ndx * rt.x + ndy * uu.x, f.y + ndx * rt.y + ndy * uu.y,
                  f.z + ndx * rt.z + ndy * uu.z, f.w + ndx * rt.w + ndy * uu.w};
    const V4 dD = normalize_adj(D, dd0);
    V4 df = dD;
    V4 drt = scale(dD, ndx);
    const V4 duu = scale(dD, ndy);
    gadd<kAcc>(grad, 16, dot(dD, rt) * sx * aspect + dot(dD, uu) * sy);
    // uu = normalize(u1 - k2 rt), k2 = u1 . rt
    const V4 dw2 = normalize_adj(w2, duu);
    V4 du1 = dw2;
    drt = madd(drt, -k2, dw2);
    const float dk2 = -dot(dw2, rt);
    du1 = madd(du1, dk2, rt);
    drt = madd(drt, dk2, u1);
    // u1 = U - k3 f, k3 = U . f
    V4 dU = du1;
    df = madd(df, -k3, du1);
    const float dk3 = -dot(du1, f);
    dU = madd(dU, dk3, f);
    df = madd(df, dk3, U);
    // rt = normalize(R - k1 f), k1 = R . f
    const V4 dr1 = normalize_adj(r1, drt);
    V4 dR = dr1;
    df = madd(df, -k1, dr1);
    const float dk1 = -dot(dr1, f);
    dR = madd(dR, dk1, f);
    df = madd(df, dk1, R);
    gadd4<kAcc>(grad, 4, normalize_adj(F, df));
    gadd4<kAcc>(grad, 8, dU);
    gadd4<kAcc>(grad, 12, dR);
}

// The colour cotangent G of pixel (x, y) of the slab: in vjp mode the
// caller's g; fused, 2 norm (acc - target), with the loss term
// norm |acc - target|^2 added into the gradient vector.
template <int kAcc>
__device__ __forceinline__ void seed(const Offs& off, const float* gin,
                                     int x, int y, int W, const float acc[3],
                                     float norm, bool fused, float* grad,
                                     float G[3]) {
    const float* gp = gin + 3 * ((size_t)y * W + x);
    if (fused) {
        float l = 0.0f;
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
            const float r = acc[ch] - gp[ch];
            l += r * r;
            G[ch] = r * (2.0f * norm);
        }
        gadd<kAcc>(grad, off.loss, l * norm);
    } else {
        G[0] = gp[0];
        G[1] = gp[1];
        G[2] = gp[2];
    }
}

// --- the kernels' common parts ----------------------------------------------

// The block's sums of its threads' gradient vectors, in a fixed order:
// each warp's 32 threads in order, then the warps in order.  A shared
// vector is summed where it lies (row r of thread t at acc[r * ACC_STRIDE
// + t]): lane l of warp w sums row l of its warp's 32 columns
// (warp_row_sums), a __syncthreads, then one thread a row sums the warps
// (block_row_sums).  A local vector goes through its warp's tile of
// shared memory, a chunk of rows at a time (tile_put, then tile_sums into
// the warp's row red[w * MAX_PARAMS + p] of partial sums, each after a
// __syncwarp), and after a __syncthreads block_row_sums sums red.  One
// shared load an entry a thread, and for a local vector one local load
// and one shared store more; the 33rd word of ACC_STRIDE and TILE_STRIDE
// puts a warp's lanes reading their rows on 32 banks.  The CPU harness
// runs these phases the same way, each over every thread before the next
// (tools/kernel_harness.py block_sums).  The tiles are TILE_ROWS rows: a
// few, so that L1 keeps what the tape spills (a 32-row tile, 39 KB of
// shared memory a block, made config5's backward 3-6% slower, PERF.md §6).
constexpr int TILE_STRIDE = 33;
constexpr int TILE_ROWS = 8;

// Thread tid's entries [p0, p0 + m) into rows [0, m) of its lane's column
// of its warp's tile.
__device__ __forceinline__ void tile_put(float* tile, const float* grad,
                                         int p0, int m, int lane) {
    for (int r = 0; r < m; ++r) tile[r * TILE_STRIDE + lane] = grad[p0 + r];
}

// Lane l < m: the sum of row l of its warp's tile over the 32 lanes, in
// order, into red[l].
__device__ __forceinline__ void tile_sums(const float* tile, int m, int lane,
                                          float* red) {
    if (lane >= m) return;
    const float* row = tile + lane * TILE_STRIDE;
    float v = row[0];
#pragma unroll
    for (int k = 1; k < 32; ++k) v += row[k];
    red[lane] = v;
}

// Lane l of thread tid's warp sums rows l, l + 32, ... below m of acc over
// the warp's 32 columns in order and leaves each sum in the row's column
// of the warp's first thread.
__device__ __forceinline__ void warp_row_sums(float* acc, int m, int tid) {
    const int col = tid & ~31;
    for (int r = tid & 31; r < m; r += 32) {
        float* row = acc + r * ACC_STRIDE + col;
        float v = row[0];
#pragma unroll
        for (int k = 1; k < 32; ++k) v += row[k];
        row[0] = v;
    }
}

// Thread tid sums the warps' sums of rows tid, tid + NTHREADS, ... below
// m, warps in order, into out[r * out_stride]: row r of warp w at
// sums[r * row_stride + w * warp_stride].
__device__ __forceinline__ void block_row_sums(const float* sums,
                                               int row_stride,
                                               int warp_stride, int m,
                                               int tid, float* out,
                                               long long out_stride) {
    for (int r = tid; r < m; r += NTHREADS) {
        const float* row = sums + r * row_stride;
        float v = row[0];
#pragma unroll
        for (int w = 1; w < NWARPS; ++w) v += row[w * warp_stride];
        out[r * out_stride] = v;
    }
}

// Floats of shared memory block_partials needs for a local vector: the
// warps' partial sums and tiles (13.6 KB).
constexpr int LOCAL_SUMS_FLOATS =
    NWARPS * (MAX_PARAMS + TILE_ROWS * TILE_STRIDE);

// The block's sums of its threads' own gradient entries (the first
// MAX_PARAMS) into its column of partials [p * n_blocks + block]; the
// entries from MAX_PARAMS on are there already.  grad: the thread's
// column of shared memory (ACC_SHARED) or its local vector, which goes
// through `work` (LOCAL_SUMS_FLOATS floats of shared memory).
template <int kAcc>
__device__ __forceinline__ void block_partials(const Offs& off, float* grad,
                                               float* partials, float* work) {
    const int np = min(off.n, MAX_PARAMS);
    const int tid = threadIdx.y * BLOCK_X + threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    const int n_blocks = gridDim.x * gridDim.y;
    float* out = partials + blockIdx.y * gridDim.x + blockIdx.x;
    __syncthreads();
    if constexpr (kAcc == ACC_SHARED) {
        float* acc = grad - tid;
        warp_row_sums(acc, np, tid);
        __syncthreads();
        block_row_sums(acc, ACC_STRIDE, 32, np, tid, out, n_blocks);
    } else {
        float* tile = work + NWARPS * MAX_PARAMS +
                      warp * TILE_ROWS * TILE_STRIDE;
        for (int p0 = 0; p0 < np; p0 += TILE_ROWS) {
            const int m = min(TILE_ROWS, np - p0);
            tile_put(tile, grad, p0, m, lane);
            __syncwarp();
            tile_sums(tile, m, lane, work + warp * MAX_PARAMS + p0);
            __syncwarp();
        }
        __syncthreads();
        block_row_sums(work, 1, MAX_PARAMS, np, tid, out, n_blocks);
    }
}

// Zero a thread's own gradient entries and, in a wide build, point the
// block's ext_col at its column of partial sums (the entries from
// MAX_PARAMS on).
template <int kAcc>
__device__ __forceinline__ void thread_grad(const Offs& off, float* grad,
                                            float* partials) {
    const int np = min(off.n, MAX_PARAMS);
    for (int p = 0; p < np; ++p)
        grad[kAcc == ACC_SHARED ? p * ACC_STRIDE : p] = 0.0f;
    if constexpr (kAcc == ACC_WIDE) {
        if (threadIdx.x == 0 && threadIdx.y == 0) {
            const int n_blocks = gridDim.x * gridDim.y;
            ext_col = partials + (size_t)MAX_PARAMS * n_blocks +
                      blockIdx.y * gridDim.x + blockIdx.x;
            ext_stride = n_blocks;
        }
        __syncthreads();
    }
}

constexpr int RED_THREADS = 256;

// out[p] = sum over blocks of partials[p, :], one block per parameter.
__global__ void __launch_bounds__(RED_THREADS)
sum_partials_kernel(const float* __restrict__ partials, int n_blocks,
                    float* __restrict__ out) {
    __shared__ float buf[RED_THREADS];
    const float* row = partials + (size_t)blockIdx.x * n_blocks;
    float v = 0.0f;
    for (int i = threadIdx.x; i < n_blocks; i += RED_THREADS) v += row[i];
    buf[threadIdx.x] = v;
    __syncthreads();
    for (int h = RED_THREADS / 2; h > 0; h >>= 1) {
        if (threadIdx.x < h) buf[threadIdx.x] += buf[threadIdx.x + h];
        __syncthreads();
    }
    if (threadIdx.x == 0) out[blockIdx.x] = buf[0];
}

// The checks both entry points make, and the gradient vector's layout ->
// 0 or a cudaError.
inline int check_scene(const Scene& s, const int* params, const int* sizes,
                       Offs* off) {
    const int build = scene_build(params);
    if (s.max_depth + 1 > MAX_SLOTS || s.max_nodes < 1 ||
        (has_march(build) && s.n_ent > MAX_MARCH_ENTITIES) ||
        s.march_steps > MARCH_CB * MAX_MARCH_CK)
        return (int)cudaErrorInvalidValue;
    if (sizes[3] != (has_march(build) ? sizes[1] : 0) ||
        (!has_march(build) && sizes[4] != 0) ||
        sizes[5] != (has_vm(build) ? sizes[1] : 0))
        return (int)cudaErrorInvalidValue;
    *off = make_offs(sizes);
    return 0;
}

// The kernel of the scene's build (CASE(kB) launches kernel<kB, wide>).
#define TRACE_BWD_BUILDS(CASE)                                             \
    switch (build) { /* this library's builds (trace_common.cuh) */        \
        TRACE_BWD_LIB_BUILDS(CASE)                                         \
        default: return (int)cudaErrorInvalidValue;                        \
    }
#ifdef TRACE_SHAPES_BUILDS
#define TRACE_BWD_LIB_BUILDS(CASE)                                         \
    CASE(BUILD_SHAPES) CASE(BUILD_SHAPES | BUILD_WARP)                     \
    CASE(BUILD_SHAPES | BUILD_EXPR)
#else
#define TRACE_BWD_LIB_BUILDS(CASE)                                         \
    CASE(BUILD_STRAIGHT) CASE(BUILD_WARP) CASE(BUILD_EXPR)
#endif

// --- the launch: where the gradient vectors live ------------------------

// Where a launch keeps the gradient vector (acc: ACC_SHARED, ACC_LOCAL or
// ACC_WIDE), its dynamic shared memory and its occupancy.
struct BwdPlan {
    int acc;
    int bytes;      // dynamic shared memory
    int blocks;     // active blocks an SM
};

// Active blocks an SM of kernel K::fn<kB, kAcc> with `bytes` of dynamic
// shared memory on the current device, which the kernel is then allowed
// (0 past what a block can have).  The allowance is only ever raised (a
// plan of more bytes than the last one stays launchable), and the last
// answer is kept: the queries would cost host time every training step.
template <class K, int kB, int kAcc>
int occupancy(int bytes, int* blocks) {
    const auto fn = K::template fn<kB, kAcc>();
    static int allowed[64], asked[64], answer[64];   // by device
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return (int)err;
    *blocks = 0;
    if (device < 0 || device >= 64) return (int)cudaErrorInvalidDevice;
    if (asked[device] == bytes) {
        *blocks = answer[device];
        return 0;
    }
    if (bytes > allowed[device]) {
        if (cudaFuncSetAttribute(fn,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 bytes) != cudaSuccess) {
            cudaGetLastError();   // more than a block can have: 0 blocks
            return 0;
        }
        allowed[device] = bytes;
    }
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn, NTHREADS,
                                                        bytes);
    if (err != cudaSuccess) return (int)err;
    asked[device] = bytes;
    answer[device] = *blocks;
    return 0;
}

// The plan of backward kernel K (a struct whose fn<kB, kAcc>() is the
// kernel of build kB keeping its vectors as kAcc) for a scene of build kB
// and gradient layout off: each thread's vector in a column of the block's
// shared memory (up to MAX_PARAMS entries) where that keeps the blocks an
// SM of a local vector, or, in a build without the VM, where one block an
// SM fits; else local.  Measured on the H100 (PERF.md §6): one
// block an SM cost config5 4.8% and its vector's local bytes 27%; it cost
// config6, whose VM keeps its values in local arrays, 34%.  -> 0 or a
// cudaError.
template <class K, int kB>
int bwd_plan(const Offs& off, BwdPlan* plan) {
    const int local = off.n <= MAX_PARAMS ? ACC_LOCAL : ACC_WIDE;
    const int work = 4 * LOCAL_SUMS_FLOATS;
    int rc, base, b;
    if (local == ACC_LOCAL) rc = occupancy<K, kB, ACC_LOCAL>(work, &base);
    else rc = occupancy<K, kB, ACC_WIDE>(work, &base);
    if (rc != 0) return rc;
    *plan = BwdPlan{local, work, base};
    if (local == ACC_LOCAL) {
        const int bytes = 4 * ((off.n * ACC_STRIDE + 3) & ~3);
        if ((rc = occupancy<K, kB, ACC_SHARED>(bytes, &b)) != 0) return rc;
        if (b >= base || (!has_vm(kB) && b >= 1))
            *plan = BwdPlan{ACC_SHARED, bytes, b};
    }
    return 0;
}

inline int zero_ext(float* partials, const Offs& off, long long n_blocks,
                    cudaStream_t st) {
    if (off.n <= MAX_PARAMS) return 0;
    return (int)cudaMemsetAsync(
        partials + (size_t)MAX_PARAMS * n_blocks, 0,
        sizeof(float) * (size_t)(off.n - MAX_PARAMS) * n_blocks, st);
}

}  // namespace
