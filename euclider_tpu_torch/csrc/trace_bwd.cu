// trace_bwd.cu - the backward ray-tracing kernel for Hopper (sm_90a).
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
// tree, so one kernel serves shallow and deep trees alike.  Inside both
// modes it also replaces the march backward nested in K2/K3 (K4,
// pallas_vjp.py::make_march_ckpt -> march_bwd_rev): the reversible reverse
// sweep of a marched node (see march_reverse below), through the attractor
// field or an expression material's VM program (vm_adjoint: the gradients
// of the field's position, of p0..p7 and of the scene time), and the
// adjoint of the portal teleport.
//
// Per thread: a forward sweep shades the pixel's tree with the forward
// kernel's own device code (trace_common.cuh) and writes a tape, one entry
// per shaded node: its input slot (origin, direction, weight, material,
// depth), its discrete decisions (winning entity and root, normal flip,
// material past the surface) and the indices of the children it shaded.
// The reverse sweep walks the tape backwards, recomputes each node from
// its slot under the recorded decisions and applies hand-written adjoints
// (nearest hit or march, normal and flip, UV through the mathx
// polynomials, the surface colour, Schlick always, the local term,
// refraction or the portal, reflection, the PUSH offsets), leaving the
// node's input adjoint in its tape entry for
// its parent.  The camera-ray adjoint comes last.  The adjoint of the
// ray origin of the primary node is d(position).
//
// Gradient sums across pixels: each thread accumulates its gradient of
// every parameter (the 24-float camera row, then the float tables in the
// order of ops/cuda_kernel.py FLOAT_FIELDS, then the loss) in local
// memory; the block sums them with warp shuffles and shared memory in a
// fixed order and writes one row of partial sums per block; a second small
// kernel sums the rows, again in a fixed order.  No atomics: the result is
// deterministic.
//
// What bounds it: FP32 ALU work, warp divergence and the local-memory
// traffic of the tape (at most MAX_TAPE entries of 17 words per thread, 19
// in the builds that march) and, in the expression build, of the VM's
// value and adjoint arrays (one float each per instruction), not
// device-memory bytes: it reads 12 B and writes nothing per pixel.  The
// per-thread gradient vector holds only the tables the build reads, since
// every thread reduces all of it.
//
// Built like trace_fwd.cu: nvcc -gencode arch=compute_90a,code=sm_90a
// -std=c++17 -O3, without --use_fast_math.

#include "trace_common.cuh"

using namespace trace;

namespace {

constexpr int MAX_TAPE = 63;      // nodes per pixel: compile.py's max_nodes cap
constexpr int MAX_PARAMS = 160;   // camera row + tables + loss
constexpr int BLOCK_X = 32, BLOCK_Y = 8;
constexpr int NWARPS = BLOCK_X * BLOCK_Y / 32;
constexpr int MARCH_CB = 16;      // march steps per checkpoint (K4)
constexpr int MAX_MARCH_CK = 32;  // checkpoints: march_steps <= 512

// offsets of each table in the gradient vector (the camera row is [0, 24))
struct Offs {
    int sv, ssc, ior, col, col2, refl, fres, uvs, bg, wc, ws, wh, plin, ptr,
        ep, loss, n;
};
constexpr int CAM_TIME = 17;      // the time's slot in the camera row

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

__device__ __forceinline__ void add4(float* g, V4 v) {
    g[0] += v.x;
    g[1] += v.y;
    g[2] += v.z;
    g[3] += v.w;
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

// adjoint of (u, v) = (p . t1, p . t2) with (t1, t2) = tangent_frame(c):
// adds to dp and dc
__device__ __forceinline__ void plane_uv_adj(V4 p, V4 c, int dim, float du,
                                             float dv, V4* dp, V4* dc) {
    int a, b;
    tangent_axes(c, dim, &a, &b);
    const V4 ea = axis(a), eb = axis(b);
    const V4 a1 = madd(ea, -dot(c, ea), c);
    const V4 t1 = normalize(a1);
    const V4 b1 = madd(eb, -dot(c, eb), c);
    const float kb = dot(t1, b1);
    const V4 b2 = madd(b1, -kb, t1);
    const V4 t2 = normalize(b2);
    *dp = madd(madd(*dp, du, t1), dv, t2);
    V4 dt1 = scale(p, du);
    const V4 db2 = normalize_adj(b2, scale(p, dv));
    V4 db1 = db2;
    dt1 = madd(dt1, -kb, db2);
    const float dkb = -dot(db2, t1);
    dt1 = madd(dt1, dkb, b1);
    db1 = madd(db1, dkb, t1);
    const V4 da1 = normalize_adj(a1, dt1);
    // a1 = ea - c[a] c and b1 = eb - c[b] c
    V4 g = madd(scale(da1, -comp(c, a)), -comp(c, b), db1);
    const float ga = -dot(da1, c), gb = -dot(db1, c);
    g = add(g, scale(ea, ga));
    g = add(g, scale(eb, gb));
    *dc = add(*dc, g);
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

struct MarchTape {
    V4 ckx[MAX_MARCH_CK], ckv[MAX_MARCH_CK];  // state at each chunk's start
    V4 xb, xe, ve;   // state before the last step (sx0), after it (sx1, sv)
};

// Re-march the n steps of a marched node from its input.
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

// Adjoint of the march of material mat: from the cotangents of the segment
// slots (g_sx0, g_sx1, g_sv) to those of its input (d_org, d_dir), adding
// the field's gradients into grad: centre and strength of an attractor,
// p0..p7 and the scene time of an expression, the step h of both.
template <bool kExpr>
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
            const V4 u = madd(vp, h, a);
            const V4 v1 = normalize(u);
            gh += dot(g_x1, v1);
            g_v1 = madd(g_v1, h, g_x1);
            const V4 g_u = normalize_adj(u, g_v1);
            gh += dot(g_u, a);
            const V4 g_a = scale(g_u, h);
            if (expr) {
                // a = the material's program at xp
                V4 g_f = vzero();
                if constexpr (kExpr) vm_adjoint(f, g_a, val, adj, &g_f, gp, &gt);
                gx = add(add(g_x1, g_xp), g_f);
            } else {
                // a = dd * k, dd = c - xp, k = strength r2^-1.5,
                // r2 = |dd|^2 + 1e-4
                const V4 dd = sub(f.c, xp);
                const float r2 = dot(dd, dd) + 1e-4f;
                const float inv = powf(r2, -1.5f);
                const float k = f.strength * inv;
                const float g_k = dot(g_a, dd);
                gs += g_k * inv;
                const float g_r2 = g_k * f.strength * (-1.5f) * inv / r2;
                const V4 g_dd = madd(scale(g_a, k), 2.0f * g_r2, dd);
                gc = add(gc, g_dd);
                gx = sub(add(g_x1, g_xp), g_dd);
            }
            gv = g_u;
            xc = xp;
            vc = vp;
        }
    }
    if (expr) {
#pragma unroll
        for (int k = 0; k < 8; ++k) grad[off.ep + 8 * mat + k] += gp[k];
        grad[CAM_TIME] += gt;
    } else {
        add4(grad + off.wc + 4 * mat, gc);
        grad[off.ws + mat] += gs;
    }
    grad[off.wh + mat] += gh;
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
// the pixel colour and the input adjoints of the children it shaded.
template <int kB>
__device__ void node_adj(const Scene& s, const Offs& off,
                         const TapeNode<kB != BUILD_STRAIGHT>& T,
                         const float G[3],
                         const TapeNode<kB != BUILD_STRAIGHT>* tape,
                         float* grad, V4* d_org, V4* d_dir, float* d_w) {
    constexpr bool kWarp = kB != BUILD_STRAIGHT;
    constexpr bool kExpr = kB == BUILD_EXPR;
    using Tape = TapeNode<kWarp>;
    const V4 o = T.org;
    const float w = T.w;
    *d_org = vzero();
    *d_dir = vzero();
    *d_w = 0.0f;
    if (T.rec.ent < 0) {  // miss: w * background
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
            grad[off.bg + ch] += w * G[ch];
            *d_w += G[ch] * s.background[ch];
        }
        return;
    }
    const int ent = T.rec.ent;
    const int node = s.ent_root[ent];
    const int row = s.node_row[node];
    const V4 c = load4(s.shape_vec + 4 * row);
    const float sc = s.shape_sc[row];
    const bool sphere = s.node_kind[node] == NODE_SPHERE;

    // ---- recompute: the hit point p and the direction d there ----
    const bool marched = kWarp && s.mat_warp[T.mat] != MAT_STRAIGHT;
    float t = 0.0f, b = 0.0f, sq = 1.0f, nd = 1.0f;
    V4 oc = vzero(), p, d;
    Field<kExpr> f;
    MarchTape mt;
    if (marched) {
        f = field<kExpr>(s, T.mat);
        march_replay<kExpr>(f, o, T.dir, rec_n(T.rec), &mt);
        p = lerp_rn(mt.xb, mt.xe, rec_lam(T.rec));
        d = mt.ve;
    } else {
        d = T.dir;
        if (sphere) {
            oc = sub(o, c);
            b = dot(oc, d);
            const float q = dot(oc, oc) - sc * sc;
            sq = sqrtf(b * b - q);
            t = T.rec.root ? -b + sq : -b - sq;
        } else {
            nd = dot(c, d);
            t = (sc - dot(c, o)) / nd;
        }
        p = madd(o, t, d);
    }
    const V4 n0 = sphere ? normalize(sub(p, c)) : c;
    const V4 n = T.rec.flip ? scale(n0, -1.0f) : n0;
    const int sf = s.ent_surf[ent];
    const int skind = s.surf_kind[sf];
    float u = 0.0f, v = 0.0f;
    if (skind != SURF_UNIFORM) {
        if (sphere) {
            sphere_uv(p, c, &u, &v);
        } else {
            V4 t1, t2;
            tangent_frame(c, s.dim, &t1, &t2);
            u = dot(p, t1);
            v = dot(p, t2);
        }
    }
    float col[4];
    surface_color(s, sf, u, v, col);
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
        add4(grad + off.ptr + 4 * portal, dpp);
        float* gl = grad + off.plin + 16 * portal;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
            for (int j = 0; j < 4; ++j)
                gl[4 * i + j] += comp(dpp, i) * comp(p, j)
                                 + comp(dq, i) * comp(d, j);
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
        grad[off.ior + T.mat] += deta / ib;
        grad[off.ior + m_to] += -deta * ia / (ib * ib);
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
    grad[off.refl + sf] += drefl * (1.0f - fres * m5);
    grad[off.fres + sf] += drefl * (1.0f - refl0) * m5;
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
            grad[off.col + 4 * sf + ch] += dcol[ch] * (1.0f - f);
            grad[off.col2 + 4 * sf + ch] += dcol[ch] * f;
            df += dcol[ch] * (c2[ch] - c1[ch]);
        }
        const float dA = df * 0.25f * (1.0f + sb) * cosf(A);
        const float dB = df * 0.25f * (1.0f + sa) * cosf(B);
        du = dA * TWO_PI_F * uvs;
        dv = dB * TWO_PI_F * uvs;
        grad[off.uvs + sf] += dA * TWO_PI_F * u + dB * TWO_PI_F * v;
    } else {
        int base = off.col;
        if (skind == SURF_CHECKER) {
            const float uvs = s.surf_uv_scale[sf];
            const float sum = floorf(u * uvs) + floorf(v * uvs);
            if (sum - 2.0f * floorf(sum * 0.5f) >= 0.5f) base = off.col2;
        }
#pragma unroll
        for (int ch = 0; ch < 4; ++ch) grad[base + 4 * sf + ch] += dcol[ch];
    }
    if (skind == SURF_SMOOTH) {
        if (sphere) {
            const V4 dloc = sphere_uv_adj(p, c, du, dv);
            dp = add(dp, dloc);
            dc = sub(dc, dloc);
        } else {
            plane_uv_adj(p, c, s.dim, du, dv, &dp, &dc);
        }
    }

    // ---- normal: orientation flip, then the leaf normal ----
    const V4 dn0 = T.rec.flip ? scale(dn, -1.0f) : dn;
    if (sphere) {
        const V4 da = normalize_adj(sub(p, c), dn0);
        dp = add(dp, da);
        dc = sub(dc, da);
    } else {
        dc = add(dc, dn0);
    }

    if (marched) {
        // ---- p = sx0 (1 - lambda) + sx1 lambda, d = sv: the march (K4) ----
        const float lam = rec_lam(T.rec);
        march_reverse<kExpr>(off, T.mat, f, mt, rec_n(T.rec),
                             scale(dp, 1.0f - lam), scale(dp, lam), dd, grad,
                             &dorg, &dd);
        add4(grad + off.sv + 4 * row, dc);
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
        const float dsq = T.rec.root ? dt : -dt;
        const float ddisc = dsq * 0.5f / sq;
        db += 2.0f * b * ddisc;
        const float dq = -ddisc;
        V4 doc = scale(oc, 2.0f * dq);
        grad[off.ssc + row] += -2.0f * sc * dq;
        doc = madd(doc, db, d);
        dd = madd(dd, db, oc);
        dorg = add(dorg, doc);
        dc = sub(dc, doc);
    } else {
        const float dnum = dt / nd;
        const float dnd = -dt * t / nd;
        grad[off.ssc + row] += dnum;
        dc = madd(dc, -dnum, o);
        dorg = madd(dorg, -dnum, c);
        dc = madd(dc, dnd, d);
        dd = madd(dd, dnd, c);
    }
    add4(grad + off.sv + 4 * row, dc);
    *d_org = dorg;
    *d_dir = dd;
    *d_w = dw;
}

// Adjoint of camera_ray for pixel (x, y): d(direction) -> the camera row.
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
    grad[16] += dot(dD, rt) * sx * aspect + dot(dD, uu) * sy;
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
    add4(grad + 4, normalize_adj(F, df));
    add4(grad + 8, dU);
    add4(grad + 12, dR);
}

// Forward sweep, seed, reverse sweep for one pixel; adds its gradient (and,
// fused, its loss term) into grad.
template <int kB>
__device__ void pixel_backward(const Scene& s, const Offs& off,
                               const float* cam, int x, int y, int H, int W,
                               const float* gin, float norm, bool fused,
                               float* grad) {
    using Tape = TapeNode<kB != BUILD_STRAIGHT>;
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

    const float* gp = gin + 3 * ((size_t)y * W + x);
    float G[3];
    if (fused) {
        float l = 0.0f;
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
            const float r = acc[ch] - gp[ch];
            l += r * r;
            G[ch] = r * (2.0f * norm);
        }
        grad[off.loss] += l * norm;
    } else {
        G[0] = gp[0];
        G[1] = gp[1];
        G[2] = gp[2];
    }

    for (int i = n - 1; i >= 0; --i) {
        V4 dorg, ddir;
        float dw;
        node_adj<kB>(s, off, tape[i], G, tape, grad, &dorg, &ddir, &dw);
        tape[i].org = dorg;
        tape[i].dir = ddir;
        tape[i].w = dw;
    }
    add4(grad + 0, tape[0].org);
    camera_adj(cam, x, y, H, W, tape[0].dir, grad);
}

// One thread per pixel of the row slab; one row of partial sums per block
// into partials[p * n_blocks + block].
template <int kB>
__global__ void __launch_bounds__(BLOCK_X * BLOCK_Y)
trace_bwd_kernel(Scene s, Offs off, const float* __restrict__ cam, int H,
                 int W, int rows, const float* __restrict__ gin, float norm,
                 int fused, float* __restrict__ partials) {
    const int x = blockIdx.x * BLOCK_X + threadIdx.x;
    const int y = blockIdx.y * BLOCK_Y + threadIdx.y;
    float grad[MAX_PARAMS];
    for (int p = 0; p < off.n; ++p) grad[p] = 0.0f;
    if (x < W && y < rows)
        pixel_backward<kB>(s, off, cam, x, y, H, W, gin, norm, fused != 0,
                            grad);

    __shared__ float red[NWARPS][MAX_PARAMS];
    const int tid = threadIdx.y * BLOCK_X + threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    for (int p = 0; p < off.n; ++p) {
        float v = grad[p];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
        if (lane == 0) red[warp][p] = v;
    }
    __syncthreads();
    const int n_blocks = gridDim.x * gridDim.y;
    const int blk = blockIdx.y * gridDim.x + blockIdx.x;
    for (int p = tid; p < off.n; p += BLOCK_X * BLOCK_Y) {
        float v = 0.0f;
#pragma unroll
        for (int wi = 0; wi < NWARPS; ++wi) v += red[wi][p];
        partials[(size_t)p * n_blocks + blk] = v;
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

}  // namespace

// The gradient vector out[n_params + 1]: the camera row [0, 24) (the
// scene time's gradient at 17), then the float tables in FLOAT_FIELDS order
// (shape_vec, shape_sc, mat_ior, surf_color, surf_color2, surf_refl,
// surf_fresnel, surf_uv_scale, background, mat_warp_center,
// mat_warp_strength, mat_warp_step, portal_lin, portal_tr, mat_expr_params),
// then the loss (fused mode; 0 in vjp mode).  A table the scene's build
// never reads takes no entries (its gradient is zero): every thread
// reduces the whole vector, so its length is paid per pixel.  ints,
// floats, params: the scene (trace_common.cuh make_scene); sizes: the rows
// of shape_vec, mat_ior and surf_color, and the rows in the gradient of
// the march's tables (mat_warp_*: n_mat, or 0 in the straight build), of
// the portals' (portal_*: their rows, or 0 in the straight build) and of
// mat_expr_params (n_mat in the VM build, else 0).  partials:
// scratch of (n_params + 1) * n_blocks floats, n_blocks = ceil(W/32) *
// ceil(rows/8).
extern "C" int euclider_trace_bwd(
    const int32_t* const* ints, const float* const* floats, const int* params,
    float t_max, const int* sizes, const float* cam, int H, int W, int rows,
    const float* gin, float norm, int fused, float* partials,
    long long partials_len, float* out, int device, void* stream) {
    const Scene s = make_scene(ints, floats, params, t_max, cam);
    if (s.max_depth + 1 > MAX_SLOTS || s.max_nodes > MAX_TAPE ||
        s.max_nodes < 1 || s.n_ent > 32 ||
        s.march_steps > MARCH_CB * MAX_MARCH_CK)
        return (int)cudaErrorInvalidValue;
    const int n_shape = sizes[0], n_mat = sizes[1], n_surf = sizes[2],
              n_warp = sizes[3], n_portal = sizes[4], n_expr = sizes[5];
    const int build = scene_build(params);
    if (n_warp != (build != BUILD_STRAIGHT ? n_mat : 0) ||
        (build == BUILD_STRAIGHT && n_portal != 0) ||
        n_expr != (build == BUILD_EXPR ? n_mat : 0))
        return (int)cudaErrorInvalidValue;
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
    if (off.n > MAX_PARAMS) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (rows <= 0 || W <= 0) return 0;
    const dim3 block(BLOCK_X, BLOCK_Y);
    const dim3 grid((W + BLOCK_X - 1) / BLOCK_X, (rows + BLOCK_Y - 1) / BLOCK_Y);
    const long long n_blocks = (long long)grid.x * grid.y;
    if (partials_len < n_blocks * off.n) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    switch (build) {
        case BUILD_STRAIGHT:
            trace_bwd_kernel<BUILD_STRAIGHT><<<grid, block, 0, st>>>(
                s, off, cam, H, W, rows, gin, norm, fused, partials);
            break;
        case BUILD_WARP:
            trace_bwd_kernel<BUILD_WARP><<<grid, block, 0, st>>>(
                s, off, cam, H, W, rows, gin, norm, fused, partials);
            break;
        default:
            trace_bwd_kernel<BUILD_EXPR><<<grid, block, 0, st>>>(
                s, off, cam, H, W, rows, gin, norm, fused, partials);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    sum_partials_kernel<<<off.n, RED_THREADS, 0, st>>>(
        partials, (int)n_blocks, out);
    return (int)cudaGetLastError();
}
