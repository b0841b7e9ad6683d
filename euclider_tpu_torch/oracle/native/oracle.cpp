// Scalar recursive C++ oracle — the fast ground-truth renderer.
//
// Native-runtime counterpart of euclider_tpu/oracle/cpu_oracle.py: implements
// docs/SEMANTICS.md with literal recursion per ray (the role the Rust
// reference's Universe::trace plays per SURVEY.md §3.3), multithreaded over
// pixels with OpenMP (the reference's scoped_threadpool pixel loop,
// SURVEY.md §2.1 'Pixel-loop parallelism').  Used to produce golden images at
// full resolution and finite-difference pixel gradients cheaply.
//
// Built on demand by euclider_tpu/oracle/native_oracle.py via g++ (ctypes
// interface; no pybind11 dependency).
//
// Scene encoding (see native_oracle.py):
//   node_kind: 0 sphere, 1 hyperplane, 2 halfspace, 3 cylinder (two shape
//              rows: [row] center + radius, [row+1] unit axis),
//              4 union, 5 intersection, 6 difference, 7 symdiff, 8 complement
//   mat_kind:  0 vacuum, 1 dielectric, 2 warp, 3 expr (postfix acceleration
//              programs compiled by scene/expr.py::to_postfix; evaluated by
//              the stack VM below with the same arithmetic as the NumPy/JAX
//              evaluators)
//   surf_kind: 0 uniform, 1 checker, 2 smooth, 3 texture, 4 perlin

#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <algorithm>

namespace {

constexpr double EPS_T = 1e-4;
constexpr double PROBE = 2e-4;
constexpr double PUSH = 1e-3;
constexpr double W_EPS = 1e-4;
constexpr int BISECT_ITERS = 10;

// --- Perlin noise (exact twin of ops/shading.py::perlin2) -------------------

constexpr double INV_SQRT2 = 0.7071067811865476;
constexpr double PERLIN_DIRS[8][2] = {
    {1.0, 0.0}, {-1.0, 0.0}, {0.0, 1.0}, {0.0, -1.0},
    {INV_SQRT2, INV_SQRT2}, {-INV_SQRT2, INV_SQRT2},
    {INV_SQRT2, -INV_SQRT2}, {-INV_SQRT2, -INV_SQRT2}};

static inline uint32_t hash2(uint32_t xi, uint32_t yi, uint32_t seed) {
    uint32_t n = xi * 374761393u + yi * 668265263u + seed * 974711u;
    n = (n ^ (n >> 13)) * 1274126177u;
    return n ^ (n >> 16);
}

static inline double fade(double t) {
    return t * t * t * (t * (t * 6.0 - 15.0) + 10.0);
}

static inline double perlin2(double pu, double pv, uint32_t seed) {
    double x0f = std::floor(pu), y0f = std::floor(pv);
    double xf = pu - x0f, yf = pv - y0f;
    uint32_t x0 = (uint32_t)(int32_t)x0f, y0 = (uint32_t)(int32_t)y0f;
    auto gd = [&](uint32_t cx, uint32_t cy, double dx, double dy) {
        uint32_t h = hash2(x0 + cx, y0 + cy, seed) & 7u;
        return PERLIN_DIRS[h][0] * dx + PERLIN_DIRS[h][1] * dy;
    };
    double n00 = gd(0, 0, xf, yf);
    double n01 = gd(1, 0, xf - 1.0, yf);
    double n10 = gd(0, 1, xf, yf - 1.0);
    double n11 = gd(1, 1, xf - 1.0, yf - 1.0);
    double sx = fade(xf), sy = fade(yf);
    double nx0 = n00 + sx * (n01 - n00);
    double nx1 = n10 + sx * (n11 - n10);
    return nx0 + sy * (nx1 - nx0);
}

static inline double perlin_fbm(double pu, double pv, int octaves,
                                uint32_t seed) {
    double acc = 0.0, amp = 1.0, freq = 1.0;
    for (int o = 0; o < octaves; o++) {
        acc += amp * perlin2(pu * freq, pv * freq, seed + (uint32_t)o);
        amp *= 0.5;
        freq *= 2.0;
    }
    return std::min(1.0, std::max(0.0, 0.5 + 0.5 * acc));
}

// --- expression stack VM (scene/expr.py opcode table) -----------------------
// Free function so the ctypes test surface (euclider_eval_expr below) can
// drive it directly with raw programs.  Scene program depth is validated at
// IR time on the Python side (scene/expr.py stack-depth check) and again by
// to_postfix; the in-VM bound here is defense in depth for callers handing
// the C ABI a raw program: a push past the 64-slot stack returns NaN instead
// of corrupting the frame (ADVICE/VERDICT r3).
static double expr_vm(const int32_t* ops, const double* vals, int lo, int hi,
                      const double* vars) {
    double st[64];
    int sp = 0;
    for (int i = lo; i < hi; i++) {
        // Per-opcode-class bounds (ADVICE r4): pushes need a free slot —
        // checking before EVERY opcode rejected legal peak-depth-64
        // programs that check_vm_depth accepts — and pops need enough
        // operands, or a raw program via the C ABI starting with e.g. a
        // binary op would read/write st[-1].
        int32_t op = ops[i];
        bool push = op == 0 || op == 1;
        int need = push ? 0 : ((op >= 2 && op <= 5) || op == 8 ||
                               (op >= 21 && op <= 23)) ? 2 : 1;
        if (push ? sp >= 64 : sp < need)
            return std::numeric_limits<double>::quiet_NaN();
        double val = vals[i];
        switch (op) {
        case 0: st[sp++] = val; break;                        // const
        case 1: st[sp++] = vars[(int)val]; break;             // var
        case 2: sp--; st[sp - 1] += st[sp]; break;            // add
        case 3: sp--; st[sp - 1] -= st[sp]; break;            // sub
        case 4: sp--; st[sp - 1] *= st[sp]; break;            // mul
        case 5: sp--; st[sp - 1] /= st[sp]; break;            // div
        case 6: st[sp - 1] = -st[sp - 1]; break;              // neg
        case 7: {                                             // powi
            int n = (int)val;
            if (n == 0) { st[sp - 1] = 1.0; break; }
            double a = st[sp - 1], acc = a;
            for (int k = 1; k < (n < 0 ? -n : n); k++) acc *= a;
            st[sp - 1] = n < 0 ? 1.0 / acc : acc;
            break;
        }
        case 8:  // powf: exp(b * log(a)), matching eval_ast exactly
            sp--;
            st[sp - 1] = std::exp(st[sp] * std::log(st[sp - 1]));
            break;
        case 9:  st[sp - 1] = std::sin(st[sp - 1]); break;
        case 10: st[sp - 1] = std::cos(st[sp - 1]); break;
        case 11: st[sp - 1] = std::tanh(st[sp - 1]); break;
        case 12: st[sp - 1] = std::exp(st[sp - 1]); break;
        case 13: st[sp - 1] = std::log(st[sp - 1]); break;
        case 14: st[sp - 1] = std::sqrt(st[sp - 1]); break;
        case 15: st[sp - 1] = std::fabs(st[sp - 1]); break;
        case 16: st[sp - 1] = std::floor(st[sp - 1]); break;
        case 17:                                              // sign
            st[sp - 1] = (st[sp - 1] > 0.0) - (st[sp - 1] < 0.0);
            break;
        case 18: st[sp - 1] = std::atan(st[sp - 1]); break;
        case 19: st[sp - 1] = std::asin(st[sp - 1]); break;
        case 20: st[sp - 1] = std::acos(st[sp - 1]); break;
        case 21: sp--; st[sp - 1] = std::min(st[sp - 1], st[sp]); break;
        case 22: sp--; st[sp - 1] = std::max(st[sp - 1], st[sp]); break;
        case 23: sp--; st[sp - 1] = std::atan2(st[sp - 1], st[sp]); break;
        }
    }
    // a well-formed program leaves exactly one value (empty or unbalanced
    // raw programs would otherwise return uninitialized stack memory)
    if (sp != 1) return std::numeric_limits<double>::quiet_NaN();
    return st[0];
}

struct V4 {
    double x, y, z, w;
};
static inline V4 operator+(V4 a, V4 b) { return {a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w}; }
static inline V4 operator-(V4 a, V4 b) { return {a.x - b.x, a.y - b.y, a.z - b.z, a.w - b.w}; }
static inline V4 operator*(double s, V4 a) { return {s * a.x, s * a.y, s * a.z, s * a.w}; }
static inline double dot(V4 a, V4 b) { return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w; }
static inline double norm(V4 a) { return std::sqrt(dot(a, a)); }
static inline V4 normalize(V4 a) {
    double n = norm(a);
    return (1.0 / std::max(n, 1e-20)) * a;
}

struct Scene {
    int dim;
    int n_ent;
    const int32_t *ent_root, *ent_mat, *ent_surf, *ent_portal;
    int n_nodes;
    const int32_t *node_kind, *node_row, *node_cstart, *node_ccount, *child_idx;
    const double *shape_vec, *shape_sc;
    int n_mat;
    const int32_t *mat_kind;
    const double *mat_ior, *mat_wc, *mat_ws, *mat_wh;
    const double *mat_ep;      // [n_mat * 8] p0..p7
    const int32_t *expr_ops;   // postfix programs, 4 per material
    const double *expr_vals;   // operand per op
    const int32_t *expr_off;   // n_mat*4+1 slice offsets into ops/vals
    int n_surf;
    const int32_t *surf_kind;
    const double *surf_color, *surf_color2, *surf_refl, *surf_fres, *surf_uvs;
    const int32_t *surf_tex;
    const int32_t *surf_poct, *surf_pseed;   // perlin octaves / seed per surf
    const double *portal_lin, *portal_tr;
    const double *tex_data;
    const int32_t *tex_off, *tex_h, *tex_w;
    const double *background;
    int ambient, max_depth, march_steps;
    double t_max;
    double time;   // scene time ('t' in expression materials)

    V4 svec(int row) const {
        const double* p = shape_vec + 4 * row;
        return {p[0], p[1], p[2], p[3]};
    }

    // radial component of (p - center) w.r.t. the cylinder axis at row+1
    V4 cyl_radial(int row, V4 p) const {
        V4 pc = p - svec(row);
        V4 a = svec(row + 1);
        return pc - dot(pc, a) * a;
    }

    // ---- membership / sides ------------------------------------------------
    bool member(int node, V4 p) const {
        int k = node_kind[node];
        if (k == 0) {
            V4 d = p - svec(node_row[node]);
            double r = shape_sc[node_row[node]];
            return dot(d, d) < r * r;
        }
        if (k == 1) return false;
        if (k == 2) return dot(svec(node_row[node]), p) < shape_sc[node_row[node]];
        if (k == 3) {  // cylinder
            V4 q = cyl_radial(node_row[node], p);
            double r = shape_sc[node_row[node]];
            return dot(q, q) < r * r;
        }
        int cs = node_cstart[node], cc = node_ccount[node];
        if (k == 4) {  // union
            for (int i = 0; i < cc; i++) if (member(child_idx[cs + i], p)) return true;
            return false;
        }
        if (k == 5) {  // intersection
            for (int i = 0; i < cc; i++) if (!member(child_idx[cs + i], p)) return false;
            return true;
        }
        if (k == 6)    // difference
            return member(child_idx[cs], p) && !member(child_idx[cs + 1], p);
        if (k == 7) {  // symdiff
            bool out = member(child_idx[cs], p);
            for (int i = 1; i < cc; i++) out ^= member(child_idx[cs + i], p);
            return out;
        }
        return !member(child_idx[cs], p);  // complement
    }

    bool sideP(int node, V4 p) const {
        if (node_kind[node] == 1)
            return dot(svec(node_row[node]), p) < shape_sc[node_row[node]];
        return member(node, p);
    }

    void leaves(int node, int* out, int* n) const {
        if (node_kind[node] <= 3) { out[(*n)++] = node; return; }
        int cs = node_cstart[node], cc = node_ccount[node];
        for (int i = 0; i < cc; i++) leaves(child_idx[cs + i], out, n);
    }

    // ---- leaf geometry -----------------------------------------------------
    int leaf_crossings(int leaf, V4 o, V4 d, double* ts) const {
        int k = node_kind[leaf];
        int row = node_row[leaf];
        if (k == 0) {
            V4 oc = o - svec(row);
            double r = shape_sc[row];
            double b = dot(oc, d);
            double q = dot(oc, oc) - r * r;
            double disc = b * b - q;
            if (disc <= 0.0) return 0;
            double s = std::sqrt(disc);
            ts[0] = -b - s;
            ts[1] = -b + s;
            return 2;
        }
        if (k == 3) {  // cylinder: |q + t w|^2 = r^2 with radial parts q, w
            V4 c = svec(row);
            V4 a = svec(row + 1);
            double r = shape_sc[row];
            V4 oc = o - c;
            V4 q = oc - dot(oc, a) * a;
            V4 w = d - dot(d, a) * a;
            double w2 = dot(w, w);
            if (w2 < 1e-12) return 0;
            double b = dot(q, w) / w2;
            double cc = (dot(q, q) - r * r) / w2;
            double disc = b * b - cc;
            if (disc <= 0.0) return 0;
            double s = std::sqrt(disc);
            ts[0] = -b - s;
            ts[1] = -b + s;
            return 2;
        }
        V4 n = svec(row);
        double nd = dot(n, d);
        if (std::fabs(nd) <= 1e-12) return 0;
        ts[0] = (shape_sc[row] - dot(n, o)) / nd;
        return 1;
    }

    V4 leaf_normal(int leaf, V4 p) const {
        if (node_kind[leaf] == 0) return normalize(p - svec(node_row[leaf]));
        if (node_kind[leaf] == 3) return normalize(cyl_radial(node_row[leaf], p));
        return svec(node_row[leaf]);
    }

    double boundary_abs(int leaf, V4 p) const {
        int row = node_row[leaf];
        if (node_kind[leaf] == 0)
            return std::fabs(norm(p - svec(row)) - shape_sc[row]);
        if (node_kind[leaf] == 3)
            return std::fabs(norm(cyl_radial(row, p)) - shape_sc[row]);
        return std::fabs(dot(svec(row), p) - shape_sc[row]);
    }

    void tangent_frame(V4 n, V4* t1, V4* t2) const {
        double comps[4] = {std::fabs(n.x), std::fabs(n.y), std::fabs(n.z), std::fabs(n.w)};
        for (int i = dim; i < 4; i++) comps[i] = 1e9;
        int a = 0;
        for (int i = 1; i < 4; i++) if (comps[i] < comps[a]) a = i;
        double c2[4];
        std::memcpy(c2, comps, sizeof(c2));
        c2[a] = 1e9;
        int b = 0;
        for (int i = 1; i < 4; i++) if (c2[i] < c2[b]) b = i;
        V4 ea = {0, 0, 0, 0}, eb = {0, 0, 0, 0};
        (&ea.x)[a] = 1.0;
        (&eb.x)[b] = 1.0;
        V4 u = ea - dot(n, ea) * n;
        *t1 = normalize(u);
        V4 v = eb - dot(n, eb) * n;
        v = v - dot(*t1, v) * (*t1);
        *t2 = normalize(v);
    }

    void leaf_uv(int leaf, V4 p, double* u, double* v) const {
        if (node_kind[leaf] == 0) {
            V4 loc = p - svec(node_row[leaf]);
            double sx = (std::fabs(loc.x) + std::fabs(loc.y) < 1e-12) ? 1.0 : loc.x;
            *u = std::atan2(loc.y, sx) / (2.0 * M_PI) + 0.5;
            double rl = norm(loc);
            double c = loc.z / std::max(rl, 1e-12);
            c = std::min(1.0 - 1e-6, std::max(-1.0 + 1e-6, c));
            *v = std::acos(c) / M_PI;
            return;
        }
        if (node_kind[leaf] == 3) {  // cylinder: angle around axis, axial coord
            int row = node_row[leaf];
            V4 pc = p - svec(row);
            V4 a = svec(row + 1);
            double ax = dot(pc, a);
            V4 q = pc - ax * a;
            V4 t1, t2;
            tangent_frame(a, &t1, &t2);
            double qx = dot(q, t1), qy = dot(q, t2);
            double sx = (std::fabs(qx) + std::fabs(qy) < 1e-12) ? 1.0 : qx;
            *u = std::atan2(qy, sx) / (2.0 * M_PI) + 0.5;
            *v = ax;
            return;
        }
        V4 n = svec(node_row[leaf]);
        V4 t1, t2;
        tangent_frame(n, &t1, &t2);
        *u = dot(p, t1);
        *v = dot(p, t2);
    }

    // ---- propagation -------------------------------------------------------
    // entity-level nearest valid crossing; returns t<0 on miss
    double entity_hit(int root, V4 o, V4 d, V4* n, double* u, double* v) const {
        int lv[64], nl = 0;
        leaves(root, lv, &nl);
        bool csg = node_kind[root] > 3;
        double best = -1.0;
        for (int li = 0; li < nl; li++) {
            double ts[2];
            int nt = leaf_crossings(lv[li], o, d, ts);
            for (int ti = 0; ti < nt; ti++) {
                double t = ts[ti];
                if (!(t > EPS_T && t < t_max)) continue;
                if (csg) {
                    if (member(root, o + (t - PROBE) * d)
                        == member(root, o + (t + PROBE) * d)) continue;
                }
                if (best < 0.0 || t < best) {
                    best = t;
                    V4 p = o + t * d;
                    *n = leaf_normal(lv[li], p);
                    leaf_uv(lv[li], p, u, v);
                }
            }
        }
        return best;
    }

    int material_at(V4 p) const {
        for (int e = 0; e < n_ent; e++)
            if (member(ent_root[e], p)) return ent_mat[e];
        return ambient;
    }

    // ---- shading -----------------------------------------------------------
    void eval_surface(int s, double u, double v, double* rgba) const {
        int k = surf_kind[s];
        const double* c = surf_color + 4 * s;
        if (k == 0) { std::memcpy(rgba, c, 4 * sizeof(double)); return; }
        if (k == 1) {
            double sc = surf_uvs[s];
            double par = std::fmod(std::floor(u * sc) + std::floor(v * sc), 2.0);
            if (par < 0) par += 2.0;
            const double* pick = (par >= 0.5) ? surf_color2 + 4 * s : c;
            std::memcpy(rgba, pick, 4 * sizeof(double));
            return;
        }
        if (k == 2) {
            double sc = surf_uvs[s];
            double f = 0.25 * (1.0 + std::sin(2.0 * M_PI * u * sc))
                            * (1.0 + std::sin(2.0 * M_PI * v * sc));
            const double* c2 = surf_color2 + 4 * s;
            for (int i = 0; i < 4; i++) rgba[i] = c[i] + (c2[i] - c[i]) * f;
            return;
        }
        if (k == 4) {  // perlin
            double sc = surf_uvs[s];
            double f = perlin_fbm(u * sc, v * sc, surf_poct[s],
                                  (uint32_t)surf_pseed[s]);
            const double* c2 = surf_color2 + 4 * s;
            for (int i = 0; i < 4; i++) rgba[i] = c[i] + (c2[i] - c[i]) * f;
            return;
        }
        // texture
        int tid = surf_tex[s];
        int th = tex_h[tid], tw = tex_w[tid];
        const double* tex = tex_data + tex_off[tid];
        double sc = surf_uvs[s];
        double fu = std::fmod(u * sc, 1.0);
        if (fu < 0) fu += 1.0;
        double fv = std::fmod(v * sc, 1.0);
        if (fv < 0) fv += 1.0;
        fu *= (tw - 1);
        fv *= (th - 1);
        int x0 = (int)std::floor(fu), y0 = (int)std::floor(fv);
        double dx = fu - x0, dy = fv - y0;
        int x1 = std::min(x0 + 1, tw - 1), y1 = std::min(y0 + 1, th - 1);
        for (int ch = 0; ch < 3; ch++) {
            double v00 = tex[(y0 * tw + x0) * 3 + ch];
            double v01 = tex[(y0 * tw + x1) * 3 + ch];
            double v10 = tex[(y1 * tw + x0) * 3 + ch];
            double v11 = tex[(y1 * tw + x1) * 3 + ch];
            rgba[ch] = (v00 * (1 - dx) + v01 * dx) * (1 - dy)
                     + (v10 * (1 - dx) + v11 * dx) * dy;
        }
        rgba[3] = c[3];
    }

    // ---- expression VM (scene/expr.py opcode table) --------------------------
    double eval_prog(int prog, const double* vars) const {
        return expr_vm(expr_ops, expr_vals, expr_off[prog],
                       expr_off[prog + 1], vars);
    }

    // acceleration field of a warped material (kind 2 attractor, kind 3 expr)
    V4 accel(int mat, V4 x) const {
        if (mat_kind[mat] == 2) {
            V4 wc = {mat_wc[4 * mat], mat_wc[4 * mat + 1],
                     mat_wc[4 * mat + 2], mat_wc[4 * mat + 3]};
            V4 dv = wc - x;
            double r2 = dot(dv, dv) + 1e-4;
            return (mat_ws[mat] * std::pow(r2, -1.5)) * dv;
        }
        double vars[13] = {x.x, x.y, x.z, x.w,
                           mat_ep[8 * mat], mat_ep[8 * mat + 1],
                           mat_ep[8 * mat + 2], mat_ep[8 * mat + 3],
                           mat_ep[8 * mat + 4], mat_ep[8 * mat + 5],
                           mat_ep[8 * mat + 6], mat_ep[8 * mat + 7], time};
        return {eval_prog(4 * mat, vars), eval_prog(4 * mat + 1, vars),
                eval_prog(4 * mat + 2, vars), eval_prog(4 * mat + 3, vars)};
    }

    // ---- march (SEMANTICS.md 'warp') ---------------------------------------
    bool march_hit(V4 o, V4 d, int mat, V4* hp, V4* hd, int* hent,
                   V4* hn, double* hu, double* hv) const {
        double h = mat_wh[mat];
        V4 x = o, v = d;
        bool sides[64];
        for (int e = 0; e < n_ent; e++) sides[e] = sideP(ent_root[e], x);
        double dist = 0.0;
        for (int step = 0; step < march_steps; step++) {
            if (dist > t_max) return false;
            V4 a = accel(mat, x);
            V4 v1 = normalize(v + h * a);
            V4 x1 = x + h * v1;
            bool crossed_any = false;
            bool crossed[64];
            bool ns[64];
            for (int e = 0; e < n_ent; e++) {
                ns[e] = sideP(ent_root[e], x1);
                crossed[e] = (sides[e] != ns[e]);
                crossed_any |= crossed[e];
            }
            if (crossed_any) {
                double best_lam = 2.0;
                int best_e = -1;
                V4 best_p{};
                for (int e = 0; e < n_ent; e++) {
                    if (!crossed[e]) continue;
                    bool s0 = sideP(ent_root[e], x);
                    double lo = 0.0, hi = 1.0;
                    for (int i = 0; i < BISECT_ITERS; i++) {
                        double mid = 0.5 * (lo + hi);
                        V4 pm = (1 - mid) * x + mid * x1;
                        if (sideP(ent_root[e], pm) == s0) lo = mid; else hi = mid;
                    }
                    if (hi < best_lam) {
                        best_lam = hi;
                        best_e = e;
                        best_p = (1 - hi) * x + hi * x1;
                    }
                }
                int lv[64], nl = 0;
                leaves(ent_root[best_e], lv, &nl);
                int bl = lv[0];
                double bb = boundary_abs(lv[0], best_p);
                for (int li = 1; li < nl; li++) {
                    double b = boundary_abs(lv[li], best_p);
                    if (b < bb) { bb = b; bl = lv[li]; }
                }
                *hp = best_p;
                *hd = v1;
                *hent = best_e;
                *hn = leaf_normal(bl, best_p);
                leaf_uv(bl, best_p, hu, hv);
                return true;
            }
            x = x1;
            v = v1;
            std::memcpy(sides, ns, sizeof(bool) * n_ent);
            dist += h;
        }
        return false;
    }

    // ---- the recursion (docs/SEMANTICS.md 'trace') -------------------------
    void trace(V4 o, V4 d, int mat, int depth, double weight, double* rgb) const {
        V4 p, dout, n;
        double u, v;
        int ei;
        if (mat_kind[mat] == 2 || mat_kind[mat] == 3) {
            if (!march_hit(o, d, mat, &p, &dout, &ei, &n, &u, &v)) {
                std::memcpy(rgb, background, 3 * sizeof(double));
                return;
            }
        } else {
            double best = -1.0;
            V4 bn{};
            double bu = 0, bv = 0;
            int be = -1;
            for (int e = 0; e < n_ent; e++) {
                V4 en;
                double eu, ev;
                double t = entity_hit(ent_root[e], o, d, &en, &eu, &ev);
                if (t > 0 && (best < 0 || t < best)) {
                    best = t;
                    be = e;
                    bn = en;
                    bu = eu;
                    bv = ev;
                }
            }
            if (be < 0) {
                std::memcpy(rgb, background, 3 * sizeof(double));
                return;
            }
            p = o + best * d;
            dout = d;
            ei = be;
            n = bn;
            u = bu;
            v = bv;
        }
        if (dot(n, dout) > 0.0) n = -1.0 * n;
        double rgba[4];
        int surf = ent_surf[ei];
        eval_surface(surf, u, v, rgba);
        double alpha = rgba[3], rho = surf_refl[surf];
        double fres = surf_fres[surf];
        if (fres != 0.0) {
            // get_reflection_ratio with Schlick term (SEMANTICS.md shading)
            double cos_i = std::min(1.0, std::max(0.0, -dot(dout, n)));
            double m = 1.0 - cos_i;
            rho = rho + (1.0 - rho) * fres * m * m * m * m * m;
        }
        for (int c = 0; c < 3; c++) rgb[c] = (1.0 - rho) * alpha * rgba[c];

        double w_t = (1.0 - rho) * (1.0 - alpha);
        if (depth >= 2 && weight * w_t > W_EPS) {
            double sub[3];
            if (ent_portal[ei] >= 0) {
                const double* L = portal_lin + 16 * ent_portal[ei];
                const double* tr = portal_tr + 4 * ent_portal[ei];
                V4 ps = {L[0] * p.x + L[1] * p.y + L[2] * p.z + L[3] * p.w + tr[0],
                         L[4] * p.x + L[5] * p.y + L[6] * p.z + L[7] * p.w + tr[1],
                         L[8] * p.x + L[9] * p.y + L[10] * p.z + L[11] * p.w + tr[2],
                         L[12] * p.x + L[13] * p.y + L[14] * p.z + L[15] * p.w + tr[3]};
                V4 ds = normalize({L[0] * dout.x + L[1] * dout.y + L[2] * dout.z + L[3] * dout.w,
                                   L[4] * dout.x + L[5] * dout.y + L[6] * dout.z + L[7] * dout.w,
                                   L[8] * dout.x + L[9] * dout.y + L[10] * dout.z + L[11] * dout.w,
                                   L[12] * dout.x + L[13] * dout.y + L[14] * dout.z + L[15] * dout.w});
                V4 ot = ps + PUSH * ds;
                trace(ot, ds, material_at(ot), depth - 1, weight * w_t, sub);
                for (int c = 0; c < 3; c++) rgb[c] += w_t * sub[c];
            } else {
                int m_to = material_at(p + PUSH * dout);
                double eta = mat_ior[mat] / mat_ior[m_to];
                double cos_i = -dot(dout, n);
                double k = 1.0 - eta * eta * (1.0 - cos_i * cos_i);
                if (k > 0.0) {
                    V4 ds = normalize(eta * dout + (eta * cos_i - std::sqrt(k)) * n);
                    trace(p + PUSH * ds, ds, m_to, depth - 1, weight * w_t, sub);
                    for (int c = 0; c < 3; c++) rgb[c] += w_t * sub[c];
                }
            }
        }
        if (depth >= 2 && weight * rho > W_EPS) {
            V4 r = dout - (2.0 * dot(dout, n)) * n;
            double sub[3];
            trace(p + PUSH * r, r, mat, depth - 1, weight * rho, sub);
            for (int c = 0; c < 3; c++) rgb[c] += rho * sub[c];
        }
    }
};

}  // namespace

extern "C" {

void euclider_oracle_render(
    int dim, int n_ent, const int32_t* ent_root, const int32_t* ent_mat,
    const int32_t* ent_surf, const int32_t* ent_portal,
    int n_nodes, const int32_t* node_kind, const int32_t* node_row,
    const int32_t* node_cstart, const int32_t* node_ccount,
    const int32_t* child_idx,
    const double* shape_vec, const double* shape_sc,
    int n_mat, const int32_t* mat_kind, const double* mat_ior,
    const double* mat_wc, const double* mat_ws, const double* mat_wh,
    const double* mat_ep, const int32_t* expr_ops, const double* expr_vals,
    const int32_t* expr_off,
    int n_surf, const int32_t* surf_kind, const double* surf_color,
    const double* surf_color2, const double* surf_refl,
    const double* surf_fres, const double* surf_uvs,
    const int32_t* surf_tex,
    const int32_t* surf_poct, const int32_t* surf_pseed,
    const double* portal_lin, const double* portal_tr,
    const double* tex_data, const int32_t* tex_off, const int32_t* tex_h,
    const int32_t* tex_w,
    const double* background, int ambient, int max_depth, double t_max,
    int march_steps, double time,
    const double* cam,  // pos4 fwd4 up4 right4 tan_half_fov
    int H, int W, float* out) {
    Scene s{dim, n_ent, ent_root, ent_mat, ent_surf, ent_portal,
            n_nodes, node_kind, node_row, node_cstart, node_ccount, child_idx,
            shape_vec, shape_sc,
            n_mat, mat_kind, mat_ior, mat_wc, mat_ws, mat_wh,
            mat_ep, expr_ops, expr_vals, expr_off,
            n_surf, surf_kind, surf_color, surf_color2, surf_refl, surf_fres,
            surf_uvs, surf_tex, surf_poct, surf_pseed, portal_lin, portal_tr,
            tex_data, tex_off, tex_h, tex_w,
            background, ambient, max_depth, march_steps, t_max, time};

    // camera frame (Gram-Schmidt, same as SEMANTICS.md)
    V4 pos = {cam[0], cam[1], cam[2], cam[3]};
    V4 f = normalize({cam[4], cam[5], cam[6], cam[7]});
    V4 u0 = {cam[8], cam[9], cam[10], cam[11]};
    V4 r0 = {cam[12], cam[13], cam[14], cam[15]};
    double thf = cam[16];
    V4 r = normalize(r0 - dot(r0, f) * f);
    V4 u = u0 - dot(u0, f) * f;
    u = normalize(u - dot(u, r) * r);
    double aspect = (double)W / (double)H;

#pragma omp parallel for schedule(dynamic, 4)
    for (int iy = 0; iy < H; iy++) {
        for (int ix = 0; ix < W; ix++) {
            double ndx = ((ix + 0.5) / W * 2.0 - 1.0) * aspect * thf;
            double ndy = (1.0 - (iy + 0.5) / H * 2.0) * thf;
            V4 d = normalize(f + ndx * r + ndy * u);
            double rgb[3];
            s.trace(pos, d, s.ambient, s.max_depth, 1.0, rgb);
            for (int c = 0; c < 3; c++)
                out[(iy * W + ix) * 3 + c] = (float)rgb[c];
        }
    }
}

double euclider_eval_expr(const int32_t* ops, const double* vals, int n,
                          const double* vars) {
    // direct VM entry for tests (incl. the over-deep-program NaN guard)
    return expr_vm(ops, vals, 0, n, vars);
}

}  // extern "C"
