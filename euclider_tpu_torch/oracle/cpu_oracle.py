"""Scalar recursive NumPy oracle — the debuggable ground-truth twin.

Implements docs/SEMANTICS.md with literal recursion, exactly as the
reference's ``Universe::trace`` does per ray (SURVEY.md §3.3): nearest-hit
search over entities, surface shading, recursive reflection, transition-based
transmission (refraction / portal / warped-space march).  The reference mount
was empty (SURVEY.md §0), so this oracle *is* the ground truth the TPU
backends are validated against (forward allclose + finite-difference
gradients).  A faster C++ twin lives in native/oracle.cpp.

Deliberately slow and simple: one Python call tree per ray, float64.
Use tiny resolutions in tests.

A copy of ``euclider_tpu/oracle/cpu_oracle.py`` (numpy only) on this
package's own scene front end, for the CLI's ``--backend numpy``;
``tests/test_torch_viewer.py`` holds its frames equal to the JAX
package's to the bit.
"""
from __future__ import annotations

import numpy as np

EPS_T = 1e-4
PROBE = 2e-4
PUSH = 1e-3
W_EPS = 1e-4
BISECT_ITERS = 10

_PRIMS = ("sphere", "hyperplane", "halfspace", "cylinder")

# --- Perlin noise (scalar twin of ops/shading.py::perlin2) -------------------

_INV_SQRT2 = 0.7071067811865476
_PERLIN_DIRS = ((1.0, 0.0), (-1.0, 0.0), (0.0, 1.0), (0.0, -1.0),
                (_INV_SQRT2, _INV_SQRT2), (-_INV_SQRT2, _INV_SQRT2),
                (_INV_SQRT2, -_INV_SQRT2), (-_INV_SQRT2, -_INV_SQRT2))
_M32 = 0xFFFFFFFF


def _hash2(xi: int, yi: int, seed: int) -> int:
    """uint32 lattice hash — exact twin of the XLA/C++ versions (Python ints
    masked to 32 bits reproduce uint32 wraparound bit-for-bit)."""
    n = (xi * 374761393 + yi * 668265263 + ((seed * 974711) & _M32)) & _M32
    n = ((n ^ (n >> 13)) * 1274126177) & _M32
    return n ^ (n >> 16)


def _fade(t):
    return t * t * t * (t * (t * 6.0 - 15.0) + 10.0)


def _perlin2(pu: float, pv: float, seed: int) -> float:
    x0f, y0f = np.floor(pu), np.floor(pv)
    xf, yf = pu - x0f, pv - y0f
    # int32 cast then uint32 reinterpret, matching the jnp path exactly
    x0 = int(np.int32(x0f)) & _M32
    y0 = int(np.int32(y0f)) & _M32

    def gd(cx, cy, dx, dy):
        h = _hash2((x0 + cx) & _M32, (y0 + cy) & _M32, seed) & 7
        gx, gy = _PERLIN_DIRS[h]
        return gx * dx + gy * dy

    n00 = gd(0, 0, xf, yf)
    n01 = gd(1, 0, xf - 1.0, yf)
    n10 = gd(0, 1, xf, yf - 1.0)
    n11 = gd(1, 1, xf - 1.0, yf - 1.0)
    sx, sy = _fade(xf), _fade(yf)
    nx0 = n00 + sx * (n01 - n00)
    nx1 = n10 + sx * (n11 - n10)
    return nx0 + sy * (nx1 - nx0)


def _perlin_fbm(pu: float, pv: float, octaves: int, seed: int) -> float:
    acc, amp, freq = 0.0, 1.0, 1.0
    for o in range(octaves):
        acc += amp * _perlin2(pu * freq, pv * freq, seed + o)
        amp *= 0.5
        freq *= 2.0
    return min(1.0, max(0.0, 0.5 + 0.5 * acc))


class Oracle:
    def __init__(self, static, tables, time: float = 0.0):
        self.st = static
        self.tb = tables
        self.time = float(time)
        self.shape_vec = np.asarray(tables.shape_vec, np.float64)
        self.shape_sc = np.asarray(tables.shape_sc, np.float64)
        self.mat_ior = np.asarray(tables.mat_ior, np.float64)
        self.mat_wc = np.asarray(tables.mat_warp_center, np.float64)
        self.mat_ws = np.asarray(tables.mat_warp_strength, np.float64)
        self.mat_wh = np.asarray(tables.mat_warp_step, np.float64)
        self.mat_ep = np.asarray(tables.mat_expr_params, np.float64)
        self.surf_color = np.asarray(tables.surf_color, np.float64)
        self.surf_color2 = np.asarray(tables.surf_color2, np.float64)
        self.surf_refl = np.asarray(tables.surf_refl, np.float64)
        self.surf_fres = np.asarray(tables.surf_fresnel, np.float64)
        self.surf_uvs = np.asarray(tables.surf_uv_scale, np.float64)
        self.portal_lin = np.asarray(tables.portal_lin, np.float64)
        self.portal_tr = np.asarray(tables.portal_tr, np.float64)
        self.bg = np.asarray(tables.background, np.float64)
        self.textures = [np.asarray(t, np.float64) for t in tables.textures]

    # -- membership / sides --------------------------------------------------

    def member(self, node, p):
        kind = node[0]
        if kind == "sphere":
            row = node[1]
            return float(np.dot(p - self.shape_vec[row], p - self.shape_vec[row])) \
                < self.shape_sc[row] ** 2
        if kind == "hyperplane":
            return False
        if kind == "halfspace":
            row = node[1]
            return float(np.dot(self.shape_vec[row], p)) < self.shape_sc[row]
        if kind == "cylinder":
            q = self._cyl_radial(node[1], p)
            return float(np.dot(q, q)) < self.shape_sc[node[1]] ** 2
        ms = [self.member(c, p) for c in node[1]]
        if kind == "union":
            return any(ms)
        if kind == "intersection":
            return all(ms)
        if kind == "difference":
            return ms[0] and not ms[1]
        if kind == "symdiff":
            out = ms[0]
            for m in ms[1:]:
                out ^= m
            return out
        if kind == "complement":
            return not ms[0]
        raise ValueError(kind)

    def _cyl_radial(self, row, p):
        pc = p - self.shape_vec[row]
        a = self.shape_vec[row + 1]
        return pc - np.dot(pc, a) * a

    def side(self, node, p):
        if node[0] == "hyperplane":
            row = node[1]
            return float(np.dot(self.shape_vec[row], p)) < self.shape_sc[row]
        return self.member(node, p)

    def leaves(self, node):
        if node[0] in _PRIMS:
            return [node]
        out = []
        for c in node[1]:
            out.extend(self.leaves(c))
        return out

    # -- leaf geometry -------------------------------------------------------

    def leaf_crossings(self, leaf, o, d):
        kind, row = leaf
        if kind == "sphere":
            c = self.shape_vec[row]
            r = self.shape_sc[row]
            oc = o - c
            b = float(np.dot(oc, d))
            q = float(np.dot(oc, oc)) - r * r
            disc = b * b - q
            if disc <= 0.0:
                return []
            s = np.sqrt(disc)
            return [-b - s, -b + s]
        if kind == "cylinder":
            c = self.shape_vec[row]
            a = self.shape_vec[row + 1]
            r = self.shape_sc[row]
            oc = o - c
            q = oc - np.dot(oc, a) * a
            w = d - np.dot(d, a) * a
            w2 = float(np.dot(w, w))
            if w2 < 1e-12:
                return []
            b = float(np.dot(q, w)) / w2
            cc = (float(np.dot(q, q)) - r * r) / w2
            disc = b * b - cc
            if disc <= 0.0:
                return []
            s = np.sqrt(disc)
            return [-b - s, -b + s]
        n = self.shape_vec[row]
        c = self.shape_sc[row]
        nd = float(np.dot(n, d))
        if abs(nd) <= 1e-12:
            return []
        return [(c - float(np.dot(n, o))) / nd]

    def leaf_normal(self, leaf, p):
        kind, row = leaf
        if kind == "sphere":
            v = p - self.shape_vec[row]
            return v / max(np.linalg.norm(v), 1e-20)
        if kind == "cylinder":
            q = self._cyl_radial(row, p)
            return q / max(np.linalg.norm(q), 1e-20)
        return self.shape_vec[row].copy()

    def boundary_abs(self, leaf, p):
        kind, row = leaf
        if kind == "sphere":
            return abs(np.linalg.norm(p - self.shape_vec[row]) - self.shape_sc[row])
        if kind == "cylinder":
            return abs(np.linalg.norm(self._cyl_radial(row, p))
                       - self.shape_sc[row])
        return abs(float(np.dot(self.shape_vec[row], p)) - self.shape_sc[row])

    def plane_tangent_frame(self, n):
        dim = self.st.dim
        vals = [abs(n[i]) if i < dim else 1e9 for i in range(4)]
        a = int(np.argmin(vals))
        vals2 = list(vals)
        vals2[a] = 1e9
        b = int(np.argmin(vals2))
        ea = np.zeros(4)
        ea[a] = 1.0
        eb = np.zeros(4)
        eb[b] = 1.0
        t1 = ea - np.dot(n, ea) * n
        t1 = t1 / max(np.linalg.norm(t1), 1e-20)
        t2 = eb - np.dot(n, eb) * n
        t2 = t2 - np.dot(t1, t2) * t1
        t2 = t2 / max(np.linalg.norm(t2), 1e-20)
        return t1, t2

    def leaf_uv(self, leaf, p):
        kind, row = leaf
        if kind == "sphere":
            loc = p - self.shape_vec[row]
            sx = 1.0 if abs(loc[0]) + abs(loc[1]) < 1e-12 else loc[0]
            u = np.arctan2(loc[1], sx) / (2 * np.pi) + 0.5
            rl = np.linalg.norm(loc)
            cz = np.clip(loc[2] / max(rl, 1e-12), -1.0 + 1e-6, 1.0 - 1e-6)
            v = np.arccos(cz) / np.pi
            return u, v
        if kind == "cylinder":
            pc = p - self.shape_vec[row]
            a = self.shape_vec[row + 1]
            ax = float(np.dot(pc, a))
            q = pc - ax * a
            t1, t2 = self.plane_tangent_frame(a)
            qx, qy = float(np.dot(q, t1)), float(np.dot(q, t2))
            sx = 1.0 if abs(qx) + abs(qy) < 1e-12 else qx
            u = np.arctan2(qy, sx) / (2 * np.pi) + 0.5
            return u, ax
        n = self.shape_vec[row]
        t1, t2 = self.plane_tangent_frame(n)
        return float(np.dot(p, t1)), float(np.dot(p, t2))

    # -- propagation ---------------------------------------------------------

    def entity_hit_straight(self, node, o, d):
        csg = node[0] not in _PRIMS
        best = None  # (t, normal, u, v)
        for leaf in self.leaves(node):
            for t in self.leaf_crossings(leaf, o, d):
                if not (EPS_T < t < self.st.t_max):
                    continue
                if csg:
                    pm = o + (t - PROBE) * d
                    pp = o + (t + PROBE) * d
                    if self.member(node, pm) == self.member(node, pp):
                        continue
                if best is None or t < best[0]:
                    p = o + t * d
                    best = (t, self.leaf_normal(leaf, p),
                            *self.leaf_uv(leaf, p))
        return best

    def nearest_hit_straight(self, o, d):
        best = None  # (t, ei, n, u, v)
        for ei, e in enumerate(self.st.entities):
            h = self.entity_hit_straight(e.shape, o, d)
            if h is not None and (best is None or h[0] < best[0]):
                best = (h[0], ei, h[1], h[2], h[3])
        return best

    def accel(self, mat, x):
        """March acceleration field of a warped material at point x —
        the attractor formula for 'warp', the compiled expression field
        for 'expr' (scene/expr.py; same ASTs the TPU backends burn in)."""
        if self.st.mat_kinds[mat] == "warp":
            dvec = self.mat_wc[mat] - x
            r2 = float(np.dot(dvec, dvec)) + 1e-4
            return self.mat_ws[mat] * dvec * r2 ** -1.5
        from ..scene import expr as E
        env = {"x": x[0], "y": x[1], "z": x[2], "w": x[3], "t": self.time}
        for i in range(8):
            env[f"p{i}"] = self.mat_ep[mat, i]
        lib = E.numpy_lib()
        return np.array([float(E.eval_ast(t, env, lib))
                         for t in self.st.mat_exprs[mat]], np.float64)

    def march_hit(self, o, d, mat):
        h = self.mat_wh[mat]
        x = o.copy()
        v = d.copy()
        sides = [self.side(e.shape, x) for e in self.st.entities]
        dist = 0.0
        for _ in range(self.st.march_steps):
            if dist > self.st.t_max:
                return None
            a = self.accel(mat, x)
            v1 = v + h * a
            v1 = v1 / max(np.linalg.norm(v1), 1e-20)
            x1 = x + h * v1
            new_sides = [self.side(e.shape, x1) for e in self.st.entities]
            crossed = [sides[i] != new_sides[i]
                       for i in range(len(self.st.entities))]
            if any(crossed):
                # refine each crossed entity on [x, x1]; nearest lambda wins
                best = None  # (lam, ei, p)
                for ei, cr in enumerate(crossed):
                    if not cr:
                        continue
                    node = self.st.entities[ei].shape
                    s0 = self.side(node, x)
                    lo, hi = 0.0, 1.0
                    for _ in range(BISECT_ITERS):
                        mid = 0.5 * (lo + hi)
                        pm = (1 - mid) * x + mid * x1
                        if self.side(node, pm) == s0:
                            lo = mid
                        else:
                            hi = mid
                    if best is None or hi < best[0]:
                        best = (hi, ei, (1 - hi) * x + hi * x1)
                lam, ei, p = best
                node = self.st.entities[ei].shape
                lvs = self.leaves(node)
                babs = [self.boundary_abs(l, p) for l in lvs]
                leaf = lvs[int(np.argmin(babs))]
                n = self.leaf_normal(leaf, p)
                u, v_ = self.leaf_uv(leaf, p)
                return (p, v1, ei, n, u, v_)
            x, v, sides = x1, v1, new_sides
            dist += h
        return None

    def material_at(self, p):
        for e in self.st.entities:
            if self.member(e.shape, p):
                return e.material
        return self.st.ambient

    # -- shading -------------------------------------------------------------

    def eval_surface(self, s, u, v):
        kind = self.st.surf_kinds[s]
        col = self.surf_color[s]
        if kind == "uniform":
            return col.copy()
        if kind == "checker":
            sc = self.surf_uvs[s]
            par = (np.floor(u * sc) + np.floor(v * sc)) % 2.0
            return (self.surf_color2[s] if par >= 0.5 else col).copy()
        if kind == "smooth":
            sc = self.surf_uvs[s]
            f = 0.25 * (1.0 + np.sin(2 * np.pi * u * sc)) \
                     * (1.0 + np.sin(2 * np.pi * v * sc))
            return col + (self.surf_color2[s] - col) * f
        if kind == "perlin":
            octaves, seed = self.st.surf_perlin[s]
            sc = self.surf_uvs[s]
            f = _perlin_fbm(u * sc, v * sc, octaves, seed)
            return col + (self.surf_color2[s] - col) * f
        if kind == "texture":
            tex = self.textures[self.st.surf_texture[s]]
            th, tw = tex.shape[:2]
            sc = self.surf_uvs[s]
            fu = (u * sc) % 1.0 * (tw - 1)
            fv = (v * sc) % 1.0 * (th - 1)
            x0, y0 = int(np.floor(fu)), int(np.floor(fv))
            dx, dy = fu - x0, fv - y0
            x1, y1 = min(x0 + 1, tw - 1), min(y0 + 1, th - 1)
            rgb = ((tex[y0, x0] * (1 - dx) + tex[y0, x1] * dx) * (1 - dy)
                   + (tex[y1, x0] * (1 - dx) + tex[y1, x1] * dx) * dy)
            return np.array([rgb[0], rgb[1], rgb[2], col[3]])
        raise ValueError(kind)

    # -- the recursion (SEMANTICS.md 'trace') --------------------------------

    def trace(self, o, d, mat, depth, weight=1.0):
        is_warp = self.st.mat_kinds[mat] in ("warp", "expr")
        if is_warp:
            mh = self.march_hit(o, d, mat)
            if mh is None:
                return self.bg.copy()
            p, dout, ei, n, u, v = mh
        else:
            h = self.nearest_hit_straight(o, d)
            if h is None:
                return self.bg.copy()
            t, ei, n, u, v = h
            p = o + t * d
            dout = d
        e = self.st.entities[ei]
        if float(np.dot(n, dout)) > 0.0:
            n = -n
        rgba = self.eval_surface(e.surface, u, v)
        alpha = rgba[3]
        rho = self.surf_refl[e.surface]
        fres = self.surf_fres[e.surface]
        if fres != 0.0:
            # get_reflection_ratio with Schlick term (SEMANTICS.md shading)
            cos_i = min(max(-float(np.dot(dout, n)), 0.0), 1.0)
            rho = rho + (1.0 - rho) * fres * (1.0 - cos_i) ** 5
        out = (1.0 - rho) * alpha * rgba[:3]

        # transmission
        w_t = (1.0 - rho) * (1.0 - alpha)
        if depth >= 2 and weight * w_t > W_EPS:
            if e.portal is not None:
                lin = self.portal_lin[e.portal]
                tr = self.portal_tr[e.portal]
                pstar = lin @ p + tr
                dstar = lin @ dout
                dstar = dstar / max(np.linalg.norm(dstar), 1e-20)
                o_t = pstar + PUSH * dstar
                m_t = self.material_at(o_t)
                out = out + w_t * self.trace(o_t, dstar, m_t, depth - 1,
                                             weight * w_t)
            else:
                m_to = self.material_at(p + PUSH * dout)
                eta = self.mat_ior[mat] / self.mat_ior[m_to]
                cos_i = -float(np.dot(dout, n))
                k = 1.0 - eta * eta * (1.0 - cos_i * cos_i)
                if k > 0.0:
                    dstar = eta * dout + (eta * cos_i - np.sqrt(k)) * n
                    dstar = dstar / max(np.linalg.norm(dstar), 1e-20)
                    o_t = p + PUSH * dstar
                    out = out + w_t * self.trace(o_t, dstar, m_to, depth - 1,
                                                 weight * w_t)

        # reflection
        if depth >= 2 and weight * rho > W_EPS:
            r = dout - 2.0 * float(np.dot(dout, n)) * n
            out = out + rho * self.trace(p + PUSH * r, r, mat, depth - 1,
                                         weight * rho)
        return out

    # -- camera + frame ------------------------------------------------------

    def camera_rays(self, cam, ix, iy, W, H):
        f = np.asarray(cam.forward, np.float64)
        f = f / np.linalg.norm(f)
        r = np.asarray(cam.right, np.float64)
        r = r - np.dot(r, f) * f
        r = r / max(np.linalg.norm(r), 1e-20)
        u = np.asarray(cam.up, np.float64)
        u = u - np.dot(u, f) * f
        u = u - np.dot(u, r) * r
        u = u / max(np.linalg.norm(u), 1e-20)
        t = float(cam.tan_half_fov)
        ndx = ((ix + 0.5) / W * 2.0 - 1.0) * (W / H) * t
        ndy = (1.0 - (iy + 0.5) / H * 2.0) * t
        d = f + ndx * r + ndy * u
        d = d / np.linalg.norm(d)
        return np.asarray(cam.position, np.float64).copy(), d

    def render(self, cam, H, W):
        img = np.zeros((H, W, 3))
        for iy in range(H):
            for ix in range(W):
                o, d = self.camera_rays(cam, ix, iy, W, H)
                img[iy, ix] = self.trace(o, d, self.st.ambient,
                                         self.st.max_depth)
        return img


def render_oracle(static, tables, cam, H, W, time: float = 0.0):
    return Oracle(static, tables, time).render(cam, H, W)
