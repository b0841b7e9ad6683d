"""ctypes wrapper for the C++ oracle, the float64 ground-truth renderer.

Port of ``euclider_tpu/oracle/native_oracle.py`` that loads without jax.  It
compiles the port's own copy of the oracle source,
``euclider_tpu_torch/oracle/native/oracle.cpp`` (held identical to the JAX
package's by ``tests/test_torch_expr.py``), with g++ into
``euclider_tpu_torch/build/``; encodes the
compiled scene (SceneStatic topology + SceneTables parameters, numpy arrays
or torch tensors) into flat arrays; and exposes
``render_native(static, tables, cam, H, W)``.  ``_encode_nodes`` is also the
node encoding the CUDA kernel reads (ops/cuda_kernel.py).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from functools import lru_cache

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "oracle", "native", "oracle.cpp")
BUILD_DIR = os.path.join(_PKG, "build")

NODE_KINDS = {"sphere": 0, "hyperplane": 1, "halfspace": 2, "cylinder": 3,
              "union": 4, "intersection": 5, "difference": 6, "symdiff": 7,
              "complement": 8}
MAT_KINDS = {"vacuum": 0, "dielectric": 1, "warp": 2, "expr": 3}
SURF_KINDS = {"uniform": 0, "checker": 1, "smooth": 2, "texture": 3,
              "perlin": 4}


def _encode_exprs(static):
    """Postfix programs for 'expr' materials: 4 component programs per
    material (empty slices for non-expr kinds) — scene/expr.py opcodes."""
    from ..scene import expr as E

    ops, vals, off = [], [], [0]
    for m, kind in enumerate(static.mat_kinds):
        for c in range(4):
            if kind == "expr":
                o, v = E.to_postfix(static.mat_exprs[m][c])
                ops.extend(o)
                vals.extend(v)
            off.append(len(ops))
    return (np.asarray(ops if ops else [0], np.int32),
            np.asarray(vals if vals else [0.0], np.float64),
            np.asarray(off, np.int32))


def build() -> str:
    """Compile the oracle shared library if needed; returns its path.

    Built with OpenMP where g++ has it; without, its ``omp`` pragmas run
    serially and the result is the same."""
    with open(_SRC, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    lib = os.path.join(BUILD_DIR, f"liboracle-{tag}.so")
    if not os.path.exists(lib):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = os.path.join(BUILD_DIR, f"tmp-{os.getpid()}-oracle-{tag}.so")
        base = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-o", tmp,
                _SRC]
        proc = subprocess.run(base[:1] + ["-fopenmp"] + base[1:],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            subprocess.run(base, check=True, capture_output=True, text=True)
        os.replace(tmp, lib)
    return lib


@lru_cache(maxsize=1)
def _lib():
    lib = ctypes.CDLL(build())
    lib.euclider_oracle_render.restype = None
    return lib


def _host(a) -> np.ndarray:
    """numpy view of a table field (numpy array or torch tensor)."""
    if hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    return np.asarray(a)


def _encode_nodes(static):
    """Flatten every entity's shape tree into parallel node arrays.

    Returns (ent_root, kind, row, cstart, ccount, child_idx)."""
    kind, row, cstart, ccount, children = [], [], [], [], []

    def add(node):
        if node[0] in ("sphere", "hyperplane", "halfspace", "cylinder"):
            idx = len(kind)
            kind.append(NODE_KINDS[node[0]])
            row.append(node[1])
            cstart.append(0)
            ccount.append(0)
            return idx
        child_ids = [add(c) for c in node[1]]
        idx = len(kind)
        kind.append(NODE_KINDS[node[0]])
        row.append(-1)
        cstart.append(len(children))
        ccount.append(len(child_ids))
        children.extend(child_ids)
        return idx

    ent_root = [add(e.shape) for e in static.entities]
    return (np.asarray(ent_root, np.int32), np.asarray(kind, np.int32),
            np.asarray(row, np.int32), np.asarray(cstart, np.int32),
            np.asarray(ccount, np.int32),
            np.asarray(children if children else [0], np.int32))


def render_native(static, tables, cam, H: int, W: int,
                  time: float = 0.0) -> np.ndarray:
    lib = _lib()
    ent_root, nk, nr, ncs, ncc, cidx = _encode_nodes(static)
    ents = static.entities
    ent_mat = np.asarray([e.material for e in ents], np.int32)
    ent_surf = np.asarray([e.surface for e in ents], np.int32)
    ent_portal = np.asarray(
        [-1 if e.portal is None else e.portal for e in ents], np.int32)

    mat_kind = np.asarray([MAT_KINDS[k] for k in static.mat_kinds], np.int32)
    surf_kind = np.asarray([SURF_KINDS[k] for k in static.surf_kinds], np.int32)
    surf_tex = np.asarray(static.surf_texture, np.int32)
    sp = static.surf_perlin or ((None,) * len(static.surf_kinds))
    surf_poct = np.asarray([1 if p is None else p[0] for p in sp], np.int32)
    surf_pseed = np.asarray([0 if p is None else p[1] for p in sp], np.int32)

    texs = [np.asarray(_host(t), np.float64) for t in tables.textures]
    if texs:
        tex_data = np.concatenate([t.reshape(-1) for t in texs])
        offs, o = [], 0
        for t in texs:
            offs.append(o)
            o += t.size
        tex_off = np.asarray(offs, np.int32)
        tex_h = np.asarray([t.shape[0] for t in texs], np.int32)
        tex_w = np.asarray([t.shape[1] for t in texs], np.int32)
    else:
        tex_data = np.zeros(1, np.float64)
        tex_off = np.zeros(1, np.int32)
        tex_h = np.ones(1, np.int32)
        tex_w = np.ones(1, np.int32)

    cam_arr = np.concatenate([
        np.asarray(_host(cam.position), np.float64).reshape(4),
        np.asarray(_host(cam.forward), np.float64).reshape(4),
        np.asarray(_host(cam.up), np.float64).reshape(4),
        np.asarray(_host(cam.right), np.float64).reshape(4),
        np.asarray([float(_host(cam.tan_half_fov))], np.float64)])

    out = np.zeros((H, W, 3), np.float32)

    def f64(a):
        return np.ascontiguousarray(np.asarray(_host(a), np.float64))

    def i32p(a):
        return np.ascontiguousarray(a).ctypes.data_as(
            ctypes.POINTER(ctypes.c_int32))

    def f64p(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))

    sv = f64(tables.shape_vec)
    sc = f64(tables.shape_sc)
    mior = f64(tables.mat_ior)
    mwc = f64(tables.mat_warp_center)
    mws = f64(tables.mat_warp_strength)
    mwh = f64(tables.mat_warp_step)
    mep = f64(tables.mat_expr_params)
    eops, evals, eoff = _encode_exprs(static)
    ucol = f64(tables.surf_color)
    ucol2 = f64(tables.surf_color2)
    urefl = f64(tables.surf_refl)
    ufres = f64(tables.surf_fresnel)
    uuvs = f64(tables.surf_uv_scale)
    plin = f64(tables.portal_lin)
    ptr_ = f64(tables.portal_tr)
    bg = f64(tables.background)

    lib.euclider_oracle_render(
        ctypes.c_int(static.dim), ctypes.c_int(len(ents)),
        i32p(ent_root), i32p(ent_mat), i32p(ent_surf), i32p(ent_portal),
        ctypes.c_int(len(nk)), i32p(nk), i32p(nr), i32p(ncs), i32p(ncc),
        i32p(cidx),
        f64p(sv), f64p(sc),
        ctypes.c_int(len(mat_kind)), i32p(mat_kind), f64p(mior), f64p(mwc),
        f64p(mws), f64p(mwh),
        f64p(mep), i32p(eops), f64p(np.ascontiguousarray(evals)), i32p(eoff),
        ctypes.c_int(len(surf_kind)), i32p(surf_kind), f64p(ucol), f64p(ucol2),
        f64p(urefl), f64p(ufres), f64p(uuvs), i32p(surf_tex),
        i32p(surf_poct), i32p(surf_pseed),
        f64p(plin), f64p(ptr_),
        f64p(np.ascontiguousarray(tex_data)), i32p(tex_off), i32p(tex_h),
        i32p(tex_w),
        f64p(bg), ctypes.c_int(static.ambient), ctypes.c_int(static.max_depth),
        ctypes.c_double(static.t_max), ctypes.c_int(static.march_steps),
        ctypes.c_double(time),
        f64p(np.ascontiguousarray(cam_arr)),
        ctypes.c_int(H), ctypes.c_int(W),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out.astype(np.float64)


if __name__ == "__main__":
    print(build())
