# Frozen copy of euclider_tpu_torch/scene/compile.py at commit ee5cc13d71e7, part of the
# benchmark's plain reference: it is never edited to follow the program.
"""Scene IR -> (SceneStatic, SceneTables).

Port note: a copy of ``euclider_tpu/scene/compile.py`` that gives the same
numpy tables without importing jax (tests/test_torch_scene.py holds the two
equal), plus ``tables_to_torch`` / ``camera_to_torch``, which carry the
numpy tables onto a torch device.

The reference resolves (space TypeId, shape TypeId) pairs through HashMaps at
trace time (SURVEY.md §1.4, §3.3).  On TPU that double-dynamic dispatch is
hoisted to *compile* time: the scene's topology is baked into the traced
program (Python-unrolled loops over entities / CSG trees), so XLA sees
straight-line masked vector code specialised to the scene — the idiomatic
equivalent of shader specialisation.  Only float parameters stay as runtime
arrays, which is exactly the differentiable parameter set.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import expr, ir

# --- static shape tree ------------------------------------------------------
# A ShapeNode is a nested tuple:
#   ('sphere', row) | ('hyperplane', row) | ('halfspace', row)
#   | (csg_op, (child ShapeNode, ...))
ShapeNode = Tuple


@dataclass(frozen=True)
class EntityStatic:
    shape: ShapeNode
    material: int          # index into material tables
    surface: int           # index into surface tables
    portal: Optional[int]  # index into portal tables, or None
    name: str = ""


@dataclass(frozen=True)
class SceneStatic:
    """Hashable scene topology — safe to use as a jit static argument."""

    dim: int
    entities: Tuple[EntityStatic, ...]
    mat_kinds: Tuple[str, ...]      # 'vacuum' | 'dielectric' | 'warp'
    surf_kinds: Tuple[str, ...]     # 'uniform' | 'checker' | 'texture'
    surf_texture: Tuple[int, ...]   # texture id per surface (-1 if none)
    ambient: int                    # material index of the surrounding space
    max_depth: int
    t_max: float
    march_steps: int
    max_nodes: int
    name: str = ""
    # Static-specialisation hints, derived from the IR's literal values.
    # They gate dead-branch elision in the *non-differentiable* forward
    # path only (ops/trace.py): a surface whose IR alpha is exactly 1 can
    # never spawn a transmission ray, and one with reflectivity exactly 0
    # can never spawn a reflection ray, so the whole branch (including the
    # stack write) is dropped from the compiled program.  The
    # differentiable path ignores the hints so gradients w.r.t. alpha /
    # reflectivity stay exact even at the pruning point.
    surf_alpha1: Tuple[bool, ...] = ()   # alpha statically == 1
    surf_refl0: Tuple[bool, ...] = ()    # reflectivity AND fresnel == 0
    surf_need_uv: Tuple[bool, ...] = ()  # color depends on the UV coords
    surf_fres0: Tuple[bool, ...] = ()    # fresnel statically == 0
    # Per-material acceleration-field ASTs for 'expr' materials (scene/expr
    # .py): (ax, ay, az, aw) tuples, or None for non-expr materials.  ASTs
    # are nested tuples -> hashable -> burned into the traced program.
    mat_exprs: Tuple[Optional[Tuple], ...] = ()
    # (octaves, seed) per 'perlin' surface, None otherwise
    surf_perlin: Tuple[Optional[Tuple[int, int]], ...] = ()

    @property
    def has_warp(self) -> bool:
        return any(k in ("warp", "expr") for k in self.mat_kinds)

    @property
    def has_portal(self) -> bool:
        return any(e.portal is not None for e in self.entities)


class SceneTables(NamedTuple):
    """Differentiable scene parameters (pytree of f32 arrays).

    This is the TPU-native replacement for the reference's boxed entity graph
    — the flat SoA table mandated by the north star (BASELINE.json:5).
    """

    shape_vec: np.ndarray     # [S, 4] sphere center | plane/halfspace normal
    shape_sc: np.ndarray      # [S]    sphere radius | plane/halfspace offset
    mat_ior: np.ndarray       # [M]
    mat_warp_center: np.ndarray    # [M, 4]
    mat_warp_strength: np.ndarray  # [M]
    mat_warp_step: np.ndarray      # [M]
    mat_expr_params: np.ndarray    # [M, 8] p0..p7 for 'expr' materials
    surf_color: np.ndarray    # [U, 4] rgba
    surf_color2: np.ndarray   # [U, 4] rgba (checker second color)
    surf_refl: np.ndarray     # [U]
    surf_fresnel: np.ndarray  # [U] Schlick coefficient of get_reflection_ratio
    surf_uv_scale: np.ndarray # [U]
    portal_lin: np.ndarray    # [P, 4, 4]
    portal_tr: np.ndarray     # [P, 4]
    background: np.ndarray    # [3]
    textures: Tuple[np.ndarray, ...]  # each [th, tw, 3]


class CameraParams(NamedTuple):
    """Differentiable camera parameters."""

    position: np.ndarray      # [4]
    forward: np.ndarray       # [4]
    up: np.ndarray            # [4]
    right: np.ndarray         # [4]
    tan_half_fov: np.ndarray  # scalar


def cast_tables(tables: SceneTables, dtype) -> SceneTables:
    """Cast every float table to ``dtype`` (np.float32 / np.float64).

    The plain render derives its compute dtype from these arrays (through
    ``tables_to_torch(..., dtype=torch.float64)``) — the CustomFloat
    f32/f64 genericity axis of the reference (SURVEY.md L0).  The CUDA
    kernels take tables of any floating dtype and compute in float32, as
    the Pallas kernels do: they cast float64 tables to float32 and hand
    back gradients in float64."""
    def cast(f):
        if isinstance(f, tuple):
            return tuple(np.asarray(x, dtype) for x in f)
        return np.asarray(f, dtype)

    return SceneTables(*[cast(f) for f in tables])


def cast_camera(cam: "CameraParams", dtype) -> "CameraParams":
    return CameraParams(*[np.asarray(f, dtype) for f in cam])


def compile_camera(cam: ir.Camera) -> CameraParams:
    t = np.tan(np.deg2rad(cam.fov_deg) * 0.5)
    return CameraParams(
        position=np.asarray(cam.position, np.float32),
        forward=np.asarray(cam.forward, np.float32),
        up=np.asarray(cam.up, np.float32),
        right=np.asarray(cam.right, np.float32),
        tan_half_fov=np.float32(t),
    )


def _mat_kind(m: ir.Material) -> str:
    if isinstance(m, ir.Vacuum):
        return "vacuum"
    if isinstance(m, ir.Dielectric):
        return "dielectric"
    if isinstance(m, ir.WarpSpace):
        return "warp"
    if isinstance(m, ir.ExprSpace):
        return "expr"
    raise TypeError(f"unknown material {m!r}")


def _surf_kind(s: ir.Surface) -> str:
    if isinstance(s, ir.UniformSurface):
        return "uniform"
    if isinstance(s, ir.CheckerSurface):
        return "checker"
    if isinstance(s, ir.SmoothSurface):
        return "smooth"
    if isinstance(s, ir.PerlinSurface):
        return "perlin"
    if isinstance(s, ir.TextureSurface):
        return "texture"
    raise TypeError(f"unknown surface {s!r}")


def compile_scene(scene: ir.Scene) -> Tuple[SceneStatic, SceneTables]:
    shape_vec, shape_sc = [], []

    def flatten_shape(s: ir.Shape) -> ShapeNode:
        if isinstance(s, ir.Sphere):
            row = len(shape_sc)
            shape_vec.append(s.center)
            shape_sc.append(s.radius)
            return ("sphere", row)
        if isinstance(s, ir.Hyperplane):
            row = len(shape_sc)
            n = np.asarray(s.normal, np.float64)
            nn = n / np.linalg.norm(n)
            shape_vec.append(tuple(nn))
            shape_sc.append(s.offset / np.linalg.norm(n))
            return ("hyperplane", row)
        if isinstance(s, ir.HalfSpace):
            row = len(shape_sc)
            n = np.asarray(s.normal, np.float64)
            nn = n / np.linalg.norm(n)
            shape_vec.append(tuple(nn))
            shape_sc.append(s.offset / np.linalg.norm(n))
            return ("halfspace", row)
        if isinstance(s, ir.Cylinder):
            # two consecutive rows: [row] center (+radius in sc),
            # [row+1] unit axis
            row = len(shape_sc)
            shape_vec.append(s.center)
            shape_sc.append(s.radius)
            a = np.asarray(s.axis, np.float64)
            shape_vec.append(tuple(a / np.linalg.norm(a)))
            shape_sc.append(0.0)
            return ("cylinder", row)
        if isinstance(s, ir.Csg):
            return (s.op, tuple(flatten_shape(c) for c in s.children))
        raise TypeError(f"unknown shape {s!r}")

    # dedupe materials / surfaces / portals by IR equality
    materials: list[ir.Material] = []
    surfaces: list[ir.Surface] = []
    portals: list[ir.Portal] = []

    def mat_index(m: ir.Material) -> int:
        if m in materials:
            return materials.index(m)
        materials.append(m)
        return len(materials) - 1

    def surf_index(s: ir.Surface) -> int:
        if s in surfaces:
            return surfaces.index(s)
        surfaces.append(s)
        return len(surfaces) - 1

    ambient_idx = mat_index(scene.ambient)

    ents = []
    for e in scene.entities:
        node = flatten_shape(e.shape)
        p_idx = None
        if e.portal is not None:
            portals.append(e.portal)
            p_idx = len(portals) - 1
        ents.append(EntityStatic(node, mat_index(e.material),
                                 surf_index(e.surface), p_idx, e.name))

    st = scene.settings
    # Tight bound on DFS node count: a node only pushes children while its
    # remaining depth >= 2 (ops/trace.py depth_ge2 gate), so a root at depth
    # D spans at most D levels -> <= 2^D - 1 nodes in the full binary case.
    # This is the fori trip count of the differentiable bounce loop, so the
    # old 2^(D+1)-1 bound doubled every backward pass for nothing.
    max_nodes = st.max_nodes or max(1, min(2 ** st.max_depth - 1, 63))

    def _alpha1(s: ir.Surface) -> bool:
        if isinstance(s, ir.UniformSurface):
            return s.color[3] == 1.0
        if isinstance(s, (ir.CheckerSurface, ir.SmoothSurface,
                          ir.PerlinSurface)):
            return s.color[3] == 1.0 and s.color2[3] == 1.0
        if isinstance(s, ir.TextureSurface):
            return s.alpha == 1.0
        return False

    def _refl0(s: ir.Surface) -> bool:
        # the reflection branch is statically dead only when BOTH the
        # constant ratio and the Schlick fresnel term are exactly zero
        return (getattr(s, "reflectivity", 1.0) == 0.0
                and getattr(s, "fresnel", 1.0) == 0.0)

    def _need_uv(s: ir.Surface) -> bool:
        return not isinstance(s, ir.UniformSurface)

    static = SceneStatic(
        dim=scene.dim,
        entities=tuple(ents),
        mat_kinds=tuple(_mat_kind(m) for m in materials),
        surf_kinds=tuple(_surf_kind(s) for s in surfaces),
        surf_texture=tuple(
            s.texture_id if isinstance(s, ir.TextureSurface) else -1
            for s in surfaces),
        ambient=ambient_idx,
        max_depth=st.max_depth,
        t_max=float(st.t_max),
        march_steps=st.march_steps,
        max_nodes=max_nodes,
        name=scene.name,
        surf_alpha1=tuple(_alpha1(s) for s in surfaces),
        surf_refl0=tuple(_refl0(s) for s in surfaces),
        surf_need_uv=tuple(_need_uv(s) for s in surfaces),
        surf_fres0=tuple(s.fresnel == 0.0 for s in surfaces),
        mat_exprs=tuple(
            (expr.parse(m.ax), expr.parse(m.ay),
             expr.parse(m.az), expr.parse(m.aw))
            if isinstance(m, ir.ExprSpace) else None
            for m in materials),
        surf_perlin=tuple(
            (s.octaves, s.seed) if isinstance(s, ir.PerlinSurface) else None
            for s in surfaces),
    )

    M, U, P = len(materials), len(surfaces), len(portals)
    mat_ior = np.ones(M, np.float32)
    mat_wc = np.zeros((M, 4), np.float32)
    mat_ws = np.zeros(M, np.float32)
    mat_wh = np.full(M, 0.05, np.float32)
    mat_ep = np.zeros((M, 8), np.float32)
    for i, m in enumerate(materials):
        if isinstance(m, ir.Dielectric):
            mat_ior[i] = m.ior
        elif isinstance(m, ir.WarpSpace):
            mat_ior[i] = m.ior
            mat_wc[i] = m.center
            mat_ws[i] = m.strength
            mat_wh[i] = m.step
        elif isinstance(m, ir.ExprSpace):
            mat_ior[i] = m.ior
            mat_wh[i] = m.step
            mat_ep[i, :len(m.params)] = m.params

    s_col = np.zeros((U, 4), np.float32)
    s_col2 = np.zeros((U, 4), np.float32)
    s_refl = np.zeros(U, np.float32)
    s_fres = np.zeros(U, np.float32)
    s_uvs = np.ones(U, np.float32)
    for i, s in enumerate(surfaces):
        s_fres[i] = s.fresnel
        if isinstance(s, ir.UniformSurface):
            s_col[i] = s.color
            s_refl[i] = s.reflectivity
        elif isinstance(s, (ir.CheckerSurface, ir.SmoothSurface,
                            ir.PerlinSurface)):
            s_col[i] = s.color
            s_col2[i] = s.color2
            s_refl[i] = s.reflectivity
            s_uvs[i] = s.uv_scale
        elif isinstance(s, ir.TextureSurface):
            s_col[i] = (1.0, 1.0, 1.0, s.alpha)
            s_refl[i] = s.reflectivity
            s_uvs[i] = s.uv_scale

    p_lin = np.zeros((max(P, 1), 4, 4), np.float32)
    p_tr = np.zeros((max(P, 1), 4), np.float32)
    for i, p in enumerate(portals):
        p_lin[i] = np.asarray(p.linear, np.float32)
        p_tr[i] = np.asarray(p.translation, np.float32)

    tables = SceneTables(
        shape_vec=np.asarray(shape_vec, np.float32).reshape(-1, 4),
        shape_sc=np.asarray(shape_sc, np.float32).reshape(-1),
        mat_ior=mat_ior,
        mat_warp_center=mat_wc,
        mat_warp_strength=mat_ws,
        mat_warp_step=mat_wh,
        mat_expr_params=mat_ep,
        surf_color=s_col,
        surf_color2=s_col2,
        surf_refl=s_refl,
        surf_fresnel=s_fres,
        surf_uv_scale=s_uvs,
        portal_lin=p_lin,
        portal_tr=p_tr,
        background=np.asarray(st.background, np.float32),
        textures=tuple(np.asarray(t, np.float32) for t in scene.textures),
    )
    return static, tables


def _to_torch(a, device, dtype) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.detach().to(device=device, dtype=dtype)
    return torch.tensor(np.asarray(a), device=device, dtype=dtype)


def tables_to_torch(tables, device, dtype=torch.float32) -> SceneTables:
    """SceneTables (numpy, from this package or euclider_tpu) -> the same
    NamedTuple holding ``dtype`` tensors on ``device``.  The plain render
    computes in the tables' dtype (float64 is the JAX package's x64 path);
    the CUDA kernels cast any floating dtype to float32, as the Pallas
    kernels do, and hand back gradients in the tables' dtype."""
    device = torch.device(device)
    fields = {k: _to_torch(v, device, dtype)
              for k, v in tables._asdict().items() if k != "textures"}
    return SceneTables(**fields, textures=tuple(
        _to_torch(t, device, dtype) for t in tables.textures))


def camera_to_torch(cam, device, dtype=torch.float32) -> CameraParams:
    """CameraParams (numpy) -> ``dtype`` tensors on ``device``."""
    device = torch.device(device)
    return CameraParams(*(_to_torch(v, device, dtype) for v in cam))
