"""Built-in scenes: the five acceptance configurations (BASELINE.json:7-11).

These play the role of euclider's ``resources/*.json`` example scenes
(SURVEY.md §2.1 'Scene assets') — the integration fixtures the oracle renders
for golden images.  Each builder returns a Scene; scene/jsonio.py can
round-trip them to JSON files under scenes/.
"""
from __future__ import annotations

import numpy as np

from .ir import (Camera, CheckerSurface, Csg, Dielectric, Entity, ExprSpace,
                 HalfSpace, PerlinSurface, Portal, RenderSettings, Scene,
                 SmoothSurface, Sphere, TextureSurface, UniformSurface,
                 WarpSpace)


def _cam3(pos, fwd, fov=60.0):
    fwd = np.asarray(fwd, np.float64)
    fwd = fwd / np.linalg.norm(fwd)
    up0 = np.array([0.0, 1.0, 0.0])
    right = np.cross(fwd[:3], up0)
    right = right / np.linalg.norm(right)
    up = np.cross(right, fwd[:3])
    return Camera(position=tuple(pos), forward=tuple(fwd),
                  up=tuple(up), right=tuple(right), fov_deg=fov)


def config1_sphere_room() -> Scene:
    """Euclidean 3D: one sphere + ground plane, single-bounce shading."""
    return Scene(
        dim=3,
        name="config1_sphere_room",
        entities=(
            Entity(Sphere((0.0, 0.0, -4.0), 1.0),
                   surface=UniformSurface((0.9, 0.2, 0.15, 1.0)),
                   name="sphere"),
            Entity(HalfSpace((0.0, -1.0, 0.0), 1.2),
                   surface=CheckerSurface(uv_scale=1.0),
                   name="floor"),
        ),
        camera=_cam3((0.0, 0.5, 1.0), (0.0, -0.15, -1.0)),
        settings=RenderSettings(max_depth=1, background=(0.05, 0.07, 0.12)),
    )


def config2_mirror_glass() -> Scene:
    """Multi-object 3D with reflective/refractive materials, depth 6."""
    glass = Dielectric(ior=1.5)
    return Scene(
        dim=3,
        name="config2_mirror_glass",
        entities=(
            Entity(Sphere((-1.6, 0.0, -5.0), 1.0),
                   surface=UniformSurface((0.95, 0.95, 0.98, 1.0),
                                          reflectivity=0.85),
                   name="mirror"),
            Entity(Sphere((1.6, 0.0, -5.0), 1.0), material=glass,
                   surface=UniformSurface((0.9, 0.95, 1.0, 0.08),
                                          reflectivity=0.08),
                   name="glass"),
            Entity(Sphere((0.0, -0.45, -3.2), 0.5),
                   surface=UniformSurface((0.2, 0.45, 0.9, 1.0)),
                   name="blue"),
            Entity(HalfSpace((0.0, -1.0, 0.0), 1.0),
                   surface=CheckerSurface(uv_scale=1.0, reflectivity=0.25),
                   name="floor"),
        ),
        camera=_cam3((0.0, 0.6, 0.8), (0.0, -0.18, -1.0)),
        settings=RenderSettings(max_depth=6, background=(0.04, 0.05, 0.09)),
    )


def _make_texture(n=64):
    """Procedural RGB texture (stripes + gradient), deterministic."""
    y, x = np.mgrid[0:n, 0:n].astype(np.float64) / n
    r = 0.5 + 0.5 * np.sin(x * 12.0)
    g = y
    b = ((np.floor(x * 8) + np.floor(y * 8)) % 2)
    return np.stack([r, g, 0.3 + 0.6 * b], axis=-1).astype(np.float32)


def config3_csg_textured() -> Scene:
    """CSG composites (union/intersection/difference) with UV texturing."""
    cut_sphere = Csg("intersection", (
        Sphere((-2.0, 0.0, -5.0), 1.0),
        HalfSpace((0.0, -1.0, 0.0), 0.35),
    ))
    blob = Csg("union", (
        Sphere((0.0, -0.1, -4.6), 0.6),
        Sphere((0.55, 0.25, -4.6), 0.45),
    ))
    shell = Csg("difference", (
        Sphere((2.0, 0.0, -5.0), 1.0),
        Sphere((2.0, 0.4, -4.4), 0.75),
    ))
    return Scene(
        dim=3,
        name="config3_csg_textured",
        entities=(
            Entity(cut_sphere, surface=CheckerSurface(
                color=(0.85, 0.3, 0.1, 1.0), color2=(0.95, 0.8, 0.2, 1.0),
                uv_scale=6.0), name="cut_sphere"),
            Entity(blob, surface=TextureSurface(texture_id=0, uv_scale=2.0),
                   name="blob"),
            Entity(shell, surface=UniformSurface((0.3, 0.8, 0.4, 1.0),
                                                 reflectivity=0.15),
                   name="shell"),
            Entity(HalfSpace((0.0, -1.0, 0.0), 1.1),
                   surface=CheckerSurface(uv_scale=0.8), name="floor"),
        ),
        camera=_cam3((0.0, 0.7, 0.6), (0.0, -0.2, -1.0), fov=65.0),
        settings=RenderSettings(max_depth=3, background=(0.06, 0.06, 0.1)),
        textures=(tuple(map(tuple, _make_texture().tolist())),),
    )


def config4_hypersphere() -> Scene:
    """4D Euclidean: hypersphere + 4D camera, rays marched in R^4.

    The camera frame is tilted into the w axis so the 3-sphere's 4D extent
    is visible (slices of it change with the w-tilt — SURVEY §3.5)."""
    theta = 0.06  # forward slightly tilted into +w (keeps the 3-sphere in view)
    fwd = (0.0, -0.1, -np.cos(theta), np.sin(theta))
    fwd = tuple(np.asarray(fwd) / np.linalg.norm(fwd))
    return Scene(
        dim=4,
        name="config4_hypersphere",
        entities=(
            Entity(Sphere((0.0, 0.0, -4.0, 0.3), 1.2),
                   surface=UniformSurface((0.2, 0.6, 0.95, 1.0),
                                          reflectivity=0.1),
                   name="hypersphere"),
            Entity(Sphere((1.8, 0.4, -5.0, -0.5), 0.8),
                   surface=UniformSurface((0.9, 0.5, 0.15, 1.0)),
                   name="hypersphere2"),
            Entity(HalfSpace((0.0, -1.0, 0.0, 0.0), 1.2),
                   surface=CheckerSurface(uv_scale=1.0), name="floor"),
        ),
        camera=Camera(position=(0.0, 0.5, 1.0, 0.0), forward=fwd,
                      up=(0.0, 1.0, 0.0, 0.0), right=(1.0, 0.0, 0.0, 0.0),
                      fov_deg=60.0),
        settings=RenderSettings(max_depth=2, background=(0.05, 0.05, 0.1)),
    )


def config5_warp_portal() -> Scene:
    """Non-Euclidean: warped-space region + portal pair, iterative march.

    A sphere of WarpSpace bends rays passing through it (gravitational-lens
    look); a portal sphere teleports transmitted rays across the scene.
    Invisible boundaries use alpha=0 surfaces — pure material transitions
    (SURVEY §3.4)."""
    warp = WarpSpace(center=(0.0, 0.2, -5.0), strength=0.35, step=0.06)
    invisible = UniformSurface((0.0, 0.0, 0.0, 0.0))
    # portal: translate by (-6, 0, -2) — entering the right portal sphere
    # drops the ray near the far-left marker
    portal = Portal(translation=(-6.0, 0.0, -2.0))
    return Scene(
        dim=3,
        name="config5_warp_portal",
        entities=(
            Entity(Sphere((0.0, 0.2, -5.0), 1.6), material=warp,
                   surface=invisible, name="warp_region"),
            Entity(Sphere((2.8, 0.1, -4.2), 0.7), portal=portal,
                   surface=invisible, name="portal_in"),
            Entity(Sphere((-3.2, 0.1, -6.2), 0.7),
                   surface=UniformSurface((0.95, 0.3, 0.6, 1.0)),
                   name="portal_marker"),
            Entity(Sphere((0.0, 0.2, -9.0), 1.0),
                   surface=UniformSurface((0.95, 0.75, 0.2, 1.0)),
                   name="backdrop_sphere"),
            Entity(HalfSpace((0.0, -1.0, 0.0), 1.3),
                   surface=CheckerSurface(uv_scale=0.7), name="floor"),
        ),
        camera=_cam3((0.0, 0.6, 1.5), (0.0, -0.12, -1.0), fov=70.0),
        settings=RenderSettings(max_depth=4, march_steps=320,
                                background=(0.03, 0.04, 0.08)),
    )


def config7_warp4d() -> Scene:
    """4D x non-Euclidean: the reference's two flagship axes combined
    (SURVEY §3.4 + §3.5 jointly; VERDICT r2 item 8).  A hypersphere of
    WarpSpace lenses rays in R^4, a 4D portal pair teleports transmitted
    rays (including across w), and the camera is tilted into +w so the 4D
    extent of every object is visible."""
    warp = WarpSpace(center=(0.0, 0.2, -5.0, 0.0), strength=0.3, step=0.06)
    invisible = UniformSurface((0.0, 0.0, 0.0, 0.0))
    portal = Portal(translation=(-5.5, 0.0, -2.5, -0.4))
    theta = 0.05  # forward tilt into +w (SURVEY §3.5 4D camera)
    fwd = np.asarray((0.0, -0.1, -np.cos(theta), np.sin(theta)))
    fwd = tuple(fwd / np.linalg.norm(fwd))
    return Scene(
        dim=4,
        name="config7_warp4d",
        entities=(
            Entity(Sphere((0.0, 0.2, -5.0, 0.0), 1.6), material=warp,
                   surface=invisible, name="warp_region4d"),
            Entity(Sphere((2.6, 0.2, -4.0, 0.4), 0.7), portal=portal,
                   surface=invisible, name="portal_in4d"),
            Entity(Sphere((-2.9, 0.2, -6.5, 0.0), 0.7),
                   surface=UniformSurface((0.95, 0.3, 0.6, 1.0)),
                   name="portal_marker4d"),
            Entity(Sphere((0.0, 0.2, -9.0, 0.3), 1.2),
                   surface=UniformSurface((0.95, 0.75, 0.2, 1.0)),
                   name="backdrop_hypersphere"),
            Entity(HalfSpace((0.0, -1.0, 0.0, 0.0), 1.3),
                   surface=CheckerSurface(uv_scale=0.7), name="floor"),
        ),
        camera=Camera(position=(0.0, 0.6, 1.5, 0.0), forward=fwd,
                      up=(0.0, 1.0, 0.0, 0.0), right=(1.0, 0.0, 0.0, 0.0),
                      fov_deg=70.0),
        settings=RenderSettings(max_depth=4, march_steps=320,
                                background=(0.03, 0.04, 0.08)),
    )


def config6_expr_space() -> Scene:
    """Expression-driven non-Euclidean space (reference's
    ComponentTransformation-style material, SURVEY §2.1): the acceleration
    field is written as math expressions over position and differentiable
    params — here a sinusoidal shear field that makes straight edges ripple
    when seen through the region."""
    ripple = ExprSpace(
        ax="p0 * sin(p1 * y + p1 * z)",
        ay="p0 * cos(p1 * x) * 0.5",
        az="0", aw="0",
        step=0.06, params=(0.6, 3.0))
    invisible = UniformSurface((0.0, 0.0, 0.0, 0.0))
    return Scene(
        dim=3,
        name="config6_expr_space",
        entities=(
            Entity(Sphere((0.0, 0.1, -4.5), 1.5), material=ripple,
                   surface=invisible, name="ripple_region"),
            Entity(Sphere((0.0, 0.2, -8.5), 1.1),
                   surface=UniformSurface((0.2, 0.7, 0.95, 1.0)),
                   name="backdrop_sphere"),
            Entity(Sphere((-2.4, -0.2, -7.0), 0.7),
                   surface=UniformSurface((0.95, 0.5, 0.2, 1.0)),
                   name="side_sphere"),
            Entity(HalfSpace((0.0, -1.0, 0.0), 1.2),
                   surface=CheckerSurface(uv_scale=0.7), name="floor"),
        ),
        camera=_cam3((0.0, 0.5, 1.2), (0.0, -0.1, -1.0), fov=65.0),
        settings=RenderSettings(max_depth=4, march_steps=320,
                                background=(0.04, 0.04, 0.09)),
    )


def perlin_probe() -> Scene:
    """Procedural Perlin-fBm textures: a marbled sphere over noisy terrain
    coloring (SURVEY §8 item 5 — procedural noise surfaces)."""
    return Scene(
        dim=3,
        name="perlin_probe",
        entities=(
            Entity(Sphere((0.0, 0.0, -4.0), 1.2),
                   surface=PerlinSurface(color=(0.1, 0.1, 0.3, 1.0),
                                         color2=(0.9, 0.85, 0.7, 1.0),
                                         uv_scale=4.0, octaves=4, seed=7,
                                         reflectivity=0.1),
                   name="marble"),
            Entity(Sphere((2.0, -0.3, -5.5), 0.8),
                   surface=PerlinSurface(color=(0.5, 0.2, 0.05, 1.0),
                                         color2=(0.95, 0.7, 0.3, 1.0),
                                         uv_scale=8.0, octaves=2, seed=42),
                   name="rusty"),
            Entity(HalfSpace((0.0, -1.0, 0.0), 1.2),
                   surface=PerlinSurface(uv_scale=0.6, octaves=3),
                   name="terrain"),
        ),
        camera=_cam3((0.0, 0.5, 1.0), (0.0, -0.15, -1.0)),
        settings=RenderSettings(max_depth=2, background=(0.06, 0.07, 0.1)),
    )


def grad_probe() -> Scene:
    """Smooth-surface fixture for gradient tests: every color is C^inf in
    the hit position, so geometry/camera gradients are finite-difference
    checkable away from silhouettes."""
    return Scene(
        dim=3,
        name="grad_probe",
        entities=(
            Entity(Sphere((0.0, 0.0, -4.0), 1.0),
                   surface=SmoothSurface(uv_scale=2.0, reflectivity=0.2),
                   name="sphere"),
            Entity(Sphere((1.4, 0.3, -5.5), 0.8), material=Dielectric(1.4),
                   surface=SmoothSurface(color=(0.8, 0.2, 0.2, 0.15),
                                         color2=(0.2, 0.8, 0.3, 0.15),
                                         uv_scale=1.5),
                   name="glassy"),
            Entity(HalfSpace((0.0, -1.0, 0.0), 1.2),
                   surface=SmoothSurface(uv_scale=0.4), name="floor"),
        ),
        camera=_cam3((0.0, 0.4, 1.0), (0.0, -0.1, -1.0)),
        settings=RenderSettings(max_depth=3, background=(0.1, 0.1, 0.15)),
    )


def fresnel_probe() -> Scene:
    """Schlick-fresnel reflection-ratio fixture: grazing-angle reflections
    via the composable get_reflection_ratio model (SURVEY §2.1 Surfaces).
    Smooth color fields keep it finite-difference checkable."""
    return Scene(
        dim=3,
        name="fresnel_probe",
        entities=(
            Entity(Sphere((0.0, 0.0, -4.0), 1.0),
                   surface=SmoothSurface(uv_scale=2.0, reflectivity=0.05,
                                         fresnel=0.9), name="glossy"),
            Entity(Sphere((1.5, 0.2, -5.2), 0.8),
                   surface=UniformSurface((0.9, 0.4, 0.1, 1.0),
                                          fresnel=0.6), name="matte_fres"),
            Entity(HalfSpace((0.0, -1.0, 0.0), 1.2),
                   surface=SmoothSurface(uv_scale=0.5, fresnel=0.5),
                   name="floor"),
        ),
        camera=_cam3((0.0, 0.5, 1.0), (0.0, -0.15, -1.0)),
        settings=RenderSettings(max_depth=3, background=(0.05, 0.07, 0.12)),
    )


BUILDERS = {
    "config1_sphere_room": config1_sphere_room,
    "config2_mirror_glass": config2_mirror_glass,
    "config3_csg_textured": config3_csg_textured,
    "config4_hypersphere": config4_hypersphere,
    "config5_warp_portal": config5_warp_portal,
    "config6_expr_space": config6_expr_space,
    "config7_warp4d": config7_warp4d,
    "perlin_probe": perlin_probe,
    "grad_probe": grad_probe,
    "fresnel_probe": fresnel_probe,
}

ACCEPTANCE = tuple(n for n in BUILDERS if n.startswith("config"))


def get_scene(name: str) -> "Scene":
    if name in BUILDERS:
        return BUILDERS[name]()
    raise KeyError(f"unknown scene {name!r}; have {sorted(BUILDERS)}")
