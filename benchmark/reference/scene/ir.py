# Frozen copy of euclider_tpu_torch/scene/ir.py at commit ee5cc13d71e7, part of the
# benchmark's plain reference: it is never edited to follow the program.
"""Scene intermediate representation (IR).

This is the user-facing scene vocabulary — the TPU-native analogue of
euclider's trait layer (upstream ``src/universe/entity/`` — ``Entity``,
``Shape``, ``Material``, ``Surface``; SURVEY.md §2.1).  Instead of boxed
trait objects dispatched by TypeId, a scene here is a plain dataclass tree
that *compiles* (scene/compile.py) into

  * ``SceneStatic``  — hashable topology (shape kinds, CSG trees, entity
    wiring, material/surface kinds).  This becomes Python-unrolled XLA code:
    the (space, shape) double dispatch of the reference becomes shader-style
    program specialisation, with zero runtime dispatch and zero gathers.
  * ``SceneTables``  — a pytree of float arrays (centers, radii, colors,
    IORs, portal transforms…).  Everything differentiable lives here.

Dimension-generic: all points/normals are padded to 4 components; ``dim``
on the Scene selects 3D or 4D semantics (SURVEY.md §3.5).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple, Union

# ---------------------------------------------------------------------------
# Shapes  (reference: src/universe/d3/entity/*.rs, d4/…; SURVEY.md §2.1)
# ---------------------------------------------------------------------------


def _pad4(p: Sequence[float]) -> Tuple[float, float, float, float]:
    p = tuple(float(v) for v in p)
    if len(p) == 3:
        return p + (0.0,)
    if len(p) == 4:
        return p
    raise ValueError(f"expected 3 or 4 components, got {len(p)}")


@dataclass(frozen=True)
class Sphere:
    """n-sphere: |x - center| = radius.  (Sphere / Sphere4 in the reference.)"""

    center: Sequence[float]
    radius: float

    def __post_init__(self):
        object.__setattr__(self, "center", _pad4(self.center))
        object.__setattr__(self, "radius", float(self.radius))


@dataclass(frozen=True)
class Hyperplane:
    """Measure-zero sheet: normal·x = offset.  Never 'contains' points."""

    normal: Sequence[float]
    offset: float

    def __post_init__(self):
        object.__setattr__(self, "normal", _pad4(self.normal))
        object.__setattr__(self, "offset", float(self.offset))


@dataclass(frozen=True)
class HalfSpace:
    """Solid region normal·x < offset; boundary is the hyperplane."""

    normal: Sequence[float]
    offset: float

    def __post_init__(self):
        object.__setattr__(self, "normal", _pad4(self.normal))
        object.__setattr__(self, "offset", float(self.offset))


@dataclass(frozen=True)
class Cylinder:
    """Infinite n-cylinder: points within ``radius`` of the line
    center + t*axis.  In 4D the axis lives in R^4 (the solid is the product
    of a 3-ball cross-section with the axis line)."""

    center: Sequence[float]
    axis: Sequence[float]
    radius: float

    def __post_init__(self):
        object.__setattr__(self, "center", _pad4(self.center))
        object.__setattr__(self, "axis", _pad4(self.axis))
        object.__setattr__(self, "radius", float(self.radius))


CSG_OPS = ("union", "intersection", "difference", "symdiff", "complement")


@dataclass(frozen=True)
class Csg:
    """Composable shape (reference ComposableShape + SetOperation).

    ``union`` / ``intersection`` / ``symdiff`` fold over >=2 children;
    ``difference`` is binary (a minus b); ``complement`` is unary.
    Children may be any Shape, nested arbitrarily.
    """

    op: str
    children: Tuple["Shape", ...]

    def __post_init__(self):
        if self.op not in CSG_OPS:
            raise ValueError(f"unknown CSG op {self.op!r}")
        object.__setattr__(self, "children", tuple(self.children))
        n = len(self.children)
        if self.op == "complement" and n != 1:
            raise ValueError("complement takes exactly one child")
        if self.op == "difference" and n != 2:
            raise ValueError("difference takes exactly two children")
        if self.op in ("union", "intersection", "symdiff") and n < 2:
            raise ValueError(f"{self.op} takes at least two children")


Shape = Union[Sphere, Hyperplane, HalfSpace, Cylinder, Csg]

# ---------------------------------------------------------------------------
# Materials — "space as material" (reference entity/material.rs; SURVEY §3.4)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Vacuum:
    """Straight propagation, IOR 1."""


@dataclass(frozen=True)
class Dielectric:
    """Straight propagation with refraction at boundaries (Snell)."""

    ior: float = 1.5


@dataclass(frozen=True)
class WarpSpace:
    """Non-Euclidean space: rays bend toward/away from ``center``.

    Propagation integrates  v' = normalize(v + h * s * (c-x)/|c-x|^3),
    x' = x + h * v'  for a bounded number of steps (the 'iterative march'
    of BASELINE config 5).  ``strength`` > 0 attracts, < 0 repels.
    """

    center: Sequence[float] = (0.0, 0.0, 0.0, 0.0)
    strength: float = 1.0
    step: float = 0.05
    ior: float = 1.0

    def __post_init__(self):
        object.__setattr__(self, "center", _pad4(self.center))


@dataclass(frozen=True)
class ExprSpace:
    """Expression-driven non-Euclidean space (the reference's
    ComponentTransformation-style warped material, SURVEY.md §2.1
    'Materials & transitions': behaviour written as math expressions and
    parsed at scene-load time).

    ``ax..aw`` are expressions in ``x y z w`` (ray position) and ``p0..p7``
    (the differentiable ``params``) giving the per-step acceleration field;
    propagation integrates  v' = normalize(v + h*a(x)), x' = x + h*v' —
    the same bounded march as WarpSpace, with an arbitrary user field.
    Expressions compile to hashable ASTs burned into the XLA program
    (scene/expr.py); gradients flow through ``params``.
    """

    ax: str = "0"
    ay: str = "0"
    az: str = "0"
    aw: str = "0"
    step: float = 0.05
    ior: float = 1.0
    params: Tuple[float, ...] = ()

    def __post_init__(self):
        from . import expr as E
        for f in ("ax", "ay", "az", "aw"):
            # validate eagerly at IR build time: syntax AND native-VM stack
            # depth (untrusted scene JSON must not overflow the C++ oracle)
            E.check_vm_depth(E.parse(getattr(self, f)), getattr(self, f))
        if len(self.params) > 8:
            raise ValueError("ExprSpace supports at most 8 params (p0..p7)")
        object.__setattr__(self, "params",
                           tuple(float(p) for p in self.params))


Material = Union[Vacuum, Dielectric, WarpSpace, ExprSpace]

# ---------------------------------------------------------------------------
# Surfaces  (reference entity/surface.rs: get_reflection_ratio /
# get_reflection_direction / get_surface_color; SURVEY §2.1)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class UniformSurface:
    color: Tuple[float, float, float, float] = (1.0, 1.0, 1.0, 1.0)
    reflectivity: float = 0.0
    fresnel: float = 0.0

    def __post_init__(self):
        object.__setattr__(self, "color", tuple(float(c) for c in self.color))


@dataclass(frozen=True)
class CheckerSurface:
    """UV checkerboard (reference MappedTexture checkerboard)."""

    color: Tuple[float, float, float, float] = (0.1, 0.1, 0.1, 1.0)
    color2: Tuple[float, float, float, float] = (0.9, 0.9, 0.9, 1.0)
    uv_scale: float = 1.0
    reflectivity: float = 0.0
    fresnel: float = 0.0

    def __post_init__(self):
        object.__setattr__(self, "color", tuple(float(c) for c in self.color))
        object.__setattr__(self, "color2", tuple(float(c) for c in self.color2))


@dataclass(frozen=True)
class SmoothSurface:
    """C^inf color field: rgba = color + (color2-color) * f(u,v) with
    f = 0.25*(1+sin(2*pi*u*scale))*(1+sin(2*pi*v*scale)).

    Exists so geometry/camera gradients are non-zero and finite-difference
    checkable (checker/uniform surfaces are piecewise-constant in hit
    position, which makes those gradients zero almost everywhere)."""

    color: Tuple[float, float, float, float] = (0.1, 0.1, 0.4, 1.0)
    color2: Tuple[float, float, float, float] = (0.9, 0.8, 0.2, 1.0)
    uv_scale: float = 1.0
    reflectivity: float = 0.0
    fresnel: float = 0.0

    def __post_init__(self):
        object.__setattr__(self, "color", tuple(float(c) for c in self.color))
        object.__setattr__(self, "color2", tuple(float(c) for c in self.color2))


@dataclass(frozen=True)
class PerlinSurface:
    """Procedural Perlin-fBm surface: rgba = color + (color2-color) * f(u,v)
    with f an ``octaves``-octave gradient-noise field over scaled UV
    (lacunarity 2, gain 0.5, mapped to [0,1]).

    The lattice hash is exact uint32 arithmetic, identical across the lax,
    Pallas, NumPy-oracle and C++-oracle backends (ops/shading.py::perlin2;
    docs/SEMANTICS.md pins the contract).  Reference parity: procedural
    noise textures (SURVEY.md §8 item 5)."""

    color: Tuple[float, float, float, float] = (0.05, 0.1, 0.05, 1.0)
    color2: Tuple[float, float, float, float] = (0.7, 0.9, 0.6, 1.0)
    uv_scale: float = 1.0
    octaves: int = 3
    seed: int = 0
    reflectivity: float = 0.0
    fresnel: float = 0.0

    def __post_init__(self):
        object.__setattr__(self, "color", tuple(float(c) for c in self.color))
        object.__setattr__(self, "color2", tuple(float(c) for c in self.color2))
        if not (1 <= int(self.octaves) <= 8):
            raise ValueError("octaves must be in [1, 8]")
        object.__setattr__(self, "octaves", int(self.octaves))
        object.__setattr__(self, "seed", int(self.seed))


@dataclass(frozen=True)
class TextureSurface:
    """Image texture sampled by UV (reference MappedTexture image path).

    ``texture`` is a row-major (th, tw, 3) nested tuple / list of floats at
    IR level; the compiler packs it into the tables.  Bilinear filtering.
    """

    texture_id: int
    uv_scale: float = 1.0
    reflectivity: float = 0.0
    fresnel: float = 0.0
    alpha: float = 1.0


Surface = Union[UniformSurface, CheckerSurface, SmoothSurface,
                PerlinSurface, TextureSurface]

# ---------------------------------------------------------------------------
# Portal + Entity + Camera + Scene
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Portal:
    """Affine teleport applied when a ray transmits *into* the entity.

    x -> linear @ x + translation ; d -> normalize(linear @ d).
    Realises euclider's teleporting material transitions (SURVEY §3.4).
    """

    linear: Tuple[Tuple[float, ...], ...] = (
        (1, 0, 0, 0), (0, 1, 0, 0), (0, 0, 1, 0), (0, 0, 0, 1))
    translation: Sequence[float] = (0.0, 0.0, 0.0, 0.0)

    def __post_init__(self):
        lin = tuple(tuple(float(v) for v in row) for row in self.linear)
        if len(lin) != 4 or any(len(r) != 4 for r in lin):
            raise ValueError("portal linear part must be 4x4")
        object.__setattr__(self, "linear", lin)
        object.__setattr__(self, "translation", _pad4(self.translation))


@dataclass(frozen=True)
class Entity:
    """shape + material(inside) + surface(boundary) — reference trait Entity."""

    shape: Shape
    material: Material = Vacuum()
    surface: Surface = UniformSurface()
    portal: Optional[Portal] = None
    name: str = ""


@dataclass(frozen=True)
class Camera:
    """Free-flight pinhole camera, dimension-generic.

    The image plane is spanned by ``right``/``up``; ``forward`` completes the
    frame.  In 4D all basis vectors live in R^4 (reference d4 camera:
    a 2D screen embedded in R^4, extra rotations re-orient the frame).
    """

    position: Sequence[float] = (0.0, 0.0, 0.0)
    forward: Sequence[float] = (0.0, 0.0, -1.0)
    up: Sequence[float] = (0.0, 1.0, 0.0)
    right: Sequence[float] = (1.0, 0.0, 0.0)
    fov_deg: float = 60.0

    def __post_init__(self):
        for f in ("position", "forward", "up", "right"):
            object.__setattr__(self, f, _pad4(getattr(self, f)))


@dataclass(frozen=True)
class RenderSettings:
    max_depth: int = 4
    t_max: float = 100.0
    march_steps: int = 256
    max_nodes: int = 0  # 0 -> derived: 2**max_depth - 1 capped at 63
    background: Tuple[float, float, float] = (0.0, 0.0, 0.0)

    def __post_init__(self):
        object.__setattr__(self, "background",
                           tuple(float(c) for c in self.background))


@dataclass(frozen=True)
class Scene:
    """A complete scene: ordered entities (first-contains-wins for the
    'which material am I in' query), ambient material, camera, settings."""

    dim: int
    entities: Tuple[Entity, ...]
    camera: Camera = Camera()
    ambient: Material = Vacuum()
    settings: RenderSettings = RenderSettings()
    textures: Tuple[Tuple[Tuple[Tuple[float, float, float], ...], ...], ...] = ()
    name: str = ""

    def __post_init__(self):
        if self.dim not in (3, 4):
            raise ValueError("dim must be 3 or 4")
        object.__setattr__(self, "entities", tuple(self.entities))
