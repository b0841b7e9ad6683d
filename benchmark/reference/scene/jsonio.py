# Frozen copy of euclider_tpu_torch/scene/jsonio.py at commit ee5cc13d71e7, part of the
# benchmark's plain reference: it is never edited to follow the program.
"""JSON scene files <-> Scene IR.

The reference loads scenes from JSON via a name->constructor registry
(upstream ``src/main.rs`` + parser; SURVEY.md §2.1 'CLI + scene loading',
§3.1).  Same shape here: tagged JSON nodes map to IR dataclasses through a
per-type registry, dimension read from the scene file.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict

from . import ir

# --- encoders ---------------------------------------------------------------


def _enc_shape(s: ir.Shape) -> Dict[str, Any]:
    if isinstance(s, ir.Sphere):
        return {"type": "sphere", "center": list(s.center), "radius": s.radius}
    if isinstance(s, ir.Hyperplane):
        return {"type": "hyperplane", "normal": list(s.normal),
                "offset": s.offset}
    if isinstance(s, ir.HalfSpace):
        return {"type": "halfspace", "normal": list(s.normal),
                "offset": s.offset}
    if isinstance(s, ir.Cylinder):
        return {"type": "cylinder", "center": list(s.center),
                "axis": list(s.axis), "radius": s.radius}
    if isinstance(s, ir.Csg):
        return {"type": "csg", "op": s.op,
                "children": [_enc_shape(c) for c in s.children]}
    raise TypeError(f"unknown shape {s!r}")


def _enc_material(m: ir.Material) -> Dict[str, Any]:
    if isinstance(m, ir.Vacuum):
        return {"type": "vacuum"}
    if isinstance(m, ir.Dielectric):
        return {"type": "dielectric", "ior": m.ior}
    if isinstance(m, ir.WarpSpace):
        return {"type": "warp", "center": list(m.center),
                "strength": m.strength, "step": m.step, "ior": m.ior}
    if isinstance(m, ir.ExprSpace):
        return {"type": "expr", "ax": m.ax, "ay": m.ay, "az": m.az,
                "aw": m.aw, "step": m.step, "ior": m.ior,
                "params": list(m.params)}
    raise TypeError(f"unknown material {m!r}")


def _enc_surface(s: ir.Surface) -> Dict[str, Any]:
    if isinstance(s, ir.UniformSurface):
        return {"type": "uniform", "color": list(s.color),
                "reflectivity": s.reflectivity, "fresnel": s.fresnel}
    if isinstance(s, ir.CheckerSurface):
        return {"type": "checker", "color": list(s.color),
                "color2": list(s.color2), "uv_scale": s.uv_scale,
                "reflectivity": s.reflectivity, "fresnel": s.fresnel}
    if isinstance(s, ir.SmoothSurface):
        return {"type": "smooth", "color": list(s.color),
                "color2": list(s.color2), "uv_scale": s.uv_scale,
                "reflectivity": s.reflectivity, "fresnel": s.fresnel}
    if isinstance(s, ir.PerlinSurface):
        return {"type": "perlin", "color": list(s.color),
                "color2": list(s.color2), "uv_scale": s.uv_scale,
                "octaves": s.octaves, "seed": s.seed,
                "reflectivity": s.reflectivity, "fresnel": s.fresnel}
    if isinstance(s, ir.TextureSurface):
        return {"type": "texture", "texture_id": s.texture_id,
                "uv_scale": s.uv_scale, "reflectivity": s.reflectivity,
                "fresnel": s.fresnel, "alpha": s.alpha}
    raise TypeError(f"unknown surface {s!r}")


def scene_to_dict(sc: ir.Scene) -> Dict[str, Any]:
    d: Dict[str, Any] = {
        "dim": sc.dim,
        "name": sc.name,
        "ambient": _enc_material(sc.ambient),
        "camera": {
            "position": list(sc.camera.position),
            "forward": list(sc.camera.forward),
            "up": list(sc.camera.up),
            "right": list(sc.camera.right),
            "fov_deg": sc.camera.fov_deg,
        },
        "settings": {
            "max_depth": sc.settings.max_depth,
            "t_max": sc.settings.t_max,
            "march_steps": sc.settings.march_steps,
            "max_nodes": sc.settings.max_nodes,
            "background": list(sc.settings.background),
        },
        "entities": [],
    }
    for e in sc.entities:
        ent: Dict[str, Any] = {
            "shape": _enc_shape(e.shape),
            "material": _enc_material(e.material),
            "surface": _enc_surface(e.surface),
            "name": e.name,
        }
        if e.portal is not None:
            ent["portal"] = {"linear": [list(r) for r in e.portal.linear],
                             "translation": list(e.portal.translation)}
        d["entities"].append(ent)
    if sc.textures:
        d["textures"] = [[[list(px) for px in row] for row in tex]
                         for tex in sc.textures]
    return d


# --- decoders ---------------------------------------------------------------


def _dec_shape(d: Dict[str, Any]) -> ir.Shape:
    t = d["type"]
    if t == "sphere":
        return ir.Sphere(d["center"], d["radius"])
    if t == "hyperplane":
        return ir.Hyperplane(d["normal"], d["offset"])
    if t == "halfspace":
        return ir.HalfSpace(d["normal"], d["offset"])
    if t == "cylinder":
        return ir.Cylinder(d["center"], d["axis"], d["radius"])
    if t == "csg":
        return ir.Csg(d["op"], tuple(_dec_shape(c) for c in d["children"]))
    raise ValueError(f"unknown shape type {t!r}")


def _dec_material(d: Dict[str, Any]) -> ir.Material:
    t = d["type"]
    if t == "vacuum":
        return ir.Vacuum()
    if t == "dielectric":
        return ir.Dielectric(d.get("ior", 1.5))
    if t == "warp":
        return ir.WarpSpace(d.get("center", (0, 0, 0, 0)),
                            d.get("strength", 1.0), d.get("step", 0.05),
                            d.get("ior", 1.0))
    if t == "expr":
        return ir.ExprSpace(d.get("ax", "0"), d.get("ay", "0"),
                            d.get("az", "0"), d.get("aw", "0"),
                            step=d.get("step", 0.05),
                            ior=d.get("ior", 1.0),
                            params=tuple(d.get("params", ())))
    raise ValueError(f"unknown material type {t!r}")


def _dec_surface(d: Dict[str, Any]) -> ir.Surface:
    t = d["type"]
    fres = d.get("fresnel", 0.0)
    if t == "uniform":
        return ir.UniformSurface(tuple(d["color"]),
                                 reflectivity=d.get("reflectivity", 0.0),
                                 fresnel=fres)
    if t == "checker":
        return ir.CheckerSurface(tuple(d["color"]), tuple(d["color2"]),
                                 uv_scale=d.get("uv_scale", 1.0),
                                 reflectivity=d.get("reflectivity", 0.0),
                                 fresnel=fres)
    if t == "smooth":
        return ir.SmoothSurface(tuple(d["color"]), tuple(d["color2"]),
                                uv_scale=d.get("uv_scale", 1.0),
                                reflectivity=d.get("reflectivity", 0.0),
                                fresnel=fres)
    if t == "perlin":
        return ir.PerlinSurface(tuple(d["color"]), tuple(d["color2"]),
                                uv_scale=d.get("uv_scale", 1.0),
                                octaves=d.get("octaves", 3),
                                seed=d.get("seed", 0),
                                reflectivity=d.get("reflectivity", 0.0),
                                fresnel=fres)
    if t == "texture":
        return ir.TextureSurface(d["texture_id"],
                                 uv_scale=d.get("uv_scale", 1.0),
                                 reflectivity=d.get("reflectivity", 0.0),
                                 fresnel=fres,
                                 alpha=d.get("alpha", 1.0))
    raise ValueError(f"unknown surface type {t!r}")


def scene_from_dict(d: Dict[str, Any], base_dir: str = "") -> ir.Scene:
    cam = d.get("camera", {})
    st = d.get("settings", {})
    entities = []
    for ed in d["entities"]:
        portal = None
        if ed.get("portal") is not None:
            portal = ir.Portal(tuple(map(tuple, ed["portal"]["linear"])),
                               ed["portal"]["translation"])
        entities.append(ir.Entity(
            shape=_dec_shape(ed["shape"]),
            material=_dec_material(ed.get("material", {"type": "vacuum"})),
            surface=_dec_surface(ed.get("surface", {"type": "uniform",
                                                    "color": [1, 1, 1, 1]})),
            portal=portal,
            name=ed.get("name", ""),
        ))
    return ir.Scene(
        dim=d["dim"],
        name=d.get("name", ""),
        entities=tuple(entities),
        ambient=_dec_material(d.get("ambient", {"type": "vacuum"})),
        camera=ir.Camera(
            position=cam.get("position", (0, 0, 0)),
            forward=cam.get("forward", (0, 0, -1)),
            up=cam.get("up", (0, 1, 0)),
            right=cam.get("right", (1, 0, 0)),
            fov_deg=cam.get("fov_deg", 60.0),
        ),
        settings=ir.RenderSettings(
            max_depth=st.get("max_depth", 4),
            t_max=st.get("t_max", 100.0),
            march_steps=st.get("march_steps", 256),
            max_nodes=st.get("max_nodes", 0),
            background=tuple(st.get("background", (0, 0, 0))),
        ),
        textures=tuple(_dec_texture(tex, base_dir)
                       for tex in d.get("textures", ()))
        if d.get("textures") else (),
    )


def _dec_texture(tex: Any, base_dir: str = ""):
    """A texture entry is either an inline [th][tw][3] nested array or a
    ``{"file": "relative.png"}`` image reference (the reference loads
    MappedTexture images from disk via the ``image`` crate — SURVEY.md §2.1
    'Surfaces / shading')."""
    if isinstance(tex, dict):
        path = tex["file"]
        if base_dir and not os.path.isabs(path):
            path = os.path.join(base_dir, path)
        return load_texture_image(path)
    return tuple(tuple(map(tuple, (map(tuple, row) for row in tex))))


def load_texture_image(path: str):
    """Load an image file into the IR's nested-tuple texture format
    ([th][tw][3] floats in [0, 1])."""
    from PIL import Image

    import numpy as np

    with Image.open(path) as im:
        arr = np.asarray(im.convert("RGB"), np.float32) / 255.0
    return tuple(tuple(tuple(px) for px in row) for row in arr.tolist())


def save_scene(sc: ir.Scene, path: str) -> None:
    with open(path, "w") as f:
        json.dump(scene_to_dict(sc), f, indent=1)


def load_scene(path: str) -> ir.Scene:
    with open(path) as f:
        # image-file texture refs resolve relative to the scene file
        return scene_from_dict(json.load(f),
                               base_dir=os.path.dirname(os.path.abspath(path)))
