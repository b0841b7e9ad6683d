"""The reference's render and its work count, in blocks of rows.

``counted`` wraps the frozen plain version's node shading, propagation and
march step for the length of a render, as ``chip_smoke.py::counted_render``
(commit ee5cc13d71e7) wraps the program's, and counts on the device with
no synchronising call a step: the ray-tree nodes shaded (the primary node
included), the live march steps, the marched nodes and the nodes that hit
each entity.  Those are the counts that ``benchmark/roofline.py::bound``
takes."""
from __future__ import annotations

import contextlib

import torch

from .ops import march, trace
from .scene import compile as C
from .scene import jsonio

def load(scene_dict):
    """A configuration's scene JSON -> (static, numpy tables, numpy camera)
    by the reference's own front end."""
    scene = jsonio.scene_from_dict(scene_dict)
    static, tables = C.compile_scene(scene)
    return static, tables, C.compile_camera(scene.camera)


def to_device(tables, cam, device, dtype=torch.float32):
    return (C.tables_to_torch(tables, device, dtype),
            C.camera_to_torch(cam, device, dtype))


class Counts:
    """Work of the renders made under ``counting``, summed on the device."""

    def __init__(self, static, device):
        self.nodes = torch.zeros((), dtype=torch.int64, device=device)
        self.steps = torch.zeros((), dtype=torch.int64, device=device)
        self.marches = torch.zeros((), dtype=torch.int64, device=device)
        self.hits = torch.zeros(len(static.entities), dtype=torch.int64,
                                device=device)

    def as_dict(self):
        return {"nodes": int(self.nodes), "steps": int(self.steps),
                "marches": int(self.marches), "hits": self.hits.tolist()}


@contextlib.contextmanager
def counting(counts: Counts):
    make_body = march.make_march_body
    shade_node, propagate = trace._shade_node, trace.propagate
    active = [None]

    def shading(*args, **kw):
        active[0] = args[7]          # _shade_node's `active`
        counts.nodes += active[0].sum()
        return shade_node(*args, **kw)

    def propagating(*args, **kw):
        out = propagate(*args, **kw)
        hit = out[0] & active[0]
        counts.hits += torch.bincount(out[3][hit].long(),
                                      minlength=len(counts.hits))
        return out

    def counted_body(*args):
        body = make_body(*args)
        first = [True]

        def step(carry):
            live = (~carry[2]).sum()
            counts.steps += live
            if first[0]:
                counts.marches += live
                first[0] = False
            return body(carry)

        return step

    march.make_march_body = counted_body
    trace._shade_node, trace.propagate = shading, propagating
    try:
        yield counts
    finally:
        march.make_march_body = make_body
        trace._shade_node, trace.propagate = shade_node, propagate


def render(static, tables, cam, H: int, W: int, block_rows: int,
           counts: Counts | None = None, time=0.0) -> torch.Tensor:
    """The H x W frame in blocks of ``block_rows`` rows -> [H, W, 3] in the
    tables' dtype on their device; with ``counts``, its work is added
    there."""
    ctx = counting(counts) if counts is not None else contextlib.nullcontext()
    out = []
    with torch.no_grad(), ctx:
        for y0 in range(0, H, block_rows):
            rows = min(block_rows, H - y0)
            out.append(trace.render_image(static, tables, cam, H, W, time,
                                          y0, rows))
    return torch.cat(out)
