"""The frozen bound arithmetic against a count by hand."""
import json

import pytest
import torch

from benchmark import harness, roofline
from benchmark.reference import render as ref

FLOOR = {
    "dim": 3, "name": "floor_only", "ambient": {"type": "vacuum"},
    "camera": {"position": [0, 0, 0, 0], "forward": [0, 0, -1, 0],
               "up": [0, 1, 0, 0], "right": [1, 0, 0, 0], "fov_deg": 60.0},
    "settings": {"max_depth": 1, "t_max": 100.0, "march_steps": 0,
                 "max_nodes": 0, "background": [0.1, 0.2, 0.3]},
    "entities": [
        {"shape": {"type": "halfspace", "normal": [0, -1, 0, 0],
                   "offset": 1.0},
         "material": {"type": "vacuum"},
         "surface": {"type": "uniform", "color": [0.5, 0.5, 0.5, 1],
                     "reflectivity": 0.0},
         "name": "floor"}]}


EXPR = dict(FLOOR, name="ripple", entities=FLOOR["entities"] + [
    {"shape": {"type": "sphere", "center": [0, 0, -4, 0], "radius": 1.5},
     "material": {"type": "expr", "ax": "p0 * sin(p1 * y + p1 * z)",
                  "ay": "p0 * cos(p1 * x) * 0.5", "az": "0", "aw": "0",
                  "step": 0.06, "ior": 1.0, "params": [0.6, 3.0]},
     "surface": {"type": "uniform", "color": [0, 0, 0, 0],
                 "reflectivity": 0.0},
     "name": "ripple_region"}])
EXPR["settings"] = dict(FLOOR["settings"], march_steps=16)


def test_floor_counts_and_bound_by_hand():
    """A camera looking level at a floor: every pixel is one node, the
    rows below the horizon (half of them) hit the floor, nothing marches.
    Operations: 125 a camera ray, 6 a node's shading, 16 a node's
    half-space test."""
    H, W = 6, 8
    static, tables, cam = ref.load(FLOOR)
    t, c = ref.to_device(tables, cam, "cpu")
    counts = ref.Counts(static, "cpu")
    ref.render(static, t, c, H, W, 3, counts)
    got = counts.as_dict()
    assert got == {"nodes": H * W, "steps": 0, "marches": 0,
                   "hits": [H * W // 2]}
    ms, by, ops = roofline.bound(static, got["nodes"], False, 0, 0,
                                 got["hits"], 0, H * W)
    assert ops == H * W * (125 + 6 + 16)
    # 147 operations a pixel take less than its 12 bytes at the peaks
    assert by == "bytes"
    assert ms == pytest.approx(H * W * 12 / 3.35e12 * 1e3)
    ms2, by2, ops2 = roofline.bound(static, got["nodes"], True, 0, 0,
                                    got["hits"], 0, H * W)
    assert ops2 == 2 * ops and by2 == "operations"
    assert ms2 == pytest.approx(ops2 / 67e12 * 1e3)
    # bytes bound a frame whose work is only its 12 bytes a pixel
    ms3, by3, _ = roofline.bound(static, 0, False, 0, 0, (), 0, 0)
    assert ms3 == 0.0 and by3 == "bytes"


def test_expression_field_counted_by_hand():
    """An expression field: p0 sin(p1 y + p1 z) is 5 operations (3 mul,
    add, sin), p0 cos(p1 x) 0.5 is 4 (3 mul, cos); constants and
    variables are free."""
    static, _, _ = ref.load(EXPR)
    assert roofline.field_ops(static) == 9
    spec = harness.load_spec()
    _, config, _ = harness.find_cell(spec, "view.config5_warp_portal")
    static, _, _ = ref.load(config["scene"])
    assert roofline.field_ops(static) == roofline.ATTRACTOR_OPS


def test_march_counts_are_counted():
    """On config5, marching rays count steps and one march a marched
    node, and the counts add up over blocks of rows."""
    spec = harness.load_spec()
    _, config, _ = harness.find_cell(spec, "view.config5_warp_portal")
    static, tables, cam = ref.load(config["scene"])
    t, c = ref.to_device(tables, cam, "cpu")
    whole, parts = ref.Counts(static, "cpu"), ref.Counts(static, "cpu")
    a = ref.render(static, t, c, 12, 16, 12, whole)
    b = ref.render(static, t, c, 12, 16, 4, parts)
    assert torch.equal(a, b)
    assert whole.as_dict() == parts.as_dict()
    got = whole.as_dict()
    assert got["marches"] > 0 and got["steps"] > got["marches"]
    assert got["nodes"] >= 12 * 16
