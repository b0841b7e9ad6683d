"""CSG composites, cylinders, perlin and texture surfaces in the torch port
against the JAX package.

The port's plain geometry and shading (ops/geometry.py, ops/shading.py) are
held against the JAX functions they port on seeded numpy inputs; the plain
render of the scenes that use them (config3_csg_textured, perlin_probe, the
cylinder scene of tests/test_cylinder.py) against the lax render, the
goldens and the float64 C++ oracle; and the plain backward against
jax.vjp, the textures' texels included.  The lax renders and the jax.vjp
leaves are stored (tests/jax_refs.py).
"""
import os
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import euclider_tpu as et
from euclider_tpu.ops import geometry as JG
from euclider_tpu.ops import shading as JS
from euclider_tpu.ops import vec as JV
from euclider_tpu.scene import ir

import euclider_tpu_torch as ett
from euclider_tpu_torch.ops import geometry as G
from euclider_tpu_torch.ops import shading as S
from euclider_tpu_torch.ops import trace
from euclider_tpu_torch.ops import vec as V
from euclider_tpu_torch.ops.vjp import vjp_blocked
from euclider_tpu_torch.utils.validate import assert_oracle_match

import jax_refs
from conftest import assert_images_close
from test_cylinder import _cyl_scene

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens.npz")


def compiled(sc):
    """(static, numpy tables, numpy camera, torch tables, torch camera)."""
    static, tables = et.compile_scene(sc)
    cam = et.compile_camera(sc.camera)
    return (static, tables, cam, ett.tables_to_torch(tables, "cpu"),
            ett.camera_to_torch(cam, "cpu"))


def cylinder_smooth(max_depth=3):
    """The cylinder scene with smooth surfaces: on its checker and uniform
    ones the geometry's gradient is zero (as in JAX)."""
    sc = _cyl_scene()
    smooth = {"pillar": ir.SmoothSurface(uv_scale=3.0),
              "ring": ir.SmoothSurface(uv_scale=2.0, reflectivity=0.1),
              "floor": ir.SmoothSurface(uv_scale=0.8)}
    return replace(sc, entities=tuple(replace(e, surface=smooth[e.name])
                                      for e in sc.entities),
                   settings=replace(sc.settings, max_depth=max_depth))


def csg_warp_scene():
    """A small warp region bounded by CSG (a sphere cut by a half-space)
    before a cylinder and a perlin wall."""
    region = ir.Entity(
        ir.Csg("intersection", (ir.Sphere((0, 0, -4), 1.8),
                                ir.HalfSpace((0, -1, 0), 0.6))),
        material=ir.WarpSpace(center=(0, 0, -4), strength=0.4, step=0.05),
        surface=ir.UniformSurface((0, 0, 0, 0.0)))
    pillar = ir.Entity(ir.Cylinder((1.6, 0.0, -6.0), (0.0, 1.0, 0.0), 0.4),
                       surface=ir.SmoothSurface(uv_scale=1.5))
    wall = ir.Entity(ir.Hyperplane((0, 0, 1), -8.0),
                     surface=ir.PerlinSurface(uv_scale=0.5, octaves=2))
    return ir.Scene(dim=3, entities=(region, pillar, wall),
                    settings=ir.RenderSettings(max_depth=3, march_steps=120,
                                               background=(0.1, 0.1, 0.2)))


def scene(name):
    return {"cylinder_test": _cyl_scene, "csg_warp": csg_warp_scene}.get(
        name, lambda: et.get_scene(name))()


# --- geometry ---------------------------------------------------------------

def csg_tree_scene(dim):
    """Every CSG op over spheres, half-spaces and cylinders, nested."""
    z = (0.0,) * (dim - 3)
    sph = lambda c, r: ir.Sphere(c + z, r)                      # noqa: E731
    cyl = lambda c, a, r: ir.Cylinder(c + z, a + z, r)          # noqa: E731
    half = lambda n, o: ir.HalfSpace(n + z, o)                  # noqa: E731
    tree = ir.Csg("union", (
        ir.Csg("intersection", (sph((0.0, 0.0, 0.0), 1.0),
                                half((0.0, -1.0, 0.0), 0.3),
                                cyl((0.2, 0.0, 0.0), (0.0, 0.0, 1.0), 0.8))),
        ir.Csg("difference", (sph((1.0, 0.5, 0.0), 0.9),
                              cyl((1.0, 0.5, 0.0), (1.0, 1.0, 0.0), 0.4))),
        ir.Csg("symdiff", (sph((-1.0, 0.0, 0.3), 0.8),
                           sph((-1.3, 0.2, 0.0), 0.7),
                           half((1.0, 0.0, 0.0), -1.1))),
        ir.Csg("complement", (sph((0.0, 0.0, 0.0), 2.2),)),
    ))
    return ir.Scene(dim=dim, entities=(ir.Entity(tree),))


def subtrees(node):
    yield node
    if not G.is_primitive(node):
        for c in node[1]:
            yield from subtrees(c)


def points(n, seed, scale=2.6):
    p = np.random.default_rng(seed).uniform(-scale, scale, size=(4, n))
    return p.astype(np.float32)


def jvec(a):
    return JV.Vec(*(jnp.asarray(c) for c in a))


def tvec(a):
    return V.Vec(*(torch.from_numpy(np.ascontiguousarray(c)) for c in a))


@pytest.mark.parametrize("dim", [3, 4])
def test_member_matches_jax_over_every_op(dim):
    static, tables, _, ttables, _ = compiled(csg_tree_scene(dim))
    p = points(4000, dim)
    if dim == 3:
        p[3] = 0.0
    kinds = set()
    for node in subtrees(static.entities[0].shape):
        ref = np.asarray(JG.member(node, tables, jvec(p)))
        got = G.member(node, ttables, tvec(p)).numpy()
        assert got.dtype == np.bool_
        np.testing.assert_array_equal(got, ref, err_msg=str(node[0]))
        assert 0 < ref.mean() < 1, node[0]   # the points straddle it
        kinds.add(node[0])
    assert kinds == {"union", "intersection", "difference", "symdiff",
                     "complement", "sphere", "halfspace", "cylinder"}
    lv = [leaf[0] for leaf in G.leaves(static.entities[0].shape)]
    assert lv == [leaf[0] for leaf in JG.leaves(static.entities[0].shape)]


@pytest.mark.parametrize("dim", [3, 4])
def test_cylinder_leaf_geometry_matches_jax(dim):
    """leaf_crossings, leaf_normal, leaf_uv and boundary_abs of a cylinder
    with a tilted axis, on seeded rays (a few parallel to the axis)."""
    axis = (0.3, 1.0, -0.2, 0.5)[:dim]
    sc = ir.Scene(dim=dim, entities=(ir.Entity(ir.Cylinder(
        (0.2, -0.1, -3.0, 0.4)[:dim], axis, 0.7)),))
    static, tables, _, ttables, _ = compiled(sc)
    leaf = static.entities[0].shape
    rng = np.random.default_rng(10 + dim)
    org = rng.uniform(-1.0, 1.0, size=(4, 512)).astype(np.float32)
    # aimed near the axis, so that most rays cross
    c = np.asarray(tables.shape_vec[leaf[1]], np.float64)
    d = c[:, None] + rng.normal(size=(4, 512)) * 0.6 - org
    if dim == 3:
        org[3] = d[3] = 0.0
    a = np.asarray(tables.shape_vec[leaf[1] + 1], np.float64)
    d[:, :8] = a[:, None] * np.where(np.arange(8) % 2, 1.0, -1.0)
    d = (d / np.linalg.norm(d, axis=0)).astype(np.float32)
    ref = JG.leaf_crossings(leaf, tables, jvec(org), jvec(d))
    got = G.leaf_crossings(leaf, ttables, tvec(org), tvec(d))
    assert len(ref) == len(got) == 2
    for (rt, rok), (gt, gok) in zip(ref, got):
        rok = np.asarray(rok)
        np.testing.assert_array_equal(gok.numpy(), rok)
        assert 0.2 < rok.mean() < 1.0 and not rok[:8].any()
        np.testing.assert_allclose(gt.numpy()[rok], np.asarray(rt)[rok],
                                   rtol=0, atol=4e-6)
    p = org + np.asarray(ref[0][0]) * d
    for fn in ("leaf_normal", "boundary_abs"):
        r = getattr(JG, fn)(leaf, tables, jvec(p))
        g = getattr(G, fn)(leaf, ttables, tvec(p))
        r, g = (np.stack(list(r)), np.stack([c.numpy() for c in g])) \
            if fn == "leaf_normal" else (np.asarray(r), g.numpy())
        np.testing.assert_allclose(g, r, rtol=0, atol=4e-6, err_msg=fn)
    ru, rv = JG.leaf_uv(leaf, tables, jvec(p), dim)
    gu, gv = G.leaf_uv(leaf, ttables, tvec(p), dim)
    np.testing.assert_allclose(gu.numpy(), np.asarray(ru), rtol=0, atol=2e-6)
    np.testing.assert_allclose(gv.numpy(), np.asarray(rv), rtol=0, atol=2e-6)


def test_entity_hit_of_a_composite_matches_jax():
    """The membership-flip probe: the nearest valid crossing of seeded rays
    with the nested tree, its hit flag, normal and UV."""
    static, tables, _, ttables, _ = compiled(csg_tree_scene(3))
    node = static.entities[0].shape
    rng = np.random.default_rng(3)
    org = np.zeros((4, 1024), np.float32)
    org[:3] = rng.uniform(-0.5, 0.5, size=(3, 1024)) + np.array(
        [[0.0], [0.0], [6.0]])
    d = np.zeros((4, 1024))
    d[:3] = rng.normal(size=(3, 1024)) * 0.25 + np.array([[0], [0], [-1.0]])
    d = (d / np.linalg.norm(d, axis=0)).astype(np.float32)
    ref = JG.entity_hit_straight(node, tables, jvec(org), jvec(d), 3, 1e3)
    got = G.entity_hit_straight(node, ttables, tvec(org), tvec(d), 3, 1e3)
    hit = np.asarray(ref[1])
    np.testing.assert_array_equal(got[1].numpy(), hit)
    assert 0.3 < hit.mean() < 1.0
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), rtol=2e-6)
    for r, g in ((ref[2], got[2]), ((ref[3], ref[4]), (got[3], got[4]))):
        r = np.stack([np.asarray(c) for c in r])[:, hit]
        g = np.stack([c.numpy() for c in g])[:, hit]
        np.testing.assert_allclose(g, r, rtol=0, atol=2e-5)


# --- shading ----------------------------------------------------------------

def test_hash2_matches_jax_uint32():
    rng = np.random.default_rng(4)
    xi = rng.integers(0, 2 ** 32, size=2048, dtype=np.uint64)
    yi = rng.integers(0, 2 ** 32, size=2048, dtype=np.uint64)
    xi[:4] = [0, 1, 2 ** 32 - 1, 2 ** 31]
    for seed in (0, 7, 42, 123456789, -3):
        ref = np.asarray(JS._hash2(jnp.asarray(xi.astype(np.uint32)),
                                   jnp.asarray(yi.astype(np.uint32)), seed))
        got = S._hash2(torch.from_numpy(xi.astype(np.int64)),
                       torch.from_numpy(yi.astype(np.int64)), seed)
        np.testing.assert_array_equal(got.numpy(), ref.astype(np.int64))


def test_perlin_matches_jax():
    rng = np.random.default_rng(5)
    pu = rng.uniform(-40.0, 40.0, size=4096).astype(np.float32)
    pv = rng.uniform(-40.0, 40.0, size=4096).astype(np.float32)
    pu[:6] = [0.0, -1.0, 3.0, -0.5, 1e-7, -1e-7]
    for seed in (0, 7, 42):
        ref = np.asarray(JS.perlin2(jnp.asarray(pu), jnp.asarray(pv), seed))
        got = S.perlin2(torch.from_numpy(pu), torch.from_numpy(pv), seed)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)
    u, v = pu / 40.0, pv / 40.0
    for scale, octaves, seed in ((4.0, 4, 7), (8.0, 2, 42), (0.6, 3, 0)):
        ref = np.asarray(JS.perlin_field(jnp.asarray(u), jnp.asarray(v),
                                         jnp.float32(scale), octaves, seed))
        got = S.perlin_field(torch.from_numpy(u), torch.from_numpy(v),
                             torch.tensor(scale), octaves, seed)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)
        assert 0.0 <= ref.min() and ref.max() <= 1.0 and ref.std() > 0.05


def test_texture_sample_matches_jax_at_negative_uv():
    """The gather filter of config3's texture surface at UVs of both signs
    and at whole numbers, where jnp.mod wraps (fmod plus the divisor)."""
    static, tables, _, ttables, _ = compiled(et.get_scene(
        "config3_csg_textured"))
    s = static.surf_kinds.index("texture")
    rng = np.random.default_rng(6)
    u = rng.uniform(-3.0, 3.0, size=4096).astype(np.float32)
    v = rng.uniform(-3.0, 3.0, size=4096).astype(np.float32)
    u[:6] = [0.0, -0.5, -1.0, 1.0, -1e-8, 0.49999997]
    ref = JS.eval_surface(static, tables, s, jnp.asarray(u), jnp.asarray(v))
    got = S.eval_surface(static, ttables, s, torch.from_numpy(u),
                         torch.from_numpy(v))
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                   atol=1e-6)
    x = np.concatenate([u, -u, np.float32([-0.0, -1e-30, 5.0, -5.0])])
    np.testing.assert_array_equal(S.mod1(torch.from_numpy(x)).numpy(),
                                  np.asarray(jnp.mod(jnp.asarray(x), 1.0)))


# --- renders ----------------------------------------------------------------

SCENES = ("config3_csg_textured", "perlin_probe", "cylinder_test")


@jax_refs.stored("csg.lax", SCENES)
def lax_ref(name):
    """The lax render at 16 x 128, op by op: on a CPU that takes a fraction
    of the time of its jit compile."""
    sc = scene(name)
    static, tables, cam, _, _ = compiled(sc)

    def run():
        with jax.disable_jit():
            return {"rgb": et.render_image(static, tables, cam, 16, 128)}
    return {"scene": sc, "H": 16, "W": 128}, run


@pytest.mark.parametrize("name", SCENES)
def test_plain_matches_lax(name):
    static, tables, cam, ttables, tcam = compiled(scene(name))
    ref = lax_ref.load(name)["rgb"]
    got = trace.render_image(static, ttables, tcam, 16, 128)
    # an ulp of the texel coordinate or of a probe point may move one
    # pixel: allow 0.2% of them, as tests/test_torch_trace.py does
    assert_images_close(ref, got.numpy(), atol=1e-5, max_bad_frac=0.002,
                        msg=f"torch-vs-lax {name}")


@pytest.mark.parametrize("name", SCENES[:2])
def test_plain_matches_golden(name):
    gold = np.load(GOLDENS)[name]
    static, _, _, ttables, tcam = compiled(scene(name))
    err = np.abs(trace.render_image(static, ttables, tcam, 48, 64).numpy()
                 - gold).max(axis=-1)
    assert (err > 2e-3).mean() <= 0.01, (name, err.max())


@pytest.mark.parametrize("name", SCENES + ("csg_warp",))
def test_plain_passes_oracle_gate(name):
    static, _, _, ttables, tcam = compiled(scene(name))
    assert assert_oracle_match(static, ttables, tcam, trace.render_image,
                               h=48, w=128, label=name) >= 0.99


# --- gradients --------------------------------------------------------------

def grad_case(name):
    """config3 and the smooth cylinder scene cut to max_depth=2
    (tests/test_gradients.py::_depth2: both pushes and the loop)."""
    sc = et.get_scene(name) if name == "config3_csg_textured" \
        else cylinder_smooth()
    return replace(sc, settings=replace(sc.settings, max_depth=2))


def grad_cotangent():
    return np.random.default_rng(7).normal(size=(16, 24, 3)).astype(
        np.float32)


@jax_refs.stored("csg.vjp", ["config3_csg_textured", "cylinder_smooth"])
def vjp_ref(name):
    """jax.vjp of the lax render at 16 x 24, op by op, as
    tests/test_torch_grad.py runs it: on a CPU its jit compile of these
    scenes' reverse pass takes longer than the op-by-op run (ROADMAP.md
    Queue 3)."""
    sc = grad_case(name)
    static, tables, cam, _, _ = compiled(sc)
    g = grad_cotangent()

    def run():
        t32 = jax.tree.map(lambda x: jnp.asarray(x, jnp.float32), tables)
        with jax.disable_jit():
            _, vjp = jax.vjp(lambda t, c: et.render_image(static, t, c, 16,
                                                          24, True), t32, cam)
            return jax_refs.leaves(*vjp(jnp.asarray(g)))
    return {"scene": sc, "H": 16, "W": 24, "seed": 7, "cotangent": g}, run


@pytest.mark.parametrize("name", ["config3_csg_textured", "cylinder_smooth"])
def test_vjp_matches_jax(name):
    """vjp_blocked against jax.vjp of the lax render at 16 x 24: every float
    table, every texel and the camera within 1e-3 * max(max |ref|, 1)
    (tests/test_gradients.py's rule)."""
    static, tables, cam, ttables, tcam = compiled(grad_case(name))
    H, W = 16, 24
    g = grad_cotangent()
    ref = vjp_ref.load(name)
    gt, gc, _ = vjp_blocked(static, ttables, tcam, H, W, torch.from_numpy(g))
    got = jax_refs.leaves(gt, gc)
    assert sorted(ref) == sorted(got)
    for k, b in got.items():
        a, b = np.asarray(ref[k], np.float64), np.asarray(b, np.float64)
        assert a.shape == b.shape, k
        tol = 1e-3 * max(np.abs(a).max(), 1.0)
        assert np.abs(a - b).max() <= tol, (k, np.abs(a - b).max(), tol)
    if name == "config3_csg_textured":
        assert np.abs(ref["textures[0]"]).max() > 1e-2  # the texels
    else:
        # the cylinders' rows (centre and axis) get gradients
        rows = [e.shape[1] for e in static.entities if e.shape[0] ==
                "cylinder"]
        assert np.abs(ref["shape_vec"][rows[0]]).max() > 1e-3
        assert np.abs(ref["shape_vec"][rows[0] + 1]).max() > 1e-3
