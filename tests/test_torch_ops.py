"""The torch port's ops against euclider_tpu.ops on seeded random rays.

Same numpy inputs through both; float32 on both sides, atol 1e-6 (the
functions are a handful of f32 operations in the same order, so they agree
to a few ulps of values of order one).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import euclider_tpu as et
from euclider_tpu.ops import geometry as jG
from euclider_tpu.ops import shading as jS
from euclider_tpu.ops import vec as jV

import euclider_tpu_torch as ett
from euclider_tpu_torch.ops import geometry as G
from euclider_tpu_torch.ops import shading as S
from euclider_tpu_torch.ops import vec as V

N = 4096
ATOL = 1e-6


def rand_vec(rng, n=N, dim=3, unit=False, lo=-3.0, hi=3.0):
    a = rng.uniform(lo, hi, (n, 4)).astype(np.float32)
    a[:, dim:] = 0.0
    if unit:
        a /= np.linalg.norm(a, axis=1, keepdims=True)
    return a


def both(a):
    """numpy [n, 4] -> (JAX Vec, torch Vec)."""
    return (jV.Vec(*(jnp.asarray(a[:, i]) for i in range(4))),
            V.Vec(*(torch.from_numpy(a[:, i].copy()) for i in range(4))))


def close(j, t, atol=ATOL):
    j = np.asarray(j)
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    if j.dtype == bool:
        assert np.array_equal(j, t)
    else:
        np.testing.assert_allclose(t, j, rtol=0, atol=atol)


def close_vec(jv, tv, atol=ATOL):
    for a, b in zip(jv, tv):
        close(a, b, atol)


@pytest.fixture(scope="module")
def scene():
    """config2's compiled tables (three spheres and a half-space), numpy for
    the JAX side and torch for the port."""
    sc = et.get_scene("config2_mirror_glass")
    static, tables = et.compile_scene(sc)
    return static, tables, ett.tables_to_torch(tables, "cpu")


def test_vec_normalize_reflect():
    rng = np.random.default_rng(0)
    (jd, td), (jn, tn) = both(rand_vec(rng)), both(rand_vec(rng, unit=True))
    close_vec(jV.normalize(jd), V.normalize(td))
    close_vec(jV.reflect(jd, jn), V.reflect(td, tn))
    close(jV.dot(jd, jn), V.dot(td, tn), atol=4e-6)   # |dot| up to ~5


def test_vec_refract_with_total_internal_reflection():
    rng = np.random.default_rng(1)
    d = rand_vec(rng, unit=True)
    n = rand_vec(rng, unit=True)
    n[(d * n).sum(1) > 0] *= -1.0           # normal faces against d
    eta = rng.uniform(0.5, 2.0, N).astype(np.float32)
    (jd, td), (jn, tn) = both(d), both(n)
    jdir, jok = jV.refract(jd, jn, jnp.asarray(eta))
    tdir, tok = V.refract(td, tn, torch.from_numpy(eta))
    close(jok, tok)
    assert 0 < int(tok.sum()) < N, "want both refracting and TIR lanes"
    close_vec(jdir, tdir)


@pytest.mark.parametrize("row, kind", [(0, "sphere"), (3, "halfspace")])
def test_leaf_crossings(scene, row, kind):
    _, jt, tt = scene
    rng = np.random.default_rng(2)
    (jo, to), (jd, td) = both(rand_vec(rng)), both(rand_vec(rng, unit=True))
    jc = jG.leaf_crossings((kind, row), jt, jo, jd)
    tc = G.leaf_crossings((kind, row), tt, to, td)
    assert len(jc) == len(tc)
    for (jt_, jok), (tt_, tok) in zip(jc, tc):
        close(jok, tok)
        ok = tok.numpy()
        assert ok.any()
        close(np.asarray(jt_)[ok], tt_.numpy()[ok], atol=4e-6)  # |t| < 10


@pytest.mark.parametrize("row, kind, need_uv", [
    (0, "sphere", False), (3, "halfspace", True), (3, "halfspace", False)])
def test_entity_hit_straight(scene, row, kind, need_uv):
    static, jt, tt = scene
    rng = np.random.default_rng(3)
    (jo, to), (jd, td) = both(rand_vec(rng)), both(rand_vec(rng, unit=True))
    jr = jG.entity_hit_straight((kind, row), jt, jo, jd, static.dim,
                                static.t_max, need_uv)
    tr = G.entity_hit_straight((kind, row), tt, to, td, static.dim,
                               static.t_max, need_uv)
    hit = tr[1].numpy()
    close(jr[1], tr[1])
    assert 0 < hit.sum() < N
    close(np.asarray(jr[0])[hit], tr[0].numpy()[hit], atol=4e-6)
    close_vec([np.asarray(c)[hit] for c in jr[2]],
              [c.numpy()[hit] for c in tr[2]])
    for j, t in zip(jr[3:], tr[3:]):          # u, v: plane coordinates
        close(np.asarray(j)[hit], t.numpy()[hit], atol=4e-6)


@pytest.mark.parametrize("dim", [3, 4])
def test_plane_tangent_frame(dim):
    rng = np.random.default_rng(4 + dim)
    n = rand_vec(rng, dim=dim, unit=True)
    n[:8, :] = 0.0                           # ties: axis-aligned normals
    n[np.arange(8), np.arange(8) % dim] = 1.0
    jn, tn = both(n)
    for jv, tv in zip(jG.plane_tangent_frame(jn, dim),
                      G.plane_tangent_frame(tn, dim)):
        close_vec(jv, tv)


def test_checker_surface_negative_uv():
    sc = et.get_scene("config1_sphere_room")
    static, tables = et.compile_scene(sc)
    tt = ett.tables_to_torch(tables, "cpu")
    s = static.surf_kinds.index("checker")
    rng = np.random.default_rng(5)
    u = rng.uniform(-6.0, 6.0, N).astype(np.float32)
    v = rng.uniform(-6.0, 6.0, N).astype(np.float32)
    par = (np.floor(u) + np.floor(v)) % 2.0
    assert ((np.floor(u) + np.floor(v) < 0) & (par == 1)).sum() > 100
    jc = jS.eval_surface(static, tables, s, jnp.asarray(u), jnp.asarray(v))
    tc = S.eval_surface(static, tt, s, torch.from_numpy(u),
                        torch.from_numpy(v))
    for j, t in zip(jc, tc):
        assert np.array_equal(np.asarray(j), t.numpy())
