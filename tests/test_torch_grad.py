"""Gradients of the torch port's plain render against the JAX package.

The port's autograd VJP of ``trace.render_image(..., differentiable=True)``
is held against ``jax.vjp`` of the lax render ``et.render_image(...,
True)`` under the same numpy cotangent, with the JAX package's own rule
(``tests/test_gradients.py::_assert_grads_close``: per leaf, max |diff| <=
1e-3 * max(max |ref|, 1)).  The JAX side runs with jit disabled: its compile
of the reverse-mode bounce loop takes minutes on the CPU, its op-by-op run
seconds.  Its leaves are stored (tests/jax_refs.py), and config4's are
re-derived live.  Scenes are cut to ``max_depth=2``
(``test_gradients._depth2``), which already exercises both pushes and the
loop.
"""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import euclider_tpu as et

import euclider_tpu_torch as ett
import jax_refs
from euclider_tpu_torch.ops import trace
from euclider_tpu_torch.ops.vjp import FLOAT_FIELDS, vjp_blocked

H, W = 16, 24
PROBES = ("grad_probe", "fresnel_probe", "config2_mirror_glass",
          "config4_hypersphere")


def depth2_scene(name):
    sc = et.get_scene(name)
    return replace(sc, settings=replace(sc.settings, max_depth=2))


def depth2(name):
    """(static, numpy tables, numpy camera) of a library scene at depth 2,
    compiled by the JAX package."""
    sc = depth2_scene(name)
    static, tables = et.compile_scene(sc)
    return static, tables, et.compile_camera(sc.camera)


def to_port(tables, cam):
    return ett.tables_to_torch(tables, "cpu"), ett.camera_to_torch(cam, "cpu")


def jax_vjp(static, tables, cam, g):
    t32 = jax.tree.map(lambda x: jnp.asarray(x, jnp.float32), tables)
    with jax.disable_jit():
        _, vjp = jax.vjp(
            lambda t, c: et.render_image(static, t, c, H, W, True), t32, cam)
        return vjp(jnp.asarray(g))


def leaves(d_tables, d_cam):
    """The differentiated leaves in one order: float tables, then camera."""
    return ([np.asarray(getattr(d_tables, k)) for k in FLOAT_FIELDS]
            + [np.asarray(v) for v in d_cam])


def assert_grads_close(ref, got, rtol=1e-3):
    """Port of tests/test_gradients.py::_assert_grads_close."""
    assert len(ref) == len(got)
    for a, b in zip(ref, got):
        a = np.asarray(a, np.float64)
        b = np.asarray(b, np.float64)
        tol = rtol * max(np.abs(a).max(), 1.0) if a.size else 0.0
        assert np.abs(a - b).max() <= tol, (np.abs(a - b).max(), tol)


def cotangent(seed):
    return np.random.default_rng(seed).normal(size=(H, W, 3)).astype(
        np.float32)


@jax_refs.stored("grad.vjp", PROBES)
def vjp_ref(name):
    """jax.vjp of the lax render of the scene at depth 2 under cotangent(0):
    the leaves by name (jax_refs.leaves)."""
    static, tables, cam = depth2(name)
    g = cotangent(0)
    return ({"scene": depth2_scene(name), "H": H, "W": W, "seed": 0,
             "cotangent": g},
            lambda: jax_refs.leaves(*jax_vjp(static, tables, cam, g)))


@pytest.mark.parametrize("name", PROBES)
def test_vjp_matches_jax(name):
    static, tables, cam = depth2(name)
    g = cotangent(0)
    ref = vjp_ref.load(name)
    tt, tc = to_port(tables, cam)
    gt, gc, gtm = vjp_blocked(static, tt, tc, H, W, torch.from_numpy(g),
                              block_rows=H)
    got = jax_refs.leaves(gt, gc)
    assert sorted(ref) == sorted(got)
    assert_grads_close([ref[k] for k in got], list(got.values()))
    assert float(gtm) == 0.0
    if name == "grad_probe":
        # every surface of grad_probe has fresnel 0: the Schlick skip of the
        # non-differentiable render would zero this leaf
        assert np.abs(ref["surf_fresnel"]).min() > 1e-3


def test_vjp_reference_is_the_jax_vjp():
    """The stored leaves are jax.vjp's, to the bit (the cheapest case)."""
    jax_refs.assert_live_is_stored(vjp_ref, "config4_hypersphere")


def test_differentiable_flag_keeps_pruned_gradients():
    """Repair of the pruning: without the flag the Schlick block is skipped
    at fresnel 0 and d/d surf_fresnel vanishes; with it, it does not (the
    JAX side of test_vjp_matches_jax[grad_probe] holds its value)."""
    static, tables, cam = depth2("grad_probe")
    tt, tc = to_port(tables, cam)
    g = torch.from_numpy(cotangent(1))
    imgs = {}
    fres = tt.surf_fresnel.clone().requires_grad_(True)
    for diff in (False, True):
        imgs[diff] = trace.render_image(
            static, tt._replace(surf_fresnel=fres), tc, H, W,
            differentiable=diff)
    assert torch.equal(imgs[False], imgs[True].detach())
    assert not imgs[False].requires_grad     # the table is never read
    d_fres, = torch.autograd.grad(imgs[True], (fres,), g)
    assert float(d_fres.abs().min()) > 1e-3


def test_blocked_vjp_matches_whole_frame():
    """5-row blocks (not dividing H) against one block of the whole frame;
    the sums differ only in their order."""
    static, tables, cam = depth2("grad_probe")
    tt, tc = to_port(tables, cam)
    g = torch.from_numpy(cotangent(2))
    whole = vjp_blocked(static, tt, tc, H, W, g, block_rows=H)
    blocked = vjp_blocked(static, tt, tc, H, W, g, block_rows=5)
    assert_grads_close(leaves(*whole[:2]), leaves(*blocked[:2]), rtol=1e-5)


def test_slab_vjps_sum_to_the_frame():
    """VJPs of row slabs (y0, rows) with their rows of the cotangent add up
    to the whole frame's: the contract the multi-device slice relies on."""
    static, tables, cam = depth2("fresnel_probe")
    tt, tc = to_port(tables, cam)
    g = torch.from_numpy(cotangent(3))
    whole = vjp_blocked(static, tt, tc, H, W, g)
    parts = [vjp_blocked(static, tt, tc, H, W, g[y0:y0 + r], y0=y0, rows=r)
             for y0, r in ((0, 7), (7, 6), (13, 3))]
    summed = [sum(p) for p in zip(*(leaves(*p[:2]) for p in parts))]
    assert_grads_close(leaves(*whole[:2]), summed, rtol=1e-5)


def test_vjp_refuses_a_mismatched_cotangent():
    static, tables, cam = depth2("grad_probe")
    tt, tc = to_port(tables, cam)
    with pytest.raises(ValueError, match="cotangent shape"):
        vjp_blocked(static, tt, tc, H, W, torch.zeros(H - 1, W, 3))
