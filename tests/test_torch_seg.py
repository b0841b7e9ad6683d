"""The segmented backward's plain version and its routing.

``ops/vjp.py::vjp_segmented`` (the structure of the JAX package's
``vjp_pallas_segmented``: chunks of bounce trips, boundary carries, the
chunks differentiated in reverse) is held against ``vjp_blocked`` on the
cases of ``tests/test_gradients.py``'s segmented tests and on a tree past
the tape kernel's 63 nodes, and against ``jax.vjp`` of the lax render, by
that file's rule (per leaf, max |diff| <= 1e-3 * max(max |ref|, 1); the
time within 1e-4).  The JAX side runs op by op (``test_torch_grad.py``),
and its leaves are stored (``tests/jax_refs.py``).
The kernels' device code is held against ``vjp_segmented`` in
``test_torch_harness.py``, the kernels on the card in
``test_torch_cuda.py``.
"""
from dataclasses import replace

import numpy as np
import pytest
import torch

import euclider_tpu_torch as ett
from euclider_tpu_torch.ops import cuda_bwd
from euclider_tpu_torch.ops.vjp import (FLOAT_FIELDS, chunk_sizes,
                                        vjp_blocked, vjp_segmented)

import jax_refs
from test_torch_cuda import deep_scene

H, W = 16, 24


def port_scene(sc):
    static, tables = ett.compile_scene(sc)
    return (static, ett.tables_to_torch(tables, "cpu"),
            ett.camera_to_torch(ett.compile_camera(sc.camera), "cpu"))


def with_settings(name, **settings):
    sc = ett.get_scene(name)
    return replace(sc, settings=replace(sc.settings, **settings))


def cotangent(seed, h=H, w=W):
    return np.random.default_rng(seed).normal(size=(h, w, 3)).astype(
        np.float32)


def leaves(d_tables, d_cam):
    """Every differentiated leaf: the float tables, the texels, the
    camera."""
    return ([getattr(d_tables, k) for k in FLOAT_FIELDS]
            + list(d_tables.textures) + list(d_cam))


def assert_grads_close(ref, got, rtol=1e-3):
    """tests/test_gradients.py::_assert_grads_close."""
    assert len(ref) == len(got)
    for a, b in zip(ref, got):
        a = np.asarray(a, np.float64)
        b = np.asarray(b, np.float64)
        tol = rtol * max(np.abs(a).max(), 1.0) if a.size else 0.0
        assert np.abs(a - b).max() <= tol, (np.abs(a - b).max(), tol)


@pytest.mark.parametrize("max_nodes, chunk_trips, sizes", [
    (1, 16, []), (2, 16, [1]), (4, 2, [2, 1]), (7, 1, [1] * 6),
    (63, 16, [16, 16, 16, 14]), (255, 16, [16] * 15 + [14]),
    (64, 16, [16, 16, 16, 15])])
def test_chunk_sizes_sum_to_the_trips(max_nodes, chunk_trips, sizes):
    """vjp_pallas_segmented's exact split: ceil(trips / chunk_trips) chunks
    of ceil(trips / K) trips, the last one the rest."""
    assert chunk_sizes(max_nodes, chunk_trips) == sizes
    assert sum(sizes) == max(max_nodes - 1, 0)


@pytest.mark.parametrize("settings, chunk_trips, sizes, seed", [
    ({"max_depth": 2}, 1, [1, 1], 3),
    # a truncated tree: max_nodes 4 below the full depth-3 tree's 7
    ({"max_depth": 3, "max_nodes": 4}, 2, [2, 1], 5)],
    ids=["two_segments", "truncated_tree"])
def test_segmented_matches_blocked(settings, chunk_trips, sizes, seed):
    """tests/test_gradients.py's two segmented cases on grad_probe:
    chunk_trips 1 forces a boundary at depth 2; the truncated tree's
    uneven chunks must not pop a node the forward never shaded."""
    static, tables, cam = port_scene(with_settings("grad_probe", **settings))
    assert chunk_sizes(static.max_nodes, chunk_trips) == sizes
    g = torch.from_numpy(cotangent(seed))
    ref = vjp_blocked(static, tables, cam, H, W, g)
    got = vjp_segmented(static, tables, cam, H, W, g,
                        chunk_trips=chunk_trips)
    assert_grads_close(leaves(*ref[:2]), leaves(*got[:2]))
    assert abs(float(ref[2]) - float(got[2])) <= 1e-4
    assert float(np.abs(np.asarray(ref[0].shape_vec)).max()) > 1.0


def jax_case():
    """grad_probe at depth 2, compiled by the JAX package -> (scene,
    static, numpy tables, numpy camera)."""
    import euclider_tpu as et

    sc = et.get_scene("grad_probe")
    sc = replace(sc, settings=replace(sc.settings, max_depth=2))
    static, tables = et.compile_scene(sc)
    return sc, static, tables, et.compile_camera(sc.camera)


@jax_refs.stored("seg.vjp", ["grad_probe"])
def vjp_ref(_):
    """jax.vjp of the lax render of jax_case's scene at scene time 0 under
    cotangent(3), op by op: the float tables, ``cam.<field>`` and time."""
    sc, static, tables, cam = jax_case()
    g = cotangent(3)

    def run():
        import jax
        import jax.numpy as jnp

        import euclider_tpu as et

        t32 = jax.tree.map(lambda x: jnp.asarray(x, jnp.float32), tables)
        with jax.disable_jit():
            _, vjp = jax.vjp(
                lambda t, c, tt: et.render_image(static, t, c, H, W, True,
                                                 tt),
                t32, cam, jnp.float32(0.0))
            return jax_refs.leaves(*vjp(jnp.asarray(g)))
    return {"scene": sc, "H": H, "W": W, "seed": 3, "cotangent": g}, run


def test_segmented_matches_jax():
    """vjp_segmented against jax.vjp of the lax render on the same numpy
    inputs: grad_probe at depth 2, chunks of one trip, 16x24."""
    _, static, tables, cam = jax_case()
    g = cotangent(3)
    ref = vjp_ref.load("grad_probe")
    gt, gc, gtm = vjp_segmented(static, ett.tables_to_torch(tables, "cpu"),
                                ett.camera_to_torch(cam, "cpu"), H, W,
                                torch.from_numpy(g), chunk_trips=1)
    assert_grads_close([ref[k] for k in FLOAT_FIELDS]
                       + [ref[f"cam.{k}"] for k in gc._fields],
                       [getattr(gt, k) for k in FLOAT_FIELDS] + list(gc))
    assert abs(float(ref["time"]) - float(gtm)) <= 1e-4


def test_segmented_matches_blocked_past_the_tape():
    """A tree of up to 255 nodes (config2 at max_depth 8, a smooth floor),
    16 chunks of up to 16 trips, at 8x16 in 5-row blocks."""
    static, tables, cam = port_scene(deep_scene(smooth=True))
    assert static.max_nodes == 255 > cuda_bwd.MAX_TAPE
    assert len(chunk_sizes(static.max_nodes)) == 16
    g = torch.from_numpy(cotangent(7, 8, 16))
    ref = vjp_blocked(static, tables, cam, 8, 16, g)
    got = vjp_segmented(static, tables, cam, 8, 16, g, block_rows=5)
    assert_grads_close(leaves(*ref[:2]), leaves(*got[:2]))
    assert float(np.abs(np.asarray(ref[0].shape_vec)).max()) > 1.0


def test_segmented_row_slab():
    """A slab (y0, rows) of the frame through vjp_segmented is the slab
    through vjp_blocked."""
    static, tables, cam = port_scene(with_settings("fresnel_probe",
                                                   max_depth=3))
    g = torch.from_numpy(cotangent(9, 5, W))
    ref = vjp_blocked(static, tables, cam, H, W, g, y0=6, rows=5)
    got = vjp_segmented(static, tables, cam, H, W, g, y0=6, rows=5,
                        chunk_trips=2)
    assert_grads_close(leaves(*ref[:2]), leaves(*got[:2]))


@pytest.mark.parametrize("max_nodes, backward, kind", [
    (63, "auto", "tape"), (64, "auto", "segmented"),
    (7, "segmented", "segmented"), (255, "segmented", "segmented"),
    (63, "tape", "tape")])
def test_route(max_nodes, backward, kind):
    """'auto' is the tape kernel up to MAX_TAPE nodes and the segmented
    kernels beyond."""
    static, _, _ = port_scene(with_settings("config2_mirror_glass",
                                            max_depth=8,
                                            max_nodes=max_nodes))
    assert cuda_bwd.route(static, backward) == kind


@pytest.mark.parametrize("max_nodes, backward, chunk_trips, match", [
    (64, "tape", 16, "tape kernel"), (63, "segmented", 0, "chunk_trips"),
    (63, "segmented", 64, "chunk_trips"), (63, "ckpt", 16, "backward")])
def test_route_refuses(max_nodes, backward, chunk_trips, match):
    static, _, _ = port_scene(with_settings("config2_mirror_glass",
                                            max_depth=8,
                                            max_nodes=max_nodes))
    with pytest.raises(ValueError, match=match):
        cuda_bwd.route(static, backward, chunk_trips)


def test_vjp_segmented_refuses_a_mismatched_cotangent():
    static, tables, cam = port_scene(with_settings("grad_probe",
                                                   max_depth=2))
    with pytest.raises(ValueError, match="cotangent shape"):
        vjp_segmented(static, tables, cam, H, W, torch.zeros(H, W - 1, 3))
