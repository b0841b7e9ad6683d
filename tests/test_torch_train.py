"""The port's training step (train/inverse.py) and trainer (train/fit.py)
against the JAX package on the CPU.

The reference is the lax MSE loss under ``jax.value_and_grad`` and
``optax.adam``.  The
scene is grad_probe cut to ``max_depth=1``: the training machinery is what
is under test here, and the reverse sweep of deeper trees is held against
``jax.vjp`` in tests/test_torch_grad.py.
"""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import euclider_tpu as et

import euclider_tpu_torch as ett
from euclider_tpu_torch.ops.cuda_kernel import FLOAT_FIELDS
from euclider_tpu_torch.train import fit
from euclider_tpu_torch.train.inverse import (InverseParams,
                                              make_fused_value_and_grad,
                                              make_train_step)

H, W = 16, 24
LR, STEPS = 2e-2, 3


def sphere_rows(static):
    """A make_train_step mask of shape_vec that fits the spheres' rows and
    freezes the planes' (whose far field makes optimisation trajectories
    diverge over a few Adam steps; test_example_step_matches_jax)."""
    return torch.tensor([[float(e.shape[0] == "sphere")]
                         for e in static.entities])


@pytest.fixture(scope="module")
def problem():
    """grad_probe at depth 1 with perturbed colours, a seeded target, and
    three optax.adam steps of the lax loss on the spheres' rows of shape_vec
    and on surf_color (the camera and the rest frozen): the losses, the
    first gradients and the tables after each step."""
    sc = et.get_scene("grad_probe")
    sc = replace(sc, settings=replace(sc.settings, max_depth=1))
    static, tables = et.compile_scene(sc)
    cam = et.compile_camera(sc.camera)
    tables = tables._replace(surf_color=tables.surf_color + np.asarray(
        [0.1, -0.05, 0.08, 0.0], np.float32))
    target = np.random.default_rng(11).uniform(size=(H, W, 3)).astype(
        np.float32)
    spheres = sphere_rows(static).numpy()

    t32 = jax.tree.map(lambda x: jnp.asarray(x, jnp.float32), tables)

    def loss_lax(fields):
        img = et.render_image(static, t32._replace(**fields), cam, H, W, True)
        return jnp.mean((img - target) ** 2)

    # jitted once for the three steps (the persistent compilation cache of
    # tests/conftest.py keeps it across runs)
    value_and_grad = jax.jit(jax.value_and_grad(loss_lax))
    tabs = {k: getattr(t32, k) for k in FLOAT_FIELDS}
    opt = optax.adam(LR)
    state = opt.init({k: tabs[k] for k in fit.FIT})
    losses, grads, after = [], [], []
    for _ in range(STEPS):
        loss, g = value_and_grad(tabs)
        grads.append({k: np.asarray(v) for k, v in g.items()})
        g = {k: g[k] for k in fit.FIT}
        g["shape_vec"] = g["shape_vec"] * spheres
        fields = {k: tabs[k] for k in fit.FIT}
        updates, state = opt.update(g, state, fields)
        tabs.update(optax.apply_updates(fields, updates))
        losses.append(float(loss))
        after.append({k: np.asarray(tabs[k]) for k in fit.FIT})
    return static, tables, cam, target, losses, grads[0], after


def port_params(tables, cam):
    return InverseParams(ett.tables_to_torch(tables, "cpu"),
                         ett.camera_to_torch(cam, "cpu"))


def test_value_and_grad_matches_jax(problem):
    static, tables, cam, target, losses, grads, _ = problem
    vg = make_fused_value_and_grad(static, H, W, backend="torch")
    loss, g = vg(port_params(tables, cam), torch.from_numpy(target))
    assert np.isclose(float(loss), losses[0], rtol=1e-5, atol=0.0)
    for k in FLOAT_FIELDS:
        ref = grads[k].astype(np.float64)
        got = getattr(g.tables, k).double().numpy()
        assert np.abs(ref - got).max() <= 1e-3 * max(np.abs(ref).max(), 1.0)
    assert all(float(v.abs().max()) > 0 for v in g.cam)   # not frozen here


def test_adam_steps_track_optax(problem):
    static, tables, cam, target, losses, _, after = problem
    params = port_params(tables, cam)
    frozen = [v.clone() for v in params.cam] + [
        getattr(params.tables, k).clone() for k in FLOAT_FIELDS
        if k not in fit.FIT]
    step, opt = make_train_step(static, H, W, params, lr=LR, backend="torch",
                                fit={"shape_vec": sphere_rows(static),
                                     "surf_color": None})
    assert isinstance(opt, torch.optim.Adam)
    for i in range(STEPS):
        loss = step(torch.from_numpy(target))
        assert np.isclose(float(loss), losses[i], rtol=1e-5, atol=0.0)
        for k in fit.FIT:
            np.testing.assert_allclose(getattr(params.tables, k).numpy(),
                                       after[i][k], rtol=0, atol=1e-4)
    assert all(torch.equal(a, b) for a, b in zip(
        frozen, list(params.cam) + [getattr(params.tables, k)
                                    for k in FLOAT_FIELDS
                                    if k not in fit.FIT]))


def test_example_step_matches_jax():
    """Three steps of examples/inverse_fit.py at its one-device size (16 x
    64): its perturbation of grad_probe, its lax loss through make_loss_fn
    on a one-device mesh and optax.multi_transform with its labels (Adam
    2e-2 on all of shape_vec and surf_color, the rest and the camera
    frozen), against fit.perturb and make_train_step on fit.FIT.  Each step
    starts from the example's parameters (the optimisers keep their own
    moments): the loss and the updated tables within 1e-5 relative (of
    each table's largest entry).  Left to run free, the two trajectories
    part after the first step (loss 2.1e-5 relative apart at step 2, 8.7e-4
    at step 3, on the CPU): the fitted floor normal tilts the
    far field, where pixel flips change the loss discontinuously."""
    from euclider_tpu.parallel.mesh import make_mesh
    from euclider_tpu.train.inverse import InverseParams as JParams
    from euclider_tpu.train.inverse import make_loss_fn

    H, W = 16, 64
    sc = et.get_scene("grad_probe")
    static, tables = et.compile_scene(sc)
    cam = et.compile_camera(sc.camera)
    tables = jax.tree.map(lambda x: jnp.asarray(x, jnp.float32), tables)
    target = np.array(et.render_image_jit(static, tables, cam, H, W))
    perturbed = tables._replace(
        shape_vec=tables.shape_vec.at[0, 0].add(0.35).at[0, 2].add(-0.3),
        surf_color=tables.surf_color.at[:, :3].add(0.15))
    params = JParams(perturbed, cam)
    loss_fn = make_loss_fn(static, H, W, make_mesh(1))
    label = JParams(tables=type(tables)(*["opt" if f in fit.FIT else "frozen"
                                          for f in tables._fields]),
                    cam="frozen")
    opt = optax.multi_transform(
        {"opt": optax.adam(LR), "frozen": optax.set_to_zero()}, label)
    state = opt.init(params)

    @jax.jit
    def jstep(params, state):
        loss, g = jax.value_and_grad(loss_fn)(params, jnp.asarray(target))
        updates, state = opt.update(g, state, params)
        return optax.apply_updates(params, updates), state, loss

    truth = ett.tables_to_torch(tables, "cpu")
    port = InverseParams(fit.perturb(truth), ett.camera_to_torch(cam, "cpu"))
    for k in fit.FIT:
        assert np.array_equal(getattr(port.tables, k).numpy(),
                              np.asarray(getattr(perturbed, k)))
    frozen = [v.clone() for v in port.cam] + [
        getattr(port.tables, k).clone() for k in FLOAT_FIELDS
        if k not in fit.FIT]
    step, _ = make_train_step(static, H, W, port, lr=LR, backend="torch",
                              fit=dict.fromkeys(fit.FIT))
    for _ in range(STEPS):
        with torch.no_grad():
            for k in fit.FIT:
                getattr(port.tables, k).copy_(torch.from_numpy(
                    np.array(getattr(params.tables, k))))
        params, state, loss = jstep(params, state)
        got = step(torch.from_numpy(target))
        assert abs(float(got) - float(loss)) <= 1e-5 * abs(float(loss))
        for k in fit.FIT:
            ref = np.asarray(getattr(params.tables, k))
            np.testing.assert_allclose(getattr(port.tables, k).numpy(), ref,
                                       rtol=0,
                                       atol=1e-5 * np.abs(ref).max())
    assert all(torch.equal(a, b) for a, b in zip(
        frozen, list(port.cam) + [getattr(port.tables, k)
                                  for k in FLOAT_FIELDS if k not in fit.FIT]))


def test_fit_runs_and_its_loss_falls(capsys):
    """The trainer end to end on config1, whose fit recovers colours: its
    loss falls from the first step.  (On grad_probe, the example's scene,
    fitting the floor's normal as the example does raises the loss in the
    first steps.)"""
    out = fit.main(["--scene", "config1_sphere_room", "--device", "cpu",
                    "--backend", "torch", "--size", "32x16", "--steps", "2"])
    assert len(out["losses"]) == 2 and np.isfinite(out["losses"]).all()
    assert out["losses"][1] < out["losses"][0]
    assert out["launches"] == {"trace_fwd": 0, "trace_bwd": 0, "trace_seg": 0}
    assert "sphere-position error" in capsys.readouterr().out


@pytest.mark.parametrize("backend", ["cuda", "cuda-fused"])
def test_fit_kernel_backends_need_the_card(backend):
    with pytest.raises(SystemExit, match="device cuda"):
        fit.main(["--device", "cpu", "--backend", backend, "--steps", "1"])
