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


@pytest.fixture(scope="module")
def problem():
    """grad_probe at depth 1 with perturbed colours, a seeded target, and
    three optax.adam steps of the lax loss on what the trainer fits (the
    sphere rows of shape_vec and surf_color; the camera and the rest
    frozen): the losses, the first gradients and the tables after each
    step."""
    sc = et.get_scene("grad_probe")
    sc = replace(sc, settings=replace(sc.settings, max_depth=1))
    static, tables = et.compile_scene(sc)
    cam = et.compile_camera(sc.camera)
    tables = tables._replace(surf_color=tables.surf_color + np.asarray(
        [0.1, -0.05, 0.08, 0.0], np.float32))
    target = np.random.default_rng(11).uniform(size=(H, W, 3)).astype(
        np.float32)
    spheres = fit.fit_masks(static, "cpu")["shape_vec"].numpy()

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
                                fit=fit.fit_masks(static, "cpu"))
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


def test_fit_runs_and_its_loss_falls(capsys):
    out = fit.main(["--device", "cpu", "--backend", "torch",
                    "--size", "32x16", "--steps", "2"])
    assert len(out["losses"]) == 2 and np.isfinite(out["losses"]).all()
    assert out["losses"][1] < out["losses"][0]
    assert out["launches"] == {"trace_fwd": 0, "trace_bwd": 0}
    assert "sphere-position error" in capsys.readouterr().out


@pytest.mark.parametrize("backend", ["cuda", "cuda-fused"])
def test_fit_kernel_backends_need_the_card(backend):
    with pytest.raises(SystemExit, match="device cuda"):
        fit.main(["--device", "cpu", "--backend", backend, "--steps", "1"])
