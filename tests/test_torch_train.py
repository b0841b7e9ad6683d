"""The port's training step (train/inverse.py) and trainer (train/fit.py)
against the JAX package on the CPU.

The reference is the lax MSE loss under ``jax.value_and_grad`` and
``optax.adam``.  The
scene is grad_probe cut to ``max_depth=1``: the training machinery is what
is under test here, and the reverse sweep of deeper trees is held against
``jax.vjp`` in tests/test_torch_grad.py.  The JAX side's losses, gradients
and tables are stored (tests/jax_refs.py); the three steps of ``problem``
are re-derived live.
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

import jax_refs

H, W = 16, 24
LR, STEPS = 2e-2, 3


def sphere_rows(static):
    """A make_train_step mask of shape_vec that fits the spheres' rows and
    freezes the planes' (whose far field makes optimisation trajectories
    diverge over a few Adam steps; test_example_step_matches_jax)."""
    return torch.tensor([[float(e.shape[0] == "sphere")]
                         for e in static.entities])


def problem_case():
    """grad_probe at depth 1 with perturbed colours and a seeded target ->
    (scene, static, numpy tables, numpy camera, target)."""
    sc = et.get_scene("grad_probe")
    sc = replace(sc, settings=replace(sc.settings, max_depth=1))
    static, tables = et.compile_scene(sc)
    cam = et.compile_camera(sc.camera)
    tables = tables._replace(surf_color=tables.surf_color + np.asarray(
        [0.1, -0.05, 0.08, 0.0], np.float32))
    target = np.random.default_rng(11).uniform(size=(H, W, 3)).astype(
        np.float32)
    return sc, static, tables, cam, target


@jax_refs.stored("train.problem", ["grad_probe"])
def problem_ref(_):
    """Three optax.adam steps of the lax loss on the spheres' rows of
    shape_vec and on surf_color (the camera and the rest frozen):
    ``loss`` [STEPS], the first gradients (``grad/<field>``) and each
    fitted table after each step (``after/<field>``, [STEPS, ...])."""
    sc, static, tables, cam, target = problem_case()
    spheres = sphere_rows(static).numpy()

    def run():
        t32 = jax.tree.map(lambda x: jnp.asarray(x, jnp.float32), tables)

        def loss_lax(fields):
            img = et.render_image(static, t32._replace(**fields), cam, H, W,
                                  True)
            return jnp.mean((img - target) ** 2)

        # jitted once for the three steps
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
            losses.append(np.asarray(loss))
            after.append({k: np.asarray(tabs[k]) for k in fit.FIT})
        out = {"loss": np.stack(losses)}
        out.update((f"grad/{k}", v) for k, v in grads[0].items())
        out.update((f"after/{k}", np.stack([a[k] for a in after]))
                   for k in fit.FIT)
        return out
    return ({"scene": sc, "H": H, "W": W, "lr": LR, "steps": STEPS,
             "colour": tables.surf_color, "target": target,
             "spheres": spheres, "fit": list(fit.FIT)}, run)


@pytest.fixture(scope="module")
def problem():
    """problem_case's inputs and problem_ref's stored outputs: the losses,
    the first gradients and the tables after each step."""
    _, static, tables, cam, target = problem_case()
    ref = problem_ref.load("grad_probe")
    losses = [float(v) for v in ref["loss"]]
    grads = {k: ref[f"grad/{k}"] for k in FLOAT_FIELDS}
    after = [{k: ref[f"after/{k}"][i] for k in fit.FIT}
             for i in range(STEPS)]
    return static, tables, cam, target, losses, grads, after


def test_train_step_reference_is_the_jax_steps():
    """The stored losses, gradients and tables are the three optax steps',
    to the bit."""
    jax_refs.assert_live_is_stored(problem_ref, "grad_probe")


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


EX_H, EX_W = 16, 64


def example_case():
    """examples/inverse_fit.py's scene at its one-device size -> (scene,
    static, numpy tables, numpy camera)."""
    sc = et.get_scene("grad_probe")
    static, tables = et.compile_scene(sc)
    return sc, static, tables, et.compile_camera(sc.camera)


@jax_refs.stored("train.example", ["grad_probe"])
def example_ref(_):
    """examples/inverse_fit.py's first three steps: its target (the jit'd
    lax render, ``target``), its perturbation of grad_probe
    (``perturbed/<field>``), and its jit'd step (make_loss_fn on a
    one-device mesh, optax.multi_transform with its labels): ``loss``
    [STEPS] and the fitted tables after each step (``after/<field>``,
    [STEPS, ...])."""
    sc, static, tables, cam = example_case()

    def run():
        from euclider_tpu.parallel.mesh import make_mesh
        from euclider_tpu.train.inverse import InverseParams as JParams
        from euclider_tpu.train.inverse import make_loss_fn

        t32 = jax.tree.map(lambda x: jnp.asarray(x, jnp.float32), tables)
        target = np.array(et.render_image_jit(static, t32, cam, EX_H, EX_W))
        perturbed = t32._replace(
            shape_vec=t32.shape_vec.at[0, 0].add(0.35).at[0, 2].add(-0.3),
            surf_color=t32.surf_color.at[:, :3].add(0.15))
        params = JParams(perturbed, cam)
        loss_fn = make_loss_fn(static, EX_H, EX_W, make_mesh(1))
        label = JParams(tables=type(t32)(*["opt" if f in fit.FIT
                                           else "frozen"
                                           for f in t32._fields]),
                        cam="frozen")
        opt = optax.multi_transform(
            {"opt": optax.adam(LR), "frozen": optax.set_to_zero()}, label)
        state = opt.init(params)

        @jax.jit
        def jstep(params, state):
            loss, g = jax.value_and_grad(loss_fn)(params,
                                                  jnp.asarray(target))
            updates, state = opt.update(g, state, params)
            return optax.apply_updates(params, updates), state, loss

        out = {"target": target}
        out.update((f"perturbed/{k}", np.asarray(getattr(perturbed, k)))
                   for k in fit.FIT)
        losses, after = [], []
        for _ in range(STEPS):
            params, state, loss = jstep(params, state)
            losses.append(np.asarray(loss))
            after.append({k: np.asarray(getattr(params.tables, k))
                          for k in fit.FIT})
        out["loss"] = np.stack(losses)
        out.update((f"after/{k}", np.stack([a[k] for a in after]))
                   for k in fit.FIT)
        return out
    return ({"scene": sc, "H": EX_H, "W": EX_W, "lr": LR, "steps": STEPS,
             "fit": list(fit.FIT)}, run)


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
    _, static, tables, cam = example_case()
    ref = example_ref.load("grad_probe")
    target = ref["target"]
    truth = ett.tables_to_torch(tables, "cpu")
    port = InverseParams(fit.perturb(truth), ett.camera_to_torch(cam, "cpu"))
    for k in fit.FIT:
        assert np.array_equal(getattr(port.tables, k).numpy(),
                              ref[f"perturbed/{k}"])
    frozen = [v.clone() for v in port.cam] + [
        getattr(port.tables, k).clone() for k in FLOAT_FIELDS
        if k not in fit.FIT]
    step, _ = make_train_step(static, EX_H, EX_W, port, lr=LR,
                              backend="torch", fit=dict.fromkeys(fit.FIT))
    for i in range(STEPS):
        with torch.no_grad():
            for k in fit.FIT:
                start = (ref[f"perturbed/{k}"] if i == 0
                         else ref[f"after/{k}"][i - 1])
                getattr(port.tables, k).copy_(torch.from_numpy(start))
        loss = float(ref["loss"][i])
        got = step(torch.from_numpy(target))
        assert abs(float(got) - loss) <= 1e-5 * abs(loss)
        for k in fit.FIT:
            want = ref[f"after/{k}"][i]
            np.testing.assert_allclose(getattr(port.tables, k).numpy(), want,
                                       rtol=0,
                                       atol=1e-5 * np.abs(want).max())
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
