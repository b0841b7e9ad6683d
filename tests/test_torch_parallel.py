"""The port's multi-device path (parallel/, the sharded train/inverse.py)
on the CPU.

At world size 1 in this process: the sharded render is the plain render to
the bit, uneven rows raise, ``initialize`` is a no-op without torchrun's
environment.  Two gloo ranks run euclider_tpu_torch/tools/dist_check.py
under torch.distributed.run (one launch for every case, at 16x32 or the
case's own size): the gathered frame, the loss and the gradients against
the port's own one-device path (which the other tests hold against the JAX
package), the same bits on both ranks; and two single-device JAX anchors
(config1's frame, grad_probe's loss and gradients as in
tests/test_torch_train.py).  Four gloo ranks, two launches of two as two
hosts, lay out the (host, chip) mesh.  No test here builds a JAX mesh.
"""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import euclider_tpu as et

import euclider_tpu_torch as ett
from euclider_tpu_torch.ops.cuda_kernel import FLOAT_FIELDS
from euclider_tpu_torch.ops.trace import render_image
from euclider_tpu_torch.parallel import distributed as D
from euclider_tpu_torch.parallel.mesh import (Mesh, gather_frame, make_mesh,
                                              render_image_sharded)
from euclider_tpu_torch.tools.dist_check import STEPS, named
from euclider_tpu_torch.tools.dist_check import problem as case_problem
from euclider_tpu_torch.train.inverse import (make_fused_value_and_grad,
                                              make_loss_fn)

from test_torch_train import problem  # noqa: F401  (the JAX anchor's)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
                "GROUP_RANK", "MASTER_ADDR", "MASTER_PORT")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start(out, nodes, nproc, *extra):
    """dist_check.py on ``nodes`` launches of ``nproc`` gloo ranks each, on
    127.0.0.1 at a free port, started -> (out, processes, ranks)."""
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k not in TORCHRUN_ENV}
    env["PYTHONPATH"] = ROOT
    procs = [subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--nnodes",
         str(nodes), "--node_rank", str(i), "--nproc_per_node", str(nproc),
         "--master_addr", "127.0.0.1", "--master_port", str(port), "-m",
         "euclider_tpu_torch.tools.dist_check", "--device", "cpu", "--out",
         str(out), *extra], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for i in range(nodes)]
    return out, procs, nodes * nproc


def _wait(out, procs, ranks):
    """Each rank's results of a launch from ``_start``."""
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(ranks)]


@pytest.fixture(scope="module")
def launches(tmp_path_factory):
    """Both launches started together (about 2.4 GB of processes for about
    10 s), each waited for by the fixture that reads it: the two ranks, and
    the four ranks as two hosts of two."""
    runs = {"two": _start(tmp_path_factory.mktemp("dist2"), 1, 2),
            "four": _start(tmp_path_factory.mktemp("dist4"), 2, 2,
                           "--hybrid")}
    yield runs
    for _, procs, _ in runs.values():
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


@pytest.fixture(scope="module")
def two_ranks(launches):
    return _wait(*launches["two"])


@pytest.fixture(scope="module")
def four_ranks(launches):
    return _wait(*launches["four"])


# --- the JAX anchors first: the launches run while JAX compiles --------------

def test_two_rank_value_and_grad_matches_jax(launches,
                                             problem,  # noqa: F811
                                             two_ranks):
    _, _, _, _, losses, grads, _ = problem
    r = two_ranks[1]
    assert np.isclose(float(r["grad_probe/torch/loss"]), losses[0],
                      rtol=1e-5, atol=0.0)
    for k in FLOAT_FIELDS:
        ref = grads[k].astype(np.float64)
        got = r[f"grad_probe/torch/grad/{k}"].astype(np.float64)
        assert np.abs(ref - got).max() <= 1e-3 * max(np.abs(ref).max(), 1.0)


def test_two_rank_frame_matches_jax(two_ranks, compiled_scenes):
    _, static, tables, cam = compiled_scenes["config1_sphere_room"]
    ref = np.asarray(et.render_image_jit(static, tables, cam, 16, 32))
    assert np.abs(two_ranks[0]["config1/frame"] - ref).max() < 1e-5


def test_new_modules_import_no_jax():
    code = ("import sys\n"
            "import euclider_tpu_torch.parallel.distributed\n"
            "import euclider_tpu_torch.parallel.mesh\n"
            "import euclider_tpu_torch.utils.checkpointing\n"
            "import euclider_tpu_torch.tools.dist_check\n"
            "import euclider_tpu_torch.train.fit\n"
            "bad = [m for m in sys.modules\n"
            "       if m.split('.')[0] in ('jax', 'jaxlib', 'euclider_tpu')]\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


# --- world size 1, in this process ------------------------------------------

@pytest.fixture
def no_torchrun(monkeypatch):
    for k in TORCHRUN_ENV:
        monkeypatch.delenv(k, raising=False)


def test_sharded_render_is_the_plain_render_at_world_size_one(no_torchrun):
    sc = ett.get_scene("config2_mirror_glass")
    static, tables = ett.compile_scene(sc)
    tables = ett.tables_to_torch(tables, CPU)
    cam = ett.camera_to_torch(ett.compile_camera(sc.camera), CPU)
    slab = render_image_sharded(static, tables, cam, 16, 32,
                                backend="torch")
    ref = render_image(static, tables, cam, 16, 32)
    assert torch.equal(slab, ref)
    assert torch.equal(gather_frame(slab), ref)
    assert np.array_equal(D.host_gather_image(slab), ref.numpy())


def test_uneven_rows_raise(no_torchrun):
    sc = ett.get_scene("config1_sphere_room")
    static, tables = ett.compile_scene(sc)
    tables = ett.tables_to_torch(tables, CPU)
    cam = ett.camera_to_torch(ett.compile_camera(sc.camera), CPU)
    three = Mesh(np.arange(3), ("rows",), (None,))
    with pytest.raises(ValueError, match="not divisible"):
        render_image_sharded(static, tables, cam, 16, 32, three,
                             backend="torch")
    with pytest.raises(ValueError, match="not divisible"):
        make_loss_fn(static, 16, 32, "torch", three)


def test_initialize_is_a_no_op_without_the_environment(no_torchrun):
    assert D.initialize("cpu") is False
    assert D.initialize("cuda") is False     # nothing configured, no card
    assert D.process_info() == (0, 1)
    assert make_mesh().size == 1 and D.make_render_mesh().size == 1
    assert D.make_hybrid_mesh().devices.shape == (1, 1)
    with pytest.raises(ValueError):
        make_mesh(2)


def test_hybrid_layout_is_host_major():
    assert D.hybrid_layout(["a", "b", "a", "b"]).tolist() == [[0, 2], [1, 3]]
    assert D.hybrid_layout(["a"] * 4).tolist() == [[0, 1, 2, 3]]
    with pytest.raises(RuntimeError, match="uniform"):
        D.hybrid_layout(["a", "a", "a", "b"])


# --- two gloo ranks ----------------------------------------------------------

@pytest.fixture(scope="module")
def unsharded():
    """case -> (the port's one-device frame, loss, gradients)."""
    cache = {}

    def get(case):
        if case not in cache:
            static, params, target, H, W = case_problem(case, CPU)
            frame = render_image(static, params.tables, params.cam, H, W)
            loss, g = make_fused_value_and_grad(static, H, W, "torch")(
                params, torch.from_numpy(target))
            cache[case] = (frame.numpy(), float(loss),
                           {k: v.numpy() for k, v in named(g).items()})
        return cache[case]

    return get


@pytest.mark.parametrize("case", ["config2", "config5"])
def test_two_rank_frame_is_the_unsharded_render(two_ranks, unsharded, case):
    ref = unsharded(case)[0]
    for r in two_ranks:
        assert np.abs(r[f"{case}/frame"] - ref).max() <= 1e-6
        assert np.array_equal(r[f"{case}/host_frame"], r[f"{case}/frame"])
        assert r[f"{case}/replicated"] and r[f"{case}/uneven_raised"]
        assert r["world"] == 2 and r["mesh_devices"].tolist() == [0, 1]
    assert two_ranks[0][f"{case}/slab"].shape == (8, 32, 3)
    assert np.array_equal(np.concatenate([r[f"{case}/slab"]
                                          for r in two_ranks]),
                          two_ranks[0][f"{case}/frame"])


@pytest.mark.parametrize("case", ["config2", "config5"])
def test_two_rank_value_and_grad_is_the_unsharded_one(two_ranks, unsharded,
                                                      case):
    _, loss, grads = unsharded(case)
    r = two_ranks[0]
    assert abs(float(r[f"{case}/torch/loss"]) - loss) <= 1e-6 * abs(loss)
    assert abs(float(r[f"{case}/loss_fn"]) - loss) <= 1e-6 * abs(loss)
    for k, ref in grads.items():
        got = r[f"{case}/torch/grad/{k}"]
        tol = 1e-5 * max(np.abs(ref).max(), 1.0) if ref.size else 0.0
        assert np.abs(got - ref).max() <= tol, k


@pytest.mark.parametrize("case", ["config1", "config2", "config5",
                                  "grad_probe", "animated"])
def test_two_rank_grads_and_steps_are_the_same_bits(two_ranks, case):
    a, b = two_ranks
    keys = [k for k in a if k.startswith(f"{case}/torch/")
            or k.startswith(f"{case}/steps/")]
    assert len(keys) > 2 * len(FLOAT_FIELDS)
    for k in keys:
        assert np.array_equal(a[k], b[k]), k
    assert a[f"{case}/steps/loss"].shape == (STEPS,)
    assert a[f"{case}/checkpoint_bits"] and b[f"{case}/checkpoint_bits"]


def test_two_rank_animated_scene_trains_in_time(two_ranks):
    a, b = two_ranks
    l0, l1 = float(a["animated/loss_t0"]), float(a["animated/loss_t09"])
    assert np.isfinite(l0) and np.isfinite(l1) and abs(l0 - l1) > 1e-6
    gt = float(a["animated/time_grad"])
    assert np.isfinite(gt) and gt != 0.0
    assert np.array_equal(a["animated/time_grad"], b["animated/time_grad"])


# --- four gloo ranks as 2 hosts x 2 ------------------------------------------

def test_four_ranks_hybrid_mesh(four_ranks):
    for r in four_ranks:
        assert r["world"] == 4
        assert r["render_devices"].tolist() == [0, 1, 2, 3]
        assert r["hybrid_devices"].tolist() == [[0, 1], [2, 3]]
        assert r["sum"].tolist() == [6.0]
        assert r["uneven_raised"]
