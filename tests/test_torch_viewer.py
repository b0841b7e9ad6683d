"""The port's camera, terminal viewer, frame loop, numpy oracle and
render_rays against the JAX package's (models/camera.py,
viewer/terminal.py, viewer/simulation.py, oracle/cpu_oracle.py,
ops/trace.py::render_rays).

The copies are numpy like their originals, so the camera's poses, the
terminal's strings and bytes and the numpy oracle's frames must be the
JAX package's to the bit; render_rays runs the port's plain trace and is
held within 1e-5 of the JAX lax trace run op by op.  The frame loop's
own behaviour is checked on the port alone, with the plain version on the
CPU (``backend="torch", device="cpu"``), at a few pixels: no JAX render is
compiled here.
"""
import io

import jax
import numpy as np
import pytest

import euclider_tpu as et
from euclider_tpu.models import camera as jax_camctl
from euclider_tpu.oracle import cpu_oracle as jax_cpu_oracle
from euclider_tpu.scene.compile import CameraParams as JaxCameraParams
from euclider_tpu.viewer import terminal as jax_terminal
from euclider_tpu.viewer.simulation import Simulation as JaxSimulation

import euclider_tpu_torch as ett
from euclider_tpu_torch.models import camera as camctl
from euclider_tpu_torch.oracle import cpu_oracle
from euclider_tpu_torch.viewer import terminal
from euclider_tpu_torch.viewer.simulation import Simulation, render_orbit


def seeded_pose(seed, dim):
    """A random camera pose from numpy (w = 0 in 3D), as both packages'
    CameraParams."""
    rng = np.random.default_rng(seed)
    vecs = [rng.normal(size=4).astype(np.float32) for _ in range(4)]
    if dim == 3:
        for v in vecs:
            v[3] = 0.0
    fov = np.float32(rng.uniform(0.3, 1.2))
    return (ett.CameraParams(*(v.copy() for v in vecs), fov),
            JaxCameraParams(*(v.copy() for v in vecs), fov))


def assert_same_camera(port, ref):
    assert len(port) == len(ref)
    for a, b in zip(port, ref):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and np.array_equal(a, b), (a, b)


POSE_OPS = {
    "translate": lambda m, cam, rng: m.translate(cam, *rng.normal(size=3)),
    "rotate": lambda m, cam, rng: m.rotate(cam, *rng.normal(size=3) * 0.3),
    "rotate_4d": lambda m, cam, rng: m.rotate(
        cam, *rng.normal(size=5) * 0.3),
    "look_at": lambda m, cam, rng: m.look_at(
        tuple(np.asarray(cam.position)), tuple(rng.normal(size=4)),
        fov_deg=float(rng.uniform(30, 90))),
    "look_at_3d": lambda m, cam, rng: m.look_at(
        tuple(rng.normal(size=3)), tuple(rng.normal(size=3))),
    "orbit": lambda m, cam, rng: m.orbit(cam, tuple(rng.normal(size=3)),
                                         float(rng.uniform(-3, 3))),
}


@pytest.mark.parametrize("dim", [3, 4])
@pytest.mark.parametrize("op", sorted(POSE_OPS))
def test_camera_pose_updates_match_jax(op, dim):
    """translate / rotate (with the 4D w_yaw, w_pitch) / look_at / orbit
    on seeded poses, chained three times: the JAX package's poses to the
    bit."""
    port, ref = seeded_pose(7 + dim, dim)
    for k in range(3):
        port = POSE_OPS[op](camctl, port, np.random.default_rng(k))
        ref = POSE_OPS[op](jax_camctl, ref, np.random.default_rng(k))
        assert_same_camera(port, ref)


@pytest.mark.parametrize("name", ["config1_sphere_room",
                                  "config4_hypersphere"])
def test_simulation_pose_after_keys_and_mouse_matches_jax(name):
    """The same keys and mouse moves on a JAX Simulation (never stepped,
    so nothing is compiled) and a port Simulation: the same camera."""
    ref = JaxSimulation(et.get_scene(name), H=4, W=4)
    sim = Simulation(ett.get_scene(name), H=4, W=4, backend="torch",
                     device="cpu")
    assert_same_camera(sim.cam, ref.cam)
    for keys, (du, dv) in (("wwl", (3, -2)), ("asdqe", (0, 5)),
                           ("jikuo", (-4, 1)), ("nm,.", (2, 2)),
                           ("xw.n", (1, -1))):
        for s in (sim, ref):
            s.handle_keys(keys)
            s.mouse_look(du, dv)
        assert_same_camera(sim.cam, ref.cam)


def _img(seed, shape):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-0.2, 1.2, size=shape)).astype(np.float32)


@pytest.mark.parametrize("shape,cols,rows", [((32, 48, 3), 24, 8),
                                             ((9, 7, 3), 80, 20),
                                             ((40, 30, 3), 13, 5)])
def test_frame_to_ansi_matches_jax(shape, cols, rows):
    img = _img(sum(shape), shape)
    assert terminal.frame_to_ansi(img, cols, rows) == \
        jax_terminal.frame_to_ansi(img, cols, rows)


def test_mouse_parser_matches_jax():
    """The same raw input, fed in the same pieces: the same keys and
    mouse-look deltas."""
    rng = np.random.default_rng(3)
    pieces = []
    for _ in range(40):
        kind = rng.integers(4)
        x, y = (int(v) for v in rng.integers(1, 60, size=2))
        pieces.append(["w", f"\x1b[<0;{x};{y}M", f"\x1b[<32;{x};{y}M",
                       f"\x1b[<0;{x};{y}m"][kind])
    port, ref = terminal.MouseParser(), jax_terminal.MouseParser()
    for i in range(0, len(pieces), 3):
        data = "".join(pieces[i:i + 3])
        assert port.parse(data) == ref.parse(data)


def test_save_ansi_matches_jax(tmp_path):
    img = _img(5, (24, 40, 3))
    terminal.save_ansi(img, str(tmp_path / "port.ans"), cols=20, rows=6)
    jax_terminal.save_ansi(img, str(tmp_path / "ref.ans"), cols=20, rows=6)
    assert (tmp_path / "port.ans").read_bytes() == \
        (tmp_path / "ref.ans").read_bytes()


def test_cpu_oracle_matches_jax():
    """The numpy float64 oracle on config1 at 6x8: the JAX package's frame
    to the bit."""
    sc, ref_sc = ett.get_scene("config1_sphere_room"), \
        et.get_scene("config1_sphere_room")
    static, tables = ett.compile_scene(sc)
    rstatic, rtables = et.compile_scene(ref_sc)
    got = cpu_oracle.render_oracle(static, tables,
                                   ett.compile_camera(sc.camera), 6, 8)
    ref = jax_cpu_oracle.render_oracle(rstatic, rtables,
                                       et.compile_camera(ref_sc.camera), 6, 8)
    assert got.dtype == ref.dtype and np.array_equal(got, ref)


def test_render_rays_matches_jax():
    """render_rays on 40 seeded pixel coordinates of config1's 48x64 frame
    within 1e-5 of the JAX render_rays (the lax trace, op by op)."""
    from euclider_tpu.ops.trace import render_rays as jax_render_rays
    H, W = 48, 64
    rng = np.random.default_rng(11)
    xi = rng.uniform(0, W, size=40).astype(np.float32)
    yi = rng.uniform(0, H, size=40).astype(np.float32)
    sc = ett.get_scene("config1_sphere_room")
    static, tables = ett.compile_scene(sc)
    got = ett.render_rays(static, ett.tables_to_torch(tables, "cpu"),
                          ett.camera_to_torch(ett.compile_camera(sc.camera),
                                              "cpu"), xi, yi, W, H)
    rsc = et.get_scene("config1_sphere_room")
    rstatic, rtables = et.compile_scene(rsc)
    with jax.disable_jit():
        ref = jax_render_rays(rstatic, rtables, et.compile_camera(rsc.camera),
                              xi, yi, W, H)
    for a, b in zip(got, ref):
        assert a.shape == (40,)
        assert np.abs(a.numpy() - np.asarray(b)).max() <= 1e-5


def test_simulation_run_with_a_moving_camera_changes_the_frame():
    sc = ett.get_scene("config1_sphere_room")
    frames = []
    sim = Simulation(sc, H=8, W=12, backend="torch", device="cpu",
                     on_frame=lambda img, i: frames.append(img.copy()))

    def script(s, i):
        if i == 1:
            s.handle_keys("wwl")
    last = sim.run(3, script)
    assert len(frames) == 3 and last.shape == (8, 12, 3)
    assert np.abs(frames[0] - frames[2]).max() > 1e-3   # moved -> changed
    assert np.abs(last - frames[0]).max() > 1e-3
    assert sim.fps > 0 and len(sim.frame_times) == 3


def test_step_returns_the_previous_frame():
    """step(i) dispatches frame i and returns frame i - 1 (frame 0 on the
    first call); flush returns the last frame, which is the render at the
    final camera."""
    sc = ett.get_scene("config1_sphere_room")
    sim = Simulation(sc, H=8, W=12, backend="torch", device="cpu")
    f0 = sim.step(0).copy()
    sim.mouse_look(6, 0)
    again = sim.step(1).copy()
    last = sim.flush()
    assert np.array_equal(again, f0)
    assert np.abs(last - f0).max() > 1e-3
    direct = ett.render_image(sim.static, sim.tables,
                              ett.camera_to_torch(sim.cam, "cpu"), 8, 12)
    assert np.array_equal(last, direct.numpy())
    with pytest.raises(RuntimeError, match="no frame in flight"):
        sim.flush()


def test_simulation_time_steps_the_scene_time():
    sc = ett.get_scene("config1_sphere_room")
    sim = Simulation(sc, H=4, W=4, backend="torch", device="cpu")
    sim.time_step = 0.25
    sim.run(3)
    assert sim.time == 0.75


def test_simulation_refuses_what_it_cannot_render():
    sc = ett.get_scene("config1_sphere_room")
    with pytest.raises(ValueError, match="backend"):
        Simulation(sc, H=4, W=4, backend="lax", device="cpu")
    with pytest.raises(ValueError, match="CUDA device"):
        Simulation(sc, H=4, W=4, backend="cuda", device="cpu")


def test_run_interactive_runs_headless_frames():
    """stdin is not a tty here: the loop renders max_frames frames."""
    sim = Simulation(ett.get_scene("config4_hypersphere"), H=6, W=8,
                     backend="torch", device="cpu")
    out = io.StringIO()
    assert terminal.run_interactive(sim, max_frames=3, out=out) == 3
    assert "fps" in out.getvalue() and "▀" in out.getvalue()


def test_render_orbit_writes_the_frames(tmp_path):
    paths = render_orbit(ett.get_scene("config1_sphere_room"), 6, 8, 3,
                         str(tmp_path / "orbit.png"), backend="torch",
                         device="cpu")
    assert [p.rsplit("/", 1)[-1] for p in paths] == [
        "orbit_0000.png", "orbit_0001.png", "orbit_0002.png"]
    for p in paths:
        with open(p, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"
