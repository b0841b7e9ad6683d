"""The port's meters and traces (utils/profiling.py) and its CLI's flags
and backends (cli.py) against the JAX package's.

RenderMeter's report must be the JAX package's after the same calls;
profile_trace writes a torch.profiler trace (a no-op without a
directory); the CLI takes every flag and backend of euclider_tpu/cli.py,
with cuda and torch in place of lax and pallas.  Everything runs on the
CPU at a few pixels, through the plain version or the host oracles.
"""
import json

import numpy as np
import pytest
import torch

from euclider_tpu.cli import build_parser as jax_build_parser
from euclider_tpu.utils.profiling import RenderMeter as JaxRenderMeter

import euclider_tpu_torch as ett
from euclider_tpu_torch import cli
from euclider_tpu_torch.utils.profiling import RenderMeter, profile_trace


@pytest.mark.parametrize("calls", [
    (), ((0.4, 4),), ((0.0125, 1), (0.3, 3), (1e-4, 1)),
    ((2.5, 7), (0.011, 2))])
@pytest.mark.parametrize("chips", [1, 4])
def test_render_meter_report_matches_jax(calls, chips):
    port, ref = RenderMeter(90, 160, n_chips=chips), \
        JaxRenderMeter(90, 160, n_chips=chips)
    for seconds, frames in calls:
        port.add(seconds, frames)
        ref.add(seconds, frames)
    assert port.times == ref.times
    for label in ("render", "cuda"):
        assert port.report(label) == ref.report(label)
    assert port.mrays_per_sec() == ref.mrays_per_sec()
    assert port.mrays_per_sec_per_chip() == ref.mrays_per_sec_per_chip()


def test_render_meter_frame_on_the_cpu_takes_the_host_clock(capsys):
    m = RenderMeter(4, 6, device=torch.device("cpu"))
    for _ in range(2):
        with m.frame():
            torch.ones(64).sum()
    assert len(m.times) == 2 and all(t > 0 for t in m.times)
    m.log("unit")
    rec = json.loads(capsys.readouterr().out)
    assert rec["frames"] == 2 and rec["resolution"] == "6x4"


def test_profile_trace_is_a_noop_without_a_directory(tmp_path):
    with profile_trace(None):
        x = torch.ones(3).sum()
    assert float(x) == 3.0
    assert not any(tmp_path.iterdir())


def test_profile_trace_writes_a_trace(tmp_path):
    logdir = tmp_path / "prof"
    with profile_trace(str(logdir)):
        torch.arange(8.0).sum()
    files = list(logdir.iterdir())
    assert len(files) == 1 and files[0].name.endswith(".pt.trace.json")
    trace = json.loads(files[0].read_text())
    assert any("aten::" in e.get("name", "") for e in trace["traceEvents"])


def _flags(parser):
    return {a.dest: a for a in parser._actions}


def test_cli_takes_every_flag_of_the_jax_cli():
    """Every flag of euclider_tpu/cli.py with its default; --backend's
    choices with cuda and torch in place of lax and pallas."""
    port, ref = _flags(cli.build_parser()), _flags(jax_build_parser())
    for dest, action in ref.items():
        assert dest in port, dest
        assert port[dest].option_strings == action.option_strings
        if dest not in ("backend", "time_frames"):
            assert port[dest].default == action.default, dest
    swap = {"lax": "cuda", "pallas": "torch"}
    assert list(port["backend"].choices) == [
        swap.get(c, c) for c in ref["backend"].choices]


def test_cli_flags_parse():
    args = cli.build_parser().parse_args([
        "--scene", "config1_sphere_room", "--size", "8x6", "--out", "x.png",
        "--backend", "numpy", "--device", "cpu", "--cpu", "--depth", "2",
        "--animate", "3", "--orbit-radius", "2.5", "--time",
        "--time-frames", "4", "--profile-dir", "p", "--view",
        "--view-frames", "2"])
    assert (args.backend, args.depth, args.animate, args.orbit_radius,
            args.time_frames, args.profile_dir, args.view_frames) == \
        ("numpy", 2, 3, 2.5, 4, "p", 2)
    assert args.cpu and args.time and args.view


def _png_size(path):
    with open(path, "rb") as f:
        head = f.read(24)
    assert head[:8] == b"\x89PNG\r\n\x1a\n"
    return int.from_bytes(head[16:20], "big"), int.from_bytes(head[20:24],
                                                              "big")


def test_cli_animate_writes_the_frames(tmp_path, capsys):
    out = tmp_path / "anim.png"
    assert cli.main(["--scene", "config1_sphere_room", "--size", "8x6",
                     "--backend", "torch", "--device", "cpu", "--animate",
                     "2", "--out", str(out)]) == 0
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "anim_0000.png", "anim_0001.png"]
    assert _png_size(tmp_path / "anim_0001.png") == (8, 6)
    assert "wrote 2 frames" in capsys.readouterr().out


def test_cli_time_prints_the_render_meter_record(tmp_path, capsys):
    out, prof = tmp_path / "t.png", tmp_path / "prof"
    assert cli.main(["--scene", "config1_sphere_room", "--size", "8x6",
                     "--backend", "torch", "--cpu", "--out", str(out),
                     "--time", "--time-frames", "2", "--profile-dir",
                     str(prof)]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert any(ln.startswith("time: ") and "median of 2" in ln
               for ln in lines)
    rec = json.loads([ln for ln in lines if ln.startswith("{")][0])
    assert rec["frames"] == 2 and rec["label"] == "torch"
    # the rate of the frames' mean time, rounded to 0.01 as the record
    # rounds it: 48 rays a frame read 0.0 once a frame takes 10 ms
    assert rec["ms_per_frame"] > 0
    assert abs(rec["mrays_per_s"] - 48 / rec["ms_per_frame"] / 1e3) <= 0.005
    assert len(list(prof.iterdir())) == 1


@pytest.mark.parametrize("backend", ["numpy", "oracle"])
def test_cli_host_backends_render_the_oracles(backend, tmp_path):
    """--backend numpy (oracle/cpu_oracle.py) and --backend oracle (the
    native float64 oracle) write the frame their oracle renders."""
    from euclider_tpu_torch.oracle.cpu_oracle import render_oracle
    out = tmp_path / "o.png"
    assert cli.main(["--scene", "config1_sphere_room", "--size", "8x6",
                     "--backend", backend, "--out", str(out)]) == 0
    assert _png_size(out) == (8, 6)
    sc = ett.get_scene("config1_sphere_room")
    static, tables = ett.compile_scene(sc)
    ref = render_oracle(static, tables, ett.compile_camera(sc.camera), 6, 8)
    got = cli.make_render(sc, 6, 8, backend, torch.device("cpu"))()
    assert got.shape == (6, 8, 3)
    assert np.abs(got - ref).max() <= (0.0 if backend == "numpy" else 2e-3)


def test_cli_depth_overrides_the_bounce_depth(tmp_path):
    """--depth 0 renders config2's mirror and glass without their
    bounces: another frame than the scene's own depth."""
    imgs = []
    for extra in ([], ["--depth", "0"]):
        out = tmp_path / f"d{len(imgs)}.png"
        assert cli.main(["--scene", "config2_mirror_glass", "--size", "8x6",
                         "--backend", "torch", "--cpu", "--out", str(out)]
                        + extra) == 0
        imgs.append(out.read_bytes())
    assert imgs[0] != imgs[1]


def test_cli_view_runs_headless_frames(capsys):
    assert cli.main(["--scene", "config1_sphere_room", "--size", "8x6",
                     "--backend", "torch", "--cpu", "--view",
                     "--view-frames", "2"]) == 0
    assert "viewed 2 frames" in capsys.readouterr().out


@pytest.mark.parametrize("argv,match", [
    (["--backend", "cuda", "--cpu"], "--device cuda"),
    (["--backend", "numpy", "--view"], "--view and --animate"),
    (["--backend", "oracle", "--animate", "2"], "--view and --animate")])
def test_cli_refuses_what_it_cannot_run(argv, match):
    with pytest.raises(SystemExit, match=match):
        cli.main(["--scene", "config1_sphere_room", "--size", "8x6"] + argv)
