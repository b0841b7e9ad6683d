"""Package-level contract of euclider_tpu_torch: no jax, device dispatch,
no fallback between the CUDA kernel and its plain version, and the CLI."""
import os
import subprocess
import sys

import pytest
import torch

import euclider_tpu_torch as ett
from euclider_tpu_torch import cli
from euclider_tpu_torch.ops import cuda_kernel, trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def cpu_scene(name="config1_sphere_room"):
    sc = ett.get_scene(name)
    static, tables = ett.compile_scene(sc)
    return (static, ett.tables_to_torch(tables, "cpu"),
            ett.camera_to_torch(ett.compile_camera(sc.camera), "cpu"))


def test_package_imports_no_jax():
    code = ("import sys\n"
            "import euclider_tpu_torch, euclider_tpu_torch.cli\n"
            "import euclider_tpu_torch.ops.cuda_kernel\n"
            "import euclider_tpu_torch.ops.cuda_bwd\n"
            "import euclider_tpu_torch.ops.vjp\n"
            "import euclider_tpu_torch.ops.march\n"
            "import euclider_tpu_torch.ops.probes\n"
            "import euclider_tpu_torch.ops.march_probe\n"
            "import euclider_tpu_torch.tools.mosaic_probe\n"
            "import euclider_tpu_torch.tools.march_bisect\n"
            "import euclider_tpu_torch.tools.kernel_harness\n"
            "import euclider_tpu_torch.train.inverse\n"
            "import euclider_tpu_torch.train.fit\n"
            "import euclider_tpu_torch.utils.validate\n"
            "import euclider_tpu_torch.utils.profiling\n"
            "import euclider_tpu_torch.models.camera\n"
            "import euclider_tpu_torch.viewer.simulation\n"
            "import euclider_tpu_torch.viewer.terminal\n"
            "import euclider_tpu_torch.oracle.cpu_oracle\n"
            "bad = [m for m in sys.modules\n"
            "       if m.split('.')[0] in ('jax', 'jaxlib', 'euclider_tpu')]\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_cpu_render_never_touches_the_kernel():
    before = cuda_kernel.LAUNCHES
    static, tables, cam = cpu_scene("config2_mirror_glass")
    img = ett.render_image(static, tables, cam, 8, 16, y0=2, rows=4)
    assert img.shape == (4, 16, 3) and img.device.type == "cpu"
    assert torch.equal(img, trace.render_image(static, tables, cam, 8, 16,
                                               y0=2, rows=4))
    assert cuda_kernel.LAUNCHES == before


def test_render_image_cuda_refuses_cpu_tensors():
    before = cuda_kernel.LAUNCHES
    static, tables, cam = cpu_scene()
    with pytest.raises(ValueError, match="CUDA device"):
        cuda_kernel.render_image_cuda(static, tables, cam, 8, 16)
    assert cuda_kernel.LAUNCHES == before


def test_cli_writes_png(tmp_path):
    out = tmp_path / "frame.png"
    rc = cli.main(["--scene", os.path.join(ROOT, "scenes",
                                           "config1_sphere_room.json"),
                   "--backend", "torch", "--device", "cpu",
                   "--size", "64x48", "--out", str(out)])
    assert rc == 0
    head = out.read_bytes()[:24]
    assert head[:8] == b"\x89PNG\r\n\x1a\n"
    assert (int.from_bytes(head[16:20], "big"),
            int.from_bytes(head[20:24], "big")) == (64, 48)


def test_cli_cuda_backend_without_a_card_is_an_error(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit) as exc:
        cli.main(["--scene", "config1_sphere_room", "--backend", "cuda",
                  "--size", "64x48", "--out", str(tmp_path / "x.png")])
    assert "no CUDA device" in str(exc.value.code)
    assert not (tmp_path / "x.png").exists()
