"""What a run loads: never JAX or the JAX package, compared by whole
top-level names; and the reference loads nothing of the program."""
import subprocess
import sys

from benchmark import harness

RUN_A_CELL = """
import sys, time
from benchmark import harness
from benchmark.tests.helpers import small_cell
for w in [w["name"] for w in harness.load_spec()["workloads"]]:
    cell = small_cell(w, seconds=0.05)
    harness.loop(cell.traffic["kind"]).run(cell)
print(",".join(sorted({m.split(".")[0] for m in sys.modules})))
"""

REFERENCE_ALONE = """
import json, sys
from benchmark import roofline
from benchmark.reference import camera, render
spec = json.load(open("BENCHMARK.json"))
cfg = json.load(open(spec["configs"][0]["file"]))
static, tables, cam = render.load(cfg["scene"])
t, c = render.to_device(tables, camera.orbit(cam, (0, 0, -4), 0.5), "cpu")
counts = render.Counts(static, "cpu")
render.render(static, t, c, 6, 8, 3, counts)
roofline.bound(static, 1, False, pixels=48)
print(",".join(sorted({m.split(".")[0] for m in sys.modules})))
"""


def loaded(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(out.stdout.strip().splitlines()[-1].split(","))


def test_a_run_loads_no_jax():
    top = loaded(RUN_A_CELL)
    assert "euclider_tpu_torch" in top          # the program ran
    assert not top & set(harness.FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    top = loaded(REFERENCE_ALONE)
    assert not top & {"euclider_tpu_torch", "euclider_tpu", "jax"}


def test_forbidden_is_whole_names(monkeypatch):
    for name in ("euclider_tpu_torch", "euclider_tpu_torch.ops",
                 "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "euclider_tpu.scene", sys)
    monkeypatch.setitem(sys.modules, "jax", sys)
    assert harness.forbidden_modules() == ["euclider_tpu.scene", "jax"]
