"""A cell, a configuration, a traffic mix and a metric added as files and
entries only, in a copy of the benchmark: the harness finds and runs them,
and no file that was there changes."""
import json
import os
import shutil

from benchmark import harness
from benchmark.tests.helpers import bench_files, small_cell

NEW_SCENE = {
    "dim": 3, "name": "one_floor", "ambient": {"type": "vacuum"},
    "camera": {"position": [0, 0, 0, 0], "forward": [0, 0, -1, 0],
               "up": [0, 1, 0, 0], "right": [1, 0, 0, 0], "fov_deg": 60.0},
    "settings": {"max_depth": 1, "t_max": 100.0, "march_steps": 0,
                 "max_nodes": 0, "background": [0.1, 0.2, 0.3]},
    "entities": [
        {"shape": {"type": "sphere", "center": [0, 0, -4, 0], "radius": 1},
         "material": {"type": "vacuum"},
         "surface": {"type": "uniform", "color": [1, 0, 0, 1],
                     "reflectivity": 0.0},
         "name": "ball"}]}


def copy_benchmark(tmp_path):
    root = str(tmp_path)
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), root)
    shutil.copytree(os.path.join(harness.ROOT, "benchmark"),
                    os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    return root


def test_new_cell_config_traffic_and_metric_are_files_only(tmp_path):
    root = copy_benchmark(tmp_path)
    before = bench_files(root)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        spec_before = json.load(f)

    # the additions: one file each, and entries in BENCHMARK.json
    with open(os.path.join(root, "benchmark/configs/one_ball.json"),
              "w") as f:
        json.dump({"name": "one_ball", "source": "a test",
                   "scene": NEW_SCENE}, f)
    traffic = harness.find_cell(spec_before, "view.config5_warp_portal",
                                harness.ROOT)[2]
    with open(os.path.join(root, "benchmark/traffic/view_small.json"),
              "w") as f:
        json.dump(dict(traffic, width=32, height=18, block_rows=18), f)
    with open(os.path.join(root, "benchmark/metrics/frames_seen.py"),
              "w") as f:
        f.write("def read(record):\n"
                "    return record.units if record.kind == 'view' "
                "else None\n")
    spec = dict(spec_before)
    spec["configs"] = spec["configs"] + [{
        "name": "one_ball", "source": "a test", "reduced": [],
        "file": "benchmark/configs/one_ball.json", "why": "a test"}]
    spec["workloads"] = spec["workloads"] + [{
        "name": "view.one_ball", "config": "one_ball",
        "traffic": "view_small", "chips": 1, "why": "a test"}]
    spec["end_to_end"] = [dict(m, workloads=m["workloads"] + ["view.one_ball"])
                          if "workloads" in m and "view.config5_warp_portal"
                          in m["workloads"] else m
                          for m in spec["end_to_end"]]
    spec["end_to_end"].append({
        "name": "frames_seen", "unit": "frames", "better": "higher",
        "bound": 0.25, "source": "host_clock", "workloads": ["view.one_ball"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)

    work, config, traffic = harness.find_cell(spec, "view.one_ball", root)
    assert config["scene"]["name"] == "one_floor"
    assert traffic["width"] == 32
    names = [m["name"] for m in harness.metrics_of(spec, "view.one_ball",
                                                   False)]
    assert {"frames_per_s", "frame_ms_p95", "setup_s",
            "frames_seen"} == set(names)

    cell = small_cell("view.one_ball", root=root)
    record = harness.loop(traffic["kind"]).run(cell)
    assert record.correct
    metrics = harness.read_metrics(
        harness.metrics_of(spec, "view.one_ball", False), record, root)
    assert metrics["frames_seen"]["value"] == record.units >= 1
    assert metrics["frames_per_s"]["value"] > 0

    after = bench_files(root)
    assert {k: v for k, v in after.items() if k in before} == before
    assert set(after) - set(before) == {
        "benchmark/configs/one_ball.json", "benchmark/traffic/view_small.json",
        "benchmark/metrics/frames_seen.py"}


def test_every_named_file_exists(tmp_path):
    spec = harness.load_spec()
    for w in spec["workloads"]:
        harness.find_cell(spec, w["name"])
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert callable(harness.reader(m["name"]))
    for c in spec["configs"]:
        assert os.path.exists(os.path.join(harness.ROOT, c["file"]))
