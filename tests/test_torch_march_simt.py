"""euclider_tpu_torch/tools/march_simt.py: the march's SIMT efficiency under
a warp tile, on hand-made counts of live steps, and the counts of the plain
render on config5 at a small size."""
import numpy as np
import pytest
import torch

import euclider_tpu_torch as ett
from euclider_tpu_torch.tools import march_simt as MS


def test_efficiency_of_hand_made_counts():
    """A column of 4 pixels marching 8 steps each: four 32 x 1 warps step
    one lane in 32, one 8 x 4 warp four lanes in 32.  Two lanes marching 4
    steps in different trips: the trips take 8 warp steps, the trees 4.
    A 20-pixel row, each pixel one step: its warp is padded to 32 lanes.
    A frame that does not march: 1.  A tile of other than 32 lanes: an
    error."""
    col = np.zeros((1, 4, 32), np.int32)
    col[0, :, 0] = 8
    assert MS.efficiency(col, (32, 1)) == pytest.approx(1 / 32)
    assert MS.efficiency(col, (8, 4)) == pytest.approx(1 / 8)
    assert MS.efficiency(col, (4, 8)) == pytest.approx(4 * 8 / (32 * 8))
    trips = np.zeros((2, 1, 32), np.int32)
    trips[0, 0, 0] = trips[1, 0, 1] = 4
    assert MS.efficiency(trips, (32, 1)) == pytest.approx(1 / 32)
    assert MS.efficiency(trips.sum(axis=0), (32, 1)) == pytest.approx(1 / 16)
    assert MS.efficiency(np.ones((1, 20), np.int32), (32, 1)) == \
        pytest.approx(20 / 32)
    assert MS.efficiency(np.zeros((3, 8, 8), np.int32), (8, 4)) == 1.0
    with pytest.raises(ValueError, match="32 lanes"):
        MS.efficiency(col, (8, 8))


def test_steps_by_trip_counts_the_plain_march():
    """config5 at 18 x 32: one count a trip that marches, every pixel's
    live steps at most march_steps a trip, some pixels marching,
    efficiencies in (0, 1]."""
    sc = ett.get_scene("config5_warp_portal")
    static, t = ett.compile_scene(sc)
    cpu = torch.device("cpu")
    tables = ett.tables_to_torch(t, cpu)
    cam = ett.camera_to_torch(ett.compile_camera(sc.camera), cpu)
    counts = MS.steps_by_trip(static, tables, cam, 18, 32)
    assert counts.ndim == 3 and counts.shape[1:] == (18, 32)
    assert 1 <= counts.shape[0] <= static.max_nodes
    assert counts.min() >= 0 and counts.max() <= static.march_steps
    assert counts.sum() > 0
    for tile in MS.TILES:
        assert 0.0 < MS.efficiency(counts, tile) <= 1.0
