"""The check decides ``correct``: sound runs pass it, and its control
(the reference computed in bfloat16 in the program's place) and each
fault planted under the timed path fail it.  The harness's look for a
card is skipped: the program's plain version runs on the CPU."""
import pytest

from benchmark import faults, harness
from benchmark.loops import view
from benchmark.tests.helpers import small_cell

CELLS = tuple(w["name"] for w in harness.load_spec()["workloads"])


def limits(cell):
    return cell.traffic["limits"]


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload):
    cell = small_cell(workload, seconds=0.3)
    record = harness.loop(cell.traffic["kind"]).run(cell)
    assert record.correct, record.checks
    assert record.units >= 1 and record.failed == 0


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(workload):
    cell = small_cell(workload)
    got = harness.loop(cell.traffic["kind"]).control(cell)
    over = [k for k, lim in limits(cell).items() if got[k] > lim]
    assert over, got


@pytest.mark.parametrize("workload,fault", [
    (w, f) for w in CELLS for f in faults.VIEW])
def test_fault_is_not_correct(workload, fault):
    cell = small_cell(workload, seconds=0.3)
    with faults.planted(fault, cell.traffic["kind"]):
        record = harness.loop(cell.traffic["kind"]).run(cell)
    assert not record.correct, record.checks
    assert record.failed >= 1


def test_traced_view_checks_its_frames():
    """A traced run measures a shorter window: its checked frames are
    drawn inside it all the same."""
    cell = small_cell("view.config5_warp_portal", seconds=51.0, trace=True)
    cell.traffic["count_poses"] = 2
    record = harness.loop("view").run(cell)
    assert record.correct, record.checks
    assert record.notes["checked"] == cell.traffic["check_frames"]
    assert record.window_s < 10 and record.bound_ms > 0


def test_checked_frames_take_both_buffers():
    """The j-th checked frame has the parity of j: the viewer's two pinned
    buffers in turn."""
    assert view.takes(0, 600) and not view.takes(0, 601)
    assert view.takes(1, 7) and not view.takes(1, 8)
    assert view.takes(2, 8) and not view.takes(3, 8)
    cell = small_cell("view.config5_warp_portal", seconds=3.0)
    cell.traffic["check_frames"] = 2
    record = harness.loop("view").run(cell)
    assert record.correct, record.checks
    assert [n % 2 for n in record.notes["frames"]] == [0, 1]
