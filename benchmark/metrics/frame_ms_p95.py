"""frame_ms_p95: the 95th percentile, over every frame of the window, of
the host time of one ``Simulation.step``: the gap between frames that a
viewer sees."""
import numpy as np


def read(record):
    return float(np.percentile(np.asarray(record.unit_times) * 1e3, 95))
