"""roofline_pct.<kind>: the least time of a unit's work on the H100
(benchmark/roofline.py: FP32 operations over 67 TFLOP/s or bytes over
3.35 TB/s, whichever is larger) over the device time of all the kernels
the window's units ran, whatever their names (copies left out), in %.
The loop counts the work on the reference's own render (a view cell: the
traffic's ``count_poses`` frames evenly spaced around the orbit, the same
poses for every seed).  Nothing where the trace holds no kernel."""


def read(record):
    if record.trace is None or not record.units or record.bound_ms is None:
        return None
    kernel_s = record.trace.kernel_s()
    if kernel_s <= 0:
        return None
    return 100.0 * record.bound_ms * 1e-3 / (kernel_s / record.units)
