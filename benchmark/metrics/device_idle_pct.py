"""device_idle_pct.<kind>: the share of the traced window in which no
kernel, copy or memset ran on the device (the union of the profiler's
device intervals), in %."""


def read(record):
    if record.trace is None:
        return None
    busy, _ = record.trace.busy_gaps()
    return 100.0 * (1.0 - busy / record.trace.window_s)
