"""host_busy_ms.<kind>: host milliseconds a unit (a frame or a step) in
which the loop's thread was not waiting for the device: the traced window
less that thread's time in the runtime's synchronising calls
(cudaEventSynchronize, cudaStreamSynchronize, cudaDeviceSynchronize),
over the units."""


def read(record):
    if record.trace is None or not record.units:
        return None
    t = record.trace
    return (t.window_s - t.sync_s()) / record.units * 1e3
