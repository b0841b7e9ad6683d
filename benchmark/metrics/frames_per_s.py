"""frames_per_s: frames that reached the host in the window, over the
window's host seconds."""


def read(record):
    return record.units / record.window_s
