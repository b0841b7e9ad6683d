"""launches.<kind>: kernels, copies and memsets that ran on the device in
the traced window, a unit (a frame or a step): a count, exact, whatever
the program names its kernels."""


def read(record):
    if record.trace is None or not record.units:
        return None
    return record.trace.launches() / record.units
