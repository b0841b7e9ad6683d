"""setup_s: seconds from the start of the process to the first timed
frame or step: the program's import, the scene, the kernels' build (on a
checkout's first run) or their load, the inputs and the warm-up."""


def read(record):
    return record.setup_s
