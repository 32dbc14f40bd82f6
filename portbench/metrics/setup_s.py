"""Process start to the window's start: importing, the kernels' build or
load, the weights, the session and its store calibration, the first
epoch."""


def read(run):
    return run["setup_s"] if run["on_card"] else None
