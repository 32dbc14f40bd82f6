"""Useful FLOPs of the profiled epoch's steps (``flops.step_flops``) over
the length of that epoch on the profiler's timeline times the card's dense
bf16 peak, in percent; traced runs only."""


def read(run):
    prof = run["profile"]
    if not (prof and run["peak_flops"]):
        return None
    return 100.0 * run["step_flops"] * run["profiled_steps"] \
        / (prof["window_s"] * run["peak_flops"])
