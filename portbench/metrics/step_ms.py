"""Median of the window's step spans (a call of the program's train step
ended by a synchronize), in milliseconds; traced runs only."""
import statistics


def read(run):
    if not (run["on_card"] and run["trace"] and run["step_spans_s"]):
        return None
    return statistics.median(run["step_spans_s"]) * 1e3
