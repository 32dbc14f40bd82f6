"""Share of the window spent outside the step spans and the benchmark's own
feed: Flor's loop bookkeeping, its ``flor.log`` captures and the controller's
decision at each epoch's end, in percent; traced runs only."""


def read(run):
    if not (run["on_card"] and run["trace"]):
        return None
    rest = run["window_s"] - sum(run["step_spans_s"]) - run["data_s"]
    return 100.0 * rest / run["window_s"]
