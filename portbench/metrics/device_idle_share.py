"""Share of the profiled epoch in which no operation ran on the card, in
percent; traced runs only."""


def read(run):
    prof = run["profile"]
    if not prof:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
