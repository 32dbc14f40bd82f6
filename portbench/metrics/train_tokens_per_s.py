"""Tokens of every step of the window over the window's whole length (host
clock, the window ending when its last step has returned)."""


def read(run):
    if not run["on_card"] or run["trace"]:
        return None
    return run["window_tokens"] / run["window_s"]
