"""The window's peak of allocated device memory
(``torch.cuda.max_memory_allocated`` after a reset at its start), in GB;
traced runs only."""


def read(run):
    if not (run["on_card"] and run["trace"]):
        return None
    return run["window_peak_bytes"] / 1e9
