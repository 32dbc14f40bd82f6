"""Shared utilities: pytree helpers, timing, formatting."""
from repro_torch.utils.pytree import tree_bytes, tree_leaves_with_paths
from repro_torch.utils.timing import EMA, Stopwatch

__all__ = ["tree_bytes", "tree_leaves_with_paths", "Stopwatch", "EMA",
           "fmt_bytes"]


def fmt_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024.0:
            return f"{n:.2f}{unit}"
        n /= 1024.0
    return f"{n:.2f}PiB"
