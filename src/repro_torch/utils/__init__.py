"""Shared utilities: pytree helpers, timing, formatting."""
from repro_torch.utils.pytree import (path_str, tree_allclose, tree_bytes,
                                     tree_leaves_with_paths, tree_size)
from repro_torch.utils.timing import EMA, span

__all__ = ["tree_bytes", "tree_leaves_with_paths", "path_str",
           "tree_allclose", "tree_size", "span", "EMA", "fmt_bytes"]


def fmt_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024.0:
            return f"{n:.2f}{unit}"
        n /= 1024.0
    return f"{n:.2f}PiB"
