"""Log-value serialization: the one place a raw logged value becomes JSON.

``jsonable`` is shared by the synchronous and background log paths (and by
``flor.arg`` persistence), so the two logging modes are bit-identical by
construction. Unknown objects degrade to ``repr(v)`` — but no longer
silently: the first time a log KEY degrades, a :class:`FlorLogValueWarning`
names the offending type, so "why is my metric a string?" is answered at
record time instead of at query time.
"""
from __future__ import annotations

import threading
import warnings

_warned_keys: set = set()
_warned_lock = threading.Lock()


class FlorLogValueWarning(UserWarning):
    """A logged value of an unsupported type was degraded to ``repr(v)``.
    Emitted once per log key (record and replay both): the value still
    lands in the log as a string, but it will not compare numerically in
    the deferred check or pivot as a number in the query surface."""


def reset_warned_keys():
    """Forget which keys already warned (tests)."""
    with _warned_lock:
        _warned_keys.clear()


def jsonable(v, key=None):
    """Lower a logged value to a JSON-encodable one.

    0-d array-likes (torch or numpy scalars) become floats, tensors and
    ndarrays become nested lists, native JSON types pass through (containers may still hold
    array/object leaves — ``json_default`` lowers those at dump time);
    anything else degrades to ``repr(v)`` with a one-time
    :class:`FlorLogValueWarning` per `key`."""
    try:
        import numpy as np
        import torch
        if isinstance(v, torch.Tensor):
            t = v.detach().cpu()
            return float(t.item()) if t.ndim == 0 else t.tolist()
        if hasattr(v, "item") and getattr(v, "ndim", 1) == 0:
            return float(v.item()) if hasattr(v, "dtype") else v
        if isinstance(v, (np.ndarray,)):
            return v.tolist()
        if hasattr(v, "dtype") and getattr(v, "ndim", 0) > 0:
            # other array-likes (incl. ones nested inside logged
            # containers): lower exactly like a top-level array, not to
            # repr
            return np.asarray(v).tolist()
    except Exception:
        pass
    if isinstance(v, (int, float, str, bool, type(None), list, dict)):
        return v
    _warn_degraded(key, v)
    return repr(v)


def json_default(key=None):
    """A ``json.dumps(default=)`` hook lowering non-JSON LEAVES inside
    logged containers (a dict of numpy arrays, a list holding a tensor
    scalar, ...) through the same rules as :func:`jsonable` — instead of
    ``json.dumps`` raising TypeError, which on the background stage would
    surface as a deferred crash at ``close()``. Unknown leaf types degrade
    to ``repr`` with the same one-time warning."""
    def default(o):
        out = jsonable(o, key)
        if out is o:                     # jsonable passed it through as-is:
            _warn_degraded(key, o)       # json couldn't encode it, so lower
            return repr(o)               # to repr (and warn) rather than die
        return out
    return default


def _warn_degraded(key, v):
    if key is None:
        return
    with _warned_lock:
        first = key not in _warned_keys
        _warned_keys.add(key)
    if first:
        warnings.warn(
            f"flor.log({key!r}, ...): value of type "
            f"{type(v).__module__}.{type(v).__qualname__} is not "
            f"JSON-serializable; degrading to repr(). It will compare "
            f"as a string in the deferred check and the query surface.",
            FlorLogValueWarning, stacklevel=3)
