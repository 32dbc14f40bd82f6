"""The numbers behind ``correct`` and their judgement against a cell's
limits (``limits/<cell>.json``: {number: limit}).

From the first steps, which set-up drives through the window's own call
and feed and which the reference follows from the same weights and ids
(and, in a sparse model, the program's own choices of experts):

* ``loss_gap``: the largest |program - reference| / |reference| of a
  step's loss;
* ``grad_gap``: over the leaves, the largest gap between the program's and
  the reference's norm of the first step's clipped gradient (the program's
  worked out from its first moment after one step, as AdamW got it),
  over the larger of the reference leaf's norm and the median leaf's;
* ``change_gap``: the same of each leaf's change over the steps, leaving
  out leaves whose reference gradient is under a thousandth of the median
  leaf's (they move by round-off alone);
* ``drop_gap`` (a sparse model): the largest absolute gap of a step's
  share of the choices dropped past capacity;
* ``route_gap`` (a sparse model): the largest over steps of the
  reference's route gap (``reference.model.moe``): where the program's
  choices, which the reference follows, fall short of the reference's own
  top k in the reference's probabilities;
* ``route_miss_share`` (a sparse model): the largest over steps and layers
  of the share of tokens whose choices are not the reference's own top k
  as a set: near ties that the program's rounding flips, which a sound
  run keeps to a small share and a bias in choosing would not;
* ``route_mismatch`` (a sparse model, from the program's run): the
  recomputed layers whose choices differ from their forward's
  (``harness.RouteCapture``).

From the whole run: ``log_mismatch``, the logged rows that differ from the
values the steps returned (or are missing or extra); ``ckpt_mismatch``, the
materialized checkpoints that the plain reader cannot read back, whose
chunks do not hash to their names, or (the last epoch's) whose bytes differ
from the final state's.
"""
from __future__ import annotations

import fnmatch
import statistics

import numpy as np

from portbench.reference.store_reader import StoreReader, itemsize, values

QUIET_GRAD = 1e-3


def leaf_gaps(prog: dict, ref: dict) -> dict:
    """Each leaf's gap of its first-gradient norm ("grad") and of its
    change ("change"), over the larger of the reference leaf's value and
    the median leaf's."""
    out = {}
    for key in ("grad", "change"):
        med = statistics.median(ref[key].values())
        out[key] = {p: abs(prog[key][p] - r) / max(r, med, 1e-30)
                    for p, r in ref[key].items()}
    return out


def numbers(prog: dict, ref: dict) -> dict:
    gaps = leaf_gaps(prog, ref)
    med = statistics.median(ref["grad"].values())
    moving = [p for p, g in ref["grad"].items() if g >= QUIET_GRAD * med]
    out = {
        "loss_gap": max(abs(a - b) / abs(b)
                        for a, b in zip(prog["loss"], ref["loss"])),
        "grad_gap": max(gaps["grad"].values()),
        "change_gap": max(gaps["change"][p] for p in moving),
    }
    if ref["dropped"][0] is not None:
        out["drop_gap"] = max(abs(a - b) for a, b in zip(prog["dropped"],
                                                         ref["dropped"]))
        out["route_gap"] = max(ref["route_gap"])
        out["route_miss_share"] = max(ref["route_miss"])
        if "route_mismatch" in prog:
            out["route_mismatch"] = prog["route_mismatch"]
    return out


def log_mismatch(rows: list, values: list, keys) -> int:
    """Rows of the log that differ from the steps' values, in order."""
    want = [(k, v[k]) for v in values for k in keys if k in v]
    got = [(r["key"], r["value"]) for r in sorted(rows,
                                                  key=lambda r: r["seq"])]
    bad = sum(1 for a, b in zip(want, got) if a != b)
    return bad + abs(len(want) - len(got))


def check_checkpoints(store_root: str, final: dict | None, last_epoch: int,
                      bounds: dict | None = None) -> tuple[int, int]:
    """(bad checkpoints, checkpoints) of the run's store. The last epoch's
    checkpoint equals the final state byte for byte, but for leaves stored
    lossy, which hold within the mix's declared error bound of their slot."""
    reader = StoreReader(store_root)
    keys = reader.keys()
    bad = 0
    for key in keys:
        try:
            tree = reader.read_tree(key)
        except (OSError, ValueError, KeyError) as e:
            print(f"checkpoint {key}: {e}")
            bad += 1
            continue
        if final is None:
            continue
        ok = set(tree) == set(final) and all(
            a.size == len(final[p]) == itemsize(dt) * _prod(shape)
            for p, (a, dt, shape, _) in tree.items())
        if ok and key == f"train_at_{last_epoch}.0":
            ok = all(_leaf_ok(p, a, dt, lossy, final[p], bounds or {})
                     for p, (a, dt, _, lossy) in tree.items())
        bad += not ok
    return bad, len(keys)


def _leaf_ok(path, got, dtype, lossy, want: bytes, bounds: dict) -> bool:
    if not lossy:
        return got.tobytes() == want
    atol = next((a for pat, a in bounds.items()
                 if f"['{pat}']" in path or f".{pat}" in path
                 or fnmatch.fnmatch(path, pat)), None)
    if atol is None:
        return False
    diff = values(got, dtype) - values(np.frombuffer(want, np.uint8), dtype)
    return bool(np.abs(diff).max(initial=0.0) <= atol)


def _prod(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def judge(nums: dict, limits: dict) -> dict:
    """Every number the limits name, beside its limit; correct when each
    is present and within it."""
    checks = {k: {"value": nums.get(k), "limit": lim}
              for k, lim in limits.items()}
    ok = all(c["value"] is not None and c["value"] <= c["limit"]
             for c in checks.values())
    return {"correct": ok, "checks": checks}
