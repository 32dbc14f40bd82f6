"""Replay-log merge of the cross-run log query surface.

``merge_replay_logs`` merges the per-worker logs of a planned replay into
one canonical log, by plan segment, for the deferred correctness check.
The rest of the reference package's query surface (``log_records``,
``pivot``, the sqlite index) is a later slice of this package.
"""
from __future__ import annotations

import json
import os
from typing import Optional

from repro_torch.logging import FingerprintLog


MERGED_LOG = "merged_replay.jsonl"     # NOT "replay_*": run_logs must skip it


def merge_replay_logs(run_dir: str, owners: list,
                      out_path: Optional[str] = None) -> list[dict]:
    """Merge per-worker replay logs by PLAN SEGMENT into one canonical log.

    `owners` is ``[(source, [epoch, ...]), ...]`` — for each worker log
    (source is the log-file stem, e.g. ``replay_p3``) the work epochs that
    worker OWNS under the plan's assignment. For every owned epoch, exactly
    the owner's rows are taken (in their original order); rows a worker
    emitted while INIT-visiting someone else's epoch — and rows from a
    cancelled straggler duplicate — are dropped. Epochs are emitted in
    global order and ``seq`` is renumbered, so a multi-worker merge is
    bit-identical to a single-worker replay of the same plan.

    Writes ``<run_dir>/logs/merged_replay.jsonl`` when `out_path` is True-ish
    (default path) or a string path; returns the merged rows either way."""
    logs_dir = os.path.join(run_dir, "logs")
    rows_by_source: dict[str, dict] = {}
    for source, _epochs in owners:
        by_epoch: dict = {}
        for r in FingerprintLog.read(os.path.join(logs_dir,
                                                  source + ".jsonl")):
            by_epoch.setdefault(r.get("epoch"), []).append(r)
        rows_by_source[source] = by_epoch
    owner_of: dict = {}
    for source, epochs in owners:
        for e in epochs:
            owner_of[e] = source
    merged: list[dict] = []
    for e in sorted(owner_of):
        source = owner_of[e]
        for r in rows_by_source.get(source, {}).get(e, []):
            merged.append({"epoch": r.get("epoch"), "seq": len(merged),
                           "key": r.get("key"), "value": r.get("value")})
    if out_path:
        path = out_path if isinstance(out_path, str) \
            else os.path.join(logs_dir, MERGED_LOG)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            for r in merged:
                f.write(json.dumps(r) + "\n")
    return merged
