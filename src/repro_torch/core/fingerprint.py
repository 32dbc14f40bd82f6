"""Deferred correctness checks (paper section 5.2.2).

The side-effect analysis is deliberately unsafe (fast record beats strict
guarantees); instead, user-observable metrics logged during record form a
fingerprint that replay must reproduce. After replay we diff the two logs:
any divergence other than hindsight additions is flagged as an anomaly.
"""
from __future__ import annotations

import math
import os
from dataclasses import dataclass, field

from repro_torch.logging import FingerprintLog


@dataclass
class CheckResult:
    ok: bool
    anomalies: list = field(default_factory=list)
    compared: int = 0
    hindsight_only: int = 0


def _index(records):
    """(epoch, key, occurrence) -> value."""
    idx = {}
    counts = {}
    for r in records:
        k = (r["epoch"], r["key"])
        occ = counts.get(k, 0)
        counts[k] = occ + 1
        idx[(r["epoch"], r["key"], occ)] = r["value"]
    return idx


def _close(a, b, rtol=1e-4, atol=1e-6):
    if isinstance(a, (int, float)) and isinstance(b, (int, float)):
        if math.isnan(a) and math.isnan(b):
            return True
        return abs(a - b) <= atol + rtol * max(abs(a), abs(b))
    if isinstance(a, dict) and isinstance(b, dict) \
            and "ref" in a and "digest" in a \
            and "ref" in b and "digest" in b:
        # large-value SPILL rows (repro_torch.logging): record and replay store
        # under different stream-derived keys by construction, so the
        # pointer can never match — fidelity means same bytes, compared by
        # content digest + structure. Requiring BOTH marker fields keeps
        # user-logged dicts that merely contain a "ref" key on the plain
        # equality path.
        return (a["digest"], a.get("dtype"), a.get("shape"),
                a.get("nbytes")) == \
               (b["digest"], b.get("dtype"), b.get("shape"),
                b.get("nbytes"))
    return a == b


def deferred_check(record_log_path: str, replay_log_paths: list,
                   replayed_epochs: list[int] | None = None,
                   rtol: float = 1e-4) -> CheckResult:
    """`replay_log_paths` entries may be file paths OR already-loaded row
    dicts — the planned-replay launcher feeds the MERGED per-segment rows
    (core/query.merge_replay_logs) instead of raw per-worker files, so
    straggler duplicates and init-phase re-logs never skew occurrence
    counting."""
    rec = _index(FingerprintLog.read(record_log_path))
    rep_records = []
    for p in replay_log_paths:
        if isinstance(p, str):
            rep_records.extend(FingerprintLog.read(p))
        else:
            rep_records.append(p)
    rep = _index(rep_records)

    res = CheckResult(ok=True)
    epochs = set(replayed_epochs) if replayed_epochs is not None else None
    for k, v_rep in rep.items():
        epoch, key, occ = k
        if epochs is not None and epoch not in epochs:
            continue
        if k not in rec:
            res.hindsight_only += 1       # a hindsight probe — expected
            continue
        res.compared += 1
        if not _close(rec[k], v_rep, rtol=rtol):
            res.ok = False
            res.anomalies.append({"epoch": epoch, "key": key, "occ": occ,
                                  "record": rec[k], "replay": v_rep})
    # record entries missing from replay are anomalies only for epochs the
    # replay actually re-executed. A skipped epoch may still emit
    # hindsight-only probes (outer-loop logging over restored state), so
    # "re-executed" means: replay reproduced at least one key that the
    # record log also has for that epoch.
    rec_keys_by_epoch: dict = {}
    for (epoch, key, _occ) in rec:
        rec_keys_by_epoch.setdefault(epoch, set()).add(key)
    replay_epochs_seen = {
        k[0] for k in rep
        if k[1] in rec_keys_by_epoch.get(k[0], ())}
    for k, v_rec in rec.items():
        epoch, key, occ = k
        if epoch not in replay_epochs_seen:
            continue
        if epochs is not None and epoch not in epochs:
            continue
        if k not in rep:
            res.ok = False
            res.anomalies.append({"epoch": epoch, "key": key, "occ": occ,
                                  "record": v_rec, "replay": None})
    return res


def run_logs(run_dir: str) -> tuple[str, list[str]]:
    """(record stream, [replay streams]) of a run dir. Paths are stream
    ids — flat files or background-writer segment dirs at the same name —
    readable by ``FingerprintLog.read`` either way."""
    d = os.path.join(run_dir, "logs")
    record = os.path.join(d, "record.jsonl")
    replays = sorted(os.path.join(d, f) for f in os.listdir(d)
                     if f.startswith("replay_"))
    return record, replays
