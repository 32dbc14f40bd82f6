"""Cross-run log query surface: the run registry exposed as DATA.

FlorDB (arXiv:2408.02498) treats the accumulated logs of every run sharing
a store as one queryable relation. This module gives that surface to the
library tier:

* ``log_records(path)`` — flat rows across ALL registered runs:
  ``{run_id, parent_run, source, epoch, seq, key, value}`` (source is
  ``record`` or ``replay_p<pid>``; hindsight replay probes appear alongside
  the original record rows).
* ``pivot(path, *keys)`` — one row per (run, epoch) with the requested log
  keys as columns: the "loss across a whole lineage" view.

Two engines serve the same relation:

* the **file scan** — parse every log stream on every call; always correct,
  O(total log bytes) per query;
* the **index** (``repro_torch.querydb``) — the sqlite database the
  background log stage maintains incrementally as segments seal. ``engine="auto"``
  (the default) serves each run from the index exactly when its watermarks
  prove the index covers the run's on-disk streams, and falls back to the
  file scan for that run otherwise — the two paths are bit-identical by
  contract, so callers cannot tell which one answered. ``engine="files"``
  forces the scan; ``engine="index"`` demands the index and raises on any
  run it cannot serve (tests and benchmarks pin the path this way).

``lineage=<run_id>`` restricts a query to that run's ancestor chain — a
recursive CTE over the indexed ``runs`` mirror, or an equivalent
parent-link walk on fallback. ``where=``/``limit=``/``tail=`` push into SQL
when the index serves, and are applied post-hoc on the scan.

``path`` is a shared store root, a run dir carrying ``flor.run.json`` (the
binding is followed to its store), or a bare legacy run dir (queried as a
single pseudo-run). The CLI lives in ``repro_torch.launch.runs``
(``python -m repro_torch.launch.runs logs|pivot|reindex``).
"""
from __future__ import annotations

import json
import os
from typing import Optional, Sequence, Union

from repro_torch.checkpoint.lineage import (RunRegistry, read_run_meta,
                                            registry_dirsig)
from repro_torch.logging import FingerprintLog

# where= columns grouped by how each engine applies them: per-run/stream
# constants short-circuit before any rows are read; row columns push into
# SQL (or filter inline on the scan); everything else — "value" — is
# filtered post-hoc on the built rows, identically in both engines
_CONST_COLS = ("run_id", "parent_run", "source")
_ROW_COLS = ("epoch", "seq", "key", "step")


def resolve_store_root(path: str) -> str:
    """Accept a store root directly, or a run dir carrying flor.run.json
    (follow the binding), or a legacy run dir with a private ./store."""
    meta = read_run_meta(path)
    if meta.get("store_root"):
        return meta["store_root"]
    if os.path.isdir(os.path.join(path, "store")) \
            and not os.path.isdir(os.path.join(path, "manifests")):
        return os.path.join(path, "store")
    return path


def _registered_runs(path: str) -> list[dict]:
    """[{run_id, parent, run_dir}] for every run reachable from `path`, in
    registry (creation) order; falls back to `path` itself as a single
    pseudo-run when no registry exists (pre-lineage run dirs). This is the
    JSON-scanning listing — ``_runs_listing`` routes around it through the
    indexed ``runs`` mirror when that mirror is provably current."""
    root = resolve_store_root(path)
    runs = []
    if os.path.isdir(os.path.join(root, "runs")):
        runs = [r for r in RunRegistry(root).list_runs()]
    if not runs and os.path.isdir(os.path.join(path, "logs")):
        meta = read_run_meta(path)
        runs = [{"run_id": meta.get("run_id")
                 or os.path.basename(os.path.abspath(path)),
                 "parent": meta.get("parent_run"),
                 "namespace": meta.get("namespace"),
                 "run_dir": os.path.abspath(path)}]
    return runs


def _runs_listing(path: str, root: str, idx) -> tuple[list[dict], bool]:
    """(runs listing, served-from-index) — preferring the indexed mirror:
    when the registry directory's signature matches the one the mirror was
    synced under, the listing is one SELECT instead of one JSON parse per
    registered run. Pseudo-run stores (no registered runs) never route
    through the mirror — their listing depends on which path the caller
    queried from."""
    if idx is not None:
        sig = registry_dirsig(root)
        if sig is not None and sig[1] > 0:
            listing = idx.runs_listing(sig)
            if listing is not None:
                return listing, True
    return _registered_runs(path), False


def _ancestors(listing: list[dict], run_id: str) -> set:
    """Run ids on ``run_id``'s ancestor chain (inclusive), walking parent
    links through `listing` — cycle-safe, stops at the first unlisted
    ancestor. Mirrors both ``RunRegistry.ancestry`` and the index's
    recursive CTE, so lineage filters agree across engines."""
    by_id = {r.get("run_id"): r for r in listing}
    chain = set()
    cur = run_id
    while cur is not None and cur not in chain:
        chain.add(cur)
        rec = by_id.get(cur)
        if rec is None:
            break
        cur = rec.get("parent")
    return chain


def _run_log_files(run_dir: Optional[str],
                   include_replay: bool) -> list[tuple[str, str]]:
    """[(source, path)] of the fingerprint log STREAMS a run dir holds. A
    stream path may be a flat file or a background-writer segment dir at
    the same name (repro_torch.logging) — ``FingerprintLog.read``
    dispatches, so this listing treats them uniformly. Both engines select streams from
    THIS disk enumeration: index rows for a stream that no longer exists on
    disk are unreachable, not wrong answers."""
    if not run_dir:
        return []
    d = os.path.join(run_dir, "logs")
    if not os.path.isdir(d):
        return []
    out = [("record", os.path.join(d, "record.jsonl"))]
    if include_replay:
        for fn in sorted(os.listdir(d)):
            if fn.startswith("replay_") and fn.endswith(".jsonl"):
                out.append((fn[: -len(".jsonl")], os.path.join(d, fn)))
    return [(src, p) for src, p in out if os.path.exists(p)]


def _is_spill_ref(value) -> bool:
    """A large-value pointer row written by the background log's spill path
    (repro_torch.logging): {"ref": "logref__<stream>__<seq>", dtype, shape,
    nbytes, digest}."""
    return (isinstance(value, dict)
            and str(value.get("ref", "")).startswith("logref__")
            and "nbytes" in value)


def _inline_spill(value: dict, rec: dict, path: str, cache: dict):
    """Materialize one spilled value back from the checkpoint store (the
    inverse of FingerprintLog._spill_value), JSON-lowered like a never-
    spilled row would have been. Best-effort: a missing ref (gc'd store,
    detached run dir) leaves the pointer row untouched."""
    from repro_torch.checkpoint.store import CheckpointStore
    from repro_torch.logging import jsonable
    try:
        root = resolve_store_root(rec.get("run_dir") or path)
        store = cache.get(root)
        if store is None:
            store = cache[root] = CheckpointStore(root)
        # spills live in the run's manifest namespace; "::" pins the flat
        # namespace for legacy private stores
        qual = f"{rec.get('namespace') or ''}::{value['ref']}"
        arr = store.get_tree(qual)["['v']"]
        return jsonable(arr, value["ref"])
    except Exception:
        return value


def _open_engine(path: str, engine: str):
    """(store_root, LogIndex-or-None) for a query. ``engine="files"`` never
    opens the index; ``engine="index"`` requires one to exist."""
    if engine not in ("auto", "files", "index"):
        raise ValueError(f"engine must be auto|files|index, got {engine!r}")
    root = resolve_store_root(path)
    if engine == "files":
        return root, None
    from repro_torch.querydb import open_index
    idx = open_index(root)
    if engine == "index" and idx is None:
        raise RuntimeError(f"engine='index' but no query index exists under "
                           f"{root!r} — run flor.reindex() first")
    return root, idx


def log_records(path: str, run: Optional[str] = None,
                key: Union[str, Sequence[str], None] = None,
                include_replay: bool = True,
                inline_spill_bytes: int = 0, *,
                lineage: Optional[str] = None,
                where: Optional[dict] = None,
                limit: Optional[int] = None,
                tail: Optional[int] = None,
                engine: str = "auto") -> list[dict]:
    """Every logged value across every run registered under `path`, as flat
    row dicts tagged with the run lineage.

    Filters compose and behave identically whichever engine serves:

    * ``run=`` — one run id; ``key=`` — one log key or a sequence of keys.
    * ``lineage=`` — restrict to the ancestor chain (inclusive) of a run.
    * ``where=`` — {column: value} equality over row fields (``run_id``,
      ``parent_run``, ``source``, ``epoch``, ``seq``, ``key``, ``value``).
    * ``limit=`` — at most N rows (in global row order); ``tail=`` — the
      LAST N rows after all other filters (both given: limit first).

    ``inline_spill_bytes`` re-inlines spilled large values: a pointer row
    whose recorded ``nbytes`` is at or below the threshold is resolved from
    the checkpoint store and returned as the actual value (as if it had
    never spilled); larger spills keep their pointer dict. 0 (default)
    leaves every pointer untouched. Resolution runs AFTER filtering, so the
    store is touched only for rows the query actually returns.

    ``engine`` selects the serving path (see module docstring)."""
    keys = None
    if key is not None:
        keys = (key,) if isinstance(key, str) else tuple(key)
    where = dict(where or {})
    const_where = {c: where.pop(c) for c in _CONST_COLS if c in where}
    row_where = {c: where.pop(c) for c in _ROW_COLS if c in where}
    post_where = where                      # whatever remains (e.g. value)
    # limit can stop the scan early only when nothing downstream of it
    # still needs to see (or drop) rows
    eager_limit = limit if (tail is None and not post_where) else None

    root, idx = _open_engine(path, engine)
    try:
        listing, runs_from_idx = _runs_listing(path, root, idx)
        anc = None
        if lineage is not None:
            # same chain either way — the CTE walks the same parent links
            # the Python fallback does, just inside sqlite
            anc = idx.ancestry_ids(lineage) if runs_from_idx \
                else _ancestors(listing, lineage)
        rows: list[dict] = []
        done = False
        for rec in listing:
            rid = rec.get("run_id")
            if run is not None and rid != run:
                continue
            if anc is not None and rid not in anc:
                continue
            if "run_id" in const_where and const_where["run_id"] != rid:
                continue
            if "parent_run" in const_where \
                    and const_where["parent_run"] != rec.get("parent"):
                continue
            streams = _run_log_files(rec.get("run_dir"), include_replay)
            if "source" in const_where:
                streams = [(s, p) for s, p in streams
                           if s == const_where["source"]]
            use_idx = idx is not None and idx.covers(rid, streams)
            if engine == "index" and not use_idx:
                raise RuntimeError(
                    f"engine='index' but the index does not cover run "
                    f"{rid!r} (stale or never-indexed stream) — run "
                    f"flor.reindex() to catch up")
            for source, lp in streams:
                if use_idx:
                    remaining = None if eager_limit is None \
                        else eager_limit - len(rows)
                    rows.extend(idx.select_rows(
                        rid, rec.get("parent"), source, keys=keys,
                        where=row_where, limit=remaining))
                else:
                    for r in FingerprintLog.read(lp):
                        if keys is not None and r.get("key") not in keys:
                            continue
                        if any(r.get(c) != v for c, v in row_where.items()):
                            continue
                        rows.append({"run_id": rid,
                                     "parent_run": rec.get("parent"),
                                     "source": source,
                                     "epoch": r.get("epoch"),
                                     "seq": r.get("seq"),
                                     "key": r.get("key"),
                                     "value": r.get("value")})
                        if eager_limit is not None \
                                and len(rows) >= eager_limit:
                            break
                if eager_limit is not None and len(rows) >= eager_limit:
                    done = True
                    break
            if done:
                break
    finally:
        if idx is not None:
            idx.close()

    if post_where:
        rows = [r for r in rows
                if all(r.get(c) == v for c, v in post_where.items())]
    if limit is not None:
        rows = rows[:limit]
    if tail is not None:
        rows = rows[-tail:] if tail > 0 else []
    if inline_spill_bytes:
        cache: dict = {}
        by_id = {r.get("run_id"): r for r in listing}
        for row in rows:
            v = row["value"]
            if _is_spill_ref(v) and int(v["nbytes"]) <= inline_spill_bytes:
                row["value"] = _inline_spill(v, by_id.get(row["run_id"], {}),
                                             path, cache)
    return rows


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


def pivot(path: str, *keys: str, run: Optional[str] = None,
          include_replay: bool = True,
          inline_spill_bytes: int = 0,
          lineage: Optional[str] = None,
          engine: str = "auto") -> list[dict]:
    """One row per (run, epoch) with log keys as columns, across the whole
    lineage: ``[{run_id, parent_run, epoch, <key>: value, ...}, ...]``.
    With no explicit `keys`, every observed key becomes a column. The LAST
    logged occurrence in an epoch wins (replay attempts, logging after
    record, override earlier values — hindsight refines the log).
    ``lineage=<run_id>`` restricts the aggregation to that run's ancestor
    chain; ``inline_spill_bytes`` resolves small spilled values like
    :func:`log_records` does; ``engine`` selects the serving path. When
    explicit `keys` are given and the index serves, only matching rows are
    ever parsed — the key filter pushes into SQL."""
    rows = log_records(path, run=run, key=(keys or None),
                       include_replay=include_replay,
                       inline_spill_bytes=inline_spill_bytes,
                       lineage=lineage, engine=engine)
    want = list(keys)
    if not want:
        seen = []
        for r in rows:
            if r["key"] not in seen:
                seen.append(r["key"])
        want = seen
    order: list[tuple] = []
    cells: dict[tuple, dict] = {}
    for r in rows:
        if r["key"] not in want:
            continue
        g = (r["run_id"], r["epoch"])
        if g not in cells:
            order.append(g)
            cells[g] = {"run_id": r["run_id"], "parent_run": r["parent_run"],
                        "epoch": r["epoch"]}
        cells[g][r["key"]] = r["value"]
    return [cells[g] for g in order]
