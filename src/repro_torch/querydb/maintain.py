"""Incremental maintenance of the log index.

Two feeders keep ``<store_root>/index/flor.db`` current:

* :class:`SegmentIndexer` — the LIVE feeder. FlorContext hands its
  ``on_seal`` to the run's :class:`~repro_torch.logging.stream.FingerprintLog`;
  the background log stage (or the closing thread) calls it the moment a
  segment seals, and the segment's rows land in sqlite while the training
  loop keeps stepping. Ingest wall time is reported to ``on_overhead``
  (``AdaptiveController.observe_logging``), so index upkeep draws from the
  same epsilon budget as the logging work it rides behind. Every failure
  degrades silently: the index is a cache, the segment files are the truth,
  and a broken index must never break training.

* :func:`reindex` — the CATCH-UP feeder. Walks every registered run's log
  streams and ingests exactly what the watermarks say is missing: sealed
  segments never seen, unsealed tails / flat files whose byte size moved,
  watermarks whose segment vanished from disk (a rotated replay stream, a
  gc'd run). Runs that logged with ``log_index=False``, crashed mid-run, or
  predate the index all become index-serviceable here.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

from repro_torch.logging.segment import _seal_of, list_segments
from repro_torch.querydb.index import LogIndex, ensure_index, open_index
from repro_torch.querydb.schema import FLAT_SEG

import os


class SegmentIndexer:
    """Per-(run, stream) seal hook bound to one store root's index.

    Construction is cheap and safe: the sqlite handle opens lazily on the
    first seal, and any error anywhere permanently disables the hook for
    this instance (``self.dead``) — subsequent seals cost one attribute
    check. ``finish(registry)`` runs at context close to sync the full runs
    mirror + directory signature, making the whole store's runs listing
    index-serviceable."""

    def __init__(self, store_root: str, run_id: str, stream: str,
                 registry=None, on_overhead: Optional[Callable] = None,
                 staging=None):
        self.store_root = store_root
        self.run_id = run_id
        self.stream = stream
        self.registry = registry
        self.on_overhead = on_overhead
        # multi-process record: ``staging`` labels a PER-PROCESS database
        # (<root>/index/staging/p<label>.db) this indexer ingests into —
        # concurrent recorders never contend on the shared flor.db; each
        # process absorbs its own staging file into the main index at
        # finish(), and `reindex` sweeps leftovers of crashed processes
        self.staging = staging
        self.dead = False
        self._idx: Optional[LogIndex] = None
        self._seeded = False

    def _index(self) -> LogIndex:
        if self._idx is None:
            if self.staging is not None:
                from repro_torch.querydb.index import staging_path
                sp = staging_path(self.store_root, self.staging)
                self._idx = LogIndex(self.store_root, create=True,
                                     db_path=sp)
                _write_alive_marker(sp)
            else:
                self._idx = ensure_index(self.store_root)
        return self._idx

    def _seed_run(self, idx: LogIndex):
        """Mirror this run's registry record on first contact so lineage
        queries see the row even before the close-time full sync."""
        if self._seeded:
            return
        self._seeded = True
        if self.registry is not None:
            rec = self.registry.get(self.run_id)
            if rec:
                idx.upsert_run(rec)

    # ------------------------------------------------------------- hooks --
    def on_seal(self, seg_path: str, seg_no: int, footer: dict):
        """SegmentSink seal callback — fires on the sealing thread, never on
        the training step path. All-exception barrier: a failure here marks
        the hook dead and the run simply stays file-scan-served."""
        if self.dead:
            return
        t0 = time.perf_counter()
        try:
            idx = self._index()
            self._seed_run(idx)
            idx.ingest_segment(self.run_id, self.stream, seg_no,
                               seg_path, sealed=True)
        except Exception:
            self.dead = True
            return
        if self.on_overhead:
            self.on_overhead(time.perf_counter() - t0, 0)

    def invalidate(self):
        """Drop everything indexed for this stream — called before a replay
        attempt rotates (truncates) it, so rows of the previous attempt can
        never be served as current."""
        if self.dead:
            return
        try:
            self._index().invalidate_stream(self.run_id, self.stream)
        except Exception:
            self.dead = True

    def finish(self, registry=None):
        """Close-time sync: merge this process's staging database into the
        main index (multi-process record), mirror the full registry listing
        (the run's own record now carries final status/keys) and stamp the
        directory signature, then release the handle. Best-effort, like
        every other path into the index."""
        registry = registry or self.registry
        try:
            if self.staging is not None:
                # release the staging handle first (WAL checkpoint), then
                # absorb into the main db — sqlite's busy timeout serializes
                # sibling processes merging concurrently. The staging file
                # is deleted only after the absorb transaction committed.
                if self._idx is not None:
                    self._idx.close()
                    self._idx = None
                from repro_torch.querydb.index import (ensure_index,
                                                       staging_path)
                sp = staging_path(self.store_root, self.staging)
                if not self.dead and os.path.exists(sp):
                    main = ensure_index(self.store_root)
                    try:
                        main.absorb(sp)
                        _remove_db(sp)
                    finally:
                        main.close()
            if not self.dead and registry is not None:
                from repro_torch.checkpoint.lineage import registry_dirsig
                from repro_torch.querydb.index import ensure_index
                idx = ensure_index(self.store_root) if self.staging \
                    is not None else self._index()
                try:
                    sig = registry_dirsig(self.store_root)
                    idx.set_runs(registry.list_runs(), sig)
                finally:
                    if self.staging is not None:
                        idx.close()
        except Exception:
            self.dead = True
        finally:
            if self._idx is not None:
                self._idx.close()
                self._idx = None


def _remove_db(db_path: str):
    """Delete a sqlite database, its WAL sidecar files, and the alive
    marker the staging path hangs next to it."""
    for suffix in ("", "-wal", "-shm", "-journal", ".alive"):
        try:
            os.remove(db_path + suffix)
        except OSError:
            pass


def _write_alive_marker(db_path: str):
    """Stamp ``<db>.alive`` with this process's identity (atomic rename,
    so a concurrent sweep never reads a torn marker). The sweep uses it to
    tell a LIVE recorder's staging db from a crashed process's leftover —
    deleting a live one would orphan every row the recorder seals after
    the sweep (it keeps writing to the unlinked inode, and its finish()
    absorb finds no file)."""
    import json
    import socket
    from repro_torch.checkpoint.store import _atomic_write
    _atomic_write(db_path + ".alive",
                  json.dumps({"pid": os.getpid(),
                              "host": socket.gethostname()}).encode())


_FOREIGN_LIVE_WINDOW_S = 600.0


def _staging_live(db_path: str) -> bool:
    """Whether the process that owns this staging db still looks alive. No
    marker means no live owner: a SegmentIndexer stamps the marker the
    moment it creates the db, so an unmarked file is a pre-marker layout
    or test fixture — sweepable either way. A marker from THIS host is
    checked against the pid; one from another host (shared store) cannot
    be probed, so the db counts as live while it moved recently."""
    import json
    import socket
    try:
        with open(db_path + ".alive", "rb") as f:
            mark = json.loads(f.read())
    except (OSError, ValueError):
        return False
    if mark.get("host") == socket.gethostname():
        try:
            pid = int(mark.get("pid") or 0)
        except (TypeError, ValueError):
            return False
        if pid <= 0:
            return False
        try:
            os.kill(pid, 0)
        except OSError:
            return False
        return True
    newest = 0.0
    for suffix in ("", "-wal", "-shm", ".alive"):
        try:
            newest = max(newest, os.path.getmtime(db_path + suffix))
        except OSError:
            pass
    return time.time() - newest < _FOREIGN_LIVE_WINDOW_S


def sweep_staging(store_root: str, idx: LogIndex) -> int:
    """Absorb (then delete) leftover per-process staging databases — the
    residue of record processes that crashed between sealing segments and
    merging at finish. Absorbing (rather than just deleting) keeps streams
    the file walk cannot enumerate (non-lead record_p<N> debug streams);
    anything else the walk re-ingests from the segment files anyway.

    A staging db whose owner is still alive (``_staging_live``) is left
    untouched: a reindex racing an in-flight distributed record must not
    delete a database another process is mid-write on — its rows merge at
    that process's own finish()."""
    sdir = os.path.join(store_root, "index", "staging")
    swept = 0
    try:
        names = sorted(os.listdir(sdir))
    except OSError:
        return 0
    for fn in names:
        if not fn.endswith(".db"):
            continue
        sp = os.path.join(sdir, fn)
        if _staging_live(sp):
            continue
        try:
            idx.absorb(sp)
        except Exception:
            pass          # torn staging db from a crash: drop it regardless
        _remove_db(sp)
        swept += 1
    return swept


def reindex(path: str) -> dict:
    """Bring ``path``'s index fully up to date and return ingestion stats.

    ``path`` is anything the query surface accepts (store root, bound run
    dir, legacy run dir). Only work the watermarks prove necessary is done:
    a segment whose (number, size, sealed) watermark already matches disk is
    skipped without opening it. Crash-safe by construction — each segment's
    rows and watermark commit in one transaction, so an interrupted reindex
    leaves a consistent prefix and the next call resumes past it."""
    from repro_torch.checkpoint.lineage import registry_dirsig
    from repro_torch.core.query import (_registered_runs, _run_log_files,
                                        resolve_store_root)
    root = resolve_store_root(path)
    # signature BEFORE the listing: a racing registration makes the mirror
    # stale (harmless), never fresh-but-incomplete
    sig = registry_dirsig(root)
    listing = _registered_runs(path)
    idx = ensure_index(root)
    stats = {"runs": len(listing), "segments_ingested": 0,
             "segments_skipped": 0, "segments_pruned": 0, "rows": 0}
    try:
        stats["staging_swept"] = sweep_staging(root, idx)
        idx.set_runs(listing, sig)
        for rec in listing:
            rid = rec.get("run_id")
            streams = _run_log_files(rec.get("run_dir"), include_replay=True)
            # a stream deleted wholesale (a cleaned-up replay log, a pruned
            # run dir) is invisible to the disk enumeration below — drop its
            # lingering watermarks and rows outright
            on_disk = {source for source, _sp in streams}
            for (stream,) in idx.conn.execute(
                    "SELECT DISTINCT stream FROM segments WHERE run_id=?",
                    (rid,)).fetchall():
                if stream not in on_disk:
                    n_gone = len(idx.stream_segments(rid, stream))
                    idx.invalidate_stream(rid, stream)
                    stats["segments_pruned"] += n_gone
            for source, sp in streams:
                marks = idx.stream_segments(rid, source)
                disk: dict[int, tuple[str, int, bool]] = {}
                if os.path.isdir(sp):
                    for n, seg_path in list_segments(sp):
                        try:
                            size = os.path.getsize(seg_path)
                        except OSError:
                            continue
                        sealed = _seal_of(seg_path) is not None
                        disk[n] = (seg_path, size, sealed)
                elif os.path.exists(sp):
                    # flat legacy file: one pseudo-segment, size-watermarked
                    disk[FLAT_SEG] = (sp, os.path.getsize(sp), False)
                for n, (seg_path, size, sealed) in sorted(disk.items()):
                    if marks.get(n) == size:
                        stats["segments_skipped"] += 1
                        continue
                    stats["rows"] += idx.ingest_segment(
                        rid, source, n, seg_path, sealed=sealed)
                    stats["segments_ingested"] += 1
                gone = set(marks) - set(disk)
                if gone:
                    idx.prune_segments(rid, source, disk.keys())
                    stats["segments_pruned"] += len(gone)
        stats.update(idx.stats())
    finally:
        idx.close()
    return stats


__all__ = ["SegmentIndexer", "reindex", "sweep_staging", "open_index",
           "ensure_index"]
