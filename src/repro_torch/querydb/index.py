"""LogIndex: the sqlite-backed store behind ``log_records``/``pivot``.

This is the storage half of the query engine. It knows how to ingest one
sealed (or snapshot-watermarked) log segment transactionally, how to judge
whether it can SERVE a run's streams (watermark check against the files on
disk), and how to answer the row queries the surface needs — including the
lineage dimension via a recursive CTE over ``runs``.

Correctness contract: a query served from here is bit-identical to the
file-scan path. That holds because (a) ingestion parses segment text
through the very same ``repro_torch.logging.segment.parse_text`` the scan uses,
(b) values round-trip as JSON text, (c) row order is reproduced as
``(seg, rowid)`` per stream, and (d) ``covers`` refuses to serve any run
whose on-disk segments don't exactly match the ingested watermarks — the
caller then falls back to scanning files for that run.
"""
from __future__ import annotations

import json
import os
from typing import Iterable, Optional

from repro_torch.logging.segment import list_segments, parse_text
from repro_torch.querydb.schema import FLAT_SEG, connect

# columns a WHERE filter may push down into SQL; run_id/parent_run/source
# are per-stream constants and are tested in Python before the SELECT
SQL_WHERE_COLS = ("epoch", "seq", "key", "step")


def index_path(store_root: str) -> str:
    return os.path.join(store_root, "index", "flor.db")


def staging_path(store_root: str, label) -> str:
    """Per-process staging database for multi-process record: process
    ``label`` ingests its sealed segments here (zero contention on the
    shared ``flor.db``) and ``absorb``-s the file into the main index at
    finish. A crashed process's leftover is swept by ``reindex``."""
    return os.path.join(store_root, "index", "staging", f"p{label}.db")


def spill_fields(value) -> tuple[Optional[str], Optional[str]]:
    """(spill_ref, spill_digest) of a large-value pointer row written by the
    background log's spill path (``{"ref": "logref__<stream>__<seq>",
    dtype, shape, nbytes, digest}``), (None, None) for ordinary values."""
    if (isinstance(value, dict)
            and str(value.get("ref", "")).startswith("logref__")
            and "nbytes" in value):
        return str(value["ref"]), value.get("digest")
    return None, None


class LogIndex:
    """Handle on one store root's index database.

    Writers (the seal hook, ``reindex``) and readers (the query surface)
    hold separate handles; WAL keeps them from blocking each other. Every
    write method is transactional — rows and their watermark commit
    atomically."""

    def __init__(self, store_root: str, create: bool = False,
                 db_path: Optional[str] = None):
        self.store_root = store_root
        # db_path overrides the default <root>/index/flor.db — the staging
        # databases of multi-process record use the same schema + methods
        self.path = db_path or index_path(store_root)
        self.conn = connect(self.path, create=create)

    def close(self):
        try:
            self.conn.close()
        except Exception:
            pass

    # ------------------------------------------------------------ ingest --
    def ingest_segment(self, run_id: str, stream: str, seg: int,
                       seg_path: str, sealed: bool) -> int:
        """Index one segment file (or, with ``seg=FLAT_SEG``, one whole flat
        legacy file). The file's bytes are snapshotted FIRST and the byte
        count becomes the watermark, so rows appended after the snapshot
        make the watermark stale rather than silently missing — ``covers``
        then routes the run to the file scan until a re-ingest catches up.
        Delete + insert + watermark are one transaction: a crash mid-ingest
        leaves the previous consistent state."""
        with open(seg_path, "rb") as f:
            data = f.read()
        rows = parse_text(data.decode("utf-8", errors="replace"), seg_path)
        seqs = [r["seq"] for r in rows
                if isinstance(r.get("seq"), int)]
        params = []
        for r in rows:
            value = r.get("value")
            ref, digest = spill_fields(value)
            params.append((run_id, stream, int(seg), r.get("seq"),
                           r.get("epoch"), r.get("step"), r.get("key"),
                           json.dumps(value), ref, digest))
        with self.conn:
            self.conn.execute(
                "DELETE FROM records WHERE run_id=? AND source=? AND seg=?",
                (run_id, stream, int(seg)))
            self.conn.executemany(
                "INSERT INTO records(run_id, source, seg, seq, epoch, step, "
                "key, value_json, spill_ref, spill_digest) "
                "VALUES (?,?,?,?,?,?,?,?,?,?)", params)
            self.conn.execute(
                "INSERT OR REPLACE INTO segments(run_id, stream, seg, "
                "sealed, size, rows, first_seq, last_seq) "
                "VALUES (?,?,?,?,?,?,?,?)",
                (run_id, stream, int(seg), int(bool(sealed)), len(data),
                 len(rows), min(seqs) if seqs else None,
                 max(seqs) if seqs else None))
        return len(rows)

    def invalidate_stream(self, run_id: str, stream: str):
        """Drop a stream's rows AND watermarks — a replay re-attempt rotated
        (truncated) the stream, so everything indexed for it is stale."""
        with self.conn:
            self.conn.execute(
                "DELETE FROM records WHERE run_id=? AND source=?",
                (run_id, stream))
            self.conn.execute(
                "DELETE FROM segments WHERE run_id=? AND stream=?",
                (run_id, stream))

    def prune_segments(self, run_id: str, stream: str,
                       keep_segs: Iterable[int]):
        """Drop indexed segments that no longer exist on disk (a truncated
        replay stream indexed by a previous attempt, a gc'd run dir)."""
        keep = {int(s) for s in keep_segs}
        rows = self.conn.execute(
            "SELECT seg FROM segments WHERE run_id=? AND stream=?",
            (run_id, stream)).fetchall()
        stale = [s for (s,) in rows if s not in keep]
        if not stale:
            return
        with self.conn:
            for s in stale:
                self.conn.execute(
                    "DELETE FROM records WHERE run_id=? AND source=? "
                    "AND seg=?", (run_id, stream, s))
                self.conn.execute(
                    "DELETE FROM segments WHERE run_id=? AND stream=? "
                    "AND seg=?", (run_id, stream, s))

    def absorb(self, other_path: str) -> int:
        """Merge a staging database (same schema) into this index: for each
        (run, stream, segment) the staging db ingested, replace this db's
        rows and watermark with the staged ones — the exact DELETE+INSERT
        a direct ingest performs, so a merged index is engine-identical to
        one that ingested the segments itself. Rows copy ordered by
        (source, seg, rowid): per-stream file order is preserved under
        fresh rowids, which is all ``select_rows``' (seg, rowid) ordering
        needs. Rows + watermarks commit in ONE transaction — a crash
        mid-merge leaves the main index at its previous consistent state
        and the staging file intact for the next sweep."""
        if not os.path.exists(other_path):
            return 0
        self.conn.execute("ATTACH DATABASE ? AS stg", (other_path,))
        try:
            segs = self.conn.execute(
                "SELECT run_id, stream, seg FROM stg.segments").fetchall()
            with self.conn:
                for rid, stream, seg in segs:
                    self.conn.execute(
                        "DELETE FROM records WHERE run_id=? AND source=? "
                        "AND seg=?", (rid, stream, seg))
                self.conn.execute(
                    "INSERT INTO records(run_id, source, seg, seq, epoch, "
                    "step, key, value_json, spill_ref, spill_digest) "
                    "SELECT run_id, source, seg, seq, epoch, step, key, "
                    "value_json, spill_ref, spill_digest FROM stg.records "
                    "ORDER BY source, seg, rowid")
                self.conn.execute(
                    "INSERT OR REPLACE INTO segments "
                    "SELECT * FROM stg.segments")
                # staged run rows only fill gaps: the main mirror's rows
                # (possibly already finalized via set_runs) stay as-is
                self.conn.execute(
                    "INSERT OR IGNORE INTO runs SELECT * FROM stg.runs")
            return len(segs)
        finally:
            try:
                self.conn.execute("DETACH DATABASE stg")
            except Exception:
                pass

    # -------------------------------------------------------------- runs --
    def upsert_run(self, rec: dict):
        """Mirror one registry record (the seal hook keeps its OWN run row
        current without paying a full registry sync per seal). Does NOT
        update the listing signature: the full-listing mirror only becomes
        authoritative through ``set_runs``."""
        with self.conn:
            self.conn.execute(
                "INSERT OR REPLACE INTO runs(run_id, parent, namespace, "
                "run_dir, status, created_at) VALUES (?,?,?,?,?,?)",
                (rec.get("run_id"), rec.get("parent"), rec.get("namespace"),
                 rec.get("run_dir"), rec.get("status"),
                 rec.get("created_at")))

    def set_runs(self, listing: list[dict], dirsig):
        """Replace the runs mirror with a full registry listing and stamp
        the registry-directory signature it was read under. The signature
        was captured BEFORE the listing was read, so a registration racing
        the sync can only make the mirror look stale (safe), never fresh
        with missing rows. ``dirsig=None`` (no registry directory) stores
        an unmatchable sentinel: pseudo-run listings are never routed
        through the mirror."""
        with self.conn:
            self.conn.execute("DELETE FROM runs")
            self.conn.executemany(
                "INSERT OR REPLACE INTO runs(run_id, parent, namespace, "
                "run_dir, status, created_at) VALUES (?,?,?,?,?,?)",
                [(r.get("run_id"), r.get("parent"), r.get("namespace"),
                  r.get("run_dir"), r.get("status"), r.get("created_at"))
                 for r in listing])
            self.conn.execute(
                "INSERT OR REPLACE INTO meta(k, v) VALUES ('runs_dirsig', ?)",
                (json.dumps(dirsig) if dirsig is not None else "unsynced",))

    def runs_listing(self, dirsig) -> Optional[list[dict]]:
        """The mirrored registry listing in registry order — or None when
        the stored signature doesn't match ``dirsig`` (registrations,
        removals, or finalizations happened since the last sync; the caller
        then scans the JSON records instead)."""
        if dirsig is None:
            return None
        row = self.conn.execute(
            "SELECT v FROM meta WHERE k='runs_dirsig'").fetchone()
        if row is None or row[0] != json.dumps(dirsig):
            return None
        out = []
        for rid, parent, ns, rdir, status, created in self.conn.execute(
                "SELECT run_id, parent, namespace, run_dir, status, "
                "created_at FROM runs "
                "ORDER BY COALESCE(created_at, 0), COALESCE(run_id, '')"):
            out.append({"run_id": rid, "parent": parent, "namespace": ns,
                        "run_dir": rdir, "status": status,
                        "created_at": created})
        return out

    def ancestry_ids(self, run_id: str) -> set:
        """Run ids on ``run_id``'s ancestor chain (itself included when
        mirrored), via a recursive CTE over the runs mirror — the indexed
        replacement for walking registry JSON parent links."""
        rows = self.conn.execute(
            "WITH RECURSIVE anc(run_id) AS ("
            "  SELECT :r "
            "  UNION "
            "  SELECT runs.parent FROM runs "
            "  JOIN anc ON runs.run_id = anc.run_id "
            "  WHERE runs.parent IS NOT NULL) "
            "SELECT run_id FROM anc", {"r": run_id}).fetchall()
        return {r for (r,) in rows}

    # --------------------------------------------------------- freshness --
    def stream_segments(self, run_id: str, stream: str) -> dict[int, int]:
        """{seg: ingested byte size} for one stream's watermarks."""
        return {seg: size for seg, size in self.conn.execute(
            "SELECT seg, size FROM segments WHERE run_id=? AND stream=?",
            (run_id, stream))}

    def covers(self, run_id: str, streams: list[tuple[str, str]]) -> bool:
        """Whether the index can serve ``streams`` (the ``(source, path)``
        list the file scan would read for this run) bit-identically: every
        stream's on-disk segment set must match the ingested watermarks
        EXACTLY — same segment numbers, same byte sizes. Growth of an
        unsealed tail, a rotated replay stream, an un-ingested segment, or
        a lingering watermark for a deleted segment all fail the check and
        route the run to the file scan. Cost is a listdir + stat per
        segment; no file contents are read."""
        for source, path in streams:
            disk: dict[int, int] = {}
            if os.path.isdir(path):
                for n, sp in list_segments(path):
                    try:
                        disk[n] = os.path.getsize(sp)
                    except OSError:
                        return False
            elif os.path.exists(path):
                try:
                    disk[FLAT_SEG] = os.path.getsize(path)
                except OSError:
                    return False
            if disk != self.stream_segments(run_id, source):
                return False
        return True

    # ------------------------------------------------------------- query --
    def select_rows(self, run_id: str, parent_run, source: str,
                    keys: Optional[tuple] = None,
                    where: Optional[dict] = None,
                    limit: Optional[int] = None) -> list[dict]:
        """One stream's rows as query-surface dicts, in file order. ``keys``
        and the SQL-safe ``where`` columns are pushed into the SELECT;
        ``limit`` bounds the scan when the caller may stop early."""
        sql = ["SELECT epoch, seq, key, value_json FROM records "
               "WHERE run_id=? AND source=?"]
        args: list = [run_id, source]
        if keys:
            sql.append(f"AND key IN ({','.join('?' * len(keys))})")
            args.extend(keys)
        for col, val in (where or {}).items():
            if col not in SQL_WHERE_COLS:
                continue                 # non-pushable: caller post-filters
            if val is None:
                sql.append(f"AND {col} IS NULL")
            else:
                sql.append(f"AND {col}=?")
                args.append(val)
        sql.append("ORDER BY seg, rowid")
        if limit is not None:
            sql.append("LIMIT ?")
            args.append(int(limit))
        out = []
        for epoch, seq, key, vj in self.conn.execute(" ".join(sql), args):
            out.append({"run_id": run_id, "parent_run": parent_run,
                        "source": source, "epoch": epoch, "seq": seq,
                        "key": key, "value": json.loads(vj)})
        return out

    def stats(self) -> dict:
        """Row/segment/run counts — `runs reindex` and tests report these."""
        one = lambda q: self.conn.execute(q).fetchone()[0]  # noqa: E731
        return {"runs": one("SELECT COUNT(*) FROM runs"),
                "segments": one("SELECT COUNT(*) FROM segments"),
                "records": one("SELECT COUNT(*) FROM records"),
                "spilled": one("SELECT COUNT(*) FROM records "
                               "WHERE spill_ref IS NOT NULL")}


def open_index(store_root: str) -> Optional[LogIndex]:
    """The store's index handle, or None when no index exists (or it is
    unreadable / a future schema) — callers treat None as 'file-scan'."""
    try:
        return LogIndex(store_root)
    except (FileNotFoundError, RuntimeError, OSError):
        return None
    except Exception:
        return None


def ensure_index(store_root: str) -> LogIndex:
    """Open the store's index, creating the database on first use."""
    return LogIndex(store_root, create=True)
