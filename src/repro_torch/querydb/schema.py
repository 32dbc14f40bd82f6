"""Relational schema of the incremental log index (stdlib sqlite3).

One database per store root at ``<store_root>/index/flor.db`` holds the
accumulated log records of EVERY run sharing that store — the FlorDB view
(arXiv:2408.02498): logs are a relation, queries are SQL, and the relation
is maintained incrementally as the training loop seals log segments.

Three tables:

* ``runs`` — a mirror of the ``RunRegistry`` JSON records (run_id, parent,
  namespace, run_dir, status, created_at). The lineage dimension: recursive
  CTEs over ``parent`` answer ancestor-chain queries without re-walking
  registry JSON. The mirror's freshness is judged against a directory
  signature of ``<store_root>/runs/`` stored in ``meta`` — when stale, the
  query surface falls back to scanning the JSON records.

* ``segments`` — the per-stream WATERMARKS: one row per indexed log segment
  (``seg`` is the segment number; ``-1`` is a whole flat legacy file),
  recording whether it was sealed and the byte size that was ingested. A
  (run, stream) is index-serviceable iff the segment set on disk matches
  this table exactly — same segment numbers, same sizes. An unsealed tail
  that grew, a replay re-attempt that rotated the stream, a segment never
  ingested: all surface as a mismatch, and the query transparently falls
  back to the file scan for that run.

* ``records`` — the log rows themselves. ``value_json`` is the JSON text of
  the row's value (round-trips bit-identically through ``json.loads``);
  ``spill_ref``/``spill_digest`` are lifted out of large-value pointer rows
  so spill-aware queries can reason about spilled bytes in SQL without
  parsing values. ``step`` is reserved for sub-epoch row addressing (serve
  tier); today's rows carry only ``epoch``/``seq``. Row order within a
  (run, source) is ``(seg, rowid)`` — segments are ingested whole, in file
  order, inside one transaction, so rowid order within a segment is file
  order and the index reproduces the file scan's row order exactly.

Crash safety is transactional: a segment's rows and its watermark commit in
the SAME transaction (WAL journal), so a torn ingest is invisible — the
watermark is absent, the segment re-ingests next time, and until then the
file-scan fallback serves the truth.
"""
from __future__ import annotations

import os
import sqlite3
import time

SCHEMA_VERSION = 1

# a whole flat (legacy, sync-mode) log file indexed as one pseudo-segment
FLAT_SEG = -1

DDL = """
CREATE TABLE IF NOT EXISTS meta(
  k TEXT PRIMARY KEY,
  v TEXT
);
CREATE TABLE IF NOT EXISTS runs(
  run_id     TEXT PRIMARY KEY,
  parent     TEXT,
  namespace  TEXT,
  run_dir    TEXT,
  status     TEXT,
  created_at REAL
);
CREATE TABLE IF NOT EXISTS segments(
  run_id TEXT NOT NULL,
  stream TEXT NOT NULL,
  seg    INTEGER NOT NULL,
  sealed INTEGER NOT NULL,
  size   INTEGER NOT NULL,
  rows   INTEGER NOT NULL,
  first_seq INTEGER,
  last_seq  INTEGER,
  PRIMARY KEY (run_id, stream, seg)
);
CREATE TABLE IF NOT EXISTS records(
  run_id TEXT NOT NULL,
  source TEXT NOT NULL,
  seg    INTEGER NOT NULL,
  seq    INTEGER,
  epoch  INTEGER,
  step   INTEGER,
  key    TEXT,
  value_json   TEXT NOT NULL,
  spill_ref    TEXT,
  spill_digest TEXT
);
CREATE INDEX IF NOT EXISTS ix_records_run ON records(run_id, source, seg);
CREATE INDEX IF NOT EXISTS ix_records_key ON records(key, run_id);
"""


BUSY_TIMEOUT_S = 30.0


def _set_wal(conn: sqlite3.Connection):
    """Switch to WAL. sqlite answers "database is locked" at once, without
    its busy handler, when another connection holds a lock on a database
    still in rollback mode — processes of a fleet creating the same fresh
    index at finish hit this — so wait for the lock as the busy timeout
    would."""
    deadline = time.monotonic() + BUSY_TIMEOUT_S
    while True:
        try:
            conn.execute("PRAGMA journal_mode=WAL")
            return
        except sqlite3.OperationalError as e:
            if "locked" not in str(e) or time.monotonic() >= deadline:
                raise
            time.sleep(0.02)


def connect(db_path: str, create: bool = False) -> sqlite3.Connection:
    """Open (optionally creating) the index database: WAL mode so one
    background writer and any number of query readers coexist without
    blocking each other, NORMAL sync (the index is a cache over the
    segment files — it may lose the last instants before a crash, the
    fallback path covers the gap), and a busy timeout so two runs sealing
    into one shared store serialize instead of erroring.

    ``check_same_thread=False``: the seal hook ingests from the background
    log stage while ``close()``-time seals ingest from the finishing
    thread; the two are serialized by the stage lifecycle (close drains
    the stage first), never concurrent."""
    if create:
        os.makedirs(os.path.dirname(db_path), exist_ok=True)
    elif not os.path.exists(db_path):
        raise FileNotFoundError(db_path)
    conn = sqlite3.connect(db_path, timeout=BUSY_TIMEOUT_S,
                           check_same_thread=False)
    _set_wal(conn)
    conn.execute("PRAGMA synchronous=NORMAL")
    conn.executescript(DDL)
    cur = conn.execute("SELECT v FROM meta WHERE k='schema_version'")
    row = cur.fetchone()
    if row is None:
        with conn:
            conn.execute("INSERT OR REPLACE INTO meta(k, v) VALUES "
                         "('schema_version', ?)", (str(SCHEMA_VERSION),))
    elif int(row[0]) != SCHEMA_VERSION:
        # a future schema we don't understand: refuse — the caller degrades
        # to the file-scan path rather than misreading a newer layout
        conn.close()
        raise RuntimeError(f"query index schema v{row[0]} != "
                           f"v{SCHEMA_VERSION} at {db_path}")
    return conn
