"""Crash-safe, seq-ordered segment files for the fingerprint log.

One log STREAM (``logs/record.jsonl``, ``logs/replay_p3.jsonl``) is either

* a legacy FLAT file — one JSON record per line (the pre-subsystem layout,
  still written by ``async_log=False`` streams and still read forever), or
* a segment DIRECTORY at the very same path, holding ordered segment files
  ``log.<n>.jsonl``. The background writer appends records to the current
  segment and, at the roll threshold (and on clean close), SEALS it with a
  one-line footer ``{"__seal__": 1, "rows": R, "first_seq": a,
  "last_seq": b}``.

Keeping the directory at the legacy path means every consumer that treats
the path as an opaque stream id (``FingerprintLog.read``, the cross-run
query surface, ``run_logs``, the replay merge) keeps working unchanged —
``read_stream`` below dispatches on what it finds.

Crash safety. Records are written append-only and a stream NEVER reopens an
existing segment: a resumed writer always starts segment ``n+1``, so a torn
line (the process died mid-``write``) can only sit at the tail of a
segment. The reader skips seal footers and a torn FINAL line; an
unparsable line anywhere else is real corruption and raises. A sealed
segment additionally lets ``tail_seq`` trust ``last_seq`` without parsing
rows. Nothing here fsyncs: like the paper's materialization stage, the log
is allowed to lose the last instants before a crash, but never to
misparse what WAS durable.
"""
from __future__ import annotations

import json
import os
import re
import shutil
from typing import Optional

SEAL_KEY = "__seal__"
# roll threshold: segments stay small enough that tail_seq's "parse the
# trailing partial segment" is bounded work
DEFAULT_ROLL_BYTES = 1 << 20
# bounded-tail window for flat files (doubles until a valid row is found)
TAIL_WINDOW_BYTES = 64 * 1024

_SEG_RE = re.compile(r"^log\.(\d+)\.jsonl$")


def segment_path(stream_dir: str, n: int) -> str:
    return os.path.join(stream_dir, f"log.{n:05d}.jsonl")


def list_segments(stream_dir: str) -> list[tuple[int, str]]:
    """Ordered ``(n, path)`` of the segment files a stream dir holds."""
    try:
        names = os.listdir(stream_dir)
    except OSError:
        return []
    out = []
    for fn in names:
        m = _SEG_RE.match(fn)
        if m:
            out.append((int(m.group(1)), os.path.join(stream_dir, fn)))
    return sorted(out)


def remove_stream(path: str) -> None:
    """Delete a log stream, whichever layout it is in (flat file, segment
    dir, or a half-migrated leftover). Missing streams are a no-op."""
    if os.path.isdir(path):
        shutil.rmtree(path, ignore_errors=True)
    else:
        try:
            os.remove(path)
        except OSError:
            pass
    try:
        os.remove(path + ".migrate")
    except OSError:
        pass


def migrate_flat_to_segments(path: str) -> None:
    """Adopt an existing flat log file as segment 0 of a segment dir at the
    same path (a record run resumed with ``async_log=True`` over a run dir
    written by the synchronous path). The old rows keep their byte-exact
    lines; the resumed writer appends from segment 1. Each step is a
    rename, and a process killed between them is recovered on the next
    call (the ``.migrate`` leftover completes its move), so the rows are
    never stranded."""
    tmp = path + ".migrate"
    if os.path.isfile(path):
        os.replace(path, tmp)
    if os.path.isfile(tmp):
        os.makedirs(path, exist_ok=True)
        os.replace(tmp, segment_path(path, 0))


def needs_migration(path: str) -> bool:
    """True when `path` holds a flat file (or an interrupted migration's
    leftover) that must be adopted into the segment layout."""
    return os.path.isfile(path) or os.path.isfile(path + ".migrate")


class SegmentSink:
    """Append-only writer over a stream's segment directory.

    Exactly one thread appends (the background stage in async mode, the
    calling thread in sync-over-segments mode). Segments open lazily on the
    first row, roll at ``roll_bytes``, and are sealed with a footer on roll
    and on close — an unsealed trailing segment is the signature of a
    crashed writer, and the reader treats it accordingly.

    ``on_seal(path, n, footer)`` fires right after a segment seals — on the
    sealing thread (the background log stage on roll, the closing thread on
    close), NEVER on the training step path. The query index's incremental
    maintenance hangs off this hook: a segment becomes indexable exactly
    when it becomes immutable."""

    def __init__(self, stream_dir: str, roll_bytes: int = DEFAULT_ROLL_BYTES,
                 on_seal=None):
        self.dir = stream_dir
        self.on_seal = on_seal
        self.roll_bytes = max(int(roll_bytes), 1)
        os.makedirs(stream_dir, exist_ok=True)
        segs = list_segments(stream_dir)
        # never append to a pre-existing segment: its tail may be torn
        self._n = segs[-1][0] + 1 if segs else 0
        self._f = None
        self._bytes = 0
        self._rows = 0
        self._first_seq: Optional[int] = None
        self._last_seq: Optional[int] = None

    def append(self, line: str, seq: int) -> int:
        """Write one pre-serialized JSONL line (newline included). Returns
        the byte count written."""
        if self._f is None:
            self._f = open(segment_path(self.dir, self._n), "w")
            self._bytes = 0
            self._rows = 0
            self._first_seq = seq
        self._f.write(line)
        self._f.flush()
        n = len(line.encode("utf-8"))
        self._bytes += n
        self._rows += 1
        self._last_seq = seq
        if self._bytes >= self.roll_bytes:
            self._seal()
        return n

    def _seal(self):
        if self._f is None:
            return
        footer = {SEAL_KEY: 1, "rows": self._rows,
                  "first_seq": self._first_seq, "last_seq": self._last_seq}
        self._f.write(json.dumps(footer) + "\n")
        self._f.close()
        self._f = None
        sealed_n = self._n
        self._n += 1
        if self.on_seal is not None:
            self.on_seal(segment_path(self.dir, sealed_n), sealed_n, footer)

    def close(self):
        self._seal()


# ---------------------------------------------------------------- reading --
def parse_text(text: str, path: str = "<segment>") -> list[dict]:
    """Every record line of one file's TEXT, in file order, skipping seal
    footers and blank lines. An unparsable FINAL line is a torn tail — the
    signature of a writer killed mid-write (writers never reopen existing
    segments, so a torn line can only sit at the end of its file) — and is
    skipped. An unparsable line anywhere ELSE is real corruption and
    raises: silently dropping a mid-file record would let the deferred
    check report fidelity on rows it never compared.

    Exposed at the text level so the query index (``repro_torch.querydb``) can
    read a captured byte snapshot through the exact same row contract as
    the file-scan path — the bit-identity guarantee between the two query
    engines rests on sharing this one parser."""
    out = []
    lines = text.split("\n")
    last_content = max((i for i, ln in enumerate(lines) if ln.strip()),
                       default=-1)
    for i, line in enumerate(lines):
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            if i == last_content:
                continue                    # torn tail of a crashed writer
            raise ValueError(
                f"corrupt log line {path}:{i + 1} (not valid JSON and not "
                f"a torn tail)") from None
        if isinstance(rec, dict) and SEAL_KEY not in rec:
            out.append(rec)
    return out


def _parse_lines(path: str) -> list[dict]:
    """parse_text over one file on disk; a missing file is an empty log."""
    try:
        f = open(path)
    except OSError:
        return []
    with f:
        return parse_text(f.read(), path)


def read_stream(path: str) -> list[dict]:
    """All records of a stream, in seq order — flat file or segment dir,
    transparently. This is the single reader behind ``FingerprintLog.read``,
    so every downstream consumer (deferred check, replay merge, cross-run
    query) sees one row contract regardless of how the stream was written."""
    if os.path.isdir(path):
        rows: list[dict] = []
        for _n, seg in list_segments(path):
            rows.extend(_parse_lines(seg))
        return rows
    if not os.path.exists(path):
        return []
    return _parse_lines(path)


def _seal_of(path: str) -> Optional[dict]:
    """The seal footer of a segment, if it is sealed (footer = last line)."""
    try:
        with open(path, "rb") as f:
            f.seek(0, os.SEEK_END)
            size = f.tell()
            back = min(size, 4096)
            f.seek(size - back)
            tail = f.read().decode("utf-8", errors="replace")
    except OSError:
        return None
    lines = [ln for ln in tail.split("\n") if ln.strip()]
    if not lines:
        return None
    try:
        rec = json.loads(lines[-1])
    except json.JSONDecodeError:
        return None
    return rec if isinstance(rec, dict) and SEAL_KEY in rec else None


def _max_seq(rows: list[dict]) -> int:
    best = -1
    for r in rows:
        try:
            best = max(best, int(r["seq"]))
        except (KeyError, TypeError, ValueError):
            continue
    return best


def _flat_tail_seq(path: str) -> int:
    """Bounded-tail seq recovery for flat files: read a window from the end
    (doubling on miss) instead of parsing the whole file — resume cost is
    O(tail), not O(run length)."""
    try:
        size = os.path.getsize(path)
    except OSError:
        return 0
    window = TAIL_WINDOW_BYTES
    while True:
        start = max(size - window, 0)
        with open(path, "rb") as f:
            f.seek(start)
            tail = f.read().decode("utf-8", errors="replace")
        lines = tail.split("\n")
        if start > 0:
            lines = lines[1:]              # first line may be cut mid-record
        best = -1
        for line in lines:
            line = line.strip()
            if not line:
                continue
            try:
                best = max(best, int(json.loads(line)["seq"]))
            except (KeyError, TypeError, ValueError, json.JSONDecodeError):
                continue
        if best >= 0:
            return best + 1
        if start == 0:
            return 0
        window *= 2


def tail_seq(path: str) -> int:
    """1 + the last durable seq of a stream (0 for a missing/empty stream).

    Segment dirs walk segments from the END: a sealed trailing segment
    answers from its footer alone; an unsealed (crashed) one is parsed in
    full — bounded by the roll threshold — and the walk steps back past
    segments whose every line tore. Flat files use the bounded-tail window.
    Either way, resume never re-parses the whole history."""
    if os.path.isdir(path):
        for _n, seg in reversed(list_segments(path)):
            seal = _seal_of(seg)
            if seal is not None and seal.get("last_seq") is not None:
                return int(seal["last_seq"]) + 1
            best = _max_seq(_parse_lines(seg))
            if best >= 0:
                return best + 1
        return 0
    if not os.path.exists(path):
        return 0
    return _flat_tail_seq(path)
