"""FingerprintLog: the per-run metric/probe log, off the step path.

The paper's task (i) — "efficient background logging in Python" — landed
everywhere in this repro EXCEPT the log itself: checkpoints materialize in
the background, but every ``flor.log`` used to serialize and write JSONL
synchronously on the training thread. This module is the fix:

* **record (async, the default)** — ``log()`` assigns a seq number and
  enqueues ``(epoch, seq, key, captured value)`` onto a bounded
  :class:`~repro_torch.checkpoint.async_writer.AsyncStage`; the stage thread does
  the device->host copy, JSON serialization, large-value spill, and the
  crash-safe segment write (``repro_torch.logging.segment``). Tensors are
  mutable, so they are SNAPSHOTTED at capture: a CUDA tensor by an
  asynchronous copy into pinned host memory, queued in the stream's order,
  and an event the stage waits on (the step path never blocks on
  ``.item()`` or a device->host copy, and neither does the stage hold up
  the step path's launches: see :class:`_HostCopy`); a host tensor by a
  clone; host numpy arrays with a memcpy; plain Python values are
  lowered with :func:`~repro_torch.logging.jsonable.jsonable` inline (cheap, and
  it freezes mutable lists/dicts at log time, keeping async output
  bit-identical to sync).
* **record (sync, ``async_log=False``)** — the legacy path: serialize and
  write a line-buffered flat JSONL file on the calling thread. Same
  serializer, same rows; only WHERE the work runs differs.
* **replay** — each attempt rotates its per-pid stream (``fresh=True``);
  both modes apply.

Large values: a logged array whose host size exceeds ``spill_bytes`` is
stored to the run's checkpoint store under ``logref__<stream>__<seq>`` and
the log row carries ``{"ref": key, dtype, shape, nbytes}`` instead of a
megabyte JSON literal. The ref key is derived from (stream, seq), so sync
and async spills are identical.

Overhead accounting: every serialize+spill+write batch reports its wall
time and byte count to ``on_overhead`` — FlorContext points this at
``AdaptiveController.observe_logging``, so observed logging cost draws down
the same epsilon budget that gates checkpoint materialization.
"""
from __future__ import annotations

import copy
import json
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.checkpoint.async_writer import AsyncStage
from repro_torch.checkpoint.store import _leaf_to_np, _to_tensor
from repro_torch.logging.jsonable import json_default, jsonable
from repro_torch.logging.segment import (DEFAULT_ROLL_BYTES, SegmentSink,
                                   migrate_flat_to_segments, needs_migration,
                                   read_stream, remove_stream, tail_seq)
from repro_torch.utils.timing import span

DEFAULT_QUEUE_DEPTH = 1024
DEFAULT_SPILL_BYTES = 1 << 20          # 1 MiB of host bytes


class FingerprintLog:
    """Append-only metric log; record/replay logs are diffed by the deferred
    correctness check (paper section 5.2.2).

    ``fresh=True`` truncates (each replay ATTEMPT rotates its stream —
    stale lines from a previous attempt with the same pid would corrupt the
    deferred diff); ``fresh=False`` appends and continues ``seq`` from the
    existing tail (bounded-tail recovery, not a full re-parse), so a
    resumed record run never emits duplicate seqs.

    ``async_log=True`` moves serialization and I/O onto a background stage
    and switches the on-disk layout to crash-safe segments; the row
    contract of :meth:`read` is identical either way. A stream that is
    ALREADY segmented stays segmented even when reopened with
    ``async_log=False`` (the layout is a property of the run dir, not of
    the process that happens to reopen it)."""

    def __init__(self, path: str, fresh: bool = False, *,
                 async_log: bool = False,
                 queue_depth: int = DEFAULT_QUEUE_DEPTH,
                 spill_bytes: Optional[int] = DEFAULT_SPILL_BYTES,
                 store=None, stream: Optional[str] = None,
                 on_overhead: Optional[Callable] = None,
                 on_seal: Optional[Callable] = None,
                 roll_bytes: int = DEFAULT_ROLL_BYTES):
        self.path = path
        self.stream = stream or \
            os.path.splitext(os.path.basename(path))[0]
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        if fresh:
            remove_stream(path)
        segmented = async_log or os.path.isdir(path) \
            or (not fresh and os.path.isfile(path + ".migrate"))
        if segmented and needs_migration(path):
            # resume of a sync-era run dir with async on: adopt the flat
            # file as segment 0 so one reader pass sees the whole stream
            # (also completes a migration a crash interrupted) — BEFORE
            # tail_seq, which must see the adopted rows
            migrate_flat_to_segments(path)
        self._seq = 0 if fresh else tail_seq(path)
        self._spill = int(spill_bytes) if spill_bytes else 0
        self._store = store
        self._on_overhead = on_overhead
        self.stats = {"rows": 0, "bytes": 0, "overhead_s": 0.0,
                      "spilled": 0}
        self._f = None
        self._sink = None
        if segmented:
            # on_seal is the query index's incremental-maintenance hook
            # (repro_torch.querydb): it fires on the sealing thread — the
            # background stage on roll, the closing thread on close — so
            # index upkeep rides the same off-step-path budget as the
            # serialize+write work itself
            self._sink = SegmentSink(path, roll_bytes=roll_bytes,
                                     on_seal=on_seal)
        else:
            self._f = open(path, "w" if fresh else "a", buffering=1)
        self._stage = AsyncStage(self._emit, max_queue=queue_depth) \
            if async_log else None

    # ------------------------------------------------------------- write --
    def log(self, epoch, key: str, value):
        """Record one (epoch, key, value) row. Async mode: O(1) capture +
        enqueue on the calling thread (blocking only when the bounded queue
        is full — backpressure, the same contract as checkpoint submits);
        sync mode: serialize + write here and now."""
        with span("repro_torch.flor.log"):
            epoch = int(epoch) if epoch is not None else None
            seq = self._seq
            self._seq += 1
            if self._stage is not None:
                self._stage.put((epoch, seq, key, _capture(value, key)))
                return
            t0 = time.perf_counter()
            line, nbytes = self._serialize(epoch, seq, key, value)
            self._f.write(line) if self._f is not None \
                else self._sink.append(line, seq)
            self._account(time.perf_counter() - t0, nbytes)

    def _emit(self, item):
        """Background stage: device->host + serialize + spill + segment
        write for one enqueued row."""
        epoch, seq, key, value = item
        if isinstance(value, _HostCopy):
            value = value.wait()       # the card's time, not the log's
        t0 = time.perf_counter()
        line, nbytes = self._serialize(epoch, seq, key, value)
        self._sink.append(line, seq)
        self._account(time.perf_counter() - t0, nbytes)

    def _serialize(self, epoch, seq, key, value) -> tuple[str, int]:
        if isinstance(value, (np.ndarray, torch.Tensor)) \
                or hasattr(value, "dtype"):
            host, dtype = _leaf_to_np(value)
            if self._spill and self._store is not None \
                    and host.ndim and int(host.nbytes) > self._spill:
                value = self._spill_value(host, dtype, seq)
            else:
                value = jsonable(_widen_bf16(host, dtype), key)
        else:
            value = jsonable(value, key)   # idempotent for captured values
        rec = {"epoch": epoch, "seq": seq, "key": key, "value": value}
        # default= lowers non-JSON leaves nested INSIDE containers (dict of
        # arrays, ...) instead of raising — on the background stage a dumps
        # TypeError would otherwise surface as a deferred crash at close()
        line = json.dumps(rec, default=json_default(key)) + "\n"
        return line, len(line.encode("utf-8"))

    def _spill_value(self, host: np.ndarray, dtype: str, seq: int) -> dict:
        """Store an oversized array as checkpoint-store chunks and log a
        pointer row instead. The key is a pure function of (stream, seq),
        so sync and async modes produce the same ref. The row also carries
        a content DIGEST: record and replay spill under different stream
        names, and the deferred check compares spill rows by digest — same
        bytes pass, divergent bytes are an anomaly — rather than by the
        pointer. ``host`` holds the value's bytes (a bfloat16 value as its
        uint16 bit pattern, ``dtype`` "bfloat16"): the row's dtype, nbytes
        and digest are those of the 2-byte values, as the reference
        package's ml_dtypes array gives them."""
        import hashlib
        ref = f"logref__{self.stream}__{seq:08d}"
        self._store.put_tree(ref, {"v": _to_tensor(host, dtype)
                                   if dtype == "bfloat16" else host})
        self.stats["spilled"] += 1
        return {"ref": ref, "dtype": dtype,
                "shape": list(host.shape), "nbytes": int(host.nbytes),
                "digest": hashlib.blake2b(
                    np.ascontiguousarray(host).tobytes(),
                    digest_size=16).hexdigest()}

    def _account(self, seconds: float, nbytes: int):
        self.stats["rows"] += 1
        self.stats["bytes"] += nbytes
        self.stats["overhead_s"] += seconds
        if self._on_overhead:
            self._on_overhead(seconds, nbytes)

    # --------------------------------------------------------- lifecycle --
    def drain(self):
        """Block until every enqueued row is durable (async mode no-op when
        sync). Background errors surface here."""
        if self._stage is not None:
            self._stage.drain()

    def close(self):
        try:
            if self._stage is not None:
                stage, self._stage = self._stage, None
                stage.close()
        finally:
            # a background error must still seal the rows that DID land and
            # release the handle — durability of the good prefix beats
            # tidiness of the failure
            if self._sink is not None:
                self._sink.close()
            if self._f is not None:
                self._f.close()

    # ------------------------------------------------------------- read ---
    @staticmethod
    def read(path: str) -> list[dict]:
        """All rows of a stream in seq order — flat file or segment dir
        (record and replay alike); torn tails from a killed writer are
        skipped, seal footers are invisible."""
        return read_stream(path)


def _widen_bf16(host: np.ndarray, dtype: str) -> np.ndarray:
    """A bfloat16 value's uint16 bit pattern as float32 (which holds every
    bfloat16 value exactly) for the inline JSON path; other arrays as they
    are."""
    if dtype == "bfloat16":
        return (host.astype(np.uint32) << 16).view(np.float32)
    return host


class _HostCopy:
    """A CUDA tensor's value on its way to the host: an asynchronous copy
    into pinned memory, queued on the tensor's current stream (a snapshot,
    as a clone on the card is), and an event recorded after it.

    The stage thread waits on the event alone. When it copied the value to
    the host itself, with a blocking copy into pageable memory, the copy
    queued behind every launch made since the capture, and on an H100 the
    step path's CUDA calls were seen to wait as long as it did (~160 ms, a
    whole step of one Mixtral-8x7B layer): the card ran dry at every step
    boundary, for longer in a process whose host ran slower."""

    __slots__ = ("host", "done")

    def __init__(self, t: torch.Tensor):
        self.host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        self.host.copy_(t.detach(), non_blocking=True)
        # a blocking-sync event: the stage sleeps while it waits, leaving
        # the host's cores to the thread that launches the steps
        self.done = torch.cuda.Event(blocking=True)
        self.done.record(torch.cuda.current_stream(t.device))

    def wait(self) -> torch.Tensor:
        self.done.synchronize()
        return self.host


def _capture(value, key):
    """Make a value safe to serialize LATER, as cheaply as possible on the
    step path. Tensors are mutable: a CUDA tensor starts its copy to the
    host now, asynchronously (:class:`_HostCopy`), and a host tensor is
    cloned. Host numpy arrays: snapshot bytes (memcpy — still far cheaper
    than tolist+json). Everything else is lowered inline; mutable
    containers are deep-copied so a later mutation by the training loop
    cannot reach back into the queue."""
    if isinstance(value, torch.Tensor):
        if value.is_cuda:
            return _HostCopy(value)
        return value.detach().clone()
    if isinstance(value, np.ndarray):
        return value.copy()              # 0-d arrays are mutable too
    if hasattr(value, "dtype"):
        return value
    v = jsonable(value, key)
    return copy.deepcopy(v) if isinstance(v, (list, dict)) else v
