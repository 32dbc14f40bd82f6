"""File-based stitch rendezvous for multi-process mesh record.

In this package a mesh of more than one position is always a fleet of
processes (a ``DeviceMesh`` has one process per position), so every such
record publishes per-process member manifests and needs the v4 stitch done
here. Each process records its local shards and publishes member manifests
into its own ``store/shards/<hid>/`` pool; the only cross-process
coordination is a small file barrier under ``<store_root>/runs/<run>/.stitch/``
— no tensor collective runs on the record or restore path:

  * every process ``publish()``-es one JSON marker per checkpoint key
    (``<key>/p<pid>.json``, via the store's crash-safe ``_atomic_write``)
    carrying its member-manifest names and local layout fragment, and
    touches its heartbeat file ``hb.p<pid>``;
  * the LEAD process (process 0) ``gather()``-s all markers, validates the
    member manifests, and writes the global v4 manifest atomically — the
    ONLY writer of the stitch, so there is no election race;
  * a process that dies between member publication and the stitch leaves
    only unreferenced member manifests (GC reclaims them — the v4 was
    never written, so nothing dangles); a straggler past the deadline
    makes ``gather`` return ``None`` and the lead marks the checkpoint
    ``incomplete`` in run meta instead of wedging training.

The protocol and the marker files are the reference package's
(``repro.parallel.rendezvous``), so either package's processes read the
other's. ``init_distributed`` starts a gloo process group: gloo serves CPU
processes and ranks that share one card (NCCL refuses two ranks on one
GPU), and the record path needs only this file barrier.

Heartbeats bound the wait from the OTHER side: every live process runs a
background beater thread that renews its ``hb.p<pid>`` file continuously
(a beat only at publish time would go stale between checkpoints whenever
the cadence exceeds the stitch timeout). A gather measures staleness
RELATIVE TO ITS OWN START — a heartbeat is evidence of death only once it
has been silent for ``timeout_s`` within the current gather — because the
``.stitch/`` dir (and the heartbeat files in it) outlives checkpoints and
even whole runs: replay reuses the record run's dir, and a leftover
record-phase heartbeat must not declare a replay host dead before it had
a chance to start.

Fault injection (tests / the distributed example): set
``FLOR_DIST_CRASH_BEFORE_PUBLISH=<key>`` (optionally scoped with
``FLOR_DIST_CRASH_PROCESS=<pid>``) and the matching process exits with
code 43 after writing its member manifests but before publishing its
marker — the exact window the crash-safety argument is about.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time
from dataclasses import dataclass
from typing import Optional

from repro_torch.checkpoint.store import _atomic_write

CRASH_EXIT_CODE = 43


def _fsafe(name: str) -> str:
    return re.sub(r"[^A-Za-z0-9._-]", "_", name)


@dataclass(frozen=True)
class ProcessGroup:
    """Identity of this process inside a record or replay fleet."""
    process_id: int
    num_processes: int
    coordinator: Optional[str] = None

    def __post_init__(self):
        if not (0 <= self.process_id < self.num_processes):
            raise ValueError(
                f"process_id {self.process_id} outside fleet of "
                f"{self.num_processes}")

    @property
    def is_lead(self) -> bool:
        return self.process_id == 0


def init_distributed(coordinator: str, process_id: int,
                     num_processes: int) -> ProcessGroup:
    """Join a fleet of ``num_processes``: a gloo default process group over
    ``tcp://<coordinator>`` (``host:port``; process 0 listens there) and
    the matching ProcessGroup. A fleet of one starts its group too: a
    DeviceMesh needs one. Call ``torch.distributed.destroy_process_group()``
    when done."""
    import torch.distributed as dist
    group = ProcessGroup(process_id, num_processes, coordinator)
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                            rank=process_id, world_size=num_processes)
    return group


def current_group() -> ProcessGroup:
    """ProcessGroup of the initialized default process group (process 0 of
    1 when none is initialized)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return ProcessGroup(int(dist.get_rank()), int(dist.get_world_size()))
    return ProcessGroup(0, 1)


def crash_requested(key: str, process_id: int) -> bool:
    """Whether the fault-injection env asks THIS process to die before
    publishing ``key``'s marker."""
    want = os.environ.get("FLOR_DIST_CRASH_BEFORE_PUBLISH")
    if not want or want != key:
        return False
    pid = os.environ.get("FLOR_DIST_CRASH_PROCESS")
    return pid is None or int(pid) == process_id


class StitchRendezvous:
    """Crash-safe file barrier under ``<store_root>/runs/<run>/.stitch/``.

    Every mutation goes through ``_atomic_write`` (tmp + ``os.replace``),
    so a reader never observes a torn marker; a marker either exists whole
    or not at all, which is exactly the publication-ordering guarantee the
    v4 stitch needs.
    """

    POLL_S = 0.02

    def __init__(self, store_root: str, run_id: str, group: ProcessGroup,
                 timeout_s: float = 30.0):
        self.root = os.path.join(str(store_root), "runs", _fsafe(run_id),
                                 ".stitch")
        self.group = group
        self.timeout_s = float(timeout_s)
        os.makedirs(self.root, exist_ok=True)
        # continuous liveness: beat NOW (so a peer's gather never sees only
        # a stale record-phase leftover) and keep beating on a daemon
        # thread until close() — a beat only at publish time goes stale
        # between checkpoints whenever the cadence exceeds timeout_s
        self._beat_interval = min(max(self.timeout_s / 4.0, 0.05), 5.0)
        self._beat_stop = threading.Event()
        self.heartbeat()
        self._beater = threading.Thread(
            target=self._beat_loop, daemon=True,
            name=f"stitch-hb-p{group.process_id}")
        self._beater.start()

    # ------------------------------------------------------------ paths --
    def _key_dir(self, key: str) -> str:
        return os.path.join(self.root, _fsafe(key))

    def _marker(self, key: str, pid: int) -> str:
        return os.path.join(self._key_dir(key), f"p{pid}.json")

    def _hb_path(self, pid: int) -> str:
        return os.path.join(self.root, f"hb.p{pid}")

    # ------------------------------------------------------- publication --
    def heartbeat(self):
        _atomic_write(self._hb_path(self.group.process_id),
                      str(time.time()).encode())

    def _beat_loop(self):
        while not self._beat_stop.wait(self._beat_interval):
            try:
                self.heartbeat()
            except OSError:
                pass    # store dir gone (gc'd run): liveness is moot

    def close(self):
        """Stop the background beater. The rendezvous stays usable (publish
        still beats once per call); only continuous liveness ends — callers
        close when the record/replay session is done with coordination."""
        self._beat_stop.set()
        self._beater.join(timeout=2 * self._beat_interval)

    def publish(self, key: str, payload: dict):
        """Atomically publish this process's marker for ``key`` and renew
        the heartbeat. The fault-injection window sits just above this
        call (see ``crash_requested``) — by the time a marker exists, the
        member manifests it names are durably on disk."""
        d = self._key_dir(key)
        os.makedirs(d, exist_ok=True)
        _atomic_write(self._marker(key, self.group.process_id),
                      json.dumps(payload, sort_keys=True).encode())
        self.heartbeat()

    # ----------------------------------------------------------- gather --
    def _hb_stale(self, pid: int, since: float) -> bool:
        """Dead iff the heartbeat has been silent for ``timeout_s`` WITHIN
        the current gather (``since`` = the gather's wall-clock start).
        Absolute file age is meaningless across invocations: the heartbeat
        file survives in ``.stitch/`` between checkpoints and between the
        record run and a later replay, so an old mtime only proves the
        peer has not STARTED yet — it gets the timeout to show up and its
        beater makes the file fresh the moment it does."""
        try:
            m = os.path.getmtime(self._hb_path(pid))
        except OSError:
            return False          # never beat yet: charge the deadline
        return time.time() - max(m, since) > self.timeout_s

    def gather(self, key: str,
               timeout_s: Optional[float] = None) -> Optional[list]:
        """Lead-only. All processes' payloads for ``key`` ordered by
        process id, or ``None`` once the deadline passes or a missing
        process's heartbeat goes stale (it is dead; waiting longer cannot
        help — the early exit matters when the budget exceeds the
        heartbeat timeout, e.g. a long merge deadline over a short
        liveness window)."""
        budget = self.timeout_s if timeout_s is None else float(timeout_s)
        deadline = time.monotonic() + budget
        start = time.time()
        want = range(self.group.num_processes)
        while True:
            found = {}
            for pid in want:
                try:
                    with open(self._marker(key, pid), "rb") as f:
                        found[pid] = json.loads(f.read())
                except (OSError, ValueError):
                    pass
            if len(found) == self.group.num_processes:
                return [found[p] for p in want]
            if time.monotonic() >= deadline:
                return None
            if any(p not in found and self._hb_stale(p, start)
                   for p in want):
                return None
            time.sleep(self.POLL_S)

    def clear(self, key: str):
        """Drop a stitched key's marker dir (the v4 manifest is the
        durable record; markers are scratch)."""
        shutil.rmtree(self._key_dir(key), ignore_errors=True)

    def retract(self, key: str):
        """Remove this process's OWN marker for ``key`` (no heartbeat).
        Barrier users call it at startup so a stale marker left by a
        crashed previous invocation can never satisfy this round's
        ``await_all`` on their behalf."""
        try:
            os.remove(self._marker(key, self.group.process_id))
        except OSError:
            pass

    # ---------------------------------------------------------- barrier --
    def arrive(self, name: str, payload: Optional[dict] = None):
        """Generic named barrier arrival (e.g. replay-merge handoff):
        publish a marker under the pseudo-key ``name``."""
        self.publish(name, payload if payload is not None
                     else {"process": self.group.process_id})

    def await_all(self, name: str,
                  timeout_s: Optional[float] = None) -> Optional[list]:
        """Lead-side wait for every process's ``arrive(name)``."""
        return self.gather(name, timeout_s)
