"""Run lineage: the registry that turns a shared CheckpointStore into a
versioned system of record across runs.

*Multiversion Hindsight Logging for Continuous Training* (arXiv:2310.07898)
and *Flow with FlorDB* (arXiv:2408.02498) motivate checkpoint lineage ACROSS
runs: a fine-tune of a fine-tune should record only true deltas against its
ancestor, and storage reclamation must reason about every run that can still
reach a chunk. This module owns the run-level half of that:

* ``RunRegistry`` — per-run records persisted as JSON under
  ``<store_root>/runs/<run_id>.json``::

      {"run_id", "parent",        # parent run id (lineage edge) or null
       "namespace",               # manifest namespace in the store (null =
                                  #   legacy flat layout, single-run store)
       "run_dir", "status",       # running | finished
       "created_at", "finished_at",
       "final_keys": {scope: key}}  # tip checkpoint per SkipBlock scope —
                                    #   what a derived run warm-starts from

  with ancestry resolution (``ancestry``) and registry-driven multi-run GC
  (``gc``): the live set is the union of every registered run's manifests;
  ``CheckpointStore.gc`` then retains the cross-run parent closure, so
  unregistering run A reclaims exactly the chunks no surviving descendant
  inherits.

* ``flor.run.json`` helpers — each run directory carries a small metadata
  file binding it to (run_id, store_root, namespace, parent_run), so replay
  reconnects to the shared store without re-passing any of it.

The CLI lives in ``repro/launch/runs.py`` (``python -m repro_torch.launch.runs
list|show|gc|rm``).
"""
from __future__ import annotations

import json
import os
import threading
import time
import uuid
from typing import Optional

from repro_torch.checkpoint.store import _atomic_write

RUN_META_FILE = "flor.run.json"


class RunIdCollision(RuntimeError):
    """An exclusive registration lost the race: the run id already belongs
    to a DIFFERENT run (other run_dir/namespace). Callers with generated
    ids retry with a fresh id; callers with explicit ids surface the
    conflict."""


def generate_run_id() -> str:
    """Sortable-by-creation, collision-safe id: timestamp + random suffix."""
    return time.strftime("%Y%m%d-%H%M%S") + "-" + uuid.uuid4().hex[:6]


def write_run_meta(run_dir: str, meta: dict):
    os.makedirs(run_dir, exist_ok=True)
    _atomic_write(os.path.join(run_dir, RUN_META_FILE),
                  json.dumps(meta, indent=1).encode())


def read_run_meta(run_dir: str) -> dict:
    """The run directory's lineage binding; {} for pre-lineage run dirs."""
    path = os.path.join(run_dir, RUN_META_FILE)
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return json.load(f)


class RunRegistry:
    """Persistent registry of the runs sharing one store root. Thread/process
    coordination is filesystem-level (atomic JSON replace per run record) —
    matching the store's own crash-safety discipline."""

    def __init__(self, store_root: str):
        self.root = os.path.join(store_root, "runs")
        os.makedirs(self.root, exist_ok=True)

    def _path(self, run_id: str) -> str:
        return os.path.join(self.root, _fsafe(run_id) + ".json")

    # --------------------------------------------------------- lifecycle --
    def register(self, run_id: str, parent: Optional[str] = None,
                 run_dir: Optional[str] = None,
                 namespace: Optional[str] = None,
                 meta: Optional[dict] = None,
                 exclusive: bool = False) -> dict:
        """Create (or replace) a run record at record-init time. A re-record
        into the same (run_dir, namespace) replaces the stale registration —
        its manifests were overwritten anyway, and a dangling record would
        pin dead chunks forever. Parent validation applies only to FIRST
        registration: a resumed run whose parent was since `runs rm`'d must
        still relaunch (its closure survived the rm by design).

        ``exclusive=True`` makes the CREATE atomic on the shared filesystem
        (hard-link publish of a fully-written temp record): of two
        simultaneous recorders racing the same run id, exactly one wins; the
        loser gets :class:`RunIdCollision` and (when its id was generated)
        retries with a fresh one. A record that already belongs to this
        (run_dir, namespace) is a crash-restart/resume, not a collision."""
        if parent is not None and self.get(parent) is None \
                and self.get(run_id) is None:
            raise ValueError(
                f"parent run {parent!r} is not registered in this store "
                f"(known runs: {[r['run_id'] for r in self.list_runs()]})")
        rec = {"run_id": run_id, "parent": parent, "namespace": namespace,
               "run_dir": run_dir, "status": "running",
               "created_at": time.time(), "finished_at": None,
               "final_keys": {},
               "meta": meta or {}}
        # a re-record into the same (run_dir, namespace) under a NEW id must
        # drop the stale registration on BOTH paths — a dangling record
        # would show as a ghost in `runs list` and pin dead chunks through
        # registry-driven gc forever
        self._sweep_stale(run_id, run_dir, namespace)
        if exclusive:
            # loop instead of falling through: under true multi-PROCESS
            # contention a loser of the link race can observe the path
            # vanish again (the winner finished and was unregistered, or a
            # sweep raced us) — re-reading and falling through to the
            # unconditional write below would claim the id NON-atomically,
            # silently clobbering whichever peer re-created it in between.
            # Every exit from this loop is either an atomic create we won,
            # a RunIdCollision, or proof the existing record is OURS.
            for _ in range(64):
                prev = self.get(run_id)
                if prev is None:
                    if self._create_exclusive(rec):
                        return rec
                    continue       # lost the link race: reload and re-check
                if (prev.get("run_dir") != run_dir
                        or prev.get("namespace") != namespace):
                    raise RunIdCollision(
                        f"run id {run_id!r} is already registered for "
                        f"{prev.get('run_dir')!r} "
                        f"(ns {prev.get('namespace')!r})")
                break     # our own stale/resumed registration — replaceable
            else:
                raise RuntimeError(
                    f"exclusive registration of {run_id!r} could not "
                    f"stabilize — registry under pathological churn")
        prev = self.get(run_id)
        if prev:
            # a crash-restart/resume re-registers the same run id: its
            # prior final_keys must survive until finalize() updates
            # them, or a no-op resume would break every descendant's
            # warm start
            rec["final_keys"] = dict(prev.get("final_keys") or {})
        self._write(rec)
        return rec

    def _sweep_stale(self, run_id: str, run_dir: Optional[str],
                     namespace: Optional[str]):
        """Unregister OTHER run ids previously recorded into the same
        (run_dir, namespace) — their manifests were overwritten anyway."""
        if run_dir is None:
            return
        for other in self.list_runs():
            if other["run_id"] != run_id \
                    and other.get("run_dir") == run_dir \
                    and other.get("namespace") == namespace:
                self.unregister(other["run_id"])

    def _create_exclusive(self, rec: dict) -> bool:
        """Atomically publish a NEW run record; False when the path already
        exists (a concurrent recorder won). The record is fully written to a
        temp file first and published via hard link, so a racing reader can
        never observe a torn record under the final name."""
        path = self._path(rec["run_id"])
        tmp = path + f".tmp.{os.getpid()}.{threading.get_ident()}"
        try:
            with open(tmp, "wb") as f:
                f.write(json.dumps(rec, indent=1, default=str).encode())
            try:
                os.link(tmp, path)     # atomic create-if-absent
                return True
            except FileExistsError:
                return False
        finally:
            try:
                os.remove(tmp)
            except OSError:
                pass

    def finalize(self, run_id: str, final_keys: dict,
                 status: str = "finished") -> Optional[dict]:
        """Record the per-scope tip checkpoints when a record run completes —
        the manifests a derived run's warm start resolves against. MERGES
        into the existing keys: a resumed run that re-submitted nothing for
        a scope keeps that scope's previous tip."""
        rec = self.get(run_id)
        if rec is None:
            return None
        rec["final_keys"] = {**(rec.get("final_keys") or {}),
                             **dict(final_keys)}
        rec["status"] = status
        rec["finished_at"] = time.time()
        self._write(rec)
        return rec

    def unregister(self, run_id: str) -> bool:
        """Drop a run's registration. Its manifests stay on disk until the
        next ``gc``, which reclaims whatever no surviving run's closure
        reaches."""
        try:
            os.remove(self._path(run_id))
            return True
        except FileNotFoundError:
            return False

    def _write(self, rec: dict):
        _atomic_write(self._path(rec["run_id"]),
                      json.dumps(rec, indent=1, default=str).encode())

    # ----------------------------------------------------------- queries --
    def get(self, run_id: str) -> Optional[dict]:
        try:
            with open(self._path(run_id)) as f:
                return json.load(f)
        except FileNotFoundError:
            return None

    def list_runs(self) -> list[dict]:
        out = []
        for fn in os.listdir(self.root):
            if not fn.endswith(".json"):
                continue
            try:
                with open(os.path.join(self.root, fn)) as f:
                    out.append(json.load(f))
            except (OSError, json.JSONDecodeError):
                continue      # torn write from a crashed run: skip, not fatal
        return sorted(out, key=lambda r: (r.get("created_at") or 0,
                                          r.get("run_id", "")))

    def ancestry(self, run_id: str) -> list[dict]:
        """Run records from `run_id` back to the root of its lineage
        (cycle-safe; stops at the first unregistered ancestor)."""
        chain = []
        seen = set()
        cur = run_id
        while cur is not None and cur not in seen:
            seen.add(cur)
            rec = self.get(cur)
            if rec is None:
                break
            chain.append(rec)
            cur = rec.get("parent")
        return chain

    # ---------------------------------------------------------------- gc --
    def live_keys(self, store,
                  exclude_run_id: Optional[str] = None) -> list[str]:
        """Qualified manifest keys of every registered run — the multi-run
        live set. ``store.gc`` extends it with the cross-run parent closure,
        so a chunk survives while ANY registered run can still resolve a
        manifest through it. `exclude_run_id` lets a run apply its OWN
        retention policy while keeping every sibling fully live."""
        from repro_torch.checkpoint.store import filter_orphan_members
        live = []
        for rec in self.list_runs():
            if exclude_run_id is not None \
                    and rec.get("run_id") == exclude_run_id:
                continue
            ns = rec.get("namespace")
            # orphan member manifests — shard members whose v4 stitch was
            # never written because a host died between publication and
            # stitch — must not SEED the closure (they'd pin their own
            # chunks forever); members of stitched checkpoints re-enter
            # through the v4's member walk, and incomplete predecessors a
            # later delta inherits from re-enter through per-shard parent
            # chains, so nothing live is lost
            for k in filter_orphan_members(store.list_keys(run=ns)):
                # "::key" = explicit flat namespace, immune to whatever
                # namespace the store handle happens to be bound to
                live.append(f"{ns or ''}::{k}")
        return live

    def gc(self, store) -> dict:
        """Multi-run collection: keep the union of all registered runs'
        manifest closures, delete everything else (manifests of unregistered
        runs, then unreachable chunks)."""
        return store.gc(self.live_keys(store))


def registry_dirsig(store_root: str) -> Optional[list]:
    """Cheap change signature of the registry directory — (mtime_ns, number
    of JSON records) of ``<store_root>/runs/``. The query index stamps its
    runs-table mirror with the signature it was built under; a mismatch at
    query time means registrations/removals/finalizations happened since and
    the mirror must not be trusted. The directory is stat'ed BEFORE it is
    listed so a write racing this read can only make the mirror look stale
    (re-sync), never current with missing rows. None when no registry
    directory exists (legacy pseudo-run stores — never index-served)."""
    root = os.path.join(store_root, "runs")
    try:
        st = os.stat(root)
        n = sum(1 for fn in os.listdir(root) if fn.endswith(".json"))
    except OSError:
        return None
    return [int(st.st_mtime_ns), n]


def _fsafe(run_id: str) -> str:
    return run_id.replace("/", "_").replace(":", "_")
