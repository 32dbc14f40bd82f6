"""Cost-balanced replay scheduling.

Two halves:

* **Partitioning** — LPT (longest-processing-time-first) over the plan's
  per-segment cost estimates, replacing the blind contiguous
  ``pid``/``nworkers`` split. Delta chains make per-epoch resume cost
  non-uniform (resolve depth 1 vs K) and real workloads make per-epoch
  exec cost non-uniform (measured in the record-side block profile); LPT's
  makespan is within 4/3 of optimal, and on skewed runs it beats the
  contiguous split by exactly the skew (see benchmarks/replay_latency.py).
  ``contiguous_shares`` is kept for the deprecation shim and as the
  benchmark baseline.

* **DynamicExecutor** — a work-queue over worker slots: tasks (one per
  share, or finer with ``tasks_per_worker``) are pulled by up to G
  concurrent runners; a failed task is re-queued (bounded attempts); an
  optional straggler policy speculatively re-issues the longest-running
  task when slots idle — first completion wins, the loser is cancelled.
  ``run_task(task, attempt, cancelled)`` is caller-supplied: the launcher
  spawns worker subprocesses, tests pass stub callables.
"""
from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

MIN_STRAGGLER_HORIZON_S = 1.0
# default speculation horizon multiplier once tasks carry MEASURED cost
# estimates (record-side block profile + learned restore model): a task
# running 3x its estimate is a straggler worth duplicating. Launchers apply
# this only when estimates are measured — with fallback-constant estimates
# the horizon would be noise, so speculation stays off unless asked for.
DEFAULT_STRAGGLER_FACTOR = 3.0


def measured_straggler_factor(tasks: list) -> float:
    """The measured-default speculation policy: DEFAULT_STRAGGLER_FACTOR
    when every task has a positive cost estimate (the plan had real
    profile/calibration data to set horizons from), else 0.0 (off)."""
    if tasks and all(t.est_cost_s > 0 for t in tasks):
        return DEFAULT_STRAGGLER_FACTOR
    return 0.0


# ------------------------------------------------------------ partitioning --
def contiguous_shares(segments: list, nworkers: int) -> list[list]:
    """The legacy split: contiguous runs of segments, balanced by COUNT
    (not cost) to within one."""
    n = len(segments)
    shares = []
    base, rem = divmod(n, nworkers)
    start = 0
    for pid in range(nworkers):
        size = base + (1 if pid < rem else 0)
        shares.append(list(segments[start:start + size]))
        start += size
    return shares


def balanced_shares(segments: list, nworkers: int) -> list[list]:
    """LPT over segment cost estimates: sort by decreasing cost, place each
    on the least-loaded worker. Shares come back in segment (epoch) order
    so downstream visit derivation stays monotone."""
    order = {id(s): i for i, s in enumerate(segments)}
    shares: list[list] = [[] for _ in range(nworkers)]
    loads = [0.0] * nworkers
    for seg in sorted(segments, key=lambda s: (-s.cost, order[id(s)])):
        w = min(range(nworkers), key=lambda i: (loads[i], i))
        shares[w].append(seg)
        loads[w] += seg.cost
    for sh in shares:
        sh.sort(key=lambda s: order[id(s)])
    return shares


def share_cost(plan, share: list) -> float:
    """Estimated wall seconds for ONE worker running `share`: its exec work
    plus the init restores its visit list actually pays (strong init walks
    the whole prefix; weak jumps to checkpoint anchors)."""
    by_epoch = {s.epoch: s for s in plan.segments}
    total = 0.0
    for epoch, phase in plan.visits_for(share):
        seg = by_epoch[epoch]
        if phase == "exec":
            total += seg.cost
        else:
            # init: restore when a checkpoint exists, logical redo otherwise
            total += seg.restore_cost_s if seg.has_ckpt else seg.exec_cost_s
    return total


# --------------------------------------------------------- dynamic executor --
@dataclass
class Task:
    """One schedulable unit: a worker share plus its derived visit list."""
    task_id: int
    visits: list                     # [(epoch, "init"|"exec"), ...]
    epochs: list = field(default_factory=list)   # work epochs it OWNS
    est_cost_s: float = 0.0
    payload: Any = None              # caller scratch (e.g. argv extras)
    host: int = 0                    # preferred host queue (sharded replay)


def assign_hosts(tasks: list, n_hosts: int) -> list:
    """LPT host placement for sharded replay: heaviest task first onto the
    least-loaded host. Mutates each task's ``host`` in place and returns the
    list; the DynamicExecutor's per-host queues then keep each task near its
    store shard while still allowing idle hosts to steal."""
    n = max(1, int(n_hosts))
    loads = [0.0] * n
    for t in sorted(tasks, key=lambda t: -t.est_cost_s):
        h = min(range(n), key=lambda i: (loads[i], i))
        t.host = h
        loads[h] += t.est_cost_s
    return tasks


class TaskFailure(RuntimeError):
    """One or more tasks exhausted their attempts; `.errors` maps task_id
    to the list of raised exceptions."""

    def __init__(self, errors: dict):
        super().__init__(f"tasks failed after retries: {sorted(errors)}")
        self.errors = errors


class DynamicExecutor:
    """Work-queue execution of tasks over `nworkers` concurrent slots.

    * failure re-queue: a task whose run_task raises is retried on another
      slot up to `max_attempts` total attempts;
    * straggler re-queue: with `straggler_factor` > 0, an idle slot
      speculatively duplicates the longest-running task once it has run
      longer than ``straggler_factor * max(est_cost, median completed)``;
      the first attempt to finish wins and the other is cancelled via the
      per-attempt ``cancelled`` event passed to run_task;
    * incremental completion: `on_complete(task, attempt, result)` fires as
      each task FIRST completes — the launcher merges that task's logs into
      the growing merged view right there, instead of waiting for the
      slowest worker;
    * host affinity: with `n_hosts` > 1 each task carries a preferred host
      (see :func:`assign_hosts`) and workers drain their home host's queue
      before stealing — sharded-store restores stay near their shard.

    ``run()`` returns {task_id: (attempt, result)} and raises
    :class:`TaskFailure` if any task permanently failed.
    """

    def __init__(self, tasks: list, run_task: Callable, nworkers: int, *,
                 max_attempts: int = 2, straggler_factor: float = 0.0,
                 on_complete: Optional[Callable] = None, n_hosts: int = 1):
        self.tasks = list(tasks)
        self.run_task = run_task
        self.nworkers = max(1, int(nworkers))
        self.max_attempts = max(1, int(max_attempts))
        self.straggler_factor = float(straggler_factor)
        self.on_complete = on_complete
        # one queue per host: workers drain their home queue first and only
        # then steal, so sharded-replay tasks mostly run near their store
        # shard while idle hosts still keep the makespan bounded
        self.n_hosts = max(1, int(n_hosts))
        self._qs: list["queue.Queue"] = [queue.Queue()
                                         for _ in range(self.n_hosts)]
        self._lock = threading.Lock()
        self._done: dict[int, tuple[int, Any]] = {}
        self._errors: dict[int, list] = {}
        self._failed: set[int] = set()
        self._attempts: dict[int, int] = {}
        self._running: dict[tuple[int, int], float] = {}
        self._cancels: dict[tuple[int, int], threading.Event] = {}
        self._durations: list[float] = []

    # ------------------------------------------------------------ control --
    def run(self) -> dict:
        for t in self.tasks:
            self._attempts[t.task_id] = 1
            self._qs[t.host % self.n_hosts].put((t, 1))
        # with speculation on, keep ALL slots alive even when tasks <
        # workers: an idle slot is what picks up a straggler's duplicate
        nthreads = self.nworkers if self.straggler_factor > 0 \
            else min(self.nworkers, max(1, len(self.tasks)))
        threads = [threading.Thread(target=self._worker,
                                    args=(i % self.n_hosts,), daemon=True)
                   for i in range(nthreads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        if self._failed:
            raise TaskFailure({tid: self._errors.get(tid, [])
                               for tid in self._failed})
        return dict(self._done)

    def _resolved(self, tid: int) -> bool:
        return tid in self._done or tid in self._failed

    def _all_resolved(self) -> bool:
        return all(self._resolved(t.task_id) for t in self.tasks)

    def _try_get(self, home: int):
        """Pop from the home host's queue first, then steal round-robin from
        the others. Raises queue.Empty when every queue is drained."""
        order = [home] + [i for i in range(len(self._qs)) if i != home]
        for i in order:
            try:
                return self._qs[i].get_nowait()
            except queue.Empty:
                continue
        raise queue.Empty

    def _next(self, home: int = 0):
        """Atomically claim the next (task, attempt, cancelled) for an idle
        slot, or None to exit. Pop and claim happen under ONE lock — the
        same lock the give-up check takes — so a popped-but-unregistered
        task can never be mistaken for an exhausted one."""
        while True:
            with self._lock:
                try:
                    task, attempt = self._try_get(home)
                except queue.Empty:
                    if self._all_resolved():
                        return None
                    dup = self._pick_straggler()
                    if dup is not None:
                        return self._claim(*dup)
                    if not self._running:
                        # nothing running, nothing queued, not all resolved:
                        # tasks exhausted attempts — mark them failed
                        for t in self.tasks:
                            if not self._resolved(t.task_id):
                                self._failed.add(t.task_id)
                        return None
                else:
                    if self._resolved(task.task_id):
                        continue   # a duplicate of an already-finished task
                    return self._claim(task, attempt)
            time.sleep(0.02)

    def _claim(self, task, attempt):
        """Register a claimed attempt as running (lock held)."""
        cancelled = threading.Event()
        self._running[(task.task_id, attempt)] = time.monotonic()
        self._cancels[(task.task_id, attempt)] = cancelled
        return task, attempt, cancelled

    def _pick_straggler(self):
        """Speculatively duplicate the longest-running task (lock held)."""
        if self.straggler_factor <= 0 or not self._running:
            return None
        med = sorted(self._durations)[len(self._durations) // 2] \
            if self._durations else 0.0
        now = time.monotonic()
        best = None
        for (tid, attempt), t0 in self._running.items():
            if self._resolved(tid):
                continue
            if self._attempts[tid] >= self.max_attempts:
                continue
            task = next(t for t in self.tasks if t.task_id == tid)
            # the floor keeps bad (near-zero) estimates from triggering
            # speculation during ordinary startup (e.g. jit warmup)
            horizon = self.straggler_factor * max(task.est_cost_s, med,
                                                  MIN_STRAGGLER_HORIZON_S)
            if now - t0 > horizon and (best is None
                                       or t0 < self._running[best]):
                best = (tid, attempt)
        if best is None:
            return None
        tid, _ = best
        task = next(t for t in self.tasks if t.task_id == tid)
        self._attempts[tid] += 1
        return task, self._attempts[tid]

    # ------------------------------------------------------------- worker --
    def _worker(self, home: int = 0):
        while True:
            item = self._next(home)
            if item is None:
                return
            task, attempt, cancelled = item
            key = (task.task_id, attempt)
            t0 = time.monotonic()
            try:
                result = self.run_task(task, attempt, cancelled)
                err = None
            except Exception as e:          # noqa: BLE001 — task isolation
                result, err = None, e
            dt = time.monotonic() - t0
            callback = None
            with self._lock:
                self._running.pop(key, None)
                self._cancels.pop(key, None)
                if err is None and not cancelled.is_set():
                    self._durations.append(dt)
                    if task.task_id not in self._done:
                        self._done[task.task_id] = (attempt, result)
                        self._failed.discard(task.task_id)
                        callback = self.on_complete
                        # cancel any still-running duplicate attempt
                        for (tid, att), ev in self._cancels.items():
                            if tid == task.task_id:
                                ev.set()
                elif err is not None and task.task_id not in self._done:
                    self._errors.setdefault(task.task_id, []).append(err)
                    if self._attempts[task.task_id] < self.max_attempts:
                        self._attempts[task.task_id] += 1
                        self._qs[task.host % self.n_hosts].put(
                            (task, self._attempts[task.task_id]))
                    else:
                        running_elsewhere = any(
                            tid == task.task_id for tid, _ in self._running)
                        if not running_elsewhere:
                            self._failed.add(task.task_id)
            if callback is not None:
                callback(task, attempt, result)
