"""Background work stages (paper section 5.1) — the FIFO job-stage substrate
behind BOTH checkpoints and logs.

The paper forks a child process to snapshot mutable PyTorch tensors with
copy-on-write. Here the train step is functional (kernels and optimizer
return NEW tensors and never write in place, train/step.py), so a
"snapshot" is a reference — the training thread captures references and
returns; a daemon worker thread then performs the heavy half of the work.
A bounded queue applies backpressure so record can never run unboundedly
ahead of the disk.

Two layers live here:

* :class:`AsyncStage` — the generic single-worker FIFO stage: a bounded
  queue, a daemon thread draining it through a ``process(item)`` callable,
  error capture surfaced on the next ``put``/``drain``, and
  ``drain``/``close`` lifecycle. The background LOG writer
  (``repro_torch.logging.stream``) runs its serialize+spill+segment-write work on
  this same stage type — the step path only enqueues.
* :class:`AsyncWriter` — the checkpoint materialization stage built on it.
  The unit of work is a job callable ``fn(store) -> stat dict``:

  - ``submit(key, tree, meta)`` — the classic whole-tree path: the job does
    device->host transfer of every leaf (``.cpu()`` releases the GIL
    during the copy), chunking, hashing, compression and I/O.
  - ``submit_job(key, fn)`` — the delta pipeline's path: the pipeline has
    already gathered only the CHANGED blocks to host; the job just hashes,
    compresses, writes, and emits the manifest.

  Materialization wall time per job is reported to a callback — that is the
  M_i the adaptive controller (core/adaptive.py) consumes.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Optional

_STOP = object()


class AsyncStage:
    """A bounded FIFO queue drained by one daemon worker thread.

    ``put`` blocks when the queue is full (backpressure) unless
    ``block=False``, in which case it returns False and the caller decides
    what to skip. A processing exception is captured and re-raised on the
    NEXT ``put``/``drain``/``close`` — same contract the checkpoint writer
    has always had: background failures can't be silent, but they surface
    on the submitting thread, not inside the worker."""

    def __init__(self, process: Callable, max_queue: int = 2):
        self._process = process
        self._q: queue.Queue = queue.Queue(maxsize=max_queue)
        self._err: Optional[BaseException] = None
        self._closed = False
        self._t = threading.Thread(target=self._worker, daemon=True)
        self._t.start()

    def _worker(self):
        while True:
            item = self._q.get()
            try:
                if item is _STOP:
                    return
                self._process(item)
            except BaseException as e:   # surfaced on next put/drain
                self._err = e
            finally:
                self._q.task_done()

    def put(self, item, block: bool = True) -> bool:
        """Enqueue one work item. Returns False when the queue is full and
        ``block=False`` (bounded overhead: the caller may drop the item)."""
        if self._err:
            raise self._err
        try:
            self._q.put(item, block=block)
            return True
        except queue.Full:
            return False

    def drain(self):
        self._q.join()
        if self._err:
            raise self._err

    def close(self):
        if self._closed:
            return
        self._closed = True
        self._q.join()
        self._q.put(_STOP)
        self._t.join()
        if self._err:
            raise self._err


class AsyncWriter:
    """Checkpoint materialization stage: FIFO jobs ``fn(store)`` executed on
    the writer thread, per-job wall time reported to ``on_materialized``."""

    def __init__(self, store, max_queue: int = 2,
                 on_materialized: Optional[Callable] = None):
        self.store = store
        self._on_mat = on_materialized
        self._stats: list[dict] = []
        self._stage = AsyncStage(self._run, max_queue=max_queue)

    def _run(self, item):
        key, fn = item
        t0 = time.perf_counter()
        stat = fn(self.store) or {}
        stat.setdefault("key", key)
        stat["materialize_s"] = time.perf_counter() - t0
        self._stats.append(stat)
        if self._on_mat:
            self._on_mat(stat)

    def submit_job(self, key: str, fn: Callable, block: bool = True) -> bool:
        """Enqueue a materialization job. Returns False if the queue is full
        and block=False (caller may skip this checkpoint — bounded
        overhead)."""
        return self._stage.put((key, fn), block=block)

    def submit(self, key: str, tree, meta: Optional[dict] = None,
               block: bool = True) -> bool:
        """Whole-tree checkpoint (v1 manifest): transfer + store in the
        background."""
        return self.submit_job(key, _full_tree_job(key, tree, meta), block)

    def drain(self):
        self._stage.drain()

    def close(self):
        self._stage.close()

    @property
    def stats(self):
        return list(self._stats)


def _full_tree_job(key: str, tree, meta: Optional[dict]) -> Callable:
    def job(store):
        import torch

        from repro_torch.utils.pytree import tree_map
        host_tree = tree_map(
            lambda x: x.detach().cpu() if isinstance(x, torch.Tensor) else x,
            tree)
        return store.put_tree(key, host_tree, meta)
    return job
