"""Double-buffered host prefetch around the synthetic source.

The producer thread builds batch t+1 while the device runs step t, so input
generation never sits on the critical path (this matters for Flor's record
overhead measurements: the vanilla baseline and the Flor run share the same
input pipeline cost).
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional


class PrefetchLoader:
    def __init__(self, make_batch: Callable[[int], dict], start_step: int,
                 num_steps: int, depth: int = 2):
        self._make = make_batch
        self._range = range(start_step, start_step + num_steps)
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._err: Optional[BaseException] = None
        self._t = threading.Thread(target=self._produce, daemon=True)
        self._t.start()

    def _produce(self):
        try:
            for s in self._range:
                self._q.put((s, self._make(s)))
        except BaseException as e:              # surfaced on next __next__
            self._err = e
        finally:
            self._q.put(None)

    def __iter__(self) -> Iterator:
        while True:
            item = self._q.get()
            if item is None:
                if self._err:
                    raise self._err
                return
            yield item
