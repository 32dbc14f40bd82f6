"""Background logging subsystem (paper task (i): efficient background
logging in Python).

``flor.log`` on the record/replay step path is a non-blocking enqueue; a
background stage owns device->host copies, JSON serialization, large-value
spill to the checkpoint store, and crash-safe segment-file I/O. The
segmented reader keeps the historical one-row-per-line contract for every
consumer (deferred check, replay merge, cross-run query), whichever layout
a stream was written in. See ``docs/logging.md`` for the overhead model
and the on-disk format.

Modules:
  * ``stream``   — :class:`FingerprintLog`, the per-run log stream facade
  * ``segment``  — segment files, seal footers, torn-tail-tolerant reader
  * ``jsonable`` — value lowering + :class:`FlorLogValueWarning`
"""
from repro_torch.logging.jsonable import (FlorLogValueWarning, jsonable,  # noqa: F401
                                    reset_warned_keys)
from repro_torch.logging.segment import (DEFAULT_ROLL_BYTES, SegmentSink,  # noqa: F401
                                   list_segments, read_stream,
                                   remove_stream, segment_path, tail_seq)
from repro_torch.logging.stream import (DEFAULT_QUEUE_DEPTH,  # noqa: F401
                                  DEFAULT_SPILL_BYTES, FingerprintLog)
