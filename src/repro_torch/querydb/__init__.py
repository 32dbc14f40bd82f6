"""FlorDB-style incremental query engine: an indexed, incrementally-
maintained sqlite mirror of every run's fingerprint logs, living at
``<store_root>/index/flor.db`` behind the ``log_records``/``pivot`` query
surface. See ``docs/queries.md`` for the schema, the watermark/freshness
rules, and the bit-identity contract with the file-scan path."""
from repro_torch.querydb.index import (LogIndex, ensure_index, index_path,
                                 open_index)
from repro_torch.querydb.maintain import SegmentIndexer, reindex
from repro_torch.querydb.schema import FLAT_SEG, SCHEMA_VERSION

__all__ = ["LogIndex", "index_path", "open_index", "ensure_index",
           "SegmentIndexer", "reindex", "FLAT_SEG", "SCHEMA_VERSION"]
