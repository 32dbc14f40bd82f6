"""The port's query surface on the CPU: the sqlite log index the background
log stage maintains as segments seal (``repro_torch.querydb``), replay
re-attempt invalidation, reindex catch-up, lineage filters, where / limit /
tail, spill refs, schema fallback — each answered identically by the index
and the file scan — and the cross-package contract: on one store, the
port's ``log_records`` / ``pivot`` rows equal ``repro.core.query``'s, and
an index written by either package serves the other's ``engine="index"``.

Inputs: tiny float64 states and logged floats; the spill case logs a
64-element numpy array.
"""
import json
import os

import numpy as np
import pytest
import torch

import repro_torch.flor as flor
from repro_torch.checkpoint.lineage import RunRegistry
from repro_torch.core.query import _ancestors, log_records, pivot
from repro_torch.logging import FingerprintLog, list_segments
from repro_torch.querydb import (LogIndex, SegmentIndexer, index_path,
                                 open_index, reindex)


def _state(x=0.0):
    return {"w": torch.arange(6.0, dtype=torch.float64) + x,
            "b": torch.zeros(3, dtype=torch.float64) + x}


def _record(run_dir, store, run_id, parent=None, epochs=2, **spec_kw):
    lineage = flor.LineageSpec(store_root=store, run_id=run_id,
                               parent_run=parent)
    with flor.Session(run_dir, record=flor.RecordSpec(adaptive=False,
                                                      **spec_kw),
                      lineage=lineage) as sess:
        with sess.checkpointing(state=_state()) as ckpt:
            for e in sess.loop("epochs", range(epochs)):
                for _ in sess.loop("train", range(2)):
                    ckpt.state = {k: v + 1.0 for k, v in ckpt.state.items()}
                sess.log("loss", 1.0 / (e + 1))
                sess.log("acc", e * 0.125)


def _replay(run, probe_value, epochs=2):
    with flor.Session(run, mode="replay") as sess:
        with sess.checkpointing(state=_state()):
            for _ in sess.loop("epochs", range(epochs)):
                for _ in sess.loop("train", range(2)):
                    pass
        sess.log("probe", probe_value)


def _assert_engines_agree(path, **kw):
    files = log_records(path, engine="files", **kw)
    assert log_records(path, engine="auto", **kw) == files
    assert log_records(path, engine="index", **kw) == files
    return files


# ------------------------------------------------ live seal-hook feeder ----
def test_seal_hook_indexes_rolled_segments_not_tail(tmp_path):
    """Rolled (sealed) segments are ingested the moment they seal; the
    unsealed tail never is — mid-run queries fall back to the file scan and
    stay identical, and close-time sealing makes the run index-served."""
    store = str(tmp_path / "store")
    run_dir = str(tmp_path / "run")
    registry = RunRegistry(store)
    registry.register("r1", run_dir=run_dir)
    indexer = SegmentIndexer(store, "r1", "record", registry=registry)
    lp = os.path.join(run_dir, "logs", "record.jsonl")
    log = FingerprintLog(lp, async_log=True, store=None,
                         on_seal=indexer.on_seal, roll_bytes=256)
    for i in range(40):
        log.log(i // 10, "loss", float(i))
    log.drain()
    while len(LogIndex(store).stream_segments("r1", "record")) \
            >= len(list_segments(lp)):
        log.log(4, "loss", float(len(list_segments(lp)) * 1000))
        log.drain()
    idx = LogIndex(store)
    marks = idx.stream_segments("r1", "record")
    assert marks, "rolled segments were not ingested by the seal hook"
    assert len(marks) < len(list_segments(lp))      # tail not watermarked
    streams = [("record", lp)]
    assert not idx.covers("r1", streams)
    idx.close()
    files = log_records(store, engine="files")
    assert [r["value"] for r in files[:40]] == [float(i) for i in range(40)]
    assert log_records(store, engine="auto") == files
    with pytest.raises(RuntimeError):
        log_records(store, engine="index")
    log.close()                        # seals the tail -> hook ingests it
    indexer.finish(registry)
    idx = LogIndex(store)
    assert idx.covers("r1", streams)
    idx.close()
    _assert_engines_agree(store)


# ------------------------------------------------ replay rotation ----------
def test_replay_reattempt_invalidates_stream(tmp_path):
    store = str(tmp_path / "store")
    run = str(tmp_path / "run")
    _record(run, store, "base", epochs=2)
    for attempt in range(2):           # two replay attempts, same pid
        _replay(run, attempt * 100)
    rows = _assert_engines_agree(store)
    # only the LAST attempt's row survives: rotation truncated the stream
    # and invalidation dropped the indexed rows of the previous attempt
    assert [r["value"] for r in rows if r["key"] == "probe"] == [100]
    idx = LogIndex(store)
    vals = [json.loads(v) for (v,) in idx.conn.execute(
        "SELECT value_json FROM records WHERE key='probe'")]
    idx.close()
    assert vals == [100]


# ------------------------------------------------ reindex catch-up ---------
def test_reindex_catches_up_unindexed_runs_and_stale_tails(tmp_path):
    store = str(tmp_path / "store")
    _record(str(tmp_path / "a"), store, "base", log_index=False)
    _record(str(tmp_path / "b"), store, "ft1", parent="base",
            log_index=False)
    assert open_index(store) is None
    with pytest.raises(RuntimeError):
        log_records(store, engine="index")
    stats = reindex(store)
    assert stats["runs"] == 2 and stats["records"] > 0
    assert os.path.exists(index_path(store))
    _assert_engines_agree(store)
    _assert_engines_agree(store, lineage="ft1")
    # grow a stream past its watermark: the index refuses until reindex
    log = FingerprintLog(os.path.join(str(tmp_path / "a"), "logs",
                                      "record.jsonl"))
    log.log(9, "late", 3.14)
    log.close()
    auto = log_records(store, engine="auto")
    assert auto == log_records(store, engine="files")
    assert any(r["key"] == "late" for r in auto)
    with pytest.raises(RuntimeError):
        log_records(store, engine="index")
    assert reindex(store)["segments_ingested"] >= 1
    assert any(r["key"] == "late"
               for r in log_records(store, engine="index"))
    third = reindex(store)             # idempotent when nothing changed
    assert third["segments_ingested"] == 0 and third["segments_pruned"] == 0


# ------------------------------------------------ lineage CTE --------------
def test_lineage_cte_matches_python_walk(tmp_path):
    store = str(tmp_path / "store")
    _record(str(tmp_path / "a"), store, "base")
    _record(str(tmp_path / "b"), store, "mid", parent="base")
    _record(str(tmp_path / "c"), store, "leaf", parent="mid")
    listing = RunRegistry(store).list_runs()
    idx = LogIndex(store)
    for rid in ("base", "mid", "leaf", "nosuch"):
        assert idx.ancestry_ids(rid) == _ancestors(listing, rid)
    idx.close()
    for rid in ("base", "mid", "leaf"):
        rows = _assert_engines_agree(store, lineage=rid)
        assert {r["run_id"] for r in rows} == \
            {"base", "mid", "leaf"} & _ancestors(listing, rid)
    assert pivot(store, "loss", lineage="mid", engine="index") == \
        pivot(store, "loss", lineage="mid", engine="files")


# ------------------------------------------------ filters ------------------
WHERE_CASES = [
    {}, {"key": "loss"}, {"key": ("loss", "acc")}, {"where": {"key": "loss"}},
    {"where": {"epoch": 1}}, {"where": {"epoch": 1, "key": "acc"}},
    {"where": {"source": "record"}}, {"where": {"run_id": "ft1"}},
    {"where": {"value": 0.5}}, {"limit": 3}, {"limit": 0}, {"tail": 4},
    {"limit": 8, "tail": 2}, {"where": {"key": "loss"}, "limit": 2},
    {"where": {"key": "loss"}, "tail": 2},
    {"run": "base", "where": {"epoch": 2}, "limit": 1},
]


def test_where_limit_tail_equivalence(tmp_path):
    store = str(tmp_path / "store")
    _record(str(tmp_path / "a"), store, "base", epochs=3)
    _record(str(tmp_path / "b"), store, "ft1", parent="base", epochs=3)
    for kw in WHERE_CASES:
        _assert_engines_agree(store, **kw)
    assert len(log_records(store, limit=3, engine="index")) == 3
    assert log_records(store, tail=2, engine="index") == \
        log_records(store, engine="index")[-2:]


# ------------------------------------------------ spill refs ---------------
def test_spill_refs_indexed_and_inlined_identically(tmp_path):
    store = str(tmp_path / "store")
    run = str(tmp_path / "run")
    lineage = flor.LineageSpec(store_root=store, run_id="base")
    with flor.Session(run, record=flor.RecordSpec(adaptive=False,
                                                  log_spill_bytes=64),
                      lineage=lineage) as sess:
        with sess.checkpointing(state=_state()) as ckpt:
            for e in sess.loop("epochs", range(2)):
                for _ in sess.loop("train", range(2)):
                    ckpt.state = {k: v + 1.0
                                  for k, v in ckpt.state.items()}
                sess.log("hist", np.arange(64.0) + e)   # 512 B > 64 B
    idx = LogIndex(store)
    refs = idx.conn.execute(
        "SELECT spill_ref, spill_digest FROM records "
        "WHERE spill_ref IS NOT NULL").fetchall()
    idx.close()
    assert len(refs) == 2 and all(d for _, d in refs)
    rows = _assert_engines_agree(store, key="hist")
    assert all(isinstance(r["value"], dict) and "ref" in r["value"]
               for r in rows)
    fi = log_records(store, key="hist", inline_spill_bytes=1 << 20,
                     engine="files")
    ix = log_records(store, key="hist", inline_spill_bytes=1 << 20,
                     engine="index")
    assert fi == ix
    assert fi[0]["value"] == list(np.arange(64.0))


# ------------------------------------------------ schema fallback ----------
def test_future_schema_degrades_to_file_scan(tmp_path):
    store = str(tmp_path / "store")
    _record(str(tmp_path / "a"), store, "base")
    idx = LogIndex(store)
    with idx.conn:
        idx.conn.execute("UPDATE meta SET v='999' WHERE k='schema_version'")
    idx.close()
    assert open_index(store) is None
    assert log_records(store) == log_records(store, engine="files")
    with pytest.raises(RuntimeError):
        log_records(store, engine="index")


# ------------------------------------------------ lineage fixture ----------
def test_bit_identity_on_lineage_fixture(tmp_path):
    """A warm-started derived run answers identically from both engines,
    from the store root and from the run dir's binding."""
    store = str(tmp_path / "store")
    _record(str(tmp_path / "base"), store, "base")
    with flor.Session(str(tmp_path / "ft1"), mode="record",
                      record=flor.RecordSpec(adaptive=False),
                      lineage=flor.LineageSpec(store_root=store,
                                               run_id="ft1",
                                               parent_run="base")) as sess:
        start = sess.warm_start("train", like={"state": _state()})
        with sess.checkpointing(state=start["state"]) as ckpt:
            for e in sess.loop("epochs", range(2)):
                for _ in sess.loop("train", range(3)):
                    ckpt.state = {k: v + 1.0
                                  for k, v in ckpt.state.items()}
                sess.log("loss", float(ckpt.state["w"][0]))
    _assert_engines_agree(store)
    assert pivot(store, "loss", engine="index") == \
        pivot(store, "loss", engine="files")
    assert pivot(str(tmp_path / "ft1"), "loss", engine="index") == \
        pivot(str(tmp_path / "ft1"), "loss", engine="files")
    # ft1 continues from base's final state: w[0] = 4 after base, +3, +3
    assert [r["loss"] for r in pivot(store, "loss", run="ft1")] == \
        [7.0, 10.0]


# ------------------------------------------------------- cross-package --
def _jax_record(run_dir, store, run_id, parent=None):
    """The same lineage recording through the reference package."""
    import repro.flor as jflor
    lineage = jflor.LineageSpec(store_root=store, run_id=run_id,
                                parent_run=parent)
    with jflor.Session(run_dir, record=jflor.RecordSpec(adaptive=False),
                       lineage=lineage) as sess:
        state = {k: v.numpy() for k, v in _state().items()}
        if parent is not None:
            state = sess.warm_start("train", like=state)
        with sess.checkpointing(state=state) as ckpt:
            for e in sess.loop("epochs", range(3)):
                for _ in sess.loop("train", range(2)):
                    ckpt.state = {k: np.asarray(v) + 1.0
                                  for k, v in ckpt.state.items()}
                sess.log("loss", float(np.asarray(ckpt.state["w"])[0]))
                sess.log("acc", e * 0.125)


def _torch_record(run_dir, store, run_id, parent=None):
    lineage = flor.LineageSpec(store_root=store, run_id=run_id,
                               parent_run=parent)
    with flor.Session(run_dir, record=flor.RecordSpec(adaptive=False),
                      lineage=lineage) as sess:
        state = _state()
        if parent is not None:
            state = sess.warm_start("train", like=state)
        with sess.checkpointing(state=state) as ckpt:
            for e in sess.loop("epochs", range(3)):
                for _ in sess.loop("train", range(2)):
                    ckpt.state = {k: v + 1.0 for k, v in ckpt.state.items()}
                sess.log("loss", float(ckpt.state["w"][0]))
                sess.log("acc", e * 0.125)


@pytest.fixture(scope="module", params=["repro", "repro_torch"])
def mixed_store(request, tmp_path_factory):
    """A base run and a warm-started derived run recorded by one package,
    then a replay of the derived run with a hindsight probe; each
    package's live indexer wrote the index."""
    tmp = tmp_path_factory.mktemp(f"q_{request.param}")
    store = str(tmp / "store")
    rec = _jax_record if request.param == "repro" else _torch_record
    rec(str(tmp / "base"), store, "base")
    rec(str(tmp / "ft1"), store, "ft1", parent="base")
    _replay(str(tmp / "ft1"), 42, epochs=3)
    return store


@pytest.mark.parametrize("engine", ["files", "index", "auto"])
def test_rows_equal_reference_on_same_store(mixed_store, engine):
    """On one store (recorded by either package; the index written by that
    package), the port's rows and pivots equal the reference's on every
    engine — so an index written by one package serves the other."""
    from repro.core import query as jq
    got = log_records(mixed_store, engine=engine)
    assert got == jq.log_records(mixed_store, engine=engine)
    assert {r["source"] for r in got} == {"record", "replay_p0"}
    assert {r["run_id"] for r in got} == {"base", "ft1"}
    for kw in WHERE_CASES + [{"lineage": "ft1"}, {"lineage": "base"}]:
        assert log_records(mixed_store, engine=engine, **kw) == \
            jq.log_records(mixed_store, engine=engine, **kw), kw
    piv = pivot(mixed_store, "loss", engine=engine)
    assert piv == jq.pivot(mixed_store, "loss", engine=engine)
    assert pivot(mixed_store, engine=engine) == \
        jq.pivot(mixed_store, engine=engine)
    assert [(r["run_id"], r["loss"]) for r in piv] == [
        ("base", 2.0), ("base", 4.0), ("base", 6.0),
        ("ft1", 8.0), ("ft1", 10.0), ("ft1", 12.0)]


def test_index_opens_while_another_connection_creates_it(tmp_path):
    """Processes of a fleet create the same fresh index at finish. sqlite
    refuses the switch to WAL at once ("database is locked", no busy
    handler) while another connection holds a lock on a database still in
    rollback mode; opening the index waits for that lock instead."""
    import sqlite3
    import threading
    import time

    path = str(tmp_path / "index" / "flor.db")
    os.makedirs(os.path.dirname(path))
    holder = sqlite3.connect(path, check_same_thread=False)
    holder.execute("BEGIN IMMEDIATE")
    holder.execute("CREATE TABLE held(x)")
    with pytest.raises(sqlite3.OperationalError, match="locked"):
        sqlite3.connect(path, timeout=30).execute("PRAGMA journal_mode=WAL")
    release = threading.Timer(0.3, holder.commit)
    release.start()
    try:
        t0 = time.monotonic()
        idx = LogIndex(str(tmp_path), create=True)
        assert time.monotonic() - t0 >= 0.2
        assert idx.conn.execute("PRAGMA journal_mode").fetchone()[0] == "wal"
        idx.close()
    finally:
        release.join()
        holder.close()
