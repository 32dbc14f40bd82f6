"""Fleet record in the port: gloo processes, one per DeviceMesh position,
each checkpointing only its own shards while the lead stitches v4 manifests
through the crash-safe file rendezvous — the reference's
``tests/test_dist_record.py`` run against ``repro_torch``, plus the v4 and
member manifests held field for field against the reference's, stores
crossing both ways, and the launchers' fleets.

The reference records the same states and specs on a (2, 2) mesh of four
forced host devices in one process (a subprocess: the forced devices need
their own). Manifests are compared with tolerance 0 on every field but
``treedef``, each package's rendering of its own tree type. Restores are
held bit for bit.

Fault injection: ``FLOR_DIST_CRASH_BEFORE_PUBLISH=<key>`` kills the matching
process (exit 43) after its member manifests are durable but before its
rendezvous marker."""
import json
import os
import re
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import CheckpointStore
from repro_torch.parallel.rendezvous import (CRASH_EXIT_CODE, ProcessGroup,
                                             StitchRendezvous,
                                             crash_requested)
from torch_fleet import SRC, ref_subprocess, run_fleet


# ------------------------------------------------------------- rendezvous --
def test_process_group_validates_and_leads():
    g0 = ProcessGroup(0, 2)
    g1 = ProcessGroup(1, 2)
    assert g0.is_lead and not g1.is_lead
    with pytest.raises(ValueError):
        ProcessGroup(2, 2)
    with pytest.raises(ValueError):
        ProcessGroup(-1, 1)


def test_rendezvous_publish_gather_clear(tmp_path):
    root = str(tmp_path / "store")
    r0 = StitchRendezvous(root, "r", ProcessGroup(0, 2), timeout_s=5.0)
    r1 = StitchRendezvous(root, "r", ProcessGroup(1, 2), timeout_s=5.0)
    r0.publish("train@0.0", {"process": 0, "members": {"0": "a"}})
    r1.publish("train@0.0", {"process": 1, "members": {"1": "b"}})
    got = r0.gather("train@0.0")
    assert [m["process"] for m in got] == [0, 1]
    r0.clear("train@0.0")
    # cleared markers are gone: a fresh gather times out
    assert r0.gather("train@0.0", timeout_s=0.1) is None
    r0.close()
    r1.close()


def test_rendezvous_deadline_and_stale_heartbeat(tmp_path):
    root = str(tmp_path / "store")
    r0 = StitchRendezvous(root, "r", ProcessGroup(0, 2), timeout_s=0.3)
    r1 = StitchRendezvous(root, "r", ProcessGroup(1, 2), timeout_s=0.3)
    r0.publish("k", {"process": 0})
    # the missing process is alive (its beater renews the heartbeat):
    # gather charges the full deadline
    assert r0.gather("k", timeout_s=0.3) is None
    # a heartbeat silent for the timeout WITHIN the gather short-circuits a
    # longer budget (the peer is dead)
    r1.close()
    os.utime(r1._hb_path(1), (1, 1))
    t0 = time.monotonic()
    assert r0.gather("k", timeout_s=30.0) is None
    assert time.monotonic() - t0 < 5.0
    # a marker arriving late still satisfies a fresh gather
    r1.publish("k", {"process": 1})
    assert len(r0.gather("k")) == 2
    r0.close()


def test_rendezvous_slow_cadence_not_declared_dead(tmp_path):
    """A live peer whose LAST beat predates the stitch timeout is not
    declared dead at the start of the next gather — staleness is relative
    to the gather, not the heartbeat file's absolute age."""
    root = str(tmp_path / "store")
    r0 = StitchRendezvous(root, "r", ProcessGroup(0, 2), timeout_s=0.3)
    r1 = StitchRendezvous(root, "r", ProcessGroup(1, 2), timeout_s=0.3)
    r1.close()
    os.utime(r1._hb_path(1), (1, 1))
    r0.publish("k1", {"process": 0})
    late = threading.Timer(0.1, lambda: r1.publish("k1", {"process": 1}))
    late.start()
    try:
        got = r0.gather("k1", timeout_s=5.0)
    finally:
        late.join()
    assert got is not None and [m["process"] for m in got] == [0, 1]
    r0.close()


def test_rendezvous_record_leftover_heartbeats_ignored_by_replay(tmp_path):
    """Replay reuses the record run's .stitch/ dir; leftover record-phase
    heartbeats must not fail a replay merge barrier that starts long
    after."""
    root = str(tmp_path / "store")
    rec0 = StitchRendezvous(root, "r", ProcessGroup(0, 2), timeout_s=0.3)
    rec1 = StitchRendezvous(root, "r", ProcessGroup(1, 2), timeout_s=0.3)
    rec0.close()
    rec1.close()
    os.utime(rec0._hb_path(0), (1, 1))
    os.utime(rec1._hb_path(1), (1, 1))
    rep0 = StitchRendezvous(root, "r", ProcessGroup(0, 2), timeout_s=1.0)
    rep0.retract("replay.merge")
    rep0.arrive("replay.merge", {"process": 0})

    def late_host():
        rep1 = StitchRendezvous(root, "r", ProcessGroup(1, 2),
                                timeout_s=1.0)
        rep1.retract("replay.merge")
        rep1.arrive("replay.merge", {"process": 1})
        rep1.close()

    late = threading.Timer(0.2, late_host)
    late.start()
    try:
        got = rep0.await_all("replay.merge", timeout_s=5.0)
    finally:
        late.join()
    assert got is not None and [m["process"] for m in got] == [0, 1]
    rep0.close()


def test_rendezvous_retract_own_marker(tmp_path):
    root = str(tmp_path / "store")
    r1 = StitchRendezvous(root, "r", ProcessGroup(1, 2), timeout_s=1.0)
    r1.arrive("replay.merge")
    r1.retract("replay.merge")
    r0 = StitchRendezvous(root, "r", ProcessGroup(0, 2), timeout_s=1.0)
    r0.arrive("replay.merge")
    assert r0.await_all("replay.merge", timeout_s=0.2) is None
    r0.close()
    r1.close()


def test_crash_requested_env_scoping(monkeypatch):
    monkeypatch.delenv("FLOR_DIST_CRASH_BEFORE_PUBLISH", raising=False)
    monkeypatch.delenv("FLOR_DIST_CRASH_PROCESS", raising=False)
    assert not crash_requested("train@2.0", 0)
    monkeypatch.setenv("FLOR_DIST_CRASH_BEFORE_PUBLISH", "train@2.0")
    assert crash_requested("train@2.0", 0)
    assert crash_requested("train@2.0", 1)
    assert not crash_requested("train@1.0", 0)
    monkeypatch.setenv("FLOR_DIST_CRASH_PROCESS", "1")
    assert crash_requested("train@2.0", 1)
    assert not crash_requested("train@2.0", 0)


def test_reference_reads_the_ports_markers(tmp_path):
    """Both packages write the same marker files: a reference lead gathers
    the port's publication and vice versa."""
    from repro.parallel.rendezvous import ProcessGroup as JGroup
    from repro.parallel.rendezvous import StitchRendezvous as JRendezvous
    root = str(tmp_path / "store")
    t1 = StitchRendezvous(root, "r", ProcessGroup(1, 2), timeout_s=5.0)
    j0 = JRendezvous(root, "r", JGroup(0, 2), timeout_s=5.0)
    t1.publish("k", {"process": 1, "members": {"1": "x"}})
    j0.publish("k", {"process": 0, "members": {"0": "y"}})
    assert [m["members"] for m in j0.gather("k")] == [{"0": "y"}, {"1": "x"}]
    t0 = StitchRendezvous(root, "r", ProcessGroup(0, 2), timeout_s=5.0)
    assert [m["process"] for m in t0.gather("k")] == [0, 1]
    for r in (t1, j0, t0):
        r.close()


# --------------------------------------------------- (2, 2) fleet record --
EPOCHS = 3


def host_state(epoch):
    rng = np.random.default_rng(7)
    w = (rng.normal(size=(64, 32)).astype(np.float32)
         * (1.0 + 0.001 * epoch))
    b = np.arange(32, dtype=np.float32) * (2.0 + 0.001 * epoch)
    return {"w": w, "b": b}


STATE_SRC = """
import numpy as np
def host_state(epoch):
    rng = np.random.default_rng(7)
    w = (rng.normal(size=(64, 32)).astype(np.float32)
         * (1.0 + 0.001 * epoch))
    b = np.arange(32, dtype=np.float32) * (2.0 + 0.001 * epoch)
    return {"w": w, "b": b}
SPECS = {"w": ("data", "model"), "b": ("model",)}
EPOCHS = 3
"""

# The port: four gloo processes, one per position of a (2, 2) DeviceMesh,
# record 3 epochs through the full Session path (staging index dbs,
# per-process log streams, the lead's stitch).
PORT_RECORD = STATE_SRC + """
from torch.distributed.device_mesh import DeviceMesh
import repro_torch.flor as flor
from repro_torch.parallel import place
from repro_torch.parallel.rendezvous import ProcessGroup


def main(rank, world, args):
    run_dir = args[0]
    mesh = DeviceMesh("cpu", torch.arange(4).reshape(2, 2),
                      mesh_dim_names=("data", "model"))
    def tree(epoch):
        return {k: place(torch.from_numpy(v), mesh, SPECS[k])
                for k, v in host_state(epoch).items()}
    timeout = float(os.environ.get("T_STITCH", "60"))
    with flor.Session(run_dir, mode="record", record=flor.RecordSpec(
            adaptive=False, mesh=mesh, distributed=ProcessGroup(rank, world),
            stitch_timeout_s=timeout)) as s:
        with s.checkpointing(state=tree(0)) as ckpt:
            for epoch in s.loop("epochs", range(EPOCHS)):
                for _ in s.loop("train", range(2)):
                    pass
                ckpt.state = tree(epoch + 1)
                flor.log("epoch", epoch)
    print(f"CHILD_OK p{rank}", flush=True)
"""

# The reference: the same states and specs on a (2, 2) mesh of four forced
# host devices, one process; then restores of both stores onto its own
# (4, 1) and (1, 4) meshes with read accounting.
REF_RECORD_AND_RESTORE = STATE_SRC + """
import json, sys
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
import repro.flor as flor
from repro.checkpoint import CheckpointStore, restore_sharded_tree
jrun, trun = sys.argv[1], sys.argv[2]
devs = jax.devices()
mesh = Mesh(np.array(devs).reshape(2, 2), ("data", "model"))
def tree(epoch):
    h = host_state(epoch)
    return {k: jax.make_array_from_callback(
                h[k].shape, NamedSharding(mesh, P(*SPECS[k])),
                lambda idx, a=h[k]: a[idx]) for k in h}
with flor.Session(jrun, mode="record",
                  record=flor.RecordSpec(adaptive=False, mesh=mesh)) as s:
    with s.checkpointing(state=tree(0)) as ckpt:
        for epoch in s.loop("epochs", range(EPOCHS)):
            for _ in s.loop("train", range(2)):
                pass
            ckpt.state = tree(epoch + 1)
            flor.log("epoch", epoch)
out = {}
truth = host_state(EPOCHS - 1)
for name, run in (("ref", jrun), ("port", trun)):
    store = CheckpointStore(os.path.join(run, "store"))
    like = {"state": {k: np.empty_like(v) for k, v in truth.items()}}
    got = store.get_tree(f"train@{EPOCHS - 1}.0", like=like)["state"]
    assert all(np.array_equal(got[k], truth[k]) for k in truth), name
    for shape in ((4, 1), (1, 4)):
        m2 = Mesh(np.array(devs).reshape(shape), ("data", "model"))
        stats = {}
        res = restore_sharded_tree(store, f"train@{EPOCHS - 1}.0", m2,
                                   stats_out=stats)
        for k in truth:
            arr = np.asarray(jax.device_get(res[f"['state']['{k}']"]))
            assert np.array_equal(arr, truth[k]), (name, shape, k)
        out[f"{name}{shape}"] = {str(h): int(v) for h, v in
                                 stats["bytes_by_shard"].items()}
print("REF_OK" + json.dumps(out))
"""

# The port restores both stores onto (1, 4) and (4, 1) fleets.
PORT_RESTORE = STATE_SRC + """
import json
from torch.distributed.device_mesh import DeviceMesh
from repro_torch.checkpoint import CheckpointStore, restore_sharded_tree
from repro_torch.parallel.sharding import local_box


def main(rank, world, args):
    jrun, trun, out_dir = args
    truth = host_state(EPOCHS - 1)
    out = {}
    for shape in ((4, 1), (1, 4)):
        mesh = DeviceMesh("cpu", torch.arange(4).reshape(shape),
                          mesh_dim_names=("data", "model"))
        for name, run in (("ref", jrun), ("port", trun)):
            store = CheckpointStore(os.path.join(run, "store"))
            stats = {}
            got = restore_sharded_tree(store, f"train@{EPOCHS - 1}.0", mesh,
                                       stats_out=stats)
            for k, v in truth.items():
                x = got[f"['state']['{k}']"]
                box = local_box(x.shape, mesh, x.placements)
                want = v[tuple(slice(lo, hi) for lo, hi in box)]
                assert np.array_equal(x.to_local().numpy(), want), \\
                    (name, shape, k, rank)
            out[f"{name}{shape}"] = {str(h): int(v) for h, v in
                                     stats["bytes_by_shard"].items()}
    with open(os.path.join(out_dir, f"restore{rank}.json"), "w") as f:
        json.dump(out, f)
"""


def _view(m: dict) -> dict:
    """A manifest without ``treedef`` (each package's tree rendering)."""
    return {k: v for k, v in m.items() if k != "treedef"}


@pytest.fixture(scope="module")
def fleet_runs(tmp_path_factory):
    """(reference run dir, port run dir, the reference's restore stats, the
    port's restore stats per rank)."""
    tmp = tmp_path_factory.mktemp("fleet")
    jrun, trun = str(tmp / "jrun"), str(tmp / "trun")
    res = run_fleet(PORT_RECORD, 4, tmp, trun)
    assert [rc for rc, _ in res] == [0] * 4, res
    assert all("CHILD_OK" in out for _, out in res), res
    ref = ref_subprocess(REF_RECORD_AND_RESTORE, 4, jrun, trun)
    line = [ln for ln in ref.stdout.splitlines() if ln.startswith("REF_OK")]
    assert line, ref.stderr[-4000:]
    res = run_fleet(PORT_RESTORE, 4, tmp, jrun, trun, tmp)
    assert [rc for rc, _ in res] == [0] * 4, res
    port_stats = []
    for r in range(4):
        with open(tmp / f"restore{r}.json") as f:
            port_stats.append(json.load(f))
    return jrun, trun, json.loads(line[0][len("REF_OK"):]), port_stats


@pytest.mark.slow
def test_fleet_record_stitches_every_epoch(fleet_runs):
    _, trun, _, _ = fleet_runs
    store = CheckpointStore(os.path.join(trun, "store"))
    keys = set(store.list_keys())
    for e in range(EPOCHS):
        assert f"train_at_{e}.0" in keys
        assert {f"train_at_{e}.0.shard{h}" for h in range(4)} <= keys
        m = store.get_manifest(f"train@{e}.0")
        assert m["version"] == 4 and len(m["members"]) == 4
    assert store.get_meta("incomplete_ckpts") in (None, {"keys": []})
    # every process's markers were consumed by the stitch
    sdir = os.path.join(trun, "store", "runs", "dist-trun", ".stitch")
    assert not [d for d in os.listdir(sdir) if d.startswith("train")]
    # per-process log streams: the lead's record.jsonl is the query
    # surface's copy; the peers' SPMD-identical rows live beside it
    logs = set(os.listdir(os.path.join(trun, "logs")))
    assert {"record.jsonl", "record_p1.jsonl", "record_p2.jsonl",
            "record_p3.jsonl"} <= logs
    # staging index dbs merged and removed at close
    assert not [f for f in os.listdir(os.path.join(trun, "store", "index",
                                                   "staging"))
                if f.endswith(".db")]
    from repro_torch.checkpoint.lineage import RunRegistry
    recs = {r["run_id"]: r
            for r in RunRegistry(os.path.join(trun, "store")).list_runs()}
    assert recs["dist-trun"]["status"] == "finished"
    assert recs["dist-trun"]["final_keys"] == {"train": f"train@{EPOCHS - 1}.0"}


@pytest.mark.slow
def test_fleet_manifests_equal_the_references(fleet_runs):
    """The stitched v4 and every member manifest equal the reference's,
    field for field, for the same states, specs and (2, 2) mesh."""
    jrun, trun, _, _ = fleet_runs
    js = CheckpointStore(os.path.join(jrun, "store"))
    ts = CheckpointStore(os.path.join(trun, "store"))
    assert sorted(js.list_keys()) == sorted(ts.list_keys())
    for key in js.list_keys():
        assert _view(ts.get_manifest(key)) == _view(js.get_manifest(key)), \
            key
    assert ts.get_meta("mesh") == js.get_meta("mesh")
    v4 = ts.get_manifest(f"train@{EPOCHS - 1}.0")
    leaves = {lf["path"]: lf for lf in v4["leaves"]}
    assert leaves["['state']['w']"]["spec"] == ["data", "model"]
    # the replicated-over-data leaf is owned by the positions at data 0
    assert [s["sid"] for s in leaves["['state']['b']"]["shards"]] == [0, 1]


@pytest.mark.slow
def test_stores_cross_both_ways_bit_for_bit(fleet_runs):
    """The port restores the reference's store unsharded and onto (1, 4)
    and (4, 1) fleets (checked in the fleet), the reference restores the
    port's store unsharded and onto its own (4, 1) / (1, 4) meshes (checked
    in its subprocess), and equal target layouts read equal bytes.

    The reference reads a target shard that several devices hold once; in
    the port each process holding it reads it. On (1, 4) no target shard
    is replicated; on (4, 1) ``b`` is held by all four positions, so the
    port reads its recorded bytes three more times."""
    jrun, trun, ref_stats, port_stats = fleet_runs
    truth = host_state(EPOCHS - 1)
    for run in (jrun, trun):
        store = CheckpointStore(os.path.join(run, "store"))
        like = {"state": {k: torch.empty(0) for k in truth}}
        got = store.get_tree(f"train@{EPOCHS - 1}.0", like=like)["state"]
        for k, v in truth.items():
            assert np.array_equal(got[k].numpy(), v)
    v4 = CheckpointStore(os.path.join(trun, "store")).get_manifest(
        f"train@{EPOCHS - 1}.0")
    b_bytes = {str(sh["hid"]): 4 * (sh["bounds"][0][1] - sh["bounds"][0][0])
               for lf in v4["leaves"] if lf["path"] == "['state']['b']"
               for sh in lf["shards"]}
    for layout, extra in (("(1, 4)", 0), ("(4, 1)", 3)):
        for name in ("ref", "port"):
            summed: dict = {}
            for per_rank in port_stats:
                for h, n in per_rank[f"{name}{layout}"].items():
                    summed[h] = summed.get(h, 0) + n
            want = {h: n + extra * b_bytes.get(h, 0)
                    for h, n in ref_stats[f"{name}{layout}"].items()}
            assert summed == want, (name, layout)
        assert ref_stats[f"ref{layout}"] == ref_stats[f"port{layout}"]


@pytest.mark.slow
def test_crash_between_publish_and_stitch(tmp_path):
    """Kill process 1 after its final-epoch member manifests are durable
    but before its marker: the lead marks the checkpoint incomplete, the
    run finalizes at the last COMPLETE checkpoint, the replay planner skips
    the torn key, and GC reclaims the orphan members."""
    run = str(tmp_path / "crun")
    res = run_fleet(PORT_RECORD, 4, tmp_path, run, env={
        "T_STITCH": "6", "FLOR_DIST_CRASH_BEFORE_PUBLISH": "train@2.0",
        "FLOR_DIST_CRASH_PROCESS": "1"})
    assert res[1][0] == CRASH_EXIT_CODE, res[1][1]
    assert [rc for rc, _ in res[:1] + res[2:]] == [0, 0, 0], res
    store = CheckpointStore(os.path.join(run, "store"))
    keys = set(store.list_keys())
    # publication-ordering invariant: orphan members, NO v4 naming them
    assert "train_at_2.0" not in keys
    orphans = {k for k in keys if k.startswith("train_at_2.0.shard")}
    assert orphans, keys
    assert "train_at_1.0" in keys
    assert store.get_meta("incomplete_ckpts") == {"keys": ["train@2.0"]}
    from repro_torch.checkpoint.lineage import RunRegistry
    reg = RunRegistry(os.path.join(run, "store"))
    rec = {r["run_id"]: r for r in reg.list_runs()}["dist-crun"]
    assert rec["status"] == "finished"
    assert rec["final_keys"] == {"train": "train@1.0"}
    from repro_torch.replay.plan import build_plan
    assert build_plan(run).incomplete == ["train_at_2.0"]
    truth = host_state(1)
    like = {"state": {k: torch.empty(0) for k in truth}}

    def restored_ok():
        got = store.get_tree("train@1.0", like=like)["state"]
        return all(np.array_equal(got[k].numpy(), truth[k]) for k in truth)

    assert restored_ok()
    res = reg.gc(store)
    assert res["deleted_manifests"] == len(orphans)
    keys_after = set(store.list_keys())
    assert not [k for k in keys_after if "2.0" in k]
    assert "train_at_1.0" in keys_after
    assert restored_ok()
    # a dead process's staging index db is swept (absorbed) on reindex
    from repro_torch.querydb.index import LogIndex, staging_path
    root = os.path.join(run, "store")
    LogIndex(root, create=True, db_path=staging_path(root, 9)).close()
    staging = os.path.join(root, "index", "staging")
    assert any(f.endswith(".db") for f in os.listdir(staging))
    from repro_torch.querydb.maintain import reindex
    assert reindex(run)["staging_swept"] >= 1
    assert not any(f.endswith(".db") for f in os.listdir(staging))


# --------------------------------------------------------------- launchers --
SMOKE = ["--smoke", "--device", "cpu", "--batch", "2", "--seq", "32"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(module: str, n: int, argv: list, timeout=300) -> list:
    """``python -m <module> argv --process-id i`` for i < n, together."""
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    env.pop("LOCAL_RANK", None)
    procs = [subprocess.Popen(
        [sys.executable, "-m", module, *argv, "--process-id", str(i)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for i in range(n)]
    out = []
    try:
        for p in procs:
            text, _ = p.communicate(timeout=timeout)
            out.append((p.returncode, text))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


@pytest.mark.slow
def test_train_launcher_fleet_records_and_resumes(tmp_path):
    run = str(tmp_path / "run")

    def fleet(epochs):
        return _launch("repro_torch.launch.train", 2, [
            *SMOKE, "--epochs", str(epochs), "--steps-per-epoch", "2",
            "--no-adaptive", "--run-dir", run, "--mesh", "2x1",
            "--num-processes", "2",
            "--coordinator", f"127.0.0.1:{_free_port()}"])

    res = fleet(2)
    assert [rc for rc, _ in res] == [0, 0], res
    store = CheckpointStore(os.path.join(run, "store"))
    for e in range(2):
        assert store.get_manifest(f"train@{e}.0")["version"] == 4
    res = fleet(3)
    assert [rc for rc, _ in res] == [0, 0], res
    assert all("resuming: restoring epoch 1 checkpoint" in out
               for _, out in res), res
    assert all("epoch 2 done" in out and "epoch 1 done" not in out
               for _, out in res), res
    assert store.get_manifest("train@2.0")["version"] == 4


def test_train_launcher_mesh_needs_one_process_per_position(tmp_path):
    from repro_torch.launch import train
    with pytest.raises(SystemExit):
        train.main([*SMOKE, "--run-dir", str(tmp_path), "--mesh", "2x2"])
    with pytest.raises(SystemExit):
        train.main([*SMOKE, "--run-dir", str(tmp_path), "--mesh", "2x2",
                    "--num-processes", "2"])
    with pytest.raises(SystemExit):
        train.main([*SMOKE, "--run-dir", str(tmp_path),
                    "--num-processes", "2"])


def _merged_rows(run: str) -> list:
    with open(os.path.join(run, "logs", "merged_replay.jsonl")) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    return sorted((r.get("epoch"), r["key"], json.dumps(r.get("value")))
                  for r in rows)


@pytest.mark.slow
def test_replay_launcher_fleet_merges_the_same_rows(tmp_path):
    from repro_torch.launch import train
    run = str(tmp_path / "run")
    train.main([*SMOKE, "--epochs", "3", "--steps-per-epoch", "2",
                "--no-adaptive", "--run-dir", run])
    argv = ["--run-dir", run, *SMOKE, "--nworkers", "2", "--probe", "train",
            "--check"]
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    one = subprocess.run([sys.executable, "-m", "repro_torch.launch.replay",
                          *argv], env=env, capture_output=True, text=True,
                         timeout=300)
    assert one.returncode == 0, one.stderr[-3000:]
    rows = _merged_rows(run)
    res = _launch("repro_torch.launch.replay", 2,
                  [*argv, "--num-processes", "2"])
    assert [rc for rc, _ in res] == [0, 0], res
    m = re.search(r"deferred check: ok=(\w+) compared=(\d+) hindsight=(\d+)",
                  res[0][1])
    assert m and m[1] == "True" and int(m[3]) == 6, res[0][1]
    assert "host 1: share complete" in res[1][1]
    assert _merged_rows(run) == rows
