"""Mesh-sharded record and restore in the port: v4 manifests, resharding
math, host-aware planning — the reference's ``tests/test_sharded_ckpt.py``
run against ``repro_torch``.

In-process cases run on a one-rank gloo group (a ``FileStore`` under
``tmp_path``) with a CPU ``DeviceMesh`` of one position; the cross-mesh case
records on a (2, 2) fleet of four gloo processes and restores on (4, 1),
(1, 4) and unsharded. Restores are held to the recorded bytes bit for bit,
and error-bounded slots to their atol."""
import json
import os

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import (CheckpointPipeline, CheckpointStore,
                                    restore_sharded_tree)
from repro_torch.checkpoint.mesh import box_intersect, chunk_range
from repro_torch.parallel import place
from repro_torch.parallel.sharding import respec, spec_entries
from torch_fleet import run_fleet, world1


# ------------------------------------------------------- pure-unit helpers --
def test_box_intersect():
    assert box_intersect([[0, 4], [0, 8]], [[2, 6], [4, 12]]) \
        == [[2, 4], [4, 8]]
    assert box_intersect([[0, 4]], [[4, 8]]) is None
    # scalars: full (empty-box) overlap, not None
    assert box_intersect([], []) == []


def test_chunk_range_envelope():
    # local 4x8 f32 leaf, 2 rows per 64-byte chunk -> 2 chunks
    assert chunk_range([[0, 4], [0, 8]], [[1, 2], [0, 8]], 4, 64, 2) \
        == (0, 1)
    assert chunk_range([[0, 4], [0, 8]], [[0, 4], [0, 8]], 4, 64, 2) \
        == (0, 2)


def test_spec_entries_and_respec():
    assert spec_entries(("data", ("data", "model"), None)) \
        == ["data", ["data", "model"], None]
    assert spec_entries(None) is None

    class Mesh:
        shape = {"data": 2, "model": 4}
    mesh = Mesh()
    # recorded spec re-resolves verbatim when divisible
    assert respec(["data", "model"], (8, 8), mesh) == ("data", "model")
    # non-divisible dim drops the offending axis (replicates)
    assert respec(["data", "model"], (8, 6), mesh) == ("data", None)
    # axis missing from the target mesh is filtered out
    assert respec(["pod", "model"], (8, 8), mesh) == (None, "model")
    # an axis never shards two dims
    assert respec(["data", "data"], (8, 8), mesh) == ("data", None)


# ------------------------------------------- v4 manifests on a tiny mesh --
def _sharded_store(tmp_path, mesh, n_ckpts=2):
    store = CheckpointStore(os.path.join(tmp_path, "store"))
    pipe = CheckpointPipeline(store, async_stage=False, mesh=mesh)
    trees = []
    for i in range(n_ckpts):
        w = torch.arange(64, dtype=torch.float32).reshape(8, 8) + i
        pipe.submit(f"train@{i}.0", {"w": place(w, mesh, ("data", None)),
                                     "step": i}, block=True)
        trees.append({"w": w.numpy(), "step": np.int64(i)})
    pipe.close()
    return store, trees


def _like():
    return {"w": torch.empty(8, 8), "step": torch.tensor(0)}


def test_sharded_record_roundtrip_and_delta_chain(tmp_path):
    with world1(tmp_path) as mesh:
        store, trees = _sharded_store(str(tmp_path), mesh)
    m0 = store.resolve_manifest("train@0.0")
    m1 = store.resolve_manifest("train@1.0")
    assert m0["kind"] == "sharded" and m0["ckpt_kind"] == "full"
    assert m1["ckpt_kind"] == "delta" and m1["parent"] == "train@0.0"
    # member manifests chain per shard
    mem1 = m1["members_resolved"][0]
    assert mem1["parent"] == "train@0.0.shard0"
    assert mem1["store_shard"] == 0
    assert {lf["path"]: lf["spec"] for lf in m1["leaves"]} \
        == {"['step']": None, "['w']": ["data", None]}
    for i, truth in enumerate(trees):
        out = store.get_tree(f"train@{i}.0", like=_like())
        assert np.array_equal(out["w"].numpy(), truth["w"])
        assert out["step"].shape == () and int(out["step"]) == i


def test_restore_sharded_tree_same_mesh(tmp_path):
    from torch.distributed.tensor import DTensor
    with world1(tmp_path) as mesh:
        store, trees = _sharded_store(str(tmp_path), mesh)
        out = restore_sharded_tree(store, "train@1.0", mesh)
        w = out["['w']"]
        assert isinstance(w, DTensor) and w.device_mesh == mesh
        assert np.array_equal(w.to_local().numpy(), trees[1]["w"])
        # a DTensor like leaf restores sharded through get_tree too
        like = {"w": place(torch.empty(8, 8), mesh, ("data", None)),
                "step": torch.tensor(0)}
        got = store.get_tree("train@1.0", like=like)
        assert isinstance(got["w"], DTensor)
        assert np.array_equal(got["w"].to_local().numpy(), trees[1]["w"])


def test_stats_report_sharded_members(tmp_path):
    with world1(tmp_path) as mesh:
        store, _ = _sharded_store(str(tmp_path), mesh)
    st = store.stats(keys=store.list_keys(), per_key=True)
    assert st["sharded_manifests"] == 2
    info = st["per_key"]["train_at_1.0"]
    assert 0 in {int(h) for h in info["shards"]}
    assert info["shards"][list(info["shards"])[0]]["chunks"] >= 1


def test_gc_keeps_live_shard_member_closure(tmp_path):
    """Shard members are part of the global manifest's closure — GC with
    only the DELTA tip live must keep the parent full's member chunks."""
    with world1(tmp_path) as mesh:
        store, trees = _sharded_store(str(tmp_path), mesh)
    res = store.gc(live_keys=["train@1.0"])
    assert res["deleted_chunks"] == 0, res
    out = store.get_tree("train@1.0", like=_like())
    assert np.array_equal(out["w"].numpy(), trees[1]["w"])
    # dropping the tip reclaims the whole chain, shard pools included
    assert store.gc(live_keys=[])["deleted_chunks"] > 0


def test_sharded_restore_read_stats(tmp_path):
    with world1(tmp_path) as mesh:
        store, _ = _sharded_store(str(tmp_path), mesh)
    stats = {}
    store.get_tree("train@1.0", like=_like(), stats_out=stats)
    assert stats["chunks_read"] >= 1
    assert sum(stats["bytes_by_shard"].values()) > 0


def test_warm_start_from_sharded_manifest_raises(tmp_path):
    with world1(tmp_path) as mesh:
        store, _ = _sharded_store(str(tmp_path), mesh)
    pipe = CheckpointPipeline(store, async_stage=False)
    with pytest.raises(ValueError):
        pipe.warm_start("train", "train@1.0",
                        store.resolve_manifest("train@1.0"), {})
    pipe.close()


def test_mesh_of_many_positions_needs_a_fleet(tmp_path):
    """A DeviceMesh has one process per position: a pipeline on a mesh of
    more than one position without ``dist=`` would let every process write
    its own v4, so it raises."""
    class Grid:
        mesh = torch.zeros(2, 2)
    with pytest.raises(ValueError, match="fleet"):
        CheckpointPipeline(CheckpointStore(str(tmp_path)), mesh=Grid())
    with pytest.raises(ValueError, match="needs mesh"):
        CheckpointPipeline(CheckpointStore(str(tmp_path)), dist=object())


# -------------------------------------------------- host-aware plan costs --
def test_plan_uses_per_shard_read_rates(tmp_path):
    from repro_torch.replay import build_plan
    with world1(tmp_path) as mesh:
        store, _ = _sharded_store(str(tmp_path), mesh)
    store.put_meta("run", {"epochs": [0, 1], "main_loop": "epochs",
                           "num_epochs": 2})

    def plan_with(bps):
        calib = {"read_bps": 1e9, "hop_s": 0.0}
        if bps is not None:
            calib["shard_read_bps"] = {"0": bps}
        store.put_meta("store_calib", calib)
        return build_plan(str(tmp_path), probed=frozenset(), store=store,
                          epochs=[0, 1])

    slow = plan_with(1e3)
    fast = plan_with(1e9)
    s_cost = sum(s.restore_cost_s for s in slow.segments)
    f_cost = sum(s.restore_cost_s for s in fast.segments)
    assert s_cost > f_cost * 100       # slow shard dominates the estimate
    assert all(s.hosts >= 1 for s in slow.segments)
    assert slow.mesh.get("n_store_shards") == 1   # from recorded mesh meta
    loaded = type(slow).from_dict(slow.to_dict())
    assert loaded.mesh == slow.mesh
    assert [s.hosts for s in loaded.segments] \
        == [s.hosts for s in slow.segments]


# ----------------------------------------------- encodings on a mesh --------
def test_sharded_error_bound_slots(tmp_path):
    """The adaptive encoding selector composes with the sharded (v4) path:
    bounded slots land as q4/q8 wire chunks in the member manifests, deltas
    carry denc, the resolved member chain inherits enc, and restores stay
    within the declared bound (exact slots bit-identical)."""
    store = CheckpointStore(os.path.join(str(tmp_path), "store"))
    rng = np.random.default_rng(7)
    mus, ws = [], []
    with world1(tmp_path) as mesh:
        pipe = CheckpointPipeline(store, async_stage=False, mesh=mesh,
                                  chunk_words=16, error_bounds={"mu": 1e-2})
        for i in range(2):
            mu = (0.02 * rng.normal(size=(8, 8))).astype(np.float32)
            w = rng.normal(size=(8, 8)).astype(np.float32)
            pipe.submit(f"train@{i}.0", {
                "mu": place(torch.from_numpy(mu), mesh, ("data", None)),
                "w": place(torch.from_numpy(w), mesh, ("data", None))},
                block=True)
            mus.append(mu)
            ws.append(w)
        pipe.close()
        out = restore_sharded_tree(store, "train@1.0", mesh)
        assert np.max(np.abs(out["['mu']"].to_local().numpy()
                             - mus[1])) <= 1e-2
        assert np.array_equal(out["['w']"].to_local().numpy(), ws[1])
    for i in range(2):
        like = {"mu": torch.empty(8, 8), "w": torch.empty(8, 8)}
        got = store.get_tree(f"train@{i}.0", like=like)
        assert np.max(np.abs(got["mu"].numpy() - mus[i])) <= 1e-2
        assert np.array_equal(got["w"].numpy(), ws[i])
    m0 = store.resolve_manifest("train@0.0")
    lf0 = {lf["path"]: lf for lf in m0["members_resolved"][0]["leaves"]}
    assert lf0["['mu']::shard0"]["leaf_enc"] == "eb:0.01"
    assert set(lf0["['mu']::shard0"]["enc"]) <= {"q4", "q8", "q4+z", "q8+z"}
    assert all(e == "raw" for e in lf0["['w']::shard0"].get("enc", []))
    raw1 = store.get_manifest("train@1.0.shard0")
    rlf = {lf["path"]: lf for lf in raw1["leaves"]}["['mu']::shard0"]
    assert rlf.get("delta") and rlf.get("denc")
    assert set(rlf["denc"].values()) <= {"q4", "q8", "q4+z", "q8+z"}
    m1 = store.resolve_manifest("train@1.0")
    lf1 = {lf["path"]: lf for lf in m1["members_resolved"][0]["leaves"]}
    assert set(lf1["['mu']::shard0"]["enc"]) <= {"q4", "q8", "q4+z", "q8+z"}
    assert any(e.startswith("q") for e in store.encoding_mix("train@1.0"))
    st = store.stats(keys=store.list_keys(), per_key=True)
    encc = st["per_key"]["train_at_1.0"]["enc_counts"]
    assert any(e.startswith("q") for e in encc)


# ----------------------------------------------- fleet cross-mesh restore --
ENC_FLEET = """
import json
import numpy as np
from torch.distributed.device_mesh import DeviceMesh
from repro_torch.checkpoint import (CheckpointPipeline, CheckpointStore,
                                    restore_sharded_tree)
from repro_torch.parallel import place
from repro_torch.parallel.rendezvous import ProcessGroup, StitchRendezvous


def state(i):
    rng = np.random.default_rng(11 + i)
    return {"mu": (0.02 * rng.normal(size=(64, 32))).astype(np.float32),
            "w": rng.normal(size=(64, 32)).astype(np.float32)}


def main(rank, world, args):
    root = args[0]
    store = CheckpointStore(os.path.join(root, "store"))
    mesh = DeviceMesh("cpu", torch.arange(4).reshape(2, 2),
                      mesh_dim_names=("data", "model"))
    rdv = StitchRendezvous(store.root, "enc", ProcessGroup(rank, world),
                           timeout_s=60)
    pipe = CheckpointPipeline(store, async_stage=False, mesh=mesh,
                              chunk_words=64, error_bounds={"mu": 1e-2},
                              dist=rdv)
    for i in range(2):
        pipe.submit(f"train@{i}.0",
                    {k: place(torch.from_numpy(v), mesh, ("data", "model"))
                     for k, v in state(i).items()}, block=True)
    pipe.close()
    rdv.close()
    dist.barrier()
    out = {}
    for shape in ((4, 1), (1, 4)):
        m2 = DeviceMesh("cpu", torch.arange(4).reshape(shape),
                        mesh_dim_names=("data", "model"))
        got = restore_sharded_tree(store, "train@1.0", m2)
        out[str(shape)] = {
            k: {"box": [[o, o + n] for o, n in zip(
                    *_box(got[f"['{k}']"]))],
                "data": got[f"['{k}']"].to_local().numpy().tolist()}
            for k in ("mu", "w")}
    with open(os.path.join(root, f"enc{rank}.json"), "w") as f:
        json.dump(out, f)


def _box(x):
    from torch.distributed.tensor._utils import \\
        compute_local_shape_and_global_offset
    shape, off = compute_local_shape_and_global_offset(
        x.shape, x.device_mesh, x.placements)
    return off, shape
"""


@pytest.mark.slow
def test_encoded_slots_cross_mesh_restore_within_bound(tmp_path):
    """q4/q8-encoded slots recorded by a (2, 2) fleet of four processes
    restore within their declared bound on (4, 1), (1, 4) and unsharded;
    the exact slot stays bit-identical across every resharding."""
    res = run_fleet(ENC_FLEET, 4, tmp_path, tmp_path)
    assert all(rc == 0 for rc, _ in res), res
    store = CheckpointStore(os.path.join(tmp_path, "store"))
    m1 = store.resolve_manifest("train@1.0")
    assert m1["ckpt_kind"] == "delta" and len(m1["members"]) == 4
    for mem in m1["members_resolved"].values():
        for lf in mem["leaves"]:
            if lf["path"].startswith("['mu']"):
                assert set(lf["enc"]) <= {"q4", "q8", "q4+z", "q8+z"}, lf
    rng = np.random.default_rng(12)
    truth = {"mu": (0.02 * rng.normal(size=(64, 32))).astype(np.float32),
             "w": rng.normal(size=(64, 32)).astype(np.float32)}
    got = store.get_tree("train@1.0", like={k: torch.empty(1)
                                            for k in truth})
    assert np.max(np.abs(got["mu"].numpy() - truth["mu"])) <= 1e-2
    assert np.array_equal(got["w"].numpy(), truth["w"])
    for rank in range(4):
        with open(os.path.join(tmp_path, f"enc{rank}.json")) as f:
            per_mesh = json.load(f)
        for shape, leaves in per_mesh.items():
            for k, lf in leaves.items():
                want = truth[k][tuple(slice(lo, hi) for lo, hi in lf["box"])]
                data = np.asarray(lf["data"], np.float32)
                if k == "mu":
                    assert np.max(np.abs(data - want)) <= 1e-2, shape
                else:
                    assert np.array_equal(data, want), (shape, rank)
