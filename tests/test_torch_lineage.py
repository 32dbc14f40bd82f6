"""The port's run lineage on the CPU: cross-run warm start (the derived
run's first checkpoint is a delta against its ancestor's tip), its cold
fallbacks, replay of a derived run, registry gc, the ``runs`` CLI, the
launcher's ``--parent-run``, and warm start across packages both ways — a
store recorded by ``repro`` seeds a ``repro_torch`` run and the reverse,
with restores bit-identical through either package.

Inputs: a frozen-majority state (four 64 KiB chunks of seeded normals, one
small hot head), made with numpy from seed 0.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro_torch.flor as flor
from repro_torch.checkpoint import CheckpointStore, RunRegistry
from repro_torch.checkpoint import delta as delta_mod
from repro_torch.checkpoint.delta import DeltaTracker
from repro_torch.checkpoint.lineage import read_run_meta
from repro_torch.launch import train as launcher
from repro_torch.launch.runs import main as runs_main
from repro_torch.utils.pytree import tree_leaves

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
SMALL = ["--smoke", "--device", "cpu", "--batch", "2", "--seq", "32",
         "--no-adaptive"]
FROZEN = np.random.default_rng(0).standard_normal(4 * 16384) \
    .astype(np.float32)
HEAD_CHUNK = 256 * 4                    # the head leaf: one 1 KiB chunk


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _tree(step: float) -> dict:
    return {"frozen": torch.from_numpy(FROZEN.copy()),
            "head": torch.full((256,), step, dtype=torch.float32)}


def _bump(t: dict) -> dict:
    return dict(t, head=t["head"] + 1)


def _bytes(x) -> bytes:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().contiguous().numpy().tobytes()
    return np.ascontiguousarray(np.asarray(x)).tobytes()


def _equal(a, b) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(_bytes(x) == _bytes(y)
                                      for x, y in zip(la, lb))


def _session(run_dir, store_root=None, run_id=None, parent=None,
             full_every=2, mode="record"):
    if mode == "replay":
        return flor.Session(str(run_dir), mode="replay")
    return flor.Session(
        str(run_dir), mode="record",
        record=flor.RecordSpec(adaptive=False, async_materialize=False,
                               full_manifest_every=full_every),
        lineage=flor.LineageSpec(
            store_root=None if store_root is None else str(store_root),
            run_id=run_id, parent_run=parent))


def _record_run(run_dir, store_root, run_id, n_ckpts, *, parent=None,
                full_every=2):
    """Record one run of the lineage chain through the port's flor API;
    returns the final state."""
    with _session(run_dir, store_root, run_id, parent, full_every) as sess:
        t = _tree(1.0)
        if parent is not None:
            t = sess.warm_start("train", like=t)
        for e in range(n_ckpts):
            t = _bump(t)
            sess.ctx.submit_checkpoint("train", f"train@{e}.0", t, meta={})
    return t


# ------------------------------------------------------------ warm start --
def test_warm_start_first_checkpoint_is_cross_run_delta(tmp_path):
    root = tmp_path / "store"
    final_a = _record_run(tmp_path / "runA", root, "A", 3)
    with _session(tmp_path / "runB", root, "B", "A", full_every=4) as sess:
        ctx = sess.ctx
        state = sess.warm_start("train", like=_tree(0.0))
        assert _equal(state, final_a)
        info = ctx.warmstart_stats["train"]
        assert info["seeded"] and info["parent_key"] == "A::train@2.0"
        assert info["leaves"] == 2 and info["restore_s"] > 0
        state = _bump(state)
        ctx.submit_checkpoint("train", "train@0.0", state, meta={})
        stat = ctx.pipeline.stats[-1]
        # the FIRST checkpoint of the derived run: a delta against the
        # ancestor, transferring only the hot head's chunk
        assert stat["kind"] == "delta" and stat["parent"] == "A::train@2.0"
        assert stat["transferred_bytes"] == HEAD_CHUNK
        assert stat["transferred_bytes"] < 0.05 * stat["logical_bytes"]
    # replay-side: B's chain resolves through A's chunks transparently
    with _session(tmp_path / "runB", mode="replay") as sess:
        back, _ = sess.ctx.restore_checkpoint("train@0.0", like=_tree(0.0))
    assert _equal(back, state)


def test_warm_start_v1_ancestor_falls_back_cold(tmp_path):
    """An ancestor whose final checkpoint is a v1 (put_tree) manifest can't
    seed digests — warm_start still restores the state; the first
    checkpoint records cold instead of failing."""
    root = str(tmp_path / "store")
    t = _tree(7.0)
    CheckpointStore(root, run_id="A").put_tree("train@0.0", t)
    reg = RunRegistry(root)
    reg.register("A", namespace="A")
    reg.finalize("A", final_keys={"train": "train@0.0"})
    with _session(tmp_path / "runB", root, "B", "A") as sess:
        ctx = sess.ctx
        state = sess.warm_start("train", like=_tree(0.0))
        assert _equal(state, t)
        info = ctx.warmstart_stats["train"]
        assert not info["seeded"] and "v1" in info["reason"]
        ctx.submit_checkpoint("train", "train@0.0", state, meta={})
        assert ctx.pipeline.stats[-1]["kind"] == "full"   # cold, but correct
        assert _equal(state, ctx.store.get_tree("train@0.0", like=state))


def test_warm_start_requires_lineage_config(tmp_path):
    with _session(tmp_path / "run") as sess:
        with pytest.raises(RuntimeError, match="parent_run"):
            sess.warm_start("train")


def test_warm_start_from_flat_namespace_parent(tmp_path):
    """A legacy run (private flat store, no store_root) can parent a
    namespaced derived run sharing its store: the '::key' explicit-flat
    form keeps the parent addressable, and the child's gc never treats the
    flat sibling's manifests as dead."""
    run_a = tmp_path / "runA"
    final_a = _record_run(run_a, None, None, 3)
    run_a_id = read_run_meta(str(run_a))["run_id"]
    root = run_a / "store"                   # share A's private store
    with _session(tmp_path / "runB", root, "B", run_a_id,
                  full_every=8) as sess:
        ctx = sess.ctx
        state = sess.warm_start("train", like=_tree(0.0))
        assert _equal(state, final_a)
        assert ctx.warmstart_stats["train"]["parent_key"] == "::train@2.0"
        state = _bump(state)
        ctx.submit_checkpoint("train", "train@0.0", state, meta={})
        assert ctx.pipeline.stats[-1]["kind"] == "delta"
        ctx.gc(keep_keys=["train@0.0"])     # B's run-local retention
        sa = CheckpointStore(str(root))
        for e in range(3):
            assert sa.has(f"train@{e}.0"), f"flat sibling lost train@{e}.0"
        assert _equal(final_a, sa.get_tree("train@2.0", like=final_a))
        assert _equal(state, ctx.store.get_tree("train@0.0", like=state))


def test_derived_run_replays_after_parent_unregistered(tmp_path):
    """`runs rm A` keeps descendants' chunk closure — replay of B does not
    need A's registry record either (the warm-start key is persisted in
    B's own flor.run.json at record time)."""
    root = str(tmp_path / "store")
    _record_run(tmp_path / "runA", root, "A", 4, full_every=2)
    final_b = _record_run(tmp_path / "runB", root, "B", 1, parent="A",
                          full_every=8)
    meta = read_run_meta(str(tmp_path / "runB"))
    assert meta["warm_start_keys"] == {"train": "A::train@3.0"}
    reg = RunRegistry(root)
    reg.unregister("A")
    reg.gc(CheckpointStore(root))
    with _session(tmp_path / "runB", mode="replay") as sess:
        start = sess.warm_start("train", like=_tree(0.0))  # no registry
        assert start["head"][0].item() == 5.0              # A's tip
        assert sess.ctx.pipeline is None                   # restore only
        back, _ = sess.ctx.restore_checkpoint("train@0.0", like=_tree(0.0))
    assert _equal(back, final_b)


# -------------------------------------------------------- multi-run gc --
def test_registry_gc_reclaims_only_unreachable(tmp_path):
    """Drop run A's registration; gc keeps exactly what run B's closure
    still resolves through."""
    root = str(tmp_path / "store")
    _record_run(tmp_path / "runA", root, "A", 4, full_every=2)
    # A: ck0 full, ck1 delta, ck2 full, ck3 delta; B chains onto ck3
    final_b = _record_run(tmp_path / "runB", root, "B", 1, parent="A",
                          full_every=8)
    store = CheckpointStore(root)
    reg = RunRegistry(root)
    assert reg.gc(store)["deleted_manifests"] == 0    # both runs live
    reg.unregister("A")
    stats = reg.gc(store)
    # A's final chain (ck3 -> ck2 full) survives via B's closure
    assert stats["deleted_manifests"] == 2
    assert store.has("A::train@3.0") and store.has("A::train@2.0")
    assert not store.has("A::train@0.0") and not store.has("A::train@1.0")
    assert stats["deleted_chunks"] >= 1
    sb = CheckpointStore(root, run_id="B")
    assert _equal(final_b, sb.get_tree("train@0.0", like=final_b))
    stats2 = reg.gc(store)                            # second pass: no-op
    assert stats2["deleted_manifests"] == 0 and stats2["deleted_chunks"] == 0


def test_default_gc_keeps_warmstart_tip_before_first_submit(tmp_path):
    """ctx.gc() with no keep_keys, after warm_start but before the first
    submit, keeps the ancestor tip the pipeline will chain to — even when
    the ancestor run was unregistered."""
    root = str(tmp_path / "store")
    _record_run(tmp_path / "runA", root, "A", 2, full_every=8)
    with _session(tmp_path / "runB", root, "B", "A", full_every=8) as sess:
        ctx = sess.ctx
        state = sess.warm_start("train", like=_tree(0.0))
        RunRegistry(root).unregister("A")
        ctx.gc()                  # default live set; B's namespace is empty
        assert ctx.store.has("A::train@1.0")      # pipeline tip survives
        state = _bump(state)
        ctx.submit_checkpoint("train", "train@0.0", state, meta={})
        assert ctx.pipeline.stats[-1]["kind"] == "delta"
        assert _equal(state, ctx.store.get_tree("train@0.0", like=state))


# ----------------------------------------------------------- runs CLI --
def test_runs_cli_list_show_rm_gc(tmp_path, capsys):
    root = str(tmp_path / "store")
    _record_run(tmp_path / "runA", root, "A", 4, full_every=2)
    final_b = _record_run(tmp_path / "runB", root, "B", 1, parent="A")
    assert runs_main(["list", "--store-root", root]) == 0
    out = capsys.readouterr().out
    assert "A" in out and "B" in out and "delta" in out
    assert runs_main(["show", "B", "--store-root", root]) == 0
    assert "ancestry   B <- A" in capsys.readouterr().out
    # rm refuses while descendants are registered
    assert runs_main(["rm", "A", "--store-root", root]) == 1
    assert runs_main(["rm", "A", "--force", "--gc",
                      "--store-root", root]) == 0
    assert "deleted 2 manifests" in capsys.readouterr().out
    # run-dir form resolves through flor.run.json
    assert runs_main(["list", "--store-root", str(tmp_path / "runB")]) == 0
    sb = CheckpointStore(root, run_id="B")
    assert _equal(final_b, sb.get_tree("train@0.0", like=final_b))


def test_runs_cli_diff_chunks_shared_vs_unique(tmp_path, capsys):
    """`runs diff A B`: a warm-started child shares its parent's frozen
    chunks; the diff exposes exactly that."""
    root = str(tmp_path / "store")
    _record_run(tmp_path / "runA", root, "A", 2, full_every=2)
    _record_run(tmp_path / "runB", root, "B", 2, parent="A")
    assert runs_main(["diff", "A", "B", "--store-root", root]) == 0
    out = capsys.readouterr().out
    assert "shared" in out and "only A" in out and "only B" in out
    store = CheckpointStore(root)
    ca = store.closure_chunks([f"A::{k}" for k in store.list_keys(run="A")])
    cb = store.closure_chunks([f"B::{k}" for k in store.list_keys(run="B")])
    assert ca & cb, "warm-started child must share parent chunks"
    assert cb - ca, "child's own mutations must be unique"
    assert runs_main(["diff", "A", "nope", "--store-root", root]) == 1


# ------------------------------------------------------------ launcher --
def test_launcher_parent_run_then_replay_check(tmp_path):
    """The record launcher warm-starts a derived run from its parent's
    final checkpoint (first checkpoint a cross-run delta), and the replay
    launcher replays it through the parent's chunks: deferred check ok."""
    root = str(tmp_path / "store")
    a = launcher.main(SMALL + ["--epochs", "2", "--steps-per-epoch", "2",
                               "--run-dir", str(tmp_path / "runA"),
                               "--store-root", root, "--run-id", "A"])
    b = launcher.main(SMALL + ["--epochs", "2", "--steps-per-epoch", "2",
                               "--run-dir", str(tmp_path / "runB"),
                               "--store-root", root, "--run-id", "B",
                               "--parent-run", "A"])
    ws = b["warmstart"]["train"]
    assert ws["seeded"] and ws["parent_key"] == "A::train@1.0"
    first = b["ckpt_stats"][0]
    assert first["kind"] == "delta" and first["parent"] == "A::train@1.0"
    assert int(b["state"].step) == int(a["state"].step) + 4
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="2")
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.replay", *SMALL[:7],
         "--run-dir", str(tmp_path / "runB"), "--nworkers", "2",
         "--probe", "train", "--check"],
        env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert "deferred check: ok=True compared=2 hindsight=4" in r.stdout


# --------------------------------------------------------- digest reuse --
def test_seeded_digest_is_reused_not_recomputed(monkeypatch):
    """A digest seeded on the leaf's own device feeds the fused
    fingerprint+compare: no first-sight fingerprint, nothing transferred
    for identical bytes, one chunk for a one-element change."""
    tr = DeltaTracker(chunk_words=256)
    x = torch.from_numpy(FROZEN[:4 * 256].copy())
    tr.seed("p", x)

    def _no_first_sight(*a, **k):
        raise AssertionError("seeded digest was recomputed from scratch")

    monkeypatch.setattr(delta_mod, "fingerprint_leaf", _no_first_sight)
    h = tr.delta_dispatch("p", x)
    assert not h["first"]
    d = tr.finalize(h)
    assert d["transferred_bytes"] == 0 and not d["mask"].any()
    y = x.clone()
    y[300] += 1.0
    d = tr.delta("p", y)
    assert d["changed_idx"].tolist() == [1]
    assert d["transferred_bytes"] == 256 * 4


@pytest.mark.cuda
def test_cpu_seeded_digest_moves_to_the_card(monkeypatch):
    """A digest seeded on the CPU (a warm start without ``like``) moves to
    the card at the first compare: the fused kernel runs against it, no
    first-sight fingerprint, nothing transferred for identical bytes, one
    chunk for a one-element change."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from repro_torch.kernels import ops
    tr = DeltaTracker(chunk_words=256)
    x = torch.from_numpy(FROZEN[:4 * 256].copy())
    tr.seed("p", x)
    assert tr._digests["p"].device.type == "cpu"

    def _no_first_sight(*a, **k):
        raise AssertionError("seeded digest was recomputed from scratch")

    monkeypatch.setattr(delta_mod, "fingerprint_leaf", _no_first_sight)
    ops.reset_launch_counts()
    h = tr.delta_dispatch("p", x.cuda())
    assert not h["first"] and h["digest"].is_cuda
    d = tr.finalize(h)
    assert d["transferred_bytes"] == 0 and not d["mask"].any()
    y = x.clone()
    y[300] += 1.0
    d = tr.delta("p", y.cuda())
    assert d["changed_idx"].tolist() == [1]
    assert d["transferred_bytes"] == 256 * 4
    assert ops.launch_counts()["fingerprint_changed"] == 2


# ------------------------------------------------------- cross-package --
def _jax_record(run_dir, root, run_id, n_ckpts, parent=None):
    """The reference package's side of a lineage: the same recording
    through ``repro.flor`` on numpy host trees."""
    import repro.flor as jflor
    spec = jflor.RecordSpec(adaptive=False, async_materialize=False,
                            full_manifest_every=2)
    with jflor.Session(str(run_dir), mode="record", record=spec,
                       lineage=jflor.LineageSpec(store_root=str(root),
                                                 run_id=run_id,
                                                 parent_run=parent)) as sess:
        t = {k: v.numpy() for k, v in _tree(1.0).items()}
        if parent is not None:
            t = sess.warm_start("train", like=t)
            t = {k: np.asarray(v) for k, v in t.items()}
        for e in range(n_ckpts):
            t = dict(t, head=t["head"] + 1)
            sess.ctx.submit_checkpoint("train", f"train@{e}.0", t, meta={})
        stats = sess.ctx.pipeline.stats
        ws = dict(sess.ctx.warmstart_stats)
    return t, stats, ws


def _torch_record(run_dir, root, run_id, n_ckpts, parent=None):
    with _session(run_dir, root, run_id, parent) as sess:
        t = _tree(1.0)
        if parent is not None:
            t = sess.warm_start("train", like=t)
        for e in range(n_ckpts):
            t = _bump(t)
            sess.ctx.submit_checkpoint("train", f"train@{e}.0", t, meta={})
        stats = sess.ctx.pipeline.stats
        ws = dict(sess.ctx.warmstart_stats)
    return t, stats, ws


@pytest.mark.parametrize("parent_pkg", ["repro", "repro_torch"])
def test_warm_start_across_packages(tmp_path, parent_pkg):
    """A run recorded by one package parents a run recorded by the other:
    the child's first checkpoint is a delta against the other package's
    tip, and every checkpoint restores bit-identically through both."""
    from repro.checkpoint import CheckpointStore as JStore
    root = tmp_path / "store"
    rec_parent, rec_child = (_jax_record, _torch_record) \
        if parent_pkg == "repro" else (_torch_record, _jax_record)
    final_a, _, _ = rec_parent(tmp_path / "runA", root, "A", 3)
    final_b, stats, ws = rec_child(tmp_path / "runB", root, "B", 2,
                                   parent="A")
    assert ws["train"]["seeded"] and ws["train"]["parent_key"] == "A::train@2.0"
    first = stats[0]
    assert first["kind"] == "delta" and first["parent"] == "A::train@2.0"
    assert first["transferred_bytes"] == HEAD_CHUNK
    for key, want in (("A::train@2.0", final_a), ("B::train@1.0", final_b)):
        got_t = CheckpointStore(str(root)).get_tree(key)
        got_j = JStore(str(root)).get_tree(key)
        for name in ("frozen", "head"):
            path = f"['{name}']"
            assert _bytes(got_t[path]) == _bytes(want[name]), (key, name)
            assert _bytes(got_j[path]) == _bytes(want[name]), (key, name)
