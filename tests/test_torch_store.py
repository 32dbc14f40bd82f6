"""Cross-package checkpoint store: the same states recorded through each
package's CheckpointPipeline give manifests with equal per-leaf chunk hashes
and encodings, and a store recorded by either package restores through the
other bit for bit (the lossy q8/q4 slot as well: both decode the same
bytes).

Inputs: a smoke-config TrainState initialized by the reference package,
then two seeded numpy edits (a delta chain), plus an odd-length bf16 leaf.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
from repro.checkpoint import CheckpointPipeline as JPipeline
from repro.checkpoint import CheckpointStore as JStore
from repro.train.step import build_train_step as jax_build_train_step
from repro_torch.checkpoint import CheckpointPipeline, CheckpointStore
from repro_torch.checkpoint.pipeline import PIPELINE_CHUNK_WORDS
from repro_torch.train.state import TrainState, state_from_numpy
from repro_torch.utils.pytree import tree_leaves as t_leaves

MU_ATOL = 1e-2


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfg(size: str):
    cfg = JC.get_smoke("florbench-100m")
    if size == "tiny":                  # small enough for 16-word chunks
        cfg = cfg.replace(num_layers=1, d_model=32, num_heads=2,
                          num_kv_heads=2, head_dim=16, d_ff=64,
                          vocab_size=128)
    return cfg


def _states(size: str):
    """Three host states: the reference package's init, then two edits
    that change some leaves wholly, some partly, and leave the rest."""
    init_state, _ = jax_build_train_step(_cfg(size))
    s0 = jax.device_get(jax.jit(init_state)(jax.random.PRNGKey(0)))
    s0 = jax.tree_util.tree_map(np.array, s0)
    rng = np.random.default_rng(0)
    bf = rng.standard_normal(1001).astype(np.float32).astype(jnp.bfloat16)
    out = [{"state": s0, "emb16": bf}]
    for i in (1, 2):
        prev = out[-1]
        st = jax.tree_util.tree_map(np.array, prev["state"])
        table = st.params["embed"]["table"]
        table[i * 7:i * 7 + 3] += 0.5                   # a few rows change
        mu = jax.tree_util.tree_map(
            lambda m: (m + 0.01 * rng.standard_normal(m.shape)).astype(
                m.dtype), st.mu)                        # every chunk changes
        st = st._replace(mu=mu, step=np.asarray(st.step + 1, np.int32))
        bf2 = np.array(prev["emb16"])
        bf2[:10] = (bf2[:10].astype(np.float32) + 1).astype(jnp.bfloat16)
        out.append({"state": st, "emb16": bf2})
    return out


def _to_torch(tree):
    bf = torch.from_numpy(tree["emb16"].view(np.uint16).copy()) \
        .view(torch.bfloat16)
    return {"state": state_from_numpy(tree["state"], "cpu"), "emb16": bf}


def _record(pipe, trees):
    for i, tree in enumerate(trees):
        assert pipe.submit(f"k{i}", tree, scope="train") is not None
    pipe.close()


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype == jnp.bfloat16 else a


def _manifest_view(store, key):
    m = store.resolve_manifest(key)
    return [{k: lf.get(k) for k in ("path", "dtype", "shape", "nbytes",
                                    "n_chunks", "chunks", "enc",
                                    "leaf_enc")}
            for lf in m["leaves"]]


CASES = [
    pytest.param("tiny", 16, None, False, id="cw16-exact"),
    pytest.param("tiny", 16, {"mu": MU_ATOL}, True, id="cw16-eb-overlap"),
    pytest.param("tiny", PIPELINE_CHUNK_WORDS, {"mu": MU_ATOL}, False,
                 id="cw16384-eb"),
    pytest.param("smoke", PIPELINE_CHUNK_WORDS, None, True,
                 id="cw16384-exact-overlap"),
]


@pytest.mark.parametrize("size,cw,bounds,overlap", CASES)
def test_cross_package_store(tmp_path, size, cw, bounds, overlap):
    trees = _states(size)
    jroot, troot = str(tmp_path / "jax"), str(tmp_path / "torch")
    kw = dict(chunk_words=cw, full_every=3, error_bounds=bounds,
              overlap=overlap)
    _record(JPipeline(JStore(jroot), **kw),
            [jax.tree_util.tree_map(jnp.asarray, t) for t in trees])
    _record(CheckpointPipeline(CheckpointStore(troot), **kw),
            [_to_torch(t) for t in trees])

    j_on_j, t_on_t = JStore(jroot), CheckpointStore(troot)
    j_on_t, t_on_j = JStore(troot), CheckpointStore(jroot)
    kinds = [j_on_j.get_manifest(f"k{i}")["kind"] for i in range(3)]
    assert kinds == ["full", "delta", "delta"]
    for i, tree in enumerate(trees):
        key = f"k{i}"
        # the two packages wrote the same chunks under the same encodings
        assert _manifest_view(t_on_t, key) == _manifest_view(j_on_j, key)
        assert t_on_t.get_manifest(key)["kind"] \
            == j_on_j.get_manifest(key)["kind"]
        if bounds:
            encs = {e for lf in _manifest_view(j_on_j, key)
                    for e in (lf["enc"] or ["raw"])}
            assert encs & {"q4", "q4+z", "q8", "q8+z"}, encs
        like_t = _to_torch(tree)
        want = [_np(x) for x in jax.tree_util.tree_leaves(
            j_on_j.get_tree(key, like=tree))]
        # the port reads the reference's store and its own identically ...
        for store in (t_on_j, t_on_t):
            got = [_np(x) for x in t_leaves(store.get_tree(key, like=like_t))]
            assert len(got) == len(want)
            for g, w in zip(got, want):
                assert g.dtype == w.dtype and np.array_equal(g, w)
        # ... and the reference reads the port's store identically
        got = [_np(x) for x in jax.tree_util.tree_leaves(
            j_on_t.get_tree(key, like=tree))]
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and np.array_equal(g, w)
        # exact slots are bit-identical to the source, mu within its atol
        src = jax.tree_util.tree_leaves_with_path(tree)
        for (path, s), w in zip(src, want):
            pstr = jax.tree_util.keystr(path)
            if bounds and ".mu" in pstr:
                assert np.max(np.abs(w - s)) <= MU_ATOL
            else:
                assert np.array_equal(w, _np(s)), pstr


def test_restore_into_like_keeps_devices_and_paths(tmp_path):
    """get_tree(like=) unflattens into the like tree's structure (sorted
    dict keys, NamedTuple fields) with leaves on the like leaves' device."""
    tree = _to_torch(_states("tiny")[0])
    store = CheckpointStore(str(tmp_path / "s"))
    store.put_tree("k", tree)
    back = store.get_tree("k", like=tree)
    assert isinstance(back["state"], TrainState)
    for a, b in zip(t_leaves(back), t_leaves(tree)):
        assert a.device == b.device and a.dtype == b.dtype
        assert np.array_equal(_np(a), _np(b))
    flat = store.get_tree("k")
    assert "['state'].params['embed']['table']" in flat
    assert os.path.isdir(str(tmp_path / "s"))


def test_python_scalar_leaf_records_0d_like_the_reference(tmp_path):
    """A Python scalar leaf is a 0-d leaf in both packages' manifests (it
    was once promoted to shape [1]) and restores 0-d."""
    tree = {"step": 3, "w": np.arange(8, dtype=np.float32)}
    _record(JPipeline(JStore(str(tmp_path / "j")), async_stage=False),
            [tree])
    _record(CheckpointPipeline(CheckpointStore(str(tmp_path / "t")),
                               async_stage=False), [tree])
    view = _manifest_view(CheckpointStore(str(tmp_path / "t")), "k0")
    assert view == _manifest_view(JStore(str(tmp_path / "j")), "k0")
    assert view[0]["path"] == "['step']" and view[0]["shape"] == []
    got = CheckpointStore(str(tmp_path / "t")).get_tree("k0")["['step']"]
    assert got.shape == () and int(got) == 3
