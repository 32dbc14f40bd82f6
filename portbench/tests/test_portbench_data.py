"""The token generator and the plain store reader."""
import numpy as np
import pytest
import torch

from portbench import tokens
from portbench.reference.store_reader import StoreReader, values

UNIFORM = {"distribution": "uniform"}


def test_tokens_repeat_and_differ():
    a = tokens.step_tokens(UNIFORM, 32000, 2, 64, 2**31 + 5, 3)
    assert a.dtype == np.int32 and a.shape == (2, 64)
    assert np.array_equal(a, tokens.step_tokens(UNIFORM, 32000, 2, 64,
                                                2**31 + 5, 3))
    # another step, and seeds 2**32 apart, give other ids
    assert not np.array_equal(a, tokens.step_tokens(UNIFORM, 32000, 2, 64,
                                                    2**31 + 5, 4))
    assert not np.array_equal(a, tokens.step_tokens(UNIFORM, 32000, 2, 64,
                                                    2**31 + 5 + 2**32, 3))


def test_tokens_uniform_and_zipf():
    u = tokens.step_tokens(UNIFORM, 100, 100, 1000, 7, 0)
    assert u.min() == 0 and u.max() == 99
    counts = np.bincount(u.ravel(), minlength=100)
    assert counts.min() > 800 and counts.max() < 1200      # ~1000 each
    z = tokens.step_tokens({"distribution": "zipf", "s": 1.1}, 100, 100,
                           1000, 7, 0)
    zc = np.bincount(z.ravel(), minlength=100)
    assert zc[0] > 10 * zc[50] and z.max() <= 99
    with pytest.raises(ValueError):
        tokens.step_tokens({"distribution": "poisson"}, 10, 1, 1, 0, 0)


@pytest.mark.parametrize("bounds", [(), {"mu": 1e-2, "nu": 1e-3}])
def test_store_reader_reads_what_the_program_wrote(tmp_path, bounds):
    """Every checkpoint of a record (full, delta and, with error bounds,
    q8 / q4 chunks) read by the plain reader equals what the program's
    own store returns for it."""
    from repro_torch import flor
    from repro_torch.checkpoint import CheckpointStore

    gen = torch.Generator().manual_seed(0)
    state = {"w": torch.randn(70_000, generator=gen),
             "b": torch.randn(300, generator=gen).to(torch.bfloat16),
             "mu": torch.randn(50_000, generator=gen) * 1e-3,
             "nu": torch.rand(50_000, generator=gen) * 1e-4,
             "i": torch.arange(10, dtype=torch.int32)}
    run = str(tmp_path / "run")
    with flor.Session(run, record=flor.RecordSpec(
            adaptive=False, ckpt_error_bounds=bounds)) as sess:
        with sess.checkpointing(state=state) as ck:
            for epoch in sess.loop("epochs", range(4)):
                for _ in sess.loop("train", range(1)):
                    s = dict(ck.state)
                    s["w"] = s["w"].clone()
                    s["w"][: 1000 * (epoch + 1)] += 1.0     # a few chunks
                    s["mu"] = s["mu"] * 0.9 + 1e-4
                    s["nu"] = s["nu"] * 0.95
                    ck.state = s
        root = sess.store_root
    reader, store = StoreReader(root), CheckpointStore(root)
    keys = reader.keys()
    assert len(keys) == 4
    kinds, lossy = set(), False
    for key in keys:
        kinds.add(reader.manifest(key).get("kind"))
        mine = reader.read_tree(key)
        theirs = store.get_tree(key)
        assert set(mine) == set(theirs)
        for path, (raw, dtype, shape, was_lossy) in mine.items():
            t = theirs[path]
            assert tuple(t.shape) == shape
            if t.dtype == torch.bfloat16:
                t = t.view(torch.int16)
            assert raw.tobytes() == t.numpy().tobytes(), (key, path)
            lossy |= was_lossy
            if dtype in ("float32", "bfloat16"):
                assert np.isfinite(values(raw, dtype)).all()
    assert kinds == {"full", "delta"}
    assert lossy == bool(bounds)
