"""The check sees a broken timed path: a run driven through the harness
(its look for a card skipped: the CPU) with the program's step broken
underneath comes out not correct, once for each fault a one-chip training
cell can have. The program runs in float32 here, so the sound run's gaps
are float32 rounding and every number it reads lies far below its limit;
the limits are the real cells'."""
import json
import os

import pytest

from portbench import harness
from portbench.tests.smoke import smoke_tree


def unchanged(step):
    """A step that returns its state unchanged."""
    def broken(state, batch):
        _, out = step(state, batch)
        return state, out
    return broken


def half_batch(step):
    """Half of the batch left out, the mean taken over the rest (half of
    the sequence where the batch is one row)."""
    def broken(state, batch):
        t = batch["tokens"]
        t = t[: t.shape[0] // 2] if t.shape[0] > 1 else t[:, : t.shape[1] // 2]
        return step(state, {"tokens": t})
    return broken


def altered_answer(step):
    """The step's loss altered where it is produced (by 1%)."""
    def broken(state, batch):
        new, out = step(state, batch)
        return new, dict(out, loss=out["loss"] * 1.01)
    return broken


def _cell(tmp_path, index):
    bench, here, cells = smoke_tree(str(tmp_path))
    cell = cells[index]
    path = os.path.join(here, "configs", cell.split(".")[0] + ".json")
    with open(path) as f:
        conf = json.load(f)
    conf["run"]["dtype"] = "float32"
    with open(path, "w") as f:
        json.dump(conf, f)
    return bench, here, cell


@pytest.mark.parametrize("index", [0, 1, 2])
@pytest.mark.parametrize("fault", [None, unchanged, half_batch,
                                   altered_answer])
def test_fault_fails_the_check(tmp_path, index, fault):
    bench, here, cell = _cell(tmp_path, index)
    r = harness.run_cell(bench, cell, 21, 0.0, False, "cpu", 0.0, here=here,
                         wrap_step=fault, log=lambda s: None)
    assert r["correct"] is (fault is None), r["checks"]


def test_lost_log_row_fails_the_check(tmp_path, monkeypatch):
    """The logging layer losing a row where it takes it in."""
    from repro_torch.logging.stream import FingerprintLog

    take = FingerprintLog.log
    seen = []

    def lossy(self, epoch, key, value):
        seen.append(key)
        if len(seen) != 7:
            take(self, epoch, key, value)
    monkeypatch.setattr(FingerprintLog, "log", lossy)
    bench, here, cell = _cell(tmp_path, 0)
    r = harness.run_cell(bench, cell, 21, 0.0, False, "cpu", 0.0, here=here,
                         log=lambda s: None)
    assert r["checks"]["log_mismatch"]["value"] > 0 and not r["correct"]
