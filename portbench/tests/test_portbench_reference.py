"""The plain reference against the program's train step, on the CPU.

With the program computing in float32 (its configuration's ``dtype``) the
two must agree to float32 rounding over the three steps the check follows:
the same losses, first-gradient norms, changes and MoE drops. The smoke
cells run the program's naive attention (S <= 2048); the long cases its
chunked online softmax, with and without a sliding window."""
import json
import os

import pytest

from portbench import harness
from portbench.tests.smoke import smoke_tree

F32_TOL = 1e-5


def _f32_cell(tmp_path, index, mix=None, conf=None):
    bench, here, cells = smoke_tree(str(tmp_path))
    cell = cells[index]
    cfg_name, mix_name = cell.split(".")
    for folder, name, extra in (("configs", cfg_name, conf),
                                ("traffic", mix_name, mix)):
        path = os.path.join(here, folder, name + ".json")
        with open(path) as f:
            obj = json.load(f)
        if folder == "configs":
            obj["run"]["dtype"] = "float32"
        obj.update(extra or {})
        with open(path, "w") as f:
            json.dump(obj, f)
    return bench, here, cell


def _numbers(bench, here, cell, seed):
    r = harness.run_cell(bench, cell, seed, 0.0, False, "cpu", 0.0,
                         here=here, log=lambda s: None)
    return {k: c["value"] for k, c in r["checks"].items()}


@pytest.mark.parametrize("index", [0, 1, 2])
@pytest.mark.parametrize("seed", [3, 2**31 + 11])
def test_reference_matches_port_float32(tmp_path, index, seed):
    nums = _numbers(*_f32_cell(tmp_path, index), seed)
    for key in ("loss_gap", "grad_gap", "change_gap", "drop_gap"):
        if key in nums:
            assert nums[key] < F32_TOL, (key, nums)
    assert nums["log_mismatch"] == 0 and nums["ckpt_mismatch"] == 0


@pytest.mark.parametrize("index,window", [(0, None), (0, 1000), (2, None)])
def test_reference_matches_port_chunked_attention(tmp_path, index, window):
    conf = {"sliding_window": window} if window else None
    cell = _f32_cell(tmp_path, index, mix={"batch": 1, "seq": 2560},
                     conf=conf)
    nums = _numbers(*cell, 5)
    for key in ("loss_gap", "grad_gap", "change_gap", "drop_gap"):
        if key in nums:
            assert nums[key] < F32_TOL, (key, nums)


def test_reference_window_short(tmp_path):
    """A window shorter than the sequence on the naive path."""
    nums = _numbers(*_f32_cell(tmp_path, 0, conf={"sliding_window": 24}), 9)
    assert nums["loss_gap"] < F32_TOL and nums["grad_gap"] < F32_TOL
