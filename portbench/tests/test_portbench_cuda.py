"""On the card: the check's control fails where the program passes.

For each cell, at its own size and with one seed: the program's run is
correct under the cell's limits (``check.judge`` against the float32
reference), and the control, the reference computed in float8 in the
program's place, is not. In a sparse model the control chooses its own
experts and the float32 reference follows those choices, as it follows
the program's in a run. Skips without a card; ``PYTHONPATH=src python -m
pytest -m cuda portbench/tests`` runs it there."""
import json
import os

import pytest
import torch

from portbench import calibrate, check, harness
from portbench.tests.smoke import ROOT

BENCH = os.path.join(ROOT, "BENCHMARK.json")
SEED = 2**31 + 17


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


def _cells():
    with open(BENCH) as f:
        return [w["name"] for w in json.load(f)["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("name", _cells())
def test_control_fails_where_the_program_passes(card, name):
    c = harness.Cell(BENCH, name)
    r = harness.run_cell(BENCH, name, SEED, 0.0, False, str(card), 0.0,
                         log=lambda s: None)
    assert r["correct"], r["checks"]
    ctrl = harness.reference_readings(c.conf, c.mix, SEED, card, "float8")
    routes = calibrate.own_routes(ctrl, c.dims["k"]) if c.dims["k"] \
        else None
    base = harness.reference_readings(c.conf, c.mix, SEED, card, "float32",
                                      routes=routes)
    # the control in the program's place, its logs, checkpoints and
    # recomputed choices sound
    verdict = check.judge(dict(check.numbers(ctrl, base), log_mismatch=0,
                               ckpt_mismatch=0, route_mismatch=0), c.limits)
    assert not verdict["correct"], verdict["checks"]
