"""Each cell's loop end to end at smoke sizes on the CPU, through the
harness's own functions, and the harness's data-driven extension: the smoke
cells are new files and entries beside the real ones, and a per-layer
metric is a new reader file. A CPU run writes no device metric: the
command itself refuses to run without a card."""
import hashlib
import json
import os
import subprocess
import sys

import pytest

from portbench import harness
from portbench.tests.smoke import HERE, ROOT, smoke_tree

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _digests(folder):
    out = {}
    for dirpath, _, files in os.walk(folder):
        for f in files:
            if "__pycache__" in dirpath:
                continue
            p = os.path.join(dirpath, f)
            out[os.path.relpath(p, folder)] = hashlib.sha256(
                open(p, "rb").read()).hexdigest()
    return out


@pytest.mark.parametrize("index", [0, 1, 2])
@pytest.mark.parametrize("trace_on", [False, True])
def test_cell_rehearsal(tmp_path, index, trace_on):
    bench, here, cells = smoke_tree(str(tmp_path))
    r = harness.run_cell(bench, cells[index], 2**31 + 99, 0.3, trace_on,
                         "cpu", 0.0, here=here, log=lambda s: None)
    assert list(r)[:5] == KEYS and list(r)[-1] == "checks"
    assert isinstance(r["correct"], bool) and r["failed"] == 0
    assert r["attempted"] >= 2
    assert r["device"]["platform"] == "cpu"
    # no device metric from a CPU run; the MoE cell's counter only
    want = {"moe_drop_frac"} if trace_on and "mixtral" in cells[index] \
        else set()
    assert set(r["metrics"]) == want
    # the smoke widths are not the cells' (their limits come from the
    # card at published widths): every number is there, the exact ones 0
    for name, c in r["checks"].items():
        assert c["value"] is not None
        if c["limit"] == 0:
            assert c["value"] == 0, name


def test_new_cell_and_metric_are_files_and_entries(tmp_path):
    """A cell, configuration, mix, limits and per-layer metric added as new
    files and entries run without an edit to any existing file."""
    bench, here, cells = smoke_tree(str(tmp_path))
    before = {k: v for k, v in _digests(HERE).items()
              if not k.startswith("tests")}
    assert {k: v for k, v in _digests(here).items() if k in before} \
        == before
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        original = json.load(f)
    with open(bench) as f:
        extended = json.load(f)
    n = len(original["workloads"])
    assert extended["workloads"][:n] == original["workloads"]
    assert extended["per_layer"][:len(original["per_layer"])] \
        == original["per_layer"]
    with open(os.path.join(here, "metrics", "smoke_window_steps.py"),
              "w") as f:
        f.write("def read(run):\n    return float(run['window_steps'])\n")
    extended["per_layer"].append(
        {"name": "smoke_window_steps", "unit": "steps", "better": "higher",
         "source": "program_counter", "layer": "train step",
         "moves": "train_tokens_per_s", "workloads": [cells[0]]})
    with open(bench, "w") as f:
        json.dump(extended, f)
    r = harness.run_cell(bench, cells[0], 4, 0.0, True, "cpu", 0.0,
                         here=here, log=lambda s: None)
    assert r["metrics"]["smoke_window_steps"]["value"] == r["attempted"]


def test_command_refuses_without_a_card():
    out = subprocess.run(
        [sys.executable, os.path.join(HERE, "run.py"), "--workload",
         "granite-3-2b.record_512", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr
