"""Smoke-sized copies of the benchmark's cells for the CPU tests.

``smoke_tree(tmp)`` copies the benchmark (its folder and ``BENCHMARK.json``)
under ``tmp`` and adds, for every cell, a smoke configuration, a smoke mix,
its limits and a cell ``<config>-smoke.<mix>-smoke``, named in the
``workloads`` of each metric that names the cell it shrinks: new files and
entries only, the way a later change adds a cell. The MoE cell, which
``BENCHMARK.json`` leaves out while its rate spreads from run to run by more
than the accepted bound allows (``PERF.md``), is shrunk the same way from
its configuration, mix and limits, so that its check stays held to the
program. A configuration with experts keeps 4 of them.
"""
from __future__ import annotations

import json
import os
import shutil

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)

SMOKE_SIZES = {"hidden_size": 64, "intermediate_size": 128,
               "num_attention_heads": 4, "num_key_value_heads": 2,
               "num_hidden_layers": 2, "vocab_size": 256}
SMOKE_MIX = {"batch": 2, "seq": 64, "steps_per_epoch": 2}
HELD_BACK = {"name": "mixtral-8x7b.record_8k", "config": "mixtral-8x7b",
             "traffic": "record_8k", "chips": 1}
HELD_BACK_METRIC = {"name": "moe_drop_frac", "unit": "%", "better": "lower",
                    "source": "program_counter", "layer": "MoE layer",
                    "moves": "train_tokens_per_s"}


def smoke_tree(tmp: str, record: dict | None = None) -> tuple[str, str,
                                                             list[str]]:
    """(BENCHMARK.json path, benchmark dir, smoke cell names)."""
    here = os.path.join(tmp, "portbench")
    shutil.copytree(HERE, here, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = []
    bench["per_layer"].append(dict(HELD_BACK_METRIC, workloads=[]))
    for w in list(bench["workloads"]) + [HELD_BACK]:
        conf = _load(here, "configs", w["config"])
        conf.update(SMOKE_SIZES, name=w["config"] + "-smoke")
        if conf.get("num_local_experts"):
            conf["num_local_experts"] = 4
        _dump(here, "configs", conf["name"], conf)
        mix = _load(here, "traffic", w["traffic"])
        mix.update(SMOKE_MIX, name=w["traffic"] + "-smoke")
        if record is not None:
            mix["record"] = record
        _dump(here, "traffic", mix["name"], mix)
        name = f"{conf['name']}.{mix['name']}"
        _dump(here, "limits", name, _load(here, "limits", w["name"]))
        bench["workloads"].append(dict(w, name=name, config=conf["name"],
                                       traffic=mix["name"]))
        for metric in bench["end_to_end"] + bench["per_layer"]:
            if w["name"] in metric.get("workloads", ()) or (
                    w is HELD_BACK
                    and metric["name"] == HELD_BACK_METRIC["name"]):
                metric["workloads"].append(name)
        cells.append(name)
    path = os.path.join(tmp, "BENCHMARK.json")
    with open(path, "w") as f:
        json.dump(bench, f, indent=1)
    return path, here, cells


def _load(here, folder, name):
    with open(os.path.join(here, folder, name + ".json")) as f:
        return json.load(f)


def _dump(here, folder, name, obj):
    with open(os.path.join(here, folder, name + ".json"), "w") as f:
        json.dump(obj, f, indent=1)
