#!/usr/bin/env python3
"""Device time by the program's spans, on one card.

    python3 tools/span_probe.py flor [--rounds 6] [--out DIR]
    python3 tools/span_probe.py cell --workload <cell> --seed <n> \
        [--seconds 10] [--dump] [--out DIR]

Run from a checkout on a machine with one NVIDIA H100. ``cell`` runs one
traced run of a benchmark cell (``portbench.harness.run_cell``, ``--trace
1``) whose profiled epoch is also read by ``portbench.spans.attribute``,
and writes ``<out>/<cell>-<seed>.json`` (``--out``, by default
``build/spans``): the result line, the
attribution, each layer's milliseconds a step (``spans.layer_ms``), each
span's own device milliseconds a step (``span_ms``: a MoE layer's
``repro_torch.moe.route`` / ``.dispatch`` / ``.experts`` / ``.combine``
beside what stays in ``repro_torch.ffn``), the count of each span, and the
optimizer's elements by route over the run (``route_elems``, from
``train/optimizer.py``) with the fused kernels' share of them
(``fused_share``, printed after ``layer_ms``' ``optimizer_ms``);
``--dump`` adds every profiler event to
``<out>/<cell>-<seed>.events.json.gz`` for reading off the card. ``flor``
times ``flor.log`` of a scalar on the card in a record ``Session``, in
rounds of 50 calls with no profiler and 50 under one (the device idle
before each call), and writes the median host µs of each to
``<out>/flor.json``: what the profiler adds to Flor's spans. Exits
non-zero without a card.
"""
from __future__ import annotations

import argparse
import gzip
import json
import os
import subprocess
import sys
import time

T0 = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]


def event_rows(events) -> list:
    """The profiler's events as plain rows (``FIELDS``)."""
    from portbench import spans

    rows = []
    for e in events:
        rows.append([e.name()[:200], str(e.device_type()).split(".")[-1],
                     spans._kind(e), e.start_ns(), e.duration_ns(),
                     e.start_thread_id(), e.correlation_id(),
                     e.linked_correlation_id(), e.sequence_nr(),
                     e.fwd_thread_id(), bool(e.is_user_annotation())])
    return rows


FIELDS = ["name", "device_type", "activity_type", "start_ns", "duration_ns",
          "start_thread_id", "correlation_id", "linked_correlation_id",
          "sequence_nr", "fwd_thread_id", "is_user_annotation"]


def span_counts(events) -> dict:
    out = {}
    for e in events:
        if e.name().startswith("repro_torch.") \
                and str(e.device_type()).endswith("CPU"):
            out[e.name()] = out.get(e.name(), 0) + 1
    return out


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def write(out_dir, name, report, events, dump):
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, name + ".json"), "w") as f:
        json.dump(report, f, indent=1)
    if dump:
        with gzip.open(os.path.join(out_dir, name + ".events.json.gz"),
                       "wt") as f:
            json.dump({"fields": FIELDS, "rows": event_rows(events)}, f)


def cell(args):
    import torch

    from portbench import harness, spans, trace
    from repro_torch.train import optimizer

    kept = {}

    class Tracer(trace.Tracer):
        def summary(self):
            events = self._prof.profiler.kineto_results.events()
            self._prof = self._win = None
            kept["events"] = events
            return trace.summarize(events)

    harness.Tracer = Tracer
    result = harness.run_cell(
        os.path.join(ROOT, "BENCHMARK.json"), args.workload, args.seed,
        args.seconds, True, "cuda:0", T0,
        log=lambda s: print(s, file=sys.stderr))
    got = spans.attribute(kept["events"])
    # the profiled epoch is one of the mix's epochs
    steps = harness.Cell(os.path.join(ROOT, "BENCHMARK.json"),
                         args.workload).mix["steps_per_epoch"]
    by = got["spans"]
    report = {"card": card(), "torch": torch.__version__,
              "workload": args.workload, "seed": args.seed,
              "profiled_steps": steps,
              "counts": span_counts(kept["events"]),
              "layer_ms": spans.layer_ms(got, steps),
              "span_ms": {k: v["device_s"] * 1e3 / steps
                          for k, v in sorted(by.items())},
              "route_elems": dict(optimizer.route_elems),
              "fused_share": optimizer.route_elems["fused"] / max(
                  1, sum(optimizer.route_elems.values())),
              "busy_s": result["device"]["busy_s"], "attributed_s": sum(
                  v["device_s"] for k, v in by.items() if k != spans.NONE),
              "unattributed_s": by.get(spans.NONE, {}).get("device_s", 0.0),
              "result": result, "attribution": got}
    write(args.out, f"{args.workload}-{args.seed}", report, kept["events"],
          args.dump)
    print(json.dumps({k: report[k] for k in (
        "workload", "seed", "layer_ms", "route_elems", "fused_share",
        "span_ms", "busy_s",
        "attributed_s", "unattributed_s")}))
    print(json.dumps(result))


def flor(args):
    import statistics
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import flor as F

    dev = torch.device("cuda", 0)
    x = torch.zeros((), device=dev)
    got = {"off": [], "on": []}
    with tempfile.TemporaryDirectory() as d:
        with F.Session(d, mode="record", record=F.RecordSpec()) as sess:
            for _ in range(args.rounds):
                for side in ("off", "on"):
                    prof = profile(activities=[
                        ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
                        if side == "on" else None
                    if prof is not None:
                        prof.start()
                    for _ in range(50):
                        x = x + 1
                        torch.cuda.synchronize(dev)
                        t0 = time.perf_counter()
                        sess.log("loss", x)
                        got[side].append(time.perf_counter() - t0)
                    if prof is not None:
                        prof.stop()
    report = {"card": card(), "torch": torch.__version__,
              "calls": {k: len(v) for k, v in got.items()},
              "median_us": {k: statistics.median(v) * 1e6
                            for k, v in got.items()},
              "quartiles_us": {k: [q * 1e6 for q in statistics.quantiles(
                  v, n=4)] for k, v in got.items()}}
    write(args.out, "flor", report, None, False)
    print(json.dumps(report))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("mode", choices=("cell", "flor"))
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--dump", action="store_true")
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "spans"))
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("span_probe: no card (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    (cell if args.mode == "cell" else flor)(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
