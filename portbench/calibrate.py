"""The readings that a cell's limits are set from, on the card.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,... \
        [--control-seeds 1,2,3] [--out FILE]

For each seed, the program's sound readings: a run of the cell with a
window of one epoch, compared with the float32 reference as every run is
(``harness.run_cell``). For each control seed, more readings against the
same reference: the control (the reference in float8 in the program's
place) and planted faults in the reference put in the program's place
(half of each batch left out, its mean taken over the rest; the loss
altered by 1% where it is produced; a state left unchanged). Each reading
is one JSON line with the cell's judgement of it (``check.judge`` against
``limits/<cell>.json``, the logged rows and checkpoints taken as sound); a
cell's limit lies above the largest sound reading and below the smallest
control or fault reading that separates (``PERF.md``).
"""
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]


def half_batch(feed, mix):
    """The ids of each step with half the batch left out (half of the
    sequence where the batch is one row)."""
    def ids(step):
        t = feed(step)["tokens"]
        if mix["batch"] > 1:
            return t[: mix["batch"] // 2]
        return t[:, : mix["seq"] // 2]
    return ids


def main() -> int:
    import argparse

    import torch

    from portbench import check, harness

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    bench = os.path.join(ROOT, "BENCHMARK.json")
    cell = harness.Cell(bench, args.workload)
    dev = torch.device("cuda:0")
    out = open(args.out, "a") if args.out else None

    def emit(obj):
        if "correct" not in obj:
            obj["correct"] = check.judge(
                dict(obj["numbers"], log_mismatch=0, ckpt_mismatch=0),
                cell.limits)["correct"]
        line = json.dumps(obj)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    for seed in [int(s) for s in args.seeds.split(",") if s]:
        t0 = time.perf_counter()
        diag = {}
        r = harness.run_cell(bench, args.workload, seed, 0.0, False,
                             str(dev), t0, diag=diag,
                             log=lambda s: print(s, file=sys.stderr))
        emit({"cell": args.workload, "seed": seed, "kind": "program",
              "correct": r["correct"],
              "numbers": dict(check.numbers(diag["prog"], diag["ref"]),
                              **{k: c["value"] for k, c in
                                 r["checks"].items()}),
              "leaves": check.leaf_gaps(diag["prog"], diag["ref"]),
              "metrics": r["metrics"], "s": time.perf_counter() - t0})
    for seed in [int(s) for s in args.control_seeds.split(",") if s]:
        t0 = time.perf_counter()
        base = harness.reference_readings(cell.conf, cell.mix, seed, dev,
                                          "float32")
        ctrl = harness.reference_readings(cell.conf, cell.mix, seed, dev,
                                          "float8")
        emit({"cell": args.workload, "seed": seed, "kind": "control",
              "numbers": check.numbers(ctrl, base),
              "leaves": check.leaf_gaps(ctrl, base),
              "s": time.perf_counter() - t0})
        altered = dict(base, loss=[x * 1.01 for x in base["loss"]])
        emit({"cell": args.workload, "seed": seed, "kind": "altered_answer",
              "numbers": check.numbers(altered, base)})
        unchanged = dict(base, change=dict.fromkeys(base["change"], 0.0))
        emit({"cell": args.workload, "seed": seed, "kind": "unchanged_state",
              "numbers": check.numbers(unchanged, base)})
        feed = harness.Feed(cell.mix, cell.dims["V"], seed, dev)
        half = harness.reference_readings(cell.conf, cell.mix, seed, dev,
                                          "float32",
                                          tokens_fn=half_batch(feed,
                                                               cell.mix))
        emit({"cell": args.workload, "seed": seed, "kind": "half_batch",
              "numbers": check.numbers(half, base),
              "s": time.perf_counter() - t0})
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
