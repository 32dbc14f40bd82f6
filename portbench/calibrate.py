"""The readings that a cell's limits are set from, on the card.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,... \
        [--control-seeds 1,2,3] [--out FILE]

For each seed, the program's sound readings: a run of the cell with a
window of one epoch, compared with the float32 reference as every run is
(``harness.run_cell``). For each control seed, more readings against the
float32 reference: the control (the reference in float8 in the program's
place, choosing its own experts, which the float32 reference follows as it
follows the program's) and planted faults in the reference put in the
program's place (half of each batch left out, its mean taken over the
rest; the loss altered by 1% where it is produced; a state left unchanged;
and in a sparse model, misrouted: the float32 reference's own choices with
a token's k-th choice swapped for its (k+1)-th on 1% of the tokens, drawn
from the seed). Each reading is one JSON line with the cell's judgement of
it (``check.judge`` against ``limits/<cell>.json``, the logged rows,
checkpoints and recomputed choices taken as sound); a cell's limit lies
above the largest sound reading and below the smallest control or fault
reading that separates (``PERF.md``).
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


def own_routes(readings, k):
    """The choices a reference run made itself: each step's and layer's
    first ``k`` of its ranking."""
    return [[r[:, :k] for r in step] for step in readings["ranks"]]


def misrouted(readings, k, seed, share=0.01):
    """A reference run's own choices with the k-th swapped for the
    (k+1)-th on ``share`` of the tokens (at least one), drawn from the
    seed, in every step and layer."""
    import torch

    out = []
    for step in readings["ranks"]:
        layers = []
        for r in step:
            T = r.shape[0]
            g = torch.Generator().manual_seed(seed % (1 << 63))
            rows = torch.randperm(T, generator=g)[:max(1, round(share * T))]
            ids = r[:, :k].clone()
            ids[rows.to(r.device), k - 1] = r[rows.to(r.device), k]
            layers.append(ids)
        out.append(layers)
    return out


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
                dict(obj["numbers"], log_mismatch=0, ckpt_mismatch=0,
                     route_mismatch=0), cell.limits)["correct"]
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
    k = cell.dims["k"]

    def reference(seed, precision, **kw):
        return harness.reference_readings(cell.conf, cell.mix, seed, dev,
                                          precision, **kw)

    for seed in [int(s) for s in args.control_seeds.split(",") if s]:
        t0 = time.perf_counter()
        base = reference(seed, "float32")
        ctrl = reference(seed, "float8")
        if k:
            ctrl_base = reference(seed, "float32",
                                  routes=own_routes(ctrl, k))
        else:
            ctrl_base = base
        emit({"cell": args.workload, "seed": seed, "kind": "control",
              "numbers": check.numbers(ctrl, ctrl_base),
              "leaves": check.leaf_gaps(ctrl, ctrl_base),
              "s": time.perf_counter() - t0})
        altered = dict(base, loss=[x * 1.01 for x in base["loss"]])
        emit({"cell": args.workload, "seed": seed, "kind": "altered_answer",
              "numbers": check.numbers(altered, base)})
        unchanged = dict(base, change=dict.fromkeys(base["change"], 0.0))
        emit({"cell": args.workload, "seed": seed, "kind": "unchanged_state",
              "numbers": check.numbers(unchanged, base)})
        feed = harness.Feed(cell.mix, cell.dims["V"], seed, dev)
        half = reference(seed, "float32",
                         tokens_fn=half_batch(feed, cell.mix))
        emit({"cell": args.workload, "seed": seed, "kind": "half_batch",
              "numbers": check.numbers(half, base)})
        if k:
            # the program's readings and the reference's alike follow the
            # misrouted choices: only the route gap can see them
            mis = reference(seed, "float32",
                            routes=misrouted(base, k, seed))
            emit({"cell": args.workload, "seed": seed, "kind": "misrouted",
                  "numbers": check.numbers(mis, mis)})
        print(f"control seed {seed}: {time.perf_counter() - t0:.1f} s",
              file=sys.stderr, flush=True)
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
