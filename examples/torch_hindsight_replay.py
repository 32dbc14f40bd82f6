"""Hindsight logging on the PyTorch port: query execution data you never
logged, after the fact.

    PYTHONPATH=src python examples/torch_hindsight_replay.py \
        --run-dir /tmp/flor_torch_quickstart [--device cpu] [--probe-inner]

The PyTorch counterpart of examples/hindsight_replay.py, over a run that
examples/torch_quickstart.py recorded (pass the same --arch / --full).
Scenario (paper section 2.1): training looked wrong and you wish you had
logged per-step gradient norms and the embedding-norm trajectory. This
script "adds the log statements in hindsight" on the session API: the
outer-loop probe (embedding norm per epoch) needs NO re-execution — epochs
restore physically into the `flor.checkpointing` scope; the inner probe
(per-step grad norm, --probe-inner) re-executes the probed epochs
(`ReplaySpec(probed={"train"})`). `flor.arg` returns the RECORDED
hyperparameters, so the replay loop shape can never drift from record. It
runs on the card (``--device cuda``, the default) unless ``--device cpu``
is given. The last line prints the digest of the final state, which equals
the record's.
"""
import argparse
import sys
import time

import repro_torch.configs as C
import repro_torch.flor as flor
from repro_torch.data import synthetic_batch
from repro_torch.train.step import build_train_step
from repro_torch.utils.pytree import tree_digest

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda",
                help="torch device (default cuda; 'cpu' runs the kernels' "
                     "plain versions)")
ap.add_argument("--run-dir", default="/tmp/flor_torch_quickstart")
ap.add_argument("--arch", default="florbench-100m")
ap.add_argument("--full", action="store_true")
ap.add_argument("--epochs", type=int, default=8)
ap.add_argument("--steps-per-epoch", type=int, default=25)
ap.add_argument("--probe-inner", action="store_true",
                help="probe INSIDE the training loop (forces re-execution)")
args = ap.parse_args()

cfg = C.get(args.arch) if args.full else C.get_smoke(args.arch)
batch_size, seq = (8, 512) if args.full else (4, 128)

probed = frozenset({"train"}) if args.probe_inner else frozenset()
t0 = time.time()
with flor.Session(args.run_dir, mode="replay",
                  replay=flor.ReplaySpec(probed=probed)) as sess:
    epochs = flor.arg("epochs", args.epochs)
    steps = flor.arg("steps_per_epoch", args.steps_per_epoch)
    peak_lr = flor.arg("peak_lr", 1e-3)

    init_state, train_step = build_train_step(cfg, device=args.device,
                                              peak_lr=peak_lr, warmup=20)
    state = init_state(0)

    with flor.checkpointing(state=state) as ckpt:
        for epoch in flor.loop("epochs", range(epochs)):
            for s in flor.loop("train", range(steps)):
                batch = synthetic_batch(cfg, batch_size, seq,
                                        epoch * steps + s)
                ckpt.state, metrics = train_step(ckpt.state, batch)
                if args.probe_inner:
                    # the hindsight INNER probe you wish you'd written:
                    flor.log("grad_norm", metrics["grad_norm"])
            if flor.executed("train"):
                flor.log("loss", metrics["loss"])
            # the hindsight OUTER probe: embedding norm over time — computed
            # from the (restored) scope state, no re-execution needed
            emb = ckpt.state.params["embed"]["table"]
            flor.log("embed_norm", float(emb.float().norm()))
            print(f"epoch {epoch}: embed_norm logged", flush=True)
    state = ckpt.state

mode = "inner-probe (logical redo)" if args.probe_inner else \
    "outer-probe (physical restore only)"
print(f"\nhindsight replay [{mode}] finished in {time.time() - t0:.1f}s")

rec, reps = flor.run_logs(args.run_dir)
res = flor.deferred_check(rec, reps)
print(f"deferred correctness check: ok={res.ok} compared={res.compared} "
      f"hindsight_values={res.hindsight_only}")
if not res.ok:
    for a in res.anomalies[:5]:
        print("  anomaly:", a)
    sys.exit(1)

# the query surface: every logged value of this run (and any lineage
# sharing its store) as one pivoted table
rows = flor.pivot(args.run_dir, "loss", "embed_norm")
print(f"\nflor.pivot: {len(rows)} (run, epoch) rows; last: {rows[-1]}")
print(f"final state digest: {tree_digest(state)}")
