"""Quickstart on the PyTorch port: train a model with Flor record on.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu] [--full]

The PyTorch counterpart of examples/quickstart.py, on ``repro_torch``: it
trains the florbench-100m model (the reduced config by default; --full
trains the real 124M config; --arch picks another architecture of
``repro_torch.configs``) for a few hundred steps with always-on
hindsight-logging record, on the session-first API: an explicit
`flor.Session`, named nested `flor.loop`s, a declarative
`flor.checkpointing` scope, and replay-stable `flor.arg` hyperparameters.
It runs on the card (``--device cuda``, the default) unless ``--device
cpu`` is given. Afterwards, see examples/torch_hindsight_replay.py to query
execution data you never logged, and

    python -m repro_torch.launch.runs pivot --store-root <run-dir>

to view the run's logs (and any lineage sharing its store) as a table.
The last line prints a digest of the final training state: a replay that
re-executes every epoch ends on the same digest.
"""
import argparse
import time

import repro_torch.configs as C
import repro_torch.flor as flor
from repro_torch.data import PrefetchLoader, synthetic_batch
from repro_torch.train.step import build_train_step
from repro_torch.utils.pytree import tree_digest

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda",
                help="torch device (default cuda; 'cpu' runs the kernels' "
                     "plain versions)")
ap.add_argument("--arch", default="florbench-100m")
ap.add_argument("--full", action="store_true", help="the published config")
ap.add_argument("--epochs", type=int, default=8)
ap.add_argument("--steps-per-epoch", type=int, default=25)
ap.add_argument("--run-dir", default="/tmp/flor_torch_quickstart")
ap.add_argument("--no-adaptive", action="store_true",
                help="checkpoint every epoch regardless of the eps budget "
                     "(useful on slow disks / CI to guarantee physical "
                     "replay restores)")
ap.add_argument("--sync-log", action="store_true",
                help="synchronous flor.log (serialize + write on the step "
                     "path); default is the background log stage — see "
                     "docs/logging.md")
args = ap.parse_args()

cfg = C.get(args.arch) if args.full else C.get_smoke(args.arch)
batch_size, seq = (8, 512) if args.full else (4, 128)

t0 = time.time()
with flor.Session(args.run_dir, mode="record",
                  record=flor.RecordSpec(
                      adaptive=not args.no_adaptive,
                      async_log=not args.sync_log)) as sess:
    # hyperparameters recorded for replay (override: FLOR_ARGS="peak_lr=3e-4")
    epochs = flor.arg("epochs", args.epochs)
    steps = flor.arg("steps_per_epoch", args.steps_per_epoch)
    peak_lr = flor.arg("peak_lr", 1e-3)

    init_state, train_step = build_train_step(cfg, device=args.device,
                                              peak_lr=peak_lr, warmup=20)
    state = init_state(0)

    with flor.checkpointing(state=state) as ckpt:
        for epoch in flor.loop("epochs", range(epochs)):
            for step, batch in flor.loop("train", lambda: PrefetchLoader(
                    lambda s: synthetic_batch(cfg, batch_size, seq, s),
                    start_step=epoch * steps, num_steps=steps)):
                ckpt.state, metrics = train_step(ckpt.state, batch)
            flor.log("loss", metrics["loss"])
            print(f"epoch {epoch}: loss={float(metrics['loss']):.4f} "
                  f"({time.time() - t0:.1f}s)", flush=True)
    state = ckpt.state

print(f"\nrecorded {args.epochs} epochs in {time.time() - t0:.1f}s; "
      f"checkpoints in {args.run_dir}/store")
print("next: python examples/torch_hindsight_replay.py --run-dir",
      args.run_dir)
print(f"final state digest: {tree_digest(state)}")
