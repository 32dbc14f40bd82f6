"""Hindsight parallelism on the PyTorch port, query-driven: record, EDIT the
script to add the log statement you wish you had, and let the replay
planner work out the minimal re-execution — then scale it over G workers.

    PYTHONPATH=src python examples/torch_parallel_replay.py --nworkers 4 \
        [--device cpu]

The PyTorch counterpart of examples/parallel_replay.py. It runs on the
card (``--device cuda``, the default) unless ``--device cpu`` is given.
Flow:
  1. record a run with the port's training launcher (the record session
     stores a copy of the driving script automatically);
  2. simulate the hindsight edit: copy the recorded script and insert a
     ``flor.log`` probe INSIDE the training loop;
  3. replay with ``--probe auto``: the launcher diffs recorded vs edited
     source, maps the added line to its innermost enclosing flor loop
     ("train"), plans which epochs must re-execute at what cost, schedules
     them cost-balanced over G worker processes (dynamic work queue), and
     merges the per-worker logs by plan segment;
  4. the deferred fingerprint check must pass on the merged log.
"""
import argparse
import importlib.util
import os
import shutil
import subprocess
import sys
import time

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda",
                help="torch device (default cuda; 'cpu' runs the kernels' "
                     "plain versions)")
ap.add_argument("--run-dir", default="/tmp/flor_torch_parallel_replay")
ap.add_argument("--nworkers", type=int, default=4)
ap.add_argument("--epochs", type=int, default=8)
ap.add_argument("--steps-per-epoch", type=int, default=6)
ap.add_argument("--init-mode", choices=("strong", "weak"), default="strong")
args = ap.parse_args()

# strict: the launchers run on the session surface; any deprecation-shim
# call escaping from them fails the example
env = dict(os.environ, PYTHONPATH=SRC, FLOR_STRICT_DEPRECATIONS="1")
shutil.rmtree(args.run_dir, ignore_errors=True)
model = ["--arch", "florbench-100m", "--smoke", "--device", args.device,
         "--batch", "2", "--seq", "32", "--epochs", str(args.epochs),
         "--steps-per-epoch", str(args.steps_per_epoch)]

print("== record ==", flush=True)
t0 = time.time()
subprocess.run([sys.executable, "-m", "repro_torch.launch.train", *model,
                "--run-dir", args.run_dir, "--no-adaptive"],
               env=env, check=True)
print(f"record wall {time.time() - t0:.1f}s")

# the hindsight edit: add a probe line inside the train loop of the SAME
# script that recorded (here: the train launcher), exactly what a user does
# when training looked wrong and they wish they had logged more
try:
    train_py = importlib.util.find_spec("repro_torch.launch.train").origin
except (ImportError, AttributeError):
    sys.path.insert(0, SRC)
    train_py = importlib.util.find_spec("repro_torch.launch.train").origin
src_lines = open(train_py).read().splitlines(keepends=True)
anchor = next(i for i, ln in enumerate(src_lines)
              if "ckpt.state, m = ts(ckpt.state, b)" in ln)
indent = src_lines[anchor][: len(src_lines[anchor])
                           - len(src_lines[anchor].lstrip())]
probe = indent + 'flor.log("probe_grad_norm", m["grad_norm"])\n'
edited = os.path.join(args.run_dir, "train_probed.py")
with open(edited, "w") as f:
    f.writelines(src_lines[: anchor + 1] + [probe]
                 + src_lines[anchor + 1:])
print(f"== hindsight edit: probe inserted after line {anchor + 1} "
      f"-> {edited} ==")

print(f"== planned replay: --probe auto, {args.nworkers} workers ==",
      flush=True)
t0 = time.time()
subprocess.run([sys.executable, "-m", "repro_torch.launch.replay",
                "--run-dir", args.run_dir, *model,
                "--nworkers", str(args.nworkers), "--probe", "auto",
                "--current-src", edited, "--init-mode", args.init_mode,
                "--check"],
               env=env, check=True)
print(f"replay wall {time.time() - t0:.1f}s "
      f"(workers are processes sharing the device)")
