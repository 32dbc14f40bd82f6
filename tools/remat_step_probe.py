#!/usr/bin/env python3
"""Time one train step under each per-layer remat setting on one card.

    python3 tools/remat_step_probe.py [--batch 8] [--seq 512] [--layers 12]
                                      [--steps 5] [--pairs 2]

Run from a checkout on a machine with one NVIDIA H100. florbench-100m at
full width, cut to ``--layers``, one state and one batch from chip_smoke's
seed; for remat off, "nothing" and "dots", in turns (``--pairs`` times:
off, nothing, dots, dots, nothing, off, ...): two warm steps, then
``--steps`` timed ones (median wall), then one under ``torch.profiler``
(the card's busy ms and device activities, from chip_smoke's
``device_profile``). A small step is host-bound: the wall against the busy
ms says how much of the recompute the host adds. Prints one line per turn
and setting, the medians over the turns, and the card's name and power
limit. Exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SETTINGS = {"off": {"remat": False}, "nothing": {},
            "dots": {"remat_policy": "dots"}}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--layers", type=int, default=12)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--pairs", type=int, default=2)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        sys.exit("remat_step_probe: no card (torch.cuda.is_available() is "
                 "False)")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(1, ROOT)
    import chip_smoke as cs
    import repro_torch.configs as C
    from repro_torch.data import synthetic_batch
    from repro_torch.train.step import batch_to_device, build_train_step

    dev = torch.device("cuda", 0)
    base = C.with_layers(C.get("florbench-100m"), args.layers)
    init_state, _ = build_train_step(base, device=dev)
    state = init_state(cs.SEED)
    batch = batch_to_device(synthetic_batch(base, args.batch, args.seq, 0,
                                            cs.SEED), dev)
    steps = {name: build_train_step(base.replace(**over), device=dev)[1]
             for name, over in SETTINGS.items()}
    order = list(SETTINGS)
    got: dict = {name: [] for name in order}
    for turn in range(2 * args.pairs):
        for name in (order if turn % 2 == 0 else order[::-1]):
            step = steps[name]
            for _ in range(2):
                step(state, batch)
            torch.cuda.synchronize(dev)
            walls = []
            for _ in range(args.steps):
                t0 = time.perf_counter()
                step(state, batch)
                torch.cuda.synchronize(dev)
                walls.append((time.perf_counter() - t0) * 1e3)
            wall = statistics.median(walls)
            _, busy, n, _ = cs.device_profile(torch,
                                              lambda: step(state, batch))
            got[name].append((wall, busy, n))
            print(f"turn {turn} {name}: wall {wall:.2f} ms (median of "
                  f"{args.steps}), device busy {busy:.2f} ms "
                  f"({busy / wall:.0%}), {n} device activities", flush=True)
    for name in order:
        w, b, n = (statistics.median(x[i] for x in got[name])
                   for i in range(3))
        print(f"{name}: florbench-100m {args.layers} layers, "
              f"{args.batch}x{args.seq} tokens: wall {w:.2f} ms, device busy "
              f"{b:.2f} ms, {n:.0f} device activities (medians of "
              f"{len(got[name])} turns)")
    print(cs.smi_line())


if __name__ == "__main__":
    main()
