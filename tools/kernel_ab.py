#!/usr/bin/env python3
"""Time the port's kernels of two checkouts on one card, in turns.

    python3 tools/kernel_ab.py OTHER_CHECKOUT [--pairs 2]

Run from a checkout on a machine with one NVIDIA H100. OTHER_CHECKOUT is
the root of another checkout, for example the parent commit unpacked with
``git archive`` into a git-ignored directory. The turns run other, this,
this, other (``--pairs`` times), each in a fresh process that imports that
checkout's ``src/repro_torch`` and times, with this checkout's
``chip_smoke.time_calls`` (card time from the profiler), at chip_smoke's
shapes and seed:

- the q8 and q4 gathers over the 10 ``mu`` leaves of the florbench-100m
  TrainState, every row changed (one checkpoint's pass);
- flash attention on every case of ``chip_smoke.FLASH_CASES`` in f32, bf16
  and f16.

Prints one ``TURN {json}`` line per turn, then for each timing the two
checkouts' medians and ranges, and the card's name and power limit. Exits
non-zero without a card or when a turn fails.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def turn(checkout: str) -> dict:
    """Timings of one checkout's kernels, in this process."""
    src = os.path.join(os.path.abspath(checkout), "src")
    sys.path.insert(0, src)
    sys.path.insert(1, ROOT)
    import torch

    import chip_smoke as cs
    import repro_torch
    import repro_torch.configs as C
    from repro_torch.checkpoint.pipeline import PIPELINE_CHUNK_WORDS as CW
    from repro_torch.kernels import ops

    if not list(repro_torch.__path__)[0].startswith(src):
        raise RuntimeError(f"imported {repro_torch.__path__}, not {src}")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    state = cs.state_leaves(torch, C.get("florbench-100m"), gen, dev)
    slot = [x for p, x in state if p.startswith(".mu")]
    idxs = [torch.arange(-(-x.numel() // CW), device=dev, dtype=torch.int32)
            for x in slot]
    out = {}
    for name, kern in (("gather_quantize", ops.gather_quantize_blocks),
                       ("gather_quantize4", ops.gather_quantize4_blocks)):
        out[name] = cs.time_calls(
            torch, [lambda x=x, i=i, k=kern: k(x, i, CW)
                    for x, i in zip(slot, idxs)])["ms"]
    del state, slot
    for case, B, H, KV, Sq, Sk, d, causal in cs.FLASH_CASES:
        for dt in ("float32", "bfloat16", "float16"):
            dtype = getattr(torch, dt)
            q = torch.randn(B, H, Sq, d, generator=gen, device=dev).to(dtype)
            k = torch.randn(B, KV, Sk, d, generator=gen, device=dev).to(dtype)
            v = torch.randn(B, KV, Sk, d, generator=gen, device=dev).to(dtype)
            out[f"flash_attention {case} {dt}"] = cs.time_calls(
                torch, [lambda: ops.flash_attention(q, k, v, causal=causal)]
            )["ms"]
    return out


def main():
    if len(sys.argv) > 2 and sys.argv[1] == "--turn":
        print("TURN " + json.dumps(turn(sys.argv[2])), flush=True)
        return
    if len(sys.argv) < 2:
        sys.exit(__doc__)
    import torch
    if not torch.cuda.is_available():
        sys.exit("kernel_ab: torch.cuda.is_available() is False: needs a GPU")
    other = os.path.abspath(sys.argv[1])
    pairs = int(sys.argv[sys.argv.index("--pairs") + 1]) \
        if "--pairs" in sys.argv else 2
    if not os.path.isdir(os.path.join(other, "src", "repro_torch")):
        sys.exit(f"no src/repro_torch under {other}")
    order = [("other", other), ("this", ROOT), ("this", ROOT),
             ("other", other)] * pairs
    runs: dict = {"other": [], "this": []}
    for tag, checkout in order:
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--turn", checkout], capture_output=True,
                           text=True, timeout=900)
        line = next((x for x in r.stdout.splitlines()
                     if x.startswith("TURN ")), None)
        if r.returncode != 0 or line is None:
            sys.exit(f"turn {tag} ({checkout}) failed, exit "
                     f"{r.returncode}:\n{r.stderr[-3000:]}")
        print(f"TURN {tag} {line[5:]}", flush=True)
        runs[tag].append(json.loads(line[5:]))
    print(f"{'ms on the card':48s} {'other: median [min, max]':>30s} "
          f"{'this: median [min, max]':>30s}")
    for key in runs["this"][0]:
        cells = []
        for tag in ("other", "this"):
            v = [r[key] for r in runs[tag]]
            cells.append(f"{statistics.median(v):.4f} [{min(v):.4f}, "
                         f"{max(v):.4f}]")
        print(f"{key:48s} {cells[0]:>30s} {cells[1]:>30s}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip())


if __name__ == "__main__":
    main()
