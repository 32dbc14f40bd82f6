#!/usr/bin/env python3
"""Which collectives gloo runs on CUDA tensors, each asked in a fleet of its
own (a refused one may abort its processes).

    python3 tools/gloo_cuda_probe.py [--device cuda|cpu]

Run from a checkout on a machine with a card. For each collective of
``src/repro_torch/parallel/collectives.py`` it starts four processes that
share the card in one gloo group on a loopback coordinator, lay a (2, 2)
("data", "model") mesh over them, and hand gloo that collective on device
tensors of 1 MiB directly (``collectives.probe(direct=True)``: the
``STAGED`` table ignored), then compare the result with the same
collective on CPU copies, bit for bit on integer-valued f32. Prints one
line per collective: the four exit codes, the probe's rows and the first
error lines. ``collectives.STAGED`` stages the ones that fail here through
pinned host buffers.
"""
from __future__ import annotations

import json
import os
import socket
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPS = ("all_gather", "psum", "psum_scatter", "ppermute", "pmax")


def child(rank: int, port: int, device: str, op: str):
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.parallel import collectives as col
    from repro_torch.parallel.sharding import use_mesh

    if device == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=4)
    try:
        mesh = DeviceMesh(device, torch.arange(4).reshape(2, 2),
                          mesh_dim_names=("data", "model"))
        with use_mesh(mesh):
            rows = col.probe(torch.device(device), sizes=(1 << 20,),
                             reps=1, ops=(op,), direct=True)
        if rank == 0:
            for r in rows:
                print(json.dumps(r), flush=True)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def main():
    if sys.argv[1:2] == ["--child"]:
        rank, port, device, op = sys.argv[2:6]
        child(int(rank), int(port), device, op)
        return
    device = "cuda"
    if "--device" in sys.argv:
        device = sys.argv[sys.argv.index("--device") + 1]
    fleets = {}
    for op in OPS:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        fleets[op] = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--child", str(r),
             str(port), device, op], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(4)]
    for op, procs in fleets.items():
        outs = []
        for p in procs:
            try:
                text, _ = p.communicate(timeout=120)
            except subprocess.TimeoutExpired:
                p.kill()
                text = p.communicate()[0] + "\n[timeout]"
            outs.append((p.returncode, text))
        rows = [line for line in outs[0][1].splitlines()
                if line.startswith("{")]
        errors = [line.strip() for _, text in outs
                  for line in text.splitlines()
                  if "Error" in line or "what()" in line
                  or "timeout" in line][:3]
        print(f"{op}: exit codes {[rc for rc, _ in outs]}; {rows}; "
              f"{errors}", flush=True)


if __name__ == "__main__":
    main()
