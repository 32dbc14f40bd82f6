"""Mesh-sharded record -> RESHARDED hindsight replay, end to end, in the
PyTorch port.

    PYTHONPATH=src python examples/torch_sharded_replay.py \
        --run-dir /tmp/pt_sharded [--device cpu]

Scenario: a training run recorded on a (2, 2) ``DeviceMesh`` — four
processes, one per position, each fingerprinting and gathering ONLY the
checkpoint shards it owns (no gather of the state; bytes never leave their
process), each store shard keeping a delta chain of its local bytes. Later
you want per-step values you never logged, but the original mesh is gone:
replay runs on a (1, 4) mesh, a (4, 1) mesh (four processes each) and a
plain unsharded session. A restore reads only the chunks each process's
target shard needs and re-resolves the recorded specs through the
logical-axis rules, so every replay restores bit-identically.

The script is its own fleet launcher (``--child`` processes over a gloo
group on a loopback coordinator; on the card they share it). Each process
computes the replicated state and hands the checkpoint scope its slices on
the mesh (``repro_torch.parallel.place``). The update is ELEMENT-WISE, so
every layout holds the same bytes; each epoch logs a blake2 digest of the
state. The resharded replays restore every epoch and check each process's
shards against its own slices of the state; the unsharded replay re-executes
with a per-step probe, and the deferred check compares its digests with the
record's.

Runs on the card by default; ``--device cpu`` runs it on the CPU.
"""
import argparse
import json
import os
import shutil
import socket
import subprocess
import sys

SPECS = {"w": ("data", "model"), "b": ("model",), "scale": ()}
EPOCHS, STEPS = 4, 4
RECORD_MESH = (2, 2)
REPLAY_MESHES = ((1, 4), (4, 1))


def init_state(torch, dev):
    return {"w": torch.arange(64 * 128, dtype=torch.float32,
                              device=dev).reshape(64, 128),
            "b": torch.linspace(-1.0, 1.0, 128, device=dev),
            "scale": torch.tensor(1.0, device=dev)}


def step_fn(state, delta: float):
    # element-wise only: identical bytes under ANY layout of the mesh
    return {"w": state["w"] * 0.999 + delta,
            "b": state["b"] * 0.999 - delta,
            "scale": state["scale"] * 0.9999}


def digest(state) -> str:
    import hashlib
    h = hashlib.blake2b(digest_size=16)
    for k in sorted(state):
        h.update(state[k].detach().cpu().numpy().tobytes())
    return h.hexdigest()


def train(flor, state, ckpt, placed, probed=False):
    """The recorded loop; ``placed`` lays the state out for the scope."""
    epochs = flor.arg("epochs", EPOCHS)
    steps = flor.arg("steps_per_epoch", STEPS)
    digests = []
    for epoch in flor.loop("epochs", range(epochs)):
        for s in flor.loop("train", range(steps)):
            state = step_fn(state, 0.001 * (epoch * steps + s + 1))
            ckpt.state = placed(state)
            if probed:
                # the hindsight probe: per-step state digest
                flor.log("step_digest", digest(state))
        d = digest(state)
        digests.append(d)
        flor.log("digest", d)
    return digests


# ------------------------------------------------------------------ child --
def child(args):
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    import repro_torch.flor as flor
    from repro_torch.parallel import place
    from repro_torch.parallel.rendezvous import init_distributed
    from repro_torch.parallel.sharding import local_box

    dev = torch.device(args.device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    shape = tuple(int(x) for x in args.mesh.split("x"))
    group = init_distributed(f"127.0.0.1:{args.port}", args.child,
                             shape[0] * shape[1])
    try:
        mesh = DeviceMesh(dev.type, torch.arange(group.num_processes)
                          .reshape(shape), mesh_dim_names=("data", "model"))

        def placed(state):
            return {k: place(v, mesh, SPECS[k]) for k, v in state.items()}

        state = init_state(torch, dev)
        if args.role == "record":
            with flor.Session(args.run_dir, mode="record",
                              record=flor.RecordSpec(adaptive=False,
                                                     mesh=mesh,
                                                     distributed=group)):
                with flor.checkpointing(state=placed(state)) as ckpt:
                    train(flor, state, ckpt, placed)
            dist.barrier()
            return
        # resharded restore-only replay: every epoch restores into this
        # process's shards of the new layout; check them against its own
        # slices of the replicated state
        checked = 0
        visits = [(e, "exec") for e in range(EPOCHS)]
        with flor.Session(args.run_dir, mode="replay", replay=flor.ReplaySpec(
                pid=100 + group.process_id, segments=visits)):
            steps = flor.arg("steps_per_epoch", STEPS)
            with flor.checkpointing(state=placed(state)) as ckpt:
                for epoch in flor.loop("epochs",
                                       range(flor.arg("epochs", EPOCHS))):
                    for _ in flor.loop("train", range(steps)):
                        raise RuntimeError("a restore-only replay "
                                           "re-executed a step")
                    for s in range(steps):
                        state = step_fn(state, 0.001 * (epoch * steps
                                                        + s + 1))
                    for k, x in ckpt.state.items():
                        box = local_box(x.shape, mesh, x.placements)
                        want = state[k][tuple(slice(lo, hi)
                                              for lo, hi in box)]
                        if not torch.equal(x.to_local(), want):
                            raise RuntimeError(f"epoch {epoch} {k} shard "
                                               f"{box} differs")
                        checked += 1
        print(json.dumps({"rank": group.process_id, "shards": checked}),
              flush=True)
        dist.barrier()
    finally:
        dist.destroy_process_group()


# ----------------------------------------------------------- fleet driver --
def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def fleet(args, role: str, shape) -> None:
    env = dict(os.environ)
    env.pop("LOCAL_RANK", None)      # DeviceMesh would pick cuda:<LOCAL_RANK>
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    env["PYTHONPATH"] = os.pathsep.join(
        [src, env.get("PYTHONPATH", "")]).rstrip(os.pathsep)
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--child", str(r),
         "--role", role, "--mesh", f"{shape[0]}x{shape[1]}", "--port",
         str(port), "--run-dir", args.run_dir, "--device", args.device],
        env=env) for r in range(shape[0] * shape[1])]
    rcs = [p.wait() for p in procs]
    if any(rcs):
        sys.exit(f"FAIL: {role} fleet on {shape} exited {rcs}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--run-dir", default="/tmp/pt_sharded")
    ap.add_argument("--device", default="cuda",
                    help="torch device of every process (default cuda; "
                         "'cpu' runs the kernels' plain versions)")
    ap.add_argument("--child", type=int, default=None)
    ap.add_argument("--role", default="record")
    ap.add_argument("--mesh", default="2x2")
    ap.add_argument("--port", type=int, default=0)
    args = ap.parse_args()
    if args.child is not None:
        child(args)
        return
    import torch
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        sys.exit(f"--device {args.device}: torch.cuda.is_available() is "
                 f"False (pass --device cpu to run on the CPU)")
    import repro_torch.flor as flor
    from repro_torch.logging import remove_stream

    if os.path.isdir(args.run_dir):
        shutil.rmtree(args.run_dir)
    # ---- record on a (2, 2) mesh: per-shard delta checkpoints ----
    fleet(args, "record", RECORD_MESH)
    from repro_torch.checkpoint import CheckpointStore
    store = CheckpointStore(os.path.join(args.run_dir, "store"))
    for e in range(EPOCHS):
        m = store.get_manifest(f"train@{e}.0")
        if m.get("version") != 4 or len(m["members"]) != 4:
            sys.exit(f"FAIL: epoch {e} has no stitched v4 with 4 members")
    print(f"record {RECORD_MESH}: 4 processes, every epoch stitched (v4 + "
          f"4 members)")
    # ---- resharded restores on meshes the record run never saw ----
    for shape in REPLAY_MESHES:
        fleet(args, "replay", shape)
        print(f"replay {shape} restore-only: every process's shards "
              f"bit-identical to its slices, every epoch")
    # their logs hold no rows: drop them so the deferred check reads the
    # probed replay below
    for r in range(4):
        remove_stream(os.path.join(args.run_dir, "logs",
                                   f"replay_p{100 + r}.jsonl"))
    # ---- unsharded replay with a per-step probe, on this process ----
    dev = torch.device(args.device)
    with flor.Session(args.run_dir, mode="replay",
                      replay=flor.ReplaySpec(probed={"train"})):
        state = init_state(torch, dev)
        with flor.checkpointing(state=state) as ckpt:
            digests = train(flor, state, ckpt, lambda s: s, probed=True)
    print(f"replay unsharded, inner probe: {len(digests)} epochs, final "
          f"digest {digests[-1]}")
    rec, reps = flor.run_logs(args.run_dir)
    res = flor.deferred_check(rec, reps)
    print(f"deferred check: ok={res.ok} compared={res.compared} "
          f"hindsight={res.hindsight_only}")
    if not res.ok:
        for a in res.anomalies[:5]:
            print("  anomaly:", a)
        sys.exit(1)
    print("OK: bit-identical restores of a (2, 2) record on (1, 4), "
          "(4, 1) and unsharded")


if __name__ == "__main__":
    main()
