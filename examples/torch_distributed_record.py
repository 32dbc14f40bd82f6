"""Multi-process mesh record, crash injection and recovery, end to end, in
the PyTorch port.

    PYTHONPATH=src python examples/torch_distributed_record.py \
        --run-dir /tmp/pt_dist [--device cpu]

The script is its own fleet launcher: it re-execs itself four times with
``--child <rank>`` so four processes join a gloo group over a loopback
coordinator, one per position of a (2, 2) ``DeviceMesh`` (a DeviceMesh has
one process per position; on the card they share it). Each process records
through the full Session path:

* its state is placed on the mesh as DTensors (``repro_torch.parallel.
  place``: its own slices, no collective), and it fingerprints and gathers
  ONLY the checkpoint shards it owns and publishes its member manifests
  crash-safely;
* the lead gathers every process's publication through the file rendezvous
  under ``<store>/runs/<run>/.stitch/`` and writes the v4 stitch atomically.

Round 1 proves the happy path: every epoch stitches, and the state restores
bit-identically unsharded. Round 2 proves the crash-safety argument:
``FLOR_DIST_CRASH_BEFORE_PUBLISH`` kills process 1 in the exact window
between durable member manifests and its rendezvous marker. The store is
never corrupted — the lead marks the checkpoint incomplete, the run
finalizes at the last COMPLETE checkpoint, the replay planner skips the
torn key, and GC reclaims the orphan members.

Runs on the card by default; ``--device cpu`` runs it on the CPU.
"""
import argparse
import os
import shutil
import socket
import subprocess
import sys

EPOCHS = 3
CRASH_KEY = "train@2.0"
MESH = (2, 2)
SPECS = {"w": ("data", "model"), "b": ("model",)}


def host_state(epoch):
    import numpy as np
    rng = np.random.default_rng(7)
    w = (rng.normal(size=(64, 32)).astype(np.float32)
         * (1.0 + 0.001 * epoch))
    b = np.arange(32, dtype=np.float32) * (2.0 + 0.001 * epoch)
    return {"w": w, "b": b}


# ------------------------------------------------------------------ child --
def child(run_dir: str, port: int, rank: int, device: str):
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    import repro_torch.flor as flor
    from repro_torch.parallel import place
    from repro_torch.parallel.rendezvous import (StitchRendezvous,
                                                 init_distributed)

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    group = init_distributed(f"127.0.0.1:{port}", rank, MESH[0] * MESH[1])
    try:
        mesh = DeviceMesh(dev.type, torch.arange(group.num_processes)
                          .reshape(MESH), mesh_dim_names=("data", "model"))

        def tree(epoch):
            return {k: place(torch.from_numpy(v).to(dev), mesh, SPECS[k])
                    for k, v in host_state(epoch).items()}

        timeout = float(os.environ.get("T_STITCH", "30"))
        with flor.Session(run_dir, mode="record", record=flor.RecordSpec(
                adaptive=False, mesh=mesh, distributed=group,
                stitch_timeout_s=timeout)) as s:
            with s.checkpointing(state=tree(0)) as ckpt:
                for epoch in s.loop("epochs", range(EPOCHS)):
                    for _ in s.loop("train", range(2)):
                        pass
                    ckpt.state = tree(epoch + 1)
                    flor.log("epoch", epoch)
        # exit barrier: process 0 hosts the coordinator, so it leaves last
        rdv = StitchRendezvous(os.path.join(run_dir, "store"),
                               "dist-" + os.path.basename(run_dir.rstrip("/")),
                               group, timeout_s=timeout)
        rdv.arrive("exit")
        if group.is_lead:
            rdv.await_all("exit")
        rdv.close()
        print(f"child {rank}: record complete", flush=True)
    finally:
        dist.destroy_process_group()


# ----------------------------------------------------------- fleet driver --
def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_fleet(run_dir: str, device: str, env_extra=None) -> list:
    if os.path.isdir(run_dir):
        shutil.rmtree(run_dir)
    env = dict(os.environ)
    env.pop("LOCAL_RANK", None)      # DeviceMesh would pick cuda:<LOCAL_RANK>
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    env["PYTHONPATH"] = os.pathsep.join(
        [src, env.get("PYTHONPATH", "")]).rstrip(os.pathsep)
    env.update(env_extra or {})
    port = free_port()
    procs = [subprocess.Popen(
                 [sys.executable, os.path.abspath(__file__),
                  "--child", str(r), "--port", str(port),
                  "--run-dir", run_dir, "--device", device], env=env)
             for r in range(MESH[0] * MESH[1])]
    return [p.wait() for p in procs]


def restored_equal(store, key: str, epoch: int, device) -> bool:
    import numpy as np
    import torch
    truth = host_state(epoch)
    like = {"state": {k: torch.empty(0, device=device) for k in truth}}
    got = store.get_tree(key, like=like)["state"]
    return all(got[k].device == torch.device(device)
               and np.array_equal(got[k].cpu().numpy(), truth[k])
               for k in truth)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--run-dir", default="/tmp/pt_dist")
    ap.add_argument("--device", default="cuda",
                    help="torch device of every process (default cuda; "
                         "'cpu' runs the kernels' plain versions)")
    ap.add_argument("--child", type=int, default=None)
    ap.add_argument("--port", type=int, default=0)
    args = ap.parse_args()
    if args.child is not None:
        child(args.run_dir, args.port, args.child, args.device)
        return
    import torch
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        sys.exit(f"--device {args.device}: torch.cuda.is_available() is "
                 f"False (pass --device cpu to run on the CPU)")
    device = torch.device(args.device)

    from repro_torch.checkpoint import CheckpointStore
    from repro_torch.checkpoint.lineage import RunRegistry
    from repro_torch.replay.plan import build_plan

    # ---- round 1: clean 4-process record --------------------------------
    run = args.run_dir
    run_id = "dist-" + os.path.basename(run.rstrip("/"))
    print("== round 1: 4-process record over a (2, 2) mesh ==")
    rcs = run_fleet(run, args.device)
    assert rcs == [0] * 4, f"fleet failed: exit codes {rcs}"

    store = CheckpointStore(os.path.join(run, "store"))
    for e in range(EPOCHS):
        m = store.get_manifest(f"train@{e}.0")
        assert m["version"] == 4 and len(m["members"]) == 4
    print(f"  {EPOCHS} checkpoints stitched, 4 member shards each")
    # train@2.0 = the state ENTERING epoch 2
    assert restored_equal(store, "train@2.0", 2, device)
    print(f"  unsharded restore onto {device}: bit-identical")
    rec = {r["run_id"]: r
           for r in RunRegistry(os.path.join(run, "store")).list_runs()}
    assert rec[run_id]["status"] == "finished"
    assert rec[run_id]["final_keys"] == {"train": f"train@{EPOCHS - 1}.0"}
    print(f"  registry: finished at train@{EPOCHS - 1}.0")

    # ---- round 2: crash between publication and stitch ------------------
    crun = run.rstrip("/") + "_crash"
    print("== round 2: kill process 1 before it publishes", CRASH_KEY, "==")
    rcs = run_fleet(crun, args.device, env_extra={
        "T_STITCH": "6",
        "FLOR_DIST_CRASH_BEFORE_PUBLISH": CRASH_KEY,
        "FLOR_DIST_CRASH_PROCESS": "1",
    })
    assert rcs[1] == 43 and rcs[:1] + rcs[2:] == [0, 0, 0], \
        f"unexpected exit codes {rcs}"
    print(f"  exit codes {rcs}: survivors finished, victim crashed")

    cstore = CheckpointStore(os.path.join(crun, "store"))
    ckeys = set(cstore.list_keys())
    assert "train_at_2.0" not in ckeys            # no torn v4, ever
    orphans = [k for k in ckeys if k.startswith("train_at_2.0.shard")]
    assert orphans and cstore.get_meta("incomplete_ckpts") == \
        {"keys": [CRASH_KEY]}
    print(f"  no v4 for {CRASH_KEY}; {len(orphans)} orphan member(s); "
          f"checkpoint marked incomplete")

    creg = RunRegistry(os.path.join(crun, "store"))
    crec = {r["run_id"]: r for r in creg.list_runs()}[run_id + "_crash"]
    assert crec["final_keys"] == {"train": "train@1.0"}
    assert build_plan(crun).incomplete == ["train_at_2.0"]
    assert restored_equal(cstore, "train@1.0", 1, device)
    print("  run finalized at train@1.0; replay plan skips the torn key; "
          "last complete checkpoint restores bit-identically")

    res = creg.gc(cstore)
    assert res["deleted_manifests"] == len(orphans)
    assert restored_equal(cstore, "train@1.0", 1, device)
    print(f"  gc reclaimed {res['deleted_manifests']} orphan manifest(s) + "
          f"{res['deleted_chunks']} chunk(s); restore still intact")
    print("DISTRIBUTED_RECORD_OK")


if __name__ == "__main__":
    main()
