"""Training launcher with Flor record integrated as a first-class feature.

    PYTHONPATH=src python -m repro_torch.launch.train --arch florbench-100m \
        --epochs 4 --steps-per-epoch 8 --run-dir /tmp/run1

Runs on the card (``--device cuda``, the default; it fails when there is no
card) unless ``--device cpu`` is given. ``--smoke`` picks the reduced
same-family config; ``--layers N`` cuts a config's depth, not its widths.

Fault tolerance IS the paper's substrate: on start, if the run dir already
holds checkpoints, training resumes from the latest epoch checkpoint. Kill
the process mid-run and relaunch with the same command to see it.

Run lineage (continuous training): record several runs into one shared
store and chain them —

    ... train --run-dir /tmp/base --store-root /tmp/store --run-id base
    ... train --run-dir /tmp/ft1  --store-root /tmp/store --run-id ft1 \
        --parent-run base          # warm-starts; 1st ckpt is a cross-run delta

The warm start restores the ancestor's final checkpoint onto the card and
seeds the delta pipeline there. Inspect, query and reclaim with
``python -m repro_torch.launch.runs list|show|diff|logs|pivot|gc|rm``.

Fleet record: ``--mesh AxB --num-processes A*B``, one process per mesh
position (a torch ``DeviceMesh`` has one process per position), each
started with its own ``--process-id`` and the same ``--coordinator``
(``host:port`` of process 0's gloo rendezvous; the processes may share one
card). Every process trains the same replicated state; the record runs
sharded over the mesh (``RecordSpec(mesh=, distributed=)``): each process
checkpoints only the shards it owns and process 0 stitches the v4
manifests. The launcher places the state on no layout of its own, as the
reference launcher does, so its replicated leaves are filed by process 0. A
relaunch resumes from the last stitched epoch.
"""
from __future__ import annotations

import argparse
import time


def main(argv=None):
    """Parse ``argv`` (default: the command line), record the run, and
    return {"state": final TrainState, "run_dir", "store", "ckpt_stats":
    the pipeline's per-checkpoint stats, "warmstart": the warm start's
    stats per block (empty without ``--parent-run``)} for callers that
    drive the launcher in-process."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="florbench-100m")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the config to this many layers at its "
                         "widths (a large model on one card)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the "
                         "kernels' plain versions)")
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--steps-per-epoch", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--run-dir", required=True)
    ap.add_argument("--epsilon", type=float, default=1.0 / 15)
    ap.add_argument("--no-adaptive", action="store_true")
    ap.add_argument("--no-flor", action="store_true",
                    help="vanilla baseline (no record) for overhead benchs")
    ap.add_argument("--sync-log", action="store_true",
                    help="synchronous flor.log (serialize + write on the "
                         "step path) instead of the background log stage")
    ap.add_argument("--log-spill-bytes", type=int, default=1 << 20,
                    help="spill logged arrays larger than this many host "
                         "bytes to the checkpoint store, logging a ref row "
                         "(0 disables)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh", default=None,
                    help="AxB: a (data, model) DeviceMesh of A*B positions, "
                         "one process each (needs --num-processes A*B)")
    ap.add_argument("--coordinator", default="127.0.0.1:12355",
                    help="host:port of process 0's gloo rendezvous for a "
                         "fleet record")
    ap.add_argument("--process-id", type=int, default=0,
                    help="this process's id in the record fleet")
    ap.add_argument("--num-processes", type=int, default=1,
                    help="record fleet size; > 1 turns on the fleet record: "
                         "each process checkpoints only its own shards, "
                         "process 0 stitches the v4 manifests")
    ap.add_argument("--stitch-timeout", type=float, default=30.0,
                    help="seconds the stitch rendezvous waits for every "
                         "process before marking a checkpoint incomplete")
    ap.add_argument("--ckpt-shard-axes", default="",
                    help="comma-separated mesh axes mapping onto store "
                         "shards (default: all axes — one shard per "
                         "position)")
    ap.add_argument("--store-root", default=None,
                    help="SHARED checkpoint store root (multi-run lineage); "
                         "default: private <run-dir>/store")
    ap.add_argument("--run-id", default=None,
                    help="explicit run id in the shared store")
    ap.add_argument("--parent-run", default=None,
                    help="ancestor run id: warm-start from its final "
                         "checkpoint and record cross-run deltas")
    args = ap.parse_args(argv)
    mesh_shape = None
    if args.mesh:
        mesh_shape = tuple(int(x) for x in args.mesh.split("x"))
        if len(mesh_shape) != 2:
            ap.error(f"--mesh {args.mesh}: expected AxB (data x model)")
        if mesh_shape[0] * mesh_shape[1] != args.num_processes:
            ap.error(f"--mesh {args.mesh} needs --num-processes "
                     f"{mesh_shape[0] * mesh_shape[1]}: a DeviceMesh has "
                     f"one process per position (got --num-processes "
                     f"{args.num_processes})")
    elif args.num_processes > 1:
        ap.error("--num-processes > 1 requires --mesh (the DeviceMesh "
                 "spanning every process)")

    import torch

    import repro_torch.configs as C
    from repro_torch.train.step import build_train_step

    cfg = C.get_smoke(args.arch) if args.smoke else C.get(args.arch)
    if args.layers:
        cfg = C.with_layers(cfg, args.layers)
    init_state, ts = build_train_step(cfg, device=args.device)
    state = init_state(args.seed)
    if mesh_shape is None:
        return _record(args, cfg, state, ts, None, None)
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.parallel.rendezvous import init_distributed
    group = init_distributed(args.coordinator, args.process_id,
                             args.num_processes)
    try:
        mesh = DeviceMesh(torch.device(args.device).type,
                          torch.arange(args.num_processes).reshape(
                              mesh_shape),
                          mesh_dim_names=("data", "model"))
        print(f"distributed record: process {group.process_id}/"
              f"{group.num_processes} on mesh {args.mesh}", flush=True)
        out = _record(args, cfg, state, ts, mesh, group)
        dist.barrier()
        return out
    finally:
        dist.destroy_process_group()


def _record(args, cfg, state, ts, mesh, group) -> dict:
    """The record (or, with ``--no-flor``, the vanilla run) from ``state``;
    ``mesh`` and ``group`` are None outside a fleet."""
    import torch

    import repro_torch.flor as flor
    from repro_torch.checkpoint.store import _safe
    from repro_torch.data import synthetic_batch

    if args.no_flor:
        t0 = time.time()
        for epoch in range(args.epochs):
            for s in range(args.steps_per_epoch):
                b = synthetic_batch(cfg, args.batch, args.seq,
                                    epoch * args.steps_per_epoch + s,
                                    args.seed)
                state, m = ts(state, b)
            print(f"epoch {epoch} loss {float(m['loss']):.4f}", flush=True)
        print(f"vanilla wall {time.time() - t0:.2f}s")
        return {"state": state, "run_dir": args.run_dir, "store": None,
                "ckpt_stats": [], "warmstart": {}}

    with flor.Session(
            args.run_dir, mode="record",
            record=flor.RecordSpec(
                epsilon=args.epsilon, adaptive=not args.no_adaptive,
                async_log=not args.sync_log,
                log_spill_bytes=args.log_spill_bytes, mesh=mesh,
                ckpt_shard_axes=tuple(a for a in
                                      args.ckpt_shard_axes.split(",") if a)
                if mesh is not None else (),
                distributed=group or False,
                stitch_timeout_s=args.stitch_timeout),
            lineage=flor.LineageSpec(store_root=args.store_root,
                                     run_id=args.run_id,
                                     parent_run=args.parent_run)) as sess:
        ctx = sess.ctx
        if ctx.parent_run and not ctx.store.list_keys():
            # derived run (fine-tune of a fine-tune): start from the
            # ancestor's final state; the first checkpoint is already a
            # cross-run delta against it
            print(f"warm start from run {ctx.parent_run!r}", flush=True)
            state = sess.warm_start("train", like=state)
        # crash-restart: resume from the latest epoch checkpoint if any.
        # Shard MEMBER manifests (<key>.shard<h>) and checkpoints a fleet
        # record marked incomplete never anchor a resume — only stitched
        # (or flat) epoch keys count as done.
        inc = {_safe(k) for k in
               (ctx.store.get_meta("incomplete_ckpts") or {})
               .get("keys") or ()}
        done = set()
        for k in ctx.store.list_keys():
            if "_at_" in k and ".shard" not in k and k not in inc:
                try:
                    done.add(int(k.split("_at_")[1].split(".")[0]))
                except ValueError:
                    pass
        resume_from = max(done) + 1 if done else 0
        if resume_from:
            # physical restore of the latest Loop End Checkpoint, then
            # skip the completed epochs — restart == weak-init replay
            print(f"resuming: restoring epoch {max(done)} checkpoint",
                  flush=True)
            state = ctx.store.get_tree(f"train@{max(done)}.0", like=state)

        t0 = time.time()
        steps = sess.arg("steps_per_epoch", args.steps_per_epoch)
        with sess.checkpointing(state=state) as ckpt:
            for epoch in sess.loop("epochs",
                                   range(sess.arg("epochs", args.epochs))):
                if epoch < resume_from:
                    continue
                for s in sess.loop("train", range(steps)):
                    b = synthetic_batch(cfg, args.batch, args.seq,
                                        epoch * steps + s, args.seed)
                    ckpt.state, m = ts(ckpt.state, b)
                flor.log("loss", m["loss"])
                print(f"epoch {epoch} done", flush=True)
        state = ckpt.state
        store = ctx.store
        ctx.pipeline.drain()
        ckpt_stats = ctx.pipeline.stats
        warmstart = dict(ctx.warmstart_stats)
    if state.step.is_cuda:
        torch.cuda.synchronize(state.step.device)
    print(f"record wall {time.time() - t0:.2f}s")
    return {"state": state, "run_dir": args.run_dir, "store": store,
            "ckpt_stats": ckpt_stats, "warmstart": warmstart}


if __name__ == "__main__":
    main()
