"""Parallel hindsight-replay launcher — a thin front end over the replay
planner and the cost-balanced scheduler (paper section 5.4 + Fig. 8;
``repro_torch.replay``).

    PYTHONPATH=src python -m repro_torch.launch.replay --run-dir RUN \
        --nworkers 2 --probe train --check

Runs on the card (``--device cuda``, the default; it fails when there is no
card) unless ``--device cpu`` is given; the flag goes on to every worker.
The model, epochs and steps per epoch are the record run's (``flor.arg``
returns the recorded values); ``--arch``/``--smoke``/``--layers``/
``--batch``/``--seq``/``--seed`` must match the record run's.

Flow: PLAN (probe set x checkpoint-manifest metadata -> per-epoch segments
with resume-cost estimates) -> SCHEDULE (LPT cost-balanced shares, dynamic
work-queue over worker processes with failure/straggler re-queue) -> MERGE
(per-segment log merge into ``logs/merged_replay.jsonl``) -> deferred
correctness CHECK. Workers share the host's card; each restores the
checkpoints its visits skip onto it.

``--probe auto`` is the paper's section-3.2 source-diff tier: record stored
a copy of the driving script; the current file (or ``--current-src``) is
diffed against it, added lines map to their innermost enclosing loop, and
non-additive edits are surfaced as a HARD WARNING. ``--hosts N`` places the
tasks on N modelled host queues (placement only). A replay fleet
(``--num-processes N``, each host started with its ``--process-id``) runs
this launcher on every host against the shared store: each derives the same
plan and LPT host partition, executes its own share with read affinity to
its block of store shards (``--prefer-shards``), and host 0 merges once
every host has arrived at a store-file barrier (``--merge-timeout``).
``--no-plan`` is the legacy contiguous fan-out (no planner: each worker
replays its contiguous share of the epochs; it refuses ``--probe auto``,
which needs the planner). ``--coordinator`` is accepted for symmetry with
the train launcher and unused: replay hosts coordinate through the store
filesystem.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time


# barrier pseudo-key multi-host replay uses for the merge handoff
MERGE_BARRIER = "replay.merge"


def _parse_segments(spec: str) -> list:
    """'0:init,1:exec,...' -> [(0, 'init'), (1, 'exec'), ...]."""
    out = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        e, ph = part.split(":", 1)
        out.append((int(e), ph))
    return out


def _fmt_segments(visits: list) -> str:
    return ",".join(f"{e}:{ph}" for e, ph in visits)


def worker_main(args):
    import repro_torch.configs as C
    import repro_torch.flor as flor
    from repro_torch.data import synthetic_batch
    from repro_torch.train.step import build_train_step

    cfg = C.get_smoke(args.arch) if args.smoke else C.get(args.arch)
    if args.layers:
        cfg = C.with_layers(cfg, args.layers)
    probed = frozenset(p for p in args.probe.split(",") if p) \
        if args.probe and args.probe != "auto" else frozenset()
    segments = _parse_segments(args.segments) if args.segments else None
    with flor.Session(args.run_dir, mode="replay",
                      replay=flor.ReplaySpec(pid=args.pid,
                                             nworkers=args.nworkers,
                                             init_mode=args.init_mode,
                                             probed=probed,
                                             segments=segments)) as sess:
        # the record's compute dtype (``launch/train.py --dtype``)
        cfg = cfg.replace(dtype=sess.arg("dtype", cfg.dtype))
        init_state, ts = build_train_step(cfg, device=args.device)
        state = init_state(args.seed)
        if sess.parent_run:
            # derived run (lineage): record started from the ancestor's
            # final checkpoint, so replay must too
            state = sess.warm_start("train", like=state)
        steps = sess.arg("steps_per_epoch", args.steps_per_epoch)
        with sess.checkpointing(state=state) as ckpt:
            for epoch in sess.loop("epochs",
                                   range(sess.arg("epochs", args.epochs))):
                for s in sess.loop("train", range(steps)):
                    b = synthetic_batch(cfg, args.batch, args.seq,
                                        epoch * steps + s, args.seed)
                    ckpt.state, m = ts(ckpt.state, b)
                    if args.probe:
                        flor.log("probe_grad_norm", m["grad_norm"])
                if sess.executed("train"):
                    flor.log("loss", m["loss"])


def _print_store_summary(run_dir: str):
    """How the record run's checkpoints are laid out: full vs delta
    manifests and the longest parent chain a restore has to resolve."""
    from repro_torch.replay import open_run_store
    store, meta = open_run_store(run_dir)
    st = store.stats(keys=store.list_keys())
    print(f"store: {st['full_manifests']} full + {st['delta_manifests']} "
          f"delta manifests, max resolve chain {st['max_chain_depth']}, "
          f"{st['stored_bytes'] / 2**20:.1f} MiB chunks"
          + (f" (shared store {store.root}, run {meta.get('run_id')})"
             if meta.get("store_root") else ""))


def _worker_cmd(args, pid: int, segments: str = "") -> list[str]:
    cmd = [sys.executable, "-m", "repro_torch.launch.replay",
           "--run-dir", args.run_dir, "--arch", args.arch,
           "--device", args.device,
           "--epochs", str(args.epochs),
           "--steps-per-epoch", str(args.steps_per_epoch),
           "--batch", str(args.batch), "--seq", str(args.seq),
           "--nworkers", str(args.nworkers), "--pid", str(pid),
           "--probe", "" if args.probe == "auto" else args.probe,
           "--init-mode", args.init_mode, "--seed", str(args.seed)]
    if segments:
        cmd += ["--segments", segments]
    if args.smoke:
        cmd.append("--smoke")
    if args.layers:
        cmd += ["--layers", str(args.layers)]
    return cmd


def _legacy_fanout(args) -> None:
    """The pre-planner contiguous fan-out (``--no-plan``): every worker
    replays its contiguous share of the epochs, as the record's epoch
    count splits over ``--nworkers``."""
    t0 = time.time()
    procs = [subprocess.Popen(_worker_cmd(args, pid), env=os.environ.copy())
             for pid in range(args.nworkers)]
    rcodes = [p.wait() for p in procs]
    print(f"parallel replay (legacy contiguous): {args.nworkers} workers, "
          f"wall {time.time() - t0:.2f}s, rc={rcodes}")
    _print_store_summary(args.run_dir)
    if any(rcodes):
        sys.exit(1)
    if args.check:
        import repro_torch.flor as flor
        rec, reps = flor.run_logs(args.run_dir)
        _report_check(flor.deferred_check(rec, reps))


def _report_check(res) -> None:
    print(f"deferred check: ok={res.ok} compared={res.compared} "
          f"hindsight={res.hindsight_only} anomalies={len(res.anomalies)}")
    if not res.ok:
        for a in res.anomalies[:10]:
            print("  anomaly:", a)
        sys.exit(2)


def _report_auto_probes(args):
    """Run --probe auto detection once for user-facing output, HARD-WARNING
    on suspicious non-additive source edits (the plan re-derives the same
    probe set internally)."""
    from repro_torch.replay import detect_probes_for_run
    report = detect_probes_for_run(args.run_dir,
                                   current_src=args.current_src or None)
    if report.suspicious:
        print("=" * 70, file=sys.stderr)
        print(f"WARNING: {len(report.suspicious)} NON-ADDITIVE source "
              f"edit(s) between record and replay — hindsight replay "
              f"assumes only log statements were ADDED; changed or deleted "
              f"lines can invalidate the recorded checkpoints:",
              file=sys.stderr)
        for s in report.suspicious[:5]:
            print(f"  [{s['tag']}] {s['old']!r} -> {s['new']!r}",
                  file=sys.stderr)
        print("=" * 70, file=sys.stderr)
    print(f"probe auto: {len(report.added_lines)} added line(s) -> "
          f"inner blocks {sorted(report.probed_blocks) or '-'} "
          f"outer loops {sorted(report.probed_outer) or '-'}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--run-dir", required=True)
    ap.add_argument("--arch", default="florbench-100m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--layers", type=int, default=None,
                    help="the record run's depth cut, if it had one")
    ap.add_argument("--device", default="cuda",
                    help="torch device of every worker (default cuda; "
                         "'cpu' runs the kernels' plain versions)")
    ap.add_argument("--epochs", type=int, default=4,
                    help="used only if the record run declared none")
    ap.add_argument("--steps-per-epoch", type=int, default=8,
                    help="used only if the record run declared none")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--nworkers", type=int, default=1)
    ap.add_argument("--pid", type=int, default=None,
                    help="run as ONE worker (internal)")
    ap.add_argument("--segments", default=None,
                    help="planned visit list '0:init,1:exec,...' (internal)")
    ap.add_argument("--probe", default="",
                    help="comma-separated probed block ids ('train', '*'), "
                         "or 'auto' for source-diff detection")
    ap.add_argument("--current-src", default="",
                    help="with --probe auto: the edited script to diff "
                         "against the recorded copy (default: the recorded "
                         "path on disk)")
    ap.add_argument("--init-mode", choices=("strong", "weak"),
                    default="strong")
    ap.add_argument("--partition", choices=("balanced", "contiguous"),
                    default="balanced",
                    help="work partitioning: LPT over segment cost "
                         "estimates (default) or a contiguous split")
    ap.add_argument("--tasks-per-worker", type=int, default=1,
                    help="split work finer than one share per worker so "
                         "the dynamic queue can rebalance")
    ap.add_argument("--hosts", type=int, default=1,
                    help="model N replay hosts: tasks are LPT-placed onto "
                         "host queues and workers steal only when their "
                         "home queue drains")
    ap.add_argument("--coordinator", default=None,
                    help="accepted for launcher symmetry with train; "
                         "replay hosts coordinate through the store "
                         "filesystem, not a process group")
    ap.add_argument("--process-id", type=int, default=0,
                    help="this host's id in a multi-process replay fleet "
                         "(every host runs this launcher)")
    ap.add_argument("--num-processes", type=int, default=1,
                    help="replay fleet size; > 1 partitions the planned "
                         "tasks across hosts — each host executes only its "
                         "share, host 0 merges after a store-file barrier")
    ap.add_argument("--merge-timeout", type=float, default=600.0,
                    help="seconds host 0 waits for every host's share "
                         "before failing the merge")
    ap.add_argument("--prefer-shards", default=None,
                    help="comma-separated store shard ids this host reads "
                         "first (default under --num-processes: a "
                         "contiguous block of the recorded shards)")
    ap.add_argument("--straggler-factor", type=float, default=None,
                    help="speculatively re-issue a task running this many "
                         "times longer than expected (0 = off; default: "
                         "measured — on at 3x when every task has a real "
                         "cost estimate from the record profile, else off)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--plan-only", action="store_true",
                    help="print the plan and assignments, run nothing")
    ap.add_argument("--no-plan", action="store_true",
                    help="legacy contiguous fan-out (deprecated)")
    ap.add_argument("--check", action="store_true",
                    help="run the deferred correctness check after replay")
    args = ap.parse_args(argv)

    if args.pid is not None:
        worker_main(args)
        return
    if args.device.startswith("cuda"):
        import torch
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"--device {args.device}: torch.cuda.is_available() is "
                f"False (pass --device cpu to replay on the CPU)")
    if args.no_plan:
        if args.probe == "auto":
            # the legacy fan-out has no planner to consume the detection:
            # silently degrading to "no probes" would report a vacuously
            # passing check
            ap.error("--probe auto requires the planner; drop --no-plan")
        _legacy_fanout(args)
        return

    import repro_torch.flor as flor
    from repro_torch.logging import remove_stream
    from repro_torch.replay import (DynamicExecutor, Task, TaskFailure,
                                    assign_hosts, balanced_shares,
                                    build_plan, contiguous_shares,
                                    measured_straggler_factor, share_cost)

    # ---- plan ----
    if args.probe == "auto":
        _report_auto_probes(args)
        plan = build_plan(args.run_dir, probed="auto",
                          init_mode=args.init_mode,
                          current_src=args.current_src or None)
    else:
        plan = build_plan(args.run_dir,
                          probed={p for p in args.probe.split(",") if p},
                          init_mode=args.init_mode)
    print(plan.summary())

    # ---- schedule ----
    work = plan.work_segments()
    nshares = max(1, args.nworkers * max(1, args.tasks_per_worker))
    split = balanced_shares if args.partition == "balanced" \
        else contiguous_shares
    shares = [sh for sh in split(work, nshares) if sh]
    tasks = [Task(task_id=tid, visits=plan.visits_for(sh),
                  epochs=[s.epoch for s in sh],
                  est_cost_s=share_cost(plan, sh))
             for tid, sh in enumerate(shares)]
    # ---- multi-host replay (--num-processes > 1): every host runs this
    # launcher against the shared store; the plan and the LPT host
    # assignment are deterministic, so each host independently derives the
    # SAME partition and executes only its share. Host 0 merges once every
    # host has arrived at the store-file barrier.
    fleet = max(1, args.num_processes)
    n_hosts = fleet if fleet > 1 else max(1, args.hosts)
    if n_hosts > 1:
        assign_hosts(tasks, n_hosts)
    for t in tasks:
        print(f"  task {t.task_id}: epochs {t.epochs} "
              f"({len(t.visits)} visits, est {t.est_cost_s:.2f}s"
              + (f", host {t.host}" if n_hosts > 1 else "") + ")")
    rdv = None
    my_tasks = tasks
    if fleet > 1:
        from repro_torch.parallel.rendezvous import (ProcessGroup,
                                                     StitchRendezvous)
        from repro_torch.replay import open_run_store
        store, run_meta = open_run_store(args.run_dir)
        rdv = StitchRendezvous(store.root,
                               run_meta.get("run_id") or "replay",
                               ProcessGroup(args.process_id, fleet),
                               timeout_s=args.merge_timeout)
        # a stale marker from a crashed previous invocation must never
        # satisfy this round's barrier on our behalf
        rdv.retract(MERGE_BARRIER)
        my_tasks = [t for t in tasks if t.host == args.process_id]
        print(f"host {args.process_id}/{fleet}: executing "
              f"{len(my_tasks)}/{len(tasks)} task(s)")
        # shard-pool read affinity: this host reads its share of the
        # recorded store shards first (content addressing keeps every pool
        # valid); the workers inherit it through the environment
        if args.prefer_shards is not None:
            os.environ["FLOR_PREFER_SHARDS"] = args.prefer_shards
        else:
            n_store = int((plan.mesh or {}).get("n_store_shards") or 0)
            mine = [str(h) for h in range(n_store)
                    if h * fleet // n_store == args.process_id]
            if mine:
                os.environ["FLOR_PREFER_SHARDS"] = ",".join(mine)
    elif args.prefer_shards:
        os.environ["FLOR_PREFER_SHARDS"] = args.prefer_shards
    if rdv is None or rdv.group.is_lead:
        plan.save(assignments={str(t.task_id): {"epochs": t.epochs,
                                                "visits": t.visits,
                                                "est_cost_s": t.est_cost_s,
                                                "host": t.host}
                               for t in tasks})
    if args.plan_only:
        return

    # ---- execute: dynamic work-queue over worker processes ----
    inner_probes = ",".join(sorted(plan.probed))
    # per-(task, attempt) log identity: stride by the task count so retry
    # pids can never collide with first-attempt pids of other tasks
    pid_stride = len(tasks)

    def run_task(task, attempt, cancelled):
        pid = task.task_id + (attempt - 1) * pid_stride
        wargs = argparse.Namespace(**vars(args))
        wargs.probe = inner_probes
        cmd = _worker_cmd(wargs, pid, _fmt_segments(task.visits))
        proc = subprocess.Popen(cmd, env=os.environ.copy())
        while proc.poll() is None:
            if cancelled.is_set():
                proc.terminate()
                proc.wait()
                return None
            time.sleep(0.05)
        if proc.returncode != 0:
            raise RuntimeError(f"worker task {task.task_id} attempt "
                               f"{attempt} exited rc={proc.returncode}")
        return pid

    merged_epochs: set = set()

    def on_complete(task, attempt, pid):
        merged_epochs.update(task.epochs)
        print(f"  task {task.task_id} done (attempt {attempt}): "
              f"{len(merged_epochs)}/{len(work)} work epochs merged",
              flush=True)

    # measured default: with real cost estimates on every task, speculation
    # turns on at the scheduler's default horizon; an explicit
    # --straggler-factor (incl. 0) always wins
    straggler = args.straggler_factor if args.straggler_factor is not None \
        else measured_straggler_factor(tasks)
    if args.straggler_factor is None and straggler > 0:
        print(f"  straggler speculation: on (measured estimates, "
              f"{straggler:g}x horizon)")

    t0 = time.time()
    ex = DynamicExecutor(my_tasks, run_task, args.nworkers,
                         straggler_factor=straggler,
                         on_complete=on_complete,
                         n_hosts=1 if fleet > 1 else n_hosts)
    try:
        done = ex.run()
    except TaskFailure as e:
        print(f"parallel replay FAILED: {e}")
        sys.exit(1)
    print(f"parallel replay (planned, {args.partition}): "
          f"{args.nworkers} workers / {len(my_tasks)} tasks, "
          f"wall {time.time() - t0:.2f}s")
    _print_store_summary(args.run_dir)

    # ---- merge per plan segment ----
    # owner log = the pid run_task RETURNED for the winning attempt; the
    # logs of superseded attempts (failed first tries, cancelled straggler
    # duplicates) are dropped so no later raw-file check reads them. Task
    # ids are fleet-global, so each host only touches its own logs.
    owners = [(f"replay_p{done[t.task_id][1]}", t.epochs) for t in my_tasks]
    keep = {f"{src}.jsonl" for src, _ in owners}
    for t in my_tasks:
        for attempt in range(1, ex.max_attempts + 1):
            fn = f"replay_p{t.task_id + (attempt - 1) * pid_stride}.jsonl"
            if fn not in keep:
                remove_stream(os.path.join(args.run_dir, "logs", fn))

    if rdv is not None:
        # hand this host's owner map to host 0 through the store barrier;
        # only the lead merges (and only after EVERY host arrived, so the
        # merge never reads a log a straggler is still writing)
        rdv.arrive(MERGE_BARRIER,
                   {"process": rdv.group.process_id,
                    "owners": [[src, list(eps)] for src, eps in owners]})
        if not rdv.group.is_lead:
            print(f"host {rdv.group.process_id}: share complete "
                  f"({len(owners)} task log(s)); host 0 merges")
            rdv.close()
            return
        got = rdv.await_all(MERGE_BARRIER, timeout_s=args.merge_timeout)
        rdv.close()
        if got is None:
            print(f"replay merge FAILED: a host missed the merge barrier "
                  f"within {args.merge_timeout:.0f}s")
            sys.exit(1)
        rdv.clear(MERGE_BARRIER)
        owners = [(src, eps) for marker in got
                  for src, eps in (marker.get("owners") or [])]
    merged = flor.merge_replay_logs(args.run_dir, owners, out_path=True)
    print(f"merged {len(merged)} log rows from {len(owners)} task log(s) "
          f"-> logs/merged_replay.jsonl")

    if args.check:
        rec, _ = flor.run_logs(args.run_dir)
        _report_check(flor.deferred_check(rec, merged))


if __name__ == "__main__":
    main()
