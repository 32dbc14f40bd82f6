"""Run-lineage CLI: inspect, QUERY and garbage-collect a multi-run store.

    PYTHONPATH=src python -m repro_torch.launch.runs list --store-root STORE
    PYTHONPATH=src python -m repro_torch.launch.runs show RUN --store-root STORE
    PYTHONPATH=src python -m repro_torch.launch.runs gc   --store-root STORE
    PYTHONPATH=src python -m repro_torch.launch.runs rm RUN --store-root STORE [--gc]
    PYTHONPATH=src python -m repro_torch.launch.runs diff RUN_A RUN_B \
        --store-root STORE
    PYTHONPATH=src python -m repro_torch.launch.runs logs --store-root STORE \
        [--run RUN] [--key loss] [--no-replay] [--where key=loss] \
        [--limit N] [--tail N] [--lineage RUN] [--engine auto|files|index]
    PYTHONPATH=src python -m repro_torch.launch.runs pivot --store-root STORE \
        [loss grad_norm ...] [--run RUN] [--lineage RUN] [--engine ...]
    PYTHONPATH=src python -m repro_torch.launch.runs reindex --store-root STORE

`--store-root` also accepts a RUN DIRECTORY (anything containing
flor.run.json): the CLI follows the binding to the store the run actually
used, so `runs list --store-root /tmp/runB` works on legacy per-run stores
too.

`gc` applies the multi-run live-set policy: the union of every registered
run's manifests, extended by `CheckpointStore.gc` with the cross-run parent
closure — so after `rm A`, `gc` reclaims exactly the checkpoints and chunks
no surviving descendant of A still resolves through.

`show` on a run recorded mesh-sharded (v4 manifests; only the JAX package
records those today) prints what its manifests and mesh meta hold; it reads
no tensor, so it needs no sharded restore.

`logs` streams every fingerprint-log row of every registered run (tagged
run_id/parent/source); `pivot` prints one row per (run, epoch) with log
keys as columns — the cross-run hindsight-logging view (`flor.log_records`
/ `flor.pivot` are the library spellings).
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from repro_torch.checkpoint import CheckpointStore, RunRegistry
from repro_torch.core.query import log_records, pivot, resolve_store_root

def _fmt_ts(ts) -> str:
    if not ts:
        return "-"
    return time.strftime("%Y-%m-%d %H:%M:%S", time.localtime(float(ts)))


def _run_keys(store: CheckpointStore, rec: dict) -> list[str]:
    return store.list_keys(run=rec.get("namespace"))


def cmd_list(store: CheckpointStore, registry: RunRegistry, args) -> int:
    runs = registry.list_runs()
    if not runs:
        print(f"no registered runs under {registry.root}")
        return 0
    print(f"{'RUN':<24} {'PARENT':<24} {'STATUS':<9} {'CKPTS':>5}  "
          f"{'SCOPES':<16} CREATED")
    for rec in runs:
        scopes = ",".join(sorted(rec.get("final_keys") or {})) or "-"
        print(f"{rec['run_id']:<24} {str(rec.get('parent') or '-'):<24} "
              f"{rec.get('status', '?'):<9} {len(_run_keys(store, rec)):>5}  "
              f"{scopes:<16} {_fmt_ts(rec.get('created_at'))}")
    st = store.stats()
    print(f"store: {st['manifests']} manifests "
          f"({st['full_manifests']} full + {st['delta_manifests']} delta), "
          f"max resolve chain {st['max_chain_depth']}, "
          f"{st['chunks']} chunks, {st['stored_bytes'] / 2**20:.1f} MiB")
    return 0


def cmd_show(store: CheckpointStore, registry: RunRegistry, args) -> int:
    rec = registry.get(args.run)
    if rec is None:
        print(f"unknown run {args.run!r} "
              f"(known: {[r['run_id'] for r in registry.list_runs()]})")
        return 1
    print(f"run        {rec['run_id']}")
    print(f"status     {rec.get('status', '?')}  "
          f"(created {_fmt_ts(rec.get('created_at'))}, "
          f"finished {_fmt_ts(rec.get('finished_at'))})")
    print(f"run_dir    {rec.get('run_dir') or '-'}")
    print(f"namespace  {rec.get('namespace') or '(flat)'}")
    chain = registry.ancestry(args.run)
    print("ancestry   " + " <- ".join(r["run_id"] for r in chain))
    for scope, key in sorted((rec.get("final_keys") or {}).items()):
        print(f"final      {scope}: {key}")
    keys = _run_keys(store, rec)
    ns = rec.get("namespace")
    # no chunk fields printed here: skip the O(store) objects-pool walk
    st = store.stats(keys=[f"{ns or ''}::{k}" for k in keys],
                     include_chunks=False, per_key=True)
    print(f"manifests  {st['manifests']} ({st['full_manifests']} full + "
          f"{st['delta_manifests']} delta"
          + (f" + {st['sharded_manifests']} sharded"
             if st.get("sharded_manifests") else "")
          + f"), max resolve chain "
          f"{st['max_chain_depth']} (may cross into ancestor runs)")
    _show_mesh(store, rec, st)
    _show_encodings(store, rec)
    return 0


def _show_mesh(store: CheckpointStore, rec: dict, st: dict) -> None:
    """Mesh shape + per-store-shard breakdown for sharded (v4) recordings —
    read from the recorded mesh meta and the v4 manifests' member chains."""
    rstore = CheckpointStore(store.root, run_id=rec.get("namespace"))
    mesh = rstore.get_meta("mesh")
    per_key = st.get("per_key") or {}
    shard_keys: dict[str, set] = {}    # hid -> sanitized member keys
    for info in per_key.values():
        for hid in (info.get("shards") or {}):
            shard_keys.setdefault(str(hid), set())
    if not mesh and not shard_keys:
        return
    if mesh:
        axes = " ".join(f"{n}={s}" for n, s in mesh.get("axes") or [])
        shard_axes = ",".join(mesh.get("shard_axes") or []) or "(all axes)"
        print(f"mesh       {axes or '-'}  "
              f"(ckpt shard axes: {shard_axes}; "
              f"{mesh.get('n_store_shards', len(shard_keys) or 1)} "
              f"store shards)")
    stored = store.shard_stored_bytes()
    ns = rec.get("namespace")
    print(f"{'  SHARD':<8} {'MANIFESTS':>9} {'CLOSURE CHUNKS':>14} "
          f"{'CLOSURE MiB':>12} {'POOL MiB':>9}")
    for hid in sorted(shard_keys, key=lambda h: int(h)):
        members = [f"{ns or ''}::{k}" for k in store.list_keys(run=ns)
                   if k.endswith(f".shard{hid}")]
        chunks = store.closure_chunks(members)
        print(f"  {hid:<6} {len(members):>9} {len(chunks):>14} "
              f"{store.chunk_bytes(chunks) / 2**20:>12.2f} "
              f"{stored.get(str(hid), 0) / 2**20:>9.2f}")


def _show_encodings(store: CheckpointStore, rec: dict) -> None:
    """Per-chunk wire-encoding mix of each scope's FINAL checkpoint (what a
    restore of it reads, chain-inherited chunks included): chunk counts and
    on-disk bytes per encoding — raw / q8 / q4, "+z" marking payloads the
    writer-thread entropy stage kept compressed. Checkpoints that are all
    raw print nothing (the default exact path has no mix to show)."""
    ns = rec.get("namespace")
    for scope, key in sorted((rec.get("final_keys") or {}).items()):
        try:
            mix = store.encoding_mix(f"{ns or ''}::{key}")
        except Exception:
            continue                       # broken chain: diagnostic only
        if not mix or set(mix) == {"raw"}:
            continue
        parts = ", ".join(
            f"{e} {mix[e]['chunks']} ({mix[e]['stored_bytes'] / 2**20:.2f} "
            f"MiB)" for e in sorted(mix))
        print(f"encodings  {scope}: {parts}")


def cmd_gc(store: CheckpointStore, registry: RunRegistry, args) -> int:
    stats = registry.gc(store)
    print(f"gc: kept {stats['kept_manifests']} manifests / "
          f"{stats['kept_chunks']} chunks; deleted "
          f"{stats['deleted_manifests']} manifests / "
          f"{stats['deleted_chunks']} chunks "
          f"({stats['deleted_bytes'] / 2**20:.2f} MiB)")
    return 0


def cmd_rm(store: CheckpointStore, registry: RunRegistry, args) -> int:
    descendants = [r["run_id"] for r in registry.list_runs()
                   if r.get("parent") == args.run]
    if descendants and not args.force:
        print(f"run {args.run!r} has registered descendants {descendants}; "
              f"their warm-start closure will keep pinning what they "
              f"inherit. Pass --force to unregister anyway.")
        return 1
    if not registry.unregister(args.run):
        print(f"unknown run {args.run!r}")
        return 1
    print(f"unregistered {args.run!r} "
          f"(manifests remain until gc; descendants keep their closure)")
    if args.gc:
        return cmd_gc(store, registry, args)
    return 0


def cmd_diff(store: CheckpointStore, registry: RunRegistry, args) -> int:
    """Chunk-level diff of two runs' manifest CLOSURES (each run's own
    manifests plus every ancestor manifest its delta chains resolve
    through): what lineage sharing actually saves on disk."""
    recs = []
    for rid in (args.run_a, args.run_b):
        rec = registry.get(rid)
        if rec is None:
            print(f"unknown run {rid!r} "
                  f"(known: {[r['run_id'] for r in registry.list_runs()]})")
            return 1
        recs.append(rec)
    closures = []
    for rec in recs:
        ns = rec.get("namespace")
        keys = [f"{ns or ''}::{k}" for k in store.list_keys(run=ns)]
        closures.append(store.closure_chunks(keys))
    ca, cb = closures
    shared, only_a, only_b = ca & cb, ca - cb, cb - ca
    rows = [("shared", shared), (f"only {args.run_a}", only_a),
            (f"only {args.run_b}", only_b)]
    print(f"{'SET':<28} {'CHUNKS':>8} {'MiB':>10}")
    for label, chunks in rows:
        print(f"{label:<28} {len(chunks):>8} "
              f"{store.chunk_bytes(chunks) / 2**20:>10.2f}")
    union = len(ca | cb)
    if union:
        print(f"dedup: {len(shared)}/{union} chunks shared "
              f"({100.0 * len(shared) / union:.1f}% of the union — bytes "
              f"one copy serves both runs)")
    return 0


def _parse_where(pairs) -> dict:
    """--where col=value (repeatable) -> {col: value}. Values parse as JSON
    when they can (epoch=3 is the int 3), else stay strings (key=loss)."""
    out = {}
    for pair in pairs or ():
        if "=" not in pair:
            raise SystemExit(f"--where expects col=value, got {pair!r}")
        col, raw = pair.split("=", 1)
        try:
            out[col.strip()] = json.loads(raw)
        except json.JSONDecodeError:
            out[col.strip()] = raw
    return out


def cmd_logs(store: CheckpointStore, registry: RunRegistry, args) -> int:
    rows = log_records(args.store_root, run=args.run, key=args.key,
                       include_replay=not args.no_replay,
                       inline_spill_bytes=args.inline_spill_bytes,
                       lineage=args.lineage, where=_parse_where(args.where),
                       limit=args.limit, tail=args.tail, engine=args.engine)
    if not rows:
        print("no log records found")
        return 0
    print(f"{'RUN':<24} {'PARENT':<24} {'SOURCE':<10} {'EPOCH':>5} "
          f"{'SEQ':>4}  {'KEY':<18} VALUE")
    for r in rows:
        print(f"{str(r['run_id']):<24} {str(r['parent_run'] or '-'):<24} "
              f"{r['source']:<10} {str(r['epoch']):>5} {str(r['seq']):>4}  "
              f"{str(r['key']):<18} {json.dumps(r['value'], default=str)}")
    print(f"({len(rows)} rows)")
    return 0


def cmd_pivot(store: CheckpointStore, registry: RunRegistry, args) -> int:
    rows = pivot(args.store_root, *args.keys, run=args.run,
                 include_replay=not args.no_replay,
                 inline_spill_bytes=args.inline_spill_bytes,
                 lineage=args.lineage, engine=args.engine)
    if not rows:
        print("no log records found")
        return 0
    cols = []
    for r in rows:
        for k in r:
            if k not in cols and k not in ("run_id", "parent_run", "epoch"):
                cols.append(k)
    header = f"{'RUN':<24} {'PARENT':<24} {'EPOCH':>5}"
    for c in cols:
        header += f" {c:>14}"
    print(header)
    for r in rows:
        line = (f"{str(r['run_id']):<24} {str(r['parent_run'] or '-'):<24} "
                f"{str(r['epoch']):>5}")
        for c in cols:
            v = r.get(c)
            line += f" {v:>14.6g}" if isinstance(v, float) \
                else f" {str(v if v is not None else '-'):>14}"
        print(line)
    print(f"({len(rows)} rows x {len(cols)} keys)")
    return 0


def cmd_reindex(store: CheckpointStore, registry: RunRegistry, args) -> int:
    from repro_torch.querydb import reindex
    stats = reindex(args.store_root)
    print(f"reindexed {args.store_root}: {stats['runs']} runs, "
          f"{stats['segments_ingested']} segments ingested "
          f"({stats['segments_skipped']} already current, "
          f"{stats['segments_pruned']} pruned), {stats['rows']} rows read; "
          f"index now holds {stats['records']} records over "
          f"{stats['segments']} segments ({stats['spilled']} spill refs)")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.runs",
                                 description=__doc__.splitlines()[0])
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--store-root", required=True,
                        help="shared store root, or a run dir with "
                             "flor.run.json")
    sub = ap.add_subparsers(dest="cmd", required=True)
    sub.add_parser("list", parents=[common],
                   help="registered runs + store summary")
    p_show = sub.add_parser("show", parents=[common],
                            help="one run: lineage, finals, stats")
    p_show.add_argument("run")
    sub.add_parser("gc", parents=[common],
                   help="multi-run live-set garbage collection")
    p_rm = sub.add_parser("rm", parents=[common],
                          help="unregister a run (reclaim via gc)")
    p_rm.add_argument("run")
    p_rm.add_argument("--force", action="store_true",
                      help="unregister even with registered descendants")
    p_rm.add_argument("--gc", action="store_true",
                      help="run gc immediately after unregistering")
    p_diff = sub.add_parser("diff", parents=[common],
                            help="chunks shared vs unique between two "
                                 "runs' manifest closures")
    p_diff.add_argument("run_a")
    p_diff.add_argument("run_b")
    p_logs = sub.add_parser("logs", parents=[common],
                            help="every log row across the lineage")
    p_logs.add_argument("--run", default=None, help="restrict to one run id")
    p_logs.add_argument("--key", default=None, help="restrict to one log key")
    p_logs.add_argument("--no-replay", action="store_true",
                        help="record logs only (skip hindsight replay logs)")
    p_logs.add_argument("--inline-spill-bytes", type=int, default=0,
                        help="resolve spilled values at/below this size "
                             "back to the actual value (0 = keep pointers)")
    p_logs.add_argument("--where", action="append", metavar="COL=VALUE",
                        help="equality filter (repeatable; e.g. key=loss, "
                             "epoch=3, source=record) — pushed into SQL "
                             "when the index serves")
    p_logs.add_argument("--limit", type=int, default=None,
                        help="at most N rows (in global row order)")
    p_logs.add_argument("--tail", type=int, default=None,
                        help="only the LAST N rows after filtering")
    p_logs.add_argument("--lineage", default=None, metavar="RUN",
                        help="restrict to RUN's ancestor chain (inclusive)")
    p_logs.add_argument("--engine", default="auto",
                        choices=("auto", "files", "index"),
                        help="serving path (default auto: index when fresh, "
                             "file scan otherwise)")
    p_piv = sub.add_parser("pivot", parents=[common],
                           help="one row per (run, epoch), keys as columns")
    p_piv.add_argument("keys", nargs="*",
                       help="log keys to pivot (default: all observed)")
    p_piv.add_argument("--run", default=None, help="restrict to one run id")
    p_piv.add_argument("--no-replay", action="store_true",
                       help="record logs only (skip hindsight replay logs)")
    p_piv.add_argument("--inline-spill-bytes", type=int, default=0,
                       help="resolve spilled values at/below this size "
                            "back to the actual value (0 = keep pointers)")
    p_piv.add_argument("--lineage", default=None, metavar="RUN",
                       help="restrict to RUN's ancestor chain (inclusive)")
    p_piv.add_argument("--engine", default="auto",
                       choices=("auto", "files", "index"),
                       help="serving path (default auto: index when fresh, "
                            "file scan otherwise)")
    sub.add_parser("reindex", parents=[common],
                   help="catch the sqlite query index up with the log "
                        "segments on disk")
    args = ap.parse_args(argv)

    root = resolve_store_root(args.store_root)
    store = CheckpointStore(root)
    registry = RunRegistry(root)
    return {"list": cmd_list, "show": cmd_show, "gc": cmd_gc, "rm": cmd_rm,
            "diff": cmd_diff, "logs": cmd_logs, "pivot": cmd_pivot,
            "reindex": cmd_reindex}[args.cmd](store, registry, args)


if __name__ == "__main__":
    sys.exit(main())
