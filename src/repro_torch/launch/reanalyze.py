"""Re-derive analysis artifacts without re-running anything (reference:
the reference package's ``launch/reanalyze.py``): roofline numbers from
the archived traced graphs (results/fx/*.fx.zst) whenever
hlo_analysis.py improves, and checkpoint-store summaries for recorded runs
— lineage-aware, so a derived run's chains resolving through ancestor-run
manifests in a shared store are reported correctly. Stores are shared by
both packages, so either package's runs can be summarized.

    PYTHONPATH=src python -m repro_torch.launch.reanalyze \
        --json results/dryrun_single.json
    PYTHONPATH=src python -m repro_torch.launch.reanalyze \
        --store-summary /tmp/runB --store-summary /tmp/runA
    PYTHONPATH=src python -m repro_torch.launch.reanalyze --logs-summary STORE
"""
from __future__ import annotations

import argparse
import json
import os

from repro_torch.launch.dryrun import FX_DIR, cell_tag, roofline_terms
from repro_torch.launch.hlo_analysis import analyze
from repro_torch.utils.codec import Compressor


def reanalyze_json(path: str, fx_dir: str = FX_DIR):
    with open(path) as f:
        results = json.load(f)
    dctx = Compressor()
    for r in results:
        if r.get("status") != "ok":
            continue
        fp = os.path.join(fx_dir, cell_tag(r["arch"], r["shape"], None,
                                           r.get("smoke", False),
                                           r.get("mesh", "card"))
                          + ".fx.zst")
        if not os.path.exists(fp):
            continue
        with open(fp, "rb") as f:
            text = dctx.decompress(f.read()).decode()
        hl = analyze(text)
        r["flops_per_device"] = hl["flops"]
        r["bytes_accessed_per_device"] = hl["bytes"]
        r["collective_bytes_per_device"] = dict(hl["coll"])
        r["collective_counts"] = dict(hl["coll_counts"])
        r["roofline"] = roofline_terms(hl)
    with open(path, "w") as f:
        json.dump(results, f, indent=1, default=str)
    print(f"reanalyzed {path}")


def reanalyze_store(run_dir: str):
    """Post-hoc store summary for one run dir (same single-pass
    CheckpointStore.stats() the replay launcher and `runs` CLI use)."""
    from repro_torch.checkpoint import CheckpointStore
    from repro_torch.checkpoint.lineage import read_run_meta
    meta = read_run_meta(run_dir)
    root = meta.get("store_root") or os.path.join(run_dir, "store")
    store = CheckpointStore(root, run_id=meta.get("namespace"))
    st = store.stats(keys=store.list_keys())
    lineage = f", run {meta['run_id']} in shared store {root}" \
        if meta.get("store_root") else ""
    print(f"{run_dir}: {st['manifests']} manifests "
          f"({st['full_manifests']} full + {st['delta_manifests']} delta), "
          f"max resolve chain {st['max_chain_depth']}, "
          f"{st['stored_bytes'] / 2**20:.1f} MiB chunks{lineage}")


def reanalyze_logs(path: str):
    """Cross-run log summary without re-running anything: per registered run,
    how many fingerprint rows / distinct keys / epochs the lineage holds
    (`flor.log_records` is the row-level spelling)."""
    from repro_torch.core.query import log_records
    rows = log_records(path)
    per_run: dict = {}
    for r in rows:
        d = per_run.setdefault(r["run_id"],
                               {"parent": r["parent_run"], "rows": 0,
                                "keys": set(), "epochs": set()})
        d["rows"] += 1
        d["keys"].add(r["key"])
        if r["epoch"] is not None:
            d["epochs"].add(r["epoch"])
    print(f"{path}: {len(rows)} log rows across {len(per_run)} run(s)")
    for rid, d in per_run.items():
        print(f"  {rid} (parent {d['parent'] or '-'}): {d['rows']} rows, "
              f"{len(d['epochs'])} epochs, keys {sorted(d['keys'])}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--json", action="append", default=[])
    ap.add_argument("--fx-dir", default=FX_DIR)
    ap.add_argument("--store-summary", action="append", default=[],
                    metavar="RUN_DIR",
                    help="print a lineage-aware checkpoint-store summary "
                         "for a recorded run dir")
    ap.add_argument("--logs-summary", action="append", default=[],
                    metavar="STORE_OR_RUN_DIR",
                    help="print a cross-run fingerprint-log summary "
                         "(rows/keys/epochs per registered run)")
    args = ap.parse_args(argv)
    if not args.json and not args.store_summary and not args.logs_summary:
        ap.error("pass --json, --store-summary and/or --logs-summary")
    for p in args.json:
        reanalyze_json(p, args.fx_dir)
    for rd in args.store_summary:
        reanalyze_store(rd)
    for p in args.logs_summary:
        reanalyze_logs(p)


if __name__ == "__main__":
    main()
