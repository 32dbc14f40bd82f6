"""Roofline report: dry-run JSON -> per-cell three-term table + markdown
(reference: the reference package's ``launch/roofline.py``).

    PYTHONPATH=src python -m repro_torch.launch.roofline \
        --in results/dryrun_single.json --md results/roofline.md

Terms (seconds, PER DEVICE, from launch/hlo_analysis.py over the traced
graph; bounds from the NVIDIA H100 SXM5 80GB data-sheet peaks, not
measurements):
    compute    = graph_mm_FLOPs / 989.4e12      (bf16 tensor cores, dense)
    memory     = graph_bytes    / 3.35e12       (HBM3)
    collective = coll_bytes     / 450e9         (NVLink 4, per direction)

MODEL_FLOPS is the analytic useful compute: 6*N_active*tokens for train
(fwd+bwd), 2*N_active*tokens for prefill/decode. The ratio
MODEL_FLOPS / (graph_FLOPs * ndev) exposes recompute, attention and
dispatch overheads.
"""
from __future__ import annotations

import argparse
import json

import repro_torch.configs as C
from repro_torch.launch.mesh import PEAK_FLOPS_BF16

HINTS = {
    "compute": ("compute-bound: reduce recompute (chunk remat), keep the "
                "matmuls in bf16 on the tensor cores, or spread the step "
                "over more cards"),
    "memory": ("HBM-bound: cut the per-call weight casts and activation "
               "round trips (fuse elementwise chains, flash attention), or "
               "raise arithmetic intensity with a larger batch per card"),
    "collective": ("NVLink-bound: reshard to cut all-gathers, overlap "
                   "collectives with compute, or compress the gradients "
                   "(int8 + error feedback, parallel/compression.py)"),
}


def _shape_of(shape) -> C.ShapeSpec:
    return C.SHAPES[shape] if isinstance(shape, str) else shape


def model_flops(arch: str, shape, smoke: bool = False) -> float:
    """``shape``: a ``SHAPES`` name or a ``ShapeSpec``; ``smoke``: the
    arch's reduced config."""
    cfg = C.get_smoke(arch) if smoke else C.get(arch)
    shape = _shape_of(shape)
    n_active = cfg.active_param_count()
    if cfg.family == "audio" and shape.kind != "decode":
        tokens = shape.global_batch * shape.seq_len          # enc+dec halves
    elif shape.kind == "decode":
        tokens = shape.global_batch * 1
    else:
        tokens = shape.global_batch * shape.seq_len
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n_active * tokens


def result_shape(r: dict):
    """The cell's shape: its ``SHAPES`` name, or the ``ShapeSpec`` a
    dry run kept under ``shape_spec``."""
    if "shape_spec" in r:
        return C.ShapeSpec(r["shape"], **r["shape_spec"])
    return r["shape"]


def build_rows(results: list[dict]) -> list[dict]:
    rows = []
    for r in results:
        row = {"arch": r["arch"], "shape": r["shape"], "mesh": r["mesh"],
               "status": r["status"]}
        if r["status"] != "ok":
            row["note"] = r.get("reason", r.get("error", ""))[:90]
            rows.append(row)
            continue
        rl = r["roofline"]
        terms = {"compute": rl["compute_s"], "memory": rl["memory_s"],
                 "collective": rl["collective_s"]}
        dom = max(terms, key=terms.get)
        mf = model_flops(r["arch"], result_shape(r), r.get("smoke", False))
        graph_global = r["flops_per_device"] * r["ndev"]
        row.update({
            "compute_s": terms["compute"],
            "memory_s": terms["memory"],
            "collective_s": terms["collective"],
            "dominant": dom,
            "model_flops": mf,
            "hlo_flops_global": graph_global,
            "useful_ratio": mf / graph_global if graph_global else 0.0,
            # roofline fraction: useful compute time / achievable step time
            # (= max of the three terms, the bound a perfect overlap hits)
            "roofline_frac": (mf / r["ndev"] / PEAK_FLOPS_BF16)
            / max(terms.values()) if max(terms.values()) > 0 else 0.0,
            "hint": HINTS[dom],
        })
        rows.append(row)
    return rows


def to_markdown(rows: list[dict]) -> str:
    out = ["| arch | shape | compute_s | memory_s | collective_s | dominant "
           "| useful FLOP ratio | roofline frac |",
           "|---|---|---|---|---|---|---|---|"]
    for r in rows:
        if r["status"] != "ok":
            out.append(f"| {r['arch']} | {r['shape']} | — | — | — | "
                       f"{r['status']}: {r.get('note','')} | — | — |")
            continue
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['compute_s']:.4g} | "
            f"{r['memory_s']:.4g} | {r['collective_s']:.4g} | "
            f"{r['dominant']} | {r['useful_ratio']:.3f} | "
            f"{r['roofline_frac']:.3f} |")
    return "\n".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--in", dest="inp", default="results/dryrun_single.json")
    ap.add_argument("--out", default=None)
    ap.add_argument("--md", default=None)
    args = ap.parse_args(argv)
    with open(args.inp) as f:
        results = json.load(f)
    rows = build_rows(results)
    print(to_markdown(rows))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    if args.md:
        with open(args.md, "w") as f:
            f.write(to_markdown(rows) + "\n")


if __name__ == "__main__":
    main()
