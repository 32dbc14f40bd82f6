"""Dry run: trace each (arch, shape) cell's step at full width and depth and
derive its cost and roofline, with no parameter or activation allocated
(reference: the reference package's ``launch/dryrun.py``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-14b \
        --shape train_4k --device cpu --out results/dryrun_single.json

The reference lowers and compiles each cell for the production mesh. This
package traces the program a card would run: ``make_fx(...,
tracing_mode="fake")`` over fake tensors of the cell's shapes.

One card (``mesh: "card"``, ``ndev`` 1; the default): the TrainState and
batch through ``build_train_step``'s step; the parameters and prompt batch
through ``serve/step.py``'s prefill; the parameters, the caches of
``seq_len`` positions and one token through its decode, at the last
position. Serving cells keep the parameters in ``param_dtype``, as the
serving path runs them (``--override param_dtype=bfloat16`` gives the
reference dry run's compute-dtype weights).

The production mesh (``--multi-pod``: the reference's (2, 16, 16)
"multi"; ``--both-meshes``: its (16, 16) "single" and "multi";
``launch/mesh.py::make_production_mesh``, a fake process group of 512
ranks in this process): rank 0's program, the way the reference's
``lower_cell`` builds the cell — train on the local shards of the state
laid out by ``state_shardings`` (``train_step.local_step``), prefill and
decode on parameters laid out by ``param_shardings(serve=global_batch >=
16)`` and caches by ``cache_shardings`` (``Model.prefill_local`` /
``decode_local``), each input cut to rank 0's shard by
``batch_shardings``. Its collectives are ``_c10d_functional`` nodes,
counted by kind. ``ndev`` is the mesh's size.

Every row holds the trace's seconds in place of ``lower_s`` /
``compile_s``, the per-device numbers from ``launch/hlo_analysis.py`` and
the roofline from the card's data-sheet peaks (``launch/mesh.py``).
``memory`` holds the arguments', outputs' and aliased outputs' bytes and
``temp_bytes``, the peak of live intermediates over the graph in its
order (each buffer freed after its last use), which says whether the cell
fits one card.

The graph text is archived compressed under
``results/fx/<tag>.fx.zst`` (``launch/reanalyze.py`` re-derives the rows
from it). ``--device`` (default ``cuda``) is the fake tensors' device; the
CPU gives the same graph but for the device of the few tensors a step
makes itself.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from repro_torch.configs import (SHAPES, ShapeSpec, cell_applicable, get,
                                 get_smoke, list_archs)
from repro_torch.launch.mesh import HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16

FX_DIR = os.path.join("results", "fx")
NDEV = {"card": 1, "single": 256, "multi": 512}


def _apply_overrides(cfg, overrides: dict):
    """--override key=value config surgery for perf experiments."""
    if not overrides:
        return cfg
    kw = {}
    for k, v in overrides.items():
        cur = getattr(cfg, k)
        if isinstance(cur, bool):
            kw[k] = v in ("1", "true", "True")
        elif isinstance(cur, int):
            kw[k] = int(v)
        elif isinstance(cur, float):
            kw[k] = float(v)
        else:
            kw[k] = v
    return cfg.replace(**kw)


def _shape(shape) -> ShapeSpec:
    return SHAPES[shape] if isinstance(shape, str) else shape


def _fake_tree(spec, device, dtype_of):
    """Fake tensors (the caller's FakeTensorMode) for a nested dict of
    ParamSpec or (torch.Size, dtype) leaves."""
    if isinstance(spec, dict):
        return {k: _fake_tree(v, device, dtype_of) for k, v in spec.items()}
    shape, dtype = dtype_of(spec)
    return torch.empty(shape, dtype=dtype, device=device)


def trace_cell(arch: str, shape, overrides: dict | None = None, *,
               device="cuda", smoke: bool = False):
    """Trace the right step for one cell (``shape`` a ``SHAPES`` name or a
    ``ShapeSpec``; ``smoke``: the arch's reduced config): the
    ``torch.fx.GraphModule`` of its aten ops, made on fake tensors."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.fx.experimental.proxy_tensor import make_fx

    from repro_torch.models import build_model, layers
    from repro_torch.serve.step import build_decode_step, build_prefill_step
    from repro_torch.train.state import TrainState
    from repro_torch.train.step import build_train_step

    cfg = _apply_overrides(get_smoke(arch) if smoke else get(arch),
                           overrides or {})
    shape = _shape(shape)
    model = build_model(cfg)
    dev = torch.device(device)

    def param_dtype(s):
        return s.shape, getattr(torch, s.dtype or cfg.param_dtype)

    def moment_dtype(s):
        return s.shape, getattr(torch, cfg.moment_dtype)

    with FakeTensorMode():
        params = _fake_tree(model.param_spec(), dev, param_dtype)
        inputs = _fake_tree(model.input_specs(shape), dev, lambda s: s)
        if shape.kind == "train":
            state = TrainState(
                params=params,
                mu=_fake_tree(model.param_spec(), dev, moment_dtype),
                nu=_fake_tree(model.param_spec(), dev, moment_dtype),
                step=torch.empty((), dtype=torch.int32, device=dev),
                rng=torch.empty((2,), dtype=torch.uint32, device=dev))
            _, step = build_train_step(cfg, device=dev)
            fn, args = step, (state, inputs)
        elif shape.kind == "prefill":
            fn = build_prefill_step(cfg, shape.seq_len)
            args = (params, inputs)
        else:
            caches = _fake_tree(model.cache_spec(shape.global_batch,
                                                 shape.seq_len), dev,
                                lambda s: s)
            decode = build_decode_step(cfg)
            pos = shape.seq_len - 1

            def fn(params, caches, tokens):
                return decode(params, caches, tokens, pos)
            args = (params, caches, inputs["tokens"])
    # the rope frequencies are cached per device at first use: a trace
    # must neither read a cached tensor nor leave its fake one behind
    saved = dict(layers._FREQS)
    layers._FREQS.clear()
    try:
        return make_fx(fn, tracing_mode="fake")(*args)
    finally:
        layers._FREQS.clear()
        layers._FREQS.update(saved)


def _local_fake(spec, specs, device, dtype_of, mesh):
    """Fake local shards of a nested dict of spec leaves laid out by the
    same nesting of ``specs`` on ``mesh``."""
    from repro_torch.parallel.sharding import local_shape
    if isinstance(spec, dict):
        return {k: _local_fake(spec[k], specs[k], device, dtype_of, mesh)
                for k in spec}
    shape, dtype = dtype_of(spec)
    return torch.empty(local_shape(shape, specs, mesh), dtype=dtype,
                       device=device)


def trace_sharded(arch: str, shape, mesh, overrides: dict | None = None, *,
                  device="cuda", smoke: bool = False):
    """Rank 0's program of one cell on ``mesh`` (a ``DeviceMesh`` over a
    fake process group): its ``torch.fx.GraphModule``, made on fake local
    shards laid out as the reference's ``lower_cell`` lays the cell
    out."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.fx.experimental.proxy_tensor import make_fx

    from repro_torch.launch.specs import batch_shardings, param_shardings
    from repro_torch.models import build_model, layers
    from repro_torch.models.transformer import mesh_param_specs
    from repro_torch.parallel.sharding import local_shape, use_mesh
    from repro_torch.train.step import build_train_step

    cfg = _apply_overrides(get_smoke(arch) if smoke else get(arch),
                           overrides or {})
    shape = _shape(shape)
    model = build_model(cfg)
    dev = torch.device(device)

    def param_dtype(s):
        return s.shape, getattr(torch, s.dtype or cfg.param_dtype)

    def moment_dtype(s):
        return s.shape, getattr(torch, cfg.moment_dtype)

    b_sh, b_in = batch_shardings(model, shape, mesh)
    bspecs = {k: v.spec for k, v in b_sh.items()}
    with FakeTensorMode():
        inputs = {k: torch.empty(local_shape(v[0], bspecs[k], mesh),
                                 dtype=v[1], device=dev)
                  for k, v in b_in.items()}
        if shape.kind == "train":
            specs = mesh_param_specs(cfg, mesh)
            params = _local_fake(model.param_spec(), specs, dev,
                                 param_dtype, mesh)
            mu = _local_fake(model.param_spec(), specs, dev, moment_dtype,
                             mesh)
            nu = _local_fake(model.param_spec(), specs, dev, moment_dtype,
                             mesh)
            step = torch.empty((), dtype=torch.int32, device=dev)
            _, ts = build_train_step(cfg, device=dev, mesh=mesh)

            def fn(params, mu, nu, step, batch):
                return ts.local_step(params, mu, nu, step, batch, bspecs)
            args = (params, mu, nu, step, inputs)
        else:
            p_sh, _ = param_shardings(model, mesh,
                                      serve=shape.global_batch >= 16)
            specs = _spec_tree(p_sh)
            params = _local_fake(model.param_spec(), specs, dev,
                                 param_dtype, mesh)
            if shape.kind == "prefill":
                def fn(params, batch):
                    with use_mesh(mesh), torch.no_grad():
                        caches, _, logits = model.prefill_local(
                            params, specs, batch, bspecs, shape.seq_len)
                    return caches, logits
                args = (params, inputs)
            else:
                with use_mesh(mesh):
                    cspecs, local = model.cache_specs_on(
                        shape.global_batch, shape.seq_len)
                caches = _fake_tree(local, dev, lambda s: s)
                pos = shape.seq_len - 1

                def fn(params, caches, tokens):
                    with use_mesh(mesh), torch.no_grad():
                        return model.decode_local(
                            params, specs, caches, cspecs, tokens,
                            bspecs["tokens"], pos)
                args = (params, caches, inputs["tokens"])
    saved = dict(layers._FREQS)
    layers._FREQS.clear()
    try:
        return make_fx(fn, tracing_mode="fake")(*args)
    finally:
        layers._FREQS.clear()
        layers._FREQS.update(saved)


def _spec_tree(shardings):
    """The specs of a tree of ``MeshSharding`` leaves."""
    if isinstance(shardings, dict):
        return {k: _spec_tree(v) for k, v in shardings.items()}
    return shardings.spec


def memory_analysis(gm) -> dict:
    """Bytes of the graph's arguments, outputs and outputs that alias an
    argument, and ``temp_bytes``: the peak of live intermediate storage
    over the graph in its order, each storage (views share theirs) freed
    after the last node that uses it. Outputs stay live to the end."""
    from torch.multiprocessing.reductions import StorageWeakRef

    def tensors(val):
        if isinstance(val, torch.Tensor):
            return [val]
        if isinstance(val, (tuple, list)):
            return [t for v in val for t in tensors(v)]
        return []

    def storages(node):
        return {StorageWeakRef(t.untyped_storage()): t.untyped_storage()
                .nbytes() for t in tensors(node.meta.get("val"))}

    nodes = list(gm.graph.nodes)
    args, made, last = {}, {}, {}
    for i, n in enumerate(nodes):
        for ref, nb in storages(n).items():
            if n.op == "placeholder":
                args[ref] = nb
            elif ref not in args and ref not in made:
                made[ref] = (i, nb)
        for a in n.all_input_nodes:
            for ref in storages(a):
                last[ref] = i
    output = nodes[-1]
    outs = [t for a in output.all_input_nodes
            for t in tensors(a.meta.get("val"))]
    out_refs = {StorageWeakRef(t.untyped_storage()) for t in outs}
    events = [0] * (len(nodes) + 1)
    for ref, (i, nb) in made.items():
        events[i] += nb
        if ref not in out_refs:
            events[last.get(ref, i) + 1] -= nb
    live = peak = 0
    for delta in events:
        live += delta
        peak = max(peak, live)
    return {"argument_bytes": sum(args.values()),
            "output_bytes": sum(t.numel() * t.element_size() for t in outs),
            "temp_bytes": peak,
            "alias_bytes": sum(t.numel() * t.element_size() for t in outs
                               if StorageWeakRef(t.untyped_storage())
                               in args)}


def cell_tag(arch: str, shape_name: str, overrides: dict | None,
             smoke: bool = False, mesh: str = "card") -> str:
    tag = f"{arch}_{shape_name}_{mesh}" + ("_smoke" if smoke else "")
    if overrides:
        tag += "__" + "_".join(f"{k}-{v}" for k, v in
                               sorted(overrides.items()))
    return tag


def roofline_terms(hl: dict) -> dict:
    return {"compute_s": hl["flops"] / PEAK_FLOPS_BF16,
            "memory_s": hl["bytes"] / HBM_BW,
            "collective_s": hl["coll"]["total"] / NVLINK_BW}


def run_cell(arch: str, shape, multi_pod: bool = False,
             save_hlo: str | None = None, overrides: dict | None = None,
             *, device="cuda", smoke: bool = False,
             mesh: str | None = None, device_mesh=None) -> dict:
    """The reference's result dict for one cell (``shape`` a ``SHAPES``
    name or a ``ShapeSpec``, whose fields are then kept under
    ``shape_spec``); ``smoke`` traces the arch's reduced config (at the
    cell's shapes). ``mesh``: "card" (one card, the default), "single" or
    "multi" (the reference's production meshes; ``multi_pod`` means
    "multi"); ``device_mesh`` traces rank 0 of that mesh instead (labelled
    by its shape)."""
    from repro_torch.launch.mesh import make_production_mesh
    mesh = mesh or ("multi" if multi_pod else "card")
    spec = _shape(shape)
    if device_mesh is not None:
        mesh = "x".join(str(n) for n in device_mesh.shape)
    ok, why = cell_applicable(arch, spec.name)
    if not ok:
        return {"arch": arch, "shape": spec.name, "mesh": mesh,
                "status": "skipped", "reason": why}
    t0 = time.time()
    if mesh == "card":
        gm = trace_cell(arch, spec, overrides, device=device, smoke=smoke)
        ndev = 1
    else:
        dm = device_mesh or make_production_mesh(multi_pod=mesh == "multi")
        gm = trace_sharded(arch, spec, dm, overrides, device=device,
                           smoke=smoke)
        ndev = dm.size()
    t_trace = time.time() - t0
    from repro_torch.launch.hlo_analysis import analyze
    text = gm.print_readable(print_output=False)
    if save_hlo:
        with open(save_hlo, "w") as f:
            f.write(text)
    # always archive the graph text so the analysis can be re-derived
    # offline without tracing again
    from repro_torch.utils.codec import Compressor
    os.makedirs(FX_DIR, exist_ok=True)
    with open(os.path.join(FX_DIR, cell_tag(arch, spec.name, overrides,
                                            smoke, mesh) + ".fx.zst"),
              "wb") as f:
        f.write(Compressor(level=9).compress(text.encode()))
    hl = analyze(text)
    result = {
        "arch": arch,
        "shape": spec.name,
        "mesh": mesh,
        "status": "ok",
        "ndev": ndev,
        "trace_s": round(t_trace, 2),
        "graph_nodes": len(gm.graph.nodes),
        # per-device numbers (launch/hlo_analysis.py)
        "flops_per_device": hl["flops"],
        "bytes_accessed_per_device": hl["bytes"],
        "collective_bytes_per_device": dict(hl["coll"]),
        "collective_counts": dict(hl["coll_counts"]),
        "memory": memory_analysis(gm),
        # per-device roofline terms (seconds) from the data-sheet peaks
        "roofline": roofline_terms(hl),
    }
    if smoke:
        result["smoke"] = True
    if spec.name not in SHAPES:
        result["shape_spec"] = {"kind": spec.kind, "seq_len": spec.seq_len,
                                "global_batch": spec.global_batch}
    return result


def cell_or_error(arch: str, shape: str, save_hlo, overrides, device,
                  smoke, mesh: str = "card") -> dict:
    """``run_cell``, with an exception reported as a ``status: "error"``
    result (the run goes on to the next cell)."""
    try:
        return run_cell(arch, shape, save_hlo=save_hlo, overrides=overrides,
                        device=device, smoke=smoke, mesh=mesh)
    except Exception as e:  # noqa: BLE001 — report and continue
        return {"arch": arch, "shape": shape, "mesh": mesh,
                "status": "error", "error": f"{type(e).__name__}: {e}"}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true",
                    help="rank 0 of the (2, 16, 16) production mesh")
    ap.add_argument("--both-meshes", action="store_true",
                    help="rank 0 of the (16, 16) and (2, 16, 16) meshes")
    ap.add_argument("--all", action="store_true", help="all (arch x shape) cells")
    ap.add_argument("--out", default=None, help="write JSON results here")
    ap.add_argument("--save-hlo", default=None,
                    help="write the traced graph's text here")
    ap.add_argument("--override", action="append", default=[],
                    help="config override key=value (repeatable)")
    ap.add_argument("--device", default="cuda",
                    help="device of the fake tensors (default cuda)")
    ap.add_argument("--smoke", action="store_true",
                    help="the archs' reduced configs (at the cells' shapes)")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells traced side by side, each in a worker "
                         "process of its own")
    args = ap.parse_args(argv)
    overrides = dict(kv.split("=", 1) for kv in args.override)
    meshes = (["single", "multi"] if args.both_meshes
              else ["multi"] if args.multi_pod else ["card"])

    archs = list_archs() if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    cells = [(arch, shape, mesh) for arch in archs for shape in shapes
             for mesh in meshes]
    work = [(arch, shape, args.save_hlo, overrides, args.device, args.smoke,
             mesh) for arch, shape, mesh in cells]
    if args.jobs > 1:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor
        pool = ProcessPoolExecutor(
            args.jobs, mp_context=multiprocessing.get_context("spawn"),
            max_tasks_per_child=1)
        pending = [pool.submit(cell_or_error, *w) for w in work]
        outcomes = (f.result() for f in pending)
    else:
        pool = None
        outcomes = (cell_or_error(*w) for w in work)
    results = []
    for (arch, shape, mesh), r in zip(cells, outcomes):
        print(f"=== {arch} x {shape} x {mesh} ({NDEV[mesh]} "
              f"{'card' if mesh == 'card' else 'ranks'}) ===", flush=True)
        print(json.dumps(r, indent=1, default=str), flush=True)
        results.append(r)
    if pool is not None:
        pool.shutdown()
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1, default=str)
    bad = [r for r in results if r["status"] == "error"]
    sys.exit(1 if bad else 0)


if __name__ == "__main__":
    main()
