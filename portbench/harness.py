"""One run of one cell: set-up, the measured window, the readings, the check.

A cell (``BENCHMARK.json``'s ``workloads`` entry) names a configuration and a
traffic mix; the harness finds ``configs/<config>.json``,
``traffic/<traffic>.json``, ``limits/<cell>.json`` and each metric's reader
``metrics/<metric>.py`` beside this file by those names, so a new cell,
configuration, mix or metric is new files and entries, never an edit.

The run is the paper's hands-on record loop on the program: a
``flor.Session`` in record mode, a ``checkpointing`` scope holding the
TrainState, an outer "epochs" loop and an inner "train" loop that calls the
program's train step and ``flor.log``s the step's scalars. Set-up makes the
weights from the seed, loads the program's CUDA kernels, opens the session
and runs the first epoch: the mix's ``check_steps`` steps, from which the
check takes its readings and which the reference follows (in a model with
routed experts, through the program's own choices: ``RouteCapture``,
which only those steps run). The window is a
closed loop of whole epochs (the next step starts when the last returns)
until ``--seconds`` have passed; the rate is the tokens of every step in it
over its whole length. ``--trace 1`` adds a span around each step (ended by
a synchronize) and profiles one whole epoch of the window on the device.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import torch

from portbench import check, flops, tokens
from portbench.trace import Tracer
from portbench.reference import model as ref
from portbench.weights import make_params, zeros_like_params

HERE = os.path.dirname(os.path.abspath(__file__))
MAX_EPOCHS = 1 << 20
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class Cell:
    """A cell's entry and the files it names."""

    def __init__(self, bench_path: str, name: str, here: str = HERE):
        with open(bench_path) as f:
            self.bench = json.load(f)
        by_name = {w["name"]: w for w in self.bench["workloads"]}
        if name not in by_name:
            raise KeyError(f"no workload {name!r} in {bench_path}")
        self.entry = by_name[name]
        self.name = name
        self.conf = _json(here, "configs", self.entry["config"])
        self.mix = _json(here, "traffic", self.entry["traffic"])
        self.limits = _json(here, "limits", name)
        self.dims = ref.dims(self.conf)
        self.here = here

    def metrics(self, trace_on: bool) -> list[dict]:
        """The metric entries this cell reports in such a run."""
        e2e = [m for m in self.bench["end_to_end"]
               if self.name in m.get("workloads", [self.name])]
        if not trace_on:
            return e2e
        names = {m["name"] for m in e2e}
        return [m for m in self.bench["per_layer"]
                if self.name in m.get("workloads", [self.name])
                and m["moves"] in names]

    def reader(self, metric: str):
        path = os.path.join(self.here, "metrics", metric + ".py")
        spec = importlib.util.spec_from_file_location(
            "portbench_metric_" + metric.replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


def _json(here, folder, name):
    with open(os.path.join(here, folder, name + ".json")) as f:
        return json.load(f)


def port_config(conf: dict):
    """The program's ModelConfig of a configuration file."""
    from repro_torch.configs.base import ModelConfig, MoEConfig

    m = ref.dims(conf)
    run = dict(conf["run"])
    cf = run.pop("capacity_factor", 1.25)
    moe = None
    if m["E"]:
        moe = MoEConfig(num_experts=m["E"], top_k=m["k"], d_ff_expert=m["f"],
                        router="softmax", capacity_factor=cf,
                        router_aux_loss=m["aux_coef"])
    return ModelConfig(
        name=conf["name"], family="moe" if moe else "dense",
        num_layers=m["L"], d_model=m["d"], num_heads=m["H"],
        num_kv_heads=m["KV"], d_ff=m["f"], vocab_size=m["V"],
        head_dim=m["hd"], ffn_activation="swiglu",
        sliding_window=m["window"], rope_theta=m["theta"],
        tie_embeddings=m["tied"], norm_eps=m["eps"], moe=moe, **run)


class Feed:
    """The token ids of each step, made from the seed and sent to the
    device ahead of the step (pinned host memory, an async copy)."""

    def __init__(self, mix: dict, vocab: int, seed: int, device):
        self.mix, self.vocab, self.seed = mix, vocab, seed
        self.device = torch.device(device)

    def __call__(self, step: int) -> dict:
        t = torch.from_numpy(tokens.step_tokens(
            self.mix["tokens"], self.vocab, self.mix["batch"],
            self.mix["seq"], self.seed, step))
        if self.device.type == "cuda":
            t = t.pin_memory().to(self.device, non_blocking=True)
        return {"tokens": t}


def warm_kernels(device):
    """Build (first run in a checkout) or load the program's CUDA kernels
    and launch each record kernel once, so that neither lands in the
    window, should the controller take a checkpoint there."""
    from repro_torch.kernels import ops

    x = torch.arange(1 << 16, dtype=torch.float32, device=device)
    d = ops.fingerprint_leaf(x)
    ops.fingerprint_and_changed(x + 1, d)
    idx = torch.zeros(1, dtype=torch.int64, device=device)
    ops.gather_changed_blocks(x, idx)
    ops.gather_quantize_blocks(x, idx)
    ops.gather_quantize4_blocks(x, idx)
    torch.cuda.synchronize(device)


class RouteCapture:
    """The choices of each MoE layer in each step of set-up's first epoch,
    as the program's ``repro_torch.models.moe.route`` hands them to the
    layer, which uses them. Within a step a layer, known by the router
    weight it was called with, keeps its first call's choices: its forward.
    A later call of that layer in the step is its recompute (remat), and
    one whose choices differ from the forward's by a bit counts in
    ``mismatch``, since the backward follows the recompute's. ``stop`` puts
    the program's function back, so the window runs it untouched."""

    def __init__(self):
        from repro_torch.models import moe

        self.moe, self.route = moe, moe.route
        self.steps, self.mismatch = [], 0
        self.wrapper = self._route
        moe.route = self.wrapper

    def _route(self, cfg, router_w, x_flat):
        w, ids, aux = self.route(cfg, router_w, x_flat)
        if self.steps:
            layers = self.steps[-1]
            key = (router_w.data_ptr(), tuple(router_w.shape))
            if key not in layers:
                layers[key] = ids.detach().clone()
            elif not torch.equal(layers[key], ids):
                self.mismatch += 1
        return w, ids, aux

    def step(self):
        """The calls from here on are the next step's."""
        self.steps.append({})

    def stop(self):
        if self.moe.route is self.wrapper:
            self.moe.route = self.route

    def routes(self, layers: int, tokens: int, k: int):
        """Each step's choices [tokens, k], layer by layer in the order of
        the forward; None unless every step called each of ``layers``
        layers with that shape."""
        out = [list(step.values()) for step in self.steps]
        ok = out and all(len(r) == layers and all(
            tuple(ids.shape) == (tokens, k) for ids in r) for r in out)
        return out if ok else None


def _leaf_norms(tree) -> dict:
    return {k: v for p, x in ref.leaves(tree)
            for k, v in ref.leaf_norms(p, x).items()}


def _change_norms(conf, params, seed, device) -> dict:
    p0 = dict(ref.leaves(make_params(conf, seed, device)))
    out = {k: v for p, x in ref.leaves(params)
           for k, v in ref.leaf_norms(p, x - p0[p]).items()}
    del p0
    return out


def _floats(d: dict) -> dict:
    return {k: float(v) for k, v in d.items()}


def _state_path_bytes(state) -> dict:
    """{manifest path: host bytes} of every leaf of the TrainState that the
    checkpointing scope holds as its slot "state"."""
    out = {}
    for field in ("params", "mu", "nu"):
        for path, x in ref.leaves(getattr(state, field)):
            key = f"['state'].{field}" + "".join(f"['{k}']"
                                                 for k in path.split("/"))
            out[key] = x
    out["['state'].step"], out["['state'].rng"] = state.step, state.rng
    return {k: _host_bytes(v) for k, v in out.items()}


def _host_bytes(t: torch.Tensor) -> bytes:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().tobytes()


def run_cell(bench_path: str, name: str, seed: int, seconds: float,
             trace_on: bool, device: str, t_start: float,
             here: str = HERE, wrap_step=None, log=print,
             diag: dict | None = None) -> dict:
    """One run; returns the result line's object. ``wrap_step(train_step)``
    may replace the program's step (the checks' fault tests); ``diag``, if
    given, receives the program's and the reference's readings."""
    from repro_torch import flor
    from repro_torch.models.params import shape_tree
    from repro_torch.models.transformer import lm_param_spec
    from repro_torch.train.state import TrainState
    from repro_torch.train.step import build_train_step

    marks = [("imports", time.perf_counter())]
    cell = Cell(bench_path, name, here)
    mix, conf, m = cell.mix, cell.conf, cell.dims
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    B, S = mix["batch"], mix["seq"]
    # set-up's epoch is the steps the reference follows
    warm, spe = mix["check_steps"], mix["steps_per_epoch"]
    cfg = port_config(conf)
    if on_card:
        warm_kernels(dev)
    marks.append(("kernels", time.perf_counter()))
    _, train_step = build_train_step(cfg, device=dev)
    if wrap_step is not None:
        train_step = wrap_step(train_step)

    params = make_params(conf, seed, dev)
    want = {p: tuple(s) for p, s in ref.leaves(shape_tree(lm_param_spec(cfg)))}
    have = {p: tuple(x.shape) for p, x in ref.leaves(params)}
    if want != have:
        raise ValueError(f"weights do not fit the program's tree: {want} "
                         f"!= {have}")
    rng = torch.tensor([seed % (1 << 32), 0], dtype=torch.int64) \
        .to(torch.uint32)
    state = TrainState(params=params, mu=zeros_like_params(params),
                       nu=zeros_like_params(params),
                       step=torch.zeros((), dtype=torch.int32, device=dev),
                       rng=rng.to(dev))
    del params
    _sync(dev)
    marks.append(("step and weights", time.perf_counter()))
    feed = Feed(mix, m["V"], seed, dev)
    log_keys = mix["log_keys"]
    probes = mix.get("tensor_probes") or {}
    kept, readings, epochs = [], {}, []
    tracer = Tracer(trace_on and on_card)
    base = tempfile.gettempdir()
    run_dir = tempfile.mkdtemp(prefix="portbench-", dir=base)
    capture = RouteCapture() if m["E"] else None
    try:
        with flor.Session(run_dir, mode="record",
                          record=flor.RecordSpec(**mix["record"])) as sess:
            store_root = sess.store_root
            with sess.checkpointing(state=state) as ckpt:
                del state
                marks.append(("session", time.perf_counter()))
                step = 0
                for epoch in sess.loop("epochs", range(MAX_EPOCHS)):
                    n = warm if epoch == 0 else spe
                    rec = {"steps": n, "spans": [], "data_s": 0.0,
                           "profiled": tracer.enabled and epoch == 1}
                    if rec["profiled"]:
                        tracer.start()
                    for _ in sess.loop("train", range(n)):
                        t0 = time.perf_counter()
                        batch = feed(step)
                        if capture is not None and epoch == 0:
                            capture.step()
                        t1 = time.perf_counter()
                        with tracer.span("portbench.step"):
                            ckpt.state, out = train_step(ckpt.state, batch)
                            if trace_on:
                                _sync(dev)
                        t2 = time.perf_counter()
                        with tracer.span("portbench.log"):
                            for key in log_keys:
                                if key in out:
                                    sess.log(key, out[key])
                            for i, leaf in enumerate(
                                    _probe_leaves(ckpt.state.params, probes)):
                                sess.log(f"probe{i}", leaf)
                        step += 1
                        kept.append({k: out[k] for k in log_keys if k in out})
                        rec["data_s"] += t1 - t0
                        rec["spans"].append(t2 - t1)
                        if step == 1:
                            readings["grad"] = {
                                p: v / (1 - ref.B1) for p, v in
                                _leaf_norms(ckpt.state.mu).items()}
                        if step == warm:
                            readings["change"] = _change_norms(
                                conf, ckpt.state.params, seed, dev)
                    if rec["profiled"]:
                        tracer.stop()
                    _sync(dev)
                    now = time.perf_counter()
                    if epoch == 0:
                        if capture is not None:
                            capture.stop()
                        setup_s = now - t_start
                        marks.append(("first epoch", now))
                        first_window_step = step
                        if on_card:
                            setup_peak = torch.cuda.max_memory_allocated(dev)
                            torch.cuda.reset_peak_memory_stats(dev)
                        t_w0 = t_prev = now
                        continue
                    rec["wall_s"], t_prev = now - t_prev, now
                    epochs.append(rec)
                    if _window_done(epochs, now - t_w0, seconds,
                                    tracer.enabled):
                        break
                window_peak = torch.cuda.max_memory_allocated(dev) \
                    if on_card else None
                blk = sess.ctx.controller.blocks.get("train")
                final = _state_path_bytes(ckpt.state) \
                    if blk is not None and blk.k + blk.pending else None
                ckpt.state = None
        # the session has closed: its log writer has flushed
        values = [{k: float(v) for k, v in d.items()} for d in kept]
        del kept
        log_rows = flor.log_records(store_root, key=tuple(log_keys))
        ckpt_bad, n_ckpt = check.check_checkpoints(
            store_root, final, last_epoch=epoch,
            bounds=mix["record"].get("ckpt_error_bounds"))
    finally:
        if capture is not None:
            capture.stop()
        shutil.rmtree(run_dir, ignore_errors=True)
    del train_step, final
    gc.collect()
    profiled = tracer.summary() if tracer.enabled else None
    window_steps = step - first_window_step
    # a traced run's spans and rates leave out the profiled epoch
    timed = [e for e in epochs if not e["profiled"]]
    profiled_steps = sum(e["steps"] for e in epochs if e["profiled"])
    info = _device_info(dev) if on_card else {}
    run = {
        "on_card": on_card, "trace": trace_on, "setup_s": setup_s,
        "window_s": sum(e["wall_s"] for e in timed),
        "window_steps": sum(e["steps"] for e in timed),
        "profiled_steps": profiled_steps,
        "window_tokens": sum(e["steps"] for e in timed) * B * S,
        "step_spans_s": [s for e in timed for s in e["spans"]],
        "data_s": sum(e["data_s"] for e in timed),
        "step_flops": flops.step_flops(m, B, S),
        "peak_flops": flops.BF16_PEAK_FLOPS.get(info.get("kind")),
        "window_peak_bytes": window_peak,
        "moe_dropped": [v["moe_dropped"] for v in values[first_window_step:]
                        if "moe_dropped" in v],
        "profile": profiled,
    }
    failed = sum(1 for v in values[first_window_step:]
                 if not all(math.isfinite(x) for x in v.values()))

    # ---- the check: the reference follows the first steps -------------
    if on_card:
        torch.cuda.empty_cache()
    prog = {
        "loss": [v["loss"] for v in values[:warm]],
        "grad": _floats(readings["grad"]),
        "change": _floats(readings["change"]),
        "dropped": [v.get("moe_dropped") for v in values[:warm]],
    }
    # a sparse model's reference follows the program's own choices
    routes = None
    if capture is not None:
        routes = capture.routes(m["L"], B * S, m["k"])
        prog["route_mismatch"] = capture.mismatch
        if routes is None:
            log(f"no choices to follow: {[len(r) for r in capture.steps]} "
                f"layers a step captured, of {m['L']}")
    t_ref = time.perf_counter()
    refr = reference_readings(conf, mix, seed, dev, "float32", routes=routes)
    t_ref = time.perf_counter() - t_ref
    numbers = check.numbers(prog, refr)
    if capture is not None and routes is None:
        numbers["route_gap"] = numbers["route_miss_share"] = None
    if diag is not None:
        diag.update(prog=prog, ref=refr, routes=routes)
    for key, gaps in check.leaf_gaps(prog, refr).items():
        worst = sorted(gaps.items(), key=lambda kv: -kv[1])[:3]
        log(f"{key} gaps, worst leaves: "
            + ", ".join(f"{p} {g:.3e}" for p, g in worst))
    log(f"losses: program {prog['loss']} reference {refr['loss']}")
    numbers["log_mismatch"] = check.log_mismatch(log_rows, values, log_keys)
    numbers["ckpt_mismatch"] = ckpt_bad
    verdict = check.judge(numbers, cell.limits)

    # ---- the result line ---------------------------------------------------
    metrics = {}
    for entry in cell.metrics(trace_on):
        if not on_card and entry["source"] != "program_counter":
            continue
        value = cell.reader(entry["name"])(run)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    result = {"correct": verdict["correct"], "attempted": window_steps,
              "failed": failed, "metrics": metrics}
    if on_card:
        result["device"] = {
            "platform": "gpu", "kind": info["kind"], "count": 1,
            "memory_peak_bytes": max(setup_peak, window_peak),
            "power_limit_w": info.get("power_limit_w")}
        if trace_on:
            result["device"].update(busy_s=profiled["busy_s"],
                                    window_s=profiled["window_s"])
            result["breakdown"] = {"device_ops": profiled["device_ops"],
                                   "idle_gaps": profiled["idle_gaps"]}
    else:
        result["device"] = {"platform": "cpu", "kind": "cpu", "count": 0,
                            "memory_peak_bytes": 0}
    result["checks"] = verdict["checks"]
    t_prev = t_start
    phases = []
    for what, t in marks:
        phases.append(f"{what} {t - t_prev:.3f}")
        t_prev = t
    log("set-up, s: " + ", ".join(phases))
    log(f"cell {name} seed {seed}: {window_steps} window steps in "
        f"{sum(e['wall_s'] for e in epochs):.3f} s, {n_ckpt} checkpoints, "
        f"setup {setup_s:.3f} s, "
        f"reference {t_ref:.3f} s; device {info}")
    return result


def _window_done(epochs: list, elapsed: float, seconds: float,
                 traced: bool) -> bool:
    """Whether the window ends after the epochs so far: the number of whole
    epochs nearest to ``seconds`` (at least one; a traced run profiles its
    first and times the rest, so at least two)."""
    if traced and len(epochs) < 2:
        return False
    return elapsed + 0.5 * elapsed / len(epochs) >= seconds


def _probe_leaves(params, probes: dict):
    """The mix's tensor probes: the first ``numel`` elements of each of the
    ``count`` largest parameter leaves."""
    if not probes:
        return []
    big = sorted((x for _, x in ref.leaves(params)), key=lambda x: -x.numel())
    return [x.reshape(-1)[:probes["numel"]] for x in big[:probes["count"]]]


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _device_info(dev) -> dict:
    info = {"kind": torch.cuda.get_device_name(dev)}
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={dev.index or 0}",
             "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30, check=True)
        info["power_limit_w"] = float(out.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        info["power_limit_w"] = None
    return info


def reference_readings(conf, mix, seed, dev, precision, tokens_fn=None,
                       routes=None):
    """The reference's readings over the mix's first ``check_steps`` steps
    from the seed's weights and ids: losses, the first step's clipped gradient
    norm of each leaf, each leaf's change over the steps, the MoE drops, and
    of a sparse model each step's route gap and route miss share and each
    layer's own ranking of the experts. ``routes[s][i]``, where given, are
    the choices that layer ``i`` follows in step ``s``; ``tokens_fn(step)``
    may replace the ids (a fault: half a batch)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    feed = Feed(mix, ref.dims(conf)["V"], seed, dev)
    params = make_params(conf, seed, dev)
    state = {"params": params, "mu": zeros_like_params(params),
             "nu": zeros_like_params(params)}
    del params
    losses, drops, gaps, misses, ranks, grad = [], [], [], [], [], None
    for s in range(mix["check_steps"]):
        toks = tokens_fn(s) if tokens_fn else feed(s)["tokens"]
        loss, met, gnorms = ref.train_step(
            conf, state, s, toks, precision,
            routes=None if routes is None else routes[s])
        losses.append(float(loss))
        sparse = "moe_dropped" in met
        drops.append(float(met["moe_dropped"]) if sparse else None)
        gaps.append(float(met["route_gap"]) if sparse else None)
        misses.append(float(met["route_miss"]) if sparse else None)
        ranks.append(met.get("ranks"))
        grad = grad or gnorms
    change = _floats(_change_norms(conf, state["params"], seed, dev))
    del state
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return {"loss": losses, "grad": grad, "change": change,
            "dropped": drops, "route_gap": gaps, "route_miss": misses,
            "ranks": ranks}


def forbidden_modules() -> list[str]:
    """Modules of the JAX stack or the JAX package loaded in this process
    (top-level names compared whole)."""
    return sorted({n.split(".")[0] for n in list(sys.modules)}
                  & set(FORBIDDEN))
