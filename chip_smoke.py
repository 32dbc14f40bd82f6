#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--kernels-only]

Run from a checkout on a machine with one NVIDIA H100. Phases:

1. the card (``nvidia-smi`` name and power limit) and the build of the
   hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``;
2. kernel phases: each of the four checkpoint kernels against its plain
   torch version (``kernels/ref.py``) on the card, on seeded inputs —
   the leaves of the full florbench-100m TrainState (its own ``init_state``,
   with seeded moment values), odd-length bf16/f16/uint8/int64/bool
   leaves, a scalar leaf, 0xFFFFFFFF and all-zero rows, exact .5 ties,
   C=1 and partial last rows. Digests and masks must match bit for bit,
   q8/q4 payloads and scales byte for byte. Then, at the main path's
   shapes, each kernel's device time beside its plain version's and its
   bound, and the host-inclusive time of the pass (``time_calls``);
3. a small-input model check: the same weights on the CPU and the card
   give the same loss;
4. main path A: ``repro_torch.launch.train.main`` at the full
   florbench-100m width (batch 8, seq 512, 3 epochs x 3 steps, every epoch
   checkpointed), then a restore of the last checkpoint that must equal the
   live state bit for bit;
5. main path B: ``flor.Session`` at the same width (2 epochs x 3 steps)
   with ``RecordSpec(ckpt_error_bounds={"mu": 1e-2, "nu": 1e-3},
   ckpt_overlap=True)``; ``mu``/``nu`` restore within their bounds, every
   other leaf bit for bit. At these bounds the selector stores every
   moment chunk as q4, so the q8 kernel does not run here;
6. main path C: the same Session with tight bounds
   (``TIGHT_BOUNDS``, 1 epoch x 3 steps), at which the selector splits
   the moment chunks between q4, q8 and raw, checked as in B;
7. a ``kernels`` JSON line (launches in phases 4-6, times, bounds), the
   card line, and last the JSON line ``{"ok": true, "device": {...}}``.

Any failed phase exits non-zero before the last line is printed. The run
directories live under ``build/chip_smoke`` (git-ignored) and are removed at
the end.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")
F32_OPS_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
SEED = 0
BATCH, SEQ, EPOCHS, STEPS = 8, 512, 3, 3
# path B takes one full and one delta checkpoint, path C one full; each
# full-width checkpoint costs about a minute on the writer thread
B_EPOCHS, C_EPOCHS = 2, 1
B_BOUNDS = {"mu": 1e-2, "nu": 1e-3}
# selector bands per chunk: q4 if absmax <= 13.5 atol, q8 if <= 126 atol,
# else raw; these put the measured moment amplitudes across all three
TIGHT_BOUNDS = {"mu": 1e-5, "nu": 1e-8}


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str):
    print(msg, flush=True)


def peak_hbm(name: str) -> tuple[float, str]:
    """Peak device-memory rate by card name (NVIDIA data sheets)."""
    if "NVL" in name:
        return 3.9e12, "H100 NVL 3.9 TB/s"
    if "PCIe" in name:
        return 2.0e12, "H100 PCIe 2.0 TB/s"
    return 3.35e12, "H100 SXM 3.35 TB/s"


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi exited {out.returncode}: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def time_calls(torch, calls, reps: int = 5) -> dict:
    """Times one pass of ``calls`` (one kernel or plain version per leaf):

    - ``ms``: the card's time, no host gaps: the durations of the device
      activities (kernels, copies) that the pass launched, as
      ``torch.profiler`` (CUPTI) records them, summed; mean over ``reps``
      passes;
    - ``pass_ms``: CUDA events around the pass as the host issues it, host
      dispatch included — what a checkpoint waits (median);
    - ``dispatch_us``: host time to issue one call (wrapper, allocation,
      launch; median)."""
    from torch.profiler import ProfilerActivity, profile

    for c in calls:
        c()
    torch.cuda.synchronize()
    whole, disp = [], []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        for c in calls:
            c()
        disp.append((time.perf_counter() - t0) / len(calls) * 1e6)
        end.record()
        end.synchronize()
        whole.append(start.elapsed_time(end))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            for c in calls:
                c()
        torch.cuda.synchronize()
    dev_us = sum(e.device_time for e in prof.events()
                 if e.device_type.name == "CUDA")
    if not dev_us > 0:
        fail("torch.profiler recorded no device time for a timed pass")
    return {"ms": dev_us / reps / 1e3, "pass_ms": statistics.median(whole),
            "dispatch_us": statistics.median(disp)}


def sync(torch, dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def bits_equal(torch, a, b) -> bool:
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        view = {2: torch.int16, 4: torch.int32, 8: torch.int64}[
            a.element_size()]
        return torch.equal(a.contiguous().view(view),
                           b.contiguous().view(view))
    return torch.equal(a, b)


def max_abs_diff(torch, a, b) -> float:
    if a.numel() == 0:
        return 0.0
    return float((a.to(torch.float64) - b.to(torch.float64)).abs().max())


# --------------------------------------------------------------- inputs --
def state_leaves(torch, cfg, gen, dev):
    """[(path, leaf)] of the florbench-100m TrainState as the port's own
    ``init_state`` lays it out, with the moments (zero at init) replaced by
    seeded values of amplitude 1e-3 at their real shapes and dtypes."""
    from repro_torch.train.step import build_train_step
    from repro_torch.utils.pytree import keystr, tree_flatten_with_path

    init_state, _ = build_train_step(cfg, device=dev)
    flat, _ = tree_flatten_with_path(init_state(SEED))
    out = []
    for path, x in flat:
        p = keystr(path)
        if p.startswith((".mu", ".nu")):
            x = 1e-3 * torch.randn(x.shape, generator=gen, device=dev,
                                   dtype=x.dtype)
        out.append((p, x))
    return out


def edge_fp_leaves(torch, gen, dev):
    W = 16384
    return [
        ("scalar int32", torch.tensor(7, dtype=torch.int32, device=dev)),
        ("bf16 odd 40001", torch.randn(40001, generator=gen, device=dev)
         .to(torch.bfloat16)),
        ("f16 odd 33333 (negatives)", -torch.rand(33333, generator=gen,
                                                  device=dev).half()),
        ("uint8 odd 70001", torch.randint(0, 256, (70001,), generator=gen,
                                          device=dev, dtype=torch.uint8)),
        ("int64 odd 12345", torch.randint(-2 ** 62, 2 ** 62, (12345,),
                                          generator=gen, device=dev,
                                          dtype=torch.int64)),
        ("bool 999", torch.randint(0, 2, (999,), generator=gen, device=dev)
         .bool()),
        ("0xFFFFFFFF rows", torch.full((3 * W + 5,), -1, dtype=torch.int32,
                                       device=dev)),
        ("all-zero rows", torch.zeros(2 * W, device=dev)),
    ]


def tie_rows(torch, dev, q4: bool, W: int = 16384):
    """Rows whose every element divides by its block scale to an exact
    k + 0.5 (round-half-even decides the byte), at scales 1 and 2."""
    qmax = 7.0 if q4 else 127.0
    j = torch.arange(W, device=dev, dtype=torch.float32)
    span = 2 * int(qmax)
    halves = torch.remainder(j, span) - qmax + 0.5      # -qmax+.5 .. qmax-.5
    halves[::256] = qmax                                # block absmax
    return torch.cat([halves, 2.0 * halves])            # scale 1, scale 2


def edge_q_cases(torch, gen, dev):
    """[(name, leaf, idx, chunk_words)] for the gather-quantize kernels."""
    W = 16384
    cases = []
    x = 1e-3 * torch.randn(5 * W + 777, generator=gen, device=dev)
    g = 6
    cases.append(("f32 partial last row, C=1", x,
                  torch.tensor([g - 1], device=dev), W))
    cases.append(("f32 random rows", x,
                  torch.tensor([4, 0, 2], device=dev), W))
    cases.append(("bf16 odd 50001", torch.randn(50001, generator=gen,
                                               device=dev).bfloat16(),
                  torch.arange(4, device=dev), W))
    cases.append(("f16 odd 40003", torch.randn(40003, generator=gen,
                                              device=dev).half(),
                  torch.arange(3, device=dev), W))
    cases.append(("all-zero rows", torch.zeros(3 * W + 100, device=dev),
                  torch.arange(4, device=dev), W))
    cases.append(("chunk_words 1024", x, torch.arange(0, 81, 4,
                                                      device=dev), 1024))
    cases.append(("chunk_words 64", x[:1000], torch.arange(16, device=dev),
                  64))
    return cases


# --------------------------------------------------------- kernel phase --
def kernel_phase(torch, dev, hbm_bps, cfg):
    from repro_torch.checkpoint.pipeline import PIPELINE_CHUNK_WORDS as CW
    from repro_torch.checkpoint.pipeline import _fp_view
    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device=dev).manual_seed(SEED)
    state = state_leaves(torch, cfg, gen, dev)
    moments = [(p, x) for p, x in state if p.startswith((".mu", ".nu"))]
    results = {}

    # ---- fingerprint / fingerprint_changed: bit-exact digests and masks
    err_fp = err_fpc = 0.0
    n_cases = 0
    fp_cases = [(p, _fp_view(x), CW) for p, x in state] \
        + [(p, _fp_view(x), cw) for p, x in edge_fp_leaves(torch, gen, dev)
           for cw in (CW, 1024)]
    for name, x, cw in fp_cases:
        blocks = ops._as_u32_blocks(x, cw)
        d_ref = ref.fingerprint_ref(blocks)
        d = ops.fingerprint_leaf(x, cw)
        if not bits_equal(torch, d, d_ref):
            fail(f"fingerprint digest differs from the plain version on "
                 f"{name} (chunk_words {cw})")
        err_fp = max(err_fp, max_abs_diff(torch, d, d_ref))
        prev = d_ref.clone()
        prev[::3, 0] ^= 1                         # every third row changed
        prev[1::5, 1] ^= -1
        d2, m2 = ops.fingerprint_and_changed(x, prev, cw)
        d2_ref, m2_ref = ref.fingerprint_changed_ref(blocks, prev)
        if not (bits_equal(torch, d2, d2_ref)
                and bits_equal(torch, m2, m2_ref)):
            fail(f"fingerprint_changed differs from the plain version on "
                 f"{name} (chunk_words {cw})")
        if not bool(m2.any()) or bool(m2.all()) and m2.numel() > 2:
            fail(f"fingerprint_changed mask degenerate on {name}")
        err_fpc = max(err_fpc, max_abs_diff(torch, d2, d2_ref),
                      max_abs_diff(torch, m2, m2_ref))
        n_cases += 1
    say(f"kernel fingerprint / fingerprint_changed: {n_cases} leaves "
        f"bit-exact vs plain (max_abs_err {err_fp} / {err_fpc})")

    # timing at the main path's shapes: one checkpoint's pass over all 32
    # TrainState leaves at the pipeline's 64 KiB chunks
    views = [_fp_view(x) for _, x in state]
    prevs = [ops.fingerprint_leaf(v, CW) for v in views]
    blocks_all = [ops._as_u32_blocks(v, CW) for v in views]
    leaf_bytes = sum(v.numel() * v.element_size() for v in views)
    dig_bytes = sum(p.numel() * 4 for p in prevs)
    words = sum(v.numel() * v.element_size() // 4 for v in views)

    def bound(nbytes, ops_n):
        t_bytes = nbytes / hbm_bps * 1e3
        t_ops = ops_n / F32_OPS_PER_S * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops,
                                                            "operations")

    def timed(kernel_calls, plain_calls, nbytes, ops_n, err):
        t = time_calls(torch, kernel_calls)
        b, by = bound(nbytes, ops_n)
        return dict(max_abs_err=err, ms=t["ms"], pass_ms=t["pass_ms"],
                    dispatch_us=t["dispatch_us"],
                    plain_ms=time_calls(torch, plain_calls, reps=3)["ms"],
                    bound_ms=b, bound_by=by)

    results["fingerprint"] = timed(
        [lambda v=v: ops.fingerprint_leaf(v, CW) for v in views],
        [lambda b=b: ref.fingerprint_ref(b) for b in blocks_all],
        leaf_bytes + dig_bytes, 8 * words, err_fp)
    results["fingerprint_changed"] = timed(
        [lambda v=v, p=p: ops.fingerprint_and_changed(v, p, CW)
         for v, p in zip(views, prevs)],
        [lambda b=b, p=p: ref.fingerprint_changed_ref(b, p)
         for b, p in zip(blocks_all, prevs)],
        leaf_bytes + 2 * dig_bytes + dig_bytes // 2, 8 * words, err_fpc)
    del blocks_all

    # ---- gather_quantize (q8) / gather_quantize4 (q4): byte-exact
    for kname, q4 in (("gather_quantize", False), ("gather_quantize4", True)):
        kern = ops.gather_quantize4_blocks if q4 else ops.gather_quantize_blocks
        plain_fn = ref.gather_quantize4_ref if q4 else ref.gather_quantize_ref
        cases = [(p, x, None, CW) for p, x in moments] \
            + edge_q_cases(torch, gen, dev) \
            + [("exact .5 ties", tie_rows(torch, dev, q4),
                torch.tensor([0, 1], device=dev), CW)]
        err = 0.0
        for name, x, idx, cw in cases:
            if idx is None:                     # every real row (main path)
                idx = torch.arange(-(-x.numel() // cw), device=dev)
            idx = idx.to(torch.int32)
            block = min(256, cw)
            q, s = kern(x, idx, cw)
            q_ref, s_ref = plain_fn(ops._padded_float_blocks(x, cw), idx,
                                    block)
            if not (bits_equal(torch, q, q_ref)
                    and bits_equal(torch, s, s_ref)):
                fail(f"{kname} differs from the plain version on {name} "
                     f"(chunk_words {cw}): {int((q != q_ref).sum())} payload "
                     f"bytes and {int((s != s_ref).sum())} scales differ")
            err = max(err, max_abs_diff(torch, q, q_ref),
                      max_abs_diff(torch, s, s_ref))
        say(f"kernel {kname}: {len(cases)} cases byte-exact vs plain "
            f"(max_abs_err {err})")
        # timing: one checkpoint's gather of one moment slot, the 10 mu
        # leaves with every row changed
        slot = [x for p, x in moments if p.startswith(".mu")]
        idxs = [torch.arange(-(-x.numel() // CW), device=dev,
                             dtype=torch.int32) for x in slot]
        padded = [ops._padded_float_blocks(x, CW) for x in slot]
        elems = sum(x.numel() for x in slot)
        rows = sum(i.numel() for i in idxs)
        out_bytes = rows * CW // (2 if q4 else 1) + rows * (CW // 256) * 4
        results[kname] = timed(
            [lambda x=x, i=i: kern(x, i, CW) for x, i in zip(slot, idxs)],
            [lambda p=p, i=i: plain_fn(p, i, 256)
             for p, i in zip(padded, idxs)],
            elems * 4 + rows * 4 + out_bytes, 8 * elems, err)
        del padded
    for k, r in results.items():
        say(f"kernel {k}: {r['ms']:.4f} ms on the card (profiler, sum of "
            f"its launches), {r['plain_ms']:.4f} ms plain, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}); the pass as the "
            f"host issues it {r['pass_ms']:.4f} ms, "
            f"{r['dispatch_us']:.1f} us of host dispatch per launch")
    return results


# ---------------------------------------------------------- model check --
def model_check(torch, dev):
    """Same weights, same small batch: the card's loss equals the CPU's
    (f32 to 1e-4 relative: reduction order differs, TF32 off)."""
    import repro_torch.configs as C
    from repro_torch.data import synthetic_batch
    from repro_torch.train.state import state_from_numpy, state_to_numpy
    from repro_torch.train.step import build_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = C.get_smoke("florbench-100m").replace(dtype="float32")
    init_cpu, step_cpu = build_train_step(cfg, device="cpu")
    _, step_gpu = build_train_step(cfg, device=dev)
    st_cpu = init_cpu(SEED)
    st_gpu = state_from_numpy(state_to_numpy(st_cpu), dev)
    batch = synthetic_batch(cfg, 2, 64, 0, SEED)
    _, m_cpu = step_cpu(st_cpu, batch)
    _, m_gpu = step_gpu(st_gpu, batch)
    a, b = float(m_cpu["loss"]), float(m_gpu["loss"])
    if not (abs(a - b) <= 1e-4 * abs(a)):
        fail(f"smoke-model loss on the card {b} vs CPU {a}")
    say(f"model check: smoke f32 loss card {b:.6f} vs cpu {a:.6f}")


# ------------------------------------------------------------ main path --
def check_restore(torch, restored, live, lossy: dict) -> dict:
    """Leaf-by-leaf comparison; ``lossy`` maps a slot name to its atol.
    Returns {path: max_abs_err} for the lossy leaves."""
    from repro_torch.utils.pytree import keystr, tree_flatten_with_path

    got, _ = tree_flatten_with_path(restored)
    want, _ = tree_flatten_with_path(live)
    if len(got) != len(want):
        fail(f"restore has {len(got)} leaves, live state {len(want)}")
    errs = {}
    for (path, a), (_, b) in zip(got, want):
        p = keystr(path)
        slot = next((s for s in lossy if f".{s}" in p), None)
        if a.shape != b.shape or a.dtype != b.dtype:
            fail(f"restored leaf {p} is {a.dtype} {list(a.shape)}, live "
                 f"{b.dtype} {list(b.shape)}")
        if slot is None:
            if not bits_equal(torch, a.to(b.device), b):
                fail(f"restored leaf {p} differs from the live state")
        else:
            e = max_abs_diff(torch, a.to(b.device), b)
            if not e <= lossy[slot]:
                fail(f"restored leaf {p} off by {e} > atol {lossy[slot]}")
            errs[p] = e
    return errs


def host_line(tag: str, stats: list):
    mat = sum(s.get("materialize_s") or 0.0 for s in stats)
    ent = sum(s.get("entropy_s") or 0.0 for s in stats)
    stored = sum(s.get("stored_bytes") or 0 for s in stats)
    say(f"host {tag}: writer thread {mat:.2f} s for {len(stats)} "
        f"checkpoints ({stored / 1e9:.3f} GB of wire chunks hashed, "
        f"compressed and written; entropy stage {ent:.2f} s)")


def main_path_a(torch, ops, dev, smoke=False):
    from repro_torch.checkpoint import CheckpointStore
    from repro_torch.launch import train as launcher

    run = os.path.join(WORK, "path_a")
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = launcher.main(["--arch", "florbench-100m", "--device", str(dev),
                         *(["--smoke"] if smoke else []),
                         "--batch", str(BATCH), "--seq", str(SEQ),
                         "--epochs", str(EPOCHS),
                         "--steps-per-epoch", str(STEPS), "--no-adaptive",
                         "--seed", str(SEED), "--run-dir", run])
    sync(torch, dev)
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    state = out["state"]
    if int(state.step) != EPOCHS * STEPS:
        fail(f"path A state.step {int(state.step)} != {EPOCHS * STEPS}")
    store = CheckpointStore(os.path.join(run, "store"))
    keys = store.list_keys()
    if len(keys) != EPOCHS:
        fail(f"path A wrote checkpoints {keys}, expected {EPOCHS}")
    restored = store.get_tree(f"train@{EPOCHS - 1}.0", like={"state": state})
    check_restore(torch, restored, {"state": state}, {})
    width = state.params["embed"]["table"].shape[1]
    say(f"main path A: launcher main() {width}-wide florbench-100m, "
        f"{EPOCHS}x"
        f"{STEPS} steps in {wall:.2f} s; {len(keys)} checkpoints; restore "
        f"of train@{EPOCHS - 1}.0 bit-identical on all 32 leaves")
    host_line("path A", out["ckpt_stats"])
    return counts


def amplitudes(torch, ops, state, slot: str, cw: int) -> str:
    """Quantiles of the per-chunk absmax of one moment slot (its real
    chunks, all leaves): what the error-bound selector compares with
    13.5 and 126 times the slot's atol."""
    from repro_torch.utils.pytree import tree_leaves

    amax = torch.cat([ops.chunk_absmax(x, cw)[:-(-x.numel() // cw)]
                      for x in tree_leaves(getattr(state, slot))])
    q = torch.quantile(amax.double(), torch.tensor(
        [0.0, 0.1, 0.5, 0.9, 1.0], dtype=torch.float64, device=amax.device))
    return (f"{slot} chunk absmax over {amax.numel()} chunks: min/p10/p50/"
            f"p90/max " + " / ".join(f"{float(v):.3e}" for v in q))


def session_path(torch, ops, dev, cfg, tag: str, bounds: dict, epochs: int):
    """``flor.Session`` record at full width with error-bounded moments and
    the overlapped checkpoint pass; restores the last checkpoint and holds
    each leaf to its slot's bound (bit for bit outside mu/nu)."""
    import repro_torch.flor as flor
    from repro_torch.checkpoint import CheckpointStore
    from repro_torch.checkpoint.pipeline import PIPELINE_CHUNK_WORDS as CW
    from repro_torch.data import synthetic_batch
    from repro_torch.train.step import build_train_step

    run = os.path.join(WORK, f"path_{tag}")
    init_state, train_step = build_train_step(cfg, device=dev)
    state = init_state(SEED + 1)
    spec = flor.RecordSpec(adaptive=False, ckpt_overlap=True,
                           ckpt_error_bounds=bounds)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with flor.Session(run, mode="record", record=spec) as sess:
        with sess.checkpointing(state=state) as ckpt:
            for epoch in sess.loop("epochs", range(epochs)):
                for s in sess.loop("train", range(STEPS)):
                    batch = synthetic_batch(cfg, BATCH, SEQ,
                                            epoch * STEPS + s, SEED + 1)
                    ckpt.state, m = train_step(ckpt.state, batch)
                flor.log("loss", m["loss"])
        sess.ctx.pipeline.drain()
        stats = sess.ctx.pipeline.stats
    sync(torch, dev)
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    state = ckpt.state
    loss = float(m["loss"])
    if not loss == loss or abs(loss) == float("inf"):
        fail(f"path {tag} loss is not finite: {loss}")
    store = CheckpointStore(os.path.join(run, "store"))
    key = f"train@{epochs - 1}.0"
    encs: dict = {}
    for lf in store.resolve_manifest(key)["leaves"]:
        by_slot = encs.setdefault(re.search(r"\.(\w+)", lf["path"])[1], {})
        for e in lf.get("enc") or ["raw"] * len(lf["chunks"]):
            by_slot[e] = by_slot.get(e, 0) + 1
    restored = store.get_tree(key, like={"state": state})
    errs = check_restore(torch, restored, {"state": state}, bounds)
    err_line = ", ".join(
        f"{s} max err {max(e for p, e in errs.items() if f'.{s}' in p):.3e} "
        f"(atol {a})" for s, a in bounds.items())
    say(f"main path {tag.upper()}: flor.Session {cfg.d_model}-wide "
        f"florbench-100m, overlap, ckpt_error_bounds {json.dumps(bounds)}, "
        f"{epochs}x{STEPS} steps in {wall:.2f} s, final loss {loss:.4f}; "
        f"chunk encodings of {key} by slot: {json.dumps(encs)}; restore: "
        f"params/step/rng bit-identical, {err_line}")
    for s in bounds:
        say(f"path {tag.upper()} final state: "
            f"{amplitudes(torch, ops, state, s, CW)}")
    host_line(f"path {tag.upper()}", stats)
    return counts


# ------------------------------------------------------------------ main --
def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a GPU")
    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        fail(f"no src/repro_torch beside {__file__}: run it from a checkout")
    sys.path.insert(0, src)
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    name = torch.cuda.get_device_name(0)
    card = smi_line()
    hbm_bps, hbm_note = peak_hbm(name)
    say(f"card: {card}")
    say(f"peak memory rate used for bounds: {hbm_note}")
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)

    import repro_torch.configs as C
    from repro_torch.kernels import cuda_build, ops

    t0 = time.perf_counter()
    cuda_build.library("chunk_delta")           # builds every source
    say(f"kernel build: {time.perf_counter() - t0:.1f} s "
        f"({', '.join(cuda_build.SOURCES)}; flags "
        f"{' '.join(cuda_build.NVCC_FLAGS)})")
    for src_name, log in cuda_build.build_log.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                say(f"  ptxas {src_name}: {line.strip()}")

    cfg = C.get("florbench-100m")
    results = kernel_phase(torch, dev, hbm_bps, cfg)
    if "--kernels-only" in sys.argv[1:]:
        say("--kernels-only: stopping after the kernel phases")
        return
    model_check(torch, dev)
    counts_a = main_path_a(torch, ops, dev)
    counts_b = session_path(torch, ops, dev, cfg, "b", B_BOUNDS, B_EPOCHS)
    counts_c = session_path(torch, ops, dev, cfg, "c", TIGHT_BOUNDS,
                            C_EPOCHS)
    paths = {"A": counts_a, "B": counts_b, "C": counts_c}
    for tag, counts in paths.items():
        say(f"launches path {tag}: {json.dumps(counts)}")

    sources = {"fingerprint": "chunk_delta.cu",
               "fingerprint_changed": "chunk_delta.cu",
               "gather_quantize": "quantize.cu",
               "gather_quantize4": "quantize.cu"}
    replaces = {"fingerprint": "src/repro/kernels/chunk_delta.py:37",
                "fingerprint_changed": "src/repro/kernels/chunk_delta.py:64",
                "gather_quantize": "src/repro/kernels/quantize.py:59",
                "gather_quantize4": "src/repro/kernels/quantize.py:107"}
    line = []
    for k, r in results.items():
        n = sum(c.get(k, 0) for c in paths.values())
        if n <= 0:
            fail(f"kernel {k} was never launched on the main path")
        line.append({"name": k, "route": "cuda",
                     "source": "src/repro_torch/kernels/csrc/" + sources[k],
                     "replaces": replaces[k], "launches": n,
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"], "library_ms": None,
                     "pass_ms": r["pass_ms"],
                     "dispatch_us": r["dispatch_us"]})
    shutil.rmtree(WORK, ignore_errors=True)
    say(f"total wall {time.perf_counter() - t_start:.1f} s")
    say(json.dumps({"kernels": line}))
    say(smi_line())
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
