#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--kernels-only]

Run from a checkout on a machine with one NVIDIA H100. Phases:

1. the card (``nvidia-smi`` name and power limit) and the build of the
   hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``, with
   the ``ptxas -v`` report (registers, shared memory, spills) of the
   kernels new in this slice;
2. kernel phases: each of the eight kernels against its plain torch
   version (``kernels/ref.py``) on the card, on seeded inputs, then timed
   at its main shape beside the plain version, its bound and, for flash
   attention, ``scaled_dot_product_attention``:
   - the four checkpoint kernels (fingerprint, fused fingerprint + changed
     mask, q8 / q4 gathers) on the leaves of the full florbench-100m
     TrainState (its own ``init_state``, with seeded moment values),
     odd-length bf16/f16/uint8/int64/bool leaves, a scalar leaf,
     0xFFFFFFFF and all-zero rows, exact .5 ties, C=1 and partial last
     rows, chunk_words 1024, 64 (a partly idle last CTA) and, for q8, 16
     (one lane a sub-block): digests and masks bit for bit, q8/q4 payloads
     and scales byte for byte;
   - the stand-alone changed mask on the TrainState's digests against a
     prev that differs in a seeded subset of rows (in one word only for
     some), bit for bit, and its per-launch floor (one call on 8 rows);
   - quantize_blocks / dequantize_blocks on the largest TrainState leaf
     and edge cases (odd lengths in f32/bf16/f16, all-zero rows, exact .5
     ties, +-absmax rows): q, scales and values bit for bit;
   - flash attention in f32 and bf16 at florbench-100m's width, a
     qwen3-14b GQA layer (in f16 too), Sq < Sk and bidirectional, plus rows
     that see no key (with and without a key split), ragged f16 cases at
     head dims 24 and 128 and head dim 256: within atol = rtol 2e-6 in
     f32, and within one output ulp (rtol 1e-2, atol 1e-4) in bf16 / f16,
     of the plain version (TF32 off); each case prints its route (the
     ``wgmma`` tensor-core kernel or the CUDA-core one) and key split, and
     is timed beside ``scaled_dot_product_attention`` (with a
     ``causal_lower_right`` mask at Sq < Sk); quantize / dequantize beside
     their library peer where one call computes the function;
3. a small-input model check: the same weights on the CPU and the card
   give the same loss;
4. main path A: ``repro_torch.launch.train.main`` at the full
   florbench-100m width (batch 8, seq 512, 2 epochs x 3 steps, every epoch
   checkpointed), then a restore of the last checkpoint that must equal the
   live state bit for bit;
5. replay R1: ``flor.Session(mode="replay")`` over path A's run with no
   probed block: every epoch restored onto the card (seconds and GB/s per
   restore), an outer probe logging the embedding norm, and the final
   state equal to the recorded one bit for bit; its kernel launches are
   counted as a path's (the restore path runs none);
6. replay R2: ``python -m repro_torch.launch.replay --probe train
   --nworkers 2 --check`` over path A's run on the card: two worker
   processes share the card, and the deferred check must pass at its own
   rtol 1e-4 with one hindsight row per step;
7. main path B: ``flor.Session`` at the same width (2 epochs x 3 steps)
   with ``RecordSpec(ckpt_error_bounds={"mu": 1e-2, "nu": 1e-3},
   ckpt_overlap=True)``; ``mu``/``nu`` restore within their bounds, every
   other leaf bit for bit. At these bounds the selector stores every
   moment chunk as q4, so the q8 kernel does not run here;
8. main path C: the same Session with tight bounds
   (``TIGHT_BOUNDS``, 1 epoch x 3 steps), at which the selector splits
   the moment chunks between q4, q8 and raw, checked as in B;
9. a ``kernels`` JSON line (for the checkpoint kernels, their launches in
   paths A, R1, B and C; for the four ``ops`` kernels, the launches of
   their own phase), the card line, and last the JSON line
   ``{"ok": true, "device": {...}}``.

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
BF16_OPS_PER_S = 989e12      # H100 SXM bf16 / f16 tensor cores, dense
SEED = 0
# path A: 2 epochs (its third went to make room for the replay phases)
BATCH, SEQ, EPOCHS, STEPS = 8, 512, 2, 3
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
      passes; of three profiler windows, the median of those that
      recorded the most device activities;
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
    # three profiler windows: a window now and then drops device events, so
    # keep those that recorded the most and take their median
    windows = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                for c in calls:
                    c()
            torch.cuda.synchronize()
        dev = [e.device_time for e in prof.events()
               if e.device_type.name == "CUDA"]
        windows.append((len(dev), sum(dev)))
    most = max(n for n, _ in windows)
    dev_us = statistics.median(t for n, t in windows if n == most)
    if not (most > 0 and dev_us > 0):
        fail("torch.profiler recorded no device time for a timed pass")
    return {"ms": dev_us / reps / 1e3, "pass_ms": statistics.median(whole),
            "dispatch_us": statistics.median(disp)}


def bound(hbm_bps, nbytes, ops_n, peak_ops=F32_OPS_PER_S):
    """(least ms the card could take, "bytes" | "operations"): the larger of
    the bytes over the memory rate and the operations over their peak."""
    t_bytes = nbytes / hbm_bps * 1e3
    t_ops = ops_n / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def timed_pass(torch, hbm_bps, kernel_calls, plain_calls, nbytes, ops_n,
               err, peak_ops=F32_OPS_PER_S, library_calls=None) -> dict:
    """Card time of a pass of kernel calls beside its plain version's, its
    bound and, where one PyTorch call computes the same function, that
    call's (``library_ms``, else None)."""
    t = time_calls(torch, kernel_calls)
    b, by = bound(hbm_bps, nbytes, ops_n, peak_ops)
    lib = time_calls(torch, library_calls)["ms"] if library_calls else None
    return dict(max_abs_err=err, ms=t["ms"], pass_ms=t["pass_ms"],
                dispatch_us=t["dispatch_us"],
                plain_ms=time_calls(torch, plain_calls, reps=3)["ms"],
                bound_ms=b, bound_by=by, library_ms=lib)


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


def edge_q_cases(torch, gen, dev, q4: bool):
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
    # the last 67 rows at chunk_words 64, the last one partial: the second
    # CTA's first warp has idle lanes that join the shuffles
    g64 = -(-x.numel() // 64)
    cases.append(("chunk_words 64, last CTA partly idle", x,
                  torch.arange(g64 - 67, g64, device=dev), 64))
    if not q4:           # one lane a sub-block (the q4 kernel takes W % 32)
        g16 = -(-x.numel() // 16)
        cases.append(("chunk_words 16", x,
                      torch.arange(g16 - 101, g16, device=dev), 16))
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

    results["fingerprint"] = timed_pass(
        torch, hbm_bps,
        [lambda v=v: ops.fingerprint_leaf(v, CW) for v in views],
        [lambda b=b: ref.fingerprint_ref(b) for b in blocks_all],
        leaf_bytes + dig_bytes, 8 * words, err_fp)
    results["fingerprint_changed"] = timed_pass(
        torch, hbm_bps,
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
            + edge_q_cases(torch, gen, dev, q4) \
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
        results[kname] = timed_pass(
            torch, hbm_bps,
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
    results["changed_mask"] = changed_mask_phase(torch, dev, gen, hbm_bps,
                                                 prevs)
    results.update(quantize_phase(torch, dev, gen, hbm_bps, state))
    results["flash_attention"] = flash_phase(torch, dev, gen, hbm_bps)
    return results


# ------------------------------------------------------ ops kernel phases --
# Kernels #5-#8 have no caller on the record path (none in the reference
# package either): ``kernels/ops.py`` is their entry point. Each phase resets
# the launch counts, drives the ops entry point on its inputs, reads the
# counts (its "launches"), then holds every output against the plain
# version on the same inputs and times the kernel at the phase's main shape.

def changed_mask_phase(torch, dev, gen, hbm_bps, digests) -> dict:
    """#8 on the [G, 2] digests of the whole florbench-100m TrainState (one
    call per leaf, as a checkpoint pass would make them) against a prev
    that differs in a seeded subset of rows: in word 0 only, in word 1 only,
    or in both."""
    from repro_torch.kernels import ops, ref

    d = torch.cat(digests)
    u = torch.rand(d.shape[0], generator=gen, device=dev)
    prev = d.clone()
    prev[u < 0.2, 0] ^= 1 << 7
    prev[(u >= 0.2) & (u < 0.3), 1] ^= -1
    prev[(u >= 0.3) & (u < 0.4)] ^= 0x5A5A
    prevs = list(torch.split(prev, [x.shape[0] for x in digests]))
    ops.reset_launch_counts()
    masks = [ops.changed_chunks(a, p) for a, p in zip(digests, prevs)]
    launches = ops.launch_counts()["changed_mask"]
    mask = torch.cat(masks)
    want = ref.changed_mask_ref(d, prev).to(torch.int32)
    if not bits_equal(torch, mask, want):
        fail(f"changed_mask differs from the plain version on "
             f"{int((mask != want).sum())} of {mask.numel()} rows")
    if int(mask.sum()) != int((u < 0.4).sum()):
        fail(f"changed_mask flags {int(mask.sum())} rows, "
             f"{int((u < 0.4).sum())} were changed")
    say(f"kernel changed_mask: {mask.numel()} TrainState digest rows over "
        f"{len(digests)} leaves ({int(mask.sum())} changed, some in one "
        f"word only) bit-exact vs plain")
    G = d.shape[0]
    r = timed_pass(torch, hbm_bps,
                   [lambda a=a, p=p: ops.changed_chunks(a, p)
                    for a, p in zip(digests, prevs)],
                   [lambda a=a, p=p: ref.changed_mask_ref(a, p)
                    .to(torch.int32) for a, p in zip(digests, prevs)],
                   2 * G * 8 + G * 4, 2 * G, 0.0)
    # the per-launch floor: one call on an 8-row digest pair, timed alike
    d8, p8 = d[:8].contiguous(), prev[:8].contiguous()
    floor = time_calls(torch, [lambda: ops.changed_chunks(d8, p8)])["ms"]
    say(f"kernel changed_mask: one launch on 8 digest rows {floor:.5f} ms on "
        f"the card (profiler); {len(digests)} launches x that floor = "
        f"{len(digests) * floor:.4f} ms beside a byte bound of "
        f"{r['bound_ms']:.5f} ms for the pass")
    return dict(r, launches=launches, launch_floor_ms=floor)


def quantize_cases(torch, gen, dev, state):
    """[(name, leaf)] for quantize_blocks / dequantize_blocks: the largest
    TrainState leaf (the main shape), then odd lengths in each float dtype,
    all-zero rows, exact .5 ties and rows whose absmax is hit with both
    signs."""
    path, big = max(state, key=lambda px: px[1].numel())
    pm = 2.0 * torch.rand(64 * 256, generator=gen, device=dev) - 1.0
    pm[0::256] = 3.0
    pm[1::256] = -3.0
    pm[512:768] *= 0.5
    pm[600] = -5.0                          # a row whose absmax is negative
    return [
        (f"{path} {list(big.shape)}", big),
        ("f32 odd 50001", 1e-3 * torch.randn(50001, generator=gen,
                                             device=dev)),
        ("bf16 odd 40001", torch.randn(40001, generator=gen, device=dev)
         .bfloat16()),
        ("f16 odd 33333", torch.randn(33333, generator=gen, device=dev)
         .half()),
        ("all-zero rows", torch.zeros(3 * 8 * 256 + 100, device=dev)),
        ("exact .5 ties", tie_rows(torch, dev, False)),
        ("+-absmax rows", pm),
    ]


def quantize_phase(torch, dev, gen, hbm_bps, state) -> dict:
    """#6 and #7: q, scales and dequantized values bit for bit against the
    plain versions; every value back within half a scale step."""
    from repro_torch.kernels import ops, ref

    cases = quantize_cases(torch, gen, dev, state)
    ops.reset_launch_counts()
    outs = []
    for name, x in cases:
        q, s = ops.quantize_blocks(x)
        outs.append((name, x, q, s, ops.dequantize_blocks(q, s, x.shape,
                                                          x.dtype)))
    counts = ops.launch_counts()
    for name, x, q, s, back in outs:
        n = x.numel()
        g = q.shape[0]
        flat = torch.nn.functional.pad(x.reshape(-1).float(),
                                       (0, g * 256 - n))
        q_ref, s_ref = ref.quantize_ref(flat.reshape(g, 256))
        if not (bits_equal(torch, q, q_ref) and bits_equal(torch, s, s_ref)):
            fail(f"quantize_blocks differs from the plain version on {name}: "
                 f"{int((q != q_ref).sum())} bytes, "
                 f"{int((s != s_ref).sum())} scales")
        back_ref = ref.dequantize_ref(q, s).reshape(-1)[:n] \
            .reshape(x.shape).to(x.dtype)
        if not bits_equal(torch, back, back_ref):
            fail(f"dequantize_blocks differs from the plain version on "
                 f"{name}")
        step = s.repeat_interleave(256)[:n].reshape(x.shape)
        err = (back.float() - x.float()).abs()
        slack = 0.0 if x.dtype == torch.float32 else 1e-2 * x.float().abs()
        # half a step, plus the f32 product's rounding (below 1e-5 of a
        # step at |q| <= 127) and, for bf16/f16 leaves, their own rounding
        if bool((err > 0.5 * step + 1e-5 * step + slack).any()):
            fail(f"dequantize_blocks(quantize_blocks(x)) off by more than "
                 f"half a scale step on {name}")
    say(f"kernel quantize_rows / dequantize_rows: {len(cases)} cases "
        f"(largest leaf {cases[0][0]}) bit-exact vs plain: q, scales and "
        f"dequantized values; every value within half a scale step")
    _, big = cases[0]
    n = big.numel()
    q, s = outs[0][2], outs[0][3]
    g = q.shape[0]
    res = {"quantize_rows": timed_pass(
        torch, hbm_bps, [lambda: ops.quantize_blocks(big)],
        [lambda: ref.quantize_ref(torch.nn.functional.pad(
            big.reshape(-1), (0, g * 256 - n)).reshape(g, 256))],
        n * 4 + g * 256 + g * 4, 4 * n, 0.0)}
    # the library peer: one int8 x f32 product (promotes to f32), the same
    # function at this shape (n = g * 256, nothing to trim)
    res["dequantize_rows"] = timed_pass(
        torch, hbm_bps,
        [lambda: ops.dequantize_blocks(q, s, big.shape, big.dtype)],
        [lambda: ref.dequantize_ref(q, s).reshape(-1)[:n]
         .reshape(big.shape)],
        g * 256 + g * 4 + n * 4, n, 0.0,
        library_calls=[lambda: torch.mul(q, s[:, None])])
    lib_same = bits_equal(torch, torch.mul(q, s[:, None]).reshape(big.shape),
                          ops.dequantize_blocks(q, s, big.shape, big.dtype))
    say(f"kernel dequantize_rows library peer torch.mul(q, scale[:, None]): "
        f"{res['dequantize_rows']['library_ms']:.4f} ms, same bits as the "
        f"kernel: {lib_same}")
    res["quantize_rows"]["launches"] = counts["quantize_rows"]
    res["dequantize_rows"]["launches"] = counts["dequantize_rows"]
    return res


# name, B, H, KV, Sq, Sk, d, causal
FLASH_CASES = [
    ("florbench-100m attention", 8, 12, 12, 512, 512, 64, True),
    ("qwen3-14b GQA layer", 1, 40, 8, 2048, 2048, 128, True),
    ("Sq 128 < Sk 2048", 1, 40, 8, 128, 2048, 128, True),
    ("bidirectional", 8, 12, 12, 512, 512, 64, False),
]
# dtypes each timed case runs in (the qwen3-14b layer in f16 too)
FLASH_DTYPES = {"qwen3-14b GQA layer": ("float32", "bfloat16", "float16")}
# checked, not timed: (case, dtype); a causal case with Sq > Sk also checks
# that the rows which see no key give the mean of v
FLASH_EDGE = [
    (("fully masked rows, Sq 192 > Sk 64", 1, 4, 2, 192, 64, 64, True),
     "float32"),
    (("fully masked rows, split keys, Sq 320 > Sk 256", 1, 4, 2, 320, 256,
      64, True), "bfloat16"),
    (("ragged S 200, d 24", 2, 4, 2, 200, 200, 24, True), "float16"),
    (("ragged S 200, d 128", 2, 4, 2, 200, 200, 128, True), "float16"),
    (("head dim 256", 1, 2, 1, 128, 128, 256, True), "float32"),
]
# (atol, rtol). Kernel and plain version both compute in f32 from the same
# inputs: in f32 they differ by summation order (the reference package's
# own 2e-6); in bf16 / f16 by at most the final rounding, one output ulp
# (2**-7 relative in bf16 at most, below rtol 1e-2)
FLASH_TOL = {"float32": (2e-6, 2e-6), "bfloat16": (1e-4, 1e-2),
             "float16": (1e-4, 1e-2)}
MAIN_FLASH = ("qwen3-14b GQA layer", "bfloat16")   # the kernels line's row


def sdpa_calls(torch, q, k, v, causal):
    """One ``scaled_dot_product_attention`` call computing #5's function on
    these inputs (the library yardstick, never called by the port). Below
    the diagonal at Sq < Sk the port's mask is ``causal_lower_right``; k/v
    are expanded to H heads outside the timed call where ``enable_gqa`` is
    refused with that bias."""
    F = torch.nn.functional
    Sq, Sk = q.shape[2], k.shape[2]
    if Sq == Sk or not causal:
        return [lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=True)]
    from torch.nn.attention.bias import causal_lower_right
    bias = causal_lower_right(Sq, Sk)
    try:
        F.scaled_dot_product_attention(q, k, v, attn_mask=bias,
                                       enable_gqa=True)
        return [lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=bias, enable_gqa=True)]
    except (RuntimeError, TypeError, ValueError):
        g = q.shape[1] // k.shape[1]
        ke, ve = k.repeat_interleave(g, dim=1), v.repeat_interleave(g, dim=1)
        return [lambda: F.scaled_dot_product_attention(q, ke, ve,
                                                       attn_mask=bias)]


def flash_phase(torch, dev, gen, hbm_bps) -> dict:
    """#5 against its plain version (einsum, f32 softmax; TF32 off) within
    ``FLASH_TOL``: the reference package's own 2e-6 in f32, one output ulp
    in bf16 and f16. Each case names its route (``wgmma`` tensor-core or
    CUDA-core kernel) and its key split."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say(f"flash attention plain version: TF32 off (matmul allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32}, cudnn allow_tf32="
        f"{torch.backends.cudnn.allow_tf32})")
    cases = []
    for c in FLASH_CASES:
        for dt in FLASH_DTYPES.get(c[0], ("float32", "bfloat16")):
            cases.append((c, dt, True))
    for c, dt in FLASH_EDGE:
        cases.append((c, dt, False))
    inputs = []
    for (name, B, H, KV, Sq, Sk, d, causal), dt, timed in cases:
        dtype = getattr(torch, dt)
        q = torch.randn(B, H, Sq, d, generator=gen, device=dev).to(dtype)
        k = torch.randn(B, KV, Sk, d, generator=gen, device=dev).to(dtype)
        v = torch.randn(B, KV, Sk, d, generator=gen, device=dev).to(dtype)
        inputs.append((q, k, v))
    ops.reset_launch_counts()
    routes0 = dict(fa.route_launches)
    outs = [ops.flash_attention(q, k, v, causal=c[7])
            for (c, _, _), (q, k, v) in zip(cases, inputs)]
    launches = ops.launch_counts()["flash_attention"]
    by_route = {r: n - routes0[r] for r, n in fa.route_launches.items()}
    main = None
    rows = []
    for ((name, B, H, KV, Sq, Sk, d, causal), dt, timed), (q, k, v), o in \
            zip(cases, inputs, outs):
        want = ref.flash_attention_ref(q, k, v, causal=causal)
        atol, rtol = FLASH_TOL[dt]
        g, w = o.float(), want.float()
        if o.shape != want.shape or o.dtype != want.dtype \
                or not bool(torch.isfinite(g).all()):
            fail(f"flash_attention on {name} {dt}: {o.dtype} "
                 f"{list(o.shape)}, finite={bool(torch.isfinite(g).all())}")
        excess = float(((g - w).abs() - rtol * w.abs()).max())
        err = max_abs_diff(torch, g, w)
        if excess > atol:
            fail(f"flash_attention on {name} {dt} off the plain version by "
                 f"{err} (atol {atol}, rtol {rtol})")
        blind = Sq - Sk if causal else 0
        if blind > 0:
            # 1e-5 in f32; in bf16 / f16 the output's own rounding, FLASH_TOL
            mean_v = v.float().mean(dim=2).repeat_interleave(H // KV, dim=1)
            dev_b = (g[:, :, :blind] - mean_v[:, :, None]).abs() \
                - (0.0 if dt == "float32" else rtol) * mean_v[:, :, None].abs()
            if dev_b.max() > (1e-5 if dt == "float32" else atol):
                fail(f"flash_attention on {name}: a row that sees no key is "
                     f"not the mean of v")
        p = fa.plan(B, H, Sq, Sk, d, q.dtype)
        line = f"{name} {dt} [B {B}, H {H}, KV {KV}, Sq {Sq}, Sk {Sk}, " \
               f"d {d}, causal {causal}] route {p['route']}, " \
               f"{p['n_split']} key split(s): max_abs_err {err:.3e} (atol " \
               f"{atol}, rtol {rtol})"
        if not timed:
            say(f"kernel flash_attention {line}")
            continue
        off = Sk - Sq
        r_idx = torch.arange(Sq, dtype=torch.float64)
        visible = float((r_idx + off + 1).clamp(0, Sk).sum()) if causal \
            else float(Sq * Sk)
        flops = 4.0 * B * H * d * visible
        nbytes = (2 * B * H * Sq * d + 2 * B * KV * Sk * d) * q.element_size()
        peak = F32_OPS_PER_S if dt == "float32" else BF16_OPS_PER_S
        sdpa = sdpa_calls(torch, q, k, v, causal)
        r = timed_pass(torch, hbm_bps,
                       [lambda q=q, k=k, v=v, c=causal:
                        ops.flash_attention(q, k, v, causal=c)],
                       [lambda q=q, k=k, v=v, c=causal:
                        ref.flash_attention_ref(q, k, v, causal=c)],
                       nbytes, flops, err, peak_ops=peak, library_calls=sdpa)
        say(f"kernel flash_attention {line}; {r['ms']:.4f} ms on the card, "
            f"{flops / r['ms'] / 1e9:.2f} TFLOP/s, plain {r['plain_ms']:.4f}"
            f" ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), SDPA "
            f"{r['library_ms']:.4f} ms")
        rows.append(dict(case=name, dtype=dt, route=p["route"],
                         n_split=p["n_split"], ms=r["ms"],
                         plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                         bound_by=r["bound_by"], library_ms=r["library_ms"],
                         max_abs_err=err))
        if (name, dt) == MAIN_FLASH:
            main = r
    say(f"kernel flash_attention: {len(cases)} cases within tolerance of "
        f"the plain version ({launches} launches: {json.dumps(by_route)})")
    return dict(main, launches=launches, routes=by_route, cases=rows)


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
    return counts, state


# --------------------------------------------------------------- replay --
def replay_r1(torch, dev, cfg, recorded) -> dict:
    """Hindsight replay of path A's run through ``flor.Session(mode=
    "replay")`` with no probed block: every epoch restores its Loop End
    Checkpoint onto the card; an outer probe logs the embedding norm per
    epoch. The final state must equal the recorded final state bit for
    bit. Returns the kernel launches of the replay (the restore path runs
    no kernel)."""
    import repro_torch.flor as flor
    from repro_torch.kernels import ops
    from repro_torch.logging import read_stream
    from repro_torch.train.step import build_train_step

    run = os.path.join(WORK, "path_a")
    init_state, _ = build_train_step(cfg, device=dev)
    state = init_state(SEED)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with flor.Session(run, mode="replay",
                      replay=flor.ReplaySpec(probed=set())) as sess:
        steps = sess.arg("steps_per_epoch", STEPS)
        with sess.checkpointing(state=state) as ckpt:
            for epoch in sess.loop("epochs",
                                   range(sess.arg("epochs", EPOCHS))):
                for _ in sess.loop("train", range(steps)):
                    fail("R1 re-executed a training step: with no probed "
                         "block every epoch should restore")
                flor.log("embed_norm",
                         ckpt.state.params["embed"]["table"].float().norm())
        samples = list(sess.ctx.restore_stats)
    sync(torch, dev)
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    if len(samples) != EPOCHS:
        fail(f"R1 restored {len(samples)} checkpoints, expected {EPOCHS}")
    check_restore(torch, {"state": ckpt.state}, {"state": recorded}, {})
    rows = [r for r in read_stream(os.path.join(run, "logs",
                                                "replay_p0.jsonl"))
            if r["key"] == "embed_norm"]
    norms = [r["value"] for r in rows]
    if len(norms) != EPOCHS or not all(v == v and v > 0 for v in norms):
        fail(f"R1 outer probe logged {norms}")
    per = [f"{x['key']} {x['restore_s']:.2f} s "
           f"({x['bytes'] / x['restore_s'] / 1e9:.3f} GB/s, "
           f"{x['hops']} hops)" for x in samples]
    say(f"replay R1: flor.Session(mode='replay') over path A, {EPOCHS} "
        f"epochs restored on the card in {wall:.2f} s; per restore: "
        f"{'; '.join(per)}; embed_norm per epoch {norms}; final state "
        f"bit-identical to the recorded one on all 32 leaves")
    return counts


def replay_r2(torch, dev, smoke=False):
    """The planned replay launcher over path A's run on the card: probe
    ``train``, two worker processes sharing the card (one restores its init
    checkpoint), merge, and the deferred check at its own rtol 1e-4."""
    run = os.path.join(WORK, "path_a")
    cmd = [sys.executable, "-m", "repro_torch.launch.replay",
           "--run-dir", run, "--probe", "train", "--nworkers", "2",
           "--check", "--batch", str(BATCH), "--seq", str(SEQ),
           "--seed", str(SEED), "--device", torch.device(dev).type,
           *(["--smoke"] if smoke else [])]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    t0 = time.perf_counter()
    r = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=600)
    wall = time.perf_counter() - t0
    for line in r.stdout.strip().splitlines():
        say(f"  R2| {line}")
    if r.returncode != 0:
        fail(f"R2 replay launcher exited {r.returncode}:\n"
             f"{r.stderr[-4000:]}")
    m = re.search(r"deferred check: ok=(\w+) compared=(\d+) "
                  r"hindsight=(\d+)", r.stdout)
    if not m or m[1] != "True":
        fail("R2 printed no passing deferred check")
    if int(m[3]) != EPOCHS * STEPS:
        fail(f"R2 hindsight rows {m[3]} != {EPOCHS * STEPS}")
    say(f"replay R2: python -m repro_torch.launch.replay --probe train "
        f"--nworkers 2 --check on the card: wall {wall:.2f} s; deferred "
        f"check: ok=True, compared {m[2]}, hindsight {m[3]}")


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
# kernel -> (CUDA source, the TPU kernel it replaces, its path); "record"
# kernels must have launched on paths A-C, "ops" kernels report the
# launches of their own phase (kernels/ops.py is their only entry point)
KERNELS = {
    "fingerprint": ("chunk_delta.cu", "chunk_delta.py:37", "record"),
    "fingerprint_changed": ("chunk_delta.cu", "chunk_delta.py:64", "record"),
    "gather_quantize": ("quantize.cu", "quantize.py:59", "record"),
    "gather_quantize4": ("quantize.cu", "quantize.py:107", "record"),
    # the main case (qwen3-14b layer, bf16) runs the tensor-core kernel; f32
    # and other head dims the CUDA-core one in flash_attention.cu
    "flash_attention": ("flash_wgmma.cu", "flash_attention.py:68", "ops"),
    "quantize_rows": ("quantize.cu", "quantize.py:31", "ops"),
    "dequantize_rows": ("quantize.cu", "quantize.py:140", "ops"),
    "changed_mask": ("chunk_delta.cu", "chunk_delta.py:95", "ops"),
}


def kernels_line(results: dict, paths: dict) -> list:
    line = []
    for k, (src, tpu, path) in KERNELS.items():
        r = results[k]
        n = sum(c.get(k, 0) for c in paths.values()) if path == "record" \
            else r["launches"]
        if n <= 0:
            fail(f"kernel {k} was never launched on its path ({path})")
        entry = {"name": k, "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/" + src,
                 "replaces": "src/repro/kernels/" + tpu, "launches": n,
                 "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                 "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                 "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                 "pass_ms": r["pass_ms"], "dispatch_us": r["dispatch_us"],
                 "path": path}
        for extra in ("cases", "routes", "launch_floor_ms"):
            if extra in r:
                entry[extra] = r[extra]
        line.append(entry)
    return line


# kernels new in this slice: their ptxas -v report is printed after the build
NEW_KERNELS = ("gq8_kernel",)


def ptxas_report(build_log: dict, names) -> list:
    """One line per compiled kernel whose name holds one of ``names``:
    registers, shared memory, stack and spills from ``nvcc -Xptxas -v``
    (names demangled by c++filt where it is installed)."""
    entries = []
    for src, log in build_log.items():
        fn, props = None, ""
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                fn, props = m[1], ""
            elif "spill" in line:
                props = line.strip()
            elif fn and "Used" in line and "registers" in line:
                if any(n in fn for n in names):
                    entries.append((src, fn, line.split(":", 1)[1].strip(),
                                    props))
                fn = None
    demangled = [fn for _, fn, _, _ in entries]
    if entries and shutil.which("c++filt"):
        out = subprocess.run(["c++filt"], input="\n".join(demangled),
                             capture_output=True, text=True)
        if out.returncode == 0:
            demangled = out.stdout.splitlines()
    short = [n[:n.rfind("(")].replace("(anonymous namespace)::", "")
             .removeprefix("void ") if n.endswith(")") else n
             for n in demangled]         # drop the parameter list
    return [f"{src}: {name}: {used}; {props}"
            for (src, _, used, props), name in zip(entries, short)]


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
    say(f"card: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")
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
    for line in ptxas_report(cuda_build.build_log, NEW_KERNELS):
        say(f"  ptxas {line}")

    cfg = C.get("florbench-100m")
    results = kernel_phase(torch, dev, hbm_bps, cfg)
    if "--kernels-only" in sys.argv[1:]:
        say(json.dumps({k: {f: r[f] for f in ("ms", "plain_ms", "bound_ms",
                                               "library_ms", "max_abs_err")}
                        for k, r in results.items()}))
        say("--kernels-only: stopping after the kernel phases")
        return
    model_check(torch, dev)
    counts_a, state_a = main_path_a(torch, ops, dev)
    counts_r1 = replay_r1(torch, dev, cfg, state_a)
    del state_a
    replay_r2(torch, dev)
    counts_b = session_path(torch, ops, dev, cfg, "b", B_BOUNDS, B_EPOCHS)
    counts_c = session_path(torch, ops, dev, cfg, "c", TIGHT_BOUNDS,
                            C_EPOCHS)
    paths = {"A": counts_a, "R1": counts_r1, "B": counts_b, "C": counts_c}
    for tag, counts in paths.items():
        say(f"launches path {tag}: {json.dumps(counts)}")
    say(json.dumps({"kernels": kernels_line(results, paths)}))
    shutil.rmtree(WORK, ignore_errors=True)
    say(f"total wall {time.perf_counter() - t_start:.1f} s")
    say(smi_line())
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
