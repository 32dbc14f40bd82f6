#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--kernels-only | --mixtral-only | --families-only
                           | --serve-only | --handsfree-only | --dist-only]

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
     some), bit for bit, its time on an 8-row call and the card's launch
     floor (an empty kernel, ``torch.cuda._sleep(0)``, timed alike);
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
3. phase M, mixtral-8x7b at its published widths cut from 32 layers to 1
   (one whole period: every layer is SWA + MoE), one 8192-token sequence
   a step, random weights from the seed made on the card (1.72 B
   parameters, a 20.59 GB TrainState):
   - M1: the port's ``moe_apply`` against a plain per-expert version
     (``plain_moe``: no sort, no gather, no scatter) on the layer's input
     and on that input leaning towards expert 0 (which drops choices): in
     f32 with TF32 off the top-k ids and drop fractions equal and the
     output within 1e-5 of its largest magnitude; the bf16-compute path's
     error printed beside it, within its tolerance;
   - M2: ``flor.Session`` record, 2 epochs x 3 steps, the adaptive
     controller on at eps = 1/15 as the launcher runs it, loss / moe_aux /
     moe_dropped logged every step; each epoch's Eq. 4 test printed (M
     estimate, C, bound), and the phase fails at once if a checkpoint
     materialization starts (a 20.59 GB write would take the host ~20
     minutes);
   - M3: the replay with a probe in the inner loop re-executes every
     epoch: the deferred check passes and the final state equals the
     recorded one bit for bit; step wall and tokens/s printed;
   - the fingerprint kernels (plain and fused) on every leaf of that
     state, the 1 879 048 192-byte expert leaves included, bit for bit
     against their plain versions, one pass of each timed beside its bound;
4. phase F, the families ported last, each at its published widths with
   its depth cut (``F_FAMILIES``), built through ``build_train_step`` on
   the card from the seed: deepseek-v3 (MLA, its 3 leading dense layers,
   an empty MoE stack of zero-byte leaves, bf16 parameters and moments),
   falcon-mamba-7b (Mamba1, 2 layers), zamba2-7b (Mamba2 + the shared
   attention block, one group of 6) and seamless-m4t-large-v2 (encoder-
   decoder, 4 + 4 layers). Each records 2 epochs x 2 steps under a
   ``flor.Session`` with the controller at eps = 1/15 (which must decline
   every checkpoint), replays every epoch by re-execution with an inner
   probe (deferred check, final state bit for bit, every gradient norm
   finite), then runs #2 and #1 over every leaf of that state against
   their plain versions; one line per family (widths, cut, parameters,
   state GB, step wall, tokens/s, peak device memory, controller, replay,
   #1/#2 against their bound);
5. phase S, serving (``repro_torch.serve.step``) with qwen3-14b at its
   published widths and full depth (40 layers, 14.8 B f32 parameters made
   on the card from the seed): S1 in f32 with TF32 off at batch 1, a
   decode step after a 512-token prefill against the 513-token prefill's
   logits (within ``S_TOL`` of the largest) and ``greedy_generate``'s first
   token against the prefill argmax; S2 in the config's bf16 compute, 8
   prompts of 2048 tokens and 32 greedy tokens timed step by step
   (prefill wall and tokens/s, the decode step's median and tokens/s
   beside its bound, the parameters read once; the cache's GB and the
   peak device memory), then ``greedy_generate`` again: the same tokens
   bit for bit; S3 each family's cache path at phase F's cuts
   (``S3_FAMILIES``: mixtral-8x7b's ring past its window, deepseek-v3's
   latent cache, falcon-mamba-7b's and zamba2-7b's states with the
   group's shared-attention cache, seamless-m4t-large-v2's cross K/V):
   S1's check, then a 16-token bf16 generate twice, bit-identical; one
   ``S <arch>`` line each;
6. phase H, hands-free mode: a training script with no Flor call but
   ``flor.log`` (``H_SCRIPT``, florbench-100m's smoke widths on the card,
   3 epochs x 2 steps) runs through ``flor.exec_instrumented``: record with
   the controller off (its inner loop instrumented with the changeset
   ``["state", "metrics"]``, every epoch checkpointed through #1/#2),
   ``detect_probes`` against a copy with a probe in the inner loop, a
   replay with it (deferred check: ok, 6 hindsight rows), and a replay
   with no probe that restores every epoch and ends on the recorded state
   bit for bit;
7. a small-input model check: the same weights on the CPU and the card
   give the same loss;
8. main path A: ``repro_torch.launch.train.main`` at the full
   florbench-100m width (batch 8, seq 512, 2 epochs x 3 steps, every epoch
   checkpointed) into the shared store ``build/chip_smoke/store`` as run
   ``A``, then a restore of ``A::train@1.0`` that must equal the live state
   bit for bit;
9. replay R2: ``python -m repro_torch.launch.replay --probe train
   --nworkers 2 --check`` over path A's run on the card (the run dir's
   ``flor.run.json`` leads it to the shared store): two worker processes
   share the card, and the deferred check must pass at its own rtol 1e-4
   with one hindsight row per step;
10. replay R1: ``flor.Session(mode="replay")`` over path A's run with no
   probed block: every epoch restored onto the card (seconds and GB/s per
   restore), an outer probe logging the embedding norm, and the final
   state equal to the recorded one bit for bit; its kernel launches are
   counted as a path's (the restore path runs none);
11. main path B: ``flor.Session`` at the same width, cut to 2 of its 12
   layers (``LIN_LAYERS``, as the lineage paths below: the writer time of
   a full-depth checkpoint went to phase D), 2 epochs x 3 steps (a full
   checkpoint, then a delta that inherits the full one's quantized chunks)
   with ``RecordSpec(ckpt_error_bounds={"mu": 1e-2, "nu": 1e-3},
   ckpt_overlap=True)``; the restore of the delta through that lossy chain
   holds ``mu``/``nu`` within their bounds, every other leaf bit for bit.
   At these bounds the selector stores every moment chunk as q4, so the q8
   kernel does not run here;
12. main path C: the same Session with tight bounds
   (``TIGHT_BOUNDS``, 1 epoch x 3 steps), at which the selector splits
   the moment chunks between q4, q8 and raw, checked as in B;
13. the lineage paths run florbench-100m at full width cut to 2 of its 12
   layers (``LIN_LAYERS``), which shrinks each of their restores and
   checkpoints 2.8x; path A2: the launcher records their parent, run
   ``A2`` (1 epoch x 3 steps, ``--layers 2``) into the shared store;
14. path W: the launcher derives run ``W`` from ``A2`` (``--parent-run
   A2``, 1 epoch x 3 steps): the warm start must seed from
   ``A2::train@0.0``, the first checkpoint must be a delta on it (its
   transferred bytes and changed chunks printed); the warm-start restore's
   seconds and GB/s are printed;
15. path W2: a ``flor.Session`` derived from ``A2`` warm-starts onto the
   card (the fingerprint kernel must launch once per leaf), changes one
   leaf (``params.ln_f``) and checkpoints: a delta on ``A2::train@0.0``
   moving no more than that leaf's chunk and under 5% of the logical bytes,
   restored bit for bit; then digests seeded on the CPU from A2's tip (a
   warm start without ``like``) must move to the card at the first compare:
   the fused kernel on every leaf of ``params`` plus ``step`` and ``rng``,
   and only ``ln_f``'s chunk flagged;
16. replay R3: ``flor.Session(mode="replay")`` over run W: the warm start
   restores through A2's chunks from the key W persisted, the epoch from
   W's checkpoint, and the final state must equal W's live state bit for
   bit (the restore check of path W);
17. path Q: over the shared store, ``flor.log_records`` from the sqlite
   index must equal the file scan row for row (R1's probe rows included),
   ``flor.pivot(..., "loss")`` must hold A's two epochs, A2's one and W's
   one, ``lineage="W"`` must hold A2's and W's rows only, and ``python -m
   repro_torch.launch.runs list|show|diff|logs|pivot`` must exit 0 (their
   output printed); query walls printed;
18. phase D, mesh-sharded record over a fleet, after ``empty_cache`` with
   no state held: florbench-100m at full width and depth with path A's
   seed, batches and steps, in processes of this script (``--d-child``)
   that share the card through a gloo group on a loopback coordinator:
   - D1: four processes on a (2, 2) ``DeviceMesh`` ("data", "model") train
     replicated; at each epoch's last step the checkpoint scope gets the
     TrainState placed by ``launch.specs.state_shardings`` (each rank its
     own slices, no collective) and a fleet ``flor.Session`` records it:
     each process fingerprints only the shards it owns (#2 once per owned
     shard, then #1), writes its member manifests, and the lead stitches
     every epoch's v4; each prints its shards, bytes, launches, submit
     stall, writer and stitch seconds, and the four trained states must be
     equal leaf for leaf (blake2b);
   - then three things side by side, none reading what another writes:
     D2a, ``get_tree`` of the tip unsharded onto the card, equal bit for
     bit to the fleet's state and to path A's ``A::train@1.0``; D2b,
     ``restore_sharded_tree`` onto a (1, 2) mesh of two processes, each
     local shard equal to its slice of D2a's restore, with the bytes each
     rank read beside its shard's and each restore's seconds and GB/s; D3,
     ``python -m repro_torch.launch.replay --num-processes 2`` as two
     replay hosts over path A's run (probe ``train``, 2 tasks): host 0
     merges after the store-file barrier and prints ``deferred check:
     ok=True`` with one hindsight row per step, the same rows R2 merged;
19. a ``kernels`` JSON line (for the checkpoint kernels, their launches in
   paths A, R1, B, C, A2, W, W2, R3, H and D and their passes over the
   mixtral state and phase F's four states, outside that count; for the
   four ``ops`` kernels, the launches of their own phase), the card line,
   and last the JSON line ``{"ok": true, "device": {...}}``.

``--kernels-only`` stops after phase 2, ``--mixtral-only`` runs phase M
alone after the build, ``--families-only`` phase F alone, ``--serve-only``
phase S alone, ``--handsfree-only`` phase H alone and ``--dist-only``
path A (which phase D reads) and phase D. Any failed phase, and any of
phase D's processes that fails, exits non-zero before the last line is
printed. The run directories live under ``build/chip_smoke`` (git-ignored)
and are removed at the end.
"""
from __future__ import annotations

import json
import math
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
# paths A, A2, W, W2 (and the replays of A and W) share one store: A2 is
# the parent run of W and W2, which derive from its final checkpoint
STORE = os.path.join(WORK, "store")
# path A: 2 epochs (its third went to make room for the replay phases)
BATCH, SEQ, EPOCHS, STEPS = 8, 512, 2, 3
# path B takes one full and one delta checkpoint, path C one full; each
# full-width checkpoint costs about a minute on the writer thread
B_EPOCHS, C_EPOCHS = 2, 1
B_BOUNDS = {"mu": 1e-2, "nu": 1e-3}
# selector bands per chunk: q4 if absmax <= 13.5 atol, q8 if <= 126 atol,
# else raw; these put the measured moment amplitudes across all three
TIGHT_BOUNDS = {"mu": 1e-5, "nu": 1e-8}
A_TIP = f"A::train@{EPOCHS - 1}.0"
# R2's merged rows, kept for phase D's replay hosts to match
R2_ROWS = os.path.join(WORK, "r2_merged_replay.jsonl")
# W, W2 and R3 run florbench-100m at full width cut to LIN_LAYERS layers,
# derived from their own parent run A2 (the launcher, 1 x 3 steps, at the
# same cut): a warm start needs its parent's structure, and the cut makes
# each of their restores and checkpoints about 2.8x smaller
LIN_LAYERS = 2
A2_TIP = "A2::train@0.0"
# phase M: mixtral-8x7b at its published widths, depth cut from 32 layers
# to 1, which is one whole period (every layer is SWA + MoE); one sequence
# of 8192 tokens, so the 4096-token window bites
M_LAYERS, M_BATCH, M_SEQ, M_EPOCHS, M_STEPS = 1, 1, 8192, 2, 3
# M1 holds moe_apply to a plain per-expert version, both in f32 with TF32
# off: only the order of the sums differs, so 1e-5 of the largest output.
# The bf16-compute path against the same plain f32 math on the same
# bf16-rounded input (and so the same routing): the port rounds the
# weights, the expert hidden states and the output to bf16 (2**-9 relative
# each), so M_BF16_TOL of the largest output
M_F32_TOL, M_BF16_TOL = 1e-5, 2e-2


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
def check_fingerprints(torch, name, x, cw, slab=2048):
    """#2 and #1 on one leaf against their plain versions, bit for bit: the
    digests, and the fused kernel's digests and mask against a prev that
    differs in every third row (word 0) and every fifth (word 1). The plain
    version runs in row slabs, so the int64 words of a 1.88 GB leaf fit
    beside a 20 GB state. Returns (digests, max abs err of #2, of #1)."""
    from repro_torch.kernels import ops, ref

    blocks = ops._as_u32_blocks(x, cw)
    # a zero-byte leaf (an empty layer stack) has zero rows
    d_ref = torch.cat([ref.fingerprint_ref(blocks[i:i + slab])
                       for i in range(0, max(blocks.shape[0], 1), slab)])
    del blocks
    d = ops.fingerprint_leaf(x, cw)
    if not bits_equal(torch, d, d_ref):
        fail(f"fingerprint digest differs from the plain version on "
             f"{name} (chunk_words {cw})")
    prev = d_ref.clone()
    prev[::3, 0] ^= 1                             # every third row changed
    prev[1::5, 1] ^= -1
    d2, m2 = ops.fingerprint_and_changed(x, prev, cw)
    m2_ref = ref.changed_mask_ref(d_ref, prev).to(torch.int32)
    if not (bits_equal(torch, d2, d_ref) and bits_equal(torch, m2, m2_ref)):
        fail(f"fingerprint_changed differs from the plain version on "
             f"{name} (chunk_words {cw})")
    if m2.numel() and (not bool(m2.any())
                       or bool(m2.all()) and m2.numel() > 2):
        fail(f"fingerprint_changed mask degenerate on {name}")
    return d_ref, max_abs_diff(torch, d, d_ref), max(
        max_abs_diff(torch, d2, d_ref), max_abs_diff(torch, m2, m2_ref))


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
        _, e_fp, e_fpc = check_fingerprints(torch, name, x, cw)
        err_fp, err_fpc = max(err_fp, e_fp), max(err_fpc, e_fpc)
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
    # the pass is one launch per leaf: beside it, one call on an 8-row
    # digest pair and the card's launch floor, an empty kernel (a zero-cycle
    # spin) timed alike, which owes nothing to this kernel's code
    d8, p8 = d[:8].contiguous(), prev[:8].contiguous()
    small = time_calls(torch, [lambda: ops.changed_chunks(d8, p8)])["ms"]
    floor = time_calls(torch, [lambda: torch.cuda._sleep(0)])["ms"]
    say(f"kernel changed_mask: one launch on 8 digest rows {small:.5f} ms, "
        f"an empty kernel {floor:.5f} ms on the card (profiler); "
        f"{len(digests)} launches x the empty kernel = "
        f"{len(digests) * floor:.4f} ms beside a byte bound of "
        f"{r['bound_ms']:.5f} ms for the pass")
    return dict(r, launches=launches, small_call_ms=small,
                launch_floor_ms=floor)


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


def launch_train(dev, run: str, epochs: int, *extra, smoke=False,
                 layers=None) -> dict:
    """``repro_torch.launch.train.main`` at the full width (cut to
    ``layers`` layers if given) into the shared store; returns its result
    dict."""
    from repro_torch.launch import train as launcher

    return launcher.main(["--arch", "florbench-100m", "--device", str(dev),
                          *(["--smoke"] if smoke else []),
                          *(["--layers", str(layers)] if layers else []),
                          "--batch", str(BATCH), "--seq", str(SEQ),
                          "--epochs", str(epochs),
                          "--steps-per-epoch", str(STEPS), "--no-adaptive",
                          "--seed", str(SEED), "--run-dir", run,
                          "--store-root", STORE, *extra])


def main_path_a(torch, ops, dev, smoke=False):
    from repro_torch.checkpoint import CheckpointStore

    run = os.path.join(WORK, "path_a")
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = launch_train(dev, run, EPOCHS, "--run-id", "A", smoke=smoke)
    sync(torch, dev)
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    state = out["state"]
    if int(state.step) != EPOCHS * STEPS:
        fail(f"path A state.step {int(state.step)} != {EPOCHS * STEPS}")
    store = CheckpointStore(STORE)
    keys = store.list_keys(run="A")
    if len(keys) != EPOCHS:
        fail(f"path A wrote checkpoints {keys}, expected {EPOCHS}")
    restored = store.get_tree(A_TIP, like={"state": state})
    check_restore(torch, restored, {"state": state}, {})
    width = state.params["embed"]["table"].shape[1]
    say(f"main path A: launcher main() {width}-wide florbench-100m, "
        f"{EPOCHS}x{STEPS} steps in {wall:.2f} s into the shared store as "
        f"run A; {len(keys)} checkpoints; restore of {A_TIP} "
        f"bit-identical on all 32 leaves")
    host_line("path A", out["ckpt_stats"])
    return counts, state


# --------------------------------------------------------------- replay --
def restore_line(samples: list) -> str:
    return "; ".join(f"{x['key']} {x['restore_s']:.2f} s "
                     f"({x['bytes'] / x['restore_s'] / 1e9:.3f} GB/s, "
                     f"{x['hops']} hops)" for x in samples)


def replay_r1(torch, dev, cfg, recorded) -> dict:
    """Hindsight replay of path A's run through ``flor.Session(mode=
    "replay")`` with no probed block, reconnecting to the shared store
    through the run dir's ``flor.run.json``: every epoch restores its Loop
    End Checkpoint onto the card; an outer probe logs the embedding norm
    per epoch (rows that path Q reads back). The final state must equal the
    recorded final state bit for bit. Returns the kernel launches of the
    replay (the restore path runs no kernel)."""
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
    say(f"replay R1: flor.Session(mode='replay') over path A, {EPOCHS} "
        f"epochs restored on the card in {wall:.2f} s; per restore: "
        f"{restore_line(samples)}; embed_norm per epoch {norms}; final "
        f"state bit-identical to the recorded one on all 32 leaves")
    return counts


def replay_r2(torch, dev, smoke=False):
    """The planned replay launcher over path A's run on the card: probe
    ``train``, two worker processes sharing the card (one restores its init
    checkpoint), merge, and the deferred check at its own rtol 1e-4. It
    runs before R1, whose ``replay_p0`` stream then replaces its worker
    0's."""
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
    # phase D's replay hosts merge into the same file: keep R2's rows
    shutil.copy(os.path.join(run, "logs", "merged_replay.jsonl"), R2_ROWS)
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
        f"{cfg.num_layers}-layer florbench-100m, overlap, ckpt_error_bounds {json.dumps(bounds)}, "
        f"{epochs}x{STEPS} steps in {wall:.2f} s, final loss {loss:.4f}; "
        f"chunk encodings of {key} by slot: {json.dumps(encs)}; restore: "
        f"params/step/rng bit-identical, {err_line}")
    for s in bounds:
        say(f"path {tag.upper()} final state: "
            f"{amplitudes(torch, ops, state, s, CW)}")
    host_line(f"path {tag.upper()}", stats)
    return counts


# ------------------------------------------------------------ lineage --
def path_a2(torch, ops, dev, smoke=False):
    """The parent of W and W2: the record launcher at full width cut to
    ``LIN_LAYERS`` layers, 1 epoch x 3 steps, one exact checkpoint, into
    the shared store as run A2. Its restore is checked through W's warm
    start (R3) and W2's."""
    from repro_torch.checkpoint import CheckpointStore

    run = os.path.join(WORK, "path_a2")
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = launch_train(dev, run, 1, "--run-id", "A2", smoke=smoke,
                       layers=LIN_LAYERS)
    sync(torch, dev)
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    keys = CheckpointStore(STORE).list_keys(run="A2")
    if len(keys) != 1:
        fail(f"path A2 wrote checkpoints {keys}, expected {A2_TIP} alone")
    width = out["state"].params["embed"]["table"].shape[1]
    say(f"path A2: launcher main() {width}-wide florbench-100m cut to "
        f"{LIN_LAYERS} layers, 1x{STEPS} steps in {wall:.2f} s into the "
        f"shared store as run A2, the parent of W and W2")
    host_line("path A2", out["ckpt_stats"])
    return counts


def path_w(torch, ops, dev, smoke=False):
    """The record launcher derives run W from run A2 (``--parent-run
    A2``, the same depth cut): the warm start restores A2's tip onto the
    card and seeds the delta pipeline there, so W's first checkpoint is a
    delta against A2's tip (three full training steps later nearly every
    chunk has changed, so its transfer is near the logical size: a fact,
    not a gate). The restore of W's checkpoint is R3's: it must equal W's
    live state."""
    run = os.path.join(WORK, "path_w")
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = launch_train(dev, run, 1, "--run-id", "W", "--parent-run", "A2",
                       smoke=smoke, layers=LIN_LAYERS)
    sync(torch, dev)
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    ws = out["warmstart"].get("train") or {}
    if not ws.get("seeded") or ws.get("parent_key") != A2_TIP:
        fail(f"path W warm start {ws}")
    first = out["ckpt_stats"][0]
    if first["kind"] != "delta" or first["parent"] != A2_TIP:
        fail(f"path W first checkpoint is {first['kind']} on "
             f"{first['parent']}, expected a delta on {A2_TIP}")
    say(f"path W: launcher --parent-run A2 --layers {LIN_LAYERS}, "
        f"1x{STEPS} steps in {wall:.2f} s; "
        f"warm start from {ws['parent_key']}: {ws['leaves']} leaves "
        f"seeded, restore {ws['restore_s']:.2f} s "
        f"({ws['bytes'] / ws['restore_s'] / 1e9:.3f} GB/s); first "
        f"checkpoint {first['kind']} on {first['parent']}: transferred "
        f"{first['transferred_bytes']} of {first['logical_bytes']} bytes "
        f"({first['transferred_bytes'] / first['logical_bytes']:.4f}), "
        f"{first['changed_chunks']} of {first['total_chunks']} chunks "
        f"changed (its restore is checked in R3)")
    host_line("path W", out["ckpt_stats"])
    return counts, out["state"]


def path_w2(torch, ops, dev, cfg):
    """A ``flor.Session`` derived from run A2 (``cfg`` is its depth cut)
    warm-starts onto the card: the seeding fingerprint must launch once per
    leaf there. Then ONE leaf changes (``params.ln_f``) and the first
    checkpoint must be a delta on A2's tip that moves that leaf's chunk and
    nothing else — what a seed on the CPU, or over the wrong view, would
    get wrong."""
    import repro_torch.flor as flor
    from repro_torch.checkpoint import CheckpointStore
    from repro_torch.checkpoint.pipeline import PIPELINE_CHUNK_WORDS as CW
    from repro_torch.train.step import build_train_step
    from repro_torch.utils.pytree import tree_leaves

    init_state, _ = build_train_step(cfg, device=dev)
    state = init_state(SEED)
    ops.reset_launch_counts()
    lineage = flor.LineageSpec(store_root=STORE, run_id="W2",
                               parent_run="A2")
    t0 = time.perf_counter()
    with flor.Session(os.path.join(WORK, "path_w2"), mode="record",
                      record=flor.RecordSpec(adaptive=False),
                      lineage=lineage) as sess:
        ctx = sess.ctx
        state = sess.warm_start("train", like=state)
        sync(torch, dev)
        t_ws = time.perf_counter() - t0
        seeded = ops.launch_counts().get("fingerprint", 0)
        n_leaves = len(tree_leaves(state))
        if seeded != n_leaves:
            fail(f"W2 warm start launched the fingerprint kernel {seeded} "
                 f"times for {n_leaves} leaves")
        base, ln_f = state, state.params["ln_f"]
        state = state._replace(params={**state.params, "ln_f": ln_f + 1.0})
        ctx.submit_checkpoint("train", "train@0.0", {"state": state},
                              meta={})
        flor.log("ln_f_bumped", 1.0)
        ctx.pipeline.drain()
        stat = ctx.pipeline.stats[-1]
        ws = dict(ctx.warmstart_stats["train"])
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    leaf_bytes = ln_f.numel() * ln_f.element_size()
    cap = -(-ln_f.numel() // CW) * CW * ln_f.element_size()
    frac = stat["transferred_bytes"] / stat["logical_bytes"]
    if stat["kind"] != "delta" or stat["parent"] != A2_TIP \
            or not 0 < stat["transferred_bytes"] <= cap or not frac < 0.05:
        fail(f"W2 first checkpoint: {stat['kind']} on {stat['parent']}, "
             f"{stat['transferred_bytes']} bytes moved (the changed leaf's "
             f"chunks hold {cap}), fraction {frac}")
    restored = CheckpointStore(STORE).get_tree("W2::train@0.0",
                                               like={"state": state})
    check_restore(torch, restored, {"state": state}, {})
    say(f"path W2: flor.Session warm start from {ws['parent_key']} in "
        f"{t_ws:.2f} s (restore {ws['restore_s']:.2f} s, "
        f"{ws['bytes'] / ws['restore_s'] / 1e9:.3f} GB/s), fingerprint "
        f"kernel launched {seeded} times for {n_leaves} leaves; params.ln_f "
        f"({ln_f.numel()} {str(ln_f.dtype).removeprefix('torch.')}, "
        f"{leaf_bytes} bytes) changed: first checkpoint {stat['kind']} on "
        f"{stat['parent']}, transferred {stat['transferred_bytes']} of "
        f"{stat['logical_bytes']} bytes ({frac:.3e}), "
        f"{stat['changed_chunks']} of {stat['total_chunks']} chunks; "
        f"restore of W2::train@0.0 bit-identical; {wall:.2f} s in all")
    digest_move_check(torch, ops, base, state)
    return counts


def digest_move_check(torch, ops, base, bumped):
    """Digests seeded on the CPU move to the card at the first compare.
    A warm start without ``like`` restores flat CPU tensors and seeds from
    them; the first checkpoint then compares the card's leaves. A tracker
    is seeded so, through the pipeline's word view, from CPU copies of
    ``base`` (A2's tip) for the ``params`` leaves, ``step`` and ``rng``, and
    dispatched on the card's leaves of ``bumped`` (``params.ln_f`` + 1):
    every leaf must take the fused kernel (no first sight) and only
    ``ln_f``'s chunk may be flagged, which holds only if the CPU's plain
    fingerprint and the card's kernel agree bit for bit. Its launches are
    not a path's."""
    from repro_torch.checkpoint.delta import DeltaTracker
    from repro_torch.checkpoint.pipeline import PIPELINE_CHUNK_WORDS as CW
    from repro_torch.checkpoint.pipeline import _fp_view
    from repro_torch.utils.pytree import tree_leaves_with_paths

    def leaves(s):
        return [(p, x) for p, x in tree_leaves_with_paths({"state": s})
                if ".mu" not in p and ".nu" not in p]

    pairs = [(p, b, x) for (p, b), (_, x) in zip(leaves(base),
                                                  leaves(bumped))]
    tracker = DeltaTracker(CW)
    t0 = time.perf_counter()
    host = [(p, b.cpu()) for p, b, _ in pairs]
    nbytes = sum(b.numel() * b.element_size() for _, b in host)
    for p, b in host:
        tracker.seed(p, _fp_view(b))
    t_seed = time.perf_counter() - t0
    if any(tracker._digests[p].device.type != "cpu" for p, _ in host):
        fail("digest move: a CPU seed left its digest off the CPU")
    before = ops.launch_counts().get("fingerprint_changed", 0)
    flagged = {}
    for p, _, x in pairs:
        h = tracker.delta_dispatch(p, _fp_view(x))
        if h["first"] or h["mask"] is None \
                or h["digest"].device != x.device:
            fail(f"digest move: {p} was treated as first sight")
        n = int(h["mask"].sum())
        if n:
            flagged[p] = n
    launched = ops.launch_counts()["fingerprint_changed"] - before
    ln_f = [p for p, _, x in pairs if x is bumped.params["ln_f"]]
    if launched != len(pairs) or flagged != {ln_f[0]: 1}:
        fail(f"digest move: {launched} fused launches for {len(pairs)} "
             f"leaves, chunks flagged {flagged}, expected {{{ln_f[0]}: 1}}")
    say(f"digest move: {len(pairs)} leaves ({nbytes} bytes: params, step, "
        f"rng) seeded on the CPU in {t_seed:.2f} s "
        f"({nbytes / t_seed / 1e9:.3f} GB/s, copy off the card included), "
        f"compared on the card: {launched} fused launches, no first sight, "
        f"chunks flagged {flagged}")


def replay_r3(torch, dev, cfg, recorded) -> dict:
    """Hindsight replay of run W with no probed block (``cfg`` is W's depth
    cut): the warm start restores A2's tip from the key W's
    ``flor.run.json`` persisted (through A2's chunks), then the epoch
    restores W's own checkpoint ``W::train@0.0``. The final state must
    equal W's live state at the end of path W bit for bit."""
    import repro_torch.flor as flor
    from repro_torch.kernels import ops
    from repro_torch.train.step import build_train_step

    init_state, _ = build_train_step(cfg, device=dev)
    state = init_state(SEED)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with flor.Session(os.path.join(WORK, "path_w"), mode="replay",
                      replay=flor.ReplaySpec(probed=set())) as sess:
        state = sess.warm_start("train", like=state)
        ws = dict(sess.ctx.warmstart_stats["train"])
        steps = sess.arg("steps_per_epoch", STEPS)
        with sess.checkpointing(state=state) as ckpt:
            for _ in sess.loop("epochs", range(sess.arg("epochs", 1))):
                for _ in sess.loop("train", range(steps)):
                    fail("R3 re-executed a training step")
        samples = list(sess.ctx.restore_stats)
    sync(torch, dev)
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    if ws["parent_key"] != A2_TIP or len(samples) != 1:
        fail(f"R3 warm start from {ws['parent_key']}, {len(samples)} "
             f"epoch restores")
    check_restore(torch, {"state": ckpt.state}, {"state": recorded}, {})
    say(f"replay R3: flor.Session(mode='replay') over run W in {wall:.2f} "
        f"s; warm start {ws['parent_key']} {ws['restore_s']:.2f} s "
        f"({ws['bytes'] / ws['restore_s'] / 1e9:.3f} GB/s, {ws['hops']} "
        f"hops); per epoch restore: W::{restore_line(samples)}; final "
        f"state bit-identical to W's live state on all 32 leaves")
    return counts


def path_q(torch):
    """The lineage query surface over the shared store after A, R2, R1, A2,
    W, W2 and R3: the sqlite index and the file scan give the same rows, the
    pivot and the lineage filter see the runs they should, and the ``runs``
    CLI answers."""
    import repro_torch.flor as flor

    t0 = time.perf_counter()
    by_index = flor.log_records(STORE, engine="index")
    t_index = time.perf_counter() - t0
    t0 = time.perf_counter()
    by_files = flor.log_records(STORE, engine="files")
    t_files = time.perf_counter() - t0
    if by_index != by_files:
        fail(f"Q: index rows ({len(by_index)}) differ from file-scan rows "
             f"({len(by_files)})")
    norms = [r for r in by_index if r["run_id"] == "A"
             and r["source"] == "replay_p0" and r["key"] == "embed_norm"]
    if len(norms) != EPOCHS:
        fail(f"Q: {len(norms)} R1 embed_norm rows, expected {EPOCHS}")
    t0 = time.perf_counter()
    piv = flor.pivot(STORE, "loss")
    t_pivot = time.perf_counter() - t0
    cells = [(r["run_id"], r["epoch"]) for r in piv]
    want = [("A", e) for e in range(EPOCHS)] + [("A2", 0), ("W", 0)]
    if cells != want or not all(isinstance(r["loss"], float)
                                and r["loss"] == r["loss"] for r in piv):
        fail(f"Q: pivot loss cells {cells}, expected {want}: {piv}")
    t0 = time.perf_counter()
    lin = {r["run_id"] for r in flor.log_records(STORE, lineage="W")}
    t_lineage = time.perf_counter() - t0
    if lin != {"A2", "W"}:
        fail(f"Q: lineage W rows come from runs {sorted(lin)}")
    if not any(r["run_id"] == "W2" for r in by_index):
        fail("Q: run W2 logged no row")
    # the five CLI processes run side by side: each spends most of its
    # wall importing torch
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    t0 = time.perf_counter()
    procs = [(args, subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.runs", *args,
         "--store-root", STORE], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True))
        for args in (["list"], ["show", "W"], ["diff", "A2", "W"], ["logs"],
                     ["pivot", "loss"])]
    t_cli = {}
    for args, proc in procs:
        try:
            out, err = proc.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for _, p in procs:
                p.kill()
            fail(f"Q: runs {' '.join(args)} did not finish in 300 s")
        t_cli[args[0]] = time.perf_counter() - t0
        for line in out.strip().splitlines():
            say(f"  Q| {line}")
        if proc.returncode != 0:
            fail(f"Q: runs {' '.join(args)} exited {proc.returncode}:\n"
                 f"{err[-3000:]}")
    say(f"path Q: {len(by_index)} log rows, index == file scan; pivot "
        f"loss {cells}; lineage W -> runs {sorted(lin)}; walls: "
        f"log_records index {t_index * 1e3:.1f} ms, files "
        f"{t_files * 1e3:.1f} ms, pivot {t_pivot * 1e3:.1f} ms, lineage "
        f"{t_lineage * 1e3:.1f} ms; runs CLI, five processes side by side "
        f"(done at, process start included) "
        + ", ".join(f"{k} {v:.2f} s" for k, v in t_cli.items()))


# -------------------------------------------------------------- phase M --
def mixtral_cfg():
    """mixtral-8x7b at its published widths (d_model 4096, 32 heads, 8 KV
    heads, head_dim 128, 8 experts top-2 softmax, d_ff_expert 14336,
    capacity factor 1.25, vocab 32000 padded to 32256, window 4096, rope
    theta 1e6, untied embeddings), cut from 32 layers to ``M_LAYERS``."""
    import repro_torch.configs as C

    return C.get("mixtral-8x7b").replace(num_layers=M_LAYERS)


def plain_moe(torch, cfg, p, x):
    """The MoE layer as plain per-expert code: the router logits as the
    port forms them (one einsum in ``x``'s dtype), softmax, the top k by
    repeated ``argmax`` (which takes the lowest index among equal scores,
    as ``jax.lax.top_k`` orders ties: bf16 logits tie often), renormalized
    weights; expert e keeps the first C of the choices routed to it in
    (token, choice) order, runs its swiglu MLP (mixtral's) in f32 on every
    token and adds its output weighted by the kept choices' weights (zero
    elsewhere). No sort, no gather, no scatter. Returns (y f32 [T, d], ids
    [T, k], dropped fraction, tokens whose k-th and (k+1)-th scores tie)."""
    F = torch.nn.functional
    mo = cfg.moe
    d = x.shape[-1]
    xf = x.reshape(-1, d)
    T, k, E = xf.shape[0], mo.top_k, mo.num_experts
    logits = torch.einsum("td,de->te", xf,
                          p["router"].to(xf.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    left, ids, w = probs, [], []
    for _ in range(k):
        i = left.argmax(-1)
        hot = F.one_hot(i, E).bool()
        ids.append(i)
        w.append((probs * hot).sum(-1))
        left = left.masked_fill(hot, -1.0)
    ids, w = torch.stack(ids, -1), torch.stack(w, -1)
    ties = int((left.amax(-1) == w[:, -1]).sum())
    w = w / w.sum(-1, keepdim=True)
    cap = max(math.ceil(k * T / E * mo.capacity_factor), 4)
    x32 = xf.float()
    pe = p["experts"]
    y = torch.zeros(T, d, device=x.device)
    kept_n = 0
    for e in range(E):
        mine = ids == e
        rank = torch.cumsum(mine.reshape(-1).int(), 0).reshape(T, k) - 1
        kept = mine & (rank < cap)
        kept_n += int(kept.sum())
        h = F.silu(x32 @ pe["wg"][e]) * (x32 @ pe["wi"][e])
        y += (w * kept).sum(-1)[:, None] * (h @ pe["wo"][e])
    return y, ids, (T * k - kept_n) / (T * k), ties


def phase_m1(torch, dev, cfg, params):
    """The port's ``moe_apply`` on the card against ``plain_moe`` on the
    same input: the layer's input from the first training batch (its
    embedded tokens, RMS-normed), and that input leaning towards expert 0,
    which then drops choices. f32 with TF32 off: the top-k ids equal, the
    drop fractions equal, the output within ``M_F32_TOL`` of its largest
    magnitude; the bf16-compute path beside it, within ``M_BF16_TOL``."""
    from repro_torch.data import synthetic_batch
    from repro_torch.models import moe
    from repro_torch.models.layers import embed_tokens, rms_norm
    from repro_torch.models.transformer import _layer
    from repro_torch.train.step import batch_to_device

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg32 = cfg.replace(dtype="float32")
    lyr = _layer(params["layers"], 0)
    p = lyr["moe"]
    tokens = batch_to_device(synthetic_batch(cfg, M_BATCH, M_SEQ, 0, SEED),
                             dev)["tokens"]
    with torch.no_grad():
        x = rms_norm(embed_tokens(cfg32, params["embed"]["table"], tokens,
                                  torch.float32), lyr["ln2"], cfg.norm_eps)
        r0 = p["router"][:, 0]
        cases = [("layer input", x), ("leaning to expert 0",
                                      x + 3.0 * r0 / r0.norm())]
        for name, xc in cases:
            out = {}
            for c, xin in ((cfg32, xc), (cfg, xc.bfloat16())):
                y, m = moe.moe_apply(c, p, xin)
                _, ids, _ = moe.route(c, p["router"], xin.reshape(-1,
                                                                  cfg.d_model))
                y_ref, ids_ref, drop_ref, ties = plain_moe(torch, c, p, xin)
                if not torch.equal(ids, ids_ref):
                    fail(f"M1 {name} {c.dtype}: top-k ids differ on "
                         f"{int((ids != ids_ref).any(-1).sum())} tokens")
                if float(m["moe_dropped"]) != drop_ref:
                    fail(f"M1 {name} {c.dtype}: dropped "
                         f"{float(m['moe_dropped'])} vs plain {drop_ref}")
                scale = float(y_ref.abs().max())
                err = max_abs_diff(torch, y.reshape(y_ref.shape), y_ref)
                tol = (M_F32_TOL if c is cfg32 else M_BF16_TOL) * scale
                if not (err <= tol and bool(torch.isfinite(y).all())):
                    fail(f"M1 {name} {c.dtype}: max err {err} > {tol}")
                out[c.dtype] = (err, tol, drop_ref, ties)
            e32, t32, drop, _ = out["float32"]
            e16, t16, _, ties16 = out["bfloat16"]
            say(f"M1 moe_apply on {name} [{M_BATCH * M_SEQ} tokens, "
                f"d {cfg.d_model}, {cfg.moe.num_experts} experts top-"
                f"{cfg.moe.top_k}, capacity "
                f"{moe.capacity(cfg, M_BATCH * M_SEQ)}]: "
                f"top-k ids equal, dropped {drop:.4f} equal; f32 max err "
                f"{e32:.3e} (atol {M_F32_TOL} x max|y| = {t32:.3e}); bf16 "
                f"compute max err {e16:.3e} (atol {M_BF16_TOL} x max|y| = "
                f"{t16:.3e}: weights, hidden states and output rounded to "
                f"bf16; {ties16} tokens with the k-th and next router "
                f"scores tied, lowest index first)")


def controller_line(ctrl, block: str, est_bytes: int, tag: str) -> str:
    """The Eq. 4 test the controller made at the end of this epoch's
    block, as ``AdaptiveController.should_materialize`` computes it."""
    b = ctrl.blocks[block]
    frac = b.tfrac.value if b.tfrac.count else 1.0
    M = b.M.value if b.M.count else est_bytes * frac / ctrl.write_bps
    thr = (b.n / (b.k + b.pending + 1)) * min(1.0 / (1.0 + ctrl.c.value),
                                              ctrl.effective_epsilon())
    if ctrl.should_materialize(block, est_bytes=est_bytes) or b.k \
            or b.pending:
        fail(f"{tag}: the controller would checkpoint (M {M} s, C "
             f"{b.C.value} s, bound {thr})")
    return (f"M estimate {M:.2f} s ({est_bytes / 1e9:.2f} GB at the "
            f"calibrated {ctrl.write_bps / 1e6:.1f} MB/s), C {b.C.value:.3f}"
            f" s, M/C {M / b.C.value:.2f} >= Eq. 4 bound n/(k+1) x "
            f"min(1/(1+c), eps) = {thr:.4f}: declined")


# the metrics each record logs at every step, where the model reports them
LOG_KEYS = ("loss", "moe_aux", "moe_dropped")


def session_loop(torch, dev, cfg, init_state, train_step, run, mode, shape,
                 tag):
    """Record (``mode="record"``, the controller on at eps = 1/15 as the
    launcher runs it) or replay with a probe in the inner loop (every
    epoch re-executes), from ``init_state(SEED)``; ``shape`` is (batch,
    seq, epochs, steps). Logs the ``LOG_KEYS`` the model reports at every
    step; fails at once if a gradient norm is not finite or (record) a
    checkpoint materialization starts. Nothing but the checkpointing scope
    holds a state, so a step holds two (its input and its output) and the
    gradients. Returns (final state, step walls, controller lines, logged
    keys)."""
    import repro_torch.flor as flor
    from repro_torch.data import synthetic_batch
    from repro_torch.utils.pytree import tree_bytes

    batch, seq, n_epochs, n_steps = shape
    kw = ({"record": flor.RecordSpec(epsilon=1.0 / 15)} if mode == "record"
          else {"replay": flor.ReplaySpec(probed={"train"})})
    walls, lines, keys = [], [], ()
    with flor.Session(run, mode=mode, **kw) as sess:
        if mode == "record":
            def refuse(*_a, **_k):
                fail(f"{tag}: a checkpoint materialization started")
            sess.ctx.submit_checkpoint = refuse
        steps = sess.arg("steps_per_epoch", n_steps)
        with sess.checkpointing(state=init_state(SEED)) as ckpt:
            est = tree_bytes(ckpt.state)
            for epoch in sess.loop("epochs",
                                   range(sess.arg("epochs", n_epochs))):
                for s in sess.loop("train", range(steps)):
                    b = synthetic_batch(cfg, batch, seq, epoch * steps + s,
                                        SEED)
                    t0 = time.perf_counter()
                    ckpt.state, m = train_step(ckpt.state, b)
                    sync(torch, dev)
                    walls.append(time.perf_counter() - t0)
                    if not bool(torch.isfinite(m["grad_norm"])):
                        fail(f"{tag}: gradient norm {float(m['grad_norm'])}"
                             f" at epoch {epoch} step {s}")
                    keys = tuple(k for k in LOG_KEYS if k in m)
                    for key in keys:
                        flor.log(key, m[key])
                    if mode == "replay":
                        flor.log("grad_norm", m["grad_norm"])
                if mode == "record":
                    lines.append(f"epoch {epoch}: " + controller_line(
                        sess.ctx.controller, "train", est, tag))
    return ckpt.state, walls, lines, keys


def record_and_replay(torch, dev, cfg, init_state, train_step, run, shape,
                      tags) -> dict:
    """A ``flor.Session`` record in which the adaptive controller must
    decline every checkpoint, then a replay that re-executes every epoch
    with an inner probe: the deferred check passes and the final state
    equals the recorded one bit for bit. ``tags`` names the two in the
    output. Returns the replayed state and the run's figures."""
    import repro_torch.flor as flor
    from repro_torch.checkpoint import CheckpointStore
    from repro_torch.utils.pytree import tree_leaves

    batch, seq, n_epochs, n_steps = shape
    rec_tag, rep_tag = tags
    torch.cuda.reset_peak_memory_stats(dev)
    recorded, walls, lines, keys = session_loop(
        torch, dev, cfg, init_state, train_step, run, "record", shape,
        rec_tag)
    for line in lines:
        say(f"{rec_tag} controller {line}")
    stored = CheckpointStore(os.path.join(run, "store")).list_keys()
    if stored:
        fail(f"{rec_tag} materialized checkpoints {stored}")
    rows = [r for r in flor.log_records(run) if r["key"] in keys]
    if len(rows) != len(keys) * n_epochs * n_steps or not all(
            r["value"] == r["value"] for r in rows):
        fail(f"{rec_tag} logged {len(rows)} rows: {rows}")
    peak_record = torch.cuda.max_memory_allocated(dev)
    wall = statistics.median(walls[1:])
    host = [x.cpu() for x in tree_leaves(recorded)]
    del recorded
    torch.cuda.empty_cache()
    replayed, r_walls, _, _ = session_loop(
        torch, dev, cfg, init_state, train_step, run, "replay", shape,
        rep_tag)
    rec, reps = flor.run_logs(run)
    res = flor.deferred_check(rec, reps)
    want = len(keys) * n_epochs * n_steps
    if not res.ok or res.compared != want \
            or res.hindsight_only != n_epochs * n_steps:
        fail(f"{rep_tag} deferred check: ok={res.ok} compared={res.compared} "
             f"hindsight={res.hindsight_only} {res.anomalies[:3]}")
    leaves = tree_leaves(replayed)
    if len(leaves) != len(host) or not all(
            bits_equal(torch, a, b.to(dev)) for a, b in zip(leaves, host)):
        fail(f"{rep_tag}: the replayed final state differs from the "
             f"recorded one")
    del host
    return {"state": replayed, "rows": rows, "keys": keys,
            "controller": lines, "walls": walls, "wall": wall,
            "tokens_per_s": batch * seq / wall, "replay_walls": r_walls,
            "peak_record_gb": peak_record / 1e9,
            "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
            "compared": res.compared, "hindsight": res.hindsight_only,
            "leaves": len(leaves)}


def phase_m(torch, dev, hbm_bps) -> dict:
    """Phase M: mixtral-8x7b at full width, one layer, through the port's
    entry points. M1 the MoE layer against its plain version; M2 a
    ``flor.Session`` record (2 x 3 steps of 8192 tokens) in which the
    adaptive controller must decline every checkpoint; M3 a replay that
    re-executes every epoch with an inner probe: the deferred check passes
    and the final state equals the recorded one bit for bit; then the
    fingerprint kernels on every leaf of that state. Returns the kernels'
    pass over the mixtral leaves for the kernels line."""
    from repro_torch.train.step import build_train_step
    from repro_torch.utils.pytree import tree_bytes, tree_leaves

    cfg = mixtral_cfg()
    run = os.path.join(WORK, "path_m")
    t0 = time.perf_counter()
    init_state, train_step = build_train_step(cfg, device=dev)
    state = init_state(SEED)
    sync(torch, dev)
    n_params = sum(x.numel() for x in tree_leaves(state.params))
    say(f"M: mixtral-8x7b, d_model {cfg.d_model}, {cfg.num_heads} heads / "
        f"{cfg.num_kv_heads} KV, {cfg.moe.num_experts} experts top-"
        f"{cfg.moe.top_k} x d_ff {cfg.moe.d_ff_expert}, window "
        f"{cfg.sliding_window}, vocab {cfg.vocab_size}, {cfg.num_layers} of "
        f"32 layers: {n_params} parameters, TrainState "
        f"{tree_bytes(state) / 1e9:.2f} GB, built on the card in "
        f"{time.perf_counter() - t0:.2f} s")
    phase_m1(torch, dev, cfg, state.params)
    del state
    r = record_and_replay(torch, dev, cfg, init_state, train_step, run,
                          (M_BATCH, M_SEQ, M_EPOCHS, M_STEPS), ("M2", "M3"))
    rows = r["rows"]
    drops = [x["value"] for x in rows if x["key"] == "moe_dropped"]
    say(f"M2 record: {M_EPOCHS}x{M_STEPS} steps of {M_BATCH}x{M_SEQ} tokens, "
        f"no checkpoint materialized; loss "
        f"{[round(x['value'], 4) for x in rows if x['key'] == 'loss']}, "
        f"moe_dropped {drops}; peak device memory "
        f"{r['peak_record_gb']:.1f} GB")
    walls = r["walls"]
    say(f"M step wall: {r['wall']:.3f} s (median of steps 2-{len(walls)} of "
        f"the record; first step {walls[0]:.3f} s)")
    say(f"M tokens/s: {r['tokens_per_s']:.0f}")
    say(f"M3 replay: every epoch re-executed ({len(r['replay_walls'])} "
        f"steps, median {statistics.median(r['replay_walls'][1:]):.3f} s), "
        f"deferred check: ok=True compared={r['compared']} hindsight="
        f"{r['hindsight']}; final state bit-identical to the recorded one on "
        f"all {r['leaves']} leaves")
    return state_fingerprints(torch, dev, hbm_bps, r["state"], "mixtral")


# phase F: the families ported last, each at its published widths with its
# depth cut: (arch, layers, batch, seq, the cut and why). One MoE layer of
# deepseek-v3 is 256 x 3 x 7168 x 2048 = 11.3 B parameters, ~90 GB with
# bf16 moments and gradients, over one card: it runs its leading dense
# layers only, and its MoE stack is empty (zero-byte leaves)
F_FAMILIES = (
    ("deepseek-v3-671b", 3, 1, 4096,
     "3 of 61 layers: the 3 leading dense layers, no MoE layer"),
    ("falcon-mamba-7b", 2, 1, 4096,
     "2 of 64 layers (7.3 B f32 parameters with AdamW exceed one card)"),
    ("zamba2-7b", 6, 1, 4096,
     "6 of 81 blocks: one group, 5 Mamba2 + the shared attention block, "
     "no tail (a whole period)"),
    ("seamless-m4t-large-v2", 4, 2, 4096,
     "4 + 4 of 24 + 24 encoder + decoder layers"),
)
F_EPOCHS, F_STEPS = 2, 2


def widths_note(cfg) -> str:
    """The published widths a family keeps, for its phase F line."""
    if cfg.mla is not None:
        m = cfg.mla
        return (f"d_model {cfg.d_model}, {cfg.num_heads} heads, MLA q/kv "
                f"rank {m.q_lora_rank}/{m.kv_lora_rank}, head "
                f"{m.qk_nope_head_dim}+{m.qk_rope_head_dim}/{m.v_head_dim}, "
                f"d_ff {cfg.d_ff}, {param_note(cfg)}")
    if cfg.ssm is not None:
        s = cfg.ssm
        note = (f"d_model {cfg.d_model}, d_inner {s.expand * cfg.d_model}, "
                f"state {s.state_dim}, conv {s.conv_dim}, chunk {s.chunk}")
        if s.version == 1:
            return note + f", dt_rank {s.dt_rank}, {param_note(cfg)}"
        return (note + f", Mamba2 head {s.head_dim}; shared block "
                f"{cfg.num_heads} heads of {cfg.resolved_head_dim()}, "
                f"{cfg.ffn_activation} {cfg.d_ff}, window "
                f"{cfg.sliding_window}, {param_note(cfg)}")
    return (f"d_model {cfg.d_model}, {cfg.num_heads} heads of "
            f"{cfg.resolved_head_dim()}, {cfg.ffn_activation} {cfg.d_ff}, "
            f"{param_note(cfg)}")


def param_note(cfg) -> str:
    from repro_torch.models.transformer import padded_vocab

    return (f"vocab {cfg.vocab_size} (padded {padded_vocab(cfg)}), "
            f"{cfg.param_dtype} parameters, {cfg.moment_dtype} moments")


def phase_f(torch, dev, hbm_bps) -> dict:
    """Phase F: each of ``F_FAMILIES`` at its published widths, depth cut,
    built through ``build_train_step`` on the card: a ``flor.Session``
    record of ``F_EPOCHS`` x ``F_STEPS`` steps in which the controller
    declines every checkpoint, a replay that re-executes every epoch with
    an inner probe (deferred check, final state bit for bit), every
    gradient norm finite, then #2 and #1 on every leaf of the replayed
    state against their plain versions. One line per family. Returns
    {arch: the kernels' pass over its state}."""
    import repro_torch.configs as C
    from repro_torch.train.step import build_train_step
    from repro_torch.utils.pytree import tree_bytes, tree_leaves

    out = {}
    for arch, layers, batch, seq, cut in F_FAMILIES:
        tag = f"F {arch}"
        cfg = C.with_layers(C.get(arch), layers)
        t0 = time.perf_counter()
        init_state, train_step = build_train_step(cfg, device=dev)
        state = init_state(SEED)
        sync(torch, dev)
        t_build = time.perf_counter() - t0
        n_params = sum(x.numel() for x in tree_leaves(state.params))
        empty = sum(1 for x in tree_leaves(state) if x.numel() == 0)
        gb = tree_bytes(state) / 1e9
        del state
        r = record_and_replay(torch, dev, cfg, init_state, train_step,
                              os.path.join(WORK, "path_f", arch),
                              (batch, seq, F_EPOCHS, F_STEPS),
                              (f"{tag} record", f"{tag} replay"))
        losses = [round(x["value"], 4) for x in r["rows"]
                  if x["key"] == "loss"]
        fp = state_fingerprints(torch, dev, hbm_bps, r.pop("state"), arch)
        torch.cuda.empty_cache()
        out[arch] = fp
        f1, f2 = fp["fingerprint_changed"], fp["fingerprint"]
        say(f"{tag}: {widths_note(cfg)}; cut: {cut}; {n_params} parameters"
            f", TrainState {gb:.2f} GB ({r['leaves']} leaves, {empty} of "
            f"zero bytes), built in {t_build:.2f} s; {batch}x{seq} tokens a "
            f"step, step wall {r['wall']:.3f} s (median of steps 2-"
            f"{len(r['walls'])}; first {r['walls'][0]:.3f} s), "
            f"{r['tokens_per_s']:.0f} tokens/s, peak device memory "
            f"{r['peak_gb']:.1f} GB; loss {losses}, every gradient norm "
            f"finite; controller declined {len(r['controller'])} of "
            f"{F_EPOCHS} epochs; replay: deferred check: ok=True compared="
            f"{r['compared']} hindsight={r['hindsight']}, final state "
            f"bit-identical on all {r['leaves']} leaves; #1 {f1['ms']:.4f} "
            f"ms vs bound {f1['bound_ms']:.4f} ms ({f1['bound_ms'] / f1['ms']:.0%}),"
            f" #2 {f2['ms']:.4f} ms vs bound {f2['bound_ms']:.4f} ms "
            f"({f2['bound_ms'] / f2['ms']:.0%}), bit-exact on every leaf")
    return out


def state_fingerprints(torch, dev, hbm_bps, state, label) -> dict:
    """#2 and #1 through ``kernels/ops.py`` on every leaf of a TrainState at
    the pipeline's 64 KiB chunks, digests and masks bit for bit against
    the plain versions (``check_fingerprints``), then one pass of each
    timed beside its bound."""
    from repro_torch.checkpoint.pipeline import PIPELINE_CHUNK_WORDS as CW
    from repro_torch.checkpoint.pipeline import _fp_view
    from repro_torch.kernels import ops
    from repro_torch.utils.pytree import tree_leaves_with_paths

    views, prevs = [], []
    for path, x in tree_leaves_with_paths(state):
        v = _fp_view(x)
        views.append(v)
        prevs.append(check_fingerprints(torch, f"{label} leaf {path}", v,
                                        CW)[0])
    rows = sum(p.shape[0] for p in prevs)
    big = max(views, key=lambda v: v.numel() * v.element_size())
    leaf_bytes = sum(v.numel() * v.element_size() for v in views)
    dig_bytes = sum(p.numel() * 4 for p in prevs)
    words = sum(-(-v.numel() * v.element_size()
                  // ops.native_bytes_per_word(v.dtype)) for v in views)
    out = {}
    for name, calls, nbytes in (
            ("fingerprint", [lambda v=v: ops.fingerprint_leaf(v, CW)
                             for v in views], leaf_bytes + dig_bytes),
            ("fingerprint_changed",
             [lambda v=v, p=p: ops.fingerprint_and_changed(v, p, CW)
              for v, p in zip(views, prevs)],
             leaf_bytes + 2 * dig_bytes + dig_bytes // 2)):
        t = time_calls(torch, calls, reps=3)
        b, by = bound(hbm_bps, nbytes, 8 * words)
        out[name] = {"leaves": len(views), "rows": rows,
                     "bytes": leaf_bytes, "ms": t["ms"],
                     "pass_ms": t["pass_ms"], "bound_ms": b, "bound_by": by}
        say(f"kernel {name} on the {label} TrainState: {len(views)} leaves, "
            f"{rows} rows of 64 KiB ({leaf_bytes / 1e9:.2f} GB; the largest "
            f"leaf {big.numel() * big.element_size()} bytes, "
            f"{-(-big.numel() * big.element_size() // (4 * CW))} rows) "
            f"bit-exact vs plain; {t['ms']:.4f} ms on the card, bound "
            f"{b:.4f} ms ({by}), {b / t['ms']:.0%} of it; the pass as "
            f"issued {t['pass_ms']:.4f} ms")
    return out


# ---------------------------------------------------------------- serve --
# phase S: qwen3-14b at its published widths and full depth (40 layers,
# 14.8 B f32 parameters, 59.1 GB). S1: f32 consistency at batch 1; S2: the
# config's bf16 compute, 8 prompts of 2048 tokens, 32 greedy tokens each
S_ARCH = "qwen3-14b"
S1_PROMPT = 512
S2_BATCH, S2_PROMPT, S2_STEPS = 8, 2048, 32
# decode(prefill(x), t) against prefill(x + t): the reference test's atol
# (tests/test_models.py), here of the logits' largest magnitude
S_TOL = 2e-3
# S3: each family's cache path at phase F's cuts: (arch, layers, prompt
# tokens of the decoder, the cache it exercises)
S3_FAMILIES = (
    ("mixtral-8x7b", 1, 4608, "SWA ring cache, the prompt past the 4096 "
     "window so the ring wraps"),
    ("deepseek-v3-671b", 3, 2048, "MLA latent cache (3 leading dense "
     "layers)"),
    ("falcon-mamba-7b", 2, 2048, "Mamba1 conv + scan state"),
    ("zamba2-7b", 6, 2048, "Mamba2 states + the group's shared-attention "
     "cache"),
    ("seamless-m4t-large-v2", 4, 2048, "self-attention cache + static "
     "cross K/V (4 + 4 layers)"),
)
S3_STEPS = 16


def f32_serving(cfg):
    """``cfg`` in f32 compute; a MoE config at capacity factor 8, so no
    token is dropped and the prompt and a step route alike (as
    tests/test_models.py runs its decode check)."""
    import dataclasses

    cfg = cfg.replace(dtype="float32")
    if cfg.moe is not None:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                  capacity_factor=8.0))
    return cfg


def prompt_batch(cfg, batch: int, prompt: int, step: int = 0) -> dict:
    """A seeded prompt batch; ``prompt`` is the decoder's length (an
    encoder-decoder gets as many encoder frames)."""
    from repro_torch.data import synthetic_batch

    return synthetic_batch(cfg, batch, 2 * prompt if cfg.family == "audio"
                           else prompt, step, SEED)


def start_pos(cfg, batch: dict) -> int:
    """The position after the prompt (greedy_generate's start)."""
    if cfg.family == "audio":
        return batch["dec_tokens"].shape[1]
    return batch["tokens"].shape[1] + (cfg.frontend_tokens
                                       if cfg.family == "vlm" else 0)


def serve_consistency(torch, dev, cfg, params, batch, tag) -> float:
    """decode(prefill(x), t) against prefill(x + t), f32 with TF32 off:
    returns max |diff| over the logits' largest magnitude; fails past
    ``S_TOL``."""
    import numpy as np
    from repro_torch.serve.step import build_decode_step, build_prefill_step

    key = "dec_tokens" if cfg.family == "audio" else "tokens"
    pos = start_pos(cfg, batch)
    B = batch[key].shape[0]
    caches, _ = build_prefill_step(cfg, pos + 8)(params, batch)
    tok = torch.full((B, 1), 7, dtype=torch.int32, device=dev)
    _, got, caches = build_decode_step(cfg)(params, caches, tok, pos)
    del caches
    longer = dict(batch)
    longer[key] = np.concatenate([batch[key], np.full((B, 1), 7, np.int32)],
                                 axis=1)
    _, want = build_prefill_step(cfg, pos + 9)(params, longer)
    err = float((got.double() - want.double()).abs().max()
                / want.double().abs().max())
    if not err <= S_TOL:
        fail(f"{tag}: decode after prefill differs from the longer "
             f"prefill by {err:.3e} of the largest logit (tol {S_TOL})")
    return err


def generate_twice(torch, dev, cfg, params, batch, steps) -> tuple:
    """``greedy_generate`` twice on the same prompts: the tokens must match
    bit for bit. Returns (tokens, wall of each run)."""
    from repro_torch.serve.step import greedy_generate

    outs, walls = [], []
    for _ in range(2):
        t0 = time.perf_counter()
        outs.append(greedy_generate(cfg, params, batch, steps,
                                    start_pos(cfg, batch) + steps))
        sync(torch, dev)
        walls.append(time.perf_counter() - t0)
    if not torch.equal(outs[0], outs[1]):
        fail(f"{cfg.name}: greedy_generate gave different tokens on the "
             f"same prompts")
    return outs[0], walls


def device_profile(torch, fn, top: int = 4):
    """One call of ``fn`` under ``torch.profiler``: (its result, the card's
    busy ms (the device rows' durations, summed), the device activities
    launched, the ``top`` kernels by summed time as (name, ms))."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    by_name: dict = {}
    n = 0
    for e in prof.events():
        if e.device_type.name == "CUDA":
            by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time
            n += 1
    busy = sum(by_name.values()) / 1e3
    if not busy > 0:
        fail("torch.profiler recorded no device time for a serving call")
    tops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return out, busy, n, [(name[:48], t / 1e3) for name, t in tops]


def profile_note(busy, n, tops, wall_ms) -> str:
    return (f"device busy {busy:.2f} ms of a {wall_ms:.2f} ms wall "
            f"({busy / wall_ms:.0%}; idle {1 - busy / wall_ms:.0%}), {n} "
            f"device activities; top: " + "; ".join(
                f"{name} {t:.2f} ms" for name, t in tops))


def allocator_line(torch, dev) -> str:
    free, total = torch.cuda.mem_get_info(dev)
    return (f"allocated {torch.cuda.memory_allocated(dev) / 1e9:.2f} GB, "
            f"reserved {torch.cuda.memory_reserved(dev) / 1e9:.2f} GB, "
            f"free {free / 1e9:.2f} of {total / 1e9:.2f} GB")


def phase_s(torch, dev, hbm_bps):
    """Phase S: the serving path (``repro_torch.serve.step``) on the card.
    S1: qwen3-14b at full width and depth in f32, TF32 off, batch 1: a
    decode step after a 512-token prefill gives the logits of the
    513-token prefill within ``S_TOL``; greedy_generate's first token is
    the prefill's argmax. S2: the config's bf16 compute, 8 prompts of 2048
    tokens, 32 greedy tokens, timed step by step through the step
    builders, then again through ``greedy_generate``: the same tokens bit
    for bit. S3: each family's cache path at phase F's cuts, S1's check
    and a 16-token bf16 generate twice, bit-identical."""
    import repro_torch.configs as C
    from repro_torch.models import build_model
    from repro_torch.serve.step import (build_decode_step,
                                        build_prefill_step)
    from repro_torch.train.step import batch_to_device
    from repro_torch.utils.pytree import tree_bytes, tree_leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say(f"S: device memory before the phase: {allocator_line(torch, dev)}")
    cfg = C.get(S_ARCH)
    t0 = time.perf_counter()
    params = build_model(cfg).init(SEED, dev)
    sync(torch, dev)
    n_params = sum(x.numel() for x in tree_leaves(params))
    p_bytes = tree_bytes(params)
    say(f"S: {S_ARCH}, {cfg.num_layers} layers (full depth), d_model "
        f"{cfg.d_model}, {cfg.num_heads} heads / {cfg.num_kv_heads} KV of "
        f"{cfg.resolved_head_dim()}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}: {n_params} {cfg.param_dtype} parameters "
        f"({p_bytes / 1e9:.2f} GB), made on the card in "
        f"{time.perf_counter() - t0:.2f} s; {allocator_line(torch, dev)}")

    # S1: f32 consistency at batch 1
    from repro_torch.serve.step import greedy_generate
    cfg32 = f32_serving(cfg)
    b1 = prompt_batch(cfg, 1, S1_PROMPT)
    err = serve_consistency(torch, dev, cfg32, params, b1, "S1")
    _, logits = build_prefill_step(cfg32, S1_PROMPT + 2)(params, b1)
    first = greedy_generate(cfg32, params, b1, 2, S1_PROMPT + 2)[:, 0]
    if not torch.equal(first, logits.argmax(-1).to(first.dtype)):
        fail(f"S1: greedy_generate's first token {first.tolist()} is not "
             f"the prefill argmax {logits.argmax(-1).tolist()}")
    say(f"S1 {S_ARCH} f32, TF32 off, batch 1, {S1_PROMPT}-token prompt: "
        f"decode(prefill(x), t) vs prefill(x + t) max diff {err:.3e} of the "
        f"largest logit (tol {S_TOL}); greedy_generate's first token "
        f"{first.tolist()} = the prefill argmax")
    del logits
    torch.cuda.empty_cache()

    # S2: throughput in the config's bf16 compute
    torch.cuda.reset_peak_memory_stats(dev)
    batch = prompt_batch(cfg, S2_BATCH, S2_PROMPT)
    max_len = S2_PROMPT + S2_STEPS
    prefill = build_prefill_step(cfg, max_len)
    decode = build_decode_step(cfg)
    tb = batch_to_device(batch, dev)
    sync(torch, dev)
    t0 = time.perf_counter()
    caches, logits = prefill(params, tb)
    sync(torch, dev)
    t_prefill = time.perf_counter() - t0
    cache_gb = tree_bytes(caches) / 1e9
    tok = logits.argmax(-1).to(torch.int32)[:, None]
    toks, walls = [tok], []
    for i in range(S2_STEPS - 1):
        t0 = time.perf_counter()
        tok, _, caches = decode(params, caches, tok, S2_PROMPT + i)
        sync(torch, dev)
        walls.append(time.perf_counter() - t0)
        toks.append(tok)
    tokens = torch.cat(toks, dim=1)
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    step = statistics.median(walls)
    # where a step's time goes: one more step (at the last free position)
    # and then one prefill, each under the profiler; outputs unused
    _, d_busy, d_n, d_top = device_profile(torch, lambda: decode(
        params, caches, tok, max_len - 1))
    del caches, logits
    _, p_busy, p_n, p_top = device_profile(torch, lambda: prefill(params,
                                                                  tb))
    again, g_walls = generate_twice(torch, dev, cfg, params, batch,
                                    S2_STEPS)
    if not torch.equal(tokens, again):
        fail("S2: greedy_generate's tokens differ from the step-by-step "
             "run's")
    b_ms = p_bytes / hbm_bps * 1e3
    say(f"S2 {S_ARCH} bf16 compute ({cfg.param_dtype} parameters), "
        f"{S2_BATCH} prompts x {S2_PROMPT} tokens, {S2_STEPS} greedy tokens "
        f"each: prefill {t_prefill:.3f} s ({S2_BATCH * S2_PROMPT / t_prefill:.0f}"
        f" tokens/s); decode step median {step * 1e3:.2f} ms (min "
        f"{min(walls) * 1e3:.2f}, max {max(walls) * 1e3:.2f}; "
        f"{S2_BATCH / step:.1f} tokens/s); bound {b_ms:.2f} ms (the "
        f"{p_bytes / 1e9:.2f} GB of parameters read once at "
        f"{hbm_bps / 1e12:.2f} TB/s), the step at {b_ms / (step * 1e3):.0%} "
        f"of it; cache {cache_gb:.2f} GB; peak device memory {peak:.2f} GB; "
        f"greedy_generate twice ({g_walls[0]:.2f} s, {g_walls[1]:.2f} s): "
        f"the same {tuple(tokens.shape)} tokens bit for bit")
    say(f"S2 profile, decode step: "
        f"{profile_note(d_busy, d_n, d_top, step * 1e3)}")
    say(f"S2 profile, prefill: "
        f"{profile_note(p_busy, p_n, p_top, t_prefill * 1e3)}")
    del params
    torch.cuda.empty_cache()

    # S3: every family's cache path at phase F's cuts
    for arch, layers, prompt, what in S3_FAMILIES:
        cfg = C.with_layers(C.get(arch), layers)
        params = build_model(cfg).init(SEED, dev)
        b = prompt_batch(cfg, 1, prompt)
        err = serve_consistency(torch, dev, f32_serving(cfg), params, b,
                                f"S {arch}")
        toks, g_walls = generate_twice(torch, dev, cfg, params, b,
                                      S3_STEPS)
        say(f"S {arch}: {layers} layers, {what}; f32 batch 1, "
            f"{prompt}-token prompt: decode vs longer prefill max diff "
            f"{err:.3e} of the largest logit (tol {S_TOL}); {cfg.dtype} "
            f"generate of {S3_STEPS} tokens twice ({g_walls[0]:.2f} s, "
            f"{g_walls[1]:.2f} s), bit-identical: {toks[0].tolist()}")
        del params
        torch.cuda.empty_cache()


# ------------------------------------------------------------ hands-free --
# phase H: an un-instrumented training script run through the script tier
# (``flor.exec_instrumented``), modelled on the reference's
# tests/test_record_replay.py; florbench-100m at its smoke widths
H_SCRIPT = """\
import repro_torch.configs as C
from repro_torch.data import synthetic_batch
from repro_torch.train.step import build_train_step
cfg = C.get_smoke('florbench-100m')
init_state, ts = build_train_step(cfg, device={device!r})
state = init_state(0)
metrics = {{}}
for epoch in range(3):
    for s in range(2):
        batch = synthetic_batch(cfg, 2, 64, epoch * 2 + s)
        state, metrics = ts(state, batch)
    flor.log('loss', metrics['loss'])
"""
H_PROBE = "\n        flor.log('probe', metrics['grad_norm'])"


def phase_h(torch, ops, dev) -> dict:
    """Phase H: record the script instrumented (the controller off, so
    every epoch checkpoints through #1/#2), detect the probe an edited copy
    adds, replay with it (deferred check: ok, 6 hindsight rows), then
    replay with no probe (every epoch skipped and restored) and end on the
    recorded state bit for bit. Returns the record's kernel launches."""
    import repro_torch.flor as flor
    from repro_torch.checkpoint import CheckpointStore
    from repro_torch.utils.pytree import tree_leaves

    work = os.path.join(WORK, "path_h")
    os.makedirs(work)
    run = os.path.join(work, "run")
    script = os.path.join(work, "train_script.py")
    src = H_SCRIPT.format(device=str(torch.device(dev)))
    with open(script, "w") as f:
        f.write(src)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    ns, report = flor.exec_instrumented(script, run_dir=run, mode="record",
                                        adaptive=False)
    sync(torch, dev)
    t_record = time.perf_counter() - t0
    counts = ops.launch_counts()
    if list(report.instrumented.values()) != [["state", "metrics"]]:
        fail(f"H: instrumented {report.instrumented}, refused "
             f"{report.refused}")
    recorded = [x.cpu() for x in tree_leaves(ns["state"])]
    store = CheckpointStore(os.path.join(run, "store"))
    keys = store.list_keys()
    if len(keys) != 3:
        fail(f"H: record wrote checkpoints {keys}, expected 3")
    probed_src = src.replace("state, metrics = ts(state, batch)",
                             "state, metrics = ts(state, batch)" + H_PROBE)
    probed = os.path.join(work, "probed.py")
    with open(probed, "w") as f:
        f.write(probed_src)
    rep = flor.detect_probes(store.get_meta("source")["src"], probed_src)
    t0 = time.perf_counter()
    flor.exec_instrumented(probed, run_dir=run, mode="replay",
                           probed=rep.probed_blocks)
    t_probe = time.perf_counter() - t0
    res = flor.deferred_check(*flor.run_logs(run))
    if not res.ok or res.hindsight_only != 6:
        fail(f"H deferred check: ok={res.ok} compared={res.compared} "
             f"hindsight={res.hindsight_only} {res.anomalies[:3]}")
    t0 = time.perf_counter()
    ns2, _ = flor.exec_instrumented(script, run_dir=run, mode="replay")
    t_skip = time.perf_counter() - t0
    got = tree_leaves(ns2["state"])
    if len(got) != len(recorded) or not all(
            bits_equal(torch, a.cpu(), b) for a, b in zip(got, recorded)):
        fail("H: the no-probe replay's final state differs from the "
             "recorded one")
    say(f"H: exec_instrumented record on {torch.device(dev)}, florbench-100m "
        f"smoke widths, 3 x 2 steps in {t_record:.2f} s: inner loop "
        f"{list(report.instrumented)} instrumented with changeset "
        f"{list(report.instrumented.values())[0]}, main loop(s) "
        f"{report.main_loops}, {len(keys)} checkpoints; detect_probes: "
        f"{sorted(rep.probed_blocks)}; probed replay {t_probe:.2f} s, "
        f"deferred check: ok=True compared={res.compared} "
        f"hindsight={res.hindsight_only}; no-probe replay {t_skip:.2f} s, "
        f"every epoch restored, final state bit-identical on all "
        f"{len(got)} leaves")
    for k in ("fingerprint", "fingerprint_changed"):
        if torch.device(dev).type == "cuda" and not counts.get(k):
            fail(f"H: kernel {k} never launched in the record")
    return counts


# --------------------------------------------------------------- phase D --
# a (2, 2) DeviceMesh of four processes sharing the card records path A's
# run (same seed, batches and steps) with the TrainState placed by
# launch.specs.state_shardings; then the restores and two replay hosts
D_MESH = (2, 2)
D_RESTORE_MESH = (1, 2)          # D2b: the resharded restore's fleet
D_RUN = os.path.join(WORK, "path_d")
D_TIP = f"train@{EPOCHS - 1}.0"


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def leaf_digests(tree) -> dict:
    """{leaf path: blake2b-16 hex of its bytes}."""
    from repro_torch.utils.pytree import tree_digest, tree_leaves_with_paths

    return {p: tree_digest(x) for p, x in tree_leaves_with_paths(tree)}


def replay_rows(path: str) -> list:
    """(epoch, key, value) of every row of a merged replay log."""
    with open(path) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    return sorted((r.get("epoch"), r["key"], json.dumps(r.get("value")))
                  for r in rows)


def d_start(role: str, n: int, dev, smoke: bool) -> list:
    """Start ``n`` children of this script (``--d-child role rank port dev
    smoke batch seq``) over one loopback gloo coordinator, all on
    ``dev``."""
    port = free_port()
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    env.pop("LOCAL_RANK", None)     # DeviceMesh would pick cuda:<LOCAL_RANK>
    return [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--d-child", role,
         str(r), str(port), str(dev), str(int(smoke)), str(BATCH),
         str(SEQ)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(n)]


def d_wait(role: str, procs: list, timeout: int) -> list:
    """Wait for a fleet from ``d_start``; each process must exit 0. Returns
    their results (``path_d/<role>_p<rank>.json``) by rank."""
    n = len(procs)
    try:
        for r, p in enumerate(procs):
            out, err = p.communicate(timeout=timeout)
            for line in out.strip().splitlines():
                say(f"  {role} p{r}| {line}")
            if p.returncode != 0:
                fail(f"phase D {role} process {r} exited {p.returncode}:\n"
                     f"{err[-4000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    out = []
    for r in range(n):
        with open(os.path.join(D_RUN, f"{role}_p{r}.json")) as f:
            out.append(json.load(f))
    return out


def d_child(role: str, rank: int, port: int, dev: str, smoke: bool):
    """One process of a phase D fleet on ``dev`` (the card): ``record`` (D1,
    one of four on a (2, 2) mesh) or ``restore`` (D2b, one of two on
    (1, 2))."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    sys.path.insert(0, os.path.join(ROOT, "src"))
    import repro_torch.configs as C
    from repro_torch.parallel.rendezvous import init_distributed

    dev = torch.device(dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    shape = D_MESH if role == "record" else D_RESTORE_MESH
    n = shape[0] * shape[1]
    group = init_distributed(f"127.0.0.1:{port}", rank, n)
    try:
        mesh = DeviceMesh(dev.type, torch.arange(n).reshape(shape),
                          mesh_dim_names=("data", "model"))
        cfg = (C.get_smoke if smoke else C.get)("florbench-100m")
        res = d_record(torch, dev, cfg, mesh, group) if role == "record" \
            else d_restore(torch, dev, mesh, rank)
        with open(os.path.join(D_RUN, f"{role}_p{rank}.json"), "w") as f:
            json.dump(res, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def d_record(torch, dev, cfg, mesh, group) -> dict:
    """D1 in one process: train replicated on path A's batches; at each
    epoch's last step the checkpoint scope gets the TrainState placed on
    the mesh (each rank's own slices); record under a fleet Session."""
    import repro_torch.flor as flor
    from repro_torch.checkpoint.mesh import (device_maps, local_anchor,
                                             owned_shards)
    from repro_torch.data import synthetic_batch
    from repro_torch.kernels import ops
    from repro_torch.launch.specs import state_shardings
    from repro_torch.parallel import place
    from repro_torch.train.step import build_train_step
    from repro_torch.utils.pytree import tree_leaves, tree_map

    init_state, ts = build_train_step(cfg, device=dev)
    state = init_state(SEED)
    shardings = state_shardings(cfg, mesh, state)

    def placed(st):
        return tree_map(lambda x, sh: place(x, mesh, sh.spec), st, shardings)

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with flor.Session(D_RUN, mode="record", record=flor.RecordSpec(
            adaptive=False, mesh=mesh, distributed=group)) as sess:
        with sess.checkpointing(state=placed(state)) as ckpt:
            for epoch in sess.loop("epochs", range(EPOCHS)):
                for s in sess.loop("train", range(STEPS)):
                    b = synthetic_batch(cfg, BATCH, SEQ, epoch * STEPS + s,
                                        SEED)
                    state, m = ts(state, b)
                    if s == STEPS - 1:
                        ckpt.state = placed(state)
                flor.log("loss", m["loss"])
        sess.ctx.pipeline.drain()
        stats = sess.ctx.pipeline.stats
    sync(torch, dev)
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    ords, hosts = device_maps(mesh)
    anchor = local_anchor(mesh, ords, hosts, 0)
    own = [sh for x in tree_leaves(placed(state)) if x.numel()
           for sh in owned_shards(x, mesh, ords, hosts, group.process_id,
                                  anchor)]
    say(f"D1 rank {group.process_id} at {mesh.get_coordinate()}: "
        f"{len(own)} shards owned, "
        f"{sum(s['data'].numel() * s['data'].element_size() for s in own)} "
        f"bytes; launches {json.dumps(counts)}; {wall:.2f} s")
    return {"rank": group.process_id, "wall_s": wall, "counts": counts,
            "n_owned": len(own),
            "owned_bytes": sum(s["data"].numel() * s["data"].element_size()
                               for s in own),
            "digests": leaf_digests(state),
            "stats": [{k: st.get(k) for k in (
                "key", "kind", "submit_stall_s", "materialize_s", "stitch_s",
                "stored_bytes", "transferred_bytes", "stitched")}
                | {"shard_bytes": sum((st.get("shard_bytes") or {}).values())}
                for st in stats]}


def d_restore(torch, dev, mesh, rank: int) -> dict:
    """D2b in one process: ``restore_sharded_tree`` of run D's tip onto the
    (1, 2) mesh; each leaf's local shard, its box and digest."""
    from repro_torch.checkpoint import CheckpointStore, restore_sharded_tree
    from repro_torch.parallel.sharding import local_box
    from repro_torch.utils.pytree import tree_digest

    store = CheckpointStore(os.path.join(D_RUN, "store"))
    stats: dict = {}
    t0 = time.perf_counter()
    out = restore_sharded_tree(store, D_TIP, mesh, stats_out=stats)
    sync(torch, dev)
    dt = time.perf_counter() - t0
    leaves = []
    for path, x in out.items():
        loc = x.to_local()
        if loc.device != dev:
            fail(f"D2b {path} restored on {loc.device}, not {dev}")
        leaves.append({"path": path, "box": local_box(x.shape, mesh,
                                                      x.placements),
                       "digest": tree_digest(loc),
                       "bytes": loc.numel() * loc.element_size()})
    return {"rank": rank, "restore_s": dt, "leaves": leaves,
            "bytes_read": sum(stats["bytes_by_shard"].values()),
            "chunks_read": stats["chunks_read"]}


def placeholder_like(torch, cfg, dev):
    """A ``{"state": TrainState}`` of empty tensors on ``dev``: the
    structure and devices a ``get_tree(like=)`` needs, without the bytes."""
    from repro_torch.models.api import build_model
    from repro_torch.train.state import TrainState

    def empty(tree):
        if isinstance(tree, dict):
            return {k: empty(v) for k, v in tree.items()}
        return torch.empty(0, device=dev)

    shapes = build_model(cfg).param_shapes()
    return {"state": TrainState(empty(shapes), empty(shapes), empty(shapes),
                                torch.empty(0, device=dev),
                                torch.empty(0, device=dev))}


def phase_d(torch, dev, digests_a: dict, smoke=False) -> dict:
    """D1 the fleet record, D2 the restores, D3 two replay hosts; returns
    the record fleet's kernel launches summed over its four processes."""
    import repro_torch.configs as C
    from repro_torch.checkpoint import CheckpointStore
    from repro_torch.utils.pytree import tree_digest, tree_leaves_with_paths

    shutil.rmtree(D_RUN, ignore_errors=True)
    os.makedirs(D_RUN)
    cfg = (C.get_smoke if smoke else C.get)("florbench-100m")
    # ---- D1 ----
    t0 = time.perf_counter()
    recs = d_wait("record", d_start("record", D_MESH[0] * D_MESH[1], dev,
                                    smoke), timeout=900)
    d1 = time.perf_counter() - t0
    store = CheckpointStore(os.path.join(D_RUN, "store"))
    for e in range(EPOCHS):
        m = store.get_manifest(f"train@{e}.0")
        if m is None or m.get("version") != 4 or len(m["members"]) != 4:
            fail(f"D1 epoch {e}: no stitched v4 with 4 members")
    if (store.get_meta("incomplete_ckpts") or {}).get("keys"):
        fail(f"D1 incomplete checkpoints: "
             f"{store.get_meta('incomplete_ckpts')}")
    counts: dict = {}
    state_bytes = 0
    for r in recs:
        if r["digests"] != recs[0]["digests"]:
            bad = [p for p in r["digests"]
                   if r["digests"][p] != recs[0]["digests"][p]]
            fail(f"D1 rank {r['rank']} trained another state than rank 0: "
                 f"{bad[:4]}")
        c = r["counts"]
        # first sight: #2 once per owned shard; later epochs #1
        if c.get("fingerprint") != r["n_owned"] or \
                c.get("fingerprint_changed") != r["n_owned"] * (EPOCHS - 1):
            fail(f"D1 rank {r['rank']}: launches {c} for {r['n_owned']} "
                 f"owned shards")
        for k, v in c.items():
            counts[k] = counts.get(k, 0) + v
        state_bytes += r["owned_bytes"]
        st = r["stats"]
        stitch = [x["stitch_s"] for x in st]
        say(f"D1 rank {r['rank']}: {r['n_owned']} shards, "
            f"{r['owned_bytes'] / 1e9:.4f} GB owned; #2 "
            f"{c.get('fingerprint')} / #1 {c.get('fingerprint_changed')} "
            f"launches; submit stall "
            f"{sum(x['submit_stall_s'] for x in st):.2f} s, writer "
            f"{sum(x['materialize_s'] for x in st):.2f} s for "
            f"{sum(x['shard_bytes'] for x in st) / 1e9:.4f} GB; stitch "
            + ("(lead) " if r["rank"] == 0 else "(publish) ")
            + ", ".join(f"{s:.2f}" for s in stitch) + " s; record "
            f"{r['wall_s']:.2f} s")
    if state_bytes != sum(
            int(lf["nbytes"]) for lf in store.get_manifest(D_TIP)["leaves"]):
        fail(f"D1 owned shards hold {state_bytes} bytes, not the state's")
    say(f"D1: (2, 2) fleet of 4 processes on one card, florbench-100m "
        f"{EPOCHS}x{STEPS} steps at {BATCH}x{SEQ}, {EPOCHS} epochs "
        f"stitched (v4 + 4 members each), {state_bytes / 1e9:.4f} GB state "
        f"covered once by the owned shards; wall {d1:.2f} s")
    # ---- D2a in this process, beside D2b's two processes and D3's two
    # replay hosts: none of the three reads what another writes ----
    run_a = os.path.join(WORK, "path_a")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    # their output goes to files: nothing reads it before D2 is done
    d3_logs = [(os.path.join(D_RUN, f"d3_host{h}.out"),
                os.path.join(D_RUN, f"d3_host{h}.err")) for h in (0, 1)]
    t3 = time.perf_counter()
    d3_procs = []
    for h, (out_p, err_p) in enumerate(d3_logs):
        with open(out_p, "w") as out_f, open(err_p, "w") as err_f:
            d3_procs.append(subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.replay",
                 "--run-dir", run_a, "--probe", "train", "--nworkers", "2",
                 "--check", "--batch", str(BATCH), "--seq", str(SEQ),
                 "--seed", str(SEED), "--device", torch.device(dev).type,
                 "--num-processes", "2", "--process-id", str(h),
                 "--merge-timeout", "600",
                 *(["--smoke"] if smoke else [])],
                cwd=ROOT, env=env, stdout=out_f, stderr=err_f))
    t0 = time.perf_counter()
    d2b_procs = d_start("restore", D_RESTORE_MESH[0] * D_RESTORE_MESH[1],
                        dev, smoke)
    try:
        t1 = time.perf_counter()
        rstats: dict = {}
        full = store.get_tree(D_TIP, like=placeholder_like(torch, cfg, dev),
                              stats_out=rstats)
        sync(torch, dev)
        d2a = time.perf_counter() - t1
        got = leaf_digests(full["state"])
        for name, want in (("the fleet's trained state", recs[0]["digests"]),
                           ("path A's A::train@1.0", digests_a)):
            if got != want:
                bad = [p for p in got if got[p] != want.get(p)]
                fail(f"D2a unsharded restore differs from {name}: {bad[:4]}")
        say(f"D2a: get_tree({D_TIP}) unsharded onto the card in {d2a:.2f} s "
            f"({state_bytes / d2a / 1e9:.3f} GB/s, {rstats['chunks_read']} "
            f"chunks from {len(rstats['bytes_by_shard'])} store shards); "
            f"all {len(got)} leaves bit-identical to the fleet's state and "
            f"to A::train@{EPOCHS - 1}.0")
        # ---- D2b ----
        rest = d_wait("restore", d2b_procs, timeout=600)
        d2b = time.perf_counter() - t0
    except BaseException:
        for p in d2b_procs + d3_procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        raise
    by_path = dict(tree_leaves_with_paths(full))
    for r in rest:
        for lf in r["leaves"]:
            x = by_path[lf["path"]]
            want = tree_digest(x[tuple(slice(lo, hi) for lo, hi in lf["box"])])
            if lf["digest"] != want:
                fail(f"D2b rank {r['rank']} {lf['path']} box {lf['box']} "
                     f"differs from its slice of the unsharded restore")
        mine = sum(lf["bytes"] for lf in r["leaves"])
        say(f"D2b rank {r['rank']}: restore_sharded_tree onto (1, 2) in "
            f"{r['restore_s']:.2f} s ({mine / r['restore_s'] / 1e9:.3f} "
            f"GB/s); read {r['bytes_read']} bytes ({r['chunks_read']} "
            f"chunks) for a {mine}-byte shard; every local shard equal to "
            f"its slice")
    del full, by_path
    torch.cuda.empty_cache()
    say(f"D2b: two processes, wall {d2b:.2f} s from their start")
    # ---- D3 ----
    outs = []
    try:
        for h, p in enumerate(d3_procs):
            p.wait(timeout=600)
            with open(d3_logs[h][0]) as f:
                out = f.read()
            outs.append(out)
            for line in out.strip().splitlines():
                say(f"  D3 host {h}| {line}")
            if p.returncode != 0:
                with open(d3_logs[h][1]) as f:
                    err = f.read()
                fail(f"D3 replay host {h} exited {p.returncode}:\n"
                     f"{err[-4000:]}")
    finally:
        for p in d3_procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    d3 = time.perf_counter() - t3
    m = re.search(r"deferred check: ok=(\w+) compared=(\d+) "
                  r"hindsight=(\d+)", outs[0])
    if not m or m[1] != "True":
        fail("D3 host 0 printed no passing deferred check")
    if int(m[3]) != EPOCHS * STEPS:
        fail(f"D3 hindsight rows {m[3]} != {EPOCHS * STEPS}")
    same = "R2 not run"
    if os.path.exists(R2_ROWS):
        if replay_rows(os.path.join(run_a, "logs", "merged_replay.jsonl")) \
                != replay_rows(R2_ROWS):
            fail("D3's merged rows differ from R2's")
        same = "merged rows equal R2's"
    say(f"D3: two replay hosts (--num-processes 2) over path A on the card, "
        f"wall {d3:.2f} s from their start; host 0: deferred check ok=True "
        f"compared {m[2]} hindsight {m[3]}; {same}")
    say(f"phase D: D1 {d1:.2f} s, then side by side D2a {d2a:.2f} s, D2b "
        f"{d2b:.2f} s and D3 {d3:.2f} s")
    return counts


# ------------------------------------------------------------------ main --
# kernel -> (CUDA source, the TPU kernel it replaces, its path); "record"
# kernels must have launched on paths A-C and A2-R3, "ops" kernels report the
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
        for extra in ("cases", "routes", "small_call_ms", "launch_floor_ms",
                      "mixtral_pass", "family_passes"):
            if extra in r:
                entry[extra] = r[extra]
        line.append(entry)
    return line


# kernels of this slice's path: their ptxas -v report is printed after the build
NEW_KERNELS = ("fp_kernel",)


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
    # phase F's deepseek-v3 step comes close to the card's memory, and
    # phase M leaves the caching allocator's segments split before it: let
    # segments grow in place instead
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    if sys.argv[1:2] == ["--d-child"]:
        # a phase D fleet process: role rank port device smoke batch seq
        global BATCH, SEQ
        role, rank, port, dev, smoke, BATCH, SEQ = sys.argv[2:9]
        BATCH, SEQ = int(BATCH), int(SEQ)
        d_child(role, int(rank), int(port), dev, smoke == "1")
        return
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

    def lap(tag):
        say(f"phase {tag} done at {time.perf_counter() - t_start:.1f} s")

    if "--mixtral-only" in sys.argv[1:]:
        phase_m(torch, dev, hbm_bps)
        lap("M")
        say("--mixtral-only: stopping after phase M")
        return
    if "--families-only" in sys.argv[1:]:
        phase_f(torch, dev, hbm_bps)
        lap("F")
        say("--families-only: stopping after phase F")
        return
    if "--serve-only" in sys.argv[1:]:
        phase_s(torch, dev, hbm_bps)
        lap("S")
        say("--serve-only: stopping after phase S")
        return
    if "--handsfree-only" in sys.argv[1:]:
        say(f"launches path H: {json.dumps(phase_h(torch, ops, dev))}")
        lap("H")
        say("--handsfree-only: stopping after phase H")
        return
    if "--dist-only" in sys.argv[1:]:
        # phase D reads path A's run (D2a's comparison, D3's replay)
        counts_a, state_a = main_path_a(torch, ops, dev)
        digests_a = leaf_digests(state_a)
        del state_a
        torch.cuda.empty_cache()
        lap("A")
        say(f"launches path D: {json.dumps(phase_d(torch, dev, digests_a))}")
        lap("D")
        say("--dist-only: stopping after phase D")
        return
    cfg = C.get("florbench-100m")
    results = kernel_phase(torch, dev, hbm_bps, cfg)
    if "--kernels-only" in sys.argv[1:]:
        say(json.dumps({k: {f: r[f] for f in ("ms", "plain_ms", "bound_ms",
                                               "library_ms", "max_abs_err")}
                        for k, r in results.items()}))
        say("--kernels-only: stopping after the kernel phases")
        return
    lap("kernels")
    # phase M before the florbench-100m paths: it needs most of the card
    for kname, r in phase_m(torch, dev, hbm_bps).items():
        results[kname]["mixtral_pass"] = r
    torch.cuda.empty_cache()
    lap("M")
    for arch, passes in phase_f(torch, dev, hbm_bps).items():
        for kname, r in passes.items():
            results[kname].setdefault("family_passes", {})[arch] = r
    lap("F")
    torch.cuda.empty_cache()
    phase_s(torch, dev, hbm_bps)
    torch.cuda.empty_cache()
    lap("S")
    counts_h = phase_h(torch, ops, dev)
    lap("H")
    model_check(torch, dev)
    counts_a, state_a = main_path_a(torch, ops, dev)
    digests_a = leaf_digests(state_a)
    lap("A")
    replay_r2(torch, dev)
    lap("R2")
    counts_r1 = replay_r1(torch, dev, cfg, state_a)
    del state_a
    lap("R1")
    # B and C at the lineage paths' cut (2 of 12 layers, full width): the
    # writer's minutes a full-depth checkpoint costs went to phase D
    cfg_lin = cfg.replace(num_layers=LIN_LAYERS)
    counts_b = session_path(torch, ops, dev, cfg_lin, "b", B_BOUNDS,
                            B_EPOCHS)
    lap("B")
    counts_c = session_path(torch, ops, dev, cfg_lin, "c", TIGHT_BOUNDS,
                            C_EPOCHS)
    lap("C")
    counts_a2 = path_a2(torch, ops, dev)
    lap("A2")
    counts_w, state_w = path_w(torch, ops, dev)
    lap("W")
    counts_w2 = path_w2(torch, ops, dev, cfg_lin)
    lap("W2")
    counts_r3 = replay_r3(torch, dev, cfg_lin, state_w)
    del state_w
    lap("R3")
    path_q(torch)
    lap("Q")
    torch.cuda.empty_cache()
    counts_d = phase_d(torch, dev, digests_a)
    lap("D")
    paths = {"A": counts_a, "R1": counts_r1, "B": counts_b, "C": counts_c,
             "A2": counts_a2, "W": counts_w, "W2": counts_w2,
             "R3": counts_r3, "H": counts_h, "D": counts_d}
    for tag, counts in paths.items():
        say(f"launches path {tag}: {json.dumps(counts)}")
    say(json.dumps({"kernels": kernels_line(results, paths)}))
    shutil.rmtree(WORK, ignore_errors=True)
    say(f"total wall {time.perf_counter() - t_start:.1f} s")
    say(smi_line())
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
