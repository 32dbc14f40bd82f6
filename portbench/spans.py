"""Device time by the program's spans, read from the profiler's events.

The program opens ``torch.profiler.record_function`` ranges named
``repro_torch.*`` at its layer boundaries while a profiler runs
(``repro_torch.utils.timing.span``): the step's phases
(``repro_torch.step.forward`` / ``.backward`` / ``.optimizer``), its layers
(``repro_torch.attention``, ``.ffn``, ``.head``) and Flor's record path
(``repro_torch.flor.log``, ``.block``). ``attribute(events)`` takes the
events of a stretch profiled inside the benchmark's window range
(``kineto_results.events()``) and gives each device event (kernel, copy,
set) to one span:

1. its launch is the host operation it links to (``linked_correlation_id``
   against the operations' ``correlation_id``): the innermost operation or
   range open around the runtime call that launched it, on that call's
   thread. An event launched outside every operation (a thread the
   profiler does not record, such as Flor's log writer) has none;
2. the innermost span or autograd node (``autograd::engine::
   evaluate_function``) on that thread covering the launch decides; a span
   wins;
3. a node stands for the forward operation that created it (the node's
   ``fwd_thread_id`` and ``sequence_nr``), which is followed through nodes
   run inside nodes (a recompute's own backward) to the span it ran in:
   remat's recompute and the attention chunks' recompute go to the layer
   whose forward made them. Where that is a phase span, or nothing, the
   launch goes to the innermost span on any thread covering it: the main
   thread's ``repro_torch.step.backward`` while autograd's thread runs;
4. else "unattributed".

Each span gets the union of its events' intervals clipped to the window,
its host time (the union of its ranges) and its top device operations; the
longest idle gaps of the device get the innermost span at their middle.
``layer_ms`` turns that into the per-step milliseconds of each layer.
"""
from __future__ import annotations

import collections

import torch

from portbench.trace import TOP, WINDOW, _is_device

SPAN = "repro_torch."
PHASE = "repro_torch.step."
NODE = "autograd::engine::evaluate_function"
NONE = "unattributed"
GAP_NONE = "no span"
# host operations a device event's linked_correlation_id refers to; the
# runtime's calls (cudaLaunchKernel, ...) number theirs apart
OP_KINDS = ("cpu_op", "user_annotation")

# per-step milliseconds of each layer: device time of these spans
LAYERS = {
    "attention_ms": ("repro_torch.attention",),
    "ffn_ms": ("repro_torch.ffn",),
    "head_ms": ("repro_torch.head",),
    "optimizer_ms": ("repro_torch.step.optimizer",),
    # the phases' own time: embedding, norms, residuals, unclaimed copies
    "step_rest_ms": ("repro_torch.step.forward",
                     "repro_torch.step.backward"),
}
# per-step milliseconds of host time inside these spans
FLOR = ("repro_torch.flor.log", "repro_torch.flor.block")

_CPU = torch.autograd.DeviceType.CPU


def _kind(e) -> str:
    """The event's kind; before ``activity_type`` (torch 2.13) a call into
    the CUDA API is told by its name (cudaLaunchKernel, cuLaunchKernelEx,
    ...)."""
    try:
        return str(e.activity_type())
    except AttributeError:
        if e.name().startswith("cu"):
            return "cuda_runtime"
        return "user_annotation" if e.is_user_annotation() else "cpu_op"


def _window(events):
    for e in events:
        if e.name() == WINDOW and e.device_type() == _CPU:
            return e.start_ns(), e.start_ns() + e.duration_ns()
    raise RuntimeError("the profiled window left no range in the trace")


def _union(iv) -> tuple[int, list]:
    """(covered ns, the gaps between the intervals as (start, ns))."""
    busy, gaps, cur_s, cur_t = 0, [], None, None
    for s, t in sorted(iv):
        if cur_t is not None and s > cur_t:
            busy += cur_t - cur_s
            gaps.append((cur_t, s - cur_t))
            cur_s = None
        if cur_s is None:
            cur_s, cur_t = s, t
        cur_t = max(cur_t, t)
    if cur_s is not None:
        busy += cur_t - cur_s
    return busy, gaps


class _Threads:
    """The spans and autograd nodes open on each host thread, walked in
    time order: ``push`` an interval when it starts, ``owner`` at a point
    once every interval starting by then has been pushed."""

    def __init__(self):
        self.stacks = collections.defaultdict(list)
        # (thread, sequence_nr) of a forward op -> the span it ran in
        self.made_in = {}

    def _alive(self, tid, t):
        st = self.stacks[tid]
        while st and st[-1][0] <= t:
            st.pop()
        return st

    def push(self, tid, t, end, kind, what):
        self._alive(tid, t).append((end, t, kind, what))

    def any_span(self, t):
        """The innermost span open on any thread at ``t``."""
        best = None
        for tid in list(self.stacks):
            for end, start, kind, what in self._alive(tid, t):
                if kind == "span" and (best is None or start > best[0]):
                    best = (start, what)
        return best[1] if best else None

    def owner(self, tid, t):
        st = self._alive(tid, t)
        if not st:
            return None
        _, _, kind, what = st[-1]
        if kind == "span":
            return what
        # a node: the span that its forward op ran in, if a layer's
        if what is not None and not what.startswith(PHASE):
            return what
        return self.any_span(t)


def attribute(events) -> dict:
    """Device time of each span over the profiled window (see the module's
    docstring): {"spans": {name: {"device_s", "host_s", "calls",
    "top_ops"}} with "unattributed" among the names, "ops": the top device
    operations with their seconds by span, "idle_gaps": the longest gaps
    with the innermost span at their middle}."""
    w0, w1 = _window(events)
    ops, dev, host = {}, [], []
    for e in events:
        if e.device_type() != _CPU:
            if _is_device(e):
                dev.append(e)
        elif _kind(e) in OP_KINDS:
            ops.setdefault(e.correlation_id(), e)
            if e.name().startswith(SPAN) or e.name().startswith(NODE) \
                    or e.sequence_nr() >= 0:
                host.append(e)

    # the walk: intervals (outer first) before the points at one time
    PUSH, FWD, LAUNCH = 0, 1, 2
    walk = []
    for e in host:
        s, d, tid = e.start_ns(), e.duration_ns(), e.start_thread_id()
        name = e.name()
        if name.startswith(SPAN):
            walk.append((s, PUSH, -d, tid, "span", name))
        elif name.startswith(NODE):
            walk.append((s, PUSH, -d, tid, "node",
                         (e.fwd_thread_id(), e.sequence_nr())))
        elif e.fwd_thread_id() == 0:
            walk.append((s, FWD, 0, tid, None, e.sequence_nr()))
    for i, e in enumerate(dev):
        op = ops.get(e.linked_correlation_id() or None)
        if op is not None:
            walk.append((op.start_ns(), LAUNCH, 0, op.start_thread_id(),
                         None, i))
    walk.sort(key=lambda w: w[:3])
    threads, owner_of = _Threads(), [NONE] * len(dev)
    for s, what, negd, tid, kind, x in walk:
        if what == PUSH:
            if kind == "node":
                x = threads.made_in.get(x)
            threads.push(tid, s, s - negd, kind, x)
        elif what == FWD:
            threads.made_in.setdefault((tid, x), threads.owner(tid, s))
        else:
            owner_of[x] = threads.owner(tid, s) or NONE

    spans = collections.defaultdict(lambda: {"iv": [], "ops": {}})
    by_op = collections.defaultdict(lambda: collections.defaultdict(int))
    every = []
    for e, who in zip(dev, owner_of):
        s, t = max(e.start_ns(), w0), min(e.start_ns() + e.duration_ns(), w1)
        if t <= s:
            continue
        every.append((s, t))
        rec = spans[who]
        rec["iv"].append((s, t))
        rec["ops"][e.name()] = rec["ops"].get(e.name(), 0) + (t - s)
        by_op[e.name()][who] += t - s
    host_iv = collections.defaultdict(list)
    calls = collections.Counter()
    for e in host:
        if e.name().startswith(SPAN):
            s = max(e.start_ns(), w0)
            t = min(e.start_ns() + e.duration_ns(), w1)
            calls[e.name()] += 1
            if t > s:
                host_iv[e.name()].append((s, t))
    out = {}
    for name in sorted(set(spans) | set(calls)):
        rec = spans.get(name) or {"iv": [], "ops": {}}
        top = sorted(rec["ops"].items(), key=lambda kv: -kv[1])[:TOP]
        out[name] = {"device_s": _union(rec["iv"])[0] / 1e9,
                     "host_s": _union(host_iv[name])[0] / 1e9,
                     "calls": calls[name],
                     "top_ops": [[n[:160], ns / 1e9] for n, ns in top]}
    busy, gaps = _union(every)
    if every:
        first = min(s for s, _ in every)
        last = max(t for _, t in every)
        gaps = [(w0, first - w0)] * (first > w0) + gaps \
            + [(last, w1 - last)] * (w1 > last)
    longest = sorted(gaps, key=lambda g: -g[1])[:TOP]
    top_ops = sorted(by_op.items(), key=lambda kv: -sum(kv[1].values()))
    return {
        "spans": out,
        "busy_s": busy / 1e9,
        "ops": [[n[:160], {w: ns / 1e9 for w, ns in sorted(
            split.items(), key=lambda kv: -kv[1])}]
                for n, split in top_ops[:TOP]],
        "idle_gaps": [[_span_at(host, s + ns // 2), ns / 1e9]
                      for s, ns in longest],
    }


def _span_at(host, t: int) -> str:
    """The innermost program span on any thread at ``t``."""
    best = None
    for e in host:
        s = e.start_ns()
        if e.name().startswith(SPAN) and s <= t < s + e.duration_ns() \
                and (best is None or s > best[0]):
            best = (s, e.name())
    return best[1] if best else GAP_NONE


def layer_ms(spans: dict, steps: int) -> dict:
    """Per-step milliseconds of each layer (``LAYERS``) and of the host
    time in Flor's spans (``flor_host_ms``), from ``attribute``'s result
    over ``steps`` profiled steps; a layer whose spans never ran is left
    out (a program that opens none gives {})."""
    by = spans["spans"]
    out = {}
    for metric, names in LAYERS.items():
        if any(n in by for n in names):
            out[metric] = sum(by[n]["device_s"] for n in names
                              if n in by) * 1e3 / steps
    if any(n in by for n in FLOR):
        out["flor_host_ms"] = sum(by[n]["host_s"] for n in FLOR
                                  if n in by) * 1e3 / steps
    return out
