"""The benchmark's spans and its reading of the profiler's device timeline.

Spans are ``torch.profiler.record_function`` ranges named ``portbench.*``
around the benchmark's own calls into the program (a step, the logging of
its scalars); they cost nothing while no profiler runs. ``Tracer.start`` /
``stop`` profile one stretch of the window (CPU and CUDA activity) inside a
``portbench.window`` range, and ``summarize`` reduces it to what the result
line carries: the device's busy seconds (the union of every kernel, copy
and set on the card) against the window's length, the device operations
that took most time, and the longest idle gaps named by what the host was
doing when each began.
"""
from __future__ import annotations

import contextlib

import torch

WINDOW = "portbench.window"
TOP = 10


class Tracer:
    def __init__(self, enabled: bool):
        self.enabled = enabled
        self._prof = self._win = None

    def span(self, name: str):
        if not self.enabled:
            return contextlib.nullcontext()
        return torch.profiler.record_function(name)

    def start(self):
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.start()
        self._win = torch.profiler.record_function(WINDOW)
        self._win.__enter__()

    def stop(self):
        self._win.__exit__(None, None, None)
        self._prof.stop()

    def summary(self) -> dict:
        """``summarize`` of the stretch profiled (after the window)."""
        events = self._prof.profiler.kineto_results.events()
        self._prof = self._win = None
        return summarize(events)


def _is_device(e) -> bool:
    if e.device_type() != torch.autograd.DeviceType.CUDA:
        return False
    if getattr(e, "is_user_annotation", lambda: False)():
        return False
    return not e.name().startswith("portbench.")


def summarize(events) -> dict:
    wins = [e for e in events if e.name() == WINDOW
            and e.device_type() == torch.autograd.DeviceType.CPU]
    if not wins:
        raise RuntimeError("the profiled window left no range in the trace")
    w0 = wins[0].start_ns()
    w1 = w0 + wins[0].duration_ns()
    dev, by_name = [], {}
    for e in events:
        if not _is_device(e):
            continue
        s, t = e.start_ns(), e.start_ns() + e.duration_ns()
        s, t = max(s, w0), min(t, w1)
        if t <= s:
            continue
        dev.append((s, t))
        by_name[e.name()] = by_name.get(e.name(), 0) + (t - s)
    dev.sort()
    busy, gaps, cur_s, cur_t = 0, [], None, w0
    for s, t in dev:
        if s > cur_t:
            gaps.append((cur_t, s - cur_t))
            if cur_s is not None:
                busy += cur_t - cur_s
            cur_s = s
        elif cur_s is None:
            cur_s = s
        cur_t = max(cur_t, t)
    if cur_s is not None:
        busy += cur_t - cur_s
    if w1 > cur_t:
        gaps.append((cur_t, w1 - cur_t))
    host = [e for e in events
            if e.device_type() == torch.autograd.DeviceType.CPU
            and e.name() != WINDOW]
    longest = sorted(gaps, key=lambda g: -g[1])[:TOP]
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return {
        "busy_s": busy / 1e9, "window_s": (w1 - w0) / 1e9,
        "device_ops": [[n[:160], ns / 1e9] for n, ns in ops],
        "idle_gaps": [[_host_at(host, s + ns // 2), ns / 1e9]
                      for s, ns in longest],
    }


def _host_at(host, t: int) -> str:
    """The benchmark span and the innermost host operation running at
    ``t`` (ns, the middle of a gap), joined by '/'."""
    span, inner = None, None
    for e in host:
        s = e.start_ns()
        if s <= t < s + e.duration_ns():
            if e.name().startswith("portbench."):
                if span is None or s > span[0]:
                    span = (s, e.name())
            elif inner is None or s > inner[0]:
                inner = (s, e.name())
    parts = [p[1] for p in (span, inner) if p is not None]
    return "/".join(parts) if parts else "python, no op"
