"""The port's profiler spans (``repro_torch.utils.timing.span``) and the
benchmark's reading of them (``portbench.spans``).

- With no profiler a span enters no ``record_function``: a train step and
  a record ``Session`` run with it patched to raise.
- A step's bits are the same with a profiler running and without.
- Under a profiler each span opens as often a step as the model says:
  ``repro_torch.attention`` and ``.ffn`` (in a MoE block, with
  ``repro_torch.moe.*`` inside it) once a block in the forward and once
  more in remat's recompute; the Flor spans once a ``flor.log`` and twice
  a block occurrence.
- ``portbench.spans.attribute`` on synthetic events: a launch on the
  span's own thread, one on autograd's thread linked by ``sequence_nr``,
  the attention chunks' recompute nested in the layer's, one on a thread
  with no span, and the idle gaps.
- On a real CPU trace of the smoke step, every backward node whose forward
  op ran in ``repro_torch.attention`` is attributed to it.
- The program's spans leave ``portbench.trace.summarize`` as it was.
"""
import collections

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import repro_torch.configs as C
import repro_torch.flor as flor
from portbench import spans
from portbench.trace import WINDOW, summarize
from repro_torch.data import synthetic_batch
from repro_torch.train.step import build_train_step
from repro_torch.utils import timing
from repro_torch.utils.pytree import tree_digest

CPU = torch.autograd.DeviceType.CPU
CUDA = torch.autograd.DeviceType.CUDA


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfg(arch="florbench-100m", **over):
    """A smoke config with remat on and the chunked attention forced (two
    KV chunks at 32 positions)."""
    return C.get_smoke(arch).replace(attention_impl="chunked",
                                     attention_chunk=16, **over)


def _step(cfg):
    init, step = build_train_step(cfg, device="cpu")
    return init(0), step, synthetic_batch(cfg, 2, 32, 0)


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function(WINDOW):
            out = fn()
    return out, prof.profiler.kineto_results.events()


def _counts(events) -> collections.Counter:
    return collections.Counter(e.name() for e in events
                               if e.name().startswith(spans.SPAN))


def _raise(*a, **k):
    raise AssertionError("record_function entered with no profiler")


def test_span_is_one_shared_null_context_without_profiler():
    assert timing.span("a") is timing.span("b")
    with profile(activities=[ProfilerActivity.CPU]):
        assert isinstance(timing.span("a"),
                          torch.profiler.record_function)
    assert timing.span("a") is timing.span("b")


def test_no_profiler_no_record_function(monkeypatch, tmp_path):
    cfg = _cfg()
    state, step, batch = _step(cfg)
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _raise)
    new, m = step(state, batch)
    assert torch.isfinite(m["loss"])
    with flor.Session(str(tmp_path / "run"),
                      record=flor.RecordSpec(adaptive=False)) as sess:
        with sess.checkpointing(state=new) as ckpt:
            for _ in sess.loop("epochs", range(2)):
                for _ in sess.loop("train", range(1)):
                    ckpt.state, m = step(ckpt.state, batch)
                    flor.log("loss", m["loss"])


@pytest.mark.parametrize("arch", ["florbench-100m", "mixtral-8x7b"])
def test_step_bits_equal_under_profiler(arch):
    cfg = _cfg(arch)
    state, step, batch = _step(cfg)
    plain, pm = step(state, batch)
    (traced, tm), _ = _profiled(lambda: step(state, batch))
    assert tree_digest(plain) == tree_digest(traced)
    assert pm["loss"].view(torch.int32).item() \
        == tm["loss"].view(torch.int32).item()


@pytest.mark.parametrize("arch,remat", [("florbench-100m", True),
                                        ("florbench-100m", False),
                                        ("mixtral-8x7b", True)])
def test_span_counts_per_step(arch, remat):
    cfg = _cfg(arch, remat=remat)
    state, step, batch = _step(cfg)
    _, events = _profiled(lambda: step(state, batch))
    passes = 2 if remat else 1
    # a MoE layer's stages open inside its ffn span
    moe = ("route", "dispatch", "experts", "combine") if cfg.moe else ()
    assert _counts(events) == {
        "repro_torch.step.forward": 1, "repro_torch.step.backward": 1,
        "repro_torch.step.optimizer": 1, "repro_torch.head": 1,
        "repro_torch.attention": cfg.num_layers * passes,
        "repro_torch.ffn": cfg.num_layers * passes,
        **{"repro_torch.moe." + s: cfg.num_layers * passes for s in moe}}


def test_flor_spans_in_record_session(tmp_path):
    cfg = _cfg()
    state, step, batch = _step(cfg)
    epochs, steps, keys = 2, 2, ("loss", "grad_norm")

    def record():
        with flor.Session(str(tmp_path / "run"),
                          record=flor.RecordSpec(adaptive=False)) as sess:
            with sess.checkpointing(state=state) as ckpt:
                for _ in sess.loop("epochs", range(epochs)):
                    for _ in sess.loop("train", range(steps)):
                        ckpt.state, m = step(ckpt.state, batch)
                        for k in keys:
                            flor.log(k, m[k])

    _, events = _profiled(record)
    got = _counts(events)
    assert got["repro_torch.flor.log"] == epochs * steps * len(keys)
    # the train block opens and closes once an epoch
    assert got["repro_torch.flor.block"] == 2 * epochs
    assert got["repro_torch.step.forward"] == epochs * steps


# ---------------------------------------------------------- synthetic ----

class Ev:
    """An event with the profiler's accessors."""

    def __init__(self, name, start, dur, tid=1, corr=0, linked=0, seq=-1,
                 fwd=0, device=CPU, kind="cpu_op"):
        self._v = dict(name=name, start=start, dur=dur, tid=tid, corr=corr,
                       linked=linked, seq=seq, fwd=fwd, device=device,
                       kind=kind)

    def name(self):
        return self._v["name"]

    def device_type(self):
        return self._v["device"]

    def activity_type(self):
        return self._v["kind"]

    def start_ns(self):
        return self._v["start"]

    def duration_ns(self):
        return self._v["dur"]

    def start_thread_id(self):
        return self._v["tid"]

    def correlation_id(self):
        return self._v["corr"]

    def linked_correlation_id(self):
        return self._v["linked"]

    def sequence_nr(self):
        return self._v["seq"]

    def fwd_thread_id(self):
        return self._v["fwd"]

    def is_user_annotation(self):
        return self._v["kind"] == "user_annotation" \
            or self._v["kind"] == "gpu_user_annotation"


class Trace:
    """Builds a synthetic event list: host ranges, ops and the kernels they
    launch, each with fresh correlation ids."""

    def __init__(self):
        self.events = [Ev(WINDOW, 0, 10_000, kind="user_annotation")]
        self.corr = 100

    def _id(self):
        self.corr += 1
        return self.corr

    def span(self, name, start, end, tid=1):
        self.events.append(Ev(name, start, end - start, tid, self._id(),
                              kind="user_annotation"))
        # the range's copy on the device timeline, as CUPTI gives it
        self.events.append(Ev(name, start + 5, end - start, 0, 0,
                              device=CUDA, kind="gpu_user_annotation"))

    def node(self, start, end, tid, fwd, seq):
        self.events.append(Ev(spans.NODE + ": MmBackward0", start,
                              end - start, tid, self._id(), seq=seq,
                              fwd=fwd))

    def op(self, name, start, end, tid=1, seq=-1):
        corr = self._id()
        self.events.append(Ev(name, start, end - start, tid, corr, seq=seq))
        return corr

    def kernel(self, name, launched_by, start, dur, runtime_tid=1):
        """A kernel linked to the op ``launched_by`` (None: launched by a
        thread the profiler does not record), after its runtime call."""
        corr = self._id()
        self.events.append(Ev("cudaLaunchKernel", start - 50, 5,
                              runtime_tid, corr, linked=launched_by or 0,
                              kind="cuda_runtime"))
        self.events.append(Ev(name, start, dur, 0, corr,
                              linked=launched_by or 0, device=CUDA,
                              kind="kernel"))


def _synthetic():
    t = Trace()
    # main thread (1): forward, backward, optimizer phases
    t.span("repro_torch.step.forward", 100, 1000)
    t.op("_Recomputed", 120, 900, seq=1)               # the layer's remat
    t.span("repro_torch.attention", 150, 400)
    a = t.op("aten::mm", 160, 200, seq=2)              # same-thread launch
    t.op("_Recomputed", 250, 300, seq=3)               # a chunk's remat
    t.span("repro_torch.ffn", 450, 700)
    f = t.op("aten::mm", 460, 500, seq=4)
    e = t.op("aten::embedding", 110, 115, seq=5)       # the phase's own
    t.kernel("attn_gemm", a, 1000, 100)
    t.kernel("ffn_gemm", f, 1100, 200)
    t.kernel("embed", e, 1300, 50)
    t.span("repro_torch.step.backward", 2000, 6000)
    # autograd's thread (2): the FFN's node, linked back by sequence_nr
    t.node(2100, 2200, tid=2, fwd=1, seq=4)
    g = t.op("aten::mm", 2110, 2150, tid=2)
    t.kernel("ffn_grad", g, 2200, 300)
    # the layer's recompute node: its launches outside a layer span go to
    # the backward phase; the recompute inside the attention span to it
    t.node(2300, 4000, tid=2, fwd=1, seq=1)
    r = t.op("aten::add", 2310, 2320, tid=2)
    t.kernel("residual", r, 2500, 40)
    t.span("repro_torch.attention", 2400, 2600, tid=2)
    rc = t.op("aten::mm", 2410, 2450, tid=2, seq=20)
    t.op("_Recomputed", 2460, 2500, tid=2, seq=21)     # the chunk's, again
    t.kernel("attn_recompute", rc, 2600, 100)
    # the chunk's node inside the layer's: its own recompute (no span) and
    # a node nested in it, both back to attention
    t.node(2700, 3500, tid=2, fwd=2, seq=21)
    cr = t.op("aten::exp", 2710, 2720, tid=2, seq=30)
    t.kernel("chunk_exp", cr, 2800, 100)
    t.node(2800, 3000, tid=2, fwd=2, seq=30)
    cg = t.op("aten::mul", 2810, 2820, tid=2)
    t.kernel("chunk_exp_grad", cg, 2950, 50)
    # the embedding's node: its forward op ran in the phase alone
    t.node(4100, 4200, tid=2, fwd=1, seq=5)
    eg = t.op("aten::embedding_dense_backward", 4110, 4120, tid=2)
    t.kernel("embed_grad", eg, 4200, 100)
    t.span("repro_torch.step.optimizer", 7000, 9000)
    o = t.op("aten::_foreach_mul_", 7010, 7100)
    t.kernel("adamw", o, 7200, 1000)
    # a writer thread's copy, its runtime call alone in the trace (and
    # labelled with the main thread, inside the optimizer's span)
    t.kernel("Memcpy DtoH", None, 8500, 100)
    t.kernel("tail", t.op("aten::copy_", 9100, 9110), 9990, 100)
    return t.events


def test_attribute_synthetic_trace():
    got = spans.attribute(_synthetic())
    ms = {k: v["device_s"] * 1e9 for k, v in got["spans"].items()}
    assert ms == pytest.approx({
        "repro_torch.attention": 100 + 100 + 100 + 50,
        "repro_torch.ffn": 200 + 300,
        "repro_torch.step.forward": 50,
        "repro_torch.step.backward": 40 + 100,
        "repro_torch.step.optimizer": 1000,
        "unattributed": 100 + 10,      # the tail clipped at the window
    })
    by = got["spans"]
    assert by["repro_torch.attention"]["calls"] == 2
    assert by["repro_torch.attention"]["top_ops"][0] == ["attn_gemm", 1e-7]
    assert by["repro_torch.step.optimizer"]["host_s"] == pytest.approx(2e-6)
    assert sum(v["device_s"] for v in by.values()) == \
        pytest.approx(got["busy_s"])
    assert got["busy_s"] == pytest.approx(summarize(_synthetic())["busy_s"])
    ops = dict((n, split) for n, split in got["ops"])
    assert ops["adamw"] == {"repro_torch.step.optimizer": pytest.approx(1e-6)}
    # the longest gap, 4300..7200, has its middle in the backward phase;
    # 0..1000's middle is in the FFN's span; 8600..9990 is under no span
    assert got["idle_gaps"][0] == ["repro_torch.step.backward",
                                   pytest.approx(2.9e-6)]
    assert ["repro_torch.ffn", pytest.approx(1e-6)] in got["idle_gaps"]
    assert ["no span", pytest.approx(1.39e-6)] in got["idle_gaps"]
    assert spans.layer_ms(got, 2) == pytest.approx({
        "attention_ms": 350e-6 / 2, "ffn_ms": 500e-6 / 2,
        "optimizer_ms": 1000e-6 / 2, "step_rest_ms": 190e-6 / 2})


def test_layer_ms_of_a_program_without_spans():
    t = Trace()
    t.kernel("k", t.op("aten::mm", 10, 20), 100, 50)
    got = spans.attribute(t.events)
    assert spans.layer_ms(got, 1) == {}
    assert got["spans"]["unattributed"]["device_s"] == pytest.approx(5e-8)


def test_backward_of_layers_links_back_on_a_real_trace():
    """A kernel launched in each backward node of a real CPU trace goes to
    the layer span its forward op ran in: every node made in
    ``repro_torch.attention`` (the chunks' remat nodes among them) goes
    back to it, and every node made in ``repro_torch.ffn`` to that."""
    cfg = _cfg()
    state, step, batch = _step(cfg)
    _, events = _profiled(lambda: step(state, batch))
    events = list(events)
    layer = {n: [(e.start_thread_id(), e.start_ns(),
                  e.start_ns() + e.duration_ns()) for e in events
                 if e.name() == n]
             for n in ("repro_torch.attention", "repro_torch.ffn")}

    def made_in(e):
        for name, ranges in layer.items():
            if any(tid == e.start_thread_id() and s <= e.start_ns() < t
                   for tid, s, t in ranges):
                return name
        return None

    made = {(e.start_thread_id(), e.sequence_nr()): made_in(e)
            for e in reversed(events) if e.sequence_nr() >= 0
            and e.fwd_thread_id() == 0
            and not e.name().startswith(spans.NODE)}
    want = collections.Counter()
    for i, n in enumerate(e for e in list(events)
                          if e.name().startswith(spans.NODE)):
        where = made.get((n.fwd_thread_id(), n.sequence_nr()))
        if where is None:
            continue
        want[where] += 1
        events.append(Ev("from " + where, n.start_ns(), 1, 0, 10 ** 9 + i,
                         linked=n.correlation_id(), device=CUDA,
                         kind="kernel"))
    # each layer's forward makes nodes; the chunks' remat makes more
    assert want["repro_torch.attention"] >= 10 * cfg.num_layers
    assert want["repro_torch.ffn"] >= 2 * cfg.num_layers
    ops = dict(spans.attribute(events)["ops"])
    for where, n in want.items():
        assert ops["from " + where] == {where: pytest.approx(n * 1e-9)}


def test_summarize_unchanged_by_program_spans():
    t = Trace()
    t.span("portbench.step", 50, 9000)
    a = t.op("aten::mm", 100, 200)
    t.kernel("gemm", a, 300, 400)
    t.kernel("copy", t.op("aten::copy_", 250, 260), 800, 100)
    t.kernel("gemm", t.op("aten::mm", 900, 950), 2000, 500)
    bare = summarize(t.events)
    t.span("repro_torch.step.forward", 80, 5000)
    t.span("repro_torch.attention", 90, 1000)
    full = summarize(t.events)
    for key in ("busy_s", "window_s", "device_ops"):
        assert full[key] == bare[key], key
    assert [g[1] for g in full["idle_gaps"]] == \
        [g[1] for g in bare["idle_gaps"]]
    assert not any(n.startswith("repro_torch.")
                   for n, _ in full["device_ops"])
