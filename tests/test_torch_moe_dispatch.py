"""The MoE layer's dispatch and combine (``moe_local``), on the CPU.

- Each of its two gathers (``_PadGather``), on the index maps the layer
  makes, against the zero-pad-row indexing it replaces: the same rows and
  the same gradient, bit for bit but the sign of a zero, so the layer's
  output and every gradient are those of the pad-row gathers. At capacity
  factor 1.25, where choices drop, and 8.0, where none do; in float32 and
  bfloat16; over all experts and over each half of them (``e_offset`` /
  ``e_local``, an expert-parallel rank's share).
- The mixtral smoke layer against the benchmark's plain float32 reference
  (``portbench.reference.model.moe``) given the port's own choices of
  experts.
- The layer's spans open under a profiler, inside ``repro_torch.ffn``; the
  backward of each gather is attributed to the span its forward ran in;
  and they leave ``portbench.trace.summarize`` as it was.
"""
import collections
import dataclasses

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import repro_torch.configs as C
from portbench import spans
from portbench.reference import model as ref
from portbench.trace import WINDOW, summarize
from repro_torch.data import synthetic_batch
from repro_torch.models import moe
from repro_torch.models.params import init_params
from repro_torch.train.step import build_train_step
from test_torch_trace import CUDA, Ev

# Both sides compute in float32 and differ only in the order of their sums
# (einsum against bmm, an expert-ordered index_add against a k-ordered sum
# of gathered rows), so each output and gradient is within 1e-5 of its
# largest magnitude, as in tests/test_torch_moe.py; the choices given are
# the same, so the drop share is equal.
RTOL_F32 = 1e-5
MOE_SPANS = ("repro_torch.moe.route", "repro_torch.moe.dispatch",
             "repro_torch.moe.experts", "repro_torch.moe.combine")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfg(dtype, capacity_factor):
    cfg = C.get_smoke("mixtral-8x7b").replace(dtype=dtype)
    return cfg.replace(moe=dataclasses.replace(
        cfg.moe, capacity_factor=capacity_factor))


def _layer(cfg, seed=1, T=128):
    """The MoE leaves (f32) and tokens leaning towards expert 0, so that
    at capacity factor 1.25 it drops the choices past its slots."""
    p = init_params(moe.moe_spec(cfg), seed, "float32", "cpu")
    g = torch.Generator().manual_seed(seed)
    r0 = p["router"][:, 0]
    x = torch.randn(T, cfg.d_model, generator=g) + 3.0 * r0 / r0.norm()
    probe = torch.randn(T, cfg.d_model, generator=g)
    return p, x, probe


def _gathers(cfg, p, x, cap, **share):
    """The (rows, index, inverse) of each ``_PadGather`` that
    ``moe_local`` makes on these inputs: the dispatch's, then the
    combine's."""
    seen = []
    apply = moe._PadGather.apply

    def spy(rows, idx, inv):
        seen.append((rows.detach(), idx, inv))
        return apply(rows, idx, inv)

    moe._PadGather.apply = spy
    try:
        moe.moe_local(cfg, p, x.to(getattr(torch, cfg.dtype)), cap, **share)
    finally:
        moe._PadGather.apply = apply
    return seen


def _bits(t):
    """The bits of ``t`` with -0 read as +0."""
    t = t.detach() + 0.0
    return t.view({4: torch.int32, 2: torch.int16}[t.element_size()])


@pytest.mark.parametrize("share", [{}, {"e_offset": 0, "e_local": 2},
                                   {"e_offset": 2, "e_local": 2}],
                         ids=["all", "first-half", "second-half"])
@pytest.mark.parametrize("capacity_factor", [1.25, 8.0],
                         ids=["drops", "no-drops"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gathers_match_pad_row_gathers_bit_for_bit(dtype, capacity_factor,
                                                   share):
    """Each gather of the layer, on the index maps the layer makes, gives
    the pad-row gather's rows and gradient bit for bit but the sign of a
    zero (an indexing backward sums each row into a zero buffer, which
    turns -0 into +0), and its two maps undo each other."""
    cfg = _cfg(dtype, capacity_factor)
    p, x, _ = _layer(cfg)
    T = x.shape[0]
    if share:       # the partial experts' weights, as a rank holds them
        lo, n = share["e_offset"], share["e_local"]
        p = dict(p, experts={k: v[lo:lo + n]
                             for k, v in p["experts"].items()})
    seen = _gathers(cfg, p, x, moe.capacity(cfg, T), **share)
    assert len(seen) == 2
    (_, src, slot), _ = seen
    # the slot map undoes the source map: the pad index aside, each is
    # the other's inverse
    assert torch.equal(slot[src[src < slot.numel()]],
                       torch.nonzero(src < slot.numel()).flatten())
    if not share:       # a dropped choice reads the pad slot
        assert bool((slot == src.numel()).any()) == (capacity_factor == 1.25)
    g = torch.Generator().manual_seed(7)
    for rows, idx, inv in seen:
        rows = rows.clone().requires_grad_(True)
        up = torch.randn(idx.numel(), rows.shape[1], generator=g) \
            .to(rows.dtype)
        y = moe._PadGather.apply(rows, idx, inv)
        (dy,) = torch.autograd.grad(y, rows, up)
        plain = rows.detach().clone().requires_grad_(True)
        want = torch.cat([plain, plain.new_zeros(1, plain.shape[1])])[idx]
        (dwant,) = torch.autograd.grad(want, plain, up)
        assert torch.equal(_bits(y), _bits(want))
        assert torch.equal(_bits(dy), _bits(dwant))


@pytest.mark.parametrize("capacity_factor", [1.25, 8.0],
                         ids=["drops", "no-drops"])
def test_smoke_layer_matches_plain_reference(capacity_factor):
    cfg = _cfg("float32", capacity_factor)
    p, x, probe = _layer(cfg, seed=3)
    T = x.shape[0]
    _, ids, _ = moe.route(cfg, p["router"], x)
    m = {"E": cfg.moe.num_experts, "k": cfg.moe.top_k,
         "capacity_factor": capacity_factor}

    def side(fn):
        w = [t.clone().requires_grad_(True) for t in
             (x, p["router"], p["experts"]["wi"], p["experts"]["wg"],
              p["experts"]["wo"])]
        y, aux, dropped = fn(*w)
        return [y, aux, dropped] + list(torch.autograd.grad(
            (y * probe).sum() + aux, w))

    def port(x, router, wi, wg, wo):
        return moe.moe_local(cfg, {"router": router, "experts": {
            "wi": wi, "wg": wg, "wo": wo}}, x, moe.capacity(cfg, T))

    def plain(x, router, wi, wg, wo):
        return ref.moe(m, x, router, wi, wg, wo, "float32", ids)[:3]

    got, want = side(port), side(plain)
    assert float(got[2]) == float(want[2])
    assert (float(got[2]) > 0.0) == (capacity_factor == 1.25)
    for name, a, b in zip(["y", "aux", "dropped", "x", "router", "wi", "wg",
                           "wo"], got, want):
        scale = max(float(b.detach().abs().max()), 1e-30)
        assert float((a.detach() - b.detach()).abs().max()) \
            <= RTOL_F32 * scale, name


def _profiled_step():
    cfg = C.get_smoke("mixtral-8x7b").replace(attention_impl="chunked",
                                              attention_chunk=16)
    init, step = build_train_step(cfg, device="cpu")
    state, batch = init(0), synthetic_batch(cfg, 2, 32, 0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function(WINDOW):
            step(state, batch)
    return cfg, list(prof.profiler.kineto_results.events())


def test_spans_open_inside_the_ffn_span():
    cfg, events = _profiled_step()
    ranges = collections.defaultdict(list)
    for e in events:
        if e.name().startswith(spans.SPAN):
            ranges[e.name()].append((e.start_thread_id(), e.start_ns(),
                                     e.start_ns() + e.duration_ns()))
    # once a layer in the forward and once more in remat's recompute
    for name in MOE_SPANS:
        assert len(ranges[name]) == 2 * cfg.num_layers, name
        for tid, s, t in ranges[name]:
            assert any(ft == tid and fs <= s and t <= ftt
                       for ft, fs, ftt in ranges["repro_torch.ffn"]), name


def test_gather_backward_goes_to_its_forward_span():
    """A kernel launched in each ``_PadGather`` backward node of a real CPU
    trace goes to the span its forward ran in: the dispatch's to
    ``repro_torch.moe.dispatch``, the combine's to ``.combine``."""
    cfg, events = _profiled_step()
    inside = {n: [(e.start_thread_id(), e.start_ns(),
                   e.start_ns() + e.duration_ns()) for e in events
                  if e.name() == n] for n in MOE_SPANS}

    def made_in(e):
        for name, rs in inside.items():
            if any(tid == e.start_thread_id() and s <= e.start_ns() < t
                   for tid, s, t in rs):
                return name
        return None

    made = {(e.start_thread_id(), e.sequence_nr()): made_in(e)
            for e in reversed(events) if e.sequence_nr() >= 0
            and e.fwd_thread_id() == 0
            and not e.name().startswith(spans.NODE)}
    want = collections.Counter()
    fake = []
    for i, n in enumerate(e for e in events
                          if e.name().startswith(spans.NODE)
                          and e.name().endswith("_PadGatherBackward")):
        where = made.get((n.fwd_thread_id(), n.sequence_nr()))
        want[where] += 1
        fake.append(Ev("from " + str(where), n.start_ns(), 1, 0, 10 ** 9 + i,
                       linked=n.correlation_id(), device=CUDA, kind="kernel"))
    # one node a layer for each gather
    assert want == {"repro_torch.moe.dispatch": cfg.num_layers,
                    "repro_torch.moe.combine": cfg.num_layers}
    ops = dict(spans.attribute(events + fake)["ops"])
    for where, n in want.items():
        assert ops["from " + where] == {where: pytest.approx(n * 1e-9)}


def test_summarize_unchanged_by_moe_spans():
    _, events = _profiled_step()
    fake = [Ev("k", e.start_ns(), 1, 0, 10 ** 9 + i, linked=e.correlation_id(),
               device=CUDA, kind="kernel")
            for i, e in enumerate(events) if e.name() == "aten::bmm"]
    full = events + fake
    bare = [e for e in full if not e.name().startswith("repro_torch.moe.")]
    assert len(bare) < len(full)
    got, want = summarize(full), summarize(bare)
    for key in ("busy_s", "window_s", "device_ops"):
        assert got[key] == want[key], key
    assert [g[1] for g in got["idle_gaps"]] == \
        [g[1] for g in want["idle_gaps"]]
    assert not any(n.startswith("repro_torch.")
                   for n, _ in got["device_ops"])
