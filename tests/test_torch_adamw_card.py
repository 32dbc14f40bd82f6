"""AdamW's multi-tensor kernels (``kernels/adamw.py``, ``csrc/adamw.cu``) on
the card, held to the plain per-leaf path of ``train/optimizer.py`` on the
same CUDA tensors (``cuda``-marked: each skips without a CUDA card, since a
CUDA kernel has no CPU mode):

- the update gives the plain path's bits for p', m' and v' at every dtype
  pair, with and without the clip and weight decay, over leaves of 0 dims,
  1, 3, 4 097 and ~3.1 M elements, an empty one, a view whose storage is
  not 16-byte aligned and a gradient laid out as a transpose;
- the norm is within 1e-6 of a float64 sum, the same bits on two calls, and
  its clip scale is ``clip_scale`` of that norm, bit for bit;
- the update writes no input and no output aliases one;
- a granite-3-2b step cut to 2 layers runs the expected launches, and no
  element takes the plain route;
- CUDA leaves the kernels cannot take (f64, f16, moments of another dtype
  than the optimizer's) raise ``ValueError`` and launch nothing: on the
  card there is no plain route to fall back to; parameters and moments
  laid out as a transpose go through the kernels, with the plain path's
  bits;
- under the profiler the kernels go to the step's optimizer span
  (``portbench/spans.py``), not to "unattributed".

No JAX here: the card's machine has none. Run on the card with
``python -m pytest -m cuda tests/test_torch_adamw_card.py``.
"""
import pytest
import torch

from repro_torch.kernels import adamw as K
from repro_torch.kernels import ops
from repro_torch.train import optimizer as O
from repro_torch.train.schedule import warmup_cosine

pytestmark = pytest.mark.cuda

SCHED = warmup_cosine(3e-4, 2, 100)
PAIRS = [(torch.float32, "float32"), (torch.float32, "bfloat16"),
         (torch.bfloat16, "bfloat16"), (torch.bfloat16, "float32")]
SHAPES = [(), (1,), (3,), (4097,), (2048, 1537), (0,), (300, 70), (7, 5)]
TRANSPOSED = "l6"        # its gradient is the transpose of a contiguous one


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _leaves(dev, pdt, mdt, seed=0):
    """params, grads, state; the last parameter and gradient are views
    one element into their storage (not 16-byte aligned), and one gradient
    is laid out as a transpose (as a tied embedding's is)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    mdt = getattr(torch, mdt)

    def mk(shape, k, dt, offset=False):
        n = 1
        for s in shape:
            n *= s
        base = (torch.randn(n + int(offset), generator=gen, device=dev)
                * k).to(dt)
        return base[int(offset):].view(shape)
    last = len(SHAPES) - 1
    params = {f"l{i}": mk(s, 1.0, pdt, i == last)
              for i, s in enumerate(SHAPES)}
    grads = {k: mk(p.shape, 3.0, pdt, k == f"l{last}")
             for k, p in params.items()}
    grads[TRANSPOSED] = mk(params[TRANSPOSED].shape[::-1], 3.0, pdt).t()
    assert not grads[TRANSPOSED].is_contiguous()
    mu = {k: mk(p.shape, 0.1, mdt) for k, p in params.items()}
    nu = {k: mk(p.shape, 0.01, mdt).abs() for k, p in params.items()}
    assert params[f"l{last}"].data_ptr() % 16 != 0
    return params, grads, O.AdamWState(mu, nu)


def _bits(x):
    return x.reshape(-1).view(torch.int16 if x.element_size() == 2
                              else torch.int32)


def _same(a, b):
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert torch.equal(_bits(a[k]), _bits(b[k])), k


def _plain(params, grads, state, step, scale, wd, mdt):
    """(params', mu', nu') as dicts from the plain per-leaf path
    (``optimizer.plain_update``) on the same CUDA tensors."""
    keys = list(params)
    new = O.plain_update(
        [grads[k] for k in keys], [params[k] for k in keys],
        [state.mu[k] for k in keys], [state.nu[k] for k in keys],
        [bool(wd) and params[k].ndim >= 2 for k in keys], scale,
        *O.step_scalars(SCHED, step, 0.9, 0.95), b1=0.9, b2=0.95, eps=1e-8,
        weight_decay=wd, moment_dtype=getattr(torch, mdt))
    return [dict(zip(keys, x)) for x in new]


@pytest.mark.parametrize("clip", [True, False])
@pytest.mark.parametrize("wd", [0.1, 0.0])
@pytest.mark.parametrize("pdt,mdt", PAIRS)
def test_update_gives_the_plain_paths_bits(dev, pdt, mdt, wd, clip):
    _, update = O.adamw(SCHED, weight_decay=wd, moment_dtype=mdt)
    params, grads, state = _leaves(dev, pdt, mdt)
    step = torch.tensor(3, dtype=torch.int32, device=dev)
    gn, scale = O.norm_and_scale(grads, 1.0 if clip else 0.0)
    if clip:
        assert float(scale) < 1.0                  # the clip does scale
    before = dict(O.route_elems)
    got_p, got_s = update(grads, state, params, step, scale)
    assert O.route_elems["fused"] - before["fused"] == sum(
        p.numel() for p in params.values())
    assert O.route_elems["plain"] == before["plain"]
    want_p, want_mu, want_nu = _plain(params, grads, state, step, scale, wd,
                                      mdt)
    _same(want_p, got_p)
    _same(want_mu, got_s.mu)
    _same(want_nu, got_s.nu)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_norm_is_exact_to_1e6_and_deterministic(dev, dt):
    _, grads, _ = _leaves(dev, dt, "float32", seed=1)
    want = torch.sqrt(sum(g.double().square().sum()
                          for g in grads.values()))
    gn, scale = O.norm_and_scale(grads, 1.0)
    gn2, scale2 = O.norm_and_scale(grads, 1.0)
    assert abs(float(gn) / float(want) - 1.0) < 1e-6
    assert torch.equal(_bits(gn), _bits(gn2))
    assert torch.equal(_bits(scale), _bits(scale2))
    assert torch.equal(_bits(scale), _bits(O.clip_scale(gn, 1.0)))
    gn4, one = O.norm_and_scale(grads, float(gn) * 4)
    assert float(one) == 1.0 and torch.equal(_bits(gn4), _bits(gn))
    assert O.norm_and_scale(grads, 0.0)[1] is None


def test_update_writes_no_input(dev):
    _, update = O.adamw(SCHED)
    params, grads, state = _leaves(dev, torch.float32, "float32", seed=2)
    inputs = [*params.values(), *grads.values(), *state.mu.values(),
              *state.nu.values()]
    saved = [x.clone() for x in inputs]
    gn, scale = O.norm_and_scale(grads, 1.0)
    new_p, new_s = update(grads, state, params,
                          torch.tensor(0, dtype=torch.int32, device=dev),
                          scale)
    torch.cuda.synchronize()
    for x, y in zip(inputs, saved):
        assert torch.equal(_bits(x), _bits(y))
    spans = [(x.untyped_storage().data_ptr(),
              x.untyped_storage().data_ptr() + x.untyped_storage().nbytes())
             for x in inputs if x.numel()]
    for out in (new_p, new_s.mu, new_s.nu):
        for x in out.values():
            if x.numel():
                a = x.data_ptr()
                assert not [s for s in spans if s[0] <= a < s[1]]


@pytest.mark.parametrize("case", ["float64", "float16", "moment_dtype"])
def test_unsupported_leaves_on_the_card_raise(dev, case):
    _, update = O.adamw(SCHED)
    params, grads, state = _leaves(dev, torch.float32, "float32")
    if case == "moment_dtype":              # the optimizer's are f32
        state = O.AdamWState(*({k: v.bfloat16() for k, v in t.items()}
                               for t in state))
    else:
        dt = getattr(torch, case)
        params = {k: v.to(dt) for k, v in params.items()}
        grads = {k: v.to(dt) for k, v in grads.items()}
    launches = ops.launch_counts()
    before = dict(O.route_elems)
    step = torch.tensor(0, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="AdamW"):
        update(grads, state, params, step, None)
    if case != "moment_dtype":
        with pytest.raises(ValueError, match="AdamW"):
            O.norm_and_scale(grads, 1.0)
    assert O.route_elems == before
    assert ops.launch_counts() == launches


def test_strided_leaves_on_the_card_take_the_kernels(dev):
    _, update = O.adamw(SCHED)
    params, grads, state = _leaves(dev, torch.float32, "float32")
    params["l4"], grads["l4"] = params["l4"].t(), grads["l4"].t()
    state.mu["l4"], state.nu["l4"] = state.mu["l4"].t(), state.nu["l4"].t()
    step = torch.tensor(0, dtype=torch.int32, device=dev)
    gn, scale = O.norm_and_scale(grads, 1.0)
    before = dict(O.route_elems)
    got_p, got_s = update(grads, state, params, step, scale)
    assert O.route_elems["plain"] == before["plain"]
    assert O.route_elems["fused"] - before["fused"] == sum(
        p.numel() for p in params.values())
    want_p, want_mu, want_nu = _plain(params, grads, state, step, scale, 0.1,
                                      "float32")
    _same(want_p, got_p)
    _same(want_mu, got_s.mu)
    _same(want_nu, got_s.nu)


def test_granite_step_runs_the_fused_optimizer(dev):
    """granite-3-2b at its widths, 2 layers, 2 x 512 tokens: one step runs
    one sum-of-squares launch a 128 leaves, one finish and one update launch
    a 48 leaves, and every element takes the fused route."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.data import synthetic_batch
    from repro_torch.train.step import build_train_step
    from repro_torch.utils.pytree import tree_leaves

    cfg = ModelConfig(name="granite-3-2b-2l", family="dense", num_layers=2,
                      d_model=2048, num_heads=32, num_kv_heads=8, d_ff=8192,
                      vocab_size=49155, head_dim=64, ffn_activation="swiglu",
                      tie_embeddings=True)
    init, step = build_train_step(cfg, device=dev)
    state = init(0)
    leaves = [p for p in tree_leaves(state.params) if p.numel()]
    batch = synthetic_batch(cfg, 2, 512, 0)
    ops.reset_launch_counts()
    before = dict(O.route_elems)
    new, m = step(state, batch)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts["adamw_sumsq"] == -(-len(leaves) // K.SQ_MAX)
    assert counts["adamw_finish"] == 1
    assert counts["adamw_update"] == -(-len(leaves) // K.UPD_MAX)
    assert O.route_elems["plain"] == before["plain"]
    assert O.route_elems["fused"] - before["fused"] == sum(
        p.numel() for p in leaves)
    assert bool(torch.isfinite(m["loss"])) and bool(
        torch.isfinite(m["grad_norm"]))


def test_profiled_kernels_go_to_the_optimizer_span(dev):
    """A ctypes launch inside a ``record_function`` range alone links to no
    host operation; each launch runs inside a host operation of its own,
    so ``portbench/spans.py`` gives the kernels to
    ``repro_torch.step.optimizer``."""
    from torch.profiler import ProfilerActivity, profile

    from portbench import spans, trace
    from repro_torch.configs.base import ModelConfig
    from repro_torch.data import synthetic_batch
    from repro_torch.train.step import build_train_step

    cfg = ModelConfig(name="granite-3-2b-1l", family="dense", num_layers=1,
                      d_model=2048, num_heads=32, num_kv_heads=8, d_ff=8192,
                      vocab_size=49155, head_dim=64, ffn_activation="swiglu",
                      tie_embeddings=True)
    init, step = build_train_step(cfg, device=dev)
    state = init(0)
    batch = synthetic_batch(cfg, 2, 512, 0)
    state, _ = step(state, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function(trace.WINDOW):
            state, _ = step(state, batch)
            torch.cuda.synchronize()
    got = spans.attribute(prof.profiler.kineto_results.events())["spans"]
    opt = got["repro_torch.step.optimizer"]
    names = " ".join(n for n, _ in opt["top_ops"])
    assert "upd_kernel" in names and "sq_kernel" in names
    lost = got.get(spans.NONE, {}).get("device_s", 0.0)
    assert lost < 0.1 * opt["device_s"]
