"""The port's AdamW with the clip folded in (``train/optimizer.py``), on the
CPU, where it runs the plain per-leaf path:

- ``update`` with a clip ``scale`` gives the same bits as the gradients
  clipped into a tree of their own (``_clipped``) followed by ``update``,
  for every dtype pair and with and without weight decay;
- ``norm_and_scale`` is ``global_norm`` and ``clip_scale``, bit for bit;
- CPU tensors, the dry run's fake CUDA tensors and dtypes the kernels do not
  take count under ``route_elems["plain"]`` and launch nothing;
- a train step gives the bits of the step that clipped the gradients into
  a tree of their own before the update.

The fused kernels are held to the plain path on the card by
``tests/test_torch_adamw_card.py``.
"""
import pytest
import torch

from repro_torch.kernels import cuda_build
from repro_torch.train import optimizer as O
from repro_torch.train.schedule import warmup_cosine
from repro_torch.utils.pytree import tree_map

PAIRS = [(torch.float32, "float32"), (torch.float32, "bfloat16"),
         (torch.bfloat16, "bfloat16")]
SHAPES = [(), (1,), (3,), (4097,), (64, 33), (0,)]


def _leaves(pdt, mdt, seed=0):
    gen = torch.Generator().manual_seed(seed)
    mk = lambda s, k, dt: (torch.randn(s, generator=gen) * k).to(dt)  # noqa: E731
    mdt = getattr(torch, mdt)
    params = {f"l{i}": mk(s, 1.0, pdt) for i, s in enumerate(SHAPES)}
    grads = {k: mk(p.shape, 3.0, pdt) for k, p in params.items()}
    mu = {k: mk(p.shape, 0.1, mdt) for k, p in params.items()}
    nu = {k: mk(p.shape, 0.01, mdt).abs() for k, p in params.items()}
    return params, grads, O.AdamWState(mu, nu)


def _bits(x):
    return x.reshape(-1).view(torch.int16 if x.element_size() == 2
                              else torch.int32)


def _clipped(grads, max_norm):
    """The gradients scaled to a global norm of at most ``max_norm`` as a
    tree of their own, as the step clipped them before the clip went into
    the update, and the norm."""
    gn = O.global_norm(grads)
    scale = O.clip_scale(gn, max_norm)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), gn


def _same(a, b):
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert torch.equal(_bits(a[k]), _bits(b[k])), k


@pytest.mark.parametrize("wd", [0.1, 0.0])
@pytest.mark.parametrize("pdt,mdt", PAIRS)
def test_update_with_scale_is_clip_then_update(pdt, mdt, wd):
    _, update = O.adamw(warmup_cosine(3e-4, 2, 100), weight_decay=wd,
                        moment_dtype=mdt)
    params, grads, state = _leaves(pdt, mdt)
    step = torch.tensor(3, dtype=torch.int32)
    clipped, gn = _clipped(grads, 1.0)
    assert float(gn) > 1.0                     # the clip does scale
    want_p, want_s = update(clipped, state, params, step)
    got_p, got_s = update(grads, state, params, step,
                          O.clip_scale(gn, 1.0))
    _same(want_p, got_p)
    _same(want_s.mu, got_s.mu)
    _same(want_s.nu, got_s.nu)


@pytest.mark.parametrize("max_norm", [1.0, 1e6, 0.0])
def test_norm_and_scale_is_the_plain_norm_on_the_cpu(max_norm):
    _, grads, _ = _leaves(torch.float32, "float32")
    gn, scale = O.norm_and_scale(grads, max_norm)
    assert torch.equal(_bits(gn), _bits(O.global_norm(grads)))
    if not max_norm:
        assert scale is None
        return
    assert torch.equal(_bits(scale), _bits(O.clip_scale(gn, max_norm)))
    assert float(scale) == (1.0 if max_norm > float(gn) else
                            pytest.approx(max_norm / float(gn), rel=1e-6))
    assert torch.equal(_bits(_clipped(grads, max_norm)[1]), _bits(gn))


def _fake_cuda(mode):
    """Fake CUDA leaves of ``_leaves``' shapes (the dry run's tensors: no
    memory, no card needed)."""
    params, grads, state = _leaves(torch.float32, "float32")
    with mode:
        conv = lambda t: {k: torch.empty(v.shape, dtype=v.dtype,  # noqa: E731
                                         device="cuda") for k, v in t.items()}
        return conv(params), conv(grads), O.AdamWState(conv(state.mu),
                                                        conv(state.nu))


@pytest.mark.parametrize("case", ["cpu", "fake_cuda", "float64"])
def test_unfusable_leaves_take_the_plain_route(case):
    """Nothing here may launch a kernel: the route is chosen from the
    leaves themselves, and the plain path counts their elements."""
    import contextlib
    mode = contextlib.nullcontext()
    if case == "fake_cuda":
        from torch._subclasses.fake_tensor import FakeTensorMode
        mode = FakeTensorMode()
        params, grads, state = _fake_cuda(mode)
    else:
        pdt = torch.float64 if case == "float64" else torch.float32
        params, grads, state = _leaves(pdt, "float32")
    launches = dict(cuda_build.launches)
    before = dict(O.route_elems)
    _, update = O.adamw(warmup_cosine(3e-4, 2, 100))
    with mode:
        step = torch.zeros((), dtype=torch.int32,
                           device=next(iter(params.values())).device)
        gn, scale = O.norm_and_scale(grads, 1.0)
        new_p, _ = update(grads, state, params, step, scale)
    n = sum(p.numel() for p in params.values())
    assert O.route_elems["plain"] - before["plain"] == n
    assert O.route_elems["fused"] == before["fused"]
    assert cuda_build.launches == launches
    assert all(new_p[k].shape == params[k].shape for k in params)
    if case == "fake_cuda":
        assert all(x.is_cuda for x in new_p.values())


def test_cpu_train_step_keeps_the_clipped_tree_bits():
    """A florbench smoke step on the CPU: the step that hands the clip
    scale to the update gives the bits of loss, gradients clipped into a
    tree of their own, then the update."""
    import repro_torch.configs as C
    from repro_torch.data import synthetic_batch
    from repro_torch.models import build_model
    from repro_torch.train.step import batch_to_device, build_train_step
    from repro_torch.utils.pytree import tree_flatten, tree_unflatten

    cfg = C.get_smoke("florbench-100m")
    init, step = build_train_step(cfg, device="cpu", peak_lr=3e-2, warmup=2)
    state = init(0)
    batch = synthetic_batch(cfg, 2, 32, 0)
    new, metrics = step(state, batch)

    model = build_model(cfg)
    leaves, treedef = tree_flatten(state.params)
    leaves = [p.detach().requires_grad_(True) for p in leaves]
    loss, _ = model.loss(tree_unflatten(treedef, leaves),
                         batch_to_device(batch, "cpu"))
    grads = tree_unflatten(treedef, [
        torch.zeros_like(p) if g is None else g for p, g in zip(
            leaves, torch.autograd.grad(loss, leaves, allow_unused=True))])
    clipped, gn = _clipped(grads, 1.0)
    _, update = O.adamw(warmup_cosine(3e-2, 2, 10000),
                        moment_dtype=cfg.moment_dtype)
    want_p, want_s = update(clipped, O.AdamWState(state.mu, state.nu),
                            state.params, state.step)
    assert torch.equal(_bits(metrics["grad_norm"]), _bits(gn))
    flat = lambda t: dict(enumerate(tree_flatten(t)[0]))  # noqa: E731
    _same(flat(want_p), flat(new.params))
    _same(flat(want_s.mu), flat(new.mu))
    _same(flat(want_s.nu), flat(new.nu))
