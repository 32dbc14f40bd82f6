"""The port's MoE family against the reference package's, on the CPU.

- ``moe_apply`` on the same parameters and input (f32) at the default
  capacity, where experts drop choices, and at capacity factor 8, where
  none drop: the top-k ids and the drop fraction equal, the output, the
  aux loss and the gradients within 1e-5 of their largest magnitude (both
  sides compute in f32; only the order of the sums differs);
- the same for a variant of the mixtral smoke config with the sigmoid
  router, three experts per token, one shared expert and a leading dense
  layer (the deepseek-style paths of the module), through the whole model;
- the sliding window at S > window, through the whole model, naive and
  chunked attention, at the model tests' tolerances;
- two runs of the MoE train step from one state give the same bits;
- the record launcher with ``--arch mixtral-8x7b --smoke --device cpu``
  (cut to one layer), then the replay launcher's deferred check;
- a MoE TrainState recorded by either package restores through the other
  bit for bit.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
from repro.checkpoint import CheckpointPipeline as JPipeline
from repro.checkpoint import CheckpointStore as JStore
from repro.models import build_model as jax_build_model
from repro.models import moe as jmoe
from repro.models.params import init_params as jax_init_params
from repro.train.step import build_train_step as jax_build_train_step
import repro_torch.configs as C
from repro_torch.checkpoint import CheckpointPipeline, CheckpointStore
from repro_torch.data import synthetic_batch
from repro_torch.models import build_model, moe
from repro_torch.train.state import state_from_numpy
from repro_torch.train.step import build_train_step
from repro_torch.utils.pytree import (tree_flatten, tree_leaves,
                                      tree_unflatten)

RTOL_F32 = 1e-5               # of the largest magnitude of each output
LOSS_RTOL_F32 = 1e-5          # the model tests' tolerances
GRAD_RTOL_F32 = 1e-4
SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _deepseek_style(cfg):
    """Sigmoid router, top-3, a shared expert, a leading dense layer."""
    return cfg.replace(moe=dataclasses.replace(
        cfg.moe, top_k=3, num_shared_experts=1, first_dense_layers=1,
        router="sigmoid"))


def _cfg(variant, **kw):
    cfg = JC.get_smoke("mixtral-8x7b").replace(dtype="float32")
    if variant == "deepseek-style":
        cfg = _deepseek_style(cfg)
    if kw:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, **kw))
    return cfg


def _max_rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("variant", ["mixtral", "deepseek-style"])
@pytest.mark.parametrize("capacity_factor", [1.25, 8.0],
                         ids=["drops", "no-drops"])
def test_moe_apply_matches_reference(variant, capacity_factor):
    cfg = _cfg(variant, capacity_factor=capacity_factor)
    jp = jax_init_params(jmoe.moe_spec(cfg), jax.random.PRNGKey(1),
                         "float32")
    np_p = jax.tree_util.tree_map(np.array, jp)
    # tokens lean towards expert 0 (a shift of 3 along its router column),
    # so at the default capacity it drops the choices past its 80 slots
    r0 = np_p["router"][:, 0]
    x = (np.random.default_rng(0).standard_normal((2, 64, cfg.d_model))
         + 3.0 * r0 / np.linalg.norm(r0)).astype(np.float32)
    probe = np.random.default_rng(1).standard_normal(x.shape) \
        .astype(np.float32)

    def jloss(p, x):
        y, m = jmoe.moe_apply(cfg, p, x)
        return (y * probe).sum() + m["moe_aux"], (y, m)

    (_, (jy, jm)), (jgp, jgx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jp, jnp.asarray(x))
    _, jids, _ = jmoe._route(cfg, jp["router"], jnp.asarray(
        x.reshape(-1, cfg.d_model)))

    leaves, treedef = tree_flatten(jax.tree_util.tree_map(
        torch.from_numpy, np_p))
    leaves = [t.requires_grad_(True) for t in leaves]
    tx = torch.from_numpy(x).requires_grad_(True)
    y, m = moe.moe_apply(cfg, tree_unflatten(treedef, leaves), tx)
    gx, *gp = torch.autograd.grad((y * torch.from_numpy(probe)).sum()
                                  + m["moe_aux"], [tx] + leaves)
    _, ids, _ = moe.route(cfg, torch.from_numpy(np_p["router"]),
                          torch.from_numpy(x.reshape(-1, cfg.d_model)))

    assert np.array_equal(ids.numpy(), np.asarray(jids))
    assert float(m["moe_dropped"]) == float(jm["moe_dropped"])
    if capacity_factor == 8.0:
        assert float(m["moe_dropped"]) == 0.0
    else:
        assert float(m["moe_dropped"]) > 0.0
    assert abs(float(m["moe_aux"].detach()) - float(jm["moe_aux"])) \
        <= RTOL_F32 * abs(float(jm["moe_aux"]))
    assert _max_rel(y.detach(), jy) <= RTOL_F32
    assert _max_rel(gx, jgx) <= RTOL_F32
    for g, jg in zip(gp, jax.tree_util.tree_leaves(jgp)):
        assert _max_rel(g, jg) <= RTOL_F32


def _model_parity(cfg, seq):
    init_state, _ = jax_build_train_step(cfg)
    jstate = jax.jit(init_state)(jax.random.PRNGKey(0))
    np_state = jax.tree_util.tree_map(np.array, jax.device_get(jstate))
    b = synthetic_batch(cfg, 2, seq, step=3, seed=0)
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(
        jax_build_model(cfg).loss, has_aux=True))(
        jstate.params, {k: jnp.asarray(v) for k, v in b.items()})
    leaves, treedef = tree_flatten(state_from_numpy(np_state, "cpu").params)
    leaves = [p.requires_grad_(True) for p in leaves]
    loss, m = build_model(cfg).loss(tree_unflatten(treedef, leaves),
                                    {k: torch.from_numpy(v)
                                     for k, v in b.items()})
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=LOSS_RTOL_F32)
    assert float(m["moe_dropped"]) == float(jm["moe_dropped"])
    for g, jg in zip(grads, jax.tree_util.tree_leaves(jgrads)):
        jg = np.asarray(jg)
        assert np.abs(g.numpy() - jg).max() \
            <= GRAD_RTOL_F32 * max(float(np.abs(jg).max()), 1e-30)
    return m


def test_deepseek_style_model_matches_reference():
    """The whole model with the sigmoid router, top-3, a shared expert and
    a leading dense layer: the moe subtree beside ``dense_layers``."""
    cfg = _cfg("deepseek-style")
    spec = build_model(cfg).param_spec()
    assert set(spec) >= {"dense_layers", "layers"}
    assert "shared" in spec["layers"]["moe"]
    _model_parity(cfg, 32)


@pytest.mark.parametrize("impl", ["naive", "chunked"])
def test_sliding_window_beyond_its_length_matches_reference(impl):
    """S = 64 tokens against mixtral's smoke window of 32: every query
    past position 32 loses its oldest keys."""
    cfg = _cfg("mixtral").replace(attention_impl=impl, attention_chunk=16)
    assert cfg.sliding_window == 32
    _model_parity(cfg, 64)


def _bits(t):
    t = t.detach().contiguous()
    view = {2: torch.int16, 4: torch.int32, 8: torch.int64}
    return t.view(view[t.element_size()]) if t.is_floating_point() else t


def test_moe_step_is_bit_reproducible():
    cfg = C.get_smoke("mixtral-8x7b")
    init_state, step = build_train_step(cfg, device="cpu")
    st = init_state(0)
    batch = synthetic_batch(cfg, 2, 32, 0)
    (a, ma), (b, mb) = step(st, batch), step(st, batch)
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert torch.equal(_bits(x), _bits(y))
    for k in ("loss", "moe_aux", "moe_dropped"):
        assert torch.equal(_bits(ma[k]), _bits(mb[k]))


def _launch(module, args, timeout=300):
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="2")
    return subprocess.run([sys.executable, "-m", module, *args], env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_mixtral_launcher_record_then_replay_check(tmp_path):
    """Both launchers at the reduced config cut to one layer (``--layers``
    must match between record and replay, as ``--arch`` must)."""
    run = str(tmp_path / "run")
    args = ["--arch", "mixtral-8x7b", "--smoke", "--layers", "1",
            "--device", "cpu", "--batch", "2", "--seq", "32"]
    r = _launch("repro_torch.launch.train",
                args + ["--epochs", "2", "--steps-per-epoch", "2",
                        "--no-adaptive", "--run-dir", run])
    assert r.returncode == 0, r.stderr[-3000:]
    r = _launch("repro_torch.launch.replay",
                args + ["--run-dir", run, "--nworkers", "2", "--probe",
                        "train", "--check"])
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert "deferred check: ok=True compared=2 hindsight=4" in r.stdout


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


@pytest.mark.parametrize("recorder", ["reference", "port"])
def test_moe_store_restores_across_packages(tmp_path, recorder):
    """A mixtral smoke TrainState after one reference train step, recorded
    by one package's pipeline, restores through the other bit for bit."""
    cfg = JC.get_smoke("mixtral-8x7b")
    init_state, jstep = jax_build_train_step(cfg)
    jstate = jax.jit(init_state)(jax.random.PRNGKey(0))
    jstate, _ = jax.jit(jstep)(jstate, {k: jnp.asarray(v) for k, v in
                                        synthetic_batch(cfg, 2, 32, 0)
                                        .items()})
    np_state = jax.tree_util.tree_map(np.array, jax.device_get(jstate))
    tstate = state_from_numpy(np_state, "cpu")
    root = str(tmp_path / "store")
    if recorder == "reference":
        pipe = JPipeline(JStore(root))
        pipe.submit("k0", {"state": jstate}, scope="train")
    else:
        pipe = CheckpointPipeline(CheckpointStore(root))
        pipe.submit("k0", {"state": tstate}, scope="train")
    pipe.close()
    want = [np.asarray(x) for x in jax.tree_util.tree_leaves(np_state)]
    got_t = [_np(x) for x in tree_leaves(CheckpointStore(root).get_tree(
        "k0", like={"state": tstate}))]
    got_j = [_np(x) for x in jax.tree_util.tree_leaves(JStore(root).get_tree(
        "k0", like={"state": jstate}))]
    assert len(got_t) == len(got_j) == len(want)
    assert any(w.ndim == 4 for w in want)          # [layer, E, d, f] experts
    for g_t, g_j, w in zip(got_t, got_j, want):
        assert g_t.dtype == g_j.dtype == w.dtype
        assert np.array_equal(g_t, w) and np.array_equal(g_j, w)


# the four families and archs the port refused until it had their modules
REFUSED = {"ssm": "falcon-mamba-7b", "mla": "deepseek-v3-671b",
           "hybrid": "zamba2-7b", "audio": "seamless-m4t-large-v2"}


def _spec_shapes(spec):
    return jax.tree_util.tree_map(lambda s: (tuple(s.shape), tuple(s.axes)),
                                  spec, is_leaf=lambda s: hasattr(s, "axes"))


@pytest.mark.parametrize("family", ["ssm", "hybrid", "audio", "mla"])
def test_unported_families_raise(family):
    """Named for what these families did before the port had their
    modules: they raised. Each now builds the reference's parameter tree
    (paths, shapes, logical axes) from its smoke config; a family that
    neither package knows still raises ValueError, as in the reference."""
    cfg = JC.get_smoke(REFUSED[family])
    assert (cfg.mla is not None) if family == "mla" else cfg.family == family
    assert _spec_shapes(build_model(cfg).param_spec()) \
        == _spec_shapes(jax_build_model(cfg).param_spec())
    with pytest.raises(ValueError, match="unknown"):
        build_model(cfg.replace(family="unknown"))


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "deepseek-v3-671b",
                                  "zamba2-7b", "seamless-m4t-large-v2"])
def test_unported_archs_are_unknown(arch):
    """Named for what these archs were before their families were ported:
    unknown to the port. Each is now in ``ARCHS`` at the reference
    registry's position, and its full and smoke configs equal the
    reference's field for field; a name neither registry has still raises
    KeyError."""
    assert C.ARCHS == JC.ARCHS and arch in C.ARCHS
    for get, jget in ((C.get, JC.get), (C.get_smoke, JC.get_smoke)):
        assert dataclasses.asdict(get(arch)) == dataclasses.asdict(jget(arch))
    with pytest.raises(KeyError):
        C.get_smoke(arch + "-unknown")
