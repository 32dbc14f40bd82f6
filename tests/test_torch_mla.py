"""The port's Multi-head Latent Attention (``models/mla.py``) against the
reference's ``mla_attention`` on the CPU, from the same parameters and
inputs, at the deepseek-v3 smoke config's widths (q/k heads of 16 + 8,
values of 16, so the values are padded and sliced as at full width), in
f32: outputs within 1e-5 of max|y|, gradients within 1e-4 of each leaf's
max (only the order of the sums differs). The whole deepseek-v3 smoke
model (MLA, sigmoid router, shared experts, a leading dense layer) is
held to the reference in ``tests/test_torch_model.py``; here also its
depth cut to the leading dense layers, where the MoE stack has length
zero."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
from repro.models import mla as jmla
from repro.models import transformer as jtfm
from repro.models import build_model as jax_build_model
from repro.train.step import build_train_step as jax_build_train_step
import repro_torch.configs as C
from repro_torch.data import synthetic_batch
from repro_torch.models import build_model, mla
from repro_torch.models import transformer as tfm
from repro_torch.train.state import state_from_numpy
from repro_torch.utils.pytree import (keystr, tree_flatten,
                                      tree_flatten_with_path, tree_leaves,
                                      tree_unflatten)
from torch_parity import GRAD_RTOL_F32, check_parity, reference_params


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfg(**kw):
    return JC.get_smoke("deepseek-v3-671b").replace(dtype="float32", **kw)


@pytest.mark.parametrize("S,chunk", [(32, 8), (40, 16), (24, 1024)],
                         ids=["4-chunks", "ragged-chunk", "one-chunk"])
def test_mla_attention_matches_reference(S, chunk):
    cfg = _cfg(attention_chunk=chunk)
    m = cfg.mla
    assert m.qk_nope_head_dim + m.qk_rope_head_dim != m.v_head_dim
    np_p = reference_params(jmla.mla_spec(cfg))
    x = np.random.default_rng(0).standard_normal(
        (2, S, cfg.d_model)).astype(np.float32)
    pos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32), (2, S))
    jrope = jtfm.rope_tables_for(cfg, S)
    trope = tfm.rope_tables_for(cfg, S, "cpu")
    assert trope[0].shape == (S, m.qk_rope_head_dim // 2)
    check_parity(lambda p, x: jmla.mla_attention(cfg, p, x, pos, rope=jrope),
                 lambda p, x: mla.mla_attention(cfg, p, x, trope),
                 np_p, [x], [(2, S, cfg.d_model)])


def test_mla_spec_matches_reference():
    cfg = C.get("deepseek-v3-671b")
    want = jax.tree_util.tree_map(lambda s: (s.shape, s.axes),
                                  jmla.mla_spec(cfg),
                                  is_leaf=lambda s: hasattr(s, "axes"))
    got = {k: (s.shape, s.axes) for k, s in mla.mla_spec(cfg).items()}
    assert got == want
    assert got["w_uq"][0] == (1536, 128, 192)
    assert got["wo"][0] == (128, 128, 7168)


def test_dense_only_cut_has_an_empty_moe_stack():
    """deepseek-v3 cut to its leading dense layers (as chip_smoke runs it
    at full width): the MoE stack has length zero in both packages, with
    the same leaf paths, shapes and dtypes. The port's loss is the
    cross-entropy with no router term, and its gradients equal the
    reference's (whose loss is NaN here: its mean over the empty aux stack
    is NaN, which adds NaN to the loss but nothing to the gradients)."""
    cfg = C.with_layers(_cfg(), 1)
    assert cfg.moe.first_dense_layers == cfg.num_layers == 1
    init_state, _ = jax_build_train_step(cfg)
    jstate = jax.jit(init_state)(jax.random.PRNGKey(0))
    want = [(jax.tree_util.keystr(p), tuple(x.shape), str(x.dtype))
            for p, x in jax.tree_util.tree_leaves_with_path(jstate.params)]
    flat, _ = tree_flatten_with_path(build_model(cfg).init(0, "cpu"))
    got = [(keystr(p), tuple(x.shape), str(x.dtype).removeprefix("torch."))
           for p, x in flat]
    assert got == want
    assert any(s[0] == 0 for _, s, _ in got)

    b = synthetic_batch(cfg, 2, 32, step=3, seed=0)
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(
        jax_build_model(cfg).loss, has_aux=True))(
        jstate.params, {k: jnp.asarray(v) for k, v in b.items()})
    np_state = jax.tree_util.tree_map(np.array, jax.device_get(jstate))
    leaves, treedef = tree_flatten(state_from_numpy(np_state, "cpu").params)
    leaves = [p.requires_grad_(True) for p in leaves]
    loss, m = build_model(cfg).loss(tree_unflatten(treedef, leaves),
                                    {k: torch.from_numpy(v)
                                     for k, v in b.items()})
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(
        leaves, torch.autograd.grad(loss, leaves, allow_unused=True))]
    assert np.isnan(float(jloss)) and "moe_aux" not in m
    np.testing.assert_allclose(float(loss.detach()), float(jm["ce"]),
                               rtol=1e-5)
    assert float(loss.detach()) == float(m["ce"].detach())
    for g, jg in zip(grads, jax.tree_util.tree_leaves(jgrads)):
        jg = np.asarray(jg)
        assert g.shape == jg.shape and np.isfinite(g.numpy()).all()
        if jg.size:
            assert np.abs(g.numpy() - jg).max() \
                <= GRAD_RTOL_F32 * max(float(np.abs(jg).max()), 1e-30)


def _np(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("recorder", ["reference", "port"])
def test_empty_stack_state_restores_across_packages(tmp_path, recorder):
    """The dense-only cut's TrainState (its MoE leaves hold zero bytes)
    after one reference step, recorded by one package's pipeline, restores
    through the other bit for bit."""
    from repro.checkpoint import CheckpointPipeline as JPipeline
    from repro.checkpoint import CheckpointStore as JStore
    from repro_torch.checkpoint import CheckpointPipeline, CheckpointStore

    cfg = C.with_layers(JC.get_smoke("deepseek-v3-671b"), 1)
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
    assert any(w.size == 0 for w in want)
    got_t = [_np(x) for x in tree_leaves(CheckpointStore(root).get_tree(
        "k0", like={"state": tstate}))]
    got_j = [_np(x) for x in jax.tree_util.tree_leaves(JStore(root).get_tree(
        "k0", like={"state": jstate}))]
    assert len(got_t) == len(got_j) == len(want)
    for g_t, g_j, w in zip(got_t, got_j, want):
        assert g_t.dtype == g_j.dtype == w.dtype
        assert g_t.shape == g_j.shape == w.shape
        assert np.array_equal(g_t, w) and np.array_equal(g_j, w)
