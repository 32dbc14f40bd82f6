"""The port's models and train step against the reference package's, from
the same parameters (initialized by the reference, moved over with
``state_from_numpy``) on the same seeded batch, on the CPU, for the smoke
config of every architecture the port runs: florbench-100m and the ten
configs of ``repro_torch.configs.ARCHS`` (GQA and MQA, qk-norm, gelu /
swiglu / geglu / relu2, tied and untied embeddings, ``embed_scale``, the
vlm embedding prefix, routed experts with drops, MLA with the sigmoid
router and shared experts, Mamba1, Mamba2 with the shared attention
block, the encoder-decoder).

Tolerances, and why:
- float32 compute (``cfg.replace(dtype="float32")``): loss to rtol 1e-5;
  each gradient leaf to 1e-4 * max|g| of that leaf; after one train step,
  each ``mu``/``nu`` leaf to 1e-4 * its max, each param leaf's update
  ``new - old`` to 2e-3 of the update's L2 norm, and the params to atol
  1e-5. Both sides run f32 arithmetic; only the order of the sums differs
  (XLA fuses and reorders, torch does not). The update is compared by norm:
  at step 0 Adam moves an element by lr * g / (|g| + eps), which flips
  with the grad's rounding wherever |g| is near eps, so single elements
  may differ by the whole update while the leaf's update agrees.
- AdamW alone, on identical numpy grads/moments/params: each update to
  1e-5 * max|update| of its leaf, moments to 1e-6 * max, the learning rate
  to rtol 1e-7. Only rounding differs here.
- bfloat16 compute (the config's default): loss to rtol 2e-2. The two
  frameworks round intermediates to bf16 at different places.
"""
import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
import repro_torch.configs as C
from repro.models import build_model as jax_build_model
from repro.train.optimizer import AdamWState as JaxAdamWState
from repro.train.optimizer import adamw as jax_adamw
from repro.train.schedule import warmup_cosine as jax_warmup_cosine
from repro.train.step import build_train_step as jax_build_train_step
from repro_torch.data import synthetic_batch
from repro_torch.models import build_model
from repro_torch.train.optimizer import AdamWState, adamw
from repro_torch.train.schedule import warmup_cosine
from repro_torch.train.state import state_from_numpy, state_to_numpy
from repro_torch.train.step import build_train_step
from repro_torch.utils.pytree import (keystr, tree_flatten,
                                      tree_flatten_with_path, tree_leaves,
                                      tree_unflatten)

LOSS_RTOL_F32 = 1e-5
GRAD_RTOL_F32 = 1e-4          # of each leaf's max |g|
MOMENT_RTOL_F32 = 1e-4        # of each mu / nu leaf's max
UPDATE_RTOL_F32 = 2e-3        # of each param leaf's update L2 norm
PARAM_ATOL_F32 = 1e-5
OPT_UPDATE_RTOL = 1e-5        # AdamW alone: of each leaf's max |update|
OPT_MOMENT_RTOL = 1e-6
LR_RTOL = 1e-7
LOSS_RTOL_BF16 = 2e-2

ARCHS = ["florbench-100m"] + C.ARCHS


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _setup(cfg, batch=2, seq=32):
    init_state, _ = jax_build_train_step(cfg)
    jstate = jax.jit(init_state)(jax.random.PRNGKey(0))
    np_state = jax.tree_util.tree_map(np.array, jax.device_get(jstate))
    b = synthetic_batch(cfg, batch, seq, step=3, seed=0)
    return jstate, np_state, b


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_param_tree_matches_reference(arch):
    """Same leaf paths, shapes and dtypes as the reference's params, and a
    TrainState round-trips through numpy unchanged."""
    cfg = JC.get_smoke(arch)
    jparams = jax.eval_shape(jax_build_model(cfg).init, jax.random.PRNGKey(0))
    want = [(jax.tree_util.keystr(p), tuple(x.shape), str(x.dtype))
            for p, x in jax.tree_util.tree_leaves_with_path(jparams)]
    flat, _ = tree_flatten_with_path(build_model(cfg).init(0, "cpu"))
    got = [(keystr(p), tuple(x.shape), str(x.dtype).removeprefix("torch."))
           for p, x in flat]
    assert got == want
    _, np_state, _ = _setup(cfg)
    back = state_to_numpy(state_from_numpy(np_state, "cpu"))
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(np_state)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("impl", ["naive", "chunked"])
@pytest.mark.parametrize("arch", ARCHS)
def test_f32_loss_grads_and_step_match_reference(arch, impl):
    cfg = JC.get_smoke(arch).replace(
        dtype="float32", attention_impl=impl, attention_chunk=8)
    jstate, np_state, b = _setup(cfg)
    jmodel = jax_build_model(cfg)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        jmodel.loss, has_aux=True))(jstate.params, jb)

    state = state_from_numpy(np_state, "cpu")
    t_leaves_, treedef = tree_flatten(state.params)
    t_leaves_ = [p.detach().requires_grad_(True) for p in t_leaves_]
    loss, _ = build_model(cfg).loss(tree_unflatten(treedef, t_leaves_),
                                    _torch_batch(b))
    grads = torch.autograd.grad(loss, t_leaves_)
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=LOSS_RTOL_F32)
    for g, jg in zip(grads, jax.tree_util.tree_leaves(jgrads)):
        jg = np.asarray(jg)
        scale = max(float(np.abs(jg).max()), 1e-30)
        assert np.abs(g.numpy() - jg).max() <= GRAD_RTOL_F32 * scale

    _, jstep = jax_build_train_step(cfg)
    jnew, jm = jax.jit(jstep)(jstate, jb)
    _, step = build_train_step(cfg, device="cpu")
    new, m = step(state, b)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=LOSS_RTOL_F32)
    for a, ja, old in zip(tree_leaves(new.params),
                          jax.tree_util.tree_leaves(jnew.params),
                          tree_leaves(state.params)):
        np.testing.assert_allclose(a.numpy(), np.asarray(ja),
                                   atol=PARAM_ATOL_F32, rtol=0)
        old = old.numpy().astype(np.float64)
        d = a.numpy().astype(np.float64) - old
        jd = np.asarray(ja, np.float64) - old
        assert np.linalg.norm(jd) > 0
        assert np.linalg.norm(d - jd) <= UPDATE_RTOL_F32 * np.linalg.norm(jd)
    for slot in ("mu", "nu"):
        for a, ja in zip(tree_leaves(getattr(new, slot)),
                         jax.tree_util.tree_leaves(getattr(jnew, slot))):
            ja = np.asarray(ja)
            scale = float(np.abs(ja).max())
            assert scale > 0
            assert np.abs(a.numpy() - ja).max() <= MOMENT_RTOL_F32 * scale
    assert int(new.step) == int(jnew.step) == 1
    assert np.array_equal(new.rng.numpy(), np.asarray(jnew.rng))


@pytest.mark.parametrize("step", [0, 5, 50])
def test_adamw_update_matches_reference(step):
    """One AdamW update from identical grads, moments and params (a decayed
    matrix, an undecayed vector, a stacked 3-D leaf), in warmup and in the
    cosine phase of the schedule."""
    rs = np.random.default_rng(step)
    shapes = {"w": (64, 48), "b": (48,), "stack": (3, 16, 8)}
    p = {k: rs.normal(0, 0.02, s).astype(np.float32)
         for k, s in shapes.items()}
    g = {k: rs.normal(0, 1e-2, s).astype(np.float32)
         for k, s in shapes.items()}
    m = {k: rs.normal(0, 1e-3, s).astype(np.float32)
         for k, s in shapes.items()}
    v = {k: (m[k].astype(np.float64) ** 2
             + rs.normal(0, 1e-3, s) ** 2).astype(np.float32)
         for k, s in shapes.items()}

    sched_args = (1e-3, 10, 100)
    _, jupdate = jax_adamw(jax_warmup_cosine(*sched_args))
    J = lambda d: {k: jnp.asarray(x) for k, x in d.items()}
    jp, jst = jax.jit(jupdate)(J(g), JaxAdamWState(J(m), J(v)), J(p),
                               jnp.int32(step))
    sched = warmup_cosine(*sched_args)
    _, update = adamw(sched)
    T = lambda d: {k: torch.from_numpy(x) for k, x in d.items()}
    tstep = torch.tensor(step, dtype=torch.int32)
    tp, tst = update(T(g), AdamWState(T(m), T(v)), T(p), tstep)

    np.testing.assert_allclose(
        float(sched(tstep)),
        float(jax_warmup_cosine(*sched_args)(jnp.int32(step))), rtol=LR_RTOL)
    for k in shapes:
        jd = np.asarray(jp[k], np.float64) - p[k]
        d = tp[k].numpy().astype(np.float64) - p[k]
        assert np.abs(d - jd).max() <= OPT_UPDATE_RTOL * np.abs(jd).max()
        for a, ja in ((tst.mu[k], jst.mu[k]), (tst.nu[k], jst.nu[k])):
            ja = np.asarray(ja)
            assert np.abs(a.numpy() - ja).max() \
                <= OPT_MOMENT_RTOL * np.abs(ja).max()


def _bf16_bits(x) -> np.ndarray:
    """bf16 bit patterns (of a torch tensor or an ml_dtypes array) as
    int64, so that adjacent bf16 values of one sign differ by 1."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().astype(np.int64)
    return np.asarray(x).view(np.int16).astype(np.int64)


@pytest.mark.parametrize("step", [0, 50])
def test_adamw_bf16_storage_matches_reference(step):
    """deepseek-v3's storage: bf16 parameters and bf16 moments, the update
    computed in f32 and rounded to bf16 on store, as the reference does.
    Each stored element within one bf16 step of the reference's (its bit
    pattern differs by at most 1): the f32 results may differ in their
    last bits (XLA fuses), which moves a value across a bf16 rounding
    boundary by one step. Where b1 * m + (1 - b1) * g cancels to near zero
    those last bits are the whole value, so there the element is held
    within 1e-6 of its leaf's largest magnitude instead (a few f32 ulps of
    the operands)."""
    rs = np.random.default_rng(step)
    shapes = {"w": (64, 48), "b": (48,)}
    f = lambda sc, s: rs.normal(0, sc, s).astype(np.float32)
    p = {k: f(0.02, s) for k, s in shapes.items()}
    g = {k: f(1e-2, s) for k, s in shapes.items()}
    m = {k: f(1e-3, s) for k, s in shapes.items()}
    v = {k: np.abs(f(1e-3, s)) ** 2 for k, s in shapes.items()}
    sched_args = (1e-3, 10, 100)
    _, jupdate = jax_adamw(jax_warmup_cosine(*sched_args),
                           moment_dtype="bfloat16")
    J = lambda d: {k: jnp.asarray(x, jnp.bfloat16) for k, x in d.items()}
    jp, jst = jax.jit(jupdate)(J(g), JaxAdamWState(J(m), J(v)), J(p),
                               jnp.int32(step))
    _, update = adamw(warmup_cosine(*sched_args), moment_dtype="bfloat16")
    T = lambda d: {k: torch.from_numpy(x).bfloat16() for k, x in d.items()}
    tp, tst = update(T(g), AdamWState(T(m), T(v)), T(p),
                     torch.tensor(step, dtype=torch.int32))
    for k in shapes:
        for a, ja in ((tp[k], jp[k]), (tst.mu[k], jst.mu[k]),
                      (tst.nu[k], jst.nu[k])):
            assert a.dtype == torch.bfloat16 and ja.dtype == jnp.bfloat16
            steps = np.abs(_bf16_bits(a) - _bf16_bits(ja))
            diff = np.abs(a.float().numpy() - np.asarray(ja, np.float32))
            scale = float(np.abs(np.asarray(ja, np.float32)).max())
            assert np.all((steps <= 1) | (diff <= 1e-6 * scale))


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_loss_matches_reference(arch):
    cfg = JC.get_smoke(arch)
    assert cfg.dtype == "bfloat16"
    jstate, np_state, b = _setup(cfg)
    jloss, _ = jax.jit(jax_build_model(cfg).loss)(
        jstate.params, {k: jnp.asarray(v) for k, v in b.items()})
    loss, _ = build_model(cfg).loss(state_from_numpy(np_state, "cpu").params,
                                    _torch_batch(b))
    np.testing.assert_allclose(float(loss), float(jloss),
                               rtol=LOSS_RTOL_BF16)


def test_train_step_is_functional():
    """The step returns new tensors and leaves the input state's bytes
    alone: a deferred checkpoint gather of the old state stays valid."""
    cfg = JC.get_smoke("florbench-100m")
    init_state, step = build_train_step(cfg, device="cpu")
    st = init_state(0)
    before = [x.clone() for x in tree_leaves(st)]
    new, _ = step(st, synthetic_batch(cfg, 2, 16, 0))
    for a, b in zip(tree_leaves(st), before):
        assert torch.equal(a, b)
    assert not torch.equal(new.params["embed"]["table"],
                           st.params["embed"]["table"])


@pytest.mark.parametrize("impl", ["naive", "chunked"])
def test_train_step_frees_the_old_state_at_once(impl):
    """Once the caller drops the input state, no reference cycle keeps it:
    on the card a step then holds two states, not three, until the
    garbage collector happens to run (the pytree helpers and the chunked
    attention's recompute once held one in a cycle)."""
    cfg = C.get_smoke("mixtral-8x7b").replace(attention_impl=impl,
                                               attention_chunk=16)
    init_state, step = build_train_step(cfg, device="cpu")
    st = init_state(0)
    alive = [weakref.ref(x) for x in tree_leaves(st)
             if x.is_floating_point()]
    gc.collect()
    gc.disable()
    try:
        st, _ = step(st, synthetic_batch(cfg, 2, 48, 0))
        assert not any(r() is not None for r in alive)
    finally:
        gc.enable()


def test_entry_points_default_to_cuda():
    cfg = JC.get_smoke("florbench-100m")
    if torch.cuda.is_available():
        pytest.skip("a card is present: the cuda default would run on it")
    with pytest.raises(RuntimeError, match="cuda"):
        build_train_step(cfg)
