"""The port's pipeline stage scan (``repro_torch.parallel.pipeline``)
against the reference's ``stage_scan`` on the same numpy inputs: the
reference test's (S, M) cases within atol 1e-5, the same bubble fractions,
and gradients through the scan."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.parallel import pipeline as ref
from repro_torch.parallel import pipeline as port

D = 16


def _inputs(S, M, seed=0):
    rng = np.random.default_rng(seed)
    params = {"w": (rng.standard_normal((S, D, D)) * 0.3).astype(np.float32),
              "b": (rng.standard_normal((S, D)) * 0.1).astype(np.float32)}
    x = rng.standard_normal((M * 2, D)).astype(np.float32)
    return params, x


def _stage_jax(p, h):
    return jnp.tanh(h @ p["w"] + p["b"])


def _stage_torch(p, h):
    return torch.tanh(h @ p["w"] + p["b"])


def _tparams(params, requires_grad=False):
    return {k: torch.from_numpy(v.copy()).requires_grad_(requires_grad)
            for k, v in params.items()}


@pytest.mark.parametrize("S,M", [(2, 2), (4, 4), (4, 8), (3, 6)])
def test_stage_scan_matches_reference(S, M):
    params, x = _inputs(S, M)
    want = jax.jit(lambda p, x: ref.stage_scan(_stage_jax, p, x,
                                               microbatches=M))(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x))
    got = port.stage_scan(_stage_torch, _tparams(params),
                          torch.from_numpy(x), microbatches=M)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    seq = torch.from_numpy(x)
    for s in range(S):
        seq = _stage_torch({k: v[s] for k, v in _tparams(params).items()},
                           seq)
    np.testing.assert_allclose(got.numpy(), seq.numpy(), atol=1e-5)


@pytest.mark.parametrize("S,M", [(4, 8), (3, 6)])
def test_gradients_through_the_scan_match_reference(S, M):
    params, x = _inputs(S, M, seed=1)
    probe = np.random.default_rng(2).standard_normal(x.shape) \
        .astype(np.float32)

    def loss_jax(p, x):
        return (ref.stage_scan(_stage_jax, p, x, microbatches=M)
                * probe).sum()

    g_ref = jax.jit(jax.grad(loss_jax, argnums=(0, 1)))(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x))
    tp = _tparams(params, requires_grad=True)
    tx = torch.from_numpy(x.copy()).requires_grad_(True)
    out = port.stage_scan(_stage_torch, tp, tx, microbatches=M)
    grads = torch.autograd.grad((out * torch.from_numpy(probe)).sum(),
                                [tp["w"], tp["b"], tx])
    for got, want in zip(grads, (g_ref[0]["w"], g_ref[0]["b"], g_ref[1])):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want,
                                   atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("S,M", [(4, 4), (1, 8), (4, 60), (4, 8), (3, 6)])
def test_bubble_fraction_matches_reference(S, M):
    assert port.bubble_fraction(S, M) == ref.bubble_fraction(S, M)
    assert port.bubble_fraction(4, 8) == 3 / 11


def test_stage_scan_under_a_mesh_raises():
    """The stage buffer's constraint needs sharded model compute."""
    from repro_torch.parallel import sharding

    params, x = _inputs(2, 2)
    with sharding.use_mesh(object(), rules={"stage": [("stage",), ()]}):
        with pytest.raises(NotImplementedError, match="sharded model"):
            port.stage_scan(_stage_torch, _tparams(params),
                            torch.from_numpy(x), microbatches=2)


@pytest.mark.parametrize("stages", [2, 4])
def test_stage_scan_of_model_blocks_matches_the_layer_loop(stages):
    """The port's own ``dense_block`` on slices of florbench-100m's stacked
    layer leaves (smoke widths, f32), as chip_smoke's phase T runs it at
    full width: the same output as the plain loop over the layers."""
    import repro_torch.configs as C
    from repro_torch.data import synthetic_batch
    from repro_torch.models import build_model
    from repro_torch.models.transformer import (_embed_inputs, _layer,
                                                dense_block,
                                                rope_tables_for)
    from repro_torch.utils.pytree import tree_map

    cfg = C.get_smoke("florbench-100m").replace(dtype="float32")
    params = build_model(cfg).init(0, "cpu")
    tokens = torch.from_numpy(synthetic_batch(cfg, 8, 32, 0, 0)["tokens"])
    per = cfg.num_layers // stages
    with torch.no_grad():
        x = _embed_inputs(cfg, params, tokens, None)
        rope = rope_tables_for(cfg, x.shape[1], x.device)
        stacked = tree_map(lambda w: w.reshape(stages, per, *w.shape[1:]),
                           params["layers"])

        def stage_fn(p, h):
            for i in range(per):
                h = dense_block(cfg, _layer(p, i), h, None, rope)
            return h

        got = port.stage_scan(stage_fn, stacked, x, microbatches=4)
        want = x
        for i in range(cfg.num_layers):
            want = dense_block(cfg, _layer(params["layers"], i), want, None,
                               rope)
    np.testing.assert_allclose(got.numpy(), want.numpy(),
                               atol=1e-5 * float(want.abs().max()))
