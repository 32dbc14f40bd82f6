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


class _DuckMesh:
    def __init__(self, **sizes):
        self.shape = sizes


def test_stage_scan_under_a_mesh_raises():
    """A "stage" axis must hold one stage per rank: 8 stages on a 4-rank
    axis raise before any collective. (A replicated "stage" rule, the
    default, leaves the buffer whole: the plain scan.)"""
    from repro_torch.parallel import sharding

    params, x = _inputs(8, 8)
    with sharding.use_mesh(_DuckMesh(stage=4),
                           rules={"stage": [("stage",), ()]}):
        with pytest.raises(ValueError, match="one mesh axis of 8 ranks"):
            port.stage_scan(_stage_torch, _tparams(params),
                            torch.from_numpy(x), microbatches=8)
    params, x = _inputs(4, 4)
    with sharding.use_mesh(_DuckMesh(stage=4)):
        got = port.stage_scan(_stage_torch, _tparams(params),
                              torch.from_numpy(x), microbatches=4)
    want = port.stage_scan(_stage_torch, _tparams(params),
                           torch.from_numpy(x), microbatches=4)
    assert torch.equal(got, want)


STAGE_REF = """
import sys
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.parallel import use_mesh
from repro.parallel.pipeline import stage_scan

inp, out = sys.argv[1:3]
z = np.load(inp)
mesh = Mesh(np.array(jax.devices()).reshape(4, 2), ("stage", "data"))
rules = {"stage": [("stage",), ()], "batch": [("data",), ()]}
sh = NamedSharding(mesh, P("stage"))
params = {k: jax.device_put(jnp.asarray(z[k]), sh) for k in ("w", "b")}


def stage(p, h):
    return jnp.tanh(h @ p["w"] + p["b"])


with mesh, use_mesh(mesh, rules=rules):
    pipe = jax.jit(lambda p, x: stage_scan(stage, p, x, microbatches=8))(
        params, jnp.asarray(z["x"]))
np.save(out, np.asarray(pipe))
"""

STAGE_PORT = """
import numpy as np
from torch.distributed.device_mesh import DeviceMesh
from repro_torch.parallel import collectives as col
from repro_torch.parallel.pipeline import stage_scan
from repro_torch.parallel.sharding import use_mesh


def stage(p, h):
    return torch.tanh(h @ p["w"] + p["b"])


def main(rank, world, args):
    z = np.load(args[0])
    mesh = DeviceMesh("cpu", torch.arange(4), mesh_dim_names=("stage",))
    params = {k: torch.from_numpy(z[k]).requires_grad_(True)
              for k in ("w", "b")}
    x = torch.from_numpy(z["x"]).requires_grad_(True)
    probe = torch.from_numpy(z["probe"])
    with use_mesh(mesh, rules={"stage": [("stage",), ()]}):
        col.reset_counts()
        out = stage_scan(stage, params, x, microbatches=8)
        calls = col.counts(by_op=True)["stage"]
        # the replicated output's loss over the 4 ranks (partial
        # cotangents), gradients summed over the stage axis
        wrt = [params["w"], params["b"], x]
        grads = torch.autograd.grad((out * probe).sum() / 4, wrt,
                                    allow_unused=True)   # x: stage 0's
        grads = [col.psum(torch.zeros_like(w) if g is None else g, "stage")
                 for g, w in zip(grads, wrt)]
    # the plain scan on the full buffer, one process
    want = stage_scan(stage, params, x, microbatches=8)
    wgrads = torch.autograd.grad((want * probe).sum(),
                                 [params["w"], params["b"], x])
    assert calls["ppermute"]["calls"] == 8 + 4 - 1, calls
    np.testing.assert_allclose(out.detach().numpy(), want.detach().numpy(),
                               atol=1e-6)
    for g, w in zip(grads, wgrads):
        np.testing.assert_allclose(g.numpy(), w.numpy(),
                                   atol=1e-5 * float(w.abs().max()))
    if rank == 0:
        np.save(args[1], out.detach().numpy())
"""


def test_stage_scan_on_a_stage_fleet_matches_the_reference(tmp_path):
    """The reference's 8-device test (4 stages x 2 data on a ("stage",
    "data") mesh, 8 microbatches, d 16) against the port's buffer sharded
    over a real 4-process "stage" axis: one ``ppermute`` per tick, within
    1e-5 of the reference and of the one-process scan (gradients too,
    summed over the axis)."""
    from torch_fleet import ref_subprocess, run_fleet

    rng = np.random.default_rng(0)
    inp = str(tmp_path / "in.npz")
    np.savez(inp, w=(rng.standard_normal((4, D, D)) * 0.1).astype(
        np.float32), b=(rng.standard_normal((4, D)) * 0.1).astype(
        np.float32), x=rng.standard_normal((16, D)).astype(np.float32),
        probe=rng.standard_normal((16, D)).astype(np.float32))
    ref_out, port_out = str(tmp_path / "ref.npy"), str(tmp_path / "port.npy")
    r = ref_subprocess(STAGE_REF, 8, inp, ref_out)
    assert r.returncode == 0, r.stderr[-3000:]
    res = run_fleet(STAGE_PORT, 4, tmp_path, inp, port_out)
    assert all(rc == 0 for rc, _ in res), [t[-2000:] for _, t in res]
    np.testing.assert_allclose(np.load(port_out), np.load(ref_out),
                               atol=1e-5)


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
