"""The port's Mamba blocks (``models/mamba.py``) against the reference's on
the CPU, from the same parameters and inputs, at the falcon-mamba-7b
(Mamba1) and zamba2-7b (Mamba2) smoke widths, chunk 16, in f32.

Tolerances: outputs within 1e-5 of max|y| and gradients within 1e-4 of
each leaf's max, as for the dense and moe families. The port's
Hillis–Steele prefix scan and prefix sum add in another order than XLA's
``associative_scan`` and ``cumsum``, which these tolerances cover at a
chunk of 16.

``_ssd_chunk`` is also held, with a decay large enough that exp(cA_t -
cA_s) above the chunk's diagonal overflows, to a float64 recurrence
(h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t, y_t = C_t h_t): in float64
within 1e-9, in f32 its forward within 1e-5 of max|y| and its gradients
finite and within 1e-4 of the recurrence's, except A's (``A_GRAD_RTOL``,
see the test). The reference's gradient there is NaN (0 * inf)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
from repro.models import mamba as jmamba
from repro_torch.models import mamba
from torch_parity import (GRAD_RTOL_F32, OUT_RTOL_F32, check_parity,
                          max_rel, reference_params)

A_GRAD_RTOL = 2e-3


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfg(arch):
    return JC.get_smoke(arch).replace(dtype="float32")


def _x(shape, seed=0, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)) \
        .astype(np.float32)


@pytest.mark.parametrize("S", [5, 16, 40])
def test_causal_conv_matches_reference(S):
    C, K = 24, 4
    np_p = {"w": _x((K, C), 1), "b": _x((C,), 2)}
    check_parity(lambda p, x: jmamba._causal_conv(x, p["w"], p["b"]),
                 lambda p, x: mamba._causal_conv(x, p["w"], p["b"]),
                 np_p, [_x((2, S, C))], [(2, S, C)])


@pytest.mark.parametrize("S", [16, 40], ids=["whole-chunks", "padded"])
def test_mamba1_forward_matches_reference(S):
    cfg = _cfg("falcon-mamba-7b")
    assert S % cfg.ssm.chunk == 0 or S > cfg.ssm.chunk
    np_p = reference_params(jmamba.mamba1_spec(cfg))
    check_parity(lambda p, x: jmamba.mamba1_forward(cfg, p, x),
                 lambda p, x: mamba.mamba1_forward(cfg, p, x),
                 np_p, [_x((2, S, cfg.d_model))], [(2, S, cfg.d_model)])


@pytest.mark.parametrize("S", [16, 40], ids=["whole-chunks", "padded"])
def test_mamba1_final_state_matches_reference(S):
    """The selective scan's output and carried final state: padded steps
    (dt = 0) must leave the state exact."""
    cfg = _cfg("falcon-mamba-7b")
    din = cfg.ssm.expand * cfg.d_model
    np_p = reference_params(jmamba.mamba1_spec(cfg))
    xs = [_x((2, S, din), 3), _x((2, S, din), 4)]
    check_parity(
        lambda p, x1, z: jmamba._mamba1_inner(cfg, p, x1, z,
                                              return_state=True),
        lambda p, x1, z: mamba._mamba1_inner(cfg, p, x1, z,
                                             return_state=True),
        np_p, xs, [(2, S, din), (2, din, cfg.ssm.state_dim)])


@pytest.mark.parametrize("S", [16, 40], ids=["whole-chunks", "padded"])
def test_mamba2_forward_matches_reference(S):
    cfg = _cfg("zamba2-7b")
    np_p = reference_params(jmamba.mamba2_spec(cfg))
    check_parity(lambda p, x: jmamba.mamba2_forward(cfg, p, x),
                 lambda p, x: mamba.mamba2_forward(cfg, p, x),
                 np_p, [_x((2, S, cfg.d_model))], [(2, S, cfg.d_model)])


@pytest.mark.parametrize("S", [16, 40], ids=["whole-chunks", "padded"])
def test_mamba2_final_state_matches_reference(S):
    cfg = _cfg("zamba2-7b")
    s = cfg.ssm
    din = s.expand * cfg.d_model
    nh = din // s.head_dim
    np_p = reference_params(jmamba.mamba2_spec(cfg))
    xs = [_x((2, S, din + 2 * s.state_dim), 3), _x((2, S, din), 4),
          _x((2, S, nh), 5)]
    check_parity(
        lambda p, xbc, z, dt: jmamba._mamba2_inner(cfg, p, xbc, z, dt,
                                                   return_state=True),
        lambda p, xbc, z, dt: mamba._mamba2_inner(cfg, p, xbc, z, dt,
                                                  return_state=True),
        np_p, xs, [(2, S, din), (2, nh, s.head_dim, s.state_dim)])


def _ssd_inputs(Q, dt_scale, seed=0):
    B, nh, hp, N = 2, 3, 4, 5
    rs = np.random.default_rng(seed)
    f = lambda *s: rs.standard_normal(s).astype(np.float32)
    dt = (dt_scale * rs.uniform(0.5, 1.0, (B, Q, nh))).astype(np.float32)
    return {"A": -np.exp(f(nh) * 0.1 + 1.0).astype(np.float32)}, \
        [f(B, Q, nh, hp), f(B, Q, N), f(B, Q, N), dt, f(B, nh, hp, N)]


def _jssd(p, xh, bq, cq, dtq, h):
    return jmamba._ssd_chunk(None, xh, bq, cq, dtq, p["A"], h)


def _tssd(p, xh, bq, cq, dtq, h):
    return mamba._ssd_chunk(xh, bq, cq, dtq, p["A"], h)


def test_ssd_chunk_matches_reference():
    """A decay where nothing overflows: the reference is the oracle."""
    np_p, xs = _ssd_inputs(16, 0.05)
    B, Q, nh, hp = xs[0].shape
    check_parity(_jssd, _tssd, np_p, xs,
                 [(B, Q, nh, hp), (B, nh, hp, xs[1].shape[-1])])


def _recurrence(xh, bq, cq, dtq, A, h):
    """y_t = C_t h_t, h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t, stepwise."""
    ys = []
    for t in range(xh.shape[1]):
        a = torch.exp(dtq[:, t] * A)                          # [B,nh]
        h = a[:, :, None, None] * h + torch.einsum(
            "bh,bhp,bn->bhpn", dtq[:, t], xh[:, t], bq[:, t])
        ys.append(torch.einsum("bhpn,bn->bhp", h, cq[:, t]))
    return torch.stack(ys, 1), h


def test_ssd_chunk_gradient_is_finite_where_the_decay_overflows():
    np_p, xs = _ssd_inputs(64, 3.0)
    dt, A = xs[3], np_p["A"]
    cA = np.cumsum(dt.astype(np.float64) * A, axis=1)
    iu = np.triu_indices(64, 1)
    above = (cA[:, :, None, :] - cA[:, None, :, :])[:, iu[0], iu[1]]
    assert above.max() > 89.0                 # exp overflows f32 there
    rs = np.random.default_rng(9)
    probes = [rs.standard_normal(s).astype(np.float32)
              for s in (xs[0].shape, xs[4].shape)]

    def run(fn, dtype):
        A_t = torch.tensor(A, dtype=dtype, requires_grad=True)
        ts = [torch.tensor(x, dtype=dtype, requires_grad=True) for x in xs]
        y, h = fn(*ts[:4], A_t, ts[4])
        total = (y * torch.tensor(probes[0], dtype=dtype)).sum() \
            + (h * torch.tensor(probes[1], dtype=dtype)).sum()
        return [y.detach().numpy(), h.detach().numpy()], [
            g.numpy() for g in torch.autograd.grad(total, [A_t] + ts)]

    want_y, want_g = run(_recurrence, torch.float64)
    # the masked form and its gradient are the recurrence's, exactly up to
    # float64 rounding
    y64, g64 = run(mamba._ssd_chunk, torch.float64)
    for a, w in zip(y64 + g64, want_y + want_g):
        assert max_rel(a, w) <= 1e-9
    # in f32 every gradient is finite; all but A's within the usual 1e-4.
    # dL/dA sums Q^2 terms weighted by the time offsets t - s, each with
    # the f32 rounding of cA (|cA| reaches 444 here, 2^-24 * 444 = 2.6e-5
    # a term): held within A_GRAD_RTOL = 2e-3 of its max
    y32, g32 = run(mamba._ssd_chunk, torch.float32)
    for a, w in zip(y32, want_y):
        assert np.isfinite(a).all() and max_rel(a, w) <= OUT_RTOL_F32
    for i, (a, w) in enumerate(zip(g32, want_g)):
        assert np.isfinite(a).all()
        assert max_rel(a, w) <= (A_GRAD_RTOL if i == 0 else GRAD_RTOL_F32)

    # the reference's forward agrees; its gradient is NaN here (0 * inf)
    jx = [jnp.asarray(x) for x in xs]
    jy, _ = jax.jit(_jssd)({"A": jnp.asarray(A)}, *jx)
    assert max_rel(y32[0], np.asarray(jy)) <= OUT_RTOL_F32
    jg = jax.grad(lambda a: (_jssd({"A": a}, *jx)[0] * probes[0]).sum())(
        jnp.asarray(A))
    assert not np.isfinite(np.asarray(jg)).all()
