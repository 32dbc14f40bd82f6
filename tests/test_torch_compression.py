"""The port's gradient codec (``repro_torch.parallel.compression``) against
the reference's (``repro.parallel.compression``) on the same numpy
gradients: int8 values, scales, error state and decompressed gradients bit
for bit over 8 error-feedback steps, for f32 and bf16 leaves of odd sizes,
all-zero blocks and exact .5 ties. The reference is called eagerly, as its
own test calls it (tests/test_kernels.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.parallel import compression as ref
from repro_torch.parallel import compression as port

SIZES = {"a": (7,), "b": (256,), "c": (10, 30), "d": (4097,)}
STEPS = 8


def _grads(seed: int, dtype: str) -> dict:
    """Seeded gradients: per leaf a mix of scales, an all-zero first block
    in "d", and a block of exact .5 ties in "b" (absmax 127, so the scale
    is exactly 1 and values k + .5 round half to even)."""
    rng = np.random.default_rng(seed)
    g = {k: (rng.standard_normal(s) * 10.0 ** rng.integers(-3, 3))
         .astype(np.float32) for k, s in SIZES.items()}
    g["d"].reshape(-1)[:256] = 0.0
    g["b"][:] = np.concatenate([[127.0, 0.0], np.arange(-127, 127) + 0.5])
    if dtype == "bfloat16":
        g = {k: v.astype(jnp.bfloat16) for k, v in g.items()}
    return g


def _to_torch(a: np.ndarray) -> torch.Tensor:
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _bits(x) -> np.ndarray:
    """Raw bits of a reference array or a port tensor."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.numpy().view(np.uint8)
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype == jnp.bfloat16 else a.view(np.uint8)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_feedback_steps_match_reference_bit_for_bit(dtype):
    err_r = ref.init_error_state({k: jnp.asarray(v) for k, v in
                                  _grads(0, dtype).items()})
    err_p = port.init_error_state({k: _to_torch(v) for k, v in
                                   _grads(0, dtype).items()})
    for step in range(STEPS):
        g = _grads(step, dtype)
        g_r = {k: jnp.asarray(v) for k, v in g.items()}
        g_p = {k: _to_torch(v) for k, v in g.items()}
        comp_r, err_r = ref.compress_grads_with_feedback(g_r, err_r)
        comp_p, err_p = port.compress_grads_with_feedback(g_p, err_p)
        deq_r = ref.decompress_grads(comp_r, g_r)
        deq_p = port.decompress_grads(comp_p, g_p)
        for k in SIZES:
            assert comp_p[k].n == comp_r[k].n
            assert comp_p[k].q.dtype == torch.int8
            assert comp_p[k].q.shape == comp_r[k].q.shape
            np.testing.assert_array_equal(comp_p[k].q.numpy(),
                                          np.asarray(comp_r[k].q))
            np.testing.assert_array_equal(_bits(comp_p[k].scale),
                                          _bits(comp_r[k].scale))
            np.testing.assert_array_equal(_bits(err_p[k]), _bits(err_r[k]))
            assert deq_p[k].dtype == g_p[k].dtype
            np.testing.assert_array_equal(_bits(deq_p[k]), _bits(deq_r[k]))


def test_zero_blocks_and_ties_quantize_like_the_reference():
    g = _grads(3, "float32")
    c = port.quantize_leaf(torch.from_numpy(g["d"]))
    assert float(c.scale[0]) == np.float32(1e-12)
    assert not c.q[0].any()
    c = port.quantize_leaf(torch.from_numpy(g["b"]))
    assert float(c.scale[0]) == 1.0
    # k + .5 rounds to the even neighbour
    np.testing.assert_array_equal(c.q[0, 2:5].numpy(), [-126, -126, -124])


def test_scale_is_the_eager_references_ieee_division():
    """The port follows the reference as its test calls it (eagerly): the
    scale is absmax / 127 by IEEE division. Under ``jax.jit`` the reference
    multiplies by fl(1/127) instead, which gives another scale in some
    blocks (a finding in the reference, ROADMAP queue 3)."""
    x = np.random.default_rng(7).standard_normal(256 * 400) \
        .astype(np.float32)
    absmax = np.abs(x).reshape(-1, 256).max(1)
    div = np.maximum(absmax / np.float32(127.0), np.float32(1e-12))
    mul = np.maximum(absmax * np.float32(1 / 127.0), np.float32(1e-12))
    eager = np.asarray(ref.quantize_leaf(jnp.asarray(x)).scale)
    jitted = np.asarray(jax.jit(ref.quantize_leaf)(jnp.asarray(x)).scale)
    got = port.quantize_leaf(torch.from_numpy(x)).scale.numpy()
    np.testing.assert_array_equal(got, div)
    np.testing.assert_array_equal(eager, div)
    np.testing.assert_array_equal(jitted, mul)
    assert (div != mul).any()


def test_error_feedback_carries_the_residual_and_shrinks_the_bias():
    """The reference's tests/test_kernels.py check, on the port."""
    rng = np.random.default_rng(0)
    g = {"w": torch.from_numpy(rng.standard_normal(300).astype(np.float32)),
         "b": torch.from_numpy(rng.standard_normal(7).astype(np.float32))}
    err = port.init_error_state(g)
    comp, err2 = port.compress_grads_with_feedback(g, err)
    deq = port.decompress_grads(comp, g)
    np.testing.assert_allclose(err2["w"].numpy(),
                               (g["w"] - deq["w"]).numpy(), atol=1e-6)
    total = np.zeros(300, np.float32)
    err_state = port.init_error_state(g)
    for _ in range(8):
        comp, err_state = port.compress_grads_with_feedback(g, err_state)
        total += port.decompress_grads(comp, g)["w"].numpy()
    assert np.abs(total / 8 - g["w"].numpy()).max() < 0.02


@pytest.mark.cuda
def test_codec_on_the_card_matches_the_cpu_bit_for_bit():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for dtype in ("float32", "bfloat16"):
        g = {k: _to_torch(v) for k, v in _grads(1, dtype).items()}
        out = []
        for dev in ("cpu", "cuda"):
            gd = {k: v.to(dev) for k, v in g.items()}
            err = port.init_error_state(gd)
            for _ in range(3):
                comp, err = port.compress_grads_with_feedback(gd, err)
            out.append((comp, err, port.decompress_grads(comp, gd)))
        for k in SIZES:
            for a, b in ((out[0][0][k].q, out[1][0][k].q),
                         (out[0][0][k].scale, out[1][0][k].scale),
                         (out[0][1][k], out[1][1][k]),
                         (out[0][2][k], out[1][2][k])):
                assert torch.equal(a, b.cpu())
