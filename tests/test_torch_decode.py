"""The port's serving path (``Model.prefill`` / ``Model.decode``, every
family's caches, ``serve.step.greedy_generate``) against the reference
package's, on the CPU at smoke widths in f32, from the reference's own
parameters (carried over through numpy) on the same seeded prompts.

The reference runs with ``attention_impl="naive"`` as its own decode test
does, the port with the same config; MoE configs at capacity factor 8, so
that no token is dropped and the prompt and the step route alike.

Tolerances, and why:
- logits (prefill and decode): atol 2e-3, the reference test's own
  (tests/test_models.py, ``test_decode_matches_prefill``);
- cache leaves: compared by path; integer leaves (``slot_pos``) equal,
  floating leaves within 1e-5 of the leaf's largest magnitude. Both sides
  run the same f32 arithmetic; only the order of the sums differs.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
import repro_torch.configs as C
from repro.models import build_model as jax_build_model
from repro.serve.step import greedy_generate as jax_greedy_generate
from repro_torch.data import synthetic_batch
from repro_torch.models import build_model
from repro_torch.serve.step import greedy_generate
from torch_parity import leaves_by_path, to_torch

LOGIT_ATOL = 2e-3
CACHE_RTOL = 1e-5          # of each floating cache leaf's max |x|
S = 24                     # prompt length (the decoder's, for audio)
PARITY_ARCHS = ["granite-3-2b", "mixtral-8x7b", "falcon-mamba-7b",
                "zamba2-7b", "deepseek-v3-671b", "seamless-m4t-large-v2",
                "llava-next-mistral-7b"]
# (arch, layers or None, prompt length, what the case covers)
EDGE_CASES = [
    ("mixtral-8x7b", None, 40, "prompt past the 32-token window: the "
     "prefill keeps the last 32 positions in ring order, decode wraps"),
    ("zamba2-7b", 8, S, "8 % attn_period 6 = 2: one group and a tail"),
    ("deepseek-v3-671b", 1, S, "only the leading dense layer: an empty "
     "MoE cache stack of zero-size leaves"),
]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _f32(cfg, layers=None):
    cfg = cfg.replace(attention_impl="naive", dtype="float32",
                      param_dtype="float32")
    if cfg.moe is not None:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                  capacity_factor=8.0))
    if layers is not None:
        cfg = cfg.replace(num_layers=layers)
    return cfg


def _setup(arch, layers=None, seq=S):
    """(reference cfg, port cfg, reference params, port params, prompt
    batch as numpy, max_len, the position after the prompt)."""
    jcfg = _f32(JC.get_smoke(arch), layers)
    cfg = _f32(C.get_smoke(arch), layers)
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(1))
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    batch = synthetic_batch(cfg, 2, 2 * seq if cfg.family == "audio"
                            else seq, 0)
    return jcfg, cfg, jparams, to_torch(np_params), batch, seq + 8, seq


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jax_prefill(jcfg, jparams, batch, max_len):
    m = jax_build_model(jcfg)
    return jax.jit(lambda p, b: m.prefill(p, b, max_len))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})


def _jax_decode(jcfg, jparams, caches, tok, pos):
    return jax.jit(jax_build_model(jcfg).decode)(
        jparams, caches, jnp.asarray(tok), jnp.asarray(pos, jnp.int32))


def _assert_caches_equal(got, want):
    got, want = leaves_by_path(got), leaves_by_path(want)
    assert list(got) == list(want)
    for path, w in want.items():
        g = got[path]
        assert g.shape == w.shape and g.dtype == w.dtype, path
        if w.dtype.kind == "f":
            scale = max(float(np.abs(w).max()) if w.size else 0.0, 1e-30)
            assert np.abs(g - w).max(initial=0.0) <= CACHE_RTOL * scale, path
        else:
            assert np.array_equal(g, w), path


def _check_against_reference(arch, layers=None, seq=S):
    jcfg, cfg, jparams, params, batch, max_len, pos = _setup(arch, layers,
                                                             seq)
    jcaches, jlogits = _jax_prefill(jcfg, jparams, batch, max_len)
    model = build_model(cfg)
    with torch.inference_mode():
        caches, logits = model.prefill(params, _tb(batch), max_len)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=LOGIT_ATOL, rtol=0)
    _assert_caches_equal(caches, jcaches)

    # one step from the SAME (the reference's) caches in both packages
    tok = np.full((2, 1), 7, np.int32)
    jl, jnew = _jax_decode(jcfg, jparams, jcaches, tok, pos)
    start = to_torch(jax.tree_util.tree_map(np.asarray, jcaches))
    with torch.inference_mode():
        l, new = model.decode(params, start, torch.from_numpy(tok), pos)
    np.testing.assert_allclose(l.numpy(), np.asarray(jl), atol=LOGIT_ATOL,
                               rtol=0)
    _assert_caches_equal(new, jnew)
    # decode copies the caches it is given and leaves them as they were
    _assert_caches_equal(start, jcaches)


@pytest.mark.parametrize("arch", PARITY_ARCHS)
def test_prefill_and_decode_match_reference(arch):
    _check_against_reference(arch)


@pytest.mark.parametrize("arch,layers,seq,why", EDGE_CASES,
                         ids=[c[0] for c in EDGE_CASES])
def test_cache_edge_cases_match_reference(arch, layers, seq, why):
    _check_against_reference(arch, layers, seq)


@pytest.mark.parametrize("arch", PARITY_ARCHS)
def test_decode_continues_prefill(arch):
    """The port's own invariance: decode(prefill(x), t) == prefill(x + t)."""
    _, cfg, _, params, batch, max_len, pos = _setup(arch)
    model = build_model(cfg)
    key = "dec_tokens" if cfg.family == "audio" else "tokens"
    tok = torch.full((2, 1), 7, dtype=torch.int32)
    longer = _tb(batch)
    longer[key] = torch.cat([longer[key], tok], dim=1)
    with torch.inference_mode():
        caches, _ = model.prefill(params, _tb(batch), max_len)
        got, _ = model.decode(params, caches, tok, pos)
        _, want = model.prefill(params, longer, max_len + 1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=LOGIT_ATOL,
                               rtol=0)


@pytest.mark.parametrize("max_len", [40, 10_000])
@pytest.mark.parametrize("arch", ["florbench-100m"] + C.ARCHS)
def test_cache_spec_matches_reference(arch, max_len):
    """Shapes and dtypes by path, a window-bounded ring past the window
    (``test_sliding_window_bounds_cache``), and ``init_cache`` laid out
    from the spec: every ``slot_pos`` -1, every other leaf zero."""
    want = jax_build_model(JC.get_smoke(arch)).cache_spec(2, max_len)
    want = {jax.tree_util.keystr(p): (tuple(s.shape), str(s.dtype))
            for p, s in jax.tree_util.tree_leaves_with_path(want)}
    cfg = C.get_smoke(arch)
    model = build_model(cfg)
    spec = model.cache_spec(2, max_len)
    got = {}

    def walk(tree, path):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, path + f"[{k!r}]")
        else:
            shape, dtype = tree
            got[path] = (tuple(shape), str(dtype).removeprefix("torch."))
    walk(spec, "")
    assert got == want
    if cfg.sliding_window and "layers" in spec:
        assert spec["layers"]["k"][0][2] == min(max_len, cfg.sliding_window)
    from repro_torch.utils.pytree import keystr, tree_flatten_with_path
    flat, _ = tree_flatten_with_path(model.init_cache(2, 40, "cpu"))
    assert flat
    for p, x in flat:
        assert bool((x == (-1 if keystr(p).endswith("['slot_pos']")
                           else 0)).all())


@pytest.mark.parametrize("arch", ["florbench-100m", "granite-3-2b"])
def test_greedy_generate_matches_reference(arch):
    """The tokens equal the reference's, the first of them the argmax of
    the prefill logits (tests/test_system.py)."""
    jcfg, cfg, jparams, params, _, _, _ = _setup(arch)
    batch = synthetic_batch(cfg, 2, 16, 0)
    want = jax_greedy_generate(jcfg, jparams, batch, steps=5, max_len=32)
    got = greedy_generate(cfg, params, batch, steps=5, max_len=32)
    assert got.dtype == torch.int32 and got.shape == (2, 5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with torch.inference_mode():
        _, logits = build_model(cfg).prefill(params, _tb(batch), 32)
    np.testing.assert_array_equal(got[:, 0].numpy(),
                                  logits.argmax(-1).numpy())


@pytest.mark.parametrize("arch", ["granite-3-2b", "deepseek-v3-671b"])
def test_one_layer_init_cache_matches_reference(arch):
    """``attention.init_cache`` / ``mla.mla_init_cache``: the reference's
    empty one-layer cache (zeros, every ``slot_pos`` -1), leaf for leaf."""
    from repro.models import attention as jattn
    from repro.models import mla as jmla
    from repro_torch.models import attention, mla

    jcfg, cfg = JC.get_smoke(arch), C.get_smoke(arch)
    if cfg.mla:
        want = jmla.mla_init_cache(jcfg, 2, 40, jnp.float32)
        got = mla.mla_init_cache(cfg, 2, 40, torch.float32, "cpu")
    else:
        want = jattn.init_cache(jcfg, 2, 40, jnp.float32)
        got = attention.init_cache(cfg, 2, 40, torch.float32, "cpu")
    _assert_caches_equal(got, want)
