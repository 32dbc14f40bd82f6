"""Training attention through the flash kernels (``ops.FlashAttention``),
on the CPU, where the node runs the kernels' plain versions
(``kernels/ref.py``):

- ``flash_attention_bwd_ref`` (the backward kernels' arithmetic) against
  ``torch.autograd`` through ``flash_attention_ref``, in f32: GQA, MQA,
  causal and not, a ragged S, Sq > Sk (rows that see no key), Sq < Sk;
- the hi + lo pair that carries P and dS into their 16-bit products,
  against f64, within its 2**-16 (bf16) / 2**-22 (f16) relative bound;
- ``FlashAttention``'s gradients against the chunked path's, in f32 and
  bf16, and its forward's lse against ``logsumexp``;
- a small granite-shaped model with ``attention_impl="pallas"`` (the flash
  node) against the reference package's model, whose "pallas" runs its
  chunked attention;
- the routing table of ``attention._impl``: device, dtype, head dim,
  window, a sharded sequence and each ``attention_impl``, and "auto" on
  the CPU giving the naive / chunked path's bits.

The card's half (the kernels against these plain versions, launch counts
in a train step) is ``tests/test_torch_flash_card.py``.
"""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
import repro_torch.configs as C
from repro.models import build_model as jax_build_model
from repro.train.step import build_train_step as jax_build_train_step
from repro_torch.data import synthetic_batch
from repro_torch.kernels import ops, ref
from repro_torch.models import attention as attn
from repro_torch.models import build_model
from repro_torch.train.state import state_from_numpy
from repro_torch.utils.pytree import tree_flatten, tree_unflatten
from test_torch_flash_card import bwd_exact, rounding_misses
from test_torch_model import GRAD_RTOL_F32, LOSS_RTOL_F32

# [B, H, KV, Sq, Sk, d, causal]
BWD_CASES = {
    "gqa-causal": (2, 8, 2, 64, 64, 16, True),
    "mqa-causal": (1, 4, 1, 48, 48, 32, True),
    "mha-bidirectional": (2, 4, 4, 40, 40, 16, False),
    "ragged-S200": (1, 4, 2, 200, 200, 16, True),
    "sq-gt-sk": (1, 4, 2, 96, 64, 16, True),
    "sq-lt-sk": (1, 4, 2, 40, 100, 16, True),
}


def _inputs(B, H, KV, Sq, Sk, d, dtype=torch.float32, seed=0):
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape)
                                .astype(np.float32)).to(dtype)
    return t(B, H, Sq, d), t(B, KV, Sk, d), t(B, KV, Sk, d), t(B, H, Sq, d)


@pytest.mark.parametrize("case", list(BWD_CASES))
def test_bwd_ref_matches_autograd(case):
    """In f32 the backward's arithmetic (D from the stored o, P from lse,
    hi + lo with a zero lo) is the softmax's gradient: within 2e-6 of the
    largest gradient entry, f32 summation order apart. Rows that see no
    key (Sq > Sk) give v the mean of their dO and q nothing."""
    B, H, KV, Sq, Sk, d, causal = BWD_CASES[case]
    q, k, v, do = _inputs(B, H, KV, Sq, Sk, d)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    o = ref.flash_attention_ref(*leaves, causal=causal)
    want = torch.autograd.grad(o, leaves, do)
    o2, lse = ref.flash_attention_ref(q, k, v, causal=causal,
                                      return_lse=True)
    assert torch.equal(o2, o.detach())
    got = ref.flash_attention_bwd_ref(q, k, v, o2, do, lse, causal=causal)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert float((g - w).abs().max()) <= 2e-6 * float(w.abs().max())
    if case == "sq-gt-sk":
        blind = Sq - Sk
        assert float(got[0][:, :, :blind].abs().max()) == 0.0


@pytest.mark.parametrize("dtype,bound", [(torch.bfloat16, 2.0 ** -16),
                                         (torch.float16, 2.0 ** -22)])
def test_hi_lo_pair_against_f64(dtype, bound):
    """hi = fl16(x), lo = fl16(x - hi): hi + lo is x within ``bound``
    relative (u**2 of the 16-bit type; f16's lo below its normal range adds
    half its subnormal spacing, 2**-25), for P over (0, 1] and for dS
    (signed, 1e-6 to 1e2); a product sum(hi y) + sum(lo y) in f32 stays
    within bound * sum|x y| plus f32's own n * 2**-24 of f64's sum."""
    rng = np.random.default_rng(3)
    p = np.exp(-rng.uniform(0, 20, 50_000))
    ds = rng.choice([-1, 1], 50_000) * 10.0 ** rng.uniform(-6, 2, 50_000)
    floor = 2.0 ** -25 if dtype == torch.float16 else 0.0
    for x64 in (p, ds):
        x = torch.from_numpy(x64.astype(np.float32))
        hi, lo = ref.split_pair_ref(x, dtype)
        err = (hi.double() + lo.double() - x.double()).abs()
        assert bool((err <= bound * x.double().abs() + floor).all())
        single = (hi.double() - x.double()).abs() / x.double().abs()
        assert float(single.max()) > 2.0 ** -12      # hi alone: far off
        y = torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32))
        y = y.to(dtype).float()                       # dO, q or k: 16-bit
        got = float((hi * y).sum() + (lo * y).sum())
        exact = float((x.double() * y.double()).sum())
        mag = float((x.double() * y.double()).abs().sum())
        assert abs(got - exact) <= (bound + x.numel() * 2.0 ** -24) * mag \
            + floor * float(y.abs().sum())


def test_pair_keeps_dv_closer_than_one_rounding():
    """Why the backward keeps the pair: dV = P^T dO with P rounded once to
    bf16 is off the f64 product by far more than with hi + lo."""
    rng = np.random.default_rng(11)
    p = torch.from_numpy(np.exp(-rng.uniform(0, 1, (256, 64)))
                         .astype(np.float32))
    dO = torch.from_numpy(rng.standard_normal((256, 32)).astype(np.float32))
    dO = dO.to(torch.bfloat16).float()
    exact = p.double().T @ dO.double()
    hi, lo = ref.split_pair_ref(p, torch.bfloat16)
    pair_err = float((hi.T @ dO + lo.T @ dO - exact).abs().max())
    single_err = float((hi.T @ dO - exact).abs().max())
    assert pair_err * 100 < single_err


def test_bwd_ref_pair_misses_rounding_far_less_than_one_rounding():
    """The plain version's hi + lo products against the exact (f64)
    function of the same bf16 inputs, o and lse: its dq, dk and dv miss
    the correct rounding to bf16 at under a tenth of the rate that P and
    dS rounded once give, the statistic that the card's test holds the
    kernels to."""
    q, k, v, do = (x.to(torch.bfloat16)
                   for x in _inputs(1, 4, 2, 256, 256, 32))
    o, lse = ref.flash_attention_ref(q, k, v, return_lse=True)
    got = ref.flash_attention_bwd_ref(q, k, v, o, do, lse)
    exact = bwd_exact(q, k, v, o, do, lse)
    single = bwd_exact(q, k, v, o, do, lse, torch.float32, torch.bfloat16)
    for g, e, s in zip(got, exact, single):
        pair_rate = rounding_misses(g, e)
        single_rate = rounding_misses(s.to(g.dtype), e)
        assert single_rate > 0.05, single_rate
        assert 10 * pair_rate < single_rate, (pair_rate, single_rate)


def _attn_cfg(impl):
    return C.get_smoke("florbench-100m").replace(attention_impl=impl,
                                                 attention_chunk=16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_node_gradients_match_chunked(dtype):
    """``_core`` through the flash node (attention_impl "pallas" on the
    CPU) against the chunked path, same inputs: in f32 within 2e-6 of each
    tensor's largest entry (summation order); in bf16 within 2**-6 of it,
    each path rounding its scores' products, o and the gradients to bf16
    in other places."""
    B, S, KV, G, hd = 2, 40, 2, 3, 16
    rng = np.random.default_rng(7)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape)
                                .astype(np.float32)).to(dtype)
    q, k, v, do = t(B, S, KV, G, hd), t(B, S, KV, hd), t(B, S, KV, hd), \
        t(B, S, KV, G, hd)
    res = {}
    for impl in ("pallas", "chunked"):
        cfg = _attn_cfg(impl)
        assert attn._impl(cfg, S, q) == ("flash" if impl == "pallas"
                                         else "chunked")
        xs = [x.clone().requires_grad_(True) for x in (q, k, v)]
        o = attn._core(cfg, *xs, True, None, 1.0 / np.sqrt(hd))
        res[impl] = (o, *torch.autograd.grad(o, xs, do))
    tol = 2e-6 if dtype == torch.float32 else 2.0 ** -6
    for a, b in zip(res["pallas"], res["chunked"]):
        assert a.shape == b.shape and a.dtype == b.dtype == dtype
        a, b = a.detach().float(), b.detach().float()
        assert float((a - b).abs().max()) <= tol * float(b.abs().max())


def test_flash_path_keeps_the_pair_under_bfloat16_probs():
    """A bfloat16 ``attention_probs_dtype`` does not lower the flash path's
    precision: P and dS stay hi + lo, so o and the gradients have the
    float32 configuration's bits."""
    B, S, KV, G, hd = 1, 24, 2, 2, 16
    q, k, v, do = (x.to(torch.bfloat16) for x in (
        torch.randn(B, S, KV, G, hd), torch.randn(B, S, KV, hd),
        torch.randn(B, S, KV, hd), torch.randn(B, S, KV, G, hd)))
    res = []
    for probs in ("float32", "bfloat16"):
        cfg = _attn_cfg("pallas").replace(attention_probs_dtype=probs)
        xs = [x.clone().requires_grad_(True) for x in (q, k, v)]
        o = attn._core(cfg, *xs, True, None, 0.25)
        res.append((o, *torch.autograd.grad(o, xs, do)))
    assert all(torch.equal(a, b) for a, b in zip(*res))


def test_flash_forward_lse_is_logsumexp():
    """The forward's lse [B, H, Sq] is logsumexp of the scaled, masked
    scores (f32); a row that sees no key reads -1e30."""
    B, H, KV, Sq, Sk, d = 1, 4, 2, 50, 30, 16
    q, k, v, _ = _inputs(B, H, KV, Sq, Sk, d)
    _, lse = ops.flash_attention(q, k, v, causal=True, return_lse=True)
    s = torch.einsum("bhqd,bhkd->bhqk", q,
                     k.repeat_interleave(H // KV, dim=1)) / np.sqrt(d)
    keep = torch.arange(Sk)[None, :] <= torch.arange(Sq)[:, None] + Sk - Sq
    want = torch.logsumexp(s.masked_fill(~keep, -1e30), dim=-1)
    seen = slice(Sq - Sk, None)
    torch.testing.assert_close(lse[..., seen], want[..., seen], atol=1e-5,
                               rtol=1e-6)
    assert bool((lse[..., :Sq - Sk] == torch.tensor(-1e30)).all())


def _granite_shaped(pkg):
    """granite-3-2b's shape at a CPU's size: GQA 4:1, SwiGLU, tied
    embeddings, 2 layers, f32."""
    return pkg.get_smoke("florbench-100m").replace(
        num_layers=2, d_model=128, num_heads=8, num_kv_heads=2, head_dim=16,
        d_ff=256, ffn_activation="swiglu", dtype="float32",
        attention_impl="pallas")


def test_granite_shaped_step_with_pallas_matches_reference(monkeypatch):
    """The port's loss and gradients with ``attention_impl="pallas"`` (the
    flash node, through remat's recompute) against the reference's, whose
    "pallas" runs its chunked path, in f32 at the model tests'
    tolerances."""
    cfg = _granite_shaped(JC)
    init_state, _ = jax_build_train_step(cfg)
    jstate = jax.jit(init_state)(jax.random.PRNGKey(0))
    np_state = jax.tree_util.tree_map(np.array, jax.device_get(jstate))
    b = synthetic_batch(cfg, 2, 48, step=3, seed=0)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        jax_build_model(cfg).loss, has_aux=True))(jstate.params, jb)
    pcfg = _granite_shaped(C)
    state = state_from_numpy(np_state, "cpu")
    leaves, treedef = tree_flatten(state.params)
    leaves = [p.detach().requires_grad_(True) for p in leaves]
    calls = []
    orig = ops.flash_attention

    def counted(*a, **kw):
        calls.append(kw["return_lse"])
        return orig(*a, **kw)
    monkeypatch.setattr(ops, "flash_attention", counted)
    loss, _ = build_model(pcfg).loss(tree_unflatten(treedef, leaves),
                                     {k: torch.from_numpy(v)
                                      for k, v in b.items()})
    grads = torch.autograd.grad(loss, leaves)
    assert len(calls) == 2 * pcfg.num_layers     # forward + remat recompute
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=LOSS_RTOL_F32)
    for g, jg in zip(grads, jax.tree_util.tree_leaves(jgrads)):
        jg = np.asarray(jg)
        scale = max(float(np.abs(jg).max()), 1e-30)
        assert np.abs(g.numpy() - jg).max() <= GRAD_RTOL_F32 * scale


def _q(device, dtype, hd):
    """What ``_impl`` reads of q: its device, dtype and head dim."""
    return SimpleNamespace(is_cuda=device == "cuda", dtype=dtype,
                           shape=(2, 4096, 8, 4, hd))


BF, F16, F32 = torch.bfloat16, torch.float16, torch.float32
# (impl, device, dtype, head dim, S, window, sequence sharded) -> path
ROUTES = [
    ("auto", "cuda", BF, 64, 4096, None, False, "flash"),
    ("auto", "cuda", F16, 128, 512, None, False, "flash"),
    ("pallas", "cuda", BF, 64, 512, None, False, "flash"),
    ("auto", "cuda", BF, 64, 4096, 4096, False, "flash"),
    ("auto", "cuda", BF, 64, 8192, 4096, False, "chunked"),
    ("auto", "cuda", BF, 64, 512, 256, False, "naive"),
    ("auto", "cuda", BF, 64, 4096, None, True, "chunked"),
    ("auto", "cuda", BF, 256, 4096, None, False, "chunked"),
    ("auto", "cuda", BF, 96, 512, None, False, "naive"),
    ("auto", "cuda", F32, 64, 4096, None, False, "chunked"),
    ("auto", "cuda", F32, 64, 512, None, False, "naive"),
    ("pallas", "cuda", F32, 64, 512, None, False, "chunked"),
    ("naive", "cuda", BF, 64, 4096, None, False, "naive"),
    ("chunked", "cuda", BF, 64, 512, None, False, "chunked"),
    ("auto", "cpu", BF, 64, 4096, None, False, "chunked"),
    ("auto", "cpu", F32, 64, 512, None, False, "naive"),
    ("pallas", "cpu", F32, 32, 512, None, False, "flash"),
    ("pallas", "cpu", BF, 256, 4096, None, False, "flash"),
    ("pallas", "cpu", BF, 64, 8192, 4096, False, "chunked"),
    ("pallas", "cpu", BF, 64, 512, None, True, "chunked"),
    ("naive", "cpu", F32, 64, 512, None, False, "naive"),
    ("chunked", "cpu", F32, 64, 512, None, False, "chunked"),
]


@pytest.mark.parametrize("impl,device,dtype,hd,S,window,sharded,want",
                         ROUTES, ids=[f"{r[0]}-{r[1]}-{str(r[2])[6:]}-d{r[3]}"
                                      f"-S{r[4]}-w{r[5]}-sh{int(r[6])}"
                                      for r in ROUTES])
def test_impl_routes_by_what_the_call_sees(impl, device, dtype, hd, S, window,
                                           sharded, want):
    cfg = C.get_smoke("florbench-100m").replace(attention_impl=impl)
    assert attn._impl(cfg, S, _q(device, dtype, hd), window, sharded) == want
    # without q (the sequence-parallel gate) never flash
    assert attn._impl(cfg, S) in ("naive", "chunked")


def test_impl_keeps_fake_tensors_on_the_plain_path():
    """The dry run traces the step on fake tensors (no memory, so no kernel
    can read them): a fake bf16 CUDA q at head dim 64 takes the path it
    took before the flash route existed."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    cfg = C.get_smoke("florbench-100m")
    with FakeTensorMode(allow_non_fake_inputs=True):
        q = torch.empty((2, 4096, 8, 4, 64), dtype=torch.bfloat16,
                        device="cuda")
        assert q.is_cuda
        assert attn._impl(cfg, 4096, q) == "chunked"
        assert attn._impl(cfg.replace(attention_impl="pallas"), 512,
                          q) == "chunked"


@pytest.mark.parametrize("S,path", [(40, "naive"), (2100, "chunked")])
def test_auto_on_cpu_keeps_the_plain_paths_bits(S, path):
    """On the CPU "auto" gives the bits of the path the reference's "auto"
    picks: naive at S <= 2048, chunked above."""
    B, KV, G, hd = 1, 1, 2, 8
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.standard_normal((B, S, KV, G, hd))
                         .astype(np.float32)).to(torch.bfloat16)
    k = torch.from_numpy(rng.standard_normal((B, S, KV, hd))
                         .astype(np.float32)).to(torch.bfloat16)
    scale = 1.0 / np.sqrt(hd)
    auto = C.get_smoke("florbench-100m").replace(attention_chunk=1024)
    got = attn._core(auto, q, k, k, True, None, scale)
    want = attn._core(auto.replace(attention_impl=path), q, k, k, True, None,
                      scale)
    assert torch.equal(got, want)
