"""The training flash-attention kernels on the card (``cuda``-marked: each
skips without a CUDA card, since a CUDA kernel has no CPU mode):

- the backward kernels against ``flash_attention_bwd_ref`` on the same
  bf16 inputs, the forward's o and lse, at granite-3-2b's attention (32 / 8
  heads of 64, 512 and 4096 positions) and at head dim 128 in f16;
- the kernels carry P and dS into their products as the hi + lo pair:
  against the exact function their gradients miss the correct rounding
  far less often than P and dS rounded once would;
- the forward's lse against ``logsumexp`` of the plain scores, with and
  without a key split;
- two backward calls give the same bits (dQ has its own kernel: no
  atomics);
- a granite-3-2b train step cut to 2 layers runs 2 forward launches and 1
  backward launch a layer (remat recomputes the forward) and never the
  naive or chunked path;
- fake CUDA tensors (the dry run's traces) take the plain path and launch
  nothing.

No JAX here: the card's machine has none. Run on the card with
``python -m pytest -m cuda tests/test_torch_flash_card.py``.
"""
import pytest
import torch

from repro_torch.kernels import ops, ref

# Kernel and plain version compute in f32 from the same 16-bit inputs; they
# differ in summation order and in the final rounding to bf16 / f16: within
# one output ulp (rtol 1e-2) plus 2e-3 of the tensor's largest entry for
# the sums whose terms cancel.
RTOL, ATOL_OF_MAX = 1e-2, 2e-3


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, B, H, KV, Sq, Sk, d, dtype, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(s, generator=gen, device=dev).to(dtype)
            for s in ((B, H, Sq, d), (B, KV, Sk, d), (B, KV, Sk, d),
                      (B, H, Sq, d))]


def _close(got, want):
    g, w = got.float(), want.float()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert bool(torch.isfinite(g).all())
    excess = ((g - w).abs() - RTOL * w.abs()).max()
    assert float(excess) <= ATOL_OF_MAX * float(w.abs().max())


def bwd_exact(q, k, v, o, do, lse, dtype=torch.float64, round16=None):
    """(dq, dk, dv) of the causal flash backward's function (Sq <= Sk),
    from the same 16-bit inputs, o and f32 lse, computed in ``dtype`` and
    not rounded at the end; ``round16`` rounds P and dS to that 16-bit
    type once before their products, the single rounding that the hi + lo
    pair avoids."""
    B, H, Sq, d = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    G, scale = H // KV, 1.0 / d ** 0.5
    qg, og, dog = (t.reshape(B, KV, G, Sq, d).to(dtype) for t in (q, o, do))
    kf, vf = k.to(dtype), v.to(dtype)
    keep = torch.arange(Sk, device=q.device)[None, :] \
        <= torch.arange(Sq, device=q.device)[:, None] + (Sk - Sq)
    s = torch.einsum("bkgqd,bksd->bkgqs", qg, kf) * scale
    p = torch.where(keep, torch.exp(s - lse.reshape(B, KV, G, Sq, 1)
                                    .to(dtype)), 0.0)
    dp = torch.einsum("bkgqd,bksd->bkgqs", dog, vf)
    ds = p * (dp - (dog * og).sum(dim=-1, keepdim=True))
    if round16 is not None:
        p, ds = (x.to(round16).to(dtype) for x in (p, ds))
    dq = torch.einsum("bkgqs,bksd->bkgqd", ds, kf) * scale
    dk = torch.einsum("bkgqs,bkgqd->bksd", ds, qg) * scale
    dv = torch.einsum("bkgqs,bkgqd->bksd", p, dog)
    return dq.reshape(B, H, Sq, d), dk, dv


def rounding_misses(got, exact) -> float:
    """Share of the entries of 16-bit ``got`` that are not ``exact``
    rounded once to got's dtype."""
    return float((got != exact.to(got.dtype)).float().mean())


BWD_CASES = {
    "granite-512": (2, 32, 8, 512, 512, 64, True, torch.bfloat16),
    "granite-4096": (1, 32, 8, 4096, 4096, 64, True, torch.bfloat16),
    "d128-f16": (1, 8, 2, 300, 300, 128, True, torch.float16),
    "d128-bidirectional": (2, 4, 4, 256, 256, 128, False, torch.bfloat16),
    "sq-gt-sk": (1, 4, 2, 200, 72, 64, True, torch.bfloat16),
    "sq-lt-sk": (1, 8, 2, 128, 320, 64, True, torch.bfloat16),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(BWD_CASES))
def test_flash_bwd_kernel_matches_plain_version(dev, case):
    B, H, KV, Sq, Sk, d, causal, dtype = BWD_CASES[case]
    q, k, v, do = _inputs(dev, B, H, KV, Sq, Sk, d, dtype)
    o, lse = ops.flash_attention(q, k, v, causal=causal, return_lse=True)
    got = ops.flash_attention_bwd(q, k, v, o, do, lse, causal=causal)
    want = ref.flash_attention_bwd_ref(q, k, v, o, do, lse, causal=causal)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
def test_flash_bwd_carries_p_and_ds_as_a_pair(dev, d):
    """dq, dk and dv of the kernels against the exact (f64) function of
    the same inputs, o and lse: they miss its correct rounding to bf16 at
    under a tenth of the rate that P and dS rounded once to bf16 give
    (f32 sums, TF32 off). Kernels that dropped the lo products, or ran
    P's single rounding, would miss at that rate."""
    q, k, v, do = _inputs(dev, 1, 8, 2, 512, 512, d, torch.bfloat16)
    o, lse = ops.flash_attention(q, k, v, return_lse=True)
    got = ops.flash_attention_bwd(q, k, v, o, do, lse)
    exact = bwd_exact(q, k, v, o, do, lse)
    single = bwd_exact(q, k, v, o, do, lse, torch.float32, torch.bfloat16)
    for g, e, s in zip(got, exact, single):
        pair_rate = rounding_misses(g, e)
        single_rate = rounding_misses(s.to(g.dtype), e)
        assert single_rate > 0.05, single_rate
        assert 10 * pair_rate < single_rate, (pair_rate, single_rate)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 32, 8, 512, 512, 64),
                                   (1, 40, 8, 128, 2048, 128)],
                         ids=["one-split", "key-split"])
def test_flash_forward_lse_is_logsumexp(dev, shape):
    """lse of the kernel (the combine kernel's under a key split) against
    logsumexp of the plain f32 scores: 1e-4, exp and log to a few ulps of
    numbers near 10; o keeps its bits with or without lse."""
    B, H, KV, Sq, Sk, d = shape
    q, k, v, _ = _inputs(dev, B, H, KV, Sq, Sk, d, torch.bfloat16)
    o, lse = ops.flash_attention(q, k, v, return_lse=True)
    assert torch.equal(o, ops.flash_attention(q, k, v))
    _, want = ref.flash_attention_ref(q, k, v, return_lse=True)
    torch.testing.assert_close(lse, want, atol=1e-4, rtol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("shape", [(2, 32, 8, 512), (2, 8, 2, 200)],
                         ids=["one-split", "key-split"])
def test_flash_kernels_read_the_models_layout(dev, shape, d):
    """q, k, v and dO as the model holds them ([B, S, H, d] seen as [B, H,
    S, d] through a transpose) give the bits of the contiguous call: the
    TMA maps and the writes follow the strides, the arithmetic is the
    same. dq, dk and dv come back in the inputs' layout, o too unless the
    keys are split (the combine kernel writes it contiguous)."""
    from repro_torch.kernels import flash_attention as fa

    B, H, KV, S = shape
    q, k, v, do = _inputs(dev, B, H, KV, S, S, d, torch.bfloat16)
    views = [t.transpose(1, 2).contiguous().transpose(1, 2)
             for t in (q, k, v, do)]
    assert not views[0].is_contiguous()
    o, lse = ops.flash_attention(q, k, v, return_lse=True)
    ov, lsev = ops.flash_attention(*views[:3], return_lse=True)
    split = fa.plan(B, H, S, S, d, q.dtype)["n_split"] > 1
    assert ov.stride() == (o.stride() if split else views[0].stride())
    assert torch.equal(o, ov) and torch.equal(lse, lsev)
    got = ops.flash_attention_bwd(*views[:3], ov, views[3], lsev)
    want = ops.flash_attention_bwd(q, k, v, o, do, lse)
    for g, w, x in zip(got, want, views[:3]):
        assert g.stride() == x.stride() and torch.equal(g, w)


@pytest.mark.cuda
def test_flash_bwd_gives_the_same_bits_twice(dev):
    q, k, v, do = _inputs(dev, 2, 32, 8, 512, 512, 64, torch.bfloat16)
    o, lse = ops.flash_attention(q, k, v, return_lse=True)
    a = ops.flash_attention_bwd(q, k, v, o, do, lse)
    b = ops.flash_attention_bwd(q, k, v, o, do, lse)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
def test_granite_train_step_runs_the_flash_kernels(dev, monkeypatch):
    """granite-3-2b at its widths, 2 layers, 2 x 512 tokens, bf16 compute
    and remat on: one train step launches the forward twice a layer
    (forward and remat's recompute) and the backward once, never runs the
    naive or chunked attention, and fills no mask from attention (the
    head's fill of the padded vocabulary, 49 155 of 49 664, stays)."""
    import sys
    from repro_torch.configs.base import ModelConfig
    from repro_torch.data import synthetic_batch
    from repro_torch.models import attention as attn
    from repro_torch.train.step import build_train_step

    cfg = ModelConfig(name="granite-3-2b-2l", family="dense", num_layers=2,
                      d_model=2048, num_heads=32, num_kv_heads=8, d_ff=8192,
                      vocab_size=49155, head_dim=64, ffn_activation="swiglu",
                      tie_embeddings=True)
    plain = []
    for name in ("_sdpa", "_chunked_sdpa"):
        fn = getattr(attn, name)
        monkeypatch.setattr(attn, name, lambda *a, _fn=fn, _n=name, **kw:
                            plain.append(_n) or _fn(*a, **kw))
    fills = []
    fill = torch.Tensor.masked_fill
    monkeypatch.setattr(torch.Tensor, "masked_fill", lambda x, *a, **kw:
                        fills.append(sys._getframe(1).f_code.co_filename)
                        or fill(x, *a, **kw))
    init, step = build_train_step(cfg, device=dev)
    state = init(0)
    batch = synthetic_batch(cfg, 2, 512, 0)
    ops.reset_launch_counts()
    new, m = step(state, batch)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts["flash_attention"] == 2 * cfg.num_layers
    assert counts["flash_attention_bwd"] == cfg.num_layers
    assert plain == []
    assert fills and not [f for f in fills if f.endswith("attention.py")]
    assert bool(torch.isfinite(m["loss"]))


@pytest.mark.cuda
def test_fake_cuda_tensors_trace_without_a_launch(dev):
    """The dry run traces the step on fake CUDA tensors, which hold no
    memory. Sent to the kernel, a fake q made the TMA encode refuse its
    address (cudaErrorInvalidValue). At granite-3-2b's attention (bf16,
    32 / 8 heads of 64) ``_core`` traces the plain path on them and
    launches nothing; the same real tensors take the flash route."""
    from torch.fx.experimental.proxy_tensor import make_fx

    import repro_torch.configs as C
    from repro_torch.models import attention as attn

    cfg = C.get_smoke("florbench-100m")
    B, S, KV, G, hd = 2, 512, 8, 4, 64
    q = torch.randn(B, S, KV, G, hd, device=dev).to(torch.bfloat16)
    k = torch.randn(B, S, KV, hd, device=dev).to(torch.bfloat16)
    assert attn._impl(cfg, S, q) == "flash"
    ops.reset_launch_counts()
    gm = make_fx(lambda q, k, v: attn._core(cfg, q, k, v, True, None, 0.125),
                 tracing_mode="fake")(q, k, k)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == 0
    assert len(gm.graph.nodes) > 4
