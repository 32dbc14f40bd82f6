"""The port's encoder-decoder (``models/encdec.py``) and cross-attention
against the reference's on the CPU, from the same parameters and inputs,
at the seamless-m4t-large-v2 smoke widths, in f32: outputs within 1e-5 of
max|y| and gradients within 1e-4 of each leaf's max (only the order of
the sums differs), with encoder and decoder lengths that differ."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
from repro.models import attention as jattn
from repro.models import encdec as jencdec
from repro_torch.data import synthetic_batch
from repro_torch.models import attention, encdec
from torch_parity import check_parity, reference_params


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfg(**kw):
    return JC.get_smoke("seamless-m4t-large-v2").replace(dtype="float32",
                                                         **kw)


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


@pytest.mark.parametrize("Sq,Sk", [(12, 20), (20, 7)])
def test_cross_attention_matches_reference(Sq, Sk):
    cfg = _cfg()
    np_p = reference_params(jattn.attn_spec(cfg, cross=True))
    assert "q_norm" not in np_p
    check_parity(lambda p, x, e: jattn.cross_attention(cfg, p, x, e),
                 lambda p, x, e: attention.cross_attention(cfg, p, x, e),
                 np_p, [_x((2, Sq, cfg.d_model), 0),
                        _x((2, Sk, cfg.d_model), 1)],
                 [(2, Sq, cfg.d_model)])


@pytest.mark.parametrize("impl", ["naive", "chunked"])
def test_encoder_matches_reference(impl):
    """The bidirectional encoder stack with rope, through both softmax
    paths of the port's self-attention."""
    cfg = _cfg(attention_impl=impl, attention_chunk=8)
    np_p = reference_params(jencdec.encdec_param_spec(cfg))
    S = 20
    check_parity(lambda p, e: jencdec.encode(cfg, p, e),
                 lambda p, e: encdec.encode(cfg, p, e),
                 np_p, [_x((2, S, cfg.d_model), 2)], [(2, S, cfg.d_model)])


@pytest.mark.parametrize("seq", [32, 46])
def test_encdec_loss_matches_reference(seq):
    """The whole loss on a synthetic batch (frame embeddings and decoder
    tokens, each ``seq // 2`` long), gradients on every leaf and on the
    frame embeddings."""
    cfg = _cfg()
    np_p = reference_params(jencdec.encdec_param_spec(cfg))
    b = synthetic_batch(cfg, 2, seq, step=1, seed=0)
    toks = jnp.asarray(b["dec_tokens"])
    ttoks = torch.from_numpy(b["dec_tokens"])
    check_parity(
        lambda p, e: jencdec.encdec_loss(cfg, p, {"enc_embeds": e,
                                                  "dec_tokens": toks})[0],
        lambda p, e: encdec.encdec_loss(cfg, p, {"enc_embeds": e,
                                                 "dec_tokens": ttoks})[0],
        np_p, [b["enc_embeds"]], [()])
