"""Model facade: params, loss, prefill/decode and decode caches; the audio
family is the encoder-decoder, every other family the decoder-only LM.

A cache spec is a nested dict of ``(torch.Size, dtype)`` leaves with the
reference package's leaf names and nesting (``layers``, ``dense_layers``,
``groups``, ``shared_attn``, ``tail``; ``k``/``v``/``slot_pos``,
``c_kv``/``k_r``, ``conv``/``ssm``; ``self``/``cross_k``/``cross_v``),
each stack of layers on a leading axis as the reference stacks them."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import encdec as encdec_mod
from repro_torch.models import mamba, mla
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import cache_from_spec, stack_cache_spec
from repro_torch.models.params import axes_tree, init_params, shape_tree

# encoder length of the enc-dec decode cells (about 30 s of audio frames
# after the frontend's subsampling; the frontend itself is a stub)
ENC_LEN_DECODE = 1536


def build_model(cfg: ModelConfig) -> "Model":
    return Model(cfg)


class Model:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self._spec = (encdec_mod.encdec_param_spec(cfg)
                      if cfg.family == "audio" else tfm.lm_param_spec(cfg))

    def param_spec(self):
        return self._spec

    def param_shapes(self):
        return shape_tree(self._spec)

    def param_axes(self):
        """Each parameter's logical axes (the nesting of ``param_spec``)."""
        return axes_tree(self._spec)

    def init(self, seed: int, device):
        """Materialize the parameter dict on ``device`` from ``seed``."""
        return init_params(self._spec, seed, self.cfg.param_dtype, device)

    def loss(self, params, batch):
        if self.cfg.family == "audio":
            return encdec_mod.encdec_loss(self.cfg, params, batch)
        return tfm.lm_loss(self.cfg, params, batch)

    # ----------------------------------------------------------- serving --
    def prefill(self, params, batch, max_len: int):
        """(caches holding ``max_len`` positions, last-position logits)."""
        if self.cfg.family == "audio":
            return encdec_mod.encdec_prefill(self.cfg, params, batch,
                                             max_len)
        return tfm.lm_prefill(self.cfg, params, batch, max_len)

    def decode(self, params, caches, tokens, pos):
        """One step: tokens [B,1] at position ``pos`` (an int or a 0-d
        tensor). Returns (logits [B, vocab_size], new caches)."""
        if self.cfg.family == "audio":
            return encdec_mod.encdec_decode(self.cfg, params, caches, tokens,
                                            int(pos))
        return tfm.lm_decode(self.cfg, params, caches, tokens, int(pos))

    def cache_spec(self, batch: int, max_len: int):
        cfg = self.cfg
        dtype = getattr(torch, cfg.dtype)
        fam = cfg.family
        if fam == "audio":
            return encdec_mod.encdec_cache_spec(cfg, batch, max_len,
                                                ENC_LEN_DECODE, dtype)
        if fam in ("dense", "vlm"):
            return {"layers": stack_cache_spec(
                tfm.attn_cache_spec(cfg, batch, max_len, dtype),
                cfg.num_layers)}
        if fam == "moe":
            one = tfm.attn_cache_spec(cfg, batch, max_len, dtype)
            nd = cfg.moe.first_dense_layers
            out = {"layers": stack_cache_spec(one, cfg.num_layers - nd)}
            if nd:
                out["dense_layers"] = stack_cache_spec(one, nd)
            return out
        if fam == "ssm":
            return {"layers": stack_cache_spec(
                tfm.mamba_cache_spec(cfg, batch, dtype), cfg.num_layers)}
        if fam == "hybrid":
            g, per, tail = tfm._hybrid_shape(cfg)
            m = mamba.mamba2_cache_spec(cfg, batch, dtype)
            out = {"groups": stack_cache_spec(stack_cache_spec(m, per), g),
                   "shared_attn": stack_cache_spec(
                       attn.init_cache_spec(cfg, batch, max_len, dtype), g)}
            if tail:
                out["tail"] = stack_cache_spec(m, tail)
            return out
        raise ValueError(fam)

    def _attn_cache_axes(self):
        return mla.mla_cache_axes() if self.cfg.mla \
            else attn.cache_logical_axes()

    def cache_axes(self):
        """Logical axes of every ``cache_spec`` leaf, with the same nesting
        (a stack of layers adds a leading ``"layer"`` axis)."""
        cfg = self.cfg
        fam = cfg.family

        def stack(ax):
            if isinstance(ax, dict):
                return {k: stack(v) for k, v in ax.items()}
            return ("layer",) + ax

        if fam == "audio":
            return encdec_mod.encdec_cache_axes(cfg)
        if fam in ("dense", "vlm"):
            return {"layers": stack(self._attn_cache_axes())}
        if fam == "moe":
            out = {"layers": stack(self._attn_cache_axes())}
            if cfg.moe.first_dense_layers:
                out["dense_layers"] = stack(self._attn_cache_axes())
            return out
        if fam == "ssm":
            return {"layers": stack(
                mamba.mamba1_cache_axes() if cfg.ssm.version == 1
                else mamba.mamba2_cache_axes())}
        if fam == "hybrid":
            _, _, tail = tfm._hybrid_shape(cfg)
            out = {"groups": stack(stack(mamba.mamba2_cache_axes())),
                   "shared_attn": stack(attn.cache_logical_axes())}
            if tail:
                out["tail"] = stack(mamba.mamba2_cache_axes())
            return out
        raise ValueError(fam)

    def init_cache(self, batch: int, max_len: int, device):
        """Empty caches on ``device``: ``slot_pos`` -1, the rest zeros."""
        return cache_from_spec(self.cache_spec(batch, max_len),
                               torch.device(device))

    # ------------------------------------------------------------ inputs --
    def input_specs(self, shape) -> dict:
        """Global (torch.Size, dtype) of the step inputs for a
        ``configs.base.ShapeSpec``."""
        cfg = self.cfg
        B, S = shape.global_batch, shape.seq_len
        d = cfg.d_model
        adt = getattr(torch, cfg.dtype)
        if shape.kind == "decode":
            return {"tokens": (torch.Size((B, 1)), torch.int32),
                    "pos": (torch.Size(()), torch.int32)}
        if cfg.family == "audio":
            half = S // 2
            return {"enc_embeds": (torch.Size((B, half, d)), adt),
                    "dec_tokens": (torch.Size((B, half)), torch.int32)}
        if cfg.family == "vlm":
            F = cfg.frontend_tokens
            return {"embeds": (torch.Size((B, F, d)), adt),
                    "tokens": (torch.Size((B, S - F)), torch.int32)}
        return {"tokens": (torch.Size((B, S)), torch.int32)}

    def input_axes(self, shape) -> dict:
        """Logical axes of ``input_specs``' leaves."""
        cfg = self.cfg
        b = "batch_dp3" if cfg.dense_layout == "dp" else "batch"
        if shape.kind == "decode":
            return {"tokens": (b, None), "pos": ()}
        if cfg.family == "audio":
            return {"enc_embeds": (b, None, None), "dec_tokens": (b, None)}
        if cfg.family == "vlm":
            return {"embeds": (b, None, None), "tokens": (b, None)}
        return {"tokens": (b, None)}
