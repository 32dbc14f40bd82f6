"""Model facade: params, loss, prefill/decode and decode caches; the audio
family is the encoder-decoder, every other family the decoder-only LM.

A cache spec is a nested dict of ``(torch.Size, dtype)`` leaves with the
reference package's leaf names and nesting (``layers``, ``dense_layers``,
``groups``, ``shared_attn``, ``tail``; ``k``/``v``/``slot_pos``,
``c_kv``/``k_r``, ``conv``/``ssm``; ``self``/``cross_k``/``cross_v``),
each stack of layers on a leading axis as the reference stacks them.

Under a mesh (``parallel.sharding.use_mesh``) ``prefill`` and ``decode``
take the parameters as DTensors (laid out by
``launch.specs.param_shardings``, ``serve=`` as the caller chooses) and the
global batch; caches go in and come out as DTensors laid out by
``launch.specs.cache_shardings``, logits come back whole on every rank
(the reference's replicated ``out_shardings``). The compute runs on the
local shards (``transformer.lm_prefill`` / ``lm_decode`` and their
encoder-decoder forms); with no mesh the same walk runs on whole tensors
and the caches are plain ones."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import encdec as encdec_mod
from repro_torch.models import mamba, mla
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import cache_from_spec, stack_cache_spec
from repro_torch.models.params import axes_tree, init_params, shape_tree
from repro_torch.parallel.sharding import (current_mesh, global_shape,
                                           physical_spec, place_shard,
                                           spec_from_placements)

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

    def init(self, seed: int, device, place=None):
        """Materialize the parameter dict on ``device`` from ``seed``
        (``place(path, leaf)`` keeps a process's slice of each leaf as it
        is made: ``models.params.init_params``)."""
        return init_params(self._spec, seed, self.cfg.param_dtype, device,
                           place)

    def loss(self, params, batch, batch_specs=None):
        """(loss, metrics). Under a mesh ``params`` are local shards and
        ``batch`` the global batch, or its shards laid out by
        ``batch_specs``."""
        if self.cfg.family == "audio":
            return encdec_mod.encdec_loss(self.cfg, params, batch,
                                          batch_specs)
        return tfm.lm_loss(self.cfg, params, batch, batch_specs)

    # ----------------------------------------------------------- serving --
    def cache_specs_on(self, batch: int, max_len: int, mesh=None,
                       enc_len=None):
        """(the cache leaves' specs on ``mesh`` — the reference's
        ``cache_shardings`` — and one rank's local cache spec);
        ``enc_len`` the encoder's length (default ``ENC_LEN_DECODE``)."""
        mesh = mesh or current_mesh()
        spec = self.cache_spec(batch, max_len)
        if enc_len is not None:
            spec = encdec_mod.encdec_cache_spec(
                self.cfg, batch, max_len, enc_len,
                getattr(torch, self.cfg.dtype))

        def resolve(ax, sp):
            if isinstance(ax, dict):
                return {k: resolve(ax[k], sp[k]) for k in ax}
            return tuple(physical_spec(ax, tuple(sp[0]), mesh))
        cspecs = resolve(self.cache_axes(), spec)
        return cspecs, tfm.local_cache_spec(spec, cspecs)

    def prefill_local(self, params, specs, batch, bspecs, max_len: int):
        """``prefill`` on this rank's shards: parameters laid out by
        ``specs``, the batch by ``bspecs`` (None: whole); returns (local
        caches, their specs, logits on every rank)."""
        cfg = self.cfg
        key = "dec_tokens" if cfg.family == "audio" else "tokens"
        B = global_shape(batch[key].shape, (bspecs or {}).get(key, ()))[0]
        cspecs, local = self.cache_specs_on(
            B, max_len, enc_len=batch["enc_embeds"].shape[1]
            if cfg.family == "audio" else None)
        fn = (encdec_mod.encdec_prefill if cfg.family == "audio"
              else tfm.lm_prefill)
        caches, logits = fn(cfg, params, specs, batch, bspecs or {},
                            max_len, cspecs, local)
        return caches, cspecs, logits

    def decode_local(self, params, specs, caches, cspecs, tokens, tok_have,
                     pos: int):
        """``decode`` on this rank's shards: returns (logits on every
        rank, new local caches)."""
        fn = (encdec_mod.encdec_decode if self.cfg.family == "audio"
              else tfm.lm_decode)
        return fn(self.cfg, params, specs, caches, cspecs, tokens,
                  tok_have or (None, None), int(pos))

    def prefill(self, params, batch, max_len: int):
        """(caches holding ``max_len`` positions, last-position logits)."""
        local, specs = _local(params)
        caches, cspecs, logits = self.prefill_local(local, specs, batch, {},
                                                    max_len)
        return _placed(caches, cspecs, current_mesh()), logits

    def decode(self, params, caches, tokens, pos):
        """One step: tokens [B,1] at position ``pos`` (an int or a 0-d
        tensor). Returns (logits [B, vocab_size], new caches)."""
        local, specs = _local(params)
        lc, cspecs = _local(caches)
        logits, new = self.decode_local(local, specs, lc, cspecs, tokens,
                                        None, pos)
        return logits, _placed(new, cspecs, current_mesh())

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


def _local(tree):
    """(local tensors, their specs) of a tree of DTensors; a plain tensor
    is whole on every rank (its spec replicates)."""
    from torch.distributed.tensor import DTensor
    if isinstance(tree, dict):
        pairs = {k: _local(v) for k, v in tree.items()}
        return ({k: v[0] for k, v in pairs.items()},
                {k: v[1] for k, v in pairs.items()})
    if isinstance(tree, DTensor):
        return tree.to_local(), spec_from_placements(
            tree.placements, tree.ndim, tree.device_mesh)
    return tree, (None,) * tree.ndim


def _placed(tree, specs, mesh):
    """Local shards as DTensors laid out by ``specs`` on ``mesh`` (with no
    mesh: the tensors as they are)."""
    if mesh is None:
        return tree
    if isinstance(tree, dict):
        return {k: _placed(tree[k], specs[k], mesh) for k in tree}
    return place_shard(tree, mesh, specs)
