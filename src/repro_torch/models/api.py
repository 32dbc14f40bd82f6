"""Model facade: params and loss (the train step's view of a model); the
audio family is the encoder-decoder, every other family the decoder-only
LM.

Prefill/decode and KV caches are the serving slice's (ROADMAP queue 1,
item 7)."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec as encdec_mod
from repro_torch.models import transformer as tfm
from repro_torch.models.params import init_params


def build_model(cfg: ModelConfig) -> "Model":
    return Model(cfg)


class Model:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self._spec = (encdec_mod.encdec_param_spec(cfg)
                      if cfg.family == "audio" else tfm.lm_param_spec(cfg))

    def param_spec(self):
        return self._spec

    def init(self, seed: int, device):
        """Materialize the parameter dict on ``device`` from ``seed``."""
        return init_params(self._spec, seed, self.cfg.param_dtype, device)

    def loss(self, params, batch):
        if self.cfg.family == "audio":
            return encdec_mod.encdec_loss(self.cfg, params, batch)
        return tfm.lm_loss(self.cfg, params, batch)
