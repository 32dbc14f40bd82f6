"""Model facade: params and loss (the train step's view of a model).

Prefill/decode and KV caches are the serving slice's (ROADMAP queue 1,
item 15)."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tfm
from repro_torch.models.params import init_params


def build_model(cfg: ModelConfig) -> "Model":
    return Model(cfg)


class Model:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self._spec = tfm.lm_param_spec(cfg)

    def param_spec(self):
        return self._spec

    def init(self, seed: int, device):
        """Materialize the parameter dict on ``device`` from ``seed``."""
        return init_params(self._spec, seed, self.cfg.param_dtype, device)

    def loss(self, params, batch):
        return tfm.lm_loss(self.cfg, params, batch)
