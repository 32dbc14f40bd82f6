"""Mixtral 8x7B [arXiv:2401.04088] — 8 experts top-2, sliding-window attention."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    head_dim=128,
    ffn_activation="swiglu",
    sliding_window=4096,
    rope_theta=1000000.0,
    moe=MoEConfig(
        num_experts=8,
        top_k=2,
        d_ff_expert=14336,
        router="softmax",
        router_aux_loss=0.01,
    ),
)

SMOKE = CONFIG.replace(
    name="mixtral-8x7b-smoke",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    head_dim=16,
    sliding_window=32,
    moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=128,
                  router="softmax", router_aux_loss=0.01),
)
