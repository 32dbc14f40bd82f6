"""Falcon-Mamba 7B [arXiv:2410.05355] — pure Mamba1 (attention-free)."""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    num_layers=64,
    d_model=4096,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=65024,
    head_dim=1,
    ssm=SSMConfig(
        version=1,
        state_dim=16,
        conv_dim=4,
        expand=2,
        dt_rank=256,            # ceil(4096/16)
        chunk=256,
    ),
)

SMOKE = CONFIG.replace(
    name="falcon-mamba-7b-smoke",
    num_layers=2,
    d_model=64,
    vocab_size=256,
    ssm=SSMConfig(version=1, state_dim=8, conv_dim=4, expand=2, dt_rank=8, chunk=16),
)
