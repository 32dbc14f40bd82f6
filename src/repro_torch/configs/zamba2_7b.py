"""Zamba2 7B [arXiv:2411.15242] — Mamba2 backbone + SHARED attention block.

81 blocks total; every 6th block is the (single, weight-shared) attention+MLP
block: 13 groups of [5 mamba2 + shared-attn] + 3 trailing mamba2 blocks
=> 68 mamba2 + 13 applications of one shared transformer block.

At 500k decode the shared attention uses a 4096-token sliding window (Zamba2's
long-context recipe); the Mamba2 state is O(1), making the arch long_500k-OK.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    d_ff=14336,
    vocab_size=32000,
    head_dim=112,               # d_model / num_heads
    ffn_activation="geglu",
    attn_period=6,
    sliding_window=4096,        # applied to the shared attn at long context
    ssm=SSMConfig(
        version=2,
        state_dim=64,
        conv_dim=4,
        expand=2,
        head_dim=64,
        chunk=256,
    ),
    serve_replicate_fsdp=False,
)

SMOKE = CONFIG.replace(
    name="zamba2-7b-smoke",
    num_layers=13,              # 2 groups of [5 mamba + attn] + 1 trailing mamba
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=128,
    vocab_size=256,
    head_dim=16,
    attn_period=6,
    sliding_window=32,
    ssm=SSMConfig(version=2, state_dim=16, conv_dim=4, expand=2, head_dim=16, chunk=16),
)
