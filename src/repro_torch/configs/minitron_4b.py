"""NVIDIA Minitron 4B (pruned Nemotron) [arXiv:2407.14679]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minitron-4b",
    family="dense",
    num_layers=32,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    d_ff=9216,
    vocab_size=256000,
    head_dim=128,
    ffn_activation="relu2",     # nemotron family uses squared ReLU
    rope_theta=10000.0,
    # 24 heads / 8 kv do not divide the 16-way model axis (same situation as
    # qwen3): sequence-parallel residuals avoid replicated attention
    seq_shard=True,
    serve_replicate_fsdp=False,
)

SMOKE = CONFIG.replace(
    name="minitron-4b-smoke",
    num_layers=2,
    d_model=48,
    num_heads=3,
    num_kv_heads=1,
    d_ff=96,
    vocab_size=256,
    head_dim=16,
)
