"""Qwen3 14B [hf:Qwen/Qwen3-14B] — qk_norm, GQA kv=8."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-14b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=17408,
    vocab_size=151936,
    head_dim=128,
    ffn_activation="swiglu",
    qk_norm=True,
    rope_theta=1000000.0,
    # 40 heads / 8 kv do not divide the 16-way model axis -> attention would
    # replicate; sequence-parallel residuals are the hillclimbed layout
    # (EXPERIMENTS.md Perf: 146.5s -> 13.0s step-time bound)
    seq_shard=True,
    serve_replicate_fsdp=False,
)

SMOKE = CONFIG.replace(
    name="qwen3-14b-smoke",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    head_dim=16,
)
