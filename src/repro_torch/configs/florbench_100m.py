"""florbench-100m: the paper-scale end-to-end example model (not assigned).

A ~124M-param GPT-2-small-class dense LM used by examples/ and benchmarks/ as
the "model training workload" that Flor records and replays, standing in for
the paper's ResNet/RoBERTa workloads at CPU-runnable scale.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="florbench-100m",
    family="dense",
    num_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    d_ff=3072,
    vocab_size=32768,
    head_dim=64,
    ffn_activation="gelu",
    tie_embeddings=True,
)

# CPU-runnable reduction used by examples and benchmarks (a few M params).
SMOKE = CONFIG.replace(
    name="florbench-100m-smoke",
    num_layers=4,
    d_model=128,
    num_heads=4,
    num_kv_heads=4,
    d_ff=512,
    vocab_size=1024,
    head_dim=32,
)
