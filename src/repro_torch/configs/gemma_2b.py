"""Google Gemma 2B [arXiv:2403.08295] — GeGLU, head_dim=256, MQA (kv=1)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b",
    family="dense",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    d_ff=16384,
    vocab_size=256000,
    head_dim=256,
    ffn_activation="geglu",
    rope_theta=10000.0,
    tie_embeddings=True,
    embed_scale=True,           # embeddings scaled by sqrt(d_model)
)

SMOKE = CONFIG.replace(
    name="gemma-2b-smoke",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=1,
    d_ff=128,
    vocab_size=256,
    head_dim=32,
)
