"""SeamlessM4T large v2 [arXiv:2308.11596] — encoder-decoder backbone.

Per the assignment, the modality frontend is a STUB: input_specs() provides
precomputed audio-frame embeddings as the encoder input; we model the
24L encoder + 24L decoder transformer backbone.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    num_layers=24,              # encoder layers
    num_decoder_layers=24,
    cross_attention=True,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=8192,
    vocab_size=256206,
    head_dim=64,
    ffn_activation="gelu",
    frontend="audio",
    frontend_tokens=0,          # encoder input IS the frame embeddings
)

SMOKE = CONFIG.replace(
    name="seamless-m4t-large-v2-smoke",
    num_layers=2,
    num_decoder_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=128,
    vocab_size=256,
    head_dim=16,
)
