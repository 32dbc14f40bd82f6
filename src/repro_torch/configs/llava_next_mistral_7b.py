"""LLaVA-NeXT (Mistral-7B backbone) [hf:llava-hf/llava-v1.6-mistral-7b-hf].

VLM: the assignment specifies the transformer BACKBONE only; the anyres vision
tower is a STUB — input_specs() provides precomputed patch embeddings
(``frontend_tokens`` prefix positions) alongside text tokens.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    head_dim=128,
    ffn_activation="swiglu",
    rope_theta=1000000.0,
    frontend="vision",
    frontend_tokens=576,        # one 24x24 anyres base tile of patch embeddings
    serve_replicate_fsdp=False,
)

SMOKE = CONFIG.replace(
    name="llava-next-mistral-7b-smoke",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    head_dim=16,
    frontend_tokens=8,
)
