"""DeepSeek-V3 671B [arXiv:2412.19437] — MLA, 1 shared + 256 routed top-8 MoE.

d_ff=18432 on the 3 leading dense layers; expert d_ff=2048 (assignment's d_ff
field refers to the expert width). MTP implemented as optional mtp_depth=1 but
disabled in the dry-run cells so all archs share the same objective.

param_dtype/moment_dtype bf16: at 671B the fp32 optimizer-state footprint would
exceed 512 x 16GB v5e HBM; bf16 moments are standard practice at this scale and
orthogonal to the paper's technique.
"""
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,
    d_ff=18432,                 # dense layers (first 3)
    vocab_size=129280,
    ffn_activation="swiglu",
    rope_theta=10000.0,
    moe=MoEConfig(
        num_experts=256,
        top_k=8,
        d_ff_expert=2048,
        num_shared_experts=1,
        first_dense_layers=3,
        router="sigmoid",
        router_aux_loss=0.001,
    ),
    mla=MLAConfig(
        q_lora_rank=1536,
        kv_lora_rank=512,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
    ),
    mtp_depth=0,
    param_dtype="bfloat16",
    moment_dtype="bfloat16",
    # 671B bf16 / 16 model shards = 84 GB: cannot replicate over the data
    # axis at serve time; keep FSDP-sharded serve params
    serve_replicate_fsdp=False,
)

SMOKE = CONFIG.replace(
    name="deepseek-v3-671b-smoke",
    num_layers=3,               # 1 dense + 2 moe
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=128,
    vocab_size=256,
    moe=MoEConfig(
        num_experts=4,
        top_k=2,
        d_ff_expert=32,
        num_shared_experts=1,
        first_dense_layers=1,
        router="sigmoid",
        router_aux_loss=0.001,
    ),
    mla=MLAConfig(
        q_lora_rank=32,
        kv_lora_rank=16,
        qk_nope_head_dim=16,
        qk_rope_head_dim=8,
        v_head_dim=16,
    ),
    param_dtype="float32",
    moment_dtype="float32",
)
