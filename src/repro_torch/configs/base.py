"""Configuration system: model configs, input-shape specs, registry.

Every assigned architecture gets a module in this package exporting CONFIG.
`repro_torch.configs.get(name)` returns the full config; `get_smoke(name)` returns a
reduced same-family config for CPU smoke tests.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared_experts: int = 0
    first_dense_layers: int = 0          # leading layers that stay dense
    router: str = "softmax"              # softmax | sigmoid (deepseek-v3)
    capacity_factor: float = 1.25
    router_aux_loss: float = 0.0         # load-balance loss coefficient


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek Multi-head Latent Attention."""
    q_lora_rank: int
    kv_lora_rank: int
    qk_nope_head_dim: int
    qk_rope_head_dim: int
    v_head_dim: int


@dataclass(frozen=True)
class SSMConfig:
    version: int                          # 1 = Mamba1 selective scan, 2 = Mamba2/SSD
    state_dim: int                        # N
    conv_dim: int = 4
    expand: int = 2
    head_dim: int = 64                    # Mamba2 only
    dt_rank: Optional[int] = None         # Mamba1 only (default ceil(d_model/16))
    chunk: int = 256                      # SSD / chunked-scan chunk length


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                           # dense | moe | ssm | hybrid | encdec | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None        # default d_model // num_heads
    ffn_activation: str = "swiglu"        # swiglu | geglu | gelu | relu2
    qk_norm: bool = False
    sliding_window: Optional[int] = None  # SWA window (Mixtral / long-ctx Zamba)
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    embed_scale: bool = False             # Gemma-style sqrt(d) embedding scale
    logit_softcap: Optional[float] = None

    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None

    # hybrid (Zamba2): every `attn_period`-th block is a *shared-weight*
    # attention+MLP block; the rest are Mamba2 blocks.
    attn_period: Optional[int] = None

    # encoder-decoder (Seamless)
    num_decoder_layers: int = 0
    cross_attention: bool = False

    # modality frontend STUB: "vision" | "audio" | None.  input_specs() emits
    # precomputed patch/frame embeddings for these.
    frontend: Optional[str] = None
    frontend_tokens: int = 0              # patches/frames occupying the prefix

    mtp_depth: int = 0                    # DeepSeek multi-token prediction depth
    dtype: str = "bfloat16"               # compute dtype

    # runtime knobs (not architecture identity)
    scan_layers: bool = True              # scan vs unroll the layer stack
    remat: bool = True                    # per-layer activation checkpointing
    remat_policy: str = "nothing"         # nothing | dots | full  (what to SAVE)
    attention_impl: str = "auto"          # auto | naive | chunked | pallas
    attention_chunk: int = 1024
    attention_probs_dtype: str = "float32"   # float32 | bfloat16 (perf knob:
    #   exp/p tensors and the pv matmul run in bf16; m/l stay fp32)
    attention_remat_chunk: bool = True    # remat the KV-chunk body: backward
    #   recomputes scores/probs instead of saving [nc, ..., Sq, chunk] stacks
    #   (the jnp-level analogue of flash attention's recompute-in-bwd).
    #   Confirmed win on all three hillclimb cells (EXPERIMENTS.md Perf);
    #   set False for the paper-faithful baseline measurements.
    seq_shard: bool = False               # shard the residual stream's SEQ dim
    #   over "model" (sequence parallelism). The win when num_heads doesn't
    #   divide the model axis (qwen3: 40 heads on 16) and attention would
    #   otherwise replicate; k/v are all-gathered per layer (cheap).
    serve_replicate_fsdp: bool = True     # serving layout: replicate params
    #   over the FSDP axes (weights resident per model shard, no per-token
    #   all-gathers). Decode is latency-bound and weights-stationary wins
    #   whenever params/model_axis fits HBM; False for 671B-class models.
    dense_layout: str = "tp"              # tp | dp. "dp" runs dense blocks
    #   pure-data-parallel with batch sharded over ("pod","data","model") and
    #   dense weights FSDP-only (no per-layer TP activation psums); MoE then
    #   all-gathers tokens over "model" and reduce-scatters the combine.
    #   The hillclimbed layout for deepseek-v3 train (EXPERIMENTS.md Perf).
    param_dtype: str = "float32"          # parameter storage dtype
    moment_dtype: str = "float32"         # optimizer moment dtype
    loss_chunk: int = 0                   # 0 = unchunked; else seq-chunked loss

    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.num_heads

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def _attn_params(self) -> int:
        """Parameter count of one attention block (projections only)."""
        d, hd = self.d_model, self.resolved_head_dim()
        if self.mla is not None:
            m = self.mla
            qk_hd = m.qk_nope_head_dim + m.qk_rope_head_dim
            return (d * m.q_lora_rank + m.q_lora_rank * self.num_heads * qk_hd
                    + d * (m.kv_lora_rank + m.qk_rope_head_dim)
                    + m.kv_lora_rank * self.num_heads * (m.qk_nope_head_dim + m.v_head_dim)
                    + self.num_heads * m.v_head_dim * d
                    + m.q_lora_rank + m.kv_lora_rank)      # latent norms
        return d * (self.num_heads + 2 * self.num_kv_heads) * hd + self.num_heads * hd * d

    def _mlp_params(self, d_ff: int) -> int:
        gated = self.ffn_activation in ("swiglu", "geglu")
        return self.d_model * d_ff * (3 if gated else 2)

    def _mamba_params(self) -> int:
        """One Mamba block (v1 selective-scan or v2/SSD layout)."""
        d, s = self.d_model, self.ssm
        din = s.expand * d
        if s.version == 1:
            dtr = s.dt_rank or -(-d // 16)
            return (d * 2 * din               # in_proj (x and z)
                    + s.conv_dim * din        # depthwise conv
                    + din * (dtr + 2 * s.state_dim)  # x -> dt,B,C
                    + dtr * din               # dt_proj
                    + din * s.state_dim       # A
                    + din                     # D
                    + din * d                 # out_proj
                    + d)                      # norm
        nheads = din // s.head_dim
        return (d * (2 * din + 2 * s.state_dim + nheads)   # in_proj z,x,B,C,dt
                + s.conv_dim * (din + 2 * s.state_dim)     # conv over x,B,C
                + nheads * 2                               # A, D (scalar/head)
                + din                                      # gated rmsnorm
                + din * d                                  # out_proj
                + d)                                       # pre-norm

    def param_count(self) -> int:
        """Analytic parameter count (embeddings counted once if tied)."""
        d, L = self.d_model, self.num_layers
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        attn = self._attn_params()
        if self.family == "ssm":
            return emb + L * self._mamba_params() + d       # + final norm
        if self.family == "hybrid":
            n_attn = L // self.attn_period
            n_mamba = L - n_attn
            shared_attn = attn + self._mlp_params(self.d_ff) + 2 * d  # shared ONCE
            return emb + n_mamba * self._mamba_params() + shared_attn + d
        if self.moe is not None:
            mo = self.moe
            dense_l = mo.first_dense_layers
            moe_l = L - dense_l
            router = d * mo.num_experts
            per_moe = (attn + router
                       + (mo.num_experts + mo.num_shared_experts)
                       * self._mlp_params(mo.d_ff_expert))
            layers = dense_l * (attn + self._mlp_params(self.d_ff)) + moe_l * per_moe
        else:
            layers = L * (attn + self._mlp_params(self.d_ff))
        dec = 0
        if self.num_decoder_layers:
            # decoder layer = self-attn + cross-attn + mlp (+3 norms)
            dec = self.num_decoder_layers * (2 * attn + self._mlp_params(self.d_ff) + 3 * d)
        norms = L * 2 * d + d
        return emb + layers + dec + norms

    def active_param_count(self) -> int:
        """Activated params per token (MoE counts top_k + shared experts only)."""
        if self.moe is None:
            return self.param_count()
        mo = self.moe
        full = self.param_count()
        gated = 3 if self.ffn_activation in ("swiglu", "geglu") else 2
        per_expert = self.d_model * mo.d_ff_expert * gated
        moe_l = self.num_layers - mo.first_dense_layers
        inactive = moe_l * (mo.num_experts - mo.top_k) * per_expert
        return full - inactive


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeSpec] = {
    "train_4k":    ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k":  ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k":   ShapeSpec("long_500k", "decode", 524288, 1),
}

# Archs allowed to run long_500k (sub-quadratic attention); everything else is
# a documented skip (DESIGN.md §5).
LONG_CONTEXT_OK = {"falcon-mamba-7b", "zamba2-7b", "mixtral-8x7b"}


def cell_applicable(arch: str, shape: str) -> Tuple[bool, str]:
    if shape == "long_500k" and arch not in LONG_CONTEXT_OK:
        return False, "full-attention arch: 500k decode skipped per assignment (DESIGN.md §5)"
    return True, ""
