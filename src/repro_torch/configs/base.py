"""Configuration dataclasses for the repro framework.

Every assigned architecture is expressed as a ``ModelConfig``. The config is
deliberately explicit (no HF-style kwargs soup): each field is consumed by
exactly one place in ``repro_torch.models``.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts settings (GShard/DeepSeek-style routed experts)."""

    num_experts: int
    top_k: int
    expert_d_ff: int
    num_shared_experts: int = 0
    # Layers [0, first_k_dense) use a dense FFN instead of MoE (DeepSeek V3
    # uses 3, Kimi K2 uses 1).  These dense FFNs are what §3.4's
    # "compromised FFN TP group" handling applies to.
    first_k_dense: int = 0
    dense_d_ff: int = 0           # d_ff of those first dense layers
    moe_layer_period: int = 1     # MoE every Nth layer (Jamba: 2)
    capacity_factor: float = 1.25
    # smallest per-expert dispatch capacity; 1 = exact-fit (decode perf)
    min_capacity: int = 8
    # Redundant experts (paper §3.4): number of extra physical replicas
    # provisioned for the hottest experts, used for load balance *and*
    # fault tolerance.
    num_redundant_experts: int = 0
    router_noise: float = 0.0
    aux_loss_coef: float = 0.01


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head latent attention (DeepSeek/MiniCPM3 style)."""

    q_lora_rank: int
    kv_lora_rank: int
    qk_nope_head_dim: int
    qk_rope_head_dim: int
    v_head_dim: int


@dataclass(frozen=True)
class MambaConfig:
    """Mamba-1 selective SSM settings."""

    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0  # 0 -> ceil(d_model / 16)

    def resolved_dt_rank(self, d_model: int) -> int:
        return self.dt_rank if self.dt_rank > 0 else max(1, d_model // 16)


@dataclass(frozen=True)
class ModelConfig:
    # identity
    name: str
    family: str          # dense | moe | hybrid | ssm | audio | vlm
    source: str          # citation from the assignment table

    # trunk dims
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0            # 0 -> d_model // num_heads

    # mixer selection
    attention_type: str = "gqa"  # gqa | mla | none
    activation: str = "swiglu"   # swiglu | relu2
    mla: Optional[MLAConfig] = None
    moe: Optional[MoEConfig] = None
    mamba: Optional[MambaConfig] = None
    # hybrid (Jamba): layers come in periods of ``hybrid_period``; the
    # sublayer at index ``hybrid_attn_index`` is attention, the rest Mamba.
    hybrid_period: int = 0
    hybrid_attn_index: int = 0

    # encoder-decoder (audio): number of encoder layers; 0 = decoder-only.
    encoder_layers: int = 0
    encoder_seq: int = 0         # stub frame count fed by input_specs()
    # vlm: number of stub patch embeddings prefixed to the token sequence.
    num_patches: int = 0

    # attention extras
    rope_theta: float = 10000.0
    sliding_window: int = 0      # 0 = full causal attention
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # runtime knobs (overridden per input-shape / perf experiment)
    # MoE execution: 'gather_psum' | 'a2a' pick the distributed
    # dispatch/combine; a '_fused' suffix (or plain 'fused' for
    # single-rank) additionally routes the local expert compute through
    # the fused CUDA dispatch->FFN->combine kernel instead of the
    # dense-scatter capacity buffer.
    moe_impl: str = "gather_psum"
    # Paged decode/chunk step execution: 'composed' runs the
    # attention -> router -> MoE op chain (each op's plain PyTorch
    # version on CPU, its CUDA kernel on the card); 'megakernel' fuses one attention+MoE
    # block's paged attention, output projection, residuals, norm,
    # router top-k, replica selection and expert FFN+combine into a
    # single decode-shaped kernel launch (``ops.decode_megastep``).
    # Blocks the megakernel cannot express (dense FFN, recurrent
    # mixers, distributed MoE) fall back to the composed chain.
    decode_impl: str = "composed"
    remat: bool = False
    scan_layers: bool = True
    # decode-cache update strategy: False = cache flows as scan xs/ys
    # (copies the whole cache each step); True = cache is a scan carry
    # updated with in-place dynamic_update_slice (aliasable — §Perf A4)
    decode_cache_carry: bool = False

    MOE_IMPLS = ("gather_psum", "a2a", "fused", "gather_psum_fused",
                 "a2a_fused")
    DECODE_IMPLS = ("composed", "megakernel")

    @property
    def moe_fused(self) -> bool:
        """True when local expert compute uses the fused MoE kernel."""
        return self.moe_impl == "fused" or self.moe_impl.endswith("_fused")

    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        assert self.num_heads > 0
        return self.d_model // self.num_heads

    @property
    def is_attention_free(self) -> bool:
        return self.attention_type == "none" and self.hybrid_period == 0

    @property
    def supports_long_context_natively(self) -> bool:
        """True when decode cost is sub-quadratic without modification."""
        return self.family in ("ssm",) or self.hybrid_period > 0

    def with_sliding_window(self, window: int) -> "ModelConfig":
        return replace(self, sliding_window=window)

    def validate(self) -> None:
        assert self.family in ("dense", "moe", "hybrid", "ssm", "audio", "vlm")
        assert self.moe_impl in self.MOE_IMPLS, self.moe_impl
        assert self.decode_impl in self.DECODE_IMPLS, self.decode_impl
        assert self.attention_type in ("gqa", "mla", "none")
        if self.attention_type == "mla":
            assert self.mla is not None
        if self.attention_type == "gqa" and self.num_heads:
            assert self.num_heads % max(1, self.num_kv_heads) == 0
        if self.family in ("moe",):
            assert self.moe is not None
        if self.family == "ssm":
            assert self.mamba is not None and self.attention_type == "none"
        if self.hybrid_period:
            assert self.mamba is not None
            assert self.num_layers % self.hybrid_period == 0
        if self.family == "audio":
            assert self.encoder_layers > 0 and self.encoder_seq > 0
        if self.family == "vlm":
            assert self.num_patches > 0


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}

# Window applied to full-attention architectures for the long_500k shape
# (see DESIGN.md §5): keeps decode sub-quadratic and the ring cache small.
LONG_CONTEXT_WINDOW = 8192


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Reduced variant of the same family for CPU smoke tests.

    2 layers (one hybrid period for hybrids), d_model<=256, <=4 experts.
    """
    d_model = 256
    num_heads = 4
    num_kv = min(cfg.num_kv_heads, 2) if cfg.num_kv_heads else 0
    kw = dict(
        name=cfg.name + "-smoke",
        num_layers=2,
        d_model=d_model,
        num_heads=num_heads if cfg.num_heads else 0,
        num_kv_heads=num_kv,
        d_ff=512,
        vocab_size=512,
        head_dim=64 if cfg.num_heads else 0,
        encoder_layers=2 if cfg.encoder_layers else 0,
        encoder_seq=16 if cfg.encoder_seq else 0,
        num_patches=8 if cfg.num_patches else 0,
        scan_layers=False,
    )
    if cfg.moe is not None:
        kw["moe"] = replace(
            cfg.moe,
            num_experts=4,
            top_k=min(cfg.moe.top_k, 2),
            expert_d_ff=128,
            num_shared_experts=min(cfg.moe.num_shared_experts, 1),
            first_k_dense=min(cfg.moe.first_k_dense, 1),
            dense_d_ff=256 if cfg.moe.first_k_dense else 0,
            num_redundant_experts=min(cfg.moe.num_redundant_experts, 2),
        )
    if cfg.mla is not None:
        kw["mla"] = MLAConfig(
            q_lora_rank=64, kv_lora_rank=32,
            qk_nope_head_dim=32, qk_rope_head_dim=16, v_head_dim=32,
        )
    if cfg.mamba is not None:
        kw["mamba"] = replace(cfg.mamba, dt_rank=16)
    if cfg.hybrid_period:
        kw["num_layers"] = cfg.hybrid_period  # a single period
        kw["hybrid_period"] = cfg.hybrid_period
        kw["hybrid_attn_index"] = cfg.hybrid_attn_index
    out = replace(cfg, **kw)
    out.validate()
    return out
