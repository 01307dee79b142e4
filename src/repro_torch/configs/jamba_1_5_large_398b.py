"""jamba-1.5-large-398b [hybrid] — Mamba+attention 1:7, MoE [arXiv:2403.19887].

72 layers in periods of 8: one attention sublayer per period, 7 Mamba.
MoE (16 experts, top-2) on every other sublayer.
"""
from repro_torch.configs.base import MambaConfig, MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    source="[arXiv:2403.19887]",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    head_dim=128,
    moe=MoEConfig(
        num_experts=16,
        top_k=2,
        expert_d_ff=24576,
        moe_layer_period=2,
        # one replica per expert: 16+16=32 physical slots shard 16-way
        num_redundant_experts=16,
    ),
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
    hybrid_period=8,
    hybrid_attn_index=4,
)
