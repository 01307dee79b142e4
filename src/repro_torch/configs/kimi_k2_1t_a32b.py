"""kimi-k2-1t-a32b [moe] — Kimi K2, trillion-param MoE [arXiv:2501.kimi2].

Paper-table assignment: 61L d_model=7168 64H (GQA kv=8) expert d_ff=2048,
vocab 163840, 384 experts top-8.  Kimi K2 is one of the models the paper
reports serving on xDeepServe, making this the closest production analogue
for ReviveMoE's expert-recovery paths.
"""
from repro_torch.configs.base import MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    source="[arXiv:2501.kimi2]",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    d_ff=2048,
    vocab_size=163840,
    head_dim=128,
    moe=MoEConfig(
        num_experts=384,
        top_k=8,
        expert_d_ff=2048,
        num_shared_experts=1,
        first_k_dense=1,
        dense_d_ff=18432,
        num_redundant_experts=32,
    ),
)
