"""qwen2-moe-a2.7b [moe] — 4 shared + 60 routed top-4 [hf:Qwen/Qwen1.5-MoE-A2.7B]."""
from repro_torch.configs.base import MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    source="[hf:Qwen/Qwen1.5-MoE-A2.7B]",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    vocab_size=151936,
    head_dim=128,
    moe=MoEConfig(
        num_experts=60,
        top_k=4,
        expert_d_ff=1408,
        num_shared_experts=4,
        num_redundant_experts=4,
    ),
)
