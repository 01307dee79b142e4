"""deepseek-v3 [moe] — the paper's own evaluation model [arXiv:2412.19437].

Not part of the assigned 10; included because every ReviveMoE experiment
(Fig. 1, Fig. 5, Table 2) is run on DeepSeek V3, so the benchmark
analogues use (a reduced variant of) this config.
"""
from repro_torch.configs.base import MLAConfig, MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3",
    family="moe",
    source="[arXiv:2412.19437]",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,
    d_ff=18432,
    vocab_size=129280,
    head_dim=128,
    attention_type="mla",
    mla=MLAConfig(
        q_lora_rank=1536,
        kv_lora_rank=512,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
    ),
    moe=MoEConfig(
        num_experts=256,
        top_k=8,
        expert_d_ff=2048,
        num_shared_experts=1,
        first_k_dense=3,
        dense_d_ff=18432,
        num_redundant_experts=32,
    ),
)
