"""internlm2-20b [dense] — GQA [arXiv:2403.17297]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-20b",
    family="dense",
    source="[arXiv:2403.17297]",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=16384,
    vocab_size=92544,
    head_dim=128,
)
