"""mistral-large-123b [dense] — hf:mistralai/Mistral-Large-Instruct-2407."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mistral-large-123b",
    family="dense",
    source="[hf:mistralai/Mistral-Large-Instruct-2407]",
    num_layers=88,
    d_model=12288,
    num_heads=96,
    num_kv_heads=8,
    d_ff=28672,
    vocab_size=32768,
    head_dim=128,
)
