"""nemotron-4-340b [dense] — GQA, squared-ReLU [arXiv:2402.16819]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b",
    family="dense",
    source="[arXiv:2402.16819]",
    num_layers=96,
    d_model=18432,
    num_heads=96,
    num_kv_heads=8,
    d_ff=73728,
    vocab_size=256000,
    head_dim=192,
    activation="relu2",
)
