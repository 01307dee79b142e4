"""internvl2-26b [vlm] — InternViT + InternLM2 [arXiv:2404.16821].

Backbone only (InternLM2-20B-style LM): 48L d_model=6144 48H (kv=8)
d_ff=16384 vocab=92553.  The InternViT vision encoder + projector is a
stub — ``input_specs()`` supplies precomputed patch embeddings that are
prefixed to the token sequence (the assignment carve-out).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    family="vlm",
    source="[arXiv:2404.16821]",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=16384,
    vocab_size=92553,
    head_dim=128,
    num_patches=256,  # one tile of InternViT patches after pixel-shuffle
)
