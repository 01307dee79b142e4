"""seamless-m4t-large-v2 [audio] — enc-dec multimodal [arXiv:2308.11596].

Assignment specifies the transformer backbone: 24L d_model=1024 16H
(kv=16) d_ff=8192 vocab=256206.  The mel-spectrogram + conv feature
extractor frontend is a stub — ``input_specs()`` supplies precomputed
frame embeddings for the encoder (the assignment carve-out).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    source="[arXiv:2308.11596]",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=8192,
    vocab_size=256206,
    head_dim=64,
    encoder_layers=24,
    encoder_seq=1536,  # precomputed audio frame embeddings per utterance
)
