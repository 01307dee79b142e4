"""falcon-mamba-7b [ssm] — attention-free Mamba-1 [arXiv:2410.05355]."""
from repro_torch.configs.base import MambaConfig, ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    source="[arXiv:2410.05355]",
    num_layers=64,
    d_model=4096,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=65024,
    attention_type="none",
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
)
