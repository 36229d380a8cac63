"""Falcon-Mamba-7B — attention-free Mamba-1 SSM [arXiv:2410.05355]."""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=0,
    n_kv=0,
    d_ff=0,
    vocab=65024,
    block_pattern=("M",),   # mamba1 mixer, no attention anywhere
    ssm_state=16,
    ssm_expand=2,
    ssm_conv=4,
    pos_type="none",
    source="arXiv:2410.05355",
)

REDUCED = CONFIG.replace(
    name="falcon-mamba-7b-reduced",
    n_layers=2,
    d_model=256,
    vocab=512,
    ssm_state=8,
)
