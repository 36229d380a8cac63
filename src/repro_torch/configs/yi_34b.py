"""Yi-34B — llama-architecture dense decoder with GQA [arXiv:2403.04652]."""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="yi-34b",
    family="dense",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv=8,
    head_dim=128,
    d_ff=20480,
    vocab=64000,
    block_pattern=("A",),
    rope_theta=5e6,
    source="arXiv:2403.04652",
)

REDUCED = CONFIG.replace(
    name="yi-34b-reduced",
    n_layers=2,
    d_model=256,
    n_heads=8,
    n_kv=4,
    head_dim=32,
    d_ff=512,
    vocab=512,
)
