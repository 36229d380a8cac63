"""Mixtral-8x22B — sparse MoE (8 experts, top-2) with SWA [arXiv:2401.04088]."""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv=8,
    head_dim=128,
    d_ff=16384,
    vocab=32768,
    n_experts=8,
    top_k=2,
    block_pattern=("W",),   # sliding-window attention (Mistral lineage)
    window=4096,
    rope_theta=1e6,
    source="arXiv:2401.04088",
)

REDUCED = CONFIG.replace(
    name="mixtral-8x22b-reduced",
    n_layers=2,
    d_model=256,
    n_heads=8,
    n_kv=4,
    head_dim=32,
    d_ff=512,
    n_experts=4,
    top_k=2,
    window=64,
    vocab=512,
)
