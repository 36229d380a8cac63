"""Qwen3-14B — dense with per-head QK-RMSNorm and GQA [hf:Qwen/Qwen3-8B]."""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv=8,
    head_dim=128,
    d_ff=17408,
    vocab=151936,
    block_pattern=("A",),
    rope_theta=1e6,
    qk_norm=True,
    source="hf:Qwen/Qwen3-8B",
)

REDUCED = CONFIG.replace(
    name="qwen3-14b-reduced",
    n_layers=2,
    d_model=256,
    n_heads=8,
    n_kv=4,
    head_dim=32,
    d_ff=512,
    vocab=512,
)
