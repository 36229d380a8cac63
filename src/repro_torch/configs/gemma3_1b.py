"""Gemma3-1B — dense with 5:1 local:global attention, 512-token window
[hf:google/gemma-3-1b-pt]."""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-1b",
    family="dense",
    n_layers=26,
    d_model=1152,
    n_heads=4,
    n_kv=1,
    head_dim=256,            # gemma3 decouples head_dim from d_model/n_heads
    d_ff=6912,
    vocab=262144,
    block_pattern=("W", "W", "W", "W", "W", "A"),  # 5 local : 1 global
    window=512,
    rope_theta=1e6,
    qk_norm=True,
    tie_embeddings=True,
    source="hf:google/gemma-3-1b-pt",
)

REDUCED = CONFIG.replace(
    name="gemma3-1b-reduced",
    n_layers=2,              # one local + one global layer
    block_pattern=("W", "A"),
    d_model=256,
    n_heads=4,
    n_kv=1,
    head_dim=32,
    d_ff=512,
    vocab=512,
    window=64,
)
