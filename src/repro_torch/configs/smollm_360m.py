"""SmolLM-360M — small llama-architecture dense model [hf:HuggingFaceTB/SmolLM-135M]."""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m",
    family="dense",
    n_layers=32,
    d_model=960,
    n_heads=15,
    n_kv=5,
    head_dim=64,
    d_ff=2560,
    vocab=49152,
    block_pattern=("A",),
    rope_theta=1e4,
    tie_embeddings=True,
    source="hf:HuggingFaceTB/SmolLM-135M",
)

REDUCED = CONFIG.replace(
    name="smollm-360m-reduced",
    n_layers=2,
    d_model=192,
    n_heads=6,
    n_kv=2,
    head_dim=32,
    d_ff=512,
    vocab=512,
)
