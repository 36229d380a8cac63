"""Zamba2-7B — hybrid: Mamba-2 backbone + shared-weight attention blocks
[arXiv:2411.15242].

81 Mamba-2 mixer layers; a single SHARED transformer (attention+MLP) block is
applied every ``shared_attn_every`` mixer layers (weight reuse is the Zamba
trick — one set of attention weights, many applications, each with its own KV
cache slot).
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv=32,                 # full MHA on the shared block
    head_dim=112,
    d_ff=14336,
    vocab=32000,
    block_pattern=("M2",),
    ssm_state=64,
    ssm_expand=2,
    ssm_conv=4,
    ssm_heads=112,           # d_inner=7168, mamba2 head size 64
    shared_attn_every=6,     # shared attn applied after every 6th mamba layer
    pos_type="rope",
    source="arXiv:2411.15242",
)

REDUCED = CONFIG.replace(
    name="zamba2-7b-reduced",
    n_layers=2,
    d_model=256,
    n_heads=4,
    n_kv=4,
    head_dim=64,
    d_ff=512,
    vocab=512,
    ssm_state=16,
    ssm_heads=8,             # d_inner=512, head size 64
    shared_attn_every=1,
)
