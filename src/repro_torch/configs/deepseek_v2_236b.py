"""DeepSeek-V2-236B — MLA (kv_lora=512) + MoE: 2 shared + 160 routed, top-6
[arXiv:2405.04434].

The assigned ``d_ff=1536`` is the per-routed-expert intermediate size; the
first layer is a dense FFN (intermediate 12288) per the DeepSeek-V2 design.
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv=128,                # MLA: logical kv == heads; real cache is kv_lora
    d_ff=12288,              # dense FFN (first layer)
    moe_d_ff=1536,           # per-expert intermediate
    vocab=102400,
    n_experts=160,
    n_shared_experts=2,
    top_k=6,
    first_dense_layers=1,
    block_pattern=("L",),    # MLA attention
    kv_lora=512,
    q_lora=1536,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    rope_theta=1e4,
    source="arXiv:2405.04434",
)

REDUCED = CONFIG.replace(
    name="deepseek-v2-236b-reduced",
    n_layers=2,
    d_model=256,
    n_heads=4,
    n_kv=4,
    d_ff=512,
    moe_d_ff=128,
    vocab=512,
    n_experts=4,
    n_shared_experts=1,
    top_k=2,
    first_dense_layers=1,
    kv_lora=64,
    q_lora=128,
    qk_nope_dim=32,
    qk_rope_dim=16,
    v_head_dim=32,
)
