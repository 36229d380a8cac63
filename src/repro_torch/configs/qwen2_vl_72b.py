"""Qwen2-VL-72B — VLM backbone with M-RoPE and dynamic resolution [arXiv:2409.12191].

The ViT vision encoder + projector are STUBBED per the assignment:
``input_specs`` provides precomputed patch embeddings of shape
(batch, vision_patches, d_model); this config describes the language decoder.
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv=8,
    head_dim=128,
    d_ff=29568,
    vocab=152064,
    block_pattern=("A",),
    rope_theta=1e6,
    pos_type="mrope",
    mrope_sections=(16, 24, 24),   # temporal/height/width split of hd/2
    vision_patches=1024,           # stub ViT output length (dynamic-res capable)
    source="arXiv:2409.12191",
)

REDUCED = CONFIG.replace(
    name="qwen2-vl-72b-reduced",
    n_layers=2,
    d_model=256,
    n_heads=8,
    n_kv=4,
    head_dim=32,
    d_ff=512,
    vocab=512,
    mrope_sections=(4, 6, 6),
    vision_patches=16,
)
