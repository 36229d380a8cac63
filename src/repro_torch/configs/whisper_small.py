"""Whisper-small — encoder-decoder audio transformer [arXiv:2212.04356].

The mel-spectrogram + conv feature extractor frontend is STUBBED per the
assignment: ``input_specs`` provides precomputed frame embeddings of shape
(batch, encoder_frames, d_model). This config describes the transformer
backbone (encoder stack + decoder stack with cross-attention).
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="audio",
    n_layers=12,             # decoder layers
    encoder_layers=12,
    d_model=768,
    n_heads=12,
    n_kv=12,                 # MHA (kv == heads)
    head_dim=64,
    d_ff=3072,
    vocab=51865,             # padded to 51968 (vocab_padded) for TP
    encoder_frames=1500,
    block_pattern=("A",),
    norm_type="ln",
    mlp_type="gelu",
    pos_type="learned",
    source="arXiv:2212.04356",
)

REDUCED = CONFIG.replace(
    name="whisper-small-reduced",
    n_layers=2,
    encoder_layers=2,
    d_model=192,
    n_heads=6,
    n_kv=6,
    head_dim=32,
    d_ff=512,
    vocab=512,
    encoder_frames=64,
)
