"""papernet — the paper's own workload family, adapted.

The paper trains ResNet-18/50/152 and VGG16 on CIFAR-10 over 8 workers + 1 PS.
``papernet`` is a ResNet-style mini CNN (3 stages x 2 basic blocks) on 32x32x3
inputs with 10 classes, used by the accuracy / TTA / Random-k-vs-Top-k
experiments (paper Figs 5, 12, 13). ``d_model`` is the stem width; stage
widths are (w, 2w, 4w).
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="papernet",
    family="cnn",
    n_layers=6,              # 3 stages x 2 basic blocks
    d_model=32,              # stem width
    n_heads=0,
    n_kv=0,
    d_ff=0,
    vocab=10,                # classes
    pos_type="none",
    norm_type="ln",          # per-channel scale/offset (GroupNorm-ish, BN-free)
    dtype="float32",
    source="paper §V (ResNet/CIFAR-10 testbed workload)",
)

REDUCED = CONFIG.replace(name="papernet-reduced", n_layers=2, d_model=8)
