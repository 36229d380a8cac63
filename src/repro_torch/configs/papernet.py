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
    vocab=10,                # classes
    source="paper §V (ResNet/CIFAR-10 testbed workload)",
)

REDUCED = CONFIG.replace(name="papernet-reduced", n_layers=2, d_model=8)
