"""Model substrate: functional PyTorch definitions over parameter trees.

Public API (see ``api.py``):
    build(cfg)         -> ModelApi with init / loss_fn / forward
"""
from repro_torch.models.api import ModelApi, build  # noqa: F401
