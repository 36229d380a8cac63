"""Registry of model configurations ported so far.

Only the paper's own model, ``papernet``, is here: the transformer
families of the JAX package's ``configs`` wait for the port of their
models (ROADMAP.md, queue 1 item 12). Each submodule exposes ``CONFIG``
(the full-size config) and ``REDUCED`` (a smoke variant).
"""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.config import ModelConfig

ARCH_IDS: List[str] = [
    "papernet",
]


def _norm(name: str) -> str:
    return name.replace("-", "_")


def _module(name: str):
    arch = _norm(name)
    if arch not in ARCH_IDS:
        raise KeyError(
            f"{name!r} is not ported to repro_torch yet (ported: "
            f"{', '.join(ARCH_IDS)}); see ROADMAP.md, queue 1 item 12")
    return importlib.import_module(f"repro_torch.configs.{arch}")


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_reduced(name: str) -> ModelConfig:
    return _module(name).REDUCED
