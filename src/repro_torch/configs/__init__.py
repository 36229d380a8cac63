"""Registry of model configurations ported so far.

The paper's own model, ``papernet``, and the decoder-only families:
dense (smollm, yi, qwen3, gemma3's 5 local : 1 global pattern), the VLM
backbone (qwen2-vl, M-RoPE and a patch-embedding stub), the MoE family
(mixtral's 8 experts under sliding-window attention, deepseek-v2's MLA
with 160 routed and 2 shared experts after a dense lead layer) and the
SSM family (falcon-mamba's Mamba-1 layers; zamba2's Mamba-2 layers with
one shared attention block) and the enc-dec family (whisper-small's
encoder over stubbed audio frames and its decoder with cross-attention).
Each submodule exposes ``CONFIG`` (the full-size config) and ``REDUCED``
(a smoke variant).
"""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.config import ModelConfig

ARCH_IDS: List[str] = [
    "yi_34b",
    "mixtral_8x22b",
    "smollm_360m",
    "qwen2_vl_72b",
    "gemma3_1b",
    "qwen3_14b",
    "deepseek_v2_236b",
    "falcon_mamba_7b",
    "zamba2_7b",
    "whisper_small",
    "papernet",
]

_ALIASES = {
    "yi-34b": "yi_34b",
    "mixtral-8x22b": "mixtral_8x22b",
    "smollm-360m": "smollm_360m",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "qwen2-vl-72b": "qwen2_vl_72b",
    "gemma3-1b": "gemma3_1b",
    "qwen3-14b": "qwen3_14b",
    "whisper-small": "whisper_small",
    "zamba2-7b": "zamba2_7b",
    "deepseek-v2-236b": "deepseek_v2_236b",
}


def _norm(name: str) -> str:
    return _ALIASES.get(name, name.replace("-", "_"))


def _module(name: str):
    arch = _norm(name)
    if arch not in ARCH_IDS:
        raise KeyError(f"{name!r}: no such architecture (known: "
                       f"{', '.join(ARCH_IDS)})")
    return importlib.import_module(f"repro_torch.configs.{arch}")


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_reduced(name: str) -> ModelConfig:
    return _module(name).REDUCED
