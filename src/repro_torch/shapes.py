"""The four assigned input shapes (a copy of the JAX package's ``shapes.py``).

``kind`` selects which step gets lowered in the dry-run:
  train   -> train_step(tokens, labels)
  prefill -> prefill_step (full-sequence forward, build cache)
  decode  -> serve_step (ONE new token against a seq_len KV cache / SSM state)
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


def get_shape(name: str) -> InputShape:
    if name not in SHAPES:
        raise KeyError(f"unknown input shape {name!r}; options: {sorted(SHAPES)}")
    return SHAPES[name]
