"""The benchmark's weights, made on the device from the seed.

Each leaf has a generator of its own, seeded from the run's seed and the
leaf's place in the stream, so any leaf can be made again alone (the
parameters' change after the checked steps is taken against it) and the
reference gets the very values the program started from without a copy
kept beside the run. Dense weights are N(0, 0.02) drawn in the leaf's
dtype; RMSNorm scales (added to one) start at zero, LayerNorm scales at
one and offsets at zero.
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional

import torch

_MIX = 0x9E3779B97F4A7C15


def leaf_seed(seed: int, index: int) -> int:
    return (int(seed) * 1_000_003 + index * _MIX + 1) % (1 << 63)


def make(shapes: Dict[str, tuple], seed: int, device,
         names: Optional[Iterable[str]] = None) -> Dict[str, torch.Tensor]:
    """``shapes``: leaf name -> (shape, dtype name, init), in stream
    order. Returns leaf name -> tensor on ``device`` (only ``names``,
    where given)."""
    want = None if names is None else set(names)
    out = {}
    for i, (name, (shape, dtype, init)) in enumerate(shapes.items()):
        if want is not None and name not in want:
            continue
        dt = getattr(torch, dtype)
        if init == "zeros":
            out[name] = torch.zeros(shape, dtype=dt, device=device)
        elif init == "ones":
            out[name] = torch.ones(shape, dtype=dt, device=device)
        else:
            gen = torch.Generator(device=device)
            gen.manual_seed(leaf_seed(seed, i))
            out[name] = torch.randn(shape, dtype=dt, device=device,
                                    generator=gen).mul_(0.02)
    return out
