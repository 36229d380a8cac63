"""Carry parameter trees across between the JAX package and the port.

Both packages keep parameters as nested dicts/lists with the same keys,
shapes and layouts (conv weights HWIO), so a tree converts leaf by leaf.
The JAX side hands over numpy arrays, e.g.
``params_from_numpy(jax.tree.map(np.asarray, params), device)``; this
module itself imports nothing of JAX.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.tree import tree_map


def params_from_numpy(tree: Any, device: DeviceLike = None) -> Any:
    """Nested dict/list of numpy arrays -> the same tree of tensors on
    ``device`` (copies; ``None`` means ``cuda``)."""
    dev = resolve_device(device)
    return tree_map(lambda x: torch.tensor(np.asarray(x), device=dev), tree)


def params_to_numpy(tree: Any) -> Any:
    """Tree of tensors -> the same tree of numpy arrays (on the host)."""
    return tree_map(lambda x: x.detach().cpu().numpy(), tree)
