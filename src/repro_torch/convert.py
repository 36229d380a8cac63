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

from repro_torch.checkpoint.io import to_numpy
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.tree import tree_map


def _tensor(x, dev) -> torch.Tensor:
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        # numpy's bfloat16 (JAX's) is unknown to torch: carry its bits
        return torch.tensor(x.view(np.int16), device=dev).view(
            torch.bfloat16)
    return torch.tensor(x, device=dev)


def params_from_numpy(tree: Any, device: DeviceLike = None) -> Any:
    """Nested dict/list of numpy arrays -> the same tree of tensors on
    ``device`` (copies; ``None`` means ``cuda``), each of its array's
    dtype: a bfloat16 model's float32 leaves (norm scales, the MoE
    router) stay float32."""
    dev = resolve_device(device)
    return tree_map(lambda x: _tensor(x, dev), tree)


def params_to_numpy(tree: Any) -> Any:
    """Tree of tensors -> the same tree of numpy arrays (on the host);
    bfloat16 leaves come out as float32 (``checkpoint.io.to_numpy``)."""
    return tree_map(to_numpy, tree)
