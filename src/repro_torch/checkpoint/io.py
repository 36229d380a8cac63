"""Checkpointing: tree <-> .npz with slash-joined key paths.

The same archive layout as the JAX package's ``checkpoint/io.py``: one
array per leaf, named by its dict keys and list positions joined with
``/`` (``params/fc/w``, ``opt_state/m/blocks/0/w``), plus ``__step__``.
Trees are walked in sorted-key order (``repro_torch.tree``), as
``jax.tree_util`` walks them, so archives cross between the two
packages in both directions. Host-gathered (fine at example scale).
"""
from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.tree import tree_leaves_with_path, tree_map_with_path


def _path_str(path) -> str:
    return "/".join(str(p) for p in path)


def to_numpy(v: Any) -> np.ndarray:
    """A leaf -> a numpy array on the host. numpy has no bfloat16: such
    a tensor comes out as float32, which holds it exactly."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        if v.dtype == torch.bfloat16:
            v = v.to(torch.float32)
        return v.numpy()
    return np.asarray(v)


def save_checkpoint(path: str, tree: Any, step: int = 0) -> None:
    arrays: Dict[str, np.ndarray] = {
        _path_str(p): to_numpy(v) for p, v in tree_leaves_with_path(tree)
    }
    arrays["__step__"] = np.asarray(step)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **arrays)


def restore_checkpoint(path: str, like: Any, strict: bool = True):
    """Restores into the structure of ``like``. Returns (tree, step).

    Each leaf comes back as a tensor with the dtype and on the device of
    ``like``'s leaf (a numpy or scalar leaf gives a CPU tensor of its
    dtype). Raises ``KeyError`` naming every path ``like`` requires that
    the archive lacks, and ``ValueError`` on shape mismatches or (with
    ``strict``, the default) archive paths absent from ``like`` — a
    silent partial restore is how failover corrupts a model.
    """
    if not path.endswith(".npz"):
        path = path + ".npz"
    with np.load(path) as data:
        arrays = {k: data[k] for k in data.files}
    step = int(arrays["__step__"])
    keys = [_path_str(p) for p, _ in tree_leaves_with_path(like)]
    missing = sorted(k for k in keys if k not in arrays)
    if missing:
        raise KeyError(
            f"checkpoint {path!r} is missing {len(missing)} path(s) "
            f"required by `like`: {missing}")
    if strict:
        extra = sorted(set(arrays) - set(keys) - {"__step__"})
        if extra:
            raise ValueError(
                f"checkpoint {path!r} holds {len(extra)} path(s) absent "
                f"from `like`: {extra} (pass strict=False to ignore)")

    def restore(p, old):
        key = _path_str(p)
        arr = arrays[key]
        want = tuple(np.shape(old))
        if tuple(arr.shape) != want:
            raise ValueError(
                f"checkpoint leaf {key!r} has shape {tuple(arr.shape)}, "
                f"expected {want}")
        if isinstance(old, torch.Tensor):
            return torch.as_tensor(arr).to(device=old.device,
                                           dtype=old.dtype)
        dtype = getattr(old, "dtype", None)
        return torch.as_tensor(arr if dtype is None
                               else arr.astype(dtype, copy=False))

    return tree_map_with_path(restore, like), step
