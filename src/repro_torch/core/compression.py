"""Gradient-compression baselines from the paper's §II-C (Fig 5): Top-k and
Random-k sparsification, with optional error feedback.

The PyTorch counterpart of the JAX package's ``core/compression.py``.
The gradient tree is flattened in the leaf order of ``repro_torch.tree``
(dict keys sorted, as ``jax.tree_util`` orders them), so the i-th
uniform lands on the same gradient element as in JAX.

Random-k's select runs through ``kernels.ops.randomk_sparsify``: the
hand-written ``randomk`` kernel on a CUDA tensor under the ``cuda`` /
``auto`` backends (``core.ltp_sync.resolve_backend``), the plain
``kernels.ref.randomk_ref`` under ``python``. JAX takes a PRNG key; the
port takes a ``torch.Generator`` on the gradient's device in its place,
or the uniforms themselves through ``u=`` (how the tests feed JAX's
draws). Top-k's threshold is ``torch.quantile`` of |g|, as JAX takes
``jnp.quantile``; it has no kernel in either package.
"""
from __future__ import annotations

import math
from typing import Any, Optional, Tuple

import torch

from repro_torch.core.ltp_sync import resolve_backend
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import randomk_ref
from repro_torch.tree import tree_leaves, tree_unflatten


def _flatten(grads) -> Tuple[torch.Tensor, Any]:
    leaves = tree_leaves(grads)
    flat = torch.cat([x.to(torch.float32).reshape(-1) for x in leaves])
    return flat, (grads, [(tuple(x.shape), x.dtype) for x in leaves])


def _unflatten(flat: torch.Tensor, meta) -> Any:
    template, shapes = meta
    out, off = [], 0
    for shape, dtype in shapes:
        sz = math.prod(shape)
        out.append(flat[off:off + sz].reshape(shape).to(dtype))
        off += sz
    return tree_unflatten(template, out)


def random_k(grads, k_frac: float, generator: Optional[torch.Generator],
             residual: Optional[torch.Tensor] = None, *,
             u: Optional[torch.Tensor] = None,
             backend: str = "auto") -> Tuple[Any, torch.Tensor]:
    """Keep a random k-fraction of gradient elements (Random-k [26]).

    Returns (sparse_grads, new_residual). Residual (error feedback) is in
    flat space; pass the previous call's output back in. The uniforms
    are ``u`` (flat float32, one per element) when given, else drawn from
    ``generator`` on the gradient's device. ``backend`` picks the kernel
    (``cuda``; ``auto`` on a CUDA tensor) or the plain version
    (``python``; ``auto`` on the CPU).
    """
    flat, meta = _flatten(grads)
    if residual is not None:
        flat = flat + residual
    if u is None:
        u = torch.rand(flat.shape, generator=generator, device=flat.device)
    else:
        u = u.to(device=flat.device, dtype=torch.float32).reshape(flat.shape)
    if resolve_backend(backend, flat) == "cuda":
        kept = kops.randomk_sparsify(flat, u, k_frac)
    else:
        kept = randomk_ref(flat, u, k_frac)
    # JAX multiplies by the mask; the select gives the same values for
    # finite gradients (a dropped negative is +0 here, -0 there)
    new_res = flat - kept
    return _unflatten(kept, meta), new_res


def top_k(grads, k_frac: float, residual: Optional[torch.Tensor] = None, *,
          sample_cap: int = 1 << 20) -> Tuple[Any, torch.Tensor]:
    """Keep the top k-fraction by |value| (Top-k [21]).

    The threshold is the (1-k) quantile of |g|; for very large gradients it
    is estimated on a strided sample (which also keeps ``torch.quantile``
    under its 2**24-element limit).
    """
    flat, meta = _flatten(grads)
    if residual is not None:
        flat = flat + residual
    a = flat.abs()
    if flat.numel() > sample_cap:
        stride = flat.numel() // sample_cap
        a_est = a[::stride]
    else:
        a_est = a
    thresh = torch.quantile(a_est, min(max(1.0 - k_frac, 0.0), 1.0))
    mask = (a >= thresh).to(flat.dtype)
    kept = flat * mask
    new_res = flat - kept
    return _unflatten(kept, meta), new_res


def measure_density(grads) -> torch.Tensor:
    """Fraction of nonzero gradient elements (float32 scalar tensor)."""
    flat, _ = _flatten(grads)
    return (flat != 0).to(torch.float32).mean()
