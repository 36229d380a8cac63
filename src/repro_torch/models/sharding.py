"""Sharding rules for params: the name-based 2D specs.

The PyTorch counterpart of the JAX package's ``models/sharding.py``
(baseline scheme, DESIGN.md §4: 2D "fsdp + tensor" sharding):

  - ``data`` axis: FSDP shard of weight matrices + batch parallelism.
  - ``model`` axis: tensor parallelism (heads / d_ff / experts / vocab).
  - ``pod`` axis (multi-pod only): pure data parallelism across pods;
    weights are replicated across pods, so the only cross-pod traffic is
    the gradient all-reduce, the "PS over WAN/DCN" link LTP targets.

Rules are name-based: parameter tree paths carry conventional leaf names
(``wq``, ``w_up``, ``embed``, ...). ``spec_for(path, shape, mesh)``
returns a spec; dims that do not divide the mesh axis stay replicated.

A spec is a plain tuple with one entry a dim: ``None`` (replicated), an
axis name, or a tuple of axis names; ``()`` is fully replicated, as
``PartitionSpec()`` is. A mesh is anything with axis names and sizes: a
``torch.distributed.device_mesh.DeviceMesh``, or a plain ``{name: size}``
dict, so the specs of the production meshes, (16, 16) and (2, 16, 16),
are computed with no process group.

Not carried over: ``param_shardings`` (``NamedSharding`` trees) and
``ShardCtx`` (GSPMD activation constraints). They place and constrain
tensors across the ``model`` axis, and the port's models have no tensor
parallelism: every mesh the port trains on has worker axes alone of size
> 1, and on such a mesh the JAX LTP step's ctx, which excludes the
worker axes, constrains nothing (``src/repro/train/trainer.py:80``).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

from repro_torch.tree import tree_map_with_path

Spec = Tuple[Any, ...]


def mesh_shape(mesh: Any) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` or of a plain dict."""
    if isinstance(mesh, dict):
        return dict(mesh)
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("a DeviceMesh without mesh_dim_names has no axes "
                         "to shard over")
    return {n: int(s) for n, s in zip(names, mesh.shape)}


def axis_names(mesh: Any) -> Tuple[str, ...]:
    return tuple(mesh_shape(mesh))


def dp_axes(mesh: Any) -> Tuple[str, ...]:
    """The batch-parallel axes present in this mesh ((pod, data) or
    (data,))."""
    names = axis_names(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def axis_size(mesh: Any, name: str) -> int:
    return mesh_shape(mesh).get(name, 1)


def _fits(dim: int, n: int) -> bool:
    return n > 1 and dim % n == 0


# Leaf-name -> (dim sharded over 'data', dim sharded over 'model').
# None means "never shard that side".
_RULES = {
    # embeddings / unembedding
    "embed": (1, 0),          # (vocab, d_model): vocab->model, d->data
    "lm_head": (0, 1),        # (d_model, vocab): vocab->model
    "pos_embed": (None, 1),   # (max_pos, d_model)
    # attention projections
    "wq": (0, 1),             # (d_model, H*hd)
    "wk": (0, 1),
    "wv": (0, 1),
    "wo": (1, 0),             # (H*hd, d_model)
    # MLA
    "w_dq": (0, None),        # (d, q_lora)
    "w_uq": (None, 1),        # (q_lora, H*qk_dim)
    "w_dkv": (0, None),       # (d, kv_lora + rope)
    "w_uk": (None, 1),        # (kv_lora, H*nope)
    "w_uv": (None, 1),        # (kv_lora, H*v_dim)
    # MLP
    "w_gate": (0, 1),         # (d, ff)
    "w_up": (0, 1),
    "w_down": (1, 0),         # (ff, d)
    # MoE (E, d, ff) / (E, ff, d): expert dim -> model when divisible,
    # handled specially in spec_for.
    "moe_gate": (0, None),    # router (d, E)
    # SSM
    "in_proj": (0, 1),        # (d, 2*d_inner) etc.
    "out_proj": (1, 0),       # (d_inner, d)
    "x_proj": (1, None),      # (d_inner, dt_rank + 2*state)
    "dt_proj": (None, 1),     # (dt_rank, d_inner)
    "conv_w": (1, None),      # (k, d_inner) tap-major
    "A_log": (1, None),       # (d_inner, state): model on d_inner
    # CNN
    "conv": (None, None),
    "fc": (0, None),
}

_REPLICATED_SUFFIXES = (
    "scale", "bias", "offset", "D", "dt_bias", "A_log_m2", "gamma",
)


def _leaf_name(path: Tuple[Any, ...]) -> str:
    """The last dict key of a path (``repro_torch.tree`` paths hold dict
    keys and list/tuple positions; the positions are skipped, as the
    reference skips ``SequenceKey``)."""
    keys = [p for p in path if isinstance(p, str)]
    return keys[-1] if keys else ""


def spec_for(path: Tuple[Any, ...], shape: Tuple[int, ...], mesh: Any, *,
             fsdp: bool = True) -> Spec:
    """Spec for one parameter leaf, honoring divisibility.

    ``fsdp=False`` drops the 'data' (FSDP) axis from weight specs: used
    when weights must be replicated across the worker axes (LTP's
    per-worker gradient masking on a single-pod mesh)."""
    name = _leaf_name(path)
    nd = axis_size(mesh, "data") if fsdp else 1
    nm = axis_size(mesh, "model")
    ndim = len(shape)

    if name in _REPLICATED_SUFFIXES or ndim <= 1:
        return ()

    if not fsdp and name == "embed" and ndim == 2:
        # inside manual (LTP) regions the token-lookup gather must be
        # shard-local: shard d_model, replicate vocab rows
        return (None, "model") if _fits(shape[1], nm) else ()

    # MoE expert stacks: (E, d_in, d_out)
    if name in ("experts_gate", "experts_up", "experts_down") and ndim == 3:
        e, di, _ = shape
        spec: list = [None, None, None]
        if _fits(e, nm):
            spec[0] = "model"
            if _fits(di, nd):
                spec[1] = "data"
        else:  # few big experts (mixtral): tensor-parallel within experts
            ff_dim = 2 if name != "experts_down" else 1
            if _fits(shape[ff_dim], nm):
                spec[ff_dim] = "model"
            other = 1 if ff_dim == 2 else 2
            if _fits(shape[other], nd):
                spec[other] = "data"
        return tuple(spec)

    rule = _RULES.get(name)
    if rule is None:
        # generic 2D matmul weight: fsdp on dim0, tensor on dim1 when
        # divisible
        rule = (0, 1) if ndim == 2 else (None, None)
    d_dim, m_dim = rule
    spec = [None] * ndim
    if m_dim is not None and m_dim < ndim and _fits(shape[m_dim], nm):
        spec[m_dim] = "model"
    if (
        d_dim is not None
        and d_dim < ndim
        and spec[d_dim] is None
        and _fits(shape[d_dim], nd)
    ):
        spec[d_dim] = "data"
    return tuple(spec)


def param_specs(params_shape: Any, mesh: Any, *,
                fsdp: bool = True) -> Any:
    """Tree of specs matching a params tree (tensors, meta tensors or
    anything with a ``shape``)."""
    return tree_map_with_path(
        lambda path, leaf: spec_for(path, tuple(leaf.shape), mesh,
                                    fsdp=fsdp),
        params_shape)


def spec_at(specs: Any, path: Tuple[Any, ...]) -> Optional[Spec]:
    """The spec at ``path`` of a spec tree (a spec is a tuple, so it
    cannot be told from a tree node by its type: it is found by the
    path of the params leaf it belongs to)."""
    node = specs
    for k in path:
        node = node[k]
    return node
