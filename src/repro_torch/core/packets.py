"""Packetization of gradient trees (paper §III-C, §III-E, §IV-A).

The PyTorch counterpart of the JAX package's ``core/packets.py``. The
gradient tree is flattened into one contiguous float stream, in the leaf
order of ``repro_torch.tree`` (dict keys sorted, as ``jax.tree_util``
orders them), and cut into fixed-size packets (payload =
``packet_floats`` float32 values). The stream tail is zero-padded to a
whole packet.

*Critical packets* (§III-E): the packets containing the first/last
elements of each tensor are always delivered.

``local_shape`` / ``local_plan`` give each rank's block of a tree
sharded by ``models.sharding`` specs, and the packet plan over those
blocks (the sharded path's ``LTPSync``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.models.sharding import mesh_shape, spec_at
from repro_torch.tree import tree_leaves, tree_map_with_path, tree_unflatten


@dataclasses.dataclass(frozen=True)
class PacketPlan:
    """Static description of the packet layout for one gradient tree."""

    packet_floats: int
    n_floats: int                 # unpadded total float count
    n_packets: int
    leaf_shapes: Tuple[Tuple[int, ...], ...]
    leaf_offsets: Tuple[int, ...]  # float offset of each leaf in the stream
    critical: np.ndarray           # (n_packets,) bool
    treedef: Any                   # the tree itself, used as a template

    @property
    def padded_floats(self) -> int:
        return self.n_packets * self.packet_floats

    @property
    def n_critical(self) -> int:
        return int(self.critical.sum())

    @property
    def payload_bytes(self) -> int:
        return self.packet_floats * 4


def make_plan(
    tree: Any,
    packet_floats: int = 360,
    critical_per_tensor: int = 1,
) -> PacketPlan:
    """Build the packet plan from a tree of tensors (or anything with a
    ``shape``)."""
    leaves = tree_leaves(tree)
    shapes = tuple(tuple(x.shape) for x in leaves)
    sizes = [int(np.prod(s)) if s else 1 for s in shapes]
    offsets = tuple(int(x) for x in (np.cumsum([0] + sizes)[:-1]))
    n_floats = int(sum(sizes))
    n_packets = max(1, -(-n_floats // packet_floats))
    critical = np.zeros((n_packets,), bool)
    c = critical_per_tensor
    for off, sz in zip(offsets, sizes):
        first = off // packet_floats
        last = (off + sz - 1) // packet_floats
        critical[first : min(first + c, n_packets)] = True
        critical[max(last - c + 1, 0) : last + 1] = True
    return PacketPlan(
        packet_floats=packet_floats,
        n_floats=n_floats,
        n_packets=n_packets,
        leaf_shapes=shapes,
        leaf_offsets=offsets,
        critical=critical,
        treedef=tree,
    )


def flatten(plan: PacketPlan, tree: Any) -> torch.Tensor:
    """Tree -> (n_packets, packet_floats) float32 stream (zero-padded).

    Leaves may carry leading batch dims beyond the plan's shapes (per-
    worker gradients of shape (W, *shape)); the stream then has them too:
    (*batch, n_packets, packet_floats)."""
    leaves = tree_leaves(tree)
    lead = tuple(leaves[0].shape[: leaves[0].dim() - len(plan.leaf_shapes[0])])
    out = torch.empty(lead + (plan.n_packets, plan.packet_floats),
                      dtype=torch.float32, device=leaves[0].device)
    return flatten_into(plan, tree, out)


def flatten_into(plan: PacketPlan, tree: Any,
                 out: torch.Tensor) -> torch.Tensor:
    """``flatten`` written into ``out``, a contiguous (*batch, n_packets,
    packet_floats) float32 tensor (a slice of a larger stream, say): each
    leaf is copied to its offset once and the tail is zeroed. Returns
    ``out``."""
    lead = tuple(out.shape[:-2])
    flat = out.view(lead + (-1,))
    for x, shape, off in zip(tree_leaves(tree), plan.leaf_shapes,
                             plan.leaf_offsets):
        sz = int(np.prod(shape)) if shape else 1
        flat[..., off : off + sz].copy_(x.reshape(lead + (sz,)))
    flat[..., plan.n_floats :].zero_()
    return out


def unflatten(plan: PacketPlan, packets: torch.Tensor,
              dtypes: Optional[Sequence[torch.dtype]] = None) -> Any:
    """(n_packets, packet_floats) -> tree with the plan's leaf shapes."""
    flat = packets.reshape(-1)[: plan.n_floats]
    leaves: List[torch.Tensor] = []
    for shape, off in zip(plan.leaf_shapes, plan.leaf_offsets):
        sz = int(np.prod(shape)) if shape else 1
        leaves.append(flat[off : off + sz].reshape(shape))
    if dtypes is not None:
        leaves = [x.to(d) for x, d in zip(leaves, dtypes)]
    return tree_unflatten(plan.treedef, leaves)


def delivery_mask(
    plan: PacketPlan, generator: torch.Generator, delivered_frac, *,
    extra_critical: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Random per-packet delivery (threshold-controlled Random-k, §II-C).

    Uniforms come from ``generator`` on its device. Critical packets are
    always delivered. Returns (n_packets,) float32 mask. The draws differ
    from ``jax.random``'s, so parity with the JAX package is exact on the
    critical pins and statistical elsewhere.
    """
    dev = generator.device
    u = torch.rand(plan.n_packets, generator=generator, device=dev)
    crit = torch.as_tensor(plan.critical, device=dev)
    if extra_critical is not None:
        crit = crit | extra_critical
    keep = (u < torch.as_tensor(delivered_frac, device=dev)).to(torch.float32)
    return torch.where(crit, torch.ones_like(keep), keep)


def local_shape(shape: Tuple[int, ...], spec, mesh) -> Tuple[int, ...]:
    """Per-rank block shape of a global tensor under a spec (a tuple of
    ``None`` / axis name / tuple of axis names, ``models.sharding``'s);
    ``mesh`` is a ``DeviceMesh`` or a ``{name: size}`` dict."""
    sizes = mesh_shape(mesh)
    out = list(shape)
    for dim, names in enumerate(spec):
        if names is None:
            continue
        names = (names,) if isinstance(names, str) else tuple(names)
        total = 1
        for n in names:
            total *= sizes[n]
        assert out[dim] % total == 0, (shape, spec, dim)
        out[dim] //= total
    return tuple(out)


def local_plan(
    params_shape: Any, specs: Any, mesh, packet_floats: int = 360,
    critical_per_tensor: int = 1,
) -> PacketPlan:
    """PacketPlan over LOCAL (per-rank) leaf shapes given param specs (a
    tree of ``models.sharding`` specs matching ``params_shape``)."""
    locals_ = tree_map_with_path(
        lambda path, x: torch.empty(
            local_shape(tuple(x.shape), spec_at(specs, path), mesh),
            dtype=getattr(x, "dtype", torch.float32), device="meta"),
        params_shape)
    return make_plan(locals_, packet_floats, critical_per_tensor)
