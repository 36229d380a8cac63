"""Meshes over the current process group.

The PyTorch counterpart of the JAX package's ``launch/mesh.py``. A mesh
is PyTorch's own ``DeviceMesh`` (``init_device_mesh``) with named axes,
one rank a device:

Single pod: (data=16, model=16), 256 devices.
Multi-pod:  (pod=2, data=16, model=16), 512 devices; the ``pod`` axis is
pure data parallelism over the inter-pod link, the lossy PS-over-WAN
link LTP targets (DESIGN.md §2).

The production shapes are kept as shapes (``PRODUCTION_SHAPES``): their
specs and local plans need no process group (``models.sharding`` takes a
``{name: size}`` dict). A ``DeviceMesh`` is built only when the world
size matches. The reference's TPU v5e roofline constants are not carried
over.
"""
from __future__ import annotations

from typing import Dict, Tuple

PRODUCTION_SHAPES: Dict[str, Tuple[Tuple[int, ...], Tuple[str, ...]]] = {
    "single_pod": ((16, 16), ("data", "model")),
    "multi_pod": ((2, 16, 16), ("pod", "data", "model")),
}


def production_mesh_shape(*, multi_pod: bool = False) -> Dict[str, int]:
    """``{axis: size}`` of a production mesh."""
    shape, names = PRODUCTION_SHAPES["multi_pod" if multi_pod
                                     else "single_pod"]
    return dict(zip(names, shape))


def _mesh(shape: Tuple[int, ...], names: Tuple[str, ...]):
    """A ``DeviceMesh`` on the process group's own device type: ``cuda``
    under ``nccl``, ``cpu`` under ``gloo``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("a mesh needs an initialised process group "
                           "(torch.distributed.init_process_group)")
    n = 1
    for s in shape:
        n *= s
    if dist.get_world_size() != n:
        raise ValueError(f"mesh {dict(zip(names, shape))} needs {n} ranks, "
                         f"the process group has {dist.get_world_size()}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False):
    """The production mesh as a ``DeviceMesh``; the process group must
    have its 256 (512) ranks."""
    shape, names = PRODUCTION_SHAPES["multi_pod" if multi_pod
                                     else "single_pod"]
    return _mesh(shape, names)


def make_host_mesh(n_data: int = 1, n_model: int = 1):
    """A (data, model) ``DeviceMesh`` over the current process group
    (tests, examples, one card)."""
    return _mesh((n_data, n_model), ("data", "model"))
