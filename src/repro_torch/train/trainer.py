"""Train steps over ``torch.distributed``.

The PyTorch counterpart of the JAX package's ``train/trainer.py``:

``make_plain_train_step``  the lossless baseline: each rank's gradient on
                           its shard of the batch, then an averaging
                           ``all_reduce`` of each leaf over the data
                           axes, which equals GSPMD's global mean when
                           the batch splits evenly.
``make_ltp_train_step``    LTP as a first-class feature at scale: each
                           rank is one of the paper's workers; its
                           gradient is packet-masked leaf by leaf,
                           bubble-filled, summed over the worker axes,
                           compensated and applied (paper §III).

The JAX step runs the forward and backward inside a ``shard_map`` manual
over the worker axes and auto (GSPMD) over the rest. Here a rank holds
the whole model and computes its gradient with ``torch.func.
grad_and_value`` of the model's ``loss_fn`` (remat on, as the LM paths
train); the collectives of ``core.ltp_sync`` stand for ``psum`` and
friends. A mesh with a non-worker axis larger than 1 would need tensor
parallelism inside the models, GSPMD's work in JAX, which the port does
not have yet: both step makers refuse it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Sequence, Tuple

import numpy as np
import torch
from torch.func import grad_and_value

from repro_torch.config import LTPConfig
from repro_torch.core import ltp_sync as ls
from repro_torch.device import DeviceLike
from repro_torch.models.api import ModelApi
from repro_torch.models.sharding import dp_axes, mesh_shape, spec_at
from repro_torch.optim import Optimizer
from repro_torch.tree import tree_leaves, tree_map, tree_map_with_path, \
    tree_unflatten


@dataclasses.dataclass
class TrainState:
    params: Any
    opt_state: Any
    step: torch.Tensor


def init_state(api: ModelApi, opt: Optimizer, seed: int = 0, *,
               device: DeviceLike = None, params: Any = None) -> TrainState:
    """Params from ``api.init`` with a CPU generator seeded ``seed`` (or
    the given ``params``) on ``device`` (``None`` means ``cuda``), the
    optimizer's state and step 0."""
    if params is None:
        params = api.init(torch.Generator().manual_seed(seed), device=device)
    dev = tree_leaves(params)[0].device
    return TrainState(params=params, opt_state=opt.init(params),
                      step=torch.zeros((), dtype=torch.int32, device=dev))


def zero_opt_state(params: Any, ltp: LTPConfig, mesh,
                   worker_axes: Sequence[str]) -> Dict[str, Any]:
    """The ZeRO variant's optimizer state: this rank's zero shard of each
    leaf's packet-space momentum (``ls.zero_momentum_shapes`` rows over
    W), as ``{"m_pkts": [...]}``, which selects that variant."""
    w = ls.worker_count(mesh, worker_axes)
    dev = tree_leaves(params)[0].device
    return {"m_pkts": [torch.zeros((n // w, p), dtype=torch.float32,
                                   device=dev)
                       for n, p in ls.zero_momentum_shapes(params, ltp, w)]}


def _check_mesh(mesh, worker_axes: Sequence[str]) -> None:
    for name, size in mesh_shape(mesh).items():
        if name not in worker_axes and size > 1:
            raise NotImplementedError(
                f"mesh axis {name!r} of size {size} is not a worker axis: "
                f"sharding the model over it needs tensor parallelism "
                f"inside the port's models, which is ROADMAP.md queue 1 "
                f"item 13b; give it size 1")


def _to(x, device) -> torch.Tensor:
    """A batch leaf (tensor or array) on ``device``; arrays are copied."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.tensor(np.asarray(x), device=device)


def _block(x, spec, mesh, device) -> torch.Tensor:
    """This rank's block of a global batch leaf under ``spec``."""
    x = _to(x, device)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        names = (entry,) if isinstance(entry, str) else tuple(entry)
        n = ls.worker_count(mesh, names)
        idx = ls.worker_index(mesh, names)
        size = x.shape[dim] // n
        x = x.narrow(dim, idx * size, size)
    return x


def _loss_and_grads(api: ModelApi, params, batch):
    grads, loss = grad_and_value(lambda p: api.loss_fn(p, batch))(params)
    return loss.detach(), grads


def _apply(params, updates):
    return tree_map(lambda p, u: p + u, params, updates)


def make_plain_train_step(api: ModelApi, opt: Optimizer,
                          mesh=None) -> Callable:
    """Lossless sync: ``step(state, batch, lr) -> (state, {"loss"})``.
    Without a mesh, one process takes the whole batch. With one, each
    rank takes its block of dim 0 of the global batch over the mesh's
    data axes (pod, data), and the gradients and the loss are averaged
    over them by ``all_reduce``."""
    axes = dp_axes(mesh) if mesh is not None else ()
    if mesh is not None:
        _check_mesh(mesh, axes)
    n = ls.worker_count(mesh, axes) if mesh is not None else 1
    split = (axes if len(axes) > 1 else axes[0],) if axes else ()

    def step(state: TrainState, batch, lr):
        dev = tree_leaves(state.params)[0].device
        if mesh is None:
            batch = tree_map(lambda x: _to(x, dev), batch)
        else:
            batch = tree_map_with_path(
                lambda path, x: _block(x, split, mesh, dev), batch)
        loss, grads = _loss_and_grads(api, state.params, batch)
        if mesh is not None:
            grads = tree_map(lambda g: ls.psum(g, mesh, axes) / n, grads)
            loss = ls.psum(loss.clone(), mesh, axes) / n
        updates, opt_state = opt.update(grads, state.opt_state,
                                        state.params, lr)
        return (TrainState(_apply(state.params, updates), opt_state,
                           state.step + 1),
                {"loss": loss})

    return step


def _restrict(spec, worker_axes: Tuple[str, ...]):
    """A batch spec cut to the worker axes (the others are auto in the
    reference's ``shard_map``)."""
    out = []
    for entry in spec:
        if entry is None:
            out.append(None)
            continue
        names = (entry,) if isinstance(entry, str) else tuple(entry)
        keep = tuple(n for n in names if n in worker_axes)
        out.append(keep[0] if len(keep) == 1 else (keep or None))
    return tuple(out)


def make_ltp_train_step(api: ModelApi, opt: Optimizer, mesh,
                        ltp: LTPConfig, worker_axes: Sequence[str],
                        batch_specs) -> Callable:
    """LTP-synced step (sharded, v2 leafwise-packet masking):
    ``step(state, batch, frac, seed, lr, *, uniforms=None) -> (state,
    {"loss", "delivered_frac"})``.

    worker_axes: the mesh axes whose members act as the paper's workers,
    ('data',), ('pod',) or ('pod', 'data'); every other axis must have
    size 1. batch_specs: a tree of specs for the GLOBAL batch, which
    every rank passes whole; each takes its block along the worker axes
    (the other axes of a spec are dropped, as the reference restricts
    them). frac: (W,) delivered fraction a worker; seed: the step's seed
    for the delivery draws, or ``uniforms``, this rank's per-leaf draws.

    Two variants, chosen as in the reference: the psum variant
    (``ls.masked_psum_leafwise``, then ``opt``), and, when
    ``state.opt_state`` is ``{"m_pkts": [...]}`` (``zero_opt_state``),
    the ZeRO variant (``ls.masked_rs_update_leafwise``: SGD-momentum on
    this rank's packet shard, then the deltas all-gathered in the
    params' dtype and added). The loss is the mean over workers of each
    worker's loss on its block."""
    worker_axes = tuple(worker_axes)
    _check_mesh(mesh, worker_axes)
    n_workers = ls.worker_count(mesh, worker_axes)

    def local(state: TrainState, batch):
        dev = tree_leaves(state.params)[0].device
        batch = tree_map_with_path(lambda path, x: _block(
            x, _restrict(spec_at(batch_specs, path), worker_axes), mesh,
            dev), batch)
        loss, grads = _loss_and_grads(api, state.params, batch)
        loss = ls.psum(loss.clone(), mesh, worker_axes) / n_workers
        return loss, grads

    def zero_step(state: TrainState, batch, frac, seed, lr, uniforms):
        loss, grads = local(state, batch)
        deltas, m_pkts, realized = ls.masked_rs_update_leafwise(
            grads, state.params, state.opt_state["m_pkts"], seed, frac, ltp,
            mesh, worker_axes, n_workers, lr, uniforms=uniforms)
        p_leaves = tree_leaves(state.params)
        new_leaves = [
            p + ls._from_packets(
                ls.all_gather(d, mesh, worker_axes).to(torch.float32),
                p.shape, p.dtype)
            for p, d in zip(p_leaves, deltas, strict=True)]
        return (TrainState(tree_unflatten(state.params, new_leaves),
                           {"m_pkts": m_pkts}, state.step + 1),
                {"loss": loss, "delivered_frac": realized})

    def step(state: TrainState, batch, frac, seed, lr, *, uniforms=None):
        if isinstance(state.opt_state, dict) and "m_pkts" in state.opt_state:
            return zero_step(state, batch, frac, seed, lr, uniforms)
        loss, grads = local(state, batch)
        synced, realized = ls.masked_psum_leafwise(
            grads, seed, frac, ltp, mesh, worker_axes, n_workers,
            uniforms=uniforms)
        updates, opt_state = opt.update(synced, state.opt_state,
                                        state.params, lr)
        return (TrainState(_apply(state.params, updates), opt_state,
                           state.step + 1),
                {"loss": loss, "delivered_frac": realized})

    return step
