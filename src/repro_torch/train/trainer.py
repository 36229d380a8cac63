"""Train steps over ``torch.distributed``.

The PyTorch counterpart of the JAX package's ``train/trainer.py``:

``make_plain_train_step``  the lossless baseline: each rank's gradient on
                           its shard of the batch, then an averaging
                           ``all_reduce`` of each leaf over the data
                           axes, which equals GSPMD's global mean when
                           the batch splits evenly; on a state from
                           ``init_state(..., fsdp=True)`` the
                           reference's FSDP baseline (below).
``make_ltp_train_step``    LTP as a first-class feature at scale: each
                           rank is one of the paper's workers; its
                           gradient is packet-masked leaf by leaf,
                           bubble-filled, summed over the worker axes,
                           compensated and applied (paper §III).

The JAX step runs the forward and backward inside a ``shard_map`` manual
over the worker axes and auto (GSPMD) over the rest. Here a rank
computes its gradient with ``torch.func.grad_and_value`` of the model's
``loss_fn`` (remat on, as the LM paths train); the collectives of
``core.ltp_sync`` stand for ``psum`` and friends. On a mesh whose
``model`` axis is larger than 1 the rank holds its block of every leaf
that ``sharding.model_specs`` shards (``init_state(..., mesh=)``,
``sharding.shard_params``), the model runs tensor-parallel over
``model`` (``models.sharding.ShardCtx``: GSPMD's work in JAX), and the
optimizer updates the blocks. That covers every family of the repo
(dense, VLM, MoE with MLA, SSM, hybrid, enc-dec; the CNN computes whole
on every model rank), in both variants of the LTP step.

A ``pod`` or ``data`` axis that is no worker axis is data parallelism
inside a worker (the reference's ``ctx.dp``, which GSPMD splits the
worker's batch over): each rank takes its block of the worker's block
of the batch, and the losses and gradients are summed over those axes
before the masking (``_mean_loss_and_grads``): each rank's
cross-entropy weighted by its share of the worker's label tokens, its
MoE balance loss by one over the ranks, which is the reference's one
token-weighted mean over the worker's block and its mean over the
routing groups, however unevenly the labels are masked. Every data
rank of a worker then masks and syncs the same gradient, and holds the
same result.

The plain step on an FSDP state is the counterpart of the reference's
plain step under ``spec_for(..., fsdp=True)`` shardings (its
"GSPMD/fsdp baseline"): on a mesh whose ``data`` axis is larger than 1,
each rank holds its ``data`` block of its ``model`` block of each leaf
that ``sharding.fsdp_specs`` splits (``init_state(..., fsdp=True)``,
which records the layout in the state's ``fsdp``), and so of its
gradient and optimizer state. The model gathers each
leaf where it uses it (``sharding.whole``: all-gather forward,
reduce-scatter backward), so such a leaf's gradient arrives summed over
``data``, this rank's block; it is then summed over ``pod``, over which
the weights stay replicated, as ``spec_for`` leaves them. The LTP step
keeps every weight whole over its workers, as the PS semantics ask.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.func import grad_and_value

from repro_torch.config import LTPConfig
from repro_torch.core import ltp_sync as ls
from repro_torch.device import DeviceLike
from repro_torch.models.api import ModelApi
from repro_torch.models.sharding import axis_size, block_of, dp_axes, \
    FsdpCtx, fsdp_specs, mesh_shape, model_dim, model_specs, shard_params, \
    spec_at, tp_ctx
from repro_torch.optim import Optimizer
from repro_torch.tree import tree_leaves, tree_leaves_with_path, tree_map, \
    tree_map_with_path, tree_unflatten


@dataclasses.dataclass
class TrainState:
    params: Any
    opt_state: Any
    step: torch.Tensor
    # the FsdpCtx of params split over data (init_state(..., fsdp=True)),
    # which the plain step gathers by; None: whole over data
    fsdp: Optional[FsdpCtx] = None


def model_layout(api: ModelApi, mesh) -> Any:
    """The model-axis specs of ``api``'s params on ``mesh``
    (``sharding.model_specs`` over a meta init), or ``None`` where the
    mesh has no ``model`` axis larger than 1."""
    if mesh is None or axis_size(mesh, "model") == 1:
        return None
    return model_specs(api.cfg, api.init(None, device="meta"), mesh)


def fsdp_layout(api: ModelApi, mesh) -> Any:
    """The plain step's FSDP layout of ``api``'s params on ``mesh``
    (``sharding.fsdp_specs`` over a meta init: the ``model`` dims and
    the ``data`` dims), or ``None`` where the mesh has no ``data`` axis
    larger than 1."""
    if mesh is None or axis_size(mesh, "data") == 1:
        return None
    return fsdp_specs(api.cfg, api.init(None, device="meta"), mesh)


def init_state(api: ModelApi, opt: Optimizer, seed: int = 0, *,
               device: DeviceLike = None, params: Any = None,
               mesh=None, fsdp: bool = False) -> TrainState:
    """Params from ``api.init`` with a CPU generator seeded ``seed`` (or
    the given GLOBAL ``params``) on ``device`` (``None`` means ``cuda``),
    the optimizer's state and step 0. On a ``mesh`` whose ``model`` axis
    is larger than 1, the state holds this rank's blocks
    (``model_layout``); with ``fsdp``, its blocks over ``data`` too
    (``fsdp_layout``), which the state's ``fsdp`` records for the plain
    step."""
    if params is None:
        params = api.init(torch.Generator().manual_seed(seed), device=device)
    specs = fsdp_layout(api, mesh) if fsdp else None
    fctx = None if specs is None else FsdpCtx(mesh, specs)
    if specs is None:
        specs = model_layout(api, mesh)
    if specs is not None:
        params = shard_params(params, specs, mesh)
    dev = tree_leaves(params)[0].device
    return TrainState(params=params, opt_state=opt.init(params),
                      step=torch.zeros((), dtype=torch.int32, device=dev),
                      fsdp=fctx)


def zero_opt_state(params: Any, ltp: LTPConfig, mesh,
                   worker_axes: Sequence[str]) -> Dict[str, Any]:
    """The ZeRO variant's optimizer state: this rank's worker's rows of
    each leaf's packet-space momentum (``ls.zero_momentum_shapes`` rows
    over W), as ``{"m_pkts": [...]}``, which selects that variant.
    ``params``: the GLOBAL params (``init_state``'s ``params=``, before
    it shards them over ``model``): the packets are the global leaves',
    so every model rank and every data rank of a worker holds that
    worker's rows whole, as the reference's ``P(worker_axes, None)``
    places them."""
    w = ls.worker_count(mesh, worker_axes)
    dev = tree_leaves(params)[0].device
    return {"m_pkts": [torch.zeros((n // w, p), dtype=torch.float32,
                                   device=dev)
                       for n, p in ls.zero_momentum_shapes(params, ltp, w)]}


def _check_mesh(mesh, worker_axes: Sequence[str]) -> None:
    """Every axis of size > 1 is a worker axis, a batch axis
    (``sharding.dp_axes``) or ``model``."""
    for name, size in mesh_shape(mesh).items():
        if size == 1 or name in worker_axes or name in dp_axes(mesh) + (
                "model",):
            continue
        raise NotImplementedError(
            f"mesh axis {name!r} of size {size} is neither a worker axis, "
            f"'pod', 'data' nor 'model': the port shards over no other "
            f"axis; give it size 1")


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


def _loss_and_grads(api: ModelApi, params, batch, ctx=None, fsdp=None,
                    **kw):
    if ctx is not None:
        kw["ctx"] = ctx
    if fsdp is not None:
        kw["fsdp"] = fsdp
    grads, loss = grad_and_value(
        lambda p: api.loss_fn(p, batch, **kw))(params)
    return loss.detach(), grads


def _label_count(batch) -> torch.Tensor:
    """The labels a batch block counts: those >= 0, as ``cross_entropy``
    masks the rest (every class label of the CNN's)."""
    return (batch["labels"] >= 0).sum().to(torch.float32)


def _mean_loss_and_grads(api: ModelApi, params, batch, ctx, mesh,
                         axes: Tuple[str, ...], fsdp=None):
    """The loss and its gradient over the batch whose blocks the ranks of
    ``axes`` hold, each rank holding one: each rank's cross-entropy
    weighted by n times its share of the label tokens (``ce_weight``),
    then the mean over the ranks. That is GSPMD's token-weighted mean
    over the whole batch, and the mean of the MoE balance loss over the
    groups, one a rank (``moe.py``). Under ``fsdp`` a leaf split over
    ``data`` has its gradient already summed there (the gather's
    reduce-scatter), and is summed over the other axes alone."""
    n = ls.worker_count(mesh, axes)
    if n == 1:
        return _loss_and_grads(api, params, batch, ctx, fsdp)
    count = _label_count(batch)
    total = ls.psum(count.clone(), mesh, axes)
    loss, grads = _loss_and_grads(
        api, params, batch, ctx, fsdp,
        ce_weight=count * n / torch.clamp(total, min=1.0))
    rest = tuple(a for a in axes if a != "data")

    def mean(path, g):
        split_ = fsdp is not None and fsdp.dim(path) is not None
        return ls.psum(g, mesh, rest if split_ else axes) / n

    grads = tree_map_with_path(mean, grads)
    return ls.psum(loss.clone(), mesh, axes) / n, grads


def _apply(params, updates):
    return tree_map(lambda p, u: p + u, params, updates)


def make_plain_train_step(api: ModelApi, opt: Optimizer,
                          mesh=None) -> Callable:
    """Lossless sync: ``step(state, batch, lr) -> (state, {"loss"})``.
    Without a mesh, one process takes the whole batch. With one, each
    rank takes its block of dim 0 of the global batch (of dim 1 of a
    VLM's ``positions3``) over the mesh's data axes (pod, data), and the
    loss and the gradients are the mean over the whole batch
    (``_mean_loss_and_grads``, ``all_reduce``);
    over a ``model`` axis the model runs tensor-parallel on the state's
    blocks. On a state from ``init_state(..., fsdp=True)`` the weights
    are split over ``data`` as well (its ``fsdp``; module docstring)."""
    axes = dp_axes(mesh) if mesh is not None else ()
    ctx = None
    if mesh is not None:
        _check_mesh(mesh, axes)
        ctx = tp_ctx(mesh)
    split = (axes if len(axes) > 1 else axes[0],) if axes else ()

    def step(state: TrainState, batch, lr):
        dev = tree_leaves(state.params)[0].device
        if mesh is None:
            batch = tree_map(lambda x: _to(x, dev), batch)
            loss, grads = _loss_and_grads(api, state.params, batch)
        else:
            # the M-RoPE ids (3, B, S) carry the batch on dim 1
            batch = tree_map_with_path(
                lambda path, x: _block(x, (None, *split) if path[-1]
                                       == "positions3" else split, mesh,
                                       dev), batch)
            loss, grads = _mean_loss_and_grads(api, state.params, batch,
                                               ctx, mesh, axes, state.fsdp)
        updates, opt_state = opt.update(grads, state.opt_state,
                                        state.params, lr)
        return (TrainState(_apply(state.params, updates), opt_state,
                           state.step + 1, state.fsdp),
                {"loss": loss})

    return step


def _restrict(spec, worker_axes: Tuple[str, ...],
              inner: Tuple[str, ...]):
    """A batch spec cut to the worker axes (the others are auto in the
    reference's ``shard_map``), then each dim that names a batch axis (a
    worker axis or one of ``inner``, the non-worker batch axes) split
    over ``inner``, as GSPMD splits a worker's block over the
    reference's ``ctx.dp``."""
    out = []
    for entry in spec:
        if entry is None:
            out.append(None)
            continue
        names = (entry,) if isinstance(entry, str) else tuple(entry)
        keep = tuple(n for n in names if n in worker_axes)
        if any(n in worker_axes + inner for n in names):
            keep += inner
        out.append(keep[0] if len(keep) == 1 else (keep or None))
    return tuple(out)


def _add_delta(p: torch.Tensor, d: torch.Tensor, dim, nm: int,
               idx: int) -> torch.Tensor:
    """``p`` (this rank's block, split over ``model`` on ``dim``, or
    whole) plus its block of the global leaf rebuilt from the gathered
    packet deltas ``d``."""
    shape = list(p.shape)
    if dim is not None:
        shape[dim] *= nm
    full = ls._from_packets(d.to(torch.float32), shape, p.dtype)
    return p + (full if dim is None else block_of(full, dim, nm, idx))


def make_ltp_train_step(api: ModelApi, opt: Optimizer, mesh,
                        ltp: LTPConfig, worker_axes: Sequence[str],
                        batch_specs) -> Callable:
    """LTP-synced step (sharded, v2 leafwise-packet masking):
    ``step(state, batch, frac, seed, lr, *, uniforms=None) -> (state,
    {"loss", "delivered_frac"})``.

    worker_axes: the mesh axes whose members act as the paper's workers,
    ('data',), ('pod',) or ('pod', 'data'). A ``pod`` or ``data`` axis
    that is no worker axis splits each worker's batch (module
    docstring); over ``model`` the model runs tensor-parallel on the
    state's blocks (``init_state(..., mesh=)``), each sharded leaf gated
    on its global view (``specs`` of ``ls.masked_psum_leafwise`` and
    ``ls.masked_rs_update_leafwise``); any other axis must have size 1.
    batch_specs: a tree of specs for the GLOBAL batch, which every rank
    passes whole; each takes its block along the worker axes (the other
    axes of a spec are dropped, as the reference restricts them), then
    along the non-worker batch axes. frac: (W,) delivered fraction a
    worker; seed: the step's seed for the delivery draws, or
    ``uniforms``, this rank's worker's per-leaf draws.

    Two variants, chosen as in the reference: the psum variant
    (``ls.masked_psum_leafwise``, then ``opt``), and, when
    ``state.opt_state`` is ``{"m_pkts": [...]}`` (``zero_opt_state``),
    the ZeRO variant (``ls.masked_rs_update_leafwise``: SGD-momentum on
    this worker's packet shard of each global leaf, then the deltas
    all-gathered over the workers in the params' dtype, and this rank's
    block of each added). The loss is the mean over workers of each
    worker's loss on its block."""
    worker_axes = tuple(worker_axes)
    _check_mesh(mesh, worker_axes)
    n_workers = ls.worker_count(mesh, worker_axes)
    inner = tuple(a for a in dp_axes(mesh) if a not in worker_axes)
    ctx = tp_ctx(mesh)
    specs = model_layout(api, mesh)
    nm = axis_size(mesh, "model")

    def local(state: TrainState, batch):
        if state.fsdp is not None:
            raise ValueError("the LTP step keeps the weights whole over "
                             "its workers; an FSDP state is the plain "
                             "step's")
        dev = tree_leaves(state.params)[0].device
        batch = tree_map_with_path(lambda path, x: _block(
            x, _restrict(spec_at(batch_specs, path), worker_axes, inner),
            mesh, dev), batch)
        loss, grads = _mean_loss_and_grads(api, state.params, batch, ctx,
                                           mesh, inner)
        return ls.psum(loss.clone(), mesh, worker_axes) / n_workers, grads

    def zero_finish(state: TrainState, loss, grads, frac, seed, lr,
                    uniforms):
        deltas, m_pkts, realized = ls.masked_rs_update_leafwise(
            grads, state.params, state.opt_state["m_pkts"], seed, frac, ltp,
            mesh, worker_axes, n_workers, lr, uniforms=uniforms,
            specs=specs)
        del grads
        idx = mesh.get_local_rank("model") if nm > 1 else 0
        new_leaves = []
        for i, (path, p) in enumerate(tree_leaves_with_path(state.params)):
            dim = None if specs is None else model_dim(spec_at(specs, path))
            d, deltas[i] = deltas[i], None
            new_leaves.append(_add_delta(
                p, ls.all_gather(d, mesh, worker_axes), dim, nm, idx))
        return (TrainState(tree_unflatten(state.params, new_leaves),
                           {"m_pkts": m_pkts}, state.step + 1),
                {"loss": loss, "delivered_frac": realized})

    def finish(state: TrainState, loss, grads, frac, seed, lr, *,
               uniforms=None):
        if isinstance(state.opt_state, dict) and "m_pkts" in state.opt_state:
            return zero_finish(state, loss, grads, frac, seed, lr, uniforms)
        synced, realized = ls.masked_psum_leafwise(
            grads, seed, frac, ltp, mesh, worker_axes, n_workers,
            uniforms=uniforms, specs=specs)
        updates, opt_state = opt.update(synced, state.opt_state,
                                        state.params, lr)
        return (TrainState(_apply(state.params, updates), opt_state,
                           state.step + 1),
                {"loss": loss, "delivered_frac": realized})

    def step(state: TrainState, batch, frac, seed, lr, *, uniforms=None):
        # no name here holds the gradients, so the ZeRO variant frees
        # them once their packets are scattered
        return finish(state, *local(state, batch), frac, seed, lr,
                      uniforms=uniforms)

    # the two halves, for a caller that counts them apart
    # (``launch/dryrun.py``): ``local(state, batch) -> (loss, grads)``,
    # this rank's loss and gradient; ``finish(state, loss, grads, frac,
    # seed, lr, *, uniforms=None)``, the sync and the update
    step.local, step.finish = local, finish
    return step
