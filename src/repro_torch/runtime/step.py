"""Step machinery for the PS training loop.

The PyTorch counterpart of the JAX package's ``runtime/step.py``: the
fused BSP step (per-worker grads -> ONE masked multi-worker reduction ->
optimizer update), the cluster runtime's apply-on-arrival builders (one
worker's gradient, the per-gradient error-feedback gate, the PS apply
of an admitted batch) and the host-side mask draws.
``draw_delivery_masks`` and ``tile_mask_onto_plan`` are numpy, copied as
they are, so both packages draw the same masks from the same seed.

PyTorch runs eagerly, so nothing here is jit-compiled or cached.

The fused step and the apply open ``record_function`` spans at their
phases' boundaries, once a step or once a chunk of workers, never inside
a per-leaf loop: ``worker_grads`` (one chunk's forward and backward),
then the PS sync path, ``PS_SYNC_SPANS``. A profile attributes each
device operation to the span it was launched in.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.func import grad_and_value, vmap
from torch.profiler import record_function

from repro_torch.config import LTPConfig
from repro_torch.core import ltp_sync as ls
from repro_torch.core import packets as pk
from repro_torch.optim import Optimizer
from repro_torch.tree import tree_leaves, tree_map


# gradient floats that one vmap chunk of the fused step may hold: 3 x 2^29
# (6 GiB). A chunk's activations, grads and their stacked copy take
# several times its grads, and all W = 8 workers of smollm-360m (batch 32
# x seq 128) under one vmap did not fit an 80 GB H100 beside the stream,
# the optimizer moments and the EF residual; 4 at a time peak at 45 GB,
# 61-68 GB with EF (chip_smoke.py, lm line). So a model of more than
# 3 x 2^29 / W floats takes its workers a few at a time, while papernet
# and the example LMs keep one vmap of all W: fewer chunks, fewer
# dispatches.
WORKER_CHUNK_FLOATS = 3 << 29

# the spans of the PS sync path, in the order a step opens them: the
# gradients written into the packet stream, the error-feedback gate, the
# masked reduction, the reduced stream back to leaves, the update
PS_SYNC_SPANS = ("flatten_into", "ef_gate", "reduce_packet_stream",
                 "unflatten", "opt_update")


def worker_chunk(plan, w: int) -> int:
    """Workers one vmap of the fused step takes: as many of the ``w`` as
    fit ``WORKER_CHUNK_FLOATS`` of grads, and at least one."""
    return max(1, min(w, WORKER_CHUNK_FLOATS // plan.n_floats))


def build_fused_step(api, opt: Optimizer, ltp: LTPConfig, plan, w: int,
                     protocol: str):
    """The lockstep/BSP train step: per-worker grads via ``vmap`` (in
    chunks of ``worker_chunk`` workers, written into one stream), one
    fused masked reduction (the ``packet_reduce`` kernel under
    sync_backend="cuda"/"auto" on the card), one optimizer update.
    Signature:

      step(params, opt_state, residual, batch, masks, frac, lr)
        -> (params, opt_state, residual, mean_loss, realized_frac)

    ``batch`` leaves carry the worker axis first: (W, B/W, ...).
    """
    use_ltp = protocol == "ltp"
    chunk = worker_chunk(plan, w)

    def one(params, b):
        return grad_and_value(lambda p: api.loss_fn(p, b))(params)

    per_worker = vmap(one, in_dims=(None, 0))   # (k, ...) grads, (k,) losses

    def grads_stream(params, batch):
        """The (W, n_packets, payload) stream of per-worker grads and the
        (W,) losses: ``chunk`` workers a ``vmap``, each chunk's grads
        written into the stream before the next chunk's are taken."""
        dev = tree_leaves(params)[0].device
        flat_w = torch.empty((w, plan.n_packets, plan.packet_floats),
                             dtype=torch.float32, device=dev)
        losses = []
        for a in range(0, w, chunk):
            with record_function("worker_grads"):
                grads, loss = per_worker(
                    params, {k: v[a:a + chunk] for k, v in batch.items()})
            with record_function("flatten_into"):
                pk.flatten_into(plan, grads, flat_w[a:a + chunk])
            losses.append(loss)
            del grads
        return flat_w, torch.cat(losses)

    def step(params, opt_state, residual, batch, masks, frac, lr):
        flat_w, losses = grads_stream(params, batch)
        if use_ltp:
            # the PS hot loop: ONE fused masked multi-worker reduction
            sent, premasked, new_residual = flat_w, False, None
            if residual is not None:
                # error feedback materializes the gated stream anyway —
                # gate once (one dropfill pass under cuda), reduce the
                # result
                rows = (w * plan.n_packets, plan.packet_floats)
                with record_function("ef_gate"):
                    sent, new_residual = ls.apply_delivery_ef(
                        flat_w.reshape(rows), residual.reshape(rows),
                        masks.reshape(-1), backend=ltp.sync_backend)
                sent, premasked = sent.reshape(flat_w.shape), True
                new_residual = new_residual.reshape(flat_w.shape)
            with record_function("reduce_packet_stream"):
                mean_flat = ls.reduce_packet_stream(
                    sent, masks, ltp, w, expected_frac=frac,
                    premasked=premasked)
            realized = masks.mean()
        else:
            # lossless: the PS's reduction is the plain mean
            with record_function("reduce_packet_stream"):
                mean_flat = flat_w.mean(dim=0)
            new_residual = residual
            realized = torch.ones((), device=flat_w.device)
        params, opt_state = _ps_update(opt, plan, params, opt_state,
                                       mean_flat, lr)
        return params, opt_state, new_residual, losses.mean(), realized

    return step


def _ps_update(opt: Optimizer, plan, params, opt_state, mean_flat, lr):
    """The PS's update from the reduced stream, the tail of the fused
    step and of the apply -> (params, opt_state)."""
    dtypes = [x.dtype for x in tree_leaves(params)]
    with record_function("unflatten"):
        mean_grads = pk.unflatten(plan, mean_flat, dtypes)
    with record_function("opt_update"):
        updates, opt_state = opt.update(mean_grads, opt_state, params, lr)
        params = tree_map(lambda p, u: p + u, params, updates)
    return params, opt_state


def build_worker_grad_fn(api, plan):
    """One worker's gradient against ITS OWN params snapshot (the
    async/SSP compute leg): (params, batch_slice) -> (loss, flat packets
    of shape (n_packets, packet_floats))."""

    def grad_fn(params, batch):
        grads, loss = grad_and_value(lambda p: api.loss_fn(p, batch))(params)
        return loss, pk.flatten(plan, grads)

    return grad_fn


def build_ef_gate_fn(ltp: LTPConfig):
    """Error-feedback gate for the per-gradient path: accumulate what the
    network dropped, re-add it next round (EF-SGD, DESIGN.md §2). Under
    sync_backend="cuda"/"auto" on the card the gate is one pass of the
    ``dropfill`` kernel's EF form at (n_packets, packet_floats)."""

    def gate(flat, residual, mask):
        with record_function("ef_gate"):
            return ls.apply_delivery_ef(flat, residual, mask,
                                        backend=ltp.sync_backend)

    return gate


def build_apply_fn(api, opt: Optimizer, ltp: LTPConfig, plan, w: int,
                   premasked: bool = False):
    """PS-side apply for an admitted batch of gradients (async/SSP).

    (params, opt_state, stacked (W, n, p), masks (W, n), weights (W,),
     frac, lr) -> (params, opt_state).

    The reduction divides by the cluster size ``w`` regardless of how
    many gradients the batch holds (zero-weight rows contribute nothing),
    so each admitted gradient lands with effective step lr * weight / W —
    the same per-contribution scale as one BSP iteration. ``weights``
    carries the policy's staleness damping (``ls.staleness_weights``).
    Note: under "count" compensation the per-packet deliverer count is
    taken within the admitted batch.
    """

    def apply(params, opt_state, stacked, masks, weights, frac, lr):
        with record_function("reduce_packet_stream"):
            mean_flat = ls.reduce_packet_stream(
                stacked, masks, ltp, w, expected_frac=frac,
                worker_weights=weights, premasked=premasked)
        return _ps_update(opt, plan, params, opt_state, mean_flat, lr)

    return apply


def draw_delivery_masks(plan, w: int, rng: np.random.Generator,
                        frac: np.ndarray,
                        mask_trace: np.ndarray = None,
                        it: int = 0) -> np.ndarray:
    """(W, n_packets) float32 per-(worker, packet) delivery mask.

    From the DES ``mask_trace`` when given (the trace's packet stream is
    tiled/cropped onto the plan's packets), else Bernoulli(frac) per
    packet. Critical packets are always pinned to 1 — the CQ retransmit
    guarantee (paper §III-E).
    """
    n = plan.n_packets
    if mask_trace is not None:
        m = mask_trace[it % len(mask_trace)]
        reps = -(-n // m.shape[1])
        m = np.tile(m, (1, reps))[:, :n].astype(np.float32)
    else:
        m = (rng.random((w, n)) < np.asarray(frac)[:, None]).astype(np.float32)
    m[:, plan.critical] = 1.0
    return m


def tile_mask_onto_plan(plan, mask_row: np.ndarray) -> np.ndarray:
    """(n_transport_pkts,) bool -> (plan.n_packets,) float32, tiled/cropped
    with criticals pinned — one worker's DES delivery state mapped onto
    the packet plan the aggregation kernels consume."""
    n = plan.n_packets
    reps = -(-n // len(mask_row))
    m = np.tile(mask_row, reps)[:n].astype(np.float32)
    m[plan.critical] = 1.0
    return m
