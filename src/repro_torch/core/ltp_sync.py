"""Loss-tolerant gradient synchronization: the PS host path.

The PyTorch counterpart of the host half of the JAX package's
``core/ltp_sync.py``. During *gathering*, each worker's gradient is
packetized; non-critical packets are delivered with the Early-Close-
controlled fraction; lost packets are bubble-filled with zeros at the
PS. *Broadcasting* (the reduced result) is reliable.

Compensation modes (beyond-paper, DESIGN.md §2):
  paper     sum/W             (plain mean with zero bubbles — the paper)
  count     sum/count         (per-packet unbiased mean over deliverers)
  expected  sum/(W*E[frac])   (global rescale)

Aggregation backends: ``apply_delivery`` / ``apply_delivery_ef`` /
``reduce_packet_stream`` dispatch on ``LTPConfig.sync_backend``.
``python`` is the plain torch reference; ``cuda`` runs the hand-written
``kernels.dropfill`` (both forms) / ``kernels.packet_reduce`` (their
plain version for a CPU tensor);
``auto`` is ``cuda`` for a CUDA tensor and ``python`` for a CPU tensor,
until an H100 measurement gives a crossover size.

The sharded half (``LTPSync``, ``masked_psum_leafwise``,
``masked_rs_update_leafwise``) runs over ``torch.distributed``: one rank
is one worker, or one worker's ``model`` shard. A rank's worker index is
its row-major coordinate over the worker axes of a ``DeviceMesh``
(``pod``, ``data``); ``dist.all_reduce`` over the axes' groups stands for
``psum``, ``dist.reduce_scatter_tensor`` for ``psum_scatter(tiled=True)``
and ``dist.all_gather_into_tensor`` for the delta all-gather. A rank
passes its own block of the gradients and gets its block back.

Delivery draws come from a ``torch.Generator`` on the gradients' device,
seeded from (``seed``, worker index, model index, leaf index): the same
``seed`` gives another run than the JAX package's keys, by design. Every
sharded function takes ``uniforms=`` (its rank's draws) instead, and
then agrees with the reference given the reference's draws.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.config import LTPConfig
from repro_torch.core import packets as pk
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.models.sharding import (
    all_gather_dim,
    axis_size,
    block_of,
    dp_axes,
    mesh_shape,
    model_dim,
    reduce_scatter_dim,
    spec_at,
)
from repro_torch.tree import tree_leaves, tree_leaves_with_path, \
    tree_unflatten

BACKENDS = ("python", "cuda", "auto")


def resolve_backend(backend: str, x: torch.Tensor) -> str:
    """Resolve ``"auto"`` for tensor ``x``: ``cuda`` on a CUDA device,
    ``python`` elsewhere; explicit backends pass through."""
    if backend not in BACKENDS:
        raise ValueError(f"sync_backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    if backend != "auto":
        return backend
    return "cuda" if x.device.type == "cuda" else "python"


def apply_delivery(packets: torch.Tensor, mask: torch.Tensor,
                   scale: Optional[torch.Tensor] = None, *,
                   backend: str = "python") -> torch.Tensor:
    """Bubble-fill + compensation gate: ``packets * mask * scale``.

    packets: (n_packets, payload); mask/scale: (n_packets,). The cuda
    backend runs ``kernels.dropfill``.
    """
    backend = resolve_backend(backend, packets)
    gate = mask if scale is None else mask * scale
    if backend == "cuda":
        return kops.ltp_dropfill(packets, gate)
    return packets * gate[:, None].to(packets.dtype)


def apply_delivery_ef(flat: torch.Tensor, residual: torch.Tensor,
                      mask: torch.Tensor, *, backend: str = "python"):
    """The error-feedback gate (EF-SGD, DESIGN.md §2): re-add what the
    network dropped last round, gate, keep what it drops now.

    flat, residual: (n_packets, payload); mask: (n_packets,) {0,1}.
    Returns fresh ``(sent, new_residual)``; ``residual`` is never written
    (a PS snapshot holds it by reference). The python backend is the
    three torch ops of the JAX gate; the cuda backend runs them as one
    pass of ``kernels.dropfill``'s EF form, bit for bit the same in
    float32.
    """
    backend = resolve_backend(backend, flat)
    if backend == "cuda":
        return kops.ltp_dropfill_ef(flat, residual, mask)
    s = flat + residual
    sent = apply_delivery(s, mask, backend="python")
    return sent, s - sent


def staleness_weights(staleness, damping: float) -> np.ndarray:
    """(W,) contribution weights for gradients ``staleness`` iterations
    old: 1 / (1 + damping * s) — the staleness-aware damping fed to
    ``reduce_packet_stream`` as ``worker_weights`` (DESIGN.md §8). 0
    gives the identity (every admitted gradient weighs 1)."""
    s = np.asarray(staleness, np.float32)
    return 1.0 / (1.0 + float(damping) * np.maximum(s, 0.0))


def _mean_frac(masks_w: torch.Tensor, expected_frac) -> torch.Tensor:
    if expected_frac is None:
        return masks_w.mean()
    return torch.as_tensor(expected_frac, dtype=torch.float32,
                           device=masks_w.device).mean()


def reduce_packet_stream(packets_w: torch.Tensor, masks_w: torch.Tensor,
                         ltp: LTPConfig, n_workers: int, *,
                         expected_frac=None, backend: Optional[str] = None,
                         premasked: bool = False,
                         worker_weights=None) -> torch.Tensor:
    """The PS-side hot loop: one fused masked multi-worker reduction.

    packets_w: (W, n_packets, payload); masks_w: (W, n_packets) {0,1}.
    Returns the (n_packets, payload) float32 compensated mean under
    ``ltp.compensation`` (paper | count | expected; ``expected`` uses
    ``expected_frac``, the Early-Close target fraction, else the mean
    mask).

    backend="cuda" runs ``kernels.packet_reduce``: the worker loop runs
    inside each thread, so each input element is read once and each
    output written once. backend="python" is the reference.

    ``premasked=True`` declares that ``packets_w`` has already been gated
    by ``masks_w`` (the error-feedback path): the python backend skips
    the multiply; the kernel re-applies the {0,1} mask, which is
    idempotent.

    ``worker_weights`` ((W,) float, optional) damps each worker's
    contribution (DESIGN.md §8); the stream is pre-scaled before the
    reduction, so it composes with every compensation mode and backend.
    """
    backend = resolve_backend(backend or ltp.sync_backend, packets_w)
    comp = ltp.compensation
    if worker_weights is not None:
        w_ = torch.as_tensor(worker_weights, dtype=torch.float32,
                             device=packets_w.device)
        packets_w = packets_w * w_[:, None, None]
    if backend == "cuda":
        out = kops.ltp_packet_reduce(
            packets_w, masks_w,
            compensation="count" if comp == "count" else "paper")
        if comp == "expected":
            # paper-mode output is sum/W; expected = sum/(W*E[frac])
            out = out / torch.clamp(_mean_frac(masks_w, expected_frac),
                                    min=1e-6)
        return out
    masks_w = masks_w.to(torch.float32)
    gated = (packets_w.to(torch.float32) if premasked
             else packets_w.to(torch.float32) * masks_w[:, :, None])
    tot = gated.sum(dim=0)
    if comp == "count":
        cnt = torch.clamp(masks_w.sum(dim=0), min=1.0)
        return tot / cnt[:, None]
    if comp == "expected":
        ef = _mean_frac(masks_w, expected_frac)
        return tot / (n_workers * torch.clamp(ef, min=1e-6))
    return tot / n_workers


# ----------------------------------------------------------------------------
# the sharded path: collectives over the worker axes of a DeviceMesh
# ----------------------------------------------------------------------------


def worker_index(mesh, axes: Sequence[str]) -> int:
    """This rank's row-major coordinate over ``axes`` of ``mesh`` (the
    reference's ``axis_index`` fold over (pod, data))."""
    idx = 0
    for a in axes:
        idx = idx * axis_size(mesh, a) + mesh.get_local_rank(a)
    return idx


def worker_count(mesh, axes: Sequence[str]) -> int:
    """The number of workers over ``axes`` of ``mesh``."""
    n = 1
    for a in axes:
        n *= axis_size(mesh, a)
    return n


def psum(t: torch.Tensor, mesh, axes: Sequence[str]) -> torch.Tensor:
    """Sum ``t`` over the ranks that differ only in ``axes``, in place
    (one ``all_reduce`` an axis of size > 1) and return it."""
    for a in axes:
        if axis_size(mesh, a) > 1:
            dist.all_reduce(t, group=mesh.get_group(a))
    return t


def psum_scatter(t: torch.Tensor, mesh,
                 axes: Sequence[str]) -> torch.Tensor:
    """``psum_scatter(t, axes, scatter_dimension=0, tiled=True)``: the sum
    over ``axes``, of which this rank keeps block ``worker_index`` of dim
    0 (one ``reduce_scatter_tensor`` an axis of size > 1, the first axis
    outermost)."""
    for a in axes:
        n = axis_size(mesh, a)
        if n > 1:
            t = reduce_scatter_dim(t, mesh.get_group(a), n, 0)
    return t


def all_gather(t: torch.Tensor, mesh, axes: Sequence[str]) -> torch.Tensor:
    """The inverse of ``psum_scatter``'s split: the blocks of every rank
    over ``axes``, concatenated on dim 0 in worker-index order (one
    ``all_gather_into_tensor`` an axis of size > 1)."""
    for a in reversed(tuple(axes)):
        n = axis_size(mesh, a)
        if n > 1:
            t = all_gather_dim(t, mesh.get_group(a), n, 0)
    return t


def device_uniforms(n: int, device, seed: int, *coords: int) -> torch.Tensor:
    """(n,) float32 uniforms on ``device`` from a ``torch.Generator``
    seeded from (``seed``, ``*coords``)."""
    words = np.random.SeedSequence([int(seed), *map(int, coords)]) \
        .generate_state(2, np.uint32)
    gen = torch.Generator(device=device)
    gen.manual_seed((int(words[0]) << 31) ^ int(words[1]))
    return torch.rand(n, generator=gen, device=device)


def _f32(x, device) -> torch.Tensor:
    """``x`` (a tensor, an array or a sequence) as float32 on ``device``;
    arrays are copied (a read-only numpy array cannot back a tensor)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.tensor(np.asarray(x, np.float32), device=device)


def _frac_of(frac, widx: int, device) -> torch.Tensor:
    return _f32(frac, device)[widx]


def _n_pkts(shape, p: int) -> int:
    size = int(np.prod(shape)) if len(shape) else 1
    return max(1, -(-size // p))


def _share(mask: torch.Tensor) -> torch.Tensor:
    """The share of a {0,1} float32 mask's packets that are kept, as
    float32: its exact sum over its length in float64, which rounds to
    the correctly rounded float32 quotient on every device. A float32
    ``mean`` (or a division by a Python number) on CUDA multiplies by the
    reciprocal and can differ from the CPU's in the last bit."""
    return (mask.sum(dtype=torch.float64) / mask.numel()).to(torch.float32)


def _leaf_packet_mask(leaf_shape, u: torch.Tensor, frac: torch.Tensor,
                      ltp: LTPConfig) -> torch.Tensor:
    """(n_pkts,) float32 delivery mask of one leaf from its uniforms
    ``u``. The critical pins are the reference's ``crit[:c]`` and
    ``crit[-c:]``: with ``critical_per_tensor = 0`` the second is every
    packet (``crit[-0:]``), a quirk kept as it is."""
    n_pkts = _n_pkts(leaf_shape, ltp.packet_floats)
    if tuple(u.shape) != (n_pkts,):
        raise ValueError(f"uniforms of shape {(n_pkts,)} expected, got "
                         f"{tuple(u.shape)}")
    crit = np.zeros(n_pkts, bool)
    c = ltp.critical_per_tensor
    crit[:c] = True
    crit[-c:] = True
    keep = (u < frac).to(torch.float32)
    return torch.where(torch.as_tensor(crit, device=u.device),
                       torch.ones_like(keep), keep)


def _as_packets(leaf: torch.Tensor, p: int) -> torch.Tensor:
    """Row-major (n_pkts, p) float32 view of a leaf (zero-padded tail; a
    float32 leaf of whole packets is not copied, and no caller writes
    into the view)."""
    size = leaf.numel()
    n_pkts = max(1, -(-size // p))
    flat = leaf.to(torch.float32).reshape(-1)
    pad = n_pkts * p - size
    if pad:
        flat = torch.cat([flat, flat.new_zeros((pad,))])
    return flat.view(n_pkts, p)


def _from_packets(pkts: torch.Tensor, shape, dtype) -> torch.Tensor:
    size = int(np.prod(shape)) if len(shape) else 1
    return pkts.reshape(-1)[:size].reshape(tuple(shape)).to(dtype)


def _leaf_uniforms(uniforms, i: int, shape, ltp: LTPConfig, device,
                   seed: int, widx: int) -> torch.Tensor:
    """Leaf ``i``'s draws: ``uniforms[i]``, else from (``seed``, worker,
    model 0, leaf ``i``)."""
    if uniforms is not None:
        return _f32(uniforms[i], device)
    return device_uniforms(_n_pkts(shape, ltp.packet_floats), device, seed,
                           widx, 0, i)


def leafwise_packet_masks(grads, seed: int, frac, ltp: LTPConfig, *,
                          worker: int = 0, uniforms=None):
    """Per-leaf packet delivery masks, broadcast to element space.

    Packets are spans of ``ltp.packet_floats`` contiguous elements in each
    leaf's row-major layout (per-leaf streams). ``frac`` is this worker's
    delivered fraction (a scalar); ``uniforms`` its per-leaf draws, else
    drawn from (``seed``, ``worker``, 0, leaf index).

    Returns (masks tree matching grads, packet_masks list)."""
    leaves = tree_leaves(grads)
    masks, pkt_masks = [], []
    p = ltp.packet_floats
    for i, leaf in enumerate(leaves):
        u = _leaf_uniforms(uniforms, i, leaf.shape, ltp, leaf.device, seed,
                           worker)
        m = _leaf_packet_mask(leaf.shape, u, _f32(frac, leaf.device), ltp)
        pkt_masks.append(m)
        view = _as_packets(torch.ones_like(leaf, dtype=torch.float32), p) \
            * m[:, None]
        masks.append(_from_packets(view, leaf.shape, torch.float32))
    return tree_unflatten(grads, masks), pkt_masks


def _global_leaf(leaf: torch.Tensor, path, specs, mesh):
    """``leaf`` all-gathered over ``model`` where ``specs``
    (``sharding.model_specs``) shards it, and the dim it was split on
    (``None``: the leaf as it is)."""
    dim = None if specs is None else model_dim(spec_at(specs, path))
    if dim is not None:
        leaf = all_gather_dim(leaf, mesh.get_group("model"),
                              axis_size(mesh, "model"), dim)
    return leaf, dim


def masked_psum_leafwise(grads, seed: int, frac, ltp: LTPConfig, mesh,
                         worker_axes: Sequence[str], n_workers: int, *,
                         uniforms=None, specs=None):
    """Sharded LTP sync (v2, per-leaf packets): this rank's gradient tree
    in, the synced tree (every rank the same) and the realized delivered
    fraction out.

    Per leaf: the delivery mask from this worker's draws and
    ``frac[worker_index]``; the gate ``apply_delivery`` on
    ``ltp.sync_backend`` (one ``ltp_dropfill`` launch under ``cuda``);
    an f32 ``all_reduce`` over the worker axes; then the compensation:

      paper     sum / W
      count     sum / max(count, 1), the count an ``all_reduce`` of the
                masks (a division, as in the reference; only ``LTPSync``
                compensates through a second gate)
      expected  sum / (W * mean(frac)): the mean of ``frac`` alone,
                where ``LTPSync`` takes the critical-aware mean (the
                reference's own difference)

    ``realized`` is the all-worker mean of the FIRST leaf's mask alone,
    as in the reference. ``uniforms``: this rank's per-leaf draws (a list
    of (n_pkts,) arrays), else drawn from (``seed``, worker, 0, leaf).

    ``specs`` (``sharding.model_specs``): with tensor parallelism, the
    layout of this rank's blocks. The masks are defined on the GLOBAL
    leaf's packets, which a block split on a column dim does not tile,
    so each sharded leaf is all-gathered over ``model``, gated and summed
    whole, and this rank keeps its block; one gathered leaf is alive at
    a time. Every model rank of a worker draws the same masks (the draws
    fold the worker index alone, as the reference's key does), and
    ``uniforms`` then holds the global leaves' draws."""
    widx = worker_index(mesh, worker_axes)
    p = ltp.packet_floats
    paths = tree_leaves_with_path(grads)
    dev = paths[0][1].device
    fw = _frac_of(frac, widx, dev)
    nm = axis_size(mesh, "model")
    out = []
    realized = None
    for i, (path, leaf) in enumerate(paths):
        leaf, dim = _global_leaf(leaf, path, specs, mesh)
        u = _leaf_uniforms(uniforms, i, leaf.shape, ltp, dev, seed, widx)
        m = _leaf_packet_mask(leaf.shape, u, fw, ltp)
        shape, dtype = leaf.shape, leaf.dtype
        view = _as_packets(leaf, p)
        del leaf
        view = apply_delivery(view, m, backend=ltp.sync_backend)
        # one f32 all-reduce a leaf, as the reference psums each leaf
        tot = psum(view, mesh, worker_axes)
        del view
        if ltp.compensation == "count":
            cnt = psum(m.clone(), mesh, worker_axes)
            tot = tot / torch.clamp(cnt, min=1.0)[:, None]
        elif ltp.compensation == "expected":
            mean_frac = _f32(frac, dev).mean()
            tot = tot / (n_workers * torch.clamp(mean_frac, min=1e-6))
        else:  # paper
            tot = tot / n_workers
        synced = _from_packets(tot, shape, dtype)
        del tot
        if dim is not None:
            synced = block_of(synced, dim, nm,
                             mesh.get_local_rank("model")).contiguous()
        out.append(synced)
        if realized is None:
            realized = psum(_share(m), mesh, worker_axes) / n_workers
    return tree_unflatten(grads, out), realized


def masked_rs_update_leafwise(grads, params, m_states: List[torch.Tensor],
                              seed: int, frac, ltp: LTPConfig, mesh,
                              worker_axes: Sequence[str], n_workers: int,
                              lr, momentum: float = 0.9, *, uniforms=None,
                              specs=None):
    """ZeRO-style LTP sync (beyond-paper): per-worker packet masking,
    then ``psum_scatter`` in packet space (each worker owns 1/W of each
    leaf's packet stream, a sharded PS), SGD-momentum on the local
    shard, and the delta in the parameter dtype.

    Each leaf's stream is padded to a multiple of W packets and masked
    with the plain multiply, as the reference masks it here (no kernel).
    ``m_states``: this rank's (n_pkts_padW / W, p) f32 momentum shards,
    one a leaf. Returns (delta shards in each param's dtype, new
    momentum shards, realized); the caller all-gathers the deltas
    (``all_gather``) and adds them. ``realized`` comes from the first
    leaf alone, as in the reference.

    ``specs`` (``sharding.model_specs``): with tensor parallelism, the
    layout of this rank's gradient blocks. As in
    ``masked_psum_leafwise``, each sharded leaf is all-gathered over
    ``model`` and its packets are the GLOBAL leaf's (one gathered leaf
    alive at a time), so ``m_states`` and the deltas are the global
    leaves' packet shards, the same on every model rank of a worker,
    and ``uniforms`` holds the global leaves' draws."""
    widx = worker_index(mesh, worker_axes)
    p = ltp.packet_floats
    paths = tree_leaves_with_path(grads)
    p_leaves = tree_leaves(params)
    dev = paths[0][1].device
    fw = _frac_of(frac, widx, dev)
    deltas, new_m = [], []
    realized = None
    for i, ((path, gleaf), pleaf) in enumerate(zip(paths, p_leaves,
                                                   strict=True)):
        gleaf, _ = _global_leaf(gleaf, path, specs, mesh)
        u = _leaf_uniforms(uniforms, i, gleaf.shape, ltp, dev, seed, widx)
        m = _leaf_packet_mask(gleaf.shape, u, fw, ltp)
        view = _as_packets(gleaf, p)
        del gleaf
        padw = (-view.shape[0]) % n_workers
        if padw:
            view = torch.cat([view, view.new_zeros((padw, p))])
            m = torch.cat([m, m.new_zeros((padw,))])
        shard = psum_scatter(view * m[:, None], mesh, worker_axes)
        del view
        if ltp.compensation == "count":
            cnt = psum_scatter(m, mesh, worker_axes)
            shard = shard / torch.clamp(cnt, min=1.0)[:, None]
        else:
            shard = shard / n_workers
        m_new = momentum * m_states[i] + shard
        deltas.append((-lr * m_new).to(pleaf.dtype))
        new_m.append(m_new)
        if realized is None:
            realized = psum(_share(m), mesh, worker_axes) / n_workers
    return deltas, new_m, realized


def zero_momentum_shapes(params_shape, ltp: LTPConfig,
                         n_workers: int) -> List[Tuple[int, int]]:
    """Global shapes of the packet-space momentum buffers, (n_pkts padded
    to a multiple of W, p) a leaf; each rank holds rows
    [w * n / W, (w + 1) * n / W) of each."""
    out = []
    for leaf in tree_leaves(params_shape):
        n_pkts = _n_pkts(tuple(leaf.shape), ltp.packet_floats)
        n_pkts += (-n_pkts) % n_workers
        out.append((n_pkts, ltp.packet_floats))
    return out


@dataclasses.dataclass(frozen=True)
class LTPSync:
    """Callable gradient synchronizer bound to (mesh, plan, config): the
    reference's ``LTPSync`` with one rank a device. ``plan`` is the
    packet plan of a rank's LOCAL block of the gradients
    (``packets.local_plan``)."""

    mesh: Any
    plan: pk.PacketPlan
    ltp: LTPConfig
    grad_specs: Any          # tree of specs matching grads
    n_workers: int

    def residual_spec(self):
        """Global residual shape (W, nm, n_packets, packet_floats) and its
        spec; a rank holds its (1, 1, n_packets, packet_floats) block."""
        dp = dp_axes(self.mesh)
        has_model = "model" in mesh_shape(self.mesh)
        nm = axis_size(self.mesh, "model")
        shape = (self.n_workers, nm, self.plan.n_packets,
                 self.plan.packet_floats)
        spec = (dp if len(dp) > 1 else (dp[0] if dp else None),
                "model" if has_model else None, None, None)
        return shape, spec

    def init_residual(self, device: DeviceLike = None):
        """This rank's zero residual block with error feedback, else None
        (``None`` device means ``cuda``)."""
        if not self.ltp.error_feedback:
            return None
        return torch.zeros((1, 1, self.plan.n_packets,
                            self.plan.packet_floats), dtype=torch.float32,
                           device=resolve_device(device))

    def __call__(self, grads, frac, seed: int, residual=None, *,
                 uniforms=None):
        """grads: this rank's block of the gradient tree (per
        ``grad_specs``); frac: (W,) delivered fraction a worker; seed: the
        step's seed; residual: this rank's residual block (error
        feedback).

        Returns (synced block, new residual block, stats), stats holding
        the realized delivered fraction. The draws come from (``seed``,
        worker index, model index), the model coordinate folded in as the
        reference folds ``axis_index("model")``, or from ``uniforms``,
        this rank's (n_packets,) draws. Compensation: paper sum/W; count
        through the gate with scale 1/max(count, 1); expected sum / (W *
        mean over packets of (1 if critical else mean(frac))), the
        critical-aware mean."""
        mesh, plan, ltp = self.mesh, self.plan, self.ltp
        dp = dp_axes(mesh)
        W = self.n_workers
        leaves = tree_leaves(grads)
        leaf_dtypes = [x.dtype for x in leaves]
        dev = leaves[0].device
        widx = worker_index(mesh, dp)
        midx = (mesh.get_local_rank("model")
                if "model" in mesh_shape(mesh) else 0)
        if uniforms is not None:
            u = _f32(uniforms, dev)
        else:
            u = device_uniforms(plan.n_packets, dev, seed, widx, midx)
        crit = torch.as_tensor(plan.critical, device=dev)
        keep = (u < _frac_of(frac, widx, dev)).to(torch.float32)
        mask = torch.where(crit, torch.ones_like(keep), keep)
        flat = pk.flatten(plan, grads)
        if residual is not None:
            sent, new_res = apply_delivery_ef(
                flat, residual.reshape(flat.shape), mask,
                backend=ltp.sync_backend)
            new_res = new_res.reshape(residual.shape)
        else:
            sent = apply_delivery(flat, mask, backend=ltp.sync_backend)
            new_res = None
        tot = psum(sent, mesh, dp)
        if ltp.compensation == "count":
            cnt = psum(mask.clone(), mesh, dp)
            out = apply_delivery(tot, torch.ones_like(cnt),
                                 1.0 / torch.clamp(cnt, min=1.0),
                                 backend=ltp.sync_backend)
        elif ltp.compensation == "expected":
            mean_frac = torch.where(crit, 1.0,
                                    _f32(frac, dev).mean()).mean()
            out = tot / (W * mean_frac)
        else:  # paper
            out = tot / W
        realized = psum(_share(mask), mesh, dp) / W
        return (pk.unflatten(plan, out, leaf_dtypes), new_res,
                {"delivered_frac": realized})


def make_ltp_sync(params_shape, mesh, ltp: LTPConfig,
                  grad_specs) -> LTPSync:
    """Build an LTPSync from a params (shape-)tree, global shapes, and its
    sharding specs (``models.sharding.param_specs``)."""
    plan = pk.local_plan(
        params_shape, grad_specs, mesh,
        packet_floats=ltp.packet_floats,
        critical_per_tensor=ltp.critical_per_tensor,
    )
    return LTPSync(mesh=mesh, plan=plan, ltp=ltp, grad_specs=grad_specs,
                   n_workers=worker_count(mesh, dp_axes(mesh)))
