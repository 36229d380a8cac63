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

``LTPSync`` and the leafwise sharded functions wait for the port of the
sharded path (ROADMAP.md, queue 1 item 13).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.config import LTPConfig
from repro_torch.kernels import ops as kops

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
