"""Config system for the LTP reproduction framework (PyTorch port).

The JAX package's ``config.py`` cut to the fields this port reads.
``sync_backend`` takes ``python | cuda | auto`` and defaults to
``"auto"``; ``kernel_interpret`` is gone (a CUDA kernel has no
interpret mode). Plain dataclasses (no external deps). Every
architecture is described by a ``ModelConfig``; the transport/protocol
knobs live in ``NetConfig`` and ``LTPConfig``; training in
``TrainConfig``. The mesh, fault, run, runtime and observability
configs, and the fields only the cluster runtime reads (staleness
damping, the wire-format sizes), come with the slices that read them
(ROADMAP.md, queue 1).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Optional


@dataclass(frozen=True)
class ModelConfig:
    """Architecture description: the fields the ported model families
    read. The JAX package's transformer, MoE, SSM and MLA fields come
    with the slices that port those families (ROADMAP.md, queue 1)."""

    name: str
    family: str                      # cnn (the only family ported so far)
    n_layers: int
    d_model: int
    vocab: int                       # classes for the cnn family
    source: str = ""                 # citation

    def replace(self, **kw: Any) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class LTPConfig:
    """Paper knobs (§III). Defaults follow the paper where it gives numbers."""

    packet_floats: int = 360         # payload floats, float-aligned (padding bubble)
    data_pct_threshold: float = 0.8  # Early Close received-data percentage
    lt_init_rtprop_mult: float = 1.5 # LTThreshold_init = 1.5*RTprop + Size/BtlBw
    deadline_c_ms: float = 30.0      # C: 30ms DCN / 100ms WAN
    compensation: str = "paper"      # paper | count | expected
    # Phase-aware loss tolerance (beyond-paper, DESIGN.md §3.3): the
    # effective received-pct threshold ramps linearly from
    # ``data_pct_threshold`` at training progress 0 to this value at
    # progress 1 (late training tolerates less gradient loss). None
    # disables the ramp — the paper's fixed threshold.
    phase_final_pct_threshold: Optional[float] = None
    error_feedback: bool = False     # beyond-paper
    critical_per_tensor: int = 1     # first/last packet(s) of each tensor marked critical
    # PS-side aggregation backend: "python" is the plain torch
    # reference; "cuda" routes the bubble-fill + masked multi-worker
    # reduction through the hand-written kernels in
    # ``repro_torch.kernels`` (their plain version for CPU tensors);
    # "auto" is "cuda" for CUDA tensors and "python" for CPU tensors
    # until an H100 measurement gives a crossover size.
    sync_backend: str = "auto"       # python | cuda | auto


@dataclass(frozen=True)
class NetConfig:
    """Simulated physical network (per-link). ``queue_pkts`` and
    ``mtu_bytes`` are read only by the packet-level transport, which
    comes with the cluster-runtime slice; they stay so that the
    positional form ``NetConfig(10, 1, 0.001, 4096)`` means what it
    means in the JAX package."""

    bandwidth_gbps: float = 10.0
    rtprop_ms: float = 1.0
    loss_rate: float = 0.0           # non-congestion random loss
    queue_pkts: int = 256            # droptail switch queue
    mtu_bytes: int = 1500


@dataclass(frozen=True)
class TrainConfig:
    batch: int = 32
    lr: float = 0.1
    momentum: float = 0.9
    weight_decay: float = 0.0
    optimizer: str = "sgdm"          # sgdm | adamw
    steps: int = 100
    lr_decay_every: int = 0          # epochs; paper: x0.8 every 10 epochs
    lr_decay: float = 0.8
