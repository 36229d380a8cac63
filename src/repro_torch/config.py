"""Config system for the LTP reproduction framework (PyTorch port).

The JAX package's ``config.py`` cut to the fields this port reads, apart
from ``ModelConfig``, which carries every field so that each model
family's port finds its knobs there. ``sync_backend`` takes ``python |
cuda | auto`` and defaults to ``"auto"``; ``kernel_interpret`` is gone
(a CUDA kernel has no interpret mode). Plain dataclasses (no external
deps). Every architecture is described by a ``ModelConfig``; the
transport/protocol knobs live in ``NetConfig`` and ``LTPConfig``;
training in ``TrainConfig``; the cluster runtime's knobs in
``RuntimeConfig`` (overlaid on ``LTPConfig``), ``ObservabilityConfig``
and ``FaultConfig``; the network fault plane's in ``NetFaultConfig``.
The mesh and run configs come with the slices that read them
(ROADMAP.md, queue 1). The JAX package's ``LTPConfig.mtu_bytes``,
``header_bytes`` and ``udp_ip_overhead`` are read by neither package:
the senders size packets with their own constants (``net/senders.py``:
``MSS``, ``LTP_PAYLOAD``), so the port leaves them out.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Optional, Tuple


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclass(frozen=True)
class ModelConfig:
    """Architecture description, every field of the JAX package's.

    ``block_pattern`` drives the per-layer mixer choice; it is tiled to
    ``n_layers``.  Codes: 'A' full attention, 'W' sliding-window attention,
    'M' mamba1, 'M2' mamba2, 'L' MLA (deepseek latent attention).
    """

    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio | cnn
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: int = 0                # 0 -> d_model // n_heads
    block_pattern: Tuple[str, ...] = ("A",)
    window: int = 0                  # sliding window size for 'W' layers
    rope_theta: float = 1e4
    qk_norm: bool = False
    tie_embeddings: bool = False
    # --- MoE ---
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0                # per-expert hidden (d_ff used if 0)
    first_dense_layers: int = 0      # leading dense layers before MoE starts
    # --- SSM (mamba) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_heads: int = 0               # mamba2 heads (d_inner // head size)
    # --- MLA (deepseek) ---
    kv_lora: int = 0
    q_lora: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    # --- hybrid (zamba2): shared attention block every N mixer layers ---
    shared_attn_every: int = 0
    # --- enc-dec (whisper) ---
    encoder_layers: int = 0
    encoder_frames: int = 0          # stubbed conv-frontend output length
    # --- vlm (qwen2-vl) ---
    vision_patches: int = 0          # stubbed ViT output length
    mrope_sections: Tuple[int, ...] = ()
    # --- misc ---
    norm_type: str = "rms"           # rms | ln
    mlp_type: str = "swiglu"         # swiglu | gelu
    pos_type: str = "rope"           # rope | mrope | learned | none
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    source: str = ""                 # citation

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def vocab_padded(self) -> int:
        return _round_up(self.vocab, 128)

    @property
    def pattern_layers(self) -> Tuple[str, ...]:
        """Per-layer mixer codes, length n_layers."""
        reps = (self.n_layers + len(self.block_pattern) - 1) // len(self.block_pattern)
        return (self.block_pattern * reps)[: self.n_layers]

    def replace(self, **kw: Any) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ObservabilityConfig:
    """Where runtime telemetry goes (DESIGN.md §12).

    ``tracker`` selects the sink backend by name — one of
    ``repro_torch.obs.TRACKER_BACKENDS`` (``"none"``, ``"memory"``,
    ``"jsonl"``, ``"csv"``, ``"tensorboard"``) or a comma-separated
    list for fan-out. ``"none"`` is the zero-overhead default: the
    runtime holds no tracker object at all and runs are bitwise
    identical to a build without the observability layer.

    Frozen + hashable: this config rides inside ``LTPConfig``.
    """

    tracker: str = "none"
    # file backends write to ``path`` when set, else
    # ``<out_dir>/<run_name>.<ext>``
    out_dir: str = "runs"
    path: Optional[str] = None
    run_name: str = "run"
    # histogram reservoir size for the metrics registry (Algorithm R)
    reservoir: int = 1024
    # sample per-trunk queue depths on the ``Sim.every`` grid (feeds the
    # per-trunk counter tracks in the Chrome trace). Only read when a
    # tracker is active — with ``tracker="none"`` the queue events stay
    # exactly as before.
    sample_trunks: bool = True


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
    # Staleness-aware compensation weighting (beyond-paper, DESIGN.md §8):
    # under async / bounded-staleness aggregation a worker's contribution
    # to the PS reduction is damped by 1 / (1 + staleness_comp * s) where
    # s is the gradient's staleness in iterations. 0 disables damping
    # (every admitted gradient weighs 1, the classic SSP reduction).
    staleness_comp: float = 0.0
    error_feedback: bool = False     # beyond-paper
    critical_per_tensor: int = 1     # first/last packet(s) of each tensor marked critical
    # PS-side aggregation backend: "python" is the plain torch
    # reference; "cuda" routes the bubble-fill + masked multi-worker
    # reduction through the hand-written kernels in
    # ``repro_torch.kernels`` (their plain version for CPU tensors);
    # "auto" is "cuda" for CUDA tensors and "python" for CPU tensors
    # until an H100 measurement gives a crossover size.
    sync_backend: str = "auto"       # python | cuda | auto
    # telemetry sink selection (DESIGN.md §12); None == all defaults
    # (tracker "none", zero overhead)
    obs: Optional[ObservabilityConfig] = None

    def runtime(self) -> "RuntimeConfig":
        """The runtime/cluster half of this config as a ``RuntimeConfig``."""
        return RuntimeConfig(**{f.name: getattr(self, f.name)
                                for f in dataclasses.fields(RuntimeConfig)})

    def with_runtime(self, rc: Optional["RuntimeConfig"]) -> "LTPConfig":
        """Overlay a ``RuntimeConfig`` onto this protocol config: entry
        points taking ``runtime_cfg=`` fold it in here, so every
        downstream read of ``ltp.staleness_comp`` / ``ltp.sync_backend``
        / ... sees it."""
        if rc is None:
            return self
        return dataclasses.replace(
            self, **{f.name: getattr(rc, f.name)
                     for f in dataclasses.fields(RuntimeConfig)})


@dataclass(frozen=True)
class RuntimeConfig:
    """Runtime/cluster-side knobs (DESIGN.md §11): how the PS aggregates
    and the trainer syncs — none of these change a byte on the wire.
    ``LTPConfig`` keeps the same-named fields as the combined surface;
    pass a ``RuntimeConfig`` via ``runtime_cfg=`` to ``ClusterRuntime`` /
    ``PSTrainer`` to override them (``LTPConfig.with_runtime``)."""

    # staleness-damped async/SSP reduction weighting (DESIGN.md §8)
    staleness_comp: float = 0.0
    error_feedback: bool = False
    # PS aggregation backend: python | cuda | auto
    sync_backend: str = "auto"
    # telemetry sink selection (DESIGN.md §12); None == tracker "none"
    obs: Optional[ObservabilityConfig] = None


@dataclass(frozen=True)
class NetConfig:
    """Simulated physical network (per-link). ``mtu_bytes`` is read by
    neither package: packet sizes are the senders' constants
    (``net/senders.py``)."""

    bandwidth_gbps: float = 10.0
    rtprop_ms: float = 1.0
    loss_rate: float = 0.0           # non-congestion random loss
    queue_pkts: int = 256            # droptail switch queue
    mtu_bytes: int = 1500


@dataclass(frozen=True)
class TrainConfig:
    batch: int = 32
    seq: int = 256                   # tokens a sequence (LM families)
    lr: float = 0.1
    momentum: float = 0.9
    weight_decay: float = 0.0
    optimizer: str = "sgdm"          # sgdm | adamw
    steps: int = 100
    lr_decay_every: int = 0          # epochs; paper: x0.8 every 10 epochs
    lr_decay: float = 0.8


@dataclass(frozen=True)
class FaultConfig:
    """Fault-injection knobs for the elastic runtime (DESIGN.md §10).

    Converted into a concrete ``runtime.faults.FaultSchedule`` once the
    run horizon is known (``FaultSchedule.random`` takes ``t_end``); the
    all-zero default draws an empty schedule, which the runtime treats
    exactly like no fault layer at all.
    """

    crash_rate: float = 0.0          # worker crashes, per worker-second
    rejoin_after_s: Optional[float] = None  # crashed slots rejoin after this
    leave_rate: float = 0.0          # graceful departures, per worker-second
    ps_fail_at: Tuple[float, ...] = ()      # sim times of PS failures
    ps_recovery_s: float = 0.05      # PS downtime before checkpoint failover
    checkpoint_every_s: float = 0.0  # snapshot grid (0 = initial state only)
    min_active: int = 1              # random schedules never go below this
    seed: int = 0


@dataclass(frozen=True)
class NetFaultConfig:
    """Network-layer fault-injection knobs (DESIGN.md §14).

    Converted into a concrete ``net.netfaults.LinkFaultSchedule`` once
    the run horizon and topology are known
    (``netfault_schedule_from_config``); the all-zero default draws an
    empty schedule, which the runtime treats exactly like no fabric
    fault plane at all (zero-fault parity).
    """

    link_down_rate: float = 0.0      # uplink admin-downs, per link-second
    link_recover_s: float = 0.05     # downtime before the link comes back
    flap_rate: float = 0.0           # uplink flap episodes, per link-second
    flap_period_s: float = 0.02      # flap square-wave period
    flap_duty: float = 0.5           # fraction of each period spent down
    flap_duration_s: float = 0.2     # length of one flap episode
    degrade_rate: float = 0.0        # degrade episodes, per link-second
    degrade_rate_factor: float = 0.25  # line-rate multiplier while degraded
    degrade_extra_loss: float = 0.05   # added loss probability
    degrade_duration_s: float = 0.2
    switch_crash_at: Tuple[float, ...] = ()  # sim times of ToR crashes
    switch_recover_s: float = 0.05
    partition_at: Tuple[float, ...] = ()     # sim times of rack partitions
    partition_heal_s: float = 0.1
    max_cut: int = 1                 # concurrent-severed-racks ceiling
    seed: int = 0
