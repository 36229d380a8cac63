"""Early Close (paper §III-B): the double time-threshold controller.

A numpy-only copy of the JAX package's ``core/early_close.py``.

Host-side control loop (numpy): per-link LT thresholds, the global
deadline, and the per-iteration close decision. Transport timing comes
from a pluggable gather model — either the fast analytic incast model
below (training loops) or samples from the packet-level DES in
the JAX package's ``net`` simulator (protocol benchmarks).

Definitions (paper):
  ECT            = RTprop + ModelSize/BtlBw
  LT_init        = 1.5 * RTprop + ModelSize/BtlBw      (first batch of epoch)
  LT update      = shortest observed 100%-delivery time this epoch, per link
  deadline       = max(LT thresholds) + C   (C = 30 ms DCN / 100 ms WAN)
  close rule     : t < LT       -> wait for all data
                   LT <= t < DL -> close when received pct >= threshold
                   t >= DL      -> close unconditionally

Beyond-paper extensions (DESIGN.md §3.3, §5):
  * phase-aware threshold — the received-pct threshold ramps with training
    progress (``LTPConfig.phase_final_pct_threshold``): early iterations
    tolerate more loss, late iterations less.
  * ``MultiPSEarlyClose`` — one independent controller per PS shard; an
    iteration's close time is the slowest shard's close.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np

from repro_torch.config import LTPConfig, NetConfig


@dataclasses.dataclass
class GatherSample:
    """One iteration's transport outcome for W workers."""

    completion_times: np.ndarray   # (W,) time for 100% of this worker's data
    first_arrival: np.ndarray      # (W,) time of first payload byte


class AnalyticIncastModel:
    """Fast closed-form stand-in for the DES (calibrated against it —
    compare against ``benchmarks/fig3_incast_fct.py`` output; DESIGN.md §1).

    Captures the two phenomena the paper measures:
      * incast long tail (Fig 3): most flows finish near the fair-share
        time; a few "starved" flows are inflated by a heavy-tail factor.
      * non-congestion loss (Fig 4): loss-recovery inflation for
        order-preserving TCP (cwnd collapse), mild inflation for
        BBR/LTP-style BDP control.
    """

    def __init__(self, net: NetConfig, n_workers: int, *, protocol: str = "ltp",
                 tail_prob: float = 0.15, tail_scale: float = 1.5, seed: int = 0):
        self.net = net
        self.w = n_workers
        self.protocol = protocol
        self.tail_prob = tail_prob
        self.tail_scale = tail_scale
        self.rng = np.random.default_rng(seed)

    def loss_inflation(self) -> float:
        """Goodput divisor under random loss p (per-protocol, per Fig 4)."""
        p = self.net.loss_rate
        bdp_pkts = (
            self.net.bandwidth_gbps * 1e9 / 8 * self.net.rtprop_ms * 1e-3 / 1500.0
        )
        if self.protocol in ("ltp", "bbr"):
            # BDP probing: goodput ~ (1-p) with small probe overhead
            return 1.0 / max(1e-6, (1.0 - p) ** 2)
        # Reno/Cubic-like: throughput ~ MSS/(RTT*sqrt(2p/3)) capped at fair share
        if p <= 0:
            return 1.0
        loss_limited = 1.0 / (self.net.rtprop_ms * 1e-3) * np.sqrt(1.5 / p)
        fair_share = self.net.bandwidth_gbps * 1e9 / 8 / 1500.0 / self.w
        return max(1.0, fair_share / max(loss_limited, 1e-9))

    def sample(self, model_bytes: float) -> GatherSample:
        bw = self.net.bandwidth_gbps * 1e9 / 8  # B/s shared bottleneck
        rt = self.net.rtprop_ms * 1e-3
        base = model_bytes * self.w / bw + rt  # serialized incast drain time
        infl = self.loss_inflation()
        tails = np.where(
            self.rng.random(self.w) < self.tail_prob,
            self.rng.exponential(self.tail_scale, self.w),
            0.0,
        )
        # order-preserving protocols additionally stall on per-loss RTOs
        if self.protocol in ("reno", "cubic") and self.net.loss_rate > 0:
            n_pkts = model_bytes / 1500.0
            rto_stalls = self.rng.binomial(
                int(max(1, n_pkts * self.net.loss_rate * 0.05)), 0.5, self.w
            ) * (4 * rt)
        else:
            rto_stalls = np.zeros(self.w)
        completion = base * infl * (1.0 + tails) + rto_stalls
        return GatherSample(
            completion_times=completion,
            first_arrival=np.full(self.w, rt),
        )


def phase_pct_threshold(ltp: LTPConfig, progress: float) -> float:
    """Effective Early-Close received-pct threshold at training progress
    in [0, 1]. Linear ramp from ``data_pct_threshold`` toward
    ``phase_final_pct_threshold`` (identity when the latter is None)."""
    base = ltp.data_pct_threshold
    final = ltp.phase_final_pct_threshold
    if final is None:
        return base
    p = min(max(float(progress), 0.0), 1.0)
    return base + (final - base) * p


class EarlyCloseController:
    """Maintains LT thresholds + deadline; decides close time & delivered
    fractions each iteration (gathering direction only, §III-B-2)."""

    def __init__(self, ltp: LTPConfig, net: NetConfig, n_workers: int,
                 model_bytes: float):
        self.ltp = ltp
        self.net = net
        self.w = n_workers
        self.model_bytes = float(model_bytes)
        rt = net.rtprop_ms * 1e-3
        btlbw = net.bandwidth_gbps * 1e9 / 8
        per_worker_share = btlbw / n_workers
        init = ltp.lt_init_rtprop_mult * rt + self.model_bytes / per_worker_share
        self.lt = np.full(n_workers, init)          # per-link LT threshold
        self.best_full = np.full(n_workers, np.inf)  # best 100% time this epoch
        self.iter_in_epoch = 0
        self.progress = 0.0   # training progress in [0,1] (phase-aware ramp)

    def set_progress(self, progress: float) -> None:
        """Feed training progress for the phase-aware threshold ramp."""
        self.progress = float(progress)

    @property
    def pct_threshold(self) -> float:
        return phase_pct_threshold(self.ltp, self.progress)

    @property
    def deadline(self) -> float:
        return float(self.lt.max() + self.ltp.deadline_c_ms * 1e-3)

    def new_epoch(self) -> None:
        """LT <- shortest 100%-delivery time observed last epoch (paper)."""
        upd = np.isfinite(self.best_full)
        self.lt[upd] = self.best_full[upd]
        self.best_full[:] = np.inf
        self.iter_in_epoch = 0

    def step(self, sample: GatherSample) -> Tuple[float, np.ndarray]:
        """Returns (close_time a.k.a. gather BST, delivered_frac (W,)).

        Worker w's packets arrive ~uniformly over
        [first_arrival_w, completion_w] (out-of-order transmission has no
        head-of-line ordering), so pct(t) is linear in t.
        """
        t_full = sample.completion_times
        t0 = sample.first_arrival
        lt = float(self.lt.max())
        dl = self.deadline

        def pct(t: float) -> np.ndarray:
            return np.clip((t - t0) / np.maximum(t_full - t0, 1e-12), 0.0, 1.0)

        if float(t_full.max()) <= lt:
            close = float(t_full.max())      # all data before LT: no loss
        else:
            # earliest t in [lt, dl] with mean received pct >= threshold;
            # pct is piecewise-linear & monotone -> bisect
            target = self.pct_threshold
            if pct(dl).mean() < target:
                close = dl                    # deadline wins
            elif pct(lt).mean() >= target:
                close = lt
            else:
                lo, hi = lt, dl
                for _ in range(40):
                    mid = 0.5 * (lo + hi)
                    if pct(mid).mean() >= target:
                        hi = mid
                    else:
                        lo = mid
                close = hi
        frac = pct(close)
        # record best 100% times for the epoch update
        done = t_full <= close
        self.best_full[done] = np.minimum(self.best_full[done], t_full[done])
        self.iter_in_epoch += 1
        return close, frac


class MultiPSEarlyClose:
    """Per-shard Early Close for multi-PS deployments (DESIGN.md §5).

    One independent ``EarlyCloseController`` per PS shard, each over
    ``model_bytes / n_ps``; the iteration's gather BST is the slowest
    shard's close, and a worker's delivered fraction is the mean over its
    shard flows. The single-controller interface is preserved so the
    trainer treats n_ps=1 and n_ps>1 uniformly.
    """

    def __init__(self, ltp: LTPConfig, net: NetConfig, n_workers: int,
                 model_bytes: float, n_ps: int = 1):
        if n_ps < 1:
            raise ValueError("n_ps must be >= 1")
        self.n_ps = n_ps
        self.controllers = [
            EarlyCloseController(ltp, net, n_workers, model_bytes / n_ps)
            for _ in range(n_ps)
        ]

    @property
    def deadline(self) -> float:
        return max(c.deadline for c in self.controllers)

    def set_progress(self, progress: float) -> None:
        for c in self.controllers:
            c.set_progress(progress)

    def new_epoch(self) -> None:
        for c in self.controllers:
            c.new_epoch()

    def step(self, samples: Sequence[GatherSample]) -> Tuple[float, np.ndarray]:
        """``samples``: one GatherSample per shard. Returns
        (close = max over shards, delivered frac = mean over shards)."""
        if len(samples) != self.n_ps:
            raise ValueError(
                f"expected {self.n_ps} shard samples, got {len(samples)}")
        closes, fracs = [], []
        for c, s in zip(self.controllers, samples):
            close, frac = c.step(s)
            closes.append(close)
            fracs.append(frac)
        return float(max(closes)), np.mean(fracs, axis=0)


def broadcast_time(net: NetConfig, model_bytes: float, n_ps: int = 1) -> float:
    """Reliable one-to-many broadcast (no Early Close, §III-B-2). With
    n_ps shards each PS broadcasts its 1/n_ps of the model over its own
    trunk, in parallel."""
    bw = net.bandwidth_gbps * 1e9 / 8
    rt = net.rtprop_ms * 1e-3
    # PS egress serializes the model once per worker on the shared trunk
    return rt + model_bytes / n_ps / bw
