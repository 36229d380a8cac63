"""Transport leg for the cluster runtime (DESIGN.md §8): the analytic
backend.

``AnalyticPerWorkerNet``
    Fast closed-form per-flow timing for the async/SSP paths: each
    worker's gather leg is an independent transfer whose serialization
    shares the trunk with the flows active *at its start* (a bounded
    approximation of true interleaving), inflated by the protocol's
    loss model and an incast tail draw — the same ingredients as
    ``AnalyticIncastModel``, applied per flow instead of per barrier.
    LTP flows run the per-flow Early Close rule (LT threshold, pct
    target, deadline); reliable protocols wait for their last byte.

The JAX package's second backend, ``DESTransport`` (the packet-level
co-simulation over pooled LTP/TCP senders and receivers), comes with
the port of the packet-level simulator (ROADMAP.md, queue 1 item 8b).
"""
from __future__ import annotations

from typing import Callable

import numpy as np

from repro_torch.config import LTPConfig, NetConfig
from repro_torch.core.early_close import AnalyticIncastModel
from repro_torch.net.simcore import Sim


class AnalyticPerWorkerNet:
    """Closed-form per-flow transport (the async/SSP fast path).

    ``send(worker, cb)`` schedules ``cb(frac, early_closed)`` at the
    flow's close time. The model: first byte lands after rtprop/2 + eps;
    100% would land after ``bytes * active / (bw/8) * loss_inflation *
    (1 + tail)``; LTP closes per the paper's double-threshold rule
    evaluated against that linear arrival ramp.
    """

    def __init__(self, sim: Sim, net: NetConfig, ltp: LTPConfig,
                 protocol: str, n_workers: int, model_bytes: float,
                 seed: int = 0, tail_prob: float = 0.15,
                 tail_scale: float = 1.5):
        self.sim = sim
        self.net = net
        self.ltp = ltp
        self.protocol = protocol
        self.w = n_workers
        self.bytes = float(model_bytes)
        self.rng = np.random.default_rng(seed + 77)
        self.tail_prob = tail_prob
        self.tail_scale = tail_scale
        # reuse the calibrated per-protocol loss-inflation law
        self._infl = AnalyticIncastModel(
            net, n_workers, protocol=protocol, seed=seed).loss_inflation()
        self.active = 0
        rt = net.rtprop_ms * 1e-3
        share = net.bandwidth_gbps * 1e9 / 8.0 / n_workers
        self.lt = ltp.lt_init_rtprop_mult * rt + self.bytes / share
        self.deadline = self.lt + ltp.deadline_c_ms * 1e-3

    def send(self, worker: int,
             cb: Callable[[float, bool], None]) -> None:
        rt = self.net.rtprop_ms * 1e-3
        bw = self.net.bandwidth_gbps * 1e9 / 8.0
        self.active += 1
        tail = (self.rng.exponential(self.tail_scale)
                if self.rng.random() < self.tail_prob else 0.0)
        t0 = rt
        t_full = rt + self.bytes * self.active / bw * self._infl * (1.0 + tail)
        if self.protocol != "ltp" or t_full <= self.lt:
            t_close, frac, early = t_full, 1.0, False
        else:
            # earliest t >= LT with pct >= threshold; deadline wins
            t_thr = t0 + self.ltp.data_pct_threshold * (t_full - t0)
            t_close = min(max(self.lt, t_thr), self.deadline)
            frac = float(np.clip((t_close - t0) / max(t_full - t0, 1e-12),
                                 0.0, 1.0))
            if t_close >= t_full:
                t_close, frac, early = t_full, 1.0, False
            else:
                early = True

        def done():
            self.active -= 1
            cb(frac, early)

        # ``cb`` is the runtime's on_delivered/on_close, which pops its
        # flight-registry entry itself; the analytic net has no pooled
        # flow lives of its own to fence.
        self.sim.after(t_close, done)

