"""PSTrainer — the paper's W-worker/1-PS training loop on one device.

The PyTorch counterpart of the JAX package's ``train/dp_sim.py``, with
its lockstep engine. Per-worker gradients come from a ``vmap`` over the
worker axis (the semantics of W data-parallel machines holding
replicated weights). The transport layer:

  * protocol="ltp":      Early Close controller decides each iteration's
                         per-worker delivered fraction; non-critical packets
                         drop i.i.d.; bubbles are zero-filled; compensation
                         per LTPConfig. BST comes from the same controller.
  * protocol tcp-family: lossless sync (delivered=1); BST from the transport
                         model — only wall-clock differs.

Engines:

  * ``engine="runtime"`` (default): delegates to
    ``repro_torch.runtime.ClusterRuntime`` — the event-driven
    co-simulation. With the default bsp policy and deterministic compute
    this reproduces the lockstep loop record for record (same fused
    step, same controller and mask RNG streams; pinned by
    tests/test_torch_runtime.py), while opening the async/ssp
    aggregation policies, heterogeneous compute models, and the
    packet-level DES transport (``transport="des"``) to the same API.
  * ``engine="lockstep"``: the synchronous loop below. Also selected
    automatically when a precomputed trace (``bst_trace`` /
    ``delivered_trace`` / ``mask_trace``) is supplied, since traces are
    a lockstep-only feature.

Wall-clock per iteration = compute_time + BST. Delivery masks are drawn
host-side with numpy each step (Bernoulli(frac) with critical packets
pinned, or a DES ``mask_trace``) from the same seeded stream as the JAX
package, and feed one fused masked multi-worker reduction
(``core.ltp_sync.reduce_packet_stream``): the ``packet_reduce`` kernel,
plus the ``dropfill`` gate under error feedback, on the card.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.config import LTPConfig, NetConfig, TrainConfig
from repro_torch.core import packets as pk
from repro_torch.core.early_close import (
    AnalyticIncastModel,
    MultiPSEarlyClose,
    broadcast_time,
)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.api import ModelApi
from repro_torch.net.topology import resolve_topology
from repro_torch.optim import Optimizer, lr_at
from repro_torch.runtime import ClusterRuntime
from repro_torch.runtime import step as stp
from repro_torch.tree import tree_map


class PSTrainer:
    """``device`` defaults to ``cuda`` and never falls back to the CPU.
    ``params`` (optional) starts training from a given tree, e.g. one
    carried over from the JAX package with ``convert.params_from_numpy``;
    otherwise the model is initialised from a CPU generator seeded with
    ``seed``."""

    def __init__(
        self,
        api: ModelApi,
        opt: Optimizer,
        train: TrainConfig,
        ltp: LTPConfig,
        net: NetConfig,
        n_workers: int = 8,
        protocol: str = "ltp",
        compute_time: float = 0.05,
        bst_trace: Optional[np.ndarray] = None,
        delivered_trace: Optional[np.ndarray] = None,
        mask_trace: Optional[np.ndarray] = None,
        seed: int = 0,
        n_ps: Optional[int] = None,
        engine: str = "runtime",
        policy="bsp",
        policy_kw: Optional[dict] = None,
        compute_model=None,
        transport: str = "analytic",
        topology=None,
        runtime_cfg=None,
        device: DeviceLike = None,
        params: Any = None,
    ):
        if engine not in ("runtime", "lockstep"):
            raise ValueError(f"unknown engine {engine!r}")
        self.device = resolve_device(device)
        topo = resolve_topology(topology, n_ps=n_ps, owner="PSTrainer")
        topo.validate_workers(n_workers, "PSTrainer")
        n_ps = topo.n_ps
        ltp = ltp.with_runtime(runtime_cfg)
        has_trace = (bst_trace is not None or delivered_trace is not None
                     or mask_trace is not None)
        if has_trace:
            engine = "lockstep"   # traces are a lockstep-only feature
        self.api = api
        self.opt = opt
        self.train_cfg = train
        self.ltp = ltp
        self.net = net
        self.w = n_workers
        self.protocol = protocol
        self.compute_time = compute_time
        self.bst_trace = bst_trace
        self.delivered_trace = delivered_trace
        self.mask_trace = (np.asarray(mask_trace, bool)
                           if mask_trace is not None else None)
        self.engine = engine
        self._rt: Optional[ClusterRuntime] = None
        if engine == "runtime":
            self._rt = ClusterRuntime(
                api, opt, train, ltp, net, n_workers=n_workers,
                protocol=protocol, policy=policy, policy_kw=policy_kw,
                compute_model=compute_model, compute_time=compute_time,
                topology=topo, seed=seed, transport=transport,
                device=self.device, params=params)
            # mirror the runtime's state so the public surface is stable
            self.params = self._rt.params
            self.opt_state = self._rt.opt_state
            self.plan = self._rt.plan
            self.residual = self._rt.residual
            self.model_bytes = self._rt.model_bytes
            self.controller = self._rt.controller
            self.gather_models = self._rt.gather_models
            self.telemetry = self._rt.tel
            self.host_metrics = self._rt.host_metrics
            self.n_ps = n_ps
            self.sim_time = 0.0
            self.step_idx = 0
            self.history: List[Dict] = self._rt.history
            return
        self.telemetry = None
        self.host_metrics = None
        self._mask_rng = np.random.default_rng(seed + 23)
        if params is None:
            gen = torch.Generator().manual_seed(seed)
            self.params = api.init(gen, device=self.device)
        else:
            self.params = tree_map(
                lambda x: torch.as_tensor(x).to(self.device), params)
        self.opt_state = opt.init(self.params)
        self.plan = pk.make_plan(
            self.params, ltp.packet_floats, ltp.critical_per_tensor
        )
        self.residual = (
            torch.zeros((n_workers, self.plan.n_packets,
                         self.plan.packet_floats), device=self.device)
            if ltp.error_feedback else None
        )
        self.model_bytes = self.plan.n_floats * 4
        self.n_ps = n_ps
        self.controller = MultiPSEarlyClose(ltp, net, n_workers,
                                            self.model_bytes, n_ps=n_ps)
        # one analytic incast per PS shard (independent tail draws)
        self.gather_models = [
            AnalyticIncastModel(net, n_workers, protocol=protocol,
                                seed=seed + 1 + 1000 * p)
            for p in range(n_ps)
        ]
        self.sim_time = 0.0
        self.step_idx = 0
        self.history: List[Dict] = []
        self._step_fn = stp.build_fused_step(api, opt, ltp, self.plan,
                                             n_workers, protocol)

    # ------------------------------------------------------------------
    def _delivery_masks(self, it: int, frac: np.ndarray) -> np.ndarray:
        """(W, n_packets) float32 per-(worker, packet) delivery mask."""
        return stp.draw_delivery_masks(self.plan, self.w, self._mask_rng,
                                       frac, mask_trace=self.mask_trace,
                                       it=it)

    # ------------------------------------------------------------------
    def _transport(self, it: int):
        """Returns (bst_seconds, delivered_frac (W,))."""
        if self.bst_trace is not None:
            bst = float(self.bst_trace[it % len(self.bst_trace)])
            if self.delivered_trace is not None:
                return bst, np.asarray(
                    self.delivered_trace[it % len(self.delivered_trace)])
            return bst, np.ones(self.w)
        shard_bytes = self.model_bytes / self.n_ps
        samples = [m.sample(shard_bytes) for m in self.gather_models]
        if self.protocol == "ltp":
            # phase-aware threshold: feed training progress to the
            # per-shard controllers before the close decision
            total = max(1, self.train_cfg.steps)
            self.controller.set_progress(self.step_idx / total)
            close, frac = self.controller.step(samples)
            bst = close + broadcast_time(self.net, self.model_bytes,
                                         n_ps=self.n_ps)
        else:
            close = max(float(s.completion_times.max()) for s in samples)
            bst = close + broadcast_time(
                self.net, self.model_bytes, n_ps=self.n_ps
            ) * self.gather_models[0].loss_inflation()
            frac = np.ones(self.w)
        return bst, frac

    def _to_workers(self, x) -> torch.Tensor:
        """(B, ...) host batch -> (W, B/W, ...) tensor on the device."""
        t = torch.as_tensor(np.asarray(x)).to(self.device)
        return t.reshape((self.w, t.shape[0] // self.w) + tuple(t.shape[1:]))

    def run(self, batches, *, epoch_steps: int = 0, eval_fn=None,
            eval_every: int = 0, log_every: int = 0) -> List[Dict]:
        if self._rt is not None:
            # the mirrors would hold the state the run started from (the
            # optimizer moments and the EF residual: W x the model) beside
            # the live one on the device; they are set again at the end
            self.params = self.opt_state = self.residual = None
            try:
                out = self._rt.run(batches, epoch_steps=epoch_steps,
                                   eval_fn=eval_fn, eval_every=eval_every,
                                   log_every=log_every)
            finally:
                self.params = self._rt.params
                self.opt_state = self._rt.opt_state
                self.residual = self._rt.residual
            self.sim_time = self._rt.sim_time
            self.step_idx = self._rt.step_idx
            self.history = self._rt.history
            return out
        for batch in batches:
            batch = {k: self._to_workers(v) for k, v in batch.items()}
            bst, frac = self._transport(self.step_idx)
            masks = (self._delivery_masks(self.step_idx, frac)
                     if self.protocol == "ltp"
                     else np.ones((self.w, self.plan.n_packets), np.float32))
            lr = lr_at(self.train_cfg, self.step_idx, epoch_steps)
            (self.params, self.opt_state, self.residual, loss, realized) = \
                self._step_fn(
                    self.params, self.opt_state, self.residual, batch,
                    torch.as_tensor(masks).to(self.device),
                    torch.as_tensor(np.asarray(frac, np.float32)).to(
                        self.device),
                    lr)
            # the JAX lockstep loop's association, t + (compute + bst);
            # the runtime engine commits at (t + compute) + bst, one ulp
            # away at times, as its JAX counterpart does
            self.sim_time += self.compute_time + bst
            rec = {
                "step": self.step_idx,
                "loss": float(loss),
                "bst": bst,
                "delivered": float(realized),
                "sim_time": self.sim_time,
            }
            if epoch_steps and (self.step_idx + 1) % epoch_steps == 0:
                self.controller.new_epoch()
            if eval_fn is not None and eval_every and \
                    (self.step_idx + 1) % eval_every == 0:
                rec["eval"] = float(eval_fn(self.params))
            self.history.append(rec)
            if log_every and self.step_idx % log_every == 0:
                msg = f"step {self.step_idx:5d} loss {rec['loss']:.4f} " \
                      f"bst {bst*1e3:6.1f}ms delivered {rec['delivered']:.3f}"
                if "eval" in rec:
                    msg += f" eval {rec['eval']:.4f}"
                print(msg, flush=True)
            self.step_idx += 1
        return self.history

    # throughput in items/sec of simulated wall-clock
    def throughput(self, items_per_step: int) -> float:
        if self._rt is not None:
            return self._rt.throughput(items_per_step)
        if not self.history:
            return 0.0
        return items_per_step * len(self.history) / self.sim_time
