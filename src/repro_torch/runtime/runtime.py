"""ClusterRuntime — event-driven compute/network co-simulation of the
PS training cluster (DESIGN.md §8).

The PyTorch counterpart of the JAX package's ``runtime/runtime.py``.
One shared ``Sim`` clock carries everything: per-worker compute times
(``runtime.compute``), the transport leg (analytic per-flow timing or
the packet-level DES in ``runtime.transport``), and the PS-side
aggregation policy (``runtime.policies``). The model state (params,
optimizer, packet plan, kernel-backed reductions) lives here, as device
tensors; actors and policies only schedule.

Execution paths:

* ``policy="bsp"`` — barrier semantics. The runtime runs the SAME fused
  step as the lockstep ``PSTrainer`` on the SAME Early-Close controller
  and delivery-mask RNG streams, so with the default deterministic
  compute model a bsp run reproduces the lockstep loop record for record
  (tests/test_torch_runtime.py pins this).
* ``policy="async" | "ssp"`` — apply-on-arrival. Each worker's gradient
  is computed against the params version that worker actually fetched
  (so staleness is real, not simulated), gated per-gradient through the
  error-feedback/delivery machinery (the ``dropfill`` kernel on the
  card), and folded in by ``reduce_packet_stream`` (the
  ``packet_reduce`` kernel) with the policy's staleness-damped weights.

Fault tolerance (DESIGN.md §10): a ``FaultSchedule`` (or a
``FaultConfig`` drawn at run time) injects worker crash/join/leave and
PS failure onto the same clock. Worker death rides the transport's
generation-fencing protocol, so a dead node's in-flight traffic is
provably dropped; PS failover restores the last periodic snapshot
(optionally round-tripped through ``repro_torch.checkpoint``) and, with
``n_ps > 1``, rebalances shard ownership across survivors. Every fault
path is a structural no-op when no faults are scheduled — a zero-fault
run is record-for-record identical to the fault-unaware runtime
(tests/test_torch_faults.py pins this).

The snapshot keeps params, optimizer state and the error-feedback
residual by reference. That is a copy only while nothing writes them in
place: the optimizers return new tensors, and the residual is replaced
out of place (``index_copy``), never written through ``residual[w] =``.

Network faults (DESIGN.md §14): a ``LinkFaultSchedule`` (or a
``NetFaultConfig`` drawn at run time) cuts, flaps, degrades and
partitions the packet-level fabric through a ``NetFaultPlane``, and
turns on the senders' self-healing; a flow that blackholes
(``on_flow_dead``) drops out of its round while its worker lives on. A
``BudgetController`` (``budget=``) moves each PS shard's Early-Close
threshold on a fixed sim-time grid. Both need ``transport="des"``, and
both, like the node faults, leave a run untouched when absent or empty.

Truncation safety: if the event loop stops on ``max_events`` mid-run the
runtime raises instead of returning a partial history.

Wall-clock spans and ``host_metrics``: everything above runs on the
simulated clock. The process's own wall time is named by one span
mechanism, ``torch.profiler.record_function``, so a profile's host spans
share a clock with its device trace and each device operation falls in
the span it was launched in. The fused step opens its spans
(``runtime/step.py``: ``worker_grads``, then ``step.PS_SYNC_SPANS``);
the runtime opens ``draw_delivery_masks`` around the analytic close's
mask draw, and ``bsp_commit`` around the fused step, inside which
``stage_inputs`` holds the three host-to-device copies (batch, masks,
fractions). These three are ``MetricsRegistry.span`` instruments of
``host_metrics``, a registry of their own, bound once in ``__init__``:
each adds its ``perf_counter_ns`` time to ``span/<name>/ns`` and 1 to
``span/<name>/calls``. ``h2d/bytes`` counts the bytes of every host
array copied to the device and ``h2d/batch_misses`` the device batch
cache's misses. The counters are always on, one integer add each, so
they read a run with no profiler, where the host may wait inside a
blocking copy for the previous step's device work. ``host_metrics`` is
kept out of ``metrics``: that registry rides into the tracker's summary,
which with ``history`` and the event stream is held equal to the JAX
runtime's, and wall-clock readings differ from run to run.
"""
from __future__ import annotations

import hashlib
import os
from typing import Dict, List, Optional

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.checkpoint.io import restore_checkpoint, save_checkpoint
from repro_torch.config import (
    FaultConfig,
    LTPConfig,
    NetConfig,
    NetFaultConfig,
    ObservabilityConfig,
    RuntimeConfig,
    TrainConfig,
)
from repro_torch.core import packets as pk
from repro_torch.core.early_close import (
    AnalyticIncastModel,
    MultiPSEarlyClose,
    broadcast_time,
)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.api import ModelApi
from repro_torch.net.netfaults import (
    LinkFaultSchedule,
    NetFaultPlane,
    netfault_schedule_from_config,
)
from repro_torch.net.simcore import PERF, Sim
from repro_torch.net.topology import GatherSpec, resolve_topology
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import write_chrome_trace
from repro_torch.obs.tracker import make_tracker
from repro_torch.optim import Optimizer, lr_at
from repro_torch.runtime import step as stp
from repro_torch.runtime.actors import PSActor, WorkerActor
from repro_torch.runtime.compute import ComputeModel, make_compute_model
from repro_torch.runtime.faults import (
    FaultEvent,
    FaultSchedule,
    ShardLedger,
    schedule_from_config,
)
from repro_torch.runtime.policies import (
    AggregationPolicy,
    AsyncPolicy,
    BSPPolicy,
    PendingGrad,
    SSPPolicy,
    make_policy,
)
from repro_torch.runtime.telemetry import Telemetry
from repro_torch.runtime.transport import AnalyticPerWorkerNet, DESTransport
from repro_torch.tree import tree_map


class _BSPRound:
    """One in-flight barrier iteration (bsp only)."""

    __slots__ = ("iteration", "ready", "gather", "t_first", "flows_done",
                 "members")

    def __init__(self, iteration: int):
        self.iteration = iteration
        self.ready: set = set()
        self.gather = None          # _DESBarrierGather under transport="des"
        self.t_first: Optional[float] = None
        self.flows_done: set = set()  # completed reliable flows (non-ltp DES)
        # membership snapshot at round creation; crashes shrink it, and
        # the barrier closes when members ⊆ ready (== the lockstep
        # len(ready) == W condition whenever the cluster is whole)
        self.members: set = set()


class ClusterRuntime:
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
        policy="bsp",
        policy_kw: Optional[dict] = None,
        compute_model=None,
        compute_time: float = 0.05,
        n_ps: Optional[int] = None,
        seed: int = 0,
        transport: str = "analytic",
        spec: Optional[GatherSpec] = None,
        telemetry: bool = True,
        params=None,
        opt_state=None,
        faults=None,
        checkpoint_every_s: float = 0.0,
        checkpoint_dir: Optional[str] = None,
        topology: Optional[GatherSpec] = None,
        runtime_cfg: Optional[RuntimeConfig] = None,
        obs: Optional[ObservabilityConfig] = None,
        net_faults=None,
        budget=None,
        coalesce: Optional[int] = None,
        device: DeviceLike = None,
    ):
        if transport not in ("analytic", "des"):
            raise ValueError(f"unknown transport {transport!r}")
        self.device = resolve_device(device)
        ltp = ltp.with_runtime(runtime_cfg)
        self.topology = resolve_topology(topology, n_ps=n_ps, spec=spec,
                                         owner="ClusterRuntime")
        self.topology.validate_workers(n_workers, "ClusterRuntime")
        self.api = api
        self.opt = opt
        self.train_cfg = train
        self.ltp = ltp
        self.net = net
        self.w = n_workers
        self.protocol = protocol
        self.n_ps = self.topology.n_ps
        self.seed = seed
        self.transport = transport
        self.sim = Sim()
        # observability layer (DESIGN.md §12): the explicit ``obs=``
        # kwarg wins, else the config riding on LTPConfig/RuntimeConfig.
        # tracker="none" resolves to tracker None — the runtime then
        # holds no sink and every hot path keeps its exact old shape
        # (bitwise-identical runs, pinned in tests/test_torch_obs.py).
        self.obs_cfg = obs if obs is not None \
            else (ltp.obs or ObservabilityConfig())
        self.tracker = make_tracker(self.obs_cfg,
                                    run_name=self.obs_cfg.run_name)
        self.metrics = MetricsRegistry(reservoir=self.obs_cfg.reservoir,
                                       seed=seed)
        # wall-clock readings of this process (the module's docstring):
        # the host phases of a bsp step, timed with or without a
        # profiler, and the bytes copied to the device. Kept apart from
        # ``metrics``, the simulated cluster's, so the run summary and
        # ``history`` stay the same whatever the host's speed.
        self.host_metrics = MetricsRegistry()
        self._span_draw = self.host_metrics.span("draw_delivery_masks")
        self._span_stage = self.host_metrics.span("stage_inputs")
        self._span_commit = self.host_metrics.span("bsp_commit")
        self._h2d_bytes = self.host_metrics.counter("h2d/bytes")
        self._h2d_misses = self.host_metrics.counter("h2d/batch_misses")
        self._perf0: Dict[str, int] = {}
        self.tel = Telemetry(telemetry, tracker=self.tracker)
        self.policy: AggregationPolicy = make_policy(policy,
                                                     **(policy_kw or {}))
        # LTPConfig.staleness_comp governs the damping law for BOTH
        # apply-on-arrival policies unless the instance overrides it
        if isinstance(self.policy, SSPPolicy) \
                and self.policy.staleness_comp == 0:
            self.policy.staleness_comp = ltp.staleness_comp
        if isinstance(self.policy, AsyncPolicy) and self.policy.damping is None:
            self.policy.damping = ltp.staleness_comp
        self.policy.bind(n_workers)
        self.compute: ComputeModel = make_compute_model(
            compute_model, n_workers, base=compute_time, seed=seed)

        def to_dev(tree):
            return tree_map(lambda x: torch.as_tensor(x).to(self.device),
                            tree)

        if params is None:
            gen = torch.Generator().manual_seed(seed)
            self.params = api.init(gen, device=self.device)
        else:
            self.params = to_dev(params)
        self.opt_state = opt.init(self.params) if opt_state is None \
            else to_dev(opt_state)
        self.plan = pk.make_plan(self.params, ltp.packet_floats,
                                 ltp.critical_per_tensor)
        self.model_bytes = self.plan.n_floats * 4
        self.residual = (
            torch.zeros((n_workers, self.plan.n_packets,
                         self.plan.packet_floats), device=self.device)
            if ltp.error_feedback else None)
        # row indices for the out-of-place residual writes, made once so
        # that no write waits on a host-to-device copy
        self._worker_ids = torch.arange(n_workers, device=self.device)

        # lockstep-parity RNG/controller streams (bsp path; seeds match
        # the lockstep PSTrainer exactly)
        self._mask_rng = np.random.default_rng(seed + 23)
        self.controller = MultiPSEarlyClose(ltp, net, n_workers,
                                            self.model_bytes, n_ps=self.n_ps)
        self.gather_models = [
            AnalyticIncastModel(net, n_workers, protocol=protocol,
                                seed=seed + 1 + 1000 * p)
            for p in range(self.n_ps)
        ]
        # async/ssp streams (separate, so they cannot perturb bsp parity)
        self._amask_rng = np.random.default_rng(seed + 29)
        self.net_des: Optional[DESTransport] = None
        self.anet: Optional[AnalyticPerWorkerNet] = None
        if transport == "des":
            self.net_des = DESTransport(
                self.sim, net, ltp, protocol, n_workers, self.model_bytes,
                topology=self.topology, seed=seed, coalesce=coalesce,
                on_early_close=lambda shard, t, d, lat=0.0: self.tel.record(
                    "early_close", t, shard=shard, delivered=d, lat=lat))
        else:
            self.anet = AnalyticPerWorkerNet(
                self.sim, net, ltp, protocol, n_workers, self.model_bytes,
                seed=seed)

        # step machinery, built lazily per execution path
        self._fused_step = None
        self._grad_fn = None
        self._apply_fn = None
        self._ef_gate = None

        # fault layer (runtime/faults.py): dormant unless armed.
        # ``faults`` is a FaultSchedule (explicit timeline) or a
        # FaultConfig (random churn drawn in run(), once the horizon is
        # known).
        self._fault_cfg: Optional[FaultConfig] = None
        self.faults: Optional[FaultSchedule] = None
        if isinstance(faults, FaultSchedule):
            self.faults = faults
        elif isinstance(faults, FaultConfig):
            self._fault_cfg = faults
            if checkpoint_every_s == 0.0:
                checkpoint_every_s = faults.checkpoint_every_s
        elif faults is not None:
            raise TypeError(
                f"faults must be a FaultSchedule or FaultConfig, "
                f"got {type(faults)!r}")
        # network fault plane (net/netfaults.py, DESIGN.md §14): same
        # dormant-unless-armed contract as the node-fault layer.
        # ``net_faults`` is a LinkFaultSchedule (explicit timeline) or a
        # NetFaultConfig (random fabric churn drawn in run()). Fabric
        # faults act on the packet-level topology, so they require
        # transport="des"; an empty schedule arms nothing and the run
        # stays bitwise-identical to a fault-unaware one.
        self._netfault_cfg: Optional[NetFaultConfig] = None
        self.net_faults: Optional[LinkFaultSchedule] = None
        self.netfault_plane: Optional[NetFaultPlane] = None
        if isinstance(net_faults, LinkFaultSchedule):
            self.net_faults = net_faults
        elif isinstance(net_faults, NetFaultConfig):
            self._netfault_cfg = net_faults
        elif net_faults is not None:
            raise TypeError(
                f"net_faults must be a LinkFaultSchedule or "
                f"NetFaultConfig, got {type(net_faults)!r}")
        if (self.net_faults is not None or self._netfault_cfg is not None) \
                and transport != "des":
            raise ValueError(
                "net_faults requires transport='des' — the analytic "
                "transport has no links or switches to fail")
        # closed-loop loss-budget controller (runtime/budget.py): bound
        # and ticked in run() only when provided (None -> untouched
        # thresholds, zero-fault parity)
        self.budget = budget
        if budget is not None and transport != "des":
            raise ValueError(
                "budget controller requires transport='des' — the "
                "analytic transport has no per-shard Early-Close "
                "receivers to actuate")
        self._budget_cancel = None
        self._ckpt_every = float(checkpoint_every_s)
        self._ckpt_dir = checkpoint_dir
        self._snap: Optional[dict] = None
        self._ckpt_cancel = None
        self._ps_down = False
        self._ps_epoch = 0          # bumps at each PS failure; fences
        #                             scheduled closures from a dead epoch
        self._flight: Dict[tuple, int] = {}   # (worker, it) -> ps epoch
        self.active_workers: set = set(range(n_workers))
        self.ledger = ShardLedger(self.n_ps)

        self.ps = PSActor(self)
        self.workers: List[WorkerActor] = []
        self._blocked: set = set()
        self._bsp_round: Optional[_BSPRound] = None
        self._visible = (0, self.params)
        self.version = 0                 # PS apply counter
        self.max_applied_iter = -1
        self.sim_time = 0.0
        self.step_idx = 0                # committed bsp iterations
        self.history: List[Dict] = []
        self._stopped = False
        self._batches: List = []
        self._shaped_cache: Dict[int, object] = {}
        self.steps = 0
        self._eval_fn = None
        self._eval_every = 0
        self._epoch_steps = 0
        self._log_every = 0

    # ------------------------------------------------------------------
    # params visibility (the broadcast leg)
    # ------------------------------------------------------------------
    def visible_params(self):
        return self._visible

    def _publish(self, version: int, params) -> None:
        delay = broadcast_time(self.net, self.model_bytes, n_ps=self.n_ps)
        epoch = self._ps_epoch

        def set_visible():
            # a broadcast launched before a PS failure must not clobber
            # the restored params (epoch fence); always 0 == 0 when no
            # faults are scheduled
            if epoch == self._ps_epoch and version > self._visible[0]:
                self._visible = (version, params)
            self.wake_blocked()

        self.sim.after(delay, set_visible)

    # ------------------------------------------------------------------
    # worker events
    # ------------------------------------------------------------------
    def wake_blocked(self, exclude: Optional[int] = None) -> None:
        for idx in sorted(self._blocked):
            if idx != exclude:
                self.workers[idx]._try_begin()

    def _worker_batch(self, worker: int, it: int):
        return {k: v[worker] for k, v in self._shaped_batch(it).items()}

    def _shaped_batch(self, it: int):
        """Iteration ``it``'s (B, ...) host batch as (W, B/W, ...) device
        tensors, as ``PSTrainer`` shapes it."""
        shaped = self._shaped_cache.get(it)
        if shaped is None:
            self._h2d_misses.inc()
            shaped = {}
            for k, x in self._batches[it].items():
                t = self._to_device(np.asarray(x))
                shaped[k] = t.reshape((self.w, t.shape[0] // self.w)
                                      + tuple(t.shape[1:]))
            self._shaped_cache[it] = shaped
            # small LRU: live iterations span at most the staleness
            # window; without a bound a long run would pin one device
            # copy of every batch it ever consumed
            while len(self._shaped_cache) > 8:
                self._shaped_cache.pop(next(iter(self._shaped_cache)))
        return shaped

    def _mask_on_device(self, mask) -> torch.Tensor:
        return self._to_device(np.asarray(mask, np.float32))

    def _to_device(self, x: np.ndarray) -> torch.Tensor:
        """Host array ``x`` copied to the device, its bytes counted."""
        t = torch.as_tensor(x)
        self._h2d_bytes.inc(t.nbytes)
        return t.to(self.device)

    def on_grad_ready(self, actor: WorkerActor, it: int) -> None:
        if self._ps_down:
            # the PS is between failure and failover: this gradient has
            # nowhere to go — counted out, never sent
            self.tel.record("ps_lost", self.sim.now, worker=actor.idx,
                            iteration=it)
            return
        if isinstance(self.policy, BSPPolicy):
            self._bsp_grad_ready(actor.idx, it)
            return
        # async/ssp: the gradient is computed against the params snapshot
        # this worker fetched — staleness is real
        if self._grad_fn is None:
            self._grad_fn = stp.build_worker_grad_fn(self.api, self.plan)
        loss, flat = self._grad_fn(actor.params_snap,
                                   self._worker_batch(actor.idx, it))
        worker = actor.idx
        # flight registry: teardown paths (worker crash, PS failure) pop
        # entries, and the delivery callback drops itself when its entry
        # is gone — a dead flow can never fold into the model
        self._flight[(worker, it)] = self._ps_epoch

        if self.net_des is not None:
            def on_delivered(masks_ps, frac, early, worker=worker, it=it,
                             loss=loss, flat=flat):
                if self._flight.pop((worker, it), None) is None:
                    return
                stream = np.concatenate(list(masks_ps))
                row = stp.tile_mask_onto_plan(self.plan, stream)
                if self.tel.enabled:
                    self.tel.record(
                        "masks", self.sim.now, worker=worker, iteration=it,
                        digest=hashlib.blake2b(
                            np.ascontiguousarray(masks_ps).tobytes(),
                            digest_size=8).hexdigest())
                if early:
                    self.tel.record("early_close", self.sim.now,
                                    worker=worker, iteration=it,
                                    delivered=float(frac))
                self._deliver(worker, it, loss, flat, row, float(frac))

            self.net_des.send(worker, on_delivered)
        else:
            def on_close(frac, early, worker=worker, it=it, loss=loss,
                         flat=flat):
                if self._flight.pop((worker, it), None) is None:
                    return
                if self.protocol == "ltp":
                    row = (self._amask_rng.random(self.plan.n_packets)
                           < frac).astype(np.float32)
                    row[self.plan.critical] = 1.0
                else:
                    row = np.ones(self.plan.n_packets, np.float32)
                if early:
                    self.tel.record("early_close", self.sim.now,
                                    worker=worker, iteration=it,
                                    delivered=float(frac))
                self._deliver(worker, it, loss, flat, row, float(frac))

            self.anet.send(worker, on_close)

    def _deliver(self, worker: int, it: int, loss, flat, mask_row: np.ndarray,
                 frac: float) -> None:
        g = PendingGrad(
            worker=worker, iteration=it, t_ready=self.sim.now,
            staleness=max(0, self.max_applied_iter - it),
            payload={"loss": loss, "flat": flat,
                     "mask": self._mask_on_device(mask_row), "frac": frac})
        self.ps.on_arrival(g)

    def on_worker_finished(self, idx: int) -> None:
        self.maybe_finish()

    def on_worker_dead(self, idx: int, graceful: bool = False) -> None:
        """Remove ``idx`` from the membership. A crash (graceful=False)
        additionally tears down its transport state and fences its
        in-flight gradients; a graceful leave lets them deliver."""
        self.active_workers.discard(idx)
        if not graceful:
            for key in [k for k in self._flight if k[0] == idx]:
                del self._flight[key]
                self.tel.record("flow_torn", self.sim.now, worker=idx,
                                iteration=key[1])
            if self.net_des is not None:
                self.net_des.teardown_worker(idx)
        self.policy.on_membership(self.active_workers)
        if not graceful and isinstance(self.policy, BSPPolicy):
            self._bsp_round_member_lost(idx)
        self.wake_blocked()
        self.maybe_finish()

    # ------------------------------------------------------------------
    # bsp barrier path (lockstep-parity)
    # ------------------------------------------------------------------
    def _bsp_grad_ready(self, worker: int, it: int) -> None:
        rnd = self._bsp_round
        if rnd is None or rnd.iteration != it:
            rnd = self._bsp_round = _BSPRound(it)
            rnd.t_first = self.sim.now
            rnd.members = set(self.active_workers)
            if self.net_des is not None and self.protocol == "ltp":
                rnd.gather = self.net_des.start_gather(
                    self._bsp_des_closed,
                    members=(None if len(rnd.members) == self.w
                             else rnd.members))
        rnd.ready.add(worker)
        if self.net_des is None:
            if rnd.members and rnd.members <= rnd.ready:
                self._bsp_analytic_close(rnd)
        elif self.protocol == "ltp":
            rnd.gather.add_worker(worker)
        else:
            # reliable protocols: independent flows; the barrier closes
            # when the last byte of the last member's flow lands
            # staleness guard lives in _bsp_reliable_check (``rnd is not
            # self._bsp_round`` → return); marking a dead round's
            # flows_done set first is harmless, the object is garbage.
            def on_flow(masks_ps, frac, early, rnd=rnd, worker=worker):
                rnd.flows_done.add(worker)
                self._bsp_reliable_check(rnd)

            self.net_des.send(worker, on_flow)  # replint-torch: ok(gen-fence)

    def _bsp_reliable_check(self, rnd: _BSPRound) -> None:
        if rnd is not self._bsp_round or not rnd.members \
                or not rnd.members <= rnd.flows_done:
            return
        masks = np.ones((self.w, self.plan.n_packets), np.float32)
        close = self.sim.now - rnd.t_first
        bst = close + broadcast_time(self.net, self.model_bytes,
                                     n_ps=self.n_ps)
        if len(rnd.ready & rnd.members) == self.w:
            self._bsp_commit(rnd, masks, np.ones(self.w), bst)
        else:
            self._bsp_commit_degraded(rnd, masks, np.ones(self.w), bst)

    def _bsp_round_member_lost(self, worker: int) -> None:
        """A crash removed ``worker`` mid-round: shrink the barrier to
        the survivors and re-check whether it can now close."""
        rnd = self._bsp_round
        if rnd is None or worker not in rnd.members:
            return
        rnd.members.discard(worker)
        if worker in rnd.ready:
            # its gradient reached the round but will never complete the
            # transport leg — the flow is torn, not applied (and leaves
            # ``ready`` so a later PS failure cannot double-count it)
            rnd.ready.discard(worker)
            self.tel.record("flow_torn", self.sim.now, worker=worker,
                            iteration=rnd.iteration)
        if rnd.gather is not None:
            # the gather's own close rule re-evaluates over the
            # surviving flows (may fire _bsp_des_closed synchronously)
            rnd.gather.abandon_worker(worker)
            return
        if not rnd.members:
            self._bsp_round_dissolved()
            return
        if self.net_des is None:
            if rnd.members <= rnd.ready:
                self._bsp_analytic_close(rnd)
        else:
            self._bsp_reliable_check(rnd)

    def _bsp_round_dissolved(self) -> None:
        """Every participant of the in-flight round crashed before it
        could commit. Survivor-less rounds leave joiners parked at
        iteration+1; re-anchor every live idle worker at the committed
        frontier so the barrier restarts."""
        self._bsp_round = None
        for wk in self.workers:
            if wk.state != "dead" and not wk.busy and not wk.finished:
                wk.reset_to(self.step_idx)
                wk._try_begin()
        self.maybe_finish()

    def _bsp_analytic_close(self, rnd: _BSPRound) -> None:
        """All grads ready: sample the transport models and the Early
        Close controller exactly as the lockstep loop does."""
        it = rnd.iteration
        shard_bytes = self.model_bytes / self.n_ps
        samples = [m.sample(shard_bytes) for m in self.gather_models]
        if self.protocol == "ltp":
            total = max(1, self.train_cfg.steps)
            self.controller.set_progress(it / total)
            close, frac = self.controller.step(samples)
            bst = close + broadcast_time(self.net, self.model_bytes,
                                         n_ps=self.n_ps)
        else:
            close = max(float(s.completion_times.max()) for s in samples)
            bst = close + broadcast_time(
                self.net, self.model_bytes, n_ps=self.n_ps
            ) * self.gather_models[0].loss_inflation()
            frac = np.ones(self.w)
        with self._span_draw:
            masks = (stp.draw_delivery_masks(self.plan, self.w,
                                             self._mask_rng, frac)
                     if self.protocol == "ltp"
                     else np.ones((self.w, self.plan.n_packets), np.float32))
        if self.protocol == "ltp" and float(np.mean(frac)) < 1.0 - 1e-9:
            self.tel.record("early_close", self.sim.now + close,
                            iteration=it, delivered=float(np.mean(frac)))
        # the analytic incast model assumes all W flows start together, so
        # the gather is anchored at the LAST grad-ready (= now, the event
        # that completed the barrier) — under heterogeneous compute the
        # straggler's lateness must not absorb the transport cost
        if len(rnd.ready & rnd.members) == self.w:
            self._bsp_commit(rnd, masks, frac, bst, t_anchor=self.sim.now)
        else:
            self._bsp_commit_degraded(rnd, masks, frac, bst,
                                      t_anchor=self.sim.now)

    def _bsp_des_closed(self, sharded) -> None:
        """All DES shards closed: real delivery masks -> fused step."""
        rnd = self._bsp_round
        if rnd is None:
            return
        if not (rnd.ready & rnd.members):
            # every participant crashed before the gather closed
            self._bsp_round_dissolved()
            return
        per_shard = sharded.delivery_masks()        # (n_ps, W, n)
        if self.tel.enabled:
            self.tel.record(
                "masks", self.sim.now, iteration=rnd.iteration,
                digest=hashlib.blake2b(
                    np.ascontiguousarray(per_shard).tobytes(),
                    digest_size=8).hexdigest())
        masks = np.stack([
            stp.tile_mask_onto_plan(
                self.plan, np.concatenate([per_shard[p][f]
                                           for p in range(self.n_ps)]))
            for f in range(self.w)
        ])
        frac = sharded.delivered_fracs()
        close = self.sim.now - rnd.t_first
        bst = close + broadcast_time(self.net, self.model_bytes,
                                     n_ps=self.n_ps)
        if len(rnd.ready & rnd.members) == self.w:
            self._bsp_commit(rnd, masks, frac, bst)
        else:
            self._bsp_commit_degraded(rnd, masks, frac, bst)

    def _bsp_commit(self, rnd: _BSPRound, masks: np.ndarray,
                    frac: np.ndarray, bst: float,
                    t_anchor: Optional[float] = None) -> None:
        it = rnd.iteration
        if self._fused_step is None:
            self._fused_step = stp.build_fused_step(
                self.api, self.opt, self.ltp, self.plan, self.w,
                self.protocol)
        lr = lr_at(self.train_cfg, it, self._epoch_steps)
        # the arguments the lockstep PSTrainer passes, so both engines
        # run the same step on the same inputs. A profile finds each bsp
        # commit's device work, full or degraded, by its span.
        with self._span_commit:
            # blocking copies from pageable memory: the host may wait in
            # them for the device to finish the step before
            with self._span_stage:
                batch = self._shaped_batch(it)
                masks_d = self._mask_on_device(masks)
                frac_d = self._to_device(np.asarray(frac, np.float32))
            (self.params, self.opt_state, self.residual, loss,
             realized) = self._fused_step(
                self.params, self.opt_state, self.residual, batch, masks_d,
                frac_d, lr)
        # the iteration commits when the broadcast lands: history record,
        # params visibility, and the barrier release all happen there.
        # ``t_anchor`` is the gather start (analytic: last grad-ready;
        # DES: the round's first send, whose ``bst`` already spans the
        # in-flight gather).
        t_commit = (rnd.t_first if t_anchor is None else t_anchor) + bst
        epoch = self._ps_epoch

        def commit(loss=loss, realized=realized):
            if epoch != self._ps_epoch:
                return   # PS failed between close and commit; rolled back
            self.version += 1
            self.max_applied_iter = it
            self._visible = (self.version, self.params)
            self.sim_time = self.sim.now
            # loss/realized stay 0-d device tensors: forcing them here
            # would block the event loop on the device step instead of
            # letting it run ahead (DESIGN.md §9); ``run`` converts the
            # whole history once the sim drains.
            rec = {
                "step": it,
                "loss": loss,
                "bst": bst,
                "delivered": realized,
                "sim_time": self.sim_time,
            }
            self.tel.record("apply", self.sim.now, step=it, n_grads=self.w,
                            staleness_max=0, staleness_mean=0.0,
                            loss=rec["loss"])
            if self._epoch_steps and (it + 1) % self._epoch_steps == 0:
                self.controller.new_epoch()
            if self._eval_fn is not None and self._eval_every and \
                    (it + 1) % self._eval_every == 0:
                rec["eval"] = float(self._eval_fn(self.params))
            self.history.append(rec)
            if self._log_every and it % self._log_every == 0:
                msg = f"step {it:5d} loss {float(rec['loss']):.4f} " \
                      f"bst {bst*1e3:6.1f}ms " \
                      f"delivered {float(rec['delivered']):.3f}"
                if "eval" in rec:
                    msg += f" eval {rec['eval']:.4f}"
                print(msg, flush=True)
            self.step_idx = it + 1
            self._bsp_round = None
            self.policy.on_applied([])
            self.wake_blocked()
            self.maybe_finish()

        self.sim.at(t_commit, commit)

    def _set_residual(self, worker: int, new_res: torch.Tensor) -> None:
        """Replace worker ``worker``'s error-feedback residual OUT OF
        PLACE: a PS snapshot holds the residual by reference, and an
        in-place write would change the snapshot a later failover
        restores."""
        idx = self._worker_ids[worker:worker + 1]
        self.residual = self.residual.index_copy(0, idx, new_res[None])

    def _stack_padded(self, rows_flat: list, rows_mask: list):
        """The (W, n, p) packet and (W, n) mask stacks of ``len(rows)``
        gradients, zero-padded to the cluster size W: the apply's 1/W
        scale counts the padded rows (weight 0, mask 0)."""
        n, p = self.plan.n_packets, self.plan.packet_floats
        pad = self.w - len(rows_flat)
        stacked = torch.stack(rows_flat)
        masks = torch.stack(rows_mask)
        if pad:
            stacked = torch.cat([stacked, torch.zeros(
                (pad, n, p), dtype=torch.float32, device=self.device)])
            masks = torch.cat([masks, torch.zeros(
                (pad, n), dtype=torch.float32, device=self.device)])
        return stacked, masks

    def _build_apply(self) -> None:
        if self._apply_fn is None:
            self._apply_fn = stp.build_apply_fn(
                self.api, self.opt, self.ltp, self.plan, self.w,
                premasked=self.ltp.error_feedback)
            if self.ltp.error_feedback:
                self._ef_gate = stp.build_ef_gate_fn(self.ltp)

    def _bsp_commit_degraded(self, rnd: _BSPRound, masks: np.ndarray,
                             frac, bst: float,
                             t_anchor: Optional[float] = None) -> None:
        """Partial-membership barrier commit. The fused step is shaped
        over all W batch shards, so a degraded round instead computes
        per-survivor gradients (same grad fn as the async path) and
        folds them with weight W/n_survivors — composed with the apply
        fn's 1/W reduction that is exactly the mean over survivors."""
        it = rnd.iteration
        survivors = sorted(rnd.ready & rnd.members)
        if not survivors:
            self._bsp_round_dissolved()
            return
        frac_arr = np.asarray(frac, float)
        if frac_arr.ndim == 0:
            frac_arr = np.full(self.w, float(frac_arr))
        t_commit = (rnd.t_first if t_anchor is None else t_anchor) + bst
        epoch = self._ps_epoch

        def commit():
            if epoch != self._ps_epoch:
                return
            with self._span_commit:
                if self._grad_fn is None:
                    self._grad_fn = stp.build_worker_grad_fn(self.api,
                                                             self.plan)
                self._build_apply()
                weights = np.zeros(self.w, np.float32)
                rows_flat, rows_mask, losses = [], [], []
                scale = self.w / len(survivors)
                for i, wkr in enumerate(survivors):
                    snap = self.workers[wkr].params_snap
                    loss, flat = self._grad_fn(
                        self.params if snap is None else snap,
                        self._worker_batch(wkr, it))
                    mask = self._mask_on_device(masks[wkr])
                    if self._ef_gate is not None:
                        flat, new_res = self._ef_gate(
                            flat, self.residual[wkr], mask)
                        self._set_residual(wkr, new_res)
                    rows_flat.append(flat)
                    rows_mask.append(mask)
                    weights[i] = scale
                    losses.append(loss)
                stacked, mrows = self._stack_padded(rows_flat, rows_mask)
                lr = lr_at(self.train_cfg, it, self._epoch_steps)
                fr = float(np.mean(frac_arr[survivors]))
                self.params, self.opt_state = self._apply_fn(
                    self.params, self.opt_state, stacked, mrows, weights,
                    np.float32(fr), lr)
                loss = torch.stack(losses).mean()
            self.version += 1
            self.max_applied_iter = it
            self._visible = (self.version, self.params)
            self.sim_time = self.sim.now
            rec = {
                "step": it,
                "loss": loss,
                "bst": bst,
                "delivered": fr,
                "sim_time": self.sim_time,
                "n_grads": len(survivors),
            }
            self.tel.record("apply", self.sim.now, step=it,
                            n_grads=len(survivors), staleness_max=0,
                            staleness_mean=0.0, loss=loss)
            if self._epoch_steps and (it + 1) % self._epoch_steps == 0:
                self.controller.new_epoch()
            if self._eval_fn is not None and self._eval_every and \
                    (it + 1) % self._eval_every == 0:
                rec["eval"] = float(self._eval_fn(self.params))
            self.history.append(rec)
            if self._log_every and it % self._log_every == 0:
                print(f"step {it:5d} loss {float(rec['loss']):.4f} "
                      f"bst {bst*1e3:6.1f}ms degraded "
                      f"n_grads {len(survivors)}/{self.w}", flush=True)
            self.step_idx = it + 1
            self._bsp_round = None
            self.policy.on_applied([])
            self.wake_blocked()
            self.maybe_finish()

        self.sim.at(t_commit, commit)

    # ------------------------------------------------------------------
    # async/ssp apply path
    # ------------------------------------------------------------------
    def apply_batch(self, batch: List[PendingGrad]) -> None:
        # a named span, so that a profile can read one apply's device
        # work (chip_smoke.py's profile_async_apply)
        with record_function("apply_batch"):
            self._build_apply()
            pw = self.policy.weights(batch)
            weights = np.zeros(self.w, np.float32)
            rows_flat, rows_mask, fracs = [], [], []
            for i, g in enumerate(batch):
                flat, mask = g.payload["flat"], g.payload["mask"]
                if self._ef_gate is not None:
                    flat, new_res = self._ef_gate(
                        flat, self.residual[g.worker], mask)
                    self._set_residual(g.worker, new_res)
                rows_flat.append(flat)
                rows_mask.append(mask)
                weights[i] = 1.0 if pw is None else pw[i]
                fracs.append(g.payload["frac"])
            # fixed (W, n, p) shape: the 1/W scale counts the padded rows
            stacked, masks = self._stack_padded(rows_flat, rows_mask)
            top_it = max(g.iteration for g in batch)
            lr = lr_at(self.train_cfg, top_it, self._epoch_steps)
            frac = np.float32(np.mean(fracs))
            self.params, self.opt_state = self._apply_fn(
                self.params, self.opt_state, stacked, masks, weights, frac,
                lr)
        self.version += 1
        self.max_applied_iter = max(self.max_applied_iter, top_it)
        stale = [g.staleness for g in batch]
        # lazy mean loss — forcing here would serialize the event loop
        # behind every device apply (see _bsp_commit / run finalization)
        loss = torch.stack([g.payload["loss"] for g in batch]).mean()
        self.sim_time = self.sim.now
        rec = {
            "step": self.version - 1,
            "loss": loss,
            "delivered": float(np.mean(fracs)),
            "staleness": int(max(stale)),
            "n_grads": len(batch),
            "sim_time": self.sim_time,
        }
        self.tel.record("apply", self.sim.now, step=self.version - 1,
                        n_grads=len(batch), staleness_max=int(max(stale)),
                        staleness_mean=float(np.mean(stale)), loss=loss)
        if self._eval_fn is not None and self._eval_every and \
                self.version % self._eval_every == 0:
            rec["eval"] = float(self._eval_fn(self.params))
        self.history.append(rec)
        if self._log_every and (self.version - 1) % self._log_every == 0:
            print(f"apply {self.version - 1:5d} loss {float(loss):.4f} "
                  f"staleness {max(stale)} n_grads {len(batch)}", flush=True)
        self.policy.on_applied(batch)
        self._publish(self.version, self.params)
        self.wake_blocked()

    # ------------------------------------------------------------------
    # fault injection (DESIGN.md §10)
    # ------------------------------------------------------------------
    def on_fault(self, ev: FaultEvent) -> None:
        """FaultSchedule dispatch target; one call per armed event."""
        if self._stopped:
            return
        self.tel.record("fault", self.sim.now, fault=ev.kind,
                        target=ev.target)
        if ev.kind == "worker_crash":
            self._fault_worker_crash(ev.target % self.w)
        elif ev.kind == "worker_leave":
            self._fault_worker_leave(ev.target % self.w)
        elif ev.kind == "worker_join":
            self._fault_worker_join(ev.target % self.w)
        elif ev.kind == "ps_fail":
            self._fault_ps_fail(ev.target % self.n_ps, ev.recover_s)
        elif ev.kind == "ps_recover":
            self._fault_ps_recover(ev.target % self.n_ps)

    # -- network fault plane (DESIGN.md §14) ---------------------------

    def _on_netfault(self, ev) -> None:
        """NetFaultPlane ``on_event`` tap: one record per realized
        LinkFaultEvent (mirrors the node-fault ``fault`` records)."""
        self.tel.record("netfault", self.sim.now, fault=ev.kind,
                        target=str(ev.target))

    def _on_path_state(self, kind: str, target: str) -> None:
        """NetFaultPlane ``on_path`` tap: path-state transitions —
        ``reroute`` (backup absorbed the cut) or ``blackhole`` (no
        redundancy; traffic on the path is being dropped)."""
        self.tel.record(kind, self.sim.now, link=str(target))

    def on_flow_dead(self, idx: int) -> None:
        """LTP blackhole detection fired for worker ``idx``: its sender
        hit BLACKHOLE_RTOS consecutive timeouts and aborted the flow.
        The worker itself is alive — only its transport leg is gone —
        so this drops the in-flight contribution (bsp: shrink the
        barrier; async/ssp: fence the flight entry) and tears the
        worker's flow state so the next iteration starts clean."""
        if self._stopped:
            return
        for key in [k for k in self._flight if k[0] == idx]:
            del self._flight[key]
            self.tel.record("flow_dead", self.sim.now, worker=idx,
                            iteration=key[1])
        if self.net_des is not None:
            self.net_des.teardown_worker(idx)
        if isinstance(self.policy, BSPPolicy):
            self._bsp_round_flow_dead(idx)
        self.wake_blocked()
        self.maybe_finish()

    def _bsp_round_flow_dead(self, worker: int) -> None:
        """A blackholed flow removed ``worker``'s contribution from the
        in-flight round. Same barrier surgery as a crash
        (_bsp_round_member_lost) but the event is ``flow_dead`` — the
        worker survives and rejoins the barrier next round."""
        rnd = self._bsp_round
        if rnd is None or worker not in rnd.members:
            return
        rnd.members.discard(worker)
        if worker in rnd.ready:
            rnd.ready.discard(worker)
            self.tel.record("flow_dead", self.sim.now, worker=worker,
                            iteration=rnd.iteration)
        if rnd.gather is not None:
            rnd.gather.abandon_worker(worker)
            return
        if not rnd.members:
            self._bsp_round_dissolved()
            return
        if self.net_des is not None:
            self._bsp_reliable_check(rnd)

    def _fault_worker_crash(self, idx: int) -> None:
        wk = self.workers[idx]
        if wk.state == "dead":
            return
        wk.crash()
        self.on_worker_dead(idx, graceful=False)

    def _fault_worker_leave(self, idx: int) -> None:
        wk = self.workers[idx]
        if wk.state == "dead":
            return
        wk.retire()
        if wk.state == "dead":
            # it was idle/blocked: no iteration to drain
            self.on_worker_dead(idx, graceful=True)

    def _fault_worker_join(self, idx: int) -> None:
        wk = self.workers[idx]
        if wk.state != "dead":
            return   # slot already alive; elasticity is over fixed slots
        self.active_workers.add(idx)
        self.policy.on_membership(self.active_workers)
        if isinstance(self.policy, BSPPolicy):
            # rejoin at the committed frontier; if a round is in flight
            # the joiner sits it out (its gather flows were abandoned at
            # round start and cannot re-enter a running barrier)
            at_it = self.policy.committed
            if self._bsp_round is not None:
                at_it = self._bsp_round.iteration + 1
        else:
            at_it = max(wk.it, self.max_applied_iter + 1)
        wk.rejoin(at_it)

    def _fault_ps_fail(self, ps: int, recover_s: float) -> None:
        if self._ps_down:
            return
        self._ps_down = True
        self._ps_epoch += 1   # fences queued publishes/commits/callbacks
        now = self.sim.now
        # every in-flight gradient loses its destination
        for (wkr, it) in list(self._flight):
            self.tel.record("ps_lost", now, worker=wkr, iteration=it)
        self._flight.clear()
        if self.net_des is not None:
            self.net_des.teardown_all()
        for g in self.policy.drop_pending():
            self.tel.record("ps_lost", now, worker=g.worker,
                            iteration=g.iteration)
        rnd = self._bsp_round
        if rnd is not None:
            for wkr in rnd.ready:
                self.tel.record("ps_lost", now, worker=wkr,
                                iteration=rnd.iteration)
            self._bsp_round = None
        self.ledger.fail(ps)
        self.sim.after(max(recover_s, 0.0), lambda: self._ps_failover(ps))

    def _ps_failover(self, ps: int) -> None:
        """Bring the PS back from the last snapshot: global rollback of
        model/optimizer/history, shard re-homing, and a barrier restart
        for bsp (surviving workers re-run from the committed frontier)."""
        if not self._ps_down or self._stopped:
            return
        snap = self._snap
        if snap is None:
            raise RuntimeError(
                "PS failed with no snapshot taken — arm the checkpoint "
                "grid (checkpoint_every_s / FaultConfig.checkpoint_every_s)"
                " when scheduling ps_fail events")
        params, opt_state = snap["params"], snap["opt_state"]
        if self._ckpt_dir is not None:
            # exercise the real durability path: restore the archive the
            # snapshot grid wrote, not the in-memory reference
            tree, _ = restore_checkpoint(
                self._ckpt_path(), {"params": params, "opt_state": opt_state})
            params, opt_state = tree["params"], tree["opt_state"]
        self.params, self.opt_state = params, opt_state
        self.residual = snap["residual"]
        self.version = snap["version"]
        self.max_applied_iter = snap["max_applied_iter"]
        self.step_idx = snap["step_idx"]
        del self.history[snap["n_hist"]:]
        self.policy.rollback(self.step_idx)
        if self.net_des is not None and self.n_ps > 1:
            moves = list(self.ledger.owner)
            self.net_des.set_shard_owners(moves)
            self.tel.record("rebalance", self.sim.now, owner=tuple(moves))
        self._ps_down = False
        self._visible = (self.version, self.params)
        self.tel.record("ps_failover", self.sim.now, ps=ps,
                        step=self.step_idx, n_hist=snap["n_hist"])
        if isinstance(self.policy, BSPPolicy):
            for wk in self.workers:
                if wk.state == "draining":
                    # its drain iteration was cancelled with the round;
                    # complete the leave instead of wedging the barrier
                    wk.state = "dead"
                    if wk._compute_eid is not None:
                        self.sim.cancel(wk._compute_eid)
                        wk._compute_eid = None
                    wk.busy = False
                    self.tel.record("lifecycle", self.sim.now,
                                    worker=wk.idx, state="dead",
                                    iteration=wk.it, reason="leave")
                    self.on_worker_dead(wk.idx, graceful=True)
            for wk in self.workers:
                if wk.state != "dead":
                    wk.reset_to(self.step_idx)
            for wk in self.workers:
                if wk.state != "dead":
                    wk._try_begin()
        else:
            self.wake_blocked()
        self.maybe_finish()

    def _fault_ps_recover(self, ps: int) -> None:
        moves = self.ledger.recover(ps)
        if moves and self.net_des is not None and self.n_ps > 1:
            self.net_des.set_shard_owners(list(self.ledger.owner))
            self.tel.record("rebalance", self.sim.now,
                            owner=tuple(self.ledger.owner))

    def _ckpt_path(self) -> str:
        return os.path.join(self._ckpt_dir, "runtime_ckpt")

    def _take_snapshot(self) -> None:
        """Periodic async snapshot on the Sim.every grid. In-memory by
        default, by reference (nothing writes params, optimizer state or
        residual in place, so a reference is a copy); with
        ``checkpoint_dir`` the params/opt tree also round-trips through
        repro_torch.checkpoint's npz archive."""
        self._snap = {
            "params": self.params,
            "opt_state": self.opt_state,
            "residual": self.residual,
            "version": self.version,
            "max_applied_iter": self.max_applied_iter,
            "step_idx": self.step_idx,
            "n_hist": len(self.history),
            "t": self.sim.now,
        }
        if self._ckpt_dir is not None:
            save_checkpoint(
                self._ckpt_path(),
                {"params": self.params, "opt_state": self.opt_state},
                step=self.step_idx)
        self.tel.record("checkpoint", self.sim.now, step=self.step_idx,
                        n_hist=len(self.history))

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def maybe_finish(self) -> None:
        if self._stopped or not self.workers:
            return
        if not all(wk.finished or wk.state == "dead"
                   for wk in self.workers):
            return
        if self._flight or self._bsp_round is not None:
            return
        if self._ps_down:
            return   # failover is scheduled; it restarts or finishes us
        if self.policy.pending_count():
            return
        self._stopped = True
        if self.net_des is not None:
            self.net_des.stop()
        if self._sampler_cancel is not None:
            self._sampler_cancel()
        if self._ckpt_cancel is not None:
            self._ckpt_cancel()
        if self._budget_cancel is not None:
            self._budget_cancel()

    _sampler_cancel = None

    def run(self, batches, *, epoch_steps: int = 0, eval_fn=None,
            eval_every: int = 0, log_every: int = 0,
            max_events: int = 200_000_000) -> List[Dict]:
        self._batches = list(batches)
        self.steps = len(self._batches)
        self._epoch_steps = epoch_steps
        self._eval_fn = eval_fn
        self._eval_every = eval_every
        self._log_every = log_every
        self.workers = [WorkerActor(self, i) for i in range(self.w)]
        if self._fault_cfg is not None and self.faults is None:
            # horizon estimate for the random churn draw: the schedule
            # only needs a rough upper bound on run length
            base = float(getattr(self.compute, "base", 0.05))
            t_end = max(self.steps * base * 3.0, 1.0)
            self.faults = schedule_from_config(self._fault_cfg, self.w, t_end)
        if self.faults is not None or self._ckpt_every > 0:
            self._take_snapshot()    # t=0 anchor: failover always has one
        if self._ckpt_every > 0:
            self._ckpt_cancel = self.sim.every(self._ckpt_every,
                                               self._take_snapshot)
        if self.faults is not None:
            self.faults.arm(self.sim, self.on_fault)
        if self._netfault_cfg is not None and self.net_faults is None:
            base = float(getattr(self.compute, "base", 0.05))
            t_end = max(self.steps * base * 3.0, 1.0)
            self.net_faults = netfault_schedule_from_config(
                self._netfault_cfg, self.topology, t_end)
        if self.net_faults is not None and len(self.net_faults) > 0 \
                and self.net_des is not None:
            # fabric faults armed: build the plane over the live DES
            # topology and turn on sender self-healing (RTO backoff +
            # blackhole abort -> on_flow_dead). An EMPTY schedule skips
            # all of this, so pipes stay unfaulted and senders keep the
            # exact unhealed timing (zero-fault parity pin).
            self.netfault_plane = NetFaultPlane(
                self.sim, self.net_des.topo, self.topology,
                seed=self.seed, on_event=self._on_netfault,
                on_path=self._on_path_state)
            self.net_faults.arm(self.sim, self.netfault_plane.dispatch)
            self.net_des.enable_healing(self.on_flow_dead)
        if self.budget is not None:
            self.budget.bind(self)
            self._budget_cancel = self.sim.every(self.budget.interval_s,
                                                 self.budget.tick)
        if self.net_des is not None and self.tel.enabled:
            # trunk-queue sampler: an actor hook on the shared clock.
            # The O(n_ps) topology walk lives HERE, on the wall grid —
            # never in a per-event hook (DESIGN.md §9/§12).
            interval = max(self.net.rtprop_ms * 1e-3, 1e-3)
            if self.tracker is not None:
                # tracker-active arm: per-trunk depths (feeds the trace
                # exporter's per-trunk counter tracks) + histograms.
                # Separate lambda so tracker="none" keeps the exact old
                # event payload, byte for byte.
                h_pend = self.metrics.histogram("queue/ps_pending")
                h_net = self.metrics.histogram("queue/trunk_max_pkts")
                sample_trunks = self.obs_cfg.sample_trunks

                def _sample():
                    depth = self.policy.pending_count()
                    net_depth = self.net_des.queue_depth_pkts()
                    h_pend.observe(depth)
                    h_net.observe(net_depth)
                    if sample_trunks:
                        self.tel.record(
                            "queue", self.sim.now, depth=depth,
                            net_depth=net_depth,
                            trunks=self.net_des.trunk_depths())
                    else:
                        self.tel.record("queue", self.sim.now, depth=depth,
                                        net_depth=net_depth)

                self._sampler_cancel = self.sim.every(interval, _sample)
            else:
                self._sampler_cancel = self.sim.every(
                    interval,
                    lambda: self.tel.record(
                        "queue", self.sim.now,
                        depth=self.policy.pending_count(),
                        net_depth=self.net_des.queue_depth_pkts()))
        if self.tracker is not None:
            self._perf0 = PERF.snapshot()
        for wk in self.workers:
            wk.start()
        self.sim.run(max_events=max_events)
        if self.sim.truncated:
            n_done = sum(1 for wk in self.workers
                         if wk.finished or wk.state == "dead")
            raise RuntimeError(
                f"co-simulation truncated at max_events={max_events} "
                f"(t={self.sim.now:.3f}s, {n_done}/{self.w} "
                f"workers finished) — raise max_events or shrink the "
                f"scenario; a truncated run must not pass as converged")
        if not self._stopped and self._ps_down:
            raise RuntimeError(
                "event loop drained while the PS was down — the failover "
                "event was lost; a wedged run must not pass as converged")
        if self.net_des is not None:
            self.net_des.stop()
        if self._sampler_cancel is not None:
            self._sampler_cancel()
        if self._ckpt_cancel is not None:
            self._ckpt_cancel()
        if self._budget_cancel is not None:
            self._budget_cancel()
        self._finalize_history()
        if self.tracker is not None:
            self._emit_observability()
        return self.history

    def _finalize_history(self) -> None:
        """Force the lazy device scalars the commit paths deferred (loss /
        realized fraction) into plain floats, AFTER the event loop has
        drained — one sync at the end instead of one per iteration."""
        for rec in self.history:
            for k in ("loss", "delivered"):
                v = rec.get(k)
                if v is not None and not isinstance(v, (int, float)):
                    rec[k] = float(v)
        for e in self.tel.events:
            v = e.get("loss")
            if v is not None and not isinstance(v, (int, float)):
                e["loss"] = float(v)

    def _emit_observability(self) -> None:
        """Final flush into the tracker (DESIGN.md §12), AFTER
        ``_finalize_history`` forced the lazy device scalars: per-step
        metric points from the history, the metrics-registry snapshot
        (PERF delta for this run, cumulative per-flow/per-switch
        protocol counters) folded into the run summary, then
        ``finish()`` — the only point where file I/O may block."""
        perf = PERF.snapshot()
        self.metrics.absorb(
            "sim", {k: v - self._perf0.get(k, 0) for k, v in perf.items()})
        if self.net_des is not None:
            self.metrics.absorb("flow", self.net_des.flow_stats())
        for rec in self.history:
            self.tracker.log_metrics(
                {k: v for k, v in rec.items()
                 if isinstance(v, (int, float))},
                step=int(rec["step"]))
        summary = dict(self.tel.summary())
        summary.update(self.metrics.snapshot())
        self.tracker.log_summary(summary)
        self.tracker.finish()

    def export_trace(self, path: str,
                     meta: Optional[dict] = None) -> dict:
        """Write this run's event stream as a Chrome trace (Perfetto-
        loadable; DESIGN.md §12). Call after ``run()``; returns the
        trace document."""
        base = {"policy": type(self.policy).__name__,
                "protocol": self.protocol, "transport": self.transport,
                "seed": self.seed}
        if meta:
            base.update(meta)
        return write_chrome_trace(path, self.tel.events, n_workers=self.w,
                                  n_ps=self.n_ps, meta=base)

    # throughput in items/sec of simulated wall-clock
    def throughput(self, items_per_step: int) -> float:
        if not self.history:
            return 0.0
        n_iters = (len(self.history) if isinstance(self.policy, BSPPolicy)
                   else self.steps)
        return items_per_step * n_iters / max(self.sim_time, 1e-12)
