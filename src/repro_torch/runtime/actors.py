"""Worker / PS actors on the runtime's shared event clock (DESIGN.md §8).

A ``WorkerActor`` is the per-worker state machine: (policy gate) ->
fetch params -> compute (sampled from the compute model) -> hand the
gradient to the transport -> immediately attempt the next iteration.
Whether that attempt proceeds is the aggregation policy's call — bsp
blocks until the barrier commits, ssp blocks when the worker runs too
far ahead, async never blocks.

The ``PSActor`` is the admission side: every arriving gradient goes
through the policy, ready batches are folded into the model by the
runtime (which owns the model state), and too-stale arrivals are counted
out. Both actors only *schedule*; all numerical work lives in
``ClusterRuntime``.

Fault lifecycle (DESIGN.md §10): a worker slot moves through
``joining -> active -> draining -> dead``. ``crash()`` is the hard
transition (compute cancelled, in-flight traffic fenced by the
transport's generation bump); ``retire()`` is the graceful leave (the
current iteration drains, then the slot goes dead); ``rejoin()``
re-activates a dead slot at the committed frontier, charging the
compute model's ``rejoin_penalty_s`` to the first iteration back.
With no faults scheduled every slot stays ``active`` for the whole run
and none of these paths execute.
"""
from __future__ import annotations

from typing import TYPE_CHECKING

from repro_torch.runtime.policies import PendingGrad

if TYPE_CHECKING:
    from repro_torch.runtime.runtime import ClusterRuntime


class WorkerActor:
    def __init__(self, rt: "ClusterRuntime", idx: int):
        self.rt = rt
        self.idx = idx
        self.it = 0
        self.blocked = False
        self.busy = False      # a compute event for self.it is in flight
        self.params_version = 0
        self.params_snap = None
        self.finished = False
        self.state = "active"  # joining | active | draining | dead
        self._compute_eid = None
        self._rejoin_pending = False  # charge rejoin_penalty_s next compute
        # pre-bound instrument (DESIGN.md §12): attribute deref + one
        # reservoir observe per compute — never a name lookup per event.
        # None when no tracker is attached, so the no-observability path
        # pays a single is-None branch.
        self._h_compute = (rt.metrics.histogram("worker/compute_s")
                           if rt.tracker is not None else None)

    def start(self) -> None:
        self._try_begin()

    # -- fault lifecycle ----------------------------------------------------
    def crash(self) -> None:
        """Hard failure: the in-flight compute event is cancelled and the
        slot goes dead. Transport fencing is the runtime's job."""
        rt = self.rt
        if self.state == "dead":
            return
        self.state = "dead"
        if self._compute_eid is not None:
            rt.sim.cancel(self._compute_eid)
            self._compute_eid = None
        self.busy = False
        if self.blocked:
            self.blocked = False
            rt._blocked.discard(self.idx)
        rt.tel.record("lifecycle", rt.sim.now, worker=self.idx,
                      state="dead", iteration=self.it, reason="crash")

    def retire(self) -> None:
        """Graceful leave: finish the current iteration (its gradient
        still counts), then go dead."""
        rt = self.rt
        if self.state == "dead":
            return
        if self.busy:
            self.state = "draining"
            rt.tel.record("lifecycle", rt.sim.now, worker=self.idx,
                          state="draining", iteration=self.it)
            return
        self.state = "dead"
        if self.blocked:
            self.blocked = False
            rt._blocked.discard(self.idx)
        rt.tel.record("lifecycle", rt.sim.now, worker=self.idx,
                      state="dead", iteration=self.it, reason="leave")

    def rejoin(self, at_iteration: int) -> None:
        """Re-activate a dead slot at ``at_iteration`` (the committed
        frontier for bsp, the current step for async/ssp)."""
        rt = self.rt
        rt.tel.record("lifecycle", rt.sim.now, worker=self.idx,
                      state="joining", iteration=int(at_iteration))
        self.state = "active"
        self.finished = False
        self.busy = False
        self.it = int(at_iteration)
        self._rejoin_pending = True
        rt.tel.record("lifecycle", rt.sim.now, worker=self.idx,
                      state="active", iteration=self.it, reason="join")
        self._try_begin()

    def reset_to(self, iteration: int) -> None:
        """PS failover rolled the model back: cancel any in-flight
        compute and re-anchor this slot at ``iteration``."""
        rt = self.rt
        if self.state == "dead":
            return
        if self._compute_eid is not None:
            rt.sim.cancel(self._compute_eid)
            self._compute_eid = None
        self.busy = False
        self.finished = False
        self._rejoin_pending = False
        if self.blocked:
            self.blocked = False
            rt._blocked.discard(self.idx)
        self.it = int(iteration)

    def _try_begin(self) -> None:
        rt = self.rt
        if self.busy or self.finished or self.state != "active":
            return   # wake paths may overlap; one compute per iteration
        if self.it >= rt.steps:
            if self.blocked:
                self.blocked = False
                rt._blocked.discard(self.idx)
                rt.tel.record("unblock", rt.sim.now, worker=self.idx,
                              iteration=self.it)
            if not self.finished:
                self.finished = True
                rt.on_worker_finished(self.idx)
            return
        if not rt.policy.may_start(self.idx, self.it):
            if not self.blocked:
                self.blocked = True
                rt._blocked.add(self.idx)
                rt.tel.record("block", rt.sim.now, worker=self.idx,
                              iteration=self.it)
            return
        if self.blocked:
            self.blocked = False
            rt._blocked.discard(self.idx)
            rt.tel.record("unblock", rt.sim.now, worker=self.idx,
                          iteration=self.it)
        rt.policy.on_start(self.idx, self.it)
        self.params_version, self.params_snap = rt.visible_params()
        dt = rt.compute.sample(self.idx, self.it)
        if self._rejoin_pending:
            dt += getattr(rt.compute, "rejoin_penalty_s", 0.0)
            self._rejoin_pending = False
        it = self.it
        if self._h_compute is not None:
            self._h_compute.observe(dt)
        rt.tel.record("compute_start", rt.sim.now, worker=self.idx,
                      iteration=it, dt=dt)
        self.busy = True
        self._compute_eid = rt.sim.after(dt, lambda: self._grad_ready(it))
        # starting an iteration advances this worker's clock, which may
        # release SSP peers parked on the staleness bound
        rt.wake_blocked(exclude=self.idx)

    def _grad_ready(self, it: int) -> None:
        rt = self.rt
        if self.state == "dead":
            return   # crash raced the compute event; the slot is fenced
        self.busy = False
        self._compute_eid = None
        rt.tel.record("grad_ready", rt.sim.now, worker=self.idx, iteration=it)
        rt.on_grad_ready(self, it)
        if self.state == "draining":
            # graceful leave: this iteration's gradient is in flight /
            # delivered; the slot now exits the membership
            self.state = "dead"
            rt.tel.record("lifecycle", rt.sim.now, worker=self.idx,
                          state="dead", iteration=it, reason="leave")
            rt.on_worker_dead(self.idx, graceful=True)
            return
        self.it = it + 1
        self._try_begin()


class PSActor:
    """Admission + flush loop over the aggregation policy."""

    def __init__(self, rt: "ClusterRuntime"):
        self.rt = rt
        # pre-bound instrument (DESIGN.md §12; see WorkerActor)
        self._h_stale = (rt.metrics.histogram("ps/arrival_staleness")
                         if rt.tracker is not None else None)

    def on_arrival(self, g: PendingGrad) -> None:
        rt = self.rt
        if rt._ps_down:
            # the PS is between failure and failover restore: arrivals
            # have nowhere to land and are counted out, not parked
            rt.tel.record("ps_lost", rt.sim.now, worker=g.worker,
                          iteration=g.iteration)
            rt.maybe_finish()
            return
        if self._h_stale is not None:
            self._h_stale.observe(g.staleness)
        rt.tel.record("grad_arrived", rt.sim.now, worker=g.worker,
                      iteration=g.iteration, staleness=g.staleness,
                      delivered=float(g.payload["frac"]))
        # O(1) sample: PS pending depth only. Trunk queue depths are
        # sampled on the runtime's Sim.every wall grid, NOT per arrival —
        # a topology walk per gradient would put an O(pipes) cost on the
        # hot path (DESIGN.md §9).
        rt.policy.on_arrival(g)
        rt.tel.record("queue", rt.sim.now, depth=rt.policy.pending_count())
        self.flush()

    def flush(self) -> None:
        rt = self.rt
        for g in rt.policy.drained_stale():
            rt.tel.record("stale_drop", rt.sim.now, worker=g.worker,
                          iteration=g.iteration, staleness=g.staleness)
        batch = rt.policy.ready()
        while batch:
            rt.apply_batch(batch)
            batch = rt.policy.ready()
        rt.maybe_finish()
