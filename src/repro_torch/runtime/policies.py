"""PS-side aggregation policies (DESIGN.md §8).

An ``AggregationPolicy`` decides, as gradients arrive at the PS over the
shared sim clock, (a) when to fold them into the model (``ready``),
(b) whether a worker may begin its next iteration (``may_start``), and
(c) how much each admitted gradient weighs (``weights`` — staleness
damping fed to ``ltp_sync.reduce_packet_stream``).

  bsp       full barrier: apply when all W gradients of the current
            iteration are in; workers lockstep. Reproduces the legacy
            ``PSTrainer`` loop to float tolerance (the runtime runs the
            same fused step on the same masks).
  async     apply-on-arrival with per-worker learning-rate damping
            1/(1 + damping * staleness); workers never block.
  ssp(k)    bounded staleness: a worker may run at most ``staleness``
            iterations ahead of the slowest; arrivals staler than k are
            rejected (counted, never folded in); pending reductions are
            admitted oldest-iteration-first (MLFabric-style aggregation
            ordering) with staleness-damped weights
            (``LTPConfig.staleness_comp``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Union

import numpy as np

from repro_torch.core.ltp_sync import staleness_weights


@dataclasses.dataclass
class PendingGrad:
    """One gradient parked at the PS awaiting admission."""

    worker: int
    iteration: int
    t_ready: float            # sim time the gradient arrived at the PS
    staleness: int = 0        # iterations behind the freshest applied
    payload: Any = None       # runtime-owned: flat packets, masks, frac, loss


#: name -> class; ``make_policy`` dispatches through this table.
POLICIES: Dict[str, type] = {}


def register_policy(name: str):
    def deco(cls):
        POLICIES[name] = cls
        cls.name = name
        return cls
    return deco


class AggregationPolicy:
    """Interface; concrete policies override the four decision hooks."""

    name = "?"
    active: frozenset = frozenset()

    def bind(self, n_workers: int) -> None:
        self.w = n_workers
        self.active = frozenset(range(n_workers))

    # -- degraded membership (DESIGN.md §10) --------------------------------
    def on_membership(self, active) -> None:
        """The fault layer's membership hook: ``active`` is the set of
        worker slots currently alive. bsp re-barriers on the surviving
        set; async/ssp rescale staleness damping and contribution
        weights by the effective membership."""
        self.active = frozenset(active)

    def membership_scale(self) -> float:
        """W / W_eff — restores the per-contribution effective step when
        fewer than W slots feed the 1/W reduction. 1.0 at full
        membership (and on an unbound policy, which some unit tests
        drive directly)."""
        w = getattr(self, "w", 0)
        n = len(getattr(self, "active", ()))
        if not w or not n or n == w:
            return 1.0
        return w / n

    # -- worker-side gate ---------------------------------------------------
    def may_start(self, worker: int, iteration: int) -> bool:
        return True

    def on_start(self, worker: int, iteration: int) -> None:
        pass

    # -- PS-side admission --------------------------------------------------
    def on_arrival(self, g: PendingGrad) -> None:
        raise NotImplementedError

    def ready(self) -> List[PendingGrad]:
        """Drain the batch to reduce+apply NOW (possibly empty)."""
        raise NotImplementedError

    def on_applied(self, batch: List[PendingGrad]) -> None:
        pass

    def weights(self, batch: List[PendingGrad]) -> Optional[np.ndarray]:
        """Per-gradient contribution weights (None = uniform 1)."""
        return None

    def drained_stale(self) -> List[PendingGrad]:
        """Gradients rejected as too stale since the last call."""
        return []

    def drop_pending(self) -> List[PendingGrad]:
        """Discard every parked gradient (PS failover tore the state from
        under them); returns the dropped batch for telemetry accounting."""
        return []

    def rollback(self, step: int) -> None:
        """PS failover restored the model at ``step`` applied iterations;
        policies with an iteration frontier re-anchor there."""

    def pending_count(self) -> int:
        """Gradients parked at the PS right now (telemetry queue depth)."""
        return 0


@register_policy("bsp")
class BSPPolicy(AggregationPolicy):
    """Bulk-synchronous barrier — the paper's (and legacy PSTrainer's)
    semantics: one fused reduction per iteration, workers lockstep."""

    def bind(self, n_workers: int) -> None:
        super().bind(n_workers)
        self.committed = 0                      # iterations fully applied
        self._buf: Dict[int, Dict[int, PendingGrad]] = {}

    def may_start(self, worker: int, iteration: int) -> bool:
        return iteration <= self.committed

    def on_arrival(self, g: PendingGrad) -> None:
        self._buf.setdefault(g.iteration, {})[g.worker] = g

    def ready(self) -> List[PendingGrad]:
        cur = self._buf.get(self.committed, {})
        if not self.active or not self.active <= set(cur):
            return []
        del self._buf[self.committed]
        return [cur[f] for f in sorted(cur)]

    def on_applied(self, batch: List[PendingGrad]) -> None:
        self.committed += 1

    def on_membership(self, active) -> None:
        # re-barrier on the surviving set: dead slots can no longer be
        # waited on, and their parked gradients are unreachable
        super().on_membership(active)
        for d in self._buf.values():
            for wk in [wk for wk in d if wk not in self.active]:
                del d[wk]
        self._buf = {it: d for it, d in self._buf.items() if d}

    def rollback(self, step: int) -> None:
        self.committed = int(step)
        self._buf.clear()

    def drop_pending(self) -> List[PendingGrad]:
        out = [g for d in self._buf.values() for g in d.values()]
        self._buf.clear()
        return out

    def pending_count(self) -> int:
        return sum(len(d) for d in self._buf.values())


@register_policy("async")
class AsyncPolicy(AggregationPolicy):
    """Apply-on-arrival: no barrier, no blocking. Staleness costs a
    learning-rate damp of 1/(1 + damping * staleness) per gradient
    (``ltp_sync.staleness_weights``). ``damping=None`` defers to
    ``LTPConfig.staleness_comp`` — the runtime wires it at bind time —
    so the config knob governs both async and SSP unless a policy
    instance overrides it explicitly."""

    def __init__(self, damping: Optional[float] = None):
        self.damping = None if damping is None else float(damping)

    def bind(self, n_workers: int) -> None:
        super().bind(n_workers)
        self._pending: List[PendingGrad] = []

    def on_arrival(self, g: PendingGrad) -> None:
        self._pending.append(g)

    def ready(self) -> List[PendingGrad]:
        batch, self._pending = self._pending, []
        return batch

    def weights(self, batch: List[PendingGrad]) -> Optional[np.ndarray]:
        wts = None
        if self.damping:
            wts = staleness_weights([g.staleness for g in batch],
                                    self.damping)
        scale = self.membership_scale()
        if scale != 1.0:
            # the runtime's apply divides by W; W/W_eff restores the mean
            # over the surviving contributors
            if wts is None:
                wts = np.ones(len(batch))
            wts = wts * scale
        return wts

    def drop_pending(self) -> List[PendingGrad]:
        out, self._pending = self._pending, []
        return out

    def pending_count(self) -> int:
        return len(self._pending)


@register_policy("ssp")
class SSPPolicy(AggregationPolicy):
    """Bounded staleness: worker clocks may spread at most ``staleness``
    iterations; admission is oldest-first with staleness-damped weights.

    ``staleness_comp`` is the damping coefficient for admitted-but-stale
    gradients (wired from ``LTPConfig.staleness_comp`` by the runtime);
    gradients staler than the bound are rejected outright.
    """

    def __init__(self, staleness: int = 2, staleness_comp: float = 0.0):
        if staleness < 0:
            raise ValueError("staleness bound must be >= 0")
        self.k = int(staleness)
        self.staleness_comp = float(staleness_comp)

    def bind(self, n_workers: int) -> None:
        super().bind(n_workers)
        self._clock = dict.fromkeys(range(n_workers), 0)  # next iteration
        self._pending: List[PendingGrad] = []
        self._stale: List[PendingGrad] = []

    def may_start(self, worker: int, iteration: int) -> bool:
        # membership-set order is irrelevant: only min(clocks) is used
        clocks = [self._clock[wk] for wk in self.active  # replint-torch: ok(determinism)
                  if wk in self._clock]
        if not clocks:
            clocks = [self._clock.get(worker, 0)]
        return iteration <= min(clocks) + self.k

    def on_start(self, worker: int, iteration: int) -> None:
        self._clock[worker] = iteration + 1

    def on_membership(self, active) -> None:
        # a dead slot's frozen clock must not gate the survivors; a
        # rejoiner is admitted at the surviving frontier so its stale
        # clock does not stall the bound either
        new = frozenset(active) - self.active
        super().on_membership(active)
        if new:
            cur = max((self._clock.get(wk, 0) for wk in self.active),
                      default=0)
            for wk in sorted(new):
                self._clock[wk] = max(self._clock.get(wk, 0), cur)

    def on_arrival(self, g: PendingGrad) -> None:
        if g.staleness > self.k:
            self._stale.append(g)
        else:
            self._pending.append(g)

    def ready(self) -> List[PendingGrad]:
        # MLFabric-style aggregation ordering: oldest iteration first, so
        # the reduction retires the laggard's work before fresher shards
        batch = sorted(self._pending, key=lambda g: (g.iteration, g.worker))
        self._pending = []
        return batch

    def weights(self, batch: List[PendingGrad]) -> Optional[np.ndarray]:
        wts = None
        if self.staleness_comp > 0:
            wts = staleness_weights([g.staleness for g in batch],
                                    self.staleness_comp)
        scale = self.membership_scale()
        if scale != 1.0:
            if wts is None:
                wts = np.ones(len(batch))
            wts = wts * scale
        return wts

    def drained_stale(self) -> List[PendingGrad]:
        out, self._stale = self._stale, []
        return out

    def drop_pending(self) -> List[PendingGrad]:
        out = self._pending + self._stale
        self._pending, self._stale = [], []
        return out

    def pending_count(self) -> int:
        return len(self._pending)


def make_policy(spec: Union[str, AggregationPolicy],
                **kw) -> AggregationPolicy:
    """Resolve a policy from an instance or a registered name. Extra
    kwargs go to the named policy's constructor, e.g.
    ``make_policy("ssp", staleness=3)``."""
    if isinstance(spec, AggregationPolicy):
        return spec
    try:
        cls = POLICIES[spec]
    except KeyError:
        raise ValueError(
            f"unknown aggregation policy {spec!r}; registered: "
            f"{sorted(POLICIES)}") from None
    return cls(**kw)
