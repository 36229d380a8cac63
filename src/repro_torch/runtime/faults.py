"""Deterministic fault injection for the cluster runtime (DESIGN.md §10).

A ``FaultSchedule`` is a seeded, immutable list of node-level events —
worker crash / join / leave and PS failure — placed on the runtime's
shared ``Sim`` clock before the run starts. Determinism is the whole
point: the same schedule against the same runtime seed replays the same
co-simulation event-for-event, so chaos runs are pinnable in tests.

Event semantics (enforced by ``ClusterRuntime.on_fault``):

  worker_crash   immediate death: in-flight compute is cancelled and
                 in-flight flows are torn down through the generation
                 fencing protocol (the receiver generation bumps, so any
                 packet the dead node still has in flight is provably
                 dropped as stale).
  worker_leave   graceful drain: the worker finishes the iteration it is
                 computing, its gradient is allowed to deliver, then the
                 slot retires. No teardown.
  worker_join    a previously departed slot re-enters: it fetches the
                 current params (one broadcast delay), optionally pays a
                 compute warm-up penalty, and resumes. Joining an alive
                 slot is a no-op — the cluster's slot universe is fixed
                 at ``n_workers`` (the per-worker batch shapes), so
                 elasticity is membership over slots, not slot creation.
  ps_fail        the parameter server dies for ``recover_s`` sim-seconds.
                 Pending and in-flight gradients are lost; on failover
                 the PS restores the last ``repro_torch.checkpoint`` snapshot
                 and, with ``n_ps > 1``, the dead shard's transport
                 ownership rebalances onto the surviving PSes
                 (``ShardLedger``).
  ps_recover     the failed PS process returns; shard ownership
                 rebalances back to the home assignment.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, Iterator, List, Optional, Tuple

import numpy as np

FAULT_KINDS = (
    "worker_crash",
    "worker_join",
    "worker_leave",
    "ps_fail",
    "ps_recover",
)


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One injected fault on the sim clock."""

    t: float
    kind: str
    target: int = 0          # worker slot or PS index
    recover_s: float = 0.0   # ps_fail only: downtime before failover

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; expected one of "
                f"{FAULT_KINDS}")
        if self.t < 0:
            raise ValueError(f"fault time must be >= 0, got {self.t}")

    def label(self) -> str:
        """Human-readable marker text for trace exports (DESIGN.md §12),
        e.g. ``"crash worker3 @12.50s"``. The unit derives from the kind
        prefix — a kind that names neither a worker nor a PS (the
        network fault plane's link/switch events render through the same
        trace path) carries its target verbatim instead of being
        mislabelled ``worker{target}``."""
        if self.kind.startswith("ps_"):
            unit = "ps"
        elif self.kind.startswith("worker_"):
            unit = "worker"
        else:
            unit = ""
        s = f"{self.kind} {unit}{self.target} @{self.t:.2f}s"
        if self.recover_s:
            s += f" (+{self.recover_s:.2f}s recovery)"
        return s


class FaultSchedule:
    """Ordered, deterministic fault timeline.

    Construct from an explicit event list, or draw one with
    ``FaultSchedule.random`` (seeded Poisson churn that never drops the
    active set below ``min_active``). ``arm`` registers every event on
    the shared clock; dispatch happens through the runtime's
    ``on_fault`` so the schedule itself stays pure data.
    """

    def __init__(self, events: Iterable[FaultEvent] = ()):
        evs = list(events)
        for ev in evs:
            if not isinstance(ev, FaultEvent):
                raise TypeError(f"expected FaultEvent, got {type(ev)!r}")
        # stable sort: ties keep insertion order, so schedules replay
        # identically regardless of how they were assembled
        self.events: Tuple[FaultEvent, ...] = tuple(
            sorted(evs, key=lambda e: e.t))

    def __len__(self) -> int:
        return len(self.events)

    def __iter__(self) -> Iterator[FaultEvent]:
        return iter(self.events)

    def __repr__(self) -> str:
        return f"FaultSchedule({list(self.events)!r})"

    def arm(self, sim, dispatch: Callable[[FaultEvent], None]) -> None:
        """Schedule every event: ``dispatch(ev)`` fires at ``ev.t``."""
        for ev in self.events:
            sim.at(ev.t, lambda ev=ev: dispatch(ev))

    @classmethod
    def random(cls, n_workers: int, t_end: float, *, seed: int = 0,
               crash_rate: float = 0.0,
               rejoin_after_s: Optional[float] = None,
               leave_rate: float = 0.0,
               ps_fail_at: Iterable[float] = (),
               ps_recovery_s: float = 0.05,
               min_active: int = 1) -> "FaultSchedule":
        """Seeded random churn over ``[0, t_end]``.

        Worker crashes/leaves are Poisson per worker-second; a crashed
        worker rejoins ``rejoin_after_s`` later (never, if None). Events
        that would drop the active set below ``min_active`` are thinned
        out, so a drawn schedule can never wedge the cluster.
        """
        if min_active < 1:
            raise ValueError("min_active must be >= 1")
        rng = np.random.default_rng(seed)
        raw: List[FaultEvent] = []
        for w in range(n_workers):
            for rate, kind in ((crash_rate, "worker_crash"),
                               (leave_rate, "worker_leave")):
                if rate <= 0:
                    continue
                t = float(rng.exponential(1.0 / rate))
                while t < t_end:
                    raw.append(FaultEvent(t, kind, target=w))
                    if kind == "worker_crash" and rejoin_after_s is not None:
                        raw.append(FaultEvent(t + rejoin_after_s,
                                              "worker_join", target=w))
                    t += float(rng.exponential(1.0 / rate))
        for t in ps_fail_at:
            raw.append(FaultEvent(float(t), "ps_fail", target=0,
                                  recover_s=ps_recovery_s))
        raw.sort(key=lambda e: e.t)
        # replay the membership timeline, dropping departures that would
        # violate min_active and joins/leaves that no longer make sense
        active = set(range(n_workers))
        kept: List[FaultEvent] = []
        for ev in raw:
            if ev.kind in ("worker_crash", "worker_leave"):
                if ev.target not in active or len(active) <= min_active:
                    continue
                active.discard(ev.target)
            elif ev.kind == "worker_join":
                if ev.target in active:
                    continue
                active.add(ev.target)
            kept.append(ev)
        return cls(kept)


def schedule_from_config(cfg, n_workers: int, t_end: float) -> "FaultSchedule":
    """Draw the schedule a ``repro_torch.config.FaultConfig`` describes, once
    the run horizon ``t_end`` is known."""
    return FaultSchedule.random(
        n_workers, t_end, seed=cfg.seed, crash_rate=cfg.crash_rate,
        rejoin_after_s=cfg.rejoin_after_s, leave_rate=cfg.leave_rate,
        ps_fail_at=cfg.ps_fail_at, ps_recovery_s=cfg.ps_recovery_s,
        min_active=cfg.min_active)


class ShardLedger:
    """Shard → owning-PS map for transport-level failover rebalancing.

    The runtime's model state is one tree; PS shards exist at the
    transport layer (one trunk per shard). When a PS fails, the shards
    it owns re-home round-robin onto the surviving PSes so gather/
    broadcast traffic keeps flowing; ``recover`` restores the home
    assignment. ``moves`` lists ``(shard, old_owner, new_owner)`` for
    telemetry.
    """

    def __init__(self, n_ps: int):
        if n_ps < 1:
            raise ValueError("n_ps must be >= 1")
        self.n_ps = n_ps
        self.owner: List[int] = list(range(n_ps))
        self.alive: set = set(range(n_ps))

    @property
    def n_alive(self) -> int:
        return len(self.alive)

    def fail(self, ps: int) -> List[Tuple[int, int, int]]:
        """Mark ``ps`` dead; re-home its shards onto survivors."""
        if ps not in self.alive:
            return []
        self.alive.discard(ps)
        if not self.alive:
            # last PS down: ownership is moot until failover restores it
            return []
        survivors = sorted(self.alive)
        moves: List[Tuple[int, int, int]] = []
        for shard in range(self.n_ps):
            if self.owner[shard] == ps:
                new = survivors[shard % len(survivors)]
                moves.append((shard, ps, new))
                self.owner[shard] = new
        return moves

    def recover(self, ps: int) -> List[Tuple[int, int, int]]:
        """Bring ``ps`` back; its home shards return to it."""
        if ps in self.alive:
            return []
        self.alive.add(ps)
        moves: List[Tuple[int, int, int]] = []
        # home assignment is the identity map (shard i lives on PS i)
        for shard in range(self.n_ps):
            if shard == ps and self.owner[shard] != ps:
                moves.append((shard, self.owner[shard], ps))
                self.owner[shard] = ps
        return moves
