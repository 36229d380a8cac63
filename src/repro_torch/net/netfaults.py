"""Network-layer fault plane: link/switch chaos for the netsim
(DESIGN.md §14). The port's numpy-only copy of the JAX package's
``net/netfaults.py``; it stays on the host.

``LinkFaultSchedule`` is the fabric-level sibling of the node-level
``runtime.faults.FaultSchedule``: a seeded, immutable, time-sorted list
of link and switch events, armed on the shared ``Sim`` clock and
dispatched through a ``NetFaultPlane`` that maps event targets onto the
live ``Topology`` pipes and ``AggSwitch`` instances. Determinism is the
contract — the same schedule against the same seeds replays the same
co-simulation event-for-event.

Event semantics (realized by ``NetFaultPlane.dispatch``):

  link_down      admin-down a named pipe. The pipe's ``link_gen`` bumps,
                 so every delivery already on the wire is fenced out at
                 arrival (the §9 generation pattern applied to the
                 physical layer — no silent delivery from a dead link).
                 New sends reroute onto the spine-redundant backup where
                 one exists, and blackhole otherwise. ``recover_s`` > 0
                 schedules the matching ``link_up``.
  link_up        admin-up the pipe.
  link_flap      a square-wave of down/up toggles: ``duty`` fraction of
                 each ``period_s`` spent down, for ``duration_s``.
  link_degrade   cut the line rate to ``rate_factor`` x base and/or add
                 ``extra_loss`` random loss; ``recover_s`` > 0 schedules
                 the matching ``link_restore``.
  link_restore   restore base rate/loss.
  switch_crash   crash every ``AggSwitch`` homed in the target rack:
                 pending partial reductions are lost (their members'
                 seqs stay un-ACKed — senders retransmit after
                 recovery), intake blackholes until ``switch_recover``.
  switch_recover bring the rack's switches back.
  partition      cut the target rack clean off the spine: uplink AND its
                 backup go down together (no reroute escape). ``heal``
                 reverses it; ``recover_s`` > 0 schedules it.
  heal           reconnect a partitioned rack.

Targets are strings: pipe names from the topology registry
(``"rack2/up"``, ``"ps0/trunk"``) for link events, ``"rack{r}"`` for
switch and partition events.

Safety guarantee for drawn schedules: ``LinkFaultSchedule.random`` never
admin-downs a trunk (a trunk has no redundant twin — downing it would
sever every path to that shard), never partitions a PS-home rack (that
would sever every *other* rack's path to the shard), and thins partition
/ switch-crash draws so at most ``max_cut`` racks are ever cut
concurrently — the fabric mirror of ``FaultSchedule.random``'s
``min_active`` thinning. ``max_concurrent_cut`` replays a schedule's cut
timeline and is what the property tests pin.
"""
from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np

from repro_torch.net.simcore import Pipe, Sim, Topology

LINK_FAULT_KINDS = (
    "link_down",
    "link_up",
    "link_flap",
    "link_degrade",
    "link_restore",
    "switch_crash",
    "switch_recover",
    "partition",
    "heal",
)

#: kinds whose active interval severs a rack's every path (used by the
#: cut-ceiling thinning and by ``max_concurrent_cut``)
_CUT_KINDS = ("partition", "switch_crash")


@dataclasses.dataclass(frozen=True)
class LinkFaultEvent:
    """One injected fabric fault on the sim clock."""

    t: float
    kind: str
    target: str = ""
    recover_s: float = 0.0     # auto-recovery delay (0 = permanent)
    rate_factor: float = 1.0   # link_degrade: line-rate multiplier
    extra_loss: float = 0.0    # link_degrade: added loss probability
    period_s: float = 0.0      # link_flap: square-wave period
    duty: float = 0.5          # link_flap: fraction of period spent down
    duration_s: float = 0.0    # link_flap: total flapping time

    def __post_init__(self):
        if self.kind not in LINK_FAULT_KINDS:
            raise ValueError(
                f"unknown link fault kind {self.kind!r}; expected one of "
                f"{LINK_FAULT_KINDS}")
        if self.t < 0:
            raise ValueError(f"fault time must be >= 0, got {self.t}")

    def label(self) -> str:
        """Human-readable marker text for trace exports (DESIGN.md §12),
        e.g. ``"link_flap rack1/up @0.10s (20.0ms duty 0.50 for 0.20s)"``."""
        s = f"{self.kind} {self.target} @{self.t:.2f}s"
        if self.kind == "link_flap":
            s += (f" ({self.period_s * 1e3:.1f}ms duty {self.duty:.2f} "
                  f"for {self.duration_s:.2f}s)")
        elif self.kind == "link_degrade":
            s += (f" (rate x{self.rate_factor:g} "
                  f"loss +{self.extra_loss:g})")
        elif self.recover_s:
            s += f" (+{self.recover_s:.2f}s recovery)"
        return s


def max_concurrent_cut(events: Iterable[LinkFaultEvent]) -> int:
    """Replay the cut timeline: the maximum number of racks severed at
    any one instant by partition / switch-crash intervals. A target
    with a ``recover_s`` interval heals automatically; an explicit
    ``heal`` / ``switch_recover`` event closes a permanent cut."""
    open_t: Dict[str, float] = {}
    ivals: List[Tuple[str, float, float]] = []
    for ev in sorted(events, key=lambda e: e.t):
        if ev.kind in _CUT_KINDS:
            if ev.target in open_t:
                continue
            if ev.recover_s > 0:
                ivals.append((ev.target, ev.t, ev.t + ev.recover_s))
            else:
                open_t[ev.target] = ev.t
        elif ev.kind in ("heal", "switch_recover") and ev.target in open_t:
            ivals.append((ev.target, open_t.pop(ev.target), ev.t))
    for tgt in sorted(open_t):
        ivals.append((tgt, open_t[tgt], math.inf))
    # merge per target, then sweep: count = distinct racks concurrently cut
    per: Dict[str, List[Tuple[float, float]]] = {}
    for tgt, t0, t1 in ivals:
        per.setdefault(tgt, []).append((t0, t1))
    edges: List[Tuple[float, int]] = []
    for tgt in sorted(per):
        merged: List[List[float]] = []
        for t0, t1 in sorted(per[tgt]):
            if merged and t0 <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], t1)
            else:
                merged.append([t0, t1])
        for t0, t1 in merged:
            edges.append((t0, +1))
            edges.append((t1, -1))
    depth = best = 0
    for _t, d in sorted(edges, key=lambda e: (e[0], -e[1])):
        depth += d
        best = max(best, depth)
    return best


class LinkFaultSchedule:
    """Ordered, deterministic fabric-fault timeline (pure data).

    Construct from an explicit event list, or draw one with
    ``LinkFaultSchedule.random``. ``arm`` registers every event on the
    shared clock exactly like ``FaultSchedule.arm``; dispatch goes
    through a ``NetFaultPlane`` (or any callable) so the schedule never
    holds live topology references.
    """

    def __init__(self, events: Iterable[LinkFaultEvent] = ()):
        evs = list(events)
        for ev in evs:
            if not isinstance(ev, LinkFaultEvent):
                raise TypeError(f"expected LinkFaultEvent, got {type(ev)!r}")
        # stable sort: ties keep insertion order (replay identical
        # regardless of assembly order)
        self.events: Tuple[LinkFaultEvent, ...] = tuple(
            sorted(evs, key=lambda e: e.t))

    def __len__(self) -> int:
        return len(self.events)

    def __iter__(self) -> Iterator[LinkFaultEvent]:
        return iter(self.events)

    def __repr__(self) -> str:
        return f"LinkFaultSchedule({list(self.events)!r})"

    def arm(self, sim: Sim,
            dispatch: Callable[[LinkFaultEvent], None]) -> None:
        """Schedule every event: ``dispatch(ev)`` fires at ``ev.t``."""
        for ev in self.events:
            sim.at(ev.t, lambda ev=ev: dispatch(ev))

    @classmethod
    def random(cls, spec, t_end: float, *, seed: int = 0,
               link_down_rate: float = 0.0,
               link_recover_s: float = 0.05,
               flap_rate: float = 0.0,
               flap_period_s: float = 0.02,
               flap_duty: float = 0.5,
               flap_duration_s: float = 0.2,
               degrade_rate: float = 0.0,
               degrade_rate_factor: float = 0.25,
               degrade_extra_loss: float = 0.05,
               degrade_duration_s: float = 0.2,
               switch_crash_at: Iterable[float] = (),
               switch_recover_s: float = 0.05,
               partition_at: Iterable[float] = (),
               partition_heal_s: float = 0.1,
               max_cut: int = 1) -> "LinkFaultSchedule":
        """Seeded random fabric chaos over ``[0, t_end]`` for ``spec``
        (a resolved ``repro_torch.net.topology.Topology`` / ``GatherSpec``).

        Down/flap draws are Poisson per rack uplink (reroutable via the
        spine-redundant backup, so they degrade rather than sever);
        degrade draws cover uplinks and trunks. Explicit switch crashes
        and partitions land round-robin on eligible racks. Trunks are
        never admin-downed, PS-home racks are never partitioned, and
        cuts are thinned to at most ``min(max_cut, racks - 1)``
        concurrently severed racks — a drawn schedule can never wedge
        the cluster (see module docstring).
        """
        if max_cut < 0:
            raise ValueError("max_cut must be >= 0")
        rng = np.random.default_rng(seed)
        hier = bool(getattr(spec, "hierarchical", False))
        racks = int(getattr(spec, "racks", 0)) if hier else 0
        uplinks = [f"rack{r}/up" for r in range(racks)]
        trunks = [f"ps{p}/trunk" for p in range(spec.n_ps)]
        raw: List[LinkFaultEvent] = []
        for link in uplinks:
            for rate, make in (
                (link_down_rate, lambda t, l=None: LinkFaultEvent(
                    t, "link_down", l, recover_s=link_recover_s)),
                (flap_rate, lambda t, l=None: LinkFaultEvent(
                    t, "link_flap", l, period_s=flap_period_s,
                    duty=flap_duty, duration_s=flap_duration_s)),
            ):
                if rate <= 0:
                    continue
                t = float(rng.exponential(1.0 / rate))
                while t < t_end:
                    raw.append(make(t, link))
                    t += float(rng.exponential(1.0 / rate))
        if degrade_rate > 0:
            for link in uplinks + trunks:
                t = float(rng.exponential(1.0 / degrade_rate))
                while t < t_end:
                    raw.append(LinkFaultEvent(
                        t, "link_degrade", link,
                        recover_s=degrade_duration_s,
                        rate_factor=degrade_rate_factor,
                        extra_loss=degrade_extra_loss))
                    t += float(rng.exponential(1.0 / degrade_rate))
        if hier and racks > 0:
            ps_homes = {spec.ps_rack(p) for p in range(spec.n_ps)}
            agg = bool(getattr(spec, "inetwork_agg", False))
            sw_racks = list(range(racks)) if agg else []
            part_racks = [r for r in range(racks) if r not in ps_homes]
            for i, t in enumerate(switch_crash_at):
                if sw_racks:
                    raw.append(LinkFaultEvent(
                        float(t), "switch_crash",
                        f"rack{sw_racks[i % len(sw_racks)]}",
                        recover_s=switch_recover_s))
            for i, t in enumerate(partition_at):
                if part_racks:
                    raw.append(LinkFaultEvent(
                        float(t), "partition",
                        f"rack{part_racks[i % len(part_racks)]}",
                        recover_s=partition_heal_s))
        raw.sort(key=lambda e: e.t)
        # cut-ceiling thinning: replay the cut timeline, dropping any
        # partition/switch-crash whose interval would push the number of
        # concurrently severed racks past the ceiling
        ceiling = min(max_cut, max(racks - 1, 0))
        active: List[Tuple[float, str]] = []   # (heal time, rack)
        kept: List[LinkFaultEvent] = []
        for ev in raw:
            if ev.kind not in _CUT_KINDS:
                kept.append(ev)
                continue
            active = [(end, tgt) for end, tgt in active if end > ev.t]
            cut_now = {tgt for _end, tgt in active}
            if ev.target in cut_now or len(cut_now) >= ceiling:
                continue
            active.append((ev.t + ev.recover_s, ev.target))
            kept.append(ev)
        return cls(kept)


def netfault_schedule_from_config(cfg, spec,
                                  t_end: float) -> "LinkFaultSchedule":
    """Draw the schedule a ``repro_torch.config.NetFaultConfig`` describes,
    once the run horizon ``t_end`` is known."""
    return LinkFaultSchedule.random(
        spec, t_end, seed=cfg.seed,
        link_down_rate=cfg.link_down_rate,
        link_recover_s=cfg.link_recover_s,
        flap_rate=cfg.flap_rate, flap_period_s=cfg.flap_period_s,
        flap_duty=cfg.flap_duty, flap_duration_s=cfg.flap_duration_s,
        degrade_rate=cfg.degrade_rate,
        degrade_rate_factor=cfg.degrade_rate_factor,
        degrade_extra_loss=cfg.degrade_extra_loss,
        degrade_duration_s=cfg.degrade_duration_s,
        switch_crash_at=cfg.switch_crash_at,
        switch_recover_s=cfg.switch_recover_s,
        partition_at=cfg.partition_at,
        partition_heal_s=cfg.partition_heal_s,
        max_cut=cfg.max_cut)


class NetFaultPlane:
    """Maps schedule events onto the live fabric (DESIGN.md §14).

    ``install`` marks every registered pipe faultable (their deliveries
    start riding the ``link_gen`` fence) and, on hierarchical fabrics,
    attaches a spine-redundant backup pipe to every rack uplink — the
    second spine plane that ``link_down`` reroutes onto and that only a
    ``partition`` cuts together with the primary. Installation happens
    lazily on the first dispatched event, so a runtime carrying an empty
    schedule never touches the fabric at all (the zero-fault parity
    pin).

    ``on_event`` (if set) fires once per dispatched schedule event;
    ``on_path`` (if set) fires as ``on_path(kind, target)`` for derived
    path-state changes: ``"reroute"`` when a downed link's traffic
    diverts onto its backup, ``"blackhole"`` when no escape exists.
    Both are telemetry taps — the runtime records them.
    """

    def __init__(self, sim: Sim, topo: Topology, spec, *, seed: int = 0,
                 on_event: Optional[Callable[[LinkFaultEvent], None]] = None,
                 on_path: Optional[Callable[[str, str], None]] = None):
        self.sim = sim
        self.topo = topo
        self.spec = spec
        self.seed = seed
        self.on_event = on_event
        self.on_path = on_path
        self.installed = False
        self.n_reroutes = 0     # link cuts that found a live backup
        self.n_blackholes = 0   # link cuts with no escape path

    # -- fabric arming -------------------------------------------------------
    def install(self) -> None:
        if self.installed:
            return
        self.installed = True
        for name in sorted(self.topo.pipes):
            self.topo.pipes[name].faultable = True
        if getattr(self.spec, "hierarchical", False):
            for r in range(self.spec.racks):
                p = self.topo.pipes.get(f"rack{r}/up")
                if p is None or p.backup is not None:
                    continue
                bk = Pipe(self.sim, p.rate, p.delay, p.loss, p.cap,
                          np.random.default_rng(
                              self.seed * 7919 + 104729 + r),
                          p.overhead)
                bk.faultable = True
                p.backup = self.topo.add_pipe(f"rack{r}/backup", bk,
                                              group="backup")

    # -- dispatch ------------------------------------------------------------
    def dispatch(self, ev: LinkFaultEvent) -> None:
        """Realize one schedule event on the fabric (the ``arm`` target)."""
        self.install()
        if self.on_event is not None:
            self.on_event(ev)
        k = ev.kind
        if k == "link_down":
            self._set_link(ev.target, False)
            if ev.recover_s > 0:
                self.sim.after(ev.recover_s,
                               partial(self._set_link, ev.target, True))
        elif k == "link_up":
            self._set_link(ev.target, True)
        elif k == "link_flap":
            period = max(ev.period_s, 1e-9)
            down_s = min(max(ev.duty, 0.0), 1.0) * period
            n = max(1, int(round(ev.duration_s / period)))
            for i in range(n):
                self.sim.after(i * period,
                               partial(self._set_link, ev.target, False))
                self.sim.after(i * period + down_s,
                               partial(self._set_link, ev.target, True))
        elif k == "link_degrade":
            pipe = self.topo.pipes[ev.target]
            pipe.set_degraded(ev.rate_factor, ev.extra_loss)
            if ev.recover_s > 0:
                self.sim.after(ev.recover_s, pipe.clear_degraded)
        elif k == "link_restore":
            self.topo.pipes[ev.target].clear_degraded()
        elif k == "switch_crash":
            self._set_switches(ev.target, False)
            if ev.recover_s > 0:
                self.sim.after(ev.recover_s,
                               partial(self._set_switches, ev.target, True))
        elif k == "switch_recover":
            self._set_switches(ev.target, True)
        elif k == "partition":
            self._set_partition(ev.target, True)
            if ev.recover_s > 0:
                self.sim.after(ev.recover_s,
                               partial(self._set_partition, ev.target,
                                       False))
        elif k == "heal":
            self._set_partition(ev.target, False)

    # -- realizations --------------------------------------------------------
    def _set_link(self, name: str, up: bool) -> None:
        pipe = self.topo.pipes[name]
        was = pipe.up
        pipe.set_up(up)
        if was and not up:
            if pipe.backup is not None and pipe.backup.up:
                self.n_reroutes += 1
                if self.on_path is not None:
                    self.on_path("reroute", name)
            else:
                self.n_blackholes += 1
                if self.on_path is not None:
                    self.on_path("blackhole", name)

    @staticmethod
    def _rack_of(target: str) -> int:
        return int(target[4:]) if target.startswith("rack") else int(target)

    def _set_switches(self, target: str, up: bool) -> None:
        r = self._rack_of(target)
        aggs = getattr(self.topo, "aggs", None) or {}
        for key in sorted(aggs):
            if key[1] == r:
                if up:
                    aggs[key].recover()
                else:
                    aggs[key].crash()
        if not up:
            self.n_blackholes += 1
            if self.on_path is not None:
                self.on_path("blackhole", target)

    def _set_partition(self, target: str, cut: bool) -> None:
        r = self._rack_of(target)
        pipe = self.topo.pipes.get(f"rack{r}/up")
        if pipe is None:
            return
        pipe.set_up(not cut)
        if pipe.backup is not None:
            pipe.backup.set_up(not cut)
        if cut:
            self.n_blackholes += 1
            if self.on_path is not None:
                self.on_path("blackhole", target)
