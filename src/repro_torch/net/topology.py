"""Topology-first construction surface (DESIGN.md §11).

A numpy-only copy of the JAX package's ``net/topology.py``: the port
keeps its own copy rather than importing it. The lockstep trainer reads
``n_ps`` and the worker-count check; the packet-level simulator
(``scenarios``, the runtime's ``DESTransport``) reads the rack/spine
fields.

One builder module owns every cluster shape the simulator can run:

  ``flat(...)``        the paper's topology: W workers behind one shared
                       trunk per PS shard (``n_ps=1`` is the single-PS
                       incast).
  ``multi_ps(n)``      flat, sharded over n parameter servers — one
                       trunk (pipe group) per shard.
  ``rack_spine(...)``  two-tier DC fabric: ``racks`` racks of
                       ``workers_per_rack`` workers behind ToR switches,
                       oversubscribed uplinks to a spine (``oversub``),
                       PS shard placement as a tunable (``ps_racks``),
                       and optional in-network aggregation at the ToRs
                       (``repro_torch.net.aggtree``, DESIGN.md §11).

Builders return a ``Topology`` — a declarative description accepted by
every scenario, runtime, and benchmark entry point (``topology=``).
``Topology`` extends ``GatherSpec``, so everything that composed with
specs (heterogeneous access links, cross traffic) composes with racks,
and every internal plumb that typed against ``GatherSpec`` accepts a
``Topology`` unchanged.

The scattered construction surface this module replaces —
``PSTrainer(n_ps=)``, ``ClusterRuntime(n_ps=, spec=)``,
``DESTransport(n_ps=, spec=)`` — survives as thin aliases emitting
``APIDeprecationWarning`` (promoted to an error under pytest so the old
spelling cannot creep back in-tree).
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.config import NetConfig


class APIDeprecationWarning(DeprecationWarning):
    """A deprecated construction kwarg was used (DESIGN.md §11).

    A subclass so the test run can promote exactly OUR deprecations to
    errors without tripping over third-party ``DeprecationWarning``s.
    """


def warn_deprecated(old: str, new: str) -> None:
    warnings.warn(
        f"{old} is deprecated; use {new} (repro_torch.net.topology builders)",
        APIDeprecationWarning, stacklevel=3)


@dataclasses.dataclass
class GatherSpec:
    """Topology description for one gather scenario (DESIGN.md §5).

    The default spec is the paper's setup: one PS behind one shared
    bottleneck, homogeneous workers, no background load. Every field
    composes with every other. ``Topology`` (below) extends this with
    the rack/spine tier; build instances through ``flat``/``multi_ps``/
    ``rack_spine`` rather than by hand.
    """

    n_ps: int = 1
    # per-worker access-link heterogeneity; None -> workers attach to the
    # trunk directly (no extra hop), exactly the paper topology.
    worker_rate_mult: Optional[np.ndarray] = None   # (W,) x trunk rate
    worker_delay_ms: Optional[np.ndarray] = None    # (W,) extra one-way ms
    worker_loss: Optional[np.ndarray] = None        # (W,) access loss prob
    # open-loop background load per PS trunk, as a fraction of line rate
    # offered during ON bursts (see CrossTrafficSource).
    cross_traffic_load: float = 0.0
    cross_on_ms: float = 5.0
    cross_off_ms: float = 5.0

    @property
    def heterogeneous(self) -> bool:
        return (self.worker_rate_mult is not None
                or self.worker_delay_ms is not None
                or self.worker_loss is not None)

    @property
    def hierarchical(self) -> bool:
        return False    # overridden by Topology

    def access_params(self, f: int, net: NetConfig) -> Tuple[float, float, float]:
        """(rate_bps, one-way delay s, loss) of worker f's access link."""
        bw = net.bandwidth_gbps * 1e9
        rate = bw * (self.worker_rate_mult[f]
                     if self.worker_rate_mult is not None else 1.0)
        delay = (self.worker_delay_ms[f] * 1e-3
                 if self.worker_delay_ms is not None else 0.0)
        loss = (float(self.worker_loss[f])
                if self.worker_loss is not None else 0.0)
        return rate, delay, loss

    def worker_share_bps(self, f: int, w: int, net: NetConfig) -> float:
        """Worker f's attainable per-shard rate: min(trunk fair share,
        its access-link share across the n_ps concurrent shard flows)."""
        bw = net.bandwidth_gbps * 1e9
        share = bw / w
        if self.worker_rate_mult is not None:
            share = min(share, bw * self.worker_rate_mult[f] / self.n_ps)
        return share


@dataclasses.dataclass
class Topology(GatherSpec):
    """Declarative cluster topology (builder result, DESIGN.md §11).

    ``racks == 0`` (the default) is the flat paper topology — a
    ``Topology`` then behaves exactly like the ``GatherSpec`` it
    extends. With ``racks > 0`` the gather becomes multi-hop: worker →
    ToR → (oversubscribed uplink) → spine → PS trunk, with shard ``p``
    optionally homed inside rack ``ps_racks[p]`` (its rack-mates skip
    the uplink and its oversubscription).

    ``inetwork_agg`` places an ``AggSwitch`` per (shard, rack) at the
    ToR: same-(shard, seq) packets from rack members are combined into
    one upstream wire packet (MLFabric-style partial reduction in the
    network), flushed in seq order — see ``repro_torch.net.aggtree``.
    """

    racks: int = 0
    workers_per_rack: int = 0
    oversub: float = 1.0            # rack uplink = wpr x bw / oversub
    ps_racks: Optional[Tuple[int, ...]] = None  # shard p homed in rack
    #                                             ps_racks[p]; None = spine
    inetwork_agg: bool = False
    agg_hold_ms: float = 0.0        # ToR flush hold; 0 -> 0.25 x rtprop
    name: str = "flat"

    @property
    def hierarchical(self) -> bool:
        return self.racks > 0

    @property
    def n_workers(self) -> Optional[int]:
        """Worker count implied by the rack grid (None when flat)."""
        if not self.hierarchical:
            return None
        return self.racks * self.workers_per_rack

    def rack_of(self, f: int) -> int:
        return f // self.workers_per_rack

    def rack_members(self, r: int) -> List[int]:
        w0 = r * self.workers_per_rack
        return list(range(w0, w0 + self.workers_per_rack))

    def ps_rack(self, p: int) -> Optional[int]:
        """Rack housing shard p's server (None = attached at the spine)."""
        if self.ps_racks is None:
            return None
        return self.ps_racks[p]

    def uplink_bps(self, net: NetConfig) -> float:
        """ToR→spine uplink rate: the rack's aggregate injection rate
        derated by the oversubscription ratio."""
        return self.workers_per_rack * net.bandwidth_gbps * 1e9 / self.oversub

    def validate_workers(self, w: int, owner: str = "topology") -> None:
        if self.hierarchical and w != self.n_workers:
            raise ValueError(
                f"{owner}: n_workers={w} does not match the rack grid "
                f"{self.racks} x {self.workers_per_rack} = {self.n_workers}")

    def worker_share_bps(self, f: int, w: int, net: NetConfig) -> float:
        """Attainable per-shard rate on the rack fabric — feeds the
        Early-Close LT init formula (paper §III), so slow uplinks start
        with honest thresholds instead of flat-trunk optimism."""
        share = super().worker_share_bps(f, w, net)
        if not self.hierarchical:
            return share
        bw = net.bandwidth_gbps * 1e9
        up = self.uplink_bps(net)
        if self.inetwork_agg:
            # the worker's packets ride its rack's ONE merged flow per
            # shard: uplink split over n_ps merged flows, trunk over racks
            return min(up / self.n_ps, bw / max(self.racks, 1))
        # per-worker flow: trunk shared by all W, uplink shared by the
        # rack's wpr workers x n_ps concurrent shard flows each
        return min(share, up / (self.workers_per_rack * self.n_ps))


# ----------------------------------------------------------------------------
# builders — the public construction surface
# ----------------------------------------------------------------------------


def flat(n_ps: int = 1, **kw: Any) -> Topology:
    """The paper's topology: workers behind one shared trunk per PS
    shard. Extra ``GatherSpec`` fields (heterogeneous access links,
    cross traffic) pass through as keywords."""
    if n_ps < 1:
        raise ValueError(f"n_ps must be >= 1, got {n_ps}")
    return Topology(n_ps=n_ps, name="flat" if n_ps == 1 else f"flat_ps{n_ps}",
                    **kw)


def multi_ps(n_ps: int, **kw: Any) -> Topology:
    """Flat sharded gather: n_ps parameter servers, one trunk each."""
    return flat(n_ps=n_ps, **kw)


def rack_spine(racks: int, workers_per_rack: int, *, oversub: float = 4.0,
               n_ps: int = 1, ps_racks: Optional[Tuple[int, ...]] = None,
               agg: bool = True, agg_hold_ms: float = 0.0,
               **kw: Any) -> Topology:
    """Two-tier rack/spine fabric (DESIGN.md §11).

    ``oversub`` is the ToR uplink oversubscription ratio (uplink rate =
    workers_per_rack x link rate / oversub; 1.0 = non-blocking).
    ``ps_racks`` homes shard p inside rack ps_racks[p] — its rack-mates
    reach it without paying the uplink; None attaches every PS at the
    spine. ``agg=True`` enables in-network aggregation at the ToRs for
    LTP flows (order-aware partial reduction, ``repro_torch.net.aggtree``).
    """
    if racks < 1 or workers_per_rack < 1:
        raise ValueError(
            f"rack grid must be positive, got {racks} x {workers_per_rack}")
    if oversub <= 0:
        raise ValueError(f"oversub must be > 0, got {oversub}")
    if n_ps < 1:
        raise ValueError(f"n_ps must be >= 1, got {n_ps}")
    if ps_racks is not None:
        ps_racks = tuple(int(r) for r in ps_racks)
        if len(ps_racks) != n_ps:
            raise ValueError(
                f"ps_racks must name a rack per shard: got {len(ps_racks)} "
                f"entries for n_ps={n_ps}")
        bad = [r for r in ps_racks if not 0 <= r < racks]
        if bad:
            raise ValueError(f"ps_racks out of range [0, {racks}): {bad}")
    return Topology(
        n_ps=n_ps, racks=racks, workers_per_rack=workers_per_rack,
        oversub=float(oversub), ps_racks=ps_racks, inetwork_agg=bool(agg),
        agg_hold_ms=float(agg_hold_ms),
        name=f"rack{racks}x{workers_per_rack}"
             f"{'_agg' if agg else ''}_os{oversub:g}", **kw)


# ----------------------------------------------------------------------------
# coercion + deprecation shims
# ----------------------------------------------------------------------------


def as_topology(spec: GatherSpec) -> Topology:
    """Coerce any ``GatherSpec`` to a ``Topology`` (identity when it
    already is one) so the runtime can rely on the extended surface."""
    if isinstance(spec, Topology):
        return spec
    fields = {f.name: getattr(spec, f.name)
              for f in dataclasses.fields(GatherSpec)}
    return Topology(**fields)


def resolve_topology(topology: Optional[GatherSpec], *,
                     n_ps: Optional[int] = None,
                     spec: Optional[GatherSpec] = None,
                     owner: str = "caller") -> Topology:
    """One resolution rule for every entry point: the new ``topology=``
    kwarg wins; the deprecated ``n_ps=`` / ``spec=`` aliases still work
    but emit ``APIDeprecationWarning``; nothing given -> single-PS flat.
    """
    if topology is not None:
        if spec is not None or n_ps is not None:
            raise ValueError(
                f"{owner}: pass either topology= or the deprecated "
                f"n_ps=/spec= aliases, not both")
        return as_topology(topology)
    if spec is not None:
        warn_deprecated(f"{owner}(spec=...)", f"{owner}(topology=...)")
        if n_ps is not None and n_ps != spec.n_ps:
            raise ValueError(
                f"{owner}: spec.n_ps={spec.n_ps} contradicts n_ps={n_ps}")
        return as_topology(spec)
    if n_ps is not None:
        warn_deprecated(f"{owner}(n_ps=...)",
                        f"{owner}(topology=multi_ps({n_ps}))")
        return multi_ps(n_ps)
    return flat()
