"""Structured runtime telemetry (DESIGN.md §8) — now a thin façade over
the observability layer (DESIGN.md §12).

Every actor/policy event in a ``ClusterRuntime`` run lands here as one
flat dict — an append-only stream the benchmarks and tests consume
directly, and ``summary()`` reduces into the scalar fields the sweep
rows carry. The full event schema (kinds, payload fields, and the
chaos-suite conservation law) is documented in DESIGN.md §12.1; the
stream itself is unchanged by the façade split.

When a ``Tracker`` (``repro_torch.obs.tracker``) is attached, every recorded
event is also forwarded to it — one extra O(1) buffered append per
event, nothing more. With no tracker the stream behaves exactly as it
always has (``tracker="none"`` is bitwise-identical by construction).

Sampling discipline (DESIGN.md §9): per-event hooks record O(1)
payloads only; anything that walks topology state (trunk queue depths)
is sampled on the runtime's ``Sim.every`` wall grid, never per event.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


class Telemetry:
    """Append-only event stream + scalar reduction.

    ``record`` keeps a per-kind index alongside the flat stream so
    ``of(kind)`` is O(matches), not an O(n) scan — ``summary()`` calls
    it once per kind, and benchmarks/tests call it in loops.
    """

    def __init__(self, enabled: bool = True, tracker=None):
        self.enabled = enabled
        self.tracker = tracker
        self.events: List[dict] = []
        self._by_kind: Dict[str, List[dict]] = {}

    def record(self, kind: str, t: float, **fields) -> None:
        if not self.enabled:
            return
        e = {"kind": kind, "t": float(t), **fields}
        self.events.append(e)
        bucket = self._by_kind.get(kind)
        if bucket is None:
            bucket = self._by_kind[kind] = []
        bucket.append(e)
        if self.tracker is not None:
            self.tracker.log_event(e)

    def of(self, kind: str) -> List[dict]:
        """Events of one kind, in stream order (a fresh list; mutating
        it does not corrupt the index)."""
        return list(self._by_kind.get(kind, ()))

    def _count(self, kind: str) -> int:
        return len(self._by_kind.get(kind, ()))

    def blocked_seconds(self) -> float:
        """Total worker-seconds spent blocked on the staleness/barrier
        gate (paired block/unblock events; an unmatched block counts to
        the last event's timestamp)."""
        t_end = self.events[-1]["t"] if self.events else 0.0
        open_t: Dict[int, float] = {}
        total = 0.0
        for e in self.events:
            if e["kind"] == "block":
                open_t.setdefault(e["worker"], e["t"])
            elif e["kind"] == "unblock":
                t0 = open_t.pop(e["worker"], None)
                if t0 is not None:
                    total += e["t"] - t0
        total += sum(t_end - t0 for t0 in open_t.values())
        return total

    def summary(self) -> Dict[str, float]:
        """Scalar reduction of the stream — what a sweep row carries."""
        applies = self.of("apply")
        stale = [e["staleness_max"] for e in applies]
        stale_mean = [e["staleness_mean"] for e in applies]
        queues = self.of("queue")
        closes = self.of("early_close")
        out = {
            "n_events": len(self.events),
            "n_applies": len(applies),
            "n_early_close": len(closes),
            "n_stale_drops": self._count("stale_drop"),
            "blocked_s": round(self.blocked_seconds(), 6),
            "staleness_max": int(max(stale)) if stale else 0,
            "staleness_mean": round(float(np.mean(stale_mean)), 4)
            if stale_mean else 0.0,
        }
        if queues:
            depths = [e["depth"] for e in queues]
            out["queue_depth_mean"] = round(float(np.mean(depths)), 3)
            out["queue_depth_max"] = float(np.max(depths))
            net = [e["net_depth"] for e in queues if "net_depth" in e]
            if net:
                out["net_queue_max_pkts"] = round(float(np.max(net)), 2)
        if closes:
            out["early_close_mean_delivered"] = round(
                float(np.mean([e["delivered"] for e in closes])), 4)
        # fault-layer scalars: each emitted whenever its events exist —
        # a manually driven failover or tear (no injected FaultEvent)
        # must not silently drop its count. A faulted run still carries
        # the full key set (zeros included), record-for-record as before.
        n_faults = self._count("fault")
        if n_faults:
            out["n_faults"] = n_faults
        for key, kind in (("n_flow_torn", "flow_torn"),
                          ("n_ps_lost", "ps_lost"),
                          ("n_failovers", "ps_failover"),
                          ("n_checkpoints", "checkpoint")):
            n = self._count(kind)
            if n or n_faults:
                out[key] = n
        # fabric-fault scalars (DESIGN.md §14): same contract as the
        # node-fault block — a netfault run carries the full key set
        # (zeros included); a fault-free run's summary is unchanged.
        n_netfaults = self._count("netfault")
        if n_netfaults:
            out["n_netfaults"] = n_netfaults
        for key, kind in (("n_flow_dead", "flow_dead"),
                          ("n_reroutes", "reroute"),
                          ("n_blackholes", "blackhole"),
                          ("n_budget_moves", "budget")):
            n = self._count(kind)
            if n or n_netfaults:
                out[key] = n
        return out

    # -- observability-layer hooks (DESIGN.md §12) ---------------------

    def attach(self, tracker: Optional[object]) -> None:
        """Attach a Tracker sink; already-recorded events are replayed
        into it so attachment order doesn't lose the stream prefix."""
        self.tracker = tracker
        if tracker is not None:
            for e in self.events:
                tracker.log_event(e)
