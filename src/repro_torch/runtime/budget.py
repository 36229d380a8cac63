"""Closed-loop loss-budget controller (DESIGN.md §14). The port's copy
of the JAX package's ``runtime/budget.py``, with the same control law.

The paper's Early Close rule "adjusts the loss-tolerant threshold based
on network conditions"; ``BudgetController`` closes that loop at the
runtime level. On a fixed observation grid (``Sim.every``) it reads
three signals from the run itself:

* fabric distress — new netfault / blackhole / flow-dead telemetry
  since the last tick (the network fault plane's event stream);
* per-round Early-Close behavior — new ``early_close`` records: the
  delivered fraction AND the close latency. Latency is the primary
  degradation signal: a straggling rack makes rounds close *late* while
  the delivered fraction actually climbs (a longer round lands more
  bytes), so "delivered looks fine" must never be read as health on its
  own. The controller learns its own healthy-latency baseline (EWMA
  over calm ticks) and flags distress when recent closes run
  ``late_mult`` over it;
* training-loss trend — the tail of the runtime history (accuracy
  guardrail).

and moves each PS shard's effective Early-Close pct threshold
(``DESTransport.set_pct_threshold``) by ``step`` per tick inside the
``[floor, ceiling]`` guardrail band:

  loss rising      -> narrow (raise the threshold toward the ceiling:
                      accuracy wins over speed, even under distress);
  fabric distress  -> widen (lower the threshold toward the floor: keep
                      rounds closing instead of chasing bytes a flapping
                      fabric will not deliver). Distress is *sustained*,
                      not edge-triggered: new fault telemetry counts,
                      and so does any window of Early-Close rounds that
                      delivered less than the baseline ceiling OR closed
                      ``late_mult`` over the learned healthy latency —
                      so the budget stays wide for as long as the fabric
                      under-delivers or drags, not just for the tick the
                      fault fired on;
  round stalled    -> hold (no Early Close for longer than a full close
                      window: the round is gated by criticals or a
                      blackholed path, which no pct threshold can buy
                      back — but silence is not health, so the budget
                      does not narrow back mid-outage);
  healthy for
  ``patience`` ticks -> narrow back toward the configured baseline.

The ceiling defaults to the configured ``data_pct_threshold`` (the
controller never demands more than the config did); the floor is the
accuracy guardrail. Every actuation is recorded as a ``budget``
telemetry event, so runs are auditable and the chaos tests can pin the
controller's trajectory. A runtime constructed without a controller
never touches any of this (zero-fault parity).
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

#: telemetry kinds that signal fabric distress on the observation grid
_DISTRESS_KINDS = ("netfault", "blackhole", "flow_dead")


class BudgetController:
    """One instance per runtime; ``bind`` wires it, ``tick`` observes
    and actuates. Pure deterministic arithmetic over the telemetry
    stream — no RNG, no wall clock (replayable by construction)."""

    def __init__(self, *, floor: float = 0.55,
                 ceiling: Optional[float] = None, step: float = 0.05,
                 interval_s: float = 0.05, patience: int = 3,
                 loss_window: int = 6, late_mult: float = 1.3):
        if not 0.0 < floor <= 1.0:
            raise ValueError(f"floor must be in (0, 1], got {floor}")
        if step <= 0:
            raise ValueError(f"step must be > 0, got {step}")
        if late_mult <= 1.0:
            raise ValueError(f"late_mult must be > 1, got {late_mult}")
        self.floor = float(floor)
        self.ceiling = ceiling            # None -> configured threshold
        self.step = float(step)
        self.interval_s = float(interval_s)
        self.patience = int(patience)
        self.loss_window = int(loss_window)
        self.late_mult = float(late_mult)
        self.rt = None
        self.pct: List[float] = []
        self._ceil: List[float] = []
        self._healthy = 0
        self._seen = {k: 0 for k in _DISTRESS_KINDS}
        self._n_closes = 0
        self._lat_ewma: Optional[float] = None
        self.n_widen = 0
        self.n_narrow = 0

    def bind(self, rt) -> None:
        """Attach to a runtime (its DES transport is the actuator)."""
        if rt.net_des is None:
            raise ValueError(
                "BudgetController needs transport='des' — the analytic "
                "transport has no per-shard Early-Close receivers to "
                "actuate")
        self.rt = rt
        self.pct = list(rt.net_des.pct_eff)
        self._ceil = ([float(self.ceiling)] * len(self.pct)
                      if self.ceiling is not None else list(self.pct))
        # a round is "stalled" once no Early Close has landed for longer
        # than a full close window (LT + deadline) plus a few observation
        # ticks of slack — generous enough that a healthy cadence (close
        # gaps ~ compute + LT, with ticks coarser than rounds) can never
        # read as a stall
        self._stall_after = (rt.net_des.lt_shard
                             + rt.net_des.deadline_shard
                             + 3.0 * self.interval_s)
        self._t_last_close = rt.sim.now

    # -- observation ---------------------------------------------------------
    def _distressed(self) -> bool:
        tel = self.rt.tel
        hit = False
        for kind in _DISTRESS_KINDS:
            n = tel._count(kind)
            if n > self._seen[kind]:
                hit = True
            self._seen[kind] = n
        return hit

    def _loss_rising(self) -> bool:
        hist = self.rt.history
        w = self.loss_window
        if len(hist) < w:
            return False
        tail = [self._loss_of(r) for r in hist[-w:]]
        half = w // 2
        return float(np.mean(tail[half:])) > float(np.mean(tail[:half]))

    @staticmethod
    def _loss_of(rec) -> float:
        """A history record's loss as a float. The runtime keeps it a 0-d
        device tensor until the run ends; the first read stores the float
        back into the record, so each record waits on the device once and
        not on every tick that finds it in the window. The value is the
        one ``_finalize_history`` would store."""
        v = rec["loss"]
        if not isinstance(v, (int, float)):
            v = rec["loss"] = float(v)
        return v

    def _observe(self):
        """Consume Early-Close records landed since the last tick and
        fold them into (mean delivered, mean close latency) — or
        ``(None, None)`` when no round closed. Also advances the stall
        clock."""
        closes = self.rt.tel.of("early_close")
        new = closes[self._n_closes:]
        self._n_closes = len(closes)
        if not new:
            return None, None
        self._t_last_close = float(new[-1]["t"])
        d = float(np.mean([e["delivered"] for e in new]))
        lats = [float(e["lat"]) for e in new if e.get("lat")]
        lat = float(np.mean(lats)) if lats else None
        return d, lat

    def _delivered_low(self, delivered: Optional[float]) -> bool:
        """Recent Early-Close rounds delivering under the *baseline*
        ceiling mean the fabric is carrying less than the config asked
        for — stragglers or a browned-out link are pinning the aggregate
        pct below the configured threshold. Comparing against the
        ceiling (not the already-widened ``self.pct``) is what holds the
        budget wide for the whole degraded window: a widened threshold
        closes rounds at exactly its own pct, which would read as
        "healthy" under a self-referential test and narrow the budget
        back mid-fault (hysteresis, DESIGN.md §14)."""
        return (delivered is not None
                and delivered < min(self._ceil) - 1e-9)

    def _late(self, lat: Optional[float]) -> bool:
        """Recent closes ran ``late_mult`` over the learned healthy
        latency. This is the signal that survives the delivered-fraction
        paradox: a straggling rack makes rounds run *longer*, which
        lands *more* bytes per round — delivered climbs while the round
        cadence degrades. Latency only ever moves the wrong way under
        degradation, so it is the primary distress predicate. No
        baseline yet (or async closes without latency) -> no opinion."""
        return (lat is not None and self._lat_ewma is not None
                and lat > self.late_mult * self._lat_ewma)

    def _stalled(self) -> bool:
        """No Early Close for longer than a full close window: the open
        round is gated by something the pct threshold cannot buy back
        (missing criticals, a blackholed rack in RTO backoff). Neither
        healthy nor actuatable — the controller holds its position
        instead of narrowing back mid-outage."""
        return self.rt.sim.now - self._t_last_close > self._stall_after

    # -- control law ---------------------------------------------------------
    def tick(self) -> None:
        delivered, lat = self._observe()
        distress = (self._distressed() or self._delivered_low(delivered)
                    or self._late(lat))
        if self._loss_rising():
            self._move(+self.step)        # accuracy guardrail wins
            self._healthy = 0
        elif distress:
            self._move(-self.step)
            self._healthy = 0
        elif self._stalled():
            self._healthy = 0             # hold: not healthy, not closable
        else:
            self._healthy += 1
            # the healthy-latency baseline learns only from calm ticks,
            # so a long brownout can never drag it up toward "late is
            # the new normal"
            if lat is not None:
                self._lat_ewma = (lat if self._lat_ewma is None
                                  else 0.8 * self._lat_ewma + 0.2 * lat)
            if self._healthy >= self.patience:
                self._move(+self.step)

    def _move(self, delta: float) -> None:
        rt = self.rt
        moved = False
        for p in range(len(self.pct)):
            new = float(np.clip(self.pct[p] + delta, self.floor,
                                self._ceil[p]))
            if new != self.pct[p]:
                self.pct[p] = new
                rt.net_des.set_pct_threshold(p, new)
                rt.tel.record("budget", rt.sim.now, shard=p, pct=new,
                              direction="widen" if delta < 0 else "narrow")
                moved = True
        if moved:
            if delta < 0:
                self.n_widen += 1
            else:
                self.n_narrow += 1
