"""LTP receiver(s): per-packet out-of-order ACK, Early Close, bubble
accounting (paper §III-B/C).

``LTPFlowReceiver`` handles one flow. ``PSGatherReceiver`` coordinates the
incast gather at the PS: per-link LT thresholds, one shared deadline, and
the close rule over the aggregate received percentage + critical-packet
completeness. On close it broadcasts "stop" to all senders and records,
per flow, exactly which packets must be bubble-filled.

``ShardedGatherReceiver`` (DESIGN.md §5) is the multi-PS composition: one
independent ``PSGatherReceiver`` per model shard, each with its own LT
threshold, deadline timer, and close decision. A worker appears once per
shard; aggregate statistics reduce over shards (BST = slowest shard's
close; a worker's delivered fraction = mean over its shard flows).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Set

import numpy as np

from repro_torch.net.genfence import GEN_KEY, gen_of, has_gen
from repro_torch.net.simcore import Packet, Sim, TrainItems


class LTPFlowReceiver:
    """Tracks one sender's flow; emits per-packet ACKs.

    With a train-aware ``send_ack_train`` attached, coalesced data trains
    (``on_data_train``) are acknowledged as one ACK train — K ACK packets,
    one heap event (DESIGN.md §7).
    """

    def __init__(self, sim: Sim, send_ack: Callable[[Packet], None], flow: int):
        self.sim = sim
        self.send_ack = send_ack
        # transport wiring, attached once per pooled life from outside —
        # reset() deliberately leaves it alone
        self.send_ack_train: Optional[Callable[[List[Packet]], None]] = None  # replint: ok(pool-reset)
        self.flow = flow
        self.received: Set[int] = set()
        self.reset()

    def reset(self) -> None:
        """Cold-start flow state in place (flow pooling, DESIGN.md §9)."""
        self.n: Optional[int] = None
        self.critical: Optional[np.ndarray] = None
        self.received.clear()
        self.t_start: Optional[float] = None
        self.t_full: Optional[float] = None
        self.closed = False

    @property
    def pct(self) -> float:
        if not self.n:
            return 0.0
        return len(self.received) / self.n

    @property
    def criticals_done(self) -> bool:
        if self.n is None:
            return False
        if self.critical is None:
            return True
        need = np.flatnonzero(self.critical)
        return all(int(s) in self.received for s in need)

    # replint: hotpath
    def _ack_for(self, pkt: Packet, t: float) -> Packet:
        """Per-packet bookkeeping (reg metadata / received set / t_start /
        t_full at the packet's true arrival ``t``) -> the ACK to send.
        Shared by the per-packet and coalesced-train paths so they cannot
        drift."""
        if pkt.kind == "reg":
            self.n = pkt.meta["n"]
            self.critical = pkt.meta.get("critical")
            if self.t_start is None:
                self.t_start = t
            # echo the sender's flow generation so a pooled sender can
            # tell this reg-ack from one aimed at a previous life
            ack = Packet(self.flow, -1, 41, kind="ack",
                         meta={GEN_KEY: gen_of(pkt.meta)}
                         if has_gen(pkt.meta) else {})
        else:
            self.received.add(pkt.seq)
            ack = Packet(self.flow, pkt.seq, 41, kind="ack",
                         meta={"echo": pkt.meta,
                               "order": pkt.meta.get("order", -1)})
        if self.n is not None and len(self.received) >= self.n \
                and self.t_full is None:
            self.t_full = t
        return ack

    # replint: hotpath
    def on_data(self, pkt: Packet, notify: Callable[[], None]):
        if self.closed:
            return
        self.send_ack(self._ack_for(pkt, self.sim.now))
        notify()

    def on_data_train(self, items: TrainItems, notify: Callable[[], None]):
        """Coalesced delivery: one call per train, per-packet arrival times
        from the pipe; ACKs return as a single train."""
        if self.closed:
            return
        acks: List[Packet] = [self._ack_for(pkt, t) for pkt, t in items]
        if acks:
            if self.send_ack_train is not None:
                self.send_ack_train(acks)
            else:
                for a in acks:
                    self.send_ack(a)
        notify()

    def delivered_mask(self) -> np.ndarray:
        """(n,) bool — per-packet delivery state (True = received)."""
        if self.n is None:
            return np.zeros(0, bool)
        mask = np.zeros(self.n, bool)
        # iteration order is irrelevant: each element sets one mask cell
        for s in self.received:  # replint-torch: ok(determinism)
            if 0 <= s < self.n:
                mask[s] = True
        return mask

    def bubbles(self) -> np.ndarray:
        """(n,) bool — packets that must be zero-filled at close."""
        if self.n is None:
            return np.zeros(0, bool)
        return ~self.delivered_mask()


def _noop() -> None:
    pass


class PSGatherReceiver:
    """The PS side of one gather iteration over W flows (paper Fig 7).

    close rule: before LT -> wait for 100%; in [LT, deadline) -> close when
    aggregate pct >= threshold and all criticals are in; at deadline ->
    close unconditionally (criticals are retransmitted via CQ and in
    practice always land before the deadline; if not, the close is late —
    counted in stats).
    """

    def __init__(self, sim: Sim, flows: List[int], lt_threshold: float,
                 deadline: float, pct_threshold: float,
                 send_stop: Callable[[int], None],
                 on_close: Optional[Callable[["PSGatherReceiver"], None]] = None,
                 ps_id: int = 0):
        self.sim = sim
        self.ps_id = ps_id
        self.lt = lt_threshold
        self.deadline = deadline
        self.pct_threshold = pct_threshold
        self.send_stop = send_stop
        self.on_close = on_close
        # per-flow receiver map: reset() re-initializes every value in
        # place (the map itself is the pooled wiring, keyed by flow id)
        self.flows: Dict[int, LTPFlowReceiver] = {}  # replint: ok(pool-reset)
        self.gen = 0
        #: pooled-transport hook, called as ``on_stale(flow, gen)`` when
        #: data from an older flow generation arrives: the transport
        #: re-stops the orphaned sender if it is still living that
        #: generation (its original stop was lost in flight) — without
        #: this a recycled gather would silently drop the straggler's
        #: retransmissions and the orphan would pump forever.
        self.on_stale: Optional[Callable[[int, int], None]] = None  # replint: ok(pool-reset)
        self._check_eids: List[int] = []
        #: flows abandoned mid-gather (node death, DESIGN.md §10): their
        #: receivers are closed, they are excluded from the close rule,
        #: and their delivery masks report zeros — a dead node's partial
        #: gradient must never reach the reduction.
        self._dead: Set[int] = set()
        # observability counters (DESIGN.md §12) — cumulative across the
        # pooled gather's lives: initialized here, NOT cleared by reset()
        self.n_stale_fenced = 0   # replint: ok(pool-reset)
        self.n_stop_resends = 0   # replint: ok(pool-reset)
        for f in flows:
            self.flows[f] = LTPFlowReceiver(sim, lambda p: None, f)
        self.reset()

    def reset(self, gen: Optional[int] = None) -> None:
        """Re-arm this gather for a fresh iteration (flow pooling): cold
        flow state, new t0, fresh LT/deadline check timers (stale ones
        are cancelled), and a bumped generation so deliveries from the
        previous iteration are dropped instead of polluting the masks."""
        if gen is not None:
            self.gen = gen
        for fr in self.flows.values():
            fr.reset()
        self._dead.clear()
        self.t0 = self.sim.now
        self.closed = False
        self.close_time: Optional[float] = None
        for eid in self._check_eids:
            self.sim.cancel(eid)
        self._check_eids = [self.sim.at(self.t0 + self.lt, self._check),
                            self.sim.at(self.t0 + self.deadline, self._check)]

    def abandon_flow(self, flow: int) -> None:
        """Drop ``flow`` from this gather mid-round (its node died or
        never joined): the per-flow receiver closes, the flow no longer
        gates the close rule, and its mask reports zeros. Re-evaluates
        the close rule — the death of the last straggler may complete
        the barrier."""
        if flow not in self.flows or flow in self._dead:
            return
        self._dead.add(flow)
        self.flows[flow].closed = True
        if not self.closed:
            self._check()

    def deactivate(self, gen: Optional[int] = None) -> None:
        """Hard-stop the whole gather (PS death): close every flow,
        cancel the LT/deadline timers, and optionally bump the
        generation so in-flight data is fenced out as stale. The pooled
        receiver revives through ``reset``."""
        self.closed = True
        for fr in self.flows.values():
            fr.closed = True
        for eid in self._check_eids:
            self.sim.cancel(eid)
        self._check_eids = []
        if gen is not None:
            self.gen = gen

    def _stale(self, pkt: Packet) -> bool:
        g = gen_of(pkt.meta)
        return g is not None and g != self.gen

    def attach_ack(self, flow: int, send_ack: Callable[[Packet], None]):
        self.flows[flow].send_ack = send_ack

    def attach_ack_train(self, flow: int,
                         send_ack_train: Callable[[List[Packet]], None]):
        self.flows[flow].send_ack_train = send_ack_train

    def on_data(self, pkt: Packet):
        fr = self.flows.get(pkt.flow)
        if fr is None:
            return
        if self._stale(pkt):
            self.n_stale_fenced += 1
            if self.on_stale is not None:
                self.on_stale(pkt.flow, gen_of(pkt.meta))
            return
        if self.closed:
            # data after close means the flow's "stop" was lost in flight:
            # re-send it (once per arriving packet, so the retry rate is
            # bounded by the sender's own transmission rate)
            self.n_stop_resends += 1
            self.send_stop(pkt.flow)
            return
        fr.on_data(pkt, self._check)

    def on_data_train(self, items: TrainItems):
        """Coalesced delivery: all packets in a train share one event time,
        so the close rule is evaluated once after the whole train (identical
        to per-packet evaluation at equal ``sim.now``)."""
        stale = [(p.flow, gen_of(p.meta)) for p, _ in items
                 if self._stale(p)]
        if stale:
            self.n_stale_fenced += len(stale)
            if self.on_stale is not None:
                for flow, g in dict.fromkeys(stale):
                    self.on_stale(flow, g)
            items = [(p, t) for p, t in items if not self._stale(p)]
        if not items:
            return
        if self.closed:
            # sorted so stop-resend order never depends on set hashing
            # (same-seed replays must schedule identical event sequences)
            for flow in sorted({p.flow for p, _ in items}):
                if flow in self.flows:
                    self.n_stop_resends += 1
                    self.send_stop(flow)
            return
        by_flow: Dict[int, TrainItems] = {}
        for pkt, t in items:
            by_flow.setdefault(pkt.flow, []).append((pkt, t))
        for flow, fitems in by_flow.items():
            fr = self.flows.get(flow)
            if fr is not None:
                fr.on_data_train(fitems, _noop)
        self._check()

    def _live(self):
        """Flow receivers still gating the close rule (not abandoned)."""
        if not self._dead:
            return self.flows.values()
        return [fr for f, fr in self.flows.items() if f not in self._dead]

    @property
    def agg_pct(self) -> float:
        ps = [f.pct for f in self._live()]
        return float(np.mean(ps)) if ps else 0.0

    @property
    def all_full(self) -> bool:
        return all(f.n is not None and len(f.received) >= f.n
                   for f in self._live())

    @property
    def criticals_done(self) -> bool:
        return all(f.criticals_done for f in self._live())

    def _check(self):
        if self.closed:
            return
        t = self.sim.now - self.t0
        if self.all_full:
            self._close()
            return
        if t >= self.deadline:
            if self.criticals_done:
                self._close()
            # else: criticals still owed; CQ retransmissions land shortly —
            # the close fires on the arrival that completes them.
            return
        if t >= self.lt and self.agg_pct >= self.pct_threshold and self.criticals_done:
            self._close()

    def _close(self):
        self.closed = True
        self.close_time = self.sim.now
        for f in self.flows:
            self.send_stop(f)
        for fr in self.flows.values():
            fr.closed = True
        if self.on_close:
            self.on_close(self)

    # --- results -------------------------------------------------------------
    def delivered_fracs(self) -> np.ndarray:
        return np.array([0.0 if f in self._dead else fr.pct
                         for f, fr in self.flows.items()])

    def delivery_masks(self) -> np.ndarray:
        """(W, n) bool — per-(worker, packet) delivery state at close.

        This is the mask the PS-side aggregation consumes: True packets
        carry gradient payload, False packets are bubble-filled (the exact
        input shape of ``kernels.packet_reduce``, DESIGN.md §7). An
        abandoned flow's row is all-False: whatever a dead node managed
        to land before it died is provably dropped."""
        ms = [np.zeros_like(fr.delivered_mask()) if f in self._dead
              else fr.delivered_mask()
              for f, fr in self.flows.items()]
        n = max((len(m) for m in ms), default=0)
        if n == 0:
            return np.zeros((len(ms), 0), bool)
        return np.stack([np.pad(m, (0, n - len(m))) for m in ms])

    def full_times(self) -> np.ndarray:
        return np.array([
            (fr.t_full - self.t0)
            if fr.t_full is not None and f not in self._dead else np.inf
            for f, fr in self.flows.items()
        ])

    def bst_gather(self) -> float:
        return (self.close_time or self.sim.now) - self.t0


class ShardedGatherReceiver:
    """Multi-PS gather state: one ``PSGatherReceiver`` per model shard.

    Each shard closes independently (its own LT threshold + deadline);
    the *iteration* is done when the slowest shard closes. Statistics
    reduce over shards so the result shapes match the single-PS case:
    per-worker delivered fraction is the mean over that worker's shard
    flows, and full time is the max (the worker is only "fully
    delivered" once every shard has its packets).
    """

    def __init__(self, sim: Sim, n_ps: int, workers: List[int],
                 lt_thresholds: List[float], deadlines: List[float],
                 pct_threshold: float,
                 send_stop: Callable[[int, int], None]):
        """``send_stop(ps, worker)`` stops worker's flow toward shard ps."""
        self.sim = sim
        self.n_ps = n_ps
        self.workers = list(workers)
        self.shards: List[PSGatherReceiver] = [
            PSGatherReceiver(
                sim, list(workers), lt_thresholds[p], deadlines[p],
                pct_threshold,
                send_stop=lambda w, p=p: send_stop(p, w),
                ps_id=p,
            )
            for p in range(n_ps)
        ]

    def shard(self, ps: int) -> PSGatherReceiver:
        return self.shards[ps]

    def reset(self, gen: Optional[int] = None) -> None:
        """Re-arm every shard for a fresh iteration (flow pooling)."""
        for s in self.shards:
            s.reset(gen)

    def abandon_worker(self, worker: int) -> None:
        """Drop ``worker`` from every shard's close rule (node death)."""
        for s in self.shards:
            s.abandon_flow(worker)

    def deactivate(self, gen: Optional[int] = None) -> None:
        """Hard-stop every shard (PS death); see
        ``PSGatherReceiver.deactivate``."""
        for s in self.shards:
            s.deactivate(gen)

    @property
    def all_closed(self) -> bool:
        return all(s.closed for s in self.shards)

    @property
    def criticals_done(self) -> bool:
        return all(s.criticals_done for s in self.shards)

    # --- reductions over shards ----------------------------------------------
    def bst_gather(self) -> float:
        return max(s.bst_gather() for s in self.shards)

    def delivered_fracs(self) -> np.ndarray:
        """(W,) mean delivered fraction per worker across shards."""
        return np.mean([s.delivered_fracs() for s in self.shards], axis=0)

    def full_times(self) -> np.ndarray:
        """(W,) time at which the worker's *last* shard hit 100%."""
        return np.max([s.full_times() for s in self.shards], axis=0)

    def per_shard_full_times(self) -> np.ndarray:
        """(n_ps, W) raw 100%-times — feeds per-PS LT adaptation."""
        return np.stack([s.full_times() for s in self.shards])

    def delivery_masks(self) -> np.ndarray:
        """(n_ps, W, n) bool per-(shard, worker, packet) delivery state."""
        return np.stack([s.delivery_masks() for s in self.shards])

    def payload_packets_received(self) -> int:
        return sum(len(f.received) for s in self.shards
                   for f in s.flows.values())
