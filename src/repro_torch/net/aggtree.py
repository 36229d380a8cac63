"""In-network aggregation at ToR switches (DESIGN.md §11).

``AggSwitch`` is the packet-level model of a programmable ToR doing
partial gradient reduction (MLFabric, PAPERS.md): copies of the same
(shard, seq) gradient fragment arriving from a rack's workers are
combined into ONE upstream wire packet — the reduced partial sum is the
size of a single fragment, so the oversubscribed uplink and the spine
trunk each carry ~1/rack_size of the flat gather's bytes. The numeric
reduce itself stays at the PS (``kernels.packet_reduce`` over delivery
masks, DESIGN.md §7; ``kernels.packet_reduce.tree_reduce`` pins that the
hierarchical reduction equals the flat one to float tolerance) — the
switch changes where bytes travel, never what the reduction computes.

Scheduling is order-aware per MLFabric: a seq whose rack membership
completes flushes immediately *together with every lower pending seq*
(reductions leave the switch in stream order; a finished high seq never
queues behind a straggling low one), and a hold timer bounds how long a
partial entry waits for stragglers before it is flushed as-is.

Loss accounting rides the §9 generation fence unchanged: member packets
keep their original ``meta`` (flow generation ``g`` included), so a
merged packet dropped on the uplink/trunk simply never expands — every
member's seq stays un-ACKed, its sender retransmits, and the PS delivery
masks show exactly which (worker, packet) cells arrived. Stale-round
traffic is fenced at the receivers exactly as on flat paths.

Transparency: senders need only an object with ``send``/``send_train``
(``AggIngress`` below), receivers see ordinary per-flow packets — the
runtime's pooled flow graphs (DESIGN.md §9) and all three aggregation
policies ride the tree without modification.

Pass-through rules: control packets (``reg``), critical packets (paper
§III-E: 100% delivery, retransmission latency matters), and flows from
outside the rack bypass aggregation and are forwarded solo in the same
upstream train — never delayed by the hold timer.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.net.simcore import Packet, Sim, TrainItems

#: flow id carried by merged envelope packets on the wire (never seen by
#: receivers — envelopes are expanded back into member packets on
#: delivery at the trunk end).
AGG_FLOW = -7

#: wire bookkeeping bytes per extra member folded into an envelope (a
#: worker-bitmap entry; the payload itself does not grow — that is the
#: entire bandwidth win).
MEMBER_OVERHEAD_BYTES = 2


class AggIngress:
    """Sender-facing path into a ToR switch. Duck-types ``Pipe``/
    ``Route`` (senders only require ``send``/``send_train``), learns the
    flow's delivery callbacks from the send calls themselves, and hands
    packets to the switch — so existing wiring code needs no new hook.

    One ingress per flow *life*: pooled transports build one per
    (worker, shard) sender and reuse it across iterations; expansion at
    the tree root delivers through the ingress' recorded callbacks, so
    two concurrent flow sets of the same worker can never cross wires.
    ``access`` optionally interposes that worker's heterogeneous access
    pipe in front of the switch.
    """

    __slots__ = ("sw", "flow", "access", "deliver", "deliver_train")

    def __init__(self, sw: "AggSwitch", flow: int,
                 access: Optional[object] = None):
        self.sw = sw
        self.flow = flow
        self.access = access
        self.deliver: Optional[Callable[[Packet], None]] = None
        self.deliver_train: Optional[Callable[[TrainItems], None]] = None

    def send(self, pkt: Packet, deliver: Callable[[Packet], None]) -> bool:
        self.deliver = deliver
        if self.access is not None:
            return self.access.send(pkt, self._arrive_one)
        self.sw.intake([(pkt, self.sw.sim.now)], self)
        return True

    def send_train(self, pkts: Sequence[Packet],
                   deliver_train: Callable[[TrainItems], None],
                   t_ready: Optional[Sequence[float]] = None) -> int:
        self.deliver_train = deliver_train
        if self.access is not None:
            return self.access.send_train(pkts, self._arrive_train, t_ready)
        now = self.sw.sim.now
        self.sw.intake([(p, now) for p in pkts], self)
        return len(pkts)

    def _arrive_one(self, pkt: Packet) -> None:
        self.sw.intake([(pkt, self.sw.sim.now)], self)

    def _arrive_train(self, items: TrainItems) -> None:
        self.sw.intake(items, self)

    def dispatch(self, items: TrainItems) -> None:
        """Deliver expanded member packets to this flow's receiver."""
        if self.deliver_train is not None:
            self.deliver_train(items)
        elif self.deliver is not None:
            for pkt, _ in items:
                self.deliver(pkt)


class AggSwitch:
    """One (shard, rack) aggregation point at the ToR.

    ``upstream`` is the path toward the PS (uplink + trunk ``Route``, or
    the trunk alone when the shard is homed in this rack). ``members``
    are the rack's worker/flow ids; ``live`` shrinks on node death
    (transport fault hooks) so a crashed straggler degrades membership
    flushes to hold-timer flushes instead of stalling them forever.
    """

    def __init__(self, sim: Sim, upstream, members: Sequence[int],
                 hold_s: float):
        self.sim = sim
        self.upstream = upstream
        self.members = frozenset(int(m) for m in members)
        self.live = set(self.members)
        self.hold = float(hold_s)
        # seq -> [t_open, {flow: (pkt, ingress)}]
        self._open: Dict[int, list] = {}
        self._timer: Optional[int] = None
        # counters (read by benchmarks/tests; conservation law checks)
        self.n_in = 0          # member data packets taken for aggregation
        self.n_solo = 0        # packets bypassing aggregation (reg/critical)
        self.n_merged = 0      # member packets folded into envelopes
        self.n_envelopes = 0   # merged envelopes emitted upstream
        self.n_timeout_flushes = 0
        self.n_membership_flushes = 0  # entries flushed by a member going dead
        # fault plane (DESIGN.md §14): a crashed switch drops everything
        # it holds and blackholes intake until recovery
        self.crashed = False
        self.n_dropped_crash = 0

    # -- fault plane (DESIGN.md §14) ----------------------------------------
    def crash(self) -> None:
        """The programmable switch dies: pending partial reductions are
        lost (their members' seqs stay un-ACKed, so the senders
        retransmit after recovery), the hold timer stops, and intake
        blackholes until ``recover``."""
        if self.crashed:
            return
        self.crashed = True
        for _s, e in sorted(self._open.items()):
            self.n_dropped_crash += len(e[1])
        self._open.clear()
        if self._timer is not None:
            self.sim.cancel(self._timer)
            self._timer = None

    def recover(self) -> None:
        self.crashed = False

    # -- membership (fault hooks, DESIGN.md §10) ----------------------------
    def set_live(self, flow: int, alive: bool) -> None:
        if flow not in self.members:
            return
        if alive:
            self.live.add(flow)
            return
        self.live.discard(flow)
        # entries may have just become membership-complete
        full = [s for s, e in self._open.items() if self.live <= e[1].keys()]
        if full:
            self.n_membership_flushes += len(full)
            self._emit(self._collect(max(full)))

    # -- datapath -----------------------------------------------------------
    def intake(self, items: TrainItems, ing: AggIngress) -> None:
        """Packets arriving from one rack member (one event)."""
        if self.crashed:
            self.n_dropped_crash += len(items)
            return
        out: List[Packet] = []
        flush_upto = -1
        for pkt, _t in items:
            if (pkt.kind != "data" or pkt.critical
                    or pkt.flow not in self.members):
                self.n_solo += 1
                out.append(self._envelope([(pkt, ing)]))
                continue
            self.n_in += 1
            e = self._open.get(pkt.seq)
            if e is None:
                self._open[pkt.seq] = e = [self.sim.now, {}]
            elif pkt.flow in e[1]:
                # retransmit while the seq is still pending: forward the
                # older copy solo, keep the newest in the entry
                self.n_solo += 1
                out.append(self._envelope([e[1][pkt.flow]]))
            e[1][pkt.flow] = (pkt, ing)
            if self.live <= e[1].keys():
                flush_upto = max(flush_upto, pkt.seq)
        if flush_upto >= 0:
            out.extend(self._collect(flush_upto))
        self._emit(out)
        self._arm()

    def _envelope(self, copies: List[Tuple[Packet, AggIngress]]) -> Packet:
        """Wrap member copies as one wire packet. A single copy rides at
        its own size; k copies ride at max(size) + a bitmap entry per
        extra member — the partial sum is one payload wide."""
        size = max(p.size for p, _ in copies) \
            + MEMBER_OVERHEAD_BYTES * (len(copies) - 1)
        if len(copies) > 1:
            self.n_merged += len(copies)
            self.n_envelopes += 1
        return Packet(AGG_FLOW, copies[0][0].seq, size, kind="data",
                      meta={"agg": copies})

    def _collect(self, upto: int) -> List[Packet]:
        """Order-aware flush: every pending seq <= ``upto``, ascending —
        reductions leave the switch in stream order (MLFabric)."""
        seqs = sorted(s for s in self._open if s <= upto)
        out = []
        for s in seqs:
            _, copies = self._open.pop(s)
            out.append(self._envelope(list(copies.values())))
        return out

    def _emit(self, envelopes: List[Packet]) -> None:
        if envelopes:
            self.upstream.send_train(envelopes, self._expand)

    # -- hold timer ---------------------------------------------------------
    def _arm(self) -> None:
        if self._timer is not None or not self._open:
            return
        t0 = min(e[0] for e in self._open.values())
        self._timer = self.sim.at(t0 + self.hold, self._sweep)

    def _sweep(self) -> None:
        self._timer = None
        if not self._open:
            return
        cutoff = self.sim.now - self.hold + 1e-12
        ripe = [s for s, e in self._open.items() if e[0] <= cutoff]
        if ripe:
            self.n_timeout_flushes += len(ripe)
            # order-aware even on timeout: ripe seqs drag every lower
            # pending seq out with them
            self._emit(self._collect(max(ripe)))
        self._arm()

    # -- tree root: expansion back into per-flow packets --------------------
    def _expand(self, items: TrainItems) -> None:
        """A train of envelopes survived the uplink+trunk: unwrap every
        member copy and deliver it through its own ingress' callbacks.
        Flows sharing one receiver train callback (the bsp barrier's
        sharded receiver) are dispatched as one train, so the close rule
        evaluates once per wire train, exactly like a flat trunk."""
        # id()-keyed grouping is safe here: keys only bucket callbacks
        # within this one event, the dict iterates in insertion order
        # (member order on the wire), and no id ever leaves the process.
        groups: Dict[tuple, Tuple[AggIngress, TrainItems]] = {}
        for env, t in items:
            for pkt, ing in env.meta["agg"]:
                cb = ing.deliver_train
                if cb is not None:
                    key = (id(getattr(cb, "__self__", cb)),     # replint-torch: ok(determinism)
                           id(getattr(cb, "__func__", cb)))     # replint-torch: ok(determinism)
                else:
                    key = ("pp", id(ing))                       # replint-torch: ok(determinism)
                g = groups.get(key)
                if g is None:
                    groups[key] = (ing, [(pkt, t)])
                else:
                    g[1].append((pkt, t))
        for ing, fitems in groups.values():
            ing.dispatch(fitems)

    def stats(self) -> Dict[str, float]:
        return {
            "n_in": self.n_in,
            "n_solo": self.n_solo,
            "n_merged": self.n_merged,
            "n_envelopes": self.n_envelopes,
            "n_timeout_flushes": self.n_timeout_flushes,
            "n_membership_flushes": self.n_membership_flushes,
            "n_dropped_crash": self.n_dropped_crash,
            "pending": len(self._open),
        }
