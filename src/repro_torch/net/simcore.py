"""Discrete-event core: event loop, lossy serialized pipes, and the
composable topology layer (DESIGN.md §5).

A ``Pipe`` models one direction of a link: store-and-forward serialization
at ``rate_bps``, a droptail queue (in packets) at its ingress, i.i.d.
non-congestion random loss, and fixed propagation delay. The incast
scenarios attach many senders to one shared bottleneck pipe — the ToR's
egress port toward the PS — which is where the paper's long-tail latency
is born.

Beyond the single shared bottleneck, three composable pieces build
arbitrary gather topologies:

  ``Route``              chains pipes hop-by-hop (worker NIC -> ToR ->
                         PS port); a drop at any hop kills the packet.
  ``Topology``           named-pipe registry with per-group aggregate
                         stats — one *pipe group* per PS shard.
  ``CrossTrafficSource`` open-loop on/off background load injected at a
                         pipe's ingress, stealing serialization slots
                         from the senders under test.

Packet trains (DESIGN.md §7): beyond the per-packet ``Pipe.send``, a
sender may emit a whole *train* of packets through ``Pipe.send_train`` —
one heap event for the entire train, with queue-admission and loss
decisions drawn as a single vectorized numpy pass over the same RNG
stream the per-packet path would consume, and per-packet arrival times
handed to the receiver in one callback. This is what makes paper-scale
sweeps (64 workers x 4 PS) feasible in quick mode.

Event engine (DESIGN.md §9): ``Sim`` defaults to a calendar queue — a
near-future bucket wheel plus a far-future heap, batch-popping
same-timestamp events FIFO by schedule id — with the reference binary
heap selectable via ``Sim(engine="heap")``. Both engines execute the
same schedule in the same order, bitwise.
"""
from __future__ import annotations

import bisect
import dataclasses
import heapq
import itertools
import warnings
from functools import partial
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

#: A delivered train: per-packet ``(packet, arrival_time)`` in arrival order.
TrainItems = List[Tuple["Packet", float]]


class PerfCounters:
    """Process-wide simulator throughput counters (read by benchmarks).

    ``events`` counts heap events processed; ``packets`` counts packet
    deliveries scheduled (train members count individually) — the ratio
    is the effective coalescing factor.
    """

    __slots__ = ("events", "packets")

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self.events = 0
        self.packets = 0

    def snapshot(self) -> dict:
        """Plain-dict view for the metrics registry (DESIGN.md §12)."""
        return {"events": self.events, "packets": self.packets}


PERF = PerfCounters()


@dataclasses.dataclass(slots=True)      # slots: the sim allocates millions
class Packet:
    flow: int
    seq: int              # packet sequence within the flow (jigsaw piece id)
    size: int             # bytes on the wire
    kind: str = "data"    # data | ack | stop | reg | end
    critical: bool = False
    meta: Any = None      # protocol payload (e.g. acked seq, send stamp)


#: engine selected by ``Sim()`` when none is given explicitly. "calendar"
#: is the fast bucketed engine (DESIGN.md §9); "heap" is the reference
#: binary-heap engine, kept so determinism tests can A/B the two.
DEFAULT_ENGINE = "calendar"


class Sim:
    """Event loop. Callbacks run at monotonically nondecreasing times.

    Two interchangeable engines produce the *same execution order* —
    events always fire in ``(time, schedule-id)`` order, so same-seed
    runs are bitwise-identical across engines (pinned by
    tests/test_calendar_queue.py):

    * ``"calendar"`` (default) — a calendar queue: a near-future wheel
      of ``_NB`` time buckets (each a tiny heap) plus a far-future heap
      for events beyond the wheel horizon. All events sharing the head
      timestamp are batch-popped and executed FIFO by schedule id; the
      bucket width recalibrates to the observed mean event spacing every
      ``_CAL_EVERY`` pops. Bucket placement uses ONE monotone map
      ``t -> int((t - origin) / width)`` per wheel epoch, so float
      rounding can shift a boundary event between adjacent buckets but
      can never invert time order.
    * ``"heap"`` — the single binary heap.

    ``truncated`` flips to True when a ``run`` stops on ``max_events``
    with work still pending — a co-simulation cut off mid-scenario must
    not masquerade as a converged run (callers check the flag; a
    ``RuntimeWarning`` fires too, so silent truncation is impossible).
    """

    _NB = 1024           # near-future wheel buckets
    _CAL_EVERY = 512     # pops between bucket-width recalibrations
    _ADV_EVERY = 8192    # empty-bucket advances that force a recalibration

    def __init__(self, engine: Optional[str] = None) -> None:
        engine = DEFAULT_ENGINE if engine is None else engine
        if engine not in ("calendar", "heap"):
            raise ValueError(f"unknown Sim engine {engine!r}; "
                             f"expected 'calendar' or 'heap'")
        self.engine = engine
        self.now = 0.0
        self._heap: List = []     # heap-engine queue / calendar far heap
        self._ids = itertools.count()
        self.cancelled: set = set()
        self.n_events = 0
        self.truncated = False
        if engine == "calendar":
            self._wheel: Optional[List[List]] = \
                [[] for _ in range(self._NB)]
            self._near = 0        # events currently in the wheel
            self._org = 0.0       # wheel origin (time of absolute slot 0)
            self._k = 0           # buckets consumed since the last rebuild
            self._width = 1e-6    # bucket width; recalibrated while running
            self._inv = 1e6       # 1 / width (slot = int((t-org) * inv))
            self._cal_n = 0       # pops since the last calibration
            self._cal_t = 0.0     # sim time at the last calibration
            self._adv_n = 0       # empty advances since the last calibration
            self._active: Optional[List] = None  # bucket being executed
        else:
            self._wheel = None

    # -- scheduling ---------------------------------------------------------
    # replint: hotpath
    def at(self, t: float, fn: Callable[[], None]) -> int:
        eid = next(self._ids)
        if t < self.now:
            t = self.now
        wheel = self._wheel
        if wheel is None:
            heapq.heappush(self._heap, (t, eid, fn))
            return eid
        # inlined _place (this is THE scheduling hot path)
        a = int((t - self._org) * self._inv) - self._k
        if a < 0:
            a = 0
        if a >= self._NB:
            heapq.heappush(self._heap, (t, eid, fn))
            return eid
        i = self._k % self._NB + a
        if i >= self._NB:
            i -= self._NB
        b = wheel[i]
        if b is self._active:
            bisect.insort(b, (t, eid, fn))
        else:
            b.append((t, eid, fn))
        self._near += 1
        return eid

    def after(self, dt: float, fn: Callable[[], None]) -> int:
        return self.at(self.now + dt, fn)

    def cancel(self, eid: int) -> None:
        self.cancelled.add(eid)

    def pending(self) -> int:
        """Events still queued (any engine)."""
        near = self._near if self._wheel is not None else 0
        return near + len(self._heap)

    # -- calendar internals -------------------------------------------------
    def _place(self, t: float, eid: int, fn: Callable[[], None],
               clamp: bool = False) -> None:
        # relative slot via the epoch's single monotone map: float
        # rounding at a bucket boundary cannot reorder two events
        a = int((t - self._org) * self._inv) - self._k
        if a < 0:
            a = 0          # belongs before the window: run ASAP, in order
        if a >= self._NB:
            if not clamp:  # beyond the horizon: park in the far heap
                heapq.heappush(self._heap, (t, eid, fn))
                return
            a = self._NB - 1   # far-drain boundary rounding: last bucket
        i = self._k % self._NB + a
        if i >= self._NB:
            i -= self._NB
        b = self._wheel[i]
        if b is self._active:
            # insertion into the bucket being executed: insort keeps it
            # ordered, and the new event can only land in the unexecuted
            # suffix (it compares greater than everything already run)
            bisect.insort(b, (t, eid, fn))
        else:
            b.append((t, eid, fn))   # future bucket: sorted on activation
        self._near += 1

    def _drain_far(self) -> None:
        """Move far-heap events that now fall inside the wheel horizon."""
        far = self._heap
        end = self._org + (self._k + self._NB) * self._width
        while far and far[0][0] < end:
            t, eid, fn = heapq.heappop(far)
            self._place(t, eid, fn, clamp=True)

    def _rebuild(self, width: float) -> None:
        """Re-anchor the wheel at ``now`` with a new bucket width."""
        moved = [e for b in self._wheel for e in b]
        for b in self._wheel:
            b.clear()
        self._near = 0
        self._width = width
        self._inv = 1.0 / width
        self._org = self.now
        self._k = 0
        for t, eid, fn in moved:
            self._place(t, eid, fn)
        self._drain_far()

    def _recalibrate(self) -> None:
        span = self.now - self._cal_t
        if span > 0.0 and self._cal_n > 0:
            # ~8 events per bucket: wide enough that the horizon clears
            # the pending set (no far-heap churn) and the loop is not
            # dominated by empty-bucket advances, narrow enough that
            # per-bucket sorts stay small
            width = 8.0 * span / self._cal_n
            width = min(max(width, 1e-9), 0.1)
            if not (0.25 * self._width <= width <= 4.0 * self._width):
                self._rebuild(width)
        self._cal_n = 0
        self._adv_n = 0
        self._cal_t = self.now

    def every(self, dt: float, fn: Callable[[], None],
              until: float = float("inf"),
              start: Optional[float] = None) -> Callable[[], None]:
        """Periodic actor hook: run ``fn`` every ``dt`` seconds of sim
        time starting at ``now + dt`` (telemetry samplers, watchdogs),
        or at absolute time ``start`` if given — e.g. ``start=now`` runs
        the first tick immediately as a sim event (the runtime's
        checkpoint grid anchors its t=0 snapshot this way).
        Returns a zero-argument canceller."""
        eid: Optional[int] = None
        stopped = False

        def tick() -> None:
            nonlocal eid
            if stopped or self.now > until:
                return
            fn()
            eid = self.after(dt, tick)

        eid = self.after(dt, tick) if start is None else self.at(start, tick)

        def cancel_hook() -> None:
            nonlocal stopped
            stopped = True
            if eid is not None:
                self.cancel(eid)

        return cancel_hook

    def run(self, until: float = float("inf"),
            max_events: int = 100_000_000) -> int:
        if self._wheel is None:
            n = self._run_heap(until, max_events)
        else:
            n = self._run_calendar(until, max_events)
        if n >= max_events and self.pending():
            self.truncated = True
            warnings.warn(
                f"Sim.run stopped on max_events={max_events} with "
                f"{self.pending()} events pending at t={self.now:.6f}s — "
                f"results are truncated, not converged",
                RuntimeWarning, stacklevel=2)
        self.n_events += n
        PERF.events += n
        return n

    def _run_heap(self, until: float, max_events: int) -> int:
        n = 0
        while self._heap and n < max_events:
            t, eid, fn = heapq.heappop(self._heap)
            if eid in self.cancelled:
                self.cancelled.discard(eid)
                continue
            if t > until:
                heapq.heappush(self._heap, (t, eid, fn))
                break
            self.now = t
            fn()
            n += 1
        return n

    def _run_calendar(self, until: float, max_events: int) -> int:
        n = 0
        wheel, nb = self._wheel, self._NB
        far = self._heap
        cancelled = self.cancelled
        while n < max_events:
            if not self._near:
                # discard cancelled ghosts at the far frontier first —
                # the heap engine drops a cancelled head even when it
                # lies beyond ``until``, and pending() must agree
                while far and far[0][1] in cancelled:
                    cancelled.discard(heapq.heappop(far)[1])
                if not far or far[0][0] > until:
                    break
                # the wheel is empty: jump its window to the far frontier
                self._org = far[0][0]
                self._k = 0
                self._drain_far()
                continue
            bucket = wheel[self._k % nb]
            if not bucket:
                self._k += 1
                if far and far[0][0] < \
                        self._org + (self._k + nb) * self._width:
                    self._drain_far()
                self._adv_n += 1
                if self._adv_n >= self._ADV_EVERY:
                    # sparse wheel: the width is far too small for the
                    # current event spacing — widen before scanning on
                    self._recalibrate()
                continue
            # batch-pop: sort the whole bucket once (same-timestamp runs
            # come out FIFO by schedule id) and execute it in place;
            # events landing in this bucket mid-execution insort into the
            # unexecuted suffix
            bucket.sort()
            self._active = bucket
            pos = 0
            stop = False
            while pos < len(bucket):
                t, eid, fn = bucket[pos]
                if eid in cancelled:    # drop ghosts even beyond until
                    cancelled.discard(eid)
                    pos += 1
                    continue
                if t > until or n >= max_events:
                    stop = True   # bucket head is the global pending min
                    break
                pos += 1
                self.now = t
                fn()
                n += 1
            self._active = None
            self._near -= pos
            self._cal_n += pos
            if stop:
                del bucket[:pos]   # keep the sorted unexecuted suffix
                break
            bucket.clear()
            if self._cal_n >= self._CAL_EVERY:
                self._recalibrate()
        return n


class Pipe:
    """One-direction link: droptail queue -> serializer -> loss -> delay."""

    def __init__(
        self,
        sim: Sim,
        rate_bps: float,
        delay: float,
        loss: float = 0.0,
        queue_pkts: int = 256,
        rng: Optional[np.random.Generator] = None,
        overhead: int = 0,
    ) -> None:
        self.sim = sim
        self.rate = rate_bps
        self.delay = delay
        self.loss = loss
        self.cap = queue_pkts
        self.rng = rng or np.random.default_rng(0)
        self.busy_until = 0.0
        self.overhead = overhead  # per-packet header bytes on the wire
        self.n_sent = 0
        self.n_dropped_queue = 0
        self.n_dropped_loss = 0
        self.bytes_delivered = 0
        # network fault plane (DESIGN.md §14). ``faultable`` stays False
        # until a LinkFaultSchedule arms this pipe — the default send
        # paths then never branch on any of this state, so an unarmed
        # run is bitwise-identical to a build without the fault plane.
        self.faultable = False
        self.up = True
        self.link_gen = 0        # bumps on every link_down: in-flight fence
        self.backup: Optional["Pipe"] = None   # spine-redundant reroute
        self.n_dropped_down = 0  # packets blackholed by a dead link
        self.n_rerouted = 0      # packets diverted onto the backup pipe
        self._base_rate = rate_bps
        self._base_loss = loss

    # -- fault plane (DESIGN.md §14) ----------------------------------------
    def set_up(self, up: bool) -> None:
        """Admin link state. Downing the link bumps ``link_gen`` so every
        delivery already scheduled on the wire is fenced out at arrival —
        no silent delivery from a dead link (the §9 generation pattern
        applied to the physical layer). The serializer backlog burns with
        the link."""
        self.faultable = True
        if self.up == up:
            return
        self.up = up
        if not up:
            self.link_gen += 1
            self.busy_until = 0.0

    def set_degraded(self, rate_factor: float = 1.0,
                     extra_loss: float = 0.0) -> None:
        """Degrade the link in place: cut the line rate by
        ``rate_factor`` and/or surge the random-loss probability."""
        self.faultable = True
        self.rate = self._base_rate * max(rate_factor, 1e-9)
        self.loss = min(1.0, self._base_loss + max(extra_loss, 0.0))

    def clear_degraded(self) -> None:
        self.rate = self._base_rate
        self.loss = self._base_loss

    def _deliver_fenced(self, deliver: Callable[[Packet], None],
                        pkt: Packet, gen: int) -> None:
        """Delivery on a faultable pipe: drop if the link went down after
        this packet entered the wire (``link_gen`` moved)."""
        if gen == self.link_gen:
            deliver(pkt)
        else:
            self.n_dropped_down += 1
            self.bytes_delivered -= pkt.size

    def _deliver_train_fenced(self, deliver_train: Callable[["TrainItems"], None],
                              items: "TrainItems", gen: int) -> None:
        if gen == self.link_gen:
            deliver_train(items)
        else:
            self.n_dropped_down += len(items)
            self.bytes_delivered -= sum(p.size for p, _ in items)

    def queue_len(self) -> float:
        backlog = max(0.0, self.busy_until - self.sim.now)
        return backlog * self.rate / 8.0 / 1500.0

    def recycle(self) -> None:
        """Drop residual serializer backlog (pooled per-flow back
        channels between iterations; cumulative counters are kept)."""
        self.busy_until = 0.0

    # replint: hotpath
    def send(self, pkt: Packet, deliver: Callable[[Packet], None]) -> bool:
        """Returns False if droptail-dropped at enqueue."""
        if self.faultable and not self.up:
            bk = self.backup
            if bk is not None and bk.up:
                self.n_rerouted += 1
                return bk.send(pkt, deliver)
            self.n_dropped_down += 1
            return True   # blackholed in flight (the sender can't tell)
        if self.queue_len() >= self.cap:
            self.n_dropped_queue += 1
            return False
        wire = pkt.size + self.overhead
        start = max(self.sim.now, self.busy_until)
        self.busy_until = start + wire * 8.0 / self.rate
        self.n_sent += 1
        if self.rng.random() < self.loss:
            self.n_dropped_loss += 1
            return True  # consumed wire time, dropped in flight
        arrive = self.busy_until + self.delay
        self.bytes_delivered += pkt.size
        PERF.packets += 1
        if self.faultable:
            # armed pipe: deliveries fence on link_gen so a cut kills
            # everything still on the wire (DESIGN.md §14)
            self.sim.at(arrive,
                        partial(self._deliver_fenced, deliver, pkt,
                                self.link_gen))
            return True
        # partial() beats a def-closure here: this is the per-packet hot
        # path and partial allocates no code/cell objects
        self.sim.at(arrive, partial(deliver, pkt))
        return True

    def send_train(self, pkts: Sequence[Packet],
                   deliver_train: Callable[[TrainItems], None],
                   t_ready: Optional[Sequence[float]] = None) -> int:
        """Send a train of packets as ONE heap event (DESIGN.md §7).

        Admission, serialization, and loss for the whole train are decided
        in a single vectorized pass that consumes the pipe's RNG stream in
        the same order the per-packet path would (queue drops never draw;
        admitted packets draw in send order), so a same-seed burst through
        ``send_train`` reproduces ``send`` exactly: same drops, same
        arrival times, same bytes. ``deliver_train`` fires once, at the
        last survivor's arrival, with per-packet ``(pkt, arrival_time)``
        pairs in arrival order.

        ``t_ready`` optionally gives per-packet *logical* enqueue times —
        used by multi-hop ``Route`` relays (each packet's previous-hop
        arrival) and staggered cross-traffic bursts. The relay event fires
        at the train's last arrival, so logical times may precede the
        event time: admission and serialization are computed retroactively
        at those times (exact when no other flow touched the pipe in
        between; a bounded approximation under interleaving). That path
        walks the train in order — still one event. Returns the number of
        packets admitted past the droptail queue.
        """
        if not pkts:
            return 0
        if self.faultable and not self.up:
            bk = self.backup
            if bk is not None and bk.up:
                self.n_rerouted += len(pkts)
                return bk.send_train(pkts, deliver_train, t_ready)
            self.n_dropped_down += len(pkts)
            return 0
        now = self.sim.now
        if t_ready is None:
            # same-instant burst: time does not advance within the event, so
            # the backlog only grows while admitting and freezes on a drop —
            # the first droptail drop ends the admitted prefix. Serialization
            # is a running sum in plain floats (cheaper than numpy's fixed
            # per-call cost at typical train lengths of 8..64); only the
            # loss draws vectorize — one RNG call, consuming the stream in
            # the exact order the per-packet path would.
            busy = self.busy_until
            qcap = self.cap * 1500.0 * 8.0 / self.rate    # cap in seconds
            inv_rate = 8.0 / self.rate
            admitted = []
            ends = []
            for p in pkts:
                if busy - now >= qcap or qcap <= 0:
                    break
                busy = (busy if busy > now else now) + \
                    (p.size + self.overhead) * inv_rate
                admitted.append(p)
                ends.append(busy)
            self.n_dropped_queue += len(pkts) - len(admitted)
            if not admitted:
                return 0
            self.busy_until = busy
            n_acc = len(admitted)
            self.n_sent += n_acc
            keep = self.rng.random(n_acc) >= self.loss
            self.n_dropped_loss += n_acc - int(keep.sum())
            items = [(p, e + self.delay)
                     for p, e, k in zip(admitted, ends, keep) if k]
            if not items:
                return n_acc
        else:
            items = []
            busy = self.busy_until
            n_acc = 0
            for pkt, tr in zip(pkts, t_ready):
                tr = float(tr)
                if max(0.0, busy - tr) * self.rate / 8.0 / 1500.0 >= self.cap:
                    self.n_dropped_queue += 1
                    continue
                busy = max(tr, busy) + (pkt.size + self.overhead) * 8.0 / self.rate
                self.n_sent += 1
                n_acc += 1
                if self.rng.random() < self.loss:
                    self.n_dropped_loss += 1
                    continue
                items.append((pkt, busy + self.delay))
            self.busy_until = busy
            if not items:
                return n_acc
        self.bytes_delivered += sum(p.size for p, _ in items)
        PERF.packets += len(items)
        if self.faultable:
            self.sim.at(items[-1][1],
                        partial(self._deliver_train_fenced, deliver_train,
                                items, self.link_gen))
        else:
            self.sim.at(items[-1][1], partial(deliver_train, items))
        return n_acc


class Route:
    """A chain of pipes traversed in order (store-and-forward per hop).

    Senders only require an object with ``send(pkt, deliver)``, so a
    ``Route`` substitutes for a ``Pipe`` anywhere: the packet re-enqueues
    at each hop's droptail queue, pays each hop's serialization + delay,
    and dies silently if any hop drops it. A one-pipe route behaves
    identically to using the pipe directly.
    """

    def __init__(self, pipes: Sequence[Pipe]) -> None:
        if not pipes:
            raise ValueError("Route needs at least one pipe")
        self.pipes = list(pipes)

    def send(self, pkt: Packet, deliver: Callable[[Packet], None]) -> bool:
        return self._hop(0, pkt, deliver)

    def _hop(self, i: int, pkt: Packet, deliver: Callable[[Packet], None]) -> bool:
        if i == len(self.pipes) - 1:
            return self.pipes[i].send(pkt, deliver)
        return self.pipes[i].send(
            pkt, lambda p, i=i: self._hop(i + 1, p, deliver)
        )

    def send_train(self, pkts: Sequence[Packet],
                   deliver_train: Callable[[TrainItems], None],
                   t_ready: Optional[Sequence[float]] = None) -> int:
        """Train relay over the hop chain: each hop's survivors re-enter
        the next hop as one train, carrying their per-packet hop-arrival
        times as that hop's enqueue times — still one event per hop."""
        return self._hop_train(0, list(pkts), deliver_train, t_ready)

    def _hop_train(self, i: int, pkts: List[Packet],
                   deliver_train: Callable[[TrainItems], None],
                   t_ready: Optional[Sequence[float]]) -> int:
        if i == len(self.pipes) - 1:
            return self.pipes[i].send_train(pkts, deliver_train, t_ready)

        def relay(items: TrainItems, i: int = i) -> None:
            self._hop_train(i + 1, [p for p, _ in items], deliver_train,
                            [t for _, t in items])

        return self.pipes[i].send_train(pkts, relay, t_ready)

    # aggregate counters over hops (drop-anywhere semantics)
    @property
    def n_dropped_queue(self) -> int:
        return sum(p.n_dropped_queue for p in self.pipes)

    @property
    def n_dropped_loss(self) -> int:
        return sum(p.n_dropped_loss for p in self.pipes)

    @property
    def n_dropped_down(self) -> int:
        return sum(p.n_dropped_down for p in self.pipes)

    @property
    def up(self) -> bool:
        """True when every hop is admin-up OR can reroute around its cut
        (fault plane, DESIGN.md §14) — the path can still carry traffic."""
        return all(p.up or (p.backup is not None and p.backup.up)
                   for p in self.pipes)


class Topology:
    """Named-pipe registry grouping links into *pipe groups* (one per PS
    shard in the multi-PS scenarios). Purely bookkeeping: construction
    helpers + aggregate statistics; the event loop stays in ``Sim``.
    """

    def __init__(self, sim: Sim) -> None:
        self.sim = sim
        self.pipes: Dict[str, Pipe] = {}
        self.groups: Dict[str, List[str]] = {}

    def add_pipe(self, name: str, pipe: Pipe, group: Optional[str] = None) -> Pipe:
        if name in self.pipes:
            raise ValueError(f"duplicate pipe name {name!r}")
        self.pipes[name] = pipe
        if group is not None:
            self.groups.setdefault(group, []).append(name)
        return pipe

    def route(self, *names: str) -> Route:
        return Route([self.pipes[n] for n in names])

    def group_pipes(self, group: str) -> List[Pipe]:
        return [self.pipes[n] for n in self.groups.get(group, [])]

    def queue_depths(self, group: Optional[str] = None) -> Dict[str, float]:
        """Per-pipe instantaneous queue depth in packets (actor hook:
        telemetry samplers attach via ``Sim.every`` and snapshot this)."""
        names = (self.groups.get(group, []) if group is not None
                 else list(self.pipes))
        return {n: self.pipes[n].queue_len() for n in names}

    def stats(self) -> Dict[str, Dict[str, float]]:
        """Per-group totals: sent/dropped/delivered-bytes."""
        out: Dict[str, Dict[str, float]] = {}
        for group, names in self.groups.items():
            ps = [self.pipes[n] for n in names]
            out[group] = {
                "n_sent": sum(p.n_sent for p in ps),
                "n_dropped_queue": sum(p.n_dropped_queue for p in ps),
                "n_dropped_loss": sum(p.n_dropped_loss for p in ps),
                "bytes_delivered": sum(p.bytes_delivered for p in ps),
            }
        return out


class CrossTrafficSource:
    """Open-loop background traffic on one pipe (bursty on/off).

    During ON periods, MTU-sized packets are injected at ``load`` × the
    pipe's line rate (so ``load`` is the long-run offered fraction of
    capacity while ON). ON/OFF durations are exponential with the given
    means, modelling other tenants' flows crossing the ToR — the traffic
    competes for the same serializer and droptail queue as the gather
    flows but is never ACKed or retransmitted.
    """

    FLOW_ID = -1  # cross-traffic packets carry flow == -1

    def __init__(self, sim: Sim, pipe: Pipe, load: float,
                 rng: Optional[np.random.Generator] = None,
                 pkt_bytes: int = 1500,
                 on_mean: float = 10e-3, off_mean: float = 10e-3,
                 duty: Optional[float] = None,
                 train_len: int = 1) -> None:
        self.sim = sim
        self.pipe = pipe
        self.load = float(load)
        self.rng = rng or np.random.default_rng(0)
        self.pkt_bytes = pkt_bytes
        self.train_len = max(1, int(train_len))
        self.on_mean = on_mean
        if duty is not None:
            # explicit duty cycle: derive the OFF mean from it
            self.duty = float(duty)
            self.off_mean = on_mean * (1.0 - self.duty) / max(self.duty, 1e-9)
        else:
            self.off_mean = off_mean
            self.duty = on_mean / (on_mean + off_mean)
        self.n_injected = 0
        self.n_delivered = 0
        self._seq = 0
        self._stopped = False
        self._running = False
        self._gen = 0          # burst-chain generation (restart safety)

    @property
    def offered_bps(self) -> float:
        """Long-run average offered load in bits/s."""
        return self.load * self.duty * self.pipe.rate

    def start(self) -> None:
        """Begin injecting. Idempotent: a second ``start`` on a running
        source is a no-op (no doubled burst chains); ``start`` after
        ``stop`` resumes from a fresh burst."""
        if self._running:
            return
        self._stopped = False
        self._running = True
        self._gen += 1         # orphan any pending chain from a prior life
        self._burst(self._gen)

    def stop(self) -> None:
        """Cease injecting (idempotent). Pending burst events become
        no-ops; already-enqueued packets still drain through the pipe."""
        self._stopped = True
        self._running = False

    def _burst(self, gen: Optional[int] = None) -> None:
        gen = self._gen if gen is None else gen
        if self._stopped or gen != self._gen or self.load <= 0:
            return
        on = self.rng.exponential(self.on_mean)
        gap = self.pkt_bytes * 8.0 / (self.load * self.pipe.rate)
        n = max(1, int(on / gap))
        if self.train_len > 1:
            # chunked trains: one event injects up to train_len packets with
            # staggered enqueue times, pre-claiming at most train_len * gap
            # of future wire time (a bounded approximation of the per-packet
            # interleaving; DESIGN.md §7)
            for start in range(0, n, self.train_len):
                k = min(self.train_len, n - start)
                self.sim.after(
                    start * gap,
                    lambda k=k, gap=gap: self._inject_train(k, gap, gen))
        else:
            for i in range(n):
                self.sim.after(i * gap, lambda: self._inject(gen))
        off = self.rng.exponential(self.off_mean)
        self.sim.after(on + off, lambda: self._burst(gen))

    def _inject(self, gen: Optional[int] = None) -> None:
        if self._stopped or (gen is not None and gen != self._gen):
            return
        self._seq += 1
        self.n_injected += 1
        pkt = Packet(self.FLOW_ID, self._seq, self.pkt_bytes, kind="data",
                     meta={"cross": True})
        self.pipe.send(pkt, self._sink)

    def _inject_train(self, k: int, gap: float,
                      gen: Optional[int] = None) -> None:
        if self._stopped or (gen is not None and gen != self._gen):
            return
        now = self.sim.now
        pkts = []
        for _ in range(k):
            self._seq += 1
            self.n_injected += 1
            pkts.append(Packet(self.FLOW_ID, self._seq, self.pkt_bytes,
                               kind="data", meta={"cross": True}))
        self.pipe.send_train(pkts, self._sink_train,
                             t_ready=[now + i * gap for i in range(k)])

    def _sink(self, pkt: Packet) -> None:
        self.n_delivered += 1

    def _sink_train(self, items: TrainItems) -> None:
        self.n_delivered += len(items)
