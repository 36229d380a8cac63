"""Sender-side congestion-control state machines.

Reno / Cubic are order-preserving, cumulative-ACK, loss-as-congestion.
BBR is a simplified BDP prober (loss-agnostic rate control, reliable).
LTP (paper §III/§IV): out-of-order transmission, per-packet ACK,
3-OOO-ACK loss detection, CQ/NQ/RQ queues, BDP-based CC with approximate
pacing, and receiver-driven Early Close ("stop").

Packet trains (DESIGN.md §7): with ``train_len > 1`` and a train-aware
``deliver_train`` callback attached, LTP and the window-based TCP family
emit bursts as coalesced trains through ``Pipe.send_train`` and consume
batched ACK trains via ``on_ack_train`` — K packets per heap event in
both directions. BBR keeps its per-packet pacing clock (its control law
is the inter-send spacing itself) and ignores ``train_len``.

Flow pooling (DESIGN.md §9): every sender supports ``reset(gen)`` — it
restores cold-start state in place so the cluster runtime can reuse one
sender object per (worker, shard) across iterations instead of
reconstructing the whole flow graph each round. ``gen`` is a flow
generation stamped into every outgoing packet's ``meta["g"]`` and echoed
back in ACKs; state machines silently drop packets from another
generation, so deliveries still in flight when a flow is recycled cannot
leak into the next round. Un-pooled callers never pass ``gen`` and both
sides stay at generation 0.
"""
from __future__ import annotations

import collections
import math
from functools import partial
from typing import Callable, Deque, Dict, List, Optional, Set, Tuple

import numpy as np

from repro_torch.net.genfence import GEN_KEY, echo_stale, gen_of, is_stale
from repro_torch.net.simcore import Packet, Pipe, Sim, TrainItems

MSS = 1460          # TCP payload bytes per packet
TCP_OVERHEAD = 40
LTP_PAYLOAD = 1435  # 1500 - 28 (UDP/IP) - 9 (LTP header) ≈ paper §IV-A
LTP_OVERHEAD = 37


#: protocol name -> sender class; scenario code goes through ``make_sender``
#: so new congestion controllers plug in without touching the scenarios.
SENDER_REGISTRY: Dict[str, type] = {}


def register_sender(name: str):
    def deco(cls):
        SENDER_REGISTRY[name] = cls
        return cls
    return deco


def make_sender(protocol: str, sim: "Sim", pipe, deliver, n_packets: int, *,
                flow: int = 0, rng=None, on_done=None, critical=None,
                train_len: int = 1):
    """Uniform sender construction over every registered protocol.

    ``pipe`` is anything with ``send(pkt, deliver)`` — a ``Pipe`` or a
    multi-hop ``Route``. LTP-specific knobs (``critical``, ``rng``) are
    ignored by the TCP family. ``train_len`` > 1 enables coalesced packet
    trains on senders that support them (callers must also attach a
    train-aware ``deliver_train``).
    """
    try:
        cls = SENDER_REGISTRY[protocol]
    except KeyError:
        raise ValueError(
            f"unknown protocol {protocol!r}; registered: "
            f"{sorted(SENDER_REGISTRY)}") from None
    if issubclass(cls, LTPSender):
        return cls(sim, pipe, deliver, n_packets, critical=critical,
                   flow=flow, rng=rng, on_done=on_done, train_len=train_len)
    return cls(sim, pipe, deliver, n_packets, flow=flow, on_done=on_done,
               train_len=train_len)


class RateEstimator:
    """BBR-style windowed max(delivery rate) + min(rtt)."""

    def __init__(self, sim: Sim):
        self.sim = sim
        self._acks: Deque[Tuple[float, int]] = collections.deque()
        self._bw_samples: Deque[Tuple[float, float]] = collections.deque()
        self.reset()

    def reset(self) -> None:
        """Cold-start state in place (flow pooling, DESIGN.md §9)."""
        self.rtprop = math.inf
        self._acks.clear()
        self._ack_bytes = 0
        self._bw_samples.clear()
        self._btlbw = 0.0

    def on_ack(self, nbytes: int, rtt: float):
        now = self.sim.now
        self.rtprop = min(self.rtprop, rtt)
        self._acks.append((now, nbytes))
        self._ack_bytes += nbytes
        horizon = max(self.rtprop * 2, 2e-3) if math.isfinite(self.rtprop) else 10e-3
        while self._acks and self._acks[0][0] < now - horizon:
            self._ack_bytes -= self._acks.popleft()[1]
        if len(self._acks) >= 2:
            dt = self._acks[-1][0] - self._acks[0][0]
            nb = self._ack_bytes - self._acks[0][1]
            if dt > 0:
                rate = nb * 8.0 / dt
                # monotonic deque: windowed max in O(1) amortized
                while self._bw_samples and self._bw_samples[-1][1] <= rate:
                    self._bw_samples.pop()
                self._bw_samples.append((now, rate))
        bw_horizon = max(self.rtprop * 10, 20e-3) if math.isfinite(self.rtprop) else 0.1
        while self._bw_samples and self._bw_samples[0][0] < now - bw_horizon:
            self._bw_samples.popleft()

    @property
    def btlbw(self) -> float:
        return self._bw_samples[0][1] if self._bw_samples else 0.0

    def bdp_pkts(self, mss: int) -> float:
        if not math.isfinite(self.rtprop) or self.btlbw <= 0:
            return 10.0
        return max(4.0, self.btlbw * self.rtprop / 8.0 / mss)


# ============================================================================
# Order-preserving TCP family
# ============================================================================


class TcpReceiver:
    """Cumulative-ACK receiver shared by Reno/Cubic/BBR."""

    def __init__(self, sim: Sim, send_ack: Callable[[Packet], None], flow: int):
        self.sim = sim
        self.send_ack = send_ack
        # transport wiring, attached once from outside; reset() keeps it
        self.send_ack_train: Optional[Callable[[List[Packet]], None]] = None  # replint: ok(pool-reset)
        self.flow = flow
        self.received: Set[int] = set()
        self.gen = 0
        self.reset()

    def reset(self, gen: Optional[int] = None,
              n_total: Optional[int] = None) -> None:
        """Cold-start receiver state in place (flow pooling)."""
        if gen is not None:
            self.gen = gen
        self.received.clear()
        self.next_expected = 0
        self.complete_time: Optional[float] = None
        self.n_total: Optional[int] = n_total

    def _stale(self, pkt: Packet) -> bool:
        g = gen_of(pkt.meta)
        return g is not None and g != self.gen

    # replint: hotpath
    def _ack_for(self, pkt: Packet) -> Packet:
        if pkt.kind == "reg":
            self.n_total = pkt.meta["n"]
        else:
            self.received.add(pkt.seq)
            while self.next_expected in self.received:
                self.next_expected += 1
        return Packet(self.flow, pkt.seq, TCP_OVERHEAD, kind="ack",
                      meta={"cum": self.next_expected, "echo": pkt.meta})

    def on_data(self, pkt: Packet):
        if self._stale(pkt):
            return
        self.send_ack(self._ack_for(pkt))
        if self.n_total is not None and self.next_expected >= self.n_total \
                and self.complete_time is None:
            self.complete_time = self.sim.now

    def on_data_train(self, items: TrainItems):
        """Process a coalesced train; the completion stamp uses the true
        per-packet arrival time, and the ACKs go back as one train."""
        acks = []
        for pkt, t in items:
            if self._stale(pkt):
                continue
            acks.append(self._ack_for(pkt))
            if self.n_total is not None and self.next_expected >= self.n_total \
                    and self.complete_time is None:
                self.complete_time = t
        if not acks:
            return
        if self.send_ack_train is not None:
            self.send_ack_train(acks)
        else:
            for a in acks:
                self.send_ack(a)


class _TcpBase:
    """Window-based reliable sender skeleton with SACK-style recovery
    (Linux-default behaviour). Reno/Cubic differ only in the cwnd law."""

    DUPTHRESH = 3

    def __init__(self, sim: Sim, pipe: Pipe, deliver: Callable, n_packets: int,
                 flow: int = 0, mss: int = MSS, on_done: Optional[Callable] = None,
                 train_len: int = 1):
        self.sim = sim
        self.pipe = pipe
        self.deliver = deliver
        # transport wiring, attached once from outside; reset() keeps it
        self.deliver_train: Optional[Callable[[TrainItems], None]] = None  # replint: ok(pool-reset)
        self.train_len = max(1, int(train_len))
        self.n = n_packets
        self.flow = flow
        self.mss = mss
        self.on_done = on_done
        self.inflight: Set[int] = set()
        self.sacked: Set[int] = set()
        self.retx: collections.deque = collections.deque()
        self.sent_time: Dict[int, float] = {}
        self.gen = 0
        self.rto_event: Optional[int] = None
        self.reset()

    def reset(self, gen: Optional[int] = None) -> None:
        """Restore cold-start sender state in place (flow pooling).

        ``gen`` bumps the flow generation: stale ACKs from a previous
        life of this sender (echoing an older ``meta["g"]``) are dropped
        on arrival instead of corrupting the fresh state machine.
        """
        if gen is not None:
            self.gen = gen
        self._train_buf = None
        self._in_ack_train = False
        self._rto_dirty = False
        self.cwnd = 10.0
        self.ssthresh = math.inf
        self.next_new = 0
        self.cum = 0
        self.dup = 0
        self.recover = -1
        self.inflight.clear()
        self.sacked.clear()
        self.retx.clear()
        self.marked: Set[int] = set()   # lost-marked this recovery episode
        self._scan_hi = 0               # scoreboard scan high-water mark
        self.sent_time.clear()
        self.srtt: Optional[float] = None
        self.rttvar = 0.0
        if self.rto_event is not None:
            self.sim.cancel(self.rto_event)
        self.rto_event = None
        self.done = False
        self.start_time: Optional[float] = None
        self.bytes_acked = 0

    def kill(self) -> None:
        """Hard-stop this sender (node death / pooled teardown): no
        completion callback, no further transmissions, all timers
        cancelled. In-flight ACKs fall on ``done`` and are ignored; the
        pooled sender revives through ``reset(gen=...)``."""
        self.done = True
        if self.rto_event is not None:
            self.sim.cancel(self.rto_event)
        self.rto_event = None
        pt = getattr(self, "pacing_timer", None)
        if pt is not None:
            self.sim.cancel(pt)
            self.pacing_timer = None

    # --- cwnd law hooks -----------------------------------------------------
    def on_ack_growth(self, newly: int):
        if self.cwnd < self.ssthresh:
            self.cwnd += newly
        else:
            self.cwnd += newly / self.cwnd

    def on_loss_cut(self):
        self.ssthresh = max(2.0, self.cwnd / 2.0)
        self.cwnd = self.ssthresh

    # -------------------------------------------------------------------------
    def start(self):
        self.start_time = self.sim.now
        self._arm_rto()
        self._pump()

    @property
    def rto(self) -> float:
        if self.srtt is None:
            return 0.2
        return max(0.01, self.srtt + 4 * self.rttvar)

    def _arm_rto(self):
        if self._in_ack_train:       # one re-arm per ack train, at its end
            self._rto_dirty = True
            return
        if self.rto_event is not None:
            self.sim.cancel(self.rto_event)
        self.tlp_armed = True
        delay = max(2 * (self.srtt or 0.05), 0.002)
        self.rto_event = self.sim.after(min(delay, self.rto), self._on_tlp)

    def _on_tlp(self):
        """Tail-loss probe: retransmit the head once before a full RTO."""
        if self.done:
            return
        self._prune_inflight()
        if self.cum < self.next_new and self.cum not in self.sacked:
            self._send(self.cum)
        self.rto_event = self.sim.after(self.rto, self._on_rto)
        self._pump()

    def _on_rto(self):
        if self.done:
            return
        self.ssthresh = max(2.0, self.cwnd / 2.0)
        self.cwnd = 1.0
        self.dup = 0
        self.recover = -1
        self.inflight.clear()
        self.retx.clear()
        self.marked = set()
        self._scan_hi = self.cum
        for s in range(self.cum, self.next_new):
            if s not in self.sacked:
                self.marked.add(s)
                self.retx.append(s)
        self._arm_rto()
        self._pump()

    def _mark_lost(self, s: int):
        if s in self.marked or s in self.sacked or s < self.cum:
            return
        self.marked.add(s)
        self.inflight.discard(s)
        self.retx.append(s)

    # replint: hotpath
    def _send(self, seq: int):
        pkt = Packet(self.flow, seq, self.mss, kind="data",
                     meta={"t": self.sim.now, GEN_KEY: self.gen})
        self.inflight.add(seq)
        self.sent_time[seq] = self.sim.now
        if self._train_buf is not None:
            self._train_buf.append(pkt)
        else:
            self.pipe.send(pkt, self.deliver)

    def _prune_inflight(self):
        """Expire inflight entries older than RTO (silent queue drops would
        otherwise pin the window shut)."""
        cutoff = self.sim.now - self.rto
        # sorted so the retransmit queue fills in seq order, not set-hash
        # order (bitwise same-seed replay must not depend on set history)
        stale = sorted(s for s in self.inflight
                       if self.sent_time.get(s, 0) < cutoff)
        for s in stale:
            self.inflight.discard(s)
            if s >= self.cum and s not in self.sacked and s not in self.retx:
                self.retx.append(s)

    def _pump(self):
        if self._in_ack_train:       # one pump per ack train, at its end
            return
        if self.train_len > 1 and self.deliver_train is not None:
            self._train_buf = []
            try:
                self._pump_window()
            finally:
                buf, self._train_buf = self._train_buf, None
            for i in range(0, len(buf), self.train_len):
                self.pipe.send_train(buf[i:i + self.train_len],
                                     self.deliver_train)
            return
        self._pump_window()

    # replint: hotpath
    def _pump_window(self):
        while len(self.inflight) < int(self.cwnd):
            if self.retx:
                seq = self.retx.popleft()
                if seq >= self.cum and seq not in self.sacked:
                    self._send(seq)
                continue
            if self.next_new < self.n:
                self._send(self.next_new)
                self.next_new += 1
            else:
                break

    def on_ack(self, pkt: Packet):
        if self.done:
            return
        echo = pkt.meta.get("echo") or {}
        if echo_stale(echo, self.gen):
            return          # ACK for a previous life of this pooled flow
        cum = pkt.meta["cum"]
        if "t" in echo:
            rtt = self.sim.now - echo["t"]
            if self.srtt is None:
                self.srtt, self.rttvar = rtt, rtt / 2
            else:
                self.rttvar = 0.75 * self.rttvar + 0.25 * abs(self.srtt - rtt)
                self.srtt = 0.875 * self.srtt + 0.125 * rtt
        # SACK: the data seq this ACK acknowledges
        if pkt.seq >= self.cum:
            if pkt.seq not in self.sacked:
                self.sacked.add(pkt.seq)
                self._arm_rto()   # any forward progress re-arms the timer
            self.inflight.discard(pkt.seq)
        if cum > self.cum:
            newly = cum - self.cum
            self.bytes_acked += newly * self.mss
            for s in range(self.cum, cum):
                self.inflight.discard(s)
                self.sacked.discard(s)
            self.cum = cum
            self.dup = 0
            if self.recover >= 0 and cum > self.recover:
                self.recover = -1
            elif self.recover >= 0 and cum < self.next_new and \
                    cum not in self.sacked:
                self._mark_lost(cum)   # NewReno partial-ACK retransmit
            self.on_ack_growth(newly)
            self._arm_rto()
        elif cum == self.cum and cum < self.n:
            self.dup += 1
            if self.dup >= self.DUPTHRESH and self.sacked:
                # SACK scoreboard: unSACKed seqs DUPTHRESH below the highest
                # SACKed seq are lost. Rate cut once per recovery episode;
                # ``marked`` + the scan pointer keep this O(1) amortized.
                hs = max(self.sacked)
                if self.recover < 0:
                    self.recover = self.next_new
                    self.on_loss_cut()
                    self.marked = set()
                    self._scan_hi = self.cum
                for s in range(self._scan_hi, max(self._scan_hi, hs - self.DUPTHRESH + 1)):
                    if s not in self.sacked:
                        self._mark_lost(s)
                self._scan_hi = max(self._scan_hi, hs - self.DUPTHRESH + 1)
                if self.cum not in self.sacked:
                    self._mark_lost(self.cum)
        if self.cum >= self.n:
            self.done = True
            if self.rto_event is not None:
                self.sim.cancel(self.rto_event)
            if self.on_done:
                self.on_done(self)
            return
        self._pump()

    def on_ack_train(self, items: TrainItems):
        """Consume a batched ACK train: per-ack cwnd/SACK bookkeeping runs
        unchanged, but the RTO re-arm and the send pump fire once for the
        whole train instead of once per ack."""
        if self.done:
            return
        self._in_ack_train = True
        self._rto_dirty = False
        try:
            for pkt, _t in items:
                self.on_ack(pkt)
                if self.done:
                    return
        finally:
            self._in_ack_train = False
        if self._rto_dirty:
            self._arm_rto()
        self._pump()


@register_sender("reno")
class RenoSender(_TcpBase):
    pass


@register_sender("cubic")
class CubicSender(_TcpBase):
    C = 0.4
    BETA = 0.7

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.wmax = 0.0
        self.epoch: Optional[float] = None

    def reset(self, gen: Optional[int] = None) -> None:
        super().reset(gen)
        self.wmax = 0.0
        self.epoch = None

    def on_loss_cut(self):
        self.wmax = self.cwnd
        self.cwnd = max(2.0, self.cwnd * self.BETA)
        self.ssthresh = self.cwnd
        self.epoch = None

    def on_ack_growth(self, newly: int):
        if self.cwnd < self.ssthresh:
            self.cwnd += newly
            return
        if self.epoch is None:
            self.epoch = self.sim.now
            self.k = (self.wmax * (1 - self.BETA) / self.C) ** (1.0 / 3.0)
        t = self.sim.now - self.epoch
        target = self.C * (t - self.k) ** 3 + self.wmax
        if target > self.cwnd:
            self.cwnd = min(target, self.cwnd + newly)
        else:
            self.cwnd += 0.01 * newly


@register_sender("bbr")
class BBRSender(_TcpBase):
    """Paced BDP sender; loss does not cut the rate (reliable via retx)."""

    GAINS = [1.25, 0.75, 1, 1, 1, 1, 1, 1]

    def __init__(self, *a, **kw):
        self.est = None
        super().__init__(*a, **kw)

    def reset(self, gen: Optional[int] = None) -> None:
        super().reset(gen)
        if self.est is None:
            self.est = RateEstimator(self.sim)
        else:
            self.est.reset()
        self.phase = 0
        self.phase_start = 0.0
        self.startup = True
        self.full_bw = 0.0
        self.full_cnt = 0
        self.next_send_time = 0.0
        if getattr(self, "pacing_timer", None) is not None:
            self.sim.cancel(self.pacing_timer)
        self.pacing_timer: Optional[int] = None
        self.round_end_seq = 0  # cum level that closes the current round

    def on_loss_cut(self):  # loss is not a congestion signal
        pass

    def on_ack_growth(self, newly: int):
        pass

    def _gain(self) -> float:
        if self.startup:
            return 2.885
        if math.isfinite(self.est.rtprop) and \
                self.sim.now - self.phase_start > self.est.rtprop:
            self.phase = (self.phase + 1) % len(self.GAINS)
            self.phase_start = self.sim.now
        return self.GAINS[self.phase]

    def _cap(self) -> float:
        return 2.0 * self.est.bdp_pkts(self.mss) if not self.startup else \
            max(10.0, 3.0 * self.est.bdp_pkts(self.mss))

    def _pump(self):
        if self.done:
            return
        if len(self.inflight) >= self._cap():
            return
        rate = self.est.btlbw * self._gain()
        if rate <= 0:
            rate = float("inf")  # no estimate yet: blast the initial window
        if self.sim.now < self.next_send_time:
            if self.pacing_timer is None:
                def fire():
                    self.pacing_timer = None
                    self._pump()
                self.pacing_timer = self.sim.at(self.next_send_time, fire)
            return
        seq = None
        while self.retx and seq is None:
            seq = self.retx.popleft()
            if seq < self.cum or seq in self.sacked:
                seq = None
        if seq is None and self.next_new < self.n:
            seq = self.next_new
            self.next_new += 1
        if seq is None:
            return
        self._send(seq)
        self.next_send_time = self.sim.now + self.mss * 8.0 / rate
        g = self.gen
        self.sim.at(self.next_send_time,
                    lambda: self.gen == g and self._pump())

    def on_ack(self, pkt: Packet):
        echo = pkt.meta.get("echo") or {}
        if echo_stale(echo, self.gen):
            return          # ACK for a previous life of this pooled flow
        if "t" in echo:
            self.est.on_ack(self.mss, self.sim.now - echo["t"])
        if self.startup and pkt.meta["cum"] >= self.round_end_seq:
            # once per round-trip of data: has btlbw plateaued?
            self.round_end_seq = self.next_new
            bw = self.est.btlbw
            if bw > self.full_bw * 1.25:
                self.full_bw = bw
                self.full_cnt = 0
            else:
                self.full_cnt += 1
                if self.full_cnt >= 3:
                    self.startup = False
        super().on_ack(pkt)


# ============================================================================
# LTP sender (paper §III-D, §IV-B)
# ============================================================================


@register_sender("ltp")
class LTPSender:
    """Out-of-order sender with CQ/NQ/RQ queues and BDP-based CC.

    Self-healing (DESIGN.md §14): when ``heal`` is armed by the
    transport (only while a network fault plane is active — the default
    keeps healthy-run timing bitwise identical), consecutive watchdog
    RTOs with zero ACK progress escalate the retransmission timer
    exponentially up to ``RTO_BACKOFF_CAP``x, and ``BLACKHOLE_RTOS``
    consecutive RTOs abort the flow as dead-path: ``on_flow_dead(flow)``
    signals up to the transport instead of retransmitting forever into
    a blackhole. Registration retries ride the same backoff.
    """

    OOO_THRESH = 3
    RTO_BACKOFF_CAP = 16.0   # max multiplier on the watchdog delay
    BLACKHOLE_RTOS = 6       # consecutive silent RTOs -> path is dead

    def __init__(self, sim: Sim, pipe: Pipe, deliver: Callable, n_packets: int,
                 critical: Optional[np.ndarray] = None, flow: int = 0,
                 payload: int = LTP_PAYLOAD, rng: Optional[np.random.Generator] = None,
                 on_done: Optional[Callable] = None, train_len: int = 1):
        self.sim = sim
        self.pipe = pipe
        self.deliver = deliver
        # transport wiring, attached once from outside; reset() keeps it
        self.deliver_train: Optional[Callable[[TrainItems], None]] = None  # replint: ok(pool-reset)
        self.train_len = max(1, int(train_len))
        self.n = n_packets
        self.flow = flow
        self.payload = payload
        self.rng = rng or np.random.default_rng(0)
        self.on_done = on_done
        crit = critical if critical is not None else np.zeros(n_packets, bool)
        if n_packets > 0:   # paper: first/last bytes of the stream are critical
            crit = crit.copy()
            crit[0] = crit[-1] = True
        self.critical = crit
        # queue seeds, computed once — reset() rebuilds the deques from
        # these instead of re-running flatnonzero every iteration
        self._cq0 = np.flatnonzero(crit).tolist()
        self._nq0 = np.flatnonzero(~crit).tolist()
        self.cq: Deque[int] = collections.deque(self._cq0)
        self.nq: Deque[int] = collections.deque(self._nq0)
        self.est = RateEstimator(sim)
        self.send_order: Dict[int, int] = {}
        self.outstanding: Deque[Tuple[int, int]] = collections.deque()  # (order, seq)
        self.acked: Set[int] = set()
        self.gen = 0
        self.watchdog: Optional[int] = None
        self.pacing_timer: Optional[int] = None
        # observability counters (DESIGN.md §12) — cumulative across the
        # pooled flow's lives: initialized here, NOT cleared by reset()
        self.n_retx = 0         # replint: ok(pool-reset)
        self.n_ack_trains = 0   # replint: ok(pool-reset)
        self.n_gen_fenced = 0   # replint: ok(pool-reset)
        # self-healing (DESIGN.md §14): transport wiring + cumulative
        # counter survive pooled resets; the per-life backoff state is
        # re-initialized by reset()
        self.heal = False       # replint: ok(pool-reset)
        self.on_flow_dead: Optional[Callable[[int], None]] = None  # replint: ok(pool-reset)
        self.n_flow_dead = 0    # replint: ok(pool-reset)
        self.reset()

    def reset(self, gen: Optional[int] = None) -> None:
        """Restore cold-start state in place (flow pooling, DESIGN.md §9).

        Pending timers are cancelled and the flow generation bumps so
        stale deliveries/ACKs from the previous life are dropped.
        """
        if gen is not None:
            self.gen = gen
        self.cq.clear()
        self.cq.extend(self._cq0)
        self.nq.clear()
        self.nq.extend(self._nq0)
        self.rq: List[int] = []
        self.est.reset()
        self.send_order.clear()
        self.order_ctr = 0
        self.outstanding.clear()
        self.acked.clear()
        self.highest_acked_order = -1
        self.stopped = False
        self.done = False
        self.reg_acked = False
        self.startup = True
        self.full_bw = 0.0
        self.full_cnt = 0
        self.next_send_time = 0.0
        self.total_sent = 0
        self.start_time: Optional[float] = None
        self._phase = 0
        self._phase_start = 0.0
        self._last_check = -1.0
        self.rto_backoff = 1.0
        self.n_consec_rto = 0
        if self.watchdog is not None:
            self.sim.cancel(self.watchdog)
        self.watchdog = None
        if self.pacing_timer is not None:
            self.sim.cancel(self.pacing_timer)
        self.pacing_timer = None

    def kill(self) -> None:
        """Hard-stop (node death / pooled teardown): the flow goes
        permanently silent — no stop handshake, no callbacks, timers
        cancelled. Any traffic still in flight falls on ``done``/stale
        generation checks. ``reset(gen=...)`` revives the pooled flow."""
        self.stopped = True
        self.done = True
        if self.watchdog is not None:
            self.sim.cancel(self.watchdog)
        self.watchdog = None
        if self.pacing_timer is not None:
            self.sim.cancel(self.pacing_timer)
        self.pacing_timer = None

    def start(self):
        self.start_time = self.sim.now
        self.reg_acked = False
        self._send_reg(self.gen)
        self._pump()
        self._arm_watchdog()

    def _send_reg(self, gen: Optional[int] = None):
        """Registration carries the flow metadata — critical, so it is
        retried until acknowledged (paper §III-E: critical = 100%)."""
        if gen is not None and gen != self.gen:
            return          # retry chain from a previous life of the flow
        if self.reg_acked or self.done:
            return
        reg = Packet(self.flow, -1, 64, kind="reg",
                     meta={"n": self.n, "t": self.sim.now,
                           GEN_KEY: self.gen,
                           "critical": self.critical})
        self.pipe.send(reg, self.deliver)
        delay = (max(3 * self.est.rtprop, 5e-3)
                 if math.isfinite(self.est.rtprop) else 20e-3)
        if self.heal:
            # reg retries ride the RTO backoff (DESIGN.md §14): a dead
            # path must not be hammered at the base retry rate forever
            delay *= self.rto_backoff
        self.sim.after(delay, partial(self._send_reg, self.gen))

    def _arm_watchdog(self):
        if self.watchdog is not None:
            self.sim.cancel(self.watchdog)
        # per-packet retransmission timer: a few RTTs (ack losses must not
        # stall the flow — there is no cumulative-ACK recovery in LTP)
        delay = max(3 * self.est.rtprop, 3e-3) if math.isfinite(self.est.rtprop) else 0.2
        if self.heal:
            delay *= self.rto_backoff
        self.watchdog = self.sim.after(delay, self._on_watchdog)

    def _on_watchdog(self):
        """Stall recovery: treat all outstanding as lost (per-packet RTO).

        With healing armed, consecutive silent RTOs escalate the backoff
        and eventually declare the path dead (DESIGN.md §14)."""
        if self.done or self.stopped:
            return
        if self.heal:
            self.n_consec_rto += 1
            if self.n_consec_rto >= self.BLACKHOLE_RTOS:
                self._abort_blackhole()
                return
            self.rto_backoff = min(self.rto_backoff * 2.0,
                                   self.RTO_BACKOFF_CAP)
        while self.outstanding:
            _, seq = self.outstanding.popleft()
            if seq not in self.acked:
                self._requeue_lost(seq)
        self._arm_watchdog()
        self._pump()

    def _abort_blackhole(self):
        """``BLACKHOLE_RTOS`` consecutive RTOs with zero ACK progress:
        the path is dead (DESIGN.md §14). The flow aborts — permanently
        silent, no completion callback — and ``on_flow_dead`` signals up
        to the transport, which tears the worker's flows exactly like
        the node-death ``flow_torn`` path."""
        self.n_flow_dead += 1
        self.stopped = True
        self.done = True
        if self.watchdog is not None:
            self.sim.cancel(self.watchdog)
        self.watchdog = None
        if self.pacing_timer is not None:
            self.sim.cancel(self.pacing_timer)
        self.pacing_timer = None
        if self.on_flow_dead is not None:
            self.on_flow_dead(self.flow)

    def _requeue_lost(self, seq: int):
        self.n_retx += 1
        if self.critical[seq]:
            self.cq.append(seq)
        else:
            # random-in, first-out; scalar random() is ~2x cheaper than
            # integers() and this runs once per detected loss
            pos = int(self.rng.random() * (len(self.rq) + 1))
            self.rq.insert(pos, seq)

    def _next_seq(self) -> Optional[int]:
        while self.cq:
            s = self.cq.popleft()
            if s not in self.acked:
                return s
        while self.nq:
            s = self.nq.popleft()
            if s not in self.acked:
                return s
        while self.rq:
            s = self.rq.pop(0)
            if s not in self.acked:
                return s
        return None

    GAINS = [1.25, 0.75, 1, 1, 1, 1, 1, 1]  # BBR-style probe cycle (§III-D)

    def _cap(self) -> float:
        # BDP-based inflight bound (paper §III-D); 2x headroom mirrors BBR's
        # cwnd_gain so LTP holds its share next to BBR (paper Fig 15)
        bdp = self.est.bdp_pkts(self.payload)
        return max(10.0, 2.0 * bdp)

    def _gain(self) -> float:
        if self.startup:
            return 2.885
        if math.isfinite(self.est.rtprop) and \
                self.sim.now - getattr(self, "_phase_start", 0.0) > self.est.rtprop:
            self._phase = (getattr(self, "_phase", 0) + 1) % len(self.GAINS)
            self._phase_start = self.sim.now
        return self.GAINS[getattr(self, "_phase", 0)]

    # replint: hotpath
    def _next_packet(self) -> Optional[Packet]:
        seq = self._next_seq()
        if seq is None:
            return None
        order = self.order_ctr
        self.order_ctr += 1
        self.send_order[seq] = order
        self.outstanding.append((order, seq))
        self.total_sent += 1
        return Packet(self.flow, seq, self.payload, kind="data",
                      critical=bool(self.critical[seq]),
                      meta={"t": self.sim.now, "order": order,
                            GEN_KEY: self.gen})

    def _pump(self):
        if self.done or self.stopped:
            return
        coalesce = self.train_len > 1 and self.deliver_train is not None
        while len(self.outstanding) < self._cap():
            if self.sim.now < self.next_send_time:
                if self.pacing_timer is None:
                    def fire():
                        self.pacing_timer = None
                        self._pump()
                    self.pacing_timer = self.sim.at(self.next_send_time, fire)
                return
            if coalesce:
                # per-packet admission is `while len(outstanding) < cap`, so a
                # fractional BDP cap still admits up to ceil(cap) — flooring
                # here would stall one packet short of the reference path
                room = math.ceil(self._cap()) - len(self.outstanding)
                batch = []
                while len(batch) < min(self.train_len, room):
                    pkt = self._next_packet()
                    if pkt is None:
                        break
                    batch.append(pkt)
                if not batch:
                    return
                self.pipe.send_train(batch, self.deliver_train)
                n_sent = len(batch)
            else:
                pkt = self._next_packet()
                if pkt is None:
                    return
                self.pipe.send(pkt, self.deliver)
                n_sent = 1
            # approximate pacing (paper §III-D): rate-limit bursts above 20
            # packets at the BBR-computed pacing rate (a whole train pays
            # its K packets' worth of pacing budget at once)
            rate = self.est.btlbw * self._gain()
            if rate > 0 and len(self.outstanding) > 20:
                self.next_send_time = self.sim.now + \
                    n_sent * self.payload * 8.0 / rate

    def on_ack(self, pkt: Packet):
        if self.done:
            return
        if pkt.kind == "stop":
            if is_stale(pkt.meta, self.gen):
                self.n_gen_fenced += 1
                return      # stop aimed at a previous life of this flow
            self.stopped = True
            self.done = True
            if self.watchdog is not None:
                self.sim.cancel(self.watchdog)
            if self.on_done:
                self.on_done(self)
            return
        seq = pkt.seq
        if seq == -1:           # registration ack
            if is_stale(pkt.meta, self.gen):
                self.n_gen_fenced += 1
                return
            self.reg_acked = True
            self.n_consec_rto = 0   # the path answered: not a blackhole
            self.rto_backoff = 1.0
            if len(self.acked) >= self.n:
                self._finish()  # data completed while the reg was in flight
            return
        echo = pkt.meta.get("echo") or {}
        if echo_stale(echo, self.gen):
            self.n_gen_fenced += 1
            return          # ACK for a previous life of this pooled flow
        if "t" in echo:
            self.est.on_ack(self.payload, self.sim.now - echo["t"])
        self._startup_check()
        self.acked.add(seq)
        order = pkt.meta.get("order", self.send_order.get(seq, -1))
        self.highest_acked_order = max(self.highest_acked_order, order)
        self.n_consec_rto = 0   # ACK progress: the path is alive
        self.rto_backoff = 1.0
        self._arm_watchdog()
        self._scan_outstanding()
        # the flow is only complete once the registration is acked too:
        # the reg carries the critical metadata (n, critical set) the
        # receiver's close rule depends on, so a sender that goes silent
        # with the reg lost in flight would deadlock the gather
        if self.reg_acked and len(self.acked) >= self.n:
            self._finish()
            return
        self._pump()

    def _startup_check(self):
        """BBR-style startup exit: btlbw plateau over ~3 rtprop rounds."""
        if not self.startup:
            return
        if math.isfinite(self.est.rtprop) and \
                self.sim.now - getattr(self, "_last_check", -1.0) <= self.est.rtprop:
            return
        self._last_check = self.sim.now
        bw = self.est.btlbw
        if bw > self.full_bw * 1.25:
            self.full_bw = bw
            self.full_cnt = 0
        else:
            self.full_cnt += 1
            if self.full_cnt >= 3:
                self.startup = False

    def _finish(self):
        self.done = True
        if self.watchdog is not None:
            self.sim.cancel(self.watchdog)
        if self.on_done:
            self.on_done(self)

    def _scan_outstanding(self):
        """3-OOO-ACK loss detection over the outgoing order queue."""
        while self.outstanding:
            o, s = self.outstanding[0]
            if s in self.acked:
                self.outstanding.popleft()
            elif self.highest_acked_order - o >= self.OOO_THRESH:
                self.outstanding.popleft()
                self._requeue_lost(s)
            else:
                break

    def on_ack_train(self, items: TrainItems):
        """Consume a batched ACK train: per-ack bookkeeping is a tight
        loop; the rate estimator takes ONE aggregated sample for the train
        (stretch-ack semantics: total acked bytes, min RTT), and the OOO
        scan / watchdog / pump each run once."""
        if self.done:
            return
        self.n_ack_trains += 1
        rtts = []
        for pkt, _t in items:
            if pkt.kind == "stop":
                self.on_ack(pkt)        # terminal: fires on_done
                if self.done:
                    return
                continue                # stale stop: keep consuming
            if pkt.seq == -1:
                if is_stale(pkt.meta, self.gen):
                    self.n_gen_fenced += 1
                    continue
                self.reg_acked = True
                continue
            echo = pkt.meta.get("echo") or {}
            if echo_stale(echo, self.gen):
                self.n_gen_fenced += 1
                continue    # ACK for a previous life of this pooled flow
            if "t" in echo:
                rtts.append(self.sim.now - echo["t"])
            self.acked.add(pkt.seq)
            order = pkt.meta.get("order", self.send_order.get(pkt.seq, -1))
            if order > self.highest_acked_order:
                self.highest_acked_order = order
        if rtts:
            self.est.on_ack(self.payload * len(rtts), min(rtts))
        self._startup_check()
        self.n_consec_rto = 0   # ACK progress: the path is alive
        self.rto_backoff = 1.0
        self._arm_watchdog()
        self._scan_outstanding()
        if self.reg_acked and len(self.acked) >= self.n:
            self._finish()
            return
        self._pump()

    def stats(self) -> Dict[str, int]:
        """Cumulative per-flow counters across pooled lives
        (DESIGN.md §12)."""
        return {"n_retx": self.n_retx,
                "n_ack_trains": self.n_ack_trains,
                "n_gen_fenced": self.n_gen_fenced,
                "n_flow_dead": self.n_flow_dead}
