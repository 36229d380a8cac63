"""Transport legs for the cluster runtime (DESIGN.md §8): the port's
numpy-only copy of the JAX package's ``runtime/transport.py``.

Two backends carry a worker's gradient from grad-ready to the PS on the
runtime's shared ``Sim`` clock:

``AnalyticPerWorkerNet``
    Fast closed-form per-flow timing for the async/SSP paths: each
    worker's gather leg is an independent transfer whose serialization
    shares the trunk with the flows active *at its start* (a bounded
    approximation of true interleaving), inflated by the protocol's
    loss model and an incast tail draw — the same ingredients as
    ``AnalyticIncastModel``, applied per flow instead of per barrier.
    LTP flows run the per-flow Early Close rule (LT threshold, pct
    target, deadline); reliable protocols wait for their last byte.

``DESTransport``
    The packet-level co-simulation: real LTP/TCP senders and receivers
    over a shared ``Topology`` (one trunk per PS shard, optional
    heterogeneous access links and cross traffic via ``GatherSpec``),
    with flows starting the instant the worker's compute finishes. Per
    iteration, bsp runs one ``ShardedGatherReceiver`` barrier gather;
    async/SSP run one single-flow ``PSGatherReceiver`` per (worker,
    shard) so every flow closes independently.

    Flow graphs are POOLED (DESIGN.md §9): senders, receivers, and the
    per-flow ack back-channel pipes are built once and recycled across
    iterations through the ``reset(gen)`` protocol — the per-round flow
    generation fences stale in-flight traffic out of the next round —
    and packet trains (``coalesce``) are on by default.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.config import LTPConfig, NetConfig
from repro_torch.core.early_close import AnalyticIncastModel
from repro_torch.net import senders as snd
from repro_torch.net.genfence import GEN_KEY
from repro_torch.net.ltp_receiver import PSGatherReceiver, ShardedGatherReceiver
from repro_torch.net.scenarios import (
    GatherSpec,
    _build_topology,
    _fwd_path,
    _npkts,
)
from repro_torch.net.simcore import Packet, Pipe, Sim
from repro_torch.net.topology import resolve_topology


class AnalyticPerWorkerNet:
    """Closed-form per-flow transport (the async/SSP fast path).

    ``send(worker, cb)`` schedules ``cb(frac, early_closed)`` at the
    flow's close time. The model: first byte lands after rtprop/2 + eps;
    100% would land after ``bytes * active / (bw/8) * loss_inflation *
    (1 + tail)``; LTP closes per the paper's double-threshold rule
    evaluated against that linear arrival ramp.
    """

    def __init__(self, sim: Sim, net: NetConfig, ltp: LTPConfig,
                 protocol: str, n_workers: int, model_bytes: float,
                 seed: int = 0, tail_prob: float = 0.15,
                 tail_scale: float = 1.5):
        self.sim = sim
        self.net = net
        self.ltp = ltp
        self.protocol = protocol
        self.w = n_workers
        self.bytes = float(model_bytes)
        self.rng = np.random.default_rng(seed + 77)
        self.tail_prob = tail_prob
        self.tail_scale = tail_scale
        # reuse the calibrated per-protocol loss-inflation law
        self._infl = AnalyticIncastModel(
            net, n_workers, protocol=protocol, seed=seed).loss_inflation()
        self.active = 0
        rt = net.rtprop_ms * 1e-3
        share = net.bandwidth_gbps * 1e9 / 8.0 / n_workers
        self.lt = ltp.lt_init_rtprop_mult * rt + self.bytes / share
        self.deadline = self.lt + ltp.deadline_c_ms * 1e-3

    def send(self, worker: int,
             cb: Callable[[float, bool], None]) -> None:
        rt = self.net.rtprop_ms * 1e-3
        bw = self.net.bandwidth_gbps * 1e9 / 8.0
        self.active += 1
        tail = (self.rng.exponential(self.tail_scale)
                if self.rng.random() < self.tail_prob else 0.0)
        t0 = rt
        t_full = rt + self.bytes * self.active / bw * self._infl * (1.0 + tail)
        if self.protocol != "ltp" or t_full <= self.lt:
            t_close, frac, early = t_full, 1.0, False
        else:
            # earliest t >= LT with pct >= threshold; deadline wins
            t_thr = t0 + self.ltp.data_pct_threshold * (t_full - t0)
            t_close = min(max(self.lt, t_thr), self.deadline)
            frac = float(np.clip((t_close - t0) / max(t_full - t0, 1e-12),
                                 0.0, 1.0))
            if t_close >= t_full:
                t_close, frac, early = t_full, 1.0, False
            else:
                early = True

        def done():
            self.active -= 1
            cb(frac, early)

        # ``cb`` is the runtime's on_delivered/on_close, which pops its
        # flight-registry entry itself; the analytic net has no pooled
        # flow lives of its own to fence.
        self.sim.after(t_close, done)  # replint-torch: ok(gen-fence)


def _send_stop_pkt(tr: "DESTransport", back: Pipe, s) -> None:
    """Early-Close "stop" on the ack back-channel. Under coalescing the
    stop rides the same train machinery as data ACKs (one-packet train),
    matching ``_DESFlowSet``'s ack path; per-packet otherwise. The stop
    carries the sender's current flow generation so a stop for a
    finished iteration cannot kill the pooled sender's next life."""
    stop = Packet(s.flow, -2, 41, kind="stop", meta={GEN_KEY: s.gen})
    if tr.coalesce > 1:
        back.send_train([stop], s.on_ack_train)
    else:
        back.send(stop, s.on_ack)


class _DESFlowSet:
    """Per-worker flow bundle on the shared topology: one single-flow
    gather receiver per PS shard; fires ``cb`` once all shards have
    closed.

    Pooled (DESIGN.md §9): the runtime creates ONE flow set per worker
    and recycles it every iteration through ``begin`` — the back-channel
    pipes, senders, receivers, and their wiring closures are built once;
    each iteration only resets their state (a new flow generation drops
    stragglers from the previous round).
    """

    def __init__(self, tr: "DESTransport", worker: int):
        self.tr = tr
        self.worker = worker
        self.gen = 0
        self.idle = True    # free for reuse (its last round fully closed)
        self.cb: Optional[Callable[[np.ndarray, float, bool], None]] = None
        self.masks: List[Optional[np.ndarray]] = [None] * tr.n_ps
        self.closed = 0
        self.early = False
        self.backs: List[Pipe] = []
        self.senders: List = []
        self.recvs: List = []
        self._ones = np.ones(tr.n, bool)
        for p in range(tr.n_ps):
            self._build_flow(p)

    def _build_flow(self, p: int) -> None:
        tr, w = self.tr, self.worker
        path = _fwd_path(tr.topo, tr.spec, tr.owner[p], w, tr.protocol)
        back = Pipe(tr.sim, tr.bw, tr.half_rtt, tr.net.loss_rate, 10_000,
                    tr.rng)
        if tr.protocol == "ltp":
            def send_stop(flow, p=p, back=back):
                _send_stop_pkt(tr, back, self.senders[p])

            def on_close(recv, p=p):
                full = recv.all_full
                self._shard_done(p, recv.delivery_masks()[0], not full)

            recv = PSGatherReceiver(
                tr.sim, [w], tr.lt_per_worker[w], tr.deadline_per_worker[w],
                tr.pct_eff[p], send_stop, on_close=on_close)
            # orphan recovery: data from an older generation means that
            # life of the sender never got its stop (lost in flight) —
            # re-stop it, but only while it still lives that generation
            # (a reset sender must not be killed by its past round)
            recv.on_stale = (lambda flow, g, p=p, back=back:
                             self._stop_stale(p, g, back))
            s = snd.LTPSender(tr.sim, path,
                              recv.on_data, tr.n, critical=tr.crit, flow=w,
                              rng=tr.rng, train_len=tr.coalesce)
            if tr.heal:
                s.heal = True
                s.on_flow_dead = tr._flow_dead
            recv.attach_ack(w, lambda pkt, s=s, back=back:
                            back.send(pkt, s.on_ack))
            if tr.coalesce > 1:
                s.deliver_train = recv.on_data_train
                recv.attach_ack_train(
                    w, lambda acks, s=s, back=back:
                    back.send_train(acks, s.on_ack_train))
        else:
            def on_done(s, p=p):
                self._shard_done(p, self._ones, False)

            s = snd.make_sender(tr.protocol, tr.sim, path, None,
                                tr.n, flow=w, rng=tr.rng, on_done=on_done,
                                train_len=tr.coalesce)
            recv = snd.TcpReceiver(tr.sim, lambda pkt, s=s, back=back:
                                   back.send(pkt, s.on_ack), w)
            s.deliver = recv.on_data
            if tr.coalesce > 1:
                s.deliver_train = recv.on_data_train
                recv.send_ack_train = (lambda acks, s=s, back=back:
                                       back.send_train(acks, s.on_ack_train))
            recv.n_total = tr.n
        self.backs.append(back)
        self.senders.append(s)
        self.recvs.append(recv)

    def _stop_stale(self, p: int, g, back: Pipe) -> None:
        s = self.senders[p]
        if g is not None and s.gen == g and not s.done:
            _send_stop_pkt(self.tr, back, s)

    def begin(self, cb: Callable[[np.ndarray, float, bool], None]) -> None:
        """Start (or restart) this worker's shard flows for one round."""
        self.gen += 1
        self.idle = False
        self.cb = cb
        self.masks = [None] * self.tr.n_ps
        self.closed = 0
        self.early = False
        for p in range(self.tr.n_ps):
            self.backs[p].recycle()
            if self.tr.protocol == "ltp":
                self.recvs[p].reset(gen=self.gen)
            else:
                self.recvs[p].reset(gen=self.gen, n_total=self.tr.n)
            self.senders[p].reset(gen=self.gen)
            self.senders[p].start()

    def teardown(self) -> None:
        """Hard-stop this bundle mid-round (node/PS death, DESIGN.md
        §10): the flow generation bumps so every packet still in flight
        is fenced out as stale, the pooled senders go silent, receivers
        deactivate, and the set returns to the free list. The runtime
        accounts the dropped gradient; no callback fires."""
        self.gen += 1
        self.cb = None
        for p in range(self.tr.n_ps):
            self.senders[p].kill()
            self.senders[p].gen = self.gen
            if self.tr.protocol == "ltp":
                self.recvs[p].deactivate(gen=self.gen)
            else:
                self.recvs[p].reset(gen=self.gen)
            self.backs[p].recycle()
        self.masks = [None] * self.tr.n_ps
        self.closed = 0
        self.early = False
        self.idle = True

    def _shard_done(self, p: int, mask: np.ndarray, early: bool) -> None:
        if self.cb is None or self.masks[p] is not None:
            return
        self.masks[p] = mask
        self.early = self.early or early
        self.closed += 1
        if self.closed >= self.tr.n_ps:
            stacked = np.stack(self.masks)          # (n_ps, n)
            frac = float(stacked.mean())
            self.idle = True    # every shard closed: free for reuse
            self.cb(stacked, frac, self.early)


class _DESBarrierGather:
    """Per-iteration bsp gather on the shared topology: one
    ``ShardedGatherReceiver`` over all W workers; senders join as their
    compute finishes (the runtime's start_delays, made event-driven).

    Pooled (DESIGN.md §9): built once per transport; each iteration
    calls ``begin`` to reset the sharded receiver and bump the flow
    generation, and ``add_worker`` resets+restarts that worker's pooled
    senders instead of constructing new ones.
    """

    def __init__(self, tr: "DESTransport"):
        self.tr = tr
        self.gen = 0
        self.cb: Optional[Callable[[ShardedGatherReceiver], None]] = None
        self.t0 = tr.sim.now
        self._senders: Dict = {}
        self._backs: Dict = {}

        def send_stop(p, f):
            s = self._senders.get((p, f))
            if s is not None:
                _send_stop_pkt(tr, self._backs[(p, f)], s)

        self.sharded = ShardedGatherReceiver(
            tr.sim, tr.n_ps, list(range(tr.w)),
            [tr.lt_shard] * tr.n_ps, [tr.deadline_shard] * tr.n_ps,
            tr.ltp.data_pct_threshold, send_stop)
        self._n_closed = 0
        for p, shard in enumerate(self.sharded.shards):
            # per-shard effective Early-Close threshold (the budget
            # controller's knob, DESIGN.md §14) — identical to the
            # config value until a controller moves it
            shard.pct_threshold = tr.pct_eff[p]
            shard.on_close = self._shard_closed
            # orphan recovery: a sender whose stop was lost and whose
            # shard closed before its next add_worker reset would pump
            # retransmissions forever — re-stop it while it still lives
            # the stale generation (see _DESFlowSet._stop_stale)
            shard.on_stale = (lambda flow, g, p=p:
                              self._stop_stale(p, flow, g))

    def begin(self, cb: Callable[[ShardedGatherReceiver], None],
              members=None) -> None:
        """Arm the barrier for a fresh iteration. ``members`` (optional)
        is the active worker set: flows outside it are abandoned up
        front so the close rule only waits on live nodes."""
        self.gen += 1
        self.cb = cb
        self.t0 = self.tr.sim.now
        self._n_closed = 0
        self.sharded.reset(gen=self.gen)
        if members is not None and len(members) < self.tr.w:
            for w in range(self.tr.w):
                if w not in members:
                    self.sharded.abandon_worker(w)

    def abandon_worker(self, worker: int) -> None:
        """Mid-round node death: kill the worker's pooled senders, fence
        their generation, and drop the flows from every shard's close
        rule (which may complete the barrier)."""
        self.tr._mark_live(worker, False)
        for p in range(self.tr.n_ps):
            s = self._senders.get((p, worker))
            if s is not None:
                s.kill()
                s.gen = self.gen + 1   # fence: future stops can't match
                self._backs[(p, worker)].recycle()
        self.sharded.abandon_worker(worker)

    def abort(self) -> None:
        """PS death mid-round: silence everything; no callback fires.
        The next ``begin`` revives the pooled graph."""
        self.cb = None
        for s in self._senders.values():
            s.kill()
        self.sharded.deactivate(gen=self.gen + 1)
        self.gen += 1
        for back in self._backs.values():
            back.recycle()

    def _stop_stale(self, p: int, flow: int, g) -> None:
        s = self._senders.get((p, flow))
        if s is not None and g is not None and s.gen == g and not s.done:
            _send_stop_pkt(self.tr, self._backs[(p, flow)], s)

    def _shard_closed(self, shard: PSGatherReceiver) -> None:
        if self.cb is None:
            return
        self.tr.on_early_close(shard.ps_id, self.tr.sim.now,
                               float(shard.agg_pct), shard.all_full,
                               lat=shard.bst_gather())
        self._n_closed += 1
        if self._n_closed >= self.tr.n_ps:
            self.cb(self.sharded)

    def add_worker(self, worker: int) -> None:
        """Start worker's shard flows now (its compute just finished)."""
        tr = self.tr
        if tr.topo.aggs:
            tr._mark_live(worker, True)
        for p in range(tr.n_ps):
            shard = self.sharded.shard(p)
            if shard.closed:
                continue   # shard already gave up on this straggler
            key = (p, worker)
            s = self._senders.get(key)
            if s is None:
                back = Pipe(tr.sim, tr.bw, tr.half_rtt, tr.net.loss_rate,
                            10_000, tr.rng)
                s = snd.LTPSender(
                    tr.sim, _fwd_path(tr.topo, tr.spec, tr.owner[p], worker,
                                      tr.protocol),
                    shard.on_data, tr.n, critical=tr.crit,
                    flow=worker, rng=tr.rng, train_len=tr.coalesce)
                if tr.heal:
                    s.heal = True
                    s.on_flow_dead = tr._flow_dead
                if tr.coalesce > 1:
                    s.deliver_train = shard.on_data_train
                self._backs[key] = back
                self._senders[key] = s
                s.gen = self.gen    # align with this round's receivers
            else:
                back = self._backs[key]
                back.recycle()
                s.reset(gen=self.gen)
            shard.attach_ack(worker, lambda pkt, s=s, back=back:
                             back.send(pkt, s.on_ack))
            if tr.coalesce > 1:
                shard.attach_ack_train(
                    worker, lambda acks, s=s, back=back:
                    back.send_train(acks, s.on_ack_train))
            s.start()


#: default train length for the runtime's packet-level co-simulation:
#: the netsim grid's measured sweet spot (BENCH_netsim.json). Pass
#: ``coalesce=1`` for the per-packet reference path.
DEFAULT_COALESCE = 32


class DESTransport:
    """Packet-level transport on the runtime's shared clock. bsp uses
    ``start_gather``/``add_worker`` (one barrier gather per iteration);
    async/SSP use ``send`` (independent per-worker flow sets). LTP flows
    in this transport carry static LT thresholds from the paper's init
    formula (per-link attainable share); the epoch-adaptive LT update of
    ``scenarios._iterate_gather`` is out of scope here.

    ``coalesce`` defaults to ``DEFAULT_COALESCE`` packet trains
    (DESIGN.md §7/§9) — the per-packet path is opt-in via
    ``coalesce=1``, not the default the runtime silently pays for."""

    def __init__(self, sim: Sim, net: NetConfig, ltp: LTPConfig,
                 protocol: str, n_workers: int, model_bytes: float,
                 n_ps: Optional[int] = None, spec: Optional[GatherSpec] = None,
                 seed: int = 0, coalesce: Optional[int] = None,
                 on_early_close: Optional[Callable] = None,
                 topology: Optional[GatherSpec] = None):
        self.sim = sim
        self.net = net
        self.ltp = ltp
        self.protocol = protocol
        self.w = n_workers
        self.spec = resolve_topology(topology, n_ps=n_ps, spec=spec,
                                     owner="DESTransport")
        self.spec.validate_workers(n_workers, "DESTransport")
        self.n_ps = self.spec.n_ps
        self.rng = np.random.default_rng(seed + 101)
        self.bw = net.bandwidth_gbps * 1e9
        self.half_rtt = net.rtprop_ms * 1e-3
        shard_bytes = model_bytes / self.n_ps
        self.n = _npkts(shard_bytes, protocol)
        if coalesce is None:
            # auto: coalesced by default, but never trains so long that
            # the Early Close rule loses granularity on short flows
            # (~8 close checks per shard flow minimum)
            self.coalesce = min(DEFAULT_COALESCE, max(1, self.n // 8))
        else:
            self.coalesce = max(1, int(coalesce))
        self.topo, self.sources = _build_topology(
            sim, net, n_workers, self.spec, self.rng, self.coalesce)
        # shard -> owning-PS route map (identity until a PS failover
        # rebalance re-homes a dead PS's shards, DESIGN.md §10)
        self.owner: List[int] = list(range(self.n_ps))
        crit = np.zeros(self.n, bool)
        ncrit = max(2, int(0.01 * self.n))
        crit[: ncrit // 2] = True
        crit[-(ncrit - ncrit // 2):] = True
        self.crit = crit
        rt = net.rtprop_ms * 1e-3
        c = ltp.deadline_c_ms * 1e-3
        self.lt_per_worker = np.empty(n_workers)
        for f in range(n_workers):
            share = self.spec.worker_share_bps(f, n_workers, net) / 8.0
            self.lt_per_worker[f] = (ltp.lt_init_rtprop_mult * rt
                                     + shard_bytes / share)
        self.deadline_per_worker = self.lt_per_worker + c
        self.lt_shard = float(self.lt_per_worker.max())
        self.deadline_shard = self.lt_shard + c
        self._on_early_close = on_early_close
        # self-healing (DESIGN.md §14): armed by the runtime only while
        # a network fault plane is active; the default keeps every
        # pooled sender on the exact pre-fault-plane timing
        self.heal = False
        self._on_flow_dead: Optional[Callable[[int], None]] = None
        # per-shard effective Early-Close pct threshold — the budget
        # controller's actuation knob (DESIGN.md §14); equals the config
        # value until a controller moves it
        self.pct_eff: List[float] = [ltp.data_pct_threshold] * self.n_ps
        # flow pools (DESIGN.md §9): per-worker flow-set free lists
        # (async/SSP; a worker's next flow can start while the previous
        # one is still draining, so reuse requires ``idle``), one barrier
        # gather (bsp), recycled across iterations
        self._flowsets: Dict[int, List[_DESFlowSet]] = {}
        self._barrier: Optional[_DESBarrierGather] = None
        # trunk handles cached once: telemetry sampling must not rebuild
        # a name->depth dict per sample
        self._trunks = [self.topo.pipes[f"ps{p}/trunk"]
                        for p in range(self.n_ps)]

    def stop(self) -> None:
        for src in self.sources:
            src.stop()

    # -- self-healing + budget control (DESIGN.md §14) ----------------------
    def enable_healing(self, on_flow_dead: Callable[[int], None]) -> None:
        """Arm RTO backoff + blackhole detection on every pooled LTP
        sender (existing and future). ``on_flow_dead(worker)`` fires
        when a sender declares its path dead after ``BLACKHOLE_RTOS``
        silent RTOs — the runtime tears the worker's flows exactly like
        the node-death ``flow_torn`` path."""
        self.heal = True
        self._on_flow_dead = on_flow_dead
        for s in self._all_senders():
            if isinstance(s, snd.LTPSender):
                s.heal = True
                s.on_flow_dead = self._flow_dead

    def _flow_dead(self, worker: int) -> None:
        if self._on_flow_dead is not None:
            self._on_flow_dead(worker)

    def set_pct_threshold(self, shard: int, pct: float) -> None:
        """Move shard's effective Early-Close pct threshold (the budget
        controller's actuation, DESIGN.md §14). Applies to the pooled
        receivers in place — ``pct_threshold`` survives their pooled
        resets — and to flow graphs built later."""
        self.pct_eff[shard] = float(pct)
        for pool in self._flowsets.values():
            for fs in pool:
                r = fs.recvs[shard]
                if hasattr(r, "pct_threshold"):
                    r.pct_threshold = float(pct)
        if self._barrier is not None:
            self._barrier.sharded.shard(shard).pct_threshold = float(pct)

    def _all_senders(self) -> List:
        out: List = []
        for pool in self._flowsets.values():
            for fs in pool:
                out.extend(fs.senders)
        if self._barrier is not None:
            out.extend(self._barrier._senders.values())
        return out

    def _mark_live(self, worker: int, alive: bool) -> None:
        """Keep the ToR aggregation points' live-membership in sync with
        node churn (DESIGN.md §10/§11): a dead rack member must not gate
        membership flushes (the switch would fall back to hold-timer
        flushes for every seq); a rejoined one must again."""
        for sw in self.topo.aggs.values():
            sw.set_live(worker, alive)

    # -- fault teardown (DESIGN.md §10) -------------------------------------
    def teardown_worker(self, worker: int) -> None:
        """Node death: fence + silence the worker's in-flight flow sets.
        (bsp barrier flows are torn through the gather's
        ``abandon_worker`` — the runtime owns that round state.)"""
        self._mark_live(worker, False)
        for fs in self._flowsets.get(worker, []):
            if not fs.idle:
                fs.teardown()

    def teardown_all(self) -> None:
        """PS death: fence + silence every in-flight flow graph."""
        for pool in self._flowsets.values():
            for fs in pool:
                if not fs.idle:
                    fs.teardown()
        if self._barrier is not None:
            self._barrier.abort()

    def set_shard_owners(self, owner: List[int]) -> None:
        """Re-home shard routes after a PS failover rebalance. The
        pooled flow graphs were built against the old routes, so the
        pools are dropped and rebuilt lazily on the next send — a rare,
        bounded cost (faults, not steady state)."""
        if list(owner) == self.owner:
            return
        self.owner = list(owner)
        self._flowsets = {}
        self._barrier = None

    def on_early_close(self, shard: int, t: float, delivered: float,
                       full: bool, lat: float = 0.0) -> None:
        """``lat`` is the gather's close latency (close - t0): the budget
        controller's primary distress signal — a degraded fabric shows up
        as late closes long before the delivered fraction moves."""
        if self._on_early_close is not None and not full:
            self._on_early_close(shard, t, delivered, lat)

    # -- async/SSP: independent per-worker flow sets ------------------------
    def send(self, worker: int,
             cb: Callable[[np.ndarray, float, bool], None]) -> None:
        if self.topo.aggs:
            self._mark_live(worker, True)
        pool = self._flowsets.setdefault(worker, [])
        fs = next((f for f in pool if f.idle), None)
        if fs is None:
            fs = _DESFlowSet(self, worker)
            pool.append(fs)
        fs.begin(cb)

    # -- bsp: one barrier gather per iteration ------------------------------
    def start_gather(self, cb: Callable[[ShardedGatherReceiver], None],
                     members=None) -> _DESBarrierGather:
        if self._barrier is None:
            self._barrier = _DESBarrierGather(self)
        self._barrier.begin(cb, members=members)
        return self._barrier

    def queue_depth_pkts(self) -> float:
        """Max trunk queue depth right now (telemetry sampler hook);
        O(n_ps) over cached pipe handles — no dict rebuild per sample."""
        return max((p.queue_len() for p in self._trunks), default=0.0)

    def trunk_depths(self) -> Tuple[float, ...]:
        """Per-trunk queue depths right now (observability sampler hook,
        DESIGN.md §12); O(n_ps) on the ``Sim.every`` grid only."""
        return tuple(p.queue_len() for p in self._trunks)

    def flow_stats(self) -> Dict[str, float]:
        """Cumulative per-flow protocol counters summed over every
        pooled sender/receiver plus the in-network aggregation points
        (DESIGN.md §12): retransmits, ACK trains consumed, sender-side
        generation-fenced ACKs, receiver-side fenced data packets,
        post-close stop re-sends, and ``agg/*`` switch stats. Pools
        dropped by a failover rebalance (``set_shard_owners``) take
        their counts with them — a rare, bounded fault path."""
        out: Dict[str, float] = {"n_retx": 0, "n_ack_trains": 0,
                                 "n_gen_fenced": 0, "n_stale_fenced": 0,
                                 "n_stop_resends": 0}
        senders: List = []
        recvs: List = []
        for pool in self._flowsets.values():
            for fs in pool:
                senders.extend(fs.senders)
                recvs.extend(fs.recvs)
        if self._barrier is not None:
            senders.extend(self._barrier._senders.values())
            recvs.extend(self._barrier.sharded.shards)
        out["n_flow_dead"] = 0
        for s in senders:
            out["n_retx"] += getattr(s, "n_retx", 0)
            out["n_ack_trains"] += getattr(s, "n_ack_trains", 0)
            out["n_gen_fenced"] += getattr(s, "n_gen_fenced", 0)
            out["n_flow_dead"] += getattr(s, "n_flow_dead", 0)
        for r in recvs:
            out["n_stale_fenced"] += getattr(r, "n_stale_fenced", 0)
            out["n_stop_resends"] += getattr(r, "n_stop_resends", 0)
        for sw in self.topo.aggs.values():
            for k, v in sw.stats().items():
                if k != "pending":
                    out[f"agg/{k}"] = out.get(f"agg/{k}", 0) + v
        return out
