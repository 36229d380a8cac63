"""Simulation scenarios mirroring the paper's evaluation setups, plus the
multi-PS / heterogeneous-worker extensions (DESIGN.md §5).

Paper scenarios:
  p2p_transfer     point-to-point goodput under loss        (Fig 4)
  incast_gather    W-to-1 gather; FCT tail / BST            (Fig 3, 14)
  train_iterations gather+broadcast loop -> BST + delivered fractions
                   (consumed by the training coupling; Fig 12/13)
  fairness_share   two flows on one bottleneck              (Fig 15)

Topology-engine scenarios (beyond the paper's single shared bottleneck):
  multi_ps_gather  sharded gather: n_ps parameter-server shards, one pipe
                   group (trunk) per PS; every worker sends 1/n_ps of the
                   model to each shard. n_ps=1 IS incast_gather.
  straggler_gather heterogeneous per-worker access links (rate/delay/loss
                   multipliers) feeding the shared trunk — bandwidth
                   stragglers, not just host-jitter start delays.
  cross_traffic    incast under open-loop background load on the trunk(s).

All gather-style scenarios run through one engine (``_run_gather``) driven
by a ``GatherSpec``; every scenario is registered in ``SCENARIOS`` and
runnable via ``run_scenario(name, protocol, net, **kw)``.

All scenarios use scaled transfer sizes (document the scale where used) —
event counts stay ~O(1e5-1e6) so full sweeps run in seconds on CPU.
Iterations carry warm CC state across rounds (persistent connections, as
real PS frameworks keep sockets open between batches).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.config import LTPConfig, NetConfig
from repro_torch.net import senders as snd
from repro_torch.net.aggtree import AggIngress, AggSwitch
from repro_torch.net.ltp_receiver import (
    LTPFlowReceiver,
    ShardedGatherReceiver,
)
from repro_torch.net.simcore import (
    CrossTrafficSource,
    Packet,
    Pipe,
    Sim,
    Topology,
)
from repro_torch.net.topology import (       # noqa: F401  (GatherSpec re-exported)
    GatherSpec,
    as_topology,
    rack_spine,
)

PROTOCOLS = ("ltp", "bbr", "cubic", "reno")

# ----------------------------------------------------------------------------
# scenario registry
# ----------------------------------------------------------------------------

#: name -> callable(protocol, net, **kwargs). The sweep runner and the
#: training coupling both dispatch through this table.
SCENARIOS: Dict[str, Callable] = {}


def register_scenario(name: str):
    def deco(fn):
        SCENARIOS[name] = fn
        return fn
    return deco


def run_scenario(name: str, protocol: str, net: NetConfig, **kwargs):
    """Dispatch a registered scenario by name."""
    try:
        fn = SCENARIOS[name]
    except KeyError:
        raise ValueError(
            f"unknown scenario {name!r}; registered: {sorted(SCENARIOS)}"
        ) from None
    return fn(protocol, net, **kwargs)


def list_scenarios() -> Tuple[str, ...]:
    return tuple(sorted(SCENARIOS))


def _warm(sender, state: Optional[dict]):
    if not state:
        return
    if isinstance(sender, snd.LTPSender) or isinstance(sender, snd.BBRSender):
        est = sender.est
        est.rtprop = state.get("rtprop", est.rtprop)
        if state.get("btlbw", 0) > 0:
            est._bw_samples.append((sender.sim.now, state["btlbw"]))
            sender.startup = False
    else:
        # idle restart: slow-start back toward the previous operating point
        # (RFC 2861 style — cwnd resets, ssthresh remembers)
        sender.ssthresh = state.get("ssthresh", sender.ssthresh)
        sender.srtt = state.get("srtt", sender.srtt)


def _save_warm(sender) -> dict:
    if isinstance(sender, (snd.LTPSender, snd.BBRSender)):
        return {"rtprop": sender.est.rtprop, "btlbw": sender.est.btlbw}
    return {
        "ssthresh": max(sender.cwnd, sender.ssthresh)
        if math.isfinite(sender.ssthresh) else sender.cwnd,
        "srtt": sender.srtt,
    }


def _npkts(size_bytes: float, protocol: str) -> int:
    payload = snd.LTP_PAYLOAD if protocol == "ltp" else snd.MSS
    return max(1, int(math.ceil(size_bytes / payload)))


# ----------------------------------------------------------------------------
# p2p
# ----------------------------------------------------------------------------


@register_scenario("p2p_transfer")
def p2p_transfer(protocol: str, net: NetConfig, size_bytes: float,
                 seed: int = 0, warm: Optional[dict] = None) -> Dict:
    """One flow over one lossy link. Returns fct/goodput/utilization."""
    sim = Sim()
    rng = np.random.default_rng(seed)
    bw = net.bandwidth_gbps * 1e9
    fwd = Pipe(sim, bw, net.rtprop_ms * 1e-3 / 2, net.loss_rate,
               net.queue_pkts, rng)
    back = Pipe(sim, bw, net.rtprop_ms * 1e-3 / 2, net.loss_rate,
                10_000, rng)
    n = _npkts(size_bytes, protocol)
    done = {}

    def on_done(s):
        done["t"] = sim.now

    if protocol == "ltp":
        sender = snd.LTPSender(sim, fwd, None, n, rng=rng, on_done=on_done)
        recv = LTPFlowReceiver(sim, lambda p: back.send(p, sender.on_ack), 0)
        sender.deliver = lambda p: recv.on_data(p, lambda: None)
    else:
        sender = snd.make_sender(protocol, sim, fwd, None, n, rng=rng,
                                 on_done=on_done)
        recv = snd.TcpReceiver(sim, lambda p: back.send(p, sender.on_ack), 0)
        sender.deliver = recv.on_data
    _warm(sender, warm)
    sender.start()
    sim.run(until=3600.0)
    fct = done.get("t", sim.now) - 0.0
    goodput = size_bytes * 8.0 / max(fct, 1e-12)
    return {
        "fct": fct,
        "goodput_bps": goodput,
        "utilization": goodput / bw,
        "warm": _save_warm(sender),
    }


def utilization_cached(protocol: str, net: NetConfig, size_bytes: float = 4e6,
                       _cache={}) -> float:
    """Steady-state (warm-connection) p2p utilization at this transfer size."""
    key = (protocol, net.bandwidth_gbps, net.rtprop_ms, net.loss_rate,
           round(math.log2(max(size_bytes, 1e5))))
    if key not in _cache:
        warm = p2p_transfer(protocol, net, size_bytes)["warm"]
        _cache[key] = p2p_transfer(protocol, net, size_bytes, seed=1,
                                   warm=warm)["utilization"]
    return _cache[key]


# ----------------------------------------------------------------------------
# the gather engine (single-PS incast is the n_ps=1 special case)
# ----------------------------------------------------------------------------


# GatherSpec lives in repro_torch.net.topology (DESIGN.md §11) and is
# re-imported above so `from repro_torch.net.scenarios import GatherSpec`
# keeps working for existing call sites.


@dataclasses.dataclass
class GatherResult:
    bst_gather: float
    fcts: np.ndarray              # (W,) per-flow 100%-or-close time
    delivered: np.ndarray         # (W,) fraction delivered at close
    full_times: np.ndarray        # (W,) time to 100% (inf if early-closed)
    criticals_ok: bool
    per_ps_full: Optional[np.ndarray] = None   # (n_ps, W) per-shard 100% times
    packets_received: int = 0                  # payload packets at receiver(s)
    packets_expected: int = 0                  # n_ps * W * pkts-per-shard
    trunk_stats: Optional[Dict] = None         # Topology.stats() of the trunks
    # (n_ps, W, n) bool per-(shard, worker, packet) delivery state at close —
    # the exact mask shape the kernel-backed sync consumes (DESIGN.md §7).
    # All-True for reliable protocols.
    masks: Optional[np.ndarray] = None
    # summed AggSwitch.stats() over all (shard, rack) ToR aggregation
    # points (None when the topology has no in-network aggregation).
    agg_stats: Optional[Dict] = None


def _build_topology(sim: Sim, net: NetConfig, w: int, spec: GatherSpec,
                    rng: np.random.Generator, coalesce: int = 1,
                    ) -> Tuple[Topology, List[CrossTrafficSource]]:
    """PS trunks (one pipe group per shard) + optional worker access links
    + optional cross-traffic sources. Forward routes come from
    ``_fwd_path``; ack/return paths are built per flow by the caller.

    Hierarchical specs (DESIGN.md §11) add one oversubscribed uplink pipe
    per rack and — with ``inetwork_agg`` — one ``AggSwitch`` per
    (shard, rack) at the ToR, attached as ``topo.aggs``. Delay model:
    worker→spine-PS one-way = rtprop (uplink + trunk hop, half each);
    a shard homed in the worker's own rack skips the uplink hop.
    """
    bw = net.bandwidth_gbps * 1e9
    topo = Topology(sim)
    half_rtt = net.rtprop_ms * 1e-3 / 2
    for p in range(spec.n_ps):
        topo.add_pipe(f"ps{p}/trunk",
                      Pipe(sim, bw, half_rtt, net.loss_rate,
                           net.queue_pkts, rng),
                      group=f"ps{p}")
    if spec.heterogeneous:
        for f in range(w):
            rate, delay, loss = spec.access_params(f, net)
            topo.add_pipe(f"w{f}/up",
                          Pipe(sim, rate, delay, loss, net.queue_pkts, rng),
                          group="access")
    topo.aggs = {}
    if spec.hierarchical:
        spec.validate_workers(w, "gather")
        for r in range(spec.racks):
            topo.add_pipe(f"rack{r}/up",
                          Pipe(sim, spec.uplink_bps(net), half_rtt,
                               net.loss_rate, net.queue_pkts, rng),
                          group="uplink")
        if spec.inetwork_agg:
            hold_s = (spec.agg_hold_ms or 0.25 * net.rtprop_ms) * 1e-3
            for p in range(spec.n_ps):
                for r in range(spec.racks):
                    if spec.ps_rack(p) == r:
                        upstream = topo.route(f"ps{p}/trunk")
                    else:
                        upstream = topo.route(f"rack{r}/up", f"ps{p}/trunk")
                    topo.aggs[(p, r)] = AggSwitch(
                        sim, upstream, spec.rack_members(r), hold_s)
    sources: List[CrossTrafficSource] = []
    if spec.cross_traffic_load > 0:
        for p in range(spec.n_ps):
            src = CrossTrafficSource(
                sim, topo.pipes[f"ps{p}/trunk"], spec.cross_traffic_load,
                rng=rng, on_mean=spec.cross_on_ms * 1e-3,
                off_mean=spec.cross_off_ms * 1e-3, train_len=coalesce)
            sources.append(src)
            src.start()
    return topo, sources


def _fwd_path(topo: Topology, spec: GatherSpec, p: int, f: int,
              protocol: str = "ltp"):
    """Worker f's forward path to PS shard p.

    On rack fabrics with in-network aggregation, LTP flows enter through
    an ``AggIngress`` at their ToR (order-preserving protocols never
    aggregate — the switch cannot merge in-order byte streams, so they
    route over the raw uplink instead)."""
    if spec.hierarchical:
        r = spec.rack_of(f)
        access = topo.pipes[f"w{f}/up"] if spec.heterogeneous else None
        if spec.inetwork_agg and protocol == "ltp":
            return AggIngress(topo.aggs[(p, r)], f, access=access)
        names = [f"w{f}/up"] if spec.heterogeneous else []
        if spec.ps_rack(p) != r:
            names.append(f"rack{r}/up")
        names.append(f"ps{p}/trunk")
        return topo.route(*names)
    if spec.heterogeneous:
        return topo.route(f"w{f}/up", f"ps{p}/trunk")
    return topo.pipes[f"ps{p}/trunk"]


def _agg_stats(topo: Topology) -> Optional[Dict]:
    aggs = getattr(topo, "aggs", None)
    if not aggs:
        return None
    total: Dict[str, float] = {}
    for sw in aggs.values():
        for k, v in sw.stats().items():
            total[k] = total.get(k, 0) + v
    total["n_switches"] = len(aggs)
    return total


def _run_gather(protocol: str, net: NetConfig, w: int, size_bytes: float,
                rng: np.random.Generator,
                warm: Optional[List[List[Optional[dict]]]],
                lt: np.ndarray, deadline: np.ndarray, pct_thresh: float,
                critical_frac: float = 0.01,
                start_delays: Optional[np.ndarray] = None,
                spec: Optional[GatherSpec] = None,
                coalesce: int = 1,
                ) -> Tuple[GatherResult, List[List[dict]]]:
    """One gather round over the topology in ``spec``.

    Returns (result, warm_states[n_ps][w]). ``size_bytes`` is the FULL
    model size; each of the n_ps shards carries size_bytes/n_ps.
    ``lt``/``deadline`` are per-shard (n_ps,) thresholds.

    ``start_delays``: per-worker start offsets modelling host-side
    stragglers (GC pauses, CPU contention, slow gradient production) —
    the source of the paper's Fig-3 "starved flows" beyond pure protocol
    dynamics. A worker's delay applies to all of its shard flows.

    ``coalesce`` > 1 turns on the packet-train engine (DESIGN.md §7):
    senders emit trains of up to ``coalesce`` packets per heap event, the
    receivers acknowledge per train, and cross-traffic bursts inject in
    chunks — ~coalesce x fewer events for the same simulated traffic.
    ``coalesce=1`` is the per-packet reference path. BBR ignores it (its
    pacing clock is inherently per-packet).
    """
    spec = as_topology(spec or GatherSpec())
    n_ps = spec.n_ps
    coalesce = max(1, int(coalesce))
    sim = Sim()
    bw = net.bandwidth_gbps * 1e9
    topo, sources = _build_topology(sim, net, w, spec, rng, coalesce)
    n = _npkts(size_bytes / n_ps, protocol)   # packets per shard flow
    senders: Dict[Tuple[int, int], object] = {}
    half_rtt = net.rtprop_ms * 1e-3 / 2

    def stop_sources():
        for src in sources:
            src.stop()

    # safeguard: background load dies out well past the slowest deadline so
    # a pathological round cannot spin the event loop for simulated hours
    if sources:
        d_max = (float(np.max(start_delays)) if start_delays is not None
                 else 0.0)
        sim.at(d_max + 10.0 * float(np.max(deadline)) + 1e-3, stop_sources)

    if protocol == "ltp":
        crit = np.zeros(n, bool)
        ncrit = max(2, int(critical_frac * n))
        crit[: ncrit // 2] = True
        crit[-(ncrit - ncrit // 2):] = True
        stops: Dict[Tuple[int, int], Callable[[], None]] = {}

        def send_stop(p, f):
            stops[(p, f)]()

        sharded = ShardedGatherReceiver(
            sim, n_ps, list(range(w)), [float(x) for x in lt],
            [float(x) for x in deadline], pct_thresh, send_stop)
        n_done = [0]

        def flow_stopped():
            n_done[0] += 1
            if n_done[0] >= n_ps * w:
                stop_sources()

        for p in range(n_ps):
            shard = sharded.shard(p)
            for f in range(w):
                back = Pipe(sim, bw, half_rtt, net.loss_rate, 10_000, rng)
                s = snd.LTPSender(sim, _fwd_path(topo, spec, p, f, "ltp"),
                                  shard.on_data, n, critical=crit,
                                  flow=f, rng=rng,
                                  on_done=lambda s: flow_stopped(),
                                  train_len=coalesce)
                shard.attach_ack(f, lambda pkt, s=s, back=back:
                                 back.send(pkt, s.on_ack))
                if coalesce > 1:
                    s.deliver_train = shard.on_data_train
                    shard.attach_ack_train(
                        f, lambda acks, s=s, back=back:
                        back.send_train(acks, s.on_ack_train))
                stops[(p, f)] = (lambda s=s, back=back: back.send(
                    Packet(s.flow, -2, 41, kind="stop"), s.on_ack))
                _warm(s, warm[p][f] if warm else None)
                senders[(p, f)] = s
        for (p, f), s in senders.items():
            d = float(start_delays[f]) if start_delays is not None else 0.0
            sim.at(d, s.start)
        sim.run(until=3600.0)
        res = GatherResult(
            bst_gather=sharded.bst_gather(),
            fcts=np.minimum(sharded.full_times(), sharded.bst_gather()),
            delivered=sharded.delivered_fracs(),
            full_times=sharded.full_times(),
            criticals_ok=sharded.criticals_done,
            per_ps_full=sharded.per_shard_full_times(),
            packets_received=sharded.payload_packets_received(),
            packets_expected=n_ps * w * n,
            trunk_stats=topo.stats(),
            masks=sharded.delivery_masks(),
            agg_stats=_agg_stats(topo),
        )
        return res, [[_save_warm(senders[(p, f)]) for f in range(w)]
                     for p in range(n_ps)]

    # order-preserving protocols: reliable, BST = max FCT
    fcts = np.full((n_ps, w), np.inf)
    receivers = []
    n_done = [0]
    for p in range(n_ps):
        for f in range(w):
            back = Pipe(sim, bw, half_rtt, net.loss_rate, 10_000, rng)

            def on_done(s, p=p, f=f):
                fcts[p, f] = sim.now
                n_done[0] += 1
                if n_done[0] >= n_ps * w:
                    stop_sources()

            s = snd.make_sender(protocol, sim,
                                _fwd_path(topo, spec, p, f, protocol),
                                None, n, flow=f, rng=rng, on_done=on_done,
                                train_len=coalesce)
            r = snd.TcpReceiver(
                sim, lambda pkt, s=s, back=back: back.send(pkt, s.on_ack), f)
            s.deliver = r.on_data
            if coalesce > 1:
                s.deliver_train = r.on_data_train
                r.send_ack_train = (lambda acks, s=s, back=back:
                                    back.send_train(acks, s.on_ack_train))
            # registration so the receiver knows flow length
            _warm(s, warm[p][f] if warm else None)
            senders[(p, f)] = s
            receivers.append(r)
    for r in receivers:
        r.n_total = n
    for (p, f), s in senders.items():
        d = float(start_delays[f]) if start_delays is not None else 0.0
        sim.at(d, s.start)
    sim.run(until=3600.0)
    fin = np.where(np.isfinite(fcts), fcts, sim.now)
    per_worker = fin.max(axis=0)
    res = GatherResult(
        bst_gather=float(per_worker.max()),
        fcts=per_worker,
        delivered=np.ones(w),
        full_times=fcts.max(axis=0),
        criticals_ok=True,
        per_ps_full=fcts,
        packets_received=sum(len(r.received) for r in receivers),
        packets_expected=n_ps * w * n,
        trunk_stats=topo.stats(),
        masks=np.ones((n_ps, w, n), bool),   # reliable: everything lands
    )
    return res, [[_save_warm(senders[(p, f)]) for f in range(w)]
                 for p in range(n_ps)]


def _iterate_gather(protocol: str, net: NetConfig, w: int, size_bytes: float,
                    iters: int, ltp: Optional[LTPConfig], seed: int,
                    straggler_prob: float, straggler_scale: float,
                    spec: Optional[GatherSpec] = None,
                    coalesce: int = 1) -> List[GatherResult]:
    """Repeated gather rounds with per-(shard, link) Early Close adaptation.

    Host-jitter stragglers: with prob ``straggler_prob`` a worker starts
    its flows late by Exp(straggler_scale * ECT) (the paper's Fig-3
    "starved flows"). Bandwidth stragglers come from ``spec``.
    """
    ltp = ltp or LTPConfig()
    spec = spec or GatherSpec()
    n_ps = spec.n_ps
    rng = np.random.default_rng(seed)
    shard_bytes = size_bytes / n_ps
    rt = net.rtprop_ms * 1e-3
    bw_share = net.bandwidth_gbps * 1e9 / 8.0 / w
    ect = rt + shard_bytes / bw_share
    # per-(shard, link) LT init: the paper's formula with each link's own
    # attainable share (slow access links start with larger thresholds)
    lt = np.empty((n_ps, w))
    for f in range(w):
        share = spec.worker_share_bps(f, w, net) / 8.0   # bytes/s
        lt[:, f] = ltp.lt_init_rtprop_mult * rt + shard_bytes / share
    results: List[GatherResult] = []
    warm: Optional[List[List[Optional[dict]]]] = None
    best_full = np.full((n_ps, w), np.inf)
    iters_per_epoch = max(1, iters // 3)
    for i in range(iters):
        delays = np.where(
            rng.random(w) < straggler_prob,
            rng.exponential(straggler_scale * ect, w),
            0.0,
        )
        deadline = lt.max(axis=1) + ltp.deadline_c_ms * 1e-3   # (n_ps,)
        res, warm = _run_gather(protocol, net, w, size_bytes, rng, warm,
                                lt.max(axis=1), deadline,
                                ltp.data_pct_threshold,
                                start_delays=delays, spec=spec,
                                coalesce=coalesce)
        results.append(res)
        pfull = res.per_ps_full if res.per_ps_full is not None else \
            res.full_times[None, :]
        ok = np.isfinite(pfull)
        best_full[ok] = np.minimum(best_full[ok], pfull[ok])
        if (i + 1) % iters_per_epoch == 0:   # epoch boundary: update LT
            upd = np.isfinite(best_full)
            lt[upd] = best_full[upd]
            if not upd.all():
                # some link never reached 100% (early-closed every round):
                # re-apply the paper's ECT formula with the *measured*
                # per-link BtlBw (repro extension, cf. paper §VI-B)
                for p, f in zip(*np.nonzero(~upd)):
                    btlbw = (warm[p][f] or {}).get("btlbw", 0.0) / 8.0
                    if btlbw > 0:
                        lt[p, f] = (ltp.lt_init_rtprop_mult * rt
                                    + shard_bytes / btlbw)
            best_full[:] = np.inf
    return results


# ----------------------------------------------------------------------------
# registered gather scenarios
# ----------------------------------------------------------------------------


@register_scenario("incast_gather")
def incast_gather(protocol: str, net: NetConfig, w: int, size_bytes: float,
                  iters: int = 10, ltp: Optional[LTPConfig] = None,
                  seed: int = 0, straggler_prob: float = 0.15,
                  straggler_scale: float = 0.6,
                  coalesce: int = 1) -> List[GatherResult]:
    """The paper's W-to-1 incast gather with Early Close adaptation —
    the n_ps=1 homogeneous case of the gather engine."""
    return _iterate_gather(protocol, net, w, size_bytes, iters, ltp, seed,
                           straggler_prob, straggler_scale, GatherSpec(),
                           coalesce=coalesce)


@register_scenario("multi_ps_gather")
def multi_ps_gather(protocol: str, net: NetConfig, w: int, size_bytes: float,
                    n_ps: int = 2, iters: int = 10,
                    ltp: Optional[LTPConfig] = None, seed: int = 0,
                    straggler_prob: float = 0.15,
                    straggler_scale: float = 0.6,
                    coalesce: int = 1) -> List[GatherResult]:
    """Sharded gather over n_ps parameter-server shards (DESIGN.md §5).

    The model splits evenly: each worker sends size/n_ps to every shard,
    each shard sits behind its own trunk (pipe group) and runs its own
    Early Close state. By construction n_ps=1 is ``incast_gather``.
    """
    return _iterate_gather(protocol, net, w, size_bytes, iters, ltp, seed,
                           straggler_prob, straggler_scale,
                           GatherSpec(n_ps=n_ps), coalesce=coalesce)


@register_scenario("straggler_gather")
def straggler_gather(protocol: str, net: NetConfig, w: int, size_bytes: float,
                     iters: int = 6, ltp: Optional[LTPConfig] = None,
                     seed: int = 0, n_slow: int = 0,
                     slow_rate_mult: float = 0.25,
                     slow_delay_ms: float = 0.0,
                     n_ps: int = 1, coalesce: int = 1) -> List[GatherResult]:
    """Bandwidth stragglers: the last ``n_slow`` workers (default w//4,
    at least 1) attach through access links at ``slow_rate_mult`` x the
    trunk rate (+ optional extra delay). Early-Close LT thresholds adapt
    per link, so LTP closes around the stragglers while order-preserving
    protocols wait for their last byte.
    """
    n_slow = n_slow or max(1, w // 4)
    mult = np.ones(w)
    mult[w - n_slow:] = slow_rate_mult
    delay = np.zeros(w)
    delay[w - n_slow:] = slow_delay_ms
    spec = GatherSpec(n_ps=n_ps, worker_rate_mult=mult,
                      worker_delay_ms=delay if slow_delay_ms else None)
    return _iterate_gather(protocol, net, w, size_bytes, iters, ltp, seed,
                           0.0, 0.0, spec, coalesce=coalesce)


@register_scenario("topology_gather")
def topology_gather(protocol: str, net: NetConfig, w: int, size_bytes: float,
                    topology: Optional[GatherSpec] = None, iters: int = 4,
                    ltp: Optional[LTPConfig] = None, seed: int = 0,
                    straggler_prob: float = 0.0, straggler_scale: float = 0.0,
                    coalesce: int = 1) -> List[GatherResult]:
    """Gather over an arbitrary ``repro_torch.net.topology`` builder result —
    the generic topology-first entry point (DESIGN.md §11): flat,
    multi-PS, and rack/spine (with or without in-network aggregation)
    all run through the one engine."""
    spec = as_topology(topology) if topology is not None else None
    return _iterate_gather(protocol, net, w, size_bytes, iters, ltp, seed,
                           straggler_prob, straggler_scale, spec,
                           coalesce=coalesce)


@register_scenario("rack_spine_gather")
def rack_spine_gather(protocol: str, net: NetConfig, size_bytes: float,
                      racks: int = 4, workers_per_rack: int = 8,
                      oversub: float = 4.0, n_ps: int = 1, agg: bool = True,
                      agg_hold_ms: float = 0.0, iters: int = 4,
                      ltp: Optional[LTPConfig] = None, seed: int = 0,
                      straggler_prob: float = 0.0,
                      straggler_scale: float = 0.0, coalesce: int = 1,
                      w: Optional[int] = None) -> List[GatherResult]:
    """Rack/spine gather sugar over ``topology_gather``: ToR-attached
    workers, oversubscribed uplinks, optional in-network aggregation
    (DESIGN.md §11). ``w`` is implied by the rack grid."""
    spec = rack_spine(racks, workers_per_rack, oversub=oversub, n_ps=n_ps,
                      agg=agg, agg_hold_ms=agg_hold_ms)
    if w is not None:
        spec.validate_workers(w, "rack_spine_gather")
    return _iterate_gather(protocol, net, spec.n_workers, size_bytes, iters,
                           ltp, seed, straggler_prob, straggler_scale, spec,
                           coalesce=coalesce)


@register_scenario("cross_traffic")
def cross_traffic(protocol: str, net: NetConfig, w: int, size_bytes: float,
                  iters: int = 6, ltp: Optional[LTPConfig] = None,
                  seed: int = 0, bg_load: float = 0.5,
                  on_ms: float = 5.0, off_ms: float = 5.0,
                  n_ps: int = 1, coalesce: int = 1) -> List[GatherResult]:
    """Incast gather competing with open-loop background traffic on the
    trunk(s): other tenants' flows crossing the same ToR egress. The
    background load is never ACKed or retransmitted (pure interference);
    ``bg_load`` is the offered fraction of line rate during ON bursts.
    """
    spec = GatherSpec(n_ps=n_ps, cross_traffic_load=bg_load,
                      cross_on_ms=on_ms, cross_off_ms=off_ms)
    return _iterate_gather(protocol, net, w, size_bytes, iters, ltp, seed,
                           0.0, 0.0, spec, coalesce=coalesce)


# ----------------------------------------------------------------------------
# full training-iteration loop (gather + broadcast)
# ----------------------------------------------------------------------------


@register_scenario("train_iterations")
def train_iterations(protocol: str, net: NetConfig, w: int, model_bytes: float,
                     iters: int = 10, ltp: Optional[LTPConfig] = None,
                     seed: int = 0, scale: float = 1.0,
                     scenario: str = "incast_gather", n_ps: int = 1,
                     **scenario_kw) -> Dict:
    """Gather (simulated, possibly Early-Closed) + broadcast (reliable,
    one-to-many — modeled via measured p2p utilization since it has no
    incast contention). ``scale`` < 1 simulates a scaled-down model size
    and rescales times back up (documented wherever used).

    ``scenario`` picks any registered gather scenario for the gathering
    leg (``multi_ps_gather``, ``straggler_gather``, ``cross_traffic``);
    extra kwargs pass through. ``n_ps`` governs BOTH legs: it is
    forwarded to scenarios that shard (so gather and broadcast always
    agree), and with n_ps shards the broadcast parallelizes — each PS
    broadcasts its 1/n_ps of the model over its own trunk.
    """
    import inspect
    size = model_bytes * scale
    fn = SCENARIOS[scenario]
    if scenario_kw.get("topology") is not None:
        # topology-first path (DESIGN.md §11): the Topology carries the
        # shard count for both legs
        if n_ps != 1 and n_ps != scenario_kw["topology"].n_ps:
            raise ValueError(
                f"n_ps={n_ps} contradicts topology.n_ps="
                f"{scenario_kw['topology'].n_ps}; drop the n_ps kwarg")
        n_ps = scenario_kw["topology"].n_ps
    elif "n_ps" in inspect.signature(fn).parameters:
        scenario_kw.setdefault("n_ps", n_ps)
        n_ps = int(scenario_kw["n_ps"])
    elif n_ps != 1:
        raise ValueError(
            f"scenario {scenario!r} does not take n_ps; use "
            f"scenario='multi_ps_gather' (or another sharding scenario) "
            f"for n_ps={n_ps}")
    gs = run_scenario(scenario, protocol, net, w=w, size_bytes=size,
                      iters=iters, ltp=ltp, seed=seed, **scenario_kw)
    util = utilization_cached(protocol, net, size_bytes=max(4e6, w * size))
    bcast = (net.rtprop_ms * 1e-3
             + w * size / n_ps
             / (net.bandwidth_gbps * 1e9 / 8.0 * max(util, 1e-3)))
    bst = np.array([g.bst_gather + bcast for g in gs]) / scale
    delivered = np.stack([g.delivered for g in gs])
    # (iters, W, n_ps * n) bool: each worker's full-model packet stream is
    # the concatenation of its per-shard streams — the delivery masks the
    # kernel-backed sync consumes (PSTrainer(mask_trace=...), DESIGN.md §7)
    masks = None
    if all(g.masks is not None for g in gs):
        masks = np.stack([np.concatenate(list(g.masks), axis=1) for g in gs])
    return {
        "bst": bst,
        "bst_gather": np.array([g.bst_gather for g in gs]) / scale,
        "bst_broadcast": bcast / scale,
        "delivered": delivered,
        "fct_all": np.concatenate([g.fcts for g in gs]) / scale,
        "delivery_masks": masks,
    }


# ----------------------------------------------------------------------------
# fairness
# ----------------------------------------------------------------------------


def fairness_share(proto_a: str, proto_b: str, net: NetConfig,
                   duration: float = 2.0, seed: int = 0) -> Tuple[float, float]:
    """Two long flows share the bottleneck; returns (bytes_a, bytes_b)
    normalized shares over ``duration``."""
    sim = Sim()
    rng = np.random.default_rng(seed)
    bw = net.bandwidth_gbps * 1e9
    bottleneck = Pipe(sim, bw, net.rtprop_ms * 1e-3 / 2, net.loss_rate,
                      net.queue_pkts, rng)
    delivered = {0: 0, 1: 0}
    sender_objs = []
    for f, proto in enumerate((proto_a, proto_b)):
        n = 10_000_000  # effectively infinite
        back = Pipe(sim, bw, net.rtprop_ms * 1e-3 / 2, net.loss_rate, 10_000, rng)
        if proto == "ltp":
            s = snd.LTPSender(sim, bottleneck, None, n, rng=rng, flow=f)
            r = LTPFlowReceiver(sim, lambda p, s=s, back=back: back.send(p, s.on_ack), f)
            def deliver(p, r=r, f=f):
                if p.kind == "data":
                    delivered[f] += p.size
                r.on_data(p, lambda: None)
            s.deliver = deliver
        else:
            s = snd.make_sender(proto, sim, bottleneck, None, n, flow=f,
                                rng=rng)
            r = snd.TcpReceiver(sim, lambda p, s=s, back=back: back.send(p, s.on_ack), f)
            def deliver(p, r=r, f=f):
                if p.kind == "data":
                    delivered[f] += p.size
                r.on_data(p)
            s.deliver = deliver
        sender_objs.append(s)
    for s in sender_objs:
        s.start()
    sim.run(until=duration)
    tot = delivered[0] + delivered[1]
    if tot == 0:
        return 0.5, 0.5
    return delivered[0] / tot, delivered[1] / tot


# registry adapter: the competing protocol rides in as a kwarg
SCENARIOS["fairness_share"] = (
    lambda protocol, net, proto_b="cubic", **kw:
        fairness_share(protocol, proto_b, net, **kw))
