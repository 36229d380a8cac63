"""Chrome-trace (Perfetto-loadable) export of a runtime event stream
(DESIGN.md §12).

``chrome_trace`` renders the §8 telemetry events of a ``ClusterRuntime``
run as a Trace Event Format document — open it at https://ui.perfetto.dev
or chrome://tracing. The track layout:

  pid 1 "workers"    per-worker threads: ``compute`` spans (compute_start
                     -> grad_ready, clipped at a crash), ``blocked``
                     spans (block -> unblock), lifecycle + per-worker
                     Early-Close instants.
  pid 2 "transport"  per-worker threads: ``transport`` spans from
                     grad_ready to the gradient's fate — grad_arrived
                     (async/ssp), the iteration's barrier commit (bsp),
                     or a flow_torn / ps_lost teardown.
  pid 3 "ps"         per-shard threads: shard Early-Close instants;
                     thread 0 additionally carries apply / checkpoint /
                     ps_failover / rebalance markers.
  pid 4 "net"        counter tracks from the ``Sim.every`` queue samples:
                     PS pending depth, max trunk depth, and (when the
                     sampler recorded per-trunk depths) one counter per
                     trunk.
  pid 5 "control"    injected fault markers (one instant per FaultEvent);
                     thread 1 carries fabric-fault markers (one instant
                     per LinkFaultEvent plus reroute/blackhole path
                     transitions, DESIGN.md §14) and thread 2 the
                     budget-controller pct_threshold counter.

Spans are ``X`` (complete) events in microseconds of sim time; tracks
exist for every worker/PS slot via thread_name metadata even when empty,
so a trace of a degraded run still shows who was silent.

``validate_chrome_trace`` is the schema smoke CI runs on the exported
artifact: parses, one track per worker/PS, spans well-nested per track,
fault markers present when demanded.
"""
from __future__ import annotations

import json
from typing import Any, Dict, Iterable, List, Optional, Sequence

PID_WORKERS = 1
PID_TRANSPORT = 2
PID_PS = 3
PID_NET = 4
PID_CONTROL = 5

_US = 1e6   # sim seconds -> trace microseconds


def _meta(pid: int, name: str, tid: Optional[int] = None,
          tname: Optional[str] = None) -> List[dict]:
    out = [{"name": "process_name", "ph": "M", "pid": pid,
            "args": {"name": name}}]
    if tid is not None:
        out.append({"name": "thread_name", "ph": "M", "pid": pid,
                    "tid": tid, "args": {"name": tname or f"{name} {tid}"}})
    return out


def _span(name: str, pid: int, tid: int, t0: float, t1: float,
          args: Optional[dict] = None) -> dict:
    ev = {"name": name, "ph": "X", "pid": pid, "tid": tid,
          "ts": t0 * _US, "dur": max(0.0, (t1 - t0)) * _US, "cat": "sim"}
    if args:
        ev["args"] = args
    return ev


def _instant(name: str, pid: int, tid: int, t: float,
             args: Optional[dict] = None, scope: str = "t") -> dict:
    ev = {"name": name, "ph": "i", "s": scope, "pid": pid, "tid": tid,
          "ts": t * _US, "cat": "sim"}
    if args:
        ev["args"] = args
    return ev


def _counter(name: str, series: Dict[str, float], t: float) -> dict:
    return {"name": name, "ph": "C", "pid": PID_NET, "tid": 0,
            "ts": t * _US, "args": series}


def chrome_trace(events: Iterable[dict], *, n_workers: Optional[int] = None,
                 n_ps: Optional[int] = None,
                 meta: Optional[dict] = None) -> Dict[str, Any]:
    """Render a telemetry event stream (``Telemetry.events``) into a
    Trace Event Format document (dict; ``json.dump``-able).

    ``n_workers`` / ``n_ps`` pin how many worker/PS tracks exist even if
    some recorded no events (inferred from the stream otherwise);
    ``meta`` lands in ``otherData`` for provenance (config, seed).
    """
    evs = list(events)
    workers = set(range(n_workers or 0))
    shards = set(range(n_ps or 0))
    for e in evs:
        if "worker" in e:
            workers.add(int(e["worker"]))
        if "shard" in e:
            shards.add(int(e["shard"]))
    if not shards:
        shards.add(0)
    t_end = evs[-1]["t"] if evs else 0.0
    # bsp runs record no grad_arrived: the iteration's apply commits every
    # open transport span instead (see module docstring)
    has_arrivals = any(e["kind"] == "grad_arrived" for e in evs)

    out: List[dict] = []
    out += _meta(PID_WORKERS, "workers")
    out += _meta(PID_TRANSPORT, "transport")
    out += _meta(PID_PS, "ps")
    out += _meta(PID_NET, "net", 0, "queues")
    out += _meta(PID_CONTROL, "control", 0, "faults")
    out += _meta(PID_CONTROL, "control", 1, "fabric")[1:]
    out += _meta(PID_CONTROL, "control", 2, "budget")[1:]
    for w in sorted(workers):
        out += _meta(PID_WORKERS, "workers", w, f"worker {w}")[1:]
        out += _meta(PID_TRANSPORT, "transport", w, f"worker {w} flows")[1:]
    for p in sorted(shards):
        out += _meta(PID_PS, "ps", p, f"ps shard {p}")[1:]

    compute_open: Dict[int, dict] = {}          # worker -> compute_start
    block_open: Dict[int, float] = {}           # worker -> t(block)
    flight_open: Dict[tuple, float] = {}        # (worker, it) -> t(ready)

    def close_compute(w: int, t: float, status: str) -> None:
        e = compute_open.pop(w, None)
        if e is not None:
            out.append(_span("compute", PID_WORKERS, w, e["t"], t,
                             {"iteration": e.get("iteration"),
                              "status": status}))

    def close_flight(w: int, it: int, t: float, status: str,
                     args: Optional[dict] = None) -> None:
        t0 = flight_open.pop((w, it), None)
        if t0 is not None:
            out.append(_span("transport", PID_TRANSPORT, w, t0, t,
                             {"iteration": it, "status": status,
                              **(args or {})}))

    for e in evs:
        kind, t = e["kind"], e["t"]
        if kind == "compute_start":
            w = int(e["worker"])
            # a cancelled compute (crash/rollback) never saw grad_ready:
            # close the stale span at the next start so tracks stay sane
            close_compute(w, t, "superseded")
            compute_open[w] = e
        elif kind == "grad_ready":
            w = int(e["worker"])
            close_compute(w, t, "done")
            flight_open[(w, int(e["iteration"]))] = t
        elif kind == "grad_arrived":
            close_flight(int(e["worker"]), int(e["iteration"]), t,
                         "delivered", {"staleness": e.get("staleness"),
                                       "delivered": e.get("delivered")})
        elif kind == "apply":
            if not has_arrivals:
                it = int(e["step"])
                for (w, fit) in [k for k in flight_open if k[1] == it]:
                    close_flight(w, fit, t, "committed")
            out.append(_instant("apply", PID_PS, 0, t,
                                {"step": e.get("step"),
                                 "n_grads": e.get("n_grads"),
                                 "staleness_max": e.get("staleness_max")}))
        elif kind == "flow_torn":
            close_flight(int(e["worker"]), int(e["iteration"]), t, "torn")
        elif kind == "ps_lost":
            close_flight(int(e["worker"]), int(e["iteration"]), t, "lost")
        elif kind == "block":
            block_open.setdefault(int(e["worker"]), t)
        elif kind == "unblock":
            t0 = block_open.pop(int(e["worker"]), None)
            if t0 is not None:
                out.append(_span("blocked", PID_WORKERS, int(e["worker"]),
                                 t0, t))
        elif kind == "early_close":
            if "shard" in e:
                out.append(_instant("early_close", PID_PS, int(e["shard"]),
                                    t, {"delivered": e.get("delivered")}))
            else:
                out.append(_instant(
                    "early_close", PID_TRANSPORT,
                    int(e.get("worker", 0)), t,
                    {"delivered": e.get("delivered"),
                     "iteration": e.get("iteration")}))
        elif kind == "stale_drop":
            out.append(_instant("stale_drop", PID_PS, 0, t,
                                {"worker": e.get("worker"),
                                 "staleness": e.get("staleness")}))
        elif kind == "queue":
            series = {"ps_pending": e.get("depth", 0)}
            if "net_depth" in e:
                series["trunk_max_pkts"] = e["net_depth"]
            out.append(_counter("queues", series, t))
            trunks = e.get("trunks")
            if trunks:
                for i, d in enumerate(trunks):
                    out.append(_counter(f"trunk{i} queue_pkts",
                                        {"pkts": d}, t))
        elif kind == "fault":
            out.append(_instant(f"fault:{e.get('fault')}", PID_CONTROL, 0,
                                t, {"target": e.get("target")}, scope="g"))
        elif kind == "netfault":
            # fabric faults (DESIGN.md §14) get their own control
            # thread so a link_flap timeline reads as a dotted row
            # distinct from node crash/failover markers
            out.append(_instant(f"netfault:{e.get('fault')}", PID_CONTROL,
                                1, t, {"target": e.get("target")},
                                scope="g"))
        elif kind in ("reroute", "blackhole"):
            out.append(_instant(f"path:{kind}", PID_CONTROL, 1, t,
                                {"link": e.get("link")}))
        elif kind == "flow_dead":
            close_flight(int(e["worker"]), int(e["iteration"]), t, "dead")
        elif kind == "budget":
            out.append({"name": f"pct_threshold shard{e.get('shard')}",
                        "ph": "C", "pid": PID_CONTROL, "tid": 2,
                        "ts": t * _US, "args": {"pct": e.get("pct")}})
        elif kind == "lifecycle":
            w = int(e["worker"])
            if e.get("state") == "dead":
                close_compute(w, t, "dead")
            out.append(_instant(f"worker:{e.get('state')}", PID_WORKERS,
                                w, t, {"iteration": e.get("iteration"),
                                       "reason": e.get("reason")}))
        elif kind == "ps_failover":
            out.append(_instant("ps_failover", PID_PS, 0, t,
                                {"ps": e.get("ps"), "step": e.get("step"),
                                 "n_hist": e.get("n_hist")}, scope="g"))
        elif kind == "checkpoint":
            out.append(_instant("checkpoint", PID_PS, 0, t,
                                {"step": e.get("step")}))
        elif kind == "rebalance":
            out.append(_instant("rebalance", PID_PS, 0, t,
                                {"owner": list(e.get("owner", ()))}))
        # masks digests carry no timeline information: skipped

    # unmatched opens at stream end: clip to the last event
    for w, e in list(compute_open.items()):
        out.append(_span("compute", PID_WORKERS, w, e["t"],
                         max(t_end, e["t"] + e.get("dt", 0.0)),
                         {"iteration": e.get("iteration"),
                          "status": "open"}))
    for w, t0 in block_open.items():
        out.append(_span("blocked", PID_WORKERS, w, t0, t_end,
                         {"status": "open"}))
    for (w, it), t0 in flight_open.items():
        out.append(_span("transport", PID_TRANSPORT, w, t0, t_end,
                         {"iteration": it, "status": "open"}))

    doc: Dict[str, Any] = {"traceEvents": out, "displayTimeUnit": "ms"}
    other = {"n_workers": len(workers), "n_ps": len(shards),
             "n_events": len(evs)}
    if meta:
        other.update(meta)
    doc["otherData"] = other
    return doc


def write_chrome_trace(path: str, events: Iterable[dict],
                       **kw: Any) -> Dict[str, Any]:
    doc = chrome_trace(events, **kw)
    with open(path, "w") as f:
        json.dump(doc, f)
    return doc


def _well_nested(spans: Sequence[dict], eps: float = 1e-3) -> Optional[str]:
    """None if the track's spans form a proper containment forest;
    else a description of the first partial overlap."""
    ordered = sorted(spans, key=lambda s: (s["ts"], -s["dur"]))
    stack: List[dict] = []
    for s in ordered:
        end = s["ts"] + s["dur"]
        while stack and stack[-1]["ts"] + stack[-1]["dur"] <= s["ts"] + eps:
            stack.pop()
        if stack:
            top_end = stack[-1]["ts"] + stack[-1]["dur"]
            if end > top_end + eps:
                return (f"span {s['name']!r} [{s['ts']:.3f}, {end:.3f}]us "
                        f"partially overlaps {stack[-1]['name']!r} ending "
                        f"{top_end:.3f}us")
        stack.append(s)
    return None


def validate_chrome_trace(doc: Dict[str, Any],
                          n_workers: Optional[int] = None,
                          n_ps: Optional[int] = None,
                          require_fault_markers: bool = False,
                          require_netfault_markers: bool = False
                          ) -> List[str]:
    """Schema smoke over an exported trace; returns problem strings
    (empty = valid). Checks: JSON-shape, thread tracks for every
    worker/PS slot, at least one compute and one transport span, spans
    well-nested per (pid, tid) track, fault markers when demanded."""
    problems: List[str] = []
    evs = doc.get("traceEvents")
    if not isinstance(evs, list) or not evs:
        return ["traceEvents missing or empty"]
    try:
        json.dumps(doc)
    except (TypeError, ValueError) as e:  # non-serializable payloads
        problems.append(f"not JSON-serializable: {e}")
    threads = {(e["pid"], e.get("tid")) for e in evs
               if e.get("ph") == "M" and e.get("name") == "thread_name"}
    for w in range(n_workers or 0):
        if (PID_WORKERS, w) not in threads:
            problems.append(f"no worker track for worker {w}")
    for p in range(n_ps or 0):
        if (PID_PS, p) not in threads:
            problems.append(f"no ps track for shard {p}")
    spans_by_track: Dict[tuple, List[dict]] = {}
    names = set()
    for e in evs:
        if e.get("ph") == "X":
            if e.get("dur", -1.0) < 0:
                problems.append(f"negative duration on {e.get('name')!r}")
            spans_by_track.setdefault((e["pid"], e["tid"]), []).append(e)
            names.add(e.get("name"))
    if "compute" not in names:
        problems.append("no compute spans")
    if "transport" not in names:
        problems.append("no transport spans")
    for (pid, tid), spans in sorted(spans_by_track.items()):
        bad = _well_nested(spans)
        if bad:
            problems.append(f"track (pid={pid}, tid={tid}) not "
                            f"well-nested: {bad}")
    if require_fault_markers:
        if not any(e.get("ph") == "i"
                   and str(e.get("name", "")).startswith("fault:")
                   for e in evs):
            problems.append("no fault markers in a faulted run")
    if require_netfault_markers:
        if not any(e.get("ph") == "i"
                   and str(e.get("name", "")).startswith("netfault:")
                   for e in evs):
            problems.append("no netfault markers in a fabric-faulted run")
    return problems
