"""The des16 fabric-chaos scenario: what link and switch faults cost a
training run, and what the loss-budget controller buys back
(DESIGN.md §14).

The port's copy, as a library function, of the JAX package's
``benchmarks/netfault_sweep.py`` (``DES16_NETFAULTS``, ``_recovery_s``,
``_cell``, ``run``). Sixteen workers in 4 racks of 4, two PS shards,
train over the packet-level transport (``transport="des"``) under link
flaps, an aggregation-switch crash, a rack partition and a brownout,
three ways on the same schedule and seeds: the fault-free twin, faulted
with the controller, faulted without it. Metrics:

* ``netfault_recovery_s``   — time from the first injected fault until
                              commits resume at pre-fault cadence
                              (controller on);
* ``netfault_goodput_ratio``— faulted steps/sim-second over the clean
                              twin's (controller on; 1.0 = chaos cost
                              nothing);
* ``netfault_final_loss_ratio`` — faulted final loss / clean final loss
                              (controller on);
* the same three with the ``_off`` suffix for the controller-off twin.

The rows and metrics are returned unrounded (``recovery_s`` keeps the
benchmark's 0.1 ms grid); nothing is written or printed.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.config import (
    LTPConfig,
    ModelConfig,
    NetConfig,
    RuntimeConfig,
    TrainConfig,
)
from repro_torch.configs import get_config
from repro_torch.data import SyntheticCIFAR, batches
from repro_torch.device import DeviceLike
from repro_torch.models import build
from repro_torch.net.topology import rack_spine
from repro_torch.optim import make_optimizer
from repro_torch.runtime import (
    BudgetController,
    ClusterRuntime,
    LinkFaultEvent,
    LinkFaultSchedule,
)

NET = NetConfig(10, 1, 0.001, 4096)
W = 16
RACKS = 4
#: the benchmark's seed of every des16 run (init and transport)
SEED = 11

#: the des16 fabric-chaos scenario: a flap storm on one uplink (the
#: plane reroutes it over the spare spine path), an aggregation-switch
#: crash, one rack partition (survived via blackhole detection), then a
#: mild brownout of one rack uplink — the controller's showcase: the
#: rack's flows straggle in lockstep behind in-network aggregation,
#: holding the aggregate delivered pct near the configured 0.8
#: threshold, so controller-off rounds intermittently wait out the pct
#: rule into the deadline window while the controller widens below the
#: straggler plateau and keeps rounds closing at healthy-flow latency
#: (DESIGN.md §14).
DES16_NETFAULTS = LinkFaultSchedule([
    LinkFaultEvent(0.04, "link_flap", "rack2/up", period_s=0.02,
                   duty=0.5, duration_s=0.08),
    LinkFaultEvent(0.09, "switch_crash", "rack1", recover_s=0.05),
    LinkFaultEvent(0.13, "partition", "rack3", recover_s=0.08),
    # the brownout starts only after the partitioned rack's senders have
    # worked back out of RTO backoff (~0.36 s), so the two recovery
    # phases stay separable in the apply cadence
    # 10 Gbps uplink -> 50 Mbps: deep enough that the rack's lockstep
    # delivered fraction crawls (holding the aggregate pct under 0.8
    # into the deadline window on unlucky rounds), shallow enough that
    # its critical packets — sent first via CQ — still land promptly,
    # so the pct rule (not critical completeness) is what gates closes
    LinkFaultEvent(0.45, "link_degrade", "rack2/up", rate_factor=5e-3,
                   recover_s=0.30),
])


def _recovery_s(rt) -> float:
    """Sim-seconds from the first injected fault until commits are
    *done* stalling: the end of the last inter-apply gap that exceeded
    1.5x the pre-fault median cadence. Scanning for the last slow gap
    (not the first recovered one) is deliberate — a run that limps
    through a brownout at half cadence has not recovered just because
    one early gap happened to look normal."""
    applies = [e["t"] for e in rt.tel.of("apply")]
    nf = rt.tel.of("netfault")
    if not nf or len(applies) < 3:
        return 0.0
    t0 = nf[0]["t"]
    pre = [t for t in applies if t <= t0]
    post = [t for t in applies if t > t0]
    if len(pre) >= 3:
        cadence = float(np.median(np.diff(pre)))
    else:
        cadence = float(np.median(np.diff(applies)))
    recovered = t0
    prev = pre[-1] if pre else t0
    for t in post:
        if t - prev > 1.5 * cadence:
            recovered = t
        prev = t
    return round(max(recovered - t0, 0.0), 4)


def des16_cell(api, tc: TrainConfig, steps: int, *, net_faults=None,
               budget: bool = False, sync_backend: str = "auto", device: DeviceLike = None,
               params: Any = None) -> Tuple[ClusterRuntime, Dict[str, Any]]:
    """One des16 run of ``steps`` steps (bsp over ltp, ``compute_time=
    0.01``, staleness_comp 0.5), with ``BudgetController(interval_s=
    0.02)`` when ``budget``. Returns the runtime after its run and the
    benchmark's row, unrounded; ``wall_s`` is the run's host seconds."""
    rt = ClusterRuntime(
        api, make_optimizer(tc), tc, LTPConfig(), NET, n_workers=W,
        protocol="ltp", policy="bsp", compute_time=0.01, seed=SEED,
        transport="des",
        topology=rack_spine(RACKS, W // RACKS, n_ps=2),
        net_faults=net_faults,
        budget=BudgetController(interval_s=0.02) if budget else None,
        runtime_cfg=RuntimeConfig(staleness_comp=0.5,
                                  sync_backend=sync_backend),
        device=device, params=params)
    data = list(batches(SyntheticCIFAR(seed=3), tc.batch, steps))
    t0 = time.perf_counter()
    rt.run(data)
    wall = time.perf_counter() - t0
    s = rt.tel.summary()
    return rt, {
        "scenario": "netfault_des16", "policy": "bsp", "transport": "des",
        "budget": bool(budget),
        "n_netfaults": s.get("n_netfaults", 0),
        "n_flow_dead": s.get("n_flow_dead", 0),
        "n_reroutes": s.get("n_reroutes", 0),
        "n_blackholes": s.get("n_blackholes", 0),
        "n_budget_moves": s.get("n_budget_moves", 0),
        "recovery_s": _recovery_s(rt),
        "simtime_s": rt.sim_time,
        "goodput_steps_per_s": len(rt.history) / rt.sim_time,
        "final_loss": float(rt.history[-1]["loss"]),
        "n_steps_done": len(rt.history),
        "wall_s": wall,
    }


def des16_metrics(clean: Dict[str, Any], on: Dict[str, Any],
                  off: Dict[str, Any], steps: int) -> Dict[str, Any]:
    """The benchmark's metrics from the three rows; raises if a faulted
    run did not complete its ``steps``."""
    metrics = {}
    for row, suffix in ((on, ""), (off, "_off")):
        if row["n_steps_done"] != steps:
            raise RuntimeError(f"faulted des16 run ({suffix or 'budget'}) "
                               f"did not complete: {row['n_steps_done']} "
                               f"of {steps} steps")
        metrics[f"netfault_recovery_s{suffix}"] = row["recovery_s"]
        metrics[f"netfault_goodput_ratio{suffix}"] = (
            row["goodput_steps_per_s"] / clean["goodput_steps_per_s"])
        metrics[f"netfault_final_loss_ratio{suffix}"] = (
            row["final_loss"] / clean["final_loss"])
    metrics["netfault_n_reroutes"] = on["n_reroutes"]
    metrics["netfault_n_budget_moves"] = on["n_budget_moves"]
    return metrics


def run(*, cfg: Optional[ModelConfig] = None, steps: int = 40,
        device: DeviceLike = None,
        params: Any = None) -> Tuple[List[Dict[str, Any]], Dict[str, Any]]:
    """The rows and metrics of ``netfault_sweep.run(quick=True)``: the
    clean twin, faulted with the controller, faulted without it. Unset,
    ``cfg`` (papernet at width 8, 3 layers) and ``steps`` are the
    benchmark's quick settings. Every run starts from ``params`` when
    given, else from ``SEED``'s init."""
    api = build(cfg if cfg is not None else
                get_config("papernet").replace(d_model=8, n_layers=3))
    tc = TrainConfig(batch=4 * W, lr=0.05, steps=steps)
    kw = dict(device=device, params=params)
    t_start = time.perf_counter()
    _, clean = des16_cell(api, tc, steps, **kw)
    clean["scenario"] = "netfault_des16_free"
    _, on = des16_cell(api, tc, steps, net_faults=DES16_NETFAULTS,
                       budget=True, **kw)
    _, off = des16_cell(api, tc, steps, net_faults=DES16_NETFAULTS, **kw)
    off["scenario"] = "netfault_des16_nobudget"
    metrics = des16_metrics(clean, on, off, steps)
    metrics["netfault_sweep_wall_s"] = time.perf_counter() - t_start
    return [clean, on, off], metrics
