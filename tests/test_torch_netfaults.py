"""The port's network fault plane and loss-budget controller against the
JAX package's, case for case as tests/test_netfaults.py sets them up.

The fault plane is numpy on both sides, so every schedule, drawn or
given, is equal event for event, and every pipe-level and plane-level
observation is equal. The runtime cases (``ClusterRuntime(transport=
"des", net_faults=..., budget=...)`` on the CPU) start from the JAX
runtime's own init (``convert.params_from_numpy``): step, bst, sim_time,
staleness and n_grads agree exactly, as does the whole telemetry stream
(the ``masks`` digests, ``netfault``, ``reroute``, ``blackhole``,
``flow_dead`` and ``budget`` records among it) apart from loss; loss
agrees within rtol 1e-4, ``delivered`` exactly on async and degraded
rounds and within rtol 1e-6 on full bsp commits, params within rtol
2e-4 / atol 2e-5. The des16 scenario (``repro_torch.train.netfault``)
is held against ``benchmarks.netfault_sweep._cell``."""
import dataclasses
import os
import sys

import jax
import numpy as np
import pytest
import torch

import repro.net.netfaults as jnf
import repro.net.scenarios as jscen
import repro.net.simcore as jsim
import repro.net.topology as jtopo
import repro.runtime as jrun
from repro.config import LTPConfig as JLTPConfig
from repro.config import NetConfig as JNetConfig
from repro.config import NetFaultConfig as JNetFaultConfig
from repro.config import TrainConfig as JTrainConfig
from repro.configs import get_config as jget_config
from repro.data import SyntheticCIFAR as JSyntheticCIFAR
from repro.data import batches as jbatches
from repro.models import build as jbuild
from repro.optim import make_optimizer as jmake_optimizer
import repro_torch.net.netfaults as tnf
import repro_torch.net.scenarios as tscen
import repro_torch.net.simcore as tsim
import repro_torch.net.topology as ttopo
import repro_torch.runtime as trun
from repro_torch.config import (
    LTPConfig,
    NetConfig,
    NetFaultConfig,
    TrainConfig,
)
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.data import SyntheticCIFAR, batches
from repro_torch.models import build
from repro_torch.optim import make_optimizer
from repro_torch.train import netfault as tdes16
from repro_torch.tree import tree_leaves

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
from benchmarks import netfault_sweep as jdes16  # noqa: E402

NET = (10, 1, 0.001, 4096)
W = 4
STEPS = 6
SMALL = dict(d_model=8, n_layers=3)

#: one (package's netfaults module, runtime module, NetFaultConfig) per
#: package
JAX = (jnf, jrun, JNetFaultConfig)
PORT = (tnf, trun, NetFaultConfig)


def _events(sched):
    """A schedule as plain tuples, comparable across the packages."""
    return [dataclasses.astuple(e) for e in sched]


# ---------------------------------------------------------------------------
# event / schedule units
# ---------------------------------------------------------------------------


def _validation_and_labels(NF):
    out = []
    for args in ((0.1, "meteor"), (-1.0, "link_down", "rack0/up")):
        with pytest.raises(ValueError) as e:
            NF.LinkFaultEvent(*args)
        out.append(str(e.value))
    with pytest.raises(TypeError):
        NF.LinkFaultSchedule([("not", "an", "event")])
    for ev in (NF.LinkFaultEvent(0.1, "link_flap", "rack1/up",
                                 period_s=0.02, duty=0.5, duration_s=0.2),
               NF.LinkFaultEvent(0.5, "partition", "rack2", recover_s=0.1),
               NF.LinkFaultEvent(0.25, "link_degrade", "ps0/trunk",
                                 rate_factor=0.5, extra_loss=0.02),
               NF.LinkFaultEvent(0.0, "heal", "rack3")):
        out.append(ev.label())
    return out


def test_link_fault_event_validation_and_label():
    got = _validation_and_labels(tnf)
    assert got == _validation_and_labels(jnf)
    assert "unknown link fault kind" in got[0] and "must be >= 0" in got[1]
    assert got[2].startswith("link_flap rack1/up @0.10s")
    assert "duty 0.50" in got[2] and "+0.10s recovery" in got[3]
    assert tnf.LINK_FAULT_KINDS == jnf.LINK_FAULT_KINDS


def test_node_fault_labels_name_the_right_unit():
    for kind, target in (("ps_fail", 1), ("worker_crash", 2)):
        lbl = trun.FaultEvent(0.5, kind, target).label()
        assert lbl == jrun.FaultEvent(0.5, kind, target).label()
    assert trun.FaultEvent(0.5, "ps_fail", 1).label().startswith(
        "ps_fail ps1 @0.50s")


def _sorted_and_drawn(NF, T):
    s = NF.LinkFaultSchedule([NF.LinkFaultEvent(0.3, "link_down", "rack0/up"),
                              NF.LinkFaultEvent(0.1, "link_up", "rack1/up"),
                              NF.LinkFaultEvent(0.3, "heal", "rack0")])
    spec = T.rack_spine(4, 4, n_ps=2)
    a = NF.LinkFaultSchedule.random(spec, 2.0, seed=5, flap_rate=3.0,
                                    partition_at=(0.5, 1.0))
    b = NF.LinkFaultSchedule.random(spec, 2.0, seed=5, flap_rate=3.0,
                                    partition_at=(0.5, 1.0))
    assert a.events == b.events and len(a) > 0
    return _events(s), _events(a)


def test_schedule_sorted_stable_deterministic():
    got = _sorted_and_drawn(tnf, ttopo)
    assert got == _sorted_and_drawn(jnf, jtopo)
    assert [(e[0], e[1]) for e in got[0]] == [
        (0.1, "link_up"), (0.3, "link_down"), (0.3, "heal")]


def _never_cuts_trunks(NF, T):
    spec = T.rack_spine(4, 4, n_ps=2)
    ps_homes = {spec.ps_rack(p) for p in range(spec.n_ps)}
    s = NF.LinkFaultSchedule.random(spec, 5.0, seed=7, link_down_rate=4.0,
                                    flap_rate=4.0, degrade_rate=2.0,
                                    partition_at=(0.5, 1.5, 2.5),
                                    switch_crash_at=(1.0,))
    assert len(s) > 0
    for ev in s:
        if ev.kind in ("link_down", "link_flap"):
            assert "trunk" not in ev.target
        if ev.kind == "partition":
            assert int(ev.target[4:]) not in ps_homes
    return _events(s)


def test_random_never_downs_trunks_or_partitions_ps_racks():
    assert _never_cuts_trunks(tnf, ttopo) == _never_cuts_trunks(jnf, jtopo)


MAX_CUT_CASES = [
    [(0.1, "partition", "rack2", 0.5), (0.3, "partition", "rack3", 0.5)],
    [(0.1, "partition", "rack2", 0.1), (0.3, "partition", "rack3", 0.1)],
    [(0.1, "switch_crash", "rack1", 0.0),
     (0.2, "switch_recover", "rack1", 0.0),
     (0.3, "partition", "rack2", 1.0)],
    [(0.1, "partition", "rack2", 0.0), (5.0, "partition", "rack3", 0.1)],
]


def test_max_concurrent_cut_replay():
    def replay(NF):
        return [NF.max_concurrent_cut([]), *(
            NF.max_concurrent_cut([NF.LinkFaultEvent(t, k, tgt, recover_s=r)
                                   for t, k, tgt, r in case])
            for case in MAX_CUT_CASES)]

    assert replay(tnf) == replay(jnf) == [0, 2, 1, 1, 2]


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("max_cut", [0, 1, 2, 4])
def test_drawn_schedules_respect_cut_ceiling(seed, max_cut):
    def draw(NF, T):
        spec = T.rack_spine(4, 4, n_ps=1)
        s = NF.LinkFaultSchedule.random(
            spec, 4.0, seed=seed,
            partition_at=tuple(np.linspace(0.1, 3.5, 9)),
            switch_crash_at=tuple(np.linspace(0.2, 3.6, 9)),
            partition_heal_s=0.8, switch_recover_s=0.8, max_cut=max_cut)
        assert NF.max_concurrent_cut(s.events) <= min(max_cut,
                                                      spec.racks - 1)
        return _events(s)

    assert draw(tnf, ttopo) == draw(jnf, jtopo)


def test_netfault_schedule_from_config_wires_fields():
    def draw(NF, T, Cfg):
        cfg = Cfg(flap_rate=3.0, partition_at=(0.5,), partition_heal_s=0.2,
                  seed=9, degrade_rate=1.0, link_down_rate=2.0)
        return _events(NF.netfault_schedule_from_config(
            cfg, T.rack_spine(4, 4, n_ps=1), 2.0))

    got = draw(tnf, ttopo, NetFaultConfig)
    assert got == draw(jnf, jtopo, JNetFaultConfig)
    kinds = {e[1] for e in got}
    assert {"link_flap", "partition", "link_degrade", "link_down"} <= kinds
    part = [e for e in got if e[1] == "partition"][0]
    assert (part[0], part[3]) == (0.5, 0.2)


# ---------------------------------------------------------------------------
# pipe-level fault mechanics (generation fence, reroute, degrade)
# ---------------------------------------------------------------------------


def _pipe(S, sim, seed=0, loss=0.0):
    return S.Pipe(sim, 1e9, 1e-3, loss=loss, queue_pkts=64,
                  rng=np.random.default_rng(seed))


def _fence_and_reroute(S):
    """tests/test_netfaults.py's three pipe cases, as observations."""
    out = []
    sim = S.Sim()
    p = _pipe(S, sim)
    p.faultable = True
    got = []
    assert p.send(S.Packet(flow=0, seq=0, size=1500), got.append)
    sim.after(1e-4, lambda: p.set_up(False))     # down while in flight
    sim.run()
    out.append((len(got), p.n_dropped_down))      # fenced at arrival
    assert p.send(S.Packet(flow=0, seq=1, size=1500), got.append)
    sim.run()
    out.append((len(got), p.n_dropped_down))      # blackholed
    sim = S.Sim()
    p, bk = _pipe(S, sim, 0), _pipe(S, sim, 1)
    p.faultable = bk.faultable = True
    p.backup = bk
    p.set_up(False)
    got = []
    p.send(S.Packet(flow=0, seq=0, size=1500), got.append)
    sim.run()
    out.append((len(got), p.n_rerouted, bk.bytes_delivered, sim.now))
    bk.set_up(False)                              # partition
    p.send(S.Packet(flow=0, seq=1, size=1500), got.append)
    sim.run()
    out.append((len(got), p.n_dropped_down))
    p = _pipe(S, S.Sim())
    base = (p.rate, p.loss)
    p.set_degraded(rate_factor=0.25, extra_loss=0.1)
    out.append((p.rate, p.loss))
    p.clear_degraded()
    out.append((p.rate, p.loss) == base)
    return out


def test_pipe_fence_reroute_and_degrade():
    got = _fence_and_reroute(tsim)
    assert got == _fence_and_reroute(jsim)
    assert got[:2] == [(0, 1), (0, 2)]
    assert got[2][:2] == (1, 1) and got[2][2] > 0 and got[3] == (1, 1)
    assert got[4] == (pytest.approx(0.25e9), pytest.approx(0.1))
    assert got[5] is True


def _lazy_install(NF, S, T, Scen, Net):
    sim = S.Sim()
    spec = T.rack_spine(2, 2, n_ps=1)
    topo, _ = Scen._build_topology(sim, Net(*NET), 4, spec,
                                   np.random.default_rng(0))
    plane = NF.NetFaultPlane(sim, topo, spec, seed=0)
    before = (plane.installed, any(p.faultable for p in topo.pipes.values()))
    plane.dispatch(NF.LinkFaultEvent(0.0, "link_down", "rack1/up",
                                     recover_s=0.01))
    up = topo.pipes["rack1/up"]
    mid = (plane.installed, up.backup is not None, up.up, up.backup.up,
           plane.n_reroutes, sorted(topo.pipes))
    sim.run()
    return before, mid, (up.up, sim.now)


def test_plane_installs_lazily_and_builds_backups():
    got = _lazy_install(tnf, tsim, ttopo, tscen, NetConfig)
    assert got == _lazy_install(jnf, jsim, jtopo, jscen, JNetConfig)
    before, mid, after = got
    assert before == (False, False)
    assert mid[:5] == (True, True, False, True, 1)
    assert "rack1/backup" in mid[5] and after[0]   # auto-recovery fired


# ---------------------------------------------------------------------------
# the runtime: both packages from the same init
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: these runs launch many small ops, which
    several test processes sharing the cores slow down many times over
    when each op spreads over every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def apis():
    return (jbuild(jget_config("papernet").replace(**SMALL)),
            build(get_config("papernet").replace(**SMALL)))


def _chaos_schedule(NF):
    return NF.LinkFaultSchedule([
        NF.LinkFaultEvent(0.05, "link_flap", "rack2/up", period_s=0.02,
                          duty=0.5, duration_s=0.12),
        NF.LinkFaultEvent(0.10, "switch_crash", "rack1", recover_s=0.06),
        NF.LinkFaultEvent(0.20, "partition", "rack3", recover_s=0.15),
        NF.LinkFaultEvent(0.35, "link_degrade", "ps0/trunk",
                          rate_factor=0.5, extra_loss=0.02, recover_s=0.1),
    ])


def _partition(NF):
    return NF.LinkFaultSchedule([NF.LinkFaultEvent(0.08, "partition",
                                                   "rack1")])


class Case:
    """One DES run as tests/test_netfaults.py's ``_rt`` builds it: ``kw(P)``
    gives the runtime kwargs from a package tuple (``JAX`` or ``PORT``)."""

    def __init__(self, policy, kw=None, w=W, racks=2, n_ps=1, steps=STEPS,
                 seed=0):
        self.policy, self.kw = policy, kw or (lambda P: {})
        self.w, self.racks, self.n_ps = w, racks, n_ps
        self.steps, self.seed = steps, seed


def _budget(P, **kw):
    return P[1].BudgetController(**kw)


CASES = {
    "clean_bsp": Case("bsp"),
    "clean_async": Case("async"),
    "empty_bsp": Case("bsp", lambda P: dict(
        net_faults=P[0].LinkFaultSchedule([]))),
    "empty_async": Case("async", lambda P: dict(
        net_faults=P[0].LinkFaultSchedule([]))),
    "chaos16_bsp": Case("bsp", lambda P: dict(
        net_faults=_chaos_schedule(P[0]),
        budget=_budget(P, interval_s=0.03)), w=16, racks=4, n_ps=2,
        steps=4, seed=3),
    "chaos16_async": Case("async", lambda P: dict(
        net_faults=_chaos_schedule(P[0]),
        budget=_budget(P, interval_s=0.03)), w=16, racks=4, n_ps=2,
        steps=4, seed=3),
    "partition_bsp": Case("bsp", lambda P: dict(net_faults=_partition(P[0])),
                          seed=3),
    "partition_async": Case("async",
                            lambda P: dict(net_faults=_partition(P[0])),
                            seed=3),
    "budget_floor": Case("bsp", lambda P: dict(
        net_faults=_chaos_schedule(P[0]),
        budget=_budget(P, floor=0.7, step=0.1, interval_s=0.02)), w=16,
        racks=4, n_ps=2, steps=4, seed=3),
    "budget_clean": Case("bsp", lambda P: dict(
        budget=_budget(P, interval_s=0.05))),
    # the config form: a NetFaultConfig drawn at run time
    "config_bsp": Case("bsp", lambda P: dict(net_faults=P[2](
        flap_rate=4.0, flap_duration_s=0.06, degrade_rate=2.0, seed=4)),
        w=8, racks=2),
}


def _jax_rt(apis, c):
    jtc = JTrainConfig(batch=4 * c.w, lr=0.05, steps=c.steps)
    return jrun.ClusterRuntime(
        apis[0], jmake_optimizer(jtc), jtc, JLTPConfig(), JNetConfig(*NET),
        n_workers=c.w, policy=c.policy, compute_time=0.05, seed=c.seed,
        transport="des",
        topology=jtopo.rack_spine(c.racks, c.w // c.racks, n_ps=c.n_ps),
        **c.kw(JAX))


def _port_rt(apis, c, init):
    tc = TrainConfig(batch=4 * c.w, lr=0.05, steps=c.steps)
    return trun.ClusterRuntime(
        apis[1], make_optimizer(tc), tc, LTPConfig(), NetConfig(*NET),
        n_workers=c.w, policy=c.policy, compute_time=0.05, seed=c.seed,
        transport="des",
        topology=ttopo.rack_spine(c.racks, c.w // c.racks, n_ps=c.n_ps),
        device="cpu", params=params_from_numpy(init, "cpu"), **c.kw(PORT))


@pytest.fixture(scope="module")
def runs(apis):
    """``runs(name)`` -> (port runtime, JAX runtime) after their runs, one
    pair per case, shared by the file."""
    done = {}

    def get(name):
        if name not in done:
            c = CASES[name]
            jrt = _jax_rt(apis, c)
            init = jax.tree.map(np.asarray, jrt.params)
            jrt.run(jbatches(JSyntheticCIFAR(seed=0), 4 * c.w, c.steps))
            rt = _port_rt(apis, c, init)
            rt.run(batches(SyntheticCIFAR(seed=0), 4 * c.w, c.steps))
            done[name] = (rt, jrt, init)
        return done[name]

    return get


def _strip_loss(events):
    return [{k: v for k, v in e.items() if k != "loss"} for e in events]


def _assert_matches_jax(rt, jrt):
    assert len(rt.history) == len(jrt.history) > 0
    bsp = type(rt.policy).__name__ == "BSPPolicy"
    for a, b in zip(rt.history, jrt.history):
        assert set(a) == set(b)
        for k in a:
            if k == "loss":
                np.testing.assert_allclose(a[k], b[k], rtol=1e-4)
            elif k == "delivered" and bsp and "n_grads" not in a:
                np.testing.assert_allclose(a[k], b[k], rtol=1e-6)
            else:
                assert a[k] == b[k], (k, a[k], b[k])
    assert _strip_loss(rt.tel.events) == _strip_loss(jrt.tel.events)
    assert rt.net_des.flow_stats() == jrt.net_des.flow_stats()
    for x, y in zip(tree_leaves(rt.params),
                    jax.tree_util.tree_leaves(jrt.params), strict=True):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=2e-4,
                                   atol=2e-5)


def _assert_conservation(rt):
    """grad_ready == applied + stale + torn + lost + flow_dead."""
    tel = rt.tel
    applied = sum(e["n_grads"] for e in tel.of("apply"))
    assert len(tel.of("grad_ready")) == (
        applied + len(tel.of("stale_drop")) + len(tel.of("flow_torn"))
        + len(tel.of("ps_lost")) + len(tel.of("flow_dead")))


@pytest.mark.parametrize("name", list(CASES))
def test_netfault_runtime_matches_jax(runs, name):
    rt, jrt, _ = runs(name)
    _assert_matches_jax(rt, jrt)
    _assert_conservation(rt)
    assert not rt.sim.truncated
    if CASES[name].policy == "bsp":
        assert [r["step"] for r in rt.history] == list(range(rt.steps))
    plane, jplane = rt.netfault_plane, jrt.netfault_plane
    assert (plane is None) == (jplane is None)
    if plane is not None:
        assert (plane.n_reroutes, plane.n_blackholes) == \
            (jplane.n_reroutes, jplane.n_blackholes)
    if rt.budget is not None:
        assert rt.budget.pct == jrt.budget.pct
        assert (rt.budget.n_widen, rt.budget.n_narrow) == \
            (jrt.budget.n_widen, jrt.budget.n_narrow)
    assert rt.net_des.pct_eff == jrt.net_des.pct_eff


@pytest.mark.parametrize("policy", ["bsp", "async"])
def test_zero_netfault_run_is_record_identical(runs, policy):
    """An empty LinkFaultSchedule and no controller is a structural no-op
    in the port: pipes stay unfaulted, senders keep unhealed timing, and
    the history, telemetry and params equal the fault-unaware run's."""
    base, _, _ = runs(f"clean_{policy}")
    rt, _, _ = runs(f"empty_{policy}")
    assert base.history == rt.history
    assert base.tel.events == rt.tel.events
    assert rt.netfault_plane is None and base.net_faults is None
    assert len(rt.net_faults) == 0
    assert all(not p.faultable for p in rt.net_des.topo.pipes.values())
    for x, y in zip(tree_leaves(base.params), tree_leaves(rt.params)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("policy", ["bsp", "async"])
def test_chaos16_completes_conserves_and_replays(apis, runs, policy):
    name = f"chaos16_{policy}"
    rt, _, init = runs(name)
    assert all(np.isfinite(r["loss"]) for r in rt.history)
    s = rt.tel.summary()
    assert s["n_netfaults"] == len(_chaos_schedule(tnf))
    assert s["n_reroutes"] + s["n_blackholes"] > 0
    assert len(rt.tel.of("masks")) > 0
    again = _port_rt(apis, CASES[name], init)
    again.run(batches(SyntheticCIFAR(seed=0), 64, CASES[name].steps))
    assert again.history == rt.history
    assert again.tel.events == rt.tel.events


@pytest.mark.parametrize("policy", ["bsp", "async"])
def test_permanent_partition_aborts_flows_not_the_run(runs, policy):
    """A rack partitioned forever: its members' flows abort via RTO
    backoff and blackhole detection within bounded sim time, while the
    surviving racks finish training."""
    rt, _, _ = runs(f"partition_{policy}")
    dead = rt.tel.of("flow_dead")
    assert dead, "no flow_dead despite a permanent partition"
    assert min(e["t"] for e in dead) < 0.08 + 12.0
    assert rt.tel.summary()["n_flow_dead"] == len(dead)
    assert rt.net_des.flow_stats()["n_flow_dead"] > 0


def test_budget_controller_widens_under_distress_and_respects_floor(runs):
    rt, _, _ = runs("budget_floor")
    moves = rt.tel.of("budget")
    assert moves and any(m["direction"] == "widen" for m in moves)
    base = LTPConfig().data_pct_threshold
    for m in moves:
        assert 0.7 - 1e-9 <= m["pct"] <= base + 1e-9
    assert all(0.7 - 1e-9 <= v <= base + 1e-9 for v in rt.net_des.pct_eff)


def test_budget_controller_idle_on_clean_run(runs):
    """No distress, thresholds already at the ceiling: the controller
    does not move, and the run matches the controller-free twin."""
    base, _, _ = runs("clean_bsp")
    rt, _, _ = runs("budget_clean")
    assert rt.tel.of("budget") == []
    assert [r["loss"] for r in base.history] == \
        [r["loss"] for r in rt.history]


def test_budget_loss_read_stores_the_float(runs):
    """The controller's loss window reads each record's device scalar
    once and leaves the float in the record, the value the end of the
    run would store."""
    rt, _, _ = runs("budget_clean")
    rec = {"loss": torch.tensor(2.5)}
    assert trun.BudgetController._loss_of(rec) == 2.5
    assert rec == {"loss": 2.5}
    assert all(isinstance(r["loss"], float) for r in rt.history)


def _analytic(apis, **kw):
    tc = TrainConfig(batch=4 * W, lr=0.05, steps=2)
    return trun.ClusterRuntime(apis[1], make_optimizer(tc), tc, LTPConfig(),
                               NetConfig(*NET), n_workers=W,
                               transport="analytic", device="cpu", **kw)


def test_budget_controller_requires_des(apis):
    with pytest.raises(ValueError, match="transport='des'"):
        _analytic(apis, budget=trun.BudgetController())
    rt = _analytic(apis)
    with pytest.raises(ValueError, match="transport='des'"):
        trun.BudgetController().bind(rt)


def test_netfaults_require_des(apis):
    with pytest.raises(ValueError, match="transport='des'"):
        _analytic(apis, net_faults=trun.LinkFaultSchedule([]))
    with pytest.raises(ValueError, match="transport='des'"):
        _analytic(apis, net_faults=NetFaultConfig())
    with pytest.raises(TypeError, match="LinkFaultSchedule or"):
        _analytic(apis, net_faults=object())


# ---------------------------------------------------------------------------
# the des16 scenario: train/netfault.py against benchmarks/netfault_sweep.py
# ---------------------------------------------------------------------------

DES16_STEPS = 8


def test_des16_schedule_is_the_benchmarks():
    assert _events(tdes16.DES16_NETFAULTS) == _events(jdes16.DES16_NETFAULTS)


def test_des16_run_matches_the_jax_cells(apis, monkeypatch):
    """The three runs of ``train.netfault.run`` against the benchmark's
    ``_cell`` on the same params (the JAX init of seed 11): equal
    telemetry summaries, ``recovery_s`` and step counts; the rows' other
    fields (rounded in the benchmark) agree within its rounding."""
    cells, cell = [], tdes16.des16_cell

    def kept_cell(*a, **kw):
        cells.append(cell(*a, **kw))
        return cells[-1]

    monkeypatch.setattr(tdes16, "des16_cell", kept_cell)
    jtc = JTrainConfig(batch=64, lr=0.05, steps=DES16_STEPS)
    init = jax.tree.map(np.asarray, apis[0].init(jax.random.PRNGKey(11)))
    jcells = [jdes16._cell(apis[0], jtc, DES16_STEPS, **kw) for kw in (
        {}, {"net_faults": jdes16.DES16_NETFAULTS, "budget": True},
        {"net_faults": jdes16.DES16_NETFAULTS})]
    rows, metrics = tdes16.run(steps=DES16_STEPS, device="cpu",
                               params=params_from_numpy(init, "cpu"))
    assert [r["scenario"] for r in rows] == [
        "netfault_des16_free", "netfault_des16", "netfault_des16_nobudget"]
    assert [c[1] for c in cells] == rows
    for (rt, row), (jrt, jrow) in zip(cells, jcells, strict=True):
        assert rt.tel.summary() == jrt.tel.summary()
        for k in ("budget", "n_netfaults", "n_flow_dead", "n_reroutes",
                  "n_blackholes", "n_budget_moves", "recovery_s",
                  "n_steps_done"):
            assert row[k] == jrow[k], k
        assert round(row["simtime_s"], 4) == jrow["simtime_s"]
        assert round(row["goodput_steps_per_s"], 3) == \
            jrow["goodput_steps_per_s"]
        np.testing.assert_allclose(row["final_loss"], jrow["final_loss"],
                                   rtol=1e-4)
    on, off = rows[1], rows[2]
    assert on["n_netfaults"] > 0 and on["n_budget_moves"] > 0
    assert on["n_reroutes"] + on["n_blackholes"] > 0
    assert metrics["netfault_recovery_s"] == on["recovery_s"]
    assert metrics["netfault_goodput_ratio_off"] == \
        off["goodput_steps_per_s"] / rows[0]["goodput_steps_per_s"]
    assert metrics["netfault_n_budget_moves"] == on["n_budget_moves"]
