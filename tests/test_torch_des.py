"""The port's packet-level transport (``ClusterRuntime(transport="des")``
and ``PSTrainer(transport="des")``, on the CPU) against the JAX
package's, from the same params, batches and seeds, set up as
tests/test_runtime.py, tests/test_faults.py and tests/test_aggtree.py
set them up: bsp over ltp and cubic, async under a 3x straggler, bsp
over a rack/spine topology with in-network aggregation, the DES fault
cases (zero-fault pin, randomized churn, graceful leave, PS failover
with an npz checkpoint, crash plus failover with a shard rebalance over
two PS), the trainer entry point, and truncation safety.

The simulator is numpy on both sides, so every record's step, bst,
staleness, n_grads and sim_time, and the whole telemetry stream (the
``masks`` digests of the delivery masks, ``early_close`` and ``queue``
events among it; loss aside) agree exactly. ``delivered`` is exact on
async and degraded rounds (a host mean) and within rtol 1e-6 on full
bsp commits (the float32 mean of the same {0,1} masks, summed on the
device in another order). Losses agree within rtol 1e-4 and params
within rtol 2e-4 / atol 2e-5."""
import jax
import numpy as np
import pytest
import torch

import repro.net.topology as jtopo
import repro.runtime as jrun
from repro.config import LTPConfig as JLTPConfig
from repro.config import NetConfig as JNetConfig
from repro.config import ObservabilityConfig as JObservabilityConfig
from repro.config import TrainConfig as JTrainConfig
from repro.configs import get_config as jget_config
from repro.data import SyntheticCIFAR as JSyntheticCIFAR
from repro.data import batches as jbatches
from repro.models import build as jbuild
from repro.optim import make_optimizer as jmake_optimizer
from repro.train import PSTrainer as JPSTrainer
import repro_torch.net.topology as ttopo
import repro_torch.runtime as trun
from repro_torch.config import (
    LTPConfig,
    NetConfig,
    ObservabilityConfig,
    TrainConfig,
)
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.data import SyntheticCIFAR, batches
from repro_torch.models import build
from repro_torch.optim import make_optimizer
from repro_torch.runtime import ClusterRuntime
from repro_torch.train import PSTrainer
from repro_torch.tree import tree_leaves

SMALL = dict(d_model=8, n_layers=3)
NET = (10, 1, 0.001, 4096)


def _chaos(R):
    """tests/test_faults.py::test_chaos_churn_invariants's schedule."""
    return R.FaultSchedule.random(4, 0.45, seed=3, crash_rate=2.0,
                                  rejoin_after_s=0.11, leave_rate=0.5,
                                  min_active=2)


def _chaos11(R):
    """tests/test_faults.py::test_chaos_same_seed_bitwise_identical's."""
    return R.FaultSchedule.random(4, 0.4, seed=11, crash_rate=2.5,
                                  rejoin_after_s=0.09, min_active=2)


def _failover(R, t=0.16):
    return dict(faults=R.FaultSchedule([R.FaultEvent(t, "ps_fail",
                                                     target=0,
                                                     recover_s=0.05)]),
                checkpoint_every_s=0.05)


def _multi_ps_failover(R, T):
    return dict(faults=R.FaultSchedule([
        R.FaultEvent(0.055, "worker_crash", target=3),
        R.FaultEvent(0.17, "ps_fail", target=1, recover_s=0.05),
        R.FaultEvent(0.33, "ps_recover", target=1)]),
        checkpoint_every_s=0.05, topology=T.multi_ps(2))


class Case:
    """One DES run: W workers, ``steps`` steps of ``batch`` images;
    ``kw(R, T)`` gives the runtime kwargs from the package's runtime
    module R and topology module T."""

    def __init__(self, policy, kw=None, protocol="ltp", w=4, steps=5,
                 batch=32, net=NET, epoch_steps=0, ltp=None, npz=False,
                 obs=None, kernels=False):
        self.policy, self.protocol = policy, protocol
        self.kw = kw or (lambda R, T: {})
        self.w, self.steps, self.batch, self.net = w, steps, batch, net
        self.epoch_steps, self.ltp, self.npz, self.obs = (
            epoch_steps, ltp or {}, npz, obs)
        # the kernels' routes: the Pallas kernels in interpret mode, and
        # the port's "cuda" backend (its plain versions for CPU tensors)
        self.kernels = kernels


CASES = {
    # tests/test_runtime.py: the DES cases
    "bsp_ltp": Case("bsp", epoch_steps=3),
    "bsp_cubic": Case("bsp", protocol="cubic", epoch_steps=3),
    "async_straggler": Case("async", lambda R, T: dict(
        compute_model=R.DeterministicCompute(4, base=0.05,
                                             mults=[1.0, 1.0, 1.0, 3.0]))),
    # the card's configuration at a small width: count compensation and
    # error feedback over DES masks, with the kernels' routes
    "bsp_ltp_count_ef": Case("bsp", ltp=dict(compensation="count",
                                             error_feedback=True),
                             kernels=True),
    # per packet: ``coalesce=1`` turns the runtime's packet trains off
    "bsp_ltp_per_packet": Case("bsp", lambda R, T: dict(coalesce=1)),
    # a tracker: the trunk sampler's per-trunk arm and the flow counters
    "bsp_ltp_tracked": Case("bsp", obs="memory"),
    # tests/test_aggtree.py: the bsp gather rides the ToR merge tree
    "rack_spine_agg": Case("bsp", lambda R, T: dict(
        topology=T.rack_spine(2, 4, oversub=4.0, agg=True)),
        w=8, steps=2, net=(10, 1, 0.003, 4096)),
    # tests/test_faults.py: the DES cases (W=4, 6 steps of 16 images)
    "zero_fault": Case("bsp", lambda R, T: dict(
        faults=R.FaultSchedule([]), checkpoint_every_s=0.04),
        steps=6, batch=16),
    "chaos_bsp": Case("bsp", lambda R, T: dict(
        faults=_chaos(R), checkpoint_every_s=0.05), steps=6, batch=16),
    "chaos_async": Case("async", lambda R, T: dict(
        faults=_chaos(R), checkpoint_every_s=0.05), steps=6, batch=16),
    "chaos_ssp": Case("ssp", lambda R, T: dict(
        faults=_chaos(R), checkpoint_every_s=0.05,
        policy_kw={"staleness": 2}), steps=6, batch=16),
    "chaos_seed11_bsp": Case("bsp", lambda R, T: dict(
        faults=_chaos11(R)), steps=6, batch=16),
    "chaos_seed11_ssp": Case("ssp", lambda R, T: dict(
        faults=_chaos11(R), policy_kw={"staleness": 1}), steps=6, batch=16),
    "leave_bsp": Case("bsp", lambda R, T: dict(faults=R.FaultSchedule(
        [R.FaultEvent(0.06, "worker_leave", target=1)])), steps=6, batch=16),
    "failover_bsp_npz": Case("bsp", lambda R, T: _failover(R), steps=6,
                             batch=16, npz=True),
    "failover_multi_ps": Case("bsp", _multi_ps_failover, steps=6, batch=16),
    # the PS dies inside step 1's gather (0.1033-0.1066 s): the barrier's
    # pooled flows are torn down mid-flight (DESTransport.teardown_all)
    "failover_mid_gather": Case("bsp", lambda R, T: _failover(R, 0.105),
                                steps=6, batch=16),
}


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
def jax_runs():
    """One JAX run per case, shared by every test of this file."""
    return {}


@pytest.fixture(scope="module")
def apis():
    return (jbuild(jget_config("papernet").replace(**SMALL)),
            build(get_config("papernet").replace(**SMALL)))


def _ckpt_kw(c, name, tmp_path_factory):
    if not c.npz:
        return {}
    return {"checkpoint_dir": str(tmp_path_factory.mktemp(name))}


def _jax(jax_runs, apis, name, tmp_path_factory):
    if name not in jax_runs:
        c = CASES[name]
        jtc = JTrainConfig(batch=c.batch, lr=0.05, steps=c.steps)
        obs = None if c.obs is None else JObservabilityConfig(tracker=c.obs)
        jrt = jrun.ClusterRuntime(
            apis[0], jmake_optimizer(jtc), jtc,
            JLTPConfig(**c.ltp,
                       **({"sync_backend": "pallas"} if c.kernels else {})),
            JNetConfig(*c.net), n_workers=c.w, protocol=c.protocol,
            policy=c.policy, compute_time=0.05, seed=0, transport="des",
            obs=obs, **c.kw(jrun, jtopo),
            **_ckpt_kw(c, name, tmp_path_factory))
        init = jax.tree.map(np.asarray, jrt.params)
        jrt.run(jbatches(JSyntheticCIFAR(seed=0), c.batch, c.steps),
                epoch_steps=c.epoch_steps)
        jax_runs[name] = (init, jrt)
    return jax_runs[name]


def _port(apis, name, init, tmp_path_factory, **extra):
    c = CASES[name]
    tc = TrainConfig(batch=c.batch, lr=0.05, steps=c.steps)
    obs = None if c.obs is None else ObservabilityConfig(tracker=c.obs)
    kw = {**c.kw(trun, ttopo), **_ckpt_kw(c, name, tmp_path_factory),
          **extra}
    rt = ClusterRuntime(
        apis[1], make_optimizer(tc), tc,
        LTPConfig(**c.ltp, **({"sync_backend": "cuda"} if c.kernels else {})),
        NetConfig(*c.net), n_workers=c.w, protocol=c.protocol,
        policy=c.policy, compute_time=0.05, seed=0, transport="des",
        obs=obs, device="cpu", params=params_from_numpy(init, "cpu"), **kw)
    rt.run(batches(SyntheticCIFAR(seed=0), c.batch, c.steps),
           epoch_steps=c.epoch_steps)
    return rt


def _strip_loss(events):
    return [{k: v for k, v in e.items() if k != "loss"} for e in events]


def _assert_matches_jax(rt, jrt):
    """History: step/bst/staleness/n_grads/sim_time exactly, delivered
    exactly (rtol 1e-6 on full bsp commits), loss rtol 1e-4. Telemetry
    (loss aside) exactly. Params rtol 2e-4 / atol 2e-5."""
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
    for x, y in zip(tree_leaves(rt.params),
                    jax.tree_util.tree_leaves(jrt.params), strict=True):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=2e-4,
                                   atol=2e-5)


def _assert_conservation(rt):
    """Every grad_ready is applied, stale-dropped, torn or lost."""
    tel = rt.tel
    applied = sum(e["n_grads"] for e in tel.of("apply"))
    assert len(tel.of("grad_ready")) == (
        applied + len(tel.of("stale_drop")) + len(tel.of("flow_torn"))
        + len(tel.of("ps_lost")))


@pytest.fixture
def port_run(jax_runs, apis, tmp_path_factory):
    """``port_run(name)`` -> a port runtime after its run, from the
    params the JAX run of ``name`` started from."""
    def make(name, **extra):
        init, _ = _jax(jax_runs, apis, name, tmp_path_factory)
        return _port(apis, name, init, tmp_path_factory, **extra)

    return make


@pytest.fixture(scope="module")
def pairs():
    """One checked (port, JAX) pair per case, shared by the file."""
    return {}


@pytest.fixture
def pair(pairs, jax_runs, apis, tmp_path_factory, port_run):
    """``pair(name)`` -> (port runtime after its run, JAX runtime),
    already held against each other."""
    def make(name):
        if name not in pairs:
            rt = port_run(name)
            jrt = _jax(jax_runs, apis, name, tmp_path_factory)[1]
            _assert_matches_jax(rt, jrt)
            _assert_conservation(rt)
            pairs[name] = (rt, jrt)
        return pairs[name]

    return make


@pytest.mark.parametrize("name", list(CASES))
def test_des_runtime_matches_jax(pair, name):
    rt, jrt = pair(name)
    assert not rt.sim.truncated
    assert rt.net_des is not None and rt.anet is None
    assert rt.net_des.coalesce == jrt.net_des.coalesce
    assert rt.net_des.flow_stats() == jrt.net_des.flow_stats()
    if CASES[name].policy == "bsp":
        assert [r["step"] for r in rt.history] == list(range(rt.steps))


def test_des_bsp_masks_and_trunk_sampler(pair):
    """A masks digest per committed round, partial LTP delivery, and the
    trunk-queue sampler ran (tests/test_runtime.py::test_des_bsp_cosim)."""
    rt, _ = pair("bsp_ltp")
    assert len(rt.tel.of("masks")) == len(rt.history) == 5
    assert all(0.0 < r["delivered"] <= 1.0 for r in rt.history)
    net = [e for e in rt.tel.of("queue") if "net_depth" in e]
    assert net and max(e["net_depth"] for e in net) > 0
    assert all("trunks" not in e for e in net)     # tracker off


def test_des_tracked_run_samples_every_trunk(pair):
    rt, _ = pair("bsp_ltp_tracked")
    net = rt.tel.of("queue")
    assert net and all(len(e["trunks"]) == rt.n_ps for e in net)
    snap = rt.metrics.snapshot()
    assert any(k.startswith("flow/") for k in snap)


def test_des_per_packet_run_sends_no_trains(pair):
    rt, _ = pair("bsp_ltp_per_packet")
    assert rt.net_des.coalesce == 1
    assert rt.net_des.flow_stats()["n_ack_trains"] == 0
    assert pair("bsp_ltp")[0].net_des.coalesce > 1


def test_des_cubic_delivers_everything(pair):
    rt, _ = pair("bsp_cubic")
    assert all(r["delivered"] == 1.0 for r in rt.history)
    assert rt.tel.of("masks") == [] and rt.tel.of("early_close") == []


def test_des_async_early_closes_per_flow(pair):
    """tests/test_runtime.py::test_des_async_cosim: per-flow Early Close
    fires and some applies fold partial masks."""
    rt, _ = pair("async_straggler")
    assert sum(r["n_grads"] for r in rt.history) == 4 * 5
    assert rt.tel.of("early_close")
    assert any(r["delivered"] < 1.0 for r in rt.history)
    # one masks digest per delivered gradient
    assert len(rt.tel.of("masks")) == 4 * 5


def test_des_rack_spine_merges_at_the_tors(pair):
    rt, jrt = pair("rack_spine_agg")
    merged = sum(sw.n_merged for sw in rt.net_des.topo.aggs.values())
    assert merged > 0 and merged == sum(
        sw.n_merged for sw in jrt.net_des.topo.aggs.values())


def test_des_zero_fault_run_is_record_identical(pair, port_run):
    """An armed-but-empty fault layer is a structural no-op on the DES
    transport too: the same history and params as a fault-unaware run."""
    rt, _ = pair("zero_fault")
    # the same case with the fault layer left out
    base = port_run("zero_fault", faults=None, checkpoint_every_s=0.0)
    assert base.faults is None and base.tel.of("checkpoint") == []
    assert base.history == rt.history
    for x, y in zip(tree_leaves(base.params), tree_leaves(rt.params)):
        assert torch.equal(x, y)
    assert len(rt.tel.of("checkpoint")) > 1


@pytest.mark.parametrize("name", ["chaos_bsp", "chaos_async", "chaos_ssp"])
def test_des_chaos_churn_shows_real_churn(pair, name):
    rt, _ = pair(name)
    assert 1 <= rt.tel.summary()["n_faults"]
    assert "dead" in {e["state"] for e in rt.tel.of("lifecycle")}


@pytest.mark.parametrize("name", ["chaos_seed11_bsp", "chaos_seed11_ssp"])
def test_des_chaos_same_seed_replays_bitwise(pair, port_run, name):
    rt, _ = pair(name)
    again = port_run(name)
    assert again.history == rt.history
    assert again.tel.events == rt.tel.events


def test_des_graceful_leave_never_tears_flows(pair):
    rt, _ = pair("leave_bsp")
    assert rt.tel.of("flow_torn") == []
    leaves = [e for e in rt.tel.of("lifecycle") if e["state"] == "dead"]
    assert leaves and leaves[0]["reason"] == "leave"


def test_des_ps_failover_restores_and_completes(pair):
    rt, _ = pair("failover_bsp_npz")
    assert len(rt.tel.of("ps_failover")) == 1
    assert len(rt.tel.of("ps_lost")) > 0
    fo = rt.tel.of("ps_failover")[0]
    assert fo["n_hist"] <= fo["step"] + 1


def test_des_crash_plus_failover_rebalances_shards(pair):
    """The failover re-homes PS1's shard onto PS0 and the recovery moves
    it back (``DESTransport.set_shard_owners``), as in the JAX run."""
    rt, _ = pair("failover_multi_ps")
    reb = rt.tel.of("rebalance")
    assert [list(e["owner"]) for e in reb] == [[0, 0], [0, 1]]
    assert rt.net_des.owner == [0, 1]


def test_pstrainer_des_matches_jax():
    """The entry point: ``PSTrainer(transport="des")`` reaches the DES
    runtime in both packages and their histories agree."""
    jtc = JTrainConfig(batch=32, lr=0.05, steps=3)
    jtr = JPSTrainer(jbuild(jget_config("papernet").replace(**SMALL)),
                     jmake_optimizer(jtc), jtc, JLTPConfig(),
                     JNetConfig(*NET), n_workers=4, seed=0,
                     transport="des")
    init = jax.tree.map(np.asarray, jtr.params)
    jh = jtr.run(jbatches(JSyntheticCIFAR(seed=0), 32, 3))
    tc = TrainConfig(batch=32, lr=0.05, steps=3)
    tr = PSTrainer(build(get_config("papernet").replace(**SMALL)),
                   make_optimizer(tc), tc, LTPConfig(), NetConfig(*NET),
                   n_workers=4, seed=0, transport="des", device="cpu",
                   params=params_from_numpy(init, "cpu"))
    h = tr.run(batches(SyntheticCIFAR(seed=0), 32, 3))
    assert tr._rt.net_des is not None
    assert len(h) == len(jh) == 3
    for a, b in zip(h, jh):
        assert {k: a[k] for k in ("step", "bst", "sim_time")} == \
            {k: b[k] for k in ("step", "bst", "sim_time")}
        np.testing.assert_allclose(a["delivered"], b["delivered"],
                                   rtol=1e-6)
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-4)
    assert _strip_loss(tr.telemetry.events) == _strip_loss(
        jtr.telemetry.events)


def test_des_truncation_raises(apis):
    tc = TrainConfig(batch=32, lr=0.05, steps=5)
    rt = ClusterRuntime(apis[1], make_optimizer(tc), tc, LTPConfig(),
                        NetConfig(*NET), n_workers=4, seed=0,
                        transport="des", device="cpu")
    with pytest.warns(RuntimeWarning, match="max_events"):
        with pytest.raises(RuntimeError, match="truncated"):
            rt.run(batches(SyntheticCIFAR(seed=0), 32, 5), max_events=50)
