"""Elastic fault-injected clusters on the port's runtime (analytic
transport, on the CPU) against the JAX package's, as tests/test_faults.py
sets them up: the zero-fault pin, worker crash/leave/rejoin, PS failover
from periodic snapshots with and without an npz checkpoint, the async
rollback, randomized churn across {bsp, async, ssp}, and the checkpoint
archives crossing between the two packages.

Each faulted case runs once in each package from the same params, and
the port must reproduce the JAX run: every record's step, bst,
staleness, n_grads and sim_time and the whole telemetry stream exactly
(loss aside), loss within rtol 1e-4 and params within rtol 2e-4 /
atol 2e-5. The invariants of tests/test_faults.py hold on top:

  * conservation — every grad_ready is applied, stale-dropped, torn
    (crash fencing) or lost (PS downtime); nothing vanishes silently
  * no partial history — every record carries its full schema with a
    finite loss, and bsp histories are step-contiguous
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.runtime as jrun
from repro.checkpoint import restore_checkpoint as jrestore
from repro.checkpoint import save_checkpoint as jsave
from repro.config import FaultConfig as JFaultConfig
from repro.config import LTPConfig as JLTPConfig
from repro.config import NetConfig as JNetConfig
from repro.config import TrainConfig as JTrainConfig
from repro.configs import get_config as jget_config
from repro.data import SyntheticCIFAR as JSyntheticCIFAR
from repro.data import batches as jbatches
from repro.models import build as jbuild
from repro.optim import make_optimizer as jmake_optimizer
import repro_torch.runtime as trun
from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.config import FaultConfig, LTPConfig, NetConfig, TrainConfig
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.data import SyntheticCIFAR, batches
from repro_torch.models import build
from repro_torch.optim import make_optimizer
from repro_torch.runtime import (
    ClusterRuntime,
    FaultEvent,
    FaultSchedule,
    ShardLedger,
    schedule_from_config,
)
from repro_torch.tree import tree_leaves

NET = (10, 1, 0.001, 4096)
SLOW_NET = (0.01, 1, 0.001, 4096)   # most async flows Early-Close
W = 4
STEPS = 6
SMALL = dict(d_model=8, n_layers=3)


def _chaos(R):
    return R.FaultSchedule.random(W, 0.45, seed=3, crash_rate=2.0,
                                  rejoin_after_s=0.11, leave_rate=0.5,
                                  min_active=2)


# name -> (policy, runtime kwargs given the package's runtime module R,
# net, LTPConfig kwargs)
CASES = {
    "crash_bsp": ("bsp", lambda R: dict(faults=R.FaultSchedule(
        [R.FaultEvent(0.055, "worker_crash", target=2)])), NET, {}),
    "leave_bsp": ("bsp", lambda R: dict(faults=R.FaultSchedule(
        [R.FaultEvent(0.06, "worker_leave", target=1)])), NET, {}),
    "rejoin_bsp": ("bsp", lambda R: dict(
        faults=R.FaultSchedule([
            R.FaultEvent(0.055, "worker_crash", target=0),
            R.FaultEvent(0.12, "worker_join", target=0)]),
        compute_model=R.DeterministicCompute(W, base=0.05,
                                             rejoin_penalty_s=0.02)),
        NET, {}),
    "failover_bsp": ("bsp", lambda R: dict(
        faults=R.FaultSchedule([R.FaultEvent(0.16, "ps_fail", target=0,
                                             recover_s=0.05)]),
        checkpoint_every_s=0.05), NET, {}),
    "failover_bsp_npz": ("bsp", lambda R: dict(
        faults=R.FaultSchedule([R.FaultEvent(0.16, "ps_fail", target=0,
                                             recover_s=0.05)]),
        checkpoint_every_s=0.05), NET, {}),
    "rollback_async": ("async", lambda R: dict(
        faults=R.FaultSchedule([R.FaultEvent(0.15, "ps_fail", target=0,
                                             recover_s=0.04)]),
        checkpoint_every_s=0.04), NET, {}),
    # error feedback on partial masks, then a failover: the residual
    # comes back as the snapshot held it
    "rollback_async_ef": ("async", lambda R: dict(
        faults=R.FaultSchedule([R.FaultEvent(0.47, "ps_fail", target=0,
                                             recover_s=0.02)]),
        checkpoint_every_s=0.1), SLOW_NET, dict(error_feedback=True)),
    "chaos_bsp": ("bsp", lambda R: dict(faults=_chaos(R),
                                        checkpoint_every_s=0.05), NET, {}),
    "chaos_async": ("async", lambda R: dict(faults=_chaos(R),
                                            checkpoint_every_s=0.05),
                    NET, {}),
    "chaos_ssp": ("ssp", lambda R: dict(faults=_chaos(R),
                                        checkpoint_every_s=0.05,
                                        policy_kw={"staleness": 2}),
                  NET, {}),
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
def jax_api():
    return jbuild(jget_config("papernet").replace(**SMALL))


@pytest.fixture(scope="module")
def port_api():
    return build(get_config("papernet").replace(**SMALL))


@pytest.fixture(scope="module")
def jax_runs():
    """One JAX run per case, shared by every test of this file."""
    return {}


def _ckpt_kw(name, tmp_path_factory):
    if not name.endswith("_npz"):
        return {}
    return {"checkpoint_dir": str(tmp_path_factory.mktemp(name))}


def _jax(jax_runs, jax_api, name, tmp_path_factory):
    if name not in jax_runs:
        policy, kw, net, lkw = CASES[name]
        jtc = JTrainConfig(batch=4 * W, lr=0.05, steps=STEPS)
        jrt = jrun.ClusterRuntime(
            jax_api, jmake_optimizer(jtc), jtc, JLTPConfig(**lkw),
            JNetConfig(*net), n_workers=W, policy=policy, compute_time=0.05,
            seed=0, **kw(jrun), **_ckpt_kw(name, tmp_path_factory))
        init = jax.tree.map(np.asarray, jrt.params)
        jrt.run(jbatches(JSyntheticCIFAR(seed=0), 4 * W, STEPS))
        jax_runs[name] = (init, jrt)
    return jax_runs[name]


def _port(port_api, name, init, tmp_path_factory, **extra):
    policy, kw, net, lkw = CASES[name]
    tc = TrainConfig(batch=4 * W, lr=0.05, steps=STEPS)
    rt = ClusterRuntime(
        port_api, make_optimizer(tc), tc, LTPConfig(**lkw), NetConfig(*net),
        n_workers=W, policy=policy, compute_time=0.05, seed=0, device="cpu",
        params=params_from_numpy(init, "cpu"), **kw(trun),
        **_ckpt_kw(name, tmp_path_factory), **extra)
    return rt


def _run(rt):
    return rt.run(batches(SyntheticCIFAR(seed=0), 4 * W, STEPS))


def _event_tuple(ev):
    return (ev.t, ev.kind, ev.target, ev.recover_s)


def _strip_loss(events):
    return [{k: v for k, v in e.items() if k != "loss"} for e in events]


def _assert_matches_jax(rt, jrt):
    assert len(rt.history) == len(jrt.history) > 0
    for a, b in zip(rt.history, jrt.history):
        assert set(a) == set(b)
        for k in a:
            if k == "loss":
                np.testing.assert_allclose(a[k], b[k], rtol=1e-4)
            elif k == "delivered" and "n_grads" not in a:
                # a full bsp commit: the float32 mean of the same {0,1}
                # masks on the device, summed in another order
                np.testing.assert_allclose(a[k], b[k], rtol=1e-6)
            else:
                assert a[k] == b[k], (k, a[k], b[k])
    assert _strip_loss(rt.tel.events) == _strip_loss(jrt.tel.events)
    for x, y in zip(tree_leaves(rt.params),
                    jax.tree_util.tree_leaves(jrt.params), strict=True):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=2e-4,
                                   atol=2e-5)


def _assert_conservation(rt):
    """Every grad_ready resolves exactly once (telemetry docstring)."""
    tel = rt.tel
    n_ready = len(tel.of("grad_ready"))
    applied = sum(e["n_grads"] for e in tel.of("apply"))
    n_stale = len(tel.of("stale_drop"))
    n_torn = len(tel.of("flow_torn"))
    n_lost = len(tel.of("ps_lost"))
    assert n_ready == applied + n_stale + n_torn + n_lost, (
        n_ready, applied, n_stale, n_torn, n_lost)


def _assert_complete_history(rt, policy):
    for r in rt.history:
        assert np.isfinite(r["loss"])
        assert {"step", "loss", "sim_time"} <= set(r)
    if policy == "bsp":
        # bsp commits are sequential: churn may degrade a round but can
        # never skip or duplicate an iteration
        assert [r["step"] for r in rt.history] == list(range(rt.steps))


@pytest.fixture
def pair(jax_runs, jax_api, port_api, tmp_path_factory):
    """``pair(name)`` -> (port runtime after its run, JAX runtime),
    already held against each other and checked for the invariants."""
    def make(name, **extra):
        init, jrt = _jax(jax_runs, jax_api, name, tmp_path_factory)
        rt = _port(port_api, name, init, tmp_path_factory, **extra)
        _run(rt)
        _assert_matches_jax(rt, jrt)
        _assert_conservation(rt)
        _assert_complete_history(rt, CASES[name][0])
        return rt, jrt

    return make


# ---------------------------------------------------------------------------
# the zero-fault pin
# ---------------------------------------------------------------------------


def test_zero_fault_run_is_record_identical(port_api):
    """An armed-but-empty fault layer (schedule, snapshot grid, ledger,
    flight registry, epoch fences) is a structural no-op: history and
    final params match the fault-unaware runtime bitwise."""
    tc = TrainConfig(batch=4 * W, lr=0.05, steps=STEPS)

    def make(**kw):
        return ClusterRuntime(port_api, make_optimizer(tc), tc, LTPConfig(),
                              NetConfig(*NET), n_workers=W, seed=0,
                              device="cpu", **kw)

    base, rt = make(), make(faults=FaultSchedule([]),
                            checkpoint_every_s=0.04)
    h0, h1 = _run(base), _run(rt)
    assert len(h0) == len(h1) == STEPS
    assert h0 == h1
    for x, y in zip(tree_leaves(base.params), tree_leaves(rt.params)):
        assert torch.equal(x, y)
    assert len(rt.tel.of("checkpoint")) > 1      # the grid did run


# ---------------------------------------------------------------------------
# worker churn
# ---------------------------------------------------------------------------


def test_bsp_crash_degrades_round_then_rebarriers(pair):
    """A mid-round crash with no rejoin: that iteration commits over the
    survivors (weight W/n keeps the update an unbiased mean), later
    rounds re-barrier on the surviving set, and the run completes."""
    rt, _ = pair("crash_bsp")
    degraded = [r for r in rt.history if r.get("n_grads", W) < W]
    assert degraded and all(r["n_grads"] == W - 1 for r in degraded)
    assert len(rt.tel.of("flow_torn")) <= 1


def test_bsp_graceful_leave_never_tears_flows(pair):
    rt, _ = pair("leave_bsp")
    assert rt.tel.of("flow_torn") == []          # drain, don't tear
    leaves = [e for e in rt.tel.of("lifecycle") if e["state"] == "dead"]
    assert leaves and leaves[0]["reason"] == "leave"


def test_worker_rejoin_pays_warmup_penalty(pair):
    rt, _ = pair("rejoin_bsp")
    joins = [e for e in rt.tel.of("lifecycle") if e["state"] == "joining"]
    assert len(joins) == 1
    # the joiner's first compute back carries the warm-up penalty
    post = [e for e in rt.tel.of("compute_start")
            if e["worker"] == 0 and e["t"] >= 0.12]
    assert post and abs(post[0]["dt"] - 0.07) < 1e-9


@pytest.mark.parametrize("policy", ["bsp", "async", "ssp"])
def test_chaos_churn_invariants(pair, policy):
    rt, _ = pair(f"chaos_{policy}")
    assert 1 <= rt.tel.summary()["n_faults"] <= len(rt.faults)
    states = {e["state"] for e in rt.tel.of("lifecycle")}
    assert "dead" in states


def test_fault_config_draws_the_jax_schedule(port_api):
    """A FaultConfig is drawn into the JAX package's schedule at run()."""
    kw = dict(crash_rate=2.0, rejoin_after_s=0.1, ps_fail_at=(0.2,),
              ps_recovery_s=0.03, checkpoint_every_s=0.05, min_active=2,
              seed=3)
    tc = TrainConfig(batch=4 * W, lr=0.05, steps=STEPS)
    rt = ClusterRuntime(port_api, make_optimizer(tc), tc, LTPConfig(),
                        NetConfig(*NET), n_workers=W, seed=0, device="cpu",
                        faults=FaultConfig(**kw))
    assert rt._ckpt_every == 0.05
    _run(rt)
    _assert_conservation(rt)
    _assert_complete_history(rt, "bsp")
    jsched = jrun.schedule_from_config(JFaultConfig(**kw), W,
                                       max(STEPS * 0.05 * 3.0, 1.0))
    assert [_event_tuple(e) for e in rt.faults] == \
        [_event_tuple(e) for e in jsched]
    assert len(rt.tel.of("ps_failover")) == 1


# ---------------------------------------------------------------------------
# PS failover from periodic snapshots
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["failover_bsp", "failover_bsp_npz"])
def test_ps_failover_restores_and_completes(pair, name):
    rt, _ = pair(name)
    assert len(rt.tel.of("ps_failover")) == 1
    assert len(rt.tel.of("ps_lost")) > 0         # downtime really cost us
    fo = rt.tel.of("ps_failover")[0]
    # history was truncated to the snapshot frontier and rebuilt
    assert fo["n_hist"] <= fo["step"] + 1
    assert [r["step"] for r in rt.history] == list(range(STEPS))
    if name.endswith("_npz"):
        assert os.path.exists(os.path.join(rt._ckpt_dir, "runtime_ckpt.npz"))


def test_ps_failover_async_rolls_back_and_continues(pair):
    rt, _ = pair("rollback_async")
    assert len(rt.tel.of("ps_failover")) == 1
    # record stream stays step-monotonic across the rollback splice
    steps = [r["step"] for r in rt.history]
    assert steps == sorted(steps)


def test_failover_restores_the_snapshots_residual(pair, monkeypatch):
    """Async with error feedback: gradients applied after the last
    snapshot change the residual; the failover must bring back the
    residual the snapshot held. A residual written in place
    (``residual[w] = ...``) would change the snapshot with it."""
    taken, at_fail, restored = [], [], []
    orig_snap = ClusterRuntime._take_snapshot
    orig_fail = ClusterRuntime._fault_ps_fail
    orig_over = ClusterRuntime._ps_failover

    def snap(self):
        orig_snap(self)
        taken.append((self.sim.now, self.residual.clone()))

    def fail(self, ps, recover_s):
        at_fail.append((self.sim.now, self.residual.clone()))
        orig_fail(self, ps, recover_s)

    def over(self, ps):
        orig_over(self, ps)
        restored.append((self.sim.now, self.residual.clone()))

    monkeypatch.setattr(ClusterRuntime, "_take_snapshot", snap)
    monkeypatch.setattr(ClusterRuntime, "_fault_ps_fail", fail)
    monkeypatch.setattr(ClusterRuntime, "_ps_failover", over)
    rt, jrt = pair("rollback_async_ef")
    (t_fail, res_fail), = at_fail
    (t_back, res_back), = restored
    t_snap, res_snap = [s for s in taken if s[0] <= t_back][-1]
    # the snapshot the failover restores predates applies that moved the
    # residual before the failure
    applies = [e for e in rt.tel.of("apply") if t_snap < e["t"] < t_fail]
    assert applies and not torch.equal(res_fail, res_snap)
    assert res_snap.abs().sum() > 0              # partial masks: EF is live
    assert torch.equal(res_back, res_snap)
    np.testing.assert_allclose(rt.residual.numpy(), np.asarray(jrt.residual),
                               rtol=2e-4, atol=2e-5)


def test_ps_fail_without_snapshot_raises(port_api):
    tc = TrainConfig(batch=4 * W, lr=0.05, steps=STEPS)
    rt = ClusterRuntime(port_api, make_optimizer(tc), tc, LTPConfig(),
                        NetConfig(*NET), n_workers=W, seed=0, device="cpu",
                        faults=FaultSchedule([FaultEvent(0.1, "ps_fail",
                                                         recover_s=0.01)]))
    # defeat the automatic t=0 anchor to prove the guard exists
    rt._take_snapshot = lambda: None
    with pytest.raises(RuntimeError, match="no snapshot"):
        _run(rt)


# ---------------------------------------------------------------------------
# schedule / ledger units (numpy; the JAX package's own draws)
# ---------------------------------------------------------------------------


def test_fault_event_validation():
    with pytest.raises(ValueError, match="unknown fault kind"):
        FaultEvent(0.1, "meteor")
    with pytest.raises(ValueError, match="must be >= 0"):
        FaultEvent(-1.0, "worker_crash")
    with pytest.raises(TypeError):
        FaultSchedule([("not", "an", "event")])


@pytest.mark.parametrize("kw", [
    dict(crash_rate=1.0, rejoin_after_s=0.2),
    dict(crash_rate=4.0, leave_rate=2.0, min_active=2),
    dict(crash_rate=2.5, rejoin_after_s=0.09, min_active=2, seed=11)])
def test_random_schedules_are_the_jax_packages(kw):
    kw = dict(kw)
    seed = kw.pop("seed", 5)
    s = FaultSchedule.random(8, 2.0, seed=seed, **kw)
    js = jrun.FaultSchedule.random(8, 2.0, seed=seed, **kw)
    assert len(s) > 0
    assert [_event_tuple(e) for e in s] == [_event_tuple(e) for e in js]
    assert [e.label() for e in s] == [e.label() for e in js]


def test_schedule_from_config_wires_fields():
    cfg = FaultConfig(crash_rate=2.0, rejoin_after_s=0.5, ps_fail_at=(1.0,),
                      ps_recovery_s=0.1, min_active=1, seed=9)
    s = schedule_from_config(cfg, 4, 3.0)
    ps = [e for e in s if e.kind == "ps_fail"][0]
    assert ps.t == 1.0 and ps.recover_s == 0.1


def test_shard_ledger_failover_and_recover():
    led, jled = ShardLedger(4), jrun.ShardLedger(4)
    for op, ps in (("fail", 2), ("fail", 2), ("fail", 0), ("recover", 2),
                   ("recover", 0)):
        assert getattr(led, op)(ps) == getattr(jled, op)(ps)
        assert led.owner == jled.owner and led.n_alive == jled.n_alive
    assert led.owner == [0, 1, 2, 3] and led.n_alive == 4


# ---------------------------------------------------------------------------
# checkpoints cross between the packages
# ---------------------------------------------------------------------------


def _model_and_opt(adamw=False):
    """The same small papernet + optimizer state in both packages (the
    port's from the JAX init, then one update so no leaf is zero)."""
    tc = TrainConfig(batch=8, lr=0.1, steps=1,
                     optimizer="adamw" if adamw else "sgdm")
    jtc = JTrainConfig(batch=8, lr=0.1, steps=1,
                       optimizer="adamw" if adamw else "sgdm")
    japi = jbuild(jget_config("papernet").replace(d_model=8, n_layers=2))
    jparams = japi.init(jax.random.PRNGKey(0))
    jopt = jmake_optimizer(jtc)
    jstate = jopt.init(jparams)
    grads = jax.tree.map(lambda p: jnp.full_like(p, 0.01), jparams)
    _, jstate = jopt.update(grads, jstate, jparams, 0.1)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    state = params_from_numpy(jax.tree.map(np.asarray, jstate), "cpu")
    return {"params": jparams, "opt_state": jstate}, \
        {"params": params, "opt_state": state}, make_optimizer(tc)


@pytest.mark.parametrize("adamw", [False, True])
def test_checkpoint_jax_to_port(tmp_path, adamw):
    jtree, tree, opt = _model_and_opt(adamw)
    path = str(tmp_path / "jax_ck")
    jsave(path, jtree, step=3)
    like = {"params": tree["params"],
            "opt_state": opt.init(tree["params"])}
    got, step = restore_checkpoint(path, like)
    assert step == 3
    for a, b, old in zip(tree_leaves(got), jax.tree_util.tree_leaves(jtree),
                         tree_leaves(like), strict=True):
        assert isinstance(a, torch.Tensor) and a.dtype == old.dtype
        assert a.device == old.device
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("adamw", [False, True])
def test_checkpoint_port_to_jax(tmp_path, adamw):
    jtree, tree, _ = _model_and_opt(adamw)
    path = str(tmp_path / "port_ck")
    save_checkpoint(path, tree, step=7)
    with np.load(path + ".npz") as a:
        port_keys = set(a.files)
    jsave(str(tmp_path / "jax_ck"), jtree, step=7)
    with np.load(str(tmp_path / "jax_ck.npz")) as a:
        assert port_keys == set(a.files)          # the same key paths
    got, step = jrestore(path, jtree)
    assert step == 7
    for a, b in zip(jax.tree_util.tree_leaves(got), tree_leaves(tree),
                    strict=True):
        assert a.dtype == jnp.asarray(b.numpy()).dtype
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_checkpoint_round_trip_identity(tmp_path):
    path = str(tmp_path / "ck")
    tree = {"params": {"w": torch.arange(6.0).reshape(2, 3),
                       "b": torch.zeros(3)},
            "opt": {"mu": {"w": torch.full((2, 3), 0.5)},
                    "count": torch.tensor(7)},
            "layers": [{"w": torch.ones(2)}, {"w": torch.full((2,), 2.0)}]}
    save_checkpoint(path, tree, step=42)
    # `like` carries structure, dtypes and devices only; its values must
    # not leak
    like = {"params": {"w": torch.zeros(2, 3), "b": torch.ones(3)},
            "opt": {"mu": {"w": torch.zeros(2, 3)},
                    "count": torch.tensor(0)},
            "layers": [{"w": torch.zeros(2)}, {"w": torch.zeros(2)}]}
    got, step = restore_checkpoint(path, like)
    assert step == 42
    for a, b in zip(tree_leaves(got), tree_leaves(tree), strict=True):
        assert torch.equal(a, b) and a.dtype == b.dtype
    with np.load(path + ".npz") as a:
        assert set(a.files) == {"params/w", "params/b", "opt/mu/w",
                                "opt/count", "layers/0/w", "layers/1/w",
                                "__step__"}


def test_checkpoint_missing_paths_raise_keyerror_with_names(tmp_path):
    path = str(tmp_path / "ck")
    save_checkpoint(path, {"params": {"w": torch.ones(2)}})
    like = {"params": {"w": torch.zeros(2), "b": torch.zeros(3)},
            "opt": torch.zeros(1)}
    with pytest.raises(KeyError, match=r"missing 2 path") as err:
        restore_checkpoint(path, like)
    assert "params/b" in str(err.value) and "opt" in str(err.value)


def test_checkpoint_extra_paths_strict_raises_lenient_passes(tmp_path):
    path = str(tmp_path / "ck")
    save_checkpoint(path, {"w": torch.ones(2), "legacy": torch.zeros(4)},
                    step=9)
    like = {"w": torch.zeros(2)}
    with pytest.raises(ValueError, match=r"legacy.*strict=False"):
        restore_checkpoint(path, like)
    tree, step = restore_checkpoint(path, like, strict=False)
    assert step == 9 and torch.equal(tree["w"], torch.ones(2))


def test_checkpoint_shape_mismatch_raises(tmp_path):
    path = str(tmp_path / "ck")
    save_checkpoint(path, {"w": torch.ones(2, 3)})
    with pytest.raises(ValueError, match=r"'w' has shape \(2, 3\)"):
        restore_checkpoint(path, {"w": torch.zeros(3, 2)})


def test_checkpoint_dtype_follows_like_and_suffix_is_optional(tmp_path):
    path = str(tmp_path / "ck")
    save_checkpoint(path, {"w": np.ones(4, np.float64),
                           "h": torch.ones(4, dtype=torch.bfloat16)}, step=1)
    assert (tmp_path / "ck.npz").exists()
    like = {"w": torch.zeros(4), "h": torch.zeros(4, dtype=torch.bfloat16)}
    t1, s1 = restore_checkpoint(path, like)
    t2, s2 = restore_checkpoint(path + ".npz", like)
    assert s1 == s2 == 1
    assert t1["w"].dtype == torch.float32 and t1["h"].dtype == torch.bfloat16
    assert torch.equal(t1["w"], t2["w"]) and torch.equal(t1["h"], t2["h"])
    got, _ = restore_checkpoint(path, {"w": np.zeros(4, np.float32),
                                       "h": np.zeros(4, np.float32)})
    assert got["w"].dtype == torch.float32 and got["w"].device.type == "cpu"

