"""The port's cluster runtime (repro_torch.runtime.ClusterRuntime, on the
CPU) against the JAX package's ClusterRuntime, from the same params,
batches and seeds, set up as tests/test_runtime.py sets it up: bsp over
ltp and cubic, async and ssp under lognormal stragglers, the
staleness_comp wiring, the lockstep engine, and truncation safety.

The transport, compute, policy and mask streams are numpy on both
sides, so every record's step, bst, staleness, n_grads, delivered and
sim_time agree exactly; losses and params agree to float tolerance (per
worker conv grads summed in another order)."""
import jax
import numpy as np
import pytest
import torch

from repro.config import LTPConfig as JLTPConfig
from repro.config import NetConfig as JNetConfig
from repro.config import TrainConfig as JTrainConfig
from repro.configs import get_config as jget_config
from repro.data import SyntheticCIFAR as JSyntheticCIFAR
from repro.data import batches as jbatches
from repro.models import build as jbuild
from repro.optim import make_optimizer as jmake_optimizer
from repro.runtime import ClusterRuntime as JClusterRuntime
from repro.runtime import LognormalStragglerCompute as JLognormal
from repro.runtime import make_policy as jmake_policy
from repro.runtime.policies import PendingGrad as JPendingGrad
from repro_torch.config import LTPConfig, NetConfig, RuntimeConfig, TrainConfig
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.data import SyntheticCIFAR, batches
from repro_torch.models import build
from repro_torch.optim import make_optimizer
from repro_torch.runtime import (
    AsyncPolicy,
    ClusterRuntime,
    DeterministicCompute,
    LognormalStragglerCompute,
    TraceCompute,
    make_compute_model,
    make_policy,
)
from repro_torch.runtime.policies import PendingGrad, SSPPolicy
from repro_torch.train import PSTrainer
from repro_torch.tree import tree_leaves

W = 4
STEPS = 5
SMALL = dict(d_model=8, n_layers=3)
NET = (10, 1, 0.001, 4096)
# a 10 Mbit/s trunk: the small model's per-flow transfers then outlast
# the LT threshold, and most async flows Early-Close with partial masks
SLOW_NET = (0.01, 1, 0.001, 4096)

# name -> (policy, policy_kw, straggler seed or None, protocol, net,
# LTPConfig kwargs as (JAX, port)); each case holds the port against
# the JAX run
CASES = {
    "bsp_ltp": ("bsp", None, None, "ltp", NET, ({}, {})),
    "bsp_cubic": ("bsp", None, None, "cubic", NET, ({}, {})),
    # the card's async path: damping, error feedback on partial masks,
    # and both kernels' routes (Pallas in interpret mode; the port's
    # plain versions)
    "async_ef": ("async", None, 11, "ltp", SLOW_NET,
                 (dict(staleness_comp=0.5, error_feedback=True,
                       sync_backend="pallas"),
                  dict(staleness_comp=0.5, error_feedback=True,
                       sync_backend="cuda"))),
    "ssp": ("ssp", {"staleness": 1}, 3, "ltp", NET,
            (dict(staleness_comp=0.5), dict(staleness_comp=0.5))),
}


def _stragglers(cls, seed):
    return cls(W, base=0.05, sigma=0.3, straggler_prob=0.25,
               straggler_mult=5.0, seed=seed)


def _jax_run(name):
    policy, pkw, sseed, protocol, net, (jkw, _) = CASES[name]
    japi = jbuild(jget_config("papernet").replace(**SMALL))
    jtc = JTrainConfig(batch=32, lr=0.05, steps=STEPS)
    jrt = JClusterRuntime(
        japi, jmake_optimizer(jtc), jtc, JLTPConfig(**jkw), JNetConfig(*net),
        n_workers=W, protocol=protocol, policy=policy, policy_kw=pkw,
        compute_model=None if sseed is None else _stragglers(JLognormal,
                                                             sseed),
        compute_time=0.05, seed=0)
    init = jax.tree.map(np.asarray, jrt.params)
    jrt.run(jbatches(JSyntheticCIFAR(seed=0), 32, STEPS), epoch_steps=3)
    return init, jrt


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


def _jax(jax_runs, name):
    if name not in jax_runs:
        jax_runs[name] = _jax_run(name)
    return jax_runs[name]


def _port_runtime(name, init, **kw):
    policy, pkw, sseed, protocol, net, (_, tkw) = CASES[name]
    tc = TrainConfig(batch=32, lr=0.05, steps=STEPS)
    return ClusterRuntime(
        build(get_config("papernet").replace(**SMALL)), make_optimizer(tc),
        tc, LTPConfig(**tkw), NetConfig(*net), n_workers=W,
        protocol=protocol, policy=policy, policy_kw=pkw,
        compute_model=(None if sseed is None
                       else _stragglers(LognormalStragglerCompute, sseed)),
        compute_time=0.05, seed=0, device="cpu",
        params=params_from_numpy(init, "cpu"), **kw)


def _port_run(name, init):
    rt = _port_runtime(name, init)
    rt.run(batches(SyntheticCIFAR(seed=0), 32, STEPS), epoch_steps=3)
    return rt


EXACT = ("step", "bst", "staleness", "n_grads", "sim_time")


def assert_matches_jax(rt, jrt):
    """Transport, policy and clock fields exactly; loss rtol 1e-4;
    params rtol 2e-4 / atol 2e-5."""
    assert len(rt.history) == len(jrt.history) > 0
    bsp = type(rt.policy).__name__ == "BSPPolicy"
    for a, b in zip(rt.history, jrt.history):
        assert set(a) == set(b)
        assert {k: a[k] for k in EXACT if k in a} == \
            {k: b[k] for k in EXACT if k in b}
        if bsp:
            # the float32 mean of the same {0,1} masks on the device,
            # summed in another order
            np.testing.assert_allclose(a["delivered"], b["delivered"],
                                       rtol=1e-6)
        else:
            # the mean of the admitted gradients' fractions, on the host
            assert a["delivered"] == b["delivered"]
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-4)
    leaves, jleaves = tree_leaves(rt.params), jax.tree_util.tree_leaves(
        jrt.params)
    assert len(leaves) == len(jleaves)
    for x, y in zip(leaves, jleaves):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=2e-4,
                                   atol=2e-5)
    assert rt.sim_time == jrt.sim_time
    assert rt.throughput(32) == jrt.throughput(32)


@pytest.mark.parametrize("name", list(CASES))
def test_runtime_matches_jax(jax_runs, name):
    init, jrt = _jax(jax_runs, name)
    rt = _port_run(name, init)
    assert_matches_jax(rt, jrt)
    s = rt.tel.summary()
    if name in ("bsp_ltp", "async_ef"):
        assert s["n_early_close"] > 0           # partial deliveries
    if CASES[name][0] != "bsp":
        assert s["staleness_max"] >= 1          # stragglers: real staleness
        assert sum(r["n_grads"] for r in rt.history) == \
            W * STEPS - s["n_stale_drops"]
    if name == "ssp":
        assert s["n_stale_drops"] > 0 and s["staleness_max"] <= 1


@pytest.mark.parametrize("name", ["async_ef", "ssp"])
def test_telemetry_stream_matches_jax(jax_runs, name):
    """The whole event stream — kinds, times, workers, iterations,
    staleness — is the JAX package's, loss aside."""
    init, jrt = _jax(jax_runs, name)
    rt = _port_run(name, init)

    def strip(events):
        return [{k: v for k, v in e.items() if k != "loss"} for e in events]

    assert strip(rt.tel.events) == strip(jrt.tel.events)
    assert rt.tel.summary() == jrt.tel.summary()


@pytest.mark.parametrize("name", ["bsp_ltp", "bsp_cubic"])
def test_runtime_bsp_equals_lockstep_bitwise(jax_runs, name):
    """The port's runtime bsp runs the lockstep loop's fused step on the
    same inputs: every record and every param agrees bitwise. sim_time
    sums the same compute and bst in each engine's own association (the
    runtime commits at (t + compute) + bst, lockstep adds compute + bst),
    as their JAX counterparts do."""
    init, _ = _jax(jax_runs, name)
    protocol = CASES[name][3]
    tc = TrainConfig(batch=32, lr=0.05, steps=STEPS)

    def trainer(engine):
        tr = PSTrainer(build(get_config("papernet").replace(**SMALL)),
                       make_optimizer(tc), tc, LTPConfig(), NetConfig(*NET),
                       n_workers=W, protocol=protocol, compute_time=0.05,
                       seed=0, engine=engine, device="cpu",
                       params=params_from_numpy(init, "cpu"))
        tr.run(batches(SyntheticCIFAR(seed=0), 32, STEPS), epoch_steps=3)
        return tr

    rt, ls = trainer("runtime"), trainer("lockstep")
    assert rt.engine == "runtime" and rt._rt is not None
    assert ls._rt is None
    t_rt = t_ls = 0.0
    for a, b in zip(rt.history, ls.history, strict=True):
        assert {k: v for k, v in a.items() if k != "sim_time"} == \
            {k: v for k, v in b.items() if k != "sim_time"}
        t_rt = (t_rt + 0.05) + a["bst"]
        t_ls += 0.05 + b["bst"]
        assert (a["sim_time"], b["sim_time"]) == (t_rt, t_ls)
        assert a["sim_time"] == pytest.approx(b["sim_time"], rel=1e-15)
    for x, y in zip(tree_leaves(rt.params), tree_leaves(ls.params)):
        assert torch.equal(x, y)


def test_pstrainer_defaults_to_the_runtime():
    tc = TrainConfig(batch=16, lr=0.05, steps=2)
    tr = PSTrainer(build(get_config("papernet").replace(**SMALL)),
                   make_optimizer(tc), tc, LTPConfig(), NetConfig(),
                   n_workers=2, device="cpu")
    assert tr.engine == "runtime" and isinstance(tr._rt, ClusterRuntime)
    assert tr.telemetry is tr._rt.tel and tr.plan is tr._rt.plan
    h = tr.run(batches(SyntheticCIFAR(seed=1), 16, 2))
    assert h is tr._rt.history and [r["step"] for r in h] == [0, 1]
    assert all(isinstance(r["loss"], float) for r in h)
    assert tr.params is tr._rt.params and tr.step_idx == 2
    assert tr.sim_time == tr._rt.sim_time > 0


def test_trace_inputs_fall_back_to_lockstep():
    tc = TrainConfig(batch=16, lr=0.05, steps=2)
    tr = PSTrainer(build(get_config("papernet").replace(**SMALL)),
                   make_optimizer(tc), tc, LTPConfig(), NetConfig(),
                   n_workers=2, device="cpu", engine="runtime",
                   bst_trace=np.array([0.01, 0.02]))
    assert tr.engine == "lockstep" and tr._rt is None
    h = tr.run(batches(SyntheticCIFAR(seed=1), 16, 2))
    assert [r["bst"] for r in h] == [0.01, 0.02]


def test_runtime_cfg_overlays_ltp():
    rc = RuntimeConfig(staleness_comp=0.25, error_feedback=True,
                       sync_backend="python")
    ltp = LTPConfig().with_runtime(rc)
    assert ltp.runtime() == rc and LTPConfig().with_runtime(None) == \
        LTPConfig()
    tc = TrainConfig(batch=16, lr=0.05, steps=1)
    tr = PSTrainer(build(get_config("papernet").replace(**SMALL)),
                   make_optimizer(tc), tc, LTPConfig(), NetConfig(),
                   n_workers=2, device="cpu", policy="async",
                   runtime_cfg=rc)
    assert tr._rt.ltp == ltp and tr._rt.policy.damping == 0.25
    assert tr.residual is not None and tuple(tr.residual.shape) == \
        (2, tr.plan.n_packets, tr.plan.packet_floats)


# ---------------------------------------------------------------------------
# staleness_comp wiring, policies and compute models (numpy; the JAX
# package's own draws and weights)
# ---------------------------------------------------------------------------


def _small_runtime(policy, ltp=None, **kw):
    tc = TrainConfig(batch=16, lr=0.05, steps=1)
    return ClusterRuntime(build(get_config("papernet").replace(**SMALL)),
                          make_optimizer(tc), tc, ltp or LTPConfig(),
                          NetConfig(*NET), n_workers=2, policy=policy,
                          device="cpu", **kw)


def _grad(cls, worker, it, staleness=0):
    return cls(worker=worker, iteration=it, t_ready=0.0,
               staleness=staleness, payload={"frac": 1.0})


def test_staleness_comp_wires_into_the_policies():
    """LTPConfig.staleness_comp governs async damping and the ssp law
    unless the policy instance overrides it explicitly."""
    rt = _small_runtime("async", LTPConfig(staleness_comp=0.7))
    assert rt.policy.damping == 0.7
    rt0 = _small_runtime("async")
    assert rt0.policy.damping == 0.0
    assert rt0.policy.weights([_grad(PendingGrad, 0, 0, 3)]) is None
    over = _small_runtime(AsyncPolicy(damping=1.0),
                          LTPConfig(staleness_comp=0.7))
    assert over.policy.damping == 1.0
    ssp = _small_runtime("ssp", LTPConfig(staleness_comp=0.5),
                         policy_kw={"staleness": 2})
    assert isinstance(ssp.policy, SSPPolicy)
    assert ssp.policy.staleness_comp == 0.5


@pytest.mark.parametrize("policy,kw", [
    ("bsp", {}), ("async", {"damping": 1.0}),
    ("ssp", {"staleness": 0, "staleness_comp": 0.5}),
    ("ssp", {"staleness": 2, "staleness_comp": 0.5})])
def test_policies_match_jax(policy, kw):
    """The same arrivals give the same batches, drops and weights."""
    p, jp = make_policy(policy, **kw), jmake_policy(policy, **kw)
    p.bind(3)
    jp.bind(3)
    rng = np.random.default_rng(5)
    for _ in range(30):
        wk, it = int(rng.integers(3)), int(rng.integers(4))
        s = int(rng.integers(3))
        assert p.may_start(wk, it) == jp.may_start(wk, it)
        p.on_start(wk, it)
        jp.on_start(wk, it)
        p.on_arrival(_grad(PendingGrad, wk, it, s))
        jp.on_arrival(_grad(JPendingGrad, wk, it, s))
        b, jb = p.ready(), jp.ready()
        assert [(g.worker, g.iteration) for g in b] == \
            [(g.worker, g.iteration) for g in jb]
        w, jw = p.weights(b), jp.weights(jb)
        assert (w is None) == (jw is None)
        if w is not None:
            np.testing.assert_array_equal(w, jw)
        assert len(p.drained_stale()) == len(jp.drained_stale())
        if b:
            p.on_applied(b)
            jp.on_applied(jb)


def test_compute_models_match_jax():
    from repro.runtime import DeterministicCompute as JDet
    from repro.runtime import TraceCompute as JTrace
    pairs = [
        (3, LognormalStragglerCompute(3, base=0.05, seed=5),
         JLognormal(3, base=0.05, seed=5)),
        (3, DeterministicCompute(3, base=0.1, mults=[1.0, 2.0, 4.0],
                                 rejoin_penalty_s=0.02),
         JDet(3, base=0.1, mults=[1.0, 2.0, 4.0], rejoin_penalty_s=0.02)),
        (2, TraceCompute(2, trace=[[0.1, 0.2], [0.3, 0.4]]),
         JTrace(2, trace=[[0.1, 0.2], [0.3, 0.4]])),
    ]
    for n, m, jm in pairs:
        draws = [m.sample(w, i) for w in range(n) for i in range(5)]
        assert draws == [jm.sample(w, i) for w in range(n) for i in range(5)]
        assert m.rejoin_penalty_s == jm.rejoin_penalty_s
    assert isinstance(make_compute_model(None, 4, base=0.07),
                      DeterministicCompute)
    with pytest.raises(ValueError, match="unknown compute model"):
        make_compute_model("gamma", 4)


# ---------------------------------------------------------------------------
# safety
# ---------------------------------------------------------------------------


def test_runtime_truncation_raises():
    rt = _small_runtime("bsp")
    with pytest.warns(RuntimeWarning, match="max_events"):
        with pytest.raises(RuntimeError, match="truncated"):
            rt.run(batches(SyntheticCIFAR(seed=0), 16, 3), max_events=3)


def test_runtime_rejects_unknown_transport():
    with pytest.raises(ValueError, match="unknown transport"):
        _small_runtime("bsp", transport="carrier-pigeon")


def test_loss_stays_on_the_device_until_the_loop_drains(monkeypatch):
    """Commit and apply keep loss/delivered as 0-d tensors in the history
    and the apply events; run() forces them once, after the event loop."""
    seen = []
    rt = _small_runtime("async")
    orig = rt.apply_batch

    def spy(batch):
        orig(batch)
        seen.append(rt.history[-1]["loss"])

    monkeypatch.setattr(rt, "apply_batch", spy)
    rt.run(batches(SyntheticCIFAR(seed=0), 16, 2))
    assert seen and all(isinstance(loss, torch.Tensor) and loss.dim() == 0
                        for loss in seen)
    assert all(isinstance(r["loss"], float) for r in rt.history)
    assert all(isinstance(e["loss"], float)
               for e in rt.tel.events if "loss" in e)
