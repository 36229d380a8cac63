"""The slice end to end: the port's PSTrainer (on the CPU) against the
JAX package's PSTrainer, each on its DEFAULT engine (the cluster runtime:
bsp policy, analytic transport) and each on its lockstep engine, from
the same params, batches and seeds, set up as tests/test_runtime.py sets
it up."""
import os
import runpy

import jax
import numpy as np
import pytest

from repro.config import LTPConfig as JLTPConfig
from repro.config import NetConfig as JNetConfig
from repro.config import TrainConfig as JTrainConfig
from repro.configs import get_config as jget_config
from repro.data import SyntheticCIFAR as JSyntheticCIFAR
from repro.data import batches as jbatches
from repro.models import build as jbuild
from repro.optim import make_optimizer as jmake_optimizer
from repro.train import PSTrainer as JPSTrainer
from repro_torch.config import LTPConfig, NetConfig, TrainConfig
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.data import SyntheticCIFAR, batches
from repro_torch.models import build
from repro_torch.optim import make_optimizer
from repro_torch.train import PSTrainer
from repro_torch.tree import tree_leaves

W = 4
STEPS = 5
SMALL = dict(d_model=8, n_layers=3)
ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))


def _run_both(jltp: JLTPConfig, ltp: LTPConfig, protocol: str = "ltp",
              **engine):
    """Both packages' PSTrainer on their default engine, or on the one
    ``engine=`` names."""
    japi = jbuild(jget_config("papernet").replace(**SMALL))
    jtc = JTrainConfig(batch=32, lr=0.05, steps=STEPS)
    jtr = JPSTrainer(japi, jmake_optimizer(jtc), jtc, jltp,
                     JNetConfig(10, 1, 0.001, 4096), n_workers=W,
                     protocol=protocol, compute_time=0.05, seed=0, **engine)
    jinit = jax.tree.map(np.asarray, japi.init(jax.random.PRNGKey(0)))
    jhist = jtr.run(jbatches(JSyntheticCIFAR(seed=0), 32, STEPS),
                    epoch_steps=3)

    tc = TrainConfig(batch=32, lr=0.05, steps=STEPS)
    tr = PSTrainer(build(get_config("papernet").replace(**SMALL)),
                   make_optimizer(tc), tc, ltp, NetConfig(10, 1, 0.001, 4096),
                   n_workers=W, protocol=protocol, compute_time=0.05, seed=0,
                   device="cpu", params=params_from_numpy(jinit, "cpu"),
                   **engine)
    hist = tr.run(batches(SyntheticCIFAR(seed=0), 32, STEPS), epoch_steps=3)
    assert tr.engine == jtr.engine == engine.get("engine", "runtime")
    return jtr, jhist, tr, hist


def _assert_same_history(jtr, jhist, tr, hist):
    assert len(hist) == len(jhist) == STEPS
    for a, b in zip(hist, jhist):
        # numpy transport model and controller: the same arithmetic
        assert (a["step"], a["bst"], a["sim_time"]) == \
            (b["step"], b["bst"], b["sim_time"])
        # the mean of the same {0,1} masks in float32, summed in
        # another order
        np.testing.assert_allclose(a["delivered"], b["delivered"], rtol=1e-6)
        # per-worker conv grads summed in another order (XLA vs oneDNN)
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-4)
    jleaves = jax.tree_util.tree_leaves(jtr.params)
    leaves = tree_leaves(tr.params)
    assert len(leaves) == len(jleaves)
    for a, b in zip(leaves, jleaves):
        # as tests/test_sync_backend.py holds two backends' trajectories
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4,
                                   atol=2e-5)
    assert tr.throughput(32) == pytest.approx(jtr.throughput(32), rel=1e-12)


def test_pstrainer_matches_jax_default_path():
    """Paper compensation, default backends, default (runtime) engine on
    both sides."""
    _assert_same_history(*_run_both(JLTPConfig(), LTPConfig()))


def test_pstrainer_lockstep_matches_jax_lockstep():
    """The lockstep engines: sim_time adds compute + bst as JAX's
    lockstep loop does, so it too agrees exactly."""
    _assert_same_history(*_run_both(JLTPConfig(), LTPConfig(),
                                    engine="lockstep"))


def test_pstrainer_count_ef_matches_jax_pallas_path():
    """count compensation + error feedback: JAX runs both Pallas kernels
    (interpret mode); the port runs its kernel route (the plain versions,
    on the CPU)."""
    kw = dict(compensation="count", error_feedback=True)
    _assert_same_history(*_run_both(
        JLTPConfig(sync_backend="pallas", **kw),
        LTPConfig(sync_backend="cuda", **kw)))


def test_pstrainer_cubic_matches_jax():
    _assert_same_history(*_run_both(JLTPConfig(), LTPConfig(), "cubic"))


def test_pstrainer_own_init_and_traces():
    """Without ``params`` the port initialises from its own seeded
    generator, reproducibly; a bst trace selects the replayed timing."""
    tc = TrainConfig(batch=16, lr=0.05, steps=2)
    api = build(get_config("papernet").replace(**SMALL))

    def run(**kw):
        tr = PSTrainer(api, make_optimizer(tc), tc, LTPConfig(), NetConfig(),
                       n_workers=2, device="cpu", seed=3, **kw)
        return tr, tr.run(batches(SyntheticCIFAR(seed=1), 16, 2))

    a, ha = run()
    b, hb = run()
    assert [h["loss"] for h in ha] == [h["loss"] for h in hb]
    assert all(np.isfinite(h["loss"]) and 0 < h["delivered"] <= 1
               for h in ha)
    _, ht = run(bst_trace=np.array([0.01, 0.02]),
                delivered_trace=np.array([[1.0, 1.0], [0.5, 0.5]]))
    assert [h["bst"] for h in ht] == [0.01, 0.02]
    assert ht[0]["delivered"] == 1.0 and ht[1]["delivered"] < 1.0


def test_pstrainer_trace_replay_matches_jax():
    """A DES-style replay (bst_trace + per-(worker, packet) mask_trace):
    JAX runs it on its lockstep engine, as the port does."""
    rng = np.random.default_rng(17)
    bst_trace = np.array([0.011, 0.017, 0.013])
    mask_trace = rng.random((2, W, 300)) < 0.7
    japi = jbuild(jget_config("papernet").replace(**SMALL))
    jtc = JTrainConfig(batch=32, lr=0.05, steps=3)
    jtr = JPSTrainer(japi, jmake_optimizer(jtc), jtc, JLTPConfig(),
                     JNetConfig(10, 1, 0.002, 4096), n_workers=W,
                     compute_time=0.01, seed=0, bst_trace=bst_trace,
                     mask_trace=mask_trace)
    assert jtr.engine == "lockstep"
    jinit = jax.tree.map(np.asarray, japi.init(jax.random.PRNGKey(0)))
    jhist = jtr.run(jbatches(JSyntheticCIFAR(seed=1), 32, 3))
    tc = TrainConfig(batch=32, lr=0.05, steps=3)
    tr = PSTrainer(build(get_config("papernet").replace(**SMALL)),
                   make_optimizer(tc), tc, LTPConfig(),
                   NetConfig(10, 1, 0.002, 4096), n_workers=W,
                   compute_time=0.01, seed=0, bst_trace=bst_trace,
                   mask_trace=mask_trace, device="cpu",
                   params=params_from_numpy(jinit, "cpu"))
    hist = tr.run(batches(SyntheticCIFAR(seed=1), 32, 3))
    assert tr.engine == "lockstep"
    for a, b in zip(hist, jhist):
        assert (a["step"], a["bst"], a["sim_time"]) == \
            (b["step"], b["bst"], b["sim_time"])
        np.testing.assert_allclose(a["delivered"], b["delivered"], rtol=1e-6)
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-4)


def test_quickstart_torch_runs_on_cpu(capsys):
    mod = runpy.run_path(os.path.join(ROOT, "examples", "quickstart_torch.py"))
    mod["main"](["--steps", "2", "--workers", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "LTP speedup vs cubic" in out
