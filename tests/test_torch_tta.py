"""The port's Fig 13 loop (``repro_torch.train.tta``) against a JAX loop
written like ``benchmarks/fig13_tta.py``, at its quick model (papernet
at width 8, 3 layers), on the CPU: 12 steps of batch 128 on 8 workers,
an eval every 4 steps on 256 test images, ltp / bbr / cubic at loss
0.01, both from the JAX init of seed 0.

``sim_time``, ``bst`` and ``delivered`` come from the numpy transport
model and agree exactly (``delivered`` within rtol 1e-6 on the ltp
path's full bsp commits, a float32 mean of the same {0, 1} masks summed
in another order); losses agree within rtol 1e-4 and evals within 2/256
(an argmax tie can move one image). ``tta_s`` is compared where no eval
lies within that of the target."""
import jax
import jax.numpy as jnp
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
from repro.models.cnn import accuracy as jaccuracy
from repro.optim import make_optimizer as jmake_optimizer
from repro.train import PSTrainer as JPSTrainer
from repro_torch.convert import params_from_numpy
from repro_torch.train import tta

STEPS = 12
EVAL_EVERY = 4
N_TEST = 256
LOSS = 0.01
TARGET = 0.1     # crossed between the first eval and the second
TOL = 2 / N_TEST


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_rows():
    """fig13_tta.run's loop at the test's settings; returns the init and,
    per protocol, (history, total sim time)."""
    cfg = jget_config("papernet").replace(d_model=8, n_layers=3)
    api = jbuild(cfg)
    tc = JTrainConfig(batch=128, lr=0.05, steps=STEPS)
    data = JSyntheticCIFAR(seed=5)
    test = {k: jnp.asarray(v) for k, v in data.test_set(N_TEST).items()}
    net = JNetConfig(10, 1, LOSS, 4096)
    init = jax.tree.map(np.asarray, api.init(jax.random.PRNGKey(0)))
    out = {}
    for proto in tta.PROTOCOLS:
        tr = JPSTrainer(api, jmake_optimizer(tc), tc, JLTPConfig(), net,
                        n_workers=8, protocol=proto, compute_time=0.05,
                        seed=0)
        hist = tr.run(jbatches(data, tc.batch, STEPS), epoch_steps=20,
                      eval_fn=lambda p: jaccuracy(cfg, p, test),
                      eval_every=EVAL_EVERY)
        out[proto] = (hist, tr.sim_time)
    return init, out


@pytest.fixture(scope="module")
def port_rows(jax_rows):
    init, _ = jax_rows
    return tta.run_tta(quick=True, steps=STEPS, losses=[LOSS],
                       eval_every=EVAL_EVERY, n_test=N_TEST, target=TARGET,
                       device="cpu", params=params_from_numpy(init, "cpu"))


def test_rows_are_the_benchmarks(port_rows):
    assert [(r["loss"], r["protocol"]) for r in port_rows] == [
        (LOSS, p) for p in tta.PROTOCOLS]
    keys = {"loss", "protocol", "final_acc", "tta_s", "target", "final_loss",
            "delivered", "total_sim_time_s"}
    for r in port_rows:
        assert keys <= set(r)
        assert r["target"] == TARGET and r["host_s"] > 0.0
        assert r["images_per_s"] == pytest.approx(STEPS * 128 / r["host_s"])
        assert len(r["history"]) == STEPS
    assert [r["delivered"] for r in port_rows[1:]] == [1.0, 1.0]
    assert port_rows[0]["delivered"] < 1.0


@pytest.mark.parametrize("proto", tta.PROTOCOLS)
def test_run_tta_matches_the_jax_loop(port_rows, jax_rows, proto):
    row = next(r for r in port_rows if r["protocol"] == proto)
    jhist, jsim = jax_rows[1][proto]
    hist = row["history"]
    assert len(hist) == len(jhist) == STEPS
    assert row["total_sim_time_s"] == jsim
    for a, b in zip(hist, jhist):
        assert set(a) == set(b)
        assert (a["step"], a["bst"], a["sim_time"]) == \
            (b["step"], b["bst"], b["sim_time"])
        if proto == "ltp":
            np.testing.assert_allclose(a["delivered"], b["delivered"],
                                       rtol=1e-6)
        else:
            assert a["delivered"] == b["delivered"] == 1.0
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-4)
        if "eval" in b:
            assert abs(a["eval"] - b["eval"]) <= TOL
    evals = [b["eval"] for b in jhist if "eval" in b]
    assert len(evals) == STEPS // EVAL_EVERY
    assert abs(row["final_acc"] - evals[-1]) <= TOL
    np.testing.assert_allclose(row["final_loss"], jhist[-1]["loss"],
                               rtol=1e-4)
    if all(abs(e - TARGET) > TOL for e in evals):
        jtta = next((b["sim_time"] for b in jhist
                     if "eval" in b and b["eval"] >= TARGET), "not_reached")
        assert row["tta_s"] == jtta != "not_reached"


def test_train_tta_defaults_to_the_benchmarks_settings(monkeypatch):
    """Unset, ``run_tta`` takes fig13_tta.run's settings; the training is
    stubbed here (covered above)."""
    seen = []

    class Done:
        history = [{"loss": 1.0, "delivered": 1.0, "sim_time": 0.5,
                    "eval": 0.5}]
        sim_time = 0.5

    def fake(cfg, loss, proto, steps, test, *, eval_every, device, params):
        seen.append((cfg.d_model, cfg.n_layers, loss, proto, steps,
                     len(test["labels"]), test["labels"].device.type,
                     eval_every))
        return Done(), 1.0

    monkeypatch.setattr(tta, "train_tta", fake)
    rows = tta.run_tta(quick=False, device="cpu")
    assert seen[0] == (16, 6, 0.0, "ltp", 150, 1024, "cpu", 10)
    assert [(s[2], s[3]) for s in seen] == [
        (loss, p) for loss in (0.0, 0.001, 0.01) for p in tta.PROTOCOLS]
    assert rows[0]["target"] == 0.45 and rows[0]["tta_s"] == 0.5
    tta.run_tta(quick=True, device="cpu")
    assert seen[-1][:5] == (8, 3, 0.01, "cubic", 40)
