"""One fused BSP step of the port against the JAX package's, from
identical params, batch, masks and residual: LTP under every
compensation mode, LTP with error feedback on both backends, and cubic."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import LTPConfig as JLTPConfig
from repro.config import TrainConfig as JTrainConfig
from repro.configs import get_config as jget_config
from repro.core import packets as jpk
from repro.models import build as jbuild
from repro.optim import make_optimizer as jmake_optimizer
from repro.runtime import step as jstp
from repro_torch.config import LTPConfig, TrainConfig
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import packets as pk
from repro_torch.models import build
from repro_torch.optim import make_optimizer
from repro_torch.runtime import step as stp
from repro_torch.tree import tree_leaves

W, PER_WORKER = 4, 4
SMALL = dict(d_model=8, n_layers=3)


@pytest.fixture(scope="module")
def setup():
    jcfg = jget_config("papernet").replace(**SMALL)
    japi = jbuild(jcfg)
    jparams = japi.init(jax.random.PRNGKey(0))
    api = build(get_config("papernet").replace(**SMALL))
    np_params = jax.tree.map(np.asarray, jparams)
    rng = np.random.default_rng(5)
    batch = {
        "images": rng.normal(size=(W, PER_WORKER, 32, 32, 3)).astype(
            np.float32),
        "labels": rng.integers(0, 10, (W, PER_WORKER)).astype(np.int32)}
    plan = jpk.make_plan(jparams, 360)
    masks = (rng.random((W, plan.n_packets)) < 0.7).astype(np.float32)
    masks[:, plan.critical] = 1.0
    residual = (rng.normal(size=(W, plan.n_packets, 360)) * 1e-3).astype(
        np.float32)
    frac = np.full((W,), 0.7, np.float32)
    return japi, api, np_params, batch, plan, masks, residual, frac


CASES = [
    # (protocol, compensation, error_feedback, jax backend, port backend)
    ("ltp", "paper", False, "python", "auto"),
    ("ltp", "count", False, "python", "auto"),
    ("ltp", "expected", False, "python", "auto"),
    ("ltp", "paper", False, "pallas", "cuda"),
    ("ltp", "count", True, "python", "python"),
    ("ltp", "count", True, "pallas", "cuda"),
    ("cubic", "paper", False, "python", "auto"),
]


@pytest.mark.parametrize("protocol,comp,ef,jbackend,backend", CASES)
def test_fused_step_matches_jax(setup, protocol, comp, ef, jbackend, backend):
    japi, api, np_params, batch, jplan, masks, residual, frac = setup
    jltp = JLTPConfig(compensation=comp, error_feedback=ef,
                      sync_backend=jbackend)
    ltp = LTPConfig(compensation=comp, error_feedback=ef,
                    sync_backend=backend)
    jopt = jmake_optimizer(JTrainConfig(lr=0.05))
    opt = make_optimizer(TrainConfig(lr=0.05))

    jparams = jax.tree.map(jnp.asarray, np_params)
    jstep = jstp.build_fused_step(japi, jopt, jltp, jplan, W, protocol)
    jout = jstep(jparams, jopt.init(jparams),
                 jnp.asarray(residual) if ef else None,
                 jax.tree.map(jnp.asarray, batch), jnp.asarray(masks),
                 jnp.asarray(frac), jnp.float32(0.05))

    params = params_from_numpy(np_params, "cpu")
    plan = pk.make_plan(params, 360)
    step = stp.build_fused_step(api, opt, ltp, plan, W, protocol)
    out = step(params, opt.init(params),
               torch.tensor(residual) if ef else None,
               {k: torch.tensor(v) for k, v in batch.items()},
               torch.tensor(masks), torch.tensor(frac), 0.05)

    # per-worker conv grads summed in another order (XLA vs oneDNN)
    np.testing.assert_allclose(out[3].item(), float(jout[3]), rtol=1e-4)
    np.testing.assert_allclose(out[4].item(), float(jout[4]), rtol=1e-6)
    for a, b in zip(tree_leaves(out[0]), jax.tree_util.tree_leaves(jout[0])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-6)
    for a, b in zip(tree_leaves(out[1]), jax.tree_util.tree_leaves(jout[1])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-6)
    if ef:
        np.testing.assert_allclose(out[2].numpy(), np.asarray(jout[2]),
                                   rtol=1e-4, atol=1e-7)
    else:
        assert out[2] is None and jout[2] is None


def test_draw_delivery_masks_is_the_jax_draw(setup):
    *_, plan, _, _, frac = setup
    tplan = pk.make_plan(params_from_numpy(setup[2], "cpu"), 360)
    for it in range(3):
        want = jstp.draw_delivery_masks(plan, W, np.random.default_rng(9),
                                        frac, it=it)
        got = stp.draw_delivery_masks(tplan, W, np.random.default_rng(9),
                                      frac, it=it)
        np.testing.assert_array_equal(got, want)
    trace = np.random.default_rng(2).random((2, W, 50)) < 0.5
    for it in range(3):
        np.testing.assert_array_equal(
            stp.draw_delivery_masks(tplan, W, None, frac, trace, it),
            jstp.draw_delivery_masks(plan, W, None, frac, trace, it))
    np.testing.assert_array_equal(
        stp.tile_mask_onto_plan(tplan, trace[0, 0]),
        jstp.tile_mask_onto_plan(plan, trace[0, 0]))
