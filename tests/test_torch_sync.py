"""The port's PS host path (``core/ltp_sync``) against the JAX package's,
on real papernet gradients packetized with a non-lane-aligned 360-float
payload: every compensation mode, ``premasked``, ``worker_weights``, and
both backends on each side (JAX "python" and "pallas" in interpret
mode; the port's "python" and "cuda", the latter on its CPU route)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import LTPConfig as JLTPConfig
from repro.configs import get_config as jget_config
from repro.core import ltp_sync as jls
from repro.core import packets as jpk
from repro.models import build as jbuild
from repro_torch.config import LTPConfig
from repro_torch.core import ltp_sync as ls

W = 4
# sums of W float32 terms in another order, one division
RTOL, ATOL = 1e-5, 1e-7


@pytest.fixture(scope="module")
def papernet_stream():
    """(plan, (W, n, 360) per-worker papernet gradient stream) from JAX."""
    cfg = jget_config("papernet").replace(d_model=8, n_layers=3)
    api = jbuild(cfg)
    params = api.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    imgs = jnp.asarray(rng.normal(size=(W, 8, 32, 32, 3)).astype(np.float32))
    labels = jnp.asarray(rng.integers(0, 10, (W, 8)).astype(np.int32))

    def one(img, lab):
        return jax.grad(
            lambda p: api.loss_fn(p, {"images": img, "labels": lab}))(params)

    grads_w = jax.vmap(one)(imgs, labels)
    plan = jpk.make_plan(params, packet_floats=360)
    flat_w = jax.vmap(lambda g: jpk.flatten(plan, g))(grads_w)
    return plan, np.asarray(flat_w)


def _masks(plan, seed, p=0.6):
    rng = np.random.default_rng(seed)
    m = (rng.random((W, plan.n_packets)) < p).astype(np.float32)
    m[:, plan.critical] = 1.0
    return m


@pytest.mark.parametrize("jbackend", ["python", "pallas"])
@pytest.mark.parametrize("backend", ["python", "cuda", "auto"])
@pytest.mark.parametrize("comp", ["paper", "count", "expected"])
def test_reduce_packet_stream_matches_jax(papernet_stream, comp, backend,
                                          jbackend):
    plan, flat_w = papernet_stream
    masks = _masks(plan, 3)
    frac = np.full((W,), 0.6, np.float32)
    want = jls.reduce_packet_stream(
        jnp.asarray(flat_w), jnp.asarray(masks), JLTPConfig(compensation=comp),
        W, expected_frac=jnp.asarray(frac), backend=jbackend)
    got = ls.reduce_packet_stream(
        torch.tensor(flat_w), torch.tensor(masks),
        LTPConfig(compensation=comp, sync_backend=backend), W,
        expected_frac=torch.tensor(frac))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("backend", ["python", "cuda"])
@pytest.mark.parametrize("comp", ["paper", "count", "expected"])
def test_reduce_packet_stream_expected_frac_defaults_to_mean_mask(
        papernet_stream, comp, backend):
    plan, flat_w = papernet_stream
    masks = _masks(plan, 5, p=0.7)
    want = jls.reduce_packet_stream(
        jnp.asarray(flat_w), jnp.asarray(masks),
        JLTPConfig(compensation=comp), W, backend="python")
    got = ls.reduce_packet_stream(
        torch.tensor(flat_w), torch.tensor(masks),
        LTPConfig(compensation=comp), W, backend=backend)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("backend", ["python", "cuda"])
@pytest.mark.parametrize("comp", ["paper", "count"])
def test_premasked_and_worker_weights_match_jax(papernet_stream, comp,
                                                backend):
    """The error-feedback call (gated stream, premasked=True) and the
    staleness-damped call (worker_weights) against JAX's pallas path."""
    plan, flat_w = papernet_stream
    masks = _masks(plan, 8)
    gated = flat_w * masks[:, :, None]
    weights = jls.staleness_weights(np.array([0, 1, 2, 3]), 0.5)
    np.testing.assert_array_equal(
        ls.staleness_weights(np.array([0, 1, 2, 3]), 0.5), weights)
    jltp = JLTPConfig(compensation=comp)
    ltp = LTPConfig(compensation=comp)
    for kw_j, kw_t in (
            ({"premasked": True}, {"premasked": True}),
            ({"worker_weights": jnp.asarray(weights)},
             {"worker_weights": torch.tensor(weights)})):
        want = jls.reduce_packet_stream(
            jnp.asarray(gated), jnp.asarray(masks), jltp, W,
            backend="pallas", **kw_j)
        got = ls.reduce_packet_stream(
            torch.tensor(gated), torch.tensor(masks), ltp, W,
            backend=backend, **kw_t)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("jbackend", ["python", "pallas"])
@pytest.mark.parametrize("backend", ["python", "cuda"])
@pytest.mark.parametrize("payload", [7, 100, 360, 384])
def test_apply_delivery_matches_jax_any_geometry(payload, backend, jbackend):
    rng = np.random.default_rng(payload)
    n = 77
    pkts = rng.normal(size=(n, payload)).astype(np.float32)
    mask = (rng.random(n) < 0.5).astype(np.float32)
    scale = rng.uniform(0.5, 2.0, n).astype(np.float32)
    want = jls.apply_delivery(jnp.asarray(pkts), jnp.asarray(mask),
                              jnp.asarray(scale), backend=jbackend)
    got = ls.apply_delivery(torch.tensor(pkts), torch.tensor(mask),
                            torch.tensor(scale), backend=backend)
    # one float32 product mask*scale, one product with the packet
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-7)


def test_apply_delivery_on_papernet_stream(papernet_stream):
    """The EF gate as the fused step calls it: (W*n, p) rows, no scale."""
    plan, flat_w = papernet_stream
    masks = _masks(plan, 13)
    rows = flat_w.reshape(W * plan.n_packets, plan.packet_floats)
    want = jls.apply_delivery(jnp.asarray(rows), jnp.asarray(masks.ravel()),
                              backend="pallas")
    for backend in ("python", "cuda"):
        got = ls.apply_delivery(torch.tensor(rows),
                                torch.tensor(masks.ravel()), backend=backend)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
