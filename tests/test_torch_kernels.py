"""The port's kernel wrappers (their plain route on the CPU) against the
JAX package's Pallas kernels run in interpret mode, on the shape/dtype
sweep of tests/test_kernels.py. Inputs come from numpy with a seed."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ops, ref

DROPFILL_SHAPES = [(130, 360), (256, 384), (7, 33), (1000, 128), (1, 1),
                   (513, 129)]
REDUCE_SHAPES = [(8, 130, 360), (4, 64, 384), (16, 33, 100), (2, 5, 7)]


def _dropfill_inputs(n, p, seed=7):
    rng = np.random.default_rng(seed)
    pkts = rng.normal(size=(n, p)).astype(np.float32)
    mask = (rng.random(n) < 0.7).astype(np.float32)
    scale = rng.uniform(0.5, 2.0, n).astype(np.float32)
    return pkts, mask, scale


@pytest.mark.parametrize("n,p", DROPFILL_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dropfill_matches_pallas(n, p, dtype):
    pkts, mask, scale = _dropfill_inputs(n, p)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    want = jops.ltp_dropfill(jnp.asarray(pkts).astype(jdt),
                             jnp.asarray(mask), jnp.asarray(scale))
    got = ops.ltp_dropfill(torch.tensor(pkts).to(tdt), torch.tensor(mask),
                           torch.tensor(scale))
    assert got.dtype == tdt and tuple(got.shape) == (n, p)
    # f32: the same product of f32 values; bf16: both round f32 -> bf16
    # once, the tolerance is the repo's own bf16 bound
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32),
        rtol=2e-2 if dtype == "bfloat16" else 1e-6)


def test_dropfill_zero_fills_lost_and_donates():
    pkts = torch.ones((64, 360))
    mask = torch.zeros(64)
    mask[::2] = 1.0
    out = ops.ltp_dropfill(pkts, mask)
    assert torch.all(out[1::2] == 0) and torch.all(out[::2] == 1)
    donated = ops.ltp_dropfill(pkts, mask, donate=True)
    assert donated.data_ptr() == pkts.data_ptr()
    assert torch.equal(donated, out)


def test_dropfill_other_float_dtypes_go_through_f32():
    pkts, mask, scale = _dropfill_inputs(9, 10)
    x = torch.tensor(pkts).to(torch.float16)
    out = ops.ltp_dropfill(x, torch.tensor(mask), torch.tensor(scale))
    assert out.dtype == torch.float16
    want = (x.float() * torch.tensor(mask * scale)[:, None]).half()
    assert torch.equal(out, want)


@pytest.mark.parametrize("w,n,p", REDUCE_SHAPES)
@pytest.mark.parametrize("comp", ["paper", "count"])
def test_packet_reduce_matches_pallas(w, n, p, comp):
    rng = np.random.default_rng(w * 1000 + n)
    pkts = rng.normal(size=(w, n, p)).astype(np.float32)
    mask = (rng.random((w, n)) < 0.8).astype(np.float32)
    want = jops.ltp_packet_reduce(jnp.asarray(pkts), jnp.asarray(mask),
                                  compensation=comp)
    got = ops.ltp_packet_reduce(torch.tensor(pkts), torch.tensor(mask),
                                compensation=comp)
    assert got.dtype == torch.float32 and tuple(got.shape) == (n, p)
    # sums of W float32 terms taken in another order
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)


def test_packet_reduce_full_delivery_is_mean():
    pkts = torch.stack([torch.full((16, 8), float(w)) for w in range(4)])
    out = ops.ltp_packet_reduce(pkts, torch.ones((4, 16)))
    assert torch.equal(out, torch.full((16, 8), 1.5))


def test_packet_reduce_count_unbiased_single_worker():
    pkts = torch.stack([torch.full((8, 4), 5.0), torch.zeros((8, 4))])
    mask = torch.stack([torch.ones(8), torch.zeros(8)])
    out = ops.ltp_packet_reduce(pkts, mask, compensation="count")
    assert torch.equal(out, torch.full((8, 4), 5.0))   # only deliverer counts


def test_packet_reduce_rejects_bad_inputs():
    with pytest.raises(ValueError, match="compensation"):
        ops.ltp_packet_reduce(torch.zeros(2, 3, 4), torch.ones(2, 3),
                              compensation="expected")
    with pytest.raises(ValueError, match=r"\(W, n, p\)"):
        ops.ltp_packet_reduce(torch.zeros(2, 3, 4), torch.ones(3, 2))


@pytest.mark.parametrize("k", [0.0, 0.3, 1.0])
def test_randomk_ref_matches_jax(k):
    """randomk has no kernel in the port yet; its plain version is here
    and agrees with the JAX oracle."""
    from repro.kernels import ref as jref
    rng = np.random.default_rng(11)
    x = rng.normal(size=(37, 23)).astype(np.float32)
    u = rng.random((37, 23)).astype(np.float32)
    want = jref.randomk_ref(jnp.asarray(x), jnp.asarray(u), k)
    got = ref.randomk_ref(torch.tensor(x), torch.tensor(u), k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
