"""The port's kernel wrappers (their plain route on the CPU) against the
JAX package's Pallas kernels run in interpret mode, on the shape/dtype
sweep of tests/test_kernels.py. Inputs come from numpy with a seed."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.packet_reduce import tree_reduce as jtree_reduce
from repro_torch.kernels import ops, ref
from repro_torch.kernels.packet_reduce import tree_reduce

DROPFILL_SHAPES = [(130, 360), (256, 384), (7, 33), (1000, 128), (1, 1),
                   (513, 129)]
REDUCE_SHAPES = [(8, 130, 360), (4, 64, 384), (16, 33, 100), (2, 5, 7)]
RANDOMK_SHAPES = [(1000,), (37, 23), (4096,), (3, 5, 7), (1,), (3,), (5,),
                  (1023,)]


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
    """The plain version of the randomk kernel (the CPU route and the
    card's oracle) agrees with the JAX package's plain version."""
    from repro.kernels import ref as jref
    rng = np.random.default_rng(11)
    x = rng.normal(size=(37, 23)).astype(np.float32)
    u = rng.random((37, 23)).astype(np.float32)
    want = jref.randomk_ref(jnp.asarray(x), jnp.asarray(u), k)
    got = ref.randomk_ref(torch.tensor(x), torch.tensor(u), k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _randomk_inputs(shape, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    u = rng.random(shape).astype(np.float32)
    return x, u


@pytest.mark.parametrize("shape", RANDOMK_SHAPES)
@pytest.mark.parametrize("k", [0.0, 0.3, 1.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_randomk_sparsify_matches_pallas(shape, k, dtype):
    """ops.randomk_sparsify (the kernel's plain route here) against the
    JAX wrapper over the Pallas kernel in interpret mode, on the sweep of
    tests/test_kernels.py::test_randomk. A select does no arithmetic, so
    both dtypes agree exactly."""
    x, u = _randomk_inputs(shape)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    want = jops.randomk_sparsify(jnp.asarray(x).astype(jdt), jnp.asarray(u),
                                 k)
    got = ops.randomk_sparsify(torch.tensor(x).to(tdt), torch.tensor(u), k)
    assert got.dtype == tdt and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


def test_randomk_sparsify_float16_goes_through_f32():
    x, u = _randomk_inputs((9, 10))
    xh = torch.tensor(x).to(torch.float16)
    out = ops.randomk_sparsify(xh, torch.tensor(u), 0.3)
    assert out.dtype == torch.float16
    want = jops.randomk_sparsify(jnp.asarray(x).astype(jnp.float16),
                                 jnp.asarray(u), 0.3)
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))


def test_randomk_compares_k_as_float32():
    """0.7 rounds down to float32: an element whose u equals
    float32(0.7) lies below 0.7 in double, yet the JAX kernel drops it,
    and so must the port."""
    k = 0.7
    assert float(np.float32(k)) < k
    x, u = _randomk_inputs((64,))
    u[::3] = np.float32(k)
    want = np.asarray(jops.randomk_sparsify(jnp.asarray(x), jnp.asarray(u),
                                            k))
    got = ops.randomk_sparsify(torch.tensor(x), torch.tensor(u), k).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.all(got[::3] == 0) and np.any(got != 0)


def test_randomk_rejects_bad_inputs():
    with pytest.raises(ValueError, match="elements"):
        ops.randomk_sparsify(torch.zeros(6), torch.zeros(5), 0.5)
    from repro_torch.kernels.randomk import randomk
    with pytest.raises(ValueError, match="one shape"):
        randomk(torch.zeros(2, 3), torch.zeros(6), 0.5)


@pytest.mark.parametrize("comp", ["paper", "count"])
@pytest.mark.parametrize("racks", ["pairs", "five_three"])
def test_tree_reduce_matches_pallas(comp, racks):
    """tree_reduce against the JAX tree_reduce over the Pallas kernel in
    interpret mode, on the rack layouts of tests/test_aggtree.py: four
    racks of two, and an unbalanced 5 + 3 split."""
    rack_of = ((lambda f: f // 2) if racks == "pairs"
               else (lambda f: 0 if f < 5 else 1))
    rng = np.random.default_rng(5 if racks == "pairs" else 6)
    w, n, p = 8, 128, 128
    pkts = rng.normal(size=(w, n, p)).astype(np.float32)
    mask = (rng.random((w, n)) > 0.3).astype(np.float32)
    want = jtree_reduce(jnp.asarray(pkts), jnp.asarray(mask), rack_of,
                        compensation=comp)
    got = tree_reduce(torch.tensor(pkts), torch.tensor(mask), rack_of,
                      compensation=comp)
    assert got.dtype == torch.float32 and tuple(got.shape) == (n, p)
    # per-rack sums, un-normalised and summed again, in another order
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    flat = ref.packet_reduce_ref(torch.tensor(pkts), torch.tensor(mask),
                                 compensation=comp)
    np.testing.assert_allclose(got.numpy(), flat.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_tree_reduce_ragged_and_interleaved_racks():
    """Ragged shapes the TPU kernel would pad, and racks whose members are
    not a run of workers (a gathered copy, not a view)."""
    rng = np.random.default_rng(9)
    pkts = torch.tensor(rng.normal(size=(6, 33, 100)).astype(np.float32))
    mask = torch.tensor((rng.random((6, 33)) > 0.4).astype(np.float32))
    for comp in ("paper", "count"):
        got = tree_reduce(pkts, mask, lambda f: f % 3, compensation=comp)
        want = ref.packet_reduce_ref(pkts, mask, compensation=comp)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


# rack layouts beyond tests/test_aggtree.py's: (W, rack_of)
TREE_LAYOUTS = {
    "w16_unbalanced": (16, lambda f: 0 if f < 9 else (1 if f < 12 else 2)),
    "rack_of_one": (8, lambda f: 0 if f < 7 else 1),
    "ids_out_of_order": (8, lambda f: (f * 5) % 3),
    "racks_of_one": (8, lambda f: 7 - f),
}


@pytest.mark.parametrize("comp", ["paper", "count"])
@pytest.mark.parametrize("layout", sorted(TREE_LAYOUTS))
def test_tree_reduce_layouts_match_pallas(comp, layout):
    """tree_reduce (its plain route here, ``ref.tree_reduce_ref`` over
    the grouping the kernel is given) against the JAX tree_reduce over the
    Pallas kernel in interpret mode: 16 workers in racks of 9 + 3 + 4, a
    rack of one, rack ids first met out of order (0, 2, 1), and W racks
    of one."""
    w, rack_of = TREE_LAYOUTS[layout]
    rng = np.random.default_rng(w + len(layout))
    n, p = 128, 128
    pkts = rng.normal(size=(w, n, p)).astype(np.float32)
    mask = (rng.random((w, n)) > 0.3).astype(np.float32)
    want = jtree_reduce(jnp.asarray(pkts), jnp.asarray(mask), rack_of,
                        compensation=comp)
    got = tree_reduce(torch.tensor(pkts), torch.tensor(mask), rack_of,
                      compensation=comp)
    assert got.dtype == torch.float32 and tuple(got.shape) == (n, p)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("layout", sorted(TREE_LAYOUTS))
def test_rack_groups_follow_jax_order(layout, monkeypatch):
    """The ``members`` / ``rack_ptr`` handed to the kernel list the racks
    and their members in the order the JAX tree_reduce reduces them,
    read off the slices it passes to its per-rack packet_reduce."""
    from repro.kernels import packet_reduce as jpr
    from repro_torch.kernels.packet_reduce import rack_groups

    w, rack_of = TREE_LAYOUTS[layout]
    seen = []

    def spy(sub_p, sub_m, **kw):
        seen.append([int(v) for v in np.asarray(sub_p)[:, 0, 0]])
        return jnp.zeros(sub_p.shape[1:], jnp.float32)

    monkeypatch.setattr(jpr, "packet_reduce", spy)
    ids = jnp.broadcast_to(jnp.arange(w, dtype=jnp.float32)[:, None, None],
                           (w, 2, 4))
    jpr.tree_reduce(ids, jnp.ones((w, 2)), rack_of)
    members, rack_ptr = rack_groups(rack_of, w)
    assert [members[a:b] for a, b in zip(rack_ptr, rack_ptr[1:])] == seen
    assert sorted(members) == list(range(w)) and rack_ptr[-1] == w



def _ef_inputs(n, p, seed=11):
    rng = np.random.default_rng(seed)
    flat = rng.normal(size=(n, p)).astype(np.float32)
    residual = rng.normal(size=(n, p)).astype(np.float32)
    mask = (rng.random(n) < 0.7).astype(np.float32)
    return flat, residual, mask


@pytest.mark.parametrize("n,p", [(37, 129), (1934, 360)])
def test_dropfill_ef_matches_jax_ef_gate(n, p):
    """The EF form (its plain route on the CPU) against the JAX package's
    per-gradient error-feedback gate over the Pallas dropfill in
    interpret mode: both are float32 add, gate and subtract, bit for
    bit."""
    from repro.config import LTPConfig as JLTPConfig
    from repro.runtime.step import build_ef_gate_fn as jbuild_ef_gate_fn

    flat, residual, mask = _ef_inputs(n, p)
    jgate = jbuild_ef_gate_fn(JLTPConfig(sync_backend="pallas",
                                         kernel_interpret=True))
    jsent, jres = jgate(jnp.asarray(flat), jnp.asarray(residual),
                        jnp.asarray(mask))
    sent, new_res = ops.ltp_dropfill_ef(torch.tensor(flat),
                                        torch.tensor(residual),
                                        torch.tensor(mask))
    assert sent.dtype == new_res.dtype == torch.float32
    assert np.array_equal(sent.numpy(), np.asarray(jsent))
    assert np.array_equal(new_res.numpy(), np.asarray(jres))
    assert np.any(np.asarray(jsent) == 0) and np.any(np.asarray(jres) == 0)


def test_dropfill_ef_outputs_are_fresh_and_other_dtypes_go_through_f32():
    flat, residual, mask = _ef_inputs(9, 10)
    f, r = torch.tensor(flat), torch.tensor(residual)
    r0 = r.clone()
    sent, new_res = ops.ltp_dropfill_ef(f, r, torch.tensor(mask))
    assert torch.equal(r, r0)
    assert sent.data_ptr() not in (f.data_ptr(), r.data_ptr())
    assert new_res.data_ptr() not in (f.data_ptr(), r.data_ptr())
    fh, rh = f.half(), r.half()
    sent_h, res_h = ops.ltp_dropfill_ef(fh, rh, torch.tensor(mask))
    s = fh.float() + rh.float()
    want = s * torch.tensor(mask)[:, None]
    assert sent_h.dtype == res_h.dtype == torch.float16
    assert torch.equal(sent_h, want.half())
    assert torch.equal(res_h, (s - want).half())


def test_dropfill_ef_rejects_bad_inputs():
    from repro_torch.kernels.dropfill import dropfill_ef
    z = torch.zeros(3, 4)
    with pytest.raises(ValueError, match=r"\(n, p\)"):
        dropfill_ef(torch.zeros(12), torch.zeros(12), torch.ones(3))
    with pytest.raises(ValueError, match=r"\(n, p\)"):
        dropfill_ef(z, torch.zeros(3, 5), torch.ones(3))
    with pytest.raises(ValueError, match=r"\(n,\)"):
        dropfill_ef(z, z, torch.ones(4))
    with pytest.raises(ValueError, match="CUDA device or on the CPU"):
        dropfill_ef(z, z, torch.ones(3, device="meta"))


@pytest.mark.parametrize("n,p", [(37, 129), (1934, 360)])
def test_apply_delivery_ef_backends_agree_on_cpu(n, p):
    """ltp_sync's EF gate: the python backend's three torch ops and the
    cuda backend (the kernel's plain version on CPU tensors) are
    identical, and neither writes the residual."""
    from repro_torch.core import ltp_sync as ls

    flat, residual, mask = _ef_inputs(n, p, seed=n)
    args = [torch.tensor(a) for a in (flat, residual, mask)]
    py = ls.apply_delivery_ef(*args, backend="python")
    cu = ls.apply_delivery_ef(*args, backend="cuda")
    auto = ls.apply_delivery_ef(*args, backend="auto")
    for got in (cu, auto):
        assert all(torch.equal(a, b) for a, b in zip(py, got))
    assert np.array_equal(args[1].numpy(), residual)
    s = args[0] + args[1]
    assert torch.equal(py[0], s * args[2][:, None])
    assert torch.equal(py[1], s - py[0])
