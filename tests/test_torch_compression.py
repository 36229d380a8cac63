"""The compression slice: the port's core/compression.py and its Fig 5
training loop (train/compressed.py, on the CPU) against the JAX
package's core/compression.py and a JAX loop written from the JAX
package's own functions as benchmarks/fig5_randomk_topk.py::_train
writes it. Inputs come from numpy with a seed; Random-k gets JAX's own
uniforms through ``u=`` / ``uniforms=``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import TrainConfig as JTrainConfig
from repro.configs import get_config as jget_config
from repro.core import compression as jcomp
from repro.data import SyntheticCIFAR as JSyntheticCIFAR
from repro.data import batches as jbatches
from repro.models import build as jbuild
from repro.models.cnn import accuracy as jaccuracy
from repro.optim import make_optimizer as jmake_optimizer
from repro_torch.config import TrainConfig
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import compression
from repro_torch.data import SyntheticCIFAR
from repro_torch.kernels import randomk as rk_mod
from repro_torch.train.compressed import fig5_rows, train_compressed
from repro_torch.tree import tree_leaves

N_FULL = 696_234          # full-width papernet's parameter count
SMALL = dict(d_model=8, n_layers=3)


def _full_width_grads(seed=0):
    """Gradient-like trees of full-width papernet's shapes: the JAX tree
    (jnp leaves) and the same values as the port's tree."""
    shapes = jax.eval_shape(jbuild(jget_config("papernet")).init,
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    np_tree = jax.tree.map(
        lambda s: rng.normal(0, 1e-3, s.shape).astype(np.float32), shapes)
    return jax.tree.map(jnp.asarray, np_tree), params_from_numpy(np_tree,
                                                                 "cpu")


def _residual(use, seed=1):
    if not use:
        return None, None
    rng = np.random.default_rng(seed)
    r = rng.normal(0, 1e-4, N_FULL).astype(np.float32)
    return jnp.asarray(r), torch.tensor(r)


def _assert_same(jtree, jres, tree, res):
    jl = jax.tree_util.tree_leaves(jtree)
    tl = tree_leaves(tree)
    assert len(jl) == len(tl) == 43
    for a, b in zip(tl, jl):
        assert tuple(a.shape) == b.shape
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(res.numpy(), np.asarray(jres))


def test_full_width_tree_flattens_in_jax_order():
    jg, g = _full_width_grads()
    jflat, _ = jcomp._flatten(jg)
    flat, meta = compression._flatten(g)
    assert flat.shape == (N_FULL,)
    np.testing.assert_array_equal(flat.numpy(), np.asarray(jflat))
    back = compression._unflatten(flat, meta)
    for a, b in zip(tree_leaves(back), tree_leaves(g)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("k", [0.05, 0.1, 0.4])
@pytest.mark.parametrize("with_residual", [False, True])
def test_random_k_matches_jax(k, with_residual):
    """JAX's uniforms fed through ``u=``: kept leaves and the residual are
    exact (the select and JAX's multiply differ only in the sign of a
    dropped zero, which compares equal)."""
    jg, g = _full_width_grads()
    jr, r = _residual(with_residual)
    key = jax.random.PRNGKey(4)
    u = np.asarray(jax.random.uniform(key, (N_FULL,)))
    jkept, jres = jcomp.random_k(jg, k, key, jr)
    kept, res = compression.random_k(g, k, None, r, u=torch.tensor(u),
                                     backend="cuda")
    _assert_same(jkept, jres, kept, res)
    # the plain route gives the same answer
    kept_p, res_p = compression.random_k(g, k, None, r, u=torch.tensor(u),
                                         backend="python")
    _assert_same(jkept, jres, kept_p, res_p)


def test_random_k_draws_from_the_generator():
    _, g = _full_width_grads()
    a, _ = compression.random_k(g, 0.1, torch.Generator().manual_seed(3))
    b, _ = compression.random_k(g, 0.1, torch.Generator().manual_seed(3))
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert torch.equal(x, y)
    density = float(compression.measure_density(a))
    assert abs(density - 0.1) < 0.005


def test_random_k_cpu_route_counts_no_launch():
    _, g = _full_width_grads()
    before = rk_mod.LAUNCHES
    compression.random_k(g, 0.1, torch.Generator().manual_seed(0),
                         backend="cuda")
    assert rk_mod.LAUNCHES == before


@pytest.mark.parametrize("k", [0.05, 0.1, 0.4])
@pytest.mark.parametrize("with_residual", [False, True])
def test_top_k_matches_jax(k, with_residual):
    jg, g = _full_width_grads()
    jr, r = _residual(with_residual)
    jkept, jres = jcomp.top_k(jg, k, jr)
    kept, res = compression.top_k(g, k, r)
    _assert_same(jkept, jres, kept, res)


def test_top_k_strided_sample_matches_jax():
    """A sample_cap below the gradient's size takes the strided estimate
    (stride 696,234 // 50,000 = 13)."""
    jg, g = _full_width_grads(seed=2)
    jr, r = _residual(True, seed=3)
    jkept, jres = jcomp.top_k(jg, 0.1, jr, sample_cap=50_000)
    kept, res = compression.top_k(g, 0.1, r, sample_cap=50_000)
    _assert_same(jkept, jres, kept, res)


@pytest.mark.parametrize("k", [0.1, 0.4])
def test_measure_density_matches_jax(k):
    jg, g = _full_width_grads()
    jkept, _ = jcomp.top_k(jg, k)
    kept, _ = compression.top_k(g, k)
    # float32 means of the same {0,1} values, summed in another order
    np.testing.assert_allclose(float(compression.measure_density(kept)),
                               float(jcomp.measure_density(jkept)),
                               rtol=1e-6)


# ---------------------------------------------------------------------------
# the Fig 5 loop, small: d_model 8, 3 layers, batch 32, 4 steps

STEPS = 4
BATCH = 32


def _jax_train(kind, k):
    """benchmarks/fig5_randomk_topk.py::_train, written out from the JAX
    package's functions; also returns its init, its per-step losses and
    the uniforms each Random-k step drew."""
    cfg = jget_config("papernet").replace(**SMALL)
    api = jbuild(cfg)
    tc = JTrainConfig(batch=BATCH, lr=0.05)
    opt = jmake_optimizer(tc)
    params = api.init(jax.random.PRNGKey(0))
    init = jax.tree.map(np.asarray, params)
    state = opt.init(params)
    residual = None
    key = jax.random.PRNGKey(1)
    step = jax.jit(lambda p, b: jax.value_and_grad(
        lambda q: api.loss_fn(q, b))(p))
    data = JSyntheticCIFAR(seed=3)
    losses, uniforms = [], []
    for b in jbatches(data, tc.batch, STEPS):
        b = {name: jnp.asarray(v) for name, v in b.items()}
        loss, grads = step(params, b)
        if kind == "topk":
            grads, residual = jcomp.top_k(grads, k, residual)
        elif kind == "randomk":
            key, sub = jax.random.split(key)
            n = sum(x.size for x in jax.tree_util.tree_leaves(grads))
            uniforms.append(np.array(jax.random.uniform(sub, (n,))))
            grads, residual = jcomp.random_k(grads, k, sub, residual)
        losses.append(float(loss))
        upd, state = opt.update(grads, state, params, jnp.float32(tc.lr))
        params = jax.tree.map(lambda p, u: p + u, params, upd)
    test = {name: jnp.asarray(v) for name, v in data.test_set(256).items()}
    acc = float(jaccuracy(cfg, params, test))
    return init, losses, uniforms, params, acc


@pytest.mark.parametrize("kind,k", [("none", 1.0), ("randomk", 0.1),
                                    ("topk", 0.1)])
def test_train_compressed_matches_jax_loop(kind, k):
    init, jlosses, uniforms, jparams, jacc = _jax_train(kind, k)
    data = SyntheticCIFAR(seed=3)
    acc, sel, hist, params = train_compressed(
        get_config("papernet").replace(**SMALL),
        TrainConfig(batch=BATCH, lr=0.05), data, data.test_set(256), kind,
        k, STEPS, device="cpu", params=params_from_numpy(init, "cpu"),
        uniforms=uniforms or None, return_params=True)
    assert [h["step"] for h in hist] == list(range(STEPS))
    assert sel >= 0.0 and all(h["seconds"] > 0.0 for h in hist)
    assert 0.0 <= acc <= 1.0
    losses = [h["loss"] for h in hist]
    if kind == "topk":
        # grads differ in the last bits between the frameworks and can
        # move an element across the threshold
        np.testing.assert_allclose(losses, jlosses, rtol=1e-3)
        assert all(abs(h["density"] - k) < 0.01 for h in hist)
        return
    # conv grads summed in another order (XLA vs oneDNN), as
    # tests/test_torch_trainer.py holds the PS trainer
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    leaves, jleaves = tree_leaves(params), jax.tree_util.tree_leaves(jparams)
    assert len(leaves) == len(jleaves)
    for a, b in zip(leaves, jleaves):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4,
                                   atol=2e-5)
    assert abs(acc - jacc) <= 2 / 256
    if kind == "randomk":
        assert all(abs(h["density"] - k) < 0.01 for h in hist)


def test_train_compressed_own_init_is_reproducible():
    """Without ``params`` and ``uniforms`` the loop initialises and draws
    from its own seeded generators, reproducibly."""
    cfg = get_config("papernet").replace(d_model=4, n_layers=3)
    data = SyntheticCIFAR(seed=3)
    tc = TrainConfig(batch=16, lr=0.05)

    def run():
        return train_compressed(cfg, tc, data, data.test_set(32), "randomk",
                                0.4, 2, device="cpu", seed=5)

    a, b = run(), run()
    assert a[0] == b[0]
    assert [(h["loss"], h["kept"]) for h in a[2]] == \
        [(h["loss"], h["kept"]) for h in b[2]]
    with pytest.raises(ValueError, match="kind"):
        train_compressed(cfg, tc, data, data.test_set(32), "sparse", 0.4, 1,
                         device="cpu")


def test_fig5_rows_keep_the_jax_rows_keys(monkeypatch):
    """fig5_rows builds the rows of fig5_randomk_topk.run under the same
    keys; the training itself is stubbed here (covered above)."""
    from repro_torch.train import compressed as mod
    seen = []

    def fake(cfg, tc, data, test, kind, k, steps, *, device=None):
        seen.append((cfg.d_model, cfg.n_layers, tc.batch, kind, k, steps,
                     device, len(test["labels"])))
        return 0.5, 0.007, []

    monkeypatch.setattr(mod, "train_compressed", fake)
    rows = fig5_rows(quick=True, device="cpu")
    assert seen[0] == (8, 3, 128, "none", 1.0, 30, "cpu", 1024)
    assert [(r["kind"], r["k"]) for r in rows] == [
        ("dense", 1.0), ("randomk", 0.1), ("topk", 0.1), ("randomk", 0.4),
        ("topk", 0.4)]
    assert rows[0] == {"kind": "dense", "k": 1.0, "top1": 0.5,
                       "rel_throughput": 1.0}
    assert rows[1] == {"kind": "randomk", "k": 0.1, "top1": 0.5,
                       "sel_overhead_ms": 7.0,
                       "rel_throughput": round(0.07 / 0.077, 3)}
    mod_rows = fig5_rows(quick=False, device="cpu")
    assert len(mod_rows) == 13 and seen[5][:2] == (16, 6)


def _chip_smoke():
    """chip_smoke.py at the repo root, imported as a module (it imports
    nothing of the port at top level)."""
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(__file__), os.pardir, "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_profile_step_of_a_cpu_callable_has_no_device_time():
    """chip_smoke's profile of a callable that runs no device kernel: no
    idle share, no port kernels, a positive host time."""
    prof = _chip_smoke().profile_step(torch, lambda: torch.ones(64).sum())
    assert prof["idle_share"] is None and prof["n_kernels"] == 0
    assert prof["port_kernels_ms"] == {} and prof["port_launches"] == {}
    assert prof["wall_ms"] > 0.0


def test_profile_step_reads_one_train_compressed_step():
    """The Fig 5 profile's windows: train_compressed opens one named span
    a step and one for its select; the profile reads the host time of
    the step asked for, which is part of the whole run's, and raises on a
    span that the run did not open."""
    cs = _chip_smoke()
    cfg = get_config("papernet").replace(d_model=4, n_layers=3)
    data = SyntheticCIFAR(seed=3)

    def run():
        train_compressed(cfg, TrainConfig(batch=16, lr=0.05), data,
                         data.test_set(16), "randomk", 0.1, 2, device="cpu")

    whole = cs.profile_step(torch, run)
    step = cs.profile_step(torch, run, step="train_compressed step 1",
                           select="train_compressed select")
    assert 0.0 < step["wall_ms"] < whole["wall_ms"]
    assert step["idle_share"] is None and step["port_kernels_ms"] == {}
    with pytest.raises(AssertionError, match="0 spans"):
        cs.profile_step(torch, run, step="train_compressed step 2")
