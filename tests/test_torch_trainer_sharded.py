"""The sharded train step (``repro_torch.train.trainer``) against the JAX
package's ``train/trainer.py``, on the CPU, at REDUCED smollm-360m cut to
2 layers, float32, SGD-momentum at lr 0.1.

- World size 1, in this process (a gloo group of one rank against a
  (1, 1) JAX mesh, the JAX step jitted): the psum variant under paper,
  count and expected compensation and the ZeRO variant under paper and
  count, at delivered fractions 1.0 and 0.7, from the same params and
  batch, with the reference's draws fed through ``uniforms=``; the plain
  step; and ``tests/test_trainer.py``'s two checks mirrored.
- Two gloo ranks (``sharded_cases.py``), one step of each variant
  against the JAX step under ``shard_map`` on 2 host devices, each rank
  on its block of the batch; and a planted fault, the rank-to-worker
  mapping reversed, which must disagree. The JAX step runs with its
  ``shard_map`` check off: with it on, JAX sums the workers' gradients
  before the masking (a fault of the reference, shown by
  ``test_reference_step_sums_worker_grads_under_its_check``).

Tolerances: those of ``tests/test_trainer.py``: params rtol 2e-4 / atol
2e-5 (a backward over another op order), loss rtol 1e-5; the delivered
fraction exactly.
"""
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import sharded_cases as sc
from repro import compat
from repro.config import LTPConfig as JLTPConfig
from repro.configs import get_reduced as jget_reduced
from repro.core import ltp_sync as jls
from repro.models import build as jbuild
from repro.optim import sgd_momentum as jsgd
from repro.train import trainer as jtr
from repro_torch.config import LTPConfig
from repro_torch.configs import get_reduced
from repro_torch.convert import params_from_numpy
from repro_torch.models import build
from repro_torch.optim import sgd_momentum
from repro_torch.train import trainer as tr
from repro_torch.tree import tree_leaves

LR = 0.1
PARAM_TOL = dict(rtol=2e-4, atol=2e-5)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mesh1(tmp_path_factory):
    with sc.world_of_one(str(tmp_path_factory.mktemp("world1"))) as mesh:
        yield mesh


@pytest.fixture(scope="module")
def setup():
    """JAX and port APIs, the JAX init and the same params in the port,
    and a (4, 16) batch from a numpy seed."""
    jcfg, cfg = sc.train_cfg(jget_reduced), sc.train_cfg(get_reduced)
    japi, api = jbuild(jcfg), build(cfg)
    jstate = jtr.init_state(japi, jsgd(), jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jstate.params),
                               "cpu")
    rng = np.random.default_rng(1)
    batch = {k: rng.integers(0, cfg.vocab, (4, 16)).astype(np.int32)
             for k in ("tokens", "labels")}
    return japi, api, jstate, params, batch


def _specs():
    return ({"tokens": P(), "labels": P()},
            {"tokens": (), "labels": ()})


@functools.lru_cache(maxsize=None)
def _jax_step(japi, comp):
    mesh = compat.make_mesh((1, 1), ("data", "model"))
    return mesh, jax.jit(jtr.make_ltp_train_step(
        japi, jsgd(), mesh, JLTPConfig(compensation=comp), ("data",),
        _specs()[0]))


def _uniforms(params, key, w=0):
    k = jax.random.fold_in(key, w)
    return [np.asarray(jax.random.uniform(
        jax.random.fold_in(k, i), (max(1, -(-x.size // 360)),)))
        for i, x in enumerate(jax.tree.leaves(params))]


def _zero_state(jstate, ltp):
    m = jls.zero_momentum_shapes(jax.eval_shape(lambda: jstate.params), ltp, 1)
    return jtr.TrainState(jstate.params, {"m_pkts": [
        jnp.zeros(s.shape, s.dtype) for s in m]}, jstate.step)


def _close_params(got, want):
    for a, b in zip(tree_leaves(got), jax.tree.leaves(want), strict=True):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **PARAM_TOL)


@pytest.mark.parametrize("frac", [1.0, 0.7])
@pytest.mark.parametrize("variant,comp", sc.TRAIN_CASES)
def test_ltp_step_matches_jax(setup, mesh1, variant, comp, frac):
    japi, api, jstate, params, batch = setup
    key = jax.random.PRNGKey(3)
    mesh, jstep = _jax_step(japi, comp)
    ltp = LTPConfig(compensation=comp)
    st = tr.init_state(api, sgd_momentum(), params=params)
    jst = jstate
    if variant == "zero":
        jst = _zero_state(jstate, JLTPConfig(compensation=comp))
        st.opt_state = tr.zero_opt_state(params, ltp, mesh1, ("data",))
    with compat.set_mesh(mesh):
        jnew, jm = jstep(jst, {k: jnp.asarray(v) for k, v in batch.items()},
                         jnp.full((1,), frac), key, jnp.float32(LR))
    step = tr.make_ltp_train_step(api, sgd_momentum(), mesh1, ltp,
                                  ("data",), _specs()[1])
    new, m = step(st, batch, torch.full((1,), frac), 0, LR,
                  uniforms=_uniforms(jstate.params, key))
    _close_params(new.params, jnew.params)
    if variant == "zero":
        for a, b in zip(new.opt_state["m_pkts"], jnew.opt_state["m_pkts"],
                        strict=True):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **PARAM_TOL)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    assert float(m["delivered_frac"]) == float(jm["delivered_frac"])
    assert int(new.step) == int(jnew.step) == 1


def test_plain_step_matches_jax(setup, mesh1):
    japi, api, jstate, params, batch = setup
    jnew, jm = jax.jit(jtr.make_plain_train_step(japi, jsgd()))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()},
        jnp.float32(LR))
    for mesh in (None, mesh1):
        st = tr.init_state(api, sgd_momentum(), params=params)
        new, m = tr.make_plain_train_step(api, sgd_momentum(), mesh)(
            st, batch, LR)
        _close_params(new.params, jnew.params)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5)


def test_ltp_full_delivery_matches_plain(setup, mesh1):
    """``tests/test_trainer.py``'s check, in the port alone."""
    _, api, _, params, batch = setup
    plain, _ = tr.make_plain_train_step(api, sgd_momentum())(
        tr.init_state(api, sgd_momentum(), params=params), batch, LR)
    step = tr.make_ltp_train_step(api, sgd_momentum(), mesh1,
                                  LTPConfig(packet_floats=128), ("data",),
                                  _specs()[1])
    new, m = step(tr.init_state(api, sgd_momentum(), params=params), batch,
                  torch.ones(1), 2, LR)
    assert float(m["delivered_frac"]) == 1.0
    for a, b in zip(tree_leaves(plain.params), tree_leaves(new.params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **PARAM_TOL)


def test_ltp_zero_variant_matches_psum_variant(setup, mesh1):
    """``tests/test_trainer.py``'s check, in the port alone, with the
    port's own draws (the same seed gives both variants the same
    masks)."""
    _, api, _, params, batch = setup
    ltp = LTPConfig(packet_floats=128)
    step = tr.make_ltp_train_step(api, sgd_momentum(), mesh1, ltp,
                                  ("data",), _specs()[1])
    frac = torch.full((1,), 0.7)
    s_psum, _ = step(tr.init_state(api, sgd_momentum(), params=params),
                     batch, frac, 3, LR)
    zs = tr.init_state(api, sgd_momentum(), params=params)
    zs.opt_state = tr.zero_opt_state(params, ltp, mesh1, ("data",))
    s_zero, m_zero = step(zs, batch, frac, 3, LR)
    for a, b in zip(tree_leaves(s_psum.params), tree_leaves(s_zero.params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **PARAM_TOL)
    assert 0.3 < float(m_zero["delivered_frac"]) <= 1.0


def test_non_worker_axis_needs_tensor_parallelism(setup):
    """A ``model`` axis > 1 runs tensor-parallel for every family
    (``tests/test_torch_tensor_parallel.py``,
    ``tests/test_torch_tp_families.py``): no family is refused any more.
    Nor are the two former refusals: the ZeRO variant at ``model`` > 1
    (its state holds the global leaves' packet rows) and a non-worker
    ``pod`` / ``data`` axis (data parallelism inside a worker) build a
    step (``tests/test_torch_trainer_13e.py`` runs both). An axis that
    is neither a worker axis, ``pod``, ``data`` nor ``model`` is
    refused."""
    _, api, _, params, _ = setup
    for name in ("TP_FAMILIES", "_check_tp", "_refuse_zero"):
        assert not hasattr(tr, name)
    for mesh in ({"data": 2, "model": 2}, {"pod": 2, "data": 1,
                                            "model": 4},
                 {"pod": 2, "data": 2, "model": 2}):
        tr._check_mesh(mesh, ("pod", "data"))
        tr._check_mesh(mesh, ("pod",))
    ltp = LTPConfig()
    st = tr.zero_opt_state(params, ltp, {"data": 1, "model": 2}, ("data",))
    assert [tuple(m.shape) for m in st["m_pkts"]] == \
        jls_shapes(params, ltp, 1)
    st = tr.zero_opt_state(params, ltp, {"pod": 2, "data": 2, "model": 2},
                           ("pod",))
    assert [tuple(m.shape) for m in st["m_pkts"]] == [
        (n // 2, p) for n, p in jls_shapes(params, ltp, 2)]
    for mesh, axes in (({"pod": 2, "data": 2}, ("pod",)),
                       ({"pod": 2, "data": 2, "model": 1}, ("pod",)),
                       ({"pod": 1, "data": 4}, ("pod",))):
        assert callable(tr.make_ltp_train_step(
            api, sgd_momentum(), mesh, ltp, axes, _specs()[1]))
    with pytest.raises(NotImplementedError, match="'seq'"):
        tr.make_plain_train_step(api, sgd_momentum(),
                                 {"data": 2, "seq": 2, "model": 1})
    with pytest.raises(NotImplementedError, match="'seq'"):
        tr.make_ltp_train_step(api, sgd_momentum(), {"data": 2, "seq": 2},
                               ltp, ("data",), _specs()[1])


def jls_shapes(params, ltp, w):
    """The JAX package's momentum shapes over the same leaves."""
    shapes = [jax.ShapeDtypeStruct(tuple(x.shape), jnp.float32)
              for x in tree_leaves(params)]
    return [tuple(s.shape) for s in jls.zero_momentum_shapes(
        shapes, JLTPConfig(packet_floats=ltp.packet_floats), w)]


def test_init_state_runs_on_the_card_unless_told(setup, monkeypatch):
    _, api, _, _, _ = setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tr.init_state(api, sgd_momentum())
    st = tr.init_state(api, sgd_momentum(), 0, device="cpu")
    assert int(st.step) == 0 and tree_leaves(st.params)[0].device.type == "cpu"


def test_launcher_sharded_mode_at_world_size_one(tmp_path):
    """``python -m repro_torch.launch.train --mode sharded`` without
    ``torchrun``: world size 1 over a ``file://`` rendezvous, gloo on the
    CPU, a checkpoint written."""
    ckpt = str(tmp_path / "ck")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--mode",
         "sharded", "--reduced", "--steps", "2", "--batch", "4", "--seq",
         "16", "--device", "cpu", "--ckpt", ckpt],
        env=sc.env(), capture_output=True, text=True, timeout=sc.TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "backend gloo" in proc.stdout and "step    0 loss" in proc.stdout
    assert os.path.exists(ckpt + ".npz")


# ----------------------------------------------------------------------------
# two ranks against the JAX step on two host devices
# ----------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("sharded_train"))
    path = f"{d}/ref.npz"
    return path, sc.run_jax("train", path), d


@pytest.fixture(scope="module")
def ranks2(ref):
    path, _, d = ref
    return sc.run_ranks("train", 2, path, d)


@pytest.mark.parametrize("variant,comp", sc.TRAIN_CASES)
def test_two_ranks_train_step_matches_jax(ref, ranks2, variant, comp):
    z = ref[1]
    base = f"{variant}/{comp}"
    n = sum(1 for k in z if k.startswith("in/params/"))
    for w, r in enumerate(ranks2):
        for i in range(n):
            np.testing.assert_allclose(r[f"{base}/params/{i}"],
                                       z[f"out/{base}/params/{i}"],
                                       **PARAM_TOL)
            if variant == "zero":
                want = z[f"out/{base}/m/{i}"]
                np.testing.assert_allclose(
                    r[f"{base}/m/{i}"],
                    want.reshape((sc.W, -1) + want.shape[1:])[w],
                    **PARAM_TOL)
        np.testing.assert_allclose(r[f"{base}/loss"], z[f"out/{base}/loss"],
                                   rtol=1e-5)
        assert float(r[f"{base}/realized"]) == float(
            z[f"out/{base}/realized"])
        assert int(r[f"{base}/step"]) == 1


def test_two_ranks_plain_step_routes_moe_by_data_shard(ref, ranks2):
    """The plain step on REDUCED mixtral over 2 ranks: each rank routes
    its half of the batch as one group, the reference's ``g_count = 2``
    groups under GSPMD, and the averaged gradients and loss match."""
    z = ref[1]
    n = sum(1 for k in z if k.startswith("in/moe_params/"))
    for r in ranks2:
        for i in range(n):
            np.testing.assert_allclose(r[f"plain_moe/params/{i}"],
                                       z[f"out/plain_moe/params/{i}"],
                                       **PARAM_TOL)
        np.testing.assert_allclose(r["plain_moe/loss"],
                                   z["out/plain_moe/loss"], rtol=1e-5)


def test_reference_step_sums_worker_grads_under_its_check(ref, ranks2):
    """The reference's own step (``check=True``) at full delivery over 2
    workers moves the params W = 2 times as far as the same code with
    the check off, which the port's step matches: the reference masks
    the workers' summed gradient (ROADMAP.md §3)."""
    z = ref[1]
    n = sum(1 for k in z if k.startswith("in/params/"))
    for i in range(n):
        p0 = z[f"in/params/{i}"]
        for r in ranks2:
            np.testing.assert_allclose(r[f"full/params/{i}"],
                                       z[f"out/unchecked_full/params/{i}"],
                                       **PARAM_TOL)
        np.testing.assert_allclose(
            z[f"out/checked_full/params/{i}"] - p0,
            sc.W * (z[f"out/unchecked_full/params/{i}"] - p0),
            rtol=1e-3, atol=1e-6)


def test_wrong_rank_to_worker_mapping_fails(ref, ranks2):
    """A planted fault: the psum step with each rank's worker index
    reversed (its frac and its block of the batch swapped) fails the
    comparison that holds for the right mapping."""
    z = ref[1]
    n = sum(1 for k in z if k.startswith("in/params/"))
    with pytest.raises(AssertionError):
        for r in ranks2:
            for i in range(n):
                np.testing.assert_allclose(
                    r[f"plant/psum/paper/params/{i}"],
                    z[f"out/psum/paper/params/{i}"], **PARAM_TOL)
