"""papernet, packetization and optimizers: the port against the JAX
package on identical parameters and inputs (numpy from a seed)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import TrainConfig as JTrainConfig
from repro.configs import get_config as jget_config
from repro.core import packets as jpk
from repro.models import build as jbuild
from repro.optim import adamw as jadamw
from repro.optim import make_optimizer as jmake_optimizer
from repro.optim import sgd_momentum as jsgd
from repro_torch.config import TrainConfig
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core import packets as pk
from repro_torch.models import build
from repro_torch.models.cnn import accuracy
from repro_torch.optim import adamw, lr_at, make_optimizer, sgd_momentum
from repro_torch.tree import tree_leaves, tree_map

SMALL = dict(d_model=8, n_layers=3)   # one block a stage: two stride-2 blocks


def _numpy_tree(cfg, seed):
    """JAX papernet's tree structure and shapes (no compile), filled
    with seeded numpy values."""
    shapes = jax.eval_shape(jbuild(cfg).init, jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda s: (rng.normal(size=s.shape) * 0.2).astype(np.float32), shapes)


@pytest.fixture(scope="module")
def full_width():
    cfg = jget_config("papernet")
    tree = _numpy_tree(cfg, 0)
    return tree, jpk.make_plan(tree, 360), pk.make_plan(
        params_from_numpy(tree, "cpu"), 360)


def test_full_width_plan_matches_jax(full_width):
    _, jplan, plan = full_width
    assert len(plan.leaf_shapes) == 43
    assert (plan.n_floats, plan.n_packets, plan.n_critical) == \
        (696_234, 1_934, 24)
    assert plan.packet_floats == jplan.packet_floats
    assert plan.n_floats == jplan.n_floats
    assert plan.n_packets == jplan.n_packets
    assert plan.leaf_shapes == jplan.leaf_shapes
    assert plan.leaf_offsets == jplan.leaf_offsets
    np.testing.assert_array_equal(plan.critical, jplan.critical)


def test_full_width_flatten_is_bitwise_jax(full_width):
    tree, jplan, plan = full_width
    params = params_from_numpy(tree, "cpu")
    want = np.asarray(jpk.flatten(jplan, tree))
    got = pk.flatten(plan, params)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    back = pk.unflatten(plan, got)
    for a, b in zip(tree_leaves(back), jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(a.numpy(), b)


def test_leaf_order_is_jax_order(full_width):
    tree, _, _ = full_width
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(tree)[0]]
    assert paths[:2] == ["['fc']", "['fc_b']"] and paths[-1] == \
        "['stem']['scale']"
    back = params_to_numpy(params_from_numpy(tree, "cpu"))
    for a, b in zip(tree_leaves(back), jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(a, b)
    assert list(back) == list(tree)   # the dict keeps its own key order


def test_flatten_with_worker_axis_stacks_streams(full_width):
    tree, _, plan = full_width
    params = params_from_numpy(tree, "cpu")
    stacked = tree_map(lambda x: torch.stack([x, 2 * x]), params)
    got = pk.flatten(plan, stacked)
    assert tuple(got.shape) == (2, plan.n_packets, plan.packet_floats)
    one = pk.flatten(plan, params)
    assert torch.equal(got[0], one) and torch.equal(got[1], 2 * one)


@pytest.mark.parametrize("packet_floats,crit", [(7, 1), (100, 2), (384, 1)])
def test_make_plan_matches_jax_on_odd_geometry(packet_floats, crit):
    rng = np.random.default_rng(packet_floats)
    tree = {"b": [rng.normal(size=(3, 5)).astype(np.float32),
                  np.float32(rng.normal())],
            "a": {"z": rng.normal(size=(13,)).astype(np.float32),
                  "y": rng.normal(size=(2, 2, 2)).astype(np.float32)}}
    jplan = jpk.make_plan(tree, packet_floats, crit)
    plan = pk.make_plan(params_from_numpy(tree, "cpu"), packet_floats, crit)
    assert (plan.n_packets, plan.leaf_offsets, plan.leaf_shapes) == \
        (jplan.n_packets, jplan.leaf_offsets, jplan.leaf_shapes)
    np.testing.assert_array_equal(plan.critical, jplan.critical)
    np.testing.assert_array_equal(
        pk.flatten(plan, params_from_numpy(tree, "cpu")).numpy(),
        np.asarray(jpk.flatten(jplan, tree)))


def test_delivery_mask_pins_criticals(full_width):
    _, _, plan = full_width
    gen = torch.Generator().manual_seed(3)
    m = pk.delivery_mask(plan, gen, 0.0)
    assert m.dtype == torch.float32
    np.testing.assert_array_equal(m.numpy(), plan.critical.astype(np.float32))
    m = pk.delivery_mask(plan, gen, 0.5).numpy()
    assert np.all(m[plan.critical] == 1.0)
    assert 0.4 < m[~plan.critical].mean() < 0.6
    assert torch.equal(pk.delivery_mask(plan, gen, 1.0),
                       torch.ones(plan.n_packets))


@pytest.fixture(scope="module")
def small_model():
    jcfg = jget_config("papernet").replace(**SMALL)
    japi = jbuild(jcfg)
    jparams = japi.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(2)
    batch = {"images": rng.normal(size=(16, 32, 32, 3)).astype(np.float32),
             "labels": rng.integers(0, 10, 16).astype(np.int32)}
    api = build(get_config("papernet").replace(**SMALL))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return japi, jparams, api, params, batch


def test_papernet_logits_match_jax(small_model):
    japi, jparams, api, params, batch = small_model
    want = japi.forward(jparams, jnp.asarray(batch["images"]))
    got = api.forward(params, torch.tensor(batch["images"]))
    # float32 convolutions summed in another order (XLA vs oneDNN)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-5)


def test_papernet_loss_and_grads_match_jax(small_model):
    japi, jparams, api, params, batch = small_model
    jloss, jgrads = jax.value_and_grad(
        lambda p: japi.loss_fn(p, {k: jnp.asarray(v)
                                   for k, v in batch.items()}))(jparams)
    tbatch = {k: torch.tensor(v) for k, v in batch.items()}
    grads, loss = torch.func.grad_and_value(
        lambda p: api.loss_fn(p, tbatch))(params)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4)
    jleaves = jax.tree_util.tree_leaves(jgrads)
    leaves = tree_leaves(grads)
    assert len(leaves) == len(jleaves)
    for g, jg in zip(leaves, jleaves):
        # rtol 1e-4 as the loss; atol for entries that cancel to ~0
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-4,
                                   atol=1e-6)


def test_papernet_accuracy_and_own_init(small_model):
    japi, jparams, api, params, batch = small_model
    tbatch = {k: torch.tensor(v) for k, v in batch.items()}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    from repro.models.cnn import accuracy as jaccuracy
    jacc = float(jaccuracy(japi.cfg, jparams, jbatch))
    assert float(accuracy(api.cfg, params, tbatch)) == pytest.approx(jacc)
    own = api.init(torch.Generator().manual_seed(0), device="cpu")
    assert [tuple(x.shape) for x in tree_leaves(own)] == \
        [tuple(x.shape) for x in tree_leaves(params)]
    again = api.init(torch.Generator().manual_seed(0), device="cpu")
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(own), tree_leaves(again)))


def _opt_case(seed):
    rng = np.random.default_rng(seed)
    shapes = {"w": (3, 4), "b": (4,), "s": [(2, 2), (5,)]}
    mk = lambda: jax.tree.map(  # noqa: E731
        lambda s: rng.normal(size=s).astype(np.float32), shapes,
        is_leaf=lambda x: isinstance(x, tuple))
    return mk(), mk()


@pytest.mark.parametrize("which", ["sgdm", "sgdm_wd_nesterov", "adamw",
                                   "adamw_wd"])
def test_optimizer_update_matches_jax(which):
    params, grads = _opt_case(4)
    jopt, opt = {
        "sgdm": (jsgd(), sgd_momentum()),
        "sgdm_wd_nesterov": (jsgd(0.9, 1e-2, True),
                             sgd_momentum(0.9, 1e-2, True)),
        "adamw": (jadamw(), adamw()),
        "adamw_wd": (jadamw(weight_decay=0.1), adamw(weight_decay=0.1)),
    }[which]
    jp = jax.tree.map(jnp.asarray, params)
    jg = jax.tree.map(jnp.asarray, grads)
    tp = params_from_numpy(params, "cpu")
    tg = params_from_numpy(grads, "cpu")
    jstate, state = jopt.init(jp), opt.init(tp)
    for _ in range(2):   # two updates: the second reads the state
        jupd, jstate = jopt.update(jg, jstate, jp, jnp.float32(0.05))
        upd, state = opt.update(tg, state, tp, 0.05)
        for a, b in zip(tree_leaves(upd), jax.tree_util.tree_leaves(jupd)):
            # elementwise float32; sqrt/division may differ by an ulp
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-8)


def test_make_optimizer_memoises_and_lr_schedule():
    tc = TrainConfig(lr=0.1, lr_decay_every=2, lr_decay=0.5)
    assert make_optimizer(tc) is make_optimizer(TrainConfig(lr=0.1))
    assert make_optimizer(TrainConfig(optimizer="adamw")) is \
        adamw(weight_decay=0.0)
    jtc = JTrainConfig(lr=0.1, lr_decay_every=2, lr_decay=0.5)
    from repro.optim import lr_at as jlr_at
    for step in (0, 5, 9, 10, 31):
        assert lr_at(tc, step, 5) == jlr_at(jtc, step, 5)
    assert jmake_optimizer(jtc) is jmake_optimizer(JTrainConfig(lr=0.1))
