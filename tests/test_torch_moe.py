"""The mixture-of-experts layer (``repro_torch.models.moe``) against the
JAX package's ``models/moe.py``, on the CPU, at float32, on the REDUCED
configs of mixtral-8x22b (4 experts, top-2) and deepseek-v2 (4 routed
experts, top-2, one shared).

Params come from the JAX init (``moe_params``) through
``params_from_numpy``; inputs are numpy draws from a seed. Tolerances:
float32 outputs (router weights and aux, the dispatch buffer, the
combine, ``apply_moe``'s output, aux and grads) rtol 1e-5 / atol 1e-6;
expert ids, the sort order, the slots ``pos_c`` and ``capacity``
exactly. A ``capacity_factor`` of 0.25 drops tokens at capacity, and
the test checks that it does."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad, vmap

from repro.configs import get_reduced as jget_reduced
from repro.models import moe as jmoe
from repro_torch.configs import get_reduced
from repro_torch.convert import params_from_numpy
from repro_torch.models import moe
from repro_torch.tree import tree_leaves, tree_leaves_with_path, tree_map

ARCHS = ["mixtral_8x22b", "deepseek_v2_236b"]
B, S = 2, 16
F32 = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module", params=ARCHS)
def moe_pair(request):
    """(jax cfg, port cfg, jax params, port params) of one REDUCED arch."""
    jcfg = jget_reduced(request.param).replace(dtype="float32")
    cfg = get_reduced(request.param).replace(dtype="float32")
    jp = jmoe.moe_params(jax.random.PRNGKey(3), jcfg, jnp.float32)
    return jcfg, cfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp),
                                            "cpu")


def _x(cfg, b=B, s=S, seed=0):
    return np.random.default_rng(seed).normal(
        size=(b, s, cfg.d_model)).astype(np.float32)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(tol or F32))


def test_params_tree_matches_jax(moe_pair):
    jcfg, cfg, jp, _ = moe_pair
    own = moe.moe_params(torch.Generator().manual_seed(0), cfg,
                         torch.bfloat16)
    jown = jmoe.moe_params(jax.random.PRNGKey(0), jcfg, jnp.bfloat16)
    got = [(p, tuple(x.shape), str(x.dtype).replace("torch.", ""))
           for p, x in tree_leaves_with_path(own)]
    want = [(tuple(k.key for k in p), x.shape, str(x.dtype)) for p, x in
            jax.tree_util.tree_flatten_with_path(jown)[0]]
    assert got == want
    # the router stays float32 in a bfloat16 model
    assert own["moe_gate"].dtype == torch.float32
    assert ("shared" in own) == (cfg.n_shared_experts > 0)


@pytest.mark.parametrize("n", [1, 7, 16, 32, 333])
@pytest.mark.parametrize("factor", [1.25, 0.25, 2.0])
def test_capacity_matches_jax(moe_pair, n, factor):
    jcfg, cfg, _, _ = moe_pair
    assert moe.capacity(cfg, n, factor) == jmoe.capacity(jcfg, n, factor)
    assert moe.moe_ff(cfg) == jmoe.moe_ff(jcfg)


def test_router_matches_jax(moe_pair):
    jcfg, cfg, jp, tp = moe_pair
    xf = _x(cfg).reshape(B * S, cfg.d_model)
    jw, jids, jaux = jmoe.router(jcfg, jp, jnp.asarray(xf))
    w, ids, aux = moe.router(cfg, tp, torch.as_tensor(xf))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    _close(w, jw)
    _close(aux, jaux)


def test_router_ties_take_the_lower_index_first():
    """Equal router columns give exactly equal probabilities: the expert
    ids come in jax.lax.top_k's order, the lower index first."""
    jcfg = jget_reduced("mixtral_8x22b").replace(dtype="float32")
    cfg = get_reduced("mixtral_8x22b").replace(dtype="float32")
    rng = np.random.default_rng(5)
    col = rng.normal(size=(cfg.d_model, 1)).astype(np.float32)
    other = rng.normal(size=(cfg.d_model, 1)).astype(np.float32)
    gate = np.concatenate([other, col, col, col], axis=1) * 0.02
    xf = rng.normal(size=(24, cfg.d_model)).astype(np.float32)
    jw, jids, _ = jmoe.router(jcfg, {"moe_gate": jnp.asarray(gate)},
                              jnp.asarray(xf))
    w, ids, _ = moe.router(cfg, {"moe_gate": torch.as_tensor(gate)},
                           torch.as_tensor(xf))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    _close(w, jw)
    # rows where the tied experts win hold two of them, lower first
    tied = (ids >= 1).all(dim=1)
    assert tied.any()
    assert (ids[tied, 0] < ids[tied, 1]).all()


@pytest.mark.parametrize("factor", [1.25, 0.25])
def test_route_and_combine_match_jax(moe_pair, factor):
    jcfg, cfg, jp, tp = moe_pair
    t = B * S
    xf = _x(cfg, seed=1).reshape(t, cfg.d_model)
    cap = moe.capacity(cfg, t, factor)
    jout = jmoe._route_group(jcfg, jp, jnp.asarray(xf), cap)
    out = moe._route_group(cfg, tp, torch.as_tensor(xf), cap)
    jbuf, jsid, jpos, jtok, jsw, jaux = jout
    buf, sid, pos, tok, sw, aux = out
    assert tuple(buf.shape) == (cfg.n_experts, cap, cfg.d_model)
    for a, b in ((sid, jsid), (pos, jpos), (tok, jtok)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    _close(buf, jbuf)
    _close(sw, jsw)
    _close(aux, jaux)
    dropped = int((pos == cap).sum())
    assert (dropped > 0) == (factor == 0.25)
    # the combine over an expert output of the buffer's shape
    ob = np.random.default_rng(2).normal(size=buf.shape).astype(np.float32)
    jy = jmoe._combine_group(jnp.asarray(ob), jsid, jpos, jtok, jsw, t)
    y = moe._combine_group(torch.as_tensor(ob), sid, pos, tok, sw, t)
    assert y.dtype == torch.float32
    _close(y, jy)


def _jax_moe(jcfg, jp, x, ct, factor):
    def f(p, x):
        y, aux = jmoe.apply_moe(jcfg, p, x, capacity_factor=factor)
        return jnp.sum(y * ct) + aux, (y, aux)

    (_, (y, aux)), (gp, gx) = jax.value_and_grad(f, argnums=(0, 1),
                                                 has_aux=True)(jp, x)
    return y, aux, gp, gx


@pytest.mark.parametrize("factor", [1.25, 0.25])
def test_apply_moe_and_grads_match_jax(moe_pair, factor):
    jcfg, cfg, jp, tp = moe_pair
    x = _x(cfg, seed=4)
    ct = np.random.default_rng(6).normal(size=x.shape).astype(np.float32)
    jy, jaux, jgp, jgx = _jax_moe(jcfg, jp, jnp.asarray(x), jnp.asarray(ct),
                                  factor)
    tx = torch.as_tensor(x).requires_grad_(True)
    tp = tree_map(lambda v: v.clone().requires_grad_(True), tp)
    leaves = tree_leaves(tp)
    y, aux = moe.apply_moe(cfg, tp, tx, capacity_factor=factor)
    _close(y, jy)
    _close(aux, jaux)
    (torch.sum(y * torch.as_tensor(ct)) + aux).backward()
    grads = [v.grad for v in leaves]
    jgrads = jax.tree.leaves(jgp)
    assert len(grads) == len(jgrads) == (7 if cfg.n_shared_experts else 4)
    for g, jg in zip(grads, jgrads):
        _close(g, jg)
    _close(tx.grad, jgx)


def test_apply_moe_under_vmap_is_per_sample(moe_pair):
    """The fused step takes each worker's grads under ``torch.func.vmap``:
    batched, ``apply_moe`` and its grad are each sample's own (every
    sample routes its own tokens, with its own capacity)."""
    _, cfg, _, tp = moe_pair
    xs = torch.as_tensor(np.stack([_x(cfg, 1, S, seed=i) for i in
                                   range(3)]))

    def loss(p, x):
        y, aux = moe.apply_moe(cfg, p, x)
        return torch.sum(y ** 2) + aux

    got = vmap(grad(loss), in_dims=(None, 0))(tp, xs)
    for i in range(3):
        want = grad(loss)(tp, xs[i])
        for a, b in zip(tree_leaves(got), tree_leaves(want)):
            torch.testing.assert_close(a[i], b, rtol=1e-5, atol=1e-6)
