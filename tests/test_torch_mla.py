"""Multi-head latent attention (``repro_torch.models.mla``) against the
JAX package's ``models/mla.py``, on the CPU, at float32, on deepseek-v2's
REDUCED config (4 heads, kv_lora 64, q_lora 128, nope 32, rope 16, v 32)
and on the same without the query latent (``q_lora=0``: one ``wq``).

Params come from the JAX init (``mla_params``) through
``params_from_numpy``; inputs are numpy draws from a seed. Tolerances:
float32 outputs rtol 1e-5 / atol 1e-6 (``mla_attention``'s output and
grads; ``mla_decode``'s output and latent caches over 8 steps). In the
port, the absorbed decode matches the decompressed forward within rtol
1e-4 / atol 1e-5 (the same math in another order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jget_reduced
from repro.models import mla as jmla
from repro_torch.configs import get_reduced
from repro_torch.convert import params_from_numpy
from repro_torch.models import mla
from repro_torch.tree import tree_leaves, tree_leaves_with_path, tree_map

B, S, N_DECODE = 2, 16, 8
F32 = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module", params=[128, 0], ids=["q_lora", "wq"])
def mla_pair(request):
    """(jax cfg, port cfg, jax params, port params)."""
    jcfg = jget_reduced("deepseek_v2_236b").replace(dtype="float32",
                                                    q_lora=request.param)
    cfg = get_reduced("deepseek_v2_236b").replace(dtype="float32",
                                                  q_lora=request.param)
    jp = jmla.mla_params(jax.random.PRNGKey(7), jcfg, jnp.float32)
    return jcfg, cfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp),
                                            "cpu")


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(tol or F32))


def test_params_tree_matches_jax(mla_pair):
    jcfg, cfg, _, _ = mla_pair
    own = mla.mla_params(torch.Generator().manual_seed(0), cfg,
                         torch.bfloat16)
    jown = jmla.mla_params(jax.random.PRNGKey(0), jcfg, jnp.bfloat16)
    got = [(p, tuple(x.shape), str(x.dtype).replace("torch.", ""))
           for p, x in tree_leaves_with_path(own)]
    want = [(tuple(k.key for k in p), x.shape, str(x.dtype)) for p, x in
            jax.tree_util.tree_flatten_with_path(jown)[0]]
    assert got == want
    # the latent norms' scales are float32 zeros in a bfloat16 model
    assert own["kv_norm_scale"].dtype == torch.float32
    assert not own["kv_norm_scale"].any()


def test_mla_attention_and_grads_match_jax(mla_pair):
    jcfg, cfg, jp, tp = mla_pair
    rng = np.random.default_rng(0)
    x = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    ct = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S), (B, S)).astype(np.int32)

    def f(p, x):
        out = jmla.mla_attention(jcfg, p, x, jnp.asarray(pos))
        return jnp.sum(out * ct), out

    (_, jout), (jgp, jgx) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(jp, jnp.asarray(x))
    tx = torch.as_tensor(x).requires_grad_(True)
    tp = tree_map(lambda v: v.clone().requires_grad_(True), tp)
    out = mla.mla_attention(cfg, tp, tx, torch.as_tensor(pos))
    _close(out, jout)
    torch.sum(out * torch.as_tensor(ct)).backward()
    grads, jgrads = [v.grad for v in tree_leaves(tp)], jax.tree.leaves(jgp)
    assert len(grads) == len(jgrads)
    for g, jg in zip(grads, jgrads):
        _close(g, jg)
    _close(tx.grad, jgx)


def test_mla_decode_matches_jax_and_the_forward(mla_pair):
    """8 absorbed decode steps from empty latent caches: each step's
    output and both caches equal JAX's, and the outputs equal the
    decompressed forward's."""
    jcfg, cfg, jp, tp = mla_pair
    x = np.random.default_rng(1).normal(
        size=(B, N_DECODE, cfg.d_model)).astype(np.float32)
    jckv = jnp.zeros((B, N_DECODE, cfg.kv_lora), jnp.float32)
    jkr = jnp.zeros((B, N_DECODE, cfg.qk_rope_dim), jnp.float32)
    ckv = torch.zeros((B, N_DECODE, cfg.kv_lora))
    kr = torch.zeros((B, N_DECODE, cfg.qk_rope_dim))
    outs = []
    for t in range(N_DECODE):
        jo, jckv, jkr = jmla.mla_decode(jcfg, jp, jnp.asarray(x[:, t:t + 1]),
                                        jckv, jkr, jnp.int32(t))
        o, ckv, kr = mla.mla_decode(cfg, tp, torch.as_tensor(x[:, t:t + 1]),
                                    ckv, kr, t)
        _close(o, jo)
        _close(ckv, jckv)
        _close(kr, jkr)
        outs.append(o)
    pos = torch.arange(N_DECODE).expand(B, N_DECODE)
    full = mla.mla_attention(cfg, tp, torch.as_tensor(x), pos)
    torch.testing.assert_close(torch.cat(outs, dim=1), full, rtol=1e-4,
                               atol=1e-5)
    with pytest.raises(IndexError):
        mla.mla_decode(cfg, tp, torch.as_tensor(x[:, :1]), ckv, kr,
                       N_DECODE)
