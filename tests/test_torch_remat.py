"""Remat in the port's transformer (``transformer.forward(remat=True)``,
``loss_fn``'s default): each stacked period is rematerialised by
``transformer._Remat``, under ``torch.func.vmap(grad_and_value)`` as
``runtime/step.py`` calls it, on the CPU.

Against the same call with ``remat=False`` the losses and grads are
bitwise equal (the backward recomputes the same float32 ops in the same
order): dense (smollm-360m), a six-position period (gemma3), the VLM
(qwen2-vl, whose M-RoPE ids carry the worker axis into the Function),
MoE (mixtral-8x22b: the aux loss through the Function; deepseek-v2: a
lead layer outside it), Mamba-1 (falcon-mamba) and the hybrid (zamba2:
the shared block inside each period, its grad summed over the periods).
Against JAX's ``loss_fn(remat=True)`` (``jax.checkpoint``) at the
transformer harness's bounds: loss rtol 1e-5, grads rtol 1e-4 / atol
1e-6. The grads each ``_Remat.backward`` returns carry no graph (the
enc-dec family, whisper, included), so no recomputed activation outlives
its layer's backward."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad_and_value, vmap

from repro.configs import get_reduced as jget_reduced
from repro.models import build as jbuild
from repro_torch.configs import get_reduced
from repro_torch.convert import params_from_numpy
from repro_torch.models import build, transformer
from repro_torch.tree import tree_leaves

ARCHS = ["smollm_360m", "gemma3_1b", "qwen2_vl_72b", "mixtral_8x22b",
         "deepseek_v2_236b", "falcon_mamba_7b", "zamba2_7b"]
W, B, S = 2, 2, 16


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(arch, dtype="float32"):
    jcfg = jget_reduced(arch).replace(dtype=dtype)
    cfg = get_reduced(arch).replace(dtype=dtype)
    jp = jbuild(jcfg).init(jax.random.PRNGKey(0))
    return jcfg, cfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp),
                                            "cpu")


def _batch(cfg, seed=0):
    """numpy batch of W workers x B sequences of S (a VLM's patch stub
    and M-RoPE ids included)."""
    rng = np.random.default_rng(seed)
    n_text, out = S, {}
    if cfg.family == "vlm":
        n_patch = min(cfg.vision_patches, S // 2)
        n_text = S - n_patch
        out["patch_embeds"] = (rng.normal(size=(W, B, n_patch, cfg.d_model))
                               * 0.02).astype(np.float32)
        out["positions3"] = rng.integers(0, S, (W, 3, B, S)).astype(np.int32)
    out["tokens"] = rng.integers(0, cfg.vocab, (W, B, n_text)).astype(
        np.int32)
    out["labels"] = rng.integers(-1, cfg.vocab, (W, B, S)).astype(np.int32)
    return out


def _per_worker(cfg, params, batch, remat):
    """(grads with a leading worker axis, (W,) losses), as
    ``runtime/step.py`` takes them."""
    api = build(cfg)

    def one(p, b):
        return grad_and_value(lambda q: api.loss_fn(q, b, remat=remat))(p)

    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    return vmap(one, in_dims=(None, 0))(params, tb)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_grads_bitwise_equal_under_vmap(arch):
    _, cfg, _, tp = _setup(arch)
    batch = _batch(cfg)
    g1, l1 = _per_worker(cfg, tp, batch, True)
    g0, l0 = _per_worker(cfg, tp, batch, False)
    assert l1.shape == (W,) and torch.equal(l1, l0)
    a, b = tree_leaves(g1), tree_leaves(g0)
    assert len(a) == len(b) == len(tree_leaves(tp))
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("arch", ["zamba2_7b", "mixtral_8x22b"])
def test_remat_grads_bitwise_equal_in_bfloat16(arch):
    """The configs' own dtype: bfloat16 leaves beside the float32 norm
    scales, router and SSM constants."""
    _, cfg, _, tp = _setup(arch, "bfloat16")
    batch = _batch(cfg, seed=1)
    g1, l1 = _per_worker(cfg, tp, batch, True)
    g0, l0 = _per_worker(cfg, tp, batch, False)
    assert torch.equal(l1, l0)
    for x, y, p in zip(tree_leaves(g1), tree_leaves(g0), tree_leaves(tp)):
        assert x.dtype == p.dtype and torch.equal(x, y)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_grads_match_jax_checkpoint(arch):
    """Each worker's loss and grads against JAX's ``loss_fn`` with
    ``remat=True``."""
    jcfg, cfg, jp, tp = _setup(arch)
    batch = _batch(cfg, seed=2)
    g, loss = _per_worker(cfg, tp, batch, True)
    got = tree_leaves(g)
    for w in range(W):
        jl, jg = jax.value_and_grad(lambda p: jbuild(jcfg).loss_fn(
            p, {k: jnp.asarray(v[w]) for k, v in batch.items()},
            remat=True))(jp)
        np.testing.assert_allclose(float(loss[w]), float(jl), rtol=1e-5)
        want = jax.tree.leaves(jg)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a[w].numpy(), np.asarray(b),
                                       rtol=1e-4, atol=1e-6)


def _layer_calls(monkeypatch):
    """Count ``transformer._apply_layer`` calls."""
    calls = []
    orig = transformer._apply_layer

    def counted(*args, **kwargs):
        calls.append(1)
        return orig(*args, **kwargs)

    monkeypatch.setattr(transformer, "_apply_layer", counted)
    return calls


def test_remat_recomputes_the_stacked_layers_alone(monkeypatch):
    """deepseek-v2 REDUCED: a lead layer, then one stacked period. With
    remat the grad runs the stacked layer twice (forward, then the
    backward's recompute) and the lead layer once; without remat, under
    ``no_grad`` and with ``collect_cache`` (prefill), each runs once."""
    _, cfg, _, tp = _setup("deepseek_v2_236b")
    plan = transformer.make_plan(cfg)
    n_lead = len(plan.lead_codes)
    n_stack = plan.n_periods * len(plan.period_codes)
    assert n_lead == 1 and n_stack >= 1
    batch = {k: torch.as_tensor(v[0]) for k, v in _batch(cfg).items()}
    api = build(cfg)
    calls = _layer_calls(monkeypatch)
    for remat, want in ((True, n_lead + 2 * n_stack),
                        (False, n_lead + n_stack)):
        calls.clear()
        grad_and_value(lambda p: api.loss_fn(p, batch, remat=remat))(tp)
        assert len(calls) == want, remat
    calls.clear()
    with torch.no_grad():
        api.loss_fn(tp, batch)
    assert len(calls) == n_lead + n_stack
    calls.clear()
    inputs = {"tokens": batch["tokens"]}
    api.prefill(tp, inputs)
    assert len(calls) == n_lead + n_stack


def test_remat_sums_the_shared_blocks_grad_over_periods(monkeypatch):
    """zamba2 at 4 layers with the shared block every 2: two periods, so
    two applications of ``shared_attn`` in each forward. Its grad under
    remat is the no-remat grad (both sums over the two applications),
    and the shared block runs four times with remat (two forwards, two
    recomputes), twice without."""
    jcfg = jget_reduced("zamba2_7b").replace(dtype="float32", n_layers=4,
                                             shared_attn_every=2)
    cfg = get_reduced("zamba2_7b").replace(dtype="float32", n_layers=4,
                                           shared_attn_every=2)
    jp = jbuild(jcfg).init(jax.random.PRNGKey(3))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    assert transformer.make_plan(cfg).n_periods == 2
    batch = {k: torch.as_tensor(v[0]) for k, v in _batch(cfg, 4).items()}
    orig = transformer._apply_shared_block
    calls = []

    def counted(*args, **kwargs):
        calls.append(1)
        return orig(*args, **kwargs)

    monkeypatch.setattr(transformer, "_apply_shared_block", counted)
    api = build(cfg)
    grads = {}
    for remat, want in ((True, 4), (False, 2)):
        calls.clear()
        g, _ = grad_and_value(
            lambda p: api.loss_fn(p, batch, remat=remat))(tp)
        assert len(calls) == want
        grads[remat] = tree_leaves(g["shared_attn"])
    for a, b in zip(grads[True], grads[False]):
        assert torch.equal(a, b) and bool(a.abs().sum() > 0)
    jg = jax.grad(lambda p: jbuild(jcfg).loss_fn(
        p, {k: jnp.asarray(v.numpy()) for k, v in batch.items()}))(jp)
    for a, b in zip(grads[True], jax.tree.leaves(jg["shared_attn"])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-6)


@pytest.mark.parametrize("arch", ["smollm_360m", "zamba2_7b",
                                  "whisper_small"])
def test_remat_backward_keeps_no_graph(arch, monkeypatch):
    """Under ``vmap(grad_and_value)`` the grad transforms run the
    backward with ``create_graph``; the grads each ``_Remat.backward``
    returns must carry no graph of their own, else every period's
    recomputed activations stay alive to the end of the backward and
    remat saves no memory. Every Function of the step is checked."""
    jcfg = jget_reduced(arch).replace(dtype="float32")
    cfg = get_reduced(arch).replace(dtype="float32")
    tp = params_from_numpy(jax.tree.map(
        np.asarray, jbuild(jcfg).init(jax.random.PRNGKey(0))), "cpu")
    seen = []
    backward = transformer._Remat.backward

    def checked(ctx, *grads):
        out = backward(ctx, *grads)
        seen.append([g.requires_grad for g in out if g is not None])
        return out

    monkeypatch.setattr(transformer._Remat, "backward",
                        staticmethod(checked))
    batch = _batch(cfg)
    if cfg.family == "audio":
        batch["frames"] = (np.random.default_rng(5).normal(size=(
            W, B, cfg.encoder_frames, cfg.d_model)) * 0.02).astype(
                np.float32)
    _per_worker(cfg, tp, batch, True)
    n_layers = (cfg.encoder_layers + cfg.n_layers if cfg.family == "audio"
                else transformer.make_plan(cfg).n_periods)
    assert len(seen) == n_layers > 0
    assert not any(any(r) for r in seen)
