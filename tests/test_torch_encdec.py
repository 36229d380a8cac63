"""The enc-dec family (whisper-small's backbone, ``models/encdec.py``):
the port against the JAX package on identical parameters and inputs, on
the CPU, at the REDUCED config (2 encoder + 2 decoder layers, d_model
192, 64 frames) in float32.

Params come from the JAX init through ``params_from_numpy``; frames,
tokens and labels are numpy draws from a seed. Tolerances, those of
``tests/test_torch_transformer.py``: loss rtol 1e-5; grads rtol 1e-4 /
atol 1e-6, leaf by leaf, the encoder's leaves included (their grads
reach them only through the decoder's cross-attention keys and values);
encoder outputs, logits and caches rtol 1e-4 / atol 1e-5. The port's
remat is held bitwise to its own no-remat path under
``vmap(grad_and_value)``, as ``runtime/step.py`` calls it, and a control
shows that an encoder output closed over by the decoder's rematerialised
layers, not passed in, fails the grads check. The packet plan (leaf
paths, shapes, critical mask) is equal exactly, at REDUCED and at the
full CONFIG (shapes only: JAX's ``eval_shape``, the port's init under
``FakeTensorMode``)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.func import grad_and_value, vmap

from repro.configs import get_config as jget_config
from repro.configs import get_reduced as jget_reduced
from repro.core import packets as jpk
from repro.models import build as jbuild
from repro.models import encdec as jencdec
from repro_torch.configs import get_config, get_reduced
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core import packets as pk
from repro_torch.models import build, encdec
from repro_torch.models.api import demo_inputs
from repro_torch.shapes import InputShape
from repro_torch.tree import tree_leaves, tree_leaves_with_path, tree_map

ARCH = "whisper_small"
B, S, W, N_DECODE = 2, 16, 2, 8


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    """(jax cfg, port cfg, jax params, port params) at REDUCED, float32."""
    jcfg = jget_reduced(ARCH).replace(dtype="float32")
    cfg = get_reduced(ARCH).replace(dtype="float32")
    jp = jbuild(jcfg).init(jax.random.PRNGKey(0))
    return jcfg, cfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp),
                                            "cpu")


def _batch(cfg, lead=(B,), s=S, seed=0):
    """numpy frames (0.02 x N(0, 1)), tokens and labels (-1 masked)."""
    rng = np.random.default_rng(seed)
    return {
        "frames": (rng.normal(size=lead + (cfg.encoder_frames, cfg.d_model))
                   * 0.02).astype(np.float32),
        "tokens": rng.integers(0, cfg.vocab, lead + (s,)).astype(np.int32),
        "labels": rng.integers(-1, cfg.vocab, lead + (s,)).astype(np.int32),
    }


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _jax_paths(tree):
    return [tuple(getattr(k, "key", getattr(k, "idx", None)) for k in p)
            for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _close(got, want, rtol=1e-4, atol=1e-5):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("d, positions", [(192, 64), (768, 1500), (6, 5)])
def test_sinusoid_matches_jax(d, positions):
    """XLA's float32 ``exp`` and PyTorch's differ by one ulp on some of
    the frequencies f <= 1, which moves the angle p * f by up to p * f *
    2^-23: the bound is that, at the last position, or 1e-5."""
    want = jencdec.sinusoid(jnp.arange(positions), d, jnp.float32)
    got = encdec.sinusoid(torch.arange(positions), d, torch.float32)
    assert got.shape == (positions, d)
    _close(got, want, rtol=0, atol=max(1e-5, (positions - 1) * 2.0 ** -23))


def test_tree_and_critical_mask_equal(pair):
    """The port's own init has the reference's tree (paths in
    ``jax.tree_util`` order, shapes, dtypes), so the packet plan and its
    critical mask are equal."""
    _, cfg, jp, _ = pair
    own = build(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    assert list(own) == ["embed", "enc_stack", "dec_stack", "enc_norm",
                         "final_norm"]
    paths = [p for p, _ in tree_leaves_with_path(own)]
    assert paths == _jax_paths(jp)
    assert list(dict.fromkeys(p[0] for p in paths)) == [
        "dec_stack", "embed", "enc_norm", "enc_stack", "final_norm"]
    assert [tuple(x.shape) for x in tree_leaves(own)] == \
        [x.shape for x in jax.tree.leaves(jp)]
    assert all(x.dtype == torch.float32 for x in tree_leaves(own))
    jplan, plan = jpk.make_plan(jp, 360), pk.make_plan(own, 360)
    assert (plan.n_floats, plan.n_packets, plan.n_critical) == (
        jplan.n_floats, jplan.n_packets, jplan.n_critical)
    np.testing.assert_array_equal(plan.critical, jplan.critical)


def test_full_config_plan_matches_jax():
    """The published config (12 + 12 layers, d_model 768, vocab 51,865
    padded to 51,968, 1,500 frames) in bfloat16, nothing allocated:
    278,098,944 floats in 32 leaves, JAX's count, and the same critical
    mask."""
    jp = jax.eval_shape(jbuild(jget_config(ARCH)).init, jax.random.PRNGKey(0))
    cfg = get_config(ARCH)
    assert (cfg.n_layers, cfg.encoder_layers, cfg.d_model, cfg.vocab_padded,
            cfg.encoder_frames, cfg.dtype) == (12, 12, 768, 51968, 1500,
                                               "bfloat16")
    with FakeTensorMode():
        tp = build(cfg).init(torch.Generator().manual_seed(0), device="cpu")
        plan = pk.make_plan(tp, 360)
    jplan = jpk.make_plan(jp, 360)
    assert [p for p, _ in tree_leaves_with_path(tp)] == _jax_paths(jp)
    assert [str(x.dtype).replace("torch.", "") for x in tree_leaves(tp)] \
        == [str(x.dtype) for x in jax.tree.leaves(jp)]
    assert plan.leaf_shapes == jplan.leaf_shapes
    assert (plan.n_floats, len(plan.leaf_shapes)) == (278_098_944, 32)
    assert (plan.n_floats, plan.n_packets) == (jplan.n_floats,
                                               jplan.n_packets)
    np.testing.assert_array_equal(plan.critical, jplan.critical)


def test_params_from_numpy_keeps_the_whisper_tree(pair):
    """The JAX tree's sorted keys come through both ways, and the stacked
    leaves keep their leading layer axis."""
    _, cfg, jp, tp = pair
    assert list(tp) == sorted(tp) == ["dec_stack", "embed", "enc_norm",
                                      "enc_stack", "final_norm"]
    assert tuple(tp["enc_stack"]["attn"]["wq"].shape) == (
        cfg.encoder_layers, cfg.d_model, cfg.d_model)
    assert tuple(tp["dec_stack"]["cross_attn"]["wk"].shape) == (
        cfg.n_layers, cfg.d_model, cfg.d_model)
    back = params_to_numpy(tp)
    assert _jax_paths(back) == _jax_paths(jp)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("remat", [True, False])
def test_encode_matches_jax(pair, remat):
    """With grad mode on, ``remat`` routes each layer through
    ``_Remat``'s forward."""
    jcfg, cfg, jp, tp = pair
    frames = _batch(cfg)["frames"]
    want = jencdec.encode(jcfg, jp, jnp.asarray(frames), remat=remat)
    got = encdec.encode(cfg, tp, torch.as_tensor(frames), remat=remat)
    assert got.shape == (B, cfg.encoder_frames, cfg.d_model)
    _close(got.detach(), want)


def test_decode_train_matches_jax(pair):
    jcfg, cfg, jp, tp = pair
    batch = _batch(cfg, seed=1)
    want = jencdec.decode_train(
        jcfg, jp, jnp.asarray(batch["tokens"]),
        jencdec.encode(jcfg, jp, jnp.asarray(batch["frames"])))
    with torch.no_grad():
        got = encdec.decode_train(
            cfg, tp, torch.as_tensor(batch["tokens"]),
            encdec.encode(cfg, tp, torch.as_tensor(batch["frames"])))
    assert got.shape == (B, S, cfg.vocab_padded)
    _close(got, want)


@pytest.fixture(scope="module")
def jax_grad(pair):
    """JAX's ``loss_fn(remat=True)`` value and grad, jitted once for the
    module: (params, batch) -> (loss, grad tree)."""
    jcfg = pair[0]
    return jax.jit(jax.value_and_grad(
        lambda p, b: jencdec.loss_fn(jcfg, p, b, remat=True)))


def _grads_both(pair, jax_grad, batch, remat=True):
    """JAX's loss and grad leaves (with remat), and the port's loss and
    grad tree (``remat`` as given: the same function)."""
    _, cfg, jp, tp = pair
    jl, jg = jax_grad(jp, _j(batch))
    tg, tl = grad_and_value(lambda p: encdec.loss_fn(
        cfg, p, _t(batch), remat=remat))(tp)
    return (float(jl), jax.tree.leaves(jg)), (float(tl), tg)


def _check_grads(jl, jg, tl, tg):
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    got = tree_leaves_with_path(tg)
    assert len(got) == len(jg)
    for (path, a), b in zip(got, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-6, err_msg=str(path))


@pytest.mark.parametrize("remat", [True, False])
def test_loss_and_grads_match_jax(pair, jax_grad, remat):
    (jl, jg), (tl, tg) = _grads_both(pair, jax_grad,
                                     _batch(pair[1], seed=2), remat)
    _check_grads(jl, jg, tl, tg)
    # the encoder's leaves get their grads through the cross-attention
    for path, g in tree_leaves_with_path(tg):
        if path[0] in ("enc_stack", "enc_norm"):
            assert bool(g.abs().max() > 0), path


def test_grads_check_catches_a_closed_over_encoder_output(pair, jax_grad,
                                                         monkeypatch):
    """Control: the decoder's rematerialised layers read the encoder
    output from a closure, not as an input of the Function, so no grad
    reaches the encoder through them; the grads check must fail."""
    remat_layer = encdec._remat_layer

    def closed_over(layer, p, positions, *inputs, span=None):
        if len(inputs) == 2:
            x, e = inputs
            return remat_layer(
                lambda t, x, positions: layer(t, x, e, positions),
                p, positions, x, span=span)
        return remat_layer(layer, p, positions, *inputs, span=span)

    monkeypatch.setattr(encdec, "_remat_layer", closed_over)
    (jl, jg), (tl, tg) = _grads_both(pair, jax_grad, _batch(pair[1],
                                                            seed=2))
    assert all(float(g.abs().max()) == 0.0
               for g in tree_leaves(tg["enc_stack"]))
    with pytest.raises(AssertionError):
        _check_grads(jl, jg, tl, tg)


def _per_worker(cfg, params, batch, remat):
    """(grads with a leading worker axis, (W,) losses), as
    ``runtime/step.py`` takes them."""
    api = build(cfg)

    def one(p, b):
        return grad_and_value(lambda q: api.loss_fn(q, b, remat=remat))(p)

    return vmap(one, in_dims=(None, 0))(params, _t(batch))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_remat_grads_bitwise_equal_under_vmap(dtype):
    """W = 2 workers: losses and every leaf's grad, the encoder's
    included, bitwise those of ``remat=False``; in bfloat16 too, where
    the norm scales stay float32."""
    jcfg = jget_reduced(ARCH).replace(dtype=dtype)
    cfg = get_reduced(ARCH).replace(dtype=dtype)
    tp = params_from_numpy(jax.tree.map(
        np.asarray, jbuild(jcfg).init(jax.random.PRNGKey(1))), "cpu")
    batch = _batch(cfg, lead=(W, B), seed=3)
    g1, l1 = _per_worker(cfg, tp, batch, True)
    g0, l0 = _per_worker(cfg, tp, batch, False)
    assert l1.shape == (W,) and torch.equal(l1, l0)
    a, b = tree_leaves(g1), tree_leaves(g0)
    assert len(a) == len(b) == len(tree_leaves(tp)) == 32
    for x, y, p in zip(a, b, tree_leaves(tp)):
        assert x.dtype == p.dtype and torch.equal(x, y)


def test_remat_grads_under_vmap_match_jax_checkpoint(pair, jax_grad):
    """Each worker's loss and grads under ``vmap`` with remat against
    JAX's ``loss_fn(remat=True)`` (``jax.checkpoint`` on both scans)."""
    _, cfg, jp, tp = pair
    batch = _batch(cfg, lead=(W, B), seed=4)
    g, loss = _per_worker(cfg, tp, batch, True)
    for w in range(W):
        jl, jg = jax_grad(jp, {k: jnp.asarray(v[w])
                               for k, v in batch.items()})
        _check_grads(float(jl), jax.tree.leaves(jg), float(loss[w]),
                     tree_map(lambda x: x[w], g))


def test_remat_recomputes_each_layer_once(pair, monkeypatch):
    """With remat the grad runs every encoder and decoder layer twice
    (the forward, then the backward's recompute); without remat, under
    ``no_grad`` and in ``prefill``, once."""
    _, cfg, _, tp = pair
    calls = {"enc": 0, "dec": 0}
    enc_layer, dec_layer = encdec._enc_layer, encdec._dec_layer

    def count(name, fn):
        def counted(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return counted

    monkeypatch.setattr(encdec, "_enc_layer", count("enc", enc_layer))
    monkeypatch.setattr(encdec, "_dec_layer", count("dec", dec_layer))
    batch = _t(_batch(cfg, seed=5))
    n_enc, n_dec = cfg.encoder_layers, cfg.n_layers

    def run(fn, mult):
        calls.update(enc=0, dec=0)
        fn()
        assert calls == {"enc": mult * n_enc, "dec": mult * n_dec}

    for remat, mult in ((True, 2), (False, 1)):
        run(lambda: grad_and_value(lambda p: encdec.loss_fn(
            cfg, p, batch, remat=remat))(tp), mult)
    with torch.no_grad():
        run(lambda: encdec.loss_fn(cfg, tp, batch), 1)
    run(lambda: build(cfg).prefill(tp, {"frames": batch["frames"],
                                        "tokens": batch["tokens"]}), 1)


def test_init_cache_matches_jax(pair):
    jcfg, cfg, _, _ = pair
    jc = jencdec.init_cache(jcfg, B, 24, jnp.float32)
    tc = build(cfg).init_cache(B, 24, torch.float32, device="cpu")
    assert [p for p, _ in tree_leaves_with_path(tc)] == _jax_paths(jc)
    for a, b in zip(tree_leaves(tc), jax.tree.leaves(jc)):
        assert tuple(a.shape) == b.shape and a.dtype == torch.float32
        assert not bool(a.any())
    assert tuple(tc["cross_k"].shape) == (cfg.n_layers, B,
                                          cfg.encoder_frames, cfg.n_kv,
                                          cfg.hd)
    assert tuple(tc["self_v"].shape) == (cfg.n_layers, B, 24, cfg.n_kv,
                                         cfg.hd)
    meta = build(cfg).init_cache(B, 24, "bfloat16", device="meta")
    assert all(x.device.type == "meta" and x.dtype == torch.bfloat16
               for x in tree_leaves(meta))


def test_prefill_matches_jax(pair):
    """Last-token logits and the cache: cross K/V of every layer filled
    from the encoder, self K/V as long as the prompt and zero, as in the
    reference."""
    jcfg, cfg, jp, tp = pair
    batch = _batch(cfg, seed=6)
    inputs = {k: batch[k] for k in ("frames", "tokens")}
    jl, jc = jbuild(jcfg).prefill(jp, _j(inputs))
    tl, tc = build(cfg).prefill(tp, _t(inputs))
    assert tl.shape == (B, cfg.vocab_padded)
    _close(tl, jl)
    assert [p for p, _ in tree_leaves_with_path(tc)] == _jax_paths(jc)
    for a, b in zip(tree_leaves(tc), jax.tree.leaves(jc)):
        _close(a, b)
    assert tuple(tc["self_k"].shape)[2] == S and not bool(tc["self_k"].any())
    assert bool(tc["cross_k"].abs().max() > 0)


def _decode_from_prefill(api, params, frames, prompt, cache,
                         pos_of=lambda t: t):
    """Decode steps of each of ``prompt``'s tokens from ``cache`` (an
    empty ``init_cache``) holding ``prefill``'s cross K/V: (each step's
    logits, the last cache)."""
    _, pc = api.prefill(params, {"frames": frames, "tokens": prompt[:, :1]})
    cache = {**cache, "cross_k": pc["cross_k"], "cross_v": pc["cross_v"]}
    out = []
    for t in range(prompt.shape[1]):
        logits, cache = api.decode_step(params, cache, prompt[:, t],
                                        pos_of(t))
        out.append(logits)
    return out, cache


def test_decode_chain_from_prefill_matches_jax(pair):
    """Prefill's cross K/V placed in an ``init_cache`` of 8 positions,
    then 8 chained decode steps: each step's logits and the last cache
    against the same composition in JAX."""
    jcfg, cfg, jp, tp = pair
    japi, api = jbuild(jcfg), build(cfg)
    batch = _batch(cfg, s=N_DECODE, seed=7)

    japi = dataclasses.replace(japi, decode_step=jax.jit(japi.decode_step))
    jl, jc = _decode_from_prefill(
        japi, jp, jnp.asarray(batch["frames"]), jnp.asarray(batch["tokens"]),
        japi.init_cache(B, N_DECODE, jnp.float32), jnp.int32)
    tl, tc = _decode_from_prefill(
        api, tp, torch.as_tensor(batch["frames"]),
        torch.as_tensor(batch["tokens"]),
        api.init_cache(B, N_DECODE, torch.float32, device="cpu"))
    assert len(tl) == N_DECODE
    for a, b in zip(tl, jl):
        assert a.shape == (B, cfg.vocab_padded)
        _close(a, b)
    assert [p for p, _ in tree_leaves_with_path(tc)] == _jax_paths(jc)
    for a, b in zip(tree_leaves(tc), jax.tree.leaves(jc)):
        _close(a, b)
    assert bool(tc["self_k"][:, :, -1].abs().max() > 0)


def test_decode_matches_decode_train(pair):
    """In the port: decode from prefill's cross K/V against one
    ``decode_train`` over the same tokens (the same math, one position at
    a time), and prefill's logits against decode's at the prompt's last
    position."""
    _, cfg, _, tp = pair
    api = build(cfg)
    batch = _t(_batch(cfg, s=N_DECODE, seed=8))
    frames, toks = batch["frames"], batch["tokens"]
    with torch.no_grad():
        steps, _ = _decode_from_prefill(
            api, tp, frames, toks,
            api.init_cache(B, N_DECODE, torch.float32, device="cpu"))
        full = encdec.decode_train(cfg, tp, toks,
                                   encdec.encode(cfg, tp, frames))
        last, _ = api.prefill(tp, {"frames": frames, "tokens": toks})
    torch.testing.assert_close(torch.stack(steps, 1), full, rtol=1e-4,
                               atol=1e-5)
    torch.testing.assert_close(last, steps[-1], rtol=1e-4, atol=1e-5)


def test_api_surface_and_demo_inputs():
    """``build`` of the audio family: no ``forward`` (as in the
    reference); ``demo_inputs`` drive one train step and one decode
    step."""
    cfg = get_reduced(ARCH).replace(dtype="float32")
    api = build(cfg)
    assert api.forward is None and api.prefill is not None
    gen = torch.Generator().manual_seed(0)
    params = api.init(gen, device="cpu")
    batch = demo_inputs(cfg, InputShape("t", 16, 2, "train"), gen,
                        device="cpu")
    assert batch["frames"].shape == (2, cfg.encoder_frames, cfg.d_model)
    assert batch["tokens"].shape == (2, 16)
    assert np.isfinite(float(api.loss_fn(params, batch)))
    dec = demo_inputs(cfg, InputShape("d", 24, 2, "decode"), gen,
                      device="cpu")
    logits, cache = api.decode_step(params, dec["cache"], dec["token"],
                                    dec["pos"])
    assert logits.shape == (2, cfg.vocab_padded)
    assert torch.isfinite(logits).all()
    assert set(cache) == {"self_k", "self_v", "cross_k", "cross_v"}
