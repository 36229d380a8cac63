"""The decoder-only transformers (dense, VLM, MoE, SSM and the hybrid):
the port against the JAX package on identical parameters and inputs, on
the CPU, at float32.

Params come from the JAX init through ``params_from_numpy``; inputs are
numpy draws from a seed. Tolerances: loss rtol 1e-5 (one float32 sum of
a few hundred terms, taken in another order); grads rtol 1e-4 / atol
1e-6 (backward sums in another order, against grads of size ~1e-3);
decode logits and caches rtol 1e-4 / atol 1e-5 (12 chained steps). In
the port, decode matches forward within rtol 1e-4 / atol 1e-5 (the
same math, one position at a time against the chunked softmax). The
packet plan (leaf paths, shapes, critical mask) is equal exactly, at
the REDUCED sizes and at every full CONFIG (shapes only: JAX's
``eval_shape``, the port's init under ``FakeTensorMode``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.func import grad_and_value

from repro.configs import get_config as jget_config
from repro.configs import get_reduced as jget_reduced
from repro.core import packets as jpk
from repro.models import attention as jattn
from repro.models import build as jbuild
from repro.models.api import input_specs as jinput_specs
from repro.models.api import shape_supported as jshape_supported
from repro.models.sharding import NULL_CTX
from repro_torch.configs import ARCH_IDS, get_config, get_reduced
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core import packets as pk
from repro_torch.models import attention as attn
from repro_torch.models import build
from repro_torch.models.api import demo_inputs, input_specs, shape_supported
from repro_torch.shapes import SHAPES, InputShape
from repro_torch.tree import tree_leaves, tree_leaves_with_path

LM_ARCHS = [a for a in ARCH_IDS if a != "papernet"]
# the decoder-only families, which ``transformer.forward`` serves; the
# enc-dec one (whisper) has its own tests, tests/test_torch_encdec.py
DECODER_ARCHS = [a for a in LM_ARCHS
                 if get_config(a).family in ("dense", "vlm", "moe", "ssm",
                                             "hybrid")]
B, S, N_DECODE = 2, 32, 12


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, **kw):
    return (jget_reduced(arch).replace(dtype="float32", **kw),
            get_reduced(arch).replace(dtype="float32", **kw))


def _jax_paths(tree):
    return [tuple(getattr(k, "key", getattr(k, "idx", None)) for k in p)
            for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _batch(cfg, b, s, seed=0):
    """numpy tokens/labels (and for the VLM the patch stub and its
    M-RoPE ids) from a seed."""
    rng = np.random.default_rng(seed)
    out = {}
    n_text = s
    if cfg.family == "vlm":
        n_patch = min(cfg.vision_patches, s // 2)
        n_text = s - n_patch
        out["patch_embeds"] = (rng.normal(size=(b, n_patch, cfg.d_model))
                               * 0.02).astype(np.float32)
        out["positions3"] = rng.integers(0, s, (3, b, s)).astype(np.int32)
    out["tokens"] = rng.integers(0, cfg.vocab, (b, n_text)).astype(np.int32)
    out["labels"] = rng.integers(-1, cfg.vocab, (b, s)).astype(np.int32)
    return out


@pytest.fixture(scope="module", params=DECODER_ARCHS)
def arch_pair(request):
    """(jax cfg, port cfg, jax params, port params) of one REDUCED arch."""
    jcfg, cfg = _cfgs(request.param)
    jp = jbuild(jcfg).init(jax.random.PRNGKey(0))
    return jcfg, cfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp),
                                            "cpu")


def _loss_and_grads(jcfg, cfg, jp, tp, batch):
    jl, jg = jax.value_and_grad(lambda p: jbuild(jcfg).loss_fn(
        p, {k: jnp.asarray(v) for k, v in batch.items()}))(jp)
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    tg, tl = grad_and_value(lambda p: build(cfg).loss_fn(p, tb))(tp)
    return (float(jl), jax.tree.leaves(jg)), (float(tl), tree_leaves(tg))


def test_tree_and_critical_mask_equal(arch_pair):
    jcfg, cfg, jp, _ = arch_pair
    own = build(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    paths = [p for p, _ in tree_leaves_with_path(own)]
    assert paths == _jax_paths(jp)
    assert [tuple(x.shape) for x in tree_leaves(own)] == \
        [x.shape for x in jax.tree.leaves(jp)]
    assert all(x.dtype == torch.float32 for x in tree_leaves(own))
    jplan, plan = jpk.make_plan(jp, 360), pk.make_plan(own, 360)
    assert (plan.n_floats, plan.n_packets) == (jplan.n_floats,
                                               jplan.n_packets)
    np.testing.assert_array_equal(plan.critical, jplan.critical)


def test_loss_and_grads_match_jax(arch_pair):
    jcfg, cfg, jp, tp = arch_pair
    (jl, jg), (tl, tg) = _loss_and_grads(jcfg, cfg, jp, tp,
                                         _batch(jcfg, B, S))
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert len(tg) == len(jg)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-6)


def _decode_both(jcfg, cfg, jp, tp, steps=N_DECODE, seed=1):
    """``steps`` decode steps of both packages from empty caches of
    length ``steps``; returns (jax logits, port logits, jax cache, port
    cache, tokens)."""
    japi, api = jbuild(jcfg), build(cfg)
    toks = np.random.default_rng(seed).integers(
        0, jcfg.vocab, (B, steps)).astype(np.int32)
    jc = japi.init_cache(B, steps, jnp.float32)
    tc = api.init_cache(B, steps, torch.float32, device="cpu")
    jl, tl = [], []
    for t in range(steps):
        lj, jc = japi.decode_step(jp, jc, jnp.asarray(toks[:, t]),
                                  jnp.int32(t))
        lt, tc = api.decode_step(tp, tc, torch.as_tensor(toks[:, t]), t)
        jl.append(np.asarray(lj))
        tl.append(lt)
    return np.stack(jl, 1), torch.stack(tl, 1), jc, tc, toks


def test_decode_logits_and_caches_match_jax(arch_pair):
    jcfg, cfg, jp, tp = arch_pair
    jl, tl, jc, tc, _ = _decode_both(jcfg, cfg, jp, tp)
    assert tl.shape == (B, N_DECODE, cfg.vocab_padded)
    np.testing.assert_allclose(tl.numpy(), jl, rtol=1e-4, atol=1e-5)
    assert [p for p, _ in tree_leaves_with_path(tc)] == _jax_paths(jc)
    for a, b in zip(tree_leaves(tc), jax.tree.leaves(jc)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-5)


def test_decode_matches_forward(arch_pair):
    """For an MoE arch the forward routes each sequence of 8 tokens
    alone: 8 tokens fill at most 8 slots of an expert, and its capacity
    is at least 8, so the forward drops no assignment, as no decode step
    of B tokens does (where it dropped, the two would differ by
    design)."""
    _, cfg, _, tp = arch_pair
    api = build(cfg)
    n = 8 if cfg.n_experts else N_DECODE
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (B, n))
    tok = torch.as_tensor(toks)
    if cfg.n_experts:
        full = torch.cat([api.forward(tp, {"tokens": tok[i:i + 1]})[0]
                          for i in range(B)])
    else:
        full, _, _ = api.forward(tp, {"tokens": tok})
    cache = api.init_cache(B, n, torch.float32, device="cpu")
    for t in range(n):
        logits, cache = api.decode_step(tp, cache, tok[:, t], t)
        torch.testing.assert_close(logits, full[:, t], rtol=1e-4, atol=1e-5)


def test_prefill_matches_jax(arch_pair):
    """Last-token logits and the lead/stack/rem caches of ``prefill``."""
    jcfg, cfg, jp, tp = arch_pair
    batch = _batch(jcfg, B, S, seed=3)
    batch.pop("labels")
    jl, jc = jbuild(jcfg).prefill(jp, {k: jnp.asarray(v)
                                       for k, v in batch.items()})
    tl, tc = build(cfg).prefill(tp, {k: torch.as_tensor(v)
                                     for k, v in batch.items()})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-5)
    assert set(tc) == set(jc)
    assert [p for p, _ in tree_leaves_with_path(tc)] == _jax_paths(jc)
    got = [x for _, x in tree_leaves_with_path(tc)]
    want = jax.tree.leaves(jc)
    assert len(got) == len(want)
    if set(cfg.pattern_layers) <= {"M", "M2"} and not cfg.shared_attn_every:
        # an SSM layer's prefill cache is None, in the reference too
        assert tc["stack"] == {"p0": None} and jc["stack"] == {"p0": None}
    else:
        assert len(got) > 0
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-5)


def test_gemma3_band_path_matches_jax():
    """gemma3's REDUCED window (64) at seq 256: the 'W' layer takes the
    static KV band (256 > 64 + 128), two query chunks of 128."""
    jcfg, cfg = _cfgs("gemma3_1b")
    assert cfg.window == 64 and cfg.block_pattern == ("W", "A")
    jp = jbuild(jcfg).init(jax.random.PRNGKey(1))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    (jl, jg), (tl, tg) = _loss_and_grads(jcfg, cfg, jp, tp,
                                         _batch(jcfg, 1, 256, seed=4))
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-6)


def test_ring_buffer_decode_past_the_window():
    """A window of 8 under 12 decode steps: the 'W' layer's cache is a
    ring of 8 slots that wraps; logits and caches match JAX, and the
    logits match the port's banded forward."""
    jcfg, cfg = _cfgs("gemma3_1b", window=8)
    jp = jbuild(jcfg).init(jax.random.PRNGKey(2))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    api = build(cfg)
    cache = api.init_cache(B, N_DECODE, torch.float32, device="cpu")
    assert [c["k"].shape[1] for c in cache["layers"]] == [8, N_DECODE]
    jl, tl, jc, tc, toks = _decode_both(jcfg, cfg, jp, tp)
    np.testing.assert_allclose(tl.numpy(), jl, rtol=1e-4, atol=1e-5)
    for a, b in zip(tree_leaves(tc), jax.tree.leaves(jc)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-5)
    full, _, _ = api.forward(tp, {"tokens": torch.as_tensor(toks)})
    torch.testing.assert_close(tl, full, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("window", [0, 16, 64])
def test_traced_window_attention_matches_jax(window):
    rng = np.random.default_rng(window)
    b, s, h, kv, hd = 2, 256, 4, 2, 16
    q, k, v = (rng.normal(size=(b, s, n, hd)).astype(np.float32)
               for n in (h, kv, kv))
    want = jattn._traced_window_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.int32(window),
        ctx=NULL_CTX)
    got = attn._traced_window_attention(
        torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
        torch.tensor(window, dtype=torch.int32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    if window:
        # the static band computes the same function
        band = attn.multi_head_attention(
            torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
            causal=True, window=window, chunk_q=64)
        torch.testing.assert_close(band, got, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_full_size_plan_matches_jax(arch):
    """At the published widths and depths (nothing allocated): the leaf
    paths, shapes and critical mask of the stacked layout."""
    jp = jax.eval_shape(jbuild(jget_config(arch)).init,
                        jax.random.PRNGKey(0))
    with FakeTensorMode():
        tp = build(get_config(arch)).init(torch.Generator().manual_seed(0),
                                          device="cpu")
        plan = pk.make_plan(tp, 360)
    jplan = jpk.make_plan(jp, 360)
    assert [p for p, _ in tree_leaves_with_path(tp)] == _jax_paths(jp)
    assert plan.leaf_shapes == jplan.leaf_shapes
    assert (plan.n_floats, plan.n_packets) == (jplan.n_floats,
                                               jplan.n_packets)
    np.testing.assert_array_equal(plan.critical, jplan.critical)
    if arch == "smollm_360m":
        assert (plan.n_floats, plan.n_packets, plan.n_critical,
                len(plan.leaf_shapes)) == (361_821_120, 1_005_059, 15, 11)
        assert plan.leaf_shapes[2] == (32, 960, 320)   # stack/p0 mixer wk
    if arch == "gemma3_1b":
        stack = [p for p, _ in tree_leaves_with_path(tp) if p[0] == "stack"]
        assert {p[1] for p in stack} == {f"p{j}" for j in range(6)}
        assert len(tp["rem"]) == 2


@pytest.mark.parametrize("arch, n_layers, n_floats, n_packets", [
    ("mixtral_8x22b", 1, 2_906_720_256, 8_074_223),
    ("mixtral_8x22b", 2, 5_410_781_184, 15_029_948),
    ("deepseek_v2_236b", 2, 5_358_679_040, 14_885_220),
])
def test_moe_plans_at_the_card_depths_match_jax(arch, n_layers, n_floats,
                                                n_packets):
    """The MoE configs at their published widths and the depths
    ``chip_smoke.py`` drives (mixtral trains at 1 layer and serves at 2;
    deepseek-v2 serves its dense lead layer and first MoE layer) in
    bfloat16, the configs' dtype: the plan and each leaf's dtype, the
    router and norms float32."""
    jcfg = jget_config(arch).replace(n_layers=n_layers)
    cfg = get_config(arch).replace(n_layers=n_layers)
    jp = jax.eval_shape(jbuild(jcfg).init, jax.random.PRNGKey(0))
    with FakeTensorMode():
        tp = build(cfg).init(torch.Generator().manual_seed(0), device="cpu")
        plan = pk.make_plan(tp, 360)
    assert [str(x.dtype).replace("torch.", "") for x in tree_leaves(tp)] \
        == [str(x.dtype) for x in jax.tree.leaves(jp)]
    jplan = jpk.make_plan(jp, 360)
    assert (plan.n_floats, plan.n_packets) == (n_floats, n_packets) == (
        jplan.n_floats, jplan.n_packets)
    np.testing.assert_array_equal(plan.critical, jplan.critical)


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_and_support_match_jax(arch, shape):
    jcfg, cfg = jget_config(arch), get_config(arch)
    shp = SHAPES[shape]
    assert shape_supported(cfg, shp) == jshape_supported(jcfg, shp)
    want = jinput_specs(jcfg, shp)
    got = input_specs(cfg, shp)
    assert [p for p, _ in tree_leaves_with_path(got)] == _jax_paths(want)
    for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
        assert g.device.type == "meta"
        assert tuple(g.shape) == tuple(w.shape)
        assert str(g.dtype).replace("torch.", "") == str(w.dtype)


def test_demo_inputs_drive_a_train_and_a_decode_step():
    cfg = get_reduced("qwen2_vl_72b").replace(dtype="float32")
    api = build(cfg)
    gen = torch.Generator().manual_seed(0)
    params = api.init(gen, device="cpu")
    batch = demo_inputs(cfg, InputShape("t", 64, 2, "train"), gen,
                        device="cpu")
    assert batch["tokens"].shape == (2, 48) and \
        batch["patch_embeds"].shape == (2, 16, cfg.d_model)
    assert int(batch["tokens"].max()) < cfg.vocab
    assert np.isfinite(float(api.loss_fn(params, batch)))
    dec = demo_inputs(cfg, InputShape("d", 24, 2, "decode"), gen,
                      device="cpu")
    logits, cache = api.decode_step(params, dec["cache"], dec["token"],
                                    dec["pos"])
    assert logits.shape == (2, cfg.vocab_padded)
    assert torch.isfinite(logits).all()


def test_params_from_numpy_keeps_the_transformer_tree():
    """The empty ``lead`` / ``rem`` tuples stay tuples and the stacked
    leaves keep their leading period axis, both ways."""
    jcfg, _ = _cfgs("smollm_360m")
    jp = jax.tree.map(np.asarray, jbuild(jcfg).init(jax.random.PRNGKey(0)))
    tp = params_from_numpy(jp, "cpu")
    assert tp["lead"] == () and tp["rem"] == ()
    assert isinstance(tp["lead"], tuple) and isinstance(tp["rem"], tuple)
    assert tuple(tp["stack"]["p0"]["mixer"]["wq"].shape) == (2, 192, 192)
    back = params_to_numpy(tp)
    assert back["lead"] == () and isinstance(back["rem"], tuple)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(a, b)
    jcfg, _ = _cfgs("gemma3_1b", n_layers=8,
                    block_pattern=("W", "W", "W", "W", "W", "A"))
    tp = params_from_numpy(jax.tree.map(
        np.asarray, jbuild(jcfg).init(jax.random.PRNGKey(0))), "cpu")
    assert isinstance(tp["rem"], tuple) and len(tp["rem"]) == 2
    assert tp["stack"]["p5"]["mixer"]["wq"].shape[0] == 1
