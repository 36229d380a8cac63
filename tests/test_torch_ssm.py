"""The state-space mixers (``repro_torch.models.ssm``): the port against
the JAX package's ``models/ssm.py`` on the same numpy inputs, on the CPU,
at float32.

Params come from the JAX init (``mamba1_params`` / ``mamba2_params`` at
the REDUCED falcon-mamba-7b and zamba2-7b configs), with the leaves the
init leaves constant (``conv_b``, ``dt_bias``, ``D``, ``gamma``,
``A_log_m2``) moved by seeded noise so that every term is exercised;
inputs are seeded numpy draws. Tolerances: outputs and decode states
rtol 1e-5 / atol 1e-6 (the same float32 math, summed in another order
by the einsums); grads rtol 1e-4 / atol 1e-6, the transformer harness's
bound. Decode against the port's own forward, 12 steps: rtol 1e-4 /
atol 1e-5 (one position at a time against the whole sequence)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jget_reduced
from repro.models import ssm as jssm
from repro_torch.configs import get_reduced
from repro_torch.convert import params_from_numpy
from repro_torch.models import ssm
from repro_torch.tree import tree_leaves

B, N_DECODE = 2, 12
TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
# leaves the init sets to constants, moved by noise of this size
NOISY = ("conv_b", "dt_bias", "D", "gamma", "A_log_m2")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, **kw):
    return (jget_reduced(arch).replace(dtype="float32", **kw),
            get_reduced(arch).replace(dtype="float32", **kw))


def _params(kind, jcfg, seed=0):
    """(jax params, port params) of one mixer, from the JAX init."""
    init = jssm.mamba1_params if kind == "m1" else jssm.mamba2_params
    jp = jax.tree.map(np.asarray, init(jax.random.PRNGKey(seed), jcfg,
                                       jnp.float32))
    rng = np.random.default_rng(seed)
    jp = {k: (v + 0.1 * rng.normal(size=v.shape)).astype(np.float32)
          if k in NOISY else v for k, v in jp.items()}
    return jax.tree.map(jnp.asarray, jp), params_from_numpy(jp, "cpu")


def _mixer(kind):
    if kind == "m1":
        return ("falcon_mamba_7b", jssm.mamba1_forward, ssm.mamba1_forward,
                jssm.mamba1_decode, ssm.mamba1_decode,
                jssm.mamba1_state_init, ssm.mamba1_state_init)
    return ("zamba2_7b", jssm.mamba2_forward, ssm.mamba2_forward,
            jssm.mamba2_decode, ssm.mamba2_decode,
            jssm.mamba2_state_init, ssm.mamba2_state_init)


def _u(cfg, s, seed=1):
    return np.random.default_rng(seed).normal(
        size=(B, s, cfg.d_model)).astype(np.float32)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **tol)


def test_softplus_is_jaxs_everywhere():
    """``logaddexp(x, 0)``, linear nowhere, values and grads, far past
    ``F.softplus``'s threshold of 20 and far below zero."""
    x = np.linspace(-60.0, 60.0, 481).astype(np.float32)
    want = jax.nn.softplus(jnp.asarray(x))
    want_g = jax.grad(lambda v: jnp.sum(jax.nn.softplus(v)))(jnp.asarray(x))
    xt = torch.as_tensor(x).requires_grad_()
    got = ssm.softplus(xt)
    got.sum().backward()
    _close(got, want, **TOL)
    _close(xt.grad, want_g, **TOL)


def test_dt_rank_matches_jax():
    for arch in ("falcon_mamba_7b", "zamba2_7b"):
        jcfg, cfg = _cfgs(arch)
        for d in (1, 16, 17, 256, 4096):
            assert ssm._dt_rank(cfg.replace(d_model=d)) == \
                jssm._dt_rank(jcfg.replace(d_model=d))


@pytest.mark.parametrize("k, s, c", [(4, 16, 8), (4, 3, 5), (1, 7, 3),
                                     (2, 9, 4)])
def test_causal_conv_matches_jax(k, s, c):
    rng = np.random.default_rng(k * 100 + s)
    x = rng.normal(size=(B, s, c)).astype(np.float32)
    w = rng.normal(size=(k, c)).astype(np.float32)
    bias = rng.normal(size=(c,)).astype(np.float32)
    want = jssm._causal_conv(jnp.asarray(x), jnp.asarray(w),
                             jnp.asarray(bias))
    got = ssm._causal_conv(torch.as_tensor(x), torch.as_tensor(w),
                           torch.as_tensor(bias))
    _close(got, want, **TOL)


@pytest.mark.parametrize("k", [2, 4])
def test_conv_step_matches_jax_and_the_full_conv(k):
    """One token at a time through ``_conv_step`` against JAX's, and
    against the port's full-sequence ``_causal_conv``."""
    rng = np.random.default_rng(k)
    s, c = 10, 6
    x = rng.normal(size=(B, s, c)).astype(np.float32)
    w = rng.normal(size=(k, c)).astype(np.float32)
    bias = rng.normal(size=(c,)).astype(np.float32)
    jbuf = jnp.zeros((B, k - 1, c), jnp.float32)
    buf = torch.zeros((B, k - 1, c))
    tw, tb = torch.as_tensor(w), torch.as_tensor(bias)
    full = ssm._causal_conv(torch.as_tensor(x), tw, tb)
    for t in range(s):
        jy, jbuf = jssm._conv_step(jbuf, jnp.asarray(x[:, t]),
                                   jnp.asarray(w), jnp.asarray(bias))
        y, buf = ssm._conv_step(buf, torch.as_tensor(x[:, t]), tw, tb)
        _close(y, jy, **TOL)
        _close(buf, jbuf, **TOL)
        torch.testing.assert_close(y, full[:, t], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kind", ["m1", "m2"])
def test_params_tree_matches_jax(kind):
    """Leaf paths (capitalised keys sort first, as in JAX), shapes and
    dtypes of the port's own init, in float32 and bfloat16 (where
    ``A_log``, ``D``, ``dt_bias``, ``A_log_m2``, ``gamma`` stay
    float32)."""
    arch = _mixer(kind)[0]
    for dt_name in ("float32", "bfloat16"):
        jcfg = jget_reduced(arch).replace(dtype=dt_name)
        cfg = get_reduced(arch).replace(dtype=dt_name)
        jinit = jssm.mamba1_params if kind == "m1" else jssm.mamba2_params
        init = ssm.mamba1_params if kind == "m1" else ssm.mamba2_params
        jp = jinit(jax.random.PRNGKey(0), jcfg, jnp.dtype(dt_name))
        tp = init(torch.Generator().manual_seed(0), cfg,
                  getattr(torch, dt_name))
        assert sorted(tp) == sorted(jp)
        # leaf order: the capitalised keys first, in both walkers
        paths = [p[0].key for p, _ in
                 jax.tree_util.tree_flatten_with_path(jp)[0]]
        assert paths[0][0].isupper() and paths == sorted(tp)
        assert [tuple(x.shape) for x in tree_leaves(tp)] == \
            [x.shape for x in jax.tree.leaves(jp)]
        for k in jp:
            assert tuple(tp[k].shape) == jp[k].shape, k
            assert str(tp[k].dtype) == f"torch.{jp[k].dtype}", k
        for k in ("A_log", "D", "dt_bias") if kind == "m1" else \
                ("A_log_m2", "D", "dt_bias", "gamma"):
            assert tp[k].dtype == torch.float32
        # the constant leaves are the reference's values (A_log = log n
        # within an ulp: the two logs round differently)
        for k in ("dt_bias", "D") if kind == "m1" else \
                ("dt_bias", "A_log_m2", "D", "gamma"):
            np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))
        if kind == "m1":
            np.testing.assert_allclose(tp["A_log"].numpy(),
                                       np.asarray(jp["A_log"]), rtol=2e-7)


@pytest.mark.parametrize("kind", ["m1", "m2"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_state_init_matches_jax(kind, dtype):
    arch, *_, jinit, init = _mixer(kind)
    jcfg, cfg = _cfgs(arch)
    want = jinit(jcfg, 3, jnp.dtype(dtype))
    got = init(cfg, 3, getattr(torch, dtype), "cpu")
    assert sorted(got) == sorted(want) == ["conv", "h"]
    for k in want:
        assert tuple(got[k].shape) == want[k].shape
        assert str(got[k].dtype) == f"torch.{want[k].dtype}"
        assert not got[k].any()
    assert got["h"].dtype == torch.float32


def test_mamba1_forward_matches_jax():
    jcfg, cfg = _cfgs("falcon_mamba_7b")
    jp, tp = _params("m1", jcfg)
    u = _u(cfg, 16)
    want = jssm.mamba1_forward(jcfg, jp, jnp.asarray(u))
    got = ssm.mamba1_forward(cfg, tp, torch.as_tensor(u))
    assert got.shape == (B, 16, cfg.d_model)
    _close(got, want, **TOL)


@pytest.mark.parametrize("s, chunk", [(24, 8), (12, 8), (12, 128),
                                      (32, 128), (16, 16)],
                         ids=["3-chunks", "halved-to-4", "halved-12-to-4",
                              "1-chunk", "exact"])
def test_mamba2_forward_matches_jax(s, chunk):
    """S = 24 at chunk 8 carries the state across three chunks; S = 12
    takes the halving loop (8 -> 4, and 128 -> 4), three chunks of 4."""
    jcfg, cfg = _cfgs("zamba2_7b")
    jp, tp = _params("m2", jcfg)
    u = _u(cfg, s)
    want = jssm.mamba2_forward(jcfg, jp, jnp.asarray(u), chunk=chunk)
    got = ssm.mamba2_forward(cfg, tp, torch.as_tensor(u), chunk=chunk)
    assert got.shape == (B, s, cfg.d_model)
    _close(got, want, **TOL)


def _grads(kind, s, chunk=None, seed=0, scale_a=None):
    """Grads of mean(forward * cotangent) over params and input, both
    packages."""
    arch, jfwd, fwd, *_ = _mixer(kind)
    jcfg, cfg = _cfgs(arch)
    jp, tp = _params(kind, jcfg, seed)
    if scale_a is not None:
        jp = {**jp, "A_log_m2": jp["A_log_m2"] + scale_a}
        tp = {**tp, "A_log_m2": tp["A_log_m2"] + scale_a}
    u = _u(cfg, s, seed + 1)
    ct = np.random.default_rng(seed + 2).normal(
        size=(B, s, cfg.d_model)).astype(np.float32)
    kw = {} if chunk is None else {"chunk": chunk}

    def jloss(p, x):
        return jnp.mean(jfwd(jcfg, p, x, **kw) * jnp.asarray(ct))

    def loss(p, x):
        return torch.mean(fwd(cfg, p, x, **kw) * torch.as_tensor(ct))

    jg = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(u))
    g = torch.func.grad(loss, argnums=(0, 1))(tp, torch.as_tensor(u))
    return jax.tree.leaves(jg), tree_leaves(g)


@pytest.mark.parametrize("kind, s, chunk", [("m1", 12, None),
                                            ("m2", 24, 8),
                                            ("m2", 12, 128)])
def test_forward_grads_match_jax(kind, s, chunk):
    want, got = _grads(kind, s, chunk)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        _close(a, b, **GRAD_TOL)


def test_ssd_grads_stay_finite_under_strong_decay():
    """exp(A_log_m2 + 4) ~ 55 makes the decay above the diagonal overflow
    unless it is masked before the exp: the grads stay finite and equal
    JAX's."""
    want, got = _grads("m2", 16, 8, scale_a=4.0)
    for a, b in zip(got, want):
        assert torch.isfinite(a).all()
        _close(a, b, **GRAD_TOL)


@pytest.mark.parametrize("kind", ["m1", "m2"])
def test_decode_matches_jax_and_the_forward(kind):
    """``N_DECODE`` decode steps from ``*_state_init``: outputs and states
    against JAX's decode, and the outputs against the port's forward
    over the same tokens."""
    arch, _, fwd, jdec, dec, jinit, init = _mixer(kind)
    jcfg, cfg = _cfgs(arch)
    jp, tp = _params(kind, jcfg)
    u = _u(cfg, N_DECODE, seed=5)
    jstate = jinit(jcfg, B, jnp.float32)
    state = init(cfg, B, torch.float32, "cpu")
    outs = []
    for t in range(N_DECODE):
        jo, jstate = jdec(jcfg, jp, jnp.asarray(u[:, t:t + 1]), jstate)
        o, state = dec(cfg, tp, torch.as_tensor(u[:, t:t + 1]), state)
        assert o.shape == (B, 1, cfg.d_model)
        _close(o, jo, **TOL)
        for k in ("h", "conv"):
            _close(state[k], jstate[k], **TOL)
        outs.append(o)
    full = fwd(cfg, tp, torch.as_tensor(u))
    torch.testing.assert_close(torch.cat(outs, 1), full, rtol=1e-4,
                               atol=1e-5)


def test_scans_open_their_profiler_spans():
    """``mamba1_scan`` once a Mamba-1 forward, ``ssd_chunk`` once a chunk
    of a Mamba-2 forward (the spans ``chip_smoke.py`` reads)."""
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for kind, s, chunk in (("m1", 6, None), ("m2", 24, 8)):
        arch, _, fwd, *_ = _mixer(kind)
        jcfg, cfg = _cfgs(arch)
        _, tp = _params(kind, jcfg)
        kw = {} if chunk is None else {"chunk": chunk}
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            fwd(cfg, tp, torch.as_tensor(_u(cfg, s)), **kw)
        names = [e.name for e in prof.events()]
        out[kind] = (names.count("mamba1_scan"), names.count("ssd_chunk"))
    assert out == {"m1": (1, 0), "m2": (0, 3)}


@pytest.mark.parametrize("arch", ["falcon_mamba_7b", "zamba2_7b"])
def test_convert_and_checkpoint_carry_the_bf16_trees(arch, tmp_path):
    """The JAX init of a REDUCED SSM arch in its own bfloat16, as numpy,
    through ``params_from_numpy``: the same leaf paths, shapes and dtypes
    (the SSM constants and ``gamma`` float32), the same packet plan and
    critical mask; and through an npz checkpoint and back, bit for
    bit."""
    from repro.core import packets as jpk
    from repro.models import build as jbuild
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.core import packets as pk
    from repro_torch.tree import tree_leaves_with_path

    jp = jax.tree.map(np.asarray, jbuild(jget_reduced(arch)).init(
        jax.random.PRNGKey(0)))
    tp = params_from_numpy(jp, "cpu")
    jleaves = jax.tree_util.tree_flatten_with_path(jp)[0]
    got = tree_leaves_with_path(tp)
    assert [p for p, _ in got] == [
        tuple(getattr(k, "key", getattr(k, "idx", None)) for k in p)
        for p, _ in jleaves]
    f32 = {"A_log", "D", "dt_bias", "A_log_m2", "gamma", "scale"}
    for (path, a), (_, b) in zip(got, jleaves):
        assert str(a.dtype) == f"torch.{b.dtype}"
        assert (a.dtype == torch.float32) == (path[-1] in f32), path
    plan, jplan = pk.make_plan(tp, 360), jpk.make_plan(jp, 360)
    assert (plan.n_floats, plan.n_packets, plan.leaf_shapes) == \
        (jplan.n_floats, jplan.n_packets, jplan.leaf_shapes)
    np.testing.assert_array_equal(plan.critical, jplan.critical)
    path = str(tmp_path / "ck")
    save_checkpoint(path, tp, step=3)
    back, step = restore_checkpoint(path, tp)
    assert step == 3
    for a, b in zip(tree_leaves(back), tree_leaves(tp), strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("arch, n_layers, n_floats, n_packets, n_critical", [
    ("falcon_mamba_7b", 2, 743_305_216, 2_064_737, 14),
    ("zamba2_7b", 7, 980_754_096, 2_724_317, 62),
    ("zamba2_7b", 13, 1_448_622_480, 4_023_952, None),
])
def test_ssm_plans_at_the_card_depths_match_jax(arch, n_layers, n_floats,
                                                n_packets, n_critical):
    """The SSM configs at their published widths and the depths
    ``chip_smoke.py`` drives (falcon-mamba trains and serves at 2 layers,
    zamba2 trains at 7: one period and a trailing layer, and serves at
    13: two periods) in bfloat16, the configs' dtype, with nothing
    allocated: leaf paths and dtypes, the plan and its critical mask."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro.configs import get_config as jget_config
    from repro.core import packets as jpk
    from repro.models import build as jbuild
    from repro_torch.configs import get_config
    from repro_torch.core import packets as pk
    from repro_torch.models import build

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
    if n_critical is not None:
        assert plan.n_critical == n_critical


def test_zamba2_step1_loss_at_the_tp_depth_matches_jax():
    """Zamba2 at REDUCED widths and the depth of ``chip_smoke.py``'s
    ``tp`` phase (7 layers: one period of 6 Mamba-2 layers, the shared
    block, one more), float32, from the JAX init, on a (8, 128) batch of
    ``SyntheticLM`` text: the loss within rtol 1e-5 of the JAX package's.
    Its mean logsumexp is ln V + s^2 / 2 (s^2 the logits' variance, the
    0.02^2 d of ``chip_smoke.tp_expected_loss``) within 0.02, so the
    loss's gap to that value is the label tokens' mean logit, which
    ``tp_expected_loss`` counts as a spread around it."""
    import math

    from repro.models import build as jbuild
    from repro_torch.data import SyntheticLM
    from repro_torch.models import build
    from repro_torch.models import transformer

    jcfg, cfg = _cfgs("zamba2_7b", n_layers=7, shared_attn_every=6)
    japi, api = jbuild(jcfg), build(cfg)
    jp = japi.init(jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    batch = SyntheticLM(vocab=cfg.vocab, seed=0).train_batch(8, 128, 0)
    jloss = float(jax.jit(japi.loss_fn)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()}))
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    with torch.no_grad():
        loss = float(api.loss_fn(params, tb))
        logits = transformer.forward(cfg, params, tb)[0][..., :cfg.vocab]
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    lse = torch.logsumexp(logits, -1).mean().item()
    s2 = logits.var(-1).mean().item()
    assert abs(lse - math.log(cfg.vocab) - s2 / 2) < 0.02
    label = torch.gather(logits, -1, tb["labels"].long()[..., None]).mean()
    np.testing.assert_allclose(loss, lse - label.item(), rtol=1e-5)
