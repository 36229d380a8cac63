"""bfloat16, the configs' own dtype: the port against the JAX package on
the CPU at REDUCED smollm-360m (dense), mixtral-8x22b (MoE),
falcon-mamba-7b (Mamba-1), zamba2-7b (Mamba-2 and the shared
attention block) and whisper-small (enc-dec, its frames drawn as
``lm_trainer`` draws them), from the same bfloat16 params (``params_from_numpy`` carries JAX's
bfloat16 leaves bit for bit, and its float32 leaves, the norm scales and
the MoE router, as float32).

Tolerances, set from the readings at these seeds with room on both
sides. The losses agree within 4e-5 relative and every leaf's grad
within a relative L2 distance of 0.017 (the router's; bfloat16 rounds
each op by up to 2^-9, in another order in each package); the SSM archs
read 2.6e-5 / 0.012 (falcon-mamba) and 7.3e-5 / 0.019 (zamba2), whisper
1.2e-6 / 0.0083. So the loss
is held to rtol 1e-3 and the grads to 3e-2. Dropping the ``0.01 * aux``
term moves the loss by 3.5e-3 and the router's grad by 0.30, and a
control test shows that both bounds catch it. The router itself, given
the same bfloat16 input, is float32 work in both packages and is held
to float32's rtol 1e-5 / atol 1e-6; a control shows that a router run in
bfloat16 (weights off by 8e-3) fails that check.

A 2-step ``lm_trainer`` run against a JAX loop written like
``examples/train_lm.py`` (AdamW lr 3e-4, W = 4, batch 8, seq 16):
``step``, ``bst`` and ``sim_time`` equal and ``delivered`` within rtol
1e-6 (the numpy transport model), losses within rtol 1e-3 (they read
within 9.3e-5); every leaf keeps its dtype through the update.
At these seeds no router choice flips between the two packages."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad_and_value

from repro.config import LTPConfig as JLTPConfig
from repro.config import NetConfig as JNetConfig
from repro.config import TrainConfig as JTrainConfig
from repro.configs import get_reduced as jget_reduced
from repro.data import SyntheticLM as JSyntheticLM
from repro.models import build as jbuild
from repro.models import moe as jmoe
from repro.optim import make_optimizer as jmake_optimizer
from repro.train import PSTrainer as JPSTrainer
from repro_torch.configs import get_reduced
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.models import build, moe
from repro_torch.train.lm import audio_frames, lm_trainer
from repro_torch.tree import tree_leaves

ARCHS = ["smollm_360m", "mixtral_8x22b", "falcon_mamba_7b", "zamba2_7b",
         "whisper_small"]
W, BATCH, SEQ, STEPS = 4, 8, 16, 2
LOSS_RTOL, GRAD_REL_L2 = 1e-3, 3e-2


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch):
    return (jget_reduced(arch).replace(dtype="bfloat16"),
            get_reduced(arch).replace(dtype="bfloat16"))


def _rel_l2(got: torch.Tensor, want) -> float:
    g = got.to(torch.float32).numpy().astype(np.float64)
    w = np.asarray(want, np.float32).astype(np.float64)
    return float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))


def test_params_from_numpy_carries_bfloat16_bits():
    jcfg, _ = _cfgs("mixtral_8x22b")
    jp = jax.tree.map(np.asarray, jbuild(jcfg).init(jax.random.PRNGKey(0)))
    tp = params_from_numpy(jp, "cpu")
    jl, tl = jax.tree.leaves(jp), tree_leaves(tp)
    assert {str(x.dtype) for x in jl} == {"bfloat16", "float32"}
    for a, b in zip(tl, jl):
        assert str(a.dtype) == f"torch.{b.dtype}"
        np.testing.assert_array_equal(params_to_numpy(a),
                                      b.astype(np.float32))


def _loss_and_grad_gaps(arch):
    """(the loss's relative gap to JAX's, each leaf's grad's relative L2
    distance to JAX's), from one loss_fn at batch 2 x seq 32."""
    jcfg, cfg = _cfgs(arch)
    jp = jbuild(jcfg).init(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab, (2, 32)).astype(np.int32),
             "labels": rng.integers(-1, cfg.vocab, (2, 32)).astype(np.int32)}
    if cfg.family == "audio":
        batch["frames"] = audio_frames(cfg, 2, 0, 0)
    jl, jg = jax.value_and_grad(lambda p: jbuild(jcfg).loss_fn(
        p, {k: jnp.asarray(v) for k, v in batch.items()}))(jp)
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    tg, tl = grad_and_value(lambda p: build(cfg).loss_fn(p, tb))(tp)
    got, want = tree_leaves(tg), jax.tree.leaves(jg)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert str(a.dtype) == f"torch.{b.dtype}"
    return (abs(float(tl) - float(jl)) / abs(float(jl)),
            [_rel_l2(a, b) for a, b in zip(got, want)])


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax_bf16(arch):
    loss_gap, grad_gaps = _loss_and_grad_gaps(arch)
    assert loss_gap <= LOSS_RTOL
    assert max(grad_gaps) <= GRAD_REL_L2


def test_bf16_bounds_catch_a_missing_aux_term(monkeypatch):
    """Control: the MoE layers' aux loss zeroed, so ``loss_fn`` leaves out
    its ``0.01 * aux`` term; both bounds must see it."""
    apply_moe = moe.apply_moe

    def without_aux(*args, **kwargs):
        y, aux = apply_moe(*args, **kwargs)
        return y, aux * 0

    monkeypatch.setattr(moe, "apply_moe", without_aux)
    loss_gap, grad_gaps = _loss_and_grad_gaps("mixtral_8x22b")
    assert loss_gap > LOSS_RTOL
    assert max(grad_gaps) > GRAD_REL_L2


def _router_in_bf16(cfg, p, xf):
    """``moe.router`` with its float32 casts left out (a planted fault)."""
    probs = torch.softmax(xf @ p["moe_gate"].to(xf.dtype), dim=-1)
    ids = torch.argsort(-probs, dim=-1, stable=True)[:, : cfg.top_k]
    weights = torch.gather(probs, -1, ids)
    weights = weights / torch.sum(weights, dim=-1, keepdim=True)
    experts = torch.arange(cfg.n_experts)
    density = torch.mean((ids[:, :1] == experts).to(torch.float32), dim=0)
    aux = torch.sum(density * torch.mean(probs.float(), dim=0))
    return weights.float(), ids, aux * cfg.n_experts


def _check_router_on_bf16_input(router):
    jcfg, cfg = _cfgs("mixtral_8x22b")
    jp = jmoe.moe_params(jax.random.PRNGKey(3), jcfg, jnp.bfloat16)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    jx = jnp.asarray(np.random.default_rng(0).normal(
        size=(64, cfg.d_model)), jnp.bfloat16)
    jw, jids, jaux = jmoe.router(jcfg, jp, jx)
    w, ids, aux = router(cfg, tp, params_from_numpy(np.asarray(jx), "cpu"))
    assert w.dtype == torch.float32
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5,
                               atol=1e-6)


def test_router_on_bf16_input_matches_jax_at_f32_tolerance():
    _check_router_on_bf16_input(moe.router)


def test_router_check_catches_a_router_run_in_bf16():
    with pytest.raises(AssertionError):
        _check_router_on_bf16_input(_router_in_bf16)


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_trainer_bf16_matches_jax_loop(arch):
    jcfg, cfg = _cfgs(arch)
    api = jbuild(jcfg)
    tc = JTrainConfig(batch=BATCH, seq=SEQ, lr=3e-4, optimizer="adamw",
                      steps=STEPS)
    jtr = JPSTrainer(api, jmake_optimizer(tc), tc, JLTPConfig(),
                     JNetConfig(10, 1, 0.001, 4096), n_workers=W,
                     protocol="ltp", compute_time=0.05, seed=0)
    init = jax.tree.map(np.asarray, api.init(jax.random.PRNGKey(0)))
    lm = JSyntheticLM(vocab=jcfg.vocab, seed=0)

    def host_batch(step):
        batch = lm.train_batch(BATCH, SEQ, step)
        if cfg.family == "audio":
            batch["frames"] = audio_frames(cfg, BATCH, 0, step)
        return batch

    jtr.run((host_batch(s) for s in range(STEPS)), epoch_steps=100)

    tr, data = lm_trainer(cfg, steps=STEPS, workers=W, seq=SEQ,
                          batch=BATCH, device="cpu",
                          params=params_from_numpy(init, "cpu"))
    dtypes = [x.dtype for x in tree_leaves(tr.params)]
    assert torch.bfloat16 in dtypes and torch.float32 in dtypes
    tr.run(data, epoch_steps=100)
    assert [x.dtype for x in tree_leaves(tr.params)] == dtypes
    hist, jhist = tr.history, jtr.history
    assert len(hist) == len(jhist) == STEPS
    for a, b in zip(hist, jhist):
        assert (a["step"], a["bst"], a["sim_time"]) == \
            (b["step"], b["bst"], b["sim_time"])
        np.testing.assert_allclose(a["delivered"], b["delivered"], rtol=1e-6)
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=LOSS_RTOL)
