"""The port's LM driver (``repro_torch.train.lm``) against a JAX loop
written like ``examples/train_lm.py``, and its serve loop
(``repro_torch.train.serve``) against one written like
``examples/serve.py``, on the CPU.

Training runs at the example's ``--tiny`` model (2 layers, d_model 128,
vocab 512), and with SGD-momentum also at the REDUCED mixtral-8x22b and
deepseek-v2 (MoE, MLA), falcon-mamba-7b and zamba2-7b (Mamba-1; Mamba-2
with the shared attention block), on 4 workers, batch 8, seq 16, 3
steps, both from the JAX init of seed 0. ``step``, ``bst`` and ``sim_time`` come
from the numpy transport model and agree exactly, ``delivered`` within rtol 1e-6 (a
float32 mean of the same {0, 1} masks summed in another order); losses
agree within rtol 1e-4. Params are compared (rtol 2e-4 / atol 2e-5) on
SGD-momentum runs only: AdamW's first update is about lr * sign(g), so
an element whose 4-worker sum lies within rounding of zero moves by
2 * lr between the two packages, a difference that says nothing about
the port. Greedy decode of REDUCED smollm, mixtral-8x22b, deepseek-v2,
falcon-mamba-7b, zamba2-7b and whisper-small gives the same tokens.
REDUCED whisper-small, the enc-dec family, trains 2 steps with
SGD-momentum against the JAX loop fed the same frames."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import LTPConfig as JLTPConfig
from repro.config import NetConfig as JNetConfig
from repro.config import TrainConfig as JTrainConfig
from repro.configs import get_config as jget_config
from repro.configs import get_reduced as jget_reduced
from repro.data import SyntheticLM as JSyntheticLM
from repro.models import build as jbuild
from repro.optim import make_optimizer as jmake_optimizer
from repro.train import PSTrainer as JPSTrainer
from repro_torch.config import LTPConfig, TrainConfig
from repro_torch.convert import params_from_numpy
from repro_torch.configs import get_reduced
from repro_torch.runtime import step as stp
from repro_torch.train import serve, train_lm
from repro_torch.train.lm import audio_frames, lm_config, lm_trainer
from repro_torch.tree import tree_leaves

W, BATCH, SEQ, STEPS = 4, 8, 16, 3
EF = dict(compensation="count", error_feedback=True)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_cfg():
    return jget_config("smollm_360m").replace(
        n_layers=2, d_model=128, n_heads=4, n_kv=2, head_dim=32, d_ff=256,
        vocab=512, dtype="float32")


def _jax_loop(optimizer="adamw", lr=3e-4, cfg=None, steps=STEPS,
              **ltp_kw):
    """``examples/train_lm.py --tiny`` (or ``cfg``) at the test's sizes;
    returns the trainer and the init it started from. An enc-dec
    ``cfg``'s batches also carry the frames ``lm_trainer`` draws
    (``audio_frames``, seed 0)."""
    cfg = cfg or _jax_cfg()
    api = jbuild(cfg)
    lm = JSyntheticLM(vocab=cfg.vocab, seed=0)
    tc = JTrainConfig(batch=BATCH, seq=SEQ, lr=lr, optimizer=optimizer,
                      steps=steps)
    tr = JPSTrainer(api, jmake_optimizer(tc), tc, JLTPConfig(**ltp_kw),
                    JNetConfig(10, 1, 0.001, 4096), n_workers=W,
                    protocol="ltp", compute_time=0.05, seed=0)
    init = jax.tree.map(np.asarray, api.init(jax.random.PRNGKey(0)))

    def gen():
        for step in range(steps):
            batch = lm.train_batch(BATCH, SEQ, step)
            if cfg.family == "audio":
                batch["frames"] = audio_frames(cfg, BATCH, 0, step)
            yield batch

    tr.run(gen(), epoch_steps=100)
    return tr, init


def _same_transport(hist, jhist, steps=STEPS):
    assert len(hist) == len(jhist) == steps
    for a, b in zip(hist, jhist):
        assert (a["step"], a["bst"], a["sim_time"]) == \
            (b["step"], b["bst"], b["sim_time"])
        np.testing.assert_allclose(a["delivered"], b["delivered"], rtol=1e-6)
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-4)


def test_tiny_config_is_the_examples():
    cfg = lm_config(tiny=True)
    jcfg = _jax_cfg()
    for f in ("n_layers", "d_model", "n_heads", "n_kv", "head_dim", "d_ff",
              "vocab", "dtype", "tie_embeddings", "family"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    full = lm_config()
    assert (full.n_layers, full.d_model, full.vocab) == (12, 768, 8192)


def test_train_lm_adamw_matches_jax_loop():
    jtr, init = _jax_loop()
    hist = train_lm(tiny=True, steps=STEPS, workers=W, seq=SEQ, batch=BATCH,
                    device="cpu", params=params_from_numpy(init, "cpu"))
    _same_transport(hist, jtr.history)
    assert hist[-1]["loss"] < hist[0]["loss"]


@pytest.mark.parametrize("arch, ltp_kw, chunked", [
    pytest.param(None, {}, False, id="paper"),
    pytest.param(None, EF, False, id="count_ef"),
    pytest.param(None, {}, True, id="paper_chunk1"),
    pytest.param(None, EF, True, id="count_ef_chunk1"),
    pytest.param("mixtral_8x22b", {}, False, id="mixtral-paper"),
    pytest.param("mixtral_8x22b", EF, True, id="mixtral-count_ef_chunk1"),
    pytest.param("deepseek_v2_236b", {}, False, id="deepseek-paper"),
    pytest.param("deepseek_v2_236b", EF, True,
                 id="deepseek-count_ef_chunk1"),
    pytest.param("falcon_mamba_7b", {}, False, id="falcon-mamba-paper"),
    pytest.param("falcon_mamba_7b", EF, True,
                 id="falcon-mamba-count_ef_chunk1"),
    pytest.param("zamba2_7b", {}, False, id="zamba2-paper"),
    pytest.param("zamba2_7b", EF, True, id="zamba2-count_ef_chunk1"),
])
def test_lm_trainer_sgdm_params_match_jax_loop(arch, ltp_kw, chunked,
                                                monkeypatch):
    """``arch``: the REDUCED config of an MoE arch (its loss carries 0.01
    aux) or of an SSM arch (Mamba-1; Mamba-2 with the shared block) in
    place of the example's tiny model. ``chunked``: the fused
    step takes its workers one vmap at a time, as it does for models of
    more than 3 x 2^29 / W floats."""
    if chunked:
        monkeypatch.setattr(stp, "WORKER_CHUNK_FLOATS", 1)
    if arch is None:
        jcfg, cfg = None, lm_config(tiny=True)
    else:
        jcfg = jget_reduced(arch).replace(dtype="float32")
        cfg = get_reduced(arch).replace(dtype="float32")
    jtr, init = _jax_loop(optimizer="sgdm", lr=0.1, cfg=jcfg, **ltp_kw)
    tc = TrainConfig(batch=BATCH, seq=SEQ, lr=0.1, optimizer="sgdm",
                     steps=STEPS)
    tr, data = lm_trainer(cfg, workers=W, train=tc,
                          ltp=LTPConfig(**ltp_kw), device="cpu",
                          params=params_from_numpy(init, "cpu"))
    assert stp.worker_chunk(tr.plan, W) == (1 if chunked else W)
    tr.run(data, epoch_steps=100)
    _same_transport(tr.history, jtr.history)
    got, want = tree_leaves(tr.params), jax.tree.leaves(jtr.params)
    assert len(got) == len(want)
    if arch is None:
        assert len(got) == 11
    elif cfg.n_experts:
        assert "moe" in tr.params["stack"]["p0"]
    else:
        assert {"A_log", "A_log_m2"} & set(tr.params["stack"]["p0"]["mixer"])
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4,
                                   atol=2e-5)
    if ltp_kw:
        np.testing.assert_allclose(tr.residual.numpy(),
                                   np.asarray(jtr.residual), rtol=2e-4,
                                   atol=2e-5)


@pytest.mark.parametrize("ltp_kw, chunked", [
    pytest.param({}, False, id="paper"),
    pytest.param(EF, True, id="count_ef_chunk1"),
])
def test_lm_trainer_whisper_matches_jax_loop(ltp_kw, chunked, monkeypatch):
    """The enc-dec family: REDUCED whisper-small at float32, 2 steps of
    SGD-momentum, against the JAX loop fed the same frames; transport
    fields, losses and params as above. Each host batch carries the
    (batch, 64, 192) float32 frames of ``audio_frames``."""
    if chunked:
        monkeypatch.setattr(stp, "WORKER_CHUNK_FLOATS", 1)
    jcfg = jget_reduced("whisper_small").replace(dtype="float32")
    cfg = get_reduced("whisper_small").replace(dtype="float32")
    jtr, init = _jax_loop(optimizer="sgdm", lr=0.1, cfg=jcfg, steps=2,
                          **ltp_kw)
    tc = TrainConfig(batch=BATCH, seq=SEQ, lr=0.1, optimizer="sgdm",
                     steps=2)
    tr, data = lm_trainer(cfg, workers=W, train=tc,
                          ltp=LTPConfig(**ltp_kw), device="cpu",
                          params=params_from_numpy(init, "cpu"))
    assert [sorted(b) for b in data] == [["frames", "labels", "tokens"]] * 2
    assert data[1]["frames"].shape == (BATCH, 64, 192)
    assert data[1]["frames"].dtype == np.float32
    assert not np.array_equal(data[0]["frames"], data[1]["frames"])
    tr.run(data, epoch_steps=100)
    _same_transport(tr.history, jtr.history, steps=2)
    got, want = tree_leaves(tr.params), jax.tree.leaves(jtr.params)
    assert len(got) == len(want) == 32
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4,
                                   atol=2e-5)
    if ltp_kw:
        np.testing.assert_allclose(tr.residual.numpy(),
                                   np.asarray(jtr.residual), rtol=2e-4,
                                   atol=2e-5)


def test_lm_trainer_feeds_a_smaller_corpus():
    """``data_vocab`` draws tokens from a smaller corpus; the model keeps
    its vocab."""
    tr, data = lm_trainer(lm_config(tiny=True), steps=2, workers=2,
                          batch=4, seq=8, data_vocab=64, device="cpu")
    assert len(data) == 2 and data[0]["tokens"].shape == (4, 8)
    assert max(int(b[k].max()) for b in data for k in b) < 64
    assert tr.params["embed"]["embed"].shape == (512, 128)


def _serve_both(arch):
    """``examples/serve.py``'s loop on ``arch``'s REDUCED config at
    float32, batch 4, prompt 16, 24 new tokens, and ``serve`` from the
    same params and prompts: equal greedy tokens."""
    batch, plen, new = 4, 16, 24
    cfg = jget_reduced(arch).replace(dtype="float32")
    api = jbuild(cfg)
    key = jax.random.PRNGKey(0)
    params = api.init(key)
    cache = api.init_cache(batch, plen + new, jnp.float32)
    prompts = jax.random.randint(key, (batch, plen), 0, cfg.vocab)
    for t in range(plen):
        logits, cache = api.decode_step(params, cache, prompts[:, t],
                                        jnp.int32(t))
    tok = jnp.argmax(logits[:, : cfg.vocab], axis=-1).astype(jnp.int32)
    out = [tok]
    for i in range(new - 1):
        logits, cache = api.decode_step(params, cache, tok,
                                        jnp.int32(plen + i))
        tok = jnp.argmax(logits[:, : cfg.vocab], axis=-1).astype(jnp.int32)
        out.append(tok)
    want = np.stack([np.asarray(t) for t in out], axis=1)

    got = serve(arch=arch, batch=batch, prompt_len=plen, new=new,
                device="cpu",
                params=params_from_numpy(jax.tree.map(np.asarray, params),
                                         "cpu"),
                prompts=np.asarray(prompts))
    assert got["tokens"].shape == (batch, new)
    np.testing.assert_array_equal(got["tokens"], want)
    assert got["prompt_logits"].shape == (batch, plen, cfg.vocab_padded)
    assert got["tokens_per_s"] > 0


def test_serve_greedy_tokens_match_jax():
    _serve_both("smollm_360m")


@pytest.mark.parametrize("arch", ["mixtral_8x22b", "deepseek_v2_236b"])
def test_serve_greedy_tokens_match_jax_moe(arch):
    """MoE decode: each step routes the batch's 4 tokens (no token is
    dropped at a capacity of 8); deepseek-v2 decodes by absorbed MLA."""
    _serve_both(arch)


@pytest.mark.parametrize("arch", ["falcon_mamba_7b", "zamba2_7b"])
def test_serve_greedy_tokens_match_jax_ssm(arch):
    """SSM decode: each step updates the Mamba states; zamba2's shared
    block attends over its own KV slot."""
    _serve_both(arch)


def test_serve_greedy_tokens_match_jax_encdec():
    """Enc-dec decode, as ``examples/serve.py`` serves whisper: against
    ``init_cache``'s cross K/V, which nothing fills (zero keys and
    values: each cross-attention adds ``0 @ wo``)."""
    _serve_both("whisper_small")
