"""The serve path tensor-parallel over ``model``: ``prefill``,
``init_cache`` and ``decode_step`` under ``ctx`` (``models/api.py``,
``transformer``, ``encdec``, ``attention``, ``mla``, ``moe``, ``ssm``,
``layers.gather_vocab``, ``sharding.cache_spec``), on the CPU, with gloo
ranks as subprocesses (``tests/sharded_cases.py``, the ``serve12`` and
``serve22`` tasks) on (data 1, model 2) and (data 2, model 2), for the
REDUCED smollm-360m, mixtral-8x22b, deepseek-v2, falcon-mamba, zamba2
and whisper-small at float32:

- the prefill's last-token logits and its cache, then 8 decode steps
  from ``init_cache`` fed the same tokens, their logits and the cache
  after them, against the JAX package's ``api.prefill`` and
  ``api.decode_step`` on the same params and inputs. The reference runs
  unsharded: its ``ShardCtx`` only adds sharding constraints, which
  change no number, and it routes each MoE group over one data shard,
  so each data rank's rows are held against the reference on those
  rows alone;
- each rank's cache shapes against ``sharding.cache_spec``'s layout of
  the global cache;
- decode under ``ctx`` against the forward under ``ctx`` on the same 8
  tokens (each sequence alone, so an MoE layer drops nothing in either).

Tolerances: logits rtol 1e-5 with an atol of 1e-5 of the largest
logit; the caches, gathered over ``model``, the same way with the
largest entry of each leaf; decode against forward rtol 1e-4 / atol
1e-5, as ``tests/test_torch_transformer.py`` holds the unsharded pair.
A gloo run fails at ``sharded_cases.TIMEOUT_S`` if a rank hangs.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sharded_cases as sc
from repro.configs import get_reduced as jget_reduced
from repro.models import build as jbuild
from repro_torch.configs import get_reduced
from repro_torch.convert import params_from_numpy
from repro_torch.models import build
from repro_torch.models.sharding import cache_segments, cache_spec, \
    local_shape
from repro_torch.tree import tree_leaves, tree_leaves_with_path

CASES = [(task, arch) for task in sc.SERVE_MESH for arch in sc.SERVE_MODELS]
DECODER_CASES = [(task, arch) for task, arch in CASES
                 if arch != "whisper_small"]


def _jax_cfg(arch):
    return jget_reduced(arch).replace(dtype="float32")


def _reference(arch, jp, inp, rows):
    """The JAX package's prefill and 8 decode steps on ``rows`` of the
    batch: (prefill logits, prefill cache leaves, decode logits, decode
    cache leaves), numpy."""
    japi = jbuild(_jax_cfg(arch))
    pin = {"tokens": jnp.asarray(inp["tokens"][rows])}
    if "frames" in inp:
        pin["frames"] = jnp.asarray(inp["frames"][rows])
    pl, pc = jax.jit(japi.prefill)(jp, pin)
    toks = inp["decode"][rows]
    jc = japi.init_cache(toks.shape[0], sc.SERVE_STEPS, jnp.float32)
    step = jax.jit(japi.decode_step)
    out = []
    for t in range(sc.SERVE_STEPS):
        lg, jc = step(jp, jc, jnp.asarray(toks[:, t]), jnp.int32(t))
        out.append(np.asarray(lg))
    return (np.asarray(pl), [np.asarray(x) for x in jax.tree.leaves(pc)],
            np.stack(out, 1), [np.asarray(x) for x in jax.tree.leaves(jc)])


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The ranks' records by task, and the reference's by (arch, number
    of data blocks, block): the params and inputs written first, every
    rank started, the reference computed here meanwhile."""
    d = str(tmp_path_factory.mktemp("serve"))
    z, jparams, inputs = {}, {}, {}
    for arch in sc.SERVE_MODELS:
        jp = jbuild(_jax_cfg(arch)).init(jax.random.PRNGKey(0))
        jparams[arch] = jp
        tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
        for i, x in enumerate(tree_leaves(tp)):
            z[f"{arch}/param/{i}"] = x.numpy()
        inputs[arch] = sc.serve_inputs(sc.serve_cfg(get_reduced, arch))
        for k, v in inputs[arch].items():
            z[f"{arch}/in/{k}"] = v
    ref = os.path.join(d, "serve_in.npz")
    np.savez(ref, **z)
    started = {task: sc.start_ranks(task, nd * nm, ref, d)
               for task, (nd, nm) in sc.SERVE_MESH.items()}
    try:
        want = {}
        for arch in sc.SERVE_MODELS:
            for nd in sorted({nd for nd, _ in sc.SERVE_MESH.values()}):
                size = sc.SERVE_B // nd
                for di in range(nd):
                    want[arch, nd, di] = _reference(
                        arch, jparams[arch], inputs[arch],
                        slice(di * size, (di + 1) * size))
        got = {task: sc.finish_ranks(s) for task, s in started.items()}
    finally:
        for procs, _ in started.values():
            for p in procs:
                if p.poll() is None:
                    p.kill()
    return got, want


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))


def _ranks(task):
    nd, nm = sc.SERVE_MESH[task]
    return [(r, r // nm) for r in range(nd * nm)], nd


@pytest.mark.parametrize("task,arch", CASES)
def test_prefill_matches_jax(served, task, arch):
    """The last-token logits (whole on every rank) and the prefill's cache
    gathered over ``model`` (an SSM layer keeps none, in the reference
    too)."""
    got, want = served
    ranks, nd = _ranks(task)
    for r, di in ranks:
        rec = got[task][r]
        pl, pc, _, _ = want[arch, nd, di]
        _close(rec[f"{arch}/prefill_logits"], pl)
        leaves = [rec[f"{arch}/prefill_cache/{i}"] for i in range(len(pc))]
        assert f"{arch}/prefill_cache/{len(pc)}" not in rec
        for a, b in zip(leaves, pc, strict=True):
            assert a.shape == b.shape
            _close(a, b)


@pytest.mark.parametrize("task,arch", CASES)
def test_decode_matches_jax(served, task, arch):
    """8 decode steps from ``init_cache(..., ctx=)``: every step's logits
    and the cache after the last, gathered over ``model``."""
    got, want = served
    ranks, nd = _ranks(task)
    for r, di in ranks:
        rec = got[task][r]
        _, _, dl, dc = want[arch, nd, di]
        _close(rec[f"{arch}/decode_logits"], dl)
        for i, b in enumerate(dc):
            a = rec[f"{arch}/decode_cache/{i}"]
            assert a.shape == b.shape
            _close(a, b)


@pytest.mark.parametrize("task,arch", CASES)
def test_cache_shapes_follow_the_layout(served, task, arch):
    """Each rank's ``init_cache(..., ctx=)`` leaves have the shapes that
    ``cache_spec`` (and ``cache_segments``) give of the global cache's,
    and the model rank's heads or channels are split wherever the layer
    splits them (at (1, 2) every one of these models splits some leaf)."""
    got, _ = served
    ranks, nd = _ranks(task)
    nm = sc.SERVE_MESH[task][1]
    cfg = sc.serve_cfg(get_reduced, arch)
    full = build(cfg).init_cache(sc.SERVE_B // nd, sc.SERVE_STEPS,
                                 torch.float32, device="meta")
    want = []
    for path, x in tree_leaves_with_path(full):
        code = sc.cache_code(cfg, path[-1])
        want.append(local_shape(tuple(x.shape), cache_spec(
            cfg, code, path[-1], x.dim(), nm), nm,
            cache_segments(cfg, code, path[-1])))
    if arch != "deepseek_v2_236b":   # MLA's latent cache is whole
        assert any(w != tuple(x.shape)
                   for w, x in zip(want, tree_leaves(full)))
    for r, _ in ranks:
        rec = got[task][r]
        shapes = [tuple(rec[f"{arch}/cache_shape/{i}"])
                  for i in range(len(want))]
        assert shapes == want


@pytest.mark.parametrize("task,arch", DECODER_CASES)
def test_decode_under_ctx_matches_forward(served, task, arch):
    got, _ = served
    ranks, _ = _ranks(task)
    for r, _ in ranks:
        rec = got[task][r]
        np.testing.assert_allclose(rec[f"{arch}/decode_logits"],
                                   rec[f"{arch}/forward_logits"],
                                   rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("arch", ["smollm_360m", "mixtral_8x22b",
                                  "deepseek_v2_236b", "falcon_mamba_7b"])
def test_decode_from_the_prefill_cache(arch):
    """``transformer.cache_from_prefill``: decoding 4 tokens after an
    8-token prefill's cache placed in a 12-position decode cache gives
    the logits of decoding all 12 tokens one by one (attention and MLA
    layers; an SSM prefill keeps no state, so it raises). One sequence of
    8 tokens fills at most 8 slots of an expert, whose capacity is at
    least 8, so the prefill drops no MoE assignment."""
    from repro_torch.models.transformer import cache_from_prefill

    cfg = sc.serve_cfg(get_reduced, arch)
    api = build(cfg)
    params = api.init(torch.Generator().manual_seed(0), device="cpu")
    toks = torch.as_tensor(np.random.default_rng(4).integers(
        0, cfg.vocab, (1, 12)))
    with torch.no_grad():
        _, pc = api.prefill(params, {"tokens": toks[:, :8]})
        if arch == "falcon_mamba_7b":
            with pytest.raises(NotImplementedError):
                cache_from_prefill(cfg, pc, 1, 12, torch.float32,
                                   device="cpu")
            return
        cache = cache_from_prefill(cfg, pc, 1, 12, torch.float32,
                                   device="cpu")
        ref = api.init_cache(1, 12, torch.float32, device="cpu")
        for t in range(12):
            want, ref = api.decode_step(params, ref, toks[:, t], t)
            if t >= 8:
                got, cache = api.decode_step(params, cache, toks[:, t], t)
                torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
