"""Tensor parallelism over ``model`` for MLA, the SSM and hybrid
families, enc-dec and the CNN (``repro_torch.models``' ``ctx`` in
``mla``, ``ssm``, ``transformer``'s shared block, ``encdec`` and
``cnn``; ``models/sharding.py``'s ``reduce_both``, ``reblock`` and
``cols_of``), on the CPU, with gloo ranks as subprocesses
(``tests/sharded_cases.py``, the ``tpf`` and ``tpcoll`` tasks):

- four ranks on (data 2, model 2) against the JAX step on the same mesh
  of 4 host devices (its ``shard_map`` check off, as
  ``tests/test_torch_tensor_parallel.py`` runs it; two JAX processes
  split the compiles): one psum LTP step under paper and count
  compensation at delivered (0.7, 0.9) on REDUCED deepseek-v2 (MLA, a
  dense lead layer, 4 experts expert-parallel and a shared expert),
  falcon-mamba (Mamba-1, channel-parallel), zamba2 (Mamba-2,
  head-parallel, and the shared attention block), whisper-small (heads,
  cross attention, vocab) and papernet (nothing split), the reference's
  draws fed through ``uniforms=``;
- two ranks on (data 1, model 2), and four on (1, 4), against the
  port's own (1, 1) step, since the reference fails on (1, n)
  (ROADMAP.md §3); whisper's 6 heads do not divide 4, so its attention
  runs replicated there;
- ``shard_params`` then ``gather_params`` gives the params back exactly;
- a planted fault, each rank starting from its mirror's block of
  falcon-mamba's ``in_proj`` (``[x | z]``: the reblock then hands rank 0
  channels computed from ``z``'s weights), disagrees;
- the new collectives on two ranks against one process's autograd, and
  the Mamba-1 and Mamba-2 mixers' grads at ``model`` = 2, where
  ``reduce_out`` in place of ``reduce_both`` gives wrong grads;
- the layout of the full configs, in process.

Tolerances: ``tests/test_trainer.py``'s: params rtol 2e-4 / atol 2e-5,
loss rtol 1e-5; the delivered fraction exactly; the collectives
exactly, the mixers' grads rtol 1e-5 with an atol of 1e-5 of the
leaf's largest grad (``x_proj``'s are ~1e-6 at init). Each
gloo run fails at ``sharded_cases.TIMEOUT_S`` if a rank hangs.
"""
import os

import numpy as np
import pytest
import torch

import sharded_cases as sc
from repro_torch.configs import get_config, get_reduced
from repro_torch.models import build
from repro_torch.models.sharding import block_of, model_dim, model_specs, \
    spec_at, spec_for
from repro_torch.tree import tree_leaves_with_path

PARAM_TOL = dict(rtol=2e-4, atol=2e-5)
CASES_22 = [(name, comp) for name in sc.TPF_MODELS for comp in sc.TP_COMPS]
CASES_1N = [(task, name, comp) for task, names in sc.TPF_LOCAL.items()
            for name in names for comp in sc.TP_COMPS]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every gloo run of the file, overlapped: the JAX references, the
    (1, n) ranks and the collectives' ranks start together, the port's
    (1, 1) steps run here meanwhile, and the (2, 2) ranks start once
    both references have written their inputs."""
    d = str(tmp_path_factory.mktemp("tpf"))
    jax_runs = [sc.start_jax(task, f"{d}/{task}.npz") for task in sc.TPF_JAX]
    started = []
    try:
        local = {task: sc.start_ranks(task, sc.TPF_MESH[task][1], "", d)
                 for task in sc.TPF_LOCAL}
        coll = sc.start_ranks("tpcoll", 2, "", d)
        started = [*local.values(), coll]
        with sc.world_of_one(d) as mesh:
            ones = {}
            for name in sc.TPF_MODELS:
                api = build(sc.tp_cfg(get_reduced, name))
                params, batch = sc.tp_params(api), sc.tp_batch(api.cfg, 1)
                for comp in sc.TP_COMPS:
                    ones[name, comp] = sc.tp_run(api, mesh, params, batch,
                                                 comp)
        refs = os.pathsep.join(sc.wait_for_inputs(r) for r in jax_runs)
        ranks22 = sc.start_ranks("tpf", 4, refs, d)
        started.append(ranks22)
        got = {task: sc.finish_ranks(s) for task, s in local.items()}
        got["tpcoll"] = sc.finish_ranks(coll)
        got["tpf"] = sc.finish_ranks(ranks22)
        z = {}
        for r in jax_runs:
            z.update(sc.finish_jax(r))
    finally:
        for p in [r[0] for r in jax_runs] + [p for s in started
                                             for p in s[0]]:
            if p.poll() is None:
                p.kill()
                p.wait()
    return z, got, ones


def _close(r: dict, base: str, want: dict, want_base: str, n: int):
    for i in range(n):
        np.testing.assert_allclose(r[f"{base}/params/{i}"],
                                   want[f"{want_base}/params/{i}"],
                                   **PARAM_TOL)
    np.testing.assert_allclose(r[f"{base}/loss"], want[f"{want_base}/loss"],
                               rtol=1e-5)
    if f"{want_base}/realized" in want:
        assert float(r[f"{base}/realized"]) == float(
            want[f"{want_base}/realized"])


@pytest.mark.parametrize("name,comp", CASES_22)
def test_model2_data2_step_matches_jax(runs, name, comp):
    z, got, _ = runs
    n = sum(1 for k in z if k.startswith(f"in/{name}/params/"))
    assert n > 0
    for r in got["tpf"]:
        _close(r, f"{name}/{comp}", z, f"out/{name}/{comp}", n)


@pytest.mark.parametrize("task,name,comp", CASES_1N)
def test_model_n_step_matches_one_rank(runs, task, name, comp):
    _, got, ones = runs
    want = {f"one/{k}": v for k, v in ones[name, comp].items()}
    n = sum(1 for k in want if "/params/" in k)
    for r in got[task]:
        _close(r, f"{name}/{comp}", want, "one", n)


@pytest.mark.parametrize("task", sorted(sc.TPF_MESH))
def test_shard_then_gather_is_identity(runs, task):
    _, got, _ = runs
    for r in got[task]:
        for name in sc.TPF_MODELS:
            assert bool(r[f"{name}/roundtrip"]), name


@pytest.mark.parametrize("task", sorted(sc.TPF_MESH))
def test_swapped_in_proj_blocks_fail(runs, task):
    """A planted fault: the psum step (paper) on falcon-mamba with each
    rank starting from its mirror's block of the Mamba-1 ``in_proj``
    fails the comparison that holds for the right blocks."""
    z, got, ones = runs
    name = sc.TPF_PLANT[0]
    if task == "tpf":
        want, base = z, f"out/{name}/paper"
    else:
        want = {f"one/{k}": v for k, v in ones[name, "paper"].items()}
        base = "one"
    n = sum(1 for k in want if k.startswith(f"{base}/params/"))
    for r in got[task]:
        _close(r, f"{name}/paper", want, base, n)
    with pytest.raises(AssertionError):
        for r in got[task]:
            _close(r, f"plant/{name}/paper", want, base, n)


# ----------------------------------------------------------------------------
# the collectives, against one process's autograd
# ----------------------------------------------------------------------------


def _coll():
    return {k: torch.as_tensor(v) for k, v in sc.coll_inputs().items()}


@pytest.mark.parametrize("rank", [0, 1])
def test_reduce_both_sums_forward_and_backward(runs, rank):
    """Each rank's partial summed over ``model``, and each rank's loss
    gradient summed too; ``reduce_out`` on the same partials passes back
    this rank's share alone."""
    z, r = _coll(), runs[1]["tpcoll"][rank]
    x, c = z["rb/x"], z["rb/c"]
    for name in ("both", "out"):
        np.testing.assert_array_equal(r[f"rb/{name}/y"], (x[0] + x[1]))
    np.testing.assert_array_equal(r["rb/both/grad"], c[0] + c[1])
    np.testing.assert_array_equal(r["rb/out/grad"], c[rank])


def _reblock_reference(x, seg, c):
    """Each rank's reblocked columns of the global ``x`` and the grad of
    the sum over ranks of ``sum(out_r * c_r)``, in one process."""
    x = x.clone().requires_grad_()
    outs, loss = [], 0.0
    for q in range(2):
        cols, start = [], 0
        for w, split in seg:
            lo, hi = ((start + q * w // 2, start + (q + 1) * w // 2)
                      if split else (start, start + w))
            cols += range(lo, hi)
            start += w
        outs.append(x[..., cols])
        loss = loss + (outs[-1] * c[q]).sum()
    loss.backward()
    return [o.detach() for o in outs], x.grad


@pytest.mark.parametrize("seg", sorted(sc.COLL_SEGMENTS))
@pytest.mark.parametrize("rank", [0, 1])
def test_reblock_matches_the_columns_it_takes(runs, seg, rank):
    """``reblock`` of this rank's column block: Mamba-1's [x | z] (a
    permutation) and Mamba-2's [z | x | B | C | dt] (B and C whole on
    every rank, their gradient summed over the ranks), forward and
    backward bitwise one process's column selection."""
    z, r = _coll(), runs[1]["tpcoll"][rank]
    outs, grad = _reblock_reference(z[f"reblock/{seg}/x"],
                                    sc.COLL_SEGMENTS[seg],
                                    z[f"reblock/{seg}/c"])
    np.testing.assert_array_equal(r[f"reblock/{seg}/y"], outs[rank])
    np.testing.assert_array_equal(r[f"reblock/{seg}/grad"],
                                  block_of(grad, -1, 2, rank))


@pytest.mark.parametrize("rank", [0, 1])
def test_cols_of_takes_a_block_and_sums_its_grad(runs, rank):
    z, r = _coll(), runs[1]["tpcoll"][rank]
    w, c = z["cols/w"], z["cols/c"]
    np.testing.assert_array_equal(r["cols/y"], block_of(w, -1, 2, rank))
    np.testing.assert_array_equal(r["cols/grad"], torch.cat([c[0], c[1]],
                                                            dim=-1))


def _mixer_close(got, want, name=""):
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()),
                               err_msg=name)


def _mixer_reference(k):
    z = _coll()
    cfg, p = sc.coll_mixer(get_reduced, k)
    return sc.coll_mixer_grads(cfg, p, z[f"mixer/{k}/u"], z[f"mixer/{k}/c"])


@pytest.mark.parametrize("k", sorted(sc.COLL_MIXERS))
@pytest.mark.parametrize("rank", [0, 1])
def test_mixer_grads_at_model_2(runs, k, rank):
    """A Mamba-1 (channel-parallel) and a Mamba-2 (head-parallel) mixer
    of the REDUCED SSM models at ``model`` = 2: the output and every
    param's grad (the blocks' gathered) and the input's against one
    process."""
    want, r = _mixer_reference(k), runs[1]["tpcoll"][rank]
    assert len(want) == len(sc.coll_mixer(get_reduced, k)[1]) + 2
    for name, v in want.items():
        _mixer_close(r[f"mixer/{k}/{name}"], v, name)


@pytest.mark.parametrize("k,leaf", [("m1", "x_proj"), ("m2", "in_proj")])
def test_reduce_out_alone_gives_wrong_grads(runs, k, leaf):
    """Why ``reduce_both``: with ``reduce_out`` in its place (the
    gradient passed back unsummed), Mamba-1's ``x_proj`` (its partial
    product feeds the channel-split scan) and Mamba-2's ``in_proj``
    (the gated RMSNorm's mean of squares over the whole ``d_inner``) get
    wrong grads, while the forward is unchanged."""
    want = _mixer_reference(k)
    for r in runs[1]["tpcoll"]:
        np.testing.assert_array_equal(r[f"plant/{k}/out"],
                                      r[f"mixer/{k}/out"])
        with pytest.raises(AssertionError):
            _mixer_close(r[f"plant/{k}/{leaf}"], want[leaf])


# ----------------------------------------------------------------------------
# the layout of the full configs
# ----------------------------------------------------------------------------


def _per_rank(shapes, specs, nm: int) -> int:
    return sum(x.numel() // (nm if model_dim(spec_at(specs, p)) is not None
                             else 1)
               for p, x in tree_leaves_with_path(shapes))


LAYOUTS = {
    # arch: (n_layers, parameters, a rank's at model = 2, {leaf: dim})
    "deepseek_v2_236b": (1, 1_386_562_560, 698_696_704, {
        ("embed", "embed"): 1, ("embed", "lm_head"): 1,
        ("lead", 0, "mixer", "w_dq"): None,
        ("lead", 0, "mixer", "w_dkv"): None,
        ("lead", 0, "mixer", "q_norm_scale"): None,
        ("lead", 0, "mixer", "w_uq"): 1, ("lead", 0, "mixer", "w_uk"): 1,
        ("lead", 0, "mixer", "w_uv"): 1, ("lead", 0, "mixer", "wo"): 0,
        ("lead", 0, "mlp", "w_gate"): 1, ("lead", 0, "mlp", "w_down"): 0}),
    "falcon_mamba_7b": (2, 743_305_216, 374_206_464, {
        ("stack", "p0", "mixer", "in_proj"): 2,
        ("stack", "p0", "mixer", "out_proj"): 1,
        ("stack", "p0", "mixer", "dt_proj"): 2,
        ("stack", "p0", "mixer", "x_proj"): None,
        ("stack", "p0", "mixer", "conv_w"): None,
        ("stack", "p0", "mixer", "A_log"): None,
        ("stack", "p0", "mixer", "D"): None}),
    "zamba2_7b": (7, 980_754_096, 490_548_912, {
        ("stack", "p0", "mixer", "in_proj"): 2,
        ("stack", "p0", "mixer", "out_proj"): 1,
        ("stack", "p0", "mixer", "conv_w"): None,
        ("stack", "p0", "mixer", "gamma"): None,
        ("shared_attn", "attn", "wq"): 1, ("shared_attn", "attn", "wo"): 0,
        ("shared_attn", "mlp", "w_up"): 1,
        ("rem", 0, "mixer", "in_proj"): 1}),
    "whisper_small": (12, 278_098_944, 139_097_088, {
        ("enc_stack", "attn", "wq"): 2, ("dec_stack", "cross_attn", "wk"): 2,
        ("dec_stack", "cross_attn", "wo"): 1,
        ("dec_stack", "mlp", "w_up"): 2, ("embed", "lm_head"): 1,
        ("embed", "embed"): 1}),
    "papernet": (6, 696_234, 696_234, {("fc",): None}),
}


@pytest.mark.parametrize("arch", sorted(LAYOUTS))
def test_layout_at_model_2(arch):
    """The full config at its cut depth on two ranks: the parameters and
    a rank's share, and where the leaves of the new families split (a
    stacked leaf's dims count its leading period axis)."""
    n_layers, total, per_rank, dims = LAYOUTS[arch]
    cfg = get_config(arch).replace(n_layers=n_layers)
    shapes = build(cfg).init(None, device="meta")
    specs = model_specs(cfg, shapes, {"model": 2})
    got = {p: model_dim(spec_at(specs, p))
           for p, _ in tree_leaves_with_path(shapes)}
    assert {p: got[p] for p in dims} == dims
    assert sum(x.numel() for _, x in tree_leaves_with_path(shapes)) == total
    assert _per_rank(shapes, specs, 2) == per_rank


@pytest.mark.parametrize("arch,nm", [("zamba2_7b", 7), ("zamba2_7b", 32),
                                     ("deepseek_v2_236b", 3)])
def test_mixers_stay_replicated_where_they_do_not_split(arch, nm):
    """The SSM channels rule and MLA's heads rule: where Mamba-2's heads
    (32: 112 heads) or ``in_proj`` width (7: 14,576 columns) or MLA's
    heads (3: 128 heads) do not divide the axis, the mixer's leaves stay
    replicated, where ``spec_for`` alone would split some of them."""
    cfg = get_config(arch).replace(n_layers=2)
    shapes = build(cfg).init(None, device="meta")
    specs = model_specs(cfg, shapes, {"model": nm})
    held = ("in_proj", "out_proj", "dt_proj", "w_uq", "w_uk", "w_uv",
            "wo")
    checked = [(p, x) for p, x in tree_leaves_with_path(shapes)
               if p[-1] in held and "mixer" in p]
    assert any(model_dim(spec_for(p, tuple(x.shape)[1 if "stack" in p
                                                    else 0:],
                                  {"model": nm}, fsdp=False)) is not None
               for p, x in checked)
    for p, _ in checked:
        assert model_dim(spec_at(specs, p)) is None, p
