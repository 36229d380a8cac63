"""Tensor parallelism over the ``model`` axis (``repro_torch.models.
sharding``: ``ShardCtx``, its collectives, ``model_specs``,
``shard_params`` / ``gather_params``; the models' ``ctx``;
``masked_psum_leafwise``'s ``specs``; the train steps on sharded
params), on the CPU, with gloo ranks as subprocesses
(``tests/sharded_cases.py``, the ``tp`` tasks):

- four ranks on (data 2, model 2) against the JAX step on the same mesh
  of 4 host devices (its ``shard_map`` check off, as the ``train`` task
  runs it): one psum LTP step under paper and count compensation at
  delivered (0.7, 0.9) on REDUCED smollm-360m cut to 2 layers (tied
  embeddings: the table resharded from columns to rows), REDUCED
  mixtral-8x22b (4 experts: expert-parallel) and REDUCED qwen2-vl
  (M-RoPE, patch embeddings), the reference's draws fed through
  ``uniforms=``; and the plain step on REDUCED mixtral;
- two ranks on (data 1, model 2), and four on (1, 4), against the port's
  own (1, 1) step, since the reference fails on (1, n) (ROADMAP.md §3):
  the same models and mixtral with 3 experts (d_ff-parallel) on (1, 2),
  smollm on (1, 4), whose 6 heads do not divide 4 (the attention runs
  replicated). The port's own draws: they are the global leaves', so
  every mesh masks alike;
- ``shard_params`` then ``gather_params`` gives the params back exactly;
- a planted fault, each rank starting from its mirror's blocks on
  ``model``, disagrees;
- the layout of the full configs, in process;
- the launcher at (1, 2) against itself at world size 1.

Tolerances: ``tests/test_trainer.py``'s: params rtol 2e-4 / atol 2e-5,
loss rtol 1e-5; the delivered fraction exactly. Each gloo run fails at
``sharded_cases.TIMEOUT_S`` if a rank hangs (a collective issued out of
order deadlocks).
"""
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import sharded_cases as sc
from repro_torch.configs import get_config, get_reduced
from repro_torch.models import build
from repro_torch.models.sharding import model_dim, model_specs, spec_at
from repro_torch.tree import tree_leaves_with_path

PARAM_TOL = dict(rtol=2e-4, atol=2e-5)
CASES_22 = [(name, comp) for name in sc.TP_MODELS
            for comp in sc.TP_COMPS] + [("mixtral", "plain")]


def _cases_1n(task):
    out = []
    for name in sc.TP_LOCAL[task]:
        out += [(task, name, comp) for comp in sc.TP_COMPS]
        if name.startswith("mixtral"):
            out.append((task, name, "plain"))
    return out


CASES_1N = _cases_1n("tp12") + _cases_1n("tp14")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every gloo run of the file, overlapped: the JAX reference and the
    (1, n) ranks start together, the port's (1, 1) steps run here
    meanwhile, and the (2, 2) ranks start once the reference has written
    its inputs."""
    d = str(tmp_path_factory.mktemp("tp"))
    jax_run = sc.start_jax("tp", f"{d}/ref.npz")
    try:
        local = {task: sc.start_ranks(task, sc.TP_MESH[task][1], "", d)
                 for task in sc.TP_LOCAL}
        with sc.world_of_one(d) as mesh:
            ones = {}
            for name in dict.fromkeys(sum(sc.TP_LOCAL.values(), ())):
                api = build(sc.tp_cfg(get_reduced, name))
                params, batch = sc.tp_params(api), sc.tp_batch(api.cfg, 1)
                for comp in sc.TP_COMPS + ("plain",):
                    if comp != "plain" or name.startswith("mixtral"):
                        ones[name, comp] = sc.tp_run(api, mesh, params,
                                                     batch, comp)
        ranks22 = sc.start_ranks("tp", 4, sc.wait_for_inputs(jax_run), d)
        got = {task: sc.finish_ranks(s) for task, s in local.items()}
        got["tp"] = sc.finish_ranks(ranks22)
        z = sc.finish_jax(jax_run)
    finally:
        if jax_run[0].poll() is None:
            jax_run[0].kill()
            jax_run[0].wait()
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
    for r in got["tp"]:
        _close(r, f"{name}/{comp}", z, f"out/{name}/{comp}", n)


@pytest.mark.parametrize("task,name,comp", CASES_1N)
def test_model_n_step_matches_one_rank(runs, task, name, comp):
    _, got, ones = runs
    want = {f"one/{k}": v for k, v in ones[name, comp].items()}
    n = sum(1 for k in want if "/params/" in k)
    for r in got[task]:
        _close(r, f"{name}/{comp}", want, "one", n)


@pytest.mark.parametrize("task", sorted(sc.TP_MESH))
def test_shard_then_gather_is_identity(runs, task):
    _, got, _ = runs
    names = sc.TP_MODELS if task == "tp" else sc.TP_LOCAL[task]
    for r in got[task]:
        for name in names:
            assert bool(r[f"{name}/roundtrip"]), name


@pytest.mark.parametrize("task", sorted(sc.TP_MESH))
def test_swapped_model_blocks_fail(runs, task):
    """A planted fault: the psum step (paper) on smollm with each rank
    starting from its mirror's blocks on ``model`` fails the comparison
    that holds for the right blocks."""
    z, got, ones = runs
    if task == "tp":
        want, base = z, "out/smollm/paper"
    else:
        want = {f"one/{k}": v for k, v in ones["smollm", "paper"].items()}
        base = "one"
    n = sum(1 for k in want if k.startswith(f"{base}/params/"))
    with pytest.raises(AssertionError):
        for r in got[task]:
            _close(r, "plant/smollm/paper", want, base, n)


def _layout(arch: str, nm: int):
    cfg = get_config(arch)
    shapes = build(cfg).init(None, device="meta")
    return cfg, shapes, model_specs(cfg, shapes, {"model": nm})


def _per_rank(shapes, specs, nm: int) -> int:
    return sum(x.numel() // (nm if model_dim(spec_at(specs, p)) is not None
                             else 1)
               for p, x in tree_leaves_with_path(shapes))


def test_mixtral_layout_at_model_2():
    """One Mixtral-8x22b layer on two ranks: heads (48, 8 KV), experts
    (8: expert-parallel, dim 1 of the stacked leaves) and vocab split,
    the table on ``d_model``; every rank holds half of all but the
    router and the norms: 1,453,393,920 of 2,906,720,256 parameters."""
    cfg = get_config("mixtral_8x22b").replace(n_layers=1)
    shapes = build(cfg).init(None, device="meta")
    specs = model_specs(cfg, shapes, {"model": 2})
    dims = {p: model_dim(spec_at(specs, p))
            for p, _ in tree_leaves_with_path(shapes)}
    layer = ("stack", "p0")
    assert dims == {
        ("embed", "embed"): 1, ("embed", "lm_head"): 1,
        ("final_norm", "scale"): None,
        layer + ("mixer", "wk"): 2, layer + ("mixer", "wo"): 1,
        layer + ("mixer", "wq"): 2, layer + ("mixer", "wv"): 2,
        layer + ("moe", "experts_down"): 1,
        layer + ("moe", "experts_gate"): 1,
        layer + ("moe", "experts_up"): 1,
        layer + ("moe", "moe_gate"): None,
        layer + ("norm1", "scale"): None, layer + ("norm2", "scale"): None}
    total = sum(x.numel() for _, x in tree_leaves_with_path(shapes))
    assert total == 2_906_720_256
    assert _per_rank(shapes, specs, 2) == 1_453_393_920


@pytest.mark.parametrize("arch,nm,split_heads", [
    ("smollm_360m", 5, True), ("smollm_360m", 2, False),
    ("smollm_360m", 16, False), ("qwen2_vl_72b", 16, False),
    ("qwen2_vl_72b", 8, True), ("mixtral_8x22b", 16, False)])
def test_heads_split_only_when_both_counts_divide(arch, nm, split_heads):
    """``wq``/``wk``/``wv``/``wo`` follow ``spec_for`` only where both
    ``n_heads`` and ``n_kv`` divide the axis; else they stay replicated,
    where ``spec_for`` alone would split a head."""
    cfg, shapes, specs = _layout(arch, nm)
    for p, _ in tree_leaves_with_path(shapes):
        if p[-1] in ("wq", "wk", "wv", "wo"):
            assert (model_dim(spec_at(specs, p)) is not None) == split_heads


def _free_port() -> int:
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def test_launcher_checkpoint_at_model_2_equals_one_rank(tmp_path):
    """``python -m repro_torch.launch.train --mode sharded`` as two ranks
    without ``torchrun`` (its env vars set by hand, a ``localhost``
    rendezvous) builds the (1, 2) mesh, and rank 0's ``--ckpt`` (the
    gathered global params) equals that of the same run at world size
    1."""
    argv = [sys.executable, "-m", "repro_torch.launch.train", "--mode",
            "sharded", "--reduced", "--steps", "2", "--batch", "4",
            "--seq", "16", "--device", "cpu", "--n-data", "1", "--ckpt"]
    one = subprocess.run(argv + [str(tmp_path / "one")], env=sc.env(),
                         capture_output=True, text=True,
                         timeout=sc.TIMEOUT_S)
    assert one.returncode == 0, one.stderr[-4000:]
    port = str(_free_port())
    procs = [subprocess.Popen(
        argv + [str(tmp_path / "two")], env=dict(
            sc.env(), RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE="2",
            MASTER_ADDR="127.0.0.1", MASTER_PORT=port),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    try:
        outs = [p.communicate(timeout=sc.TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-4000:]
    assert "mesh: {'data': 1, 'model': 2}" in outs[0][0]
    a, b = np.load(tmp_path / "one.npz"), np.load(tmp_path / "two.npz")
    assert sorted(a.files) == sorted(b.files) and len(a.files) > 10
    for k in a.files:
        np.testing.assert_allclose(b[k], a[k], **PARAM_TOL)


def test_meta_init_has_the_init_shapes():
    """``init(None)`` (the layout's shapes) draws nothing and matches a
    real init leaf for leaf."""
    api = build(sc.tp_cfg(get_reduced, "mixtral"))
    real = tree_leaves_with_path(sc.tp_params(api))
    meta = tree_leaves_with_path(api.init(None, device="meta"))
    assert [(p, tuple(x.shape), x.dtype) for p, x in real] == [
        (p, tuple(x.shape), x.dtype) for p, x in meta]
    assert all(x.device.type == "meta" for _, x in meta)
    assert torch.is_tensor(meta[0][1])
