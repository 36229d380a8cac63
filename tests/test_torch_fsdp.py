"""FSDP over ``data`` in the plain train step
(``make_plain_train_step`` on the state of ``init_state(...,
fsdp=True)``; ``models/sharding.py``'s ``fsdp_specs``, ``FsdpCtx`` and
``whole``), on the CPU, with gloo ranks as subprocesses
(``tests/sharded_cases.py``, the ``fsdp22``, ``fsdp221`` and ``fsdp21``
tasks) against one JAX process (``sharded_cases.jax_fsdp``):

- four ranks on (data 2, model 2) and on (pod 2, data 2, model 1), and
  two on (data 2, model 1): one FSDP plain step (SGD-momentum) of every
  family's REDUCED config (smollm dense, qwen2-vl VLM with ``positions3``
  split on dim 1, mixtral MoE, deepseek-v2 MLA, falcon-mamba SSM, zamba2
  hybrid, whisper-small enc-dec, papernet CNN) from the JAX init, held
  against the reference's plain step jitted on the same mesh of host
  devices with its state placed by ``spec_for(..., fsdp=True)`` shardings,
  as its dry-run lowers it, and against the port's own plain step
  without FSDP on the same mesh;
- ``shard_params`` then ``gather_params`` over the FSDP layout gives the
  params back exactly, on the ranks;
- a planted fault, a gather whose backward keeps this rank's block of
  its own gradient (what ``sharding._Gather``'s backward does), fails
  the comparison with the reference;
- the layout of every full config on (16, 16) and (2, 16, 16): no leaf
  splits one dim over both axes, each split dim divides, a rank's blocks
  (``init_state`` on ``meta`` tensors under a fake process group) have
  the block shapes, and an unstacked leaf whose ``model`` dim is
  ``spec_for``'s takes ``spec_for``'s ``data`` dim;
- remat: on ``meta`` tensors under ``CostCounter``, a step's ``data``
  all-gathers number two for each stacked period's split leaf (the
  forward, and the backward's recompute) and one for each unstacked
  one, and its reduce-scatters one for each;
- the MoE ``d_ff`` split in bfloat16 (REDUCED mixtral with 3 experts on
  (data 2, model 2)): the reference's compiled step rounds each rank's
  partial down product to bfloat16 before the all-reduce, as the port's
  does, and the port's step is held against it.

Tolerances: ``tests/test_torch_tp_families.py``'s for the plain step:
params rtol 2e-4 / atol 2e-5, loss rtol 1e-5; FSDP against the port's
own step without it: rtol 1e-5 / atol 1e-7 (the same sums, grouped
differently: 3e-8 apart at most); bfloat16: each leaf's momentum (the
step's gradient in float32) within twice the relative L2 distance
between the reference's own (2, 1) and (2, 2) steps, as
``tests/test_torch_trainer_13e.py`` holds its bfloat16 case. Each gloo
run fails at ``sharded_cases.TIMEOUT_S`` if a rank hangs.
"""
import json

import numpy as np
import pytest

import sharded_cases as sc
from repro_torch.configs import ARCH_IDS, get_config, get_reduced
from repro_torch.launch import dryrun
from repro_torch.launch.cost import CostCounter
from repro_torch.models import build
from repro_torch.models.sharding import data_dim, fsdp_specs, model_dim, \
    spec_at, spec_for
from repro_torch.models.transformer import make_plan
from repro_torch.optim import sgd_momentum
from repro_torch.shapes import InputShape
from repro_torch.tree import tree_leaves_with_path
from repro_torch.train.trainer import fsdp_layout, init_state

PARAM_TOL = dict(rtol=2e-4, atol=2e-5)
OWN_TOL = dict(rtol=1e-5, atol=1e-7)
CASES = [(task, name) for task in sc.FSDP_MESH for name in sc.FSDP_MODELS]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX process and every rank task, overlapped: the ranks start
    once the reference has written its inputs."""
    d = str(tmp_path_factory.mktemp("fsdp"))
    ref = sc.start_jax("fsdp", f"{d}/fsdp.npz")
    started = []
    try:
        inputs = sc.wait_for_inputs(ref)
        started = {task: sc.start_ranks(task, int(np.prod(shape)), inputs, d)
                   for task, (shape, _) in sc.FSDP_MESH.items()}
        got = {task: sc.finish_ranks(s) for task, s in started.items()}
        z = sc.finish_jax(ref)
    finally:
        for p in [ref[0]] + [p for s in dict(started).values()
                             for p in s[0]]:
            if p.poll() is None:
                p.kill()
                p.wait()
    return z, got


def _n_leaves(z, name):
    return sum(1 for k in z if k.startswith(f"in/{name}/params/"))


def _close(r, base, want, want_base, n, tol=PARAM_TOL, loss_rtol=1e-5):
    for i in range(n):
        np.testing.assert_allclose(r[f"{base}/params/{i}"],
                                   want[f"{want_base}/params/{i}"], **tol,
                                   err_msg=f"{base} leaf {i}")
    np.testing.assert_allclose(r[f"{base}/loss"], want[f"{want_base}/loss"],
                               rtol=loss_rtol)


@pytest.mark.parametrize("task,name", CASES)
def test_fsdp_step_matches_jax(runs, task, name):
    z, got = runs
    n = _n_leaves(z, name)
    assert n > 0
    for r in got[task]:
        _close(r, f"{name}/fsdp", z, f"out/{task}/{name}", n)


@pytest.mark.parametrize("task,name", CASES)
def test_fsdp_step_matches_the_plain_step(runs, task, name):
    """FSDP moves where each weight lives, not what the step computes:
    the same step as the port's without FSDP on the same mesh, and a
    rank holding less of the params."""
    z, got = runs
    n = _n_leaves(z, name)
    for r in got[task]:
        _close(r, f"{name}/fsdp", r, f"{name}/plain", n, tol=OWN_TOL,
                loss_rtol=1e-6)
    shares = [int(r[f"{name}/fsdp/bytes"]) for r in got[task]]
    whole = sum(z[f"in/{name}/params/{i}"].size for i in range(n)) * 4
    assert len(set(shares)) == 1 and shares[0] < whole


@pytest.mark.parametrize("task", sorted(sc.FSDP_MESH))
def test_shard_then_gather_is_identity(runs, task):
    for r in runs[1][task]:
        for name in sc.FSDP_MODELS:
            assert bool(r[f"{name}/roundtrip"]), name


def test_own_block_backward_fails(runs):
    """A planted fault: the gather's backward keeping this rank's block
    of its own gradient (each rank then applies its own batch block's
    gradient alone) fails the comparison that holds for the
    reduce-scatter."""
    z, got = runs
    task, name = sc.FSDP_PLANT
    n = _n_leaves(z, name)
    for r in got[task]:
        _close(r, f"{name}/fsdp", z, f"out/{task}/{name}", n)
    with pytest.raises(AssertionError):
        for r in got[task]:
            _close(r, f"plant/{name}/fsdp", z, f"out/{task}/{name}", n)


# ----------------------------------------------------------------------------
# the MoE d_ff split in bfloat16
# ----------------------------------------------------------------------------


def test_reference_rounds_the_partial_down_products(runs):
    """The reference's compiled (2, 2) step: every all-reduce of the
    experts' down product split over ``model`` (the forward's and the
    remat recompute's) takes each rank's partial product rounded to
    bfloat16, as the port's ``d_ff``-parallel branch rounds each rank's
    partial expert outputs before their sum (ROADMAP §3); at (2, 1)
    nothing splits. Read from the JAX process's HLO. The reading is
    held to its controls: the same einsum alone reads as rounded in
    bfloat16 and as not rounded with float32 partial products, so an
    f32 sum in the reference would fail this test. (The momentum test
    below cannot tell the two apart: on the CPU, the port with float32
    partial products reads as close to the reference as the port
    without.)"""
    z = runs[0]
    hlo = {task: json.loads(str(z[f"out/{task}/{sc.FSDP_BF16}/hlo"]))
           for task in ("fsdp22", "fsdp21")}
    ctl = json.loads(str(z["hlo_controls"]))
    assert ctl == {"bf16": {"all_reduces": 1, "rounded_to_bf16": 1},
                   "f32": {"all_reduces": 1, "rounded_to_bf16": 0}}
    assert hlo["fsdp22"]["all_reduces"] >= 2
    assert hlo["fsdp22"]["rounded_to_bf16"] == hlo["fsdp22"]["all_reduces"]
    assert hlo["fsdp21"] == {"all_reduces": 0, "rounded_to_bf16": 0}


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("label", ["plain", "fsdp"])
def test_moe_dff_split_bf16_matches_jax(runs, label):
    """REDUCED mixtral with 3 experts (which ``model`` = 2 does not
    divide: the ``d_ff`` split) in bfloat16 on (data 2, model 2): each
    leaf's momentum after one step (the step's gradient, float32) within
    twice the reference's own (2, 1)-against-(2, 2) distance, and the
    loss within rtol 1e-3."""
    z, got = runs
    name = sc.FSDP_BF16
    n = _n_leaves(z, name)
    want, wit = f"out/fsdp22/{name}", f"out/fsdp21/{name}"
    for r in got["fsdp22"]:
        for i in range(n):
            spread = _rel(z[f"{wit}/mom/{i}"], z[f"{want}/mom/{i}"])
            assert 0 < spread
            assert _rel(r[f"{name}/{label}/mom/{i}"],
                        z[f"{want}/mom/{i}"]) <= 2 * spread, i
        np.testing.assert_allclose(r[f"{name}/{label}/loss"],
                                   z[f"{want}/loss"], rtol=1e-3)


# ----------------------------------------------------------------------------
# the layout of the full configs
# ----------------------------------------------------------------------------

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_layout_of_the_full_config(arch, mesh_name):
    sizes, names = MESHES[mesh_name]
    size = dict(zip(names, sizes))
    cfg = get_config(arch)
    api = build(cfg)
    shapes = api.init(None, device="meta")
    specs = fsdp_specs(cfg, shapes, size)
    want = {}
    for path, x in tree_leaves_with_path(shapes):
        spec = spec_at(specs, path)
        d, m = data_dim(spec), model_dim(spec)
        assert all(e in (None, "data", "model") for e in spec), path
        block = list(x.shape)
        for dim, a in ((d, "data"), (m, "model")):
            if dim is not None:
                assert x.shape[dim] % size[a] == 0, (path, dim)
                block[dim] //= size[a]
        want[path] = tuple(block)
        stacked = path[0] in ("stack", "enc_stack", "dec_stack")
        ref = spec_for(path, tuple(x.shape), size, fsdp=True)
        if not stacked and m == model_dim(ref):
            assert d == data_dim(ref), path
    with dryrun.fake_world(int(np.prod(sizes))):
        mesh = dryrun.make_mesh(sizes, names)
        state = init_state(api, sgd_momentum(), params=shapes, mesh=mesh,
                           fsdp=True)
    got = {p: tuple(x.shape) for p, x in tree_leaves_with_path(state.params)}
    assert got == want
    n_bytes = sum(x.numel() * x.element_size()
                  for _, x in tree_leaves_with_path(state.params))
    assert n_bytes == sum(int(np.prod(want[p])) * x.element_size()
                          for p, x in tree_leaves_with_path(shapes))


# ----------------------------------------------------------------------------
# remat: the backward gathers each period again
# ----------------------------------------------------------------------------

REMAT_ARCHS = ["smollm_360m", "deepseek_v2_236b", "zamba2_7b",
               "whisper_small", "papernet"]


def _expected_data_collectives(api, mesh):
    """{kind: (calls, input bytes)} over ``data`` of one FSDP step on a
    (data 2, model 2) mesh: a stacked leaf's period slice gathered in
    the forward and again in the remat recompute and reduce-scattered
    once; zamba2's shared block likewise once a period; any other split
    leaf once each. A gather's input is this rank's block, a
    reduce-scatter's the whole (model block of the) gradient, twice
    the block."""
    cfg = api.cfg
    specs = fsdp_layout(api, mesh)
    periods = make_plan(cfg).n_periods if cfg.family not in (
        "cnn", "audio") else 0
    ag = rs = ag_bytes = rs_bytes = 0
    for path, x in tree_leaves_with_path(api.init(None, device="meta")):
        spec = spec_at(specs, path)
        if data_dim(spec) is None:
            continue
        block = x.numel() * x.element_size() // 2 // (
            2 if model_dim(spec) is not None else 1)
        if path[0] in ("stack", "enc_stack", "dec_stack"):
            n, block = x.shape[0], block // x.shape[0]
        else:
            n = periods if path[0] == "shared_attn" else 1
        fwd = 2 if n > 1 or path[0] == "shared_attn" else 1
        ag, ag_bytes = ag + fwd * n, ag_bytes + fwd * n * block
        rs, rs_bytes = rs + n, rs_bytes + n * 2 * block
    return {"all_gather_into_tensor": (ag, ag_bytes),
            "reduce_scatter_tensor": (rs, rs_bytes)}


@pytest.mark.parametrize("arch", REMAT_ARCHS)
def test_remat_gathers_each_period_twice(arch):
    cfg = get_reduced(arch).replace(dtype="float32")
    if cfg.family not in ("cnn", "audio"):
        cfg = cfg.replace(n_layers=max(cfg.n_layers, 4))
    api = build(cfg)
    shape = InputShape("t", 16, 4, "train")
    with dryrun.fake_world(4):
        mesh = dryrun.make_mesh((2, 2), ("data", "model"))
        cost = dryrun.trace("train", cfg, shape, mesh, ltp=False, zero=False)
        want = _expected_data_collectives(api, mesh)
    got = {k: (v["calls"], v["bytes"])
           for k, v in cost.collectives["data"].items() if k in want}
    assert want["all_gather_into_tensor"][0] > 0
    assert got == want


def test_no_fsdp_without_a_data_axis():
    """``fsdp=True`` on a mesh whose ``data`` axis is 1 is the plain
    step as it was: no layout, no gather."""
    assert fsdp_layout(build(get_reduced("smollm_360m")),
                       {"data": 1, "model": 2}) is None


def test_the_ltp_step_refuses_an_fsdp_state():
    """The state carries its FSDP layout (``TrainState.fsdp``), which
    the plain step reads; the LTP step keeps every weight whole over
    its workers and refuses such a state."""
    from repro_torch.config import LTPConfig
    from repro_torch.train.trainer import make_ltp_train_step

    api = build(get_reduced("smollm_360m"))
    shapes = api.init(None, device="meta")
    with dryrun.fake_world(4):
        mesh = dryrun.make_mesh((2, 2), ("data", "model"))
        state = init_state(api, sgd_momentum(), params=shapes, mesh=mesh,
                           fsdp=True)
        assert state.fsdp is not None and state.fsdp.nd == 2
        assert init_state(api, sgd_momentum(), params=shapes,
                          mesh=mesh).fsdp is None
        step = make_ltp_train_step(api, sgd_momentum(), mesh, LTPConfig(),
                                   ("data",), {"tokens": ("data",),
                                               "labels": ("data",)})
        with pytest.raises(ValueError, match="FSDP state"):
            step.local(state, {})
