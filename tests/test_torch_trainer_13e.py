"""The sharded trainer's ZeRO variant at ``model`` > 1 and data
parallelism inside a worker (``repro_torch.train.trainer``,
``core.ltp_sync.masked_rs_update_leafwise(specs=)``), on the CPU, with
gloo ranks as subprocesses (``tests/sharded_cases.py``, the ``Z_MESH``
tasks) at REDUCED configs cut to 2 layers, float32 unless noted,
SGD-momentum at lr 0.1, fractions (0.7, 0.9):

- four ranks on (data 2, model 2) against the JAX ZeRO step on the same
  mesh of 4 host devices (its ``shard_map`` check off, as
  ``tests/test_torch_tensor_parallel.py`` runs it; three JAX processes
  split the compiles), the reference's draws fed through ``uniforms=``:
  smollm-360m and deepseek-v2 under paper and count, mixtral-8x22b
  (expert-parallel) under paper in float32 and under count in its own
  bfloat16 (bfloat16 params and deltas). The params gathered over
  ``model``, each rank's momentum rows (its worker's rows of the global
  leaves' packets), the loss and the delivered fraction;
- four ranks on (pod 2, data 2, model 1) with ``worker_axes=("pod",)``
  against the JAX step on that mesh: the psum and the ZeRO variant on
  smollm, and the psum variant on mixtral, whose router takes one group
  a data shard, as the reference's ``g_count = ndp`` (its ZeRO variant
  is the same code past the gradient, which smollm covers), on the
  batch as it is and on one whose labels are masked unevenly over the
  data ranks (``sharded_cases.masked_batch``: the worker's mean is
  token-weighted, the balance loss's a mean over the groups);
- the ZeRO variant on (data 1, model 2) (smollm, mixtral, deepseek) and
  (1, 4) (smollm) against the port's own (1, 1) ZeRO step, since the
  reference fails on (1, n) (ROADMAP.md §3), under paper and count;
- both variants on (pod 1, data 2, model 2) against the port's own (1,
  1, 1) step: smollm, and qwen2-vl, whose M-RoPE ids carry the batch on
  dim 1;
- every rank of a run holds the same params;
- planted faults, each of which fails the comparison that holds for
  the right code: the ZeRO step from each rank's mirror's blocks on
  ``model``; the bfloat16 case with the attention's row-parallel
  partial sums rounded to bfloat16 before their all-reduce; the (pod 2,
  data 2) psum step with each data rank taking its worker's whole block
  (one MoE group a worker); and on the masked batch each data rank's
  mean weighted alike.

Tolerances: ``tests/test_trainer.py``'s: params and momentum rows rtol
2e-4 / atol 2e-5, loss rtol 1e-5; the delivered fraction exactly.

The bfloat16 mixtral (count, at (2, 2)) is held to the reference by
limits taken from the reference's own rounding, which the JAX process
measures in the same run (``sharded_cases.Z_WITNESS``); the relative
L2 of each leaf, the largest over leaves:

- each rank's momentum rows within half of the rows' rounding control,
  the reference's step from its init moved by one ulp (0.180 here). A
  near-tie of the router that flips moves the rows by about that much:
  the control flips some, and so did the port while its row-parallel
  partial sums were rounded to bfloat16 before the all-reduce (0.167;
  the planted fault). Routing every token as the reference does, the
  port reads 0.017, as at (2, 1) (0.015);
- each rank's step on the params (params - init) within twice the
  reference's own between (2, 1) and (2, 2) (0.090 here): the params
  are bfloat16, and ``init + delta`` rounds to a neighbour for a small
  change of ``delta`` (the port: 0.103; with the planted fault 0.254);
- the loss within ``tests/test_torch_bf16.py``'s rtol 1e-3, the
  delivered fraction exactly, and the params exactly the bfloat16 sum
  of the init and the bfloat16 delta ``-lr * m`` of the momentum rows
  (each worker's, joined), on every rank.

Each gloo run fails at ``sharded_cases.TIMEOUT_S`` if a rank hangs.
"""
import os

import numpy as np
import pytest
from torch.distributed.device_mesh import init_device_mesh

import sharded_cases as sc
from repro_torch.configs import get_reduced
from repro_torch.models import build

PARAM_TOL = dict(rtol=2e-4, atol=2e-5)
BF16_LOSS_RTOL = 1e-3
LOCAL = ("z12", "z14", "z122")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every gloo run of the file, overlapped: the JAX references and
    the ranks held against the port's one-rank step start together, the
    port's one-rank steps run here meanwhile, and the ranks held against
    the reference start once every reference has written its
    inputs."""
    d = str(tmp_path_factory.mktemp("z13e"))
    jax_runs = [sc.start_jax(task, f"{d}/{task}.npz") for task in sc.Z_JAX]
    started = []
    try:
        local = {task: sc.start_ranks(task, _world(task), "", d)
                 for task in LOCAL}
        started = list(local.values())
        ones = {}
        with sc.world_of_one(d) as mesh11:
            mesh111 = init_device_mesh("cpu", (1, 1, 1),
                                       mesh_dim_names=("pod", "data",
                                                       "model"))
            for task in LOCAL:
                mesh, workers = ((mesh111, ("pod",)) if task == "z122"
                                 else (mesh11, ("data",)))
                for name, variant, comp in sc.Z_CASES[task]:
                    if (task, name, variant, comp) in ones:
                        continue
                    api = build(sc.tp_cfg(get_reduced, name))
                    ones[task, name, variant, comp] = sc.tp_run(
                        api, mesh, sc.tp_params(api),
                        sc.tp_batch(api.cfg, 1), comp, variant=variant,
                        worker_axes=workers)
        refs = os.pathsep.join(sc.wait_for_inputs(r) for r in jax_runs)
        ref_ranks = {task: sc.start_ranks(task, 4, refs, d)
                     for task in ("z22", "pd22")}
        started += list(ref_ranks.values())
        got = {task: sc.finish_ranks(s)
               for task, s in {**local, **ref_ranks}.items()}
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


def _world(task: str) -> int:
    return int(np.prod(sc.Z_MESH[task][0]))


def _close(r: dict, base: str, want: dict, want_base: str, *, rows=None):
    """Rank ``r``'s case ``base`` against ``want``'s ``want_base``:
    params, loss, delivered fraction and, where the case has them, the
    momentum rows (``rows(i, global rows)`` picks this rank's)."""
    n = sum(1 for k in want if k.startswith(f"{want_base}/params/"))
    assert n > 0
    for i in range(n):
        np.testing.assert_allclose(r[f"{base}/params/{i}"],
                                   want[f"{want_base}/params/{i}"],
                                   **PARAM_TOL)
    m = sum(1 for k in want if k.startswith(f"{want_base}/m/"))
    assert (m > 0) == (f"{base}/m/0" in r)
    for i in range(m):
        np.testing.assert_allclose(r[f"{base}/m/{i}"],
                                   rows(i, want[f"{want_base}/m/{i}"]),
                                   **PARAM_TOL)
    np.testing.assert_allclose(r[f"{base}/loss"], want[f"{want_base}/loss"],
                               rtol=1e-5)
    assert float(r[f"{base}/realized"]) == float(
        want[f"{want_base}/realized"])


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _worst(got, want, n: int, sub=lambda i: 0.0) -> float:
    """The largest relative L2 of ``got(i) - sub(i)`` from ``want(i) -
    sub(i)`` over leaves ``i < n``."""
    return max(_rel(got(i) - sub(i), want(i) - sub(i)) for i in range(n))


def _close_bf16(ranks: list, base: str, want: dict, want_base: str,
                api):
    """The bfloat16 case against the reference (module docstring)."""
    import torch

    from repro_torch.core.ltp_sync import _from_packets
    from repro_torch.tree import tree_leaves

    _, _, name, variant, comp = want_base.split("/")
    case = f"{name}/{variant}/{comp}"
    dtypes = [x.dtype for x in tree_leaves(api.init(None, device="meta"))]
    assert torch.bfloat16 in dtypes
    n = len(dtypes)

    def init(i):
        return want[f"in/{name}/params/{i}"]

    def ref(kind, at=want_base):
        return lambda i: want[f"{at}/{kind}/{i}"]

    rows_ctl = _worst(ref("m", f"wit/ctl/{case}"), ref("m"), n)
    step_mesh = _worst(ref("params", f"wit/z21/{case}"), ref("params"), n,
                       init)
    for rank, r in enumerate(ranks):
        rows = _worker_rows(rank // 2)
        assert _worst(lambda i: r[f"{base}/m/{i}"],
                      lambda i: rows(i, want[f"{want_base}/m/{i}"]),
                      n) <= rows_ctl / 2, rows_ctl
        assert _worst(lambda i: r[f"{base}/params/{i}"], ref("params"), n,
                      init) <= 2 * step_mesh, step_mesh
        np.testing.assert_allclose(r[f"{base}/loss"],
                                   want[f"{want_base}/loss"],
                                   rtol=BF16_LOSS_RTOL)
        assert float(r[f"{base}/realized"]) == float(
            want[f"{want_base}/realized"])
    for i, dt in enumerate(dtypes):
        m = torch.as_tensor(np.concatenate([ranks[w * 2][f"{base}/m/{i}"]
                                            for w in range(sc.W)]))
        p0 = torch.as_tensor(init(i)).to(dt)
        d = (-sc.LR * m).to(dt).to(torch.float32)
        expect = (p0 + _from_packets(d, p0.shape, dt)).float().numpy()
        for r in ranks:
            assert np.array_equal(r[f"{base}/params/{i}"], expect), i


def _worker_rows(w: int):
    def rows(i, full):
        return full.reshape((sc.W, -1) + full.shape[1:])[w]
    return rows


@pytest.mark.parametrize("name,variant,comp", sc.Z_CASES["z22"])
def test_zero_model2_data2_matches_jax(runs, name, variant, comp):
    z, got, _ = runs
    base = f"{name}/{variant}/{comp}"
    want = f"out/z22/{base}"
    if name == "mixtral_bf16":
        _close_bf16(got["z22"], base, z, want,
                    build(sc.tp_cfg(get_reduced, name)))
        return
    for rank, r in enumerate(got["z22"]):
        _close(r, base, z, want, rows=_worker_rows(rank // 2))


@pytest.mark.parametrize("name,variant,comp", sc.Z_CASES["pd22"])
def test_pod2_data2_matches_jax(runs, name, variant, comp):
    z, got, _ = runs
    for rank, r in enumerate(got["pd22"]):
        _close(r, f"{name}/{variant}/{comp}", z,
               f"out/pd22/{name}/{variant}/{comp}",
               rows=_worker_rows(rank // 2))


@pytest.mark.parametrize("task,name,variant,comp", [
    (task, *case) for task in LOCAL for case in sc.Z_CASES[task]])
def test_matches_the_one_rank_step(runs, task, name, variant, comp):
    _, got, ones = runs
    want = {f"one/{k}": v for k, v in ones[task, name, variant,
                                           comp].items()}
    for r in got[task]:
        _close(r, f"{name}/{variant}/{comp}", want, "one",
               rows=lambda i, full: full)


@pytest.mark.parametrize("task", sorted(sc.Z_MESH))
def test_every_rank_holds_the_same_params(runs, task):
    """Every model rank and every data rank of every worker ends the
    step with the same global params, bit for bit."""
    _, got, _ = runs
    ranks = got[task]
    keys = [k for k in ranks[0] if "/params/" in k
            and not k.startswith("plant")]
    assert keys
    for r in ranks[1:]:
        for k in keys:
            assert np.array_equal(r[k], ranks[0][k]), k


@pytest.mark.parametrize("task,plant,base", [
    ("z22", "plant", "out/z22/smollm/zero/paper"),
    ("z22", "plant_bf16", "out/z22/mixtral_bf16/zero/count"),
    ("pd22", "plant", "out/pd22/mixtral/psum/paper"),
    ("pd22", "plant_mask", "out/pd22/mixtral_masked/psum/paper")])
def test_planted_fault_fails(runs, task, plant, base):
    """The ZeRO step from each rank's mirror's blocks on ``model``, the
    bfloat16 step with the row-parallel partial sums rounded before
    their sum, the psum step routing one MoE group a worker instead of
    one a data shard, and the masked batch's data ranks weighted alike,
    fail the comparison that holds for the right code."""
    z, got, _ = runs
    with pytest.raises(AssertionError):
        if plant == "plant_bf16":
            _close_bf16(got[task], plant, z, base,
                        build(sc.tp_cfg(get_reduced, "mixtral_bf16")))
        else:
            for rank, r in enumerate(got[task]):
                _close(r, plant, z, base, rows=_worker_rows(rank // 2))
