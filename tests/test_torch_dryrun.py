"""The dry-run and its cost accounting (``launch/dryrun.py``,
``launch/cost.py``) and the kernels' fake forms, on the CPU:

- each kernel's operator (``repro_torch::dropfill_into``,
  ``dropfill_ef_into``, ``packet_reduce_into``, ``tree_reduce_into``,
  ``randomk_into``) on fake CUDA tensors under ``FakeTensorMode`` and on
  ``meta`` tensors inside ``kernels._build.shape_only`` (outside it a
  ``meta`` tensor is refused, as before): the output's shape and dtype
  are the plain version's on real CPU inputs, its device the input's,
  no launch is counted, and ``CostCounter`` sees the operator by name;
  the CPU route stays the plain version, bitwise;
- the counted FLOPs of one train step at world size 1 against the JAX
  package's loop-aware HLO walker (``repro.launch.hlo_analysis``) on
  the JAX step's compiled HLO, for REDUCED smollm-360m, mixtral-8x22b,
  falcon-mamba and whisper-small at float32. Tolerance: equal once the
  walker's one known blind spot is added, and within 1 % for
  falcon-mamba. The gaps: (1) remat. Both packages recompute each
  rematerialised body in the backward, but XLA drops, as dead code, the
  recompute of a body's last matmul whose output feeds only the
  residual add (its backward needs the input and the output's gradient,
  not the output): smollm's and whisper's MLP ``w_down``, falcon's
  ``out_proj``, one a layer; ``torch.func.vjp`` recomputes the whole
  body, so the port counts them (5.9 %, 5.7 % and 7.5 % of the
  walker's count). Mixtral's experts' down-projection output is read by
  the backward of the combine's weights, so XLA keeps it, and the two
  agree exactly. (2) Mamba-1's per-step ``einsum("bdn,bn->bd")``, a
  batched matrix-vector product, which XLA rewrites as a multiply and a
  reduce that the walker does not count as a dot (0.23 % here);
- the depth extrapolation against a trace of every layer, at REDUCED
  widths for a dense (smollm), a hybrid (zamba2) and the enc-dec
  (whisper) config with 4 periods (whisper 3 encoder and 3 decoder
  layers), on a (2, 2) fake mesh, for the plain, LTP psum and LTP ZeRO
  train steps, prefill and decode: FLOPs, bytes, collective calls and
  bytes by kind and axis and operator calls exactly equal, the peak
  within 5 %;
- the dry-run of REDUCED deepseek-v2's psum and ZeRO LTP steps on
  (data 1, model 2) and (data 2, model 2) against real gloo ranks
  (``tests/sharded_cases.py``, tasks ``dry12`` and ``dry22``): the same
  collective calls and bytes, by kind and axis, as the ranks count by
  wrapping ``torch.distributed``, and the same gate operator calls as
  the ranks' calls of the gate's wrapper (which ``LAUNCHES`` counts on
  the card);
- the CLI on one full config per family (``CLI_ROWS``, each row's time
  beside it), and its skips equal to the JAX package's
  ``shape_supported`` reasons;
- the kernels' cost formulas give ``chip_smoke.py``'s bounds as before.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.func import grad_and_value

import sharded_cases as sc
from repro.configs import get_reduced as jget_reduced
from repro.launch import hlo_analysis
from repro.models import build as jbuild
from repro.models.api import shape_supported as jshape_supported
from repro.configs import get_config as jget_config
from repro.shapes import get_shape as jget_shape
from repro_torch.configs import get_config, get_reduced
from repro_torch.kernels import _build
from repro_torch.kernels import dropfill as df_mod
from repro_torch.kernels import ops, ref
from repro_torch.kernels import packet_reduce as pr_mod
from repro_torch.kernels import randomk as rk_mod
from repro_torch.launch import cost, dryrun
from repro_torch.launch.cost import CostCounter
from repro_torch.models import build
from repro_torch.models.sharding import model_dim, model_specs, spec_at
from repro_torch.shapes import InputShape
from repro_torch.tree import tree_leaves_with_path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _launches():
    return (df_mod.LAUNCHES, pr_mod.LAUNCHES, pr_mod.TREE_LAUNCHES,
            rk_mod.LAUNCHES)


def _kernel_calls():
    """(operator name, CPU inputs, the wrapper's call, its plain
    version) of each kernel."""
    gen = torch.Generator().manual_seed(0)

    def rnd(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen).to(dtype)

    def mask(*shape):
        return (torch.rand(shape, generator=gen) < 0.7).float()

    x, m, s = rnd(13, 360), mask(13), rnd(13).abs()
    xb = rnd(9, 7, dtype=torch.bfloat16)
    mb = mask(9)
    f, r = rnd(11, 360), rnd(11, 360)
    w = rnd(4, 6, 360)
    wm = mask(4, 6)
    u = torch.rand(101, generator=gen)
    xk = rnd(101)
    return [
        ("dropfill_into", (x, m, s), ops.ltp_dropfill, ref.dropfill_ref),
        ("dropfill_into", (xb, mb), ops.ltp_dropfill,
         lambda a, b: ref.dropfill_ref(a, b, torch.ones_like(b))),
        ("dropfill_ef_into", (f, r, m[:11]), ops.ltp_dropfill_ef,
         ref.dropfill_ef_ref),
        ("packet_reduce_into", (w, wm), ops.ltp_packet_reduce,
         ref.packet_reduce_ref),
        ("tree_reduce_into", (w, wm),
         lambda a, b: pr_mod.tree_reduce(a, b, lambda i: i // 2),
         lambda a, b: ref.tree_reduce_ref(a, b, torch.tensor([0, 1, 2, 3]),
                                          torch.tensor([0, 2, 4]))),
        ("randomk_into", (xk, u),
         lambda a, b: ops.randomk_sparsify(a, b, 0.3),
         lambda a, b: ref.randomk_ref(a, b, 0.3)),
    ]


@pytest.mark.parametrize("case", range(6))
@pytest.mark.parametrize("where", ["fake_cuda", "meta"])
def test_kernel_fake_forms(case, where):
    name, inputs, fn, plain = _kernel_calls()[case]
    want = plain(*inputs)
    want = want if isinstance(want, tuple) else (want,)
    before = _launches()
    if where == "meta":
        with pytest.raises(ValueError, match="CUDA device or on the CPU"):
            fn(*(t.to("meta") for t in inputs))   # outside a shape-only run
        with _build.shape_only():
            got = fn(*(t.to("meta") for t in inputs))
            with CostCounter() as c:
                fn(*(t.to("meta") for t in inputs))
        assert c.cost.kernels[name]["calls"] == 1
        dev = torch.device("meta")
    else:
        with FakeTensorMode():
            got = fn(*(torch.empty(t.shape, dtype=t.dtype, device="cuda")
                       for t in inputs))
        dev = torch.device("cuda", 0)
    got = got if isinstance(got, tuple) else (got,)
    assert _launches() == before
    for g, w in zip(got, want, strict=True):
        assert (tuple(g.shape), g.dtype) == (tuple(w.shape), w.dtype)
        assert g.device == dev


@pytest.mark.parametrize("case", range(6))
def test_kernel_cpu_route_is_the_plain_version(case):
    _, inputs, fn, plain = _kernel_calls()[case]
    before = _launches()
    got, want = fn(*inputs), plain(*inputs)
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert torch.equal(g, w)
    assert _launches() == before


def test_donated_gate_writes_in_place_on_meta():
    x, m = torch.empty(5, 360, device="meta"), torch.empty(5, device="meta")
    with _build.shape_only():
        assert ops.ltp_dropfill(x, m, donate=True) is x


def test_kernel_bounds_are_chip_smokes():
    """The formulas moved from ``chip_smoke.py``: its rows' bytes and
    operations, written out as they were there."""
    n, p, w = 15472, 360, 8
    assert cost.reduce_cost(w, 1934, p) == (
        4 * (w * 1934 * p + w * 1934 + 1934 * p), 2 * w * 1934 * p + 1934 * p)
    assert cost.dropfill_cost(n, p, 4, False) == (2 * n * p * 4 + n * 4,
                                                   n * p)
    assert cost.dropfill_cost(77, 7, 2, True) == (2 * 77 * 7 * 2 + 77 * 8,
                                                  77 * 7)
    assert cost.dropfill_ef_cost(n, p) == (4 * (4 * n * p + n), 3 * n * p)
    assert cost.randomk_cost(696234, 4) == (696234 * 12, 696234)
    ms, by = cost.bound(*cost.reduce_cost(w, 1934, p))
    assert by == "bytes" and ms == pytest.approx(
        4 * (w * 1934 * p + w * 1934 + 1934 * p) / 3.35e12 * 1e3, rel=1e-12)


# ----------------------------------------------------------------------------
# the counter against the JAX walker
# ----------------------------------------------------------------------------

WALKER_ARCHS = ("smollm_360m", "mixtral_8x22b", "falcon_mamba_7b",
                "whisper_small")
WB, WS = 2, 32


def _remat_dead_matmul(cfg) -> int:
    """FLOPs of the rematerialised bodies' last matmuls that XLA drops
    from the recompute (module docstring, gap 1)."""
    if cfg.family == "moe":
        return 0
    if cfg.family == "ssm":
        return cfg.n_layers * 2 * WB * WS * cfg.d_inner * cfg.d_model
    per = 2 * cfg.d_ff * cfg.d_model
    if cfg.family == "audio":
        return (cfg.encoder_layers * WB * cfg.encoder_frames
                + cfg.n_layers * WB * WS) * per
    return cfg.n_layers * WB * WS * per


@pytest.mark.parametrize("arch", WALKER_ARCHS)
def test_flops_match_the_jax_walker(arch):
    jcfg = jget_reduced(arch).replace(dtype="float32")
    cfg = get_reduced(arch).replace(dtype="float32")
    rng = np.random.default_rng(0)
    batch = {k: rng.integers(0, cfg.vocab, (WB, WS)).astype(np.int32)
             for k in ("tokens", "labels")}
    if cfg.family == "audio":
        batch["frames"] = (rng.normal(size=(WB, cfg.encoder_frames,
                                            cfg.d_model)) * 0.02
                           ).astype(np.float32)
    japi = jbuild(jcfg)
    compiled = jax.jit(jax.value_and_grad(japi.loss_fn)).lower(
        japi.init(jax.random.PRNGKey(0)),
        {k: jnp.asarray(v) for k, v in batch.items()}).compile()
    walker = hlo_analysis.analyze(compiled.as_text()).flops
    api = build(cfg)
    params = api.init(None, device="meta")
    tb = {k: torch.empty(v.shape, dtype=torch.int64 if v.dtype.kind == "i"
                         else torch.float32, device="meta")
          for k, v in batch.items()}
    with CostCounter() as c:
        grad_and_value(lambda p: api.loss_fn(p, tb))(params)
    port = c.cost.flops - _remat_dead_matmul(cfg)
    if cfg.family == "ssm":
        # gap 2: at most the forward's and the recompute's matvecs
        gap = 2 * cfg.n_layers * 2 * WB * WS * cfg.d_inner * cfg.ssm_state
        assert 0 < port - walker <= gap
        assert port == pytest.approx(walker, rel=1e-2)
    else:
        assert port == walker


# ----------------------------------------------------------------------------
# depth
# ----------------------------------------------------------------------------

DEPTH_CFGS = {"smollm_360m": {"n_layers": 4}, "zamba2_7b": {"n_layers": 4},
              "whisper_small": {"n_layers": 4, "encoder_layers": 4}}
STEPS = [("train", {"ltp": False, "zero": False}),
         ("train", {"ltp": True, "zero": False}),
         ("train", {"ltp": True, "zero": True}),
         ("prefill", {}), ("decode", {})]


@pytest.mark.parametrize("arch", DEPTH_CFGS)
@pytest.mark.parametrize("step", range(len(STEPS)))
def test_depth_extrapolation_equals_the_full_trace(arch, step):
    kind, kw = STEPS[step]
    cfg = get_reduced(arch).replace(dtype="float32", **DEPTH_CFGS[arch])
    # the depths ``lower`` traces, so the case extrapolates
    assert len(dryrun.depth_plan(
        cfg, first=dryrun.first_periods(cfg, kind, **kw))) > 1
    shape = InputShape("t", 16, 4, kind)
    with dryrun.fake_world(4):
        mesh = dryrun.make_mesh((2, 2), ("data", "model"))
        got, _ = dryrun.lower(kind, cfg, shape, mesh, **kw)
        want, _ = dryrun.lower(kind, cfg, shape, mesh, full=True, **kw)
    a, b = got.as_record(), want.as_record()
    assert a == b
    assert b["collective_bytes"] > 0
    assert got.peak == pytest.approx(want.peak, rel=0.05)


# ----------------------------------------------------------------------------
# the dry-run against real ranks
# ----------------------------------------------------------------------------


@pytest.fixture(scope="module")
def dry_ranks(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("dry"))
    started = {task: sc.start_ranks(task, nd * nm, "", d)
               for task, (nd, nm) in sc.DRY_MESH.items()}
    return {task: [json.loads(str(r["json"])) for r in sc.finish_ranks(s)]
            for task, s in started.items()}


@pytest.mark.parametrize("task", sorted(sc.DRY_MESH))
@pytest.mark.parametrize("variant", sc.DRY_VARIANTS)
def test_dryrun_counts_what_the_ranks_do(dry_ranks, task, variant):
    nd, nm = sc.DRY_MESH[task]
    cfg = get_reduced(sc.DRY_ARCH).replace(dtype="float32")
    rec = dryrun.run_one(sc.DRY_ARCH, "dry", cfg=cfg,
                         shape=InputShape("dry", sc.DRY_S, sc.DRY_B,
                                          "train"),
                         mesh_shape=((nd, nm), ("data", "model")),
                         ltp=True, zero=variant == "zero")
    assert rec["ok"], rec.get("traceback")
    ranks = [r[variant] for r in dry_ranks[task]]
    assert all(r == ranks[0] for r in ranks)   # one program on every rank
    by_axis = {a: {k: {"calls": int(c["calls"]), "bytes": int(c["bytes"])}
                   for k, c in kinds.items()}
               for a, kinds in rec["cost"]["by_axis"].items()}
    assert by_axis == ranks[0]["collectives"]
    assert "model" in by_axis and (nd == 1) == ("data" not in by_axis)
    gate = rec["cost"]["kernels"].get("dropfill_into", {}).get("calls", 0)
    assert gate == ranks[0]["gate"]
    assert (gate > 0) == (variant == "psum")


# ----------------------------------------------------------------------------
# the CLI
# ----------------------------------------------------------------------------

# one full config a family: (family, arch, shape, flags), chosen to lower
# in under 30 s; each row's ``lower_s`` run alone on one CPU core of the
# machine the tests were written on is at its end (the test does not time
# them: under a loaded test run they take longer)
CLI_ROWS = [("dense", "smollm_360m", "train_4k", ["--ltp"]),        # 5.0 s
            ("vlm", "qwen2_vl_72b", "decode_32k", []),               # 2.4 s
            ("moe", "deepseek_v2_236b", "train_4k", ["--ltp-zero"]),  # 7.8 s
            ("plain", "deepseek_v2_236b", "train_4k", []),           # 6.6 s
            ("ssm", "falcon_mamba_7b", "long_500k", []),             # 3.8 s
            ("hybrid", "zamba2_7b", "decode_32k", []),               # 3.0 s
            ("audio", "whisper_small", "decode_32k", []),            # 2.5 s
            ("skip", "yi_34b", "long_500k", [])]                     # 0 s


@pytest.fixture(scope="module")
def cli_runs():
    """Every row of ``CLI_ROWS`` through ``python -m
    repro_torch.launch.dryrun``, the processes run together; (exit code,
    JSON lines, stderr) by family."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    procs = {family: subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--multi-pod", "single", *flags],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for family, arch, shape, flags in CLI_ROWS}
    out = {}
    try:
        for family, p in procs.items():
            so, se = p.communicate(timeout=300)
            out[family] = (p.returncode, [json.loads(x) for x in
                                          so.splitlines()
                                          if x.startswith("{")], se)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
    return out


@pytest.mark.parametrize("family,arch,shape,flags", CLI_ROWS)
def test_cli_row(cli_runs, family, arch, shape, flags):
    rc, lines, err = cli_runs[family]
    assert rc == 0, err[-3000:]
    rec, summary = lines
    ok, why = jshape_supported(jget_config(arch), jget_shape(shape))
    if not ok:
        assert rec["skipped"] == why and summary["summary"]["SKIP"] == 1
        return
    assert rec["ok"] and summary["summary"] == {"OK": 1, "SKIP": 0,
                                                "FAIL": 0}
    # the plain train step shards its weights over data, as the
    # reference's does (fsdp = not ltp); the LTP steps and the serve
    # hold them whole there
    assert rec["mesh"] == "16x16" and rec["fsdp"] is (
        not flags and rec["step"] == "train_step")
    assert rec["ltp"] == bool(flags) and rec["zero"] == ("--ltp-zero"
                                                         in flags)
    c = rec["cost"]
    assert c["flops"] > 0 and c["bytes"] > 0 and c["collective_bytes"] > 0
    assert set(c["by_axis"]) <= {"data", "model"}
    assert rec["memory"]["peak"] >= rec["memory"]["params"] > 0
    assert set(rec["roofline"]) == {"compute_s", "memory_s", "collective_s"}
    if "--ltp" in flags:
        assert c["kernels"]["dropfill_into"]["calls"] > 0
    if rec["fsdp"]:
        # the weights' data blocks gathered, their gradients
        # reduce-scattered; a rank's params at most an eighth of its
        # model blocks whole (30.87 GB for deepseek-v2 before FSDP)
        data = c["by_axis"]["data"]
        assert data["all_gather_into_tensor"]["calls"] > 0
        assert data["reduce_scatter_tensor"]["calls"] > 0
        cfg = get_config(arch)
        shapes = build(cfg).init(None, device="meta")
        specs = model_specs(cfg, shapes, {"model": 16})
        whole = sum(x.numel() * x.element_size()
                    // (16 if model_dim(spec_at(specs, p)) is not None
                        else 1)
                    for p, x in tree_leaves_with_path(shapes))
        assert rec["memory"]["params"] <= whole / 8
