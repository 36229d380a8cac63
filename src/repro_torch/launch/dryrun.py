"""Multi-pod dry-run: lower every (architecture x input shape x mesh) step
on shape-only tensors, allocating nothing, and count its roofline inputs.

The PyTorch counterpart of the JAX package's ``launch/dryrun.py``. Where
the reference lowers and compiles each step with ``jax.jit`` on
``ShapeDtypeStruct``s and walks the compiled HLO
(``launch/hlo_analysis.py``), this module runs RANK 0's program of the
step once on ``meta`` tensors under ``launch.cost.CostCounter``: every
rank of a production mesh runs the same program on its own blocks, so
rank 0's counts are each rank's. The process group is ``torch``'s
``fake`` backend at the mesh's world size (256 or 512 ranks in this one
process): every collective returns at once and is counted.

Run (on the CPU; no card needed):

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi_34b \\
      --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all \\
      [--multi-pod single|multi|both] [--ltp | --ltp-zero] [--out DIR]

It prints one JSON record a combination (``--out DIR`` also writes each
to ``DIR/<arch>_<shape>_<mesh>[_ltp|_ltpzero].json``), then a summary
line. A skip comes from ``models.api.shape_supported`` alone; any other
failure is a ``FAIL`` and the exit code is 1.

What the steps are:

- train: ``make_plain_train_step`` (SGD-momentum) on the state of
  ``init_state(..., fsdp=True)``, its
  weights, gradients and momentum split over ``data`` as well as
  ``model`` (``sharding.fsdp_specs``), as the reference lowers its plain
  step (``fsdp = not ltp``); or with ``--ltp``
  ``make_ltp_train_step`` with the worker axes ``("data",)`` (``("pod",
  "data")`` on the multi-pod mesh), its weights whole over the workers,
  the psum variant, or with
  ``--ltp-zero`` the ZeRO variant (``zero_opt_state``). The LTP step
  gets ``uniforms=`` (shape-only draws) and ``sync_backend="cuda"``, what
  ``"auto"`` picks on the card, so the gate is counted as its operator
  (``repro_torch::dropfill_into``), not its plain version. The step
  takes the GLOBAL batch, as the port's steps do, and each rank its
  block of it.
- prefill and decode: ``ModelApi.prefill`` / ``decode_step`` under a
  ``ShardCtx`` over ``model``, on each rank's block of ``input_specs``
  (the batch over the data axes where it divides them) and, for decode,
  its cache (``init_cache(..., ctx=)``, ``sharding.cache_spec``).

Where the port differs from the reference's dry-run:

- It lowers in the config's own dtype: the reference lowers its LTP step
  in float32 to work around an XLA:CPU check failure, which the port
  does not meet.
- The prefill and decode hold each rank's ``model`` block whole on every
  data rank (their records say ``"fsdp": false``); the reference's
  ``param_specs`` splits their weights over ``data`` as well.
- A stacked leaf's ``data`` dim is one of its period's dims
  (``sharding.fsdp_specs``); the reference's ``spec_for`` takes the
  periods' axis where the period count divides ``data``.
- The tensors are ``meta`` tensors, not fake CUDA tensors: autograd over
  fake CUDA tensors needs a CUDA build of torch, and the dry-run runs on
  the CPU. Inside ``kernels._build.shape_only`` the kernels' wrappers
  send a ``meta`` tensor through their operator's fake form, as they
  send a CUDA tensor to the kernel.

Depth: a stack of L identical periods costs ``c(1) + (L - 1) (c(2) -
c(1))``, c(k) the step traced at k periods (the leading and trailing
unstacked layers in both); the enc-dec stacks extrapolate each on its
own. The plain step, and the enc-dec's prefill and decode, extrapolate
from c(2) and c(3) (``first_periods``).
The LTP step's sync cuts each leaf into whole packets, which is
not linear in the depth, so its half (``make_ltp_train_step``'s
``finish``) is traced once at the config's own depth on a gradient
shaped like the params, and only the loss and gradient half
(``local``) is extrapolated; the peak is the larger of the two halves'.
FLOPs, bytes, collectives and operator calls are then exact
(``tests/test_torch_dryrun.py`` holds them against a trace of every
layer), and the peak, linear in the depth to within a few percent.

Each record has the reference's keys where they apply (``arch``,
``shape``, ``mesh``, ``step``, ``ltp``, ``zero``, ``ok``, ``skipped``,
``error``), then ``memory`` (bytes a rank: ``peak``, ``params``,
``grads``, ``optimizer_state``, ``inputs``), ``cost``
(``launch.cost.Cost.as_record``), ``roofline`` (seconds: the FLOPs over
the card's peak for the config's dtype, the bytes over its memory rate,
the collective bytes over NVLink's rate a direction, ``launch/mesh.py``)
and ``lower_s``.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.config import LTPConfig, ModelConfig
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.kernels import _build
from repro_torch.launch.cost import Cost, CostCounter
from repro_torch.launch.mesh import (
    HBM_BW,
    NVLINK_BW,
    PEAK_FLOPS_BF16,
    PEAK_FLOPS_F32,
    PRODUCTION_SHAPES,
)
from repro_torch.models import build
from repro_torch.models.api import input_specs, shape_supported
from repro_torch.models.layers import dtype_of
from repro_torch.models.sharding import dp_axes, shard_params, tp_ctx
from repro_torch.models.transformer import make_plan
from repro_torch.optim import sgd_momentum
from repro_torch.shapes import SHAPES, InputShape, get_shape
from repro_torch.tree import tree_leaves, tree_map, tree_map_with_path

DEVICE = "meta"
STEP_NAMES = {"train": "train_step", "prefill": "prefill",
              "decode": "serve_step"}


@contextlib.contextmanager
def fake_world(world_size: int):
    """A process group of ``world_size`` ranks held by this process alone,
    as rank 0, over ``torch``'s ``fake`` backend (its collectives return
    at once and change nothing); destroyed on exit."""
    import torch.distributed._tools.fake_collectives  # noqa: F401
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("the dry-run needs this process to hold no "
                           "process group")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def make_mesh(shape: Tuple[int, ...], names: Tuple[str, ...]):
    """A ``DeviceMesh`` of ``shape`` over the fake process group."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(names))


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _batch_dims(mesh) -> Tuple[Any, int]:
    """The batch axes' spec entry and their product."""
    dp = dp_axes(mesh)
    n = 1
    for a in dp:
        n *= mesh.size(mesh.mesh_dim_names.index(a))
    return (dp[0] if len(dp) == 1 else dp), n


def rank_inputs(specs: Dict[str, Any], ndp: int) -> Dict[str, Any]:
    """Rank 0's block of each input of ``input_specs``: dim 0 (the M-RoPE
    ids' dim 1) over the ``ndp`` batch ranks where it divides them, as
    the reference's ``batch_spec`` places it; meta tensors."""
    def take(path, x):
        dim = 1 if path[-1] == "positions3" else 0
        shape = list(x.shape)
        if x.dim() > dim and ndp > 1 and shape[dim] % ndp == 0:
            shape[dim] //= ndp
        return torch.empty(shape, dtype=x.dtype, device=DEVICE)

    return tree_map_with_path(take, specs)


# ----------------------------------------------------------------------------
# one step, traced
# ----------------------------------------------------------------------------


def _train(cfg: ModelConfig, shape: InputShape, mesh, *, ltp: bool,
           zero: bool, half: str = "step"):
    """Rank 0's train step at ``cfg``'s depth, built on ``meta``: (the
    tensors live before it, a call that runs it, its memory). With
    ``half`` ``"local"`` or ``"finish"``, the LTP step's half of that
    name alone (``make_ltp_train_step``): this rank's loss and gradient,
    or the sync and the update of a gradient shaped like the params."""
    from repro_torch.core import ltp_sync as ls
    from repro_torch.train.trainer import init_state, make_ltp_train_step, \
        make_plain_train_step, zero_opt_state

    api, opt = build(cfg), sgd_momentum()
    params = api.init(None, device=DEVICE)
    state = init_state(api, opt, params=params, mesh=mesh, fsdp=not ltp)
    batch = input_specs(cfg, shape)
    extra: Tuple = ()
    if not ltp:
        step = make_plain_train_step(api, opt, mesh)

        def run():
            return step(state, batch, 0.1)
    else:
        worker = ("pod", "data") if "pod" in mesh.mesh_dim_names \
            else ("data",)
        ltp_cfg = LTPConfig(sync_backend="cuda")
        if zero:
            state.opt_state = zero_opt_state(params, ltp_cfg, mesh, worker)
        dp, _ = _batch_dims(mesh)
        specs = {k: ((None, dp) if k == "positions3" else (dp,))
                 for k in batch}
        step = make_ltp_train_step(api, opt, mesh, ltp_cfg, worker, specs)
        frac = torch.empty((ls.worker_count(mesh, worker),),
                           dtype=torch.float32, device=DEVICE)
        uniforms = [torch.empty((ls._n_pkts(tuple(x.shape),
                                             ltp_cfg.packet_floats),),
                                dtype=torch.float32, device=DEVICE)
                    for x in tree_leaves(params)]
        extra = (frac, uniforms)

        def run():
            if half == "local":
                return step.local(state, batch)
            if half == "finish":
                loss = torch.empty((), dtype=torch.float32, device=DEVICE)
                return step.finish(state, loss, tree_map(
                    torch.empty_like, state.params), frac, 0, 0.1,
                    uniforms=uniforms)
            return step(state, batch, frac, 0, 0.1, uniforms=uniforms)
    del params
    mem = {"params": _nbytes(state.params), "grads": _nbytes(state.params),
           "optimizer_state": _nbytes(state.opt_state),
           "inputs": _nbytes(batch) + _nbytes(extra)}
    return (state.params, state.opt_state, state.step, batch, extra), run, \
        mem


def _serve_params(cfg: ModelConfig, mesh):
    api = build(cfg)
    params = api.init(None, device=DEVICE)
    ctx = tp_ctx(mesh)
    if ctx is not None:
        from repro_torch.train.trainer import model_layout

        params = shard_params(params, model_layout(api, mesh), mesh)
    return api, params, ctx


def _prefill(cfg: ModelConfig, shape: InputShape, mesh):
    """Rank 0's prefill, as ``_train`` gives its step."""
    api, params, ctx = _serve_params(cfg, mesh)
    _, ndp = _batch_dims(mesh)
    inputs = rank_inputs(input_specs(cfg, shape), ndp)

    @torch.no_grad()
    def run():
        return api.prefill(params, inputs, ctx=ctx)

    mem = {"params": _nbytes(params), "inputs": _nbytes(inputs)}
    return (params, inputs), run, mem


def _decode(cfg: ModelConfig, shape: InputShape, mesh):
    """Rank 0's decode step against its block of a ``shape.seq_len``
    cache, as ``_train`` gives its step."""
    api, params, ctx = _serve_params(cfg, mesh)
    _, ndp = _batch_dims(mesh)
    b = shape.global_batch
    b = b // ndp if ndp > 1 and b % ndp == 0 else b
    cache = api.init_cache(b, shape.seq_len, dtype_of(cfg.dtype),
                           device=DEVICE, ctx=ctx)
    token = torch.empty((b,), dtype=torch.int32, device=DEVICE)
    pos = torch.empty((), dtype=torch.int32, device=DEVICE)

    @torch.no_grad()
    def run():
        return api.decode_step(params, cache, token, pos, ctx=ctx)

    mem = {"params": _nbytes(params), "cache": _nbytes(cache),
           "inputs": _nbytes((token, pos))}
    return (params, cache, token, pos), run, mem


STEPS = {"train": _train, "prefill": _prefill, "decode": _decode}


def trace(kind: str, cfg: ModelConfig, shape: InputShape, mesh,
          **kw) -> Cost:
    """Rank 0's step of ``kind`` at ``cfg``'s own depth, run once under
    a ``CostCounter``, the tensors it takes live from the start and the
    kernels' operators taking ``meta`` tensors."""
    live, run, _ = STEPS[kind](cfg, shape, mesh, **kw)
    with _build.shape_only(), CostCounter(mesh) as counter:
        counter.adopt(*live)
        out = run()
        del out
    return counter.cost


# ----------------------------------------------------------------------------
# depth
# ----------------------------------------------------------------------------


def with_periods(cfg: ModelConfig, k: int) -> Optional[ModelConfig]:
    """``cfg`` with its stack cut to ``k`` periods and the same leading
    and trailing layers, or ``None`` where the cut changes the layer
    plan's codes."""
    plan = make_plan(cfg)
    n = len(plan.lead_codes) + k * len(plan.period_codes) \
        + len(plan.rem_codes)
    cut = make_plan(cfg.replace(n_layers=n))
    if (cut.lead_codes, cut.period_codes, cut.rem_codes, cut.n_periods) != \
            (plan.lead_codes, plan.period_codes, plan.rem_codes, k):
        return None
    return cfg.replace(n_layers=n)


def depth_plan(cfg: ModelConfig, full: bool = False, first: int = 1):
    """``[(coefficient, config)]``: the step's cost is the sum of each
    config's traced cost times its coefficient (module docstring), from
    the traces at ``first`` and ``first + 1`` periods (layers of each of
    the enc-dec's stacks)."""
    f = first
    if cfg.family == "audio":
        e, d = cfg.encoder_layers, cfg.n_layers
        if full or (e <= f + 1 and d <= f + 1):
            return [(1, cfg)]
        base = cfg.replace(encoder_layers=f, n_layers=f)
        return [(1 - (e - f) - (d - f), base),
                (e - f, cfg.replace(encoder_layers=f + 1, n_layers=f)),
                (d - f, cfg.replace(encoder_layers=f, n_layers=f + 1))]
    if cfg.family == "cnn" or full:
        return [(1, cfg)]
    n = make_plan(cfg).n_periods
    ca, cb = with_periods(cfg, f), with_periods(cfg, f + 1)
    if n <= f + 1 or ca is None or cb is None:
        return [(1, cfg)]
    return [(f + 1 - n, ca), (n - f, cb)]


def first_periods(cfg: ModelConfig, kind: str, ltp: bool = False,
                  **_) -> int:
    """The shallower of the two depths ``lower`` traces a step at. The
    plain step's peak under FSDP sits elsewhere at one period than at
    more (its stacked gradient blocks grow past a fixed term from two
    periods on), so it extrapolates from two and three. So do the
    enc-dec's prefill and decode: their peak grows by less from one
    decoder layer to two than from then on (REDUCED whisper-small:
    0.99 MB, then 1.18 MB, then 1.26 MB a prefill layer)."""
    if kind == "train":
        return 1 if ltp else 2
    return 2 if cfg.family == "audio" else 1


def lower(kind: str, cfg: ModelConfig, shape: InputShape, mesh, *,
          full: bool = False, **kw) -> Tuple[Cost, Dict[str, int]]:
    """The step of ``kind`` at ``cfg``'s depth: its cost (extrapolated
    over the periods, ``depth_plan``) and its memory (the state's and
    inputs' bytes at that depth, built and not run; the peak
    extrapolated like the cost)."""
    plan = depth_plan(cfg, full, first_periods(cfg, kind, **kw))
    # the LTP step's sync cuts each leaf into whole packets (and the ZeRO
    # variant pads them to a multiple of the workers), which is not
    # linear in the depth: its half is traced at the config's own depth
    split = kind == "train" and kw.get("ltp") and len(plan) > 1
    total = Cost()
    for coef, c in plan:
        total = total + trace(kind, c, shape, mesh, **kw, **(
            {"half": "local"} if split else {})).scaled(coef)
    if split:
        sync = trace(kind, cfg, shape, mesh, half="finish", **kw)
        peak = max(total.peak, sync.peak)
        total = total + sync
        total.peak = peak
    _, _, mem = STEPS[kind](cfg, shape, mesh, **kw)
    mem["peak"] = total.peak
    return total, mem


# ----------------------------------------------------------------------------
# records
# ----------------------------------------------------------------------------


def roofline_terms(rec: Dict[str, Any], dtype: str) -> Dict[str, float]:
    """Three roofline terms in seconds (per-rank counts, one card's rates,
    ``launch/mesh.py``)."""
    c = rec.get("cost", {})
    peak = PEAK_FLOPS_BF16 if dtype == "bfloat16" else PEAK_FLOPS_F32
    return {"compute_s": c.get("flops", 0) / peak,
            "memory_s": c.get("bytes", 0) / HBM_BW,
            "collective_s": c.get("collective_bytes", 0) / NVLINK_BW}


def mesh_name(shape: Sequence[int]) -> str:
    return "x".join(str(s) for s in shape)


def run_one(arch: str, shape_name: str, *, multi_pod: bool = False,
            ltp: bool = False, zero: bool = False,
            cfg: Optional[ModelConfig] = None,
            shape: Optional[InputShape] = None,
            mesh_shape: Optional[Tuple[Tuple[int, ...],
                                       Tuple[str, ...]]] = None
            ) -> Dict[str, Any]:
    """The record of one combination. ``cfg``, ``shape`` and
    ``mesh_shape`` (``(sizes, names)``) stand in for ``arch``'s CONFIG,
    the shape named ``shape_name`` and the production mesh where given
    (``chip_smoke.py``'s configurations). Holds a fake process group
    while it runs."""
    cfg = cfg or get_config(arch)
    shape = shape or get_shape(shape_name)
    sizes, names = mesh_shape or PRODUCTION_SHAPES[
        "multi_pod" if multi_pod else "single_pod"]
    rec: Dict[str, Any] = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name(sizes),
        "step": STEP_NAMES[shape.kind], "ltp": ltp or zero, "zero": zero,
        "ok": False, "fsdp": shape.kind == "train" and not (ltp or zero),
        "device": DEVICE, "rank": 0,
        "dtype": cfg.dtype}
    sup, why = shape_supported(cfg, shape)
    if not sup:
        rec.update(skipped=why, ok=True)
        return rec
    world = 1
    for s in sizes:
        world *= s
    t0 = time.perf_counter()
    try:
        with fake_world(world):
            mesh = make_mesh(sizes, names)
            kw = ({"ltp": ltp or zero, "zero": zero}
                  if shape.kind == "train" else {})
            cost, mem = lower(shape.kind, cfg, shape, mesh, **kw)
        rec["lower_s"] = time.perf_counter() - t0
        rec["memory"] = mem
        rec["cost"] = cost.as_record()
        rec["roofline"] = roofline_terms(rec, cfg.dtype)
        rec["depth"] = [{"coef": coef, "n_layers": c.n_layers,
                         "encoder_layers": c.encoder_layers}
                        for coef, c in depth_plan(
                            cfg, first=first_periods(cfg, shape.kind,
                                                     **kw))]
        rec["ok"] = True
    except Exception as e:  # noqa: BLE001 - a failed row is a FAIL record
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
        rec["lower_s"] = time.perf_counter() - t0
    return rec


def record_name(rec: Dict[str, Any]) -> str:
    tag = "_ltpzero" if rec.get("zero") else ("_ltp" if rec.get("ltp")
                                             else "")
    return f"{rec['arch']}_{rec['shape']}_{rec['mesh']}{tag}.json"


def status(rec: Dict[str, Any]) -> str:
    return "SKIP" if "skipped" in rec else ("OK" if rec["ok"] else "FAIL")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--ltp", action="store_true",
                    help="lower the LTP-sync train step instead of plain")
    ap.add_argument("--ltp-zero", action="store_true",
                    help="LTP with packet-space reduce-scatter and sharded "
                         "momentum (the ZeRO variant)")
    ap.add_argument("--out", default=None,
                    help="write each record to a JSON file in this folder")
    args = ap.parse_args(argv)
    if not args.all and args.arch is None and args.shape is None:
        ap.error("pass --all or --arch/--shape")
    archs = ([a for a in ARCH_IDS if a != "papernet"] if args.arch is None
             else [args.arch])
    shapes = list(SHAPES) if args.shape is None else [args.shape]
    pods = {"single": [False], "multi": [True],
            "both": [False, True]}[args.multi_pod]
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    counts = {"OK": 0, "SKIP": 0, "FAIL": 0}
    t_all = time.perf_counter()
    for arch in archs:
        for shape in shapes:
            for mp in pods:
                rec = run_one(arch, shape, multi_pod=mp,
                              ltp=args.ltp or args.ltp_zero,
                              zero=args.ltp_zero)
                counts[status(rec)] += 1
                print(json.dumps(rec, default=str), flush=True)
                if args.out:
                    with open(os.path.join(args.out, record_name(rec)),
                              "w") as f:
                        json.dump(rec, f, indent=1, default=str)
    print(json.dumps({"summary": counts,
                      "seconds": time.perf_counter() - t_all}))
    return 0 if counts["FAIL"] == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
