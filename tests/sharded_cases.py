"""The sharded LTP path's multi-process cases, for
``tests/test_torch_sharded.py`` and ``tests/test_torch_trainer_sharded.py``.

Two kinds of process, each started by the tests:

    python tests/sharded_cases.py jax <task> <ref.npz>
        the JAX package's sharded functions under ``shard_map`` on 4 host
        devices (``XLA_FLAGS=--xla_force_host_platform_device_count=4``,
        as ``src/repro/launch/train.py`` runs them); writes the inputs,
        every worker's uniforms and the outputs.

    python tests/sharded_cases.py rank <task> <rank> <world> <init file> \
        <ref.npz> <out.npz>
        one gloo rank of the port on the CPU: reads the inputs and its own
        worker's uniforms, writes its outputs. It imports no JAX.

Tasks: ``sync`` (``masked_psum_leafwise``, ``masked_rs_update_leafwise``
and ``LTPSync`` on (data 2, model 1), and ``LTPSync`` on (data 2, model
2) with 4 ranks) and ``train`` (both variants of ``make_ltp_train_step``
on REDUCED smollm-360m cut to 2 layers, one step each, and the plain
step on REDUCED mixtral-8x22b, whose router groups by data shard) and
``tp`` (tensor parallelism over ``model``: the psum step under paper and
count compensation on REDUCED smollm-360m cut to 2 layers, REDUCED
mixtral-8x22b, expert-parallel, and REDUCED qwen2-vl, and the plain step
on REDUCED mixtral, on (data 2, model 2) against the JAX step on the
same mesh; the rank task ``tp12`` runs the same models and mixtral with
3 experts, d_ff-parallel, on (data 1, model 2), and ``tp14`` smollm on
(data 1, model 4), whose 6 heads do not divide 4, each held against the
port's own (1, 1) step, since the reference cannot run (1, n)). Each
rank task ends with a planted fault: the same case with the
rank-to-worker mapping reversed (``tp``: the model ranks' blocks
swapped), which the tests require to disagree with the reference.

The ``serve12`` and ``serve22`` rank tasks (``tests/
test_torch_serve_sharded.py``) serve ``SERVE_MODELS`` tensor-parallel on
(data 1, model 2) and (data 2, model 2): prefill, then decode from
``init_cache`` under ``ctx``, from params and inputs the test wrote (no
JAX process: the test runs the reference itself). The ``dry12`` and
``dry22`` tasks (``tests/test_torch_dryrun.py``) run REDUCED
deepseek-v2's psum and ZeRO LTP steps and count their collectives by
wrapping ``torch.distributed`` (``PyCollectives``) and the gate's calls.

The ``train`` reference runs ``make_ltp_train_step`` with its
``shard_map`` check off. With the check on, as the JAX package calls it,
JAX 0.9 hands each worker the gradient of its replicated params already
summed over the workers (the transpose of the implicit ``pvary`` is a
``psum``), so the step masks the workers' sum, not each worker's own
gradient, and at full delivery applies W times the mean gradient. The
task records that step at full delivery too (``checked_full``), beside
the same step with the check off (``unchecked_full``).
"""
from __future__ import annotations

import contextlib
import datetime
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")
W = 2
P_FLOATS = 8
COMPS = ("paper", "count", "expected")
FRACS = {"f07": (0.7, 0.9), "f10": (1.0, 1.0)}
LR = 0.1
KEY = 5
# LTPSync's grads (one block a rank before model sharding) and specs
SYNC_SHAPES = {"b": (20,), "v": (3, 5, 8), "w": (16, 24)}
SYNC_SPECS = {"b": (), "v": (None, None, "model"), "w": (None, "model")}
# the leafwise functions' per-worker grads: W blocks along dim 0
LEAF_SHAPES = {"b": (20,), "v": (3, 5, 7), "w": (16, 24)}
TRAIN_CASES = (("psum", "paper"), ("psum", "count"), ("psum", "expected"),
               ("zero", "paper"), ("zero", "count"))
TRAIN_B, TRAIN_S, TRAIN_FRAC = 4, 16, (0.7, 0.9)
TIMEOUT_S = 300
# the tp task's models: (architecture, overrides of its REDUCED config)
TP_MODELS = {"smollm": ("smollm_360m", {"n_layers": 2}),
             "mixtral": ("mixtral_8x22b", {}),
             "qwen2vl": ("qwen2_vl_72b", {})}
TP_COMPS = ("paper", "count")
# the (1, n) ranks' models and meshes, against the port's (1, 1) step
TP_LOCAL = {"tp12": ("smollm", "mixtral", "qwen2vl", "mixtral_e3"),
            "tp14": ("smollm",)}
TP_MESH = {"tp": (2, 2), "tp12": (1, 2), "tp14": (1, 4)}
TP_SEED = 3
# the families the tp task leaves out (tests/test_torch_tp_families.py):
# the ``tpf`` task on (2, 2) against the JAX step, whose two processes
# (``TPF_JAX``) split the compiles; ``tpf12`` and ``tpf14`` against the
# port's own (1, 1) step
TPF_MODELS = {"deepseek": ("deepseek_v2_236b", {}),
              "falcon": ("falcon_mamba_7b", {}),
              "zamba2": ("zamba2_7b", {}),
              "whisper": ("whisper_small", {}),
              "papernet": ("papernet", {})}
TPF_JAX = {"tpf_a": ("deepseek", "papernet"),
           "tpf_b": ("falcon", "zamba2", "whisper")}
TPF_LOCAL = {"tpf12": tuple(TPF_MODELS), "tpf14": tuple(TPF_MODELS)}
TPF_MESH = {"tpf": (2, 2), "tpf12": (1, 2), "tpf14": (1, 4)}
# the planted fault of the tpf tasks: falcon's Mamba-1 in_proj, each rank
# starting from its mirror's block
TPF_PLANT = ("falcon", "in_proj")
# the ZeRO variant at model > 1 and data parallelism inside a worker
# (tests/test_torch_trainer_13e.py): each task's mesh (shape, axis names,
# worker axes) and cases (model, variant, compensation). ``z22`` and
# ``pd22`` run against the JAX step, whose three processes (``Z_JAX``)
# split the models; the others against the port's own one-rank step.
# ``mixtral_masked``: REDUCED mixtral on a batch whose labels are masked
# unevenly over its rows (``masked_batch``).
Z_MESH = {"z22": ((2, 2), ("data", "model"), ("data",)),
          "pd22": ((2, 2, 1), ("pod", "data", "model"), ("pod",)),
          "z12": ((1, 2), ("data", "model"), ("data",)),
          "z14": ((1, 4), ("data", "model"), ("data",)),
          "z122": ((1, 2, 2), ("pod", "data", "model"), ("pod",))}
Z_CASES = {
    "z22": [(name, "zero", comp) for name in ("smollm", "deepseek")
            for comp in TP_COMPS]
    + [("mixtral", "zero", "paper"), ("mixtral_bf16", "zero", "count")],
    "pd22": [("smollm", "psum", "paper"), ("smollm", "zero", "paper"),
             ("mixtral", "psum", "paper"), ("mixtral_masked", "psum",
                                            "paper")],
    "z12": [(name, "zero", comp) for name in ("smollm", "mixtral",
                                              "deepseek")
            for comp in TP_COMPS],
    "z14": [("smollm", "zero", comp) for comp in TP_COMPS],
    "z122": [(name, variant, "paper") for name in ("smollm", "qwen2vl")
             for variant in ("psum", "zero")]}
Z_JAX = {"z13_a": ("smollm", "mixtral_masked"),
         "z13_b": ("mixtral_bf16", "mixtral"), "z13_c": ("deepseek",)}
# the bfloat16 case's witnesses of the reference's own rounding
# (tests/test_torch_trainer_13e.py): its step on (data 2, model 1), and
# on (2, 2) from its init moved by one ulp (``nudged``)
Z_WITNESS = ("mixtral_bf16", "zero", "count")


# FSDP over data in the plain step (tests/test_torch_fsdp.py): each rank
# task's mesh (shape, axis names), against the JAX plain step on the same
# mesh, its state placed by ``spec_for(fsdp=True)`` (one JAX process,
# ``jax_fsdp``); every family's REDUCED config; ``FSDP_BF16`` (REDUCED
# mixtral with 3 experts in its own bfloat16: the experts split d_ff over
# model = 2) on (2, 2), and on (2, 1) for the reference's own spread;
# the planted fault (a gather whose backward keeps this rank's block of
# the gradient) on ``FSDP_PLANT``'s mesh and model
FSDP_MESH = {"fsdp22": ((2, 2), ("data", "model")),
             "fsdp221": ((2, 2, 1), ("pod", "data", "model")),
             "fsdp21": ((2, 1), ("data", "model"))}
FSDP_MODELS = ("smollm", "qwen2vl", "mixtral", "deepseek", "falcon",
               "zamba2", "whisper", "papernet")
FSDP_BF16 = "mixtral_e3_bf16"
FSDP_PLANT = ("fsdp21", "smollm")


# the sharded serve path's models and meshes
SERVE_MODELS = ("smollm_360m", "mixtral_8x22b", "deepseek_v2_236b",
                "falcon_mamba_7b", "zamba2_7b", "whisper_small")
SERVE_MESH = {"serve12": (1, 2), "serve22": (2, 2)}
SERVE_B, SERVE_S, SERVE_STEPS = 4, 16, 8
# the dry-run's collectives against real ranks: REDUCED deepseek-v2 at
# float32, one LTP step of each variant, a (B, S) global batch
DRY_MESH = {"dry12": (1, 2), "dry22": (2, 2)}
DRY_ARCH, DRY_B, DRY_S = "deepseek_v2_236b", 4, 16
DRY_VARIANTS = ("psum", "zero")


def env() -> dict:
    return dict(os.environ, PYTHONPATH=SRC + os.pathsep
                + os.environ.get("PYTHONPATH", ""), JAX_PLATFORMS="cpu",
                XLA_FLAGS="--xla_force_host_platform_device_count=4",
                OMP_NUM_THREADS="1")


def _start(args: list, log: str) -> subprocess.Popen:
    """This file as a subprocess, its output to ``log`` (a file, so that
    no pipe fills while another process is waited on)."""
    with open(log, "w") as f:
        return subprocess.Popen([sys.executable, __file__, *args],
                                env=env(), stdout=f, stderr=subprocess.STDOUT)


def _finish(procs: list, logs: list, what: str) -> None:
    """Wait for ``procs``; one that hangs fails the run at the timeout,
    and every one is killed."""
    try:
        for p in procs:
            p.wait(timeout=TIMEOUT_S)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for i, (p, log) in enumerate(zip(procs, logs)):
        with open(log) as f:
            assert p.returncode == 0, f"{what} {i}: {f.read()[-4000:]}"


def start_jax(task: str, out: str):
    """The JAX reference of ``task`` started in a subprocess."""
    return _start(["jax", task, out], out + ".log"), out


def finish_jax(started) -> dict:
    proc, out = started
    _finish([proc], [out + ".log"], "jax")
    return dict(np.load(out))


def run_jax(task: str, out: str) -> dict:
    """The JAX reference of ``task`` in a subprocess; its npz as a dict."""
    return finish_jax(start_jax(task, out))


def start_ranks(task: str, world: int, ref: str, tmp: str):
    """``world`` gloo ranks of the port on ``task``, started."""
    init = os.path.join(tmp, f"{task}{world}.init")
    outs = [os.path.join(tmp, f"{task}{world}_rank{r}.npz")
            for r in range(world)]
    procs = [_start(["rank", task, str(r), str(world), init, ref, outs[r]],
                    outs[r] + ".log") for r in range(world)]
    return procs, outs


def finish_ranks(started) -> list:
    """Each rank's npz as a dict, in rank order."""
    procs, outs = started
    _finish(procs, [o + ".log" for o in outs], "rank")
    return [dict(np.load(o)) for o in outs]


def run_ranks(task: str, world: int, ref: str, tmp: str) -> list:
    """``world`` gloo ranks of the port on ``task``; each rank's npz as a
    dict, in rank order. A rank that hangs fails the run at the
    timeout, and every rank is killed."""
    return finish_ranks(start_ranks(task, world, ref, tmp))


@contextlib.contextmanager
def world_of_one(tmp: str):
    """A gloo process group of one rank in this process (``file://``
    rendezvous under ``tmp``, so parallel test workers share nothing),
    and its (data 1, model 1) ``DeviceMesh``; destroyed on exit."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(tmp, 'world1.init')}",
        rank=0, world_size=1, timeout=datetime.timedelta(seconds=60))
    try:
        yield init_device_mesh("cpu", (1, 1),
                               mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


def block(x: np.ndarray, spec, coords: dict) -> np.ndarray:
    """The block of global ``x`` that the rank at ``coords`` ({axis:
    (index, size)}) holds under ``spec``."""
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        names = (entry,) if isinstance(entry, str) else tuple(entry)
        idx, n = 0, 1
        for a in names:
            i, s = coords[a]
            idx, n = idx * s + i, n * s
        size = x.shape[dim] // n
        x = np.take(x, range(idx * size, (idx + 1) * size), axis=dim)
    return x


# ----------------------------------------------------------------------------
# the JAX reference
# ----------------------------------------------------------------------------


def _jax_mesh(shape, names=("data", "model")):
    import jax
    from jax.sharding import Mesh

    n = int(np.prod(shape))
    kw = {}
    if hasattr(jax.sharding, "AxisType"):
        kw["axis_types"] = (jax.sharding.AxisType.Auto,) * len(shape)
    return Mesh(np.array(jax.devices()[:n]).reshape(shape), names, **kw)


def _P(spec):
    from jax.sharding import PartitionSpec as P

    return P(*spec)


def jax_sync(out: str) -> None:
    import jax
    import jax.numpy as jnp

    from repro import compat
    from repro.config import LTPConfig
    from repro.core import ltp_sync as ls

    rng = np.random.default_rng(0)
    rec = {}
    key = jax.random.PRNGKey(KEY)
    leaf_names = sorted(LEAF_SHAPES)
    g = {k: rng.normal(size=(W * s[0],) + s[1:]).astype(np.float32)
         for k, s in LEAF_SHAPES.items()}
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in LEAF_SHAPES.items()}
    for k in leaf_names:
        rec[f"in/g/{k}"] = g[k]
        rec[f"in/p/{k}"] = params[k]
    for fname, fr in FRACS.items():
        rec[f"in/frac/{fname}"] = np.asarray(fr, np.float32)
    # every worker's per-leaf uniforms, as the reference draws them
    n_pkts = [max(1, -(-int(np.prod(LEAF_SHAPES[k])) // P_FLOATS))
              for k in leaf_names]
    for w in range(W):
        kw_ = jax.random.fold_in(key, w)
        for i, n in enumerate(n_pkts):
            rec[f"u/leaf/{w}/{i}"] = np.asarray(
                jax.random.uniform(jax.random.fold_in(kw_, i), (n,)))
    pads = [n + (-n) % W for n in n_pkts]
    m0 = [rng.normal(size=(n, P_FLOATS)).astype(np.float32) * 0.1
          for n in pads]
    for i, m in enumerate(m0):
        rec[f"in/m/{i}"] = m

    mesh21 = _jax_mesh((W, 1))
    gspec = {k: _P(("data",)) for k in leaf_names}
    rep = {k: _P(()) for k in leaf_names}
    jg = {k: jnp.asarray(v) for k, v in g.items()}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    for comp in COMPS:
        ltp = LTPConfig(packet_floats=P_FLOATS, compensation=comp)

        def inner(g_, frac, k_, ltp=ltp):
            return ls.masked_psum_leafwise(g_, k_, frac, ltp, ("data",), W)

        f = jax.jit(compat.shard_map(
            inner, mesh=mesh21, in_specs=(gspec, _P(()), _P(())),
            out_specs=(rep, _P(())), axis_names={"data"}, check=True))
        for fname, fr in FRACS.items():
            synced, realized = f(jg, jnp.asarray(fr, jnp.float32), key)
            for k in leaf_names:
                rec[f"out/psum/{comp}/{fname}/{k}"] = np.asarray(synced[k])
            rec[f"out/psum/{comp}/{fname}/realized"] = np.asarray(realized)
        if comp == "expected":
            continue
        mspec = [_P(("data", None))] * len(leaf_names)

        def inner_rs(g_, p_, m_, frac, k_, ltp=ltp):
            return ls.masked_rs_update_leafwise(
                g_, p_, m_, k_, frac, ltp, ("data",), W, jnp.float32(LR))

        f = jax.jit(compat.shard_map(
            inner_rs, mesh=mesh21,
            in_specs=(gspec, rep, mspec, _P(()), _P(())),
            out_specs=(mspec, mspec, _P(())), axis_names={"data"},
            check=True))
        for fname, fr in FRACS.items():
            deltas, new_m, realized = f(jg, jp, [jnp.asarray(m) for m in m0],
                                        jnp.asarray(fr, jnp.float32), key)
            for i in range(len(leaf_names)):
                rec[f"out/rs/{comp}/{fname}/delta/{i}"] = np.asarray(deltas[i])
                rec[f"out/rs/{comp}/{fname}/m/{i}"] = np.asarray(new_m[i])
            rec[f"out/rs/{comp}/{fname}/realized"] = np.asarray(realized)

    gs = {k: rng.normal(size=s).astype(np.float32)
          for k, s in SYNC_SHAPES.items()}
    for k, v in gs.items():
        rec[f"in/gs/{k}"] = v
    for tag, nm in (("sync21", 1), ("sync22", 2)):
        mesh = _jax_mesh((W, nm))
        specs = {k: _P(s) for k, s in SYNC_SPECS.items()}
        shapes = {k: jax.ShapeDtypeStruct(v.shape, jnp.float32)
                  for k, v in gs.items()}
        for comp in COMPS:
            for ef in (False, True):
                ltp = LTPConfig(packet_floats=P_FLOATS, compensation=comp,
                                error_feedback=ef)
                sync = ls.make_ltp_sync(shapes, mesh, ltp, specs)
                if comp == "paper" and not ef:
                    for w in range(W):
                        for m in range(nm):
                            k_ = jax.random.fold_in(
                                jax.random.fold_in(key, w), m)
                            rec[f"u/{tag}/{w}/{m}"] = np.asarray(
                                jax.random.uniform(k_,
                                                   (sync.plan.n_packets,)))
                    res0 = (rng.normal(size=sync.residual_spec()[0].shape)
                            .astype(np.float32) * 0.1)
                    rec[f"in/res/{tag}"] = res0
                jgs = {k: jnp.asarray(v) for k, v in gs.items()}
                for fname, fr in FRACS.items():
                    frac = jnp.asarray(fr, jnp.float32)
                    base = f"out/{tag}/{comp}/{int(ef)}/{fname}"
                    if ef:
                        synced, new_res, stats = jax.jit(
                            lambda a, b, c, d, sync=sync: sync(a, b, c, d))(
                                jgs, frac, key,
                                jnp.asarray(rec[f"in/res/{tag}"]))
                        rec[f"{base}/res"] = np.asarray(new_res)
                    else:
                        synced, _, stats = jax.jit(
                            lambda a, b, c, sync=sync: sync(a, b, c))(
                                jgs, frac, key)
                    for k in SYNC_SHAPES:
                        rec[f"{base}/{k}"] = np.asarray(synced[k])
                    rec[f"{base}/realized"] = np.asarray(
                        stats["delivered_frac"])
    np.savez(out, **rec)


def train_cfg(get_reduced):
    return get_reduced("smollm_360m").replace(dtype="float32", n_layers=2)


def jax_train(out: str) -> None:
    import jax
    import jax.numpy as jnp

    from repro import compat
    from repro.config import LTPConfig
    from repro.configs import get_reduced
    from repro.core import ltp_sync as ls
    from repro.models import build
    from repro.optim import sgd_momentum
    from repro.train.trainer import TrainState, init_state, \
        make_ltp_train_step

    cfg = train_cfg(get_reduced)
    api, opt = build(cfg), sgd_momentum()
    state = init_state(api, opt, jax.random.PRNGKey(0))
    leaves = jax.tree.leaves(state.params)
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, cfg.vocab, (TRAIN_B, TRAIN_S)),
             "labels": rng.integers(0, cfg.vocab, (TRAIN_B, TRAIN_S))}
    batch = {k: v.astype(np.int32) for k, v in batch.items()}
    rec = {f"in/params/{i}": np.asarray(x) for i, x in enumerate(leaves)}
    rec.update({f"in/batch/{k}": v for k, v in batch.items()})
    key = jax.random.PRNGKey(3)
    ltp0 = LTPConfig()
    for w in range(W):
        kw_ = jax.random.fold_in(key, w)
        for i, x in enumerate(leaves):
            n = max(1, -(-x.size // ltp0.packet_floats))
            rec[f"u/train/{w}/{i}"] = np.asarray(
                jax.random.uniform(jax.random.fold_in(kw_, i), (n,)))
    mesh = _jax_mesh((W, 1))
    specs = {"tokens": _P(("data",)), "labels": _P(("data",))}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    frac = jnp.asarray(TRAIN_FRAC, jnp.float32)
    checked = compat.shard_map
    with compat.set_mesh(mesh):
        # The reference's step as it is (check=True), at full delivery:
        # under the vma check the gradient of a replicated param inside
        # the manual region is already psummed over the workers, so the
        # step masks the workers' SUM and applies W x the mean gradient.
        ltp = LTPConfig()
        for name in ("checked", "unchecked"):
            compat.shard_map = checked if name == "checked" else (
                lambda f, **kw: checked(f, **dict(kw, check=False)))
            step = jax.jit(make_ltp_train_step(api, opt, mesh, ltp,
                                               ("data",), specs))
            new, _ = step(state, jb, jnp.ones((W,)), key, jnp.float32(LR))
            for i, x in enumerate(jax.tree.leaves(new.params)):
                rec[f"out/{name}_full/params/{i}"] = np.asarray(x)
        # every case below runs the reference's code with the check off,
        # which keeps each worker's own gradient, as its docstring says
        for variant, comp in TRAIN_CASES:
            ltp = LTPConfig(compensation=comp)
            step = jax.jit(make_ltp_train_step(api, opt, mesh, ltp,
                                               ("data",), specs))
            st = state
            if variant == "zero":
                m_sds = ls.zero_momentum_shapes(
                    jax.eval_shape(lambda: state.params), ltp, W)
                st = TrainState(state.params, {"m_pkts": [
                    jnp.zeros(s.shape, s.dtype) for s in m_sds]}, state.step)
            new, m = step(st, jb, frac, key, jnp.float32(LR))
            base = f"out/{variant}/{comp}"
            for i, x in enumerate(jax.tree.leaves(new.params)):
                rec[f"{base}/params/{i}"] = np.asarray(x)
            if variant == "zero":
                for i, x in enumerate(new.opt_state["m_pkts"]):
                    rec[f"{base}/m/{i}"] = np.asarray(x)
            rec[f"{base}/loss"] = np.asarray(m["loss"])
            rec[f"{base}/realized"] = np.asarray(m["delivered_frac"])
    jax_plain_moe(rec)
    np.savez(out, **rec)


def moe_cfg(get_reduced):
    return get_reduced("mixtral_8x22b").replace(dtype="float32")


def tp_cfg(get_reduced, name: str):
    """A tp case's config: ``TP_MODELS``, ``TPF_MODELS``,
    ``mixtral_e3``, REDUCED mixtral with 3 experts (which 2 does not
    divide), ``mixtral_bf16``, REDUCED mixtral in its own bfloat16,
    ``mixtral_e3_bf16``, both, and ``<name>_masked``, ``name``'s."""
    if name == "mixtral_e3":
        return tp_cfg(get_reduced, "mixtral").replace(n_experts=3)
    if name == "mixtral_bf16":
        return get_reduced("mixtral_8x22b")
    if name == "mixtral_e3_bf16":
        return get_reduced("mixtral_8x22b").replace(n_experts=3)
    if name.endswith("_masked"):
        return tp_cfg(get_reduced, name[:-len("_masked")])
    arch, over = {**TP_MODELS, **TPF_MODELS}[name]
    return get_reduced(arch).replace(dtype="float32", **over)


def tp_batch(cfg, seed: int) -> dict:
    """A (TRAIN_B, TRAIN_S) global batch from a numpy seed; the VLM's
    adds patch embeddings for half the positions and M-RoPE ids, the
    enc-dec's frame embeddings; the CNN's is TRAIN_B images and
    labels."""
    rng = np.random.default_rng(seed)
    if cfg.family == "cnn":
        return {"images": rng.normal(size=(TRAIN_B, 32, 32, 3)).astype(
                    np.float32),
                "labels": rng.integers(0, cfg.vocab, (TRAIN_B,)).astype(
                    np.int32)}
    if cfg.family == "audio":
        return {"frames": (rng.normal(size=(
                    TRAIN_B, cfg.encoder_frames, cfg.d_model)) * 0.02)
                    .astype(np.float32),
                "tokens": rng.integers(0, cfg.vocab, (TRAIN_B, TRAIN_S))
                    .astype(np.int32),
                "labels": rng.integers(0, cfg.vocab, (TRAIN_B, TRAIN_S))
                    .astype(np.int32)}
    n_text = TRAIN_S - (TRAIN_S // 2 if cfg.family == "vlm" else 0)
    b = {"tokens": rng.integers(0, cfg.vocab, (TRAIN_B, n_text)),
         "labels": rng.integers(0, cfg.vocab, (TRAIN_B, TRAIN_S))}
    b = {k: v.astype(np.int32) for k, v in b.items()}
    if cfg.family == "vlm":
        b["patch_embeds"] = (rng.normal(size=(
            TRAIN_B, TRAIN_S - n_text, cfg.d_model)) * 0.02).astype(
                np.float32)
        b["positions3"] = rng.integers(0, TRAIN_S, (3, TRAIN_B, TRAIN_S)) \
            .astype(np.int32)
    return b


def masked_batch(batch: dict) -> dict:
    """``batch`` with each row's labels past its first S, S / 4, 3 S / 4
    and 0 (in turn) masked (-1): on (pod 2, data 2) each data rank of a
    worker counts a different number of label tokens, and one none."""
    labels = batch["labels"].copy()
    s = labels.shape[1]
    for i in range(labels.shape[0]):
        labels[i, (s, s // 4, 3 * s // 4, 0)[i % 4]:] = -1
    return dict(batch, labels=labels)


def nudged(x, rng) -> np.ndarray:
    """``x`` with every element moved by one unit in its last place, up
    or down at random: the init of a rounding control."""
    a = np.asarray(x)
    return np.nextafter(a, np.where(rng.random(a.shape) < 0.5, -np.inf,
                                    np.inf).astype(a.dtype))


def tp_batch_specs(batch: dict, axes=("data",)) -> dict:
    """Every batch leaf split over ``axes`` (the mesh's batch axes) on
    its batch dim."""
    e = axes[0] if len(axes) == 1 else tuple(axes)
    return {k: (None, e) if k == "positions3" else (e,) for k in batch}


def jax_plain_moe(rec: dict) -> None:
    """The reference's plain (GSPMD) step on REDUCED mixtral over the two
    devices, the batch split over ``data``: its router takes one group a
    data shard (``g_count = 2``)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding

    from repro import compat
    from repro.configs import get_reduced
    from repro.models import build
    from repro.optim import sgd_momentum
    from repro.train.trainer import init_state, make_plain_train_step

    api, opt = build(moe_cfg(get_reduced)), sgd_momentum()
    state = init_state(api, opt, jax.random.PRNGKey(0))
    rng = np.random.default_rng(2)
    batch = {k: rng.integers(0, api.cfg.vocab, (TRAIN_B, TRAIN_S))
             .astype(np.int32) for k in ("tokens", "labels")}
    for i, x in enumerate(jax.tree.leaves(state.params)):
        rec[f"in/moe_params/{i}"] = np.asarray(x)
    rec.update({f"in/moe_batch/{k}": v for k, v in batch.items()})
    mesh = _jax_mesh((W, 1))
    with compat.set_mesh(mesh):
        jb = {k: jax.device_put(jnp.asarray(v),
                                NamedSharding(mesh, _P(("data",))))
              for k, v in batch.items()}
        new, m = jax.jit(make_plain_train_step(api, opt, mesh))(
            state, jb, jnp.float32(LR))
    for i, x in enumerate(jax.tree.leaves(new.params)):
        rec[f"out/plain_moe/params/{i}"] = np.asarray(x)
    rec["out/plain_moe/loss"] = np.asarray(m["loss"])


def tp_inputs(out: str) -> str:
    """Where ``jax_tp`` writes its inputs first (``wait_for_inputs``)."""
    return out + ".in.npz"


def wait_for_inputs(started) -> str:
    """The path of the tp inputs once the JAX process has written them;
    fails if it exits first or takes past the timeout."""
    proc, out = started
    path = tp_inputs(out)
    t0 = time.monotonic()
    while not os.path.exists(path):
        if proc.poll() is not None or time.monotonic() - t0 > TIMEOUT_S:
            finish_jax(started)
            raise AssertionError(f"no tp inputs at {path}")
        time.sleep(0.2)
    return path


def jax_tp(out: str, names=tuple(TP_MODELS)) -> None:
    """The JAX step on a (data 2, model 2) mesh of 4 host devices, its
    params replicated as the reference's ``init_state`` leaves them and
    GSPMD partitioning the model over ``model``: one psum step a model
    of ``names`` and compensation, and the plain step on REDUCED
    mixtral. The inputs (params, batches, every worker's draws) go to
    ``tp_inputs(out)`` first, so the port's ranks can start while the
    steps compile."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding

    from repro import compat
    from repro.config import LTPConfig
    from repro.configs import get_reduced
    from repro.models import build
    from repro.optim import sgd_momentum
    from repro.train.trainer import init_state, make_ltp_train_step, \
        make_plain_train_step

    rec = {}
    key = jax.random.PRNGKey(TP_SEED)
    mesh = _jax_mesh(TP_MESH["tp"])
    frac = jnp.asarray(TRAIN_FRAC, jnp.float32)
    models = {}
    for name in names:
        api, opt = build(tp_cfg(get_reduced, name)), sgd_momentum()
        state = init_state(api, opt, jax.random.PRNGKey(0))
        leaves = jax.tree.leaves(state.params)
        batch = tp_batch(api.cfg, 1)
        models[name] = (api, opt, state, batch)
        for i, x in enumerate(leaves):
            rec[f"in/{name}/params/{i}"] = np.asarray(x)
        rec.update({f"in/{name}/batch/{k}": v for k, v in batch.items()})
        sizes = [max(1, -(-x.size // LTPConfig().packet_floats))
                 for x in leaves]

        @jax.jit
        def draws(k, sizes=tuple(sizes)):
            # the reference's per-worker, per-leaf draws
            return [[jax.random.uniform(jax.random.fold_in(
                jax.random.fold_in(k, w), i), (n,))
                for i, n in enumerate(sizes)] for w in range(W)]

        for w, us in enumerate(draws(key)):
            for i, u in enumerate(us):
                rec[f"u/{name}/{w}/{i}"] = np.asarray(u)
    np.savez(out + ".tmp.npz", **rec)
    os.replace(out + ".tmp.npz", tp_inputs(out))
    checked = compat.shard_map
    # the reference's code with its shard_map check off, as jax_train
    compat.shard_map = lambda f, **kw: checked(f, **dict(kw, check=False))
    try:
        for name, (api, opt, state, batch) in models.items():
            specs = {k: _P(v) for k, v in tp_batch_specs(batch).items()}
            jb = {k: jnp.asarray(v) for k, v in batch.items()}
            with compat.set_mesh(mesh):
                for comp in TP_COMPS:
                    step = jax.jit(make_ltp_train_step(
                        api, opt, mesh, LTPConfig(compensation=comp),
                        ("data",), specs))
                    new, m = step(state, jb, frac, key, jnp.float32(LR))
                    base = f"out/{name}/{comp}"
                    for i, x in enumerate(jax.tree.leaves(new.params)):
                        rec[f"{base}/params/{i}"] = np.asarray(x)
                    rec[f"{base}/loss"] = np.asarray(m["loss"])
                    rec[f"{base}/realized"] = np.asarray(m["delivered_frac"])
                if name == "mixtral":
                    sb = {k: jax.device_put(v, NamedSharding(mesh, specs[k]))
                          for k, v in jb.items()}
                    new, m = jax.jit(make_plain_train_step(api, opt, mesh))(
                        state, sb, jnp.float32(LR))
                    for i, x in enumerate(jax.tree.leaves(new.params)):
                        rec[f"out/{name}/plain/params/{i}"] = np.asarray(x)
                    rec[f"out/{name}/plain/loss"] = np.asarray(m["loss"])
    finally:
        compat.shard_map = checked
    np.savez(out, **rec)


def _f32(x) -> np.ndarray:
    """A JAX array as float32 numpy (bfloat16 exactly; npz keeps no
    bfloat16)."""
    return np.asarray(x, np.float32)


def jax_13e(out: str, names) -> None:
    """The JAX step on ``Z_MESH``'s ``z22`` (data 2, model 2: the ZeRO
    variant, the batch over ``data``) and ``pd22`` (pod 2, data 2, model
    1, ``worker_axes=("pod",)``: the batch over (pod, data), GSPMD
    splitting each worker's block over ``data``) meshes, for the models
    ``names`` of ``Z_CASES``, its ``shard_map`` check off as in
    ``jax_tp``; for ``Z_WITNESS``'s model, also its witnesses (``wit/``:
    the step on (data 2, model 1), and on (2, 2) from the ``nudged``
    init). The inputs (params as float32, batches, every worker's draws)
    go to ``tp_inputs(out)`` first."""
    import jax
    import jax.numpy as jnp

    from repro import compat
    from repro.config import LTPConfig
    from repro.configs import get_reduced
    from repro.core import ltp_sync as ls
    from repro.models import build
    from repro.optim import sgd_momentum
    from repro.train.trainer import TrainState, init_state, \
        make_ltp_train_step

    rec = {}
    key = jax.random.PRNGKey(TP_SEED)
    frac = jnp.asarray(TRAIN_FRAC, jnp.float32)
    models = {}
    for name in names:
        api, opt = build(tp_cfg(get_reduced, name)), sgd_momentum()
        state = init_state(api, opt, jax.random.PRNGKey(0))
        leaves = jax.tree.leaves(state.params)
        batch = tp_batch(api.cfg, 1)
        if name.endswith("_masked"):
            batch = masked_batch(batch)
        models[name] = (api, opt, state, batch)
        for i, x in enumerate(leaves):
            rec[f"in/{name}/params/{i}"] = _f32(x)
        rec.update({f"in/{name}/batch/{k}": v for k, v in batch.items()})
        for w in range(W):
            kw_ = jax.random.fold_in(key, w)
            for i, x in enumerate(leaves):
                n = max(1, -(-x.size // LTPConfig().packet_floats))
                rec[f"u/{name}/{w}/{i}"] = np.asarray(jax.random.uniform(
                    jax.random.fold_in(kw_, i), (n,)))
    np.savez(out + ".tmp.npz", **rec)
    os.replace(out + ".tmp.npz", tp_inputs(out))
    def run(base, mesh_of, name, variant, comp, params=None):
        shape, axes, workers = mesh_of
        mesh = _jax_mesh(shape, axes)
        dp = tuple(a for a in axes if a != "model")
        api, opt, state, batch = models[name]
        if params is not None:
            state = TrainState(params, opt.init(params), state.step)
        specs = {k: _P(v) for k, v in tp_batch_specs(batch, dp).items()}
        ltp = LTPConfig(compensation=comp)
        if variant == "zero":
            m_sds = ls.zero_momentum_shapes(
                jax.eval_shape(lambda: state.params), ltp, W)
            state = TrainState(state.params, {"m_pkts": [
                jnp.zeros(x.shape, x.dtype) for x in m_sds]}, state.step)
        with compat.set_mesh(mesh):
            step = jax.jit(make_ltp_train_step(api, opt, mesh, ltp, workers,
                                               specs))
            new, m = step(state, {k: jnp.asarray(v)
                                  for k, v in batch.items()},
                          frac, key, jnp.float32(LR))
        for i, x in enumerate(jax.tree.leaves(new.params)):
            rec[f"{base}/params/{i}"] = _f32(x)
        if variant == "zero":
            for i, x in enumerate(new.opt_state["m_pkts"]):
                rec[f"{base}/m/{i}"] = np.asarray(x)
        rec[f"{base}/loss"] = _f32(m["loss"])
        rec[f"{base}/realized"] = _f32(m["delivered_frac"])

    checked = compat.shard_map
    compat.shard_map = lambda f, **kw: checked(f, **dict(kw, check=False))
    try:
        for task in ("z22", "pd22"):
            for name, variant, comp in Z_CASES[task]:
                if name in models:
                    run(f"out/{task}/{name}/{variant}/{comp}", Z_MESH[task],
                        name, variant, comp)
        name, variant, comp = Z_WITNESS
        if name in models:
            case = f"{name}/{variant}/{comp}"
            run(f"wit/z21/{case}", ((2, 1),) + Z_MESH["z22"][1:], name,
                variant, comp)
            rng = np.random.default_rng(TP_SEED)
            run(f"wit/ctl/{case}", Z_MESH["z22"], name, variant, comp,
                jax.tree.map(lambda x: jnp.asarray(nudged(x, rng)),
                             models[name][2].params))
    finally:
        compat.shard_map = checked
    np.savez(out, **rec)


DOWN_EINSUM = "gecf,efd->gecd"   # the reference's experts_down product


def partial_rounding(hlo: str) -> dict:
    """What a compiled step's HLO does with the experts' down product
    split over ``model``: the all-reduces of its partial products, and
    of those, how many sum operands rounded to bfloat16 first. An
    all-reduce counts as rounded where its own element type is bf16, or
    where the value it sums went through bf16 (a ``convert`` to bf16
    whose result is converted back to f32) in the instruction or fusion
    that feeds it: XLA:CPU promotes a bf16 all-reduce to f32 that way.
    A down product kept in f32 reads as not rounded
    (``rounding_controls``)."""
    comps, cur = {}, None
    for line in hlo.splitlines():
        words = line.split(" ")
        head = words[1] if words[0] == "ENTRY" else words[0]
        if head.startswith("%") and line.rstrip().endswith("{"):
            cur = comps.setdefault(head[1:], [])
        elif line.startswith("}"):
            cur = None
        elif cur is not None:
            cur.append(line)

    def defs_of(lines):
        out = {}
        for line in lines:
            lhs = line.strip().removeprefix("ROOT ").split(" = ", 1)
            if len(lhs) == 2 and lhs[0].startswith("%"):
                out[lhs[0][1:]] = lhs[1]
        return out

    defs = defs_of(line for body in comps.values() for line in body)

    def round_trip(code: dict) -> bool:
        to_bf16 = [n for n, rhs in code.items()
                   if rhs.startswith("bf16[") and " convert(" in rhs]
        return any(rhs.startswith("f32[") and f" convert(%{n})" in rhs
                   for n in to_bf16 for rhs in code.values())

    reduces = [rhs for rhs in defs.values()
               if " all-reduce(" in rhs and DOWN_EINSUM in rhs]
    rounded = 0
    for rhs in reduces:
        if rhs.lstrip("(").startswith("bf16["):
            rounded += 1
            continue
        args = rhs.split(" all-reduce(", 1)[1].split(")", 1)[0]
        for arg in args.split(","):
            # the operand the down product feeds
            name = arg.strip().lstrip("%")
            src = defs.get(name, "")
            if DOWN_EINSUM not in src:
                continue
            code = {name: src}
            if "calls=%" in src:
                callee = src.split("calls=%", 1)[1].split(",", 1)[0]
                code.update(defs_of(comps.get(callee, [])))
            else:
                # an unfused convert back to f32: what it converts
                inner = src.split(" convert(%", 1)[1].split(")", 1)[0] \
                    if " convert(%" in src else ""
                code[inner] = defs.get(inner, "")
            rounded += round_trip(code)
            break
    return {"all_reduces": len(reduces), "rounded_to_bf16": rounded}


def rounding_controls() -> dict:
    """``partial_rounding`` of the experts' down einsum alone, its
    contracted dim split over ``model`` on a (data 2, model 2) mesh of
    host devices: in bfloat16 as the reference writes it (``bf16``),
    and with ``preferred_element_type=float32`` (``f32``), the partial
    products summed unrounded. Run in a JAX process."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding

    mesh = _jax_mesh((2, 2))
    h = jnp.ones((2, 3, 8, 64), jnp.bfloat16)
    w = jnp.ones((3, 64, 32), jnp.bfloat16)
    out = {}
    for label, pet in (("bf16", None), ("f32", jnp.float32)):
        f = jax.jit(lambda h, w, pet=pet: jnp.einsum(
            DOWN_EINSUM, h, w, preferred_element_type=pet),
            in_shardings=(NamedSharding(mesh, _P(("data", None, None,
                                                  "model"))),
                          NamedSharding(mesh, _P((None, "model", None)))),
            out_shardings=NamedSharding(mesh, _P(("data",))))
        out[label] = partial_rounding(f.lower(h, w).compile().as_text())
    return out


def jax_fsdp(out: str) -> None:
    """The reference's plain step (``make_plain_train_step``, jitted,
    GSPMD) on each ``FSDP_MESH`` mesh of host devices, its state placed
    by ``spec_for(..., fsdp=True)`` shardings as its dry-run lowers it,
    the batch over the mesh's batch axes, one step (SGD-momentum) from
    the init of key 0 for every model of ``FSDP_MODELS``; and
    ``FSDP_BF16`` on (2, 2) and (2, 1), its momentum too, and what its
    compiled (2, 2) step does with the experts' partial products
    (``partial_rounding``, with its ``rounding_controls``). The inputs (params as float32, batches) go to
    ``tp_inputs(out)`` first."""
    import json

    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding

    from repro import compat
    from repro.configs import get_reduced
    from repro.models import build
    from repro.models.sharding import spec_for
    from repro.optim import sgd_momentum
    from repro.train.trainer import init_state, make_plain_train_step

    rec, models = {}, {}
    for name in FSDP_MODELS + (FSDP_BF16,):
        api, opt = build(tp_cfg(get_reduced, name)), sgd_momentum()
        # jitted: papernet's eager init dispatches for ~10 s
        state = jax.jit(lambda k, api=api, opt=opt: init_state(api, opt, k))(
            jax.random.PRNGKey(0))
        batch = tp_batch(api.cfg, 1)
        models[name] = (api, opt, state, batch)
        for i, x in enumerate(jax.tree.leaves(state.params)):
            rec[f"in/{name}/params/{i}"] = _f32(x)
        rec.update({f"in/{name}/batch/{k}": v for k, v in batch.items()})
    np.savez(out + ".tmp.npz", **rec)
    os.replace(out + ".tmp.npz", tp_inputs(out))

    runs = [(task, name) for task in FSDP_MESH for name in FSDP_MODELS]
    runs += [("fsdp22", FSDP_BF16), ("fsdp21", FSDP_BF16)]
    for task, name in runs:
        shape, axes = FSDP_MESH[task]
        mesh = _jax_mesh(shape, axes)
        api, opt, state, batch = models[name]
        dp = tuple(a for a in axes if a != "model")
        with compat.set_mesh(mesh):
            placed = jax.device_put(state, jax.tree_util.tree_map_with_path(
                lambda path, x: NamedSharding(mesh, spec_for(
                    path, x.shape, mesh, fsdp=True)), state))
            jb = {k: jax.device_put(jnp.asarray(v), NamedSharding(
                mesh, _P(spec))) for (k, v), spec in zip(
                    batch.items(), tp_batch_specs(batch, dp).values())}
            step = jax.jit(make_plain_train_step(api, opt, mesh)).lower(
                placed, jb, jnp.float32(LR)).compile()
            new, m = step(placed, jb, jnp.float32(LR))
        base = f"out/{task}/{name}"
        for i, x in enumerate(jax.tree.leaves(new.params)):
            rec[f"{base}/params/{i}"] = _f32(x)
        rec[f"{base}/loss"] = _f32(m["loss"])
        if name == FSDP_BF16:
            for i, x in enumerate(jax.tree.leaves(new.opt_state["m"])):
                rec[f"{base}/mom/{i}"] = _f32(x)
            rec[f"{base}/hlo"] = np.asarray(json.dumps(
                partial_rounding(step.as_text())))
    rec["hlo_controls"] = np.asarray(json.dumps(rounding_controls()))
    np.savez(out, **rec)


# ----------------------------------------------------------------------------
# the port's ranks
# ----------------------------------------------------------------------------


def _reversed_workers(ls):
    """Plant a fault: each rank takes the worker index of its mirror."""
    real = ls.worker_index

    def wrong(mesh, axes):
        return ls.worker_count(mesh, axes) - 1 - real(mesh, axes)

    ls.worker_index = wrong


def rank_sync(z: dict, world: int) -> dict:
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.config import LTPConfig
    from repro_torch.core import ltp_sync as ls

    rec = {}
    t = torch.as_tensor
    leaf_names = sorted(LEAF_SHAPES)
    if world == W:
        mesh = init_device_mesh("cpu", (W, 1),
                                mesh_dim_names=("data", "model"))
        w = mesh.get_local_rank("data")
        g = {k: t(z[f"in/g/{k}"]).reshape((W,) + LEAF_SHAPES[k])[w]
             for k in leaf_names}
        params = {k: t(z[f"in/p/{k}"]) for k in leaf_names}
        u = [z[f"u/leaf/{w}/{i}"] for i in range(len(leaf_names))]

        def psum_case(comp, fname):
            ltp = LTPConfig(packet_floats=P_FLOATS, compensation=comp)
            return ls.masked_psum_leafwise(
                g, 0, t(z[f"in/frac/{fname}"]), ltp, mesh, ("data",), W,
                uniforms=u)

        for comp in COMPS:
            for fname in FRACS:
                synced, realized = psum_case(comp, fname)
                for k in leaf_names:
                    rec[f"psum/{comp}/{fname}/{k}"] = synced[k].numpy()
                rec[f"psum/{comp}/{fname}/realized"] = realized.numpy()
            if comp == "expected":
                continue
            ltp = LTPConfig(packet_floats=P_FLOATS, compensation=comp)
            for fname in FRACS:
                m0 = [t(z[f"in/m/{i}"]).reshape(W, -1, P_FLOATS)[w]
                      for i in range(len(leaf_names))]
                deltas, new_m, realized = ls.masked_rs_update_leafwise(
                    g, params, m0, 0, t(z[f"in/frac/{fname}"]), ltp, mesh,
                    ("data",), W, LR, uniforms=u)
                for i in range(len(leaf_names)):
                    rec[f"rs/{comp}/{fname}/delta/{i}"] = deltas[i].numpy()
                    rec[f"rs/{comp}/{fname}/m/{i}"] = new_m[i].numpy()
                    rec[f"rs/{comp}/{fname}/gathered/{i}"] = ls.all_gather(
                        deltas[i], mesh, ("data",)).numpy()
                rec[f"rs/{comp}/{fname}/realized"] = realized.numpy()
        _sync_cases(z, rec, mesh, "sync21")
        _reversed_workers(ls)
        synced, realized = psum_case("paper", "f07")
        for k in leaf_names:
            rec[f"plant/psum/paper/f07/{k}"] = synced[k].numpy()
    else:
        mesh = init_device_mesh("cpu", (W, world // W),
                                mesh_dim_names=("data", "model"))
        _sync_cases(z, rec, mesh, "sync22")
    return rec


def _sync_cases(z: dict, rec: dict, mesh, tag: str) -> None:
    import torch

    from repro_torch.config import LTPConfig
    from repro_torch.core import ltp_sync as ls

    w, m = mesh.get_local_rank("data"), mesh.get_local_rank("model")
    nm = mesh.size(1)
    coords = {"data": (w, W), "model": (m, nm)}
    shapes = {k: torch.empty(s, device="meta") for k, s in SYNC_SHAPES.items()}
    g = {k: torch.as_tensor(block(z[f"in/gs/{k}"], SYNC_SPECS[k], coords))
         for k in SYNC_SHAPES}
    res0 = torch.as_tensor(z[f"in/res/{tag}"][w:w + 1, m:m + 1])
    for comp in COMPS:
        for ef in (False, True):
            ltp = LTPConfig(packet_floats=P_FLOATS, compensation=comp,
                            error_feedback=ef)
            sync = ls.make_ltp_sync(shapes, mesh, ltp, SYNC_SPECS)
            for fname in FRACS:
                base = f"{tag}/{comp}/{int(ef)}/{fname}"
                synced, new_res, stats = sync(
                    g, torch.as_tensor(z[f"in/frac/{fname}"]), 0,
                    res0 if ef else None, uniforms=z[f"u/{tag}/{w}/{m}"])
                for k in SYNC_SHAPES:
                    rec[f"{base}/{k}"] = synced[k].numpy()
                if ef:
                    rec[f"{base}/res"] = new_res.numpy()
                rec[f"{base}/realized"] = stats["delivered_frac"].numpy()


def rank_train(z: dict, world: int) -> dict:
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.config import LTPConfig
    from repro_torch.configs import get_reduced
    from repro_torch.core import ltp_sync as ls
    from repro_torch.models import build
    from repro_torch.optim import sgd_momentum
    from repro_torch.tree import tree_leaves, tree_unflatten
    from repro_torch.train.trainer import init_state, make_ltp_train_step, \
        make_plain_train_step, zero_opt_state

    cfg = train_cfg(get_reduced)
    api, opt = build(cfg), sgd_momentum()
    template = api.init(torch.Generator().manual_seed(0), device="cpu")
    n = len(tree_leaves(template))
    params = tree_unflatten(template, [torch.as_tensor(z[f"in/params/{i}"])
                                       for i in range(n)])
    mesh = init_device_mesh("cpu", (W, 1), mesh_dim_names=("data", "model"))
    w = mesh.get_local_rank("data")
    u = [z[f"u/train/{w}/{i}"] for i in range(n)]
    batch = {k: z[f"in/batch/{k}"] for k in ("tokens", "labels")}
    specs = {"tokens": ("data",), "labels": ("data",)}
    frac = torch.as_tensor(TRAIN_FRAC, dtype=torch.float32)
    rec = {}

    def run(variant, comp, frac=frac):
        ltp = LTPConfig(compensation=comp)
        step = make_ltp_train_step(api, opt, mesh, ltp, ("data",), specs)
        st = init_state(api, opt, params=params)
        if variant == "zero":
            st.opt_state = zero_opt_state(params, ltp, mesh, ("data",))
        return step(st, batch, frac, 0, LR, uniforms=u)

    new, _ = run("psum", "paper", torch.ones(W))
    for i, x in enumerate(tree_leaves(new.params)):
        rec[f"full/params/{i}"] = x.numpy()
    for variant, comp in TRAIN_CASES:
        new, m = run(variant, comp)
        base = f"{variant}/{comp}"
        for i, x in enumerate(tree_leaves(new.params)):
            rec[f"{base}/params/{i}"] = x.numpy()
        if variant == "zero":
            for i, x in enumerate(new.opt_state["m_pkts"]):
                rec[f"{base}/m/{i}"] = x.numpy()
        rec[f"{base}/loss"] = m["loss"].numpy()
        rec[f"{base}/realized"] = m["delivered_frac"].numpy()
        rec[f"{base}/step"] = new.step.numpy()
    # the plain step on REDUCED mixtral: each rank routes its own half
    mapi = build(moe_cfg(get_reduced))
    mtemplate = mapi.init(torch.Generator().manual_seed(0), device="cpu")
    mparams = tree_unflatten(mtemplate, [
        torch.as_tensor(z[f"in/moe_params/{i}"])
        for i in range(len(tree_leaves(mtemplate)))])
    new, m = make_plain_train_step(mapi, opt, mesh)(
        init_state(mapi, opt, params=mparams),
        {k: z[f"in/moe_batch/{k}"] for k in ("tokens", "labels")}, LR)
    for i, x in enumerate(tree_leaves(new.params)):
        rec[f"plain_moe/params/{i}"] = x.numpy()
    rec["plain_moe/loss"] = m["loss"].numpy()
    _reversed_workers(ls)
    new, _ = run("psum", "paper")
    for i, x in enumerate(tree_leaves(new.params)):
        rec[f"plant/psum/paper/params/{i}"] = x.numpy()
    return rec


def tp_run(api, mesh, params, batch, comp, *, uniforms=None,
           blocks=None, variant="psum", worker_axes=("data",),
           fsdp=False, momentum=False) -> dict:
    """One step of the port on ``mesh`` from GLOBAL ``params``: the LTP
    step's ``variant`` (``psum``, or ``zero`` from ``zero_opt_state``)
    under ``comp`` over ``worker_axes``, the batch split over the mesh's
    batch axes, or the plain step (``comp == "plain"``), fractions
    ``TRAIN_FRAC``, the port's own draws from ``TP_SEED`` or
    ``uniforms``. ``blocks``: this rank's blocks to start from instead
    of its share of ``params``. Returns the gathered global params (as
    float32), the loss, the delivered fraction and, for ``zero``, this
    rank's momentum rows. ``fsdp``: the plain step with its weights
    split over ``data`` too (``init_state(..., fsdp=True)``),
    with the bytes of this rank's params (``bytes``); ``momentum``: the
    plain step's gathered momentum (``mom/``) too."""
    import torch

    from repro_torch.config import LTPConfig
    from repro_torch.models.sharding import dp_axes, gather_params
    from repro_torch.optim import sgd_momentum
    from repro_torch.tree import tree_leaves
    from repro_torch.train.trainer import init_state, make_ltp_train_step, \
        make_plain_train_step, model_layout, zero_opt_state

    opt = sgd_momentum()
    st = (init_state(api, opt, params=params, mesh=mesh, fsdp=fsdp)
          if blocks is None else init_state(api, opt, params=blocks))
    n_bytes = sum(x.numel() * x.element_size()
                  for x in tree_leaves(st.params))
    if comp == "plain":
        new, m = make_plain_train_step(api, opt, mesh)(st, batch, LR)
    else:
        ltp = LTPConfig(compensation=comp)
        if variant == "zero":
            st.opt_state = zero_opt_state(params, ltp, mesh, worker_axes)
        step = make_ltp_train_step(api, opt, mesh, ltp, worker_axes,
                                   tp_batch_specs(batch, dp_axes(mesh)))
        new, m = step(st, batch, torch.as_tensor(TRAIN_FRAC), TP_SEED, LR,
                      uniforms=uniforms)
    specs = st.fsdp.specs if st.fsdp else model_layout(api, mesh)
    full = new.params if specs is None else gather_params(new.params,
                                                          specs, mesh)
    rec = {f"params/{i}": x.float().numpy()
           for i, x in enumerate(tree_leaves(full))}
    if fsdp:
        rec["bytes"] = np.asarray(n_bytes)
    if momentum:
        mom = new.opt_state["m"]
        mom = mom if specs is None else gather_params(mom, specs, mesh)
        rec.update({f"mom/{i}": x.float().numpy()
                    for i, x in enumerate(tree_leaves(mom))})
    if variant == "zero":
        rec.update({f"m/{i}": x.numpy()
                    for i, x in enumerate(new.opt_state["m_pkts"])})
    rec["loss"] = m["loss"].float().numpy()
    if "delivered_frac" in m:
        rec["realized"] = m["delivered_frac"].numpy()
    return rec


def tp_params(api, z=None, name=None):
    """The global params: the JAX init from ``z`` (the tp task), else
    the port's init from a CPU generator seeded 0."""
    import torch

    from repro_torch.tree import tree_leaves, tree_unflatten

    template = api.init(torch.Generator().manual_seed(0), device="cpu")
    if z is None:
        return template
    return tree_unflatten(template, [
        torch.as_tensor(z[f"in/{name}/params/{i}"]).to(x.dtype)
        for i, x in enumerate(tree_leaves(template))])


def _mirrored_blocks(params, specs, mesh, leaf=None):
    """Plant a fault: each rank holds the block of its mirror on
    ``model`` (of every leaf named ``leaf``, or of every leaf)."""
    from repro_torch.models.sharding import model_dim, shard_params, \
        spec_at
    from repro_torch.tree import tree_map_with_path

    nm = mesh.size(1)
    m = nm - 1 - mesh.get_local_rank("model")
    own = shard_params(params, specs, mesh)

    def take(path, x):
        dim = model_dim(spec_at(specs, path))
        if dim is None:
            return x
        if leaf is not None and path[-1] != leaf:
            return spec_at(own, path)
        size = x.shape[dim] // nm
        return x.narrow(dim, m * size, size).clone()

    return tree_map_with_path(take, params)


def rank_tp(z: dict, world: int, task: str) -> dict:
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_reduced
    from repro_torch.models import build
    from repro_torch.models.sharding import gather_params, shard_params
    from repro_torch.tree import tree_leaves
    from repro_torch.train.trainer import model_layout

    mesh = init_device_mesh("cpu", {**TP_MESH, **TPF_MESH}[task],
                            mesh_dim_names=("data", "model"))
    w = mesh.get_local_rank("data")
    rec = {}

    def put(prefix, r):
        rec.update({f"{prefix}/{k}": v for k, v in r.items()})

    names = {"tp": TP_MODELS, "tpf": TPF_MODELS, **TP_LOCAL,
             **TPF_LOCAL}[task]
    for name in names:
        api = build(tp_cfg(get_reduced, name))
        if task in ("tp", "tpf"):
            params = tp_params(api, z, name)
            batch = {k[len(f"in/{name}/batch/"):]: v for k, v in z.items()
                     if k.startswith(f"in/{name}/batch/")}
            n = len(tree_leaves(params))
            u = [z[f"u/{name}/{w}/{i}"] for i in range(n)]
        else:
            params, batch, u = tp_params(api), tp_batch(api.cfg, 1), None
        specs = model_layout(api, mesh)
        back = gather_params(shard_params(params, specs, mesh), specs, mesh)
        rec[f"{name}/roundtrip"] = np.asarray(all(
            torch.equal(a, b) for a, b in zip(tree_leaves(back),
                                              tree_leaves(params),
                                              strict=True)))
        for comp in TP_COMPS:
            put(f"{name}/{comp}", tp_run(api, mesh, params, batch, comp,
                                         uniforms=u))
        if name.startswith("mixtral"):
            put(f"{name}/plain", tp_run(api, mesh, params, batch, "plain"))
        if name == "smollm":
            put(f"plant/{name}/paper", tp_run(
                api, mesh, params, batch, "paper", uniforms=u,
                blocks=_mirrored_blocks(params, specs, mesh)))
        if name == TPF_PLANT[0]:
            put(f"plant/{name}/paper", tp_run(
                api, mesh, params, batch, "paper", uniforms=u,
                blocks=_mirrored_blocks(params, specs, mesh, TPF_PLANT[1])))
    return rec


def rank_13e(z: dict, task: str) -> dict:
    """The ranks of ``Z_MESH[task]``: each case of ``Z_CASES[task]``
    (``tp_run``), from the JAX init and the reference's draws of this
    rank's worker (``z22``, ``pd22``) or from the port's init and draws.
    Then planted faults: on ``z22`` the ZeRO step on smollm from each
    rank's mirror's blocks on ``model`` (``plant``), and the bfloat16
    mixtral case with the attention's row-parallel partial sums rounded
    to bfloat16 before their sum (``plant_bf16``); on ``pd22`` the psum
    step on mixtral with every data rank taking its worker's whole block
    (one MoE group a worker where the reference routes two, ``plant``),
    and on the masked batch with every data rank's mean weighted alike,
    whatever its label count (``plant_mask``)."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_reduced
    from repro_torch.core import ltp_sync as ls
    from repro_torch.models import attention, build, sharding
    from repro_torch.train import trainer
    from repro_torch.train.trainer import model_layout
    from repro_torch.tree import tree_leaves

    shape, axes, workers = Z_MESH[task]
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=axes)
    w = ls.worker_index(mesh, workers)
    rec = {}

    def case(name, variant, comp, **kw):
        api = build(tp_cfg(get_reduced, name))
        if task in ("z22", "pd22"):
            params = tp_params(api, z, name)
            batch = {k[len(f"in/{name}/batch/"):]: v for k, v in z.items()
                     if k.startswith(f"in/{name}/batch/")}
            u = [z[f"u/{name}/{w}/{i}"]
                 for i in range(len(tree_leaves(params)))]
        else:
            params, batch, u = tp_params(api), tp_batch(api.cfg, 1), None
        if kw.pop("mirrored", False):
            kw["blocks"] = _mirrored_blocks(params, model_layout(api, mesh),
                                            mesh)
        return tp_run(api, mesh, params, batch, comp, uniforms=u,
                      variant=variant, worker_axes=workers, **kw)

    def planted(key, module, attr, fault, *args):
        real = getattr(module, attr)
        setattr(module, attr, fault(real))
        try:
            r = case(*args)
        finally:
            setattr(module, attr, real)
        rec.update({f"{key}/{k}": v for k, v in r.items()})

    for name, variant, comp in Z_CASES[task]:
        r = case(name, variant, comp)
        rec.update({f"{name}/{variant}/{comp}/{k}": v for k, v in r.items()})
    if task == "z22":
        r = case("smollm", "zero", "paper", mirrored=True)
        rec.update({f"plant/{k}": v for k, v in r.items()})
        planted("plant_bf16", attention, "row_parallel",
                lambda real: lambda x, w, ctx: sharding.reduce_out(x @ w,
                                                                   ctx),
                *Z_WITNESS)
    elif task == "pd22":
        planted("plant", trainer, "_restrict",
                lambda real: lambda spec, w_, inner: real(spec, w_, ()),
                "mixtral", "psum", "paper")
        planted("plant_mask", trainer, "_label_count",
                lambda real: lambda b: torch.tensor(
                    float(b["labels"].numel())),
                "mixtral_masked", "psum", "paper")
    return rec


# the collectives' unit cases (``tpcoll``, two ranks): reblock segments
# (width, split) of Mamba-1's [x | z] and Mamba-2's [z | x | B | C | dt]
COLL_SEGMENTS = {"m1": ((16, True), (16, True)),
                 "m2": ((8, True), (8, True), (4, False), (4, False),
                        (2, True))}
COLL_MIXERS = {"m1": "falcon", "m2": "zamba2"}


def coll_inputs() -> dict:
    """The ``tpcoll`` inputs from a numpy seed: ``rb`` each rank's partial
    sum, ``reblock/<k>`` a global column-parallel output, ``cols`` a
    replicated (k, C) leaf, ``mixer/<k>`` a mixer's input; the ``c``
    entries weigh each rank's output in its loss."""
    rng = np.random.default_rng(11)
    d = {"rb/x": rng.normal(size=(2, 3, 5)),
         "rb/c": rng.normal(size=(2, 3, 5)),
         "cols/w": rng.normal(size=(4, 6)),
         "cols/c": rng.normal(size=(2, 4, 3))}
    for k, seg in COLL_SEGMENTS.items():
        width = sum(w // 2 if split else w for w, split in seg)
        d[f"reblock/{k}/x"] = rng.normal(size=(3, 4, sum(w for w, _ in seg)))
        d[f"reblock/{k}/c"] = rng.normal(size=(2, 3, 4, width))
    for k in COLL_MIXERS:
        d[f"mixer/{k}/u"] = rng.normal(size=(2, 8, 256)) * 0.5
        d[f"mixer/{k}/c"] = rng.normal(size=(2, 8, 256))
    return {k: v.astype(np.float32) for k, v in d.items()}


def coll_mixer(get_reduced, k: str):
    """The config and params (a CPU generator seeded 0) of the
    ``tpcoll`` mixer ``k``: layer 0's mixer of a REDUCED SSM model."""
    import torch

    from repro_torch.models import build

    cfg = tp_cfg(get_reduced, COLL_MIXERS[k])
    params = build(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    p = params["stack"]["p0"]["mixer"]
    return cfg, {name: x[0] for name, x in p.items()}


def coll_mixer_grads(cfg, p, u, c, ctx=None, mesh=None) -> dict:
    """The grads of ``sum(mixer(u) * c)`` for the mixer's params and
    ``u``; under ``ctx`` from this rank's blocks, the sharded leaves'
    grads gathered over ``model``."""
    import torch

    from repro_torch.models import ssm
    from repro_torch.models.sharding import gather_params, model_specs, \
        shard_params

    fwd = ssm.mamba2_forward if "A_log_m2" in p else ssm.mamba1_forward
    specs = None if ctx is None else model_specs(cfg, p, mesh)
    p = p if ctx is None else shard_params(p, specs, mesh)
    p = {k: x.detach().requires_grad_() for k, x in p.items()}
    u = torch.as_tensor(u).clone().requires_grad_()
    out = fwd(cfg, p, u, ctx=ctx)
    (out * torch.as_tensor(c)).sum().backward()
    grads = {k: x.grad for k, x in p.items()}
    if ctx is not None:
        grads = gather_params(grads, specs, mesh)
    return {"out": out.detach().numpy(), "u": u.grad.numpy(),
            **{k: g.numpy() for k, g in grads.items()}}


def rank_collectives() -> dict:
    """Two ranks on (data 1, model 2): ``reduce_both`` (and
    ``reduce_out`` on the same partials), ``reblock`` on each segment
    layout, ``cols_of``, and the Mamba-1 and Mamba-2 mixers' grads at
    ``model`` = 2, then again with ``reduce_both`` planted as
    ``reduce_out``; the forward outputs and the inputs' grads."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_reduced
    from repro_torch.models import layers, ssm
    from repro_torch.models import sharding as sh

    mesh = init_device_mesh("cpu", (1, 2), mesh_dim_names=("data", "model"))
    ctx = sh.tp_ctx(mesh)
    r = ctx.index
    z = {k: torch.as_tensor(v) for k, v in coll_inputs().items()}
    rec = {}
    for name, fn in (("both", sh.reduce_both), ("out", sh.reduce_out)):
        x = z["rb/x"][r].clone().requires_grad_()
        y = fn(x, ctx)
        (y * z["rb/c"][r]).sum().backward()
        rec[f"rb/{name}/y"], rec[f"rb/{name}/grad"] = y.detach().numpy(), \
            x.grad.numpy()
    for k, seg in COLL_SEGMENTS.items():
        x = sh.block_of(z[f"reblock/{k}/x"], -1, 2, r).clone() \
            .requires_grad_()
        y = sh.reblock(x, ctx, seg)
        (y * z[f"reblock/{k}/c"][r]).sum().backward()
        rec[f"reblock/{k}/y"] = y.detach().numpy()
        rec[f"reblock/{k}/grad"] = x.grad.numpy()
    w = z["cols/w"].clone().requires_grad_()
    y = sh.cols_of(w, ctx)
    (y * z["cols/c"][r]).sum().backward()
    rec["cols/y"], rec["cols/grad"] = y.detach().numpy(), w.grad.numpy()
    for k in COLL_MIXERS:
        cfg, p = coll_mixer(get_reduced, k)
        args = (cfg, p, z[f"mixer/{k}/u"], z[f"mixer/{k}/c"])
        for tag in ("mixer", "plant"):
            if tag == "plant":   # the mixers' and the gated norm's
                ssm.reduce_both = layers.reduce_both = sh.reduce_out
            try:
                got = coll_mixer_grads(*args, ctx=ctx, mesh=mesh)
            finally:
                ssm.reduce_both = layers.reduce_both = sh.reduce_both
            rec.update({f"{tag}/{k}/{n}": v for n, v in got.items()})
    return rec


# ----------------------------------------------------------------------------
# the sharded serve path and the dry-run's counts
# ----------------------------------------------------------------------------


def serve_cfg(get_reduced, arch: str):
    return get_reduced(arch).replace(dtype="float32")


def serve_inputs(cfg, seed: int = 0) -> dict:
    """The prefill's inputs (``tokens``, and whisper's ``frames``) and
    the decode's tokens, numpy, from a seed."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (SERVE_B, SERVE_S))
           .astype(np.int32),
           "decode": rng.integers(0, cfg.vocab, (SERVE_B, SERVE_STEPS))
           .astype(np.int32)}
    if cfg.family == "audio":
        out["frames"] = (rng.normal(size=(SERVE_B, cfg.encoder_frames,
                                          cfg.d_model)) * 0.02
                         ).astype(np.float32)
    return out


def cache_code(cfg, name: str) -> str:
    """The mixer code a cache leaf of ``name`` belongs to
    (``sharding.cache_spec``)."""
    if cfg.family == "audio":
        return "X"
    if name in ("ckv", "krope"):
        return "L"
    if name in ("h", "conv"):
        return "M2" if "M2" in cfg.pattern_layers else "M"
    return "A"


def gather_cache(cfg, cache, mesh):
    """A rank's (decode or prefill) cache made global: each leaf that
    ``cache_spec`` splits gathered over ``model`` (Mamba-2's ``conv``:
    its ``x`` blocks gathered, ``B`` and ``C`` its own); numpy leaves in
    tree order, ``None`` leaves (an SSM layer's prefill) left out."""
    import torch  # noqa: F401
    from repro_torch.models.sharding import all_gather_dim, cache_segments, \
        cache_spec, model_dim
    from repro_torch.tree import tree_leaves_with_path

    nm = mesh.size(mesh.mesh_dim_names.index("model"))
    group = mesh.get_group("model")
    out = []
    for path, x in tree_leaves_with_path(cache):
        if x is None:
            continue
        name = path[-1]
        code = cache_code(cfg, name)
        dim = model_dim(cache_spec(cfg, code, name, x.dim(), nm))
        segs = cache_segments(cfg, code, name)
        if dim is not None and segs is None:
            x = all_gather_dim(x, group, nm, dim)
        elif dim is not None:
            w = segs[0][0] // nm
            x = torch.cat([all_gather_dim(x[..., :w], group, nm, dim),
                           x[..., w:]], dim=-1)
        out.append(x.numpy())
    return out


def _rows(x, di: int, nd: int, dim: int = 0):
    size = x.shape[dim] // nd
    return np.take(x, range(di * size, (di + 1) * size), axis=dim)


def rank_serve(z: dict, task: str) -> dict:
    """Each of ``SERVE_MODELS`` served on this rank's block: the params
    from ``z`` sharded over ``model``, this rank's rows of the batch over
    ``data``; the prefill's logits (whole) and its cache gathered over
    ``model``; ``SERVE_STEPS`` decode steps from ``init_cache(...,
    ctx=)`` fed ``z``'s tokens, their logits, the local cache's shapes
    and the cache gathered; and (decoder-only) the forward's logits on
    the same tokens, each sequence alone."""
    import torch

    from repro_torch.configs import get_reduced
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build
    from repro_torch.models.sharding import ShardCtx, gather, shard_params
    from repro_torch.train.trainer import model_layout
    from repro_torch.tree import tree_leaves, tree_unflatten

    nd, nm = SERVE_MESH[task]
    mesh = make_host_mesh(nd, nm)
    ctx = ShardCtx(mesh)
    di = mesh.get_local_rank("data")
    rec = {}
    for arch in SERVE_MODELS:
        cfg = serve_cfg(get_reduced, arch)
        api = build(cfg)
        shapes = api.init(None, device="meta")
        n = len(tree_leaves(shapes))
        params = tree_unflatten(shapes, [
            torch.as_tensor(z[f"{arch}/param/{i}"]) for i in range(n)])
        params = shard_params(params, model_layout(api, mesh), mesh)
        inputs = {k: torch.as_tensor(_rows(z[f"{arch}/in/{k}"], di, nd))
                  for k in ("tokens", "frames") if f"{arch}/in/{k}" in z}
        toks = torch.as_tensor(_rows(z[f"{arch}/in/decode"], di, nd))
        b = toks.shape[0]
        with torch.no_grad():
            logits, pc = api.prefill(params, inputs, ctx=ctx)
            rec[f"{arch}/prefill_logits"] = logits.numpy()
            for i, x in enumerate(gather_cache(cfg, pc, mesh)):
                rec[f"{arch}/prefill_cache/{i}"] = x
            cache = api.init_cache(b, SERVE_STEPS, torch.float32,
                                   device="cpu", ctx=ctx)
            for i, x in enumerate(tree_leaves(cache)):
                rec[f"{arch}/cache_shape/{i}"] = np.asarray(x.shape)
            out = []
            for t in range(SERVE_STEPS):
                lg, cache = api.decode_step(params, cache, toks[:, t], t,
                                            ctx=ctx)
                out.append(lg)
            rec[f"{arch}/decode_logits"] = torch.stack(out, 1).numpy()
            for i, x in enumerate(gather_cache(cfg, cache, mesh)):
                rec[f"{arch}/decode_cache/{i}"] = x
            if api.forward is not None:
                fwd = torch.cat([gather(api.forward(
                    params, {"tokens": toks[r:r + 1]}, ctx=ctx)[0], ctx, -1)
                    for r in range(b)])
                rec[f"{arch}/forward_logits"] = fwd.numpy()
    return rec


class PyCollectives:
    """The calls and input bytes of ``torch.distributed``'s
    ``all_reduce``, ``all_gather_into_tensor``, ``all_to_all_single`` and
    ``reduce_scatter_tensor`` on each axis group of a mesh, counted by
    wrapping the module's functions (as ``chip_smoke.py``'s
    ``CollectiveCounter`` counts them)."""

    INPUT_ARG = {"all_reduce": 0, "all_gather_into_tensor": 1,
                 "all_to_all_single": 1, "reduce_scatter_tensor": 1}

    def __init__(self, dist, mesh):
        self.dist = dist
        self.groups = {a: mesh.get_group(a) for a in mesh.mesh_dim_names}
        self.orig = {n: getattr(dist, n) for n in self.INPUT_ARG}
        self.counts = {}
        for name, fn in self.orig.items():
            setattr(dist, name, self._wrap(name, fn))

    def _wrap(self, name, fn):
        def counted(*args, **kw):
            for a, group in self.groups.items():
                if kw.get("group") is group:
                    t = args[self.INPUT_ARG[name]]
                    c = self.counts.setdefault(a, {}).setdefault(
                        name, {"calls": 0, "bytes": 0})
                    c["calls"] += 1
                    c["bytes"] += t.numel() * t.element_size()
            return fn(*args, **kw)
        return counted

    def close(self):
        for name, fn in self.orig.items():
            setattr(self.dist, name, fn)


def dry_batch(cfg) -> dict:
    rng = np.random.default_rng(0)
    return {k: rng.integers(0, cfg.vocab, (DRY_B, DRY_S)).astype(np.int64)
            for k in ("tokens", "labels")}


def rank_dry(task: str) -> dict:
    """One LTP step of each of ``DRY_VARIANTS`` on REDUCED ``DRY_ARCH`` at
    float32 on ``DRY_MESH[task]`` (``sync_backend="cuda"``, the gate's
    plain version on the CPU), its collectives counted by
    ``PyCollectives`` and the gate's calls (``kernels.dropfill.dropfill``,
    whose launches ``LAUNCHES`` counts on the card); as JSON."""
    import json

    import torch
    import torch.distributed as dist

    from repro_torch.config import LTPConfig
    from repro_torch.configs import get_reduced
    from repro_torch.kernels import ops as kops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build
    from repro_torch.optim import sgd_momentum
    from repro_torch.train.trainer import init_state, make_ltp_train_step, \
        zero_opt_state

    nd, nm = DRY_MESH[task]
    mesh = make_host_mesh(nd, nm)
    cfg = get_reduced(DRY_ARCH).replace(dtype="float32")
    api, ltp = build(cfg), LTPConfig(sync_backend="cuda")
    batch = {k: torch.as_tensor(v) for k, v in dry_batch(cfg).items()}
    gate = kops._df.dropfill
    calls = [0]

    def counted_gate(*a, **kw):
        calls[0] += 1
        return gate(*a, **kw)

    rec = {}
    for variant in DRY_VARIANTS:
        params = api.init(torch.Generator().manual_seed(0), device="cpu")
        opt = sgd_momentum()
        state = init_state(api, opt, params=params, mesh=mesh)
        if variant == "zero":
            state.opt_state = zero_opt_state(params, ltp, mesh, ("data",))
        step = make_ltp_train_step(api, opt, mesh, ltp, ("data",),
                                   {k: ("data",) for k in batch})
        frac = torch.full((nd,), 0.9)
        counter = PyCollectives(dist, mesh)
        kops._df.dropfill = counted_gate
        calls[0] = 0
        try:
            step(state, batch, frac, 1, 0.1)
        finally:
            counter.close()
            kops._df.dropfill = gate
        rec[variant] = {"collectives": counter.counts, "gate": calls[0]}
    return {"json": np.asarray(json.dumps(rec))}


@contextlib.contextmanager
def own_block_backward():
    """Plant a fault: the FSDP gather's backward keeps this rank's block
    of its own gradient (``sharding._Gather``'s backward), where each
    rank used the gathered leaf on its own block of the batch."""
    from repro_torch.models import sharding

    real = sharding._FsdpGather.backward

    def own(fctx, g):
        f = fctx.fsdp
        return (sharding.block_of(g, fctx.dim, f.nd, f.index).contiguous(),
                None, None)

    sharding._FsdpGather.backward = staticmethod(own)
    try:
        yield
    finally:
        sharding._FsdpGather.backward = staticmethod(real)


def rank_fsdp(z: dict, task: str) -> dict:
    """The ranks of ``FSDP_MESH[task]``: for each model of
    ``FSDP_MODELS`` (and ``FSDP_BF16`` on (2, 2) and (2, 1)), from the
    JAX init and batch, one plain step with FSDP over ``data``
    (``fsdp/``) and one without (``plain/``); the ``fsdp_specs`` blocks'
    round trip (``shard_params`` then ``gather_params``); on
    ``FSDP_PLANT``, the FSDP step with ``own_block_backward``."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_reduced
    from repro_torch.models import build
    from repro_torch.models.sharding import gather_params, shard_params
    from repro_torch.tree import tree_leaves
    from repro_torch.train.trainer import fsdp_layout

    shape, names = FSDP_MESH[task]
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
    rec = {}

    def put(prefix, r):
        rec.update({f"{prefix}/{k}": v for k, v in r.items()})

    models = FSDP_MODELS + ((FSDP_BF16,) if task in ("fsdp22", "fsdp21")
                            else ())
    for name in models:
        api = build(tp_cfg(get_reduced, name))
        params = tp_params(api, z, name)
        batch = {k[len(f"in/{name}/batch/"):]: v for k, v in z.items()
                 if k.startswith(f"in/{name}/batch/")}
        specs = fsdp_layout(api, mesh)
        back = gather_params(shard_params(params, specs, mesh), specs, mesh)
        rec[f"{name}/roundtrip"] = np.asarray(all(
            torch.equal(a, b) for a, b in zip(tree_leaves(back),
                                              tree_leaves(params),
                                              strict=True)))
        bf16 = name == FSDP_BF16
        for label, fsdp in (("fsdp", True), ("plain", False)):
            put(f"{name}/{label}", tp_run(api, mesh, params, batch, "plain",
                                          fsdp=fsdp, momentum=bf16))
        if (task, name) == FSDP_PLANT:
            with own_block_backward():
                put(f"plant/{name}/fsdp", tp_run(api, mesh, params, batch,
                                                 "plain", fsdp=True))
    return rec


def rank_main(task, rank, world, init, ref, out) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{init}", rank=int(rank),
        world_size=int(world), timeout=datetime.timedelta(seconds=120))
    try:
        z = {}
        for path in ref.split(os.pathsep):
            if os.path.exists(path):
                z.update(np.load(path))
        if task in SERVE_MESH:
            rec = rank_serve(z, task)
        elif task in DRY_MESH:
            rec = rank_dry(task)
        elif task in TP_MESH or task in TPF_MESH:
            rec = rank_tp(z, int(world), task)
        elif task in Z_MESH:
            rec = rank_13e(z, task)
        elif task in FSDP_MESH:
            rec = rank_fsdp(z, task)
        elif task == "tpcoll":
            rec = rank_collectives()
        else:
            rec = (rank_sync if task == "sync" else rank_train)(z,
                                                                int(world))
        np.savez(out, **rec)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    if sys.argv[1] == "jax" and sys.argv[2] in TPF_JAX:
        jax_tp(sys.argv[3], TPF_JAX[sys.argv[2]])
    elif sys.argv[1] == "jax" and sys.argv[2] in Z_JAX:
        jax_13e(sys.argv[3], Z_JAX[sys.argv[2]])
    elif sys.argv[1] == "jax" and sys.argv[2] == "fsdp":
        jax_fsdp(sys.argv[3])
    elif sys.argv[1] == "jax":
        {"sync": jax_sync, "train": jax_train, "tp": jax_tp}[sys.argv[2]](
            sys.argv[3])
    else:
        rank_main(*sys.argv[2:8])
