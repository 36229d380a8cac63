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
step on REDUCED mixtral-8x22b, whose router groups by data shard). Each
rank task
ends with a planted fault: the same case with the rank-to-worker mapping
reversed, which the tests require to disagree with the reference.

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


def env() -> dict:
    return dict(os.environ, PYTHONPATH=SRC + os.pathsep
                + os.environ.get("PYTHONPATH", ""), JAX_PLATFORMS="cpu",
                XLA_FLAGS="--xla_force_host_platform_device_count=4",
                OMP_NUM_THREADS="1")


def run_jax(task: str, out: str) -> dict:
    """The JAX reference of ``task`` in a subprocess; its npz as a dict."""
    proc = subprocess.run([sys.executable, __file__, "jax", task, out],
                          env=env(), capture_output=True, text=True,
                          timeout=TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return dict(np.load(out))


def run_ranks(task: str, world: int, ref: str, tmp: str) -> list:
    """``world`` gloo ranks of the port on ``task``; each rank's npz as a
    dict, in rank order. A rank that hangs fails the run at the
    timeout, and every rank is killed."""
    init = os.path.join(tmp, f"{task}{world}.init")
    outs = [os.path.join(tmp, f"{task}{world}_rank{r}.npz")
            for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, __file__, "rank", task, str(r), str(world), init,
         ref, outs[r]], env=env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(world)]
    errs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=TIMEOUT_S)
            errs.append(err)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r}: {errs[r][-4000:]}"
    return [dict(np.load(o)) for o in outs]


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


def _jax_mesh(shape):
    import jax
    from jax.sharding import Mesh

    n = int(np.prod(shape))
    kw = {}
    if hasattr(jax.sharding, "AxisType"):
        kw["axis_types"] = (jax.sharding.AxisType.Auto,) * len(shape)
    return Mesh(np.array(jax.devices()[:n]).reshape(shape),
                ("data", "model"), **kw)


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


def rank_main(task, rank, world, init, ref, out) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{init}", rank=int(rank),
        world_size=int(world), timeout=datetime.timedelta(seconds=120))
    try:
        z = dict(np.load(ref))
        rec = (rank_sync if task == "sync" else rank_train)(z, int(world))
        np.savez(out, **rec)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    if sys.argv[1] == "jax":
        {"sync": jax_sync, "train": jax_train}[sys.argv[2]](sys.argv[3])
    else:
        rank_main(*sys.argv[2:8])
