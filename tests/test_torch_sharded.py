"""The sharded LTP path: the port's specs, local plans and sharded sync
against the JAX package, on the CPU.

- Specs and local plans of every config at full size, on meshes (1, 1),
  (2, 2), (16, 16) and (2, 16, 16) given as shapes: equal exactly (JAX's
  side over ``AbstractMesh`` and ``eval_shape``).
- World size 1, in this process (a gloo group of one rank against a
  (1, 1) JAX mesh): ``masked_psum_leafwise``,
  ``masked_rs_update_leafwise`` and ``LTPSync`` under paper, count and
  expected compensation, with and without error feedback, at delivered
  fractions 1.0 and 0.7, fed the reference's uniforms through
  ``uniforms=``; and the reference's own unit checks mirrored.
- Several ranks: 2 gloo processes on (data 2, model 1) and 4 on (data 2,
  model 2) against the JAX functions under ``shard_map`` on 4 host
  devices (``sharded_cases.py``), and a planted fault, the rank-to-worker
  mapping reversed, which must disagree.

Tolerances: synced gradients, deltas and momentum rtol 1e-6 / atol 1e-7
(the same float32 ops; a sum of two workers is the same in either
order); the delivered fraction exactly.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as P

import sharded_cases as sc
from repro import compat
from repro.config import LTPConfig as JLTPConfig
from repro.configs import get_config as jget_config
from repro.core import ltp_sync as jls
from repro.core import packets as jpk
from repro.models import build as jbuild
from repro.models import sharding as jsh
from repro_torch.config import LTPConfig
from repro_torch.configs import ARCH_IDS
from repro_torch.core import ltp_sync as ls
from repro_torch.core import packets as pk
from repro_torch.launch import mesh as lmesh
from repro_torch.models import sharding as sh

MESHES = {"1x1": (1, 1), "2x2": (2, 2), "16x16": (16, 16),
          "2x16x16": (2, 16, 16)}
RTOL, ATOL = 1e-6, 1e-7


def _names(shape):
    return ("data", "model") if len(shape) == 2 else ("pod", "data", "model")


def _jax_path(path):
    return tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)


@functools.lru_cache(maxsize=None)
def _full_shapes(arch):
    """(path, shape) of every leaf of ``arch``'s full config, from JAX's
    ``eval_shape``."""
    tree = jax.eval_shape(jbuild(jget_config(arch)).init,
                          jax.random.PRNGKey(0))
    return tuple((_jax_path(p), tuple(x.shape)) for p, x in
                 jax.tree_util.tree_flatten_with_path(tree)[0]), tree


def _port_tree(arch):
    """The port's view of the same tree: nested dicts/lists of meta
    tensors with JAX's shapes."""
    _, tree = _full_shapes(arch)
    return jax.tree.map(lambda s: torch.empty(s.shape, device="meta"), tree)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_jax(arch, mesh):
    shape = MESHES[mesh]
    jmesh = AbstractMesh(shape, _names(shape))
    tmesh = dict(zip(_names(shape), shape))
    leaves, tree = _full_shapes(arch)
    jspecs = [tuple(s) for s in jax.tree.leaves(
        jsh.param_specs(tree, jmesh), is_leaf=lambda x: isinstance(x, P))]
    tspecs = sh.param_specs(_port_tree(arch), tmesh)
    got = [sh.spec_at(tspecs, path) for path, _ in leaves]
    assert got == jspecs
    # the LTP-in-shard_map form (fsdp off) leaf by leaf
    for (path, shp), jp in zip(leaves, jax.tree_util.tree_flatten_with_path(
            tree)[0]):
        assert sh.spec_for(path, shp, tmesh, fsdp=False) == tuple(
            jsh.spec_for(jp[0], shp, jmesh, fsdp=False))
    assert sh.dp_axes(tmesh) == jsh.dp_axes(jmesh)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_local_plan_matches_jax(arch, mesh):
    shape = MESHES[mesh]
    jmesh = AbstractMesh(shape, _names(shape))
    tmesh = dict(zip(_names(shape), shape))
    leaves, tree = _full_shapes(arch)
    jspecs = jsh.param_specs(tree, jmesh)
    tspecs = sh.param_specs(_port_tree(arch), tmesh)
    for (path, shp), js in zip(leaves, jax.tree.leaves(
            jspecs, is_leaf=lambda x: isinstance(x, P))):
        assert pk.local_shape(shp, sh.spec_at(tspecs, path), tmesh) == \
            jpk.local_shape(shp, js, jmesh)
    jplan = jpk.local_plan(tree, jspecs, jmesh)
    plan = pk.local_plan(_port_tree(arch), tspecs, tmesh)
    for f in ("packet_floats", "n_floats", "n_packets", "leaf_shapes",
              "leaf_offsets", "n_critical"):
        assert getattr(plan, f) == getattr(jplan, f), f
    # np.array_equal: assert_array_equal takes ~10 s at 6.6e8 packets
    assert np.array_equal(plan.critical, jplan.critical)


def test_production_mesh_shapes():
    assert lmesh.production_mesh_shape() == {"data": 16, "model": 16}
    assert lmesh.production_mesh_shape(multi_pod=True) == {
        "pod": 2, "data": 16, "model": 16}
    assert sh.dp_axes(lmesh.production_mesh_shape(multi_pod=True)) == (
        "pod", "data")
    with pytest.raises(RuntimeError, match="process group"):
        lmesh.make_production_mesh()


# ----------------------------------------------------------------------------
# world size 1, in this process
# ----------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mesh1(tmp_path_factory):
    with sc.world_of_one(str(tmp_path_factory.mktemp("world1"))) as mesh:
        yield mesh


@pytest.fixture(scope="module")
def jmesh1():
    return compat.make_mesh((1, 1), ("data", "model"))


def _grads():
    rng = np.random.default_rng(3)
    return {"b": rng.normal(size=(20,)).astype(np.float32),
            "v": rng.normal(size=(3, 5, 7)).astype(np.float32),
            "w": rng.normal(size=(16, 24)).astype(np.float32)}


def _t(tree):
    return {k: torch.as_tensor(v) for k, v in tree.items()}


def _leaf_uniforms(key, grads, p, widx=0):
    k = jax.random.fold_in(key, widx)
    return [np.asarray(jax.random.uniform(
        jax.random.fold_in(k, i), (max(1, -(-x.size // p)),)))
        for i, x in enumerate(jax.tree.leaves(grads))]


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


def test_world_of_one_mesh(mesh1):
    assert sh.mesh_shape(mesh1) == {"data": 1, "model": 1}
    assert ls.worker_index(mesh1, ("data",)) == 0
    t = torch.arange(6.0).reshape(3, 2)
    assert torch.equal(ls.psum(t.clone(), mesh1, ("data",)), t)
    assert torch.equal(ls.all_gather(ls.psum_scatter(t, mesh1, ("data",)),
                                     mesh1, ("data",)), t)


def test_leafwise_masks_match_jax():
    """Packet structure (the reference's unit check) and the masks
    themselves, from the reference's uniforms."""
    grads = {"b": np.ones((5,), np.float32), "w": np.ones((10, 7), np.float32)}
    key = jax.random.PRNGKey(0)
    jmasks, jpkt = jls.leafwise_packet_masks(
        jax.tree.map(jnp.asarray, grads), key, 0.5, JLTPConfig(packet_floats=8))
    masks, pkt = ls.leafwise_packet_masks(
        _t(grads), 0, 0.5, LTPConfig(packet_floats=8),
        uniforms=[np.asarray(jax.random.uniform(jax.random.fold_in(key, i),
                                                (m.shape[0],)))
                  for i, m in enumerate(jpkt)])
    for k in grads:
        np.testing.assert_array_equal(masks[k].numpy(), np.asarray(jmasks[k]))
    for a, b in zip(pkt, jpkt):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    flat = masks["w"].numpy().ravel()
    for p in range(len(flat) // 8):
        seg = flat[p * 8:(p + 1) * 8]
        assert np.all(seg == seg[0])
    assert flat[0] == 1.0 and flat[-1] == 1.0
    assert masks["b"].numpy().all()


def test_device_uniforms_follow_their_seed():
    a = ls.device_uniforms(1000, "cpu", 7, 0, 0, 1)
    assert torch.equal(a, ls.device_uniforms(1000, "cpu", 7, 0, 0, 1))
    assert not torch.equal(a, ls.device_uniforms(1000, "cpu", 7, 1, 0, 1))
    assert not torch.equal(a, ls.device_uniforms(1000, "cpu", 8, 0, 0, 1))
    assert 0.0 <= float(a.min()) and float(a.max()) < 1.0


@functools.lru_cache(maxsize=None)
def _jax_psum_fn(comp):
    mesh = compat.make_mesh((1, 1), ("data", "model"))
    ltp = JLTPConfig(packet_floats=8, compensation=comp)
    rep = {k: P() for k in ("b", "v", "w")}
    return jax.jit(compat.shard_map(
        lambda g, f, k: jls.masked_psum_leafwise(g, k, f, ltp, ("data",), 1),
        mesh=mesh, in_specs=(rep, P(), P()), out_specs=(rep, P()),
        axis_names={"data"}, check=True))


@pytest.mark.parametrize("backend", ["python", "cuda"])
@pytest.mark.parametrize("frac", [1.0, 0.7])
@pytest.mark.parametrize("comp", ["paper", "count", "expected"])
def test_masked_psum_leafwise_matches_jax(mesh1, comp, frac, backend):
    grads, key = _grads(), jax.random.PRNGKey(1)
    jout, jreal = _jax_psum_fn(comp)(jax.tree.map(jnp.asarray, grads),
                                     jnp.full((1,), frac), key)
    out, real = ls.masked_psum_leafwise(
        _t(grads), 0, torch.full((1,), frac), LTPConfig(
            packet_floats=8, compensation=comp, sync_backend=backend),
        mesh1, ("data",), 1, uniforms=_leaf_uniforms(key, grads, 8))
    for k in grads:
        _close(out[k], jout[k])
    assert float(real) == float(jreal)


def test_leafwise_sync_full_delivery_identity(mesh1):
    grads = _grads()
    out, realized = ls.masked_psum_leafwise(
        _t(grads), 3, torch.ones(1), LTPConfig(packet_floats=8), mesh1,
        ("data",), 1)
    for k in grads:
        np.testing.assert_allclose(out[k].numpy(), grads[k], rtol=1e-6)
    assert float(realized) == 1.0


@functools.lru_cache(maxsize=None)
def _jax_rs_fn(comp):
    mesh = compat.make_mesh((1, 1), ("data", "model"))
    ltp = JLTPConfig(packet_floats=8, compensation=comp)
    rep = {k: P() for k in ("b", "v", "w")}
    ms = [P("data", None)] * 3
    return jax.jit(compat.shard_map(
        lambda g, p, m, f, k: jls.masked_rs_update_leafwise(
            g, p, m, k, f, ltp, ("data",), 1, jnp.float32(0.1)),
        mesh=mesh, in_specs=(rep, rep, ms, P(), P()),
        out_specs=(ms, ms, P()), axis_names={"data"}, check=True))


@pytest.mark.parametrize("frac", [1.0, 0.7])
@pytest.mark.parametrize("comp", ["paper", "count"])
def test_masked_rs_update_leafwise_matches_jax(mesh1, comp, frac):
    grads, key = _grads(), jax.random.PRNGKey(2)
    rng = np.random.default_rng(4)
    params = {k: rng.normal(size=v.shape).astype(np.float32)
              for k, v in grads.items()}
    ltp = LTPConfig(packet_floats=8, compensation=comp)
    m0 = [rng.normal(size=s).astype(np.float32) * 0.1
          for s in ls.zero_momentum_shapes(_t(grads), ltp, 1)]
    jd, jm, jreal = _jax_rs_fn(comp)(
        jax.tree.map(jnp.asarray, grads), jax.tree.map(jnp.asarray, params),
        [jnp.asarray(m) for m in m0], jnp.full((1,), frac), key)
    d, m, real = ls.masked_rs_update_leafwise(
        _t(grads), _t(params), [torch.as_tensor(x) for x in m0], 0,
        torch.full((1,), frac), ltp, mesh1, ("data",), 1, 0.1,
        uniforms=_leaf_uniforms(key, grads, 8))
    for a, b in zip(d + m, list(jd) + list(jm)):
        _close(a, b)
    assert float(real) == float(jreal)


def test_zero_momentum_shapes_match_jax():
    grads = _grads()
    for w in (1, 2, 3):
        want = jls.zero_momentum_shapes(
            jax.tree.map(jnp.asarray, grads), JLTPConfig(packet_floats=8), w)
        assert ls.zero_momentum_shapes(_t(grads), LTPConfig(packet_floats=8),
                                       w) == [tuple(s.shape) for s in want]


def _sync_pair(jmesh, mesh, comp, ef, backend="auto"):
    grads = _grads()
    jshapes = {k: jax.ShapeDtypeStruct(v.shape, jnp.float32)
               for k, v in grads.items()}
    jspecs = {k: P() for k in grads}
    jltp = JLTPConfig(packet_floats=8, compensation=comp, error_feedback=ef)
    ltp = LTPConfig(packet_floats=8, compensation=comp, error_feedback=ef,
                    sync_backend=backend)
    tshapes = {k: torch.empty(v.shape, device="meta")
               for k, v in grads.items()}
    return (grads, jls.make_ltp_sync(jshapes, jmesh, jltp, jspecs),
            ls.make_ltp_sync(tshapes, mesh, ltp, {k: () for k in grads}))


@pytest.mark.parametrize("frac", [1.0, 0.7])
@pytest.mark.parametrize("ef", [False, True])
@pytest.mark.parametrize("comp", ["paper", "count", "expected"])
def test_ltp_sync_matches_jax(mesh1, jmesh1, comp, ef, frac):
    grads, jsync, sync = _sync_pair(jmesh1, mesh1, comp, ef)
    key = jax.random.PRNGKey(4)
    u = np.asarray(jax.random.uniform(
        jax.random.fold_in(jax.random.fold_in(key, 0), 0),
        (jsync.plan.n_packets,)))
    res = None
    if ef:
        res = (np.random.default_rng(5).normal(
            size=jsync.residual_spec()[0].shape) * 0.1).astype(np.float32)
    jg = jax.tree.map(jnp.asarray, grads)
    if ef:
        jout, jres, jst = jax.jit(lambda g, f, k, r: jsync(g, f, k, r))(
            jg, jnp.full((1,), frac), key, jnp.asarray(res))
    else:
        jout, jres, jst = jax.jit(lambda g, f, k: jsync(g, f, k))(
            jg, jnp.full((1,), frac), key)
    out, new_res, st = sync(_t(grads), torch.full((1,), frac), 0,
                            None if res is None else torch.as_tensor(res),
                            uniforms=u)
    for k in grads:
        _close(out[k], jout[k])
    if ef:
        _close(new_res, jres)
    else:
        assert new_res is None and jres is None
    assert float(st["delivered_frac"]) == float(jst["delivered_frac"])
    assert sync.residual_spec() == (tuple(jsync.residual_spec()[0].shape),
                                    tuple(jsync.residual_spec()[1]))


def test_full_delivery_is_identity(mesh1, jmesh1):
    grads, _, sync = _sync_pair(jmesh1, mesh1, "paper", False)
    out, _, stats = sync(_t(grads), torch.ones(1), 0)
    for k in grads:
        np.testing.assert_allclose(out[k].numpy(), grads[k], rtol=1e-6)
    assert float(stats["delivered_frac"]) == 1.0


def test_zero_delivery_keeps_critical_only(mesh1, jmesh1):
    grads, _, sync = _sync_pair(jmesh1, mesh1, "paper", False)
    out, _, _ = sync(_t(grads), torch.zeros(1), 0)
    flat_in = pk.flatten(sync.plan, _t(grads)).numpy()
    flat_out = pk.flatten(sync.plan, out).numpy()
    crit = sync.plan.critical
    np.testing.assert_allclose(flat_out[crit], flat_in[crit], rtol=1e-6)
    assert np.all(flat_out[~crit] == 0)


def test_error_feedback_conserves_gradient(mesh1, jmesh1):
    """sent + residual == grads (+ the previous residual) exactly."""
    grads, _, sync = _sync_pair(jmesh1, mesh1, "paper", True)
    res0 = sync.init_residual("cpu")
    assert tuple(res0.shape) == (1, 1, sync.plan.n_packets, 8)
    out, res1, _ = sync(_t(grads), torch.full((1,), 0.5), 3, res0)
    flat_in = pk.flatten(sync.plan, _t(grads)).numpy()
    flat_out = pk.flatten(sync.plan, out).numpy()
    np.testing.assert_allclose(flat_out + res1.numpy()[0, 0], flat_in,
                               rtol=1e-6, atol=1e-7)
    assert 0.0 < float((res1 != 0).any(dim=-1).float().mean()) < 1.0


@pytest.mark.parametrize("comp", ["paper", "count"])
def test_ltp_sync_backends_agree(mesh1, jmesh1, comp):
    """The sync through the kernels' wrappers (their plain versions for
    CPU tensors) and through the python backend."""
    outs = {}
    for be in ("python", "cuda"):
        grads, _, sync = _sync_pair(jmesh1, mesh1, comp, False, be)
        outs[be], _, stats = sync(_t(grads), torch.full((1,), 0.5), 0)
        assert 0.0 < float(stats["delivered_frac"]) <= 1.0
    for k in outs["python"]:
        assert torch.equal(outs["python"][k], outs["cuda"][k])


# ----------------------------------------------------------------------------
# several ranks: gloo processes against the JAX functions on host devices
# ----------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("sharded_sync"))
    path = f"{d}/ref.npz"
    return path, sc.run_jax("sync", path), d


@pytest.fixture(scope="module")
def ranks2(ref):
    path, _, d = ref
    return sc.run_ranks("sync", 2, path, d)


@pytest.fixture(scope="module")
def ranks4(ref):
    path, _, d = ref
    return sc.run_ranks("sync", 4, path, d)


def _assert_real(got, want):
    assert float(got) == float(want)


@pytest.mark.parametrize("fname", list(sc.FRACS))
@pytest.mark.parametrize("comp", sc.COMPS)
def test_two_ranks_masked_psum_leafwise(ref, ranks2, comp, fname):
    z = ref[1]
    for r in ranks2:
        for k in sc.LEAF_SHAPES:
            _close(r[f"psum/{comp}/{fname}/{k}"],
                   z[f"out/psum/{comp}/{fname}/{k}"])
        _assert_real(r[f"psum/{comp}/{fname}/realized"],
                     z[f"out/psum/{comp}/{fname}/realized"])


@pytest.mark.parametrize("fname", list(sc.FRACS))
@pytest.mark.parametrize("comp", ["paper", "count"])
def test_two_ranks_masked_rs_update_leafwise(ref, ranks2, comp, fname):
    z = ref[1]
    for w, r in enumerate(ranks2):
        for i in range(len(sc.LEAF_SHAPES)):
            for part in ("delta", "m"):
                want = z[f"out/rs/{comp}/{fname}/{part}/{i}"]
                _close(r[f"rs/{comp}/{fname}/{part}/{i}"],
                       want.reshape(sc.W, -1, sc.P_FLOATS)[w])
            # every rank's delta shard, gathered back in worker order
            _close(r[f"rs/{comp}/{fname}/gathered/{i}"],
                   z[f"out/rs/{comp}/{fname}/delta/{i}"])
        _assert_real(r[f"rs/{comp}/{fname}/realized"],
                     z[f"out/rs/{comp}/{fname}/realized"])


def _own_realized(z, tag, m, fname, nm):
    """The worker mean of the delivered share of model shard ``m``'s
    masks, from the reference's draws."""
    plan = pk.local_plan(
        {k: torch.empty(s, device="meta") for k, s in sc.SYNC_SHAPES.items()},
        sc.SYNC_SPECS, {"data": sc.W, "model": nm}, packet_floats=sc.P_FLOATS)
    crit = torch.as_tensor(plan.critical)
    frac = torch.as_tensor(z[f"in/frac/{fname}"])
    means = [torch.where(crit, 1.0, (torch.as_tensor(
        z[f"u/{tag}/{w}/{m}"]) < frac[w]).float()).mean()
        for w in range(sc.W)]
    return (means[0] + means[1]) / sc.W


def _check_sync_ranks(z, ranks, tag, comp, ef, fname, nm):
    """Each rank's block against the reference's global output. With a
    model axis, a leaf replicated over it and the realized fraction are
    each model shard's own (each masks its own copy); the reference's
    ``P()`` out_spec keeps model shard 0's: those are compared at model
    coordinate 0, and elsewhere the fraction against the shard's own
    masks."""
    base = f"{tag}/{comp}/{int(ef)}/{fname}"
    for rank, r in enumerate(ranks):
        w, m = divmod(rank, nm)
        coords = {"data": (w, sc.W), "model": (m, nm)}
        for k in sc.SYNC_SHAPES:
            if m == 0 or "model" in sc.SYNC_SPECS[k]:
                _close(r[f"{base}/{k}"], sc.block(z[f"out/{base}/{k}"],
                                                  sc.SYNC_SPECS[k], coords))
        if ef:
            _close(r[f"{base}/res"], z[f"out/{base}/res"][w:w + 1, m:m + 1])
        if m == 0:
            _assert_real(r[f"{base}/realized"], z[f"out/{base}/realized"])
        else:
            _assert_real(r[f"{base}/realized"],
                         _own_realized(z, tag, m, fname, nm))


@pytest.mark.parametrize("fname", list(sc.FRACS))
@pytest.mark.parametrize("ef", [False, True])
@pytest.mark.parametrize("comp", sc.COMPS)
def test_two_ranks_ltp_sync(ref, ranks2, comp, ef, fname):
    _check_sync_ranks(ref[1], ranks2, "sync21", comp, ef, fname, 1)


@pytest.mark.parametrize("fname", list(sc.FRACS))
@pytest.mark.parametrize("ef", [False, True])
@pytest.mark.parametrize("comp", sc.COMPS)
def test_four_ranks_ltp_sync_over_a_model_axis(ref, ranks4, comp, ef, fname):
    """(data 2, model 2): each rank syncs its model block over its data
    group, with the model coordinate in its draws."""
    _check_sync_ranks(ref[1], ranks4, "sync22", comp, ef, fname, 2)


def test_wrong_rank_to_worker_mapping_fails(ref, ranks2):
    """A planted fault: the ranks run the paper case at fractions (0.7,
    0.9) with their worker indices swapped; the comparison that holds
    for the right mapping must fail."""
    z = ref[1]
    with pytest.raises(AssertionError):
        for r in ranks2:
            for k in sc.LEAF_SHAPES:
                _close(r[f"plant/psum/paper/f07/{k}"],
                       z[f"out/psum/paper/f07/{k}"])
