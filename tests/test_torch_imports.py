"""The PyTorch port stands alone: it imports with JAX blocked, no file of
it (nor chip_smoke.py) imports ``jax``, ``repro`` or ``benchmarks``, and
nothing falls back to the CPU unless the caller asked for it."""
import ast
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.config import (
    LTPConfig,
    NetConfig,
    NetFaultConfig,
    TrainConfig,
)
from repro_torch.configs import get_config, get_reduced
from repro_torch.convert import params_from_numpy
from repro_torch.core import ltp_sync as ls
from repro_torch.device import resolve_device
from repro_torch.kernels import _build
from repro_torch.kernels import dropfill as df_mod
from repro_torch.kernels import ops
from repro_torch.kernels import packet_reduce as pr_mod
from repro_torch.kernels import randomk as rk_mod
from repro_torch.models import build
from repro_torch.models.api import demo_inputs
from repro_torch.optim import make_optimizer
from repro_torch.runtime import BudgetController, ClusterRuntime
from repro_torch.shapes import InputShape
from repro_torch.train import PSTrainer, serve, train_lm

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
PORT = os.path.join(ROOT, "src", "repro_torch")
FORBIDDEN = ("jax", "jaxlib", "repro", "benchmarks")


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(PORT):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def test_port_imports_with_jax_blocked():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        sys.modules["jax"] = None      # any `import jax` now raises
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(
            repro_torch.__path__, "repro_torch.")]
        for name in names:
            importlib.import_module(name)
        leaked = sorted(k for k in sys.modules
                        if k == "repro" or k.startswith("repro."))
        assert not leaked, leaked
        print(len(names))
    """)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 56


# the packet-level simulator, the DES transport, the fault plane, the
# budget controller, the Fig 13 and des16 drivers and the port's linter
SIM_MODULES = (
    "repro_torch.net",
    "repro_torch.net.genfence",
    "repro_torch.net.senders",
    "repro_torch.net.ltp_receiver",
    "repro_torch.net.aggtree",
    "repro_torch.net.scenarios",
    "repro_torch.runtime.transport",
    "repro_torch.net.netfaults",
    "repro_torch.runtime.budget",
    "repro_torch.train.tta",
    "repro_torch.train.netfault",
    "repro_torch.devtools.replint",
    "repro_torch.devtools.replint.core",
    "repro_torch.devtools.replint.rules",
    "repro_torch.devtools.replint.__main__",
)


# the sharded LTP path: specs, the train steps, the meshes, the launcher
SHARDED_MODULES = (
    "repro_torch.models.sharding",
    "repro_torch.train.trainer",
    "repro_torch.launch.mesh",
    "repro_torch.launch.train",
)


@pytest.mark.parametrize("module", SIM_MODULES + SHARDED_MODULES)
def test_simulator_modules_import_with_jax_blocked(module):
    """Each module imports on its own, in a fresh interpreter with
    ``jax`` and ``repro`` blocked, and pulls in neither."""
    code = textwrap.dedent(f"""
        import importlib, sys
        sys.modules["jax"] = None
        sys.modules["repro"] = None
        importlib.import_module({module!r})
        leaked = sorted(k for k in sys.modules
                        if k.startswith(("jax.", "repro.")))
        assert not leaked, leaked
    """)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_replint_cli_runs_with_jax_blocked():
    code = textwrap.dedent("""
        import runpy, sys
        sys.modules["jax"] = None
        sys.modules["repro"] = None
        sys.argv = ["replint", "--list-rules"]
        runpy.run_module("repro_torch.devtools.replint", run_name="__main__")
    """)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "gen-fence" in proc.stdout


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_repro_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, \
                f"{path}:{node.lineno} imports {name}"


def test_default_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    api = build(get_config("papernet").replace(d_model=8, n_layers=3))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.init(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_numpy({"w": np.zeros(3, np.float32)})


def test_pstrainer_without_device_and_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("papernet").replace(d_model=8, n_layers=3)
    tc = TrainConfig(batch=8, steps=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PSTrainer(build(cfg), make_optimizer(tc), tc, LTPConfig(),
                  NetConfig(), n_workers=2)


def test_lm_entry_points_without_device_and_gpu_raise(monkeypatch):
    """The transformer's init and cache, its demo inputs, ``train_lm``
    and ``serve`` run on the card unless given ``device="cpu"``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_reduced("smollm_360m").replace(dtype="float32")
    api = build(cfg)
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.init(gen)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.init_cache(2, 8, torch.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        demo_inputs(cfg, InputShape("t", 8, 2, "train"), gen)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_lm(tiny=True, steps=1, workers=2, batch=2, seq=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve(batch=1, prompt_len=2, new=2)


def test_sharded_entry_points_without_device_and_gpu_raise(monkeypatch):
    """The sharded path's state, its residual and its launcher run on the
    card unless told otherwise."""
    from repro_torch.core.packets import make_plan
    from repro_torch.launch.train import init_distributed
    from repro_torch.optim import sgd_momentum
    from repro_torch.train.trainer import init_state

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    api = build(get_config("papernet").replace(d_model=8, n_layers=3))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_state(api, sgd_momentum())
    sync = ls.LTPSync(mesh={"data": 1}, plan=make_plan({"w": torch.ones(4)}),
                      ltp=LTPConfig(error_feedback=True), grad_specs={},
                      n_workers=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sync.init_residual()
    with pytest.raises(RuntimeError, match="--device cpu"):
        init_distributed()


def test_cluster_runtime_without_device_and_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("papernet").replace(d_model=8, n_layers=3)
    tc = TrainConfig(batch=8, steps=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ClusterRuntime(build(cfg), make_optimizer(tc), tc, LTPConfig(),
                       NetConfig(), n_workers=2)


def test_kernel_loader_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(_build, "_LIB", None)
    with pytest.raises(RuntimeError, match="CUDA device"):
        _build.load()


def test_wrappers_never_fall_back_off_the_cpu():
    """A tensor that is neither on the CPU nor on a CUDA device is refused;
    the plain version serves CPU tensors only."""
    x = torch.empty((4, 8, 16), device="meta")
    m = torch.empty((4, 8), device="meta")
    with pytest.raises(ValueError, match="CUDA device or on the CPU"):
        ops.ltp_packet_reduce(x, m)
    with pytest.raises(ValueError, match="CUDA device or on the CPU"):
        ops.ltp_dropfill(x[0], m[0])
    with pytest.raises(ValueError, match="CUDA device or on the CPU"):
        ops.randomk_sparsify(x, torch.empty(x.shape, device="meta"), 0.5)
    with pytest.raises(ValueError, match="CUDA device or on the CPU"):
        pr_mod.tree_reduce(x, m, lambda f: f // 2)


def test_cpu_route_is_not_counted_as_a_launch(monkeypatch):
    """CPU tensors take the plain versions: the kernel library is never
    loaded and no launch counter moves, tree_reduce's included (also at a
    ragged stream with rack ids first met out of order)."""
    def no_load():
        raise AssertionError("the CPU route loaded the kernels")

    def counts():
        return (pr_mod.LAUNCHES, pr_mod.TREE_LAUNCHES, df_mod.LAUNCHES,
                rk_mod.LAUNCHES)

    monkeypatch.setattr(_build, "load", no_load)
    rng = np.random.default_rng(0)
    before = counts()
    x = torch.tensor(rng.normal(size=(3, 5, 7)).astype(np.float32))
    m = torch.ones((3, 5))
    ops.ltp_packet_reduce(x, m)
    ops.ltp_dropfill(x[0], m[0])
    ops.randomk_sparsify(x, torch.rand(x.shape), 0.5)
    pr_mod.tree_reduce(x, m, lambda f: f // 2)
    x = torch.tensor(rng.normal(size=(6, 33, 100)).astype(np.float32))
    m = torch.tensor((rng.random((6, 33)) > 0.4).astype(np.float32))
    for comp in ("paper", "count"):
        pr_mod.tree_reduce(x, m, lambda f: (f * 5) % 3, compensation=comp)
    assert counts() == before


def test_randomk_on_a_cuda_tensor_launches_or_raises(monkeypatch):
    """Without a card the kernel's loader raises; the wrapper reaches it
    for any tensor off the CPU and never takes the plain version."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(_build, "_LIB", None)
    calls = []

    class FakeCuda:
        """Stands in for a CUDA tensor: only what the wrapper reads."""
        shape = (8,)
        dtype = torch.float32
        device = torch.device("cuda", 0)
        is_contiguous = staticmethod(lambda: True)

    monkeypatch.setattr(torch, "empty_like",
                        lambda t: calls.append("empty") or torch.empty(8))
    before = rk_mod.LAUNCHES
    with pytest.raises(RuntimeError, match="CUDA device"):
        rk_mod.randomk(FakeCuda(), FakeCuda(), 0.5)
    assert calls == ["empty"] and rk_mod.LAUNCHES == before


def test_dropfill_ef_on_a_cuda_tensor_launches_or_raises(monkeypatch):
    """The EF form on tensors off the CPU allocates its two fresh outputs
    and reaches the kernel's loader (which raises without a card), never
    the plain version; on CPU tensors it takes the plain version, loads
    nothing and counts no launch."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(_build, "_LIB", None)
    calls = []

    class FakeCuda:
        """Stands in for a CUDA tensor: only what the wrapper reads."""
        dtype = torch.float32
        device = torch.device("cuda", 0)
        is_contiguous = staticmethod(lambda: True)

        def __init__(self, *shape):
            self.shape = torch.Size(shape)

        def dim(self):
            return len(self.shape)

        def numel(self):
            return int(np.prod(self.shape))

    monkeypatch.setattr(torch, "empty_like",
                        lambda t: calls.append("empty") or torch.empty(8))
    monkeypatch.setattr(df_mod, "dropfill_ef_ref",
                        lambda *a: calls.append("plain"))
    before = df_mod.LAUNCHES
    with pytest.raises(RuntimeError, match="CUDA device"):
        df_mod.dropfill_ef(FakeCuda(3, 4), FakeCuda(3, 4), FakeCuda(3))
    assert calls == ["empty", "empty"] and df_mod.LAUNCHES == before
    monkeypatch.undo()

    def no_load():
        raise AssertionError("the CPU route loaded the kernels")

    monkeypatch.setattr(_build, "load", no_load)
    x = torch.ones((5, 8))
    sent, new_res = ops.ltp_dropfill_ef(x, x, torch.ones(5))
    assert torch.equal(sent, 2 * x) and not new_res.any()
    assert df_mod.LAUNCHES == before


def test_tree_reduce_on_a_cuda_tensor_launches_or_raises(monkeypatch):
    """tree_reduce on tensors off the CPU reaches the kernel's loader
    (which raises without a card) and never the plain version."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(_build, "_LIB", None)
    calls = []

    class FakeCuda:
        """Stands in for a CUDA tensor: only what the wrapper reads."""
        device = torch.device("cuda", 0)

        def __init__(self, *shape):
            self.shape = torch.Size(shape)

        def dim(self):
            return len(self.shape)

        def to(self, dtype):
            return self

        def contiguous(self):
            return self

    monkeypatch.setattr(torch, "empty",
                        lambda *a, **k: calls.append("empty") or
                        torch.zeros(3, 4))
    monkeypatch.setattr(pr_mod, "tree_reduce_ref",
                        lambda *a, **k: calls.append("plain"))
    before = (pr_mod.LAUNCHES, pr_mod.TREE_LAUNCHES)
    with pytest.raises(RuntimeError, match="CUDA device"):
        pr_mod.tree_reduce(FakeCuda(2, 3, 4), FakeCuda(2, 3),
                           lambda f: f // 2)
    assert calls == ["empty"]
    assert (pr_mod.LAUNCHES, pr_mod.TREE_LAUNCHES) == before


def test_resolve_backend_rules():
    cpu = torch.zeros(1)
    meta = torch.zeros(1, device="meta")
    assert ls.resolve_backend("auto", cpu) == "python"
    assert ls.resolve_backend("python", meta) == "python"
    assert ls.resolve_backend("cuda", cpu) == "cuda"
    with pytest.raises(ValueError):
        ls.resolve_backend("pallas", cpu)


def test_runtime_engine_and_other_families_wait_for_their_port():
    """The runtime engine runs over the analytic and the packet-level
    transports, with network faults and the loss-budget controller on the
    packet-level one only. Every model family is ported now: an unknown
    architecture raises ``KeyError``."""
    cfg = get_config("papernet").replace(d_model=8, n_layers=3)
    tc = TrainConfig(batch=8, steps=1)

    def runtime(**kw):
        return ClusterRuntime(build(cfg), make_optimizer(tc), tc,
                              LTPConfig(), NetConfig(), n_workers=2,
                              device="cpu", **kw)

    assert runtime(transport="des").net_des is not None
    rt = runtime(transport="des", net_faults=NetFaultConfig(),
                 budget=BudgetController())
    assert rt.budget is not None and rt._netfault_cfg == NetFaultConfig()
    with pytest.raises(ValueError, match="transport='des'"):
        runtime(net_faults=NetFaultConfig())
    with pytest.raises(ValueError, match="transport='des'"):
        runtime(budget=BudgetController())
    tr = PSTrainer(build(cfg), make_optimizer(tc), tc, LTPConfig(),
                   NetConfig(), n_workers=2, engine="runtime",
                   transport="des", device="cpu")
    assert tr._rt.net_des is not None
    with pytest.raises(KeyError, match="no such architecture"):
        get_config("whisper_medium")


def test_configs_stay_hashable():
    assert hash(LTPConfig()) == hash(LTPConfig())
    assert LTPConfig().sync_backend == "auto"
    assert not hasattr(LTPConfig(), "kernel_interpret")


@pytest.mark.parametrize("name", ["ModelConfig", "LTPConfig", "NetConfig",
                                  "TrainConfig", "RuntimeConfig",
                                  "ObservabilityConfig", "FaultConfig",
                                  "NetFaultConfig"])
def test_config_fields_are_the_jax_packages(name):
    """Every field the port keeps is the JAX package's field, with the same
    default; only ``sync_backend`` differs (the port's backends)."""
    import dataclasses

    from repro import config as jconfig
    from repro_torch import config as tconfig

    jfields = {f.name: f for f in dataclasses.fields(getattr(jconfig, name))}
    for f in dataclasses.fields(getattr(tconfig, name)):
        assert f.name in jfields, f"{name}.{f.name} is not a JAX field"
        if f.name != "sync_backend":
            assert f.default == jfields[f.name].default, f"{name}.{f.name}"


def test_kernel_build_dir_is_inside_the_package_and_ignored():
    assert _build.BUILD_ROOT.parent == _build.SOURCES[0].parent.parent
    rel = os.path.relpath(_build.BUILD_ROOT, ROOT).replace(os.sep, "/")
    with open(os.path.join(ROOT, ".gitignore")) as f:
        ignored = {line.strip().strip("/") for line in f}
    assert rel in ignored
