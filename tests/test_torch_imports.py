"""The PyTorch port stands alone: it imports with JAX blocked, no file of
it (nor chip_smoke.py) imports ``jax`` or ``repro``, and nothing falls
back to the CPU unless the caller asked for it."""
import ast
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.config import LTPConfig, NetConfig, TrainConfig
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import ltp_sync as ls
from repro_torch.device import resolve_device
from repro_torch.kernels import _build
from repro_torch.kernels import dropfill as df_mod
from repro_torch.kernels import ops
from repro_torch.kernels import packet_reduce as pr_mod
from repro_torch.kernels import randomk as rk_mod
from repro_torch.models import build
from repro_torch.optim import make_optimizer
from repro_torch.train import PSTrainer

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
PORT = os.path.join(ROOT, "src", "repro_torch")
FORBIDDEN = ("jax", "jaxlib", "repro")


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
    assert int(proc.stdout.strip()) >= 20


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


def test_cpu_route_is_not_counted_as_a_launch():
    rng = np.random.default_rng(0)
    before = (pr_mod.LAUNCHES, df_mod.LAUNCHES, rk_mod.LAUNCHES)
    x = torch.tensor(rng.normal(size=(3, 5, 7)).astype(np.float32))
    m = torch.ones((3, 5))
    ops.ltp_packet_reduce(x, m)
    ops.ltp_dropfill(x[0], m[0])
    ops.randomk_sparsify(x, torch.rand(x.shape), 0.5)
    pr_mod.tree_reduce(x, m, lambda f: f // 2)
    assert (pr_mod.LAUNCHES, df_mod.LAUNCHES, rk_mod.LAUNCHES) == before


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


def test_resolve_backend_rules():
    cpu = torch.zeros(1)
    meta = torch.zeros(1, device="meta")
    assert ls.resolve_backend("auto", cpu) == "python"
    assert ls.resolve_backend("python", meta) == "python"
    assert ls.resolve_backend("cuda", cpu) == "cuda"
    with pytest.raises(ValueError):
        ls.resolve_backend("pallas", cpu)


def test_runtime_engine_and_other_families_wait_for_their_port():
    cfg = get_config("papernet").replace(d_model=8, n_layers=3)
    tc = TrainConfig(batch=8, steps=1)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        PSTrainer(build(cfg), make_optimizer(tc), tc, LTPConfig(),
                  NetConfig(), n_workers=2, engine="runtime", device="cpu")
    with pytest.raises(KeyError, match="ROADMAP"):
        get_config("smollm_360m")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build(cfg.replace(family="dense"))


def test_configs_stay_hashable():
    assert hash(LTPConfig()) == hash(LTPConfig())
    assert LTPConfig().sync_backend == "auto"
    assert not hasattr(LTPConfig(), "kernel_interpret")


@pytest.mark.parametrize("name", ["ModelConfig", "LTPConfig", "NetConfig",
                                  "TrainConfig"])
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
