"""The paper's Fig 5 training loop: dense, Random-k and Top-k SGD with
error feedback on one device.

The port's copy, as a library function, of the JAX package's
``benchmarks/fig5_randomk_topk.py`` (``_train`` and ``run``). Each step
takes the gradient of the whole batch, sparsifies it with
``core.compression`` (Random-k through the hand-written ``randomk``
kernel on the card), carries the dropped mass to the next step as the
residual, and applies SGD-momentum. The selection time is taken on the
host clock between two device synchronisations, as JAX's loop takes it
between ``block_until_ready`` calls.
"""
from __future__ import annotations

import statistics
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch.func import grad_and_value
from torch.profiler import record_function

from repro_torch.config import ModelConfig, TrainConfig
from repro_torch.configs import get_config
from repro_torch.core import compression
from repro_torch.data import SyntheticCIFAR, batches
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import build
from repro_torch.models.cnn import accuracy
from repro_torch.optim import make_optimizer
from repro_torch.tree import tree_leaves, tree_map

KINDS = ("none", "randomk", "topk")


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def train_compressed(cfg: ModelConfig, tc: TrainConfig, data, test,
                     kind: str, k: float, steps: int, *,
                     device: DeviceLike = None, seed: int = 0,
                     uniforms: Optional[Sequence[Any]] = None,
                     params: Any = None, backend: str = "auto",
                     return_params: bool = False) -> Tuple:
    """Train ``steps`` steps of ``cfg`` on ``data`` under ``kind``
    (``none`` | ``randomk`` | ``topk``) at keep fraction ``k``; returns
    (top-1 on ``test``, median selection seconds, history), and the
    trained params after them with ``return_params=True``.

    ``history`` has one record a step: ``loss`` (before the update),
    ``density`` and ``kept`` (fraction and number of nonzero elements of
    the gradient applied) and ``seconds`` (host time of the step, ending
    in a synchronisation). The model starts from ``params`` when given
    (e.g. carried over with ``convert.params_from_numpy``), else from a
    CPU generator seeded with ``seed``. Random-k draws its uniforms from
    a generator on the device seeded with ``seed + 1``, or takes step
    i's from ``uniforms[i]``. ``backend`` is Random-k's select route:
    ``cuda`` / ``auto`` (the kernel on the card) or ``python``.
    """
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
    dev = resolve_device(device)
    api = build(cfg)
    opt = make_optimizer(tc)
    if params is None:
        params = api.init(torch.Generator().manual_seed(seed), device=dev)
    else:
        params = tree_map(lambda x: torch.as_tensor(x).to(dev), params)
    state = opt.init(params)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    residual = None
    grad_fn = grad_and_value(api.loss_fn)
    test = {name: torch.as_tensor(v).to(dev) for name, v in test.items()}

    sel_times, history = [], []
    for i, b in enumerate(batches(data, tc.batch, steps)):
        # named spans, so that a profile can find one step and its
        # selection (chip_smoke.py's profile fig5_randomk line)
        with record_function(f"train_compressed step {i}"):
            _sync(dev)
            t_step = time.perf_counter()
            b = {name: torch.as_tensor(v).to(dev) for name, v in b.items()}
            grads, loss = grad_fn(params, b)
            _sync(dev)
            t0 = time.perf_counter()
            with record_function("train_compressed select"):
                if kind == "topk":
                    grads, residual = compression.top_k(grads, k, residual)
                elif kind == "randomk":
                    u = (None if uniforms is None
                         else torch.as_tensor(uniforms[i]))
                    grads, residual = compression.random_k(
                        grads, k, gen, residual, u=u, backend=backend)
                _sync(dev)
            sel_times.append(time.perf_counter() - t0)
            leaves = tree_leaves(grads)
            kept = int(torch.stack([torch.count_nonzero(g)
                                    for g in leaves]).sum())
            n_elems = sum(g.numel() for g in leaves)
            upd, state = opt.update(grads, state, params, tc.lr)
            params = tree_map(lambda p, u_: p + u_, params, upd)
            loss = float(loss)
            _sync(dev)
            history.append({"step": i, "loss": loss,
                            "density": kept / n_elems, "kept": kept,
                            "seconds": time.perf_counter() - t_step})
    acc = float(accuracy(cfg, params, test))
    out = (acc, statistics.median(sel_times), history)
    return out + (params,) if return_params else out


def fig5_rows(quick: bool = True,
              device: DeviceLike = None) -> List[Dict[str, Any]]:
    """The rows of the JAX package's ``fig5_randomk_topk.run``, under the
    same keys: top-1 and relative throughput of dense, Random-k and
    Top-k training on SyntheticCIFAR. Throughput follows the same model:
    compute + communication fixed at 70 ms a step, plus the measured
    selection time."""
    cfg = get_config("papernet").replace(d_model=8 if quick else 16,
                                         n_layers=3 if quick else 6)
    tc = TrainConfig(batch=128, lr=0.05)
    steps = 30 if quick else 120
    data = SyntheticCIFAR(seed=3)
    test = data.test_set(1024)
    ks = [0.1, 0.4] if quick else [0.05, 0.1, 0.2, 0.3, 0.4, 0.7]
    rows = []
    base_acc, _, _ = train_compressed(cfg, tc, data, test, "none", 1.0,
                                      steps, device=device)
    rows.append({"kind": "dense", "k": 1.0, "top1": round(base_acc, 4),
                 "rel_throughput": 1.0})
    for k in ks:
        for kind in ["randomk", "topk"]:
            acc, sel, _ = train_compressed(cfg, tc, data, test, kind, k,
                                           steps, device=device)
            base_step = 0.05 + 0.02
            rel = base_step / (base_step + sel)
            rows.append({"kind": kind, "k": k, "top1": round(acc, 4),
                         "sel_overhead_ms": round(sel * 1e3, 2),
                         "rel_throughput": round(rel, 3)})
    return rows
