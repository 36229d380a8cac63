"""The paper's Fig 13 loop: time-to-accuracy of LTP against BBR and Cubic.

The port's copy, as a library function, of the JAX package's
``benchmarks/fig13_tta.py`` (``run``). Does LTP's partial gradient loss
cost final accuracy or convergence time? Each run trains papernet
through ``PSTrainer`` (8 workers, one PS, the runtime engine) under one
protocol and one non-congestion loss rate, evaluates every
``eval_every`` steps on a held-out set, and reads the simulated time at
which the accuracy first reaches the target. The rows keep the
benchmark's keys, unrounded, and add the run's history and its host
time; nothing is written or printed.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.config import LTPConfig, ModelConfig, NetConfig, TrainConfig
from repro_torch.configs import get_config
from repro_torch.data import SyntheticCIFAR, batches
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import build
from repro_torch.models.cnn import accuracy
from repro_torch.optim import make_optimizer
from repro_torch.train.dp_sim import PSTrainer

PROTOCOLS = ("ltp", "bbr", "cubic")
N_WORKERS = 8
BATCH = 128


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def train_tta(cfg: ModelConfig, loss: float, protocol: str, steps: int,
              test: Dict[str, torch.Tensor], *, eval_every: int = 10,
              sync_backend: str = "auto", device: DeviceLike = None,
              params: Any = None) -> Tuple[PSTrainer, float]:
    """One Fig 13 run: ``steps`` steps of global batch 128 from
    SyntheticCIFAR(seed=5) under ``protocol`` over ``NetConfig(10, 1,
    loss, 4096)``, 8 workers, ``compute_time=0.05``, seed 0, with an
    eval of ``accuracy`` on ``test`` (tensors on the run's device) every
    ``eval_every`` steps. Returns the trainer after its run and the
    host seconds of the run, between two device synchronisations."""
    dev = resolve_device(device)
    tc = TrainConfig(batch=BATCH, lr=0.05, steps=steps)
    tr = PSTrainer(build(cfg), make_optimizer(tc), tc,
                   LTPConfig(sync_backend=sync_backend),
                   NetConfig(10, 1, loss, 4096), n_workers=N_WORKERS,
                   protocol=protocol, compute_time=0.05, seed=0, device=dev,
                   params=params)
    data = list(batches(SyntheticCIFAR(seed=5), tc.batch, steps))
    _sync(dev)
    t0 = time.perf_counter()
    tr.run(data, epoch_steps=20, eval_fn=lambda p: accuracy(cfg, p, test),
           eval_every=eval_every)
    _sync(dev)
    return tr, time.perf_counter() - t0


def tta_row(tr: PSTrainer, loss: float, protocol: str, target: float,
            host_s: float) -> Dict[str, Any]:
    """The benchmark's row for one run, unrounded, plus its history,
    host seconds and images a host second."""
    hist = tr.history
    evals = [(h["sim_time"], h["eval"]) for h in hist if "eval" in h]
    tta = next((t for t, a in evals if a >= target), None)
    return {
        "loss": loss, "protocol": protocol,
        "final_acc": evals[-1][1] if evals else None,
        "tta_s": tta if tta is not None else "not_reached",
        "target": target,
        "final_loss": hist[-1]["loss"],
        "delivered": float(np.mean([h["delivered"] for h in hist])),
        "total_sim_time_s": tr.sim_time,
        "host_s": host_s,
        "images_per_s": len(hist) * BATCH / host_s,
        "history": hist,
    }


def run_tta(quick: bool = True, *, cfg: Optional[ModelConfig] = None,
            steps: Optional[int] = None,
            losses: Optional[Sequence[float]] = None, eval_every: int = 10,
            n_test: int = 1024, target: Optional[float] = None,
            device: DeviceLike = None,
            params: Any = None) -> List[Dict[str, Any]]:
    """The rows of ``fig13_tta.run(quick)``: one per (loss, protocol), in
    the benchmark's order. Unset, ``cfg`` (papernet at width 8 and 3
    layers quick, 16 and 6 full), ``steps`` (40 quick, 150 full),
    ``losses`` ([0, 0.01] quick, [0, 0.001, 0.01] full) and
    ``target`` (0.2 quick, 0.45 full) are the benchmark's. The test set
    (``n_test`` images of SyntheticCIFAR(seed=5)) is built once, on the
    device. Every run starts from ``params`` when given (one tree serves
    them all: each run of the benchmark initialises from seed 0), else
    from seed 0's own init."""
    dev = resolve_device(device)
    cfg = cfg if cfg is not None else get_config("papernet").replace(
        d_model=8 if quick else 16, n_layers=3 if quick else 6)
    steps = steps if steps is not None else (40 if quick else 150)
    losses = losses if losses is not None else (
        [0.0, 0.01] if quick else [0.0, 0.001, 0.01])
    target = target if target is not None else (0.2 if quick else 0.45)
    test = {k: torch.as_tensor(v).to(dev)
            for k, v in SyntheticCIFAR(seed=5).test_set(n_test).items()}
    rows = []
    for loss in losses:
        for proto in PROTOCOLS:
            tr, host_s = train_tta(cfg, loss, proto, steps, test,
                                   eval_every=eval_every, device=dev,
                                   params=params)
            rows.append(tta_row(tr, loss, proto, target, host_s))
    return rows
