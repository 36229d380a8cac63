"""Optimizers (no external deps): SGD+momentum (the paper's setup) and AdamW.

Functional over parameter trees, as in the JAX package:
``init(params) -> state``, ``update(grads, state, params, lr) ->
(updates, state)``; updates are ADDED to params. Trees are nested
dicts/lists of tensors walked by ``repro_torch.tree``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Tuple

import torch

from repro_torch.config import TrainConfig
from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any, Any], Tuple[Any, Any]]
    # update(grads, state, params, lr) -> (updates, new_state)


@functools.lru_cache(maxsize=None)
def sgd_momentum(momentum: float = 0.9, weight_decay: float = 0.0,
                 nesterov: bool = False) -> Optimizer:
    def init(params):
        return {"m": tree_map(torch.zeros_like, params)}

    def update(grads, state, params, lr):
        def new_m(g, m, p):
            g = g.to(m.dtype)
            if weight_decay:
                g = g + weight_decay * p.to(m.dtype)
            return momentum * m + g

        def upd(g, m_new, p):
            g = g.to(m_new.dtype)
            step = (momentum * m_new + g) if nesterov else m_new
            return (-lr * step).to(p.dtype)

        m = tree_map(new_m, grads, state["m"], params)
        updates = tree_map(upd, grads, m, params)
        return updates, {"m": m}

    return Optimizer(init, update)


@functools.lru_cache(maxsize=None)
def adamw(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        def f32(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        dev = tree_leaves(params)[0].device
        return {
            "m": tree_map(f32, params),
            "v": tree_map(f32, params),
            "t": torch.zeros((), dtype=torch.int32, device=dev),
        }

    def update(grads, state, params, lr):
        t = state["t"] + 1
        # bias corrections in float32, as the JAX package computes them
        tf = t.to(torch.float32)
        c1 = 1.0 - torch.tensor(b1, dtype=torch.float32, device=t.device) ** tf
        c2 = 1.0 - torch.tensor(b2, dtype=torch.float32, device=t.device) ** tf

        m = tree_map(lambda g, m: b1 * m + (1 - b1) * g.to(torch.float32),
                     grads, state["m"])
        v = tree_map(lambda g, v: b2 * v + (1 - b2) *
                     torch.square(g.to(torch.float32)), grads, state["v"])

        def upd(m, v, p):
            step = (m / c1) / (torch.sqrt(v / c2) + eps)
            if weight_decay:
                step = step + weight_decay * p.to(torch.float32)
            return (-lr * step).to(p.dtype)

        updates = tree_map(upd, m, v, params)
        return updates, {"m": m, "v": v, "t": t}

    return Optimizer(init, update)


def make_optimizer(cfg: TrainConfig) -> Optimizer:
    """Equal knobs -> the SAME (memoized) Optimizer instance. Optimizers
    are stateless function pairs, so sharing is free."""
    if cfg.optimizer == "adamw":
        return adamw(weight_decay=cfg.weight_decay)
    return sgd_momentum(momentum=cfg.momentum, weight_decay=cfg.weight_decay)


def lr_at(cfg: TrainConfig, step, steps_per_epoch: int = 0):
    """Paper schedule: lr *= decay every ``lr_decay_every`` epochs."""
    lr = cfg.lr
    if cfg.lr_decay_every and steps_per_epoch:
        epoch = step // steps_per_epoch
        n = epoch // cfg.lr_decay_every
        lr = cfg.lr * (cfg.lr_decay ** n)
    return lr
