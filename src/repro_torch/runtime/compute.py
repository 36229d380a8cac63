"""Per-worker compute-time models (DESIGN.md §8).

The cluster runtime couples these with the network DES on one shared
``Sim`` clock: a worker's iteration is compute (sampled here) followed
by its transport leg. Three models cover the paper's evaluation axes:

  deterministic  fixed per-worker times (optionally heterogeneous) —
                 the legacy ``compute_time`` scalar is the uniform case.
  lognormal      unit-mean lognormal jitter x occasional straggler
                 multiplier — the long-tail host stragglers (GC pauses,
                 CPU contention) behind the paper's Fig-3 starved flows.
  trace          replay measured per-(iteration, worker) times.

Samples are deterministic in (seed, worker, iteration) — independent of
event-loop interleaving — so a run reproduces exactly across policies.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Union

import numpy as np


class ComputeModel:
    """Interface: seconds of gradient-computation time per (worker,
    iteration)."""

    #: extra seconds charged to the first iteration after a worker
    #: (re)joins mid-run — cold caches, params re-fetch, kernel re-warm.
    #: The fault layer (runtime/faults.py) reads this; 0 = free rejoin.
    rejoin_penalty_s: float = 0.0

    def sample(self, worker: int, iteration: int) -> float:
        raise NotImplementedError


#: name -> class; ``make_compute_model`` dispatches through this table.
COMPUTE_MODELS: Dict[str, type] = {}


def register_compute(name: str):
    def deco(cls):
        COMPUTE_MODELS[name] = cls
        cls.name = name
        return cls
    return deco


@register_compute("deterministic")
class DeterministicCompute(ComputeModel):
    """Fixed times: ``base`` seconds, optionally scaled per worker by
    ``mults`` — heterogeneous-but-stable hardware."""

    def __init__(self, n_workers: int, base: float = 0.05,
                 mults: Optional[np.ndarray] = None, seed: int = 0,
                 rejoin_penalty_s: float = 0.0):
        self.base = float(base)
        self.rejoin_penalty_s = float(rejoin_penalty_s)
        self.mults = (np.ones(n_workers) if mults is None
                      else np.asarray(mults, float))
        if len(self.mults) != n_workers:
            raise ValueError(
                f"mults has {len(self.mults)} entries for {n_workers} workers")

    def sample(self, worker: int, iteration: int) -> float:
        return self.base * float(self.mults[worker])


@register_compute("lognormal")
class LognormalStragglerCompute(ComputeModel):
    """base * LogNormal(-sigma^2/2, sigma) jitter (unit mean), with
    probability ``straggler_prob`` additionally multiplied by
    ``straggler_mult`` — the occasional worker that falls off a cliff.
    Each (worker, iteration) draw is seeded independently, so samples do
    not depend on the order the event loop asks for them."""

    def __init__(self, n_workers: int, base: float = 0.05,
                 sigma: float = 0.2, straggler_prob: float = 0.1,
                 straggler_mult: float = 4.0, seed: int = 0,
                 rejoin_penalty_s: float = 0.0):
        self.base = float(base)
        self.rejoin_penalty_s = float(rejoin_penalty_s)
        self.sigma = float(sigma)
        self.straggler_prob = float(straggler_prob)
        self.straggler_mult = float(straggler_mult)
        self.seed = int(seed)

    def sample(self, worker: int, iteration: int) -> float:
        rng = np.random.default_rng((self.seed, worker, iteration))
        t = self.base * math.exp(
            rng.normal(-0.5 * self.sigma ** 2, self.sigma))
        if rng.random() < self.straggler_prob:
            t *= self.straggler_mult
        return t


@register_compute("trace")
class TraceCompute(ComputeModel):
    """Replay a measured (iters, W) compute-time trace, tiled over
    iterations. A 1-D trace broadcasts the same per-iteration time to
    every worker."""

    def __init__(self, n_workers: int, trace: np.ndarray, base: float = 1.0,
                 seed: int = 0, rejoin_penalty_s: float = 0.0):
        self.rejoin_penalty_s = float(rejoin_penalty_s)
        t = np.asarray(trace, float)
        if t.ndim == 1:
            t = np.tile(t[:, None], (1, n_workers))
        if t.ndim != 2 or t.shape[1] != n_workers:
            raise ValueError(
                f"trace shape {t.shape} incompatible with {n_workers} workers")
        if not len(t):
            raise ValueError("empty compute trace")
        self.trace = t * float(base)

    def sample(self, worker: int, iteration: int) -> float:
        return float(self.trace[iteration % len(self.trace), worker])


def make_compute_model(spec: Union[None, str, ComputeModel], n_workers: int,
                       base: float = 0.05, seed: int = 0,
                       **kw) -> ComputeModel:
    """Resolve a compute model from an instance, a registered name, or
    None (-> deterministic at ``base`` — the legacy scalar)."""
    if isinstance(spec, ComputeModel):
        return spec
    if spec is None:
        return DeterministicCompute(n_workers, base=base)
    try:
        cls = COMPUTE_MODELS[spec]
    except KeyError:
        raise ValueError(
            f"unknown compute model {spec!r}; registered: "
            f"{sorted(COMPUTE_MODELS)} (or pass a ComputeModel "
            f"instance)") from None
    return cls(n_workers, base=base, seed=seed, **kw)
