"""Deterministic synthetic datasets (offline container — no CIFAR download).

A numpy-only copy of the JAX package's ``data/synthetic.py``: both
packages draw the same batches from the same seed.

SyntheticCIFAR: class-templated 32x32x3 images + noise. Linear-separable-ish
but noisy enough that accuracy climbs over epochs like a real small-vision
task; used for the paper's accuracy/TTA experiments (Figs 5, 12, 13).

SyntheticLM: sequences from a fixed random bigram chain over the vocab.
The achievable cross-entropy floor is the chain's conditional entropy, so
training curves show real learning (loss falls from ln(V) toward the
floor) — used for LM-side LTP accuracy checks.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Tuple

import numpy as np


@dataclasses.dataclass
class SyntheticCIFAR:
    n_classes: int = 10
    n_train: int = 50_000
    n_test: int = 10_000
    noise: float = 0.6
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        # two template components per class -> not linearly trivial
        self.templates = rng.normal(0, 1, (self.n_classes, 2, 32, 32, 3)).astype(
            np.float32
        )

    def _make(self, n: int, seed: int) -> Tuple[np.ndarray, np.ndarray]:
        rng = np.random.default_rng(seed)
        labels = rng.integers(0, self.n_classes, n)
        comp = rng.integers(0, 2, n)
        mix = rng.uniform(0.6, 1.0, (n, 1, 1, 1)).astype(np.float32)
        base = self.templates[labels, comp] * mix
        imgs = base + rng.normal(0, self.noise, base.shape).astype(np.float32)
        return imgs.astype(np.float32), labels.astype(np.int32)

    def train_batch(self, batch: int, step: int) -> Dict[str, np.ndarray]:
        imgs, labels = self._make(batch, seed=1000 + step)
        return {"images": imgs, "labels": labels}

    def test_set(self, n: int = 2048) -> Dict[str, np.ndarray]:
        imgs, labels = self._make(n, seed=7)
        return {"images": imgs, "labels": labels}


@dataclasses.dataclass
class SyntheticLM:
    vocab: int = 512
    seed: int = 0
    concentration: float = 0.02   # smaller -> peakier bigram -> lower floor

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        logits = rng.gumbel(size=(self.vocab, self.vocab)) / self.concentration
        p = np.exp(logits - logits.max(axis=1, keepdims=True))
        self.trans = (p / p.sum(axis=1, keepdims=True)).astype(np.float64)
        self.entropy_floor = float(
            -(self.trans * np.log(np.maximum(self.trans, 1e-12))).sum(axis=1).mean()
        )
        self._cum = np.cumsum(self.trans, axis=1)

    def sample(self, batch: int, seq: int, seed: int) -> np.ndarray:
        rng = np.random.default_rng(seed)
        out = np.empty((batch, seq + 1), np.int64)
        out[:, 0] = rng.integers(0, self.vocab, batch)
        u = rng.random((batch, seq))
        for t in range(seq):
            out[:, t + 1] = np.array(
                [np.searchsorted(self._cum[s], x) for s, x in zip(out[:, t], u[:, t])]
            )
        return np.minimum(out, self.vocab - 1)

    def train_batch(self, batch: int, seq: int, step: int) -> Dict[str, np.ndarray]:
        toks = self.sample(batch, seq, seed=2000 + step)
        return {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }


def batches(dataset, batch: int, steps: int, seq: int = 0) -> Iterator[Dict]:
    for step in range(steps):
        if isinstance(dataset, SyntheticLM):
            yield dataset.train_batch(batch, seq, step)
        else:
            yield dataset.train_batch(batch, step)
