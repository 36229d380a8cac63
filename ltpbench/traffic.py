"""The one generator of the cells' host batches.

A batch is ``batch`` sequences of ``seq`` next-token pairs, the tokens
drawn from a Zipf law of exponent ``zipf`` over the configuration's
whole vocabulary (rank r has weight r^-zipf; token id = rank - 1), as
text is: a few tokens make most of it. An encoder-decoder configuration
(``encoder_frames`` > 0) also gets the audio frontend's output,
``frames_std`` x N(0, 1) of shape (batch, encoder_frames, d_model).
Every batch has the same sizes; the seed picks the values alone.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch


def zipf_probs(vocab: int, a: float) -> np.ndarray:
    w = np.arange(1, vocab + 1, dtype=np.float64) ** -a
    return w / w.sum()


def host_batches(config: dict, workload: dict, seed: int, n: int,
                 device) -> List[Dict[str, torch.Tensor]]:
    """``n`` host batches (CPU tensors) from ``seed``; the frames are
    drawn on ``device`` and brought to the host."""
    rng = np.random.default_rng([int(seed), 7])
    p = zipf_probs(config["vocab"], workload["zipf"])
    b, s = workload["batch"], workload["seq"]
    out = []
    for i in range(n):
        toks = torch.from_numpy(rng.choice(config["vocab"], size=(b, s + 1),
                                           p=p).astype(np.int64))
        batch = {"tokens": toks[:, :-1].contiguous(),
                 "labels": toks[:, 1:].contiguous()}
        if config.get("encoder_frames", 0):
            gen = torch.Generator(device=device)
            gen.manual_seed((int(seed) * 7919 + 104729 * (i + 1))
                            % (1 << 63))
            fr = torch.randn((b, config["encoder_frames"], config["d_model"]),
                             generator=gen, device=device)
            batch["frames"] = (fr * workload["frames_std"]).cpu()
        out.append(batch)
    return out
