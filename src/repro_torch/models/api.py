"""Model API: the same callable surface per architecture.

Only the ``cnn`` family (papernet) is ported; ``build`` raises for the
others, which wait for ROADMAP.md queue 1 item 12 (and bring the
``prefill`` / ``decode_step`` / ``init_cache`` fields of the JAX
package's ``ModelApi`` with them).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable

from repro_torch.config import ModelConfig
from repro_torch.models import cnn


@dataclasses.dataclass(frozen=True)
class ModelApi:
    cfg: ModelConfig
    init: Callable           # (generator, *, device) -> params
    loss_fn: Callable        # (params, batch) -> scalar
    forward: Callable        # (params, images) -> logits


def build(cfg: ModelConfig) -> ModelApi:
    if cfg.family != "cnn":
        raise NotImplementedError(
            f"model family {cfg.family!r} is not ported to repro_torch yet; "
            f"see ROADMAP.md, queue 1 item 12")
    return ModelApi(
        cfg=cfg,
        init=functools.partial(cnn.init, cfg=cfg),
        loss_fn=functools.partial(cnn.loss_fn, cfg),
        forward=functools.partial(cnn.forward, cfg),
    )
