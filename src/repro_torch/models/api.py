"""Model API: the same callable surface per architecture, and input specs.

``build(cfg)`` returns a ModelApi with the same callable surface for
every family: ``cnn`` (papernet), the decoder-only transformers,
``dense``, ``vlm``, ``moe`` (MoE layers, and MLA for deepseek-v2),
``ssm`` (falcon-mamba) and ``hybrid`` (zamba2), and the enc-dec
``audio`` (whisper, whose ``forward`` is ``None``, as in the reference).
``input_specs(cfg, shape)`` returns meta tensors (shapes
and dtypes, nothing allocated) for each step kind:

  train   -> loss_fn(params, batch)
  prefill -> prefill(params, inputs)          (last-token logits + cache)
  decode  -> decode_step(params, cache, token, pos)   (ONE token)
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import cnn, encdec, transformer
from repro_torch.models.layers import dtype_of
from repro_torch.shapes import InputShape
from repro_torch.tree import tree_map_with_path



@dataclasses.dataclass(frozen=True)
class ModelApi:
    cfg: ModelConfig
    init: Callable           # (generator, *, device) -> params
    loss_fn: Callable        # (params, batch, *, remat) -> scalar
    forward: Optional[Callable]
    prefill: Optional[Callable]      # (params, inputs) -> (logits, cache)
    decode_step: Optional[Callable]  # (params, cache, token, pos)
    init_cache: Optional[Callable]   # (batch, max_seq, dtype, *, device)


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family in ("cnn", "audio"):
        return
    transformer.check_supported(cfg)
    if cfg.family not in ("dense", "vlm", "moe", "ssm", "hybrid"):
        raise ValueError(f"unknown model family {cfg.family!r}")


def _tf_prefill(cfg):
    def prefill(params, inputs):
        logits, _, caches = transformer.forward(
            cfg, params, inputs, collect_cache=True, remat=False,
            last_only=True)
        return logits[:, 0], caches

    return prefill


def build(cfg: ModelConfig) -> ModelApi:
    _check_family(cfg)
    if cfg.family == "cnn":
        return ModelApi(
            cfg=cfg,
            init=functools.partial(cnn.init, cfg=cfg),
            loss_fn=functools.partial(cnn.loss_fn, cfg),
            forward=functools.partial(cnn.forward, cfg),
            prefill=None,
            decode_step=None,
            init_cache=None,
        )
    if cfg.family == "audio":
        return ModelApi(
            cfg=cfg,
            init=functools.partial(encdec.init, cfg=cfg),
            loss_fn=functools.partial(encdec.loss_fn, cfg),
            forward=None,
            prefill=functools.partial(encdec.prefill, cfg),
            decode_step=functools.partial(encdec.decode_step, cfg),
            init_cache=functools.partial(encdec.init_cache, cfg),
        )
    return ModelApi(
        cfg=cfg,
        init=functools.partial(transformer.init, cfg=cfg),
        loss_fn=functools.partial(transformer.loss_fn, cfg),
        forward=functools.partial(transformer.forward, cfg),
        prefill=_tf_prefill(cfg),
        decode_step=functools.partial(transformer.decode_step, cfg),
        init_cache=functools.partial(transformer.init_cache, cfg),
    )


# ----------------------------------------------------------------------------
# Shape support (DESIGN.md §long_500k / decode skips)
# ----------------------------------------------------------------------------


def shape_supported(cfg: ModelConfig, shape: InputShape) -> Tuple[bool, str]:
    if cfg.family == "cnn":
        if shape.kind == "train":
            return True, ""
        return False, "papernet is the paper's train-only CIFAR workload"
    if shape.name == "long_500k":
        has_ssm = any(c in ("M", "M2") for c in cfg.pattern_layers)
        if has_ssm or cfg.window > 0:
            return True, ""
        return (
            False,
            "pure full-attention arch: 524k decode requires sub-quadratic "
            "attention (DESIGN.md §long_500k skips)",
        )
    return True, ""


# ----------------------------------------------------------------------------
# Input specs (meta tensors)
# ----------------------------------------------------------------------------


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _token_split(cfg: ModelConfig, seq_len: int) -> Tuple[int, int]:
    """(n_stub_positions, n_text_tokens) summing to seq_len."""
    if cfg.family == "vlm":
        p = min(cfg.vision_patches, seq_len // 2)
        return p, seq_len - p
    return 0, seq_len


def input_specs(cfg: ModelConfig, shape: InputShape) -> Dict[str, Any]:
    """Meta tensors, with the shapes and dtypes of the JAX package's
    ``ShapeDtypeStruct``s, for the step selected by ``shape.kind``."""
    _check_family(cfg)
    b, s = shape.global_batch, shape.seq_len
    dt = dtype_of(cfg.dtype)

    if cfg.family == "cnn":
        return {
            "images": _meta((b, 32, 32, 3), torch.float32),
            "labels": _meta((b,), torch.int32),
        }

    if shape.kind == "decode":
        return {
            "cache": build(cfg).init_cache(b, s, dt, device="meta"),
            "token": _meta((b,), torch.int32),
            "pos": _meta((), torch.int32),
        }

    if cfg.family == "audio":
        specs = {
            "frames": _meta((b, cfg.encoder_frames, cfg.d_model), dt),
            "tokens": _meta((b, s), torch.int32),
        }
        if shape.kind == "train":
            specs["labels"] = _meta((b, s), torch.int32)
        return specs

    n_patch, n_text = _token_split(cfg, s)
    specs: Dict[str, Any] = {"tokens": _meta((b, n_text), torch.int32)}
    if cfg.family == "vlm":
        specs["patch_embeds"] = _meta((b, n_patch, cfg.d_model), dt)
        specs["positions3"] = _meta((3, b, s), torch.int32)
    if shape.kind == "train":
        specs["labels"] = _meta((b, s), torch.int32)
    return specs


def demo_inputs(cfg: ModelConfig, shape: InputShape,
                generator: torch.Generator, *,
                device: DeviceLike = None) -> Dict[str, Any]:
    """Concrete random inputs matching input_specs (for smoke tests),
    drawn from a CPU ``generator`` and moved to ``device`` (``None``
    means ``cuda``)."""
    dev = resolve_device(device)
    specs = input_specs(cfg, shape)

    def materialize(path, spec):
        name = path[-1] if isinstance(path[-1], str) else ""
        if not spec.dtype.is_floating_point:
            hi = cfg.vocab if "token" in name or "label" in name else max(
                2, shape.seq_len)
            x = torch.randint(0, hi, spec.shape, generator=generator,
                              dtype=spec.dtype)
        else:
            x = (torch.randn(spec.shape, generator=generator)
                 * 0.02).to(spec.dtype)
        return x.to(dev)

    return tree_map_with_path(materialize, specs)
