"""Shared building blocks: inits, norms, MLPs, rotary embeddings.

The PyTorch counterpart of the JAX package's ``models/layers.py``, over
the same parameter trees (nested dicts of tensors, weights stored
``(d_in, d_out)`` and applied as ``x @ w``). Inits draw from a
``torch.Generator`` on its own device (a CPU one gives the same values
whatever device the model then lives on): the distribution of the
reference (normal x 0.02, RMS scales zero), not its values. Every op is
out of place, so the functions run under ``torch.func.vmap`` /
``grad``.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig

Params = Dict[str, torch.Tensor]


def dtype_of(name: str) -> torch.dtype:
    """A config's ``dtype`` string as a torch dtype."""
    return getattr(torch, name)


# ----------------------------------------------------------------------------
# Init helpers
# ----------------------------------------------------------------------------


def normal(gen: torch.Generator, shape) -> torch.Tensor:
    """Standard normals of ``shape`` drawn from ``gen`` on its device."""
    return torch.randn(shape, generator=gen, device=gen.device)


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype,
               scale: float = 0.02) -> torch.Tensor:
    return (normal(gen, (d_in, d_out)) * scale).to(dtype)


# ----------------------------------------------------------------------------
# Norms
# ----------------------------------------------------------------------------


def rms_norm(x, scale, eps: float = 1e-6):
    dt = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.to(torch.float32))).to(dt)


def layer_norm(x, scale, offset, eps: float = 1e-6):
    dt = x.dtype
    x = x.to(torch.float32)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    out = (x - mu) * torch.rsqrt(var + eps)
    return (out * scale.to(torch.float32)
            + offset.to(torch.float32)).to(dt)


def norm_params(cfg: ModelConfig, d: int) -> Params:
    if cfg.norm_type == "rms":
        return {"scale": torch.zeros((d,), dtype=torch.float32)}
    return {"scale": torch.ones((d,), dtype=torch.float32),
            "offset": torch.zeros((d,), dtype=torch.float32)}


def apply_norm(cfg: ModelConfig, p: Params, x):
    if cfg.norm_type == "rms":
        return rms_norm(x, p["scale"], cfg.norm_eps)
    return layer_norm(x, p["scale"], p["offset"], cfg.norm_eps)


# ----------------------------------------------------------------------------
# MLP
# ----------------------------------------------------------------------------


def mlp_params(gen: torch.Generator, cfg: ModelConfig, d: int, ff: int,
               dtype) -> Params:
    if cfg.mlp_type == "swiglu":
        return {
            "w_gate": dense_init(gen, d, ff, dtype),
            "w_up": dense_init(gen, d, ff, dtype),
            "w_down": dense_init(gen, ff, d, dtype),
        }
    return {
        "w_up": dense_init(gen, d, ff, dtype),
        "w_down": dense_init(gen, ff, d, dtype),
    }


def apply_mlp(cfg: ModelConfig, p: Params, x):
    if cfg.mlp_type == "swiglu":
        g = F.silu(x @ p["w_gate"])
        return (g * (x @ p["w_up"])) @ p["w_down"]
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x @ p["w_up"], approximate="tanh") @ p["w_down"]


# ----------------------------------------------------------------------------
# Rotary embeddings (plain + M-RoPE), by split halves
# ----------------------------------------------------------------------------


def rope_freqs(hd: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=device) / hd))


def _rotate(x, ang):
    """x: (..., S, H, hd) by angles (..., S, hd/2): the halves of the
    head dim rotate as (x1, x2) pairs, not interleaved."""
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    inv = rope_freqs(x.shape[-1], theta, x.device)  # (hd/2,)
    ang = positions.to(torch.float32)[..., None] * inv  # (..., S, hd/2)
    return _rotate(x, ang)


def apply_mrope(x, positions3, theta: float, sections: Tuple[int, ...]):
    """Qwen2-VL multimodal RoPE.

    positions3: (3, ..., S) — temporal / height / width position ids.
    sections: per-axis sizes of the half-dim split (sum == hd//2).
    """
    hd = x.shape[-1]
    inv = rope_freqs(hd, theta, x.device)  # (hd/2,)
    # section id per frequency slot (padded with the last id, as
    # jnp.repeat's total_repeat_length pads)
    sec_id = torch.repeat_interleave(
        torch.arange(len(sections)), torch.tensor(sections))
    pad = sec_id[-1:].expand(max(0, hd // 2 - len(sec_id)))
    sec_id = torch.cat([sec_id, pad])[: hd // 2].to(x.device)
    pos = positions3.to(torch.float32)            # (3, ..., S)
    pos_slot = torch.movedim(pos[sec_id], 0, -1)  # (..., S, hd/2)
    return _rotate(x, pos_slot * inv)


# ----------------------------------------------------------------------------
# Embedding / unembedding
# ----------------------------------------------------------------------------


def embed_params(gen: torch.Generator, cfg: ModelConfig, dtype) -> Params:
    p = {"embed": dense_init(gen, cfg.vocab_padded, cfg.d_model, dtype)}
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(gen, cfg.d_model, cfg.vocab_padded, dtype)
    return p


def embed_tokens(p: Params, tokens):
    return F.embedding(tokens, p["embed"])


def unembed(p: Params, x):
    if "lm_head" in p:
        return x @ p["lm_head"]
    return x @ p["embed"].T


def cross_entropy(logits, labels, vocab: int):
    """Mean next-token CE in float32; labels < 0 are masked out.

    ``vocab`` is the true (unpadded) vocab — padded logit columns are
    masked with -1e30.
    """
    logits = logits.to(torch.float32)
    if logits.shape[-1] > vocab:
        neg = torch.full(logits.shape[:-1] + (logits.shape[-1] - vocab,),
                         -1e30, dtype=logits.dtype, device=logits.device)
        logits = torch.cat([logits[..., :vocab], neg], dim=-1)
    lse = torch.logsumexp(logits, dim=-1)
    lab = torch.clamp(labels, min=0).to(torch.int64)
    picked = torch.gather(logits, -1, lab[..., None])[..., 0]
    nll = lse - picked
    mask = (labels >= 0).to(torch.float32)
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
