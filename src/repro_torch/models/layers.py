"""Shared building blocks: inits, norms, MLPs, rotary embeddings.

The PyTorch counterpart of the JAX package's ``models/layers.py``, over
the same parameter trees (nested dicts of tensors, weights stored
``(d_in, d_out)`` and applied as ``x @ w``). Inits draw from a
``torch.Generator`` on its own device (a CPU one gives the same values
whatever device the model then lives on): the distribution of the
reference (normal x 0.02, RMS scales zero), not its values; a
generator of ``None`` draws nothing and gives meta tensors of the same
shapes (the layout of a global tree, ``sharding.model_specs``). Every
op is out of place, so the functions run under ``torch.func.vmap`` /
``grad``.

Under a ``ShardCtx`` (``ctx=``, tensor parallelism over ``model``):
``embed_tokens`` looks up this rank's ``d_model`` columns of the table
and gathers them; ``apply_mlp`` is column-parallel in ``w_gate`` /
``w_up`` and row-parallel in ``w_down``; ``unembed`` gives this rank's
vocab block of the logits (the untied head split over vocab, the tied
table resharded from columns to rows), and ``cross_entropy`` reduces
over such a block with a vocab-parallel logsumexp (the max and the sum
all-reduced), so no rank holds the whole logits.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.models.sharding import (
    all_max,
    cols_to_rows,
    copy_in,
    gather,
    reduce_both,
    reduce_out,
    row_parallel,
    rows_of,
    split,
)

Params = Dict[str, torch.Tensor]


def dtype_of(name: str) -> torch.dtype:
    """A config's ``dtype`` string as a torch dtype."""
    return getattr(torch, name)


# ----------------------------------------------------------------------------
# Init helpers
# ----------------------------------------------------------------------------


def normal(gen: torch.Generator, shape) -> torch.Tensor:
    """Standard normals of ``shape`` drawn from ``gen`` on its device;
    with ``gen`` ``None``, a meta tensor of that shape."""
    if gen is None:
        return torch.empty(shape, device="meta")
    return torch.randn(shape, generator=gen, device=gen.device)


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype,
               scale: float = 0.02) -> torch.Tensor:
    return (normal(gen, (d_in, d_out)) * scale).to(dtype)


# ----------------------------------------------------------------------------
# Norms
# ----------------------------------------------------------------------------


def rms_norm(x, scale, eps: float = 1e-6, ctx=None):
    """Under ``ctx`` ``x`` (and ``scale``) is this rank's block of the
    last dim, and the mean of squares is over every rank's block: the
    sum summed both ways over ``model`` (``reduce_both``)."""
    dt = x.dtype
    x = x.to(torch.float32)
    sq = torch.square(x)
    if ctx is None:
        var = torch.mean(sq, dim=-1, keepdim=True)
    else:
        var = reduce_both(torch.sum(sq, dim=-1, keepdim=True), ctx) \
            / (x.shape[-1] * ctx.nm)
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


def apply_mlp(cfg: ModelConfig, p: Params, x, ctx=None):
    """The dense MLP; under ``ctx``, split over ``d_ff`` when it divides
    the ``model`` axis (else replicated)."""
    tp = split(ctx, cfg.d_ff)
    x = copy_in(x, tp)
    if cfg.mlp_type == "swiglu":
        h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    else:
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(x @ p["w_up"], approximate="tanh")
    return row_parallel(h, p["w_down"], tp)


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


def embed_tokens(p: Params, tokens, ctx=None):
    """The lookup; under ``ctx`` the table is this rank's block of
    ``d_model`` columns (``spec_for``'s ``embed`` at ``fsdp=False``) and
    the rows are gathered over ``model``."""
    return gather(F.embedding(tokens, p["embed"]), ctx, -1)


def unembed(p: Params, x, ctx=None):
    """Logits of the full-width ``x``. Under ``ctx``, when the padded
    vocab divides the ``model`` axis, this rank's block of vocab columns
    (``cross_entropy(..., ctx=ctx)`` reduces over it); otherwise the
    whole logits on every rank."""
    e = p["embed"]
    vctx = split(ctx, e.shape[0])
    if "lm_head" in p:
        return copy_in(x, vctx) @ p["lm_head"]
    if ctx is None:
        return x @ e.T
    cols = e.shape[1] != x.shape[-1]   # the table split over d_model
    if vctx is None:
        return x @ (gather(e, ctx, 1) if cols else e).T
    e = cols_to_rows(e, ctx) if cols else rows_of(e, ctx)
    return copy_in(x, ctx) @ e.T


def gather_vocab(logits, vocab_padded: int, ctx=None):
    """``unembed``'s logits made whole on every rank: under ``ctx``, where
    they are this rank's vocab block (``vocab_padded`` divides
    ``model``), every rank's blocks gathered in vocab order (the serve
    path's vocab-parallel logits); as they are otherwise."""
    return gather(logits, split(ctx, vocab_padded), -1)


def cross_entropy(logits, labels, vocab: int, ctx=None):
    """Mean next-token CE in float32; labels < 0 are masked out.

    ``vocab`` is the true (unpadded) vocab — padded logit columns are
    masked with -1e30. Under ``ctx``, ``logits`` is this rank's block of
    vocab columns, and the logsumexp and the label's logit are reduced
    over ``model``.
    """
    logits = logits.to(torch.float32)
    if ctx is not None:
        return _vocab_parallel_ce(logits, labels, vocab, ctx)
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


def _vocab_parallel_ce(logits, labels, vocab: int, ctx):
    """``cross_entropy`` over this rank's vocab block of float32
    ``logits``: max and sum of the logsumexp all-reduced, the label's
    logit from the rank whose block holds it."""
    n = logits.shape[-1]
    off = ctx.index * n
    col = off + torch.arange(n, device=logits.device)
    logits = torch.where(col < vocab, logits, -1e30)
    m = all_max(torch.amax(logits, dim=-1), ctx)
    s = reduce_out(torch.sum(torch.exp(logits - m[..., None]), dim=-1), ctx)
    lse = torch.log(s) + m
    loc = torch.clamp(labels, min=0).to(torch.int64) - off
    mine = (loc >= 0) & (loc < n)
    picked = torch.gather(logits, -1, torch.clamp(loc, 0, n - 1)[..., None])
    picked = reduce_out(torch.where(mine, picked[..., 0], 0.0), ctx)
    nll = lse - picked
    mask = (labels >= 0).to(torch.float32)
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
