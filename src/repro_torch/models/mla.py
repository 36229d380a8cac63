"""Multi-head Latent Attention (DeepSeek-V2, arXiv:2405.04434).

The PyTorch counterpart of the JAX package's ``models/mla.py``, over the
same parameter tree. Train/prefill decompress K/V from the latent;
decode uses the *absorbed* formulation: the query is projected into the
kv_lora latent space so the KV cache holds only (c_kv: kv_lora) +
(k_rope: qk_rope_dim) per token (576 values a token and layer at
deepseek-v2's widths, against 32,768 for plain MHA of 128 heads of 128).

Under a ``ShardCtx`` (``ctx=``) whose axis both ``n_heads`` and ``n_kv``
divide, ``mla_attention`` runs head-parallel: the latent projections
``w_dq`` and ``w_dkv`` and their norms are replicated, so the latents
``cq``, ``c_kv`` and ``k_rope`` are computed whole on every rank; they
enter the parallel block (``copy_in``) where this rank's column blocks
of ``w_uq`` (or ``wq``), ``w_uk`` and ``w_uv``, whole heads, take them.
Each rank's heads see only part of the latents' gradient, which
``copy_in`` sums, so ``w_dq``, ``w_dkv`` and the norms get their whole
gradient on every rank. ``wo`` is a row block (``row_parallel``).
Elsewhere the attention runs replicated. The absorbed decode
(``mla_decode``) splits the same heads against the latent cache, which
every rank holds whole.
"""
from __future__ import annotations

import math

import torch

from repro_torch.config import ModelConfig
from repro_torch.models.attention import (
    NEG_INF,
    multi_head_attention,
    pos_tensor,
)
from repro_torch.models.layers import Params, apply_rope, dense_init, rms_norm
from repro_torch.models.sharding import copy_in, row_parallel


def mla_params(gen: torch.Generator, cfg: ModelConfig, dtype) -> Params:
    d, h = cfg.d_model, cfg.n_heads
    qk = cfg.qk_nope_dim + cfg.qk_rope_dim
    p = {
        "w_dkv": dense_init(gen, d, cfg.kv_lora + cfg.qk_rope_dim, dtype),
        "w_uk": dense_init(gen, cfg.kv_lora, h * cfg.qk_nope_dim, dtype),
        "w_uv": dense_init(gen, cfg.kv_lora, h * cfg.v_head_dim, dtype),
        "wo": dense_init(gen, h * cfg.v_head_dim, d, dtype),
        "kv_norm_scale": torch.zeros((cfg.kv_lora,), dtype=torch.float32),
    }
    if cfg.q_lora > 0:
        p["w_dq"] = dense_init(gen, d, cfg.q_lora, dtype)
        p["w_uq"] = dense_init(gen, cfg.q_lora, h * qk, dtype)
        p["q_norm_scale"] = torch.zeros((cfg.q_lora,), dtype=torch.float32)
    else:
        p["wq"] = dense_init(gen, d, h * qk, dtype)
    return p


def _queries(cfg: ModelConfig, p: Params, x, tp=None):
    """(q_nope, q_rope) of the heads whose columns ``p`` holds (all, or
    under ``tp`` this rank's); the normed ``cq`` (or ``x`` without
    ``q_lora``) enters the parallel block here."""
    b, s, _ = x.shape
    qk = cfg.qk_nope_dim + cfg.qk_rope_dim
    if cfg.q_lora > 0:
        cq = x @ p["w_dq"]
        cq = copy_in(rms_norm(cq, p["q_norm_scale"], cfg.norm_eps), tp)
        q = cq @ p["w_uq"]
    else:
        q = copy_in(x, tp) @ p["wq"]
    q = q.reshape(b, s, -1, qk)
    return q[..., : cfg.qk_nope_dim], q[..., cfg.qk_nope_dim :]


def _latents(cfg: ModelConfig, p: Params, x, positions):
    """Returns (c_kv normed, k_rope with rope applied)."""
    ckv_full = x @ p["w_dkv"]
    c_kv = rms_norm(ckv_full[..., : cfg.kv_lora], p["kv_norm_scale"],
                    cfg.norm_eps)
    k_rope = ckv_full[..., cfg.kv_lora :][:, :, None, :]  # (B,S,1,rope)
    k_rope = apply_rope(k_rope, positions, cfg.rope_theta)
    return c_kv, k_rope


def mla_attention(cfg: ModelConfig, p: Params, x, positions, tp=None):
    """Full-sequence MLA (train/prefill). Decompresses K/V per layer.
    ``tp``: the heads split over ``model`` (``attention.heads_ctx``)."""
    b, s, _ = x.shape
    q_nope, q_rope = _queries(cfg, p, x, tp)
    h = q_nope.shape[2]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    c_kv, k_rope = _latents(cfg, p, x, positions)
    c_kv, k_rope = copy_in(c_kv, tp), copy_in(k_rope, tp)
    k_nope = (c_kv @ p["w_uk"]).reshape(b, s, h, cfg.qk_nope_dim)
    v = (c_kv @ p["w_uv"]).reshape(b, s, h, cfg.v_head_dim)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope.expand(b, s, h, cfg.qk_rope_dim)], dim=-1)
    # pad v to q/k head_dim so the shared chunked attention applies, then
    # crop
    pad = q.shape[-1] - cfg.v_head_dim
    vp = torch.nn.functional.pad(v, (0, pad)) if pad > 0 else v
    out = multi_head_attention(q, k, vp, causal=True)[..., : cfg.v_head_dim]
    return row_parallel(out.reshape(b, s, h * cfg.v_head_dim), p["wo"], tp)


def mla_decode(cfg: ModelConfig, p: Params, x1, cache_ckv, cache_krope,
               pos, tp=None):
    """Absorbed one-token MLA decode.

    cache_ckv: (B, Smax, kv_lora); cache_krope: (B, Smax, qk_rope_dim);
    ``pos`` an int or a 0-d integer tensor. Returns (out, new_ckv,
    new_krope). A write index past the cache raises (``index_copy``),
    where the reference's ``dynamic_update_slice`` clamps it onto the
    last slot. ``tp`` (``attention.heads_ctx``): this rank's heads of
    ``w_uq`` (or ``wq``), ``w_uk`` and ``w_uv`` against the replicated
    latent cache, ``wo`` a row block.
    """
    b = x1.shape[0]
    scale = 1.0 / math.sqrt(cfg.qk_nope_dim + cfg.qk_rope_dim)
    pos_t = pos_tensor(pos, x1.device)
    positions = pos_t.reshape(1, 1).expand(b, 1)

    q_nope, q_rope = _queries(cfg, p, x1, tp)  # (B,1,h,*)
    h = q_nope.shape[2]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    c_kv1, k_rope1 = _latents(cfg, p, x1, positions)

    widx = pos_t.reshape(1)
    new_ckv = cache_ckv.index_copy(1, widx, c_kv1.to(cache_ckv.dtype))
    new_krope = cache_krope.index_copy(
        1, widx, k_rope1[:, :, 0, :].to(cache_krope.dtype))

    # absorb W_uk into the query: q_abs (B,1,h,kv_lora)
    w_uk = p["w_uk"].reshape(cfg.kv_lora, h, cfg.qk_nope_dim)
    q_abs = torch.einsum("bqhd,lhd->bqhl", q_nope, w_uk)
    scores = (
        torch.einsum("bqhl,bsl->bhqs", q_abs, new_ckv)
        + torch.einsum("bqhd,bsd->bhqs", q_rope, new_krope)
    ).to(torch.float32) * scale
    valid = torch.arange(cache_ckv.shape[1], device=x1.device) <= pos_t
    scores = torch.where(valid[None, None, None, :], scores, NEG_INF)
    m = torch.amax(scores, dim=-1, keepdim=True)
    pr = torch.exp(scores - m)
    pr = (pr / torch.clamp(torch.sum(pr, dim=-1, keepdim=True),
                           min=1e-30)).to(new_ckv.dtype)
    out_lat = torch.einsum("bhqs,bsl->bqhl", pr, new_ckv)  # (B,1,h,kv_lora)
    w_uv = p["w_uv"].reshape(cfg.kv_lora, h, cfg.v_head_dim)
    out = torch.einsum("bqhl,lhv->bqhv", out_lat, w_uv)
    out = row_parallel(out.reshape(b, 1, h * cfg.v_head_dim), p["wo"], tp)
    return out, new_ckv, new_krope
