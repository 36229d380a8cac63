"""Attention: GQA with chunked (memory-bounded) softmax, sliding window,
QK-norm, RoPE/M-RoPE, cross-attention, and single-token decode against a
KV cache.

The PyTorch counterpart of the JAX package's ``models/attention.py``, as
plain tensor math: the reference is XLA there, not a Pallas kernel, and
``F.scaled_dot_product_attention`` masks and rounds otherwise than its
float32 softmax with the ``NEG_INF`` guard. Scores are never
materialized for the whole (Sq, Sk) plane: a Python loop over query
chunks (the reference's ``lax.scan``) bounds the live scores to (B, H,
cq, Sk_band), and sliding-window layers slice a static-length KV band
per chunk, so window attention is O(S*w). Chunk counts and band offsets
are Python ints computed from shapes, so every function runs under
``torch.func.vmap`` / ``grad``. The reference's head constraints
(``_constrain_heads``, the ``ctx`` argument) shard the heads over the
``model`` axis; the port's sharded path (``train/trainer.py``) runs on
worker axes alone, and tensor parallelism over ``model`` inside the
models waits for ROADMAP.md queue 1 item 13b.
"""
from __future__ import annotations

import math
import torch

from repro_torch.config import ModelConfig
from repro_torch.models.layers import (
    Params,
    apply_mrope,
    apply_rope,
    dense_init,
    rms_norm,
)

NEG_INF = -1e30


def pick_chunk(s: int, target: int = 128) -> int:
    """Largest divisor of ``s`` that is <= target (static)."""
    if s <= target:
        return s
    for c in range(target, 0, -1):
        if s % c == 0:
            return c
    return s


def attn_params(gen: torch.Generator, cfg: ModelConfig, dtype) -> Params:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.hd
    p = {
        "wq": dense_init(gen, d, h * hd, dtype),
        "wk": dense_init(gen, d, kv * hd, dtype),
        "wv": dense_init(gen, d, kv * hd, dtype),
        "wo": dense_init(gen, h * hd, d, dtype),
    }
    if cfg.qk_norm:
        p["q_norm_scale"] = torch.zeros((hd,), dtype=torch.float32)
        p["k_norm_scale"] = torch.zeros((hd,), dtype=torch.float32)
    return p


def _sdpa(q, k, v, mask, scale: float):
    """q: (B, cq, H, hd); k/v: (B, Sk, KV, hd); mask: (B or 1, cq, Sk)
    bool or None.

    GQA via reshape to (B, cq, KV, G, hd). Softmax in f32.
    """
    b, cq, h, hd = q.shape
    kvh = k.shape[2]
    g = h // kvh
    qg = q.reshape(b, cq, kvh, g, hd)
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg, k).to(torch.float32) \
        * scale
    if mask is not None:
        scores = torch.where(mask[:, None, None, :, :], scores, NEG_INF)
    m = torch.amax(scores, dim=-1, keepdim=True)
    m = torch.clamp(m, min=NEG_INF)  # guard fully-masked rows
    p = torch.exp(scores - m)
    denom = torch.sum(p, dim=-1, keepdim=True)
    p = (p / torch.clamp(denom, min=1e-30)).to(v.dtype)
    out = torch.einsum("bkgqs,bskh->bqkgh", p, v)
    return out.reshape(b, cq, h, hd)


def multi_head_attention(
    q,
    k,
    v,
    *,
    causal: bool = True,
    window: int = 0,
    q_offset: int = 0,
    chunk_q: int = 128,
):
    """Chunked attention. q: (B, Sq, H, hd); k/v: (B, Sk, KV, hd).

    ``q_offset``: absolute position of q[0] (k positions start at 0).
    ``window`` > 0: sliding-window causal attention over a static KV band.
    (The reference's ``kv_len``, a per-batch valid KV length that no
    caller passes, is left out.)
    """
    b, sq, h, hd = q.shape
    sk = k.shape[1]
    scale = 1.0 / math.sqrt(hd)
    cq = pick_chunk(sq, chunk_q)
    n_chunks = sq // cq
    dev = q.device

    use_band = causal and window > 0 and sk > window + cq
    band = window + cq if use_band else sk

    outs = []
    for iq in range(n_chunks):
        qs = iq * cq
        qc = q[:, qs:qs + cq]
        qpos = q_offset + qs + torch.arange(cq, device=dev)
        if use_band:
            # static-length KV band ending at the chunk's last position
            start = min(max(qs + q_offset + cq - band, 0), sk - band)
            kc = k[:, start:start + band]
            vc = v[:, start:start + band]
        else:
            start, kc, vc = 0, k, v
        kpos = start + torch.arange(band, device=dev)
        mask = torch.ones((1, cq, band), dtype=torch.bool, device=dev)
        if causal:
            mask = mask & (kpos[None, :] <= qpos[:, None])[None]
        if window > 0:
            mask = mask & (kpos[None, :] > qpos[:, None] - window)[None]
        outs.append(_sdpa(qc, kc, vc, mask, scale))
    return outs[0] if n_chunks == 1 else torch.cat(outs, dim=1)


def decode_attention(q1, cache_k, cache_v, pos, *, window: int = 0):
    """One-token attention. q1: (B, 1, H, hd); cache_* : (B, Smax, KV, hd);
    ``pos``: scalar index of the new token (cache holds [0, pos]).

    For windowed layers the cache is a ring buffer of size ``window``
    (all slots valid once pos >= window; positions implicit — softmax is
    permutation-invariant so ring order is fine).
    """
    b, smax, kvh, hd = cache_k.shape
    scale = 1.0 / math.sqrt(hd)
    h = q1.shape[2]
    g = h // kvh
    qg = q1.reshape(b, 1, kvh, g, hd)
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg, cache_k).to(
        torch.float32) * scale
    valid = torch.arange(smax, device=q1.device) <= pos
    scores = torch.where(valid[None, None, None, None, :], scores, NEG_INF)
    m = torch.amax(scores, dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    p = (p / torch.clamp(torch.sum(p, dim=-1, keepdim=True), min=1e-30)).to(
        cache_v.dtype)
    out = torch.einsum("bkgqs,bskh->bqkgh", p, cache_v)
    return out.reshape(b, 1, h, hd)


def _project_qkv(cfg: ModelConfig, p: Params, x):
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv, cfg.hd
    q = (x @ p["wq"]).reshape(b, s, h, hd)
    k = (x @ p["wk"]).reshape(b, s, kv, hd)
    v = (x @ p["wv"]).reshape(b, s, kv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm_scale"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm_scale"], cfg.norm_eps)
    return q, k, v


def _apply_pos(cfg: ModelConfig, q, k, positions):
    if cfg.pos_type == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    elif cfg.pos_type == "mrope":
        q = apply_mrope(q, positions, cfg.rope_theta, cfg.mrope_sections)
        k = apply_mrope(k, positions, cfg.rope_theta, cfg.mrope_sections)
    return q, k


def self_attention(cfg: ModelConfig, p: Params, x, positions, *,
                   window=0, causal: bool = True):
    """Full-sequence self attention (train / prefill).

    ``window`` may be a tensor (a per-layer scalar); the static band
    optimization is applied only when it is a Python int.
    """
    q, k, v = _project_qkv(cfg, p, x)
    q, k = _apply_pos(cfg, q, k, positions)
    if isinstance(window, int):
        out = multi_head_attention(q, k, v, causal=causal, window=window)
    else:
        # tensor window: compute full attention, mask by the window
        out = _traced_window_attention(q, k, v, window)
    b, s = x.shape[:2]
    return out.reshape(b, s, cfg.n_heads * cfg.hd) @ p["wo"]


def _traced_window_attention(q, k, v, window):
    """Causal attention where ``window`` is a tensor scalar (0 =
    unlimited).

    The reference uses it in scans over layer stacks whose pattern mixes
    'W' and 'A' layers. Cost is O(S^2) for the W layers too; the banded
    path handles static windows.
    """
    b, sq, h, hd = q.shape
    sk = k.shape[1]
    scale = 1.0 / math.sqrt(hd)
    cq = pick_chunk(sq, 128)
    n_chunks = sq // cq
    kpos = torch.arange(sk, device=q.device)
    outs = []
    for iq in range(n_chunks):
        qs = iq * cq
        qc = q[:, qs:qs + cq]
        qpos = qs + torch.arange(cq, device=q.device)
        mask = (kpos[None, :] <= qpos[:, None])[None]
        wmask = torch.where(window > 0, kpos[None, :] > qpos[:, None] - window,
                            True)[None]
        outs.append(_sdpa(qc, k, v, mask & wmask, scale))
    return outs[0] if n_chunks == 1 else torch.cat(outs, dim=1)


def pos_tensor(pos, device) -> torch.Tensor:
    """A decode position as a 0-d int64 tensor on ``device``. An int is
    filled in on the device: a copy from the host would wait for the
    device's queue to drain, once a layer."""
    if isinstance(pos, torch.Tensor):
        return pos.to(device=device, dtype=torch.int64)
    return torch.full((), pos, dtype=torch.int64, device=device)


def self_attention_decode(cfg, p, x1, cache_k, cache_v, pos, *,
                          window: int = 0):
    """One-token self attention with functional cache update.

    Returns (out, new_k, new_v). Cache layout: (B, Smax, KV, hd); for
    windowed layers Smax == window and the write index wraps (ring
    buffer). ``pos`` is an int or a 0-d integer tensor. A write index past
    the cache raises (``index_copy``), where the reference's
    ``dynamic_update_slice`` clamps it onto the last slot.
    """
    b = x1.shape[0]
    pos_t = pos_tensor(pos, x1.device)
    q, k, v = _project_qkv(cfg, p, x1)  # (B,1,...)
    if cfg.pos_type == "mrope":
        q, k = _apply_pos(cfg, q, k, pos_t.reshape(1, 1, 1).expand(3, b, 1))
    else:
        q, k = _apply_pos(cfg, q, k, pos_t.reshape(1, 1).expand(b, 1))
    smax = cache_k.shape[1]
    widx = torch.remainder(pos_t, smax) if window > 0 and smax == window \
        else pos_t
    widx = widx.reshape(1)
    new_k = cache_k.index_copy(1, widx, k.to(cache_k.dtype))
    new_v = cache_v.index_copy(1, widx, v.to(cache_v.dtype))
    out = decode_attention(q, new_k, new_v, pos_t, window=window)
    out = out.reshape(b, 1, cfg.n_heads * cfg.hd) @ p["wo"]
    return out, new_k, new_v


def cross_attention(cfg: ModelConfig, p: Params, x, enc_kv):
    """Encoder-decoder cross attention (whisper). enc_kv: precomputed
    (k, v) from encoder output, each (B, Senc, KV, hd)."""
    b, s, _ = x.shape
    h, hd = cfg.n_heads, cfg.hd
    q = (x @ p["wq"]).reshape(b, s, h, hd)
    k, v = enc_kv
    out = multi_head_attention(q, k, v, causal=False, window=0)
    return out.reshape(b, s, h * hd) @ p["wo"]


def cross_attn_params(gen: torch.Generator, cfg: ModelConfig,
                      dtype) -> Params:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.hd
    return {
        "wq": dense_init(gen, d, h * hd, dtype),
        "wk": dense_init(gen, d, kv * hd, dtype),
        "wv": dense_init(gen, d, kv * hd, dtype),
        "wo": dense_init(gen, h * hd, d, dtype),
    }
