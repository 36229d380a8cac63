"""Encoder-decoder transformer (whisper backbone, arXiv:2212.04356).

The PyTorch counterpart of the JAX package's ``models/encdec.py``, over
the same parameter tree:

  params = {embed, enc_stack, dec_stack, enc_norm, final_norm}

with each layer's leaves stacked over the layers of its stack, so the
gradient stream's leaves, and so ``core.packets.make_plan``'s critical
packets, are the reference's. The mel + conv frontend is a stub, as in
the reference: inputs carry frame embeddings (B, encoder_frames,
d_model). Positions are sinusoidal on both sides, added to the frames
and to the token embeddings; ``pos_type="learned"`` applies nothing
inside attention.

Where the reference scans over a stack, this module loops in Python over
its leading axis (``transformer._unstack``). With ``remat``
(``loss_fn``'s default) each layer of either stack is rematerialised by
``transformer._Remat``, one Function a layer, as ``jax.checkpoint`` on
the scanned body checkpoints each scan step. A decoder layer reads the
encoder output for its cross-attention keys and values, so that output
is one of the Function's inputs: its grad, summed over the decoder
layers, carries the gradient of every encoder leaf.

The encoder's work, its forward and each layer's backward under remat,
runs inside the profiler span ``encoder``.

Serving: ``prefill`` runs the encoder and fills the cross K/V of every
decoder layer, in a cache as long as the prompt whose self K/V it leaves
at zero, as the reference's does; ``decode_step`` decodes one token
against a cache of ``init_cache``'s layout.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict

import torch
from torch.profiler import record_function

from repro_torch.config import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import attention as attn
from repro_torch.models.layers import (
    Params,
    apply_mlp,
    apply_norm,
    cross_entropy,
    dtype_of,
    embed_params,
    embed_tokens,
    mlp_params,
    norm_params,
    unembed,
)
from repro_torch.models.transformer import _Remat, _unstack
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

ENCODER_SPAN = "encoder"


def sinusoid(positions, d: int, dtype):
    """positions: (...,) -> (..., d) sinusoidal embedding."""
    half = d // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=positions.device)
        / max(half - 1, 1))
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


def _enc_layer_params(gen: torch.Generator, cfg: ModelConfig,
                      dtype) -> Params:
    return {
        "norm1": norm_params(cfg, cfg.d_model),
        "attn": attn.attn_params(gen, cfg, dtype),
        "norm2": norm_params(cfg, cfg.d_model),
        "mlp": mlp_params(gen, cfg, cfg.d_model, cfg.d_ff, dtype),
    }


def _dec_layer_params(gen: torch.Generator, cfg: ModelConfig,
                      dtype) -> Params:
    return {
        "norm1": norm_params(cfg, cfg.d_model),
        "self_attn": attn.attn_params(gen, cfg, dtype),
        "norm_x": norm_params(cfg, cfg.d_model),
        "cross_attn": attn.cross_attn_params(gen, cfg, dtype),
        "norm2": norm_params(cfg, cfg.d_model),
        "mlp": mlp_params(gen, cfg, cfg.d_model, cfg.d_ff, dtype),
    }


def init(generator: torch.Generator, cfg: ModelConfig, *,
         device: DeviceLike = None) -> Params:
    """Drawn from ``generator`` on its device (a CPU one gives the same
    values whatever ``device`` is), then moved to ``device`` (``None``
    means ``cuda``)."""
    dev = resolve_device(device)
    dtype = dtype_of(cfg.dtype)
    gen = generator
    embed = embed_params(gen, cfg, dtype)
    enc = [_enc_layer_params(gen, cfg, dtype)
           for _ in range(cfg.encoder_layers)]
    dec = [_dec_layer_params(gen, cfg, dtype) for _ in range(cfg.n_layers)]
    params = {
        "embed": embed,
        "enc_stack": tree_map(lambda *xs: torch.stack(xs), *enc),
        "dec_stack": tree_map(lambda *xs: torch.stack(xs), *dec),
        "enc_norm": norm_params(cfg, cfg.d_model),
        "final_norm": norm_params(cfg, cfg.d_model),
    }
    return tree_map(lambda x: x.to(dev), params)


def _enc_layer(cfg: ModelConfig, p: Params, x, positions):
    h = apply_norm(cfg, p["norm1"], x)
    x = x + attn.self_attention(cfg, p["attn"], h, positions, causal=False)
    return x + apply_mlp(cfg, p["mlp"], apply_norm(cfg, p["norm2"], x))


def _cross_kv(cfg: ModelConfig, p: Params, enc_out):
    b, f, _ = enc_out.shape
    k = (enc_out @ p["wk"]).reshape(b, f, cfg.n_kv, cfg.hd)
    v = (enc_out @ p["wv"]).reshape(b, f, cfg.n_kv, cfg.hd)
    return k, v


def _dec_layer(cfg: ModelConfig, p: Params, x, enc_out, positions):
    h = apply_norm(cfg, p["norm1"], x)
    x = x + attn.self_attention(cfg, p["self_attn"], h, positions)
    h = apply_norm(cfg, p["norm_x"], x)
    kv = _cross_kv(cfg, p["cross_attn"], enc_out)
    x = x + attn.cross_attention(cfg, p["cross_attn"], h, kv)
    return x + apply_mlp(cfg, p["mlp"], apply_norm(cfg, p["norm2"], x))


def _remat_layer(layer, p: Params, positions, *inputs, span=None):
    """``layer(p, *inputs, positions)`` through ``_Remat``: the layer's
    ``inputs`` (the carry, and a decoder layer's encoder output) and
    the leaves of ``p`` are the Function's inputs, so each gets its
    grad. With ``span``, the backward runs inside that profiler span."""
    n = len(inputs)

    def body(positions, *flat):
        t = tree_unflatten(p, list(flat[n:]))
        return (layer(t, *flat[:n], positions),)

    if span is not None:
        body.span = span
    return _Remat.apply(body, positions, *inputs, *tree_leaves(p))[0]


def encode(cfg: ModelConfig, params: Params, frames, *, remat: bool = True):
    """frames: (B, F, d) stubbed frontend output -> (B, F, d). Remat is
    skipped where grad mode is off."""
    with record_function(ENCODER_SPAN):
        b, f, _ = frames.shape
        dt = dtype_of(cfg.dtype)
        pos = torch.arange(f, device=frames.device)
        x = frames.to(dt) + sinusoid(pos, cfg.d_model, dt)
        positions = pos.expand(b, f)
        use_remat = remat and torch.is_grad_enabled()
        for p in _unstack(params["enc_stack"], cfg.encoder_layers):
            if use_remat:
                x = _remat_layer(functools.partial(_enc_layer, cfg), p,
                                 positions, x, span=ENCODER_SPAN)
            else:
                x = _enc_layer(cfg, p, x, positions)
        return apply_norm(cfg, params["enc_norm"], x)


def decode_train(cfg: ModelConfig, params: Params, tokens, enc_out, *,
                 remat: bool = True, last_only: bool = False):
    """Teacher-forced decoder over ``tokens`` (B, S) against ``enc_out``
    -> logits (B, S or 1, vocab_padded). Remat is skipped where grad mode
    is off."""
    b, s = tokens.shape
    x = embed_tokens(params["embed"], tokens).to(dtype_of(cfg.dtype))
    pos = torch.arange(s, device=x.device)
    x = x + sinusoid(pos, cfg.d_model, x.dtype)
    positions = pos.expand(b, s)
    use_remat = remat and torch.is_grad_enabled()
    for p in _unstack(params["dec_stack"], cfg.n_layers):
        if use_remat:
            # enc_out is an input of the Function, not a closure: the
            # encoder's grads flow back through it
            x = _remat_layer(functools.partial(_dec_layer, cfg), p,
                             positions, x, enc_out)
        else:
            # one alias a layer: its two cross K/V grads sum first, then
            # the layers' sums add up in order, as the Functions' grads
            # do under remat, so both paths give the same bits
            x = _dec_layer(cfg, p, x, enc_out.view_as(enc_out), positions)
    x = apply_norm(cfg, params["final_norm"], x)
    if last_only:
        x = x[:, -1:]
    return unembed(params["embed"], x)


def loss_fn(cfg: ModelConfig, params: Params, batch: Dict[str, Any], *,
            remat: bool = True):
    enc_out = encode(cfg, params, batch["frames"], remat=remat)
    logits = decode_train(cfg, params, batch["tokens"], enc_out,
                          remat=remat)
    return cross_entropy(logits, batch["labels"], cfg.vocab)


# ----------------------------------------------------------------------------
# Serving
# ----------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, *, device: DeviceLike = None):
    """Self K/V per decoder layer + precomputed cross K/V per layer.
    ``device`` ``None`` means ``cuda``; ``"meta"`` gives shapes and
    dtypes alone."""
    dev = resolve_device(device)
    if isinstance(dtype, str):
        dtype = dtype_of(dtype)
    nl = cfg.n_layers
    self_shp = (nl, batch, max_seq, cfg.n_kv, cfg.hd)
    cross_shp = (nl, batch, cfg.encoder_frames, cfg.n_kv, cfg.hd)
    return {
        "self_k": torch.zeros(self_shp, dtype=dtype, device=dev),
        "self_v": torch.zeros(self_shp, dtype=dtype, device=dev),
        "cross_k": torch.zeros(cross_shp, dtype=dtype, device=dev),
        "cross_v": torch.zeros(cross_shp, dtype=dtype, device=dev),
    }


def prefill(cfg: ModelConfig, params: Params, inputs):
    """Runs the encoder and fills cross K/V; returns (last-token logits,
    cache). The cache is as long as the prompt, its self K/V zero."""
    frames, tokens = inputs["frames"], inputs["tokens"]
    enc_out = encode(cfg, params, frames, remat=False)
    logits = decode_train(cfg, params, tokens, enc_out, remat=False,
                          last_only=True)
    b, s = tokens.shape
    cache = init_cache(cfg, b, s, dtype_of(cfg.dtype), device=tokens.device)
    ks, vs = [], []
    for p in _unstack(params["dec_stack"]["cross_attn"], cfg.n_layers):
        k, v = _cross_kv(cfg, p, enc_out)
        ks.append(k.to(cache["cross_k"].dtype))
        vs.append(v.to(cache["cross_v"].dtype))
    cache["cross_k"] = torch.stack(ks)
    cache["cross_v"] = torch.stack(vs)
    return logits[:, 0], cache


def decode_step(cfg: ModelConfig, params: Params, cache: Dict[str, Any],
                token, pos):
    """One decoder token. token: (B,) integer; pos: int or 0-d integer
    tensor. Returns (logits (B, vocab_padded), new_cache)."""
    x = embed_tokens(params["embed"], token[:, None]).to(dtype_of(cfg.dtype))
    pos = attn.pos_tensor(pos, x.device)
    x = x + sinusoid(pos.reshape(1), cfg.d_model, x.dtype)
    nk, nv = [], []
    for i, p in enumerate(_unstack(params["dec_stack"], cfg.n_layers)):
        h = apply_norm(cfg, p["norm1"], x)
        out, k_i, v_i = attn.self_attention_decode(
            cfg, p["self_attn"], h, cache["self_k"][i], cache["self_v"][i],
            pos)
        nk.append(k_i)
        nv.append(v_i)
        x = x + out
        h = apply_norm(cfg, p["norm_x"], x)
        x = x + attn.cross_attention(
            cfg, p["cross_attn"], h, (cache["cross_k"][i],
                                      cache["cross_v"][i]))
        x = x + apply_mlp(cfg, p["mlp"], apply_norm(cfg, p["norm2"], x))
    x = apply_norm(cfg, params["final_norm"], x)
    logits = unembed(params["embed"], x)[:, 0]
    new_cache = dict(cache)
    new_cache["self_k"] = torch.stack(nk)
    new_cache["self_v"] = torch.stack(nv)
    return logits, new_cache
