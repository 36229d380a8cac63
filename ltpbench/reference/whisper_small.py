"""Plain reference of the Whisper-small encoder-decoder transformer
(arXiv:2212.04356; widths from huggingface.co/openai/whisper-small).

The encoder takes the audio frontend's output frames (the mel and
convolution frontend is not modelled: the benchmark gives the frames),
adds sinusoidal positions and runs pre-LayerNorm layers of full
(non-causal) self-attention and a GELU MLP, then a final LayerNorm. The
decoder embeds the tokens, adds sinusoidal positions and runs layers of
causal self-attention, cross-attention onto the encoder's output (its
keys and values projected from that output in each layer) and the GELU
MLP, then a final LayerNorm and an untied head over the vocabulary
padded to a multiple of 128. The loss is the next-token cross-entropy
over the real vocabulary.

Departures from the published model, as the configuration states them:
no biases, sinusoidal (not learned) decoder positions, GELU by its tanh
form, LayerNorm epsilon 1e-6. Each stack's parameters lie along a
leading layer axis (``param_shapes``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ltpbench.reference import common as C

ATTN = ("wk", "wo", "wq", "wv")


def param_shapes(cfg: dict) -> dict:
    d, ff = cfg["d_model"], cfg["d_ff"]
    le, ld = cfg["encoder_layers"], cfg["n_layers"]
    vp, dt = C.round_up(cfg["vocab"], 128), cfg["dtype"]
    out = {"embed/embed": ((vp, d), dt, "normal"),
           "embed/lm_head": ((d, vp), dt, "normal")}
    for stack, n, blocks in (("enc_stack", le, ("attn",)),
                             ("dec_stack", ld, ("self_attn", "cross_attn"))):
        for blk in blocks:
            for w in ATTN:
                out[f"{stack}/{blk}/{w}"] = ((n, d, d), dt, "normal")
        norms = ("norm1", "norm2") + (("norm_x",) if stack == "dec_stack"
                                     else ())
        for nm in norms:
            out[f"{stack}/{nm}/offset"] = ((n, d), "float32", "zeros")
            out[f"{stack}/{nm}/scale"] = ((n, d), "float32", "ones")
        out[f"{stack}/mlp/w_down"] = ((n, ff, d), dt, "normal")
        out[f"{stack}/mlp/w_up"] = ((n, d, ff), dt, "normal")
    for nm in ("enc_norm", "final_norm"):
        out[f"{nm}/offset"] = ((d,), "float32", "zeros")
        out[f"{nm}/scale"] = ((d,), "float32", "ones")
    return dict(sorted(out.items(), key=lambda kv_: kv_[0].split("/")))


def tree(flat: dict) -> dict:
    """The leaves as the program takes them."""
    return C.nest(flat)


def _ln(p, name, l, x, eps):
    if l is None:
        return C.layer_norm(x, p[f"{name}/scale"], p[f"{name}/offset"], eps)
    return C.layer_norm(x, p[f"{name}/scale"][l], p[f"{name}/offset"][l], eps)


def _heads(x, h):
    b, s, d = x.shape
    return x.reshape(b, s, h, d // h)


def _attn(p, pre, l, xq, xkv, h, mm, causal):
    b, s, d = xq.shape
    q = _heads(C.dense(xq, p[f"{pre}/wq"][l], mm), h)
    k = _heads(C.dense(xkv, p[f"{pre}/wk"][l], mm), h)
    v = _heads(C.dense(xkv, p[f"{pre}/wv"][l], mm), h)
    a = C.attention(q, k, v, mm, causal=causal)
    return C.dense(a.reshape(b, s, d), p[f"{pre}/wo"][l], mm)


def loss(cfg: dict, p: dict, batch: dict, mm) -> torch.Tensor:
    h, eps, d = cfg["n_heads"], cfg["norm_eps"], cfg["d_model"]
    dt = p["embed/embed"].dtype
    frames = batch["frames"]
    x = frames.to(dt) + C.sinusoid(frames.shape[1], d, dt, frames.device)
    for l in range(cfg["encoder_layers"]):
        hn = _ln(p, "enc_stack/norm1", l, x, eps)
        x = x + _attn(p, "enc_stack/attn", l, hn, hn, h, mm, causal=False)
        hn = _ln(p, "enc_stack/norm2", l, x, eps)
        x = x + C.gelu_mlp(hn, p["enc_stack/mlp/w_up"][l],
                           p["enc_stack/mlp/w_down"][l], mm)
    enc = _ln(p, "enc_norm", None, x, eps)
    tokens = batch["tokens"]
    x = F.embedding(tokens.long(), p["embed/embed"]).to(dt) \
        + C.sinusoid(tokens.shape[1], d, dt, tokens.device)
    for l in range(cfg["n_layers"]):
        hn = _ln(p, "dec_stack/norm1", l, x, eps)
        x = x + _attn(p, "dec_stack/self_attn", l, hn, hn, h, mm,
                      causal=True)
        hn = _ln(p, "dec_stack/norm_x", l, x, eps)
        x = x + _attn(p, "dec_stack/cross_attn", l, hn, enc, h, mm,
                      causal=False)
        hn = _ln(p, "dec_stack/norm2", l, x, eps)
        x = x + C.gelu_mlp(hn, p["dec_stack/mlp/w_up"][l],
                           p["dec_stack/mlp/w_down"][l], mm)
    x = _ln(p, "final_norm", None, x, eps)
    logits = C.dense(x, p["embed/lm_head"], mm)
    return C.next_token_loss(logits, batch["labels"], cfg["vocab"])


def worker_flops(cfg: dict, rows: int, seq: int) -> int:
    """Forward and backward FLOPs of one worker's ``rows`` sequences of
    ``seq`` tokens over ``encoder_frames`` frames: the matrix products
    and attention, three times the forward's, and not the encoder's
    recomputation under remat."""
    d, ff, h = cfg["d_model"], cfg["d_ff"], cfg["n_heads"]
    f, b, s = cfg["encoder_frames"], rows, seq
    hd = d // h
    enc = (4 * 2 * b * f * d * d + C.attention_flops(b, h, f, f, hd)
           + 2 * 2 * b * f * d * ff)
    dec = (4 * 2 * b * s * d * d + C.attention_flops(b, h, s, s, hd)
           + 2 * 2 * b * s * d * d + 2 * 2 * b * f * d * d
           + C.attention_flops(b, h, s, f, hd) + 2 * 2 * b * s * d * ff)
    head = 2 * b * s * d * C.round_up(cfg["vocab"], 128)
    return 3 * (cfg["encoder_layers"] * enc + cfg["n_layers"] * dec + head)
