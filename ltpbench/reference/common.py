"""Plain building blocks shared by the reference models: norms, rotary
positions, attention, the MLP and the loss, in the configuration's dtype
with the float32 steps a bfloat16 model keeps (norm statistics, softmax,
loss). ``mm`` is a precision from ``numerics``: every matrix-product
operand goes through ``mm.q``."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def nest(flat: dict, extra: dict = None) -> dict:
    """Leaf name ("a/b/c") -> value, as the nested dicts the benchmark
    hands to the program, with ``extra`` top-level entries (empty layer
    groups) added."""
    out: dict = dict(extra or {})
    for name, v in flat.items():
        *path, leaf = name.split("/")
        node = out
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = v
    return out


def rms_norm(x, scale, eps):
    xf = x.float()
    out = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (out * (1.0 + scale.float())).to(x.dtype)


def layer_norm(x, scale, offset, eps):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * scale.float() + offset.float()).to(x.dtype)


def rope(x, theta):
    """Rotary positions 0..S-1 on (B, S, H, hd), by split halves."""
    hd, s = x.shape[-1], x.shape[1]
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                        device=x.device) / hd))
    ang = torch.arange(s, device=x.device).float()[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def sinusoid(n: int, d: int, dtype, device):
    half = d // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=device) / max(half - 1, 1))
    ang = torch.arange(n, device=device).float()[:, None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


def attention(q, k, v, mm, *, causal: bool, window: int = 0):
    """q: (B, Sq, H, hd); k, v: (B, Sk, KV, hd), each KV head shared by
    H / KV consecutive query heads. Scores in float32."""
    h, kvh, hd = q.shape[2], k.shape[2], q.shape[3]
    k = k.repeat_interleave(h // kvh, dim=2)
    v = v.repeat_interleave(h // kvh, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", mm.q(q), mm.q(k)).float() \
        * (1.0 / math.sqrt(hd))
    sq, sk = q.shape[1], k.shape[1]
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    keep = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        keep &= kpos <= qpos
    if window > 0:
        keep &= kpos > qpos - window
    p = torch.softmax(torch.where(keep, s, NEG_INF), dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", mm.q(p), mm.q(v))


def dense(x, w, mm):
    return mm.q(x) @ mm.q(w)


def swiglu(x, wg, wu, wd, mm):
    return dense(F.silu(dense(x, wg, mm)) * dense(x, wu, mm), wd, mm)


def gelu_mlp(x, wu, wd, mm):
    return dense(F.gelu(dense(x, wu, mm), approximate="tanh"), wd, mm)


def next_token_loss(logits, labels, vocab: int):
    """Mean cross-entropy in float32 over the first ``vocab`` columns."""
    lg = logits.float()[..., :vocab]
    return F.cross_entropy(lg.reshape(-1, vocab), labels.reshape(-1).long())


def attention_flops(b, h, sq, sk, hd) -> int:
    """Forward FLOPs of the scores and the weighted values."""
    return 2 * 2 * b * h * sq * sk * hd
