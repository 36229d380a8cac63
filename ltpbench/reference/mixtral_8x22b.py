"""Plain reference of the Mixtral-8x22B decoder (arXiv:2401.04088;
widths from huggingface.co/mistralai/Mixtral-8x22B-v0.1).

Each layer: RMSNorm, grouped-query attention with rotary positions
(sliding window), a residual add; RMSNorm, a mixture of 8 SwiGLU
experts of which a softmax router picks the top 2 for each token (their
weights renormalised to sum to one), a residual add. Then the final
RMSNorm and an untied head. The loss is the next-token cross-entropy
plus 0.01 x the Switch load-balance loss of the router (the fraction of
tokens whose first choice is each expert times the mean router
probability, summed, times the number of experts).

Departures from the published model, as the configuration states them:
each expert takes at most ``capacity`` tokens of one worker's batch
(1.25 x its even share, rounded up to 8, at least 8), in token order;
the tokens past that get nothing from it. The parameters of a layer are
stacked along a leading layer axis; the leaf names follow the layout
the benchmark hands to the program (``param_shapes``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ltpbench.reference import common as C

AUX_WEIGHT = 0.01
CAPACITY_FACTOR = 1.25


def capacity(cfg: dict, n_tokens: int) -> int:
    c = int(n_tokens * cfg["top_k"] / cfg["n_experts"] * CAPACITY_FACTOR)
    return max(8, C.round_up(c, 8))


def param_shapes(cfg: dict) -> dict:
    """Leaf name -> (shape, dtype name, init), in the stream's order
    (names sorted by their parts)."""
    d, h, kv, hd = cfg["d_model"], cfg["n_heads"], cfg["n_kv"], cfg["head_dim"]
    e, ff, n = cfg["n_experts"], cfg["d_ff"], cfg["n_layers"]
    vp, dt = C.round_up(cfg["vocab"], 128), cfg["dtype"]
    out = {
        "embed/embed": ((vp, d), dt, "normal"),
        "embed/lm_head": ((d, vp), dt, "normal"),
        "final_norm/scale": ((d,), "float32", "zeros"),
        "stack/p0/mixer/wk": ((n, d, kv * hd), dt, "normal"),
        "stack/p0/mixer/wo": ((n, h * hd, d), dt, "normal"),
        "stack/p0/mixer/wq": ((n, d, h * hd), dt, "normal"),
        "stack/p0/mixer/wv": ((n, d, kv * hd), dt, "normal"),
        "stack/p0/moe/experts_down": ((n, e, ff, d), dt, "normal"),
        "stack/p0/moe/experts_gate": ((n, e, d, ff), dt, "normal"),
        "stack/p0/moe/experts_up": ((n, e, d, ff), dt, "normal"),
        "stack/p0/moe/moe_gate": ((n, d, e), "float32", "normal"),
        "stack/p0/norm1/scale": ((n, d), "float32", "zeros"),
        "stack/p0/norm2/scale": ((n, d), "float32", "zeros"),
    }
    return dict(sorted(out.items(), key=lambda kv_: kv_[0].split("/")))


def tree(flat: dict) -> dict:
    """The leaves as the program takes them: the layer's parameters under
    ``stack/p0`` and no leading or trailing unstacked layers."""
    return C.nest(flat, {"lead": (), "rem": ()})


def _moe(cfg, p, l, x, mm):
    """x: (T, d) -> (out (T, d), balance loss)."""
    t = x.shape[0]
    e, k = cfg["n_experts"], cfg["top_k"]
    probs = torch.softmax(C.dense(x.float(), p["stack/p0/moe/moe_gate"][l],
                                  mm), dim=-1)
    w, ids = torch.topk(probs, k, dim=-1)
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    cap = capacity(cfg, t)
    flat_ids, flat_w = ids.reshape(-1), w.reshape(-1)
    tok = torch.arange(t * k, device=x.device) // k
    y = torch.zeros((t, x.shape[1]), dtype=torch.float32, device=x.device)
    for j in range(e):
        sel = torch.nonzero(flat_ids == j).squeeze(1)[:cap]
        if sel.numel() == 0:
            continue
        rows = x[tok[sel]]
        o = C.swiglu(rows, p["stack/p0/moe/experts_gate"][l, j],
                     p["stack/p0/moe/experts_up"][l, j],
                     p["stack/p0/moe/experts_down"][l, j], mm)
        y = y.index_add(0, tok[sel],
                        (o * flat_w[sel, None].to(o.dtype)).float())
    first = (ids[:, :1] == torch.arange(e, device=x.device)).float()
    aux = torch.sum(first.mean(0) * probs.mean(0)) * e
    return y.to(x.dtype), aux


def loss(cfg: dict, p: dict, batch: dict, mm) -> torch.Tensor:
    tokens, labels = batch["tokens"], batch["labels"]
    b, s = tokens.shape
    h, kv, hd = cfg["n_heads"], cfg["n_kv"], cfg["head_dim"]
    eps = cfg["norm_eps"]
    x = F.embedding(tokens.long(), p["embed/embed"])
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for l in range(cfg["n_layers"]):
        hn = C.rms_norm(x, p["stack/p0/norm1/scale"][l], eps)
        q = C.dense(hn, p["stack/p0/mixer/wq"][l], mm).reshape(b, s, h, hd)
        k = C.dense(hn, p["stack/p0/mixer/wk"][l], mm).reshape(b, s, kv, hd)
        v = C.dense(hn, p["stack/p0/mixer/wv"][l], mm).reshape(b, s, kv, hd)
        q, k = C.rope(q, cfg["rope_theta"]), C.rope(k, cfg["rope_theta"])
        a = C.attention(q, k, v, mm, causal=True, window=cfg["window"])
        x = x + C.dense(a.reshape(b, s, h * hd), p["stack/p0/mixer/wo"][l],
                        mm)
        hn = C.rms_norm(x, p["stack/p0/norm2/scale"][l], eps)
        y, aux = _moe(cfg, p, l, hn.reshape(b * s, -1), mm)
        x = x + y.reshape(b, s, -1)
        aux_total = aux_total + aux
    x = C.rms_norm(x, p["final_norm/scale"], eps)
    logits = C.dense(x, p["embed/lm_head"], mm)
    return C.next_token_loss(logits, labels, cfg["vocab"]) \
        + AUX_WEIGHT * aux_total


def worker_flops(cfg: dict, rows: int, seq: int) -> int:
    """Forward and backward FLOPs of one worker's ``rows`` x ``seq``
    tokens: the matrix products and attention as computed (the experts
    over their capacity slots, attention over every key of the causal
    band the chunked kernel reads), three times the forward's, and no
    recomputation."""
    d, h, kv, hd = cfg["d_model"], cfg["n_heads"], cfg["n_kv"], cfg["head_dim"]
    e, ff = cfg["n_experts"], cfg["d_ff"]
    t = rows * seq
    cq = _chunk(seq)
    w = cfg["window"]
    keys = w + cq if (w > 0 and seq > w + cq) else seq
    layer = (2 * t * d * h * hd * 2 + 2 * t * d * kv * hd * 2
             + C.attention_flops(rows, h, seq, keys, hd)
             + 2 * t * d * e
             + 3 * 2 * e * capacity(cfg, t) * d * ff)
    head = 2 * t * d * C.round_up(cfg["vocab"], 128)
    return 3 * (cfg["n_layers"] * layer + head)


def _chunk(s: int, target: int = 128) -> int:
    if s <= target:
        return s
    return next(c for c in range(target, 0, -1) if s % c == 0)
