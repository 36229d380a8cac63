"""Mixture-of-Experts: top-k routing with sort-based capacity dispatch.

The PyTorch counterpart of the JAX package's ``models/moe.py``, over the
same parameter tree. Dispatch is scatter/gather with static shapes and
token dropping at capacity, not a one-hot einsum: an assignment whose
slot in its expert's buffer lies at or past ``capacity`` is dropped, and
that is part of the result. Expert FLOPs are ~6 * N_active * D.

The reference routes one group per data-parallel shard: without a mesh
one group (``g_count = 1``), which is what this port computes; inside
the LTP step, whose ctx excludes the worker axes, one group a shard of
the non-worker ``pod`` / ``data`` axes (``g_count = ndp``), and one
when there are none. The port's sharded steps (``train/trainer.py``)
give each rank its shard of the batch (in the LTP step, its block of
its worker's block), which it routes as one group: the reference's
grouping on a mesh (``tests/test_torch_trainer_sharded.py``,
``tests/test_torch_trainer_13e.py``). So the group axis is left out.
Under a ``ShardCtx`` (``ctx=``) the router and the dispatch stay
replicated (the groups come from the data axes alone) and the
expert einsums run on the ``model`` axis, as the reference's constraints
place them: expert-parallel when ``n_experts`` divides the axis (a rank
runs its experts on its slice of the routed buffer), otherwise
d_ff-parallel inside every expert (column blocks of ``experts_gate`` /
``experts_up``, row blocks of ``experts_down``), otherwise replicated.
Each rank combines its partial expert outputs, zeros for the experts it
does not hold, and the combined output is all-reduced.

Where the torch ops differ from JAX's:

- ``jax.lax.top_k`` puts the lower index first on ties; ``torch.topk``
  promises no order. The router takes a stable sort of ``-probs``.
- ``.at[...].set(mode="drop")`` drops the writes to slot ``cap``; torch
  raises on an out-of-range index. The dispatch buffer has ``cap + 1``
  slots and the last, which collects every dropped write, is cut off.
  Likewise the combine gathers from a buffer with one zero slot
  appended, where the reference's ``.get(mode="fill")`` fills zeros.

Every op is out of place, so the functions run under
``torch.func.vmap`` / ``grad``; the experts' counts are a ``scatter_add``
into zeros of a fixed shape, which runs on ``meta`` tensors as well.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.models.layers import Params, dense_init, normal
from repro_torch.models.sharding import copy_in, reduce_out, row_parallel, \
    split


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def moe_ff(cfg: ModelConfig) -> int:
    return cfg.moe_d_ff or cfg.d_ff


def capacity(cfg: ModelConfig, n_tokens: int, factor: float = 1.25) -> int:
    c = int(n_tokens * cfg.top_k / cfg.n_experts * factor)
    return max(8, _round_up(c, 8))


def moe_params(gen: torch.Generator, cfg: ModelConfig, dtype) -> Params:
    d, e, ff = cfg.d_model, cfg.n_experts, moe_ff(cfg)
    p = {
        "moe_gate": dense_init(gen, d, e, torch.float32),
        "experts_gate": (normal(gen, (e, d, ff)) * 0.02).to(dtype),
        "experts_up": (normal(gen, (e, d, ff)) * 0.02).to(dtype),
        "experts_down": (normal(gen, (e, ff, d)) * 0.02).to(dtype),
    }
    if cfg.n_shared_experts > 0:
        sff = cfg.n_shared_experts * ff
        p["shared"] = {
            "w_gate": dense_init(gen, d, sff, dtype),
            "w_up": dense_init(gen, d, sff, dtype),
            "w_down": dense_init(gen, sff, d, dtype),
        }
    return p


def router(cfg: ModelConfig, p: Params, xf):
    """xf: (T, d) -> (weights (T,k), ids (T,k), aux_loss scalar)."""
    logits = (xf.to(torch.float32) @ p["moe_gate"]).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    # top-k, the lower index first on ties (jax.lax.top_k's order)
    ids = torch.argsort(-probs, dim=-1, stable=True)[:, : cfg.top_k]
    weights = torch.gather(probs, -1, ids)
    weights = weights / torch.clamp(
        torch.sum(weights, dim=-1, keepdim=True), min=1e-9)
    # Switch-style load-balance auxiliary loss
    e = cfg.n_experts
    experts = torch.arange(e, device=xf.device)
    density = torch.mean((ids[:, :1] == experts).to(torch.float32), dim=0)
    density_proxy = torch.mean(probs, dim=0)
    aux = torch.sum(density * density_proxy) * e
    return weights, ids, aux


def _route_group(cfg: ModelConfig, p: Params, xf, cap: int):
    """Routing + dispatch scatter for the one group.

    Returns (buf (e, cap, d), s_ids, pos_c, s_tok, s_w, aux)."""
    tg, d = xf.shape
    e, k = cfg.n_experts, cfg.top_k
    weights, ids, aux = router(cfg, p, xf)
    a = tg * k
    flat_ids = ids.reshape(a)
    flat_w = weights.reshape(a)
    tok_idx = torch.arange(a, device=xf.device) // k

    order = torch.argsort(flat_ids, stable=True)
    s_ids = flat_ids[order]
    s_tok = tok_idx[order]
    s_w = flat_w[order]

    # a static-shape count (``bincount``'s output shape depends on the
    # data, which a shape-only run cannot give); integer counts are exact
    counts = torch.zeros(e, dtype=torch.int64, device=xf.device) \
        .scatter_add(0, flat_ids, torch.ones_like(flat_ids))
    starts = torch.cumsum(counts, dim=0) - counts
    pos = torch.arange(a, device=xf.device) - starts[s_ids]
    pos_c = torch.where(pos < cap, pos, cap)  # cap -> the dropped slot

    buf = torch.zeros((e, cap + 1, d), dtype=xf.dtype, device=xf.device)
    buf = buf.index_put((s_ids, pos_c), xf[s_tok])[:, :cap]
    return buf, s_ids, pos_c, s_tok, s_w, aux


def _combine_group(out_buf, s_ids, pos_c, s_tok, s_w, tg: int):
    """Combine gather + weighted scatter-add for the one group."""
    e, _, d = out_buf.shape
    filled = torch.cat([out_buf, out_buf.new_zeros((e, 1, d))], dim=1)
    y_assign = filled[s_ids, pos_c]   # the dropped slot reads 0
    y = torch.zeros((tg, d), dtype=torch.float32, device=out_buf.device)
    return y.index_add(0, s_tok, (y_assign * s_w[:, None].to(
        out_buf.dtype)).to(torch.float32))


def _experts(p: Params, buf):
    g = F.silu(torch.einsum("ecd,edf->ecf", buf, p["experts_gate"]))
    h = g * torch.einsum("ecd,edf->ecf", buf, p["experts_up"])
    return torch.einsum("ecf,efd->ecd", h, p["experts_down"])


def apply_moe(cfg: ModelConfig, p: Params, x, *,
              capacity_factor: float = 1.25, ctx=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out (B, S, d), aux_loss).

    All B * S tokens form one group, routed together (token dropping at
    the group's capacity). ``ctx``: the experts split over ``model``
    (module docstring)."""
    b, s, d = x.shape
    e = cfg.n_experts
    t = b * s
    xf = x.reshape(t, d)
    cap = capacity(cfg, t, capacity_factor)
    buf, s_ids, pos_c, s_tok, s_w, aux = _route_group(cfg, p, xf, cap)
    tp = split(ctx, e) or split(ctx, moe_ff(cfg))
    buf, s_w = copy_in(buf, tp), copy_in(s_w, tp)
    if tp is not None and tp.splits(e):
        n = e // tp.nm
        lo = tp.index * n
        mine = _experts(p, buf[lo:lo + n])
        out_buf = torch.cat([mine.new_zeros((lo, cap, d)), mine,
                             mine.new_zeros((e - lo - n, cap, d))])
    else:
        out_buf = _experts(p, buf)
    y = reduce_out(_combine_group(out_buf, s_ids, pos_c, s_tok, s_w, t),
                   tp).to(x.dtype)

    if cfg.n_shared_experts > 0:
        sp = p["shared"]
        stp = split(ctx, cfg.n_shared_experts * moe_ff(cfg))
        xs = copy_in(xf, stp)
        sg = F.silu(xs @ sp["w_gate"])
        y = y + row_parallel(sg * (xs @ sp["w_up"]), sp["w_down"], stp)
    return y.reshape(b, s, d), aux
