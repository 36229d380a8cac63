"""Decoder-only transformer covering the dense, VLM, MoE, SSM and hybrid
families: per-layer mixer codes 'A' (full attention), 'W' (sliding
window), 'L' (MLA, DeepSeek's latent attention), 'M' (Mamba-1) and 'M2'
(Mamba-2), with a dense MLP or a mixture of experts after each attention
mixer (a mamba block is the whole layer).

The PyTorch counterpart of the JAX package's ``models/transformer.py``,
over the same parameter tree:

  params = {
    embed, lead: (layer...), stack: {p0..p{P-1}: stacked over periods},
    rem: (layer...), shared_attn?, final_norm
  }

Layers are grouped by *pattern period*: each position within the period
has a static mixer code, and its leaves are stacked over the periods
(gemma3's 5 W : 1 A gives ``stack/p0..p5``, plus 2 trailing ``rem``
layers at 26 layers). The stacked layout is kept on purpose: the
gradient stream's leaves, and so ``core.packets.make_plan``'s critical
packets and the packet masks, are the reference's. Where the reference
scans over the stack, ``forward`` loops in Python over its leading
axis, unbinding each stacked leaf once (its backward is one stack of
the per-period grads). With ``remat`` (``loss_fn``'s default) each
period's body is rematerialised, as the reference's ``jax.checkpoint``
does: ``_Remat`` keeps only the body's inputs and recomputes it in the
backward (``_remat_body``).

The hybrid (zamba2, ``cfg.shared_attn_every > 0``) applies ONE shared
attention + MLP block (``shared_attn``) at the end of every period; its
grad is the sum over those applications. In decode each application
keeps its own KV slot (``cache["shared"]``, one a period).

MoE layers (``cfg.n_experts > 0``) carry ``p["moe"]`` in place of
``p["mlp"]``, except the ``first_dense_layers`` leading ones, which stay
dense and unstacked (``lead``: deepseek-v2's dense layer 0); their
load-balance losses sum into ``forward``'s aux loss, and ``loss_fn``
adds ``0.01 * aux``.

Decode (``decode_step``) loops over layers so every layer can carry its
own cache shape (ring buffers for 'W' layers, latent caches for 'L',
SSM states for 'M' / 'M2'). A prefill of an SSM layer returns the
``None`` cache, as the reference's does.

The enc-dec family (``family="audio"``, whisper) is ``models/encdec.py``;
its stacked layers are rematerialised by this module's ``_Remat`` too.

``forward`` and ``loss_fn`` take ``ctx``, a ``sharding.ShardCtx``: the
params are then this rank's blocks (``sharding.model_specs``) and every
layer runs tensor-parallel over ``model``: the attention mixers and
MLA by heads (``attention``, ``mla``), Mamba-1 by channels and Mamba-2
by heads (``ssm``), the MLP by ``d_ff`` and the experts by expert or
``d_ff`` (``layers``, ``moe``), the hybrid's shared block as an
attention layer; the logits are this rank's vocab block where the
vocab divides the axis. Every rank issues the same collectives in the
same order, in the forward and again in each remat recompute. The
serve path takes the same ``ctx``: the prefill is ``forward(...,
collect_cache=True, ctx=)``, its cache this rank's heads (MLA's latents
whole), and ``decode_step`` runs each layer split as the forward does
against this rank's cache (``init_cache(..., ctx=)``,
``sharding.cache_spec``); both give the whole vocab's logits on every
rank (``layers.gather_vocab``).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, List, Tuple

import torch
from torch.profiler import record_function

from repro_torch.config import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm
from repro_torch.models.layers import (
    Params,
    apply_mlp,
    apply_norm,
    cross_entropy,
    dtype_of,
    embed_params,
    embed_tokens,
    gather_vocab,
    mlp_params,
    norm_params,
    unembed,
)
from repro_torch.models.sharding import cache_zeros, split, whole
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

def check_supported(cfg: ModelConfig) -> None:
    """Raise ``ValueError`` for an unknown mixer code."""
    for code in dict.fromkeys(cfg.pattern_layers):
        if code not in ("A", "W", "L", "M", "M2"):
            raise ValueError(f"unknown mixer code {code!r}")


# ----------------------------------------------------------------------------
# Layer plan
# ----------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LayerPlan:
    lead_codes: Tuple[str, ...]   # unstacked leading layers (deepseek dense-0)
    period_codes: Tuple[str, ...] # codes within one stacked period
    n_periods: int
    rem_codes: Tuple[str, ...]    # unstacked trailing layers
    shared_attn: bool             # zamba2: shared block at each period end

    @property
    def n_layers(self) -> int:
        return (
            len(self.lead_codes)
            + self.n_periods * len(self.period_codes)
            + len(self.rem_codes)
        )


def make_plan(cfg: ModelConfig) -> LayerPlan:
    codes = cfg.pattern_layers
    lead = cfg.first_dense_layers if cfg.n_experts > 0 else 0
    rest = codes[lead:]
    if cfg.shared_attn_every > 0:
        period = cfg.shared_attn_every
        shared = True
    else:
        period = len(cfg.block_pattern)
        shared = False
    n_full = len(rest) // period
    rem = rest[n_full * period :]
    return LayerPlan(
        lead_codes=codes[:lead],
        period_codes=rest[:period] if n_full > 0 else (),
        n_periods=n_full,
        rem_codes=rem if n_full > 0 else rest,
        shared_attn=shared,
    )


def _layer_has_mlp(cfg: ModelConfig, code: str) -> bool:
    if code in ("M", "M2"):
        return False  # mamba block is the whole layer
    return cfg.d_ff > 0 or cfg.n_experts > 0


def _layer_is_moe(cfg: ModelConfig, code: str, is_lead: bool) -> bool:
    return cfg.n_experts > 0 and not is_lead and _layer_has_mlp(cfg, code)


def window_for(cfg: ModelConfig, code: str) -> int:
    return cfg.window if code == "W" else 0


# ----------------------------------------------------------------------------
# Init
# ----------------------------------------------------------------------------


def _mixer_params(gen: torch.Generator, cfg: ModelConfig, code: str,
                  dtype) -> Params:
    if code == "L":
        return mla_mod.mla_params(gen, cfg, dtype)
    if code == "M":
        return ssm.mamba1_params(gen, cfg, dtype)
    if code == "M2":
        return ssm.mamba2_params(gen, cfg, dtype)
    return attn.attn_params(gen, cfg, dtype)


def _layer_params(gen: torch.Generator, cfg: ModelConfig, code: str, *,
                  is_lead: bool, dtype) -> Params:
    p: Params = {
        "norm1": norm_params(cfg, cfg.d_model),
        "mixer": _mixer_params(gen, cfg, code, dtype),
    }
    if _layer_has_mlp(cfg, code):
        p["norm2"] = norm_params(cfg, cfg.d_model)
        if _layer_is_moe(cfg, code, is_lead):
            p["moe"] = moe_mod.moe_params(gen, cfg, dtype)
        else:
            p["mlp"] = mlp_params(gen, cfg, cfg.d_model, cfg.d_ff, dtype)
    return p


def _shared_block_params(gen: torch.Generator, cfg: ModelConfig,
                         dtype) -> Params:
    return {
        "norm1": norm_params(cfg, cfg.d_model),
        "attn": attn.attn_params(gen, cfg, dtype),
        "norm2": norm_params(cfg, cfg.d_model),
        "mlp": mlp_params(gen, cfg, cfg.d_model, cfg.d_ff, dtype),
    }


def init(generator: torch.Generator, cfg: ModelConfig, *,
         device: DeviceLike = None) -> Params:
    """Drawn from ``generator`` on its device (a CPU one gives the same
    values whatever ``device`` is), then moved to ``device`` (``None``
    means ``cuda``)."""
    check_supported(cfg)
    dev = resolve_device(device)
    dtype = dtype_of(cfg.dtype)
    plan = make_plan(cfg)
    gen = generator
    params: Params = {"embed": embed_params(gen, cfg, dtype)}
    params["lead"] = tuple(_layer_params(gen, cfg, c, is_lead=True,
                                         dtype=dtype)
                           for c in plan.lead_codes)
    if plan.n_periods > 0:
        stack: Dict[str, Any] = {}
        for j, code in enumerate(plan.period_codes):
            per = [_layer_params(gen, cfg, code, is_lead=False, dtype=dtype)
                   for _ in range(plan.n_periods)]
            stack[f"p{j}"] = tree_map(lambda *xs: torch.stack(xs), *per)
        params["stack"] = stack
    params["rem"] = tuple(_layer_params(gen, cfg, c, is_lead=False,
                                        dtype=dtype)
                          for c in plan.rem_codes)
    if plan.shared_attn:
        params["shared_attn"] = _shared_block_params(gen, cfg, dtype)
    params["final_norm"] = norm_params(cfg, cfg.d_model)
    return tree_map(lambda x: x.to(dev), params)


# ----------------------------------------------------------------------------
# Forward (train / prefill)
# ----------------------------------------------------------------------------


def _apply_mixer(cfg, code, p, x, positions, *, collect_cache=False,
                 ctx=None):
    """Returns (out, cache_or_None)."""
    if code == "M":
        return ssm.mamba1_forward(cfg, p, x, ctx=ctx), None
    if code == "M2":
        return ssm.mamba2_forward(cfg, p, x, ctx=ctx), None
    if code == "L":
        out = mla_mod.mla_attention(cfg, p, x, positions,
                                    attn.heads_ctx(cfg, ctx))
        cache = None
        if collect_cache:
            ckv, krope = mla_mod._latents(cfg, p, x, positions)
            cache = {"ckv": ckv, "krope": krope[:, :, 0, :]}
        return out, cache
    w = window_for(cfg, code)
    tp = attn.heads_ctx(cfg, ctx)
    q, k, v = attn._project_qkv(cfg, p, x, tp)
    q, k = attn._apply_pos(cfg, q, k, positions)
    out = attn._out_proj(
        attn.multi_head_attention(q, k, v, causal=True, window=w), p, tp)
    s = x.shape[1]
    cache = None
    if collect_cache:
        if w > 0 and s > w:
            cache = {"k": k[:, s - w :], "v": v[:, s - w :]}
        else:
            cache = {"k": k, "v": v}
    return out, cache


def _apply_ffn(cfg, p, x, ctx=None):
    """The layer's dense MLP or mixture of experts (or nothing) on the
    residual ``x``. Returns (x, aux loss or None)."""
    if "mlp" in p:
        h = apply_norm(cfg, p["norm2"], x)
        return x + apply_mlp(cfg, p["mlp"], h, ctx), None
    if "moe" in p:
        y, aux = moe_mod.apply_moe(cfg, p["moe"],
                                   apply_norm(cfg, p["norm2"], x), ctx=ctx)
        return x + y, aux
    return x, None


def _apply_layer(cfg, code, p, x, positions, *, collect_cache=False,
                 ctx=None):
    """Returns (x, aux loss or None, cache_or_None)."""
    h = apply_norm(cfg, p["norm1"], x)
    mix, cache = _apply_mixer(cfg, code, p["mixer"], h, positions,
                              collect_cache=collect_cache, ctx=ctx)
    x, aux = _apply_ffn(cfg, p, x + mix, ctx)
    return x, aux, cache


def _apply_shared_block(cfg, p, x, positions, *, collect_cache=False,
                        ctx=None):
    """The hybrid's shared attention + MLP block: a full-attention ('A')
    mixer, then the MLP, both split over ``model`` under ``ctx``.
    Returns (x, cache or None)."""
    h = apply_norm(cfg, p["norm1"], x)
    out, cache = _apply_mixer(cfg, "A", p["attn"], h, positions,
                              collect_cache=collect_cache, ctx=ctx)
    x = x + out
    x = x + apply_mlp(cfg, p["mlp"], apply_norm(cfg, p["norm2"], x), ctx)
    return x, cache


def _positions_for(cfg: ModelConfig, inputs: Dict[str, Any], s: int, b: int,
                   device):
    pos = torch.arange(s, device=device).expand(b, s)
    if cfg.pos_type == "mrope":
        if "positions3" in inputs:
            return inputs["positions3"]
        return pos.expand(3, b, s)
    return pos


def embed_inputs(cfg: ModelConfig, params: Params, inputs: Dict[str, Any],
                 ctx=None):
    """Token (+ modality-stub) embedding. Returns (x, positions). Under
    ``ctx`` the table's ``d_model`` columns are split over ``model`` (when
    they divide it) and the looked-up rows gathered before the VLM's
    (replicated) patch embeddings join them."""
    tok = inputs["tokens"]
    x = embed_tokens(params["embed"], tok, split(ctx, cfg.d_model)).to(
        dtype_of(cfg.dtype))
    if cfg.family == "vlm" and "patch_embeds" in inputs:
        x = torch.cat([inputs["patch_embeds"].to(x.dtype), x], dim=1)
    b, s = x.shape[:2]
    return x, _positions_for(cfg, inputs, s, b, x.device)


def _unstack(stack: Params, n: int) -> List[Params]:
    """The stacked period tree as ``n`` per-period trees: each leaf is
    unbound once, so the backward stacks the per-period grads in one
    pass."""
    cols = [torch.unbind(x, 0) for x in tree_leaves(stack)]
    return [tree_unflatten(stack, [c[i] for c in cols]) for i in range(n)]


class _Remat(torch.autograd.Function):
    """``body(positions, *primals) -> tuple of tensors`` rematerialised:
    the forward keeps only its inputs, and the backward recomputes the
    body under ``torch.func.vjp``, giving a grad to every one of
    ``primals`` (here the carry (x, aux) and the period's leaves; an
    enc-dec decoder layer's also the encoder output it reads).
    ``torch.utils.checkpoint`` runs under neither ``torch.func.grad``
    (saved-tensor hooks) nor ``vmap``; this Function runs under both,
    ``vmap`` through its generated rule. A tensor the body reads that is
    not among its inputs would get no grad. ``positions`` is an input for
    ``vmap`` (a VLM's M-RoPE ids carry the worker axis) and takes no
    grad. A body with a ``span`` attribute runs its backward inside that
    profiler span."""

    generate_vmap_rule = True

    @staticmethod
    def forward(body, positions, *primals):
        # views: an input returned as it is cannot be saved here
        return tuple(t.view_as(t) for t in body(positions, *primals))

    @staticmethod
    def setup_context(ctx, inputs, output):
        body, *tensors = inputs
        ctx.body = body
        ctx.save_for_backward(*tensors)

    @staticmethod
    def backward(ctx, *grads):
        # detached: the grad transforms run this backward with
        # create_graph, so a recompute on the saved tensors themselves
        # would record into the outer graph and every layer's recomputed
        # activations would live to the end of the backward, as if
        # nothing were rematerialised
        positions, *primals = (t.detach() for t in ctx.saved_tensors)
        grads = tuple(g.detach() for g in grads)
        span = getattr(ctx.body, "span", None)
        with torch.enable_grad(), (record_function(span) if span else
                                   contextlib.nullcontext()):
            _, vjp_fn = torch.func.vjp(
                lambda *a: ctx.body(positions, *a), *primals)
        return (None, None) + tuple(vjp_fn(grads))


def _remat_body(cfg: ModelConfig, plan: LayerPlan, slice_tree: Params,
                shared: Any, ctx=None, fsdp=None):
    """One period's body, for ``_Remat``: the period slice's layers and,
    in the hybrid, the shared block, over the carry (x, aux) and the
    flattened leaves of (slice, shared). Under ``fsdp`` the body gathers
    the period's blocks over ``data`` first (and the shared block's
    before it runs), so the backward's recompute gathers them again and
    one period's weights are whole at a time. Returns (body, leaves)."""
    tree = {"slice": slice_tree}
    if plan.shared_attn:
        tree["shared"] = shared
    leaves = tree_leaves(tree)

    def body(positions, x, aux, *flat):
        t = tree_unflatten(tree, list(flat))
        sl = whole(fsdp, t["slice"], "stack", period=True)
        for j, code in enumerate(plan.period_codes):
            x, a, _ = _apply_layer(cfg, code, sl[f"p{j}"], x, positions,
                                   ctx=ctx)
            if a is not None:
                aux = aux + a
        if plan.shared_attn:
            x, _ = _apply_shared_block(
                cfg, whole(fsdp, t["shared"], "shared_attn"), x, positions,
                ctx=ctx)
        return x, aux

    return body, leaves


def _stack_caches(period_caches: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Each period position's prefill cache stacked over the periods (an
    SSM layer's ``None`` stays ``None``)."""
    return {k: None if period_caches[0][k] is None else
            tree_map(lambda *xs: torch.stack(xs),
                     *[pc[k] for pc in period_caches])
            for k in period_caches[0]}


def forward(
    cfg: ModelConfig,
    params: Params,
    inputs: Dict[str, Any],
    *,
    collect_cache: bool = False,
    remat: bool = True,
    last_only: bool = False,
    ctx=None,
    fsdp=None,
):
    """Full-sequence forward. With ``remat``, each stacked period is
    rematerialised in the backward (``_Remat``); the ``lead`` and
    ``rem`` layers are not, as in the reference. Remat is skipped when
    ``collect_cache`` is set (prefill) and where grad mode is off.
    ``fsdp`` (a ``sharding.FsdpCtx``): the params are also split over
    ``data``, and each part is gathered where it is used: the embedding
    once, each ``lead`` / ``rem`` layer before it runs, each period (and
    the hybrid's shared block) inside its body (``_remat_body``).

    Returns (logits, aux_loss, caches) — caches is a dict with 'lead'/'stack'/
    'rem'/'shared' entries when collect_cache else None; ``stack`` holds
    each period position's cache (and the hybrid's shared block's, under
    ``shared``) stacked over the periods. Under ``ctx`` the logits are
    this rank's vocab block where the padded vocab divides ``model``.
    """
    plan = make_plan(cfg)
    params = dict(params, embed=whole(fsdp, params["embed"], "embed"))
    x, positions = embed_inputs(cfg, params, inputs, ctx)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    caches: Dict[str, Any] = {"lead": [], "rem": [], "stack": None,
                              "shared": None}

    def layer(p, code, x):
        nonlocal aux
        x, a, c = _apply_layer(cfg, code, p, x, positions,
                               collect_cache=collect_cache, ctx=ctx)
        if a is not None:
            aux = aux + a
        return x, c

    for i, (p, code) in enumerate(zip(params["lead"], plan.lead_codes)):
        x, c = layer(whole(fsdp, p, "lead", i), code, x)
        caches["lead"].append(c)

    if plan.n_periods > 0:
        shared_p = params.get("shared_attn")
        use_remat = remat and not collect_cache and torch.is_grad_enabled()
        period_caches = []
        for sl in _unstack(params["stack"], plan.n_periods):
            if use_remat:
                body, leaves = _remat_body(cfg, plan, sl, shared_p, ctx,
                                           fsdp)
                x, aux = _Remat.apply(body, positions, x, aux, *leaves)
                continue
            sl = whole(fsdp, sl, "stack", period=True)
            pc = {}
            for j, code in enumerate(plan.period_codes):
                x, pc[f"p{j}"] = layer(sl[f"p{j}"], code, x)
            if plan.shared_attn:
                x, pc["shared"] = _apply_shared_block(
                    cfg, whole(fsdp, shared_p, "shared_attn"), x, positions,
                    collect_cache=collect_cache, ctx=ctx)
            period_caches.append(pc)
        if collect_cache:
            caches["stack"] = _stack_caches(period_caches)
    for i, (p, code) in enumerate(zip(params["rem"], plan.rem_codes)):
        x, c = layer(whole(fsdp, p, "rem", i), code, x)
        caches["rem"].append(c)

    x = apply_norm(cfg, params["final_norm"], x)
    if last_only:
        x = x[:, -1:, :]
    logits = unembed(params["embed"], x, ctx)
    return logits, aux, (caches if collect_cache else None)


def loss_fn(cfg: ModelConfig, params: Params, batch: Dict[str, Any],
            *, remat: bool = True, ctx=None, ce_weight=None, fsdp=None):
    """The mean cross-entropy, times ``ce_weight`` where one is given (a
    data-parallel step's share of the label tokens), plus 0.01 times the
    MoE balance loss, which ``ce_weight`` leaves alone. ``fsdp``: the
    params split over ``data`` too (``forward``)."""
    logits, aux, _ = forward(cfg, params, batch, remat=remat, ctx=ctx,
                             fsdp=fsdp)
    loss = cross_entropy(logits, batch["labels"], cfg.vocab,
                         split(ctx, cfg.vocab_padded))
    if ce_weight is not None:
        loss = loss * ce_weight
    if cfg.n_experts > 0:
        loss = loss + 0.01 * aux
    return loss


# ----------------------------------------------------------------------------
# Decode (serve_step)
# ----------------------------------------------------------------------------


def _mixer_cache_spec(cfg: ModelConfig, code: str, batch: int, max_seq: int,
                      dtype, device, nm: int = 1):
    if code == "M":
        return ssm.mamba1_state_init(cfg, batch, dtype, device, nm)
    if code == "M2":
        return ssm.mamba2_state_init(cfg, batch, dtype, device, nm)
    if code == "L":
        return {
            "ckv": cache_zeros(cfg, code, "ckv",
                               (batch, max_seq, cfg.kv_lora), dtype, device,
                               nm),
            "krope": cache_zeros(cfg, code, "krope",
                                 (batch, max_seq, cfg.qk_rope_dim), dtype,
                                 device, nm),
        }
    w = window_for(cfg, code)
    s = min(w, max_seq) if w > 0 else max_seq
    shp = (batch, s, cfg.n_kv, cfg.hd)
    return {k: cache_zeros(cfg, code, k, shp, dtype, device, nm)
            for k in ("k", "v")}


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, *, device: DeviceLike = None, ctx=None):
    """Cache tree for decode: one entry per layer (+ the hybrid's shared
    block's KV slots, one a period). ``device`` ``None`` means ``cuda``;
    ``"meta"`` gives shapes and dtypes alone. Under ``ctx`` this rank's
    block of each leaf (``sharding.cache_spec``)."""
    check_supported(cfg)
    dev = resolve_device(device)
    if isinstance(dtype, str):
        dtype = dtype_of(dtype)
    nm = 1 if ctx is None else ctx.nm
    plan = make_plan(cfg)
    codes = (plan.lead_codes + plan.period_codes * plan.n_periods
             + plan.rem_codes)
    cache: Dict[str, Any] = {"layers": tuple(
        _mixer_cache_spec(cfg, code, batch, max_seq, dtype, dev, nm)
        for code in codes)}
    if plan.shared_attn:
        cache["shared"] = tuple(
            _mixer_cache_spec(cfg, "A", batch, max_seq, dtype, dev, nm)
            for _ in range(plan.n_periods))
    return cache


def cache_from_prefill(cfg: ModelConfig, caches: Dict[str, Any], batch: int,
                       max_seq: int, dtype, *, device: DeviceLike = None,
                       ctx=None) -> Dict[str, Any]:
    """A decode cache of ``max_seq`` positions (``init_cache``) holding a
    prefill's ``caches`` (``forward(..., collect_cache=True)``, of a
    prompt of S positions) in its first S: decode then goes on at
    position S. Attention and MLA layers only: a prefill keeps no SSM
    state, as the reference's keeps none; a sliding-window layer's
    prompt must fit its window."""
    plan = make_plan(cfg)
    flat: List[Any] = list(caches["lead"])
    for i in range(plan.n_periods):
        for j in range(len(plan.period_codes)):
            st = caches["stack"][f"p{j}"]
            flat.append(None if st is None else tree_map(lambda x: x[i], st))
    flat += list(caches["rem"])
    out = init_cache(cfg, batch, max_seq, dtype, device=device, ctx=ctx)

    def put(dst, src):
        if src is None:
            raise NotImplementedError("a prefill keeps no SSM state")
        return {k: dst[k].index_copy(1, torch.arange(
            src[k].shape[1], device=dst[k].device), src[k].to(dst[k].dtype))
            for k in dst}

    out["layers"] = tuple(put(d, c) for d, c in zip(out["layers"], flat,
                                                    strict=True))
    if plan.shared_attn:
        out["shared"] = tuple(
            put(d, tree_map(lambda x, i=i: x[i], caches["stack"]["shared"]))
            for i, d in enumerate(out["shared"]))
    return out


def _layer_param_at(params: Params, plan: LayerPlan,
                    idx: int) -> Tuple[Params, str, bool]:
    """Layer params + code for flat layer index (decode path), and
    whether the layer ends a period."""
    nl = len(plan.lead_codes)
    if idx < nl:
        return params["lead"][idx], plan.lead_codes[idx], False
    idx -= nl
    per = len(plan.period_codes)
    if idx < plan.n_periods * per:
        i, j = divmod(idx, per)
        return (tree_map(lambda x: x[i], params["stack"][f"p{j}"]),
                plan.period_codes[j], j == per - 1)
    idx -= plan.n_periods * per
    return params["rem"][idx], plan.rem_codes[idx], False


def _decode_mixer(cfg, code, p, x1, cache, pos, ctx=None):
    if code == "M":
        return ssm.mamba1_decode(cfg, p, x1, cache, ctx)
    if code == "M2":
        return ssm.mamba2_decode(cfg, p, x1, cache, ctx)
    if code == "L":
        out, nckv, nkrope = mla_mod.mla_decode(
            cfg, p, x1, cache["ckv"], cache["krope"], pos,
            attn.heads_ctx(cfg, ctx))
        return out, {"ckv": nckv, "krope": nkrope}
    w = window_for(cfg, code)
    out, nk, nv = attn.self_attention_decode(
        cfg, p, x1, cache["k"], cache["v"], pos,
        window=w if (w > 0 and cache["k"].shape[1] == w) else 0, ctx=ctx)
    return out, {"k": nk, "v": nv}


def _decode_shared_block(cfg, p, x, slot, pos, ctx=None):
    """The hybrid's shared block on one token against its KV slot.
    Returns (x, new slot)."""
    h = apply_norm(cfg, p["norm1"], x)
    out, slot = _decode_mixer(cfg, "A", p["attn"], h, slot, pos, ctx)
    x = x + out
    x = x + apply_mlp(cfg, p["mlp"], apply_norm(cfg, p["norm2"], x), ctx)
    return x, slot


def decode_step(cfg: ModelConfig, params: Params, cache: Dict[str, Any],
                token, pos, *, ctx=None):
    """One decode step. token: (B,) integer; pos: int or 0-d integer
    tensor, the position. Under ``ctx`` the params are this rank's
    blocks, the cache this rank's (``init_cache(..., ctx=)``), and every
    layer runs tensor-parallel over ``model`` as in ``forward``.

    Returns (logits (B, vocab_padded), new_cache); the logits are whole
    on every rank.
    """
    plan = make_plan(cfg)
    x = embed_tokens(params["embed"], token[:, None],
                     split(ctx, cfg.d_model)).to(dtype_of(cfg.dtype))
    pos = attn.pos_tensor(pos, x.device)
    new_layers = []
    new_shared = list(cache.get("shared", ()))
    per = len(plan.period_codes)
    n_lead = len(plan.lead_codes)
    for idx in range(plan.n_layers):
        p, code, period_end = _layer_param_at(params, plan, idx)
        h = apply_norm(cfg, p["norm1"], x)
        mix, nc = _decode_mixer(cfg, code, p["mixer"], h,
                                cache["layers"][idx], pos, ctx)
        new_layers.append(nc)
        x, _ = _apply_ffn(cfg, p, x + mix, ctx)
        if plan.shared_attn and period_end:
            app = (idx - n_lead) // per
            x, new_shared[app] = _decode_shared_block(
                cfg, params["shared_attn"], x, new_shared[app], pos, ctx)
    x = apply_norm(cfg, params["final_norm"], x)
    logits = gather_vocab(unembed(params["embed"], x, ctx)[:, 0],
                          cfg.vocab_padded, ctx)
    new_cache: Dict[str, Any] = {"layers": tuple(new_layers)}
    if plan.shared_attn:
        new_cache["shared"] = tuple(new_shared)
    return logits, new_cache
