"""State-space mixers: Mamba-1 (selective scan) and Mamba-2 (chunked SSD).

The PyTorch counterpart of the JAX package's ``models/ssm.py``, over the
same parameter trees (the float32 leaves ``A_log``, ``D``, ``dt_bias``,
``A_log_m2`` and ``gamma`` stay float32 in a bfloat16 model).

Mamba-1 (falcon-mamba): per-channel diagonal A (d_inner, state); the
recurrence runs as a Python loop over time with a (B, d_inner, state)
carry, where the reference runs a ``lax.scan``. Mamba-2 (zamba2): scalar
decay per head, the SSD block-matmul form; the sequence is chunked, the
within-chunk terms are matrix products and the chunk-to-chunk state is
the loop's carry. Neither scan is a TPU kernel in the reference (it is
XLA there), so both are plain torch ops here; the loops open the
profiler spans ``mamba1_scan`` and ``ssd_chunk``.

Where the torch ops differ from JAX's:

- ``F.softplus`` turns linear above ``threshold=20``; ``jax.nn.softplus``
  never does. ``softplus`` here is ``logaddexp(x, 0)``, JAX's formula.
- ``_causal_conv`` keeps the reference's tap loop (the shifted inputs
  summed in its order, then the bias): ``F.conv1d`` sums in another
  order.
- The reference's three-operand einsums are written as explicit steps:
  ``torch.einsum`` contracts left to right without ``opt_einsum``, and
  zamba2's widths would build a 5-D intermediate of ~2.9 GB a sample.
- The SSD decay matrix takes ``where(mask, cs_i - cs_j, -inf)`` before
  ``exp``, as the reference does: ``exp`` of the unmasked difference
  overflows above the diagonal and gives NaN grads through ``inf * 0``.
- The reference's ``0.0 * x`` provenance terms exist for ``shard_map``
  and are left out.

Every op is out of place, so the functions run under ``torch.func.vmap``
/ ``grad``.

Under a ``ShardCtx`` (``ctx=``, tensor parallelism over ``model``, where
``tp_splits`` holds; otherwise the mixer runs replicated):

- Mamba-1 runs channel-parallel over ``d_inner``. ``in_proj``'s column
  block gives ``[x | z]`` columns that are not this rank's channels, so
  its output is ``reblock``ed into this rank's ``x`` and ``z``. The
  replicated per-channel leaves (``conv_w``, ``conv_b``, ``A_log``,
  ``D``, ``dt_bias``) are sliced to this rank's channels after
  ``copy_in``, and so are the rows of ``x_proj``, whose partial
  product ``xdbl`` is summed both ways (``row_parallel`` with
  ``reduce_both``) before ``dt``,
  ``B`` and ``C`` feed the channel-split ``dt_proj`` block and scan.
  ``out_proj`` is a row block (``row_parallel``).
- Mamba-2 runs head-parallel over ``ssm_heads``: the reblock gives this
  rank's ``z``, ``x`` and ``dt`` heads and the whole of ``B`` and ``C``
  (one group, shared by every head; their gradient is summed over the
  ranks). Each rank convolves its ``x`` channels and the whole ``B``,
  ``C``. The gated RMSNorm (``layers.rms_norm`` under ``ctx``) sums its
  squares over the whole ``d_inner`` both ways; ``gamma``, ``A_log_m2``,
  ``D`` and ``dt_bias`` are sliced by heads after ``copy_in``.

Decode (``mamba1_decode``, ``mamba2_decode``) splits the same way, each
rank's state holding its channels or heads (``sharding.cache_spec``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from repro_torch.config import ModelConfig
from repro_torch.models.layers import Params, dense_init, normal, rms_norm
from repro_torch.models.sharding import (
    block_of,
    cache_zeros,
    cols_of,
    copy_in,
    reblock,
    reduce_both,
    row_parallel,
    rows_of,
    segments_split,
)


def softplus(x):
    """``log(1 + exp(x))`` as ``logaddexp(x, 0)``, linear nowhere."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _dt_rank(cfg: ModelConfig) -> int:
    return max(1, math.ceil(cfg.d_model / 16))


def _causal_conv(x, conv_w, conv_b):
    """x: (B, S, C); conv_w: (k, C) tap-major; causal depthwise conv."""
    k = conv_w.shape[0]
    s = x.shape[1]
    out = torch.zeros_like(x)
    for i in range(k):
        shift = k - 1 - i
        xi = x if shift == 0 else F.pad(x, (0, 0, shift, 0))[:, :s]
        out = out + xi * conv_w[i]
    return out + conv_b


def _conv_step(buf, x1, conv_w, conv_b):
    """One-token causal conv. buf: (B, k-1, C) previous inputs; x1: (B, C).
    Returns (y1, new_buf)."""
    window = torch.cat([buf, x1[:, None, :]], dim=1)  # (B, k, C)
    y1 = torch.einsum("bkc,kc->bc", window, conv_w) + conv_b
    return y1, window[:, 1:]


# ============================================================================
# Mamba-1
# ============================================================================


def in_proj_segments(cfg: ModelConfig):
    """The columns of the SSM mixer's ``in_proj``, ``(width, split)`` in
    order, ``split`` where each ``model`` rank takes its block of the
    segment: Mamba-1's ``[x | z]`` (channels), Mamba-2's ``[z | x | B |
    C | dt]`` (heads; ``B`` and ``C`` are one group shared by every head,
    whole on every rank). The params, the split, the reblock and the
    layout rule all read them here."""
    di, n, nh = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    if "M2" in cfg.pattern_layers:
        return ((di, True), (di, True), (n, False), (n, False), (nh, True))
    return ((di, True), (di, True))


def tp_splits(cfg: ModelConfig, nm: int) -> bool:
    """Whether ``cfg`` has an SSM mixer whose ``in_proj`` segments split
    whole over ``nm`` model ranks (``model_specs``' rule)."""
    codes = cfg.pattern_layers
    return (("M" in codes or "M2" in codes)
            and segments_split(in_proj_segments(cfg), nm))


def _in_width(cfg: ModelConfig) -> int:
    return sum(w for w, _ in in_proj_segments(cfg))


def mamba1_params(gen: torch.Generator, cfg: ModelConfig, dtype) -> Params:
    d, di, n = cfg.d_model, cfg.d_inner, cfg.ssm_state
    r = _dt_rank(cfg)
    A = torch.arange(1, n + 1, dtype=torch.float32).expand(di, n)
    return {
        "in_proj": dense_init(gen, d, _in_width(cfg), dtype),
        "conv_w": (normal(gen, (cfg.ssm_conv, di)) * 0.1).to(dtype),
        "conv_b": torch.zeros((di,), dtype=dtype),
        "x_proj": dense_init(gen, di, r + 2 * n, dtype),
        "dt_proj": dense_init(gen, r, di, dtype, scale=r ** -0.5),
        "dt_bias": torch.full((di,), math.log(math.e ** 0.01 - 1.0),
                              dtype=torch.float32),
        "A_log": torch.log(A),
        "D": torch.ones((di,), dtype=torch.float32),
        "out_proj": dense_init(gen, di, d, dtype),
    }


def ssm_ctx(cfg: ModelConfig, ctx):
    """``ctx`` where the SSM mixer splits over ``model`` (``tp_splits``,
    the layout's rule), else ``None``."""
    return ctx if ctx is not None and tp_splits(cfg, ctx.nm) else None


def _channels(p: Params, names, tp):
    """The per-channel leaves ``names`` of ``p``, whole, or under ``tp``
    this rank's block of their last dim (``A_log``, ``x_proj``: of
    their rows)."""
    if tp is None:
        return [p[k] for k in names]
    return [rows_of(p[k], tp) if k in ("A_log", "x_proj")
            else cols_of(p[k], tp) for k in names]


def _mamba1_inputs(cfg: ModelConfig, p: Params, u, tp=None):
    """Shared projection path. u: (B, S, d). Returns x, z, dt, Bc, Cc;
    under ``tp`` the channels are this rank's."""
    n, r = cfg.ssm_state, _dt_rank(cfg)
    xz = copy_in(u, tp) @ p["in_proj"]
    x, z = torch.chunk(reblock(xz, tp, in_proj_segments(cfg)), 2, dim=-1)
    conv_w, conv_b, x_proj, dt_bias = _channels(
        p, ("conv_w", "conv_b", "x_proj", "dt_bias"), tp)
    x = F.silu(_causal_conv(x, conv_w, conv_b))
    xdbl = row_parallel(x, x_proj, tp, reduce_both)
    dt = softplus((xdbl[..., :r] @ p["dt_proj"]).to(torch.float32)
                  + dt_bias)
    Bc = xdbl[..., r:r + n].to(torch.float32)
    Cc = xdbl[..., r + n:].to(torch.float32)
    return x, z, dt, Bc, Cc


def mamba1_forward(cfg: ModelConfig, p: Params, u, ctx=None):
    """Full-sequence selective scan. u: (B, S, d) -> (B, S, d). Under
    ``ctx``, channel-parallel (module docstring)."""
    b, s, _ = u.shape
    tp = ssm_ctx(cfg, ctx)
    x, z, dt, Bc, Cc = _mamba1_inputs(cfg, p, u, tp)
    A_log, D = _channels(p, ("A_log", "D"), tp)
    A = -torch.exp(A_log)  # (di, n)
    xf = x.to(torch.float32)
    h = torch.zeros((b, x.shape[-1], cfg.ssm_state), dtype=torch.float32,
                    device=u.device)
    ys = []
    with record_function("mamba1_scan"):
        for t in range(s):
            dtt = dt[:, t]
            da = torch.exp(dtt[..., None] * A)  # (B, di, n)
            h = da * h + (dtt * xf[:, t])[..., None] * Bc[:, t, None, :]
            ys.append(torch.einsum("bdn,bn->bd", h, Cc[:, t]))
    y = torch.stack(ys, dim=1) + xf * D
    y = y.to(u.dtype) * F.silu(z)
    return row_parallel(y, p["out_proj"], tp)


def mamba1_decode(cfg: ModelConfig, p: Params, u1, state, ctx=None):
    """One-token update. u1: (B, 1, d); state = {"h": (B,di,n),
    "conv": (B, k-1, di)}, under ``ctx`` this rank's channels of both
    (``mamba1_state_init(..., nm=)``). Returns (out, new_state)."""
    n, r = cfg.ssm_state, _dt_rank(cfg)
    tp = ssm_ctx(cfg, ctx)
    xz = copy_in(u1[:, 0], tp) @ p["in_proj"]
    x, z = torch.chunk(reblock(xz, tp, in_proj_segments(cfg)), 2, dim=-1)
    conv_w, conv_b, x_proj, dt_bias, A_log, D = _channels(
        p, ("conv_w", "conv_b", "x_proj", "dt_bias", "A_log", "D"), tp)
    xc, conv_buf = _conv_step(state["conv"], x, conv_w, conv_b)
    xc = F.silu(xc)
    xdbl = row_parallel(xc, x_proj, tp, reduce_both)
    dt = softplus((xdbl[..., :r] @ p["dt_proj"]).to(torch.float32)
                  + dt_bias)
    Bc = xdbl[..., r:r + n].to(torch.float32)
    Cc = xdbl[..., r + n:].to(torch.float32)
    A = -torch.exp(A_log)
    da = torch.exp(dt[..., None] * A)
    xf = xc.to(torch.float32)
    h = da * state["h"] + (dt * xf)[..., None] * Bc[:, None, :]
    y = torch.einsum("bdn,bn->bd", h, Cc) + xf * D
    y = y.to(u1.dtype) * F.silu(z)
    out = row_parallel(y, p["out_proj"], tp)[:, None, :]
    return out, {"h": h, "conv": conv_buf}


def mamba1_state_init(cfg: ModelConfig, batch: int, dtype=torch.bfloat16,
                      device=None, nm: int = 1):
    """The decode state, or on ``nm`` model ranks one rank's
    (``sharding.cache_spec``)."""
    di = cfg.d_inner
    return {
        "h": cache_zeros(cfg, "M", "h", (batch, di, cfg.ssm_state),
                         torch.float32, device, nm),
        "conv": cache_zeros(cfg, "M", "conv", (batch, cfg.ssm_conv - 1, di),
                            dtype, device, nm),
    }


# ============================================================================
# Mamba-2 (SSD)
# ============================================================================


def mamba2_params(gen: torch.Generator, cfg: ModelConfig, dtype) -> Params:
    d, di, n = cfg.d_model, cfg.d_inner, cfg.ssm_state
    nh = cfg.ssm_heads
    conv_ch = di + 2 * n  # conv over (x, B, C)
    return {
        "in_proj": dense_init(gen, d, _in_width(cfg), dtype),
        "conv_w": (normal(gen, (cfg.ssm_conv, conv_ch)) * 0.1).to(dtype),
        "conv_b": torch.zeros((conv_ch,), dtype=dtype),
        "dt_bias": torch.zeros((nh,), dtype=torch.float32),
        "A_log_m2": torch.zeros((nh,), dtype=torch.float32),
        "D": torch.ones((nh,), dtype=torch.float32),
        "gamma": torch.ones((di,), dtype=torch.float32),
        "out_proj": dense_init(gen, di, d, dtype),
    }


def _mamba2_split(proj, di: int, n: int):
    """``in_proj``'s output, with ``di`` channels each of ``z`` and ``x``
    (this rank's under ``ctx``), split into ``z``, ``xBC`` and ``dt``."""
    z = proj[..., :di]
    xBC = proj[..., di:2 * di + 2 * n]
    dt = proj[..., 2 * di + 2 * n:]
    return z, xBC, dt


def _ssd_chunk(hstate, xc, bc, cc, lac, dtc):
    """One chunk of the SSD form. hstate: (B, nh, hp, n) carried state;
    xc (B, lc, nh, hp), bc / cc (B, lc, n), lac / dtc (B, lc, nh).
    Returns (new state, y (B, lc, nh, hp))."""
    lc = xc.shape[1]
    cs = torch.cumsum(lac, dim=1)  # (B, lc, nh)
    # intra-chunk: L[i,j] = exp(cs_i - cs_j) for i >= j (incl. own-step
    # decay), masked before the exp
    idx = torch.arange(lc, device=xc.device)
    causal = (idx[:, None] >= idx[None, :])[None, :, :, None]
    L = torch.exp(torch.where(causal, cs[:, :, None, :] - cs[:, None, :, :],
                              -torch.inf))  # (B, lc, lc, nh)
    sb = torch.einsum("bin,bjn->bij", cc, bc)  # (B, lc, lc), shared by heads
    xdt = xc * dtc[..., None]  # (B, lc, nh, hp)
    y_intra = torch.einsum("bijh,bjhp->bihp", sb[..., None] * L, xdt)
    # inter-chunk: the carried state's contribution, decayed from the
    # chunk's start to step i
    y_inter = torch.einsum("bin,bhpn->bihp", cc, hstate) \
        * torch.exp(cs)[..., None]
    # new state: h' = exp(sum la) h + sum_j exp(cs_end - cs_j) dt_j x_j B_j^T
    tot = cs[:, -1:, :]  # (B, 1, nh)
    w = torch.exp(tot - cs)  # (B, lc, nh): decay from step j to chunk end
    h_new = torch.exp(tot[:, 0, :])[:, :, None, None] * hstate \
        + torch.einsum("bjhp,bjn->bhpn", xdt * w[..., None], bc)
    return h_new, y_intra + y_inter


def _mamba2_conv(cfg: ModelConfig, p: Params, tp):
    """``conv_w`` / ``conv_b`` over (x, B, C): whole, or under ``tp`` this
    rank's ``x`` channels and the whole ``B``, ``C`` (after ``copy_in``)."""
    if tp is None:
        return p["conv_w"], p["conv_b"]
    di = cfg.d_inner
    out = []
    for k in ("conv_w", "conv_b"):
        w = copy_in(p[k], tp)
        out.append(torch.cat([block_of(w[..., :di], -1, tp.nm, tp.index),
                              w[..., di:]], dim=-1))
    return out


def mamba2_forward(cfg: ModelConfig, p: Params, u, *, chunk: int = 128,
                   ctx=None):
    """Chunked SSD. u: (B, S, d) -> (B, S, d). Under ``ctx``,
    head-parallel (module docstring)."""
    b, s, _ = u.shape
    tp = ssm_ctx(cfg, ctx)
    nm = 1 if tp is None else tp.nm
    di, n, nh = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    hp = di // nh  # head dim
    lc = chunk
    while s % lc != 0:
        lc //= 2
    nchunks = s // lc

    proj = copy_in(u, tp) @ p["in_proj"]
    proj = reblock(proj, tp, in_proj_segments(cfg))
    di, nh = di // nm, nh // nm   # this rank's channels and heads
    z, xBC, dt = _mamba2_split(proj, di, n)
    xBC = F.silu(_causal_conv(xBC, *_mamba2_conv(cfg, p, tp)))
    x = xBC[..., :di].reshape(b, s, nh, hp)
    Bc = xBC[..., di:di + n].to(torch.float32)
    Cc = xBC[..., di + n:].to(torch.float32)
    dt_bias, A_log, D, gamma = _channels(
        p, ("dt_bias", "A_log_m2", "D", "gamma"), tp)
    dt = softplus(dt.to(torch.float32) + dt_bias)  # (B, S, nh)
    A = -torch.exp(A_log)  # (nh,)
    la = dt * A  # log decay per step (B, S, nh), <= 0
    xf = x.to(torch.float32)

    h = torch.zeros((b, nh, hp, n), dtype=torch.float32, device=u.device)
    ys = []
    for c in range(nchunks):
        sl = slice(c * lc, (c + 1) * lc)
        with record_function("ssd_chunk"):
            h, yc = _ssd_chunk(h, xf[:, sl], Bc[:, sl], Cc[:, sl],
                               la[:, sl], dt[:, sl])
        ys.append(yc)
    y = ys[0] if nchunks == 1 else torch.cat(ys, dim=1)  # (B, S, nh, hp)
    y = y + xf * D[:, None]
    y = y.reshape(b, s, di).to(u.dtype)
    y = rms_norm(y * F.silu(z), gamma - 1.0, cfg.norm_eps, tp)
    return row_parallel(y, p["out_proj"], tp)


def mamba2_decode(cfg: ModelConfig, p: Params, u1, state, ctx=None):
    """One-token SSD update. state = {"h": (B, nh, hp, n), "conv": (B,
    k-1, conv_ch)}, under ``ctx`` this rank's heads and its ``x``
    channels with the whole ``B`` and ``C`` (``mamba2_state_init(...,
    nm=)``)."""
    tp = ssm_ctx(cfg, ctx)
    nm = 1 if tp is None else tp.nm
    di, n, nh = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    hp = di // nh
    proj = copy_in(u1[:, 0], tp) @ p["in_proj"]
    proj = reblock(proj, tp, in_proj_segments(cfg))
    di, nh = di // nm, nh // nm   # this rank's channels and heads
    z, xBC, dt = _mamba2_split(proj, di, n)
    xBC, conv_buf = _conv_step(state["conv"], xBC,
                               *_mamba2_conv(cfg, p, tp))
    xBC = F.silu(xBC)
    x = xBC[..., :di].reshape(-1, nh, hp).to(torch.float32)
    Bc = xBC[..., di:di + n].to(torch.float32)
    Cc = xBC[..., di + n:].to(torch.float32)
    dt_bias, A_log, D, gamma = _channels(
        p, ("dt_bias", "A_log_m2", "D", "gamma"), tp)
    dt = softplus(dt.to(torch.float32) + dt_bias)  # (B, nh)
    a = torch.exp(dt * -torch.exp(A_log))  # (B, nh)
    h = a[..., None, None] * state["h"] \
        + (x * dt[..., None])[..., None] * Bc[:, None, None, :]
    y = torch.einsum("bhpn,bn->bhp", h, Cc) + x * D[:, None]
    y = y.reshape(-1, di).to(u1.dtype)
    y = rms_norm(y * F.silu(z), gamma - 1.0, cfg.norm_eps, tp)
    out = row_parallel(y, p["out_proj"], tp)[:, None, :]
    return out, {"h": h, "conv": conv_buf}


def mamba2_state_init(cfg: ModelConfig, batch: int, dtype=torch.bfloat16,
                      device=None, nm: int = 1):
    """The decode state, or on ``nm`` model ranks one rank's
    (``sharding.cache_spec``)."""
    di, n, nh = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    return {
        "h": cache_zeros(cfg, "M2", "h", (batch, nh, di // nh, n),
                         torch.float32, device, nm),
        "conv": cache_zeros(cfg, "M2", "conv",
                            (batch, cfg.ssm_conv - 1, di + 2 * n), dtype,
                            device, nm),
    }
