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
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from repro_torch.config import ModelConfig
from repro_torch.models.layers import Params, dense_init, normal, rms_norm


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


def mamba1_params(gen: torch.Generator, cfg: ModelConfig, dtype) -> Params:
    d, di, n = cfg.d_model, cfg.d_inner, cfg.ssm_state
    r = _dt_rank(cfg)
    A = torch.arange(1, n + 1, dtype=torch.float32).expand(di, n)
    return {
        "in_proj": dense_init(gen, d, 2 * di, dtype),
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


def _mamba1_inputs(cfg: ModelConfig, p: Params, u):
    """Shared projection path. u: (B, S, d). Returns x, z, dt, Bc, Cc."""
    n, r = cfg.ssm_state, _dt_rank(cfg)
    xz = u @ p["in_proj"]
    x, z = torch.chunk(xz, 2, dim=-1)
    x = F.silu(_causal_conv(x, p["conv_w"], p["conv_b"]))
    xdbl = x @ p["x_proj"]
    dt = softplus((xdbl[..., :r] @ p["dt_proj"]).to(torch.float32)
                  + p["dt_bias"])
    Bc = xdbl[..., r:r + n].to(torch.float32)
    Cc = xdbl[..., r + n:].to(torch.float32)
    return x, z, dt, Bc, Cc


def mamba1_forward(cfg: ModelConfig, p: Params, u):
    """Full-sequence selective scan. u: (B, S, d) -> (B, S, d)."""
    b, s, _ = u.shape
    x, z, dt, Bc, Cc = _mamba1_inputs(cfg, p, u)
    A = -torch.exp(p["A_log"])  # (di, n)
    xf = x.to(torch.float32)
    h = torch.zeros((b, cfg.d_inner, cfg.ssm_state), dtype=torch.float32,
                    device=u.device)
    ys = []
    with record_function("mamba1_scan"):
        for t in range(s):
            dtt = dt[:, t]
            da = torch.exp(dtt[..., None] * A)  # (B, di, n)
            h = da * h + (dtt * xf[:, t])[..., None] * Bc[:, t, None, :]
            ys.append(torch.einsum("bdn,bn->bd", h, Cc[:, t]))
    y = torch.stack(ys, dim=1) + xf * p["D"]
    y = y.to(u.dtype) * F.silu(z)
    return y @ p["out_proj"]


def mamba1_decode(cfg: ModelConfig, p: Params, u1, state):
    """One-token update. u1: (B, 1, d); state = {"h": (B,di,n),
    "conv": (B, k-1, di)}. Returns (out, new_state)."""
    n, r = cfg.ssm_state, _dt_rank(cfg)
    xz = u1[:, 0] @ p["in_proj"]
    x, z = torch.chunk(xz, 2, dim=-1)
    xc, conv_buf = _conv_step(state["conv"], x, p["conv_w"], p["conv_b"])
    xc = F.silu(xc)
    xdbl = xc @ p["x_proj"]
    dt = softplus((xdbl[..., :r] @ p["dt_proj"]).to(torch.float32)
                  + p["dt_bias"])
    Bc = xdbl[..., r:r + n].to(torch.float32)
    Cc = xdbl[..., r + n:].to(torch.float32)
    A = -torch.exp(p["A_log"])
    da = torch.exp(dt[..., None] * A)
    xf = xc.to(torch.float32)
    h = da * state["h"] + (dt * xf)[..., None] * Bc[:, None, :]
    y = torch.einsum("bdn,bn->bd", h, Cc) + xf * p["D"]
    y = y.to(u1.dtype) * F.silu(z)
    out = (y @ p["out_proj"])[:, None, :]
    return out, {"h": h, "conv": conv_buf}


def mamba1_state_init(cfg: ModelConfig, batch: int, dtype=torch.bfloat16,
                      device=None):
    return {
        "h": torch.zeros((batch, cfg.d_inner, cfg.ssm_state),
                         dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, cfg.d_inner),
                            dtype=dtype, device=device),
    }


# ============================================================================
# Mamba-2 (SSD)
# ============================================================================


def mamba2_params(gen: torch.Generator, cfg: ModelConfig, dtype) -> Params:
    d, di, n = cfg.d_model, cfg.d_inner, cfg.ssm_state
    nh = cfg.ssm_heads
    conv_ch = di + 2 * n  # conv over (x, B, C)
    return {
        "in_proj": dense_init(gen, d, 2 * di + 2 * n + nh, dtype),
        "conv_w": (normal(gen, (cfg.ssm_conv, conv_ch)) * 0.1).to(dtype),
        "conv_b": torch.zeros((conv_ch,), dtype=dtype),
        "dt_bias": torch.zeros((nh,), dtype=torch.float32),
        "A_log_m2": torch.zeros((nh,), dtype=torch.float32),
        "D": torch.ones((nh,), dtype=torch.float32),
        "gamma": torch.ones((di,), dtype=torch.float32),
        "out_proj": dense_init(gen, di, d, dtype),
    }


def _mamba2_split(cfg: ModelConfig, proj):
    di, n = cfg.d_inner, cfg.ssm_state
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


def mamba2_forward(cfg: ModelConfig, p: Params, u, *, chunk: int = 128):
    """Chunked SSD. u: (B, S, d) -> (B, S, d)."""
    b, s, _ = u.shape
    di, n, nh = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    hp = di // nh  # head dim
    lc = chunk
    while s % lc != 0:
        lc //= 2
    nchunks = s // lc

    proj = u @ p["in_proj"]
    z, xBC, dt = _mamba2_split(cfg, proj)
    xBC = F.silu(_causal_conv(xBC, p["conv_w"], p["conv_b"]))
    x = xBC[..., :di].reshape(b, s, nh, hp)
    Bc = xBC[..., di:di + n].to(torch.float32)
    Cc = xBC[..., di + n:].to(torch.float32)
    dt = softplus(dt.to(torch.float32) + p["dt_bias"])  # (B, S, nh)
    A = -torch.exp(p["A_log_m2"])  # (nh,)
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
    y = y + xf * p["D"][:, None]
    y = y.reshape(b, s, di).to(u.dtype)
    y = rms_norm(y * F.silu(z), p["gamma"] - 1.0, cfg.norm_eps)
    return y @ p["out_proj"]


def mamba2_decode(cfg: ModelConfig, p: Params, u1, state):
    """One-token SSD update. state = {"h": (B,nh,hp,n), "conv": (B,k-1,conv_ch)}."""
    di, n, nh = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    hp = di // nh
    proj = u1[:, 0] @ p["in_proj"]
    z, xBC, dt = _mamba2_split(cfg, proj)
    xBC, conv_buf = _conv_step(state["conv"], xBC, p["conv_w"], p["conv_b"])
    xBC = F.silu(xBC)
    x = xBC[..., :di].reshape(-1, nh, hp).to(torch.float32)
    Bc = xBC[..., di:di + n].to(torch.float32)
    Cc = xBC[..., di + n:].to(torch.float32)
    dt = softplus(dt.to(torch.float32) + p["dt_bias"])  # (B, nh)
    a = torch.exp(dt * -torch.exp(p["A_log_m2"]))  # (B, nh)
    h = a[..., None, None] * state["h"] \
        + (x * dt[..., None])[..., None] * Bc[:, None, None, :]
    y = torch.einsum("bhpn,bn->bhp", h, Cc) + x * p["D"][:, None]
    y = y.reshape(-1, di).to(u1.dtype)
    y = rms_norm(y * F.silu(z), p["gamma"] - 1.0, cfg.norm_eps)
    return (y @ p["out_proj"])[:, None, :], {"h": h, "conv": conv_buf}


def mamba2_state_init(cfg: ModelConfig, batch: int, dtype=torch.bfloat16,
                      device=None):
    di, n, nh = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    return {
        "h": torch.zeros((batch, nh, di // nh, n), dtype=torch.float32,
                         device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, di + 2 * n),
                            dtype=dtype, device=device),
    }
