"""Fused full attention (no causal mask, no window): CUDA C++ kernels for
Hopper, forward and backward.

Replaces no Pallas kernel: the JAX package leaves attention to XLA. It
replaces, on a CUDA tensor, the plain path's Python loop over query
chunks (``models/attention.py::multi_head_attention``), which issues some
20 operations a chunk and passes over the float32 (B, H, cq, Sk) scores
about ten times; that path stays the CPU route, unchanged. Whisper's
encoder self-attention (1,500 x 1,500) and its cross-attention (Sq x
1,500) take it.

Bound: tensor-core operations at the encoder's 1,500 x 1,500 (4 B H Sq
Sk hd forward, twice that backward, against q, k, v and o read once), and
device-memory bytes at Sq = 1 (decode's cross-attention reads the whole
K and V for one query row). Design (``csrc/fused_attention.cu``, after
FlashAttention-2, built into the port's kernel library by ``_build``):
the forward is one block a (64-query tile, batch x head), looping over
64-key tiles with ``mma.sync`` products; the scores never reach device
memory; it writes O and the rows' log-sum-exp (LSE). The backward is a
dQ kernel (one block a query tile), which also writes the rows' D =
sum_j P dP, then a dK/dV kernel (one block a key tile and KV head,
looping over the query tiles of every head that reads it): no atomics,
so two runs give the same bits. The forward and the dQ kernel pass over
the keys twice, to keep the plain path's rounding points (the source's
header says why). Reads are strided in the (B, S, H, hd) layout, tails
are masked, and query head h reads KV head h // (H / KV). Head sizes 32
(Whisper's REDUCED config) and 64 (Whisper's); bfloat16 on the tensor
cores, float32 on the CUDA cores (no TF32). Tiles are fixed: nothing is
autotuned.

``fused_attention(q, k, v)`` is an ``autograd.Function`` whose forward
saves q, k, v and the LSE (nothing of size Sq x Sk; D comes from P and
dP, not from O) and whose backward is a second Function; each has a
``vmap`` rule that folds the mapped axis into the batch, so both run
under ``torch.func.vmap``, ``grad`` and ``vjp`` (the fused step,
``transformer._Remat``'s recompute). Each launch
is also an operator (``repro_torch::fused_attention_fwd_into``,
``repro_torch::fused_attention_bwd_into``) with a fake form: a real CUDA
tensor launches directly, inside the profiler span ``fused_attention``;
a fake CUDA tensor, or a ``meta`` one inside ``_build.shape_only``, goes
through the operator, which a dispatch mode sees by name and whose fake
form launches nothing.
"""
from __future__ import annotations

import contextlib
import ctypes
import math

import torch
import torch.autograd.profiler as _profiler
from torch.profiler import record_function
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import _build
from repro_torch.launch.cost import attention_cost

#: forward launches so far
LAUNCHES = 0
#: backward launches so far (each the dQ kernel, then the dK/dV kernel)
BWD_LAUNCHES = 0
SPAN = "fused_attention"
#: the kernels' dtype codes
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64)


def _strides(*ts: torch.Tensor):
    """Each tensor's batch, seq and head strides, as a C array."""
    flat = [s for t in ts for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(flat))(*flat)


def _span():
    """The ``fused_attention`` span while a profiler runs; nothing (and no
    host cost) otherwise."""
    if _profiler._is_profiler_enabled:
        return record_function(SPAN)
    return contextlib.nullcontext()


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` with 16-byte aligned rows of unit stride, as the kernels'
    loads take them; copied only where it has none."""
    ok = (t.stride(3) == 1 and t.data_ptr() % 16 == 0
          and all(s * t.element_size() % 16 == 0 for s in t.stride()[:3]))
    return t if ok else t.contiguous()


def _check_head_dim(q: torch.Tensor) -> None:
    if q.shape[3] not in HEAD_DIMS:
        raise ValueError(f"fused_attention's kernels take head sizes "
                         f"{HEAD_DIMS}; got {q.shape[3]}")


def _forward_into(q, k, v, o, lse) -> None:
    """The forward's launch: ``o`` and ``lse`` written."""
    _check_head_dim(q)
    lib = _build.load()
    q, k, v = (_aligned(t) for t in (q, k, v))
    b, sq, h, hd = q.shape
    with _span():
        code = lib.ltp_attn_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), DTYPES[q.dtype], hd, b, h, k.shape[2], sq,
            k.shape[1], _strides(q, k, v, o), 1.0 / math.sqrt(hd),
            _build.stream_of(q))
    _build.check(lib, code, "fused_attention forward")
    global LAUNCHES
    LAUNCHES += 1


def _backward_into(q, k, v, lse, do, dq, dk, dv) -> None:
    """The backward's launches: ``dq``, ``dk`` and ``dv`` written (dk and
    dv of one layout)."""
    _check_head_dim(q)
    lib = _build.load()
    q, k, v, do = (_aligned(t) for t in (q, k, v, do))
    b, sq, h, hd = q.shape
    rows = torch.empty_like(lse)
    with _span():
        code = lib.ltp_attn_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lse.data_ptr(),
            do.data_ptr(), rows.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), DTYPES[q.dtype], hd, b, h, k.shape[2], sq,
            k.shape[1], _strides(q, k, v, do, dq, dk), 1.0 / math.sqrt(hd),
            _build.stream_of(q))
    _build.check(lib, code, "fused_attention backward")
    global BWD_LAUNCHES
    BWD_LAUNCHES += 1


_build.operator("fused_attention_fwd_into(Tensor q, Tensor k, Tensor v, "
                "Tensor(a!) o, Tensor(b!) lse) -> ()", _forward_into,
                lambda q, k, v, o, lse: None)
_build.operator("fused_attention_bwd_into(Tensor q, Tensor k, Tensor v, "
                "Tensor lse, Tensor do, Tensor(a!) dq, Tensor(b!) dk, "
                "Tensor(c!) dv) -> ()", _backward_into,
                lambda q, k, v, lse, do, dq, dk, dv: None)


for _name, _bwd in (("fused_attention_fwd_into", False),
                    ("fused_attention_bwd_into", True)):
    # ``FlopCounterMode`` (the dry-run's FLOPs) counts the operators as it
    # counts the chunked path's products
    register_flop_formula(getattr(torch.ops.repro_torch, _name))(
        lambda q, k, *_, _bwd=_bwd, **__: attention_cost(q, k, 1, _bwd)[1])


def _fold(info, in_dims, tensors):
    """The mapped axis of each tensor folded into its batch axis: (n, B,
    ...) -> (n B, ...); an unmapped tensor is repeated n times."""
    n = info.batch_size
    out = []
    for t, d in zip(tensors, in_dims):
        t = t.expand(n, *t.shape) if d is None else t.movedim(d, 0)
        out.append(t.reshape(n * t.shape[1], *t.shape[2:]))
    return out, n


def _unfold(t: torch.Tensor, n: int) -> torch.Tensor:
    return t.reshape(n, t.shape[0] // n, *t.shape[1:])


class _Attention(torch.autograd.Function):
    """(q, k, v) -> (O, LSE); the LSE takes no grad."""

    @staticmethod
    def forward(q, k, v):
        b, sq, h, _ = q.shape
        o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
        lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
        if _build.launching(q):
            _forward_into(q, k, v, o, lse)
        else:
            torch.ops.repro_torch.fused_attention_fwd_into(q, k, v, o, lse)
        return o, lse

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs, output[1])
        ctx.mark_non_differentiable(output[1])

    @staticmethod
    def backward(ctx, do, _):
        return _AttentionBackward.apply(*ctx.saved_tensors, do)

    @staticmethod
    def vmap(info, in_dims, q, k, v):
        (q, k, v), n = _fold(info, in_dims, (q, k, v))
        o, lse = _Attention.apply(q, k, v)
        return (_unfold(o, n), _unfold(lse, n)), (0, 0)


class _AttentionBackward(torch.autograd.Function):
    """(q, k, v, LSE, dO) -> (dq, dk, dv); no backward of its own."""

    @staticmethod
    def forward(q, k, v, lse, do):
        dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
        dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
        dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
        if _build.launching(q):
            _backward_into(q, k, v, lse, do, dq, dk, dv)
        else:
            torch.ops.repro_torch.fused_attention_bwd_into(
                q, k, v, lse, do, dq, dk, dv)
        return dq, dk, dv

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, *args):
        args, n = _fold(info, in_dims, args)
        return (tuple(_unfold(t, n) for t in _AttentionBackward.apply(*args)),
                (0, 0, 0))


def fused_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """Full attention, q: (B, Sq, H, hd); k, v: (B, Sk, KV, hd), KV
    dividing H, on one CUDA device (or fake / ``meta`` tensors inside
    ``_build.shape_only``). Returns O (B, Sq, H, hd) in q's dtype."""
    if not (_build.on_device(q) and k.device == q.device
            and v.device == q.device):
        raise ValueError(f"fused_attention runs on one CUDA device; got q "
                         f"on {q.device}, k on {k.device}, v on {v.device}")
    if q.dim() != 4 or k.shape != v.shape or k.shape[0] != q.shape[0] or \
            k.shape[3] != q.shape[3] or q.shape[2] % k.shape[2]:
        raise ValueError(f"q (B, Sq, H, hd) and k, v (B, Sk, KV, hd) with KV "
                         f"dividing H expected, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in DTYPES:
        raise TypeError(f"fused_attention takes float32 or bfloat16 for q, "
                        f"k and v; got {q.dtype}, {k.dtype}, {v.dtype}")
    return _Attention.apply(q, k, v)[0]
