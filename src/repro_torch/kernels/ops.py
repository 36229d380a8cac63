"""Public wrappers around the CUDA kernels.

They take any floating dtype and geometry, as the JAX package's
``ops.py`` does. The CUDA kernels take ragged shapes as they are, so
nothing is padded: these wrappers only bring the inputs to the dtypes
the kernels take (float32 masks; float32 packets for the reduction;
float32 or bfloat16 packets for the gate and for Random-k, other float
types going through float32 and back, as the JAX wrapper casts) and make
them contiguous.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import dropfill as _df
from repro_torch.kernels import packet_reduce as _pr
from repro_torch.kernels import randomk as _rk


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32).contiguous()


def ltp_dropfill(packets: torch.Tensor, mask: torch.Tensor,
                 scale: Optional[torch.Tensor] = None, *,
                 donate: bool = False) -> torch.Tensor:
    """packets: (n_packets, payload) any float; mask: (n_packets,) {0,1};
    scale: optional (n_packets,) compensation. Zero-fills lost packets.
    ``donate=True`` lets the kernel write into ``packets``: only opt in
    when the stream is dead after the call."""
    mask = _f32(mask)
    scale = None if scale is None else _f32(scale)
    x = packets if packets.dtype in (torch.float32, torch.bfloat16) \
        else packets.to(torch.float32)
    x = x.contiguous()
    # a copy made here is dead after the call, so it is always donated
    out = _df.dropfill(x, mask, scale, donate=donate or x is not packets)
    return out.to(packets.dtype)


def ltp_packet_reduce(packets: torch.Tensor, mask: torch.Tensor, *,
                      compensation: str = "paper") -> torch.Tensor:
    """packets: (W, n_packets, payload); mask: (W, n_packets).
    Returns (n_packets, payload) float32."""
    return _pr.packet_reduce(_f32(packets), _f32(mask),
                             compensation=compensation)


def randomk_sparsify(x: torch.Tensor, u: torch.Tensor,
                     k_frac: float) -> torch.Tensor:
    """Elementwise Random-k keep mask via uniforms ``u`` (x's number of
    elements, made float32): x where ``u < float32(k_frac)``, else 0, in
    x's shape and dtype."""
    if u.numel() != x.numel():
        raise ValueError(f"u must have x's {x.numel()} elements, got "
                         f"{u.numel()}")
    xk = x if x.dtype in (torch.float32, torch.bfloat16) \
        else x.to(torch.float32)
    out = _rk.randomk(xk.contiguous().reshape(-1), _f32(u).reshape(-1),
                      k_frac)
    return out.reshape(x.shape).to(x.dtype)
