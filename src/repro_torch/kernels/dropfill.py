"""Bubble-fill + compensation gate over packet rows: a CUDA kernel for
Hopper.

Replaces the JAX package's Pallas TPU kernel
``src/repro/kernels/dropfill.py::dropfill`` (body ``_dropfill_kernel``):
``out = packets * (mask * scale)[:, None]``, zeroing lost packets.

Bound: device-memory bytes. It reads the (n, p) stream and two (n,)
vectors and writes the (n, p) stream, at 1 flop per element; at the main
path's (15472, 360) f32 that is about 44.6 MB. Design
(``csrc/ltp_kernels.cu``): an elementwise pass, 4 float32 elements a
thread with 16-byte loads and stores where the payload and pointers
allow, else one element a thread; float32 and bfloat16 in and out,
computed in float32. With ``donate=True`` it writes in place, which is
safe because the op is elementwise.

A CPU tensor takes the plain version (``ref.dropfill_ref``); a CUDA
tensor launches the kernel or raises.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import dropfill_ref

#: kernel launches so far (the plain version's calls do not count)
LAUNCHES = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def dropfill(packets: torch.Tensor, mask: torch.Tensor,
             scale: Optional[torch.Tensor] = None, *,
             donate: bool = False) -> torch.Tensor:
    """packets: (n_packets, payload) f32 or bf16; mask, scale:
    (n_packets,) f32 (scale optional). Returns the gated packets in the
    input dtype; ``donate=True`` overwrites ``packets`` with them."""
    if packets.dim() != 2 or mask.shape != packets.shape[:1] or (
            scale is not None and scale.shape != mask.shape):
        raise ValueError(
            f"packets (n, p) and mask/scale (n,) expected, got "
            f"{tuple(packets.shape)}, {tuple(mask.shape)}, "
            f"{None if scale is None else tuple(scale.shape)}")
    vecs = (mask,) if scale is None else (mask, scale)
    if packets.device.type == "cpu" and all(
            v.device.type == "cpu" for v in vecs):
        out = dropfill_ref(packets, mask,
                           torch.ones_like(mask) if scale is None else scale)
        if donate:
            packets.copy_(out)
            return packets
        return out
    if packets.device.type != "cuda" or any(
            v.device != packets.device for v in vecs):
        raise ValueError(f"dropfill runs on one CUDA device or on the CPU; "
                         f"got packets on {packets.device}")
    if packets.dtype not in _DTYPE_CODE or any(
            v.dtype != torch.float32 for v in vecs):
        raise TypeError(f"dropfill takes float32/bfloat16 packets and a "
                        f"float32 mask/scale, got {packets.dtype}")
    if not (packets.is_contiguous() and all(v.is_contiguous() for v in vecs)):
        raise ValueError("dropfill takes contiguous tensors")
    n, p = packets.shape
    out = packets if donate else torch.empty_like(packets)
    if out.numel() == 0:
        return out
    lib = _build.load()
    with torch.cuda.device(packets.device):
        code = lib.ltp_dropfill(
            packets.data_ptr(), mask.data_ptr(),
            None if scale is None else scale.data_ptr(), out.data_ptr(),
            n, p, _DTYPE_CODE[packets.dtype], _build.stream_of(packets))
    _build.check(lib, code, "dropfill")
    global LAUNCHES
    LAUNCHES += 1
    return out
