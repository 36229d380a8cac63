"""Bubble-fill + compensation gate over packet rows: a CUDA kernel for
Hopper, in two forms of one pass.

Replaces the JAX package's Pallas TPU kernel
``src/repro/kernels/dropfill.py::dropfill`` (body ``_dropfill_kernel``):
``out = packets * (mask * scale)[:, None]``, zeroing lost packets
(``dropfill``). Every caller of the port gates with error feedback, which
the JAX package writes as three passes around that kernel
(``src/repro/runtime/step.py``: ``flat + residual``, the gate,
``flat - sent``); ``dropfill_ef`` is those three as the same kernel's
second form: ``s = flat + residual``, ``sent = s * mask[:, None]``,
``new_res = s - sent``, with torch's float32 rounding of each op.

Bound: device-memory bytes, at 1-3 flops per element. The plain gate
reads the (n, p) stream and writes it (44.6 MB at the bsp step's (15472,
360) float32); the EF form reads two streams and writes two (89.2 MB
there, 11.1 MB at one gradient's (1934, 360)), half the bytes and a
third of the launches of the three passes. Design
(``csrc/ltp_kernels.cu``): one elementwise pass, 16-byte vectors where
the payload and pointers allow, else one element a thread; the plain
gate takes float32 and bfloat16 (computed in float32), the EF form
float32. With ``donate=True`` the plain gate writes in place, which is
safe because the op is elementwise; the EF form's outputs are fresh.

A CPU tensor takes the plain version (``ref.dropfill_ref``,
``ref.dropfill_ef_ref``); a CUDA tensor launches the kernel or raises.
Each launch is also a PyTorch operator that writes into outputs the
wrapper allocates (``repro_torch::dropfill_into``, whose ``out`` is
``packets`` itself under ``donate=True``, and
``repro_torch::dropfill_ef_into``), with a fake form. A real CUDA
tensor launches directly; any other (a fake CUDA tensor, or a ``meta``
one inside ``_build.shape_only``) goes through the operator, which a
dispatch mode sees by name (``launch/cost.py``) and whose fake form
launches nothing.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import dropfill_ef_ref, dropfill_ref

#: kernel launches so far, both forms (the plain version's calls do not
#: count)
LAUNCHES = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _dropfill_into(packets, mask, scale, out) -> None:
    """The gate's launch: ``out = packets * (mask * scale)[:, None]``;
    ``out`` may be ``packets`` itself."""
    n, p = packets.shape
    lib = _build.load()
    with torch.cuda.device(packets.device):
        code = lib.ltp_dropfill(
            packets.data_ptr(), mask.data_ptr(),
            None if scale is None else scale.data_ptr(), out.data_ptr(),
            n, p, _DTYPE_CODE[packets.dtype], _build.stream_of(packets))
    _build.check(lib, code, "dropfill")
    global LAUNCHES
    LAUNCHES += 1


def _dropfill_ef_into(flat, residual, mask, sent, new_res) -> None:
    """The EF form's launch, into ``sent`` and ``new_res``."""
    n, p = flat.shape
    lib = _build.load()
    with torch.cuda.device(flat.device):
        code = lib.ltp_dropfill_ef(
            flat.data_ptr(), residual.data_ptr(), mask.data_ptr(),
            sent.data_ptr(), new_res.data_ptr(), n, p,
            _build.stream_of(flat))
    _build.check(lib, code, "dropfill_ef")
    global LAUNCHES
    LAUNCHES += 1


_build.operator("dropfill_into(Tensor packets, Tensor mask, Tensor? scale, "
                "Tensor(a!) out) -> ()", _dropfill_into,
                lambda packets, mask, scale, out: None)
_build.operator("dropfill_ef_into(Tensor flat, Tensor residual, Tensor mask, "
                "Tensor(a!) sent, Tensor(b!) new_res) -> ()",
                _dropfill_ef_into,
                lambda flat, residual, mask, sent, new_res: None)


def _on_device(name: str, tensors) -> None:
    """Raise unless every tensor lies on one device that the operator
    takes (``_build.on_device``)."""
    dev = tensors[0].device
    if not _build.on_device(tensors[0]) or any(t.device != dev
                                               for t in tensors):
        raise ValueError(f"{name} runs on one CUDA device or on the CPU; "
                         f"got {', '.join(str(t.device) for t in tensors)}")


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
    _on_device("dropfill", (packets, *vecs))
    if packets.dtype not in _DTYPE_CODE or any(
            v.dtype != torch.float32 for v in vecs):
        raise TypeError(f"dropfill takes float32/bfloat16 packets and a "
                        f"float32 mask/scale, got {packets.dtype}")
    if not (packets.is_contiguous() and all(v.is_contiguous() for v in vecs)):
        raise ValueError("dropfill takes contiguous tensors")
    out = packets if donate else torch.empty_like(packets)
    if out.numel() == 0:
        return out
    if _build.launching(packets):
        _dropfill_into(packets, mask, scale, out)
    else:
        torch.ops.repro_torch.dropfill_into(packets, mask, scale, out)
    return out


def dropfill_ef(flat: torch.Tensor, residual: torch.Tensor,
                mask: torch.Tensor):
    """flat, residual: (n_packets, payload) f32; mask: (n_packets,) f32.
    Returns fresh ``(sent, new_res)``: ``sent = (flat + residual) *
    mask[:, None]`` and ``new_res = (flat + residual) - sent``."""
    if flat.dim() != 2 or residual.shape != flat.shape or \
            mask.shape != flat.shape[:1]:
        raise ValueError(
            f"flat and residual (n, p) and mask (n,) expected, got "
            f"{tuple(flat.shape)}, {tuple(residual.shape)}, "
            f"{tuple(mask.shape)}")
    ts = (flat, residual, mask)
    if all(t.device.type == "cpu" for t in ts):
        return dropfill_ef_ref(flat, residual, mask)
    _on_device("dropfill_ef", ts)
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError(f"dropfill_ef takes float32 tensors, got "
                        f"{flat.dtype}, {residual.dtype}, {mask.dtype}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("dropfill_ef takes contiguous tensors")
    sent, new_res = torch.empty_like(flat), torch.empty_like(flat)
    if sent.numel() == 0:
        return sent, new_res
    if _build.launching(flat):
        _dropfill_ef_into(flat, residual, mask, sent, new_res)
    else:
        torch.ops.repro_torch.dropfill_ef_into(flat, residual, mask, sent,
                                               new_res)
    return sent, new_res
