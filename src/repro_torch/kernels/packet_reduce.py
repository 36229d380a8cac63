"""PS-side masked multi-worker packet reduction: a CUDA kernel for Hopper.

Replaces the JAX package's Pallas TPU kernel
``src/repro/kernels/packet_reduce.py::packet_reduce`` (body
``_reduce_kernel``). It aggregates W workers' packetized gradients with
per-(worker, packet) delivery masks and bubble-fill compensation:

    paper:  out[p] = sum_w g[w,p] * m[w,p] / W
    count:  out[p] = sum_w g[w,p] * m[w,p] / max(sum_w m[w,p], 1)

Bound: device-memory bytes. It reads W*n*p + W*n floats and writes n*p
floats, at 2 flops per element read; at the main path's (8, 1934, 360)
that is about 25.1 MB. Design (``csrc/ltp_kernels.cu``): one thread per
4 outputs of one packet, the W loop inside the thread with f32 register
accumulators, one coalesced read of every input element and one write
of every output, no atomics (deterministic) and no padding (ragged
shapes are bounds-checked).

A CPU tensor takes the plain version (``ref.packet_reduce_ref``); a CUDA
tensor launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import packet_reduce_ref

#: kernel launches so far (the plain version's calls do not count)
LAUNCHES = 0

COMPENSATIONS = ("paper", "count")


def packet_reduce(packets: torch.Tensor, mask: torch.Tensor, *,
                  compensation: str = "paper") -> torch.Tensor:
    """packets: (W, n_packets, payload) f32; mask: (W, n_packets) f32.
    Returns (n_packets, payload) f32."""
    if compensation not in COMPENSATIONS:
        raise ValueError(f"compensation must be one of {COMPENSATIONS}, "
                         f"got {compensation!r}")
    if packets.dim() != 3 or mask.shape != packets.shape[:2]:
        raise ValueError(f"packets (W, n, p) and mask (W, n) expected, got "
                         f"{tuple(packets.shape)} and {tuple(mask.shape)}")
    if packets.device.type == "cpu" and mask.device.type == "cpu":
        return packet_reduce_ref(packets, mask, compensation=compensation)
    if packets.device.type != "cuda" or mask.device != packets.device:
        raise ValueError(f"packet_reduce runs on one CUDA device or on the "
                         f"CPU; got packets on {packets.device} and mask "
                         f"on {mask.device}")
    if packets.dtype != torch.float32 or mask.dtype != torch.float32:
        raise TypeError(f"packet_reduce takes float32 packets and mask, got "
                        f"{packets.dtype} and {mask.dtype}")
    if not (packets.is_contiguous() and mask.is_contiguous()):
        raise ValueError("packet_reduce takes contiguous tensors")
    w, n, p = packets.shape
    out = torch.empty((n, p), dtype=torch.float32, device=packets.device)
    if out.numel() == 0:
        return out
    lib = _build.load()
    with torch.cuda.device(packets.device):
        code = lib.ltp_packet_reduce(
            packets.data_ptr(), mask.data_ptr(), out.data_ptr(), w, n, p,
            int(compensation == "count"), _build.stream_of(packets))
    _build.check(lib, code, "packet_reduce")
    global LAUNCHES
    LAUNCHES += 1
    return out
