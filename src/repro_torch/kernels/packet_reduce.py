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

``tree_reduce`` is the rack -> root reduction of the aggregation tree
(DESIGN.md §11) over this kernel: one launch per rack.
"""
from __future__ import annotations

from typing import Callable

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


def tree_reduce(packets: torch.Tensor, mask: torch.Tensor,
                rack_of: Callable[[int], int], *,
                compensation: str = "paper") -> torch.Tensor:
    """Hierarchical (rack -> root) masked reduction, DESIGN.md §11; the
    counterpart of the JAX package's ``kernels/packet_reduce.py::
    tree_reduce``, with the same math.

    Each rack's ToR partially reduces its members' delivered packets
    with ``packet_reduce`` (the kernel on a CUDA tensor); the root
    combines the partials. ``rack_of`` maps worker w -> rack id. Per rack
    the kernel's normalisation is undone back to raw masked sums (x rack
    size for "paper", x per-packet counts for "count"), so the root
    division is the only lossy float step beyond summation order.
    Returns (n_packets, payload) float32 equal to the flat
    ``packet_reduce(packets, mask)`` to float tolerance.
    """
    w, n, p = packets.shape
    racks = {}
    for f in range(w):
        racks.setdefault(int(rack_of(f)), []).append(f)
    dev = packets.device
    acc = torch.zeros((n, p), dtype=torch.float32, device=dev)
    cnt = torch.zeros((n, 1), dtype=torch.float32, device=dev)
    for members in racks.values():
        if members == list(range(members[0], members[-1] + 1)):
            # a run of workers: a view, no copy of the packets
            rows = slice(members[0], members[-1] + 1)
        else:
            rows = torch.tensor(members, device=dev)
        sub_m = mask[rows].to(torch.float32).contiguous()
        partial = packet_reduce(
            packets[rows].to(torch.float32).contiguous(), sub_m,
            compensation=compensation)
        c = sub_m.sum(dim=0)[:, None]
        if compensation == "count":
            acc = acc + partial * torch.clamp(c, min=1.0)
        else:
            acc = acc + partial * len(members)
        cnt = cnt + c
    if compensation == "count":
        return acc / torch.clamp(cnt, min=1.0)
    return acc / w
