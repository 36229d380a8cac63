"""PS-side masked multi-worker packet reduction: CUDA kernels for Hopper.

Replaces the JAX package's Pallas TPU kernel
``src/repro/kernels/packet_reduce.py::packet_reduce`` (body
``_reduce_kernel``) and its two-level form ``tree_reduce``. It aggregates
W workers' packetized gradients with per-(worker, packet) delivery masks
and bubble-fill compensation:

    paper:  out[p] = sum_w g[w,p] * m[w,p] / W
    count:  out[p] = sum_w g[w,p] * m[w,p] / max(sum_w m[w,p], 1)

Bound: device-memory bytes. It reads W*n*p + W*n floats and writes n*p
floats, at 2 flops per element read; at the main path's (8, 1934, 360)
that is 25.1 MB, 7.5 us at the H100's 3.35 TB/s. Design
(``csrc/ltp_kernels.cu``): one pass, no atomics (deterministic), no
padding, and as many loads in flight as the registers hold: W is a
template parameter for W in {2, 4, 8, 16, 32}, a thread owns 2 float4 of
output (1 above W = 8) and issues every worker's loads before its first
add. Packet loads bypass L1 and fetch 256-byte spans from L2, since every
byte is read once. A payload that is not a multiple of 4, or a stream or
output not 16-byte aligned, takes one element a thread, chosen by that
test before the launch.

``tree_reduce`` is the rack -> root reduction of the aggregation tree
(DESIGN.md §11) as one launch of the same pass, one float4 a thread: the
workers are summed rack by rack, each rack's partial un-normalised and
added to the root's sum in registers, so the stream is read once and the
output written once.

A CPU tensor takes the plain version (``ref.packet_reduce_ref``,
``ref.tree_reduce_ref``); a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import functools
from typing import Callable, List, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import packet_reduce_ref, tree_reduce_ref

#: kernel launches so far (the plain version's calls do not count)
LAUNCHES = 0
#: tree_reduce kernel launches so far, likewise
TREE_LAUNCHES = 0

COMPENSATIONS = ("paper", "count")


def _on_cpu(name: str, packets: torch.Tensor, mask: torch.Tensor,
            compensation: str) -> bool:
    """Check the arguments; True when both tensors lie on the CPU (the
    plain route), False when both lie on one CUDA device; raise else."""
    if compensation not in COMPENSATIONS:
        raise ValueError(f"compensation must be one of {COMPENSATIONS}, "
                         f"got {compensation!r}")
    if packets.dim() != 3 or mask.shape != packets.shape[:2]:
        raise ValueError(f"packets (W, n, p) and mask (W, n) expected, got "
                         f"{tuple(packets.shape)} and {tuple(mask.shape)}")
    if packets.device.type == "cpu" and mask.device.type == "cpu":
        return True
    if packets.device.type != "cuda" or mask.device != packets.device:
        raise ValueError(f"{name} runs on one CUDA device or on the CPU; "
                         f"got packets on {packets.device} and mask on "
                         f"{mask.device}")
    return False


def packet_reduce(packets: torch.Tensor, mask: torch.Tensor, *,
                  compensation: str = "paper") -> torch.Tensor:
    """packets: (W, n_packets, payload) f32; mask: (W, n_packets) f32.
    Returns (n_packets, payload) f32."""
    if _on_cpu("packet_reduce", packets, mask, compensation):
        return packet_reduce_ref(packets, mask, compensation=compensation)
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


def rack_groups(rack_of: Callable[[int], int], n_workers: int
                ) -> Tuple[List[int], List[int]]:
    """The workers grouped by rack as the JAX ``tree_reduce`` groups them:
    racks in the order their ids are first met over workers 0..W-1, each
    rack's members in worker order. Returns ``(members, rack_ptr)``:
    members (W,) and the CSR offsets (n_racks + 1,) of each rack's first
    member in it."""
    racks: dict = {}
    for f in range(n_workers):
        racks.setdefault(int(rack_of(f)), []).append(f)
    members = [f for ms in racks.values() for f in ms]
    rack_ptr = [0]
    for ms in racks.values():
        rack_ptr.append(rack_ptr[-1] + len(ms))
    return members, rack_ptr


@functools.lru_cache(maxsize=64)
def _groups_on(members: Tuple[int, ...], rack_ptr: Tuple[int, ...],
               device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The grouping as int32 tensors on ``device``, copied there once per
    rack layout (a fixed topology reuses them, with no copy per call)."""
    return (torch.tensor(members, dtype=torch.int32, device=device),
            torch.tensor(rack_ptr, dtype=torch.int32, device=device))


def tree_reduce(packets: torch.Tensor, mask: torch.Tensor,
                rack_of: Callable[[int], int], *,
                compensation: str = "paper") -> torch.Tensor:
    """Hierarchical (rack -> root) masked reduction, DESIGN.md §11; the
    counterpart of the JAX package's ``kernels/packet_reduce.py::
    tree_reduce``, with the same math.

    Each rack's ToR sums its members' delivered packets and normalises
    them as ``packet_reduce`` would; the root undoes each rack's
    normalisation back to a raw masked sum (x rack size for "paper",
    x per-packet counts for "count"), adds the racks in order and divides
    once. ``rack_of`` maps worker w -> rack id. On a CUDA tensor this is
    one kernel launch (``TREE_LAUNCHES``), no ``packet_reduce`` launch.
    Returns (n_packets, payload) float32 equal to the flat
    ``packet_reduce(packets, mask)`` to float tolerance.
    """
    on_cpu = _on_cpu("tree_reduce", packets, mask, compensation)
    w, n, p = packets.shape
    members, rack_ptr = rack_groups(rack_of, w)
    if on_cpu:
        return tree_reduce_ref(packets, mask, torch.tensor(members),
                               torch.tensor(rack_ptr),
                               compensation=compensation)
    packets = packets.to(torch.float32).contiguous()
    mask = mask.to(torch.float32).contiguous()
    out = torch.empty((n, p), dtype=torch.float32, device=packets.device)
    if out.numel() == 0:
        return out
    lib = _build.load()
    mem_t, ptr_t = _groups_on(tuple(members), tuple(rack_ptr),
                              packets.device)
    with torch.cuda.device(packets.device):
        code = lib.ltp_tree_reduce(
            packets.data_ptr(), mask.data_ptr(), mem_t.data_ptr(),
            ptr_t.data_ptr(), out.data_ptr(), w, len(rack_ptr) - 1, n, p,
            int(compensation == "count"), _build.stream_of(packets))
    _build.check(lib, code, "tree_reduce")
    global TREE_LAUNCHES
    TREE_LAUNCHES += 1
    return out
