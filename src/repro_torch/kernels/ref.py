"""Plain PyTorch versions of the kernels: the CPU route and the oracles
the CUDA kernels are held against on the card."""
from __future__ import annotations

import numpy as np
import torch


def dropfill_ref(packets: torch.Tensor, mask: torch.Tensor,
                 scale: torch.Tensor) -> torch.Tensor:
    """Bubble-fill + compensation: ``packets * mask * scale``.

    packets: (n_packets, payload) float; mask: (n_packets,) {0,1};
    scale: (n_packets,) compensation multiplier. Computed in float32 and
    returned in the input dtype, as the kernel computes it (lost packets
    zero-filled — paper §III-C).
    """
    gate = (mask.float() * scale.float())[:, None]
    return (packets.float() * gate).to(packets.dtype)


def dropfill_ef_ref(flat: torch.Tensor, residual: torch.Tensor,
                    mask: torch.Tensor):
    """The error-feedback gate (EF-SGD, DESIGN.md §2) as three ops:
    ``s = flat + residual``, ``sent = s * mask[:, None]``,
    ``new_res = s - sent``. flat, residual: (n_packets, payload);
    mask: (n_packets,) {0,1}. Returns (sent, new_res)."""
    s = flat + residual
    sent = s * mask[:, None].to(s.dtype)
    return sent, s - sent


def packet_reduce_ref(packets: torch.Tensor, mask: torch.Tensor, *,
                      compensation: str = "paper") -> torch.Tensor:
    """PS-side masked multi-worker aggregation.

    packets: (W, n_packets, payload); mask: (W, n_packets) {0,1}.
      paper: sum over delivered / W     (zero bubbles count in the mean)
      count: sum over delivered / count (unbiased over deliverers)
    Returns (n_packets, payload) float32.
    """
    w = packets.shape[0]
    mask = mask.float()
    tot = (packets.float() * mask[..., None]).sum(dim=0)
    if compensation == "count":
        cnt = torch.clamp(mask.sum(dim=0), min=1.0)
        return tot / cnt[:, None]
    return tot / w


def tree_reduce_ref(packets: torch.Tensor, mask: torch.Tensor,
                    members: torch.Tensor, rack_ptr: torch.Tensor, *,
                    compensation: str = "paper") -> torch.Tensor:
    """Rack -> root masked aggregation, in the JAX ``tree_reduce``'s
    order: per rack r (members ``members[rack_ptr[r]:rack_ptr[r+1]]``,
    summed in that order) s_r = sum g*m and c_r = sum m; the rack's
    normalisation is undone, ``acc += (s_r / k) * k`` with k the rack
    size ("paper") or max(c_r, 1) ("count"); then acc / W or
    acc / max(sum_r c_r, 1). Returns (n_packets, payload) float32.
    """
    w, n, p = packets.shape
    g, m = packets.float(), mask.float()
    mem, ptr = members.tolist(), rack_ptr.tolist()
    acc = torch.zeros((n, p), dtype=torch.float32, device=packets.device)
    cnt = torch.zeros((n, 1), dtype=torch.float32, device=packets.device)
    for r in range(len(ptr) - 1):
        s = torch.zeros_like(acc)
        c = torch.zeros_like(cnt)
        for f in mem[ptr[r]:ptr[r + 1]]:
            s = s + g[f] * m[f][:, None]
            c = c + m[f][:, None]
        k = (torch.clamp(c, min=1.0) if compensation == "count"
             else float(ptr[r + 1] - ptr[r]))
        acc = acc + (s / k) * k
        cnt = cnt + c
    if compensation == "count":
        return acc / torch.clamp(cnt, min=1.0)
    return acc / w


def randomk_ref(x: torch.Tensor, u: torch.Tensor, k_frac: float
                ) -> torch.Tensor:
    """Random-k sparsification: keep where u < k_frac (Random-k [26]).

    ``k_frac`` is rounded to float32 first, as the JAX kernel and the
    CUDA kernel compare against it: an element whose ``u`` equals
    ``float32(k_frac)`` is dropped even where ``k_frac`` rounds down.
    """
    k = float(np.float32(k_frac))
    return torch.where(u < k, x, torch.zeros_like(x))
