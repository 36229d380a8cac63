"""Plain PyTorch versions of the kernels: the CPU route and the oracles
the CUDA kernels are held against on the card."""
from __future__ import annotations

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


def randomk_ref(x: torch.Tensor, u: torch.Tensor, k_frac: float
                ) -> torch.Tensor:
    """Random-k sparsification: keep where u < k_frac (Random-k [26])."""
    return torch.where(u < k_frac, x, torch.zeros_like(x))
