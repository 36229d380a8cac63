"""Peaks of the card and the bytes a kernel needs.

Peaks are NVIDIA's data-sheet figures for the H100 SXM part (dense, no
sparsity, at its 700 W limit): 989 TFLOP/s in bfloat16, 3.35 TB/s of
HBM3. A device that is not listed has no peak, and the metrics that
need one are left out of its runs.
"""
from __future__ import annotations

from typing import Optional

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "hbm_bytes": 3.35e12},
}


def peak(device_name: Optional[str], key: str) -> Optional[float]:
    return PEAKS.get(device_name or "", {}).get(key)


def packet_reduce_bytes(w: int, n_packets: int, payload: int = 360) -> int:
    """The masked multi-worker reduction of (W, n, payload) float32
    packets under (W, n) float32 masks into (n, payload) float32: each
    input read once and the output written once."""
    return 4 * (w * n_packets * payload + w * n_packets
                + n_packets * payload)
