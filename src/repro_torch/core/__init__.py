"""The paper's primary contribution: loss-tolerant gradient synchronization.

  packets.py      float-aligned packetization + critical packets (SIII-C/E)
  early_close.py  LT-threshold / deadline controller (SIII-B)
  ltp_sync.py     the PS host path: bubble-fill gate + masked reduction
"""
from repro_torch.core.early_close import (  # noqa: F401
    AnalyticIncastModel,
    EarlyCloseController,
    MultiPSEarlyClose,
    broadcast_time,
    phase_pct_threshold,
)
from repro_torch.core.packets import PacketPlan, make_plan  # noqa: F401
