"""Hand-written Hopper kernels for the LTP-sync hot loops.

  csrc/ltp_kernels.cu  the CUDA C++ sources (packet_reduce, dropfill)
  _build.py            nvcc build into a git-ignored directory + ctypes load
  packet_reduce.py     PS-side masked multi-worker reduce (wrapper)
  dropfill.py          bubble-fill + compensation gate (wrapper)
  ops.py               dtype-normalising public wrappers
  ref.py               plain PyTorch versions (CPU route and oracles)

The JAX package's third Pallas kernel, ``randomk``, is not ported yet
(ROADMAP.md, queue 2 item 3); only its plain version is here.
"""
from repro_torch.kernels.ops import (  # noqa: F401
    ltp_dropfill,
    ltp_packet_reduce,
)
