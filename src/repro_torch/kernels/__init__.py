"""Hand-written Hopper kernels for the LTP-sync hot loops, the
Random-k compression baseline and Whisper's full attention.

  csrc/ltp_kernels.cu  the CUDA C++ sources (packet_reduce, tree_reduce,
                       dropfill, randomk)
  csrc/fused_attention.cu
                       the fused attention's CUDA C++ source (forward,
                       dQ, dK/dV), built into the same library
  _build.py            nvcc build into a git-ignored directory + ctypes load
  packet_reduce.py     PS-side masked multi-worker reduce (wrapper), and
                       tree_reduce, the rack -> root reduction (wrapper)
  dropfill.py          bubble-fill + compensation gate, and its
                       error-feedback form (wrappers)
  randomk.py           Random-k select over streamed uniforms (wrapper)
  fused_attention.py   full attention, forward and backward (wrapper,
                       autograd and vmap rules)
  ops.py               dtype-normalising public wrappers
  ref.py               plain PyTorch versions (CPU route and oracles)

Every function of the JAX package that reaches ``pl.pallas_call``
(``packet_reduce``, ``tree_reduce``, ``dropfill``, ``randomk``) has its
counterpart here. The fused attention replaces no Pallas kernel: the JAX
package leaves attention to XLA, and the port's plain path, a Python
loop of some 20 operations a query chunk, bound Whisper's step.
"""
from repro_torch.kernels.ops import (  # noqa: F401
    ltp_dropfill,
    ltp_dropfill_ef,
    ltp_packet_reduce,
    randomk_sparsify,
)
