"""Random-k gradient sparsification: a CUDA kernel for Hopper.

Replaces the JAX package's Pallas TPU kernel
``src/repro/kernels/randomk.py::randomk`` (body ``_randomk_kernel``):
``out = where(u < k_frac, x, 0)``, with the uniforms ``u`` drawn outside
the kernel and streamed in, and ``k_frac`` compared as float32.

Bound: device-memory bytes. It reads x and u and writes out, at one
compare per element; at the Fig 5 path's 696,234 float32 gradient
elements that is 8,354,808 bytes, 2.49 us at an H100's 3.35 TB/s, so
the launch, the ramp to full rate and the grid's tail weigh as much as
the stream.
Design (``csrc/ltp_kernels.cu``): a select over the flat stream with no
padding, 4 float32 elements a thread with 16-byte loads that bypass L1
and fetch whole 256-byte spans from device memory, where x, u and out
are 16-byte aligned (the last thread takes a ragged end of 1-3 elements
one by one), else one element a thread; bfloat16 x always one element a
thread.

A CPU tensor takes the plain version (``ref.randomk_ref``); a CUDA
tensor launches the kernel or raises. The launch is also a PyTorch
operator that writes into the wrapper's output
(``repro_torch::randomk_into``), with a fake form. A real CUDA tensor
launches directly; any other (a fake CUDA tensor, or a ``meta`` one
inside ``_build.shape_only``) goes through the operator, whose fake form
launches nothing.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import randomk_ref

#: kernel launches so far (the plain version's calls do not count)
LAUNCHES = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _randomk_into(x, u, k_frac, out) -> None:
    """The select's launch, into ``out``."""
    lib = _build.load()
    with torch.cuda.device(x.device):
        code = lib.ltp_randomk(x.data_ptr(), u.data_ptr(), float(k_frac),
                               out.data_ptr(), x.numel(),
                               _DTYPE_CODE[x.dtype], _build.stream_of(x))
    _build.check(lib, code, "randomk")
    global LAUNCHES
    LAUNCHES += 1


_build.operator("randomk_into(Tensor x, Tensor u, float k_frac, "
                "Tensor(a!) out) -> ()", _randomk_into,
                lambda x, u, k_frac, out: None)


def randomk(x: torch.Tensor, u: torch.Tensor, k_frac: float) -> torch.Tensor:
    """x: f32 or bf16, any shape; u: float32 of x's shape; k_frac: the
    keep fraction in [0, 1]. Returns x with the elements where
    ``u >= float32(k_frac)`` set to zero, in x's dtype and shape."""
    if u.shape != x.shape:
        raise ValueError(f"x and u of one shape expected, got "
                         f"{tuple(x.shape)} and {tuple(u.shape)}")
    if x.device.type == "cpu" and u.device.type == "cpu":
        return randomk_ref(x, u, k_frac)
    if not _build.on_device(x) or u.device != x.device:
        raise ValueError(f"randomk runs on one CUDA device or on the CPU; "
                         f"got x on {x.device} and u on {u.device}")
    if x.dtype not in _DTYPE_CODE or u.dtype != torch.float32:
        raise TypeError(f"randomk takes float32/bfloat16 x and float32 u, "
                        f"got {x.dtype} and {u.dtype}")
    if not (x.is_contiguous() and u.is_contiguous()):
        raise ValueError("randomk takes contiguous tensors")
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    if _build.launching(x):
        _randomk_into(x, u, float(k_frac), out)
    else:
        torch.ops.repro_torch.randomk_into(x, u, float(k_frac), out)
    return out
