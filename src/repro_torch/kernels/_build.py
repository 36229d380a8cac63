"""Build and load the port's CUDA kernels (``csrc/ltp_kernels.cu``).

The source has a plain C interface, so ``nvcc`` compiles it in seconds
into a shared library that ``ctypes`` loads; nothing here includes
PyTorch's headers. The library is built on first use into
``build/<hash>/`` beside this module (``src/repro_torch/kernels/build/``
in a checkout, git-ignored), keyed by a hash of the source and the
compiler flags, so an edited ``.cu`` rebuilds. An installed package
builds inside its own directory, which must then be writable. Nothing
is imported or built when the package is imported: the first kernel
launch calls ``load()``.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Optional

import torch
from torch._subclasses.fake_tensor import FakeTensor

SOURCES = (Path(__file__).resolve().parent / "csrc" / "ltp_kernels.cu",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
BUILD_ROOT = Path(__file__).resolve().parent / "build"

_LIB: Optional[ctypes.CDLL] = None
_SHAPE_ONLY = False
#: the kernels' operators, ``repro_torch::<name>`` (``operator``)
OPS = torch.library.Library("repro_torch", "DEF")
#: what the last build printed (ptxas: registers, spills) and its
#: seconds; None while no build has run in this process (cached library)
BUILD_LOG = ""
BUILD_SECONDS: Optional[float] = None


def find_nvcc() -> str:
    """``nvcc`` on PATH, else under CUDA_HOME, else /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and os.access(os.path.join(root, "bin", "nvcc"), os.X_OK):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                       "CUDA kernels cannot be built")


def _digest() -> str:
    h = hashlib.sha256()
    for src in SOURCES:
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the sources (if this hash is not built yet); return the
    library's path. The library is written under a temporary name and
    renamed, so a concurrent or interrupted build never leaves a torn
    file behind."""
    global BUILD_LOG, BUILD_SECONDS
    out_dir = BUILD_ROOT / _digest()
    lib = out_dir / "libltp_kernels.so"
    if lib.exists():
        return lib
    try:
        out_dir.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    except OSError as e:
        raise RuntimeError(f"cannot write the kernel build directory "
                           f"{out_dir}: {e}") from e
    os.close(fd)
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, SOURCES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    BUILD_SECONDS = time.perf_counter() - t0
    BUILD_LOG = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{BUILD_LOG}")
    os.replace(tmp, lib)
    return lib


def load() -> ctypes.CDLL:
    """The loaded kernel library, built on first use. Raises when no
    CUDA device is available: a kernel is never stood in for."""
    global _LIB
    if _LIB is not None:
        return _LIB
    if not torch.cuda.is_available():
        raise RuntimeError("the CUDA kernels need a CUDA device; none is "
                           "available")
    lib = ctypes.CDLL(str(build()))
    vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    cf = ctypes.c_float
    lib.ltp_packet_reduce.argtypes = [vp, vp, vp, ci, ll, ll, ci, vp]
    lib.ltp_packet_reduce.restype = ci
    lib.ltp_tree_reduce.argtypes = [vp, vp, vp, vp, vp, ci, ci, ll, ll, ci,
                                    vp]
    lib.ltp_tree_reduce.restype = ci
    lib.ltp_dropfill.argtypes = [vp, vp, vp, vp, ll, ll, ci, vp]
    lib.ltp_dropfill.restype = ci
    lib.ltp_dropfill_ef.argtypes = [vp, vp, vp, vp, vp, ll, ll, vp]
    lib.ltp_dropfill_ef.restype = ci
    lib.ltp_randomk.argtypes = [vp, vp, cf, vp, ll, ci, vp]
    lib.ltp_randomk.restype = ci
    lib.ltp_error_string.argtypes = [ci]
    lib.ltp_error_string.restype = ctypes.c_char_p
    _LIB = lib
    return lib


def check(lib: ctypes.CDLL, code: int, kernel: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if code != 0:
        msg = lib.ltp_error_string(code).decode()
        raise RuntimeError(f"{kernel} launch failed: CUDA error {code} "
                           f"({msg})")


def stream_of(x: torch.Tensor) -> int:
    """The raw handle of the current stream on ``x``'s device."""
    return torch.cuda.current_stream(x.device).cuda_stream


@contextlib.contextmanager
def shape_only():
    """Within it a ``meta`` tensor passes through the kernels' operators,
    whose fake forms give outputs of the right shape and dtype and launch
    nothing (a shape-only run: ``launch/dryrun.py``). Outside it a kernel
    takes a CPU tensor (its plain version) or a CUDA one, and refuses
    any other."""
    global _SHAPE_ONLY
    prev, _SHAPE_ONLY = _SHAPE_ONLY, True
    try:
        yield
    finally:
        _SHAPE_ONLY = prev


def on_device(t: torch.Tensor) -> bool:
    """Whether ``t`` lies where a kernel's operator takes it: on a CUDA
    device (a fake CUDA tensor too), or on ``meta`` inside
    ``shape_only``."""
    return t.device.type == "cuda" or (_SHAPE_ONLY
                                       and t.device.type == "meta")


def launching(t: torch.Tensor) -> bool:
    """Whether a call on ``t`` launches the kernel directly: a CUDA
    tensor with storage. A fake CUDA tensor goes through the kernel's
    operator instead, whose fake form launches nothing and which a
    dispatch mode sees by name."""
    return t.device.type == "cuda" and not isinstance(t, FakeTensor)


def operator(schema: str, launch, fake) -> None:
    """Define the operator ``repro_torch::<schema>``: ``launch`` its CUDA
    kernel, ``fake`` its fake form (for fake and ``meta`` tensors). Each
    writes into outputs its caller allocates (``Tensor(a!)``), so no
    output aliases an input. Registered with ``torch.library`` directly:
    ``torch.library.custom_op`` would add its Python autograd wrappers,
    some 30 us of host time a call. A wrapper calls ``launch`` itself on
    a real CUDA tensor (``launching``), past the dispatcher."""
    name = schema.split("(")[0]
    OPS.define(schema)
    OPS.impl(name, launch, "CUDA")
    torch.library.register_fake(f"repro_torch::{name}", fake, lib=OPS)
