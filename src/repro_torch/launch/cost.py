"""Cost accounting of one lowered step: the role of the JAX package's
``launch/hlo_analysis.py``, read off the PyTorch dispatcher instead of
compiled HLO.

``CostCounter`` is a ``TorchDispatchMode`` that, around one step run on
shape-only (``meta``) tensors (``launch/dryrun.py``) or on real ones,
counts per rank:

  flops             matmul and convolution FLOPs, forward and backward,
                    by ``torch.utils.flop_counter``'s formulas (the walker
                    counts dots and convolutions)
  bytes             operand and output bytes of every aten op, an upper
                    bound on device-memory traffic as the walker's is
                    (no reuse between ops); views, metadata ops and bare
                    allocations move nothing and are skipped, as the
                    walker skips ``bitcast`` and ``get-tuple-element``
  collective_bytes  the input bytes of each c10d call (``all_reduce``,
                    ``all_gather_into_tensor``, ``all_to_all_single``,
                    ``reduce_scatter_tensor``), by kind and by mesh axis,
                    as ``chip_smoke.py``'s ``CollectiveCounter`` counts
                    the calls it wraps
  kernels           the calls of each ``repro_torch::`` operator (the
                    hand-written kernels, ``kernels/*.py``) with the
                    kernel's own bytes and operations
                    (``kernel_cost``)
  peak              the most live device bytes on the rank: every storage
                    the step allocates, counted from its first appearance
                    to its release, on top of the bytes already live when
                    the counter starts (``adopt``)

The kernels' byte and operation formulas (``reduce_cost``,
``dropfill_cost``, ``dropfill_ef_cost``, ``randomk_cost``,
``attention_cost``) and ``bound``
live here, and ``chip_smoke.py`` reads its kernels' bounds from them.

A step's cost is additive over its periods of identical layers, so
``Cost`` supports ``+``, ``-`` and scaling: ``launch/dryrun.py`` traces
one and two periods and extrapolates to the config's depth, where the
walker multiplies a ``while`` body by its trip count.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.launch.mesh import HBM_BW, PEAK_FLOPS_F32

# ----------------------------------------------------------------------------
# the kernels' own costs
# ----------------------------------------------------------------------------


def bound(n_bytes: int, n_ops: int, peak: float = PEAK_FLOPS_F32):
    """The least time (ms) the card could take: the larger of the bytes
    moved over the memory rate and the operations over ``peak`` (the
    float32 rate unless said; ``launch/mesh.py``); and which of the two
    it is."""
    by_bytes = n_bytes / HBM_BW * 1e3
    by_ops = n_ops / peak * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                   else "operations")


def reduce_cost(w: int, n: int, p: int):
    """Bytes and float32 operations of a masked W-worker reduction of
    (W, n, p) packets (``packet_reduce``, ``tree_reduce``): each packet
    and mask element read once, each output written once; a multiply and
    an add per packet element and a divide per output."""
    return 4 * (w * n * p + w * n + n * p), 2 * w * n * p + n * p


def dropfill_cost(n: int, p: int, elem_size: int = 4,
                  with_scale: bool = False):
    """The plain gate over (n, p) packets of ``elem_size`` bytes: the
    packets read and written once, the float32 mask (and scale) read
    once; a multiply an element."""
    return 2 * n * p * elem_size + n * 4 * (2 if with_scale else 1), n * p


def dropfill_ef_cost(n: int, p: int):
    """The error-feedback gate over (n, p) float32 rows: two streams read,
    two written, the mask read; an add, a multiply and a subtract an
    element."""
    return 4 * (4 * n * p + n), 3 * n * p


def randomk_cost(n: int, elem_size: int = 4):
    """The Random-k select over n elements of ``elem_size`` bytes: x read
    and the output written, the float32 uniforms read; a compare an
    element."""
    return n * (2 * elem_size + 4), n


def attention_cost(q_shape, kv_shape, elem_size: int,
                   backward: bool = False):
    """Bytes and tensor-core operations of one fused attention call, q
    (B, Sq, H, hd) against k, v (B, Sk, KV, hd) of ``elem_size`` bytes:
    forward, q, k and v read once, O and the float32 LSE written once;
    backward, q, dO, k, v and the LSE read once, dq, dk and dv written
    once (the rows' D, written and read between its two kernels, not
    counted). Operations: the products' FLOPs as ``FlopCounterMode``
    counts the chunked path's, 4 B H Sq Sk hd forward and twice that
    backward (the kernels' recompute of QK^T not counted)."""
    b, sq, h, hd = q_shape
    sk, kvh = kv_shape[1], kv_shape[2]
    nq, nkv, rows = b * sq * h * hd, b * sk * kvh * hd, b * h * sq
    ops = 4 * b * h * sq * sk * hd
    if backward:
        return (3 * nq + 4 * nkv) * elem_size + 4 * rows, 2 * ops
    return (2 * nq + 2 * nkv) * elem_size + 4 * rows, ops


def kernel_cost(name: str, args) -> tuple:
    """(bytes, operations) of one call of the operator
    ``repro_torch::<name>`` on ``args``."""
    if name in ("packet_reduce_into", "tree_reduce_into"):
        return reduce_cost(*args[0].shape)
    if name == "dropfill_into":
        n, p = args[0].shape
        return dropfill_cost(n, p, args[0].element_size(),
                             args[2] is not None)
    if name == "dropfill_ef_into":
        return dropfill_ef_cost(*args[0].shape)
    if name == "randomk_into":
        return randomk_cost(args[0].numel(), args[0].element_size())
    if name in ("fused_attention_fwd_into", "fused_attention_bwd_into"):
        return attention_cost(args[0].shape, args[1].shape,
                              args[0].element_size(),
                              name == "fused_attention_bwd_into")
    raise KeyError(f"no cost formula for repro_torch::{name}")


# ----------------------------------------------------------------------------
# the counter
# ----------------------------------------------------------------------------

_c10d = torch.ops.c10d
# c10d op -> (its name in torch.distributed, index of the input tensor
# (a list for all_reduce), index of the process group)
COLLECTIVES = {
    _c10d.allreduce_.default: ("all_reduce", 0, 1),
    _c10d._allgather_base_.default: ("all_gather_into_tensor", 1, 2),
    _c10d.alltoall_base_.default: ("all_to_all_single", 1, 2),
    _c10d._reduce_scatter_base_.default: ("reduce_scatter_tensor", 1, 2),
}
_aten = torch.ops.aten
# ops that allocate without writing, or only describe a tensor
_NO_BYTES = {
    _aten.empty.memory_format, _aten.empty_like.default,
    _aten.new_empty.default, _aten.empty_strided.default,
    _aten.new_empty_strided.default, _aten.detach.default,
    _aten.lift_fresh.default,
}


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)


def _nbytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(x))


@dataclasses.dataclass
class Cost:
    """One step's counts on one rank (the counter's result)."""

    flops: float = 0.0
    bytes: float = 0.0
    collectives: Dict[str, Dict[str, Dict[str, float]]] = \
        dataclasses.field(default_factory=dict)  # axis -> kind -> calls/bytes
    kernels: Dict[str, Dict[str, float]] = \
        dataclasses.field(default_factory=dict)  # op -> calls/bytes/ops
    peak: float = 0.0

    @property
    def collective_bytes(self) -> float:
        return sum(k["bytes"] for a in self.collectives.values()
                   for k in a.values())

    def by_collective(self) -> Dict[str, float]:
        """Collective bytes by kind, over every axis."""
        out: Dict[str, float] = {}
        for a in self.collectives.values():
            for kind, c in a.items():
                out[kind] = out.get(kind, 0) + c["bytes"]
        return out

    def _combine(self, other: "Cost", f) -> "Cost":
        def merge(a, b):
            if isinstance(a, dict) or isinstance(b, dict):
                a, b = a or {}, b or {}
                return {k: merge(a.get(k), b.get(k)) for k in {**a, **b}}
            return f(a or 0, b or 0)

        return Cost(flops=f(self.flops, other.flops),
                    bytes=f(self.bytes, other.bytes),
                    collectives=merge(self.collectives, other.collectives),
                    kernels=merge(self.kernels, other.kernels),
                    peak=f(self.peak, other.peak))

    def __add__(self, other: "Cost") -> "Cost":
        return self._combine(other, lambda a, b: a + b)

    def __sub__(self, other: "Cost") -> "Cost":
        return self._combine(other, lambda a, b: a - b)

    def scaled(self, k: float) -> "Cost":
        return self._combine(Cost(), lambda a, _: a * k)

    def as_record(self) -> Dict[str, Any]:
        """The dry-run record's ``cost`` entry."""
        return {"flops": self.flops, "bytes": self.bytes,
                "collective_bytes": self.collective_bytes,
                "by_collective": self.by_collective(),
                "by_axis": self.collectives, "kernels": self.kernels}


class CostCounter(TorchDispatchMode):
    """Counts one step's ``Cost`` (module docstring). ``mesh``: a
    ``DeviceMesh`` whose axes name the collectives' groups (a group of
    none of its axes counts under ``"other"``). Use as

        with CostCounter(mesh) as c:
            c.adopt(state, batch)     # the bytes live before the step
            step(...)
        c.cost

    The FLOPs come from a ``FlopCounterMode`` entered under this mode, so
    they are exactly what one around the same step on real tensors
    counts."""

    def __init__(self, mesh: Optional[Any] = None):
        super().__init__()
        from torch.utils.flop_counter import FlopCounterMode

        self.axes: Dict[str, str] = {}
        if mesh is not None:
            for a in mesh.mesh_dim_names:
                self.axes[mesh.get_group(a).group_name] = a
        self.cost = Cost()
        self._flops = FlopCounterMode(display=False)
        self._live: Dict[int, int] = {}
        self._cur = 0

    def __enter__(self):
        self._flops.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        self._flops.__exit__(*exc)
        self.cost.flops = float(self._flops.get_total_flops())
        return out

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return
        n = st.nbytes()
        self._live[key] = n
        self._cur += n
        self.cost.peak = max(self.cost.peak, self._cur)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self._cur -= self._live.pop(key)

    def adopt(self, *trees) -> None:
        """Count the tensors of ``trees`` (the params, the optimizer
        state, the inputs) as live from the start."""
        from repro_torch.tree import tree_leaves

        for tree in trees:
            for t in tree_leaves(tree):
                if isinstance(t, torch.Tensor) and t.device.type != "cpu":
                    self._track(t)

    def _collective(self, func, args) -> None:
        from torch._C._distributed_c10d import ProcessGroup

        kind, i_in, i_pg = COLLECTIVES[func]
        pg = ProcessGroup.unbox(args[i_pg])
        axis = self.axes.get(pg.group_name, "other")
        c = self.cost.collectives.setdefault(axis, {}).setdefault(
            kind, {"calls": 0, "bytes": 0})
        c["calls"] += 1
        c["bytes"] += _nbytes(args[i_in])

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in COLLECTIVES:
            self._collective(func, args)
            return func(*args, **kwargs)
        out = func(*args, **kwargs)
        ns = func.namespace
        if ns == "repro_torch":
            name = func._schema.name.split("::")[1]
            n_bytes, n_ops = kernel_cost(name, args)
            k = self.cost.kernels.setdefault(
                name, {"calls": 0, "bytes": 0, "ops": 0})
            k["calls"] += 1
            k["bytes"] += n_bytes
            k["ops"] += n_ops
        if ns in ("aten", "repro_torch") and not func.is_view \
                and func not in _NO_BYTES:
            self.cost.bytes += _nbytes(args) + _nbytes(kwargs) + _nbytes(out)
        for t in _tensors(out):
            if t.device.type != "cpu":
                self._track(t)
        return out
