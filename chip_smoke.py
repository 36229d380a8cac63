#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

From the root of a checkout it:

1. builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``
   with ``nvcc`` for ``sm_90a`` (into the git-ignored
   ``src/repro_torch/kernels/build/``);
2. holds each kernel (packet_reduce, dropfill, randomk) against its
   plain PyTorch version on the card, at the shapes the main paths give
   it and at ragged, misaligned and bfloat16 inputs that reach each
   branch of each kernel, and times the kernel, the plain version and
   one PyTorch library call that computes the same function (CUDA
   events around 40 back-to-back calls over copies of the inputs that
   exceed the L2); packet_reduce is also timed
   at (32, 1934, 360), where the memory rate outweighs the fixed cost;
3. holds ``tree_reduce`` (the rack -> root reduction, one kernel) against
   its plain version and the flat reduction at the main path's packet
   stream, for 4 racks of 2, a 5 + 3 split and interleaved racks, and at
   a misaligned ragged stream, checks one tree_reduce launch and no
   packet_reduce launch per call, and times it beside packet_reduce. No
   training path calls tree_reduce: its launches in the ``kernels`` line
   are these check calls, and say so;
4. drives the LTP path through the user's entry points: full-width
   papernet (configs/papernet.py) trained by 8 workers and one PS over
   the LTP path, 5 steps, three times — kernels with paper
   compensation; kernels with count compensation and error feedback;
   the same again with the plain ``python`` backend on the card — and
   checks that the kernels launched once per step, that the outputs are
   sane, and that the kernel run's params match the plain run's;
5. drives the Fig 5 compression path (``train.compressed.
   train_compressed``), with deterministic cuDNN convolutions:
   full-width papernet, batch 128, 5 steps each dense, Random-k at
   k = 0.1 through the randomk kernel, the same on the plain route on
   the card, and Top-k at k = 0.1; checks one randomk
   launch per step of the kernel run and none elsewhere, equal kept
   counts and matching params between the two Random-k runs, densities
   within 0.01 of k, and finite losses; then profiles the second step of
   a 2-step Random-k run (``profile fig5_randomk`` line: idle share, the
   randomk kernel's device time in the step beside that of the select's
   other ops), which must hold one randomk launch;
6. prints a ``kernels`` JSON line and, last, the device JSON line.

TF32 is switched off for cuDNN convolutions and matmuls for the whole
run, so that float32 comparisons compare float32 arithmetic. Any
failure raises and exits non-zero. Without a CUDA device, or without
the repo's ``src/`` beside it, the script exits non-zero and prints no
result.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (NVIDIA data sheet)
F32_FLOPS_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
L2_BYTES = 50 * 2**20          # H100 SXM L2 cache
SM_HZ = 1.98e9                 # H100 SXM boost clock, to size the spin
N_TIMED = 40                   # back-to-back calls a timed run
N_RUNS = 5                     # timed runs; their median is reported


def fail(msg: str) -> int:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    return 1


class Timer:
    """Time of one call on the card: CUDA events around ``N_TIMED``
    back-to-back calls, divided by the count; the median of ``N_RUNS``
    such runs. The calls rotate over copies of their inputs that together
    hold more than twice the L2, so each call finds its inputs evicted,
    as a caller does whose data was written long before. A spin kernel
    ahead of the first event holds the card while the host enqueues the
    run, so the events time the device and not the host's launch path. A
    run whose first event had passed before the host finished enqueueing
    (a call of many small kernels fills the launch queue) is taken again
    with half the calls."""

    def __init__(self, torch):
        self.torch = torch

    def copies(self, *args) -> list:
        """The argument tuple and enough copies of its tensors (``clone``:
        contiguous and 16-byte aligned) to exceed twice the L2."""
        torch = self.torch
        n_bytes = sum(a.numel() * a.element_size() for a in args
                      if isinstance(a, torch.Tensor))
        k = max(2, 1 + math.ceil(2 * L2_BYTES / max(n_bytes, 1)))
        return [args] + [tuple(a.clone() if isinstance(a, torch.Tensor)
                               else a for a in args) for _ in range(k - 1)]

    def ms(self, fn, inputs: list) -> float:
        """Median ms of ``fn(*inputs[i % len(inputs)])``."""
        torch = self.torch
        fn(*inputs[0])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(N_TIMED):
            fn(*inputs[i % len(inputs)])
        host_s_per_call = (time.perf_counter() - t0) / N_TIMED
        torch.cuda.synchronize()
        n, runs = N_TIMED, []
        for _ in range(N_RUNS + 12):
            torch.cuda._sleep(int(2 * n * host_s_per_call * SM_HZ) + 200_000)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for i in range(n):
                fn(*inputs[i % len(inputs)])
            end.record()
            late = start.query()
            torch.cuda.synchronize()
            if late:
                n = max(1, n // 2)
                continue
            runs.append(start.elapsed_time(end) / n)
            if len(runs) == N_RUNS:
                return statistics.median(runs)
        raise RuntimeError("the host could not enqueue a timed run ahead of "
                           "the card")


def bound(n_bytes: int, n_ops: int):
    """The least time (ms) the card could take: the larger of the bytes
    moved over the memory rate and the float32 operations over the
    float32 rate; and which of the two it is."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = n_ops / F32_FLOPS_PER_S * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                   else "operations")


def reduce_cost(w: int, n: int, p: int):
    """Bytes and float32 operations of a masked W-worker reduction of
    (W, n, p) packets: each packet and mask element read once, each
    output written once; a multiply and an add per packet element and a
    divide per output."""
    return 4 * (w * n * p + w * n + n * p), 2 * w * n * p + n * p


def check_kernels(torch, timer):
    """Every kernel against its plain version; returns (checks, entries
    for the kernels line keyed by kernel name)."""
    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device="cuda").manual_seed(0)
    checks, entries = [], {}

    def randn_at(shape, offset, dtype=torch.float32):
        """A contiguous random tensor whose data starts ``offset`` floats
        into its buffer (offset 1 breaks 16-byte alignment)."""
        buf = torch.randn(math.prod(shape) + offset, device="cuda",
                          generator=gen)
        return buf[offset:].view(shape).to(dtype)

    def branch(p, *tensors):
        """The kernel branch a call takes: 16-byte vectors ("x4") when
        the payload is a multiple of 4 and the f32 pointers are aligned,
        else one element a thread ("scalar")."""
        vec = p % 4 == 0 and all(t.dtype == torch.float32 and
                                 t.data_ptr() % 16 == 0 for t in tensors)
        return "x4" if vec else "scalar"

    def record(name, shape, comp, path, err, tol, args, fn, plain, library,
               n_bytes, n_ops, main):
        """One checked case; ``main`` ones are also timed, ``fn``,
        ``plain`` and ``library`` each called on copies of ``args``, with
        their bound the larger of bytes over the memory rate and
        operations over the float32 rate (bytes bind for all three
        kernels)."""
        ok = err <= tol
        row = {"name": name, "shape": list(shape), "mode": comp,
               "branch": path, "max_abs_err": err, "tol": tol, "ok": ok}
        if main:
            bound_ms, bound_by = bound(n_bytes, n_ops)
            inputs = timer.copies(*args)
            row.update(
                ms=timer.ms(fn, inputs), plain_ms=timer.ms(plain, inputs),
                library_ms=(None if library is None
                            else timer.ms(library, inputs)),
                bound_ms=bound_ms, bound_by=bound_by, bytes=n_bytes)
        checks.append(row)
        if not ok:
            raise AssertionError(f"{name} {shape} {comp} ({path}): max abs "
                                 f"err {err} > {tol}")
        return row

    # packet_reduce: the W loop sums in another order than torch.sum, so
    # the two agree to float32 rounding of a sum of W terms of size ~1.
    # (W, n, p), offset of the packets in floats, main-path shape or not,
    # timed or not: the main shape and a ragged one take the x4 branch
    # with W unrolled, W = 6 the x4 branch's worker loop; a payload that
    # is not a multiple of 4, and a misaligned stream, take the scalar
    # one. (32, 1934, 360) is timed to tell the memory rate from the
    # fixed cost, and is not listed.
    for (w, n, p), off, main, timed in (
            ((8, 1934, 360), 0, True, True),
            ((16, 33, 100), 0, False, False),
            ((6, 33, 100), 0, False, False),
            ((8, 130, 361), 0, False, False),
            ((2, 5, 7), 0, False, False),
            ((4, 64, 360), 1, False, False),
            ((32, 1934, 360), 0, False, True)):
        x = randn_at((w, n, p), off)
        m = (torch.rand(w, n, device="cuda", generator=gen) < 0.8).float()
        path = branch(p, x)
        if path == "x4":
            path += (" unrolled" if w in (2, 4, 8, 16, 32) else " loop")
        for comp in ("paper", "count"):
            got = ops.ltp_packet_reduce(x, m, compensation=comp)
            want = ref.packet_reduce_ref(x, m, compensation=comp)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            lib = ((lambda a, b: torch.einsum("wnp,wn->np", a, b) / w)
                   if comp == "paper" else None)
            row = record(
                "packet_reduce", (w, n, p), comp, path, err, 1e-5, (x, m),
                lambda a, b: ops.ltp_packet_reduce(a, b, compensation=comp),
                lambda a, b: ref.packet_reduce_ref(a, b, compensation=comp),
                lib, *reduce_cost(w, n, p), timed and comp == "paper")
            if main and comp == "paper":
                entries["packet_reduce"] = row
    if {r["branch"] for r in checks} != {"x4 unrolled", "x4 loop",
                                         "scalar"}:
        raise AssertionError("packet_reduce cases missed a kernel branch")

    # dropfill: the gate is the same float32 product in both, so float32
    # agrees exactly and bfloat16 within one rounding of the output.
    # (n, p), dtype, with a scale, offset in floats, main-path or not:
    # f32 x4 (main), f32 scalar for p % 4 != 0 and for a misaligned
    # stream, and bf16 (always one element a thread)
    n_before = len(checks)
    for (n, p, dt, with_scale, off), main in (
            ((15472, 360, torch.float32, False, 0), True),
            ((513, 129, torch.float32, True, 0), False),
            ((300, 360, torch.float32, False, 1), False),
            ((77, 7, torch.bfloat16, True, 0), False)):
        x = randn_at((n, p), off, dt)
        m = (torch.rand(n, device="cuda", generator=gen) < 0.7).float()
        s = (torch.rand(n, device="cuda", generator=gen) + 0.5
             if with_scale else None)
        ones_or_s = torch.ones_like(m) if s is None else s
        path = branch(p, x)
        got = ops.ltp_dropfill(x, m, s)
        want = ref.dropfill_ref(x, m, ones_or_s)
        donated = randn_at((n, p), off, dt).copy_(x)
        if branch(p, donated) != path:
            raise AssertionError("donated copy takes another branch")
        ops.ltp_dropfill(donated, m, s, donate=True)
        torch.cuda.synchronize()
        err = max((got.float() - want.float()).abs().max().item(),
                  (donated.float() - want.float()).abs().max().item())
        tol = 0.0 if dt == torch.float32 else 2**-8 * want.float().abs().max().item()
        es = x.element_size()
        row = record(
            "dropfill", (n, p), str(dt).replace("torch.", ""), path, err,
            tol, (x, m, s, ones_or_s),
            lambda a, b, c, _: ops.ltp_dropfill(a, b, c),
            lambda a, b, _, d: ref.dropfill_ref(a, b, d),
            lambda a, b, c, _: torch.mul(a, b[:, None]),
            2 * n * p * es + n * 4 * (1 if s is None else 2), n * p, main)
        if main:
            entries["dropfill"] = row
    if {r["branch"] for r in checks[n_before:]} != {"x4", "scalar"}:
        raise AssertionError("dropfill cases missed a kernel branch")

    # randomk: a select, so every case agrees exactly. (n,) or shape,
    # dtype, offset in floats, main-path or not: the Fig 5 path's flat
    # gradient (x4, 680 blocks, a 2-element tail); lengths 1, 3 and 5 (the
    # tail alone, one float4 and a tail); one float4 short of, exactly at
    # and one float4 past the main path's 680 whole blocks of 256 threads
    # (the last a block of one float4); a misaligned stream (scalar) and
    # bf16 (always one element a thread)
    n_before = len(checks)
    blocks = 4 * 256 * 680
    for shape, dt, off, main in (((696234,), torch.float32, 0, True),
                                 ((1,), torch.float32, 0, False),
                                 ((3,), torch.float32, 0, False),
                                 ((5,), torch.float32, 0, False),
                                 ((blocks - 4,), torch.float32, 0, False),
                                 ((blocks,), torch.float32, 0, False),
                                 ((blocks + 4,), torch.float32, 0, False),
                                 ((10001,), torch.float32, 1, False),
                                 ((37, 23), torch.bfloat16, 0, False)):
        x = randn_at(shape, off, dt)
        u = torch.rand(math.prod(shape) + off, device="cuda",
                       generator=gen)[off:].view(shape)
        path = ("x4" if dt == torch.float32 and x.data_ptr() % 16 == 0
                and u.data_ptr() % 16 == 0 else "scalar")
        for k in (0.0, 0.1, 1.0):
            got = ops.randomk_sparsify(x, u, k)
            want = ref.randomk_ref(x, u, k)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            n = x.numel()
            es = x.element_size()
            row = record(
                "randomk", shape, f"{str(dt).replace('torch.', '')} k={k}",
                path, err, 0.0, (x, u),
                lambda a, b: ops.randomk_sparsify(a, b, 0.1),
                lambda a, b: ref.randomk_ref(a, b, 0.1),
                lambda a, b: torch.where(b < 0.1, a, 0.0),
                n * (2 * es + 4), n, main and k == 0.1)
            if main and k == 0.1:
                entries["randomk"] = row
    if {r["branch"] for r in checks[n_before:]} != {"x4", "scalar"}:
        raise AssertionError("randomk cases missed a kernel branch")
    return checks, entries


def check_tree_reduce(torch, timer):
    """tree_reduce, one kernel launch a call and no packet_reduce launch,
    against its plain version (``ref.tree_reduce_ref``, the JAX order) and
    against the flat plain reduction, on the main path's packet stream in
    three rack layouts and on a misaligned ragged stream (scalar branch).
    Both agree within 1e-5 abs: FMA contraction, and sums of 8 unit-normal
    terms taken in another order. Returns the checked cases, the timed
    entry (4 racks of 2, paper) and the tree_reduce launches of the
    checks."""
    from repro_torch.kernels import packet_reduce as pr_mod
    from repro_torch.kernels import ref

    gen = torch.Generator(device="cuda").manual_seed(1)

    def stream(w, n, p, off):
        buf = torch.randn(w * n * p + off, device="cuda", generator=gen)
        m = (torch.rand(w, n, device="cuda", generator=gen) < 0.8).float()
        return buf[off:].view(w, n, p), m

    main_x, main_m = stream(8, 1934, 360, 0)
    cases = (("4x2", lambda f: f // 2, main_x, main_m, "x4"),
             ("5+3", lambda f: 0 if f < 5 else 1, main_x, main_m, "x4"),
             ("f%3", lambda f: f % 3, main_x, main_m, "x4"),
             ("f%3", lambda f: f % 3, *stream(6, 33, 100, 1), "scalar"))
    rows, n_launches = [], 0
    for label, rack_of, x, m, path in cases:
        if (x.data_ptr() % 16 == 0) != (path == "x4"):
            raise AssertionError(f"tree_reduce {label}: not the {path} "
                                 f"branch")
        members, rack_ptr = pr_mod.rack_groups(rack_of, x.shape[0])
        for comp in ("paper", "count"):
            pr_mod.LAUNCHES = pr_mod.TREE_LAUNCHES = 0
            got = pr_mod.tree_reduce(x, m, rack_of, compensation=comp)
            launches = {"tree_reduce": pr_mod.TREE_LAUNCHES,
                        "packet_reduce": pr_mod.LAUNCHES}
            n_launches += pr_mod.TREE_LAUNCHES
            plain = ref.tree_reduce_ref(
                x, m, torch.tensor(members), torch.tensor(rack_ptr),
                compensation=comp)
            flat = ref.packet_reduce_ref(x, m, compensation=comp)
            torch.cuda.synchronize()
            err = (got - plain).abs().max().item()
            err_flat = (got - flat).abs().max().item()
            row = {"name": "tree_reduce", "shape": list(x.shape),
                   "racks": label, "branch": path, "mode": comp,
                   "launches": launches, "max_abs_err": err,
                   "max_abs_err_flat": err_flat, "tol": 1e-5}
            rows.append(row)
            if launches != {"tree_reduce": 1, "packet_reduce": 0} or \
                    not max(err, err_flat) <= 1e-5:
                raise AssertionError(f"tree_reduce {label} {comp}: {row}")
    # the paper-mode 4x2 case on the main stream is the timed one
    w, n, p = main_x.shape
    x, m = main_x, main_m
    rack_of = cases[0][1]
    members, rack_ptr = pr_mod.rack_groups(rack_of, w)
    mem_t, ptr_t = torch.tensor(members), torch.tensor(rack_ptr)
    bound_ms, bound_by = bound(*reduce_cost(w, n, p))
    inputs = timer.copies(x, m)
    timed = {"name": "tree_reduce", "shape": [w, n, p], "racks": "4x2",
             "mode": "paper", "launches_per_call": 1,
             "max_abs_err": rows[0]["max_abs_err"],
             "ms": timer.ms(lambda a, b: pr_mod.tree_reduce(a, b, rack_of),
                            inputs),
             "packet_reduce_ms": timer.ms(
                 lambda a, b: pr_mod.packet_reduce(a, b), inputs),
             "plain_ms": timer.ms(
                 lambda a, b: ref.tree_reduce_ref(a, b, mem_t, ptr_t),
                 inputs),
             "library_ms": timer.ms(
                 lambda a, b: torch.einsum("wnp,wn->np", a, b) / w, inputs),
             "bound_ms": bound_ms, "bound_by": bound_by}
    return rows, timed, n_launches


def run_main_path(torch, sync_backend: str, **ltp_kw):
    """Full-width papernet, 8 workers, one PS, 5 LTP steps; returns the
    trainer and the per-step host times (s), each ending in a sync."""
    from repro_torch.config import LTPConfig, NetConfig, TrainConfig
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticCIFAR
    from repro_torch.models import build
    from repro_torch.optim import make_optimizer
    from repro_torch.train import PSTrainer

    cfg = get_config("papernet")
    tc = TrainConfig(batch=128, lr=0.05, steps=5)
    tr = PSTrainer(build(cfg), make_optimizer(tc), tc,
                   LTPConfig(sync_backend=sync_backend, **ltp_kw),
                   NetConfig(10, 1, 0.001, 4096), n_workers=8,
                   protocol="ltp", compute_time=0.05, seed=0, device="cuda")
    data = SyntheticCIFAR(seed=0)
    step_s = []
    for step in range(tc.steps):
        batch = data.train_batch(tc.batch, step)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.run([batch], epoch_steps=3)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    return tr, step_s


def run_fig5(torch, kind: str, backend: str):
    """The Fig 5 path: full-width papernet, batch 128, lr 0.05,
    SyntheticCIFAR(seed=3) as benchmarks/fig5_randomk_topk.py has them,
    5 steps, 1024 test images; Random-k and Top-k at k = 0.1. Returns
    (top1, median selection s, history, params)."""
    from repro_torch.config import TrainConfig
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticCIFAR
    from repro_torch.train.compressed import train_compressed

    data = SyntheticCIFAR(seed=3)
    return train_compressed(
        get_config("papernet"), TrainConfig(batch=128, lr=0.05), data,
        data.test_set(1024), kind, 0.1 if kind != "none" else 1.0, 5,
        device="cuda", seed=0, backend=backend, return_params=True)


def profile_step(torch, run, step=None, select=None):
    """``run()`` under ``torch.profiler``: its host time, the device's busy
    time (union of kernel intervals), its idle share, device time by kernel
    name, and the port's kernels' own device time. With ``step``, the name
    of a span that ``run`` opens (``record_function``) and closes after a
    synchronise, all of it is read inside that span alone: its host time
    and the kernels that start in it. With ``select``, a span inside that
    one, ``port_kernels_ms`` also holds the device time of each PyTorch op
    in it (``aten::`` dropped from the name). Without device kernels (a
    CPU callable) the idle share is None. Profiling slows the host, so the
    wall time here is not the step time reported elsewhere."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    with profile(activities=activities) as prof:
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        if cuda:
            torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.events()
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]

    def span(name, within=None):
        found = [e.time_range for e in cpu if e.name == name and (
            within is None or within.start <= e.time_range.start
            <= within.end)]
        if len(found) != 1:
            raise AssertionError(f"profile: {len(found)} spans {name!r}")
        return found[0]

    if step is not None:
        win = span(step)
        wall_us = win.elapsed_us()
        kernels = [e for e in kernels
                   if win.start <= e.time_range.start <= win.end]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy_us, cur_start, cur_end = 0.0, None, None
    for a, b in spans:
        if cur_end is None or a > cur_end:
            if cur_end is not None:
                busy_us += cur_end - cur_start
            cur_start, cur_end = a, b
        else:
            cur_end = max(cur_end, b)
    if cur_end is not None:
        busy_us += cur_end - cur_start
    by_name, n_of = {}, {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
        n_of[e.name] = n_of.get(e.name, 0) + 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    # the port's own kernels, timed inside the step, and their launches
    port = [name for name in by_name
            if any(f"(anonymous namespace)::{k}" in name
                   for k in ("reduce_kernel<", "dropfill", "randomk"))]
    ours = {name[:80]: by_name[name] / 1e3 for name in port}
    if select is not None:
        sel = span(select, win if step is not None else None)
        for e in cpu:
            if e.name.startswith("aten::") and \
                    sel.start <= e.time_range.start <= sel.end:
                for kern in e.kernels:
                    op = e.name[len("aten::"):]
                    ours[op] = ours.get(op, 0.0) + kern.duration / 1e3
    return {"wall_ms": wall_us / 1e3, "n_kernels": len(kernels),
            "device_busy_ms": busy_us / 1e3,
            "idle_share": (1.0 - busy_us / wall_us) if kernels else None,
            "top_kernels_ms": [[name[:80], us / 1e3] for name, us in top],
            "port_kernels_ms": ours,
            "port_launches": {name[:80]: n_of[name] for name in port}}


def profile_fig5_randomk(torch, step=1):
    """The Fig 5 Random-k step with error feedback, profiled: a
    ``train_compressed`` run of ``step + 1`` steps (full-width papernet,
    Random-k at k = 0.1 through the kernel, the settings of ``run_fig5``,
    128 test images) under ``profile_step``, read inside its last step,
    which finds the residual of the step before it: the gradient, the
    select (flatten, residual add, uniforms, the randomk kernel, the new
    residual) and the update. ``port_kernels_ms`` holds the randomk
    kernel's device time and that of each op of the select."""
    from repro_torch.config import TrainConfig
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticCIFAR
    from repro_torch.train.compressed import train_compressed

    data = SyntheticCIFAR(seed=3)
    prof = profile_step(
        torch, lambda: train_compressed(
            get_config("papernet"), TrainConfig(batch=128, lr=0.05), data,
            data.test_set(128), "randomk", 0.1, step + 1, device="cuda",
            seed=0, backend="cuda"),
        step=f"train_compressed step {step}",
        select="train_compressed select")
    if list(prof["port_launches"].values()) != [1] or \
            "randomk" not in next(iter(prof["port_launches"])):
        raise AssertionError(f"profile fig5_randomk: port launches "
                             f"{prof['port_launches']} in the step, not one "
                             f"randomk")
    return prof


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        return fail("no CUDA device is available")
    src = os.path.join(HERE, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        return fail(f"the port's package is not at {src}/repro_torch")
    sys.path.insert(0, src)
    from repro_torch.kernels import _build
    from repro_torch.kernels import dropfill as df_mod
    from repro_torch.kernels import packet_reduce as pr_mod
    from repro_torch.kernels import randomk as rk_mod
    from repro_torch.tree import tree_leaves

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card.splitlines()[0])
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}; TF32 off for convolutions "
          f"and matmuls")
    t0 = time.perf_counter()
    _build.load()
    nvcc = ("cached, no nvcc run" if _build.BUILD_SECONDS is None
            else f"nvcc {_build.BUILD_SECONDS:.2f} s")
    print(f"kernel build: {time.perf_counter() - t0:.2f} s ({nvcc})")
    print(_build.BUILD_LOG.strip(), file=sys.stderr)

    timer = Timer(torch)
    checks, entries = check_kernels(torch, timer)
    print("kernel_checks " + json.dumps(checks))
    tree_checks, tree_timed, tree_check_launches = check_tree_reduce(
        torch, timer)
    print("tree_reduce_checks " + json.dumps(tree_checks))
    print("tree_reduce " + json.dumps(tree_timed))

    counters = {"packet_reduce": (pr_mod, "LAUNCHES"),
                "tree_reduce": (pr_mod, "TREE_LAUNCHES"),
                "dropfill": (df_mod, "LAUNCHES"),
                "randomk": (rk_mod, "LAUNCHES")}

    def zero_counts():
        for mod, attr in counters.values():
            setattr(mod, attr, 0)

    def read_counts():
        return {name: getattr(mod, attr)
                for name, (mod, attr) in counters.items()}

    def launches_of(**counts):
        return {name: counts.get(name, 0) for name in counters}

    # the LTP path: counts zeroed just before each run, read just after
    runs = {}
    for label, backend, kw in (
            ("cuda_paper", "cuda", {}),
            ("cuda_count_ef", "cuda", {"compensation": "count",
                                       "error_feedback": True}),
            ("python_count_ef", "python", {"compensation": "count",
                                           "error_feedback": True})):
        zero_counts()
        tr, step_s = run_main_path(torch, backend, **kw)
        launches = read_counts()
        runs[label] = (tr, step_s, launches)
        steady = statistics.median(step_s[1:])
        print(f"main path {label}: launches {json.dumps(launches)}; step "
              f"ms first {step_s[0] * 1e3:.3f}, median of the rest "
              f"{steady * 1e3:.3f}; {128 / steady:.1f} images/s; "
              f"history {json.dumps(tr.history)}")

    steps = 5
    expect = {"cuda_paper": launches_of(packet_reduce=steps),
              "cuda_count_ef": launches_of(packet_reduce=steps,
                                           dropfill=steps),
              "python_count_ef": launches_of()}
    for label, (tr, _, launches) in runs.items():
        if launches != expect[label]:
            raise AssertionError(f"{label}: launches {launches}, expected "
                                 f"{expect[label]}")
        for h in tr.history:
            if not (math.isfinite(h["loss"]) and 0.0 < h["delivered"] <= 1.0
                    and h["bst"] > 0.0):
                raise AssertionError(f"{label}: bad record {h}")
    ker, ref_run = runs["cuda_count_ef"][0], runs["python_count_ef"][0]
    for a, b in zip(ker.history, ref_run.history):
        if (a["step"], a["bst"], a["sim_time"]) != \
                (b["step"], b["bst"], b["sim_time"]):
            raise AssertionError(f"transport differs: {a} vs {b}")
    worst = 0.0
    for x, y in zip(tree_leaves(ker.params), tree_leaves(ref_run.params)):
        torch.testing.assert_close(x, y, rtol=2e-4, atol=2e-5)
        worst = max(worst, (x - y).abs().max().item())
    print(f"params, kernels vs plain backend after {steps} steps: max abs "
          f"diff {worst:.3e} (rtol 2e-4, atol 2e-5)")

    # a sixth step of the kernel run, profiled (after the comparisons)
    from repro_torch.data import SyntheticCIFAR
    batch = SyntheticCIFAR(seed=0).train_batch(128, 5)
    prof = profile_step(torch, lambda: ker.run([batch]))
    print("profile cuda_count_ef step 6 " + json.dumps(prof))

    # the Fig 5 compression path, the same way. cuDNN's default weight
    # gradient sums with atomics, so two runs differ in the last bits and
    # an element can be exactly 0 in one and not in the other; with
    # deterministic convolutions the kernel run and the plain run differ
    # only in the randomk select, and keep the same elements.
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    fig5, fig5_params = {}, {}
    for label, kind, backend in (("none", "none", "auto"),
                                 ("randomk_cuda", "randomk", "cuda"),
                                 ("randomk_python", "randomk", "python"),
                                 ("topk", "topk", "auto")):
        zero_counts()
        top1, sel_s, hist, params = run_fig5(torch, kind, backend)
        launches = read_counts()
        step_s = statistics.median(h["seconds"] for h in hist[1:])
        fig5[label] = {
            "launches": launches, "top1": top1, "sel_ms": sel_s * 1e3,
            "first_step_ms": hist[0]["seconds"] * 1e3,
            "step_ms": step_s * 1e3, "images_per_s": 128 / step_s,
            "loss": [h["loss"] for h in hist],
            "density": [h["density"] for h in hist],
            "kept": [h["kept"] for h in hist]}
        want = launches_of(randomk=steps if label == "randomk_cuda" else 0)
        if launches != want:
            raise AssertionError(f"fig5 {label}: launches {launches}, "
                                 f"expected {want}")
        if len(hist) != steps or not all(math.isfinite(h["loss"])
                                         for h in hist):
            raise AssertionError(f"fig5 {label}: bad history {hist}")
        if kind != "none" and not all(abs(h["density"] - 0.1) <= 0.01
                                      for h in hist):
            raise AssertionError(f"fig5 {label}: density off k = 0.1: "
                                 f"{fig5[label]['density']}")
        if not 0.0 <= top1 <= 1.0:
            raise AssertionError(f"fig5 {label}: top1 {top1}")
        fig5_params[label] = params
    rk_ker, rk_plain = fig5["randomk_cuda"], fig5["randomk_python"]
    if rk_ker["kept"] != rk_plain["kept"]:
        raise AssertionError(f"fig5 Random-k kept counts differ: kernel "
                             f"{rk_ker['kept']}, plain {rk_plain['kept']}")
    worst_rk = 0.0
    for x, y in zip(tree_leaves(fig5_params["randomk_cuda"]),
                    tree_leaves(fig5_params["randomk_python"])):
        torch.testing.assert_close(x, y, rtol=2e-4, atol=2e-5)
        worst_rk = max(worst_rk, (x - y).abs().max().item())
    torch.backends.cudnn.deterministic = False
    print("fig5 " + json.dumps(fig5))
    print(f"fig5 params, randomk kernel vs plain route after {steps} steps: "
          f"max abs diff {worst_rk:.3e} (rtol 2e-4, atol 2e-5)")
    # a second Random-k step, profiled (after the counted runs)
    print("profile fig5_randomk " + json.dumps(profile_fig5_randomk(torch)))

    # tree_reduce is on no training path: its count is the check calls'
    main_launches = {
        name: sum(r[2][name] for r in runs.values())
        + sum(r["launches"][name] for r in fig5.values())
        for name in counters}
    if main_launches["tree_reduce"] != 0:
        raise AssertionError("a training path launched tree_reduce")
    main_launches["tree_reduce"] = tree_check_launches
    src_file = "src/repro_torch/kernels/csrc/ltp_kernels.cu"
    replaces = {"packet_reduce": "src/repro/kernels/packet_reduce.py:56",
                "tree_reduce": "src/repro/kernels/packet_reduce.py:69",
                "dropfill": "src/repro/kernels/dropfill.py:42",
                "randomk": "src/repro/kernels/randomk.py:36"}
    entries["tree_reduce"] = tree_timed
    line = []
    for name in counters:
        e = entries[name]
        line.append({
            "name": name, "route": "cuda", "source": src_file,
            "replaces": replaces[name], "shape": e["shape"],
            "launches": main_launches[name],
            "launches_from": ("check calls: no training path calls it"
                              if name == "tree_reduce" else "main paths"),
            "max_abs_err": e["max_abs_err"],
            "ms": e["ms"], "plain_ms": e["plain_ms"],
            "bound_ms": e["bound_ms"], "bound_by": e["bound_by"],
            "library_ms": e["library_ms"]})
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
