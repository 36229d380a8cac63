#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

From the root of a checkout it:

1. builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``
   with ``nvcc`` for ``sm_90a`` (into the git-ignored
   ``src/repro_torch/kernels/build/``);
2. holds each kernel against its plain PyTorch version on the card, at
   the shapes the main path gives it and at ragged and misaligned
   shapes that reach each branch of each kernel, and times the
   kernel, the plain version and one PyTorch library call that computes
   the same function (CUDA events, L2 flushed before every launch);
3. drives the main path through the user's entry points: full-width
   papernet (configs/papernet.py) trained by 8 workers and one PS over
   the LTP path, 5 steps, three times — kernels with paper
   compensation; kernels with count compensation and error feedback;
   the same again with the plain ``python`` backend on the card — and
   checks that the kernels launched once per step, that the outputs are
   sane, and that the kernel run's params match the plain run's;
4. prints a ``kernels`` JSON line and, last, the device JSON line.

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
N_TIMED = 50


def fail(msg: str) -> int:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    return 1


class Timer:
    """Median time of one call, by CUDA events, over ``N_TIMED`` calls
    each made with a cold L2 (a 256 MiB buffer is written before it).
    A spin kernel after the flush keeps the card busy while the host
    enqueues the call, so the events time the device work and not the
    host's launch path."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")

    def ms(self, fn, n: int = N_TIMED, warmup: int = 5) -> float:
        torch = self.torch
        pairs = []
        for i in range(n + warmup):
            self.flush.zero_()
            torch.cuda._sleep(1_000_000)    # ~0.5 ms at H100 clocks
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            if i >= warmup:
                pairs.append((start, end))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in pairs)


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

    def record(name, shape, comp, path, err, tol, fn, plain, library,
               n_bytes, n_ops, main):
        ok = err <= tol
        row = {"name": name, "shape": list(shape), "mode": comp,
               "branch": path, "max_abs_err": err, "tol": tol, "ok": ok}
        if main:
            bound_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
            bound_ops = n_ops / F32_FLOPS_PER_S * 1e3
            row.update(
                ms=timer.ms(fn), plain_ms=timer.ms(plain),
                library_ms=None if library is None else timer.ms(library),
                bound_ms=max(bound_bytes, bound_ops),
                bound_by="bytes" if bound_bytes >= bound_ops else "operations",
                bytes=n_bytes)
        checks.append(row)
        if not ok:
            raise AssertionError(f"{name} {shape} {comp} ({path}): max abs "
                                 f"err {err} > {tol}")
        return row

    # packet_reduce: the W loop sums in another order than torch.sum, so
    # the two agree to float32 rounding of a sum of W terms of size ~1.
    # (W, n, p), offset of the packets in floats, main-path shape or not:
    # the main shape and a ragged one take the x4 branch; a payload that
    # is not a multiple of 4, and a misaligned stream, take the scalar one
    for (w, n, p), off, main in (((8, 1934, 360), 0, True),
                                 ((16, 33, 100), 0, False),
                                 ((8, 130, 361), 0, False),
                                 ((2, 5, 7), 0, False),
                                 ((4, 64, 360), 1, False)):
        x = randn_at((w, n, p), off)
        m = (torch.rand(w, n, device="cuda", generator=gen) < 0.8).float()
        path = branch(p, x)
        for comp in ("paper", "count"):
            got = ops.ltp_packet_reduce(x, m, compensation=comp)
            want = ref.packet_reduce_ref(x, m, compensation=comp)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            lib = ((lambda: torch.einsum("wnp,wn->np", x, m) / w)
                   if comp == "paper" else None)
            row = record(
                "packet_reduce", (w, n, p), comp, path, err, 1e-5,
                lambda: ops.ltp_packet_reduce(x, m, compensation=comp),
                lambda: ref.packet_reduce_ref(x, m, compensation=comp),
                lib, 4 * (w * n * p + w * n + n * p), 2 * w * n * p + n * p,
                main and comp == "paper")
            if main and comp == "paper":
                entries["packet_reduce"] = row
    if {r["branch"] for r in checks} != {"x4", "scalar"}:
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
            tol, lambda: ops.ltp_dropfill(x, m, s),
            lambda: ref.dropfill_ref(x, m, ones_or_s),
            lambda: torch.mul(x, m[:, None]),
            2 * n * p * es + n * 4 * (1 if s is None else 2), n * p, main)
        if main:
            entries["dropfill"] = row
    if {r["branch"] for r in checks[n_before:]} != {"x4", "scalar"}:
        raise AssertionError("dropfill cases missed a kernel branch")
    return checks, entries


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


def profile_step(torch, tr, batch):
    """One more training step under ``torch.profiler``: the step's host
    time, the device's busy time (union of kernel intervals), its idle
    share, and device time by kernel name. Profiling slows the host, so
    the wall time here is not the step time reported elsewhere."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.run([batch])
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
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
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"wall_ms": wall_us / 1e3, "n_kernels": len(kernels),
            "device_busy_ms": busy_us / 1e3,
            "idle_share": (1.0 - busy_us / wall_us) if kernels else None,
            "top_kernels_ms": [[name[:80], us / 1e3] for name, us in top]}


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
    del timer

    # the main path: counts zeroed just before each run, read just after
    runs = {}
    for label, backend, kw in (
            ("cuda_paper", "cuda", {}),
            ("cuda_count_ef", "cuda", {"compensation": "count",
                                       "error_feedback": True}),
            ("python_count_ef", "python", {"compensation": "count",
                                           "error_feedback": True})):
        pr_mod.LAUNCHES = 0
        df_mod.LAUNCHES = 0
        tr, step_s = run_main_path(torch, backend, **kw)
        launches = {"packet_reduce": pr_mod.LAUNCHES,
                    "dropfill": df_mod.LAUNCHES}
        runs[label] = (tr, step_s, launches)
        steady = statistics.median(step_s[1:])
        print(f"main path {label}: launches {json.dumps(launches)}; step "
              f"ms first {step_s[0] * 1e3:.3f}, median of the rest "
              f"{steady * 1e3:.3f}; {128 / steady:.1f} images/s; "
              f"history {json.dumps(tr.history)}")

    steps = 5
    expect = {"cuda_paper": {"packet_reduce": steps, "dropfill": 0},
              "cuda_count_ef": {"packet_reduce": steps, "dropfill": steps},
              "python_count_ef": {"packet_reduce": 0, "dropfill": 0}}
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
    prof = profile_step(torch, ker, SyntheticCIFAR(seed=0).train_batch(128, 5))
    print("profile cuda_count_ef step 6 " + json.dumps(prof))

    main_launches = {k: runs["cuda_paper"][2][k] + runs["cuda_count_ef"][2][k]
                     for k in ("packet_reduce", "dropfill")}
    src_file = "src/repro_torch/kernels/csrc/ltp_kernels.cu"
    replaces = {"packet_reduce": "src/repro/kernels/packet_reduce.py:56",
                "dropfill": "src/repro/kernels/dropfill.py:42"}
    line = []
    for name in ("packet_reduce", "dropfill"):
        e = entries[name]
        line.append({
            "name": name, "route": "cuda", "source": src_file,
            "replaces": replaces[name], "shape": e["shape"],
            "launches": main_launches[name],
            "max_abs_err": e["max_abs_err"], "max_err": e["max_abs_err"],
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
