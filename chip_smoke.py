#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

From the root of a checkout it:

1. builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``
   with ``nvcc`` for ``sm_90a`` (into the git-ignored
   ``src/repro_torch/kernels/build/``);
2. holds each kernel (packet_reduce, dropfill in both its forms, the
   plain gate and the error-feedback one, randomk) against its plain
   PyTorch version on the card, at the shapes the main paths give it
   and at ragged, misaligned and bfloat16 inputs that reach each branch
   of each kernel, and times the kernel, the plain version and one
   PyTorch library call that computes the same function (for the EF
   form, three calls: add, mul, sub), with CUDA events around 40
   back-to-back calls over copies of the inputs that exceed the L2;
   packet_reduce is also timed at (32, 1934, 360), where the memory
   rate outweighs the fixed cost, and at (16, 1934, 360), the des16
   path's;
3. holds ``tree_reduce`` (the rack -> root reduction, one kernel) against
   its plain version and the flat reduction at the main path's packet
   stream, for 4 racks of 2, a 5 + 3 split and interleaved racks, and at
   a misaligned ragged stream, checks one tree_reduce launch and no
   packet_reduce launch per call, and times it beside packet_reduce. No
   training path calls tree_reduce: its launches in the ``kernels`` line
   are these check calls, and say so;
4. drives the LTP path through the user's entry points: full-width
   papernet (configs/papernet.py) trained by 8 workers and one PS over
   the LTP path on ``PSTrainer``'s lockstep engine, one ``run`` call a
   step, 5 steps, three times — kernels with paper
   compensation; kernels with count compensation and error feedback;
   the same again with the plain ``python`` backend on the card — and
   checks that the kernels launched once per step, that the outputs are
   sane, and that the kernel run's params match the plain run's; then
   profiles a sixth step, with the EF gate's device time by op
   (``select_ms``: one dropfill launch);
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
6. drives the cluster runtime, ``PSTrainer``'s default engine, at the
   same width, 5 steps a run, with count compensation and error
   feedback (``run_runtime_phase``): bsp on the runtime engine against
   the lockstep engine (equal transport fields, params within
   tolerance, one packet_reduce and one dropfill launch a step); async
   under lognormal stragglers through the kernels against the plain
   backend (equal histories, packet_reduce launched once an apply and
   dropfill once an admitted gradient, at (1934, 360)); a bsp run with a
   PS failure and an npz checkpoint (every step once, one failover, no
   lost gradient applied); then times each engine as one whole run after
   a 1-step warm-up and profiles one runtime bsp step, and prints the
   ``runtime`` line: host ms a step and images/s for each engine, the
   ``Sim`` events of the timed runtime run, the profiled step's idle
   share and its EF gate by op, and one profiled async apply
   (``profile_async_apply``: its EF gate, one dropfill launch, and its
   packet_reduce);
7. drives the packet-level transport (``transport="des"``,
   ``run_des_phase``) at the same width, 5 steps a run: bsp over ltp
   through ``PSTrainer``, kernels against the plain backend (equal
   transport fields and ``masks`` digests, params within tolerance, one
   packet_reduce and one dropfill launch a step); bsp over cubic
   (delivered 1.0, its mean bst beside ltp's); async with one 3x
   straggler, kernels against plain (launches once an apply and once an
   admitted gradient); then the DES and analytic runtimes timed, four
   runs each in turns, and one DES bsp step profiled, and prints the
   ``des`` line: host ms a step, images/s and ``Sim`` events a run of
   each transport, the profiled step's idle share, the two kernels'
   device time in it and its EF gate by op;
8. drives the paper's Fig 13 time-to-accuracy run (``train.tta.run_tta``,
   ``run_tta_phase``) at the same width and ``TTA_STEPS`` steps (the
   benchmark's 150, cut to 100 for the script's time; every run had
   reached the target by step 90), an eval every 10 on 1,024 images,
   losses 0 / 0.001 / 0.01 x ltp / bbr / cubic; checks completion,
   finite losses, evals in [0, 1], delivered 1.0 for bbr and cubic and
   one packet_reduce launch an ltp step; holds a 20-step ltp run at loss
   0.01 through the kernels against the plain backend (params within twice
   the distance of a one-ulp rounding control); prints the ``tta`` line
   (final accuracy, time to 0.45, final loss, delivered, simulated and host
   time, images/s of each run; ltp minus cubic final accuracy a loss, one
   seed);
9. drives the des16 fabric-chaos scenario (``train.netfault``,
   ``run_netfault_phase``) at the same width: 16 workers in 4 racks, two
   PS shards, 30 steps a run (cut for time, PERF.md §4), clean, faulted
   with the loss-budget
   controller and faulted without it; checks completion, the
   conservation of gradients, that faults and controller moves happened
   and one packet_reduce launch at (16, 1934, 360) a commit; holds an
   8-step faulted run with the controller through the kernels against
   the plain backend (equal transport fields and telemetry, params
   within twice the distance of a one-ulp rounding control), profiled
   over one step during the faults; prints the ``netfault`` line
   (recovery, goodput and final-loss ratios, fault counts, host ms a
   step, ``Sim`` events a run, the step's idle share);
10. drives the LM path (``run_lm_phase``): ``smollm_360m``'s CONFIG at
    its published widths and all 32 layers, float32 (361,821,120
    parameters, 1,005,059 packets), on ``train.lm.lm_trainer``, the
    setup of ``examples/train_lm.py`` (8 workers, batch 32, seq 128,
    AdamW at lr 3e-4, ``LTPConfig()``, the runtime engine over the
    analytic transport), fed from ``SyntheticLM(vocab=8192)``. First it
    holds packet_reduce at (8, 1005059, 360) and dropfill's EF form at
    (8040472, 360), the first streams past 2^31 floats, against their
    plain versions and times them. Then 5 steps of paper compensation
    and 3 of error feedback, each through the kernels, on the plain
    backend and on the plain backend from an init nudged by one ulp:
    one packet_reduce (and with EF one dropfill) launch a step on the
    kernel runs alone, equal transport fields, losses within rtol 1e-4
    that start near ln 49152 and fall, the first step's reduced stream
    kernel against plain, params within twice the rounding control's
    distance; host ms a step, tokens/s and peak device memory a run,
    and one profiled step of each form; prints the ``lm`` line;
11. serves the same model by KV-cache decode (``run_serve_phase``,
    ``train.serve.serve``: batch 4, a 16-token prompt, 24 new tokens),
    checks that the logits of the prompt's decode steps match one
    ``forward`` over the prompt, and prints the ``serve`` line;
12. drives the sharded LTP path (``run_sharded_phase``), the path of
    ``launch/train.py --mode sharded``: the same model and init through
    ``train.trainer.make_ltp_train_step`` over ``torch.distributed``, one
    rank over ``nccl`` at world size 1 on a (data 1, model 1)
    ``DeviceMesh``, AdamW at lr 3e-4, batch 32 x seq 128; 5 steps each of
    the psum variant under paper and under count compensation and of the
    ZeRO variant, through the kernels, on the plain route and on the
    plain route from a one-ulp-nudged init: the plain gate's kernel
    (``ltp_dropfill``) launched once a leaf a step (11) under paper and
    under count, never by the ZeRO variant or the plain runs; equal
    delivered fractions, losses within rtol 1e-4, params within twice
    the rounding control; host ms a step, tokens/s, peak memory;
    ``LTPSync`` (``make_ltp_sync``) on one gradient of the model, paper
    and count, with and without error feedback, kernels against the
    plain route; one profiled step (idle share, the gate's device time); the gate at
    its largest leaf (218454, 360) and over a step's 11 leaves, against
    its plain version and timed; then two gloo ranks on the card (CUDA
    tensors, REDUCED config, 3 steps) against the same two ranks on the
    CPU, within twice the CPU pair's rounding control (the ``sharded``
    line);
12b. drives tensor parallelism over ``model`` and data parallelism
    inside a worker (``run_tp_phase``), each config at its published
    widths in its own dtype, cut in depth, through
    ``make_ltp_train_step`` (psum, paper, SGD-momentum, 2 steps, cut for
    time): one
    ``mixtral_8x22b`` layer and one ``deepseek_v2_236b`` layer (its
    dense lead layer: MLA), batch 32 x seq 128; ``falcon_mamba_7b`` at
    2 layers, ``zamba2_7b`` at 7 (its shared block included),
    ``whisper_small`` at 6 + 6 layers and ``papernet`` whole, batch 8
    (papernet 128 images). Each at (data 1, model 1) in this process
    through the kernels (Mixtral with a profiled step) and from a
    one-ulp-nudged init (the rounding control), DeepSeek's ZeRO variant
    the same two ways; then at (data 1, model 2) as one pair of gloo ranks sharing
    the card, subprocesses of ``chip_smoke.py --tp-rank`` that take the
    models in turn, each rank holding its block of the heads, experts,
    channels or SSM heads and vocab: each through the kernels, Mixtral
    and DeepSeek also on the plain route for one step, DeepSeek with the
    ZeRO variant; one gate launch a leaf a step a rank, none on
    the plain route or by ZeRO, params within twice the model's rounding
    control of the plain route's (at its last step) and of the (1, 1)
    run's, the ranks' gathered params equal; host ms a
    step, peak memory a rank, the model axis's collective calls and
    bytes a step; then the same two ranks on (pod 1, data 2, model 1)
    train the sharded phase's smollm-360m (AdamW, psum paper through
    the kernels, each rank on half the batch) against that phase's
    world-size-1 run at step 2, the data axis's collectives counted;
    meanwhile REDUCED smollm, mixtral, deepseek-v2, falcon-mamba and
    zamba2 on (data 2, model 2), psum and ZeRO, and smollm on (pod 2,
    data 2, model 1), four gloo ranks on the card against four on the
    CPU (and four from a nudged init); the (1, 1) process and the (1, 2)
    ranks then serve the Mixtral and DeepSeek layers from the init
    (``tp_serve``: an (8, 128) prefill, then 16 decode steps from a
    cache holding the prefill's), (1, 2) within twice the (1, 1)
    logits' one-ulp rounding control, and in each of the prefill and
    the decode at least 90 % of the rows (a token's logits) within twice
    its median row, host ms a decode token, the model
    axis's collectives of the prefill and a token, peak memory; then the
    gate at Mixtral's layer's largest leaf (2236963, 360) and DeepSeek's
    (1456356, 360) and over each layer's leaves against its plain
    version and timed (the ``tp`` line);
12c. dry-runs the same configurations (``run_dryrun_phase``,
    ``launch.dryrun`` on ``meta`` tensors under a fake process group in
    this process): Mixtral's and DeepSeek's psum steps, DeepSeek's ZeRO
    step, the prefill and a decode token at (1, 2), their ``model``
    collectives' calls and bytes equal to the ranks' counts, their gate
    operator calls equal to the ranks' launches, their predicted peaks
    within 15 % of the measured ones (less what the card held beside the
    run), the (1, 1) steps' FLOPs within 0.1 % of ``FlopCounterMode``'s
    around one real step; then the single-pod ``train_4k`` (``--ltp``)
    and ``decode_32k`` rows of one architecture a family, which two
    background processes dry-run from the ``tp`` phase's start, when no
    host-timed phase but ``tp`` runs beside them (the ``dryrun`` line);
13. drives the MoE path, trained (``run_moe_phase``):
    ``mixtral_8x22b``'s CONFIG at its published widths in bfloat16, its
    own dtype, cut to 1 layer (2,906,720,256 parameters, 8,074,223
    packets), on ``train.lm.lm_trainer`` with W = 2 and SGD-momentum
    (both forced by memory), batch 8 x seq 128, 3 steps through the
    kernels: one packet_reduce launch a step, finite losses, step 1
    near ln V plus the random head's logit variance over 2, the first
    step's reduced stream against the plain route in blocks; peak
    memory, host ms a step, tokens/s, one profiled step; then, with the
    model freed, packet_reduce at (2, 8074223, 360) against its plain
    version and timed (the ``moe`` line; the kernel's row goes to the
    ``kernels`` line);
14. serves the MoE family (``run_moe_serve_phase``, ``train.serve.
    serve`` at float32, batch 4, 16 + 24 tokens): ``mixtral_8x22b`` and
    ``deepseek_v2_236b`` (MLA, 160 routed + 2 shared experts) at 2
    layers each, with decode against the forward of sequences of 8
    tokens, where no assignment is dropped (the ``moe_serve`` line);
15. drives the SSM family, trained (``run_ssm_phase``), on the LM
    phase's setup (W = 8, batch 32 x seq 128, AdamW lr 3e-4, paper
    compensation) in bfloat16 at the published widths, cut in depth:
    ``falcon_mamba_7b`` (Mamba-1) at 2 of 64 layers (743,305,216
    parameters, 2,064,737 packets; the ``ssm`` line) and ``zamba2_7b``
    (Mamba-2 and the shared attention block) at 7 of 81 layers, one
    period and a trailing layer (980,754,096 parameters, 2,724,317
    packets; the ``hybrid`` line), 3 steps each through the kernels: one
    packet_reduce launch a step, step 1 near ln V plus the random head's
    logit variance over 2, the first reduced stream against the plain
    route; peak memory, host ms a step, tokens/s, one profiled step with
    the device and host time inside the scan's span (``mamba1_scan``,
    ``ssd_chunk``); then each stream's packet_reduce checked and timed
    with the model freed;
16. serves the SSM family (``run_ssm_serve_phase``, float32, batch 4,
    16 + 24 tokens): falcon-mamba at 2 layers, zamba2 at 13 (two
    periods: the shared block decodes against two KV slots), decode
    against one forward over the prompt within 1e-5 of the largest
    logit (the ``ssm_serve`` line);
17. drives the enc-dec path, trained (``run_encdec_phase``):
    ``whisper_small``'s CONFIG at full depth and width in bfloat16 (12
    encoder + 12 decoder layers, d_model 768, 1,500 frames, vocab
    51,865: 278,098,944 parameters, 772,498 packets) on the LM phase's
    setup, 3 steps through the kernels: one packet_reduce launch a
    step, step 1 near ln V plus the random head's logit variance over
    2, the first reduced stream against the plain route; peak memory,
    host ms a step, tokens/s, one profiled step with the host and device
    time inside the ``encoder`` span; then the stream's packet_reduce
    checked and timed with the model freed (the ``encdec`` line);
18. serves it from its encoder (``run_encdec_serve_phase``, float32,
    batch 4, frames (4, 1500, 768), a 16-token prompt, 24 new tokens,
    twice): ``prefill`` fills each decoder layer's cross K/V, placed in
    an ``init_cache``; the prompt decoded token by token, then greedily;
    decode against ``decode_train`` over the prompt and ``prefill``'s
    logits against the last prompt step's, within 1e-5 of the largest
    logit (the ``encdec_serve`` line);
19. prints a ``kernels`` JSON line (dropfill's entry with its EF form's
    numbers beside the plain gate's and its sharded-path rows under
    ``sharded`` and its tensor-parallel rows under ``tp`` and
    ``tp_deepseek``, whose launches are counted there alone,
    packet_reduce's
    with its des16
    shape's, whose launches are counted there alone, and both with
    their LM shape's under ``lm``, packet_reduce also with its MoE,
    SSM and enc-dec shapes' under ``moe``, ``ssm``, ``hybrid`` and
    ``whisper``, whose launches are counted there alone), a ``phases``
    line (each phase's wall seconds, which its own line carries too, and
    the total) and, last, the device JSON line.

Every LM path trains with remat (``loss_fn``'s default): each stacked
period, and each layer of whisper's two stacks, is recomputed in the
backward.

TF32 is switched off for cuDNN convolutions and matmuls for the whole
run, so that float32 comparisons compare float32 arithmetic. Any
failure raises and exits non-zero. Without a CUDA device, or without
the repo's ``src/`` beside it, the script exits non-zero and prints no
result.
"""
from __future__ import annotations

import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

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
    (a call of many small kernels fills the launch queue, or the host
    stalls) is taken again with half the calls and four times the spin
    a call."""

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

    def ms(self, fn, inputs: list, n_timed: int = N_TIMED) -> float:
        """Median ms of ``fn(*inputs[i % len(inputs)])``, ``n_timed``
        calls a run."""
        torch = self.torch
        fn(*inputs[0])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n_timed):
            fn(*inputs[i % len(inputs)])
        host_s_per_call = (time.perf_counter() - t0) / n_timed
        torch.cuda.synchronize()
        n, slack, runs = n_timed, 1, []
        for _ in range(N_RUNS + 12):
            torch.cuda._sleep(min(int(SM_HZ), slack * (
                int(2 * n * host_s_per_call * SM_HZ) + 200_000)))
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for i in range(n):
                fn(*inputs[i % len(inputs)])
            end.record()
            late = start.query()
            torch.cuda.synchronize()
            if late:
                n, slack = max(1, n // 2), 4 * slack
                continue
            runs.append(start.elapsed_time(end) / n)
            if len(runs) == N_RUNS:
                return statistics.median(runs)
        raise RuntimeError("the host could not enqueue a timed run ahead of "
                           "the card")


def cost():
    """``repro_torch.launch.cost``: the kernels' byte and operation
    formulas and ``bound``, the least time the card could take (the
    larger of the bytes over the memory rate and the float32 operations
    over the float32 rate, ``launch/mesh.py``'s H100 figures), which the
    dry-run's counts use too."""
    from repro_torch.launch import cost as mod

    return mod


def bound(n_bytes: int, n_ops: int):
    return cost().bound(n_bytes, n_ops)


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
    # one. (16, 1934, 360) is the des16 path's shape, listed beside the
    # main one; (32, 1934, 360) is timed to tell the memory rate from the
    # fixed cost, and is not listed.
    for (w, n, p), off, main, timed in (
            ((8, 1934, 360), 0, True, True),
            ((16, 1934, 360), 0, True, True),
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
                lib, *cost().reduce_cost(w, n, p), timed and comp == "paper")
            if main and comp == "paper":
                entries["packet_reduce" if w == 8 else
                        f"packet_reduce_w{w}"] = row
    if {r["branch"] for r in checks} != {"x4 unrolled", "x4 loop",
                                         "scalar"}:
        raise AssertionError("packet_reduce cases missed a kernel branch")

    # dropfill: the gate is the same float32 product in both, so float32
    # agrees exactly and bfloat16 within one rounding of the output.
    # (n, p), dtype, with a scale, offset in floats, main-path or not,
    # timed or not: f32 x4 (main: the bsp step's W-worker stream; and the
    # runtime's per-gradient error-feedback gate, one gradient's (1934,
    # 360), timed and not listed), f32 scalar for p % 4 != 0 and for a
    # misaligned stream, and bf16 (always one element a thread)
    n_before = len(checks)
    for (n, p, dt, with_scale, off), main, timed in (
            ((15472, 360, torch.float32, False, 0), True, True),
            ((1934, 360, torch.float32, False, 0), False, True),
            ((513, 129, torch.float32, True, 0), False, False),
            ((300, 360, torch.float32, False, 1), False, False),
            ((77, 7, torch.bfloat16, True, 0), False, False)):
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
            *cost().dropfill_cost(n, p, es, s is not None), timed)
        if main:
            entries["dropfill"] = row
    if {r["branch"] for r in checks[n_before:]} != {"x4", "scalar"}:
        raise AssertionError("dropfill cases missed a kernel branch")

    # dropfill's error-feedback form, the gate of every port caller: the
    # same float32 add, multiply and subtract in both, so every case agrees
    # exactly. (n, p), offset in floats, timed or not: x4 at the bsp step's
    # W-worker stream and at one gradient's (1934, 360); scalar for p % 4
    # != 0 and for a misaligned stream. No one PyTorch call computes the
    # pair: the library yardstick is the plain version's three calls
    # (torch.add, torch.mul, torch.sub).
    n_before = len(checks)
    for (n, p, off), timed in (((15472, 360, 0), True),
                               ((1934, 360, 0), True),
                               ((513, 129, 0), False),
                               ((300, 360, 1), False)):
        f, r = randn_at((n, p), off), randn_at((n, p), off)
        m = (torch.rand(n, device="cuda", generator=gen) < 0.7).float()
        got = ops.ltp_dropfill_ef(f, r, m)
        want = ref.dropfill_ef_ref(f, r, m)
        torch.cuda.synchronize()
        err = max((g - w).abs().max().item() for g, w in zip(got, want))
        row = record(
            "dropfill_ef", (n, p), "float32", branch(p, f, r), err, 0.0,
            (f, r, m), ops.ltp_dropfill_ef, ref.dropfill_ef_ref,
            ref.dropfill_ef_ref, *cost().dropfill_ef_cost(n, p), timed)
        if timed:
            row["library_calls"] = "3: torch.add, torch.mul, torch.sub"
            entries.setdefault("dropfill_ef", []).append(row)
    if {r["branch"] for r in checks[n_before:]} != {"x4", "scalar"}:
        raise AssertionError("dropfill_ef cases missed a kernel branch")

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
                *cost().randomk_cost(n, es), main and k == 0.1)
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
    bound_ms, bound_by = bound(*cost().reduce_cost(w, n, p))
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


def trainer(torch, engine: str, steps: int, sync_backend: str,
            transport: str = "analytic", protocol: str = "ltp", **ltp_kw):
    """``PSTrainer`` on ``engine`` over full-width papernet, 8 workers,
    one PS, global batch 128, ``NetConfig(10, 1, 0.001, 4096)``, seed 0."""
    from repro_torch.config import LTPConfig, NetConfig, TrainConfig
    from repro_torch.configs import get_config
    from repro_torch.models import build
    from repro_torch.optim import make_optimizer
    from repro_torch.train import PSTrainer

    tc = TrainConfig(batch=128, lr=0.05, steps=steps)
    return PSTrainer(build(get_config("papernet")), make_optimizer(tc), tc,
                     LTPConfig(sync_backend=sync_backend, **ltp_kw),
                     NetConfig(10, 1, 0.001, 4096), n_workers=8,
                     protocol=protocol, compute_time=0.05, seed=0,
                     device="cuda", engine=engine, transport=transport)


def run_main_path(torch, sync_backend: str, **ltp_kw):
    """Full-width papernet, 8 workers, one PS, 5 LTP steps on the lockstep
    engine, one ``run`` call a step (the runtime engine restarts its
    workers at each call); returns the trainer and the per-step host
    times (s), each ending in a sync."""
    from repro_torch.data import SyntheticCIFAR

    tr = trainer(torch, "lockstep", 5, sync_backend, **ltp_kw)
    tc = tr.train_cfg
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


class Window:
    """A host-time interval in the profiler's microseconds, read as its
    spans are."""

    def __init__(self, start, end):
        self.start, self.end = start, end

    def elapsed_us(self):
        return self.end - self.start


def profile_step(torch, run, step=None, select=None, which=None,
                 between=False, span_names=()):
    """``run()`` under ``torch.profiler``: its host time, the device's busy
    time (union of kernel intervals), its idle share, device time by kernel
    name, and the port's kernels' own device time. With ``step``, the name
    of a span that ``run`` opens (``record_function``), all of it is read
    inside that span alone: its host time and the kernels launched in it
    (by the host time of their launch, or where the trace holds no launch
    record, of their start). ``run`` opens the span once, or ``which``
    picks one (an index into the spans of that name, in order, or a
    callable that returns it once ``run`` has returned). With ``between``,
    the window is one step of an event loop whose steps end in that span:
    from the end of the span before the picked one to the end of the
    picked one. With
    ``select``, a span inside that one, ``select_ms`` holds the device time
    of everything launched in it by op: each PyTorch op (``aten::`` dropped
    from the name) and each port kernel by its own name
    (``select_device_ms``, their sum).
    With ``span_names``, names of spans that ``run`` may open many times,
    ``spans`` holds for each its count, host ms (the spans' summed
    durations) and the device ms and count of the kernels launched inside
    any of them.
    Without device kernels (a CPU callable) the idle share is None.
    Profiling slows the host, so the wall time here is not the step time
    reported elsewhere."""
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
    # a kernel and the runtime call that launched it share a correlation id
    launched = {e.id: e.time_range.start for e in cpu
                if e.name.startswith("cuda") and "Launch" in e.name}

    def launch_of(k):
        return launched.get(k.id, k.time_range.start)

    def span(name, within=None, pick=None):
        found = sorted((e.time_range for e in cpu if e.name == name and (
            within is None or within.start <= e.time_range.start
            <= within.end)), key=lambda r: r.start)
        if not found or (pick is None and len(found) != 1):
            raise AssertionError(f"profile: {len(found)} spans {name!r}")
        return found[0 if pick is None else pick]

    def port_kernel(name):
        return any(f"(anonymous namespace)::{k}" in name
                   for k in ("reduce_kernel<", "dropfill", "randomk"))

    if step is not None:
        pick = which() if callable(which) else which
        win = span(step, pick=pick)
        if between:
            if pick < 1:
                raise AssertionError(f"profile: no {step!r} span before "
                                     f"the picked one")
            win = Window(span(step, pick=pick - 1).end, win.end)
        wall_us = win.elapsed_us()
        kernels = [e for e in kernels
                   if win.start <= launch_of(e) <= win.end]
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
    port = [name for name in by_name if port_kernel(name)]
    ours = {name[:80]: by_name[name] / 1e3 for name in port}
    out = {}
    if select is not None:
        sel = span(select, win if step is not None else None)
        by_op = {}
        for e in cpu:
            if e.name.startswith("aten::") and \
                    sel.start <= e.time_range.start <= sel.end:
                for kern in e.kernels:
                    op = e.name[len("aten::"):]
                    by_op[op] = by_op.get(op, 0.0) + kern.duration / 1e3
        for e in kernels:
            if port_kernel(e.name) and sel.start <= launch_of(e) <= sel.end:
                by_op[e.name[:80]] = (by_op.get(e.name[:80], 0.0)
                                      + e.time_range.elapsed_us() / 1e3)
        out = {"select_ms": by_op, "select_device_ms": sum(by_op.values())}
    if span_names:
        out["spans"] = {}
        for name in span_names:
            wins = [e.time_range for e in cpu if e.name == name]
            inside = [k for k in kernels if any(
                w.start <= launch_of(k) <= w.end for w in wins)]
            out["spans"][name] = {
                "count": len(wins),
                "host_ms": sum(w.elapsed_us() for w in wins) / 1e3,
                "device_ms": sum(k.time_range.elapsed_us()
                                 for k in inside) / 1e3,
                "n_kernels": len(inside)}
    return {"wall_ms": wall_us / 1e3, "n_kernels": len(kernels),
            "device_busy_ms": busy_us / 1e3,
            "idle_share": (1.0 - busy_us / wall_us) if kernels else None,
            "top_kernels_ms": [[name[:80], us / 1e3] for name, us in top],
            "port_kernels_ms": ours,
            "port_launches": {name[:80]: n_of[name] for name in port},
            **out}


def profile_fig5_randomk(torch, step=1):
    """The Fig 5 Random-k step with error feedback, profiled: a
    ``train_compressed`` run of ``step + 1`` steps (full-width papernet,
    Random-k at k = 0.1 through the kernel, the settings of ``run_fig5``,
    128 test images) under ``profile_step``, read inside its last step,
    which finds the residual of the step before it: the gradient, the
    select (flatten, residual add, uniforms, the randomk kernel, the new
    residual) and the update. ``port_kernels_ms`` holds the randomk
    kernel's device time in the step, ``select_ms`` that of each op of the
    select, the randomk kernel among them."""
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


STRAGGLERS = dict(base=0.05, sigma=0.3, straggler_prob=0.25)


def ef_gate_launches(prof, step_name):
    """The port kernels launched in a profile's ``ef_gate`` span: raises
    unless they are one dropfill launch and nothing else."""
    gate = [k for k in prof["select_ms"] if "::" in k]
    if len(gate) != 1 or "dropfill" not in gate[0]:
        raise AssertionError(f"profile {step_name}: the EF gate launched "
                             f"{gate}, not one dropfill")


def profile_async_apply(torch):
    """One async apply with error feedback, profiled: a 1-step async run of
    ``cluster_runtime`` (count compensation + EF, lognormal stragglers,
    through the kernels; 8 gradients, one an apply) under
    ``profile_step``, read inside its last ``apply_batch`` span: the
    gradient's EF gate (``select_ms``: one dropfill launch), the stack of
    one gradient and 7 zero rows, packet_reduce and the update."""
    from repro_torch.runtime import LognormalStragglerCompute

    rt = cluster_runtime(
        torch, 1, "cuda", dict(staleness_comp=0.5, compensation="count",
                               error_feedback=True),
        policy="async",
        compute_model=LognormalStragglerCompute(8, **STRAGGLERS))
    data = host_batches(1)
    prof = profile_step(torch, lambda: rt.run(data, epoch_steps=3),
                        step="apply_batch", which=-1, select="ef_gate")
    prof["n_applies"] = len(rt.history)
    ef_gate_launches(prof, "async apply")
    if sorted(n for k, n in prof["port_launches"].items()) != [1, 1] or \
            not any("reduce_kernel<" in k for k in prof["port_launches"]):
        raise AssertionError(f"profile async apply: port launches "
                             f"{prof['port_launches']}, not one dropfill "
                             f"and one packet_reduce")
    return prof


def cluster_runtime(torch, steps: int, sync_backend: str, ltp_kw=None,
                    **kw):
    """``ClusterRuntime`` with ``trainer``'s settings (the entry point a
    user takes for faults, checkpoints and compute models)."""
    from repro_torch.config import LTPConfig, NetConfig, TrainConfig
    from repro_torch.configs import get_config
    from repro_torch.models import build
    from repro_torch.optim import make_optimizer
    from repro_torch.runtime import ClusterRuntime

    tc = TrainConfig(batch=128, lr=0.05, steps=steps)
    return ClusterRuntime(build(get_config("papernet")), make_optimizer(tc),
                          tc, LTPConfig(sync_backend=sync_backend,
                                        **(ltp_kw or {})),
                          NetConfig(10, 1, 0.001, 4096), n_workers=8,
                          protocol="ltp", compute_time=0.05, seed=0,
                          device="cuda", **kw)


def host_batches(steps: int) -> list:
    from repro_torch.data import SyntheticCIFAR, batches
    return list(batches(SyntheticCIFAR(seed=0), 128, steps))


def timed_run(torch, make, steps: int):
    """``make(n)`` builds a trainer or runtime for n steps: ``steps``
    steps in one ``run`` call, timed as a whole on the host clock between
    synchronizes. Returns (seconds, ``Sim`` events the run processed)."""
    from repro_torch.net.simcore import PERF

    data = host_batches(steps)
    obj = make(steps)
    torch.cuda.synchronize()
    ev0 = PERF.events
    t0 = time.perf_counter()
    obj.run(data, epoch_steps=3)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, PERF.events - ev0


def max_abs_diff(torch, a, b) -> float:
    """Largest |a - b| over two trees' leaves; raises unless every leaf
    agrees within rtol 2e-4 / atol 2e-5."""
    from repro_torch.tree import tree_leaves

    worst = 0.0
    for x, y in zip(tree_leaves(a), tree_leaves(b), strict=True):
        torch.testing.assert_close(x, y, rtol=2e-4, atol=2e-5)
        worst = max(worst, (x - y).abs().max().item())
    return worst


def nudged(torch, params, seed):
    """``params`` with every element moved by one unit in its last place,
    up or down at random: the init of a rounding control."""
    from repro_torch.tree import tree_leaves, tree_map

    gen = torch.Generator(device=tree_leaves(params)[0].device)
    gen.manual_seed(seed)
    return tree_map(lambda x: torch.nextafter(x, torch.where(
        torch.rand(x.shape, device=x.device, generator=gen) < 0.5,
        -math.inf, math.inf).to(x.dtype)), params)


def distance(a, b) -> float:
    """Largest |a - b| over two trees' leaves."""
    from repro_torch.tree import tree_leaves

    return max((x - y).abs().max().item()
               for x, y in zip(tree_leaves(a), tree_leaves(b), strict=True))


def within_rounding(label, ker, plain, control) -> dict:
    """The kernel run's params against the plain run's, held to twice the
    distance between the plain run and the plain run from a one-ulp
    nudged init. Float32 rounding differences grow with every step of
    training: after enough steps no fixed tolerance tells a summation
    order from a fault, the rounding control does."""
    got, ctl = distance(ker, plain), distance(plain, control)
    if not got <= 2 * ctl:
        raise AssertionError(f"{label}: params {got:.4e} apart, over twice "
                             f"the rounding control's {ctl:.4e}")
    return {"params_max_abs_diff": got,
            "params_max_abs_diff_rounding_control": ctl}


def run_runtime_phase(torch, zero_counts, read_counts, launches_of,
                      steps=5):
    """The cluster runtime (``PSTrainer``'s default engine) at full width,
    ``steps`` steps a run, three ways, each with count compensation and
    error feedback:

    * bsp, engine ``runtime`` against engine ``lockstep``, both through
      the kernels, with deterministic convolutions: equal step, bst and
      delivered, each engine's sim_time the sum of the same compute and
      bst in its own association ((t + compute) + bst for the runtime,
      t + (compute + bst) for lockstep, as in the JAX package), params
      within rtol 2e-4 / atol 2e-5; the runtime run launches
      packet_reduce and dropfill once a step. Then each engine timed as
      a whole run after a 1-step warm-up, with cuDNN's defaults, four
      runs each in turns;
    * async under ``LognormalStragglerCompute(8, **STRAGGLERS)`` with
      staleness_comp 0.5, through the kernels and on the plain backend:
      equal step, staleness, n_grads, delivered and sim_time, params
      within tolerance; packet_reduce launched once an apply, dropfill
      once an admitted gradient, nothing on the plain run;
    * bsp with a PS failure at 0.16 s (down 0.05 s) and an npz
      checkpoint every 0.1 s: every step committed once, one failover,
      gradients lost to the downtime counted out and none applied.

    Then one runtime bsp step (a 1-step run) profiled. Returns (the
    ``runtime`` line, the launches of the counted runs)."""
    import tempfile

    from repro_torch.runtime import FaultEvent, FaultSchedule
    from repro_torch.runtime import LognormalStragglerCompute
    from repro_torch.tree import tree_leaves

    ef = {"compensation": "count", "error_feedback": True}
    line, launches = {}, []

    def counted(label, make):
        zero_counts()
        obj = make()
        obj.run(host_batches(steps), epoch_steps=3)
        got = read_counts()
        launches.append(got)
        line.setdefault("launches", {})[label] = got
        return obj, got

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        lock, _ = counted("bsp_lockstep", lambda: trainer(
            torch, "lockstep", steps, "cuda", **ef))
        rt, got = counted("bsp_runtime", lambda: trainer(
            torch, "runtime", steps, "cuda", **ef))
        if rt._rt is None or got != launches_of(packet_reduce=steps,
                                                dropfill=steps):
            raise AssertionError(f"runtime bsp: launches {got}")
        t_rt = t_ls = 0.0
        for a, b in zip(rt.history, lock.history, strict=True):
            t_rt = (t_rt + 0.05) + a["bst"]
            t_ls += 0.05 + b["bst"]
            if (a["step"], a["bst"], a["delivered"]) != \
                    (b["step"], b["bst"], b["delivered"]) or \
                    (a["sim_time"], b["sim_time"]) != (t_rt, t_ls) or \
                    abs(a["sim_time"] - b["sim_time"]) > 1e-15 * t_ls:
                raise AssertionError(f"runtime vs lockstep: {a} vs {b}")
            if not math.isfinite(a["loss"]):
                raise AssertionError(f"runtime bsp: bad record {a}")
        line["bsp_runtime_vs_lockstep"] = {
            "history": rt.history,
            "sim_time_bits_equal": sum(
                a["sim_time"] == b["sim_time"]
                for a, b in zip(rt.history, lock.history)),
            "params_max_abs_diff": max_abs_diff(torch, rt.params,
                                                lock.params),
            "params_bitwise": all(
                torch.equal(x, y) for x, y in zip(tree_leaves(rt.params),
                                                  tree_leaves(lock.params)))}

        def async_run(backend):
            return cluster_runtime(
                torch, steps, backend, dict(staleness_comp=0.5, **ef),
                policy="async",
                compute_model=LognormalStragglerCompute(8, **STRAGGLERS))

        ker, got = counted("async_cuda", lambda: async_run("cuda"))
        plain, got_plain = counted("async_python",
                                   lambda: async_run("python"))
        hist = ker.history
        want = launches_of(packet_reduce=len(hist),
                           dropfill=sum(h["n_grads"] for h in hist))
        if got != want or got_plain != launches_of():
            raise AssertionError(f"async: launches {got} (want {want}), "
                                 f"plain {got_plain}")
        keys = ("step", "staleness", "n_grads", "delivered", "sim_time")
        for a, b in zip(hist, plain.history, strict=True):
            if [a[k] for k in keys] != [b[k] for k in keys] or \
                    not math.isfinite(a["loss"]):
                raise AssertionError(f"async kernels vs plain: {a} vs {b}")
        s = ker.tel.summary()
        line["async"] = {
            "n_applies": len(hist), "n_grads": sum(h["n_grads"]
                                                   for h in hist),
            "staleness_max": s["staleness_max"],
            "n_early_close": s["n_early_close"],
            "sim_time": ker.sim_time,
            "params_max_abs_diff": max_abs_diff(torch, ker.params,
                                                plain.params)}
    finally:
        torch.backends.cudnn.deterministic = False

    with tempfile.TemporaryDirectory() as ckpt_dir:
        fo, got = counted("failover", lambda: cluster_runtime(
            torch, steps, "cuda", ef,
            faults=FaultSchedule([FaultEvent(0.16, "ps_fail", 0,
                                             recover_s=0.05)]),
            checkpoint_every_s=0.1, checkpoint_dir=ckpt_dir))
        archive = os.path.exists(os.path.join(ckpt_dir, "runtime_ckpt.npz"))
    tel = fo.tel
    n_ready = len(tel.of("grad_ready"))
    applied = sum(e["n_grads"] for e in tel.of("apply"))
    n_lost = len(tel.of("ps_lost"))
    n_other = len(tel.of("stale_drop")) + len(tel.of("flow_torn"))
    line["failover"] = {
        "steps": [h["step"] for h in fo.history],
        "n_failovers": len(tel.of("ps_failover")), "n_ps_lost": n_lost,
        "grad_ready": n_ready, "applied": applied,
        "n_checkpoints": len(tel.of("checkpoint")), "archive": archive}
    if [h["step"] for h in fo.history] != list(range(steps)) or \
            len(tel.of("ps_failover")) != 1 or n_lost == 0 or \
            n_ready != applied + n_lost + n_other or not archive or \
            not all(math.isfinite(h["loss"]) for h in fo.history):
        raise AssertionError(f"failover: {line['failover']}")

    # the event loop's cost: each engine timed as a whole run, after a
    # 1-step warm-up run of each, in turns (L R R L L R R L), since the
    # host's pace drifts within a call
    def make(engine):
        return lambda n: trainer(torch, engine, n, "cuda", **ef)

    readings = {"lockstep": [], "runtime": []}
    for engine in readings:
        make(engine)(1).run(host_batches(1), epoch_steps=3)
    for engine in ("lockstep", "runtime", "runtime", "lockstep") * 2:
        secs, events = timed_run(torch, make(engine), steps)
        readings[engine].append(secs / steps * 1e3)
        if engine == "runtime":
            line["sim_events_per_run"] = events
    line["timing"] = {
        engine: {"host_ms_per_step": ms,
                 "median_host_ms_per_step": statistics.median(ms),
                 "images_per_s": 128e3 / statistics.median(ms)}
        for engine, ms in readings.items()}
    one, batch = trainer(torch, "runtime", 1, "cuda", **ef), host_batches(1)
    prof = profile_step(torch, lambda: one.run(batch), select="ef_gate")
    ef_gate_launches(prof, "runtime bsp step")
    line["profile_runtime_bsp_step"] = prof
    line["idle_share"] = prof["idle_share"]
    line["profile_async_apply"] = profile_async_apply(torch)
    return line, launches


def run_des_phase(torch, zero_counts, read_counts, launches_of, steps=5):
    """The packet-level transport (``transport="des"``: ``ClusterRuntime``
    over ``DESTransport``, packet trains of 32) at full width, ``steps``
    steps a run, count compensation and error feedback:

    * bsp over ltp through ``PSTrainer``, the kernels against the plain
      backend, with deterministic convolutions: equal step, bst,
      sim_time and delivered, equal ``masks`` digests (the host DES's
      delivery masks), params within rtol 2e-4 / atol 2e-5 (bitwise is
      reported); packet_reduce and dropfill once a step, nothing on the
      plain run;
    * bsp over cubic through the kernels: every step delivers 1.0; its
      mean bst beside ltp's (the paper's contrast, a simulated metric);
    * async with ``DeterministicCompute(8, base=0.05, mults=[1] * 7 +
      [3])``, kernels against plain: equal step, staleness, n_grads,
      delivered and sim_time, equal digests; packet_reduce launched once
      an apply and dropfill once an admitted gradient;

    then the DES and the analytic runtime, each timed as a whole 5-step
    run after a 1-step warm-up, four runs each in turns, and one DES bsp
    step (a 1-step run) profiled. Returns (the ``des`` line, the
    launches of the counted runs)."""
    from repro_torch.runtime import DeterministicCompute
    from repro_torch.tree import tree_leaves

    ef = {"compensation": "count", "error_feedback": True}
    line, launches = {}, []

    def counted(label, make):
        zero_counts()
        obj = make()
        obj.run(host_batches(steps), epoch_steps=3)
        got = read_counts()
        launches.append(got)
        line.setdefault("launches", {})[label] = got
        return obj, got

    def digests(tel):
        return [e["digest"] for e in tel.of("masks")]

    def compare(label, ker, plain, keys):
        """Two ``ClusterRuntime`` runs, kernels and plain backend."""
        for a, b in zip(ker.history, plain.history, strict=True):
            if [a[k] for k in keys] != [b[k] for k in keys] or \
                    not math.isfinite(a["loss"]) or \
                    not 0.0 < a["delivered"] <= 1.0:
                raise AssertionError(f"des {label} kernels vs plain: "
                                     f"{a} vs {b}")
        if digests(ker.tel) != digests(plain.tel):
            raise AssertionError(f"des {label}: masks digests differ")
        return {"params_max_abs_diff": max_abs_diff(torch, ker.params,
                                                    plain.params),
                "params_bitwise": all(
                    torch.equal(x, y) for x, y in zip(
                        tree_leaves(ker.params), tree_leaves(plain.params)))}

    def des_trainer(backend, n=steps, protocol="ltp"):
        return trainer(torch, "runtime", n, backend, transport="des",
                       protocol=protocol, **ef)

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        ker, got = counted("bsp_ltp_cuda", lambda: des_trainer("cuda"))
        plain, got_plain = counted("bsp_ltp_python",
                                   lambda: des_trainer("python"))
        net_des = ker._rt.net_des
        if net_des is None or plain._rt.net_des is None or \
                got != launches_of(packet_reduce=steps, dropfill=steps) or \
                got_plain != launches_of():
            raise AssertionError(f"des bsp: launches {got}, plain "
                                 f"{got_plain}")
        same = compare("bsp", ker._rt, plain._rt,
                       ("step", "bst", "sim_time", "delivered"))
        dk = digests(ker._rt.tel)
        if len(dk) != steps:
            raise AssertionError(f"des bsp: {len(dk)} masks digests")
        bst_ltp = statistics.mean(h["bst"] for h in ker.history)
        line["bsp_ltp"] = {
            "history": ker.history, "masks_digests": dk,
            "n_early_close": len(ker._rt.tel.of("early_close")),
            "mean_bst": bst_ltp, "coalesce": net_des.coalesce,
            "packets_per_flow": net_des.n,
            "plan_packets": ker.plan.n_packets,
            "flow_stats": net_des.flow_stats(), **same}

        # a lossless gather: the fused step takes the plain mean, no kernel
        cub, got = counted("bsp_cubic_cuda",
                           lambda: des_trainer("cuda", protocol="cubic"))
        if got != launches_of():
            raise AssertionError(f"des cubic: launches {got}")
        if [h["delivered"] for h in cub.history] != [1.0] * steps or \
                not all(math.isfinite(h["loss"]) for h in cub.history):
            raise AssertionError(f"des cubic: {cub.history}")
        line["bsp_cubic"] = {
            "history": cub.history,
            "mean_bst": statistics.mean(h["bst"] for h in cub.history),
            "ltp_mean_bst": bst_ltp}

        def async_run(backend):
            return cluster_runtime(
                torch, steps, backend, ef, policy="async", transport="des",
                compute_model=DeterministicCompute(8, base=0.05,
                                                   mults=[1.0] * 7 + [3.0]))

        ka, got = counted("async_cuda", lambda: async_run("cuda"))
        pa, got_plain = counted("async_python", lambda: async_run("python"))
        hist = ka.history
        want = launches_of(packet_reduce=len(hist),
                           dropfill=sum(h["n_grads"] for h in hist))
        if got != want or got_plain != launches_of():
            raise AssertionError(f"des async: launches {got} (want {want}),"
                                 f" plain {got_plain}")
        same = compare("async", ka, pa, ("step", "staleness", "n_grads",
                                         "delivered", "sim_time"))
        line["async"] = {
            "n_applies": len(hist),
            "n_grads": sum(h["n_grads"] for h in hist),
            "n_early_close": len(ka.tel.of("early_close")),
            "min_delivered": min(h["delivered"] for h in hist),
            "staleness_max": max(h["staleness"] for h in hist),
            "sim_time": ka.sim_time, **same}
    finally:
        torch.backends.cudnn.deterministic = False

    # the DES event loop's host cost against the analytic transport on the
    # same step: each timed as a whole run after a 1-step warm-up, in
    # turns (D A A D D A A D), since the host's pace drifts within a call
    def make(transport):
        return lambda n: trainer(torch, "runtime", n, "cuda",
                                 transport=transport, **ef)

    readings = {"des": [], "analytic": []}
    events = {"des": [], "analytic": []}
    for transport in readings:
        make(transport)(1).run(host_batches(1), epoch_steps=3)
    for transport in ("des", "analytic", "analytic", "des") * 2:
        secs, n_events = timed_run(torch, make(transport), steps)
        readings[transport].append(secs / steps * 1e3)
        events[transport].append(n_events)
    line["timing"] = {
        t: {"host_ms_per_step": ms,
            "median_host_ms_per_step": statistics.median(ms),
            "spread_ms": max(ms) - min(ms),
            "images_per_s": 128e3 / statistics.median(ms),
            "sim_events_per_run": events[t]}
        for t, ms in readings.items()}
    one, batch = des_trainer("cuda", n=1), host_batches(1)
    prof = profile_step(torch, lambda: one.run(batch), select="ef_gate")
    ef_gate_launches(prof, "DES bsp step")
    line["profile_des_bsp_step"] = prof
    line["idle_share"] = prof["idle_share"]
    return line, launches


def strip_loss(events) -> list:
    return [{k: v for k, v in e.items() if k != "loss"} for e in events]


TTA_STEPS = 100      # benchmarks/fig13_tta.py's 150, cut (PERF.md §4)


def run_tta_phase(torch, zero_counts, read_counts, launches_of, *,
                  device="cuda", cfg=None, steps=TTA_STEPS, eval_every=10,
                  n_test=1024, check_steps=20):
    """The paper's Fig 13 (``train.tta.run_tta``) at papernet's full width
    and the benchmark's schedule cut in steps: 9 runs of ``steps`` steps
    (losses 0 / 0.001 / 0.01 x ltp / bbr / cubic; 8 workers, batch 128,
    ``compute_time=0.05``), an eval every ``eval_every`` steps on
    ``n_test`` images, target 0.45. Checks that every run completes with
    finite losses and evals in [0, 1], that bbr and cubic deliver 1.0 and
    that packet_reduce launched once an ltp step. Accuracy is reported,
    not gated: it is the paper's claim under test, and one seed of it.
    Every run uses deterministic convolutions, so the line repeats from
    run to run. Then an ltp run at loss 0.01 of ``check_steps`` steps
    through the kernels against the plain backend, from one init: equal
    step, bst, sim_time and delivered, evals within 2/``n_test``, params
    within twice the distance of the rounding control (the plain run from
    the init nudged by one ulp). Returns (the ``tta`` line, the launches
    of the counted runs)."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticCIFAR
    from repro_torch.models import build
    from repro_torch.train import tta

    cfg = cfg if cfg is not None else get_config("papernet")
    line, launches = {"runs": []}, []
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    zero_counts()
    rows = tta.run_tta(quick=False, cfg=cfg, steps=steps,
                       eval_every=eval_every, n_test=n_test, device=device)
    got = read_counts()
    launches.append(got)
    line["launches"] = {"runs": got}
    n_ltp = sum(len(r["history"]) for r in rows if r["protocol"] == "ltp")
    if got != launches_of(packet_reduce=n_ltp):
        raise AssertionError(f"tta: launches {got}, not one packet_reduce "
                             f"an ltp step ({n_ltp})")
    acc = {}
    for r in rows:
        hist = r["history"]
        evals = [h["eval"] for h in hist if "eval" in h]
        label = f"{r['protocol']} loss {r['loss']}"
        if len(hist) != steps or \
                not all(math.isfinite(h["loss"]) for h in hist) or \
                len(evals) != steps // eval_every or \
                not all(0.0 <= e <= 1.0 for e in evals):
            raise AssertionError(f"tta {label}: bad history {hist}")
        if r["protocol"] != "ltp" and \
                any(h["delivered"] != 1.0 for h in hist):
            raise AssertionError(f"tta {label}: delivered below 1.0")
        acc[(r["loss"], r["protocol"])] = r["final_acc"]
        line["runs"].append({
            k: r[k] for k in ("loss", "protocol", "final_acc", "tta_s",
                              "target", "final_loss", "delivered",
                              "total_sim_time_s", "host_s",
                              "images_per_s")} | {"evals": evals})
    line["ltp_minus_cubic_final_acc"] = {
        str(loss): acc[(loss, "ltp")] - acc[(loss, "cubic")]
        for loss in sorted({r["loss"] for r in rows})}
    line["ltp_minus_cubic_final_acc_seeds"] = [0]

    test = {k: torch.as_tensor(v).to(device)
            for k, v in SyntheticCIFAR(seed=5).test_set(n_test).items()}
    init = build(cfg).init(torch.Generator().manual_seed(0), device=device)
    runs = {}
    for label, backend, params in (("cuda", "cuda", init),
                                   ("python", "python", init),
                                   ("python_nudged", "python",
                                    nudged(torch, init, 1))):
        zero_counts()
        runs[label], _ = tta.train_tta(
            cfg, 0.01, "ltp", check_steps, test, eval_every=eval_every,
            sync_backend=backend, device=device, params=params)
        got = read_counts()
        launches.append(got)
        line["launches"]["check_" + label] = got
        if got != launches_of(packet_reduce=check_steps if backend == "cuda"
                              else 0):
            raise AssertionError(f"tta check {label}: launches {got}")
    torch.backends.cudnn.deterministic = False
    ker, plain = runs["cuda"], runs["python"]
    keys = ("step", "bst", "sim_time", "delivered")
    for a, b in zip(ker.history, plain.history, strict=True):
        if [a[k] for k in keys] != [b[k] for k in keys] or \
                ("eval" in a) != ("eval" in b) or \
                abs(a.get("eval", 0.0) - b.get("eval", 0.0)) > 2 / n_test:
            raise AssertionError(f"tta check kernels vs plain: {a} vs {b}")
    line["check_ltp_loss_0.01"] = {
        "steps": check_steps,
        "evals": [[a["eval"], b["eval"]] for a, b in zip(
            ker.history, plain.history) if "eval" in a],
        **within_rounding("tta check", ker.params, plain.params,
                          runs["python_nudged"].params)}
    return line, launches


def run_netfault_phase(torch, zero_counts, read_counts, launches_of, *,
                       device="cuda", cfg=None, steps=30, check_steps=8):
    """The des16 fabric-chaos scenario (``train.netfault``) at papernet's
    full width: 16 workers in 4 racks of 4, two PS shards, batch 64,
    ``compute_time=0.01``, staleness_comp 0.5, ``steps`` steps a run, three
    runs on ``DES16_NETFAULTS``: the clean twin, faults with
    ``BudgetController(interval_s=0.02)``, faults without it. Checks that
    every run completes, that every gradient is applied, dropped or
    counted out (``grad_ready == applied + stale + torn + lost +
    flow_dead``), that faults fired and rerouted or blackholed on both
    faulted runs, that the controller moved, and that packet_reduce
    launched once a commit at (16, 1934, 360). Then the faulted budget
    run of ``check_steps`` steps through the kernels, under the profiler,
    against the plain backend, with deterministic convolutions: equal
    step, bst, sim_time and delivered, equal telemetry streams apart from
    loss, params within twice the distance of the rounding control (the
    plain run from the init nudged by one ulp); the profile is read over
    one step, the first to commit after the partition at 0.13 s. Returns
    (the ``netfault`` line, the launches of the counted runs)."""
    from repro_torch.config import TrainConfig
    from repro_torch.configs import get_config
    from repro_torch.models import build
    from repro_torch.net.simcore import PERF
    from repro_torch.train import netfault as nf

    api = build(cfg if cfg is not None else get_config("papernet"))
    tc = TrainConfig(batch=4 * nf.W, lr=0.05, steps=steps)
    faulted = {"net_faults": nf.DES16_NETFAULTS}
    line, launches, rts, rows = {}, [], {}, {}
    nf.des16_cell(api, TrainConfig(batch=4 * nf.W, lr=0.05, steps=1), 1,
                  device=device)                  # warm-up, not counted
    zero_counts()
    for label, kw in (("clean", {}), ("budget", dict(faulted, budget=True)),
                      ("nobudget", faulted)):
        ev0 = PERF.events
        rts[label], rows[label] = nf.des16_cell(api, tc, steps,
                                                device=device, **kw)
        row = rows[label]
        row.update(sim_events=PERF.events - ev0,
                   host_ms_per_step=row["wall_s"] / steps * 1e3)
    got = read_counts()
    launches.append(got)
    line["launches"] = {"runs": got}
    n_commits = sum(len(rt.history) for rt in rts.values())
    if got != launches_of(packet_reduce=n_commits):
        raise AssertionError(f"netfault: launches {got}, not one "
                             f"packet_reduce a commit ({n_commits})")
    metrics = nf.des16_metrics(rows["clean"], rows["budget"],
                               rows["nobudget"], steps)
    for label, rt in rts.items():
        tel, row = rt.tel, rows[label]
        applied = sum(e["n_grads"] for e in tel.of("apply"))
        out = (len(tel.of("stale_drop")) + len(tel.of("flow_torn"))
               + len(tel.of("ps_lost")) + len(tel.of("flow_dead")))
        row["grad_ready"], row["applied"] = len(tel.of("grad_ready")), applied
        if row["n_steps_done"] != steps or \
                row["grad_ready"] != applied + out or \
                not all(math.isfinite(h["loss"]) for h in rt.history):
            raise AssertionError(f"netfault {label}: {row}")
        if label != "clean" and not (
                row["n_netfaults"] > 0 and
                row["n_reroutes"] + row["n_blackholes"] > 0):
            raise AssertionError(f"netfault {label}: no fault took: {row}")
    if rows["budget"]["n_budget_moves"] == 0:
        raise AssertionError("netfault: the controller never moved")
    line["rows"] = rows
    line["metrics"] = metrics

    check_tc = TrainConfig(batch=4 * nf.W, lr=0.05, steps=check_steps)
    init = api.init(torch.Generator().manual_seed(nf.SEED), device=device)
    runs = {}

    def check_run(label, backend, params):
        zero_counts()
        runs[label] = nf.des16_cell(
            api, check_tc, check_steps, budget=True, sync_backend=backend,
            device=device, params=params, **faulted)[0]
        runs[label + "_launches"] = read_counts()
        launches.append(runs[label + "_launches"])

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    def first_after_partition():
        return next(i for i, h in enumerate(runs["cuda"].history)
                    if h["sim_time"] > 0.13)

    try:
        # the kernel run under the profiler: each step of its event loop
        # ends in the device work of a bsp commit (span ``bsp_commit``)
        prof = profile_step(
            torch, lambda: check_run("cuda", "cuda", init),
            step="bsp_commit", between=True, which=first_after_partition)
        check_run("python", "python", init)
        check_run("python_nudged", "python", nudged(torch, init, 1))
    finally:
        torch.backends.cudnn.deterministic = False
    ker, plain = runs["cuda"], runs["python"]
    for label in ("cuda", "python", "python_nudged"):
        line["launches"]["check_" + label] = runs[label + "_launches"]
    if runs["cuda_launches"] != launches_of(packet_reduce=len(ker.history)) \
            or runs["python_launches"] != launches_of() \
            or runs["python_nudged_launches"] != launches_of():
        raise AssertionError(f"netfault check: launches {line['launches']}")
    keys = ("step", "bst", "sim_time", "delivered")
    for a, b in zip(ker.history, plain.history, strict=True):
        if [a[k] for k in keys] != [b[k] for k in keys]:
            raise AssertionError(f"netfault check kernels vs plain: {a} vs "
                                 f"{b}")
    if len(ker.history) != check_steps or \
            strip_loss(ker.tel.events) != strip_loss(plain.tel.events):
        raise AssertionError("netfault check: telemetry streams differ")
    line["check_budget"] = {
        "steps": check_steps, "n_events": len(ker.tel.events),
        "summary": ker.tel.summary(),
        # a one-ulp nudge may flip a budget decision (it reads the loss)
        "rounding_control_transport_equal":
            strip_loss(runs["python_nudged"].tel.events)
            == strip_loss(plain.tel.events),
        **within_rounding("netfault check", ker.params, plain.params,
                          runs["python_nudged"].params)}
    line["profile_faulted_step"] = {"step": first_after_partition(), **prof}
    line["idle_share"] = prof["idle_share"]
    return line, launches


# the LM path: smollm-360m at its published widths and depth, on
# examples/train_lm.py's setup
LM_W, LM_BATCH, LM_SEQ = 8, 32, 128
LM_DATA_VOCAB = 8192         # the corpus examples/train_lm.py itself uses
LM_STEPS, LM_EF_STEPS = 5, 3
LM_LOSS_RTOL = 1e-4


def lm_kernel_row(timer, shape, err, tol, inputs, fn, plain, library,
                  n_bytes, n_ops) -> dict:
    """One kernel checked and timed at an LM stream: 5 calls a timed
    run (one call reads far more than the L2 holds)."""
    if not err <= tol:
        raise AssertionError(f"{shape}: max abs err {err} > {tol}")
    bound_ms, bound_by = bound(n_bytes, n_ops)
    return {"shape": list(shape), "max_abs_err": err, "tol": tol,
            "ms": timer.ms(fn, inputs, 5),
            "plain_ms": timer.ms(plain, inputs, 5),
            "library_ms": timer.ms(library, inputs, 5),
            "bound_ms": bound_ms, "bound_by": bound_by, "bytes": n_bytes}


def check_lm_kernels(torch, timer, w: int, n: int, p: int,
                     device="cuda", ef: bool = True) -> dict:
    """packet_reduce (paper compensation) at the LM step's (W, n, p)
    stream and, with ``ef``, dropfill's error-feedback form at its (W n,
    p) rows, the first streams past 2^31 floats (2,894,569,920 at
    smollm's full size), each against its plain version on random
    inputs: packet_reduce within 1e-5 (a sum of W terms of size ~1 in
    another order), the EF form exactly (the same float32 add, multiply
    and subtract). The plain
    EF gate runs in blocks of 2^20 rows: it is elementwise, so each block
    is the plain function's own output, and a whole second copy of its
    three 11.6 GB outputs would not fit beside the kernel's. The library
    yardsticks are ``einsum("wnp,wn->np") / W`` (``linalg.vecdot`` over
    the worker axis where the stream holds 2^31 floats a worker or more,
    past what einsum's batched GEMM indexes) and the plain EF gate's
    three calls. Returns rows keyed by kernel name."""
    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device=device).manual_seed(1)
    rows = {}
    x = torch.randn((w, n, p), device=device, generator=gen)
    m = (torch.rand(w, n, device=device, generator=gen) < 0.8).float()
    got = ops.ltp_packet_reduce(x, m)
    want = ref.packet_reduce_ref(x, m)
    err = (got - want).abs().max().item()
    del got, want
    if n * p < 2 ** 31:
        call = 'einsum("wnp,wn->np") / W'

        def library(a, b):
            return torch.einsum("wnp,wn->np", a, b) / w
    else:
        # einsum's batched GEMM takes a leading dimension below 2^31
        call = "linalg.vecdot(x, m[..., None], dim=0) / W"

        def library(a, b):
            return torch.linalg.vecdot(a, b[..., None], dim=0) / w
    rows["packet_reduce"] = lm_kernel_row(
        timer, (w, n, p), err, 1e-5, [(x, m)], ops.ltp_packet_reduce,
        ref.packet_reduce_ref, library, *cost().reduce_cost(w, n, p))
    rows["packet_reduce"]["library_call"] = call
    del x, m
    if not ef:
        return rows
    n_rows, blk = w * n, 1 << 20
    f = torch.randn((n_rows, p), device=device, generator=gen)
    r = torch.randn((n_rows, p), device=device, generator=gen)
    mk = (torch.rand(n_rows, device=device, generator=gen) < 0.7).float()
    sent, new_res = ops.ltp_dropfill_ef(f, r, mk)
    err = 0.0
    for i in range(0, n_rows, blk):
        ws, wr = ref.dropfill_ef_ref(f[i:i + blk], r[i:i + blk],
                                     mk[i:i + blk])
        err = max(err, (sent[i:i + blk] - ws).abs().max().item(),
                  (new_res[i:i + blk] - wr).abs().max().item())
    del sent, new_res, ws, wr
    rows["dropfill_ef"] = lm_kernel_row(
        timer, (n_rows, p), err, 0.0, [(f, r, mk)], ops.ltp_dropfill_ef,
        ref.dropfill_ef_ref, ref.dropfill_ef_ref,
        *cost().dropfill_ef_cost(n_rows, p))
    rows["dropfill_ef"]["library_calls"] = "3: torch.add, torch.mul, torch.sub"
    return rows


class StampedBatch(dict):
    """A host batch that notes the host clock, after a synchronise, when
    the runtime first reads it: under bsp, at the start of its step's
    commit, so successive stamps bound one step each."""

    def __init__(self, batch, stamps, torch):
        super().__init__(batch)
        self.stamps, self.torch = stamps, torch

    def items(self):
        self.torch.cuda.synchronize()
        self.stamps.append(time.perf_counter())
        return super().items()


PLAIN_BLOCK = 1 << 18       # packets a block of the plain reduction


def capture_first_reduction():
    """Wrap ``ltp_sync.reduce_packet_stream`` so that its first call, the
    first step's PS reduction through the kernels, also runs the plain
    route on the same inputs (no launch counted), ``PLAIN_BLOCK``
    packets at a time: each packet's reduction is its own, so each block
    is the plain function's own output, and the route's temporaries at
    the whole stream (47 GB at the MoE path's) need not fit beside the
    model. Returns the record it fills and the function that takes the
    wrapper off."""
    import dataclasses

    from repro_torch.core import ltp_sync as ls

    orig = ls.reduce_packet_stream
    rec = {}

    def wrapped(flat, masks, ltp, w, **kw):
        out = orig(flat, masks, ltp, w, **kw)
        if not rec:
            plain_ltp = dataclasses.replace(ltp, sync_backend="python")
            n, step = flat.shape[1], PLAIN_BLOCK
            diff, equal = 0.0, True
            for i in range(0, n, step):
                plain = orig(flat[:, i:i + step], masks[:, i:i + step],
                             plain_ltp, w, **kw)
                diff = max(diff, (out[i:i + step] - plain).abs().max().item())
                equal = equal and bool((out[i:i + step] == plain).all())
                del plain
            rec.update(shape=list(flat.shape), max_abs_diff=diff,
                       equal=equal, plain_block_packets=step,
                       max_abs=out.abs().max().item())
        return out

    ls.reduce_packet_stream = wrapped
    return rec, lambda: setattr(ls, "reduce_packet_stream", orig)


def run_lm_phase(torch, timer, zero_counts, read_counts, launches_of, *,
                 device="cuda", cfg=None):
    """The LM path: ``smollm_360m``'s CONFIG at float32 (d_model 960, 15
    heads / 5 KV heads of 64, d_ff 2560, vocab 49,152, tied embeddings,
    32 layers; 361,821,120 parameters, 1,005,059 packets), on
    ``train.lm.lm_trainer``, the setup of ``examples/train_lm.py``: 8
    workers, batch 32, seq 128, AdamW at lr 3e-4, ``LTPConfig()``,
    ``NetConfig(10, 1, 0.001, 4096)``, the runtime engine over the
    analytic transport. The one cut: tokens come from
    ``SyntheticLM(vocab=8192)``, whose dense tables at 49,152 would take
    19.3 GB each; the model keeps all its output columns.

    First ``check_lm_kernels`` at the step's streams. Then, from one
    init: paper compensation, ``LM_STEPS`` steps through the kernels, on
    the plain backend, and on the plain backend from the init nudged by
    one ulp (the rounding control); then error feedback (count
    compensation), ``LM_EF_STEPS`` steps the same three ways. Checks:
    one packet_reduce launch a step (and one dropfill a step with EF) on
    the kernel runs and none elsewhere; equal step, bst, delivered and
    sim_time; losses within rtol ``LM_LOSS_RTOL``; finite losses that
    fall; the first step's reduced stream through the kernel against the
    plain route on the same inputs within 2e-6 of its largest element;
    params within twice the rounding control's distance (AdamW's first
    update is about lr * sign(g), so no fixed tolerance holds them). Host
    ms a step from ``StampedBatch``; peak device memory a run. Then one
    1-step run of each form profiled. Returns (the ``lm`` line, the
    launches of the counted runs, the kernel rows, the config and the
    init)."""
    import gc

    from repro_torch.config import LTPConfig
    from repro_torch.configs import get_config
    from repro_torch.core import packets as pk
    from repro_torch.data import SyntheticLM
    from repro_torch.models import build
    from repro_torch.train.lm import lm_trainer

    cfg = cfg or get_config("smollm_360m").replace(dtype="float32")
    line = {"config": {k: getattr(cfg, k) for k in (
        "name", "n_layers", "d_model", "n_heads", "n_kv", "head_dim",
        "d_ff", "vocab", "tie_embeddings", "dtype")},
        "workers": LM_W, "batch": LM_BATCH, "seq": LM_SEQ,
        "data_vocab": LM_DATA_VOCAB, "runs": {}}
    init = build(cfg).init(torch.Generator().manual_seed(0), device=device)
    plan = pk.make_plan(init, 360)
    line.update(n_params=plan.n_floats, n_packets=plan.n_packets,
                n_critical=plan.n_critical)
    t0 = time.perf_counter()
    kernels = check_lm_kernels(torch, timer, LM_W, plan.n_packets,
                               plan.packet_floats, device)
    line["kernel_checks"] = kernels
    line["kernel_checks_s"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    corpus = SyntheticLM(vocab=LM_DATA_VOCAB, seed=0)
    control = nudged(torch, init, 1)
    launches = []

    def trainer_for(steps, backend, params, ltp_kw):
        return lm_trainer(cfg, steps=steps, workers=LM_W, seq=LM_SEQ,
                          batch=LM_BATCH, corpus=corpus, device=device,
                          ltp=LTPConfig(sync_backend=backend, **ltp_kw),
                          params=params)

    def run(label, steps, backend, params, ltp_kw):
        tr, data = trainer_for(steps, backend, params, ltp_kw)
        stamps = []
        data = [StampedBatch(b, stamps, torch) for b in data]
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        tr.run(data, epoch_steps=100)
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        got = read_counts()
        launches.append(got)
        step_s = [b - a for a, b in zip(stamps, stamps[1:])]
        hist = tr.history
        if len(step_s) != steps or len(hist) != steps or not all(
                math.isfinite(h["loss"]) and 0.0 < h["delivered"] <= 1.0
                and h["bst"] > 0.0 for h in hist):
            raise AssertionError(f"lm {label}: bad run {hist} {step_s}")
        steady = statistics.median(step_s[1:])
        line["runs"][label] = {
            "launches": got, "step_ms": [t * 1e3 for t in step_s],
            "median_step_ms": steady * 1e3,
            "tokens_per_s": LM_BATCH * LM_SEQ / steady,
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "loss": [h["loss"] for h in hist], "history": hist}
        out = (tr.params, hist)
        del tr, data
        return out

    for form, steps, ltp_kw, want in (
            ("paper", LM_STEPS, {}, launches_of(packet_reduce=LM_STEPS)),
            ("count_ef", LM_EF_STEPS,
             {"compensation": "count", "error_feedback": True},
             launches_of(packet_reduce=LM_EF_STEPS, dropfill=LM_EF_STEPS))):
        first, undo = capture_first_reduction()
        try:
            ker, ker_h = run(f"{form}_cuda", steps, "cuda", init, ltp_kw)
        finally:
            undo()
        plain, plain_h = run(f"{form}_python", steps, "python", init, ltp_kw)
        ctl, ctl_h = run(f"{form}_python_nudged", steps, "python", control,
                         ltp_kw)
        runs = line["runs"]
        if runs[f"{form}_cuda"]["launches"] != want or \
                runs[f"{form}_python"]["launches"] != launches_of() or \
                runs[f"{form}_python_nudged"]["launches"] != launches_of():
            raise AssertionError(f"lm {form}: launches "
                                 f"{[r['launches'] for r in runs.values()]}")
        keys = ("step", "bst", "delivered", "sim_time")
        for a, b in zip(ker_h, plain_h, strict=True):
            if [a[k] for k in keys] != [b[k] for k in keys] or \
                    abs(a["loss"] - b["loss"]) > LM_LOSS_RTOL * abs(b["loss"]):
                raise AssertionError(f"lm {form} kernels vs plain: {a} vs "
                                     f"{b}")
        if not first["max_abs_diff"] <= 2e-6 * first["max_abs"]:
            raise AssertionError(f"lm {form}: first reduced stream {first}")
        line[form] = {
            "first_step_reduced_stream": first,
            "loss_max_rel_diff": max(abs(a["loss"] - b["loss"]) / b["loss"]
                                     for a, b in zip(ker_h, plain_h)),
            "loss_max_rel_diff_rounding_control": max(
                abs(a["loss"] - b["loss"]) / b["loss"]
                for a, b in zip(ctl_h, plain_h)),
            **within_rounding(f"lm {form}", ker, plain, ctl)}
        del ker, plain, ctl
    loss = line["runs"]["paper_cuda"]["loss"]
    if not (abs(loss[0] - math.log(cfg.vocab)) < 1.0 and loss[-1] < loss[0]):
        raise AssertionError(f"lm: loss does not start near ln V or fall: "
                             f"{loss}")
    line["ln_vocab"] = math.log(cfg.vocab)

    # one step of each form profiled (not counted): its idle share and the
    # port kernels' device time in it
    for form, ltp_kw, select in (
            ("paper", {}, None),
            ("count_ef", {"compensation": "count", "error_feedback": True},
             "ef_gate")):
        tr, data = trainer_for(1, "cuda", init, ltp_kw)
        gc.collect()
        torch.cuda.empty_cache()
        prof = profile_step(torch, lambda: tr.run(data, epoch_steps=100),
                            select=select)
        if select is not None:
            ef_gate_launches(prof, f"lm {form} step")
        line[f"profile_{form}_step"] = prof
        del tr, data
    line["idle_share"] = line["profile_paper_step"]["idle_share"]
    del control
    gc.collect()
    torch.cuda.empty_cache()
    return line, launches, kernels, cfg, init


def run_serve_phase(torch, cfg, params, batch=4, prompt_len=16, new=24,
                    device="cuda"):
    """``train.serve.serve`` at ``cfg`` (smollm_360m's CONFIG at float32,
    the LM phase's init) with ``examples/serve.py``'s defaults: batch 4,
    a 16-token prompt decoded token by token, 24 new tokens greedily.
    Twice: the first call pays the card's warm-up; both are reported.
    Checks finite logits of the expected shape, and that decode matches
    forward: the logits ``decode_step`` gave at the 16 prompt positions
    against one ``forward`` over the prompt, within rtol 1e-4 / atol 1e-4
    (the same float32 math, one position at a time against the whole
    sequence, on other matrix-product shapes)."""
    from repro_torch.models import build
    from repro_torch.train.serve import serve

    line = {"batch": batch, "prompt_len": prompt_len, "new": new,
            "runs": []}
    for _ in range(2):
        out = serve(cfg, batch=batch, prompt_len=prompt_len, new=new,
                    device=device, params=params)
        line["runs"].append({k: out[k] for k in (
            "prefill_s", "decode_s", "tokens_per_s")})
    pl = out["prompt_logits"]
    if tuple(pl.shape) != (batch, prompt_len, cfg.vocab_padded) or \
            not bool(torch.isfinite(pl).all()) or \
            out["tokens"].shape != (batch, new):
        raise AssertionError(f"serve: bad output {pl.shape} "
                             f"{out['tokens'].shape}")
    with torch.no_grad():
        full, _, _ = build(cfg).forward(
            params, {"tokens": torch.as_tensor(out["prompts"]).to(device)})
    torch.testing.assert_close(pl, full, rtol=1e-4, atol=1e-4)
    line["decode_vs_forward_max_abs_diff"] = (pl - full).abs().max().item()
    line["decode_vs_forward_tol"] = "rtol 1e-4, atol 1e-4"
    line["logits_max_abs"] = full.abs().max().item()
    line["tokens_first_2"] = out["tokens"][:2].tolist()
    return line


# the MoE family: mixtral-8x22b trained over the LTP PS at its published
# widths in bfloat16, and mixtral and deepseek-v2 served
MOE_W, MOE_BATCH, MOE_SEQ, MOE_STEPS = 2, 8, 128, 3
MOE_LR = 3e-4                # examples/train_lm.py's


def train_and_check(torch, zero_counts, read_counts, launches_of, label,
                    cfg, line, tc, workers, loss_step1, *, span=None,
                    device="cuda"):
    """``cfg`` at its published widths in its own dtype, weights from a
    generator on the card seeded with 0 (their init times here), trained
    ``tc.steps`` steps through the kernels on ``train.lm.lm_trainer``,
    the setup of ``examples/train_lm.py`` (``LTPConfig(sync_backend=
    "cuda")``, ``NetConfig(10, 1, 0.001, 4096)``, the runtime engine over
    the analytic transport) with ``workers`` workers and the ``tc``
    batch, optimizer and lr, data from ``SyntheticLM(vocab=8192)``.

    Checks: one packet_reduce launch a step and no other; finite losses;
    step 1 within 1.0 of ``loss_step1``; the first step's reduced stream
    through the kernel against the plain route on the same stream
    (``capture_first_reduction``) within 1e-6 of its largest element.
    Fills ``line`` with host ms a step (``StampedBatch``), tokens/s and
    peak device memory, then one more step profiled (with ``span``, the
    host and device time inside that span, under ``span_profile``). An
    enc-dec config's batches carry ``train.lm.audio_frames``, the profiled
    step's too. Returns
    (``line``, the launches of the counted run, the plan's (W,
    n_packets, payload))."""
    from repro_torch.config import LTPConfig
    from repro_torch.core import packets as pk
    from repro_torch.data import SyntheticLM
    from repro_torch.models import build
    from repro_torch.runtime import step as stp
    from repro_torch.train.lm import audio_frames, lm_trainer
    from repro_torch.tree import tree_leaves

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    init = build(cfg).init(torch.Generator(device=device).manual_seed(0),
                           device=device)
    torch.cuda.synchronize()
    line["init_s"] = time.perf_counter() - t0
    plan = pk.make_plan(init, 360)
    line.update(n_params=plan.n_floats, n_packets=plan.n_packets,
                n_critical=plan.n_critical,
                worker_chunk=stp.worker_chunk(plan, workers),
                leaf_dtypes=sorted({str(x.dtype) for x in
                                    tree_leaves(init)}))
    tr, data = lm_trainer(cfg, workers=workers, train=tc,
                          corpus=SyntheticLM(vocab=LM_DATA_VOCAB, seed=0),
                          ltp=LTPConfig(sync_backend="cuda"), device=device,
                          params=init)
    del init    # the trainer holds the params
    stamps = []
    data = [StampedBatch(b, stamps, torch) for b in data]
    first, undo = capture_first_reduction()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    try:
        tr.run(data, epoch_steps=100)
        torch.cuda.synchronize()
    finally:
        undo()
    stamps.append(time.perf_counter())
    launches = read_counts()
    hist = tr.history
    step_s = [b - a for a, b in zip(stamps, stamps[1:])]
    if launches != launches_of(packet_reduce=tc.steps):
        raise AssertionError(f"{label}: launches {launches}")
    if len(hist) != tc.steps or len(step_s) != tc.steps or not all(
            math.isfinite(h["loss"]) and 0.0 < h["delivered"] <= 1.0
            and h["bst"] > 0.0 for h in hist):
        raise AssertionError(f"{label}: bad run {hist} {step_s}")
    if not abs(hist[0]["loss"] - loss_step1) < 1.0:
        raise AssertionError(f"{label}: step 1 loss {hist[0]['loss']}, "
                             f"expected {loss_step1} +- 1.0")
    if not first["max_abs_diff"] <= 1e-6 * first["max_abs"]:
        raise AssertionError(f"{label}: first reduced stream {first}")
    steady = statistics.median(step_s[1:])
    line.update(
        launches=launches, loss=[h["loss"] for h in hist],
        loss_step1_expected=loss_step1, ln_vocab=math.log(cfg.vocab),
        first_step_reduced_stream=first,
        step_ms=[t * 1e3 for t in step_s], median_step_ms=steady * 1e3,
        tokens_per_s=tc.batch * tc.seq / steady,
        peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
        card_memory_gb=torch.cuda.get_device_properties(0).total_memory
        / 1e9, history=hist)
    # one more step, profiled (not counted), after the cached blocks of
    # the counted run are released
    batch = SyntheticLM(vocab=LM_DATA_VOCAB, seed=0).train_batch(
        tc.batch, tc.seq, tc.steps)
    if cfg.family == "audio":
        batch["frames"] = audio_frames(cfg, tc.batch, 0, tc.steps)
    del data
    gc.collect()
    torch.cuda.empty_cache()
    prof = profile_step(torch, lambda: tr.run([batch], epoch_steps=100),
                        span_names=(span,) if span else ())
    line["profile_step"] = prof
    line["idle_share"] = prof["idle_share"]
    if span:
        sp = prof["spans"][span]
        if not sp["count"] or not sp["n_kernels"]:
            raise AssertionError(f"{label}: no {span!r} work in the "
                                 f"profiled step: {sp}")
        line["span_profile"] = {**sp, "share_of_device_busy": sp["device_ms"]
                             / prof["device_busy_ms"]}
    shape = (workers, plan.n_packets, plan.packet_floats)
    del tr, batch
    gc.collect()
    torch.cuda.empty_cache()
    return line, launches, shape


def run_moe_phase(torch, zero_counts, read_counts, launches_of, *,
                  device="cuda"):
    """The MoE path, trained: ``mixtral_8x22b``'s CONFIG at its published
    widths in bfloat16, the config's own dtype (d_model 6144, 48 query
    and 8 KV heads of 128, 8 experts of d_ff 16384, top-2, a 4096
    window, vocab 32,768 untied), cut to 1 layer of 56: 2,906,720,256
    parameters, 8,074,223 packets. ``train_and_check`` with batch 8 x
    seq 128 (``SyntheticLM(vocab=8192)``: the dense tables at 32,768
    would take 8.6 GB each) and two cuts forced by memory: W = 2
    workers, not 8 (the float32 stream is 11.6 GB a worker), and
    SGD-momentum (0.9, lr 3e-4), not AdamW, whose float32 moments would
    take 23.3 GB; ``MOE_STEPS`` steps. Step 1 is expected at ln V + s^2
    / 2 + 0.01, the loss of random logits of variance s^2 = 0.02^2
    d_model (the final norm's unit RMS under the head's normal x 0.02
    init) plus the aux term at balanced routing. Returns (the ``moe``
    line, the launches of the counted run, the plan's (W, n_packets,
    payload))."""
    from repro_torch.config import TrainConfig
    from repro_torch.configs import get_config

    cfg = get_config("mixtral_8x22b").replace(n_layers=1)
    line = {"config": {k: getattr(cfg, k) for k in (
        "name", "n_layers", "d_model", "n_heads", "n_kv", "head_dim",
        "d_ff", "n_experts", "top_k", "window", "vocab", "dtype")},
        "workers": MOE_W, "batch": MOE_BATCH, "seq": MOE_SEQ,
        "optimizer": "sgdm", "lr": MOE_LR, "data_vocab": LM_DATA_VOCAB}
    tc = TrainConfig(batch=MOE_BATCH, seq=MOE_SEQ, lr=MOE_LR,
                     optimizer="sgdm", steps=MOE_STEPS)
    expect = math.log(cfg.vocab) + 0.5 * 0.02 ** 2 * cfg.d_model + 0.01
    return train_and_check(torch, zero_counts, read_counts, launches_of,
                           "moe", cfg, line, tc, MOE_W, expect,
                           device=device)


def moe_drop_counter():
    """Wrap ``moe.apply_moe`` so that each call also counts the
    assignments its routing drops at capacity (the router's ids, the
    group's counts past ``capacity``). Returns the list of counts it
    fills and the function that takes the wrapper off."""
    from repro_torch.models import moe

    orig = moe.apply_moe
    dropped = []

    def wrapped(cfg, p, x, *, capacity_factor=1.25, ctx=None):
        xf = x.reshape(-1, x.shape[-1])
        _, ids, _ = moe.router(cfg, p, xf)
        cap = moe.capacity(cfg, xf.shape[0], capacity_factor)
        counts = ids.reshape(-1).bincount(minlength=cfg.n_experts)
        dropped.append(int((counts - cap).clamp(min=0).sum()))
        return orig(cfg, p, x, capacity_factor=capacity_factor, ctx=ctx)

    moe.apply_moe = wrapped
    return dropped, lambda: setattr(moe, "apply_moe", orig)


def run_moe_serve_phase(torch, batch=4, prompt_len=16, new=24, n_check=8,
                        device="cuda"):
    """The MoE path, served: ``train.serve.serve`` at float32 with
    ``examples/serve.py``'s defaults (batch 4, a 16-token prompt decoded
    token by token, 24 new tokens greedily), twice each (the first pays
    the card's warm-up), for ``mixtral_8x22b``'s CONFIG at 2 layers
    (5,410,781,184 parameters, 21.6 GB) and ``deepseek_v2_236b``'s at 2
    (5,358,679,040: its dense lead layer, then its first MoE layer of 160
    routed experts of 1536 and 2 shared, top-6; MLA in both), one at a
    time, weights from a generator on the card seeded with 0.

    Checks finite logits of the expected shape, and decode against the
    full-sequence forward: each prompt's first ``n_check`` tokens through
    one ``forward`` of that sequence alone, against the logits its decode
    steps gave. Capacity drops would make the two differ by design; a
    sequence of 8 tokens fills at most 8 slots of an expert, whose
    capacity is at least 8, and a decode step routes 4 tokens, so
    neither drops an assignment (the forwards' drops are counted and
    printed). Both archs are held within 1e-5 of the largest logit:
    deepseek-v2's absorbed MLA decode reorders its float32 products
    against the decompressed forward, and reads about 2e-6 of the
    largest logit on an H100, as mixtral does."""
    from repro_torch.configs import get_config
    from repro_torch.models import build
    from repro_torch.train.serve import serve
    from repro_torch.tree import tree_leaves

    line = {"batch": batch, "prompt_len": prompt_len, "new": new,
            "archs": {}}
    for arch in ("mixtral_8x22b", "deepseek_v2_236b"):
        cfg = get_config(arch).replace(n_layers=2, dtype="float32")
        t0 = time.perf_counter()
        params = build(cfg).init(
            torch.Generator(device=device).manual_seed(0), device=device)
        torch.cuda.synchronize()
        row = {"n_layers": cfg.n_layers, "init_s": time.perf_counter() - t0,
               "n_params": sum(x.numel() for x in tree_leaves(params)),
               "runs": []}
        for _ in range(2):
            out = serve(cfg, batch=batch, prompt_len=prompt_len, new=new,
                        device=device, params=params)
            row["runs"].append({k: out[k] for k in (
                "prefill_s", "decode_s", "tokens_per_s")})
        pl = out["prompt_logits"]
        if tuple(pl.shape) != (batch, prompt_len, cfg.vocab_padded) or \
                not bool(torch.isfinite(pl).all()) or \
                out["tokens"].shape != (batch, new):
            raise AssertionError(f"moe_serve {arch}: bad output {pl.shape} "
                                 f"{out['tokens'].shape}")
        toks = torch.as_tensor(out["prompts"]).to(device)
        dropped, undo = moe_drop_counter()
        try:
            with torch.no_grad():
                full = torch.cat([build(cfg).forward(
                    params, {"tokens": toks[i:i + 1, :n_check]})[0]
                    for i in range(batch)])
        finally:
            undo()
        dec = pl[:, :n_check]
        diff = (dec - full).abs().max().item()
        top = full.abs().max().item()
        tol = "1e-5 of the largest logit"
        if not diff <= 1e-5 * top or sum(dropped):
            raise AssertionError(f"moe_serve {arch}: decode vs forward "
                                 f"{diff} of {top} ({tol}), dropped "
                                 f"{dropped}")
        row.update(decode_vs_forward_max_abs_diff=diff, logits_max_abs=top,
                   decode_vs_forward_tol=tol,
                   checked=f"{batch} x {n_check} tokens",
                   forward_dropped_assignments=sum(dropped),
                   tokens_first_2=out["tokens"][:2].tolist())
        line["archs"][arch] = row
        del params, out, pl, full, dec
        gc.collect()
        torch.cuda.empty_cache()
    return line


# the SSM family: falcon-mamba-7b (Mamba-1) and the zamba2-7b hybrid
# (Mamba-2 with a shared attention block) trained over the LTP PS at
# their published widths in bfloat16, then served
SSM_STEPS = 3
SSM_PATHS = {
    # line: (arch, layers, the span around its scan, the cut)
    "ssm": ("falcon_mamba_7b", 2, "mamba1_scan", "2 of 64 layers"),
    "hybrid": ("zamba2_7b", 7, "ssd_chunk",
               "7 of 81 layers: one period of 6 Mamba-2 layers and the "
               "shared attention + MLP block, then 1 trailing layer"),
}


def run_ssm_phase(torch, zero_counts, read_counts, launches_of, line_name,
                  *, device="cuda"):
    """An SSM path, trained: ``SSM_PATHS[line_name]``'s CONFIG at its
    published widths in bfloat16, its own dtype, cut in depth alone
    (falcon-mamba-7b: d_model 4096, d_inner 8192, state 16, conv 4,
    vocab 65,024 untied, 2 of 64 layers; zamba2-7b: d_model 3584,
    d_inner 7168 in 112 Mamba-2 heads of 64, state 64, the shared block's
    32 heads of 112 and d_ff 14336, vocab 32,000, 7 of 81 layers).
    ``train_and_check`` on the LM phase's setup, that of
    ``examples/train_lm.py``: W = 8, batch 32 x seq 128, AdamW lr 3e-4,
    paper compensation, data from ``SyntheticLM(vocab=8192)`` (the dense
    tables at 65,024 would take 33.8 GB each); remat on, as ``loss_fn``
    defaults; ``SSM_STEPS`` steps. Step 1 is expected at ln V + s^2 / 2
    (no aux term). The profiled step reports the host and device time
    inside the scan's span (the forward and the backward's recompute of
    the time loop or the SSD chunks; the backward of the loop's ops runs
    outside it). Returns (the line, the launches of the counted run, the
    plan's (W, n_packets, payload))."""
    from repro_torch.config import TrainConfig
    from repro_torch.configs import get_config

    arch, n_layers, span, cut = SSM_PATHS[line_name]
    cfg = get_config(arch).replace(n_layers=n_layers)
    line = {"config": {k: getattr(cfg, k) for k in (
        "name", "family", "n_layers", "d_model", "d_inner", "ssm_state",
        "ssm_conv", "ssm_heads", "n_heads", "n_kv", "head_dim", "d_ff",
        "shared_attn_every", "vocab", "tie_embeddings", "dtype")},
        "reduced": [f"depth: {cut}",
                    f"data: SyntheticLM(vocab={LM_DATA_VOCAB})"],
        "workers": LM_W, "batch": LM_BATCH, "seq": LM_SEQ,
        "optimizer": "adamw", "lr": 3e-4, "remat": True, "span": span}
    tc = TrainConfig(batch=LM_BATCH, seq=LM_SEQ, lr=3e-4,
                     optimizer="adamw", steps=SSM_STEPS)
    expect = math.log(cfg.vocab) + 0.5 * 0.02 ** 2 * cfg.d_model
    return train_and_check(torch, zero_counts, read_counts, launches_of,
                           line_name, cfg, line, tc, LM_W, expect,
                           span=span, device=device)


def run_ssm_serve_phase(torch, batch=4, prompt_len=16, new=24,
                        device="cuda"):
    """The SSM family, served: ``train.serve.serve`` at float32 with
    ``examples/serve.py``'s defaults (batch 4, a 16-token prompt decoded
    token by token, 24 new tokens greedily), twice each (the first pays
    the card's warm-up), for ``falcon_mamba_7b``'s CONFIG at 2 layers and
    ``zamba2_7b``'s at 13 (two periods of 6 Mamba-2 layers, so the shared
    block decodes against two KV slots, then 1 trailing layer), one at a
    time, weights from a generator on the card seeded with 0.

    Checks finite logits of the expected shape, and the logits the
    prompt's decode steps gave against one ``forward`` over the prompt
    (the scan over the whole sequence; a Mamba-2 prompt of 16 is one SSD
    chunk), within 1e-5 of the largest logit."""
    from repro_torch.configs import get_config
    from repro_torch.models import build
    from repro_torch.train.serve import serve
    from repro_torch.tree import tree_leaves

    line = {"batch": batch, "prompt_len": prompt_len, "new": new,
            "archs": {}}
    for arch, n_layers in (("falcon_mamba_7b", 2), ("zamba2_7b", 13)):
        cfg = get_config(arch).replace(n_layers=n_layers, dtype="float32")
        t0 = time.perf_counter()
        params = build(cfg).init(
            torch.Generator(device=device).manual_seed(0), device=device)
        torch.cuda.synchronize()
        row = {"n_layers": cfg.n_layers, "init_s": time.perf_counter() - t0,
               "n_params": sum(x.numel() for x in tree_leaves(params)),
               "runs": []}
        for _ in range(2):
            out = serve(cfg, batch=batch, prompt_len=prompt_len, new=new,
                        device=device, params=params)
            row["runs"].append({k: out[k] for k in (
                "prefill_s", "decode_s", "tokens_per_s")})
        pl = out["prompt_logits"]
        if tuple(pl.shape) != (batch, prompt_len, cfg.vocab_padded) or \
                not bool(torch.isfinite(pl).all()) or \
                out["tokens"].shape != (batch, new):
            raise AssertionError(f"ssm_serve {arch}: bad output {pl.shape} "
                                 f"{out['tokens'].shape}")
        with torch.no_grad():
            full, _, _ = build(cfg).forward(
                params, {"tokens": torch.as_tensor(out["prompts"]).to(
                    device)})
        diff = (pl - full).abs().max().item()
        top = full.abs().max().item()
        tol = "1e-5 of the largest logit"
        if not diff <= 1e-5 * top:
            raise AssertionError(f"ssm_serve {arch}: decode vs forward "
                                 f"{diff} of {top} ({tol})")
        row.update(decode_vs_forward_max_abs_diff=diff, logits_max_abs=top,
                   decode_vs_forward_tol=tol,
                   checked=f"{batch} x {prompt_len} tokens",
                   tokens_first_2=out["tokens"][:2].tolist())
        line["archs"][arch] = row
        del params, out, pl, full
        gc.collect()
        torch.cuda.empty_cache()
    return line


# the enc-dec family: whisper-small at its full published config trained
# over the LTP PS, then served from its encoder's cross-attention cache
ENCDEC_STEPS = 3


def run_encdec_phase(torch, zero_counts, read_counts, launches_of, *,
                     device="cuda"):
    """The enc-dec path, trained: ``whisper_small``'s CONFIG at full depth
    and width in bfloat16, its own dtype (12 encoder and 12 decoder layers
    of d_model 768, 12 heads of 64, d_ff 3072, vocab 51,865 padded to
    51,968 untied, 1,500 frames): 278,098,944 parameters.
    ``train_and_check`` on the LM phase's setup, that of
    ``examples/train_lm.py``: W = 8, batch 32 x seq 128 (under whisper's
    448-token decoder window), AdamW lr 3e-4, paper compensation, data
    from ``SyntheticLM(vocab=8192)`` (the dense tables at 51,865 would
    take 21.5 GB each) and frames from ``train.lm.audio_frames`` (the
    mel + conv frontend is a stub, as in the reference); remat on, as
    ``loss_fn`` defaults; ``ENCDEC_STEPS`` steps. Step 1 is expected at
    ln V + s^2 / 2 (no aux term): the untied head after a unit-variance
    LayerNorm. The profiled step reports the host and device time inside
    the ``encoder`` span (the encoder's forward and, under remat, each
    encoder layer's backward). Returns (the line, the launches of the
    counted run, the plan's (W, n_packets, payload))."""
    from repro_torch.config import TrainConfig
    from repro_torch.configs import get_config
    from repro_torch.models.encdec import ENCODER_SPAN

    cfg = get_config("whisper_small")
    line = {"config": {k: getattr(cfg, k) for k in (
        "name", "family", "encoder_layers", "n_layers", "d_model",
        "n_heads", "n_kv", "head_dim", "d_ff", "vocab", "encoder_frames",
        "norm_type", "mlp_type", "tie_embeddings", "dtype")},
        "reduced": [f"data: SyntheticLM(vocab={LM_DATA_VOCAB})",
                    "frames: synthetic, 0.02 x N(0, 1) (the mel + conv "
                    "frontend is a stub, as in the reference)"],
        "workers": LM_W, "batch": LM_BATCH, "seq": LM_SEQ,
        "optimizer": "adamw", "lr": 3e-4, "remat": True,
        "span": ENCODER_SPAN}
    tc = TrainConfig(batch=LM_BATCH, seq=LM_SEQ, lr=3e-4,
                     optimizer="adamw", steps=ENCDEC_STEPS)
    expect = math.log(cfg.vocab) + 0.5 * 0.02 ** 2 * cfg.d_model
    line, launches, shape = train_and_check(
        torch, zero_counts, read_counts, launches_of, "encdec", cfg, line,
        tc, LM_W, expect, span=ENCODER_SPAN, device=device)
    if line["n_params"] != 278_098_944:
        raise AssertionError(f"encdec: {line['n_params']} parameters")
    return line, launches, shape


def run_encdec_serve_phase(torch, batch=4, prompt_len=16, new=24,
                           device="cuda"):
    """The enc-dec path, served from its encoder: ``whisper_small``'s
    CONFIG at float32, full depth, weights from a generator on the card
    seeded with 0; frames (4, 1500, 768) at 0.02 x N(0, 1) and a 16-token
    prompt from one seeded with 1. Twice (the first run pays the card's
    warm-up): ``encode`` alone, timed; ``prefill`` over the frames and the
    prompt, which runs the encoder and gives each decoder layer's cross
    K/V, (12, 4, 1500, 12, 64) each; those cross K/V placed in an
    ``init_cache(4, 40, float32)`` (the reference's prefill cache is only
    as long as the prompt and holds no self K/V); the prompt decoded token
    by token, then 24 new tokens greedily. The composition is this
    phase's, out of the API's own calls.

    Checks: finite logits of shape (4, 51,968); the prompt's decode
    logits against one ``decode_train(prompt, encode(frames))``, and
    ``prefill``'s logits against the last prompt position's decode
    logits, each within 1e-5 of the largest logit."""
    from repro_torch.configs import get_config
    from repro_torch.models import build, encdec
    from repro_torch.tree import tree_leaves

    cfg = get_config("whisper_small").replace(dtype="float32")
    api = build(cfg)
    t0 = time.perf_counter()
    params = api.init(torch.Generator(device=device).manual_seed(0),
                      device=device)
    torch.cuda.synchronize()
    line = {"n_layers": [cfg.encoder_layers, cfg.n_layers],
            "init_s": time.perf_counter() - t0, "batch": batch,
            "prompt_len": prompt_len, "new": new, "runs": []}
    gen = torch.Generator(device=device).manual_seed(1)
    frames = torch.randn((batch, cfg.encoder_frames, cfg.d_model),
                         generator=gen, device=device) * 0.02
    prompt = torch.randint(0, cfg.vocab, (batch, prompt_len),
                           generator=gen, device=device)
    max_seq = prompt_len + new
    with torch.no_grad():
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            enc_out = encdec.encode(cfg, params, frames)
            torch.cuda.synchronize()
            encoder_s = time.perf_counter() - t0
            first, pc = api.prefill(params, {"frames": frames,
                                             "tokens": prompt})
            torch.cuda.synchronize()
            prefill_s = time.perf_counter() - t0 - encoder_s
            cache = api.init_cache(batch, max_seq, torch.float32,
                                   device=device)
            cache["cross_k"], cache["cross_v"] = pc["cross_k"], pc["cross_v"]
            t0 = time.perf_counter()
            prompt_logits = []
            for t in range(prompt_len):
                logits, cache = api.decode_step(params, cache, prompt[:, t],
                                                t)
                prompt_logits.append(logits)
            torch.cuda.synchronize()
            prompt_s = time.perf_counter() - t0
            tok = torch.argmax(logits[:, : cfg.vocab], dim=-1)
            out = [tok]
            t0 = time.perf_counter()
            for i in range(new - 1):
                logits, cache = api.decode_step(params, cache, tok,
                                                prompt_len + i)
                tok = torch.argmax(logits[:, : cfg.vocab], dim=-1)
                out.append(tok)
            torch.cuda.synchronize()
            decode_s = time.perf_counter() - t0
            line["runs"].append({
                "encoder_s": encoder_s, "prefill_s": prefill_s,
                "prompt_decode_s": prompt_s, "decode_s": decode_s,
                "tokens_per_s": batch * (new - 1) / decode_s})
        pl = torch.stack(prompt_logits, dim=1)
        full = encdec.decode_train(cfg, params, prompt, enc_out)
    kv_shape = (cfg.n_layers, batch, cfg.encoder_frames, cfg.n_kv, cfg.hd)
    if tuple(pc["cross_k"].shape) != kv_shape or \
            tuple(pc["cross_v"].shape) != kv_shape:
        raise AssertionError(f"encdec_serve: cross K/V {pc['cross_k'].shape}")
    if tuple(pl.shape) != (batch, prompt_len, cfg.vocab_padded) or \
            tuple(first.shape) != (batch, cfg.vocab_padded) or \
            not bool(torch.isfinite(pl).all()) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"encdec_serve: bad output {pl.shape} "
                             f"{first.shape}")
    top = full.abs().max().item()
    diff = (pl - full).abs().max().item()
    diff_prefill = (first - pl[:, -1]).abs().max().item()
    tol = "1e-5 of the largest logit"
    if not diff <= 1e-5 * top:
        raise AssertionError(f"encdec_serve: decode vs decode_train {diff} "
                             f"of {top} ({tol})")
    if not diff_prefill <= 1e-5 * top:
        raise AssertionError(f"encdec_serve: prefill vs decode "
                             f"{diff_prefill} of {top} ({tol})")
    line.update(
        n_params=sum(x.numel() for x in tree_leaves(params)),
        cross_kv_shape=list(kv_shape),
        decode_vs_decode_train_max_abs_diff=diff,
        prefill_vs_decode_max_abs_diff=diff_prefill, logits_max_abs=top,
        tol=tol, checked=f"{batch} x {prompt_len} tokens",
        tokens_first_2=torch.stack(out, 1)[:2].tolist())
    del params, pc, cache, enc_out, full, pl
    gc.collect()
    torch.cuda.empty_cache()
    return line


SHARDED_STEPS = 5
SHARDED_LR = 3e-4              # launch/train.py's AdamW, the LM phase's
SHARDED_GLOO_STEPS = 3
SHARDED_GLOO_BATCH, SHARDED_GLOO_SEQ = 8, 32
SHARDED_GLOO_FRAC = (0.7, 0.9)
SHARDED_CHILD_TIMEOUT_S = 300


def sharded_gate_rows(torch, timer, shapes) -> dict:
    """The plain gate (``ops.ltp_dropfill``, the TPU kernel's function) at
    the sharded step's leaves, on random packets and a mask that keeps
    70 %: the largest leaf's (n, 360) alone, held against the plain
    version exactly and timed like the LM-stream rows (5 calls a run);
    then every leaf of a step back to back, one launch a leaf, timed as
    one call beside the plain version and ``torch.mul`` over the same
    leaves. Bound: each leaf's packets and mask read once and its gated
    packets written once, over the memory rate."""
    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device="cuda").manual_seed(2)
    leaves = [(torch.randn(s, device="cuda", generator=gen),
               (torch.rand(s[0], device="cuda", generator=gen) < 0.7).float())
              for s in shapes]

    def plain(a, b):
        return ref.dropfill_ref(a, b, torch.ones_like(b))

    def library(a, b):
        return torch.mul(a, b[:, None])

    x, m = max(leaves, key=lambda xm: xm[0].shape[0])
    n, p = x.shape
    err = (ops.ltp_dropfill(x, m) - plain(x, m)).abs().max().item()
    rows = {"leaf": lm_kernel_row(
        timer, (n, p), err, 0.0, [(x, m)], ops.ltp_dropfill, plain,
        library, *cost().dropfill_cost(n, p))}
    rows["leaf"]["library_call"] = "torch.mul(packets, mask[:, None])"
    err = max((ops.ltp_dropfill(a, b) - plain(a, b)).abs().max().item()
              for a, b in leaves)
    if err != 0.0:
        raise AssertionError(f"sharded gate over the step's leaves: max "
                             f"abs err {err}")
    per_leaf = [cost().dropfill_cost(*a.shape) for a, _ in leaves]
    n_bytes = sum(b for b, _ in per_leaf)
    bound_ms, bound_by = bound(n_bytes, sum(o for _, o in per_leaf))

    def over_leaves(fn):
        return lambda: [fn(a, b) for a, b in leaves]

    rows["step"] = {
        "shapes": [list(s) for s in shapes], "launches": len(shapes),
        "max_abs_err": err, "ms": timer.ms(over_leaves(ops.ltp_dropfill),
                                           [()], 5),
        "plain_ms": timer.ms(over_leaves(plain), [()], 5),
        "library_ms": timer.ms(over_leaves(library), [()], 5),
        "library_call": "torch.mul(packets, mask[:, None]) a leaf",
        "bound_ms": bound_ms, "bound_by": bound_by, "bytes": n_bytes}
    del leaves, x, m
    return rows


def sharded_gloo_child(argv) -> int:
    """One of two gloo ranks of the sharded step on a small model, in a
    process of its own: ``chip_smoke.py --sharded-gloo-rank RANK INIT
    DEVICE NUDGE OUT``. REDUCED smollm-360m at float32, SGD-momentum at lr
    0.1, the psum variant with paper compensation and the ``auto``
    backend (the plain gate's kernel for CUDA tensors), fractions (0.7,
    0.9), ``SHARDED_GLOO_STEPS`` steps of a (8, 32) global batch, each
    rank on its half; the draws are the CPU generator's (``uniforms=``),
    so the CUDA and CPU runs mask alike. NUDGE 1 starts from the init
    moved by one ulp (the rounding control). Writes the params, losses,
    delivered fractions and the gate's launches to OUT (npz)."""
    import datetime

    import numpy as np
    import torch
    import torch.distributed as dist

    rank, init, device, nudge, out = (int(argv[0]), argv[1], argv[2],
                                      int(argv[3]), argv[4])
    sys.path.insert(0, os.path.join(HERE, "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank,
                            world_size=2,
                            timeout=datetime.timedelta(seconds=240))
    try:
        from repro_torch.config import LTPConfig
        from repro_torch.configs import get_reduced
        from repro_torch.core import ltp_sync as ls
        from repro_torch.data import SyntheticLM
        from repro_torch.kernels import dropfill as df_mod
        from repro_torch.launch.mesh import make_host_mesh
        from repro_torch.models import build
        from repro_torch.optim import sgd_momentum
        from repro_torch.tree import tree_leaves
        from repro_torch.train.trainer import init_state, make_ltp_train_step

        cfg = get_reduced("smollm_360m").replace(dtype="float32")
        api, opt = build(cfg), sgd_momentum()
        params = api.init(torch.Generator().manual_seed(0), device=device)
        if nudge:
            params = nudged(torch, params, 7)
        mesh = make_host_mesh(2, 1)
        w = mesh.get_local_rank("data")
        step = make_ltp_train_step(api, opt, mesh, LTPConfig(), ("data",),
                                   {"tokens": ("data",),
                                    "labels": ("data",)})
        state = init_state(api, opt, params=params)
        corpus = SyntheticLM(vocab=cfg.vocab, seed=0)
        frac = torch.tensor(SHARDED_GLOO_FRAC)
        df_mod.LAUNCHES = 0
        losses, delivered = [], []
        for s in range(SHARDED_GLOO_STEPS):
            u = [ls.device_uniforms(max(1, -(-x.numel() // 360)), "cpu",
                                    1 + s, w, 0, i)
                 for i, x in enumerate(tree_leaves(state.params))]
            state, m = step(state, corpus.train_batch(
                SHARDED_GLOO_BATCH, SHARDED_GLOO_SEQ, s), frac, 1 + s, 0.1,
                uniforms=u)
            losses.append(float(m["loss"]))
            delivered.append(float(m["delivered_frac"]))
        rec = {f"params/{i}": x.cpu().numpy()
               for i, x in enumerate(tree_leaves(state.params))}
        np.savez(out, loss=np.asarray(losses), delivered=np.asarray(delivered),
                 launches=np.asarray(df_mod.LAUNCHES), **rec)
    finally:
        dist.destroy_process_group()
    return 0


def run_sharded_gloo(torch) -> dict:
    """Two gloo ranks of the sharded step on the one card (CUDA tensors)
    against the same two ranks on the CPU, and the CPU pair from a
    one-ulp-nudged init, the three pairs at once, each rank a process
    (``sharded_gloo_child``). Checks: the gate's kernel launched once a
    leaf a step on each CUDA rank and never on the CPU; the two ranks of
    a pair hold equal params; the CUDA pair's params within twice the
    rounding control's distance of the CPU pair's; losses within rtol
    1e-4 and delivered fractions equal."""
    import tempfile

    import numpy as np

    line = {"config": "smollm_360m REDUCED, float32", "world_size": 2,
            "backend": "gloo", "steps": SHARDED_GLOO_STEPS,
            "global_batch": [SHARDED_GLOO_BATCH, SHARDED_GLOO_SEQ],
            "frac": list(SHARDED_GLOO_FRAC), "variant": "psum, paper",
            "optimizer": "sgd_momentum lr 0.1"}
    runs = {"cuda": ("cuda", 0), "cpu": ("cpu", 0), "cpu_nudged": ("cpu", 1)}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        procs = {}
        for name, (device, nudge) in runs.items():
            procs[name] = [subprocess.Popen(
                [sys.executable, os.path.abspath(__file__),
                 "--sharded-gloo-rank", str(r), f"{tmp}/{name}.init", device,
                 str(nudge), f"{tmp}/{name}{r}.npz"],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                for r in range(2)]
        errs = {}
        try:
            for name, ps in procs.items():
                for r, p in enumerate(ps):
                    _, errs[name, r] = p.communicate(
                        timeout=SHARDED_CHILD_TIMEOUT_S)
        finally:
            for ps in procs.values():
                for p in ps:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
        for name, ps in procs.items():
            for r, p in enumerate(ps):
                if p.returncode != 0:
                    raise AssertionError(f"sharded gloo {name} rank {r}: "
                                         f"{errs[name, r][-3000:]}")
        line["seconds"] = time.perf_counter() - t0
        got = {name: [dict(np.load(f"{tmp}/{name}{r}.npz")) for r in range(2)]
               for name in runs}
    n = sum(1 for k in got["cuda"][0] if k.startswith("params/"))
    for name, (a, b) in got.items():
        for i in range(n):
            if not np.array_equal(a[f"params/{i}"], b[f"params/{i}"]):
                raise AssertionError(f"sharded gloo {name}: the ranks' "
                                     f"params differ at leaf {i}")
    want = n * SHARDED_GLOO_STEPS
    launches = {name: [int(r["launches"]) for r in rs]
                for name, rs in got.items()}
    if launches != {"cuda": [want, want], "cpu": [0, 0],
                    "cpu_nudged": [0, 0]}:
        raise AssertionError(f"sharded gloo: gate launches {launches}, "
                             f"expected {want} on each CUDA rank")
    cuda, cpu, ctl = (got[k][0] for k in ("cuda", "cpu", "cpu_nudged"))

    def tensors(d):
        return [torch.as_tensor(d[f"params/{i}"]) for i in range(n)]

    held = within_rounding("sharded gloo cuda vs cpu", tensors(cuda),
                           tensors(cpu), tensors(ctl))
    if not (np.allclose(cuda["loss"], cpu["loss"], rtol=1e-4)
            and np.array_equal(cuda["delivered"], cpu["delivered"])):
        raise AssertionError(f"sharded gloo: cuda {cuda['loss']} "
                             f"{cuda['delivered']}, cpu {cpu['loss']} "
                             f"{cpu['delivered']}")
    line.update(launches_per_rank=launches, loss_cuda=cuda["loss"].tolist(),
                loss_cpu=cpu["loss"].tolist(),
                delivered=cuda["delivered"].tolist(), **held)
    return line


def run_sharded_phase(torch, timer, zero_counts, read_counts, launches_of,
                      cfg, init) -> tuple:
    """The sharded LTP path (``launch/train.py --mode sharded``'s): the
    LM phase's smollm-360m CONFIG at float32 and its init (361,821,120
    parameters, 32 layers), one rank over ``nccl`` at world size 1
    (``launch.train.init_distributed`` without ``torchrun``: a ``file://``
    rendezvous in a temporary directory), a (data 1, model 1)
    ``DeviceMesh`` (``launch.mesh.make_host_mesh``), the
    ``train.trainer.make_ltp_train_step`` step (first the launcher,
    ``launch/train.py --mode sharded``, for 2 steps from its own init,
    its step-0 loss near ln V), AdamW at lr 3e-4 (the
    ZeRO variant's own SGD-momentum at the same lr), batch 32 x seq 128
    from ``SyntheticLM(8192)``, the launcher's delivered fraction at loss
    rate 0.001 (0.99), the draws from seed 1 + step on the card.

    Runs of ``SHARDED_STEPS`` steps: the psum variant with paper and with
    count compensation and the ZeRO variant (paper), each through the
    kernels (``sync_backend="cuda"``), on the plain route (``"python"``)
    and on the plain route from the init nudged by one ulp (the rounding
    control). Checks: the plain gate's kernel launched once a leaf a step
    under paper and under count (whose division is no gate, as in the
    reference), never by the ZeRO variant (its mask is the reference's
    plain multiply) nor by the plain runs, and no other kernel; equal
    delivered fractions and losses within rtol 1e-4 between kernels and
    plain; finite losses starting near ln V; params within twice the
    rounding control's distance (``within_rounding``). Host ms a step
    (median of steps 2-5), tokens/s and peak memory a run. Then
    ``LTPSync`` (``core.ltp_sync.make_ltp_sync`` over the params' specs,
    ``models.sharding.param_specs``) on the gradient of the first batch,
    under paper and count, with and without error feedback (a seeded
    residual of scale 1e-3): through the kernels, one dropfill launch a
    call and a second under count (the count compensation through the
    gate, as the reference's ``LTPSync`` does it), the EF form in place
    of the gate's first launch; on the plain route none; synced blocks
    and residuals within rtol 1e-6 / atol 0 and equal delivered
    fractions. Then one profiled psum step (paper; its idle share and
    the gate's device time, summed and a launch). Then
    ``sharded_gate_rows`` and
    ``run_sharded_gloo``. Returns (the ``sharded`` line, the launches of
    the counted runs, the gate rows, and the psum paper kernel run at
    step ``TP_DP_MODEL["steps"]`` for the ``tp`` phase: its params on the
    host, losses and delivered fractions to there, and the distance
    between the plain run and its nudged twin there)."""
    import torch.distributed as dist

    from repro_torch.config import LTPConfig
    from repro_torch.core.ltp_sync import make_ltp_sync
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import frac_schedule, init_distributed
    from repro_torch.models import build
    from repro_torch.models.sharding import param_specs
    from repro_torch.optim import adamw
    from repro_torch.tree import tree_leaves
    from repro_torch.train.trainer import init_state, make_ltp_train_step, \
        zero_opt_state

    api, opt = build(cfg), adamw()
    n_pkts = [max(1, -(-x.numel() // 360)) for x in tree_leaves(init)]
    shapes = [(n, 360) for n in n_pkts]
    line = {"config": cfg.name, "dtype": cfg.dtype,
            "n_params": sum(x.numel() for x in tree_leaves(init)),
            "leaf_packets": n_pkts, "n_leaf_packets": sum(n_pkts),
            "world_size": 1, "backend": "nccl", "mesh": {"data": 1,
                                                         "model": 1},
            "batch": LM_BATCH, "seq": LM_SEQ, "data_vocab": LM_DATA_VOCAB,
            "steps": SHARDED_STEPS, "lr": SHARDED_LR, "runs": {}}
    corpus = SyntheticLM(vocab=LM_DATA_VOCAB, seed=0)
    batches = [corpus.train_batch(LM_BATCH, LM_SEQ, s)
               for s in range(SHARDED_STEPS)]
    frac = frac_schedule(0.001, 1)
    line["frac"] = frac.tolist()
    specs = {"tokens": ("data",), "labels": ("data",)}

    # the launcher itself, as a user starts it without torchrun: its own
    # process group, init and corpus, 2 steps, its step-0 log line read
    import contextlib
    import io

    from repro_torch.launch import train as launcher

    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = launcher.main(["--mode", "sharded", "--steps", "2",
                            "--data-vocab", str(LM_DATA_VOCAB)])
    logged = out.getvalue().splitlines()
    row = [r.split() for r in logged if r.startswith("step")]
    if rc != 0 or len(row) != 1 or not (
            abs(float(row[0][3]) - math.log(cfg.vocab)) < 1.0
            and 0.9 < float(row[0][5]) <= 1.0):
        raise AssertionError(f"sharded launcher: rc {rc}, log {logged}")
    line["launcher"] = {"argv": "--mode sharded --steps 2 --data-vocab "
                                f"{LM_DATA_VOCAB}", "log": logged,
                        "seconds": time.perf_counter() - t0}
    gc.collect()
    torch.cuda.empty_cache()

    dev, tmp = init_distributed("cuda:0")
    launches = []
    try:
        mesh = make_host_mesh(1, 1)
        line["backend"] = dist.get_backend()

        def state_for(variant, ltp, params):
            state = init_state(api, opt, params=params)
            if variant == "zero":
                state.opt_state = zero_opt_state(params, ltp, mesh,
                                                 ("data",))
            return state

        def run(label, variant, comp, backend, params):
            ltp = LTPConfig(compensation=comp, sync_backend=backend)
            step = make_ltp_train_step(api, opt, mesh, ltp, ("data",), specs)
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            state = state_for(variant, ltp, params)
            zero_counts()
            step_s, losses, delivered = [], [], []
            for s, b in enumerate(batches):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, m = step(state, b, frac, 1 + s, SHARDED_LR)
                losses.append(float(m["loss"]))
                delivered.append(float(m["delivered_frac"]))
                torch.cuda.synchronize()
                step_s.append(time.perf_counter() - t0)
                if (label.startswith("psum_paper")
                        and s + 1 == TP_DP_MODEL["steps"]):
                    snaps[label] = [x.detach().clone()
                                    for x in tree_leaves(state.params)]
            got = read_counts()
            launches.append(got)
            if not all(math.isfinite(x) for x in losses):
                raise AssertionError(f"sharded {label}: losses {losses}")
            steady = statistics.median(step_s[1:])
            line["runs"][label] = {
                "launches": got, "step_ms": [t * 1e3 for t in step_s],
                "median_step_ms": steady * 1e3,
                "tokens_per_s": LM_BATCH * LM_SEQ / steady,
                "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
                "loss": losses, "delivered": delivered}
            params_out = state.params
            del state
            return params_out

        control = nudged(torch, init, 2)
        n_leaves = len(n_pkts)
        snaps = {}
        for variant, comp, per_step in (("psum", "paper", n_leaves),
                                        ("psum", "count", n_leaves),
                                        ("zero", "paper", 0)):
            form = f"{variant}_{comp}"
            ker = run(f"{form}_cuda", variant, comp, "cuda", init)
            plain = run(f"{form}_python", variant, comp, "python", init)
            ctl = run(f"{form}_python_nudged", variant, comp, "python",
                      control)
            runs = line["runs"]
            want = launches_of(dropfill=per_step * SHARDED_STEPS)
            if runs[f"{form}_cuda"]["launches"] != want or any(
                    runs[f"{form}_{r}"]["launches"] != launches_of()
                    for r in ("python", "python_nudged")):
                raise AssertionError(
                    f"sharded {form}: launches "
                    f"{[runs[f'{form}_{r}']['launches'] for r in ('cuda', 'python', 'python_nudged')]}, "
                    f"expected {want} through the kernels")
            a, b = runs[f"{form}_cuda"], runs[f"{form}_python"]
            if a["delivered"] != b["delivered"] or any(
                    abs(x - y) > LM_LOSS_RTOL * abs(y)
                    for x, y in zip(a["loss"], b["loss"])):
                raise AssertionError(f"sharded {form} kernels vs plain: "
                                     f"{a['loss']} {a['delivered']} vs "
                                     f"{b['loss']} {b['delivered']}")
            line[form] = within_rounding(f"sharded {form}", ker, plain, ctl)
            del ker, plain, ctl
            if form == "psum_paper":
                # the tp phase's (pod 1, data 2) run is held against this
                # run at its last step
                k = TP_DP_MODEL["steps"]
                ws1 = {"params": [x.cpu() for x in
                                  snaps.pop("psum_paper_cuda")],
                       "control": distance(
                           snaps.pop("psum_paper_python"),
                           snaps.pop("psum_paper_python_nudged")),
                       "loss": runs["psum_paper_cuda"]["loss"][:k],
                       "delivered": runs["psum_paper_cuda"]["delivered"][:k]}
        del control
        loss = line["runs"]["psum_paper_cuda"]["loss"]
        if not (abs(loss[0] - math.log(cfg.vocab)) < 1.0
                and loss[-1] < loss[0]):
            raise AssertionError(f"sharded: loss does not start near ln V "
                                 f"or fall: {loss}")
        line["ln_vocab"] = math.log(cfg.vocab)

        # LTPSync on one gradient of the model, kernels against plain
        dev = tree_leaves(init)[0].device
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in batches[0].items()}
        grads = torch.func.grad(lambda p: api.loss_fn(p, batch))(init)
        del batch
        grad_specs = param_specs(init, mesh)
        line["ltp_sync"] = {}
        for comp in ("paper", "count"):
            for ef in (False, True):
                outs = {}
                for backend in ("cuda", "python"):
                    sync = make_ltp_sync(init, mesh, LTPConfig(
                        compensation=comp, error_feedback=ef,
                        sync_backend=backend), grad_specs)
                    res = sync.init_residual(dev)
                    if res is not None:
                        gen = torch.Generator(device=dev).manual_seed(5)
                        res = 1e-3 * torch.randn(res.shape, device=dev,
                                                 generator=gen)
                    zero_counts()
                    synced, new_res, st = sync(grads, frac, 7, res)
                    torch.cuda.synchronize()
                    outs[backend] = (synced, new_res,
                                     float(st["delivered_frac"]),
                                     read_counts())
                    del res
                label = f"{comp}{'_ef' if ef else ''}"
                (a, ra, da, na), (b, rb, db, nb) = outs["cuda"], \
                    outs["python"]
                want = launches_of(dropfill=2 if comp == "count" else 1)
                if na != want or nb != launches_of() or da != db:
                    raise AssertionError(
                        f"sharded LTPSync {label}: launches {na} / {nb} "
                        f"(expected {want} through the kernels), "
                        f"delivered {da} / {db}")
                pairs = list(zip(tree_leaves(a), tree_leaves(b),
                                 strict=True))
                if ra is not None:
                    pairs.append((ra, rb))
                for x, y in pairs:
                    torch.testing.assert_close(x, y, rtol=1e-6, atol=0.0)
                launches.append(na)
                line["ltp_sync"][label] = {
                    "launches": na, "delivered": da,
                    "n_packets": sync.plan.n_packets,
                    "max_abs_err": max((x - y).abs().max().item()
                                       for x, y in pairs)}
                del outs, a, b, ra, rb, pairs, sync
        del grads
        gc.collect()
        torch.cuda.empty_cache()

        # the second step of a psum (paper) run profiled, not counted
        ltp = LTPConfig(sync_backend="cuda")
        step = make_ltp_train_step(api, opt, mesh, ltp, ("data",), specs)
        state, _ = step(state_for("psum", ltp, init), batches[0], frac, 1,
                        SHARDED_LR)
        gc.collect()
        torch.cuda.empty_cache()
        prof = profile_step(torch, lambda: step(state, batches[1], frac, 2,
                                                SHARDED_LR))
        gate = {k: v for k, v in prof["port_kernels_ms"].items()
                if "dropfill" in k}
        n_gate = sum(n for k, n in prof["port_launches"].items()
                     if "dropfill" in k)
        if n_gate != n_leaves or len(prof["port_launches"]) != len(gate):
            raise AssertionError(f"sharded profile: port launches "
                                 f"{prof['port_launches']}, not {n_leaves} "
                                 f"dropfill")
        prof["gate_device_ms"] = sum(gate.values())
        prof["gate_device_ms_per_launch"] = sum(gate.values()) / n_gate
        line["profile_psum_paper_step"] = prof
        line["idle_share"] = prof["idle_share"]
        del state, step
    finally:
        dist.destroy_process_group()
        if tmp is not None:
            tmp.cleanup()
    gc.collect()
    torch.cuda.empty_cache()
    rows = sharded_gate_rows(torch, timer, shapes)
    line["gate_rows"] = rows
    line["profile_psum_paper_step"]["gate_bound_ms"] = rows["step"]["bound_ms"]
    gc.collect()
    torch.cuda.empty_cache()
    line["gloo_two_ranks"] = run_sharded_gloo(torch)
    return line, launches, rows, ws1


# the tp phase's full-width runs: each config's CONFIG at its published
# widths in its own dtype (bfloat16; papernet float32), cut in depth,
# SGD-momentum at examples/train_lm.py's lr; the parent passes each to
# its ranks. Mixtral-8x22b at 1 layer (as on the MoE path) and
# DeepSeek-V2 at 1 layer (its dense lead layer: MLA, d_ff 12,288) run
# batch 32 x seq 128 at (1, 2) through the kernels, then the plain
# route over its first step, and DeepSeek's ZeRO variant; every run 2
# steps (cut for time from 3, PERF.md §4); falcon-mamba (2 layers),
# zamba2 (7: six Mamba-2 layers, the shared block, one more),
# whisper-small at 6 encoder and 6 decoder layers of 12 (cut for time)
# and papernet (whole) through the kernels, at batch 8 (papernet 128
# images)
TP_MODEL = {"arch": "mixtral_8x22b", "reduced": False, "n_layers": 1,
            "steps": 2, "batch": 32, "seq": 128, "lr": 3e-4,
            "data_vocab": LM_DATA_VOCAB, "routes": ["cuda", "python"],
            "plain_steps": 1}
TP_FAMILY_RUN = dict(TP_MODEL, batch=8, routes=["cuda"])
TP_MODELS = [TP_MODEL,
             dict(TP_MODEL, arch="deepseek_v2_236b", zero=True),
             dict(TP_FAMILY_RUN, arch="falcon_mamba_7b", n_layers=2),
             dict(TP_FAMILY_RUN, arch="zamba2_7b", n_layers=7),
             dict(TP_FAMILY_RUN, arch="whisper_small", n_layers=6,
                  encoder_layers=6),
             dict(TP_FAMILY_RUN, arch="papernet", n_layers=6, batch=128)]
# data parallelism inside a worker: the sharded phase's smollm-360m (the
# LM phase's CONFIG at float32, 32 layers, its init and batches, AdamW,
# psum paper) on (pod 1, data 2, model 1), worker_axes ("pod",), the same
# two ranks, held against that phase's world-size-1 run at step 2 (3
# before the cut for time, PERF.md §4)
TP_DP_MODEL = {"arch": "smollm_360m", "reduced": False, "n_layers": 32,
               "dtype": "float32", "steps": 2, "batch": LM_BATCH,
               "seq": LM_SEQ, "lr": SHARDED_LR, "data_vocab": LM_DATA_VOCAB}
# FSDP over data in the plain step: the same smollm-360m CONFIG at its
# published widths (float32, 32 layers) on (data 2, model 1), the same two
# ranks, SGD-momentum, 3 steps, held against the plain step at world size
# 1 from the same init and batches, run in this process with its one-ulp
# rounding control
TP_FSDP_MODEL = dict(TP_DP_MODEL, steps=3, lr=SHARDED_LR, optimizer="sgdm")
TP_REDUCED = ("smollm_360m", "mixtral_8x22b", "deepseek_v2_236b",
              "falcon_mamba_7b", "zamba2_7b")
TP_CHILD_TIMEOUT_S = 900
# the tp phase's serve: after training, the (1, 1) process and the (1, 2)
# ranks serve these models from the init (bfloat16): a (batch, prompt)
# prefill, then ``new`` decode steps
TP_SERVE = {"batch": 8, "prompt": 128, "new": 16}
TP_SERVE_ARCHS = ("mixtral_8x22b", "deepseek_v2_236b")
# a row is one token's logits (the prefill's last token, or one decode
# step's) of one sequence. A one-ulp nudge of the init moves some MoE
# routes, and a moved route moves its row's logits by about their own
# size, so the control's largest row bounds little; its median row is
# rounding. In each of the prefill and the decode at least this share
# of the (1, 2) rows must lie within twice the control's median row
SERVE_ROW_SHARE = 0.9


def serve_rows(a, b):
    """The largest |a - b| of each row of two served logits tensors
    ((steps, batch, vocab) -> (steps, batch))."""
    return (a - b).abs().amax(-1)


def tp_config(model: dict):
    """The config of a ``TP_MODELS`` entry (or ``TP_DP_MODEL``)."""
    from repro_torch.configs import get_config, get_reduced

    get = get_reduced if model["reduced"] else get_config
    cfg = get(model["arch"]).replace(n_layers=model["n_layers"])
    if "encoder_layers" in model:
        cfg = cfg.replace(encoder_layers=model["encoder_layers"])
    return cfg.replace(dtype=model["dtype"]) if "dtype" in model else cfg


def tp_batches(model: dict) -> list:
    """A run's batches: ``SyntheticLM(data_vocab)`` tokens (and an
    enc-dec config's ``train.lm.audio_frames``), or papernet's
    ``SyntheticCIFAR`` images."""
    from repro_torch.data import SyntheticCIFAR, SyntheticLM
    from repro_torch.train.lm import audio_frames

    cfg = tp_config(model)
    if cfg.family == "cnn":
        data = SyntheticCIFAR(seed=0)
        return [data.train_batch(model["batch"], s)
                for s in range(model["steps"])]
    corpus = SyntheticLM(vocab=model["data_vocab"], seed=0)
    out = []
    for s in range(model["steps"]):
        b = corpus.train_batch(model["batch"], model["seq"], s)
        if cfg.family == "audio":
            b["frames"] = audio_frames(cfg, model["batch"], 0, s)
        out.append(b)
    return out


def tp_expected_loss(cfg, labels=None) -> tuple:
    """Step 1's loss at the random init and the spread of a given init
    around it. ln V for papernet (its head is near zero), spread 0. For
    an LM, ln V plus the random head's logit variance over 2 (s^2 = 0.02^2
    d after a unit-variance norm: the mean logsumexp over the vocab),
    plus 0.01 where a MoE layer adds its balance loss (near 1). That is
    the mean over the head's init. One init's loss also subtracts the
    mean logit of the label tokens, which is 0 only on average: it is
    Gaussian over the head's columns with a standard deviation of at most
    0.02 sqrt(d sum_y p_y^2) (p_y the share of label y in ``labels``),
    reached where the final hidden states share one direction, and
    synthetic text repeats its labels (sum_y p_y^2 = 0.0055 at batch 8 x
    128 of ``SyntheticLM(8192)``). Zamba2's step 1 read 0.14-0.18 above
    the mean, the port and the JAX package giving the same loss from the
    same params (``tests/test_torch_ssm.py``, which also finds the mean
    logsumexp at ln V + s^2 / 2): about two of these standard deviations
    (0.089). ``run_tp_phase`` holds step 1 within four of them (papernet
    within 1.0)."""
    if cfg.family == "cnn":
        return math.log(cfg.vocab), 0.0
    moe = cfg.n_experts > 0 and cfg.n_layers > cfg.first_dense_layers
    mean = (math.log(cfg.vocab) + 0.5 * 0.02 ** 2 * cfg.d_model
            + (0.01 if moe else 0.0))
    if labels is None:
        return mean, None
    import numpy as np

    share = np.unique(np.asarray(labels), return_counts=True)[1] / np.size(
        labels)
    return mean, 0.02 * math.sqrt(cfg.d_model * float((share ** 2).sum()))


class CollectiveCounter:
    """Counts the calls and bytes of ``torch.distributed.all_reduce``,
    ``all_gather_into_tensor``, ``all_to_all_single`` and
    ``reduce_scatter_tensor`` on the groups of ``axes`` of a mesh (bytes:
    the tensor each rank passes in), by wrapping the functions of the
    module the port calls them through."""

    INPUT_ARG = {"all_reduce": 0, "all_gather_into_tensor": 1,
                 "all_to_all_single": 1, "reduce_scatter_tensor": 1}

    def __init__(self, dist, mesh, axes=("model",)):
        self.dist = dist
        self.groups = {a: mesh.get_group(a) for a in axes}
        self.orig = {n: getattr(dist, n) for n in self.INPUT_ARG}
        self.zero()
        for name, fn in self.orig.items():
            setattr(dist, name, self._wrap(name, fn))

    def _wrap(self, name, fn):
        def counted(*args, **kw):
            for a, group in self.groups.items():
                if kw.get("group") is group:
                    t = args[self.INPUT_ARG[name]]
                    self.calls[a][name] += 1
                    self.bytes[a][name] += t.numel() * t.element_size()
            return fn(*args, **kw)
        return counted

    def zero(self):
        self.calls = {a: dict.fromkeys(self.orig, 0) for a in self.groups}
        self.bytes = {a: dict.fromkeys(self.orig, 0) for a in self.groups}

    def read(self, steps: int) -> dict:
        """``{"<axis>_collectives": {"calls_per_step", "bytes_per_step"}}``
        an axis."""
        return {f"{a}_collectives": {
            "calls_per_step": {k: v / steps for k, v in
                               self.calls[a].items()},
            "bytes_per_step": {k: v / steps for k, v in
                               self.bytes[a].items()}}
            for a in self.groups}

    def close(self):
        for name, fn in self.orig.items():
            setattr(self.dist, name, fn)


def tp_train(torch, api, opt, mesh, params, backend, batches, frac, lr, *,
             uniforms=None, counter=None, profile=False, variant="psum",
             worker_axes=("data",), keep_at=None, flops=False,
             fsdp=False) -> dict:
    """``make_ltp_train_step`` (paper) from the GLOBAL ``params`` on
    ``mesh`` through ``backend``, over ``worker_axes`` (the batch split
    over the mesh's batch axes), the psum variant with ``opt`` or the
    ZeRO variant (``variant="zero"``: its own SGD-momentum), one step a
    batch, the draws from seed 1 + step (or ``uniforms(step, state)``);
    or (``variant="plain"``, ``backend`` and ``frac`` unused)
    ``make_plain_train_step`` with ``opt`` (without a mesh one process
    on the whole batch; with ``fsdp`` its state split over ``data``),
    which also returns the bytes of a rank's state (``state_gb``) and,
    with ``fsdp``, the state's ``FsdpCtx`` (``fsdp``).
    Every kernel's launch count is set to 0 just before the run and read
    just after. Returns the state's blocks, host ms a step, losses,
    delivered fractions, those launches, the peak memory (and what else
    the card held when the run began), and, with
    ``counter``, its axes' collectives a step; with ``profile``, one more
    step profiled after the counts are read (its params are not
    returned); with ``keep_at``, a copy on the host of the state's
    blocks after that many steps (``params_at``), taken outside the
    steps' times; with ``flops``, the FLOPs that ``FlopCounterMode``
    counts around one more step after the counts are read
    (``flops_step``; its params are not returned)."""
    import statistics as st

    from repro_torch.config import LTPConfig
    from repro_torch.kernels import dropfill as df_mod
    from repro_torch.kernels import packet_reduce as pr_mod
    from repro_torch.kernels import randomk as rk_mod
    from repro_torch.models.sharding import dp_axes
    from repro_torch.train.trainer import init_state, make_ltp_train_step, \
        make_plain_train_step, zero_opt_state
    from repro_torch.tree import tree_leaves, tree_map

    cuda = tree_leaves(params)[0].device.type == "cuda"
    state = init_state(api, opt, params=params, mesh=mesh, fsdp=fsdp)
    if variant == "plain":
        plain = make_plain_train_step(api, opt, mesh)

        def step(state, b, frac, seed, lr, uniforms=None):
            return plain(state, b, lr)
    else:
        ltp = LTPConfig(sync_backend=backend)
        if variant == "zero":
            state.opt_state = zero_opt_state(params, ltp, mesh, worker_axes)
        dp = dp_axes(mesh)
        step = make_ltp_train_step(
            api, opt, mesh, ltp, worker_axes,
            {k: (dp[0] if len(dp) == 1 else dp,) for k in batches[0]})
    del params
    other = 0.0
    if cuda:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        # what the card holds beside the state (the caller's global
        # params, earlier runs' blocks): under the peak, not the step's
        other = (torch.cuda.memory_allocated() - sum(
            x.numel() * x.element_size() for x in tree_leaves(
                (state.params, state.opt_state, state.step)))) / 1e9
    for mod, attr in ((pr_mod, "LAUNCHES"), (pr_mod, "TREE_LAUNCHES"),
                      (df_mod, "LAUNCHES"), (rk_mod, "LAUNCHES")):
        setattr(mod, attr, 0)
    if counter is not None:
        counter.zero()
    step_s, losses, delivered, kept = [], [], [], {}
    for s, b in enumerate(batches):
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        u = None if uniforms is None else uniforms(s, state)
        state, m = step(state, b, frac, 1 + s, lr, uniforms=u)
        losses.append(float(m["loss"]))
        if "delivered_frac" in m:
            delivered.append(float(m["delivered_frac"]))
        if cuda:
            torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        if s + 1 == keep_at:
            kept["params_at"] = tree_map(
                lambda x: x.detach().to("cpu", copy=True), state.params)
    out = {"params": state.params, **kept,
           "launches": {"packet_reduce": pr_mod.LAUNCHES,
                        "tree_reduce": pr_mod.TREE_LAUNCHES,
                        "dropfill": df_mod.LAUNCHES,
                        "randomk": rk_mod.LAUNCHES},
           "step_ms": [t * 1e3 for t in step_s],
           "median_step_ms": st.median(step_s[1:] or step_s) * 1e3,
           "loss": losses, "delivered": delivered}
    if variant == "plain":
        out["state_gb"] = state_gb(state)
    if fsdp:
        out["fsdp"] = state.fsdp
    if cuda:
        out["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
        out["other_allocated_gb"] = other
    if counter is not None:
        out.update(counter.read(len(batches)))
    if flops:
        from torch.utils.flop_counter import FlopCounterMode

        with FlopCounterMode(display=False) as fc:
            step(state, batches[0], frac, 1 + len(batches), lr)
        out["flops_step"] = fc.get_total_flops()
    if profile:
        gc.collect()
        torch.cuda.empty_cache()
        out["profile_step"] = profile_step(torch, lambda: step(
            state, batches[0], frac, 1 + len(batches), lr))
    return out


def tp_serve(torch, api, mesh, make_params, dev, counter=None) -> dict:
    """Serve ``TP_SERVE`` with the GLOBAL params that ``make_params()``
    gives on ``mesh`` (this rank's blocks under its ``ShardCtx``, the
    global tree freed; none at (1, 1)): the prefill of
    a (batch, prompt) prompt, then ``new`` decode steps from a cache
    holding the prefill's (``transformer.cache_from_prefill``), fed
    tokens drawn with the prompt from a CPU generator seeded 5, so every
    run decodes the same tokens. Returns the logits (the prefill's, then
    each step's, float32 on the host), the host ms of the prefill and a
    decode token, the peak memory from the prefill on (and what the card
    held before the params were made) and, with
    ``counter``, its axes' collectives of the prefill and a decode
    token."""
    from repro_torch.models.layers import dtype_of
    from repro_torch.models.sharding import shard_params, tp_ctx
    from repro_torch.models.transformer import cache_from_prefill
    from repro_torch.train.trainer import model_layout

    b, s, new = TP_SERVE["batch"], TP_SERVE["prompt"], TP_SERVE["new"]
    cfg, ctx = api.cfg, tp_ctx(mesh)
    cuda = torch.device(dev).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    gc.collect()
    out = {}
    if cuda:
        torch.cuda.empty_cache()
        out["other_allocated_gb"] = torch.cuda.memory_allocated() / 1e9
    params = make_params()
    if ctx is not None:
        params = shard_params(params, model_layout(api, mesh), mesh)
    gen = torch.Generator().manual_seed(5)
    prompt = torch.randint(0, cfg.vocab, (b, s), generator=gen).to(dev)
    toks = torch.randint(0, cfg.vocab, (b, new), generator=gen).to(dev)
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        if counter is not None:
            counter.zero()
        sync()
        t0 = time.perf_counter()
        logits, pc = api.prefill(params, {"tokens": prompt}, ctx=ctx)
        sync()
        out["prefill_ms"] = (time.perf_counter() - t0) * 1e3
        if counter is not None:
            out["prefill_collectives"] = counter.read(1)
        cache = cache_from_prefill(cfg, pc, b, s + new, dtype_of(cfg.dtype),
                                   device=dev, ctx=ctx)
        del pc
        rows = [logits.float()]
        if counter is not None:
            counter.zero()
        sync()
        t0 = time.perf_counter()
        for t in range(new):
            logits, cache = api.decode_step(params, cache, toks[:, t], s + t,
                                            ctx=ctx)
            rows.append(logits.float())
        sync()
        out["decode_ms_per_token"] = (time.perf_counter() - t0) * 1e3 / new
        if counter is not None:
            out["decode_collectives_per_token"] = counter.read(new)
    if cuda:
        out["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["logits"] = torch.stack(rows).cpu()
    if not (out["logits"].shape == (new + 1, b, cfg.vocab_padded)
            and bool(torch.isfinite(out["logits"]).all())):
        raise AssertionError(f"tp serve {cfg.name}: logits "
                             f"{tuple(out['logits'].shape)}, finite "
                             f"{bool(torch.isfinite(out['logits']).all())}")
    return out


def tp_init(torch, api, dev):
    """The global init from a generator seeded 0: on the card for an LM
    (its leaves are drawn where the generator lives), on the CPU for
    papernet (whose init draws there and moves its leaves)."""
    gen_dev = "cpu" if api.cfg.family == "cnn" else dev
    return api.init(torch.Generator(device=gen_dev).manual_seed(0),
                    device=dev)


def params_digest(torch, params) -> str:
    """SHA-1 of every leaf's bytes in tree order."""
    import hashlib

    from repro_torch.tree import tree_leaves

    h = hashlib.sha1()
    for x in tree_leaves(params):
        h.update(x.detach().reshape(-1).view(torch.uint8).cpu().numpy())
    return h.hexdigest()


def wait_for(path: str, t_start: float) -> float:
    """Seconds spent waiting for ``path`` to exist; raises past
    ``TP_CHILD_TIMEOUT_S`` from ``t_start``."""
    t0 = time.perf_counter()
    while not os.path.exists(path):
        if time.perf_counter() - t_start > TP_CHILD_TIMEOUT_S:
            raise TimeoutError(f"no params at {path}")
        time.sleep(0.2)
    return time.perf_counter() - t0


def against_saved(torch, full, path: str, dev) -> dict:
    """The digest of the global params ``full`` and their largest
    distance to the leaves saved at ``path`` (``torch.save``)."""
    from repro_torch.tree import tree_leaves

    saved = torch.load(path, mmap=True, map_location="cpu",
                       weights_only=True)
    d = max((a.float() - b.to(dev).float()).abs().max().item()
            for a, b in zip(tree_leaves(full), saved, strict=True))
    return {"digest": params_digest(torch, full), "d_saved": d}


def tp_full_model(torch, dist, mesh, counter, model: dict, dev,
                  t_start: float) -> dict:
    """One model of a full-width rank (``tp_full_rank``), once the (1, 1)
    run's params are in ``model["one"]`` (a ``torch.save`` of its
    leaves): each of ``model["routes"]`` from the same init; then the
    global params of the kernel route gathered (``gather_params``), their
    digest and their distance to the (1, 1) params, and the distance of
    this rank's blocks between the routes (the plain route over the first
    ``model["plain_steps"]`` steps, against the kernel route's blocks
    there). With ``model["zero"]``, then
    the ZeRO variant through the kernels' backend (its mask is the
    reference's multiply), its gathered params against the (1, 1) ZeRO
    run's (``model["one_zero"]``). With ``model["serve_one"]``, then
    served (``tp_serve``) from the init, its logits held against the
    (1, 1) process's, which it saved there."""
    from repro_torch.launch.train import frac_schedule
    from repro_torch.models import build
    from repro_torch.models.sharding import gather_params
    from repro_torch.optim import sgd_momentum
    from repro_torch.tree import tree_leaves, tree_map
    from repro_torch.train.trainer import model_layout

    api, opt = build(tp_config(model)), sgd_momentum()
    batches = tp_batches(model)
    rec = {"waited_s": wait_for(model["one"], t_start)}
    specs = model_layout(api, mesh)
    kept = {}
    n_plain = model["plain_steps"]
    runs = [(backend, backend, "psum") for backend in model["routes"]]
    if model.get("zero"):
        runs.append(("zero", "cuda", "zero"))
    for label, backend, variant in runs:
        t0 = time.perf_counter()
        params = tp_init(torch, api, dev)
        cut = label == "cuda" and "python" in model["routes"] \
            and n_plain < len(batches)
        r = tp_train(torch, api, opt, mesh, params, backend,
                     batches[:n_plain] if label == "python" else batches,
                     frac_schedule(0.001, 1), model["lr"], counter=counter,
                     variant=variant, keep_at=n_plain if cut else None)
        del params
        kept[label] = r.pop("params")
        if cut:
            kept["cuda_at"] = r.pop("params_at")
        r["seconds"] = time.perf_counter() - t0
        r["steps_seconds"] = sum(r["step_ms"]) / 1e3
        rec[label] = r
    if "python" in kept:
        at = kept.pop("cuda_at", None)
        rec["d_kernel_plain"] = distance(
            kept["cuda"] if at is None else tree_map(lambda x: x.to(dev), at),
            kept.pop("python"))
        del at
    rec["n_params_rank"] = sum(x.numel() for x in tree_leaves(kept["cuda"]))
    for label, key in (("cuda", "one"), ("zero", "one_zero")):
        if label not in kept:
            continue
        full = gather_params(kept.pop(label), specs, mesh)
        got = against_saved(torch, full, model[key], dev)
        del full
        sfx = "" if label == "cuda" else "_zero"
        rec[f"digest{sfx}"], rec[f"d_one_rank{sfx}"] = got["digest"], \
            got["d_saved"]
        gc.collect()
        if dev != "cpu":
            torch.cuda.empty_cache()
    if "serve_one" in model:
        served = tp_serve(torch, api, mesh, lambda: tp_init(torch, api, dev),
                          dev, counter)
        one = torch.load(model["serve_one"], weights_only=True)
        rows = serve_rows(served.pop("logits"), one)
        served["vs_model1_max_abs_diff"] = rows.max().item()
        served["vs_model1_rows"] = rows.tolist()
        rec["serve"] = served
    return rec


def tp_dp_model(torch, dist, spec: dict, dev, t_start: float) -> dict:
    """``spec`` (``TP_DP_MODEL`` with ``ws1``, the world-size-1 run's
    params at its last step, saved) on (pod 1, data 2, model 1) over the
    process group: the LM phase's init (a CPU generator seeded 0), AdamW,
    psum paper through the kernels, ``worker_axes=("pod",)``, each rank
    on its half of the global batch, the gradients averaged over
    ``data``. Returns its numbers (the ``data`` axis's collectives a
    step), the digest of its params and their distance to ``ws1``."""
    from repro_torch.launch.mesh import _mesh
    from repro_torch.launch.train import frac_schedule
    from repro_torch.models import build
    from repro_torch.optim import adamw

    mesh = _mesh((1, 2, 1), ("pod", "data", "model"))
    api = build(tp_config(spec))
    rec = {"mesh": {"pod": 1, "data": 2, "model": 1},
           "worker_axes": ["pod"],
           "waited_s": wait_for(spec["ws1"], t_start)}
    counter = CollectiveCounter(dist, mesh, ("data",))
    try:
        t0 = time.perf_counter()
        params = api.init(torch.Generator().manual_seed(0), device=dev)
        r = tp_train(torch, api, adamw(), mesh, params, "cuda",
                     tp_batches(spec), frac_schedule(0.001, 1), spec["lr"],
                     counter=counter, worker_axes=("pod",))
        del params
    finally:
        counter.close()
    got = against_saved(torch, r.pop("params"), spec["ws1"], dev)
    r["seconds"] = time.perf_counter() - t0
    r["steps_seconds"] = sum(r["step_ms"]) / 1e3
    rec.update(r, digest=got["digest"], d_ws1=got["d_saved"])
    gc.collect()
    if dev != "cpu":
        torch.cuda.empty_cache()
    return rec


def state_gb(state) -> dict:
    """The bytes (GB) of a train state's params, their gradients (one
    leaf a param, alike) and its optimizer state."""
    from repro_torch.tree import tree_leaves

    def gb(tree):
        return sum(x.numel() * x.element_size()
                   for x in tree_leaves(tree)) / 1e9

    p = gb(state.params)
    return {"params": p, "grads": p, "optimizer_state": gb(state.opt_state)}


def tp_fsdp_model(torch, dist, spec: dict, dev, t_start: float) -> dict:
    """``spec`` (``TP_FSDP_MODEL`` with ``ws1``, the world-size-1 plain
    run's params at its last step, saved) on (data 2, model 1) over the
    process group: the LM phase's init (a CPU generator seeded 0),
    SGD-momentum, the plain step with FSDP over ``data`` (``tp_train``),
    each rank on its half of the global batch. Returns its numbers (the
    ``data`` axis's collectives a step), the digest of its gathered
    params and their distance to ``ws1``."""
    from repro_torch.launch.mesh import _mesh
    from repro_torch.models import build
    from repro_torch.models.sharding import gather_params
    from repro_torch.optim import sgd_momentum

    mesh = _mesh((2, 1), ("data", "model"))
    api = build(tp_config(spec))
    rec = {"mesh": {"data": 2, "model": 1},
           "waited_s": wait_for(spec["ws1"], t_start)}
    counter = CollectiveCounter(dist, mesh, ("data",))
    try:
        t0 = time.perf_counter()
        params = api.init(torch.Generator().manual_seed(0), device=dev)
        r = tp_train(torch, api, sgd_momentum(), mesh, params, None,
                     tp_batches(spec), None, spec["lr"], variant="plain",
                     fsdp=True, counter=counter)
        del params
    finally:
        counter.close()
    r.pop("delivered")
    full = gather_params(r.pop("params"), r.pop("fsdp").specs, mesh)
    got = against_saved(torch, full, spec["ws1"], dev)
    del full
    r["seconds"] = time.perf_counter() - t0
    r["steps_seconds"] = sum(r["step_ms"]) / 1e3
    rec.update(r, digest=got["digest"], d_ws1=got["d_saved"])
    gc.collect()
    if dev != "cpu":
        torch.cuda.empty_cache()
    return rec


def tp_fsdp_ws1(torch, dev) -> tuple:
    """``TP_FSDP_MODEL``'s plain step at world size 1 in this process,
    from its init and from it nudged by one ulp (the rounding control):
    (its numbers, its params at the last step on the host)."""
    from repro_torch.models import build
    from repro_torch.optim import sgd_momentum
    from repro_torch.tree import tree_leaves

    api = build(tp_config(TP_FSDP_MODEL))
    batches = tp_batches(TP_FSDP_MODEL)
    runs = {}
    for nudge in (0, 1):
        params = api.init(torch.Generator().manual_seed(0), device=dev)
        if nudge:
            params = nudged(torch, params, 2)
        runs[nudge] = tp_train(torch, api, sgd_momentum(), None, params,
                               None, batches, None, TP_FSDP_MODEL["lr"],
                               variant="plain")
        del params
    kept = [x.cpu() for x in tree_leaves(runs[0]["params"])]
    part = {k: runs[0][k] for k in ("state_gb", "loss", "step_ms",
                                    "median_step_ms", "launches")}
    part["peak_memory_gb"] = runs[0].get("peak_memory_gb")
    part["rounding_control_max_abs_diff"] = distance(runs[0].pop("params"),
                                                     runs[1].pop("params"))
    return part, kept


def tp_full_rank(torch, dist, spec: dict) -> dict:
    """One of the two ranks of the full-width runs: each model of
    ``spec["models"]`` in turn (``tp_full_model``) on (data 1, model 2),
    then ``spec["dp"]`` (``tp_dp_model``) and ``spec["fsdp"]``
    (``tp_fsdp_model``). Returns each model's numbers."""
    from repro_torch.launch.mesh import make_host_mesh

    dev = spec["device"]
    mesh = make_host_mesh(1, 2)
    t0 = time.perf_counter()
    if dev != "cpu":
        # the CUDA context and cuBLAS, made while the (1, 1) runs hold
        # the card
        x = torch.ones((256, 256), dtype=torch.bfloat16, device=dev)
        float((x @ x).sum())
    rec = {"warm_s": time.perf_counter() - t0, "models": {}}
    counter = CollectiveCounter(dist, mesh)
    try:
        for model in spec["models"]:
            rec["models"][model["arch"]] = tp_full_model(
                torch, dist, mesh, counter, model, dev, t0)
    finally:
        counter.close()
    rec["dp"] = tp_dp_model(torch, dist, spec["dp"], dev, t0)
    rec["fsdp"] = tp_fsdp_model(torch, dist, spec["fsdp"], dev, t0)
    return rec


# the REDUCED runs on four ranks: (label, architecture, variant, mesh,
# worker axes), the ZeRO variant on (data 2, model 2) beside the psum one,
# and data parallelism inside a worker on (pod 2, data 2, model 1)
TP_REDUCED_RUNS = ([(arch, arch, "psum", (2, 2), ("data",))
                    for arch in TP_REDUCED]
                   + [(f"zero/{arch}", arch, "zero", (2, 2), ("data",))
                      for arch in TP_REDUCED]
                   + [("pd/smollm_360m", "smollm_360m", "psum", (2, 2, 1),
                       ("pod",))])


def tp_reduced_rank(torch, spec: dict) -> dict:
    """One of four ranks: each of ``TP_REDUCED_RUNS`` at its REDUCED
    config in float32 on ``spec["device"]`` (the init moved by one ulp
    with ``spec["nudge"]``), the step (paper, the ``auto`` backend: the
    gate's kernel on CUDA tensors; the ZeRO variant masks with the
    multiply), SGD-momentum lr 0.1, fractions (0.7, 0.9),
    ``SHARDED_GLOO_STEPS`` steps of a (8, 32) global batch; the draws are
    the CPU generator's for the global leaves (``uniforms=``), so the
    CUDA and CPU runs mask alike. Returns the gathered params, losses,
    delivered fractions and launches of each run."""
    import numpy as np

    from repro_torch.configs import get_reduced
    from repro_torch.core import ltp_sync as ls
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.mesh import _mesh
    from repro_torch.models import build
    from repro_torch.models.sharding import gather_params
    from repro_torch.optim import sgd_momentum
    from repro_torch.tree import tree_leaves
    from repro_torch.train.trainer import model_layout

    device = spec["device"]
    meshes = {(2, 2): _mesh((2, 2), ("data", "model")),
              (2, 2, 1): _mesh((2, 2, 1), ("pod", "data", "model"))}
    rec = {}
    for label, arch, variant, shape, workers in TP_REDUCED_RUNS:
        t0 = time.perf_counter()
        mesh = meshes[shape]
        w = ls.worker_index(mesh, workers)
        cfg = get_reduced(arch).replace(dtype="float32")
        api = build(cfg)
        params = api.init(torch.Generator().manual_seed(0), device=device)
        if spec["nudge"]:
            params = nudged(torch, params, 7)
        sizes = [max(1, -(-x.numel() // 360)) for x in tree_leaves(params)]
        corpus = SyntheticLM(vocab=cfg.vocab, seed=0)
        batches = [corpus.train_batch(SHARDED_GLOO_BATCH, SHARDED_GLOO_SEQ,
                                      s) for s in range(SHARDED_GLOO_STEPS)]

        def draws(s, state, sizes=sizes, w=w):
            return [ls.device_uniforms(n, "cpu", 1 + s, w, 0, i)
                    for i, n in enumerate(sizes)]

        r = tp_train(torch, api, sgd_momentum(), mesh, params, "auto",
                     batches, torch.tensor(SHARDED_GLOO_FRAC), 0.1,
                     uniforms=draws, variant=variant, worker_axes=workers)
        full = gather_params(r.pop("params"), model_layout(api, mesh), mesh)
        for i, x in enumerate(tree_leaves(full)):
            rec[f"{label}/params/{i}"] = x.cpu().numpy()
        for k in ("loss", "delivered"):
            rec[f"{label}/{k}"] = np.asarray(r[k])
        rec[f"{label}/launches"] = np.asarray(r["launches"]["dropfill"])
        rec[f"{label}/other_launches"] = np.asarray(
            sum(r["launches"].values()) - r["launches"]["dropfill"])
        rec[f"{label}/seconds"] = np.asarray(time.perf_counter() - t0)
    return rec


def tp_child(argv) -> int:
    """One rank of the ``tp`` phase in a process of its own:
    ``chip_smoke.py --tp-rank RANK WORLD INIT SPEC OUT``, SPEC a JSON
    object (``kind`` ``full``: ``tp_full_rank``, its numbers to OUT as
    JSON; ``reduced``: ``tp_reduced_rank``, to OUT as npz). Gloo, with
    TF32 off and deterministic convolutions, one CPU thread."""
    import datetime

    import numpy as np
    import torch
    import torch.distributed as dist

    rank, world, init, spec, out = (int(argv[0]), int(argv[1]), argv[2],
                                    json.loads(argv[3]), argv[4])
    sys.path.insert(0, os.path.join(HERE, "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=600))
    try:
        if spec["kind"] == "full":
            with open(out, "w") as f:
                json.dump(tp_full_rank(torch, dist, spec), f)
        else:
            np.savez(out, **tp_reduced_rank(torch, spec))
    finally:
        dist.destroy_process_group()
    return 0


def start_tp_ranks(world: int, spec: dict, tmp: str, name: str) -> list:
    """``world`` ``tp_child`` ranks of one run; [(process, out path)]."""
    ext = "json" if spec["kind"] == "full" else "npz"
    outs = [f"{tmp}/{name}{r}.{ext}" for r in range(world)]
    return [(subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--tp-rank", str(r),
         str(world), f"{tmp}/{name}.init", json.dumps(spec), outs[r]],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), outs[r])
        for r in range(world)]


def stop_tp_ranks(procs: dict) -> None:
    """Kills every rank of ``procs`` still running."""
    for ps in procs.values():
        for p, _ in ps:
            if p.poll() is None:
                p.kill()
                p.wait()


def finish_tp_ranks(procs: dict) -> dict:
    """Waits for every rank of every run of ``procs`` ({name: [(process,
    out path)]}), kills any left on a failure, and raises unless all
    exited 0."""
    errs = {}
    try:
        for name, ps in procs.items():
            for r, (p, _) in enumerate(ps):
                _, errs[name, r] = p.communicate(timeout=TP_CHILD_TIMEOUT_S)
    finally:
        stop_tp_ranks(procs)
    for name, ps in procs.items():
        for r, (p, _) in enumerate(ps):
            if p.returncode != 0:
                raise AssertionError(f"tp {name} rank {r}: "
                                     f"{errs[name, r][-3000:]}")
    return {name: [path for _, path in ps] for name, ps in procs.items()}


def tp_model1(torch, dev, model: dict, launches_of, profile: bool) -> tuple:
    """``model`` at (data 1, model 1) in this process: through the
    kernels (with a profiled step when ``profile``), then from the init
    nudged by one ulp (the rounding control); with ``model["zero"]`` the
    ZeRO variant the same two ways (no kernel: its mask is the
    reference's multiply); the kernel run's FLOPs of one more step
    (``FlopCounterMode``) for the dry-run. A ``TP_SERVE_ARCHS`` model is
    then served (``tp_serve``) from the init and from the nudged init.
    Returns (its part of the line, the kernel run's params, the ZeRO
    run's or ``None``, the launches of every run, the served logits or
    ``None``)."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import frac_schedule
    from repro_torch.models import build
    from repro_torch.optim import sgd_momentum
    from repro_torch.tree import tree_leaves

    cfg = tp_config(model)
    api = build(cfg)
    mesh = make_host_mesh(1, 1)
    n_leaves = len(tree_leaves(api.init(None, device="meta")))
    batches = tp_batches(model)
    part, kept, launches = {}, {}, []
    variants = ["psum"] + (["zero"] if model.get("zero") else [])
    for variant in variants:
        base = "cuda" if variant == "psum" else "zero"
        for label, nudge in ((base, 0), (f"{base}_nudged", 1)):
            params = tp_init(torch, api, dev)
            if nudge:
                params = nudged(torch, params, 2)
            r = tp_train(torch, api, sgd_momentum(), mesh, params, "cuda",
                         batches, frac_schedule(0.001, 1), model["lr"],
                         profile=(profile and not nudge
                                  and variant == "psum"),
                         variant=variant, flops=label == "cuda")
            del params
            per_step = n_leaves if variant == "psum" else 0
            if r["launches"] != launches_of(dropfill=per_step
                                            * model["steps"]):
                raise AssertionError(f"tp (1, 1) {cfg.name} {label}: "
                                     f"launches {r['launches']}")
            launches.append(r["launches"])
            if "profile_step" in r:
                prof = r["profile_step"]
                gate = {k: v for k, v in prof["port_kernels_ms"].items()
                        if "dropfill" in k}
                n_gate = sum(n for k, n in prof["port_launches"].items()
                             if "dropfill" in k)
                if n_gate != n_leaves or len(prof["port_launches"]) != len(
                        gate):
                    raise AssertionError(f"tp (1, 1) {cfg.name} profile: "
                                         f"port launches "
                                         f"{prof['port_launches']}")
                prof["gate_device_ms"] = sum(gate.values())
            kept[label] = r.pop("params")
            part[f"model1_{label}"] = r
        sfx = "" if variant == "psum" else "_zero"
        part[f"rounding_control_max_abs_diff{sfx}"] = distance(
            kept[base], kept.pop(f"{base}_nudged"))
    served = None
    if model["arch"] in TP_SERVE_ARCHS:
        runs = {nudge: tp_serve(torch, api, mesh, lambda nudge=nudge: (
            nudged(torch, tp_init(torch, api, dev), 2) if nudge
            else tp_init(torch, api, dev)), dev) for nudge in (0, 1)}
        served = runs[0].pop("logits")
        part["serve_model1"] = runs[0]
        rows = serve_rows(served, runs[1].pop("logits"))
        part["serve_rounding_control"] = {
            "max_abs_diff": rows.max().item(),
            "median_row_max_abs_diff": rows.median().item()}
    return part, kept["cuda"], kept.get("zero"), launches, served


def check_tp_rank_run(label, a, one, expect_launches) -> None:
    """A (1, 2) rank's run ``a`` against its (1, 1) twin ``one`` (over
    ``a``'s steps, which may be fewer): the launches, the delivered
    fractions equal and the losses within rtol 1e-3."""
    if a["launches"] != expect_launches:
        raise AssertionError(f"{label}: launches {a['launches']}, expected "
                             f"{expect_launches}")
    if (a["delivered"] != one["delivered"][:len(a["delivered"])] or any(
            abs(x - y) > 1e-3 * abs(y) for x, y in zip(a["loss"],
                                                       one["loss"]))):
        raise AssertionError(f"{label}: losses {a['loss']} vs {one['loss']}"
                             f", delivered {a['delivered']} vs "
                             f"{one['delivered']}")


def run_tp_phase(torch, timer, launches_of, ws1, *, device="cuda") -> tuple:
    """Tensor parallelism over ``model`` and data parallelism inside a
    worker (the ``tp`` line).

    Full width (``TP_MODELS``): one Mixtral-8x22b layer (bfloat16,
    2,906,720,256 parameters) and one DeepSeek-V2 layer (its dense lead
    layer, MLA, 1,386,562,560), batch 32 x seq 128; falcon-mamba at 2
    layers, zamba2 at 7, whisper-small at 6 encoder and 6 decoder
    layers, papernet whole, batch 8 (papernet 128 images). SGD-momentum
    at lr 3e-4, the launcher's delivered fraction at loss rate 0.001
    (0.99), psum paper, 2 steps,
    init from a generator on the card seeded 0. First each at (data 1,
    model 1) in this process (world size 1,
    ``launch.train.init_distributed``) through the kernels, then the
    same from the init nudged by one ulp (the rounding control), and the
    first run's params saved (Mixtral's step profiled); DeepSeek's ZeRO
    variant the same two ways. Then two gloo ranks on (data 1, model 2)
    sharing the card take the models in turn (``tp_full_rank``): each
    through the kernels, Mixtral and DeepSeek then on the plain route (over
    ``plain_steps``), DeepSeek with the ZeRO variant; then the same two
    ranks on (pod 1, data 2, model 1) train the sharded phase's smollm-360m
    (``TP_DP_MODEL``) from its init, held against that phase's world-size-1
    run (``ws1``: its params after step 2, its losses and delivered
    fractions to there, and its rounding control), then the same
    smollm-360m with FSDP over ``data`` on (data 2, model 1)
    (``TP_FSDP_MODEL``: the plain step, SGD-momentum, 3 steps), held
    against the plain step at world size 1 from the same init and batches,
    which this process runs after the (1, 1) runs with its rounding
    control (``tp_fsdp_ws1``). Meanwhile four gloo
    ranks run ``TP_REDUCED_RUNS`` on the card, and four more on the CPU
    twice, from the init and from it nudged (``tp_reduced_rank``).

    Checks: the gate's kernel launched once a leaf a step on each kernel
    rank and on the (1, 1) runs, no other kernel, none on the plain route
    or by the ZeRO variant; kernels against plain and (1, 2) against
    (1, 1) within twice the model's rounding control (ZeRO's own), the
    delivered fractions equal and the losses within rtol 1e-3; step 1
    within four spreads of ``tp_expected_loss``; the ranks' gathered
    global params equal (one digest); the ``model`` axis's collectives
    there where a leaf is split (the SSM families' all-to-all too), none
    for papernet; the (pod 1, data 2) run the same against ``ws1``, its
    gate once a leaf a step a rank and its gradients all-reduced over
    ``data``; the FSDP run's params within twice its world-size-1 twin's
    rounding control, its losses within rtol 1e-3, no kernel launched,
    its weights all-gathered and its gradients reduce-scattered over
    ``data``, a rank's params, gradients and momentum at most 0.55 of
    world size 1's; the REDUCED
    CUDA ranks against the CPU ranks within twice the CPU rounding
    control, every rank of a run holding the same global params. Then
    the gate (``sharded_gate_rows``) at Mixtral's and DeepSeek's layer's
    largest leaf and over its leaves, held against its plain version and
    timed. Returns (the line, the launches of the kernel runs, the gate
    rows by architecture, the gate launches by architecture)."""
    import tempfile

    import numpy as np
    import torch.distributed as dist

    from repro_torch.launch.train import init_distributed
    from repro_torch.models import build
    from repro_torch.models.sharding import model_dim, spec_at
    from repro_torch.models.ssm import tp_splits
    from repro_torch.tree import tree_leaves, tree_leaves_with_path
    from repro_torch.train.trainer import model_layout

    models = TP_MODELS
    line = {"collectives": "gloo, the tensors' own dtypes (bf16 "
                           "activations and gradient blocks; f32 combined "
                           "MoE output and Mamba statistics)",
            "optimizer": "sgdm", "variant": "psum, paper", "runs": {}}
    launches, by_model = [], {}
    procs = {}
    deterministic = torch.backends.cudnn.deterministic
    # papernet's convolutions: the same sums on every rank and run
    torch.backends.cudnn.deterministic = True
    with tempfile.TemporaryDirectory() as tmp:
        for m in models:
            m["one"] = f"{tmp}/one_{m['arch']}.pt"
            if m.get("zero"):
                m["one_zero"] = f"{tmp}/one_zero_{m['arch']}.pt"
            if m["arch"] in TP_SERVE_ARCHS:
                m["serve_one"] = f"{tmp}/serve_one_{m['arch']}.pt"
        dp = dict(TP_DP_MODEL, ws1=f"{tmp}/ws1.pt")
        torch.save(ws1["params"], dp["ws1"] + ".part")
        os.replace(dp["ws1"] + ".part", dp["ws1"])
        fsdp = dict(TP_FSDP_MODEL, ws1=f"{tmp}/fsdp_ws1.pt")
        try:
            # the REDUCED ranks first: they take the CPU while this
            # process takes the card
            t0 = time.perf_counter()
            for name, dev_r, nudge in (("reduced_cuda", device, 0),
                                       ("reduced_cpu", "cpu", 0),
                                       ("reduced_cpu_nudged", "cpu", 1)):
                procs[name] = start_tp_ranks(4, {"kind": "reduced",
                                                 "device": dev_r,
                                                 "nudge": nudge}, tmp, name)
            # and the (1, 2) ranks, which wait for the (1, 1) runs' params
            procs["full"] = start_tp_ranks(2, {
                "kind": "full", "device": device, "models": models,
                "dp": dp, "fsdp": fsdp}, tmp, "full")
            gc.collect()
            torch.cuda.empty_cache()
            dev, tmp_pg = init_distributed(
                "cuda:0" if device == "cuda" else device)
            try:
                for m in models:
                    t1 = time.perf_counter()
                    part, one, one_zero, ls_, served = tp_model1(
                        torch, dev, m, launches_of, m is TP_MODEL)
                    launches += ls_
                    by_model[m["arch"]] = sum(x["dropfill"] for x in ls_)
                    line["runs"][m["arch"]] = part
                    for key, p in (("one", one), ("one_zero", one_zero)):
                        if p is not None:
                            torch.save([x.cpu() for x in tree_leaves(p)],
                                       m[key] + ".part")
                    if served is not None:
                        torch.save(served, m["serve_one"] + ".part")
                    del one, one_zero, served
                    gc.collect()
                    torch.cuda.empty_cache()
                    part["model1_seconds"] = time.perf_counter() - t1
                # the FSDP run's twin: the plain step at world size 1
                t1 = time.perf_counter()
                fsdp_one, kept = tp_fsdp_ws1(torch, dev)
                torch.save(kept, fsdp["ws1"] + ".part")
                del kept
                gc.collect()
                torch.cuda.empty_cache()
                fsdp_one["seconds"] = time.perf_counter() - t1
            finally:
                dist.destroy_process_group()
                if tmp_pg is not None:
                    tmp_pg.cleanup()
            gc.collect()
            torch.cuda.empty_cache()
            # the card is free: the (1, 2) ranks start training
            for m in models:
                for key in ("one", "one_zero", "serve_one"):
                    if key in m:
                        os.replace(m[key] + ".part", m[key])
            os.replace(fsdp["ws1"] + ".part", fsdp["ws1"])
            t1 = time.perf_counter()
            line["model1_seconds"] = t1 - t0
            outs = finish_tp_ranks(procs)
            line["model2_seconds"] = time.perf_counter() - t1
            line["children_seconds"] = time.perf_counter() - t0
        finally:
            stop_tp_ranks(procs)
            torch.backends.cudnn.deterministic = deterministic
            for m in models:
                m.pop("one")
                m.pop("one_zero", None)
                m.pop("serve_one", None)
        full = []
        for path in outs["full"]:
            with open(path) as f:
                full.append(json.load(f))
        reduced = {name: [dict(np.load(p)) for p in outs[name]]
                   for name in outs if name != "full"}

    # the checks; a failure carries the line so far
    try:
        # the full-width (1, 2) runs
        gate_shapes = {}
        for m in models:
            arch, steps = m["arch"], m["steps"]
            cfg = tp_config(m)
            api = build(cfg)
            shapes = api.init(None, device="meta")
            n_pkts = [max(1, -(-x.numel() // 360))
                      for x in tree_leaves(shapes)]
            gate_shapes[arch] = [(n, 360) for n in n_pkts]
            specs = model_layout(api, {"model": 2})
            split = any(model_dim(spec_at(specs, p)) is not None
                        for p, _ in tree_leaves_with_path(shapes))
            a2a = tp_splits(cfg, 2)
            part = line["runs"][arch]
            part.update({"config": {k: getattr(cfg, k) for k in (
                "name", "family", "n_layers", "d_model", "n_heads", "n_kv",
                "d_ff", "n_experts", "vocab", "dtype")},
                "n_params": sum(x.numel() for x in tree_leaves(shapes)),
                **{k: m[k] for k in ("steps", "batch", "seq", "lr",
                                     "data_vocab", "routes", "plain_steps")},
                "zero": bool(m.get("zero"))})
            one = part["model1_cuda"]
            ctl = part["rounding_control_max_abs_diff"]
            want = launches_of(dropfill=len(n_pkts) * steps)
            ranks = [rk["models"][arch] for rk in full]
            for r, rk in enumerate(ranks):
                runs = [(route, one,
                         want if route == "cuda" else launches_of())
                        for route in m["routes"]]
                if m.get("zero"):
                    runs.append(("zero", part["model1_zero"], launches_of()))
                for route, twin, expect in runs:
                    a = rk[route]
                    check_tp_rank_run(f"tp (1, 2) {arch} rank {r} {route}", a,
                                      twin, expect)
                    calls = a["model_collectives"]["calls_per_step"]
                    if split:
                        ok = (calls["all_reduce"] > 0
                              and calls["all_gather_into_tensor"] > 0
                              and (calls["all_to_all_single"] > 0) == a2a)
                    else:
                        ok = not any(calls.values())
                    if not ok:
                        raise AssertionError(f"tp (1, 2) {arch} rank {r}: "
                                             f"model-axis collectives "
                                             f"{a['model_collectives']}")
                launches.append(rk["cuda"]["launches"])
                by_model[arch] += rk["cuda"]["launches"]["dropfill"]
            for sfx in ("", "_zero") if m.get("zero") else ("",):
                if len({rk[f"digest{sfx}"] for rk in ranks}) != 1:
                    raise AssertionError(f"tp (1, 2) {arch}{sfx}: the ranks' "
                                         f"gathered params differ")
            loss = one["loss"]
            expect, spread = tp_expected_loss(cfg, tp_batches(m)[0]["labels"])
            if not (all(math.isfinite(x) for x in loss)
                    and abs(loss[0] - expect) < (4 * spread or 1.0)):
                raise AssertionError(f"tp {arch}: losses {loss}, step 1 "
                                     f"expected {expect} within four spreads "
                                     f"of {spread} (papernet 1.0)")
            d_one = max(rk["d_one_rank"] for rk in ranks)
            d_routes = max((rk["d_kernel_plain"] for rk in ranks
                            if "d_kernel_plain" in rk), default=0.0)
            if not (d_routes <= 2 * ctl and d_one <= 2 * ctl):
                raise AssertionError(f"tp {arch}: kernels vs plain "
                                     f"{d_routes:.4e}, (1, 2) vs (1, 1) "
                                     f"{d_one:.4e}, over twice the rounding "
                                     f"control's {ctl:.4e}")
            part["model2"] = {"mesh": {"data": 1, "model": 2}, "world_size": 2,
                              "backend": "gloo", "ranks": ranks}
            part["rounding"] = {"kernel_vs_plain_max_abs_diff": d_routes,
                                "model2_vs_model1_max_abs_diff": d_one,
                                "rounding_control_max_abs_diff": ctl}
            if m.get("zero"):
                ctl_z = part["rounding_control_max_abs_diff_zero"]
                d_zero = max(rk["d_one_rank_zero"] for rk in ranks)
                if not d_zero <= 2 * ctl_z:
                    raise AssertionError(f"tp {arch} ZeRO: (1, 2) vs (1, 1) "
                                         f"{d_zero:.4e}, over twice the "
                                         f"rounding control's {ctl_z:.4e}")
                part["rounding"].update(
                    zero_model2_vs_model1_max_abs_diff=d_zero,
                    zero_rounding_control_max_abs_diff=ctl_z)
            if arch in TP_SERVE_ARCHS:
                ctl_s = part.pop("serve_rounding_control")
                served = [rk["serve"] for rk in ranks]
                d_serve = max(x["vs_model1_max_abs_diff"] for x in served)
                rows = torch.tensor([x.pop("vs_model1_rows")
                                     for x in served]).amax(0)
                within = rows <= 2 * ctl_s["median_row_max_abs_diff"]
                share = {"prefill": within[0].float().mean().item(),
                         "decode": within[1:].float().mean().item()}
                calls = [x["decode_collectives_per_token"][
                    "model_collectives"]["calls_per_step"] for x in served]
                if not (d_serve <= 2 * ctl_s["max_abs_diff"]
                        and min(share.values()) >= SERVE_ROW_SHARE
                        and all(c["all_reduce"] > 0 for c in calls)):
                    raise AssertionError(
                        f"tp serve {arch}: (1, 2) vs (1, 1) logits "
                        f"{d_serve:.4e} (twice the rounding control's "
                        f"{ctl_s['max_abs_diff']:.4e}), rows within twice "
                        f"its median row's {share} (at least "
                        f"{SERVE_ROW_SHARE}); decode collectives {calls}")
                part["serve"] = {
                    **TP_SERVE, "model1": part.pop("serve_model1"),
                    "model2_ranks": served,
                    "logits_model2_vs_model1_max_abs_diff": d_serve,
                    "logits_rounding_control_max_abs_diff":
                        ctl_s["max_abs_diff"],
                    "logits_rounding_control_median_row":
                        ctl_s["median_row_max_abs_diff"],
                    "rows_within_twice_median_row": share,
                    "model2_vs_model1_median_row": rows.median().item()}
            part["ln_vocab"], part["loss_step1_expected"] = \
                math.log(cfg.vocab), expect
            part["loss_step1_spread"] = spread
            if spread:
                part["loss_step1_gap_in_spreads"] = (loss[0] - expect) / spread
        line["warm_s"] = [rk["warm_s"] for rk in full]

        # data parallelism inside a worker: (pod 1, data 2) against the
        # world-size-1 run
        dps = [rk["dp"] for rk in full]
        n_dp = len(tree_leaves(build(tp_config(TP_DP_MODEL)).init(
            None, device="meta")))
        twin = {"loss": ws1["loss"], "delivered": ws1["delivered"]}
        for r, a in enumerate(dps):
            check_tp_rank_run(f"tp (pod 1, data 2) rank {r}", a, twin,
                              launches_of(
                                  dropfill=n_dp * TP_DP_MODEL["steps"]))
            calls = a["data_collectives"]["calls_per_step"]
            if not calls["all_reduce"] >= n_dp:
                raise AssertionError(f"tp (pod 1, data 2) rank {r}: data-axis "
                                     f"collectives {a['data_collectives']}")
            launches.append(a["launches"])
        if len({a["digest"] for a in dps}) != 1:
            raise AssertionError("tp (pod 1, data 2): the ranks' params "
                                 "differ")
        d_dp = max(a["d_ws1"] for a in dps)
        if not d_dp <= 2 * ws1["control"]:
            raise AssertionError(f"tp (pod 1, data 2) vs world size 1: "
                                 f"{d_dp:.4e}, over twice the rounding "
                                 f"control's {ws1['control']:.4e}")
        line["data_parallel"] = {
            "config": f"{TP_DP_MODEL['arch']} CONFIG, float32, 32 layers",
            "optimizer": "adamw", "variant": "psum, paper",
            **{k: TP_DP_MODEL[k] for k in ("steps", "batch", "seq", "lr")},
            "ranks": dps, "ws1_loss": ws1["loss"],
            "rounding": {"vs_world_size_1_max_abs_diff": d_dp,
                         "rounding_control_max_abs_diff": ws1["control"]}}
        by_model["smollm_360m_data2"] = sum(a["launches"]["dropfill"]
                                            for a in dps)

        # FSDP over data in the plain step: (data 2, model 1) against the
        # plain step at world size 1
        fs = [rk["fsdp"] for rk in full]
        one_gb = sum(fsdp_one["state_gb"].values())
        for r, a in enumerate(fs):
            calls = a["data_collectives"]["calls_per_step"]
            share = sum(a["state_gb"].values()) / one_gb
            if not (a["launches"] == launches_of()
                    and calls["all_gather_into_tensor"] > 0
                    and calls["reduce_scatter_tensor"] > 0
                    and share <= 0.55
                    and all(math.isfinite(x) for x in a["loss"])
                    and all(abs(x - y) <= 1e-3 * abs(y) for x, y in zip(
                        a["loss"], fsdp_one["loss"]))):
                raise AssertionError(
                    f"tp fsdp (data 2) rank {r}: launches {a['launches']}, "
                    f"data collectives {a['data_collectives']}, state "
                    f"{a['state_gb']} GB ({share:.3f} of world size 1's), "
                    f"losses {a['loss']} vs {fsdp_one['loss']}")
        if len({a["digest"] for a in fs}) != 1:
            raise AssertionError("tp fsdp (data 2): the ranks' gathered "
                                 "params differ")
        d_fs = max(a["d_ws1"] for a in fs)
        ctl_fs = fsdp_one["rounding_control_max_abs_diff"]
        if not d_fs <= 2 * ctl_fs:
            raise AssertionError(f"tp fsdp (data 2) vs world size 1: "
                                 f"{d_fs:.4e}, over twice the rounding "
                                 f"control's {ctl_fs:.4e}")
        line["fsdp"] = {
            "config": f"{TP_FSDP_MODEL['arch']} CONFIG, float32, 32 layers",
            "step": "make_plain_train_step, init_state(fsdp=True)",
            **{k: TP_FSDP_MODEL[k] for k in ("steps", "batch", "seq", "lr",
                                             "optimizer")},
            "mesh": {"data": 2, "model": 1}, "world_size": 2,
            "backend": "gloo", "ranks": fs, "world_size_1": fsdp_one,
            "state_share_of_world_size_1": [
                sum(a["state_gb"].values()) / one_gb for a in fs],
            "rounding": {"vs_world_size_1_max_abs_diff": d_fs,
                         "rounding_control_max_abs_diff": ctl_fs}}

        # the REDUCED runs: the card against the CPU
        red = {"meshes": {"": {"data": 2, "model": 2},
                          "zero/": {"data": 2, "model": 2},
                          "pd/": {"pod": 2, "data": 2, "model": 1,
                                  "worker_axes": ["pod"]}},
               "world_size": 4, "steps": SHARDED_GLOO_STEPS,
               "global_batch": [SHARDED_GLOO_BATCH, SHARDED_GLOO_SEQ],
               "frac": list(SHARDED_GLOO_FRAC), "optimizer": "sgdm lr 0.1",
               "configs": {}}
        n_red = 0
        for label, arch, variant, _, _ in TP_REDUCED_RUNS:
            n = sum(1 for k in reduced["reduced_cuda"][0]
                    if k.startswith(f"{label}/params/"))
            for name, ranks in reduced.items():
                for rk in ranks[1:]:
                    for i in range(n):
                        if not np.array_equal(rk[f"{label}/params/{i}"],
                                              ranks[0][f"{label}/params/{i}"]):
                            raise AssertionError(f"tp {name} {label}: the "
                                                 f"ranks' params differ at "
                                                 f"leaf {i}")
            per_rank = {name: [int(rk[f"{label}/launches"]) for rk in ranks]
                        for name, ranks in reduced.items()}
            others = [int(rk[f"{label}/other_launches"])
                      for ranks in reduced.values() for rk in ranks]
            want_n = launches_of(dropfill=n * SHARDED_GLOO_STEPS
                                 if variant == "psum" else 0)["dropfill"]
            if per_rank != {"reduced_cuda": [want_n] * 4,
                            "reduced_cpu": [0] * 4,
                            "reduced_cpu_nudged": [0] * 4} or any(others):
                raise AssertionError(f"tp reduced {label}: gate launches "
                                     f"{per_rank}, others {others}")
            launches.append(launches_of(dropfill=4 * want_n))
            n_red += 4 * want_n
            cuda, cpu, ctl_r = (reduced[k][0] for k in (
                "reduced_cuda", "reduced_cpu", "reduced_cpu_nudged"))

            def tensors(d, label=label, n=n):
                return [torch.as_tensor(d[f"{label}/params/{i}"])
                        for i in range(n)]

            held = within_rounding(f"tp reduced {label} cuda vs cpu",
                                   tensors(cuda), tensors(cpu), tensors(ctl_r))
            if not (np.allclose(cuda[f"{label}/loss"], cpu[f"{label}/loss"],
                                rtol=1e-4) and np.array_equal(
                        cuda[f"{label}/delivered"],
                        cpu[f"{label}/delivered"])):
                raise AssertionError(f"tp reduced {label}: cuda "
                                     f"{cuda[f'{label}/loss']} "
                                     f"{cuda[f'{label}/delivered']}, cpu "
                                     f"{cpu[f'{label}/loss']} "
                                     f"{cpu[f'{label}/delivered']}")
            red["configs"][label] = {
                "launches_per_rank": per_rank,
                "loss_cuda": cuda[f"{label}/loss"].tolist(),
                "loss_cpu": cpu[f"{label}/loss"].tolist(),
                "delivered": cuda[f"{label}/delivered"].tolist(),
                "seconds": {name: [float(rk[f"{label}/seconds"])
                                   for rk in ranks]
                            for name, ranks in reduced.items()}, **held}
        line["reduced"] = red
        line["launches_by_model"] = dict(by_model, reduced=n_red)
    except AssertionError as e:
        e.add_note("tp line so far: " + json.dumps(line))
        raise
    rows = {}
    for arch in ("mixtral_8x22b", "deepseek_v2_236b"):
        gc.collect()
        torch.cuda.empty_cache()
        rows[arch] = sharded_gate_rows(torch, timer, gate_shapes[arch])
    line["gate_rows"] = rows
    return line, launches, rows, by_model


# the dry-run's single-pod production rows: one architecture a family,
# its train_4k LTP step (psum) and its decode_32k step; falcon-mamba's
# train row traces 4,096 scan steps a layer, so it runs in a process of
# its own, and both run in the background from the tp phase's start
DRYRUN_ARCHS = {"dense": "smollm_360m", "vlm": "qwen2_vl_72b",
                "moe": "deepseek_v2_236b", "ssm": "falcon_mamba_7b",
                "hybrid": "zamba2_7b", "audio": "whisper_small"}
DRYRUN_ROWS = [(arch, shape, shape == "train_4k")
               for arch in DRYRUN_ARCHS.values()
               for shape in ("train_4k", "decode_32k")] + [
    # the plain step, its weights split over data (FSDP)
    ("deepseek_v2_236b", "train_4k", False)]
DRYRUN_TOL = {"flops": 1e-3, "peak": 0.15}


def dryrun_rows_child(argv) -> int:
    """``chip_smoke.py --dryrun-rows OUT ARCH...``: the dry-run's
    ``DRYRUN_ROWS`` of each ARCH on the single-pod mesh, one JSON record
    a line to OUT (on ``meta`` tensors: the card is not touched)."""
    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch.launch import dryrun

    out, archs = argv[0], argv[1:]
    with open(out, "w") as f:
        for arch, shape, ltp in DRYRUN_ROWS:
            if arch in archs:
                rec = dryrun.run_one(arch, shape, ltp=ltp)
                f.write(json.dumps(rec, default=str) + "\n")
                f.flush()
    return 0


def start_dryrun_rows(tmp: str) -> list:
    """The production rows' two background processes (falcon-mamba's
    alone); [(process, out path)]."""
    groups = [["falcon_mamba_7b"],
              [a for a in DRYRUN_ARCHS.values() if a != "falcon_mamba_7b"]]
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    procs = []
    for i, archs in enumerate(groups):
        path = os.path.join(tmp, f"dryrun_rows{i}.jsonl")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--dryrun-rows",
             path, *archs], stdout=subprocess.DEVNULL,
            stderr=subprocess.PIPE, text=True, env=env), path))
    return procs


def _model_axis(rec: dict, axis: str = "model") -> dict:
    """A dry-run record's ``axis`` collectives as
    ``{"calls_per_step", "bytes_per_step"}`` over ``CollectiveCounter``'s
    kinds (any other kind counted there fails the comparison)."""
    by = rec["cost"]["by_axis"].get(axis, {})
    extra = set(by) - set(CollectiveCounter.INPUT_ARG)
    if extra:
        raise AssertionError(f"dryrun: {axis}-axis collectives {extra} "
                             f"that the ranks do not count")
    return {"calls_per_step": {k: by.get(k, {}).get("calls", 0)
                               for k in CollectiveCounter.INPUT_ARG},
            "bytes_per_step": {k: by.get(k, {}).get("bytes", 0)
                               for k in CollectiveCounter.INPUT_ARG}}


def run_dryrun_phase(torch, tp_line: dict, rows_procs: list) -> dict:
    """The dry-run (``launch.dryrun``, ``meta`` tensors under a fake
    process group in this process) of the configurations the ``tp`` phase
    ran, held against what its processes counted: for Mixtral's and
    DeepSeek's layers on (1, 2), the psum LTP step (and DeepSeek's ZeRO
    step), the prefill and a decode token; the model axis's collective
    calls and bytes per step per rank equal to the ranks'
    ``CollectiveCounter``, the gate's operator calls equal to the ranks'
    launches a step, the predicted peak within 15 % of the measured
    ``peak_memory_gb`` less what the card held beside the run
    (``other_allocated_gb``); and the (1, 1) step's FLOPs within 0.1 % of what
    ``FlopCounterMode`` counted around one real (1, 1) step. The FSDP
    plain step of smollm-360m on (data 2, model 1) likewise: its ``data``
    collectives equal to rank 0's and its peak within 15 %. Then the
    production rows (``DRYRUN_ROWS``) from the background processes,
    every one OK and the plain train rows split over ``data``
    (``"fsdp": true``)."""
    from repro_torch.launch import dryrun
    from repro_torch.shapes import InputShape

    line = {"device": dryrun.DEVICE, "tolerance": DRYRUN_TOL, "configs": {}}
    mesh12 = ((1, 2), ("data", "model"))
    t0 = time.perf_counter()
    for m in TP_MODELS:
        arch = m["arch"]
        if arch not in TP_SERVE_ARCHS:
            continue
        cfg = tp_config(m)
        part = tp_line["runs"][arch]
        rank0 = part["model2"]["ranks"][0]
        train = InputShape("tp_train", m["seq"], m["batch"], "train")
        n, ns = TP_SERVE["prompt"], TP_SERVE["new"]
        shapes = {"train": train,
                  "prefill": InputShape("tp_prefill", n, TP_SERVE["batch"],
                                        "prefill"),
                  "decode": InputShape("tp_decode", n + ns,
                                       TP_SERVE["batch"], "decode")}
        cases = [("psum", "train", rank0["cuda"], False),
                 ("prefill", "prefill", rank0["serve"], False),
                 ("decode", "decode", rank0["serve"], False)]
        if m.get("zero"):
            cases.insert(1, ("zero", "train", rank0["zero"], True))
        out = {}
        for label, kind, got, zero in cases:
            rec = dryrun.run_one(arch, shapes[kind].name, cfg=cfg,
                                 shape=shapes[kind], mesh_shape=mesh12,
                                 ltp=kind == "train", zero=zero)
            if not rec["ok"]:
                raise AssertionError(f"dryrun {arch} {label}: "
                                     f"{rec['error']}\n{rec['traceback']}")
            pred = _model_axis(rec)
            # the measured peak less what the card held beside the run
            peak = got["peak_memory_gb"] - got["other_allocated_gb"]
            if kind == "train":
                meas = got["model_collectives"]
                launches = got["launches"]["dropfill"] / m["steps"]
            elif kind == "prefill":
                meas = got["prefill_collectives"]["model_collectives"]
                launches = 0
            else:
                meas = got["decode_collectives_per_token"][
                    "model_collectives"]
                launches = 0
            gate = rec["cost"]["kernels"].get("dropfill_into", {}).get(
                "calls", 0)
            pred_peak = rec["memory"]["peak"] / 1e9
            row = {"predicted_collectives": pred,
                   "measured_collectives": meas,
                   "predicted_gate_calls_per_step": gate,
                   "measured_gate_launches_per_step": launches,
                   "predicted_peak_gb": pred_peak, "measured_peak_gb": peak,
                   "flops": rec["cost"]["flops"],
                   "bytes": rec["cost"]["bytes"],
                   "roofline": rec["roofline"], "lower_s": rec["lower_s"]}
            out[label] = row
            if pred != meas or gate != launches:
                raise AssertionError(f"dryrun {arch} {label}: {row}")
            # the serve's measured peak covers the prefill, the cache's
            # copy into the decode cache and the decode steps: the larger
            # of the prefill's and a decode step's predicted peaks
            if kind == "prefill":
                continue
            if kind == "decode":
                pred_peak = max(pred_peak, out["prefill"]["predicted_peak_gb"])
                row["predicted_peak_gb_serve"] = pred_peak
            if abs(pred_peak - peak) > DRYRUN_TOL["peak"] * peak:
                raise AssertionError(f"dryrun {arch} {label}: peak "
                                     f"{pred_peak:.3f} GB predicted, "
                                     f"{peak:.3f} measured")
        rec = dryrun.run_one(arch, "tp_train", cfg=cfg, shape=train,
                             mesh_shape=((1, 1), ("data", "model")),
                             ltp=True)
        meas = part["model1_cuda"]["flops_step"]
        out["model1_flops"] = {"predicted": rec["cost"]["flops"],
                               "measured": meas}
        if abs(rec["cost"]["flops"] - meas) > DRYRUN_TOL["flops"] * meas:
            raise AssertionError(f"dryrun {arch} (1, 1) FLOPs: "
                                 f"{out['model1_flops']}")
        line["configs"][arch] = out
    # the plain step with FSDP over data on (data 2, model 1), against
    # the tp phase's FSDP ranks (rank 0)
    m = TP_FSDP_MODEL
    got = tp_line["fsdp"]["ranks"][0]
    shape = InputShape("tp_fsdp_train", m["seq"], m["batch"], "train")
    rec = dryrun.run_one(m["arch"], shape.name, cfg=tp_config(m),
                         shape=shape,
                         mesh_shape=((2, 1), ("data", "model")))
    if not rec["ok"]:
        raise AssertionError(f"dryrun {m['arch']} fsdp: {rec['error']}\n"
                             f"{rec['traceback']}")
    pred, meas = _model_axis(rec, "data"), got["data_collectives"]
    peak = got["peak_memory_gb"] - got["other_allocated_gb"]
    row = {"fsdp": rec["fsdp"], "predicted_collectives": pred,
           "measured_collectives": meas,
           "predicted_peak_gb": rec["memory"]["peak"] / 1e9,
           "measured_peak_gb": peak,
           "predicted_state_gb": {k: rec["memory"][k] / 1e9 for k in (
               "params", "grads", "optimizer_state")},
           "measured_state_gb": got["state_gb"],
           "flops": rec["cost"]["flops"], "bytes": rec["cost"]["bytes"],
           "roofline": rec["roofline"], "lower_s": rec["lower_s"]}
    line["configs"][f"{m['arch']}_fsdp"] = row
    if not (rec["fsdp"] and pred == meas and abs(
            row["predicted_peak_gb"] - peak) <= DRYRUN_TOL["peak"] * peak):
        raise AssertionError(f"dryrun {m['arch']} fsdp: {row}")
    line["configs_seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rows = []
    for p, path in rows_procs:
        _, err = p.communicate(timeout=TP_CHILD_TIMEOUT_S)
        if p.returncode != 0:
            raise AssertionError(f"dryrun rows: {err[-3000:]}")
        with open(path) as f:
            rows += [json.loads(x) for x in f]
    line["rows_wait_seconds"] = time.perf_counter() - t0
    line["rows"] = [{k: r.get(k) for k in (
        "arch", "shape", "mesh", "step", "ltp", "fsdp", "ok", "skipped",
        "error", "lower_s", "roofline")} | {
        "flops": r.get("cost", {}).get("flops"),
        "collective_bytes": r.get("cost", {}).get("collective_bytes"),
        "params_gb": r.get("memory", {}).get("params", 0) / 1e9,
        "peak_gb": r.get("memory", {}).get("peak", 0) / 1e9} for r in rows]
    # the plain train step splits its weights over data; the LTP steps
    # and the serve keep them whole there
    bad = [r for r in rows if not r["ok"] or "skipped" in r or r["fsdp"]
           != (r["step"] == "train_step" and not r["ltp"])]
    if bad or len(rows) != len(DRYRUN_ROWS):
        raise AssertionError(f"dryrun rows: {len(rows)} of "
                             f"{len(DRYRUN_ROWS)}, failed {bad}")
    return line


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        return fail("no CUDA device is available")
    src = os.path.join(HERE, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        return fail(f"the port's package is not at {src}/repro_torch")
    sys.path.insert(0, src)

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
    # each phase's wall seconds, in its own line and in the phases line
    phases = {}
    t_start = time.perf_counter()
    # the dry-run's production rows, on the host in the background from
    # the tp phase's start (run_phases)
    import tempfile

    rows_tmp = tempfile.TemporaryDirectory()
    rows_procs = []
    try:
        return run_phases(torch, phases, t_start, rows_tmp.name, rows_procs)
    finally:
        for p, _ in rows_procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        rows_tmp.cleanup()


def run_phases(torch, phases: dict, t_start: float, rows_dir: str,
               rows_procs: list) -> int:
    """Every phase in turn, then the kernels, phases and result lines;
    the dry-run's production rows start with the ``tp`` phase, writing
    to ``rows_dir``, their processes appended to ``rows_procs``."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import dropfill as df_mod
    from repro_torch.kernels import packet_reduce as pr_mod
    from repro_torch.kernels import randomk as rk_mod

    t0 = t_start

    def emit(name: str, line: dict, since: float) -> float:
        """Prints the phase line ``name`` with its ``seconds`` since
        ``since``; returns the clock for the next phase."""
        now = time.perf_counter()
        line["seconds"] = phases[name] = now - since
        print(f"{name} " + json.dumps(line))
        return now

    _build.load()
    nvcc = ("cached, no nvcc run" if _build.BUILD_SECONDS is None
            else f"nvcc {_build.BUILD_SECONDS:.2f} s")
    phases["build"] = time.perf_counter() - t0
    print(f"kernel build: {phases['build']:.2f} s ({nvcc})")
    print(_build.BUILD_LOG.strip(), file=sys.stderr)

    timer = Timer(torch)
    t0 = time.perf_counter()
    checks, entries = check_kernels(torch, timer)
    t0 = emit("kernel_checks", {"checks": checks}, t0)
    tree_checks, tree_timed, tree_check_launches = check_tree_reduce(
        torch, timer)
    print("tree_reduce_checks " + json.dumps(tree_checks))
    t0 = emit("tree_reduce", tree_timed, t0)

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
        now = time.perf_counter()
        phases[f"main path {label}"] = now - t0
        print(f"main path {label}: launches {json.dumps(launches)}; step "
              f"ms first {step_s[0] * 1e3:.3f}, median of the rest "
              f"{steady * 1e3:.3f}; {128 / steady:.1f} images/s; "
              f"history {json.dumps(tr.history)}; seconds "
              f"{now - t0:.3f}")
        t0 = now

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
    worst = max_abs_diff(torch, ker.params, ref_run.params)
    print(f"params, kernels vs plain backend after {steps} steps: max abs "
          f"diff {worst:.3e} (rtol 2e-4, atol 2e-5)")

    # a sixth step of the kernel run, profiled (after the comparisons)
    from repro_torch.data import SyntheticCIFAR
    batch = SyntheticCIFAR(seed=0).train_batch(128, 5)
    prof = profile_step(torch, lambda: ker.run([batch]), select="ef_gate")
    ef_gate_launches(prof, "cuda_count_ef step 6")
    t0 = emit("profile cuda_count_ef step 6", prof, t0)

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
    worst_rk = max_abs_diff(torch, fig5_params["randomk_cuda"],
                            fig5_params["randomk_python"])
    torch.backends.cudnn.deterministic = False
    print(f"fig5 params, randomk kernel vs plain route after {steps} steps: "
          f"max abs diff {worst_rk:.3e} (rtol 2e-4, atol 2e-5)")
    t0 = emit("fig5", dict(fig5), t0)
    # a second Random-k step, profiled (after the counted runs)
    t0 = emit("profile fig5_randomk", profile_fig5_randomk(torch), t0)

    # the cluster runtime, PSTrainer's default engine
    rt_line, rt_launches = run_runtime_phase(torch, zero_counts, read_counts,
                                             launches_of)
    t0 = emit("runtime", rt_line, t0)

    # the packet-level transport
    des_line, des_launches = run_des_phase(torch, zero_counts, read_counts,
                                           launches_of)
    t0 = emit("des", des_line, t0)

    # the paper's Fig 13 time-to-accuracy run
    tta_line, tta_launches = run_tta_phase(torch, zero_counts, read_counts,
                                           launches_of)
    t0 = emit("tta", tta_line, t0)

    # the des16 fabric-chaos scenario: network faults and the controller
    nf_line, nf_launches = run_netfault_phase(torch, zero_counts,
                                              read_counts, launches_of)
    t0 = emit("netfault", nf_line, t0)

    # the LM path: smollm-360m at its published widths, trained over the
    # LTP PS and served by KV-cache decode
    gc.collect()
    torch.cuda.empty_cache()
    lm_line, lm_launches, lm_kernels, lm_cfg, lm_init = run_lm_phase(
        torch, timer, zero_counts, read_counts, launches_of)
    t0 = emit("lm", lm_line, t0)
    t0 = emit("serve", run_serve_phase(torch, lm_cfg, lm_init), t0)

    # the sharded LTP path: the same model and init through the port's
    # make_ltp_train_step over torch.distributed, the plain gate on every
    # leaf; then two gloo ranks on the card against their CPU twin
    gc.collect()
    torch.cuda.empty_cache()
    sharded_line, sharded_launches, sharded_rows, ws1 = run_sharded_phase(
        torch, timer, zero_counts, read_counts, launches_of, lm_cfg, lm_init)
    t0 = emit("sharded", sharded_line, t0)
    del lm_init

    # tensor parallelism over the model axis: one Mixtral-8x22b layer and
    # one DeepSeek-V2 layer (and its ZeRO variant) at their published
    # widths, and falcon-mamba, zamba2, whisper-small and papernet, on
    # (data 1, model 2) as two gloo ranks on the card against (1, 1); the
    # sharded phase's smollm-360m on (pod 1, data 2) against its world
    # size 1; REDUCED models on (data 2, model 2) and (pod 2, data 2)
    # the dry-run's production rows start here, in the background: the
    # phases before are host-timed and run alone, while tp's ranks share
    # the host with its REDUCED ranks already
    rows_procs.extend(start_dryrun_rows(rows_dir))
    gc.collect()
    torch.cuda.empty_cache()
    tp_line, tp_launches, tp_rows, tp_by_model = run_tp_phase(
        torch, timer, launches_of, ws1)
    del ws1
    t0 = emit("tp", tp_line, t0)

    # the dry-run of the tp phase's configurations against its counts,
    # and the production rows
    t0 = emit("dryrun", run_dryrun_phase(torch, tp_line, rows_procs), t0)

    # the MoE family: mixtral-8x22b at its published widths trained over
    # the LTP PS in bfloat16, then its packet_reduce stream checked and
    # timed with the model freed; mixtral and deepseek-v2 served
    gc.collect()
    torch.cuda.empty_cache()
    moe_line, moe_launches, moe_shape = run_moe_phase(
        torch, zero_counts, read_counts, launches_of)
    moe_kernel = check_lm_kernels(torch, timer, *moe_shape,
                                  ef=False)["packet_reduce"]
    t0 = emit("moe", moe_line, t0)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = emit("moe_serve", run_moe_serve_phase(torch), t0)

    # the SSM family: falcon-mamba-7b and the zamba2-7b hybrid at their
    # published widths trained over the LTP PS in bfloat16, each stream
    # then checked and timed with the model freed; both served
    ssm_launches, ssm_kernels = {}, {}
    for name in SSM_PATHS:
        gc.collect()
        torch.cuda.empty_cache()
        ssm_line, ssm_launches[name], ssm_shape = run_ssm_phase(
            torch, zero_counts, read_counts, launches_of, name)
        ssm_kernels[name] = check_lm_kernels(torch, timer, *ssm_shape,
                                             ef=False)["packet_reduce"]
        t0 = emit(name, ssm_line, t0)
        gc.collect()
        torch.cuda.empty_cache()
    t0 = emit("ssm_serve", run_ssm_serve_phase(torch), t0)

    # the enc-dec family: whisper-small at its full published config
    # trained over the LTP PS in bfloat16, its stream then checked and
    # timed with the model freed; served from its encoder's cross K/V
    gc.collect()
    torch.cuda.empty_cache()
    encdec_line, encdec_launches, encdec_shape = run_encdec_phase(
        torch, zero_counts, read_counts, launches_of)
    encdec_kernel = check_lm_kernels(torch, timer, *encdec_shape,
                                     ef=False)["packet_reduce"]
    t0 = emit("encdec", encdec_line, t0)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = emit("encdec_serve", run_encdec_serve_phase(torch), t0)

    # tree_reduce is on no training path: its count is the check calls'
    by_path = {
        "lockstep": [r[2] for r in runs.values()],
        "Fig 5": [r["launches"] for r in fig5.values()],
        "runtime": rt_launches, "des": des_launches, "Fig 13": tta_launches,
        "des16": nf_launches, "lm": lm_launches, "moe": [moe_launches],
        **{name: [n] for name, n in ssm_launches.items()},
        "encdec": [encdec_launches]}
    path_launches = {name: {path: sum(r[name] for r in rs)
                            for path, rs in by_path.items()}
                     for name in counters}
    # des16 launches packet_reduce at (16, 1934, 360) alone: its count
    # goes to that shape's entry, not to the (8, 1934, 360) one
    w16_launches = path_launches["packet_reduce"].pop("des16")
    # so does the LM path at its stream, and dropfill's EF form at its
    # rows: those counts go to the LM shapes' entries
    lm_path = {name: path_launches[name].pop("lm") for name in counters}
    if lm_path["tree_reduce"] or lm_path["randomk"]:
        raise AssertionError(f"the LM path launched {lm_path}")
    # and the MoE path at its (2, 8074223, 360) stream
    moe_path = {name: path_launches[name].pop("moe") for name in counters}
    if moe_path != launches_of(packet_reduce=MOE_STEPS):
        raise AssertionError(f"the MoE path launched {moe_path}")
    # and each SSM path at its stream
    ssm_path = {}
    for path in SSM_PATHS:
        ssm_path[path] = {name: path_launches[name].pop(path)
                          for name in counters}
        if ssm_path[path] != launches_of(packet_reduce=SSM_STEPS):
            raise AssertionError(f"the {path} path launched "
                                 f"{ssm_path[path]}")
    # and the enc-dec path at its stream
    encdec_path = {name: path_launches[name].pop("encdec")
                   for name in counters}
    if encdec_path != launches_of(packet_reduce=ENCDEC_STEPS):
        raise AssertionError(f"the encdec path launched {encdec_path}")
    # the sharded path launches the plain gate alone, at its leaves: its
    # count goes to dropfill's ``sharded`` entry
    sharded_path = {name: sum(r[name] for r in sharded_launches)
                    for name in counters}
    if sharded_path != launches_of(dropfill=sharded_path["dropfill"]) or \
            not sharded_path["dropfill"]:
        raise AssertionError(f"the sharded path launched {sharded_path}")
    # so does the tensor-parallel path, at Mixtral's leaves (every rank's
    # launches, the child processes' counted there): its ``tp`` entry
    tp_path = {name: sum(r[name] for r in tp_launches) for name in counters}
    if tp_path != launches_of(dropfill=tp_path["dropfill"]) or \
            not tp_path["dropfill"]:
        raise AssertionError(f"the tp path launched {tp_path}")
    main_launches = {name: sum(path_launches[name].values())
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
                              if name == "tree_reduce" else
                              "main paths: " + ", ".join(
                                  path for path, n in
                                  path_launches[name].items() if n)),
            "max_abs_err": e["max_abs_err"],
            "ms": e["ms"], "plain_ms": e["plain_ms"],
            "bound_ms": e["bound_ms"], "bound_by": e["bound_by"],
            "library_ms": e["library_ms"]})
        if name == "dropfill":
            # the same kernel's EF form, which every training path launches
            line[-1]["ef_form"] = [
                {k: r[k] for k in ("shape", "max_abs_err", "ms", "plain_ms",
                                   "bound_ms", "bound_by", "library_ms",
                                   "library_calls")}
                for r in entries["dropfill_ef"]]
            # the plain gate on the sharded path, at its largest leaf and
            # over a step's leaves
            row = sharded_rows["leaf"]
            line[-1]["sharded"] = {
                "shape": row["shape"], "form": "plain",
                "launches": sharded_path["dropfill"],
                "launches_from": "main paths: sharded",
                **{k: row[k] for k in ("max_abs_err", "ms", "plain_ms",
                                       "bound_ms", "bound_by", "library_ms",
                                       "library_call")},
                "step": sharded_rows["step"]}
            # and on the tensor-parallel path, at one Mixtral layer's
            # largest leaf and over its 13 leaves (the launches: every
            # model's, every rank's), and at one DeepSeek-V2 layer's (its
            # runs' launches)
            for key, arch, n in (
                    ("tp", "mixtral_8x22b", tp_path["dropfill"]),
                    ("tp_deepseek", "deepseek_v2_236b",
                     tp_by_model["deepseek_v2_236b"])):
                row = tp_rows[arch]["leaf"]
                line[-1][key] = {
                    "shape": row["shape"], "form": "plain",
                    "launches": n,
                    "launches_from": ("main paths: tp (every model, every "
                                      "rank)" if key == "tp" else
                                      "main paths: tp, deepseek_v2_236b "
                                      "(every rank)"),
                    **{k: row[k] for k in ("max_abs_err", "ms", "plain_ms",
                                           "bound_ms", "bound_by",
                                           "library_ms", "library_call")},
                    "step": tp_rows[arch]["step"]}
        if name == "packet_reduce":
            # the des16 path's shape: every launch of that phase
            e = entries["packet_reduce_w16"]
            line[-1]["w16"] = {
                "shape": e["shape"],
                "launches": w16_launches,
                "launches_from": "main paths: des16",
                **{k: e[k] for k in ("max_abs_err", "ms", "plain_ms",
                                     "bound_ms", "bound_by", "library_ms")}}
    for e in line:
        if e["name"] in ("packet_reduce", "dropfill"):
            row = lm_kernels["packet_reduce" if e["name"] == "packet_reduce"
                             else "dropfill_ef"]
            e["lm"] = {
                "shape": row["shape"],
                "form": "paper" if e["name"] == "packet_reduce" else "ef",
                "launches": lm_path[e["name"]],
                "launches_from": "main paths: lm",
                **{k: row[k] for k in ("max_abs_err", "ms", "plain_ms",
                                       "bound_ms", "bound_by",
                                       "library_ms")}}
            if e["name"] == "packet_reduce":
                e["moe"] = {
                    "shape": moe_kernel["shape"], "form": "paper",
                    "launches": moe_path["packet_reduce"],
                    "launches_from": "main paths: moe",
                    **{k: moe_kernel[k] for k in (
                        "max_abs_err", "ms", "plain_ms", "bound_ms",
                        "bound_by", "library_ms")}}
                for path, row in ssm_kernels.items():
                    e[path] = {
                        "shape": row["shape"], "form": "paper",
                        "launches": ssm_path[path]["packet_reduce"],
                        "launches_from": f"main paths: {path}",
                        **{k: row[k] for k in (
                            "max_abs_err", "ms", "plain_ms", "bound_ms",
                            "bound_by", "library_ms")}}
                e["whisper"] = {
                    "shape": encdec_kernel["shape"], "form": "paper",
                    "launches": encdec_path["packet_reduce"],
                    "launches_from": "main paths: encdec",
                    **{k: encdec_kernel[k] for k in (
                        "max_abs_err", "ms", "plain_ms", "bound_ms",
                        "bound_by", "library_ms", "library_call")}}
    print(json.dumps({"kernels": line}))
    phases["kernels line"] = time.perf_counter() - t0
    print("phases " + json.dumps({"seconds": phases,
                                  "total": time.perf_counter() - t_start}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--sharded-gloo-rank"]:
        sys.exit(sharded_gloo_child(sys.argv[2:]))
    if sys.argv[1:2] == ["--tp-rank"]:
        sys.exit(tp_child(sys.argv[2:]))
    if sys.argv[1:2] == ["--dryrun-rows"]:
        sys.exit(dryrun_rows_child(sys.argv[2:]))
    sys.exit(main())
