"""Where a cell's unprofiled step spends its host time: the program's
counters (``ClusterRuntime.host_metrics``, mirrored as
``PSTrainer.host_metrics``) read just before and just after the
benchmark's window, and, with ``--trace 1``, one profiled step after it
for the device's side.

    python3 -m ltpbench.host_split --workload whisper_small.ltp_bsp \\
        --seed 7 --seconds 51 --trace 1 --span-cost 100000

from the root of a checkout, on a machine with a CUDA device
(``--device cpu`` runs the cell at its CPU test sizes). The set-up and
the window are ``ltpbench.run``'s. The last line of standard output is
one JSON object:

- ``window``: its steps and wall ms a step, and a step's split in host
  ms: ``mask_draw_host_ms`` (timed span ``draw_delivery_masks``),
  ``input_stage_host_ms`` (``stage_inputs``: the copies to the device and
  any wait inside them), ``commit_dispatch_host_ms`` (``bsp_commit`` less
  ``stage_inputs``: the host dispatching the step) and ``rest_ms`` (the
  wall time outside the three); ``h2d_mb_per_step``, ``batch_misses``
  and each span's calls;
- ``profiled`` (``--trace 1``): the same split over the profiled steps,
  their wall and busy ms a step, the device ms launched inside each span,
  ``ps_sync_device_ms`` and the largest idle gaps by innermost span;
- ``span_cost_us`` (``--span-cost n``): one enter and exit of a plain
  ``record_function`` span and of a timed span (``MetricsRegistry.span``)
  with no profiler, n of each, twice.

A program without ``host_metrics`` exits 2 and prints no result.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from ltpbench import cell as cells

HOST_SPANS = ("draw_delivery_masks", "stage_inputs", "bsp_commit")
# the program's ``runtime/step.py::PS_SYNC_SPANS`` and the chunk's span
DEVICE_SPANS = ("worker_grads", "encoder", "flatten_into", "ef_gate",
                "reduce_packet_stream", "unflatten", "opt_update",
                "stage_inputs", "bsp_commit")


def delta(before: dict, after: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in after.items()}


def split(d: dict, steps: int, wall_s: float) -> dict:
    """A step's host ms by span, from counter deltas ``d`` over ``steps``
    steps that took ``wall_s`` seconds."""
    ms = {k: d.get(f"span/{k}/ns", 0) / steps / 1e6 for k in HOST_SPANS}
    out = {"steps": steps, "wall_ms": wall_s / steps * 1e3,
           "mask_draw_host_ms": ms["draw_delivery_masks"],
           "input_stage_host_ms": ms["stage_inputs"],
           "commit_dispatch_host_ms": ms["bsp_commit"] - ms["stage_inputs"],
           "h2d_mb_per_step": d.get("h2d/bytes", 0) / 1e6 / steps,
           "batch_misses": d.get("h2d/batch_misses", 0),
           "calls": {k: d.get(f"span/{k}/calls", 0) for k in HOST_SPANS}}
    out["rest_ms"] = out["wall_ms"] - ms["draw_delivery_masks"] \
        - ms["bsp_commit"]
    return out


def span_cost_us(n: int) -> dict:
    """Microseconds of one enter and exit, no profiler running."""
    from torch.profiler import record_function

    from repro_torch.obs.metrics import MetricsRegistry

    out = {"plain": [], "timed": []}
    for _ in range(2):
        t0 = time.perf_counter_ns()
        for _ in range(n):
            with record_function("x"):
                pass
        out["plain"].append((time.perf_counter_ns() - t0) / n / 1e3)
        span = MetricsRegistry().span("x")
        t0 = time.perf_counter_ns()
        for _ in range(n):
            with span:
                pass
        out["timed"].append((time.perf_counter_ns() - t0) / n / 1e3)
    return out


def measure(cell, seed: int, seconds: float, trace: bool, device,
            span_cost: int = 0):
    """The split of ``cell``'s window, or None where the program keeps
    no ``host_metrics``."""
    import torch

    from ltpbench import traffic
    from ltpbench.program import Trainer, release, sync
    from ltpbench.reference.trace import top

    cfg, wl = cell.config, cell.workload
    pool = traffic.host_batches(cfg, wl, seed, wl["chunk_steps"], device)
    prog = Trainer(cell, seed, device)
    counters = getattr(prog.tr, "host_metrics", None)
    if counters is None:
        return None
    prog.first_steps(pool[:wl["checked_steps"]])
    sync(device)
    release(device)
    c0 = counters.snapshot()
    win = prog.window(pool, seconds)
    out = {"seed": seed,
           "window": split(delta(c0, counters.snapshot()), win["steps"],
                           win["seconds"])}
    if trace:
        c0 = counters.snapshot()
        tr = prog.profile(pool[:wl["profile_steps"]])
        p = split(delta(c0, counters.snapshot()), tr.steps,
                  tr.window_us / 1e6)
        p["busy_ms"] = tr.busy_us() / 1e3 / tr.steps
        p["device_ms_in"] = {n: tr.device_us_in(n) / 1e3 / tr.steps
                             for n in DEVICE_SPANS}
        p["ps_sync_device_ms"] = cells.reader("ps_sync_device_ms")(
            {"trace": tr})
        p["idle_gaps_ms"] = [[n[:60], us / 1e3 / tr.steps]
                             for n, us in top(tr.idle_gaps(), 12)]
        out["profiled"] = p
    if span_cost:
        out["span_cost_us"] = span_cost_us(span_cost)
    cuda = torch.device(device).type == "cuda"
    out["device"] = torch.cuda.get_device_name(device) if cuda else "cpu"
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--span-cost", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(cells.ROOT / "src"))
    cell = cells.load(args.workload, test_sizes=args.device == "cpu")
    out = measure(cell, args.seed, args.seconds, bool(args.trace),
                  args.device, args.span_cost)
    if out is None:
        print("ltpbench.host_split: the program keeps no host_metrics",
              file=sys.stderr)
        return 2
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
