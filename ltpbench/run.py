"""One run of one cell of the benchmark of ``repro_torch`` (the PyTorch and
CUDA port of LTP training).

    python3 -m ltpbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell asks
for. The run makes the weights on the device and the host batches from
the seed, builds the program's trainer and drives its first steps (the
set-up, which also warms every kernel and shape the window uses), then
calls ``PSTrainer.run`` on the cell's batches until ``--seconds`` have
passed. It then frees the program, follows the same first steps with the
plain reference (``ltpbench/reference``) and compares. The last line of
standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the end-to-end ones, or with ``--trace 1`` the
per-layer ones and a ``breakdown`` of the profiled steps), ``device``
and, last, ``compared``: each number compared with its limit, which the
last lines of standard error repeat.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402

from ltpbench import cell as cells  # noqa: E402

# top-level module names that must not be loaded in a run's process:
# the JAX package this port reproduces, and JAX itself
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
NAME_CHARS = 120


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def reference_run(cell, seed: int, batches, device, precision="exact",
                  fault=None) -> dict:
    """The reference's first steps on the cell's inputs (weights made
    again from ``seed``), products in ``precision``."""
    import torch

    from ltpbench.reference import ltp, numerics
    from ltpbench.reference import weights as W

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, wl = cell.config, cell.workload
    ref = cell.reference
    mm = numerics.PRECISIONS[precision]
    params = W.make(ref.param_shapes(cfg), seed, device)

    def loss_fn(p, rows):
        return ref.loss(cfg, p, {k: v.to(device) for k, v in rows.items()},
                        mm)

    return ltp.follow(loss_fn, params, batches, workers=cfg["workers"],
                      optimizer=cfg["optimizer"], lr=wl["lr"],
                      net=wl["net"], compute_time=wl["compute_time"],
                      seed=seed, device=device, fault=fault)


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             t_start: float) -> dict:
    """Everything a run does once the card has been found."""
    import torch

    from ltpbench import compare, traffic
    from ltpbench.program import Trainer, release, sync
    from ltpbench.reference import costs, ltp
    from ltpbench.reference.trace import top

    cfg, wl = cell.config, cell.workload
    cuda = torch.device(device).type == "cuda"
    t0 = time.perf_counter()
    pool = traffic.host_batches(cfg, wl, seed, wl["chunk_steps"], device)
    checked = pool[:wl["checked_steps"]]
    t1 = time.perf_counter()
    prog = Trainer(cell, seed, device)
    first = prog.first_steps(checked)
    sync(device)
    setup_s = time.perf_counter() - t_start
    setup = {"imports": t0 - t_start, "batches": t1 - t0, **prog.timings}
    # the window starts from the allocator's state after warm-up, not
    # from the blocks the set-up's own readings left cached
    release(device)
    win = prog.window(pool, seconds)
    prof = prog.profile(pool[:wl["profile_steps"]]) if trace else None
    peak = torch.cuda.max_memory_allocated(device) if cuda else None
    retries = torch.cuda.memory_stats(device).get("num_alloc_retries") \
        if cuda else None
    del prog
    release(device)
    ref = reference_run(cell, seed, checked, device)
    ok, compared = compare.judge(compare.gaps(first, ref), cell.limits())
    failed = sum(1 for x in win["losses"] if x != x or abs(x) == float("inf"))
    name = torch.cuda.get_device_name(device) if cuda else "cpu"
    sizes = [math.prod(v[0]) for v in
             cell.reference.param_shapes(cfg).values()]
    ctx = {
        "setup_s": setup_s, "window": win, "peak_bytes": peak,
        "trace": prof, "device_name": name, "workers": cfg["workers"],
        "tokens_per_step": wl["batch"] * wl["seq"],
        "flops_per_step": cfg["workers"] * cell.reference.worker_flops(
            cfg, wl["batch"] // cfg["workers"], wl["seq"]),
        "n_packets": ltp.PacketLayout.of(sizes).n_packets,
        "costs": costs,
    }
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = cells.reader(m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu", "kind": name,
           "count": cell.chips if cuda else 0, "memory_peak_bytes": peak}
    out = {"correct": bool(ok and failed == 0),
           "attempted": win["steps"], "failed": failed,
           "metrics": metrics, "device": dev}
    if prof is not None:
        dev["busy_s"] = prof.busy_us() / 1e6
        dev["window_s"] = prof.window_us / 1e6
        out["breakdown"] = {
            "device_ops": [[n[:NAME_CHARS], us / 1e6] for n, us in
                           top(prof.device_us_by_name())],
            "idle_gaps": [[n[:NAME_CHARS], us / 1e6] for n, us in
                          top(prof.idle_gaps())]}
        out["host_ops_a_step"] = host_ops_a_step(prof)
    out["setup"] = setup
    out["alloc_retries"] = retries
    out["chunk_ends"] = win["chunk_ends"]
    out["compared"] = compared
    return out


def host_ops_a_step(tr) -> dict:
    """Host operations the profiler recorded on the main thread a step,
    inside the program's ``bsp_commit`` spans and outside them: what its
    per-operation overhead scales with."""
    main = [(n, a) for n, a, b, th in tr.host_ops
            if th == tr.main_thread and n != "bsp_commit"]
    commits = [(a, b) for n, a, b, th in tr.host_ops
               if th == tr.main_thread and n == "bsp_commit"]
    inside = sum(1 for _, t in main if any(a <= t <= b for a, b in commits))
    return {"inside_bsp_commit": inside / tr.steps,
            "outside": (len(main) - inside) / tr.steps}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(cells.ROOT / "src"))
    cell = cells.load(args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"ltpbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                   T_START)
    bad = loaded_forbidden()
    if bad:
        print(f"ltpbench: the run's process loaded {bad}", file=sys.stderr)
        return 3
    print("setup " + ", ".join(f"{k} {v:.3f} s" for k, v in
                               out["setup"].items())
          + f"; allocator retries {out['alloc_retries']}", file=sys.stderr)
    for k, v in out["compared"].items():
        print(f"compared {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
