"""Host cost of calling the port's CUDA kernels, on the card.

Times, for the ``repro_torch`` package found under ``--src``:

- one call of each wrapper whose kernel the papernet path launches
  (``ops.ltp_dropfill`` on a (1934, 360) float32 gradient,
  ``ops.ltp_packet_reduce`` on its (8, 1934, 360) stream), as the host
  wall time of ``--calls`` back-to-back calls, then a synchronise,
  over the count: at these sizes the host's dispatch is the larger
  part;
- ``chip_smoke.py``'s papernet main path (full-width papernet, 8
  workers, 5 LTP steps, count compensation with error feedback: one
  ``packet_reduce`` and one ``dropfill`` launch a step): the host ms of
  each step.

Give it two checkouts' ``src`` (run from this one's root) to compare
two versions of the wrappers on one card, e.g. parent, change, change,
parent:

    python examples/op_overhead_torch.py --src path/to/src

It prints one JSON object.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", required=True,
                    help="the src directory whose repro_torch is timed")
    ap.add_argument("--calls", type=int, default=2000)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.src))
    sys.path.insert(1, os.path.dirname(HERE))   # chip_smoke.py
    import torch

    import chip_smoke
    from repro_torch.kernels import ops

    if not torch.cuda.is_available():
        print("op_overhead_torch: no CUDA device", file=sys.stderr)
        return 1
    gen = torch.Generator(device="cuda").manual_seed(0)
    g = torch.randn((1934, 360), device="cuda", generator=gen)
    m = (torch.rand(1934, device="cuda", generator=gen) < 0.9).float()
    w = torch.randn((8, 1934, 360), device="cuda", generator=gen)
    wm = (torch.rand((8, 1934), device="cuda", generator=gen) < 0.9).float()
    out = {"src": os.path.abspath(args.src), "calls": args.calls,
           "torch": torch.__version__}
    for name, fn in (("dropfill", lambda: ops.ltp_dropfill(g, m)),
                     ("packet_reduce", lambda: ops.ltp_packet_reduce(w, wm))):
        runs = []
        for _ in range(5):
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(args.calls):
                fn()
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t0) / args.calls * 1e6)
        out[f"{name}_us_per_call"] = statistics.median(runs)
    _, step_s = chip_smoke.run_main_path(torch, "cuda",
                                         compensation="count",
                                         error_feedback=True)
    out["main_path_step_ms"] = [s * 1e3 for s in step_s]
    out["main_path_median_ms"] = statistics.median(step_s[1:]) * 1e3
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
