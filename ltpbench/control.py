"""Readings that set the limits of a cell's ``correct``, on many seeds in
one process (the benchmark's own runs never run this).

    python3 -m ltpbench.control --workload <cell> --seeds 11 12 13 \\
        [--variants program fp8 half no_exchange] [--out FILE]

For each seed, each variant's first steps are compared with the
reference's (``compare.gaps``), at the cell's own sizes:

* ``program``: the program's first steps, as a run's set-up takes them
  (the lower reading of every limit);
* ``fp8``: the control, the reference with its products in float8
  (``reference/numerics.py``), which a correct check must fail;
* ``half``, ``no_exchange``: faults planted in the reference put in the
  program's place (``reference/ltp.py::follow``). A step that returns
  its state unchanged reads 1 on ``step_gap`` by definition.

One JSON line a seed and variant goes to standard output and ``--out``.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from ltpbench import cell as cells

VARIANTS = ("program", "fp8", "half", "no_exchange")


def readings(cell, seed: int, variants, device) -> list:
    from ltpbench import compare, traffic
    from ltpbench.program import Trainer, release
    from ltpbench.run import reference_run

    wl = cell.workload
    batches = traffic.host_batches(cell.config, wl, seed,
                                   wl["checked_steps"], device)
    got = {}
    if "program" in variants:
        prog = Trainer(cell, seed, device)
        got["program"] = prog.first_steps(batches)
        del prog
        release(device)
    ref = reference_run(cell, seed, batches, device)
    for v in variants:
        if v == "fp8":
            got[v] = reference_run(cell, seed, batches, device, "fp8")
        elif v in ("half", "no_exchange"):
            got[v] = reference_run(cell, seed, batches, device, fault=v)
    return [{"seed": seed, "variant": v, **compare.gaps(got[v], ref),
             "loss": got[v]["loss"], "ref_loss": ref["loss"]}
            for v in variants]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--variants", nargs="+", default=list(VARIANTS),
                    choices=VARIANTS)
    ap.add_argument("--out")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(cells.ROOT / "src"))
    cell = cells.load(args.workload)
    out = open(args.out, "a") if args.out else None
    try:
        for seed in args.seeds:
            t0 = time.perf_counter()
            for rec in readings(cell, seed, args.variants, args.device):
                rec["seconds"] = time.perf_counter() - t0
                line = json.dumps(rec)
                print(line, flush=True)
                if out:
                    out.write(line + "\n")
                    out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
