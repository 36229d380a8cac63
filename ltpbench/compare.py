"""The numbers ``correct`` compares, between the program's first steps
and the reference's, each against its limit in the cell's file.

* ``first_loss_gap``: the relative gap of the first step's mean loss.
  The later steps' losses are not compared: an update of 3e-4 x the
  gradient is mostly below half a bfloat16 step of the weight it moves,
  so from the second step on the two sides' bfloat16 weights differ
  wherever the last bit of an update decided the rounding, and their
  loss gap swings from seed to seed as far as the float8 control's
  (PERF.md, §6). The later steps are held through ``step_gap``.
* ``grad_gap``: the worst leaf's gap between the norms of the first
  step's gradient as the optimizer got it, over the larger of the
  reference's norm of that leaf and of the median leaf.
* ``step_gap``: the same, of the parameters' change after the checked
  steps.
* ``bst_gap``, ``sim_time_gap``: the largest gap of a step's simulated
  gather-and-broadcast time and commit time (host float64, exact).
* ``delivered_gap``: the largest gap of a step's delivered fraction,
  the mean of the (W, n_packets) masks (float32).
* ``mask_gap``: the number of (step, worker, packet) delivery entries
  in which the masks the program's runtime hands its step differ from
  the reference's (exact: a program that drops other packets at the
  same rate fails here, whatever its norms read).

Leaves whose reference gradient is below a thousandth of the median
leaf's (a key bias under softmax, say) move by round-off alone and are
left out of both leaf gaps. A number that is not finite fails.
"""
from __future__ import annotations

import math
from typing import Dict, List

import numpy as np

SMALL_LEAF = 1e-3


def _leaf_gap(prog: List[float], ref: List[float], keep: List[bool]) -> float:
    ref_k = [r for r, k in zip(ref, keep) if k]
    med = float(np.median(ref_k)) if ref_k else 0.0
    gaps = [abs(p - r) / max(r, med, 1e-30)
            for p, r, k in zip(prog, ref, keep) if k]
    return max(gaps) if gaps else 0.0


def gaps(prog: dict, ref: dict) -> Dict[str, float]:
    med = float(np.median(ref["grad_norm"]))
    keep = [g >= SMALL_LEAF * med for g in ref["grad_norm"]]
    return {
        "first_loss_gap": abs(prog["loss"][0] - ref["loss"][0])
        / abs(ref["loss"][0]),
        "grad_gap": _leaf_gap(prog["grad_norm"], ref["grad_norm"], keep),
        "step_gap": _leaf_gap(prog["change_norm"], ref["change_norm"], keep),
        "bst_gap": max(abs(p - r) for p, r in zip(prog["bst"], ref["bst"])),
        "sim_time_gap": max(abs(p - r) for p, r in
                            zip(prog["sim_time"], ref["sim_time"])),
        "delivered_gap": max(abs(p - r) for p, r in
                             zip(prog["delivered"], ref["delivered"])),
        "mask_gap": mask_gap(prog["masks"], ref["masks"]),
    }


def mask_gap(prog: List[np.ndarray], ref: List[np.ndarray]) -> float:
    """Differing entries of two runs' packed (W, n_packets) masks, step
    by step; infinite where the steps or sizes differ."""
    if len(prog) != len(ref) or \
            any(p.shape != r.shape for p, r in zip(prog, ref)):
        return math.inf
    return float(sum(int(np.unpackbits(np.bitwise_xor(p, r)).sum())
                     for p, r in zip(prog, ref)))


def judge(values: Dict[str, float], limits: Dict[str, float]):
    """(correct, {name: {"value", "limit"}}): every number finite and at
    or under its limit."""
    out, ok = {}, True
    for name, v in values.items():
        lim = limits.get(name)
        out[name] = {"value": v, "limit": lim}
        if not math.isfinite(v) or (lim is not None and v > lim):
            ok = False
    return ok, out
