"""The whole step's share of the card's bfloat16 peak, in %: the model's
FLOPs a step (forward and backward matrix products and attention of all
W workers' batches, as ``reference/<config>.py::worker_flops`` counts
them, remat's recomputation not counted) times the window's steps, over
the window's wall time and the data-sheet peak. In a traced run the
window is the part before the profiled steps."""


def read(ctx):
    peak = ctx["costs"].peak(ctx["device_name"], "bf16_flops")
    if peak is None:
        return None
    w = ctx["window"]
    return 100.0 * ctx["flops_per_step"] * w["steps"] / w["seconds"] / peak
