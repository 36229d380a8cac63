"""The share of a step's wall time in which no operation ran on the
device, in %: the device's busy time a step, from the profiled steps'
trace (the union of their operations' intervals), against the wall time
a step of the unprofiled window before them. The profiled steps' own
wall time is not used: the profiler's host overhead on every launch
would count as idle."""


def read(ctx):
    tr, w = ctx["trace"], ctx["window"]
    if tr is None or not tr.device_ops or not w["steps"]:
        return None
    busy_step = tr.busy_us() / 1e6 / tr.steps
    return 100.0 * (1.0 - busy_step / (w["seconds"] / w["steps"]))
