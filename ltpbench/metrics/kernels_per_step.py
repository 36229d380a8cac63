"""Device kernels launched a step over the profiled steps (copies and
fills not counted)."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not tr.device_ops:
        return None
    return len(tr.kernels()) / tr.steps
