"""Device milliseconds a step of the fused attention: the device time of
the operations launched inside the program's ``fused_attention`` spans
(each forward and backward launch of the kernels, on whichever thread
launched it), over the profiled steps. A program without the span reads
nothing."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not tr.device_ops or not tr.spans("fused_attention"):
        return None
    return tr.device_us_in("fused_attention") / tr.steps / 1e3
