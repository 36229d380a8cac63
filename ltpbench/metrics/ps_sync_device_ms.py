"""Device milliseconds a step of the PS sync path: the device time of
the operations launched inside the program's spans of that path (the
gradients written into the packet stream, the error-feedback gate, the
masked reduction, the reduced stream back to leaves, the optimizer's
update), summed over the spans' names, over the profiled steps. A
program without these spans reads nothing."""

# the program's ``runtime/step.py::PS_SYNC_SPANS``, written out: the
# harness runs beside versions of the program that lack them
SPANS = ("flatten_into", "ef_gate", "reduce_packet_stream", "unflatten",
         "opt_update")


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not tr.device_ops or \
            not any(tr.spans(name) for name in SPANS):
        return None
    return sum(tr.device_us_in(name) for name in SPANS) / tr.steps / 1e3
