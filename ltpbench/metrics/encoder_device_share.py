"""Device time of the operations launched inside the program's
``encoder`` span (the encoder's forward, and each layer's backward under
remat), over the device's busy time, in %, over the profiled steps."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not tr.device_ops or not tr.spans("encoder"):
        return None
    return 100.0 * tr.device_us_in("encoder") / tr.busy_us()
