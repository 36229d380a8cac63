"""``packet_reduce``'s share of its roofline, in %: the bytes the masked
reduction of W x n_packets x 360 float32 packets needs (each input read
once, the output written once) over the card's HBM rate, divided by the
kernel's mean device time a launch in the profiled steps."""

KERNEL = "reduce_kernel<false"


def read(ctx):
    tr = ctx["trace"]
    rate = ctx["costs"].peak(ctx["device_name"], "hbm_bytes")
    if tr is None or rate is None:
        return None
    times = [b - a for n, a, b, _, _ in tr.device_ops if KERNEL in n]
    if not times:
        return None
    need_s = ctx["costs"].packet_reduce_bytes(ctx["workers"],
                                              ctx["n_packets"]) / rate
    return 100.0 * need_s / (sum(times) / len(times) / 1e6)
