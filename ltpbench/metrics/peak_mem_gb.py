"""The CUDA caching allocator's peak of allocated bytes over set-up and
window (10^9 bytes a GB), read before the reference runs."""


def read(ctx):
    return None if ctx["peak_bytes"] is None else ctx["peak_bytes"] / 1e9
