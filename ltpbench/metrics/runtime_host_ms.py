"""Host milliseconds a step outside the program's ``bsp_commit`` span on
the main thread (the event loop, the Early Close controller, the mask
draws, the history), less the time it spent waiting on the device in a
synchronising runtime call outside that span; over the profiled
steps."""

WAITS = ("cudaDeviceSynchronize", "cudaStreamSynchronize")


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    main = [(n, a, b) for n, a, b, th in tr.host_ops if th == tr.main_thread]
    commits = sorted((a, b) for n, a, b in main if n == "bsp_commit")
    if not commits:
        return None

    def inside(t):
        return any(a <= t <= b for a, b in commits)

    waits = sum(b - a for n, a, b in main if n in WAITS and not inside(a))
    outside = tr.window_us - sum(b - a for a, b in commits) - waits
    return outside / tr.steps / 1e3
