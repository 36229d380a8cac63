"""Set-up seconds: from the start of the run's process (before torch is
imported) to the end of the first checked steps, which build the
kernels, warm every shape the window uses and fill the program's device
batch cache."""


def read(ctx):
    return ctx["setup_s"]
