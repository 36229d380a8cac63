"""Label tokens (batch x seq) of every step completed in the window,
over the wall time from the window's start to the synchronise after its
last step."""


def read(ctx):
    w = ctx["window"]
    return w["steps"] * ctx["tokens_per_step"] / w["seconds"]
