"""End to end: env steps completed in the window, each with its owed update,
over the window's seconds (host clock; the window opens and closes with a
device synchronise)."""


def read(ctx):
    w = ctx["window"]
    return w["env_steps"] / w["seconds"]
