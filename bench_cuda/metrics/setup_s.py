"""setup_s: seconds from the process's start to the window's first dispatch."""


def read(ctx):
    return ctx["setup_s"]
