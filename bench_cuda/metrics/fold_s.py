"""fold_s: the window's seconds over the folds it completed, one target at a
time, back to back."""


def read(ctx):
    if ctx["loop"] != "single" or not ctx["units"]:
        return None
    return ctx["window_s"] / ctx["units"]
