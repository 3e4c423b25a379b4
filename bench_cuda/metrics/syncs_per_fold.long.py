"""syncs_per_fold.long: host synchronisations per fold in the traced window."""


def read(ctx):
    if ctx["loop"] != "single" or ctx["syncs"] is None or not ctx["units"]:
        return None
    return ctx["syncs"] / ctx["units"]
