"""syncs_per_batch.batch: host synchronisations per batch in the traced
window (torch's sync debug mode), every thread counted."""


def read(ctx):
    if ctx["loop"] != "batch" or ctx["syncs"] is None or not ctx["units"]:
        return None
    return ctx["syncs"] / ctx["units"]
